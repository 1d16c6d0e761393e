"""Procedural scenes, generated from seeds so nothing is downloaded.

* `courtyard_scene`: the large enclosed scene with Sponza-like structure — a
  floor, four walls, two rows of columns, and scattered boxes — real
  occlusion, many triangles via quad subdivision, and several distinct
  base-color materials.
* `small_open_scene`: a small open scene at the scale of a single glTF
  model (about 4K triangles, one PNG texture) where sky misses dominate:
  a noise-displaced blob on a small ground tile.
"""

from __future__ import annotations

import numpy as np

from ..utils.image import encode_png
from .flatten import FlattenedScene
from .texture import Texture


def _subdivided_quad(corner, edge_u, edge_v, subdiv: int) -> np.ndarray:
    """(2*subdiv^2, 3, 3) triangles tiling the parallelogram
    corner + s*edge_u + t*edge_v, CCW so cross(e1, e2) faces +normal."""
    s = np.linspace(0.0, 1.0, subdiv + 1, dtype=np.float32)
    grid = (
        np.asarray(corner, np.float32)
        + s[:, None, None] * np.asarray(edge_u, np.float32)
        + s[None, :, None] * np.asarray(edge_v, np.float32)
    )  # (subdiv+1, subdiv+1, 3)
    p00 = grid[:-1, :-1].reshape(-1, 3)
    p10 = grid[1:, :-1].reshape(-1, 3)
    p01 = grid[:-1, 1:].reshape(-1, 3)
    p11 = grid[1:, 1:].reshape(-1, 3)
    t1 = np.stack([p00, p10, p11], axis=1)
    t2 = np.stack([p00, p11, p01], axis=1)
    return np.concatenate([t1, t2], axis=0)


def _box(center, half, subdiv: int) -> np.ndarray:
    cx, cy, cz = center
    hx, hy, hz = half
    quads = [
        # +y (top), -y (bottom)
        ([cx - hx, cy + hy, cz - hz], [2 * hx, 0, 0], [0, 0, 2 * hz]),
        ([cx - hx, cy - hy, cz - hz], [0, 0, 2 * hz], [2 * hx, 0, 0]),
        # +x, -x
        ([cx + hx, cy - hy, cz - hz], [0, 2 * hy, 0], [0, 0, 2 * hz]),
        ([cx - hx, cy - hy, cz - hz], [0, 0, 2 * hz], [0, 2 * hy, 0]),
        # +z, -z
        ([cx - hx, cy - hy, cz + hz], [2 * hx, 0, 0], [0, 2 * hy, 0]),
        ([cx - hx, cy - hy, cz - hz], [0, 2 * hy, 0], [2 * hx, 0, 0]),
    ]
    return np.concatenate(
        [_subdivided_quad(c, u, v, subdiv) for c, u, v in quads], axis=0
    )


def courtyard_scene(subdiv: int = 8, textured: bool = False):
    """Build (FlattenedScene, textures). Triangle count scales ~ subdiv^2:
    subdiv=8 → ~25K tris, subdiv=26 → ~262K tris (Sponza-sized).

    textured=True gives the scene Sponza-class MATERIAL variety: 14 distinct
    image textures of mixed sizes (64..512 px), each encoded to real PNG
    bytes and decoded back through Texture.from_memory — the identical code
    path glTF base-color images take (gltf_model.cpp:74-121 analog) — with
    per-wall / per-column / per-crate texture assignment so the packed atlas
    (render/scene.py) sees many offsets live in one render. textured=False
    keeps the legacy 4 solid 1x1 base colors (cheap engine tests)."""
    chunks: list[np.ndarray] = []
    materials: list[int] = []

    def add(tris: np.ndarray, material: int) -> None:
        chunks.append(tris.astype(np.float32))
        materials.extend([material] * tris.shape[0])

    # Material slots: untextured keeps the legacy 4 (floor/walls/columns/
    # crates); textured fans each group over distinct texture indices.
    def wall_mat(i):
        return 1 + (i % 4) if textured else 1

    def col_mat(i):
        return 5 + (i % 4) if textured else 2

    def crate_mat(i):
        return 9 + (i % 5) if textured else 3

    # Floor 40x20, walls height 12 (interior-facing normals).
    add(_subdivided_quad([-20, 0, -10], [0, 0, 20], [40, 0, 0], 2 * subdiv), 0)
    add(_subdivided_quad([-20, 0, -10], [40, 0, 0], [0, 12, 0], subdiv), wall_mat(0))  # -z
    add(_subdivided_quad([-20, 0, 10], [0, 12, 0], [40, 0, 0], subdiv), wall_mat(1))  # +z
    add(_subdivided_quad([-20, 0, -10], [0, 12, 0], [0, 0, 20], subdiv), wall_mat(2))  # -x
    add(_subdivided_quad([20, 0, -10], [0, 0, 20], [0, 12, 0], subdiv), wall_mat(3))  # +x

    # Two rows of columns.
    rng = np.random.default_rng(42)
    for ci, x in enumerate(np.linspace(-16, 16, 9)):
        for zi, z in enumerate((-5.0, 5.0)):
            add(_box([x, 4.0, z], [0.6, 4.0, 0.6], subdiv), col_mat(2 * ci + zi))
    # Scattered crates.
    for ki in range(12):
        cx = rng.uniform(-17, 17)
        cz = rng.uniform(-8, 8)
        h = rng.uniform(0.5, 1.5)
        add(_box([cx, h, cz], [h, h, h], subdiv), crate_mat(ki))

    positions = np.concatenate(chunks, axis=0)
    num_tris = positions.shape[0]

    e1 = positions[:, 1] - positions[:, 0]
    e2 = positions[:, 2] - positions[:, 0]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    normals = np.repeat(n[:, None, :], 3, axis=1).astype(np.float32)

    # Planar UVs from the two dominant axes of each triangle's bbox.
    uvs = positions[:, :, :2].copy()
    uvs -= uvs.min(axis=(0, 1))
    uvs /= max(uvs.max(), 1.0)
    if textured:
        # ~1 texture repeat per 5 world units (fract-wrapped at lookup,
        # like the reference's UV handling) so the checker/brick patterns
        # read at courtyard scale.
        uvs *= 8.0

    flat = FlattenedScene(
        positions=positions,
        normals=normals,
        tex_coords=uvs.astype(np.float32),
        texture_indices=np.asarray(materials, dtype=np.uint32),
    )
    if textured:
        textures = courtyard_textures()
    else:
        textures = [
            Texture.from_pixel(0.65, 0.6, 0.55, 1.0),  # floor
            Texture.from_pixel(0.75, 0.72, 0.68, 1.0),  # walls
            Texture.from_pixel(0.8, 0.78, 0.7, 1.0),  # columns
            Texture.from_pixel(0.55, 0.35, 0.2, 1.0),  # crates
        ]
    return flat, textures


def courtyard_textures() -> list[Texture]:
    """The textured courtyard's 14 distinct mixed-size image textures,
    round-tripped through real PNG bytes (see courtyard_scene docstring).
    Index layout: 0 floor; 1-4 walls; 5-8 columns; 9-13 crates."""
    return [
        # 0: floor — large stone checker
        _png_texture(_checker_rgb(512, (0.72, 0.66, 0.58), (0.5, 0.46, 0.42), 16)),
        # 1-4: walls — brick variants, mixed sizes/tints
        _png_texture(_brick_rgb(512, (0.78, 0.74, 0.7), (0.6, 0.57, 0.54))),
        _png_texture(_brick_rgb(256, (0.84, 0.82, 0.74), (0.7, 0.68, 0.6))),
        _png_texture(_brick_rgb(320, (0.75, 0.68, 0.62), (0.55, 0.5, 0.46))),
        _png_texture(_brick_rgb(192, (0.8, 0.72, 0.66), (0.62, 0.55, 0.5))),
        # 5-8: columns — marble-ish banded stone
        _png_texture(_marble_rgb(128, (0.85, 0.83, 0.78), (0.66, 0.64, 0.6), 0)),
        _png_texture(_marble_rgb(96, (0.82, 0.8, 0.78), (0.6, 0.58, 0.56), 1)),
        _png_texture(_marble_rgb(160, (0.88, 0.84, 0.76), (0.68, 0.64, 0.56), 2)),
        _png_texture(_marble_rgb(64, (0.8, 0.78, 0.72), (0.58, 0.56, 0.5), 3)),
        # 9-13: crates — wood-grain variants
        _png_texture(_wood_rgb(128, (0.6, 0.4, 0.22), (0.42, 0.26, 0.13), 0)),
        _png_texture(_wood_rgb(96, (0.55, 0.36, 0.2), (0.38, 0.24, 0.12), 1)),
        _png_texture(_wood_rgb(256, (0.64, 0.44, 0.26), (0.46, 0.3, 0.16), 2)),
        _png_texture(_wood_rgb(64, (0.5, 0.33, 0.18), (0.34, 0.21, 0.1), 3)),
        _png_texture(_checker_rgb(112, (0.6, 0.38, 0.2), (0.44, 0.27, 0.14), 8)),
    ]


def _png_texture(rgb: np.ndarray) -> "Texture":
    """(h, w, 3) float RGB -> PNG bytes -> Texture.from_memory: exercises the
    real image-decode path (stbi analog) instead of packing arrays directly."""
    u8 = np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return Texture.from_memory(encode_png(u8))


def _value_noise(size: int, cells: int, seed: int) -> np.ndarray:
    """Cheap tileable value noise in [0,1]: a random coarse grid bilinearly
    upsampled (wrap-around so fract-wrapped UVs don't seam)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(size=(cells, cells))
    y = np.linspace(0, cells, size, endpoint=False)
    x = np.linspace(0, cells, size, endpoint=False)
    yi, xi = np.floor(y).astype(int), np.floor(x).astype(int)
    yf, xf = (y - yi)[:, None], (x - xi)[None, :]
    c00 = coarse[np.ix_(yi % cells, xi % cells)]
    c10 = coarse[np.ix_((yi + 1) % cells, xi % cells)]
    c01 = coarse[np.ix_(yi % cells, (xi + 1) % cells)]
    c11 = coarse[np.ix_((yi + 1) % cells, (xi + 1) % cells)]
    return (
        c00 * (1 - yf) * (1 - xf)
        + c10 * yf * (1 - xf)
        + c01 * (1 - yf) * xf
        + c11 * yf * xf
    )


def _checker_rgb(size: int, a, b, cells: int) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    mask = ((yy * cells // size) + (xx * cells // size)) % 2
    rgb = np.where(mask[..., None] == 0, np.asarray(a), np.asarray(b))
    noise = 0.9 + 0.2 * _value_noise(size, 8, seed=size)
    return rgb * noise[..., None]


def _brick_rgb(size: int, brick, mortar) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    rows = yy * 8 // size
    xoff = (xx + (rows % 2) * (size // 8)) % size
    in_mortar = ((yy * 8 % size) < size // 16) | ((xoff * 4 % size) < size // 16)
    rgb = np.where(in_mortar[..., None], np.asarray(mortar), np.asarray(brick))
    noise = 0.88 + 0.24 * _value_noise(size, 16, seed=size + 1)
    return rgb * noise[..., None]


def _marble_rgb(size: int, light, dark, seed: int) -> np.ndarray:
    yy = np.arange(size)[:, None] / size
    warp = _value_noise(size, 4, seed=100 + seed)
    band = 0.5 + 0.5 * np.sin(2 * np.pi * (6 * yy + 1.5 * warp))
    rgb = np.asarray(light) * band[..., None] + np.asarray(dark) * (1 - band)[..., None]
    return rgb


def _wood_rgb(size: int, light, dark, seed: int) -> np.ndarray:
    xx = np.arange(size)[None, :] / size
    warp = _value_noise(size, 6, seed=200 + seed)
    grain = 0.5 + 0.5 * np.sin(2 * np.pi * (10 * xx + 2.0 * warp))
    rgb = np.asarray(light) * grain[..., None] + np.asarray(dark) * (1 - grain)[..., None]
    return rgb


def small_open_scene(seed: int = 0):
    """Build (FlattenedScene, [texture]) for the small open scene: a smooth
    blob of radius ~0.75 centred at (0, 0.8, 0), its surface displaced by a
    few seeded low-frequency waves, standing on a 2.4 x 2.4 ground tile at
    y = 0 (turned 0.3 rad about y). 4096 triangles, smooth per-vertex normals and one 256 x 256 PNG
    texture shared by both parts."""
    rng = np.random.default_rng(seed)
    n_lon, n_lat = 64, 32
    theta = np.linspace(0.0, np.pi, n_lat + 1)  # pole to pole
    phi = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)  # seam column repeated
    th, ph = np.meshgrid(theta, phi, indexing="ij")  # (n_lat+1, n_lon+1)
    radius = np.ones_like(th)
    for _ in range(4):
        a = rng.uniform(0.03, 0.08)
        n, m = rng.integers(1, 4), rng.integers(1, 5)
        radius += a * np.sin(n * th + rng.uniform(0, np.pi)) * np.cos(
            m * ph + rng.uniform(0, 2 * np.pi)
        )
    radius *= 0.75
    grid = np.stack(
        [radius * np.sin(th) * np.cos(ph), 0.8 + radius * np.cos(th),
         radius * np.sin(th) * np.sin(ph)],
        axis=-1,
    )
    grid[0, :] = grid[0, 0]  # single pole vertices
    grid[-1, :] = grid[-1, 0]
    grid[:, -1] = grid[:, 0]  # close the seam exactly
    uv_grid = np.stack(np.meshgrid(phi / (2 * np.pi), theta / np.pi, indexing="xy"), -1)

    # Vertex normals: area-weighted face normals accumulated per vertex.
    flat_idx = np.arange(grid.shape[0] * grid.shape[1]).reshape(grid.shape[:2])
    quads = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = flat_idx[i, j], flat_idx[i, j + 1]
            c, d = flat_idx[i + 1, j], flat_idx[i + 1, j + 1]
            # Counter-clockwise seen from outside: cross(e1, e2) points out.
            if i > 0:
                quads.append((a, b, c))
            if i < n_lat - 1:
                quads.append((b, d, c))
    corners = np.asarray(quads)
    verts = grid.reshape(-1, 3)
    face_n = np.cross(verts[corners[:, 1]] - verts[corners[:, 0]],
                      verts[corners[:, 2]] - verts[corners[:, 0]])
    # Identical positions (poles, seam) share one normal: key by position.
    _, key = np.unique(np.round(verts, 6), axis=0, return_inverse=True)
    key = key.reshape(-1)
    acc = np.zeros((key.max() + 1, 3))
    for k in range(3):
        np.add.at(acc, key[corners[:, k]], face_n)
    vn = acc[key] / np.linalg.norm(acc[key], axis=-1, keepdims=True)

    blob_pos = verts[corners]
    blob_nrm = vn[corners]
    blob_uv = uv_grid.reshape(-1, 2)[corners] * np.asarray([4.0, 2.0])

    ground = _subdivided_quad([-1.2, 0.0, -1.2], [0.0, 0.0, 2.4], [2.4, 0.0, 0.0], 8)
    ground_nrm = np.broadcast_to(np.asarray([0.0, 1.0, 0.0]), ground.shape)
    ground_uv = (ground[:, :, [0, 2]] + 1.2) / 2.4

    # Turn the scene about y so that no grid line of vertices lies in an
    # axis or diagonal plane: cameras on those planes would otherwise send
    # rays exactly along triangle edges.
    c, s = np.cos(0.3), np.sin(0.3)
    turn = np.asarray([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
    flat = FlattenedScene(
        positions=(np.concatenate([blob_pos, ground]) @ turn).astype(np.float32),
        normals=(np.concatenate([blob_nrm, ground_nrm]) @ turn).astype(np.float32),
        tex_coords=np.concatenate([blob_uv, ground_uv]).astype(np.float32),
        texture_indices=np.zeros(blob_pos.shape[0] + ground.shape[0], np.uint32),
    )
    spots = _value_noise(256, 8, seed=seed + 300)
    grain = _value_noise(256, 32, seed=seed + 301)
    base = np.asarray([0.9, 0.72, 0.18]) * (0.75 + 0.25 * grain)[..., None]
    dark = np.asarray([0.35, 0.22, 0.1])
    rgb = np.where((spots > 0.62)[..., None], dark, base)
    return flat, [_png_texture(rgb)]


def write_small_open_glb(path, seed: int = 0):
    """Write small_open_scene(seed) as a GLB at `path`; returns the path."""
    from ..tools.export_glb import export_flattened_glb

    flat, textures = small_open_scene(seed)
    export_flattened_glb(flat, textures, path)
    return path

