"""Multi-chip rendering: tile x sample parallelism over a device mesh.

The reference is strictly single-GPU (SURVEY.md §2.9); this module is the new
multi-chip design: a 2D `jax.sharding.Mesh` with

* a **tiles** axis — pixels are sharded across devices (data parallelism over
  the framebuffer; zero communication), and
* a **samples** axis — each device traces a subset of the frame's samples for
  its pixel shard and the partial radiances are summed with a `psum`
  (sample parallelism; one small all-reduce per step).

The scene, sky state, camera, and blue-noise tile are replicated; the
accumulation buffer lives sharded over tiles. Physics matches the single-chip
progressive loop exactly: sample s of pixel p uses the same animated blue
noise regardless of which device traces it.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..render.camera import Camera, generate_camera_ray_lens
from ..render.pathtracer import DEFAULT_ENGINE, trace_radiance
from ..render.rng import animated_blue_noise
from ..render.scene import DeviceScene
from ..sky.model import SkyState


def make_render_mesh(devices=None, sample_parallel: int | None = None) -> Mesh:
    """Build a (tiles, samples) mesh over the given devices.

    sample_parallel defaults to 2 when the device count is even, else 1."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if sample_parallel is None:
        sample_parallel = 2 if n % 2 == 0 and n > 1 else 1
    assert n % sample_parallel == 0
    tiles = n // sample_parallel
    mesh_devices = np.asarray(devices).reshape(tiles, sample_parallel)
    return Mesh(mesh_devices, axis_names=("tiles", "samples"))


@partial(
    jax.jit,
    static_argnames=("mesh", "width", "height", "num_bounces", "spp", "engine"),
    donate_argnums=(5,),
)
def render_step_sharded(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    blue_noise_tile,
    frame_base,
    accum,
    *,
    mesh: Mesh,
    width: int,
    height: int,
    num_bounces: int,
    spp: int,
    engine: str = DEFAULT_ENGINE,
):
    """One sharded progressive step: adds `samples_axis` samples per pixel.

    accum: (P_padded, 3) sharded over the mesh's tiles axis (P_padded is
    width*height rounded up to a tiles-axis multiple). frame_base: the frame
    counter of the first sample this step traces.
    """
    tiles = mesh.shape["tiles"]
    samples_axis = mesh.shape["samples"]

    ys, xs = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.int32),
        jnp.arange(width, dtype=jnp.int32),
        indexing="ij",
    )
    pad = accum.shape[0] - width * height
    ys = jnp.pad(ys.reshape(-1), (0, pad))
    xs = jnp.pad(xs.reshape(-1), (0, pad))

    def local_step(accum_shard, ys_shard, xs_shard):
        sample_rank = jax.lax.axis_index("samples")
        frame_idx = frame_base + sample_rank

        noise = animated_blue_noise(
            ys_shard, xs_shard, frame_idx, jnp.int32(spp), tile=blue_noise_tile
        )
        u = (xs_shard.astype(jnp.float32) + 0.5) / jnp.float32(width)
        v_tex = (ys_shard.astype(jnp.float32) + 0.5) / jnp.float32(height)
        jitter = noise / jnp.asarray([width, height], jnp.float32)
        ray_u = u + jitter[:, 0]
        ray_v = (jnp.float32(1.0) - v_tex) + jitter[:, 1]

        origin, direction = generate_camera_ray_lens(camera, noise, ray_u, ray_v)
        radiance = trace_radiance(
            scene, sky, origin, direction, noise, num_bounces, engine
        )
        # Sum this step's samples over the samples axis (all-reduce).
        total = jax.lax.psum(radiance, "samples")
        return accum_shard + total

    return jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("tiles"), P("tiles"), P("tiles")),
        out_specs=P("tiles"),
    )(accum, ys, xs)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "width", "height", "num_bounces", "spp", "num_frames",
        "engine",
    ),
    donate_argnums=(5,),
)
def render_step_sharded_regen(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    blue_noise_tile,
    frame_base,
    accum,
    *,
    mesh: Mesh,
    width: int,
    height: int,
    num_bounces: int,
    spp: int,
    num_frames: int,
    engine: str = DEFAULT_ENGINE,
):
    """Sharded persistent-wavefront step: every device runs the SAME regen
    pipeline as a single device (render/pathtracer.accumulate_lanes_regen —
    path regeneration and phased compaction) over its pixel shard, tracing
    num_frames/samples_axis consecutive samples; the samples axis then psums
    partial radiance.

    Pixels ride in BLOCK-MAJOR order (render/tiling.block_order) so each
    shard holds whole 32x16 pixel blocks and ray coherence survives
    sharding; unswizzle once at image assembly. accum: (P_padded, 3)
    block-ordered, sharded over tiles.

    Per-pixel f32 grouping: each device's partial starts from zero and the
    psum adds device partials in a fixed order, so multi-chip sums can
    differ from single-chip by the usual f32 regrouping ulps (the same
    budget the compacted phases already carry)."""
    from ..render.tiling import block_order

    samples_axis = mesh.shape["samples"]
    assert num_frames % samples_axis == 0
    nf_local = num_frames // samples_axis

    ys_np, xs_np, _ = block_order(width, height)
    ys = jnp.asarray(ys_np)
    xs = jnp.asarray(xs_np)
    pad = accum.shape[0] - width * height
    ys = jnp.pad(ys, (0, pad))
    xs = jnp.pad(xs, (0, pad))
    u_full = (xs.astype(jnp.float32) + 0.5) / jnp.float32(width)
    v_full = (ys.astype(jnp.float32) + 0.5) / jnp.float32(height)
    th, tw = blue_noise_tile.shape[0], blue_noise_tile.shape[1]
    nb_full = blue_noise_tile[ys % th, xs % tw]
    inv_dims = jnp.float32(1.0) / jnp.asarray([width, height], jnp.float32)

    from ..render.pathtracer import accumulate_lanes_regen

    def local_step(accum_shard, u_shard, v_shard, nb_shard):
        sample_rank = jax.lax.axis_index("samples")
        local_base = frame_base + sample_rank * nf_local
        partial_r = accumulate_lanes_regen(
            scene, sky, camera, local_base,
            jnp.zeros_like(accum_shard), u_shard, v_shard, nb_shard,
            inv_dims, num_bounces=num_bounces, spp=spp,
            num_frames=nf_local, engine=engine,
        )
        return accum_shard + jax.lax.psum(partial_r, "samples")

    return jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("tiles"), P("tiles"), P("tiles"), P("tiles")),
        out_specs=P("tiles"),
    )(accum, u_full, v_full, nb_full)


def render_image_sharded_regen(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    *,
    mesh: Mesh,
    width: int,
    height: int,
    spp: int,
    num_bounces: int,
    exposure: float = 1.0,
    engine: str = DEFAULT_ENGINE,
    samples_per_dispatch: int | None = None,
) -> np.ndarray:
    """Full sharded render on the FAST path: each step runs the regen
    pipeline per device (render_step_sharded_regen). Returns (H, W, 3)."""
    from ..render.rng import blue_noise_tile
    from ..render.tiling import unswizzle
    from ..render.tonemap import tonemap

    tiles = mesh.shape["tiles"]
    samples_axis = mesh.shape["samples"]
    spd = samples_per_dispatch or spp
    spd = max(samples_axis, (spd // samples_axis) * samples_axis)
    assert spp % samples_axis == 0

    num_pixels = width * height
    padded = -(-num_pixels // tiles) * tiles
    accum = jnp.zeros((padded, 3), jnp.float32)
    tile = jnp.asarray(blue_noise_tile())

    frame_base = 0
    while frame_base < spp:
        batch = min(spd, spp - frame_base)
        accum = render_step_sharded_regen(
            scene, sky, camera, tile, jnp.int32(frame_base), accum,
            mesh=mesh, width=width, height=height, num_bounces=num_bounces,
            spp=spp, num_frames=batch, engine=engine,
        )
        frame_base += batch
    estimator = unswizzle(accum[:num_pixels], width, height) / jnp.float32(spp)
    img = tonemap(estimator, exposure)
    return np.asarray(img).reshape(height, width, 3)


def render_image_sharded(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    *,
    mesh: Mesh,
    width: int,
    height: int,
    spp: int,
    num_bounces: int,
    exposure: float = 1.0,
    engine: str = DEFAULT_ENGINE,
) -> np.ndarray:
    """Full sharded render: progressive steps of `samples_axis` samples,
    running-mean estimator, ACES tonemap. Returns (H, W, 3) float32."""
    from ..render.rng import blue_noise_tile
    from ..render.tonemap import tonemap

    tiles = mesh.shape["tiles"]
    samples_axis = mesh.shape["samples"]
    assert spp % samples_axis == 0, "spp must divide the samples axis"

    num_pixels = width * height
    padded = -(-num_pixels // tiles) * tiles
    accum = jnp.zeros((padded, 3), jnp.float32)
    tile = jnp.asarray(blue_noise_tile())

    for frame_base in range(0, spp, samples_axis):
        accum = render_step_sharded(
            scene,
            sky,
            camera,
            tile,
            jnp.int32(frame_base),
            accum,
            mesh=mesh,
            width=width,
            height=height,
            num_bounces=num_bounces,
            spp=spp,
            engine=engine,
        )
    estimator = accum[:num_pixels] / jnp.float32(spp)
    img = tonemap(estimator, exposure)
    return np.asarray(img).reshape(height, width, 3)
