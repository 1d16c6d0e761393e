"""Many-texture atlas at Sponza scale: mixed-size image textures packed into
one texel buffer must address correctly (offset + v*w + u addressing over 14
distinct offsets), and the atlas must enforce the reference's 256MiB packed-
buffer budget (reference_path_tracer.cpp:253-263)."""

import numpy as np
import jax.numpy as jnp
import pytest

from rayfinder_tpu.render.scene import MAX_TEXEL_BYTES, build_device_scene
from rayfinder_tpu.render.texture_eval import eval_texture
from rayfinder_tpu.scene.flatten import FlattenedScene
from rayfinder_tpu.scene.procedural import courtyard_scene, courtyard_textures
from rayfinder_tpu.scene.texture import Texture


def _tiny_scene(num_textures: int) -> FlattenedScene:
    tris = np.asarray(
        [[[0, 0, 0], [1, 0, 0], [0, 1, 0]]] * num_textures, np.float32
    )
    n = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (num_textures, 3, 1))
    uv = np.zeros((num_textures, 3, 2), np.float32)
    return FlattenedScene(
        positions=tris,
        normals=n,
        tex_coords=uv,
        texture_indices=np.arange(num_textures, dtype=np.uint32),
    )


def test_multi_image_atlas_addresses_exactly():
    """14 mixed-size PNG-decoded textures in one atlas: eval_texture must
    return the exact texel a per-image numpy lookup does, for random
    (texture, uv) pairs incl. wrap-around UVs and the u==1.0 edge clamp."""
    textures = courtyard_textures()
    assert len(textures) >= 12
    sizes = {(t.width, t.height) for t in textures}
    assert len(sizes) >= 6, "mixed sizes required to catch offset bugs"

    scene = build_device_scene(_tiny_scene(len(textures)), textures=textures)

    rng = np.random.default_rng(7)
    n = 4096
    tex_idx = rng.integers(0, len(textures), size=n).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, size=(n, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [1, 1], [0.999999, 0.999999], [1e-7, 1e-7],
              [-1, -1], [2, 2], [0.5, 1], [1, 0.5]]

    got = np.asarray(eval_texture(scene, jnp.asarray(tex_idx), jnp.asarray(uv)))

    want = np.empty((n, 3), np.float32)
    for lane in range(n):
        t = textures[tex_idx[lane]]
        u, v = uv[lane] - np.floor(uv[lane])
        j = min(int(np.float32(u) * np.float32(t.width)), t.width - 1)
        i = min(int(np.float32(v) * np.float32(t.height)), t.height - 1)
        rgba = t.to_rgba()[i, j, :3].astype(np.float32) / 255.0
        want[lane] = rgba**2.2
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_atlas_limit_enforced():
    """Reference parity: packing past 256MiB of texels must refuse loudly."""
    # 3 * 150MiB-worth of 1x1 rows faked via a wide texture: use modest
    # real buffers instead — a (8192 x 8192) texture is 256MiB exactly.
    big = Texture(
        pixels=np.zeros(8192 * 8192, np.uint32), width=8192, height=8192
    )
    ok = build_device_scene(_tiny_scene(1), textures=[big])
    assert int(np.asarray(ok.tex_desc)[0, 0]) == 8192

    over = Texture(pixels=np.zeros(8192 * 8192, np.uint32), width=8192, height=8192)
    one = Texture.from_pixel(1.0, 1.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="exceeds"):
        build_device_scene(_tiny_scene(2), textures=[over, one])
    assert MAX_TEXEL_BYTES == 256 * 1024 * 1024


def test_textured_courtyard_engines_agree():
    """The multi-texture courtyard through the full path tracer: the walk
    engine's render, and so its texture gathers over all 14 atlas offsets,
    must agree with the XLA wavefront engine's."""
    from rayfinder_tpu.render.camera import create_camera
    from rayfinder_tpu.render.pathtracer import accumulate_samples_regen
    from rayfinder_tpu.render.rng import blue_noise_tile
    from rayfinder_tpu.sky.model import sky_state_from_ui

    flat, textures = courtyard_scene(4, textured=True)
    scene = build_device_scene(flat, textures=textures)

    w, h, spp = 32, 24, 2
    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, w / h)
    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    tile = jnp.asarray(blue_noise_tile())
    kw = dict(width=w, height=h, num_bounces=3, spp=spp, num_frames=spp)

    wave = accumulate_samples_regen(
        scene, sky, cam, tile, jnp.int32(0),
        jnp.zeros((w * h, 3), jnp.float32), engine="wavefront", **kw,
    )
    walk = accumulate_samples_regen(
        scene, sky, cam, tile, jnp.int32(0),
        jnp.zeros((w * h, 3), jnp.float32), engine="walk", **kw,
    )
    np.testing.assert_allclose(
        np.asarray(walk), np.asarray(wave), rtol=2e-4, atol=1e-5
    )
