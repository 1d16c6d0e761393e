"""Hybrid deferred renderer: ray-traced G-buffer + 2-bounce lighting + TAA.

The reference's DeferredRenderer (src/pt/deferred_renderer.{hpp,cpp}) rasters
a G-buffer, ray-traces lighting in a compute pass, and resolves with an
exponential temporal blend. Here the G-buffer pass is emulated with one
primary-ray traversal per pixel — producing the same
per-pixel surface data the raster pass would — while the lighting and resolve
passes match the reference exactly:

* **G-buffer** (deferred_renderer_gbuffer_pass.wgsl): per-frame R2 sub-pixel
  jitter shared by all pixels (deferred_renderer.cpp:309-315); stores linear
  albedo quantized to 8 bits (the reference's BGRA8Unorm target), the
  barycentric-interpolated vertex normal, the world-space position, and a hit
  mask (the reference's reverse-Z depth==0 test).
* **Lighting** (deferred_renderer_lighting_pass.wgsl:96-236): miss → sky
  radiance WITH the solar disk; hit → NEE light sample + a fixed 2-bounce
  Lambertian path using animatedBlueNoise(coord, frameCount, 1<<20) and the
  lighting pass's own ray-offset constants (INT_SCALE=1024,
  FLOAT_SCALE=1/16384).
* **Resolve** (deferred_renderer_resolve_pass.wgsl:41-63): frame 0 copies,
  later frames blend 0.1*current + 0.9*accumulated, then ACES + gamma.
* **Debug** (deferred_renderer_debug_pass.wgsl:25-42): albedo / encoded
  normal / depth triptych split at x = 1/3, 2/3.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..sky.model import SkyState, sky_radiance
from .camera import Camera, generate_camera_ray
from .intersect import T_MAX, offset_ray
from .pathtracer import (
    DEFAULT_ENGINE,
    FRAC_1_PI,
    SOLAR_COS_THETA_MAX,
    SOLAR_INV_PDF,
    _surface_interaction,
)
from .rng import animated_blue_noise
from .sampling import sample_cosine_hemisphere, sample_solar_disk_direction
from .scene import DeviceScene
from .texture_eval import eval_texture
from .tonemap import tonemap

# deferred_renderer_lighting_pass.wgsl:500-502
_DEFERRED_INT_SCALE = 1024.0
_DEFERRED_FLOAT_SCALE = 1.0 / 16384.0
_NOISE_PERIOD = 1 << 20  # animatedBlueNoise period in the deferred path


def _closest(scene, o, d, engine):
    from .pathtracer import get_engine

    hit, t, tri, _ = get_engine(engine)[0](scene, o, d, T_MAX)
    return hit, t, tri


def _any(scene, o, d, engine):
    from .pathtracer import get_engine

    return get_engine(engine)[1](scene, o, d, T_MAX)


@partial(jax.jit, static_argnames=("width", "height", "engine"))
def gbuffer_pass(
    scene: DeviceScene,
    camera: Camera,
    frame_count,
    *,
    width: int,
    height: int,
    engine: str = DEFAULT_ENGINE,
):
    """Primary-ray G-buffer. Returns dict of flat (H*W, ...) planes."""
    ys, xs = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.int32),
        jnp.arange(width, dtype=jnp.int32),
        indexing="ij",
    )
    ys = ys.reshape(-1)
    xs = xs.reshape(-1)

    # Per-frame sub-pixel jitter, identical for all pixels
    # (deferred_renderer.cpp:309-315, r_sequence.hpp:11-22).
    n = jnp.asarray(frame_count % _NOISE_PERIOD, jnp.float32)
    a1 = jnp.float32(1.0 / 1.32471795)
    a2 = jnp.float32(1.0 / (1.32471795**2))
    jx = (0.5 + a1 * n) % 1.0
    jy = (0.5 + a2 * n) % 1.0

    u = (xs.astype(jnp.float32) + 0.5 + (jx - 0.5)) / jnp.float32(width)
    v = jnp.float32(1.0) - (ys.astype(jnp.float32) + 0.5 + (jy - 0.5)) / jnp.float32(height)
    origin, direction = generate_camera_ray(camera, u, v)

    hit, t, tri = _closest(scene, origin, direction, engine)
    tri_safe = jnp.maximum(tri, 0)
    _, normal, uv, tex, _ = _surface_interaction(scene, origin, direction, tri_safe)
    albedo = eval_texture(scene, tex, uv)
    # BGRA8Unorm quantization of the linear albedo (gbuffer stores 8-bit).
    albedo = jnp.round(albedo * 255.0) / jnp.float32(255.0)

    # Exact hit position (not mantissa-offset): the reference reconstructs
    # world position from depth, then applies the lighting pass's own offset.
    position = origin + t[:, None] * direction

    zero3 = jnp.zeros_like(position)
    return dict(
        hit=hit,
        position=jnp.where(hit[:, None], position, zero3),
        normal=jnp.where(hit[:, None], normal, zero3),
        albedo=jnp.where(hit[:, None], albedo, zero3),
        depth=jnp.where(hit, t, jnp.float32(0.0)),  # 0 = miss, like reverse-Z
        view_dir=direction,
    )


@partial(jax.jit, static_argnames=("width", "height", "engine"))
def lighting_pass(
    scene: DeviceScene,
    sky: SkyState,
    gbuffer: dict,
    frame_count,
    *,
    width: int,
    height: int,
    engine: str = DEFAULT_ENGINE,
):
    """2-bounce lighting from the G-buffer (lighting_pass.wgsl:96-236).
    Returns (H*W, 3) radiance samples."""
    ys, xs = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.int32),
        jnp.arange(width, dtype=jnp.int32),
        indexing="ij",
    )
    noise = animated_blue_noise(
        ys.reshape(-1), xs.reshape(-1), frame_count, jnp.int32(_NOISE_PERIOD)
    )

    hit = gbuffer["hit"]
    sun_dir = jnp.asarray(sky.sun_direction)
    solar = jnp.asarray(sky.solar_radiances)

    # Miss: sky WITH the solar disk (lighting_pass.wgsl:107-118).
    v = gbuffer["view_dir"]
    theta = jnp.arccos(jnp.clip(v[:, 1], -1.0, 1.0))
    gamma = jnp.arccos(jnp.clip(jnp.sum(v * sun_dir, axis=-1), -1.0, 1.0))
    sky_rgb = sky_radiance(sky, theta, gamma)

    # Hit: offset position with the deferred constants, then NEE + 1 scatter.
    position = offset_ray(
        gbuffer["position"], gbuffer["normal"], _DEFERRED_INT_SCALE, _DEFERRED_FLOAT_SCALE
    )
    normal = gbuffer["normal"]
    albedo = gbuffer["albedo"]

    def light_sample(pos, nrm, alb):
        light_dir = sample_solar_disk_direction(noise, SOLAR_COS_THETA_MAX, sun_dir)
        cos_term = jnp.sum(nrm * light_dir, axis=-1, keepdims=True)
        occluded = _any(scene, pos, jnp.broadcast_to(light_dir, pos.shape), engine)
        vis = jnp.where(occluded, 0.0, 1.0)[:, None]
        return solar * (alb * FRAC_1_PI) * cos_term * vis * SOLAR_INV_PDF

    radiance = light_sample(position, normal, albedo)
    throughput = albedo  # applied before the single indirect bounce

    # Bounce 1 of NUM_BOUNCES=2 (lighting_pass.wgsl:154-185).
    wi = sample_cosine_hemisphere(noise, normal)
    b_hit, _, b_tri = _closest(scene, position, wi, engine)
    b_tri_safe = jnp.maximum(b_tri, 0)
    b_pos, b_nrm, b_uv, b_tex, _ = _surface_interaction(scene, position, wi, b_tri_safe)
    # The bounce surface uses the PT offset constants via Intersection.p
    # (rayIntersectTriangle applies offsetRay inside, wgsl:285-521).
    b_alb = eval_texture(scene, b_tex, b_uv)

    b_theta = jnp.arccos(jnp.clip(wi[:, 1], -1.0, 1.0))
    b_gamma = jnp.arccos(jnp.clip(jnp.sum(wi * sun_dir, axis=-1), -1.0, 1.0))
    b_sky = sky_radiance(sky, b_theta, b_gamma)

    indirect_hit = throughput * light_sample(b_pos, b_nrm, b_alb)
    indirect_miss = throughput * b_sky
    radiance = radiance + jnp.where(b_hit[:, None], indirect_hit, indirect_miss)

    return jnp.where(hit[:, None], radiance, sky_rgb)


@jax.jit
def resolve_pass(sample, accum, frame_count, exposure):
    """Temporal exponential blend + tonemap (resolve_pass.wgsl:34-63).
    Returns (new_accum, display_image_u8).

    The display image leaves the device as u8 — the reference's swapchain
    target is BGRA8Unorm (deferred_renderer.cpp surface config), so 8-bit
    is the contract, and the frame fetch moves a quarter of the f32
    bytes."""
    blended = jnp.where(
        frame_count == 0, sample, 0.1 * sample + 0.9 * accum
    )
    img = tonemap(blended, exposure)
    img8 = jnp.clip(jnp.round(img * 255.0), 0.0, 255.0).astype(jnp.uint8)
    return blended, img8


@partial(jax.jit, static_argnames=("width", "height", "engine"))
def frame_pass(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    accum,
    frame_count,
    exposure,
    *,
    width: int,
    height: int,
    engine: str = DEFAULT_ENGINE,
):
    """One fused deferred frame: gbuffer -> lighting -> resolve in a single
    jit, one dispatch per frame; the passes remain available unfused for the
    debug view and tests."""
    gbuf = gbuffer_pass(scene, camera, frame_count, width=width,
                        height=height, engine=engine)
    sample = lighting_pass(scene, sky, gbuf, frame_count, width=width,
                           height=height, engine=engine)
    return resolve_pass(sample, accum, frame_count, exposure)


class DeferredRenderer:
    """Stateful frame-loop wrapper (parity with DeferredRenderer's public
    API: render, renderDebug, resize, invalidateTemporalAccumulation —
    deferred_renderer.hpp:73-75, deferred_renderer.cpp:2055-2060)."""

    def __init__(self, scene: DeviceScene, width: int, height: int, engine: str = DEFAULT_ENGINE):
        import collections

        self.scene = scene
        self.width = width
        self.height = height
        self.engine = engine
        self.frame_count = 0
        self.accum = jnp.zeros((height * width, 3), jnp.float32)
        # 30-frame rolling durations (deferred_renderer.cpp:2031-2053).
        # The fused frame records under "frame"; the per-pass keys remain
        # for the unfused/debug paths.
        self._pass_durations = {
            name: collections.deque(maxlen=30)
            for name in ("gbuffer", "lighting", "resolve", "frame")
        }

    def resize(self, width: int, height: int) -> None:
        self.width = width
        self.height = height
        self.invalidate_temporal_accumulation()

    def invalidate_temporal_accumulation(self) -> None:
        self.frame_count = 0
        self.accum = jnp.zeros((self.height * self.width, 3), jnp.float32)

    def render(self, camera: Camera, sky: SkyState, exposure: float = 1.0) -> np.ndarray:
        import time

        fc = jnp.int32(self.frame_count)
        t0 = time.time()
        # One fused dispatch (frame_pass); under async dispatch the
        # per-pass wall-clock split was meaningless anyway (all cost
        # pooled at the fetch), so the rolling stats record the honest
        # whole-frame time under every key the reference's panel shows,
        # plus "frame".
        self.accum, img8 = frame_pass(
            self.scene, sky, camera, self.accum, fc, jnp.float32(exposure),
            width=self.width, height=self.height, engine=self.engine,
        )
        out = (np.asarray(img8).reshape(self.height, self.width, 3)
               .astype(np.float32) / np.float32(255.0))
        dt = time.time() - t0
        self._pass_durations["frame"].append(dt)
        self.frame_count += 1
        return out

    def perf_stats(self) -> dict:
        """30-frame rolling average per-pass durations in ms
        (DeferredRenderer::getPerfStats, deferred_renderer.cpp:2031-2053)."""
        return {
            name: (1000.0 * sum(d) / len(d) if d else 0.0)
            for name, d in self._pass_durations.items()
        }

    def render_debug(self, camera: Camera) -> np.ndarray:
        """G-buffer triptych: albedo | encoded normal | depth
        (debug_pass.wgsl:25-42)."""
        gbuf = gbuffer_pass(
            self.scene,
            camera,
            jnp.int32(self.frame_count),
            width=self.width,
            height=self.height,
            engine=self.engine,
        )
        albedo = np.asarray(gbuf["albedo"]).reshape(self.height, self.width, 3)
        normal = 0.5 * np.asarray(gbuf["normal"]).reshape(self.height, self.width, 3) + 0.5
        depth = np.asarray(gbuf["depth"]).reshape(self.height, self.width)
        a = 0.1
        depth_vis = (1.0 + a) * depth / (depth + a)
        depth_rgb = np.repeat(depth_vis[..., None], 3, axis=-1)

        img = np.zeros((self.height, self.width, 3), np.float32)
        third = self.width // 3
        img[:, :third] = albedo[:, :third]
        img[:, third : 2 * third] = normal[:, third : 2 * third]
        img[:, 2 * third :] = depth_rgb[:, 2 * third :]
        return np.clip(img ** (1.0 / 2.2), 0.0, 1.0)
