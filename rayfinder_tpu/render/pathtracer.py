"""Wavefront path tracer: a rebuild of the reference's WGSL megakernel
`rayColor` (src/pt/reference_path_tracer.wgsl:180-234) over ray batches.

Per sample and pixel, with a single 2D blue-noise value reused for every
sampling decision that frame (exactly like the reference):

  primary ray (thin lens) → for each bounce:
    closest hit → albedo lookup → next-event estimation against the solar
    disk (cone sample, Lambertian brdf, shadow ray, constant solar radiance,
    inverse cone PDF) → cosine-weighted scatter;
  miss → analytic Hosek-Wilkie sky radiance (sun NOT added here; it only
  contributes via NEE) and terminate.

The bounce loop is a masked loop over SoA ray batches — rays that have
terminated carry a dead mask instead of diverging. Traversal is delegated to
an engine (get_engine); everything else is plain jnp that XLA fuses.
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..sky.model import SkyState, sky_radiance_dist
from .camera import Camera, generate_camera_ray_lens
from .intersect import T_MAX, offset_ray, ray_triangle
from .sampling import sample_cosine_hemisphere, sample_solar_disk_direction
from .scene import DeviceScene
from .texture_eval import eval_texture
from .traverse import intersect_any, intersect_closest

# wgsl:79-83
TERRESTRIAL_SOLAR_RADIUS = np.float32(0.255 * np.pi / 180.0)
SOLAR_COS_THETA_MAX = np.float32(np.cos(TERRESTRIAL_SOLAR_RADIUS))
SOLAR_INV_PDF = np.float32(2.0 * np.pi * (1.0 - SOLAR_COS_THETA_MAX))

FRAC_1_PI = np.float32(1.0 / np.pi)

# Traversal engines: "walk" = per-ray native BVH walk (ops/walk.py, CUDA on
# the GPU), "wavefront" = plain-XLA cluster walk (render/wavefront.py),
# "reference" = lockstep per-ray stack oracle (render/traverse.py).
ENGINES = ("walk", "wavefront", "reference")
DEFAULT_ENGINE = "walk"

# Scenes with more clusters than this re-sort bounce rays for coherence
# (see trace_radiance); env-overridable for tuning scans.
SORT_THRESHOLD = int(os.environ.get("RAYFINDER_SORT_THRESHOLD", "256"))
# Position bits per axis in the bounce-coherence sort key.
_SORT_BITS = int(os.environ.get("RAYFINDER_SORT_BITS", "5"))
# Regen compaction (accumulate_samples_regen): when the live-lane count falls
# below 1/DIV of the current batch, the busy lanes are compacted into a batch
# 1/DIV the size (repeatedly, down to FLOOR lanes). Without it the loop's
# deep-bounce tail runs at full width with few live lanes.
_COMPACT_DIV = int(os.environ.get("RAYFINDER_COMPACT_DIV", "10"))
_COMPACT_FLOOR = int(os.environ.get("RAYFINDER_COMPACT_FLOOR", "4096"))


def _phase_sizes(batch: int, floor: int) -> list[int]:
    """Regen phase lane counts: [batch, batch/DIV, ...] down to `floor`.
    Sizes are rounded up to a 2048-lane granularity (small floors — tests —
    shrink the granularity so multiple levels still exist).

    RAYFINDER_PHASES overrides the tail with an explicit comma-separated
    descending width list (perf experiments)."""
    override = os.environ.get("RAYFINDER_PHASES")
    if override:
        widths = [int(w) for w in override.replace(" ", "").split(",") if w]
        widths = [w for w in widths if 0 < w < batch]
        return [batch] + sorted(set(widths), reverse=True)
    gran = min(2048, max(floor, 16))
    cap = max(floor, -(-batch // _COMPACT_DIV // gran) * gran)
    if cap >= batch:
        return [batch]
    # Tail ladder below the first capture: divide the capture by 2/6/12, so
    # the phase width keeps tracking the live count as it decays.
    sizes = [batch, cap]
    for div in (2, 6, 12):
        nxt = max(floor, -(-cap // div // gran) * gran)
        if nxt >= sizes[-1]:
            continue
        sizes.append(nxt)
        if nxt <= floor:
            break
    return sizes


class SamplingParams(NamedTuple):
    """reference_path_tracer.hpp:26-32 defaults."""

    num_samples_per_pixel: int = 128
    num_bounces: int = 4


def get_engine(engine: str):
    """Resolve a traversal engine name (ENGINES) to (closest, any_hit).

    closest(scene, o, d, t_max) -> (hit, t, tri_idx, extra);
    any_hit(scene, o, d, t_max) -> occluded.
    """
    if engine == "walk":
        from ..ops.walk import walk_any, walk_closest

        def closest(s, o, d, tm):
            hit, t, tri = walk_closest(s, o, d, tm)
            return hit, t, tri, None

        return closest, walk_any

    if engine == "wavefront":
        from .wavefront import intersect_any_wavefront, intersect_closest_wavefront

        def closest(s, o, d, tm):
            hit, t, tri, _ = intersect_closest_wavefront(s, o, d, tm)
            return hit, t, tri, None

        def any_hit(s, o, d, tm):
            occ, _ = intersect_any_wavefront(s, o, d, tm)
            return occ

        return closest, any_hit

    if engine == "reference":
        return intersect_closest, intersect_any

    raise ValueError(f"unknown traversal engine: {engine!r} (expected one of {ENGINES})")


def _surface_interaction(scene: DeviceScene, origin, direction, tri_idx):
    """Recover the reference's Intersection data for known hit triangles:
    offset hit point (geometric normal), interpolated shading normal, UV and
    texture index (wgsl:383-401, 477-521).

    One (B, 25) row gather from the packed attribute table instead of four
    small gathers; consumers slice it as flat (B, k) column windows."""
    attrs = scene.tri_attrs[tri_idx]  # (B, 25)
    v0 = attrs[:, 0:3]
    v1 = attrs[:, 3:6]
    v2 = attrs[:, 6:9]
    _, t, u, v = ray_triangle(origin, direction, v0, v1, v2, jnp.float32(np.inf))

    e1 = v1 - v0
    e2 = v2 - v0
    b1 = u[:, None]
    b2 = v[:, None]
    p = v0 + b1 * e1 + b2 * e2
    geo_n = jnp.cross(e1, e2)
    geo_n = geo_n / jnp.linalg.norm(geo_n, axis=-1, keepdims=True)
    p_offset = offset_ray(p, geo_n)

    b0 = jnp.float32(1.0) - b1 - b2
    # Interpolated shading normal; NOT renormalized, matching wgsl:396.
    n = b0 * attrs[:, 9:12] + b1 * attrs[:, 12:15] + b2 * attrs[:, 15:18]
    uv = b0 * attrs[:, 18:20] + b1 * attrs[:, 20:22] + b2 * attrs[:, 22:24]
    tex = jax.lax.bitcast_convert_type(attrs[:, 24], jnp.int32)
    return p_offset, n, uv, tex, t


@partial(jax.jit, static_argnames=("num_bounces", "engine", "decorrelate"))
def trace_radiance(
    scene: DeviceScene,
    sky: SkyState,
    origin,
    direction,
    noise,
    num_bounces: int,
    engine: str = DEFAULT_ENGINE,
    decorrelate: bool = False,
):
    """Radiance for a batch of primary rays (rayColor, wgsl:180-234).

    origin/direction: (B, 3); noise: (B, 2) reused across all decisions —
    exactly like the reference, which samples one blue-noise value per pixel
    per frame (wgsl:52). decorrelate=True rotates the noise by a per-bounce
    R2 offset instead (lower sample correlation at the cost of exact parity).
    engine: one of ENGINES (see get_engine).
    Returns (B, 3) float32 radiance.
    """
    closest, any_hit = get_engine(engine)

    batch = origin.shape[0]
    radiance = jnp.zeros((batch, 3), jnp.float32)
    throughput = jnp.ones((batch, 3), jnp.float32)
    alive = jnp.ones((batch,), jnp.bool_)

    sun_dir = jnp.asarray(sky.sun_direction)
    solar_radiance = jnp.asarray(sky.solar_radiances)

    # Terminated lanes get parked far outside the scene, where every engine
    # rejects them at the root, instead of re-tracing dead rays each bounce.
    park = jnp.asarray([1e30, 1e30, 1e30], jnp.float32)
    base_noise = noise

    # Bounce rays scatter in all directions, so neighbouring lanes stop
    # tracing neighbouring rays. Big scenes re-sort lanes each bounce by
    # (direction octant, quantized position) to restore coherence; `pixel_of`
    # tracks the inverse so per-pixel radiance is exactly unchanged. Small
    # scenes (cluster count is a static shape) skip the sort, whose cost
    # outweighs the gain when the whole scene is a few clusters.
    sort_bounces = num_bounces > 1 and scene.cluster_tris.shape[0] > SORT_THRESHOLD
    pixel_of = jnp.arange(batch, dtype=jnp.int32)
    # Quantization frame of the sort key: the scene's triangle bounds.
    scene_lo = jnp.min(scene.tri_positions, axis=(0, 1))
    scene_inv = jnp.float32(1023.0) / jnp.maximum(
        jnp.max(scene.tri_positions, axis=(0, 1)) - scene_lo, 1e-6
    )

    def _coherence_key(o, d, live):
        octant = (
            (d[:, 0] < 0).astype(jnp.int32)
            + 2 * (d[:, 1] < 0).astype(jnp.int32)
            + 4 * (d[:, 2] < 0).astype(jnp.int32)
        )
        cell = jnp.clip(((o - scene_lo) * scene_inv), 0.0, 1023.0).astype(jnp.int32)
        # SORT_BITS bits per axis of position under the 3-bit octant:
        # coherent cones from coherent places sort together.
        b = _SORT_BITS
        sh = 10 - b
        pos_key = (cell[:, 0] >> sh << (2 * b)) | (cell[:, 1] >> sh << b) | (cell[:, 2] >> sh)
        key = (octant << (3 * b)) | pos_key
        return jnp.where(live, key, jnp.int32(2**30))

    for bounce in range(1, num_bounces + 1):
        if decorrelate and bounce > 1:
            # Rotate the pixel's noise point by the R2 sequence per bounce.
            shift = np.float32(0.7548776662466927) * bounce, np.float32(
                0.5698402909980532
            ) * bounce
            noise = base_noise + jnp.asarray(shift, jnp.float32)
            noise = noise - jnp.floor(noise)
        if bounce > 1:
            origin = jnp.where(alive[:, None], origin, park)
        if sort_bounces and bounce > 1:
            order = jnp.argsort(_coherence_key(origin, direction, alive))
            origin = origin[order]
            direction = direction[order]
            radiance = radiance[order]
            throughput = throughput[order]
            alive = alive[order]
            noise = noise[order]
            pixel_of = pixel_of[order]
        hit, _, tri_idx, _ = closest(scene, origin, direction, T_MAX)
        hit_lane = alive & hit
        miss_lane = alive & ~hit

        # --- miss: sky radiance (solar disk excluded; sun arrives via NEE) ---
        theta = jnp.arccos(jnp.clip(direction[:, 1], -1.0, 1.0))
        gamma = jnp.arccos(jnp.clip(jnp.sum(direction * sun_dir, axis=-1), -1.0, 1.0))
        sky_rgb = sky_radiance_dist(sky, theta, gamma)
        radiance = jnp.where(
            miss_lane[:, None], radiance + throughput * sky_rgb, radiance
        )

        # --- hit: NEE toward the solar disk (wgsl:191-203) ---
        safe_tri = jnp.maximum(tri_idx, 0)
        p, n, uv, tex, _ = _surface_interaction(scene, origin, direction, safe_tri)
        albedo = eval_texture(scene, tex, uv)

        light_dir = sample_solar_disk_direction(noise, SOLAR_COS_THETA_MAX, sun_dir)
        brdf = albedo * FRAC_1_PI
        # No clamp on the cosine — parity with wgsl:201.
        cos_term = jnp.sum(n * light_dir, axis=-1, keepdims=True)
        p_ok = jnp.all(jnp.isfinite(p), axis=-1)
        shadow_origin = jnp.where((hit_lane & p_ok)[:, None], p, park)
        occluded = any_hit(
            scene, shadow_origin, jnp.broadcast_to(light_dir, p.shape), T_MAX
        )
        visibility = jnp.where(occluded, jnp.float32(0.0), jnp.float32(1.0))[:, None]
        contrib = throughput * solar_radiance * brdf * cos_term * visibility * SOLAR_INV_PDF
        radiance = jnp.where(hit_lane[:, None], radiance + contrib, radiance)

        alive = hit_lane
        if bounce == num_bounces:
            break

        # --- scatter: implicit-PDF Lambertian (wgsl:209-211, 294-301) ---
        wi = sample_cosine_hemisphere(noise, n)
        # Degenerate shading normals (zero-length interpolation, onb poles)
        # can yield non-finite scatter directions; park those lanes instead
        # of feeding NaN/Inf rays to the traversal kernels.
        ray_ok = jnp.all(jnp.isfinite(wi), axis=-1) & jnp.all(jnp.isfinite(p), axis=-1)
        hit_lane = hit_lane & ray_ok
        origin = jnp.where(hit_lane[:, None], p, origin)
        direction = jnp.where(hit_lane[:, None], wi, direction)
        throughput = jnp.where(hit_lane[:, None], throughput * albedo, throughput)
        alive = hit_lane

    if sort_bounces:
        radiance = jnp.zeros_like(radiance).at[pixel_of].set(radiance)
    return radiance


@partial(
    jax.jit,
    static_argnames=("width", "height", "num_bounces", "spp", "engine"),
    donate_argnums=(5,),
)
def accumulate_sample(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    blue_noise_tile,
    frame_idx,
    accum,
    *,
    width: int,
    height: int,
    num_bounces: int,
    spp: int,
    engine: str = DEFAULT_ENGINE,
):
    """One progressive frame: add one sample per pixel into the accumulation
    buffer (fsMain, wgsl:34-64). Returns the updated (H*W, 3) buffer.

    Pixel mapping matches the reference's fullscreen pass: the fragment at
    image row i (top-left origin) uses v = 1 - (i + 0.5)/H flipped back, i.e.
    ray v = 1 - texCoord.y, plus the blue-noise sub-pixel jitter (wgsl:51-55).
    The buffer is in block-major pixel order (render/tiling.py).
    """
    from .tiling import block_order

    ys_np, xs_np, _ = block_order(width, height)
    ys = jnp.asarray(ys_np)
    xs = jnp.asarray(xs_np)

    from .rng import animated_blue_noise

    noise = animated_blue_noise(ys, xs, frame_idx, jnp.int32(spp), tile=blue_noise_tile)

    # Fragment texCoord.x = (x + 0.5) / W, texCoord.y = (y + 0.5) / H; the
    # WGSL uses u = texCoord.x and ray v = (1 - texCoord.y), each jittered by
    # noise / dimensions (wgsl:52-54).
    u = (xs.astype(jnp.float32) + 0.5) / jnp.float32(width)
    v_tex = (ys.astype(jnp.float32) + 0.5) / jnp.float32(height)
    jitter = noise / jnp.asarray([width, height], jnp.float32)
    ray_u = u + jitter[:, 0]
    ray_v = (jnp.float32(1.0) - v_tex) + jitter[:, 1]

    origin, direction = generate_camera_ray_lens(camera, noise, ray_u, ray_v)
    sample = trace_radiance(scene, sky, origin, direction, noise, num_bounces, engine)
    return accum + sample


@partial(
    jax.jit,
    static_argnames=("width", "height", "num_bounces", "spp", "num_frames", "engine"),
    donate_argnums=(5,),
)
def accumulate_samples(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    blue_noise_tile,
    frame_base,
    accum,
    *,
    width: int,
    height: int,
    num_bounces: int,
    spp: int,
    num_frames: int,
    engine: str = DEFAULT_ENGINE,
):
    """Add `num_frames` progressive samples in one dispatch via lax.scan —
    the body compiles once and host round-trips are amortized.

    Rays, shading, and the accumulation buffer all live in BLOCK-MAJOR pixel
    order (render/tiling.py) so neighbouring lanes trace neighbouring
    pixels; unswizzle once when assembling the image."""
    from .rng import animated_blue_noise
    from .tiling import block_order

    ys_np, xs_np, _ = block_order(width, height)
    ys = jnp.asarray(ys_np)
    xs = jnp.asarray(xs_np)
    u = (xs.astype(jnp.float32) + 0.5) / jnp.float32(width)
    v_tex = (ys.astype(jnp.float32) + 0.5) / jnp.float32(height)

    def body(accum, k):
        frame_idx = frame_base + k
        noise = animated_blue_noise(ys, xs, frame_idx, jnp.int32(spp), tile=blue_noise_tile)
        jitter = noise / jnp.asarray([width, height], jnp.float32)
        ray_u = u + jitter[:, 0]
        ray_v = (jnp.float32(1.0) - v_tex) + jitter[:, 1]
        origin, direction = generate_camera_ray_lens(camera, noise, ray_u, ray_v)
        sample = trace_radiance(scene, sky, origin, direction, noise, num_bounces, engine)
        return accum + sample, None

    accum, _ = jax.lax.scan(body, accum, jnp.arange(num_frames, dtype=jnp.int32))
    return accum


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "num_bounces", "spp", "num_frames", "engine",
        "compact_floor", "count_rays",
    ),
    donate_argnums=(5,),
)
def accumulate_samples_regen(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    blue_noise_tile,
    frame_base,
    accum,
    *,
    width: int,
    height: int,
    num_bounces: int,
    spp: int,
    num_frames: int,
    engine: str = DEFAULT_ENGINE,
    compact_floor: int | None = None,
    count_rays: bool = False,
):
    """accumulate_samples with PATH REGENERATION (persistent wavefront, after
    Laine et al. 2013): each lane owns one pixel and traces its `num_frames`
    samples back-to-back — the moment a path terminates (miss, depth, or
    degenerate scatter) the lane immediately starts its pixel's next sample.
    Traversal passes therefore run near full lane occupancy, instead of the
    scan formulation's mostly-dead deep-bounce passes (~85% of lanes die at
    bounce 1 on open scenes).

    Regeneration alone still runs the loop until the SLOWEST lane finishes:
    pixels on high-bounce geometry need ~num_bounces segments per sample while
    sky pixels need one, so after ~num_frames iterations the live fraction
    collapses yet each tail iteration costs the same
    as a full one. So the loop is PHASED: when the live count drops below the
    next phase size, busy lanes are compacted (jnp.nonzero gather) into a
    batch 1/_COMPACT_DIV the size and the loop continues at that width,
    scatter-adding finished samples back to their pixels. Compaction keeps
    lanes in block-major pixel order, so ray coherence survives.

    Per-pixel arithmetic is bit-identical to accumulate_samples: the same
    noise stream per (pixel, frame), the same contribution order within a
    sample, and the same f32 accumulation grouping (each pixel's radiance
    starts from `accum` and adds one finished sample at a time, in sample
    order — compaction never reorders a single pixel's additions).
    """
    from .tiling import block_order

    ys_np, xs_np, _ = block_order(width, height)
    ys = jnp.asarray(ys_np)
    xs = jnp.asarray(xs_np)
    u = (xs.astype(jnp.float32) + 0.5) / jnp.float32(width)
    v_tex = (ys.astype(jnp.float32) + 0.5) / jnp.float32(height)

    # The blue-noise tile value is a pure function of the pixel: gather ONCE
    # per dispatch; per-sample noise is that base plus the frame's R2 offset
    # (arithmetic only) — no per-step gathers (rng.animated_blue_noise).
    th, tw = blue_noise_tile.shape[0], blue_noise_tile.shape[1]
    noise_base_full = blue_noise_tile[ys % th, xs % tw]  # (B, 2)

    inv_dims = jnp.float32(1.0) / jnp.asarray([width, height], jnp.float32)
    return accumulate_lanes_regen(
        scene, sky, camera, frame_base, accum, u, v_tex, noise_base_full,
        inv_dims, num_bounces=num_bounces, spp=spp, num_frames=num_frames,
        engine=engine, compact_floor=compact_floor, count_rays=count_rays,
    )


def accumulate_lanes_regen(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    frame_base,
    accum,
    u,
    v_tex,
    noise_base_full,
    inv_dims,
    *,
    num_bounces: int,
    spp: int,
    num_frames: int,
    engine: str = DEFAULT_ENGINE,
    compact_floor: int | None = None,
    count_rays: bool = False,
):
    """Lane-level regen accumulation: the body of accumulate_samples_regen
    for an ARBITRARY set of lanes described by per-lane pixel data (u, v_tex,
    noise base). This is the shard-friendly entry — the multi-chip render
    step (parallel/sharding.py) calls it per pixel shard so every chip runs
    the same persistent-wavefront pipeline as a single chip.

    count_rays=True additionally returns an exact int32 [closest, shadow]
    ray-segment count (bench.py instrumentation; the reference counts rays
    the same way — one closest segment per bounce-loop iteration plus one
    NEE shadow ray per surface hit, reference_path_tracer.wgsl:180-234).
    Counting costs two scalar reductions per outer loop iteration."""
    closest, any_hit = get_engine(engine)
    from .rng import _A1, _A2

    batch = u.shape[0]
    nf = jnp.int32(num_frames)
    sun_dir = jnp.asarray(sky.sun_direction)
    solar_radiance = jnp.asarray(sky.solar_radiances)
    park = jnp.asarray([1e30, 1e30, 1e30], jnp.float32)

    def _noise_of(noise_base, sample_idx):
        n = ((frame_base + sample_idx) % jnp.int32(spp)).astype(jnp.float32)
        r2 = jnp.stack([_A1 * n, _A2 * n], axis=-1)
        r2 = r2 - jnp.floor(r2)
        out = noise_base + r2
        return out - jnp.floor(out)

    def _primary(u, v_tex, noise):
        jitter = noise * inv_dims
        ray_u = u + jitter[:, 0]
        ray_v = (jnp.float32(1.0) - v_tex) + jitter[:, 1]
        return generate_camera_ray_lens(camera, noise, ray_u, ray_v)

    def make_phase(u, v_tex, noise_base, pix):
        """Loop body over lanes with per-lane pixel data (u, v_tex,
        noise_base). pix None: lane == pixel, lrad is lane-aligned. pix given:
        compacted lanes, lrad stays full-size and finished samples scatter-add
        to their pixel (out-of-range pix rows — padding — are dropped)."""

        def noise_of(sample_idx):
            return _noise_of(noise_base, sample_idx)

        def primary(noise):
            return _primary(u, v_tex, noise)

        def body(st):
            if count_rays:
                *st, cnt = st
            sample, bounce, origin, direction, thr, srad, lrad, noise = st
            live = sample < nf
            origin = jnp.where(live[:, None], origin, park)

            hit, _, tri_idx, _ = closest(scene, origin, direction, T_MAX)
            hit_lane = live & hit
            miss_lane = live & ~hit
            if count_rays:
                # Each live lane traces one closest segment this iteration;
                # each hit lane one NEE shadow ray. Exact by construction.
                cnt = cnt + jnp.stack([
                    jnp.sum(live.astype(jnp.int32)),
                    jnp.sum(hit_lane.astype(jnp.int32)),
                ])

            # --- miss: sky radiance (sun excluded; it arrives via NEE) ---
            theta = jnp.arccos(jnp.clip(direction[:, 1], -1.0, 1.0))
            gamma = jnp.arccos(
                jnp.clip(jnp.sum(direction * sun_dir, axis=-1), -1.0, 1.0)
            )
            sky_rgb = sky_radiance_dist(sky, theta, gamma)
            srad = jnp.where(miss_lane[:, None], srad + thr * sky_rgb, srad)

            # --- hit: NEE toward the solar disk ---
            safe_tri = jnp.maximum(tri_idx, 0)
            p, n, uv, tex, _ = _surface_interaction(scene, origin, direction, safe_tri)
            albedo = eval_texture(scene, tex, uv)
            light_dir = sample_solar_disk_direction(noise, SOLAR_COS_THETA_MAX, sun_dir)
            brdf = albedo * FRAC_1_PI
            cos_term = jnp.sum(n * light_dir, axis=-1, keepdims=True)
            p_ok = jnp.all(jnp.isfinite(p), axis=-1)
            shadow_origin = jnp.where((hit_lane & p_ok)[:, None], p, park)
            occluded = any_hit(
                scene, shadow_origin, jnp.broadcast_to(light_dir, p.shape), T_MAX
            )
            visibility = jnp.where(occluded, jnp.float32(0.0), jnp.float32(1.0))[:, None]
            contrib = thr * solar_radiance * brdf * cos_term * visibility * SOLAR_INV_PDF
            srad = jnp.where(hit_lane[:, None], srad + contrib, srad)

            # --- scatter or terminate ---
            wi = sample_cosine_hemisphere(noise, n)
            ray_ok = jnp.all(jnp.isfinite(wi), axis=-1) & p_ok
            scatter = hit_lane & (bounce < jnp.int32(num_bounces)) & ray_ok
            term = live & ~scatter

            # Flush the finished sample into its pixel's radiance, in sample
            # order (same f32 add as the lane-aligned form: lrad[p] += srad).
            if pix is None:
                lrad = jnp.where(term[:, None], lrad + srad, lrad)
            else:
                lrad = lrad.at[pix].add(
                    jnp.where(term[:, None], srad, jnp.float32(0.0)), mode="drop"
                )
            srad = jnp.where(term[:, None], jnp.float32(0.0), srad)
            sample = jnp.where(term, sample + 1, sample)
            regen = term & (sample < nf)

            noise_new = noise_of(sample)
            po, pd = primary(noise_new)
            origin = jnp.where(
                scatter[:, None], p, jnp.where(regen[:, None], po, origin)
            )
            direction = jnp.where(
                scatter[:, None], wi, jnp.where(regen[:, None], pd, direction)
            )
            thr = jnp.where(
                scatter[:, None],
                thr * albedo,
                jnp.where(regen[:, None], jnp.float32(1.0), thr),
            )
            noise = jnp.where(regen[:, None], noise_new, noise)
            bounce = jnp.where(scatter, bounce + 1, jnp.where(regen, 1, bounce))
            out = (sample, bounce, origin, direction, thr, srad, lrad, noise)
            return out + (cnt,) if count_rays else out

        return body

    # Derive every while_loop carry from the (possibly shard_map-varying)
    # inputs so carry types match under manual sharding (same pattern as
    # render/traverse.py; adding exact zeros, numerics unchanged). u is
    # tiles-varying and frame_base samples-varying in the sharded step, so
    # the sum carries both axes.
    zero_i = (u[:batch] * 0.0).astype(jnp.int32) + jnp.asarray(
        frame_base, jnp.int32
    ) * jnp.int32(0)
    sample0 = jnp.zeros((batch,), jnp.int32) + zero_i
    body = make_phase(u, v_tex, noise_base_full, None)
    noise0 = _noise_of(noise_base_full, sample0)
    o0, d0 = _primary(u, v_tex, noise0)
    state = (
        sample0,  # per-lane sample index
        jnp.ones((batch,), jnp.int32) + zero_i,  # bounce depth of the active path
        o0,
        d0,
        jnp.ones((batch, 3), jnp.float32) + zero_i[:, None].astype(jnp.float32),
        jnp.zeros((batch, 3), jnp.float32) + zero_i[:, None].astype(jnp.float32),
        accum + zero_i[: accum.shape[0], None].astype(jnp.float32),
        noise0,
    )
    if count_rays:
        state = state + (jnp.zeros((2,), jnp.int32) + zero_i[:2],)

    floor = _COMPACT_FLOOR if compact_floor is None else compact_floor
    cur_u, cur_v, cur_nb, pix = u, v_tex, noise_base_full, None
    for size in _phase_sizes(batch, floor)[1:]:
        body_prev = body

        def above(st, size=size):
            return jnp.sum((st[0] < nf).astype(jnp.int32)) > jnp.int32(size)

        state = jax.lax.while_loop(above, body_prev, state)

        # Compact the busy lanes into a `size`-lane batch. nonzero preserves
        # block-major order, so ray coherence survives compaction.
        if count_rays:
            *state, cnt = state
        sample, bounce, origin, direction, thr, srad, lrad, noise = state
        busy = sample < nf
        idx = jnp.nonzero(busy, size=size, fill_value=0)[0].astype(jnp.int32)
        valid = jnp.arange(size, dtype=jnp.int32) < jnp.sum(busy.astype(jnp.int32))
        ints = [sample, bounce] + ([pix] if pix is not None else [])
        (
            (origin, direction, thr, srad, noise, cur_u, cur_v, cur_nb),
            taken_i,
        ) = _take_packed(
            idx,
            [origin, direction, thr, srad, noise, cur_u, cur_v, cur_nb],
            ints,
        )
        sample, bounce = taken_i[0], taken_i[1]
        sample = jnp.where(valid, sample, nf)  # padding slots are dead
        pix = taken_i[2] if pix is not None else idx
        pix = jnp.where(valid, pix, jnp.int32(batch))  # out of range -> drop
        state = (
            sample, bounce, origin, direction, thr, srad, lrad, noise,
        )
        if count_rays:
            state = state + (cnt,)
        body = make_phase(cur_u, cur_v, cur_nb, pix)

    def any_left(st):
        return jnp.any(st[0] < nf)

    state = jax.lax.while_loop(any_left, body, state)
    if count_rays:
        return state[6], state[-1]
    return state[6]


def _take_packed(idx, float_arrs, int_arrs):
    """Compaction gather: pack every state column into ONE matrix and gather
    once, instead of one gather per state array. int arrays ride as bitcast
    f32 columns.

    Returns (floats, ints) with the input structures (1-D arrays stay 1-D).
    """
    cols = []
    fspec = []
    for a in float_arrs:
        a2 = a if a.ndim == 2 else a[:, None]
        fspec.append((a.ndim, a2.shape[1]))
        cols.append(a2)
    ispec = []
    for a in int_arrs:
        a2 = a if a.ndim == 2 else a[:, None]
        ispec.append((a.ndim, a2.shape[1]))
        cols.append(jax.lax.bitcast_convert_type(a2, jnp.float32))
    packed = jnp.concatenate(cols, axis=1)[idx]
    out_f, out_i = [], []
    base = 0
    for ndim, w in fspec:
        sl = packed[:, base:base + w]
        out_f.append(sl[:, 0] if ndim == 1 else sl)
        base += w
    for ndim, w in ispec:
        sl = jax.lax.bitcast_convert_type(packed[:, base:base + w], jnp.int32)
        out_i.append(sl[:, 0] if ndim == 1 else sl)
        base += w
    return out_f, out_i


def pick_accumulator(scene: DeviceScene):
    """Progressive-accumulator selection shared by render_image and Renderer:
    the persistent-wavefront regen loop for small scenes, and for big scenes
    (more clusters than SORT_THRESHOLD) the scan form, whose per-bounce
    coherence sort needs lanes that are not tied to pixels. Physics and the
    noise stream are the same either way."""
    if scene.cluster_tris.shape[0] > SORT_THRESHOLD:
        return accumulate_samples
    return accumulate_samples_regen


@partial(
    jax.jit,
    static_argnames=("win_w", "win_h", "width", "height", "num_bounces", "spp", "num_frames", "engine"),
    donate_argnums=(5,),
)
def accumulate_samples_window(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    blue_noise_tile,
    frame_base,
    accum,
    x0,
    y0,
    *,
    win_w: int,
    win_h: int,
    width: int,
    height: int,
    num_bounces: int,
    spp: int,
    num_frames: int,
    engine: str = DEFAULT_ENGINE,
):
    """accumulate_samples over a (win_w, win_h) sub-window at traced offset
    (x0, y0) of the full framebuffer — one compile serves every tile of a
    large render (the reference bounds work volume the same way, capping
    buffers to device limits, reference_path_tracer.cpp:253-263).

    accum: (win_h * win_w, 3) block-ordered for the window."""
    from .rng import animated_blue_noise
    from .tiling import block_order

    ys_np, xs_np, _ = block_order(win_w, win_h)
    ys = jnp.asarray(ys_np) + y0
    xs = jnp.asarray(xs_np) + x0
    u = (xs.astype(jnp.float32) + 0.5) / jnp.float32(width)
    v_tex = (ys.astype(jnp.float32) + 0.5) / jnp.float32(height)

    def body(accum, k):
        frame_idx = frame_base + k
        noise = animated_blue_noise(ys, xs, frame_idx, jnp.int32(spp), tile=blue_noise_tile)
        jitter = noise / jnp.asarray([width, height], jnp.float32)
        ray_u = u + jitter[:, 0]
        ray_v = (jnp.float32(1.0) - v_tex) + jitter[:, 1]
        origin, direction = generate_camera_ray_lens(camera, noise, ray_u, ray_v)
        sample = trace_radiance(scene, sky, origin, direction, noise, num_bounces, engine)
        return accum + sample, None

    accum, _ = jax.lax.scan(body, accum, jnp.arange(num_frames, dtype=jnp.int32))
    return accum


def render_image_tiled(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    *,
    width: int,
    height: int,
    sampling: SamplingParams = SamplingParams(),
    exposure: float = 1.0,
    engine: str = DEFAULT_ENGINE,
    tile_w: int = 512,
    tile_h: int = 512,
    samples_per_dispatch: int = 8,
) -> np.ndarray:
    """Render a large framebuffer window by window. One compiled program per
    window SHAPE (edge windows reuse the same shape via clamped offsets), so
    arbitrary resolutions render with bounded per-dispatch device work."""
    from .rng import blue_noise_tile
    from .tiling import block_order, unswizzle
    from .tonemap import tonemap

    tile = jnp.asarray(blue_noise_tile())
    spp = sampling.num_samples_per_pixel
    out = np.empty((height, width, 3), np.float32)

    for y0 in range(0, height, tile_h):
        for x0 in range(0, width, tile_w):
            # Clamp so edge windows share the interior window shape.
            wx = min(x0, max(0, width - tile_w))
            wy = min(y0, max(0, height - tile_h))
            win_w = min(tile_w, width)
            win_h = min(tile_h, height)

            accum = jnp.zeros((win_h * win_w, 3), jnp.float32)
            frame_idx = 0
            while frame_idx < spp:
                batch = min(samples_per_dispatch, spp - frame_idx)
                accum = accumulate_samples_window(
                    scene, sky, camera, tile,
                    jnp.int32(frame_idx), accum, jnp.int32(wx), jnp.int32(wy),
                    win_w=win_w, win_h=win_h, width=width, height=height,
                    num_bounces=sampling.num_bounces, spp=spp,
                    num_frames=batch, engine=engine,
                )
                frame_idx += batch
            img = tonemap(unswizzle(accum, win_w, win_h) / jnp.float32(spp), exposure)
            img = np.asarray(img).reshape(win_h, win_w, 3)
            out[wy : wy + win_h, wx : wx + win_w] = img
    return out


def render_image(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    *,
    width: int,
    height: int,
    sampling: SamplingParams = SamplingParams(),
    exposure: float = 1.0,
    engine: str = DEFAULT_ENGINE,
    samples_per_dispatch: int = 32,
) -> np.ndarray:
    """Render a full image: spp progressive samples, running-mean estimator,
    ACES tonemap + gamma (wgsl:59-63). Returns (H, W, 3) float32 in [0, 1]."""
    from .rng import blue_noise_tile
    from .tonemap import tonemap

    tile = jnp.asarray(blue_noise_tile())
    accum = jnp.zeros((height * width, 3), jnp.float32)
    spp = sampling.num_samples_per_pixel
    accumulate = pick_accumulator(scene)
    frame_idx = 0
    while frame_idx < spp:
        batch = min(samples_per_dispatch, spp - frame_idx)
        accum = accumulate(
            scene,
            sky,
            camera,
            tile,
            jnp.int32(frame_idx),
            accum,
            width=width,
            height=height,
            num_bounces=sampling.num_bounces,
            spp=spp,
            num_frames=batch,
            engine=engine,
        )
        frame_idx += batch
    from .tiling import unswizzle

    estimator = unswizzle(accum, width, height) / jnp.float32(spp)
    img = tonemap(estimator, exposure)
    return np.asarray(img).reshape(height, width, 3)
