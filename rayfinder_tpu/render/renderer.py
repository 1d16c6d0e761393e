"""Progressive path-tracing renderer with the reference's public API.

Mirrors ReferencePathTracer (src/pt/reference_path_tracer.hpp:26-102):

* RenderParameters {framebuffer size, camera, sampling params, sky, exposure};
* setRenderParameters resets the progressive accumulation only when the
  parameters actually changed (reference_path_tracer.cpp:556-563);
* render() advances one frame: adds one sample per pixel while
  accumulated < spp, while the frame counter keeps advancing the noise
  sequence regardless (fsMain, wgsl:45-57; host counters
  reference_path_tracer.cpp:577-591);
* renderProgressPercentage and a 30-entry rolling average of render-pass
  durations (reference_path_tracer.cpp:706-722).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import jax.numpy as jnp

from ..sky.model import SkyState, sky_state_from_ui
from .camera import Camera
from .pathtracer import (
    DEFAULT_ENGINE,
    SamplingParams,
    accumulate_samples_regen,
    pick_accumulator,
)
from .scene import DeviceScene
from .tonemap import tonemap


import jax as _jax


@_jax.jit
def _display_u8(estimator, exposure):
    img = tonemap(estimator, exposure)
    return jnp.clip(jnp.round(img * 255.0), 0.0, 255.0).astype(jnp.uint8)


@dataclasses.dataclass(frozen=True)
class Sky:
    """UI-level sky parameters (aligned_sky_state.hpp:15-23)."""

    turbidity: float = 1.0
    albedo: tuple = (1.0, 1.0, 1.0)
    sun_zenith_degrees: float = 30.0
    sun_azimuth_degrees: float = 0.0

    def state(self) -> SkyState:
        return sky_state_from_ui(
            self.turbidity, self.albedo, self.sun_zenith_degrees, self.sun_azimuth_degrees
        )


@dataclasses.dataclass(frozen=True)
class RenderParameters:
    """reference_path_tracer.hpp:41-49."""

    width: int
    height: int
    camera: Camera
    sampling: SamplingParams = SamplingParams()
    sky: Sky = Sky()
    exposure: float = 1.0

    def _key(self):
        cam = tuple(np.concatenate([np.ravel(f) for f in self.camera]).tolist())
        return (
            self.width,
            self.height,
            cam,
            tuple(self.sampling),
            dataclasses.astuple(self.sky),
            self.exposure,
        )

    def _digest(self) -> str:
        """Stable checkpoint-integrity key: repr of the key tuple hashed with
        sha256 (Python's hash() is salted per process and implementation-
        defined across versions — useless across restarts)."""
        import hashlib

        return hashlib.sha256(repr(self._key()).encode()).hexdigest()


class Renderer:
    """Progressive accumulation renderer over a DeviceScene."""

    def __init__(
        self,
        scene: DeviceScene,
        params: RenderParameters,
        engine: str = DEFAULT_ENGINE,
        count_rays: bool = False,
    ):
        from .rng import blue_noise_tile

        self.scene = scene
        self.engine = engine
        # count_rays: accumulate exact traced-segment counts (viewer/bench
        # Mrays/s readout). Only the regen accumulator can count; when the
        # picked accumulator is the scan form (big scenes), total_rays flips
        # back to None on the first render() so callers can distinguish
        # "counting unavailable" from "0 rays".
        self._count_rays = count_rays
        self.total_rays = 0 if count_rays else None
        self._tile = jnp.asarray(blue_noise_tile())
        self._durations = collections.deque(maxlen=30)
        self._params = params
        self._sky_state = params.sky.state()
        self._reset()

    def _reset(self) -> None:
        # Only the accumulation resets; the frame counter keeps advancing the
        # noise sequence across parameter changes
        # (reference_path_tracer.cpp:556-563: mAccumulatedSampleCount = 0).
        p = self._params
        self.accumulated_sample_count = 0
        if not hasattr(self, "frame_count"):
            self.frame_count = 0
        self._accum = jnp.zeros((p.height * p.width, 3), jnp.float32)

    def set_render_parameters(self, params: RenderParameters) -> None:
        """Reset accumulation only on an actual change
        (reference_path_tracer.cpp:556-563)."""
        if params._key() != self._params._key():
            sky_changed = dataclasses.astuple(params.sky) != dataclasses.astuple(self._params.sky)
            self._params = params
            if sky_changed:
                self._sky_state = params.sky.state()
            self._reset()

    def render(self, num_frames: int = 1) -> None:
        """Advance num_frames frames; each adds one sample/pixel while the
        target spp is not reached (frame counter always advances)."""
        p = self._params
        t0 = time.time()
        remaining = p.sampling.num_samples_per_pixel - self.accumulated_sample_count
        to_add = max(0, min(num_frames, remaining))
        if to_add > 0:
            # Same accumulator selection as render_image. Physics and noise
            # stream are identical either way.
            accumulate = pick_accumulator(self.scene)
            kw = dict(
                width=p.width,
                height=p.height,
                num_bounces=p.sampling.num_bounces,
                spp=p.sampling.num_samples_per_pixel,
                num_frames=to_add,
                engine=self.engine,
            )
            counting = self._count_rays and accumulate is accumulate_samples_regen
            if counting:
                kw["count_rays"] = True
            elif self._count_rays:
                self.total_rays = None  # counting unavailable on this path
            out = accumulate(
                self.scene,
                self._sky_state,
                p.camera,
                self._tile,
                jnp.int32(self.frame_count),
                self._accum,
                **kw,
            )
            if counting:
                self._accum, rays = out
                self.total_rays += int(np.asarray(rays).sum())
            else:
                self._accum = out
            self.accumulated_sample_count += to_add
        self.frame_count += num_frames
        self._durations.append(time.time() - t0)

    def render_progress_percentage(self) -> float:
        """reference_path_tracer.cpp:718-722."""
        return 100.0 * self.accumulated_sample_count / self._params.sampling.num_samples_per_pixel

    def average_render_pass_duration_ms(self) -> float:
        """30-frame rolling average (reference_path_tracer.cpp:706-716)."""
        if not self._durations:
            return 0.0
        return 1000.0 * sum(self._durations) / len(self._durations)

    def image(self) -> np.ndarray:
        """Tonemapped running-mean estimate, (H, W, 3) in [0, 1]."""
        from .tiling import unswizzle

        p = self._params
        count = max(1, self.accumulated_sample_count)
        estimator = unswizzle(self._accum, p.width, p.height) / jnp.float32(count)
        img = tonemap(estimator, p.exposure)
        return np.asarray(img).reshape(p.height, p.width, 3)

    def image_u8(self) -> np.ndarray:
        """Display-ready 8-bit frame: tonemap + quantize ON DEVICE and
        fetch u8, a quarter of the f32 image's bytes. PNG and any display
        target are 8-bit anyway; `image()` stays the exact f32 surface."""
        from .tiling import unswizzle

        p = self._params
        count = max(1, self.accumulated_sample_count)
        estimator = unswizzle(self._accum, p.width, p.height) / jnp.float32(count)
        img8 = _display_u8(estimator, jnp.float32(p.exposure))
        return np.asarray(img8).reshape(p.height, p.width, 3)

    # -- checkpoint / resume (beyond the reference, whose only persistence is
    # the .pt scene cache — SURVEY.md §5.4; render state lived in GPU memory
    # and was lost on any parameter change) ---------------------------------

    def save_checkpoint(self, path) -> None:
        """Persist the progressive accumulation so a render can resume
        across processes/preemptions."""
        np.savez_compressed(
            path,
            accum=np.asarray(self._accum),
            accumulated_sample_count=self.accumulated_sample_count,
            frame_count=self.frame_count,
            params_key=np.asarray(self._params._digest()),
        )

    def load_checkpoint(self, path) -> None:
        """Resume from a checkpoint; refuses on mismatched render params."""
        with np.load(path) as data:
            if str(data["params_key"]) != self._params._digest():
                raise ValueError(
                    "checkpoint was created with different render parameters"
                )
            self._accum = jnp.asarray(data["accum"])
            self.accumulated_sample_count = int(data["accumulated_sample_count"])
            self.frame_count = int(data["frame_count"])
