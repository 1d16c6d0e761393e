"""Pass timing with device fencing, and the device record of a measurement.

PassTimer is the analog of the reference's GPU timestamp queries
(reference_path_tracer.cpp:472-480, 653-703): wall-clock sections that wait
for the device work they time with `block_until_ready`. Timings land in
30-entry rolling deques like the reference's perf UI.
"""

from __future__ import annotations

import collections
import contextlib
import subprocess
import time


class PassTimer:
    def __init__(self, window: int = 30):
        self._durations: dict[str, collections.deque] = {}
        self._window = window

    @contextlib.contextmanager
    def section(self, name: str, fence_value=None):
        """Time a section; pass a jnp array as fence_value to synchronize on
        the device work that produced it."""
        t0 = time.time()
        yield
        if fence_value is not None:
            fence_value.block_until_ready()
        self._durations.setdefault(
            name, collections.deque(maxlen=self._window)
        ).append(time.time() - t0)

    def averages_ms(self) -> dict[str, float]:
        return {
            name: 1000.0 * sum(d) / len(d) for name, d in self._durations.items() if d
        }

    def report(self) -> str:
        return "  ".join(f"{k}: {v:.1f}ms" for k, v in self.averages_ms().items())


def card_description() -> str:
    """The first card's name and power limit, as nvidia-smi reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"). A card below its maximum power
    limit runs slower under load, so every measurement names it. Needs no
    JAX, so it can run before a process touches the card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def gpu_record() -> dict:
    """The device a measurement ran on: JAX's platform, device kind and
    device count, and the card's name and power limit as nvidia-smi reports
    them. Raises RuntimeError when JAX finds no GPU, so that no number is
    ever taken on the CPU under a device metric's name."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {devices[0].platform!r}")
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "card": card_description(),
    }

