"""bench.py measures the GPU only: without one it must exit non-zero and
print no result, rather than time the CPU under a device metric's name."""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).parent.parent


def test_bench_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no GPU" in proc.stderr
