"""Showcase-scale quality gate: the default engine's full-resolution
courtyard render must match the wavefront-engine golden
(tools/make_quality_goldens.py) to RMSE < 1e-3.

The render is real work (254K triangles, 512x512 @ 32spp), so the test runs
on the card only; on the CPU the thumbnail goldens (tests/test_goldens.py)
exercise the same comparison. chip_smoke.py runs it with `pytest -m gpu`."""

import pathlib
import sys

import numpy as np
import pytest

_BUDGET = 1e-3


@pytest.mark.gpu
def test_full_scale_rmse(gpu):
    sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))
    from rayfinder_tpu.render.pathtracer import DEFAULT_ENGINE
    from tools.make_quality_goldens import COURTYARD_GOLDEN, courtyard_config, quality_image

    scene, sky, camera, kw = courtyard_config()
    golden = np.load(COURTYARD_GOLDEN)["image"].astype(np.float32)
    img = quality_image(scene, sky, camera, engine=DEFAULT_ENGINE, **kw)
    rmse = float(np.sqrt(np.mean((img - golden) ** 2)))
    assert rmse < _BUDGET, f"courtyard drifted: RMSE {rmse:.2e} >= {_BUDGET}"
