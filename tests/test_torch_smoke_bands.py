"""``chip_smoke.FROZEN_BANDS`` is a hand copy of the frozen soak bands of
``tests/test_physics_targets.py::TestFullScaleSoak.test_frozen_tagging``
(chip_smoke.py imports nothing of the tests or of JAX).  On values just
inside and just outside each band edge, both checks must come out the
same: a copy that drifted from the test fails here."""

import os
import sys

import pytest

import test_physics_targets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

EPS = 1e-6


def _test_passes(m: dict) -> bool:
    try:
        test_physics_targets.TestFullScaleSoak().test_frozen_tagging({"frozen": m})
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("side", ["inside", "outside"])
@pytest.mark.parametrize("edge", ["low", "high"])
@pytest.mark.parametrize("key", sorted(chip_smoke.FROZEN_BANDS))
def test_smoke_bands_equal_the_soak_test(key, edge, side):
    m = {k: 0.5 * (lo + hi) for k, (lo, hi) in chip_smoke.FROZEN_BANDS.items()}
    m.update(n0=3500, tstart=15.0)
    assert _test_passes(m) and not chip_smoke.frozen_band_misses(m)
    lo, hi = chip_smoke.FROZEN_BANDS[key]
    inward = 1.0 if edge == "low" else -1.0
    step = EPS if side == "inside" else -EPS
    m[key] = (lo if edge == "low" else hi) + inward * step
    smoke_ok = not chip_smoke.frozen_band_misses(m)
    assert smoke_ok == (side == "inside")
    assert _test_passes(m) == smoke_ok
