"""The port's presets (``experiments/presets.py``) against the JAX
package's (CPU).

* ``PRESETS`` has the JAX package's keys, and every preset builds the same
  config field for field, with a caller's keywords passed through (and,
  for ``pre_speedup``, winning over its defaults).
* ``pre_speedup`` as a whole run at N0=64, the reference's original
  program (the old-generation Ehrenfest convention, VAF intervals and the
  LCCF stream), from the JAX package's start with its key chain replayed
  through ``rolls_fn``, as tests/test_torch_cooling.py and
  tests/test_torch_intervals.py do for the flagship.  The preset's
  intervals (t = 3, 5, ..., 27) lie past a short run, so two are brought
  inside it by keyword.  JAX runs its Pallas kernels in interpret mode.

Bars: tests/test_torch_ensemble.py's (states R/V/t_part 2e-5, psi 5e-5;
samples and .dat files, VAF_interval*.dat and J_interval0.dat among them,
1e-4 of each array's largest value; native arrays 5e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.experiments import laser_cooling as jlc
from mdqtplasmasims_tpu.experiments import presets as jpresets
from mdqtplasmasims_torch.bridge import state_from_numpy
from mdqtplasmasims_torch.experiments import laser_cooling as tlc
from mdqtplasmasims_torch.experiments import presets as tpresets

from test_torch_ensemble import (assert_outs_close, assert_states_close,
                                 assert_trees_close, files, jax_rolls)

torch.set_num_threads(1)

# 6 MD steps = 3 samples; interval 0 opens before the first sample,
# interval 1 at the second
SHORT = dict(n0=64, tmax=0.012, sample_freq=2, vaf_intervals=(0.001, 0.007))


def assert_configs_equal(ct, cj):
    """Every field of the port's config equals the JAX one's (the JAX
    configs also carry its kernel switches, which the port has not)."""
    names = [f.name for f in dataclasses.fields(ct)]
    assert set(names) <= {f.name for f in dataclasses.fields(cj)}
    for name in names:
        assert getattr(ct, name) == getattr(cj, name), name


def test_preset_table_keys():
    assert list(tpresets.PRESETS) == list(jpresets.PRESETS)
    assert tpresets.magnesium is tpresets.north_star
    assert tpresets.PRESETS["magnesium"] is tpresets.PRESETS["north-star"]


@pytest.mark.parametrize("name", list(jpresets.PRESETS))
@pytest.mark.parametrize("kw", [{}, {"save_directory": "out", "job": 3}],
                         ids=["defaults", "keywords"])
def test_preset_configs_equal(name, kw):
    ct, cj = tpresets.PRESETS[name](**kw), jpresets.PRESETS[name](**kw)
    assert type(ct).__name__ == type(cj).__name__
    assert type(ct).__module__.startswith("mdqtplasmasims_torch.")
    assert_configs_equal(ct, cj)
    for k, v in kw.items():
        assert getattr(ct, k) == v


def test_pre_speedup_defaults_give_way():
    cfg = tpresets.pre_speedup()
    assert (cfg.physics, cfg.vaf_intervals, cfg.record_lccf) == (
        "pre_speedup", tuple(range(3, 28, 2)), True)
    mine = tpresets.pre_speedup(physics="speedup", vaf_intervals=(1.0,),
                                record_lccf=False, n0=500)
    assert (mine.physics, mine.vaf_intervals, mine.record_lccf,
            mine.n0) == ("speedup", (1.0,), False, 500)
    assert_configs_equal(mine, jpresets.pre_speedup(
        physics="speedup", vaf_intervals=(1.0,), record_lccf=False, n0=500))


@pytest.fixture(scope="module")
def pre_speedup_runs(tmp_path_factory):
    tmp_a = str(tmp_path_factory.mktemp("jax"))
    tmp_b = str(tmp_path_factory.mktemp("torch"))
    cfg_j = jpresets.pre_speedup(fused_interpret=True, use_pallas=False,
                                 save_directory=tmp_a, **SHORT)
    state0 = jlc.initial_state(cfg_j)
    fin_j, res_j = jlc.run(cfg_j)
    cfg_t = tpresets.pre_speedup(save_directory=tmp_b, **SHORT)
    assert cfg_t.physics == "pre_speedup" and cfg_t.record_lccf
    fin_t, res_t = tlc.run(cfg_t, state=state_from_numpy(state0,
                                                         device="cpu"),
                           device="cpu", rolls_fn=jax_rolls(state0.key))
    return (fin_j, res_j, tmp_a), (fin_t, res_t, tmp_b)


def test_pre_speedup_run_matches_jax(pre_speedup_runs):
    (fj, rj, tmp_a), (ft, rt, tmp_b) = pre_speedup_runs
    assert_states_close(ft, fj)
    np.testing.assert_allclose(ft.F, np.asarray(fj.F), atol=2e-5,
                               rtol=1e-5)
    ot = {k: v for k, v in rt["outs"].items() if k not in ("V", "R", "J")}
    assert_outs_close(ot, rj["outs"])
    for k in ("V", "R"):
        np.testing.assert_allclose(rt["outs"][k], np.asarray(rj["outs"][k]),
                                   atol=2e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(rt["epot0"], rj["epot0"], rtol=1e-5)


def test_pre_speedup_tree_matches_jax(pre_speedup_runs):
    (_, _, tmp_a), (_, _, tmp_b) = pre_speedup_runs
    names = {n.rsplit("/", 1)[-1] for n in files(tmp_b)}
    assert {"VAF_interval0.dat", "VAF_interval1.dat",
            "J_interval0.dat"} <= names
    assert_trees_close(tmp_a, tmp_b)
