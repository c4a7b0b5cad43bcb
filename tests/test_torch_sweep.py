"""The port's laser-parameter sweep against the JAX package (CPU): a
2-point ``run_sweep`` over detuning and Rabi frequency folds both points
into one ensemble through the per-lane tick variants; both sides start
from the same states with JAX's replayed uniforms (as in
tests/test_torch_ensemble.py, whose bars hold here).  Also the port's
``cooling-ensemble`` and ``cooling-sweep`` CLI subcommands."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.experiments import laser_cooling as jlc
from mdqtplasmasims_tpu.io.datfiles import read_rows
from mdqtplasmasims_torch.experiments import laser_cooling as tlc

from test_torch_ensemble import (SMALL, assert_outs_close,
                                 assert_states_close, assert_trees_close,
                                 files, jax_member_states, jax_rolls)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTS = [{"detuning": -1.0, "om": 0.8}, {"detuning": -0.5, "om": 1.3}]


@pytest.fixture(scope="module")
def sweep_runs(tmp_path_factory):
    tmp_a = str(tmp_path_factory.mktemp("jax"))
    tmp_b = str(tmp_path_factory.mktemp("torch"))
    cfg_j = jlc.CoolingConfig(fused_interpret=True, use_pallas=False,
                              save_directory=tmp_a, **SMALL)
    states0 = jax_member_states(cfg_j, 2, seed=2)
    fin_j, outs_j, mj = jlc.run_sweep(cfg_j, POINTS, seed=2)
    cfg_t = tlc.CoolingConfig(save_directory=tmp_b, **SMALL)
    fin_t, outs_t, mt = tlc.run_sweep(cfg_t, POINTS, seed=2, device="cpu",
                                      states=states0,
                                      rolls_fn=jax_rolls(states0.key[0]))
    return (fin_j, outs_j, mj, tmp_a), (fin_t, outs_t, mt, tmp_b)


def test_sweep_matches_jax(sweep_runs):
    (fj, oj, mj, _), (ft, ot, mt, _) = sweep_runs
    assert [(c.detuning, c.om, c.job) for c in mt] == [
        (c.detuning, c.om, c.job) for c in mj]
    assert_states_close(ft, fj)
    assert_outs_close(ot, oj)
    # the points really differ
    assert np.abs(ot["pops"][0] - ot["pops"][1]).max() > 1e-4


def test_sweep_trees_match_jax(sweep_runs):
    (_, _, _, tmp_a), (_, _, _, tmp_b) = sweep_runs
    names = sorted(files(tmp_b))
    tops = {n.split(os.sep)[0] for n in names}
    assert len(tops) == 2 and any("DetSP-50" in t for t in tops)
    assert_trees_close(tmp_a, tmp_b)


def test_sweep_refuses_fields_the_fold_cannot_vary():
    with pytest.raises(ValueError, match="sweep can only override"):
        tlc.run_ensemble(tlc.CoolingConfig(**SMALL), 2, device="cpu",
                         sweep=[{"ge": 0.2}, {"ge": 0.3}])
    with pytest.raises(ValueError, match="entries"):
        tlc.run_ensemble(tlc.CoolingConfig(**SMALL), 3, device="cpu",
                         sweep=POINTS)


def _cli(tmp_path, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "mdqtplasmasims_torch.cli", *args,
         "--n0", "64", "--tmax", "0.01", "--sample-freq", "2",
         "--device", "cpu", "--save-directory", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    return sorted(f for f in files(str(tmp_path))
                  if f.endswith("energies.dat"))


def test_cli_cooling_ensemble(tmp_path):
    found = _cli(tmp_path, "cooling-ensemble", "--jobs", "2",
                 "--exact-n", "false")
    assert [f.split(os.sep)[-2] for f in found] == ["job1", "job2"]
    for f in found:
        rows = read_rows(os.path.join(str(tmp_path), f), expect_cols=7)
        assert rows.shape[0] == 2 and np.isfinite(rows).all()


def test_cli_cooling_sweep(tmp_path):
    found = _cli(tmp_path, "cooling-sweep", "--det-sp-values=-1.0,-0.5",
                 "--om-values", "0.9,1.1", "--cross")
    assert len(found) == 4
    assert len({f.split(os.sep)[0] for f in found}) == 4
