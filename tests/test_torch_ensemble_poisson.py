"""The port's Poissonian-N ensemble fold against the JAX package (CPU):
per-member ion counts drawn as the reference's array jobs draw them,
padded lanes inert, periodic checkpoints after every segment.  Same
replay and bars as tests/test_torch_ensemble.py."""

import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.experiments import laser_cooling as jlc
from mdqtplasmasims_tpu.io import checkpoint as ckpt
from mdqtplasmasims_torch.core.init import poisson_member_mask
from mdqtplasmasims_torch.experiments import laser_cooling as tlc

from test_torch_ensemble import (SMALL, assert_outs_close,
                                 assert_states_close, assert_trees_close,
                                 files, jax_rolls)

torch.set_num_threads(1)

SEED = 5
POISSON = dict(SMALL, exact_n=False, checkpoint_every_segments=1)


@pytest.fixture(scope="module")
def poisson_runs(tmp_path_factory):
    tmp_a = str(tmp_path_factory.mktemp("jax"))
    tmp_b = str(tmp_path_factory.mktemp("torch"))
    cfg_j = jlc.CoolingConfig(fused_interpret=True, use_pallas=False,
                              save_directory=tmp_a, **POISSON)
    states0, _, n_js = jlc._poisson_member_states(
        jlc.canonical_run_cfg(cfg_j), 2, SEED)
    fin_j, outs_j = jlc.run_ensemble(cfg_j, 2, seed=SEED)
    cfg_t = tlc.CoolingConfig(save_directory=tmp_b, **POISSON)
    fin_t, outs_t = tlc.run_ensemble(cfg_t, 2, seed=SEED, device="cpu",
                                     states=states0,
                                     rolls_fn=jax_rolls(states0.key[0]))
    return (fin_j, outs_j, tmp_a), (fin_t, outs_t, tmp_b), n_js


def test_poisson_counts_equal_jax(poisson_runs):
    *_, n_js = poisson_runs
    _, counts = poisson_member_mask(64, 2, SEED)
    assert counts == list(n_js) and counts[0] != counts[1]


def test_poisson_final_states_and_outputs_match_jax(poisson_runs):
    (fj, oj, _), (ft, ot, _), n_js = poisson_runs
    assert ft.R.shape == (2, max(n_js), 3)
    assert_states_close(ft, fj)
    assert_outs_close(ot, oj)
    # padded lanes stay exactly at R = V = psi = 0
    j = int(np.argmin(n_js))
    for x in (ft.R, ft.V, ft.psi):
        assert np.abs(x[j, n_js[j]:]).max() == 0.0


def test_poisson_trees_match_jax(poisson_runs):
    (_, _, tmp_a), (_, _, tmp_b), n_js = poisson_runs
    names = sorted(files(tmp_b))
    # the periodic checkpoint after segment 1 and the terminal one
    assert sum(n.endswith("checkpoint_000001.npz") for n in names) == 2
    assert sum(n.endswith("checkpoint_000004.npz") for n in names) == 2
    assert_trees_close(tmp_a, tmp_b)
    dirs = sorted({n.split("/job")[0] + "/job" + n.split("/job")[1][0]
                   for n in names})
    for d, nj in zip(dirs, n_js):
        n_file, counter = ckpt.read_ions(f"{tmp_b}/{d}", 4)
        assert (n_file, counter) == (nj, 2)
