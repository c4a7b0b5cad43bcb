"""The interval diagnostics of the cooling family (interval VAF, the LCCF
current J(k), the VAF origins in VZERO files and native checkpoints)
against the JAX package (CPU).

Both packages run the same small config with ``vaf_intervals`` and
``record_lccf`` from the same start, the port fed JAX's uniforms through
``rolls_fn`` and JAX running its Pallas kernels in interpret mode
(``fused_interpret=True``, explicit rolls), and write the same trees: the
port's form of tests/test_experiments.py:615 (interval outputs), :1149
(the vholder across a resume), tests/test_review_fixes.py:211 (an
interval before the first sample) and tests/test_classical.py:90 (J(k)
against the direct sum).  The vholder also resumes across the packages,
both ways.

Tolerances: tests/test_torch_ensemble.py's (states R/V 2e-5, psi 5e-5;
.dat files 1e-4 of each file's largest value; native arrays 5e-5); J(k)
in float64 1e-8 of the direct sum.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.experiments import laser_cooling as jlc
from mdqtplasmasims_tpu.io import checkpoint as ckpt
from mdqtplasmasims_tpu.ops import structure as js
from mdqtplasmasims_torch.bridge import state_from_numpy
from mdqtplasmasims_torch.experiments import laser_cooling as tlc
from mdqtplasmasims_torch.ops import structure as ts

from test_torch_ensemble import (assert_states_close, assert_trees_close,
                                 files, jax_member_states, jax_rolls)
from test_torch_resume_jax import _jax_cfg, _job_dirs, _key_of

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 6 MD steps = 3 samples; interval 0 starts before the first sample,
# interval 1 at the second
IV = dict(n0=64, tmax=0.012, sample_freq=2, vaf_intervals=(0.001, 0.007),
          record_lccf=True)


def assert_vholders_close(root_a, root_b):
    """Every native checkpoint of one tree carries the other's vholder."""
    fa, fb = files(root_a), files(root_b)
    npz = [n for n in fa if n.endswith(".npz")]
    assert npz
    for name in npz:
        with np.load(fa[name]) as za, np.load(fb[name]) as zb:
            np.testing.assert_allclose(zb["vholder"], za["vholder"],
                                       atol=5e-5, err_msg=name)


@pytest.fixture(scope="module")
def run_trees(tmp_path_factory):
    tmp_a = str(tmp_path_factory.mktemp("jax"))
    tmp_b = str(tmp_path_factory.mktemp("torch"))
    cfg_j = jlc.CoolingConfig(fused_interpret=True, use_pallas=False,
                              save_directory=tmp_a, **IV)
    state0 = jlc.initial_state(cfg_j)
    fin_j, res_j = jlc.run(cfg_j)
    fin_t, res_t = tlc.run(tlc.CoolingConfig(save_directory=tmp_b, **IV),
                           state=state_from_numpy(state0, device="cpu"),
                           device="cpu", rolls_fn=jax_rolls(state0.key))
    return (fin_j, res_j, tmp_a), (fin_t, res_t, tmp_b)


def test_run_interval_trees_match_jax(run_trees):
    (fj, rj, tmp_a), (ft, rt, tmp_b) = run_trees
    names = {os.path.basename(n) for n in files(tmp_b)}
    assert {"VAF_interval0.dat", "VAF_interval1.dat",
            "J_interval0.dat"} <= names
    assert_trees_close(tmp_a, tmp_b)
    assert_vholders_close(tmp_a, tmp_b)
    for k in ("V", "R"):
        np.testing.assert_allclose(rt["outs"][k], np.asarray(rj["outs"][k]),
                                   atol=2e-5, rtol=1e-5, err_msg=k)
    d = os.path.dirname(next(p for n, p in files(tmp_b).items()
                             if n.endswith("energies.dat")))
    vaf = [np.loadtxt(os.path.join(d, f"VAF_interval{k}.dat"), ndmin=2)
           for k in range(2)]
    assert [v.shape[0] for v in vaf] == [3, 2]
    J = np.loadtxt(os.path.join(d, "J_interval0.dat"))
    assert J.shape == (3 * 12 ** 3, 10) and np.isfinite(J).all()
    np.testing.assert_array_equal(np.unique(J[:, 0]), [0, 2, 4])


def test_ensemble_interval_trees_match_jax(tmp_path):
    cfg_j = jlc.CoolingConfig(fused_interpret=True, use_pallas=False,
                              save_directory=str(tmp_path / "jax"), **IV)
    states0 = jax_member_states(cfg_j, 2, seed=3)
    fj, _ = jlc.run_ensemble(cfg_j, 2, seed=3)
    ft, _ = tlc.run_ensemble(
        tlc.CoolingConfig(save_directory=str(tmp_path / "torch"), **IV), 2,
        seed=3, device="cpu", states=states0,
        rolls_fn=jax_rolls(states0.key[0]))
    assert_states_close(ft, fj)
    assert_trees_close(str(tmp_path / "jax"), str(tmp_path / "torch"))
    assert_vholders_close(str(tmp_path / "jax"), str(tmp_path / "torch"))
    assert sum(n.endswith("VAF_interval1.dat")
               for n in files(str(tmp_path / "torch"))) == 2


@pytest.mark.parametrize("ascii_resume", [False, True])
def test_vholder_restored_across_resume(tmp_path, ascii_resume):
    """An interval that began before a walltime splice streams on from
    the restored origin, from the native checkpoint's vholder or (ASCII)
    the VZERO files; leg-1 rows stay untouched and the terminal VZERO
    carries the same origin."""
    cfg1 = tlc.CoolingConfig(n0=48, tmax=0.02, sample_freq=2,
                             vaf_intervals=(0.005,),
                             checkpoint_every_segments=2,
                             save_directory=str(tmp_path))
    tlc.run(cfg1, device="cpu")
    d = _job_dirs(tmp_path)[0]
    vaf1 = np.loadtxt(os.path.join(d, "VAF_interval0.dat"), ndmin=2)
    vzero1 = np.loadtxt(os.path.join(d, "VZERO_timestep000009_interval0.dat"))
    assert np.any(vzero1) and vaf1.shape[0] == 4
    if ascii_resume:
        for n, p in files(str(tmp_path)).items():
            if n.endswith(".npz"):
                os.remove(p)
    cfg2 = dataclasses.replace(cfg1, tmax=0.04)
    tlc.run(cfg2, resume=True, device="cpu")
    vaf = np.loadtxt(os.path.join(d, "VAF_interval0.dat"), ndmin=2)
    t = (np.arange(1, 11) * 2 - 1) * 0.002 + 0.002 / 25
    n_expected = 10 - int(np.argmin(np.abs(t - 0.005)))
    assert vaf.shape[0] == n_expected == 9
    np.testing.assert_array_equal(vaf[:4], vaf1)
    np.testing.assert_allclose(np.diff(vaf[:, 0]), 0.004, rtol=1e-6)
    vzero2 = np.loadtxt(os.path.join(d, "VZERO_timestep000019_interval0.dat"))
    np.testing.assert_allclose(vzero2, vzero1, rtol=1e-5, atol=1e-12)
    # the first continuation row is <v0 . v(t)> with the restored origin
    assert vaf[4, 1] != 0.0


def test_vaf_interval_before_first_sample(tmp_path):
    """An interval starting before the first output sample snaps to
    sample 0 on a fresh run, whose first row is <|v(t0)|^2> at the
    reference's output instant (one tick into the sampling MD step)."""
    cfg = tlc.CoolingConfig(n0=32, tmax=0.02, sample_freq=5,
                            vaf_intervals=(0.0001,),
                            save_directory=str(tmp_path))
    tlc.run(cfg, device="cpu")
    vaf = np.loadtxt(os.path.join(_job_dirs(tmp_path)[0],
                                  "VAF_interval0.dat"), ndmin=2)
    assert vaf.shape[0] == 2
    t0 = (cfg.sample_freq - 1) * cfg.timestep + cfg.timestep / cfg.ratio
    assert vaf[0, 0] == pytest.approx(t0, rel=1e-6)
    assert vaf[0, 1] > 0.0


def test_lccf_matches_direct_sum():
    n, L = 40, 5.0
    rng = np.random.default_rng(5)
    R = rng.uniform(0, L, (n, 3))
    V = rng.normal(size=(n, 3))
    kv = ts.k_grid(L, 4)
    np.testing.assert_array_equal(kv, js.k_grid(L, 4))
    J = ts.current_fourier(torch.from_numpy(R), torch.from_numpy(V),
                           torch.from_numpy(kv)).numpy()
    ref = np.zeros((3, kv.shape[0]), complex)
    for kidx in range(kv.shape[0]):
        ph = np.exp(1j * R @ kv[kidx])
        for a in range(3):
            ref[a, kidx] = (V[:, a] * ph).sum()
    assert np.abs(J - ref).max() < 1e-8
    Jj = np.asarray(js.current_fourier(jnp.asarray(R), jnp.asarray(V),
                                       jnp.asarray(kv)))
    assert np.abs(J - Jj).max() < 1e-8
    # float32 (the runs' precision): 1e-5 of the largest |J|
    J32 = ts.current_fourier(*(torch.from_numpy(x.astype(np.float32))
                               for x in (R, V, kv))).numpy()
    assert np.abs(J32 - ref).max() < 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_vholder_resumes_across_packages(tmp_path, direction):
    """Window 1 (4 MD steps, an interval starting at its first sample)
    by one package, window 2 (to 6 steps) by the other: the interval
    streams on from the restored origin."""
    iv = dict(vaf_intervals=(0.003,))
    if direction == "jax_to_port":
        jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
        cfg1 = _jax_cfg(jax_dir, **iv)
        jlc.run(cfg1)
        shutil.copytree(jax_dir, port_dir)
        jlc.run(dataclasses.replace(cfg1, tmax=0.012), resume=True)
        cfg_t = tlc.CoolingConfig(save_directory=str(port_dir), n0=64,
                                  sample_freq=2, tmax=0.012,
                                  checkpoint_every_segments=1, **iv)
        key = jax_rolls(_key_of(_job_dirs(port_dir)[0], 3))
        tlc.run(cfg_t, resume=True, device="cpu", rolls_fn=key)
        assert_trees_close(str(jax_dir), str(port_dir))
        assert_vholders_close(str(jax_dir), str(port_dir))
        d = _job_dirs(port_dir)[0]
    else:
        cfg_t = tlc.CoolingConfig(save_directory=str(tmp_path), n0=64,
                                  sample_freq=2, tmax=0.008,
                                  checkpoint_every_segments=1, **iv)
        tlc.run(cfg_t, device="cpu")
        d = _job_dirs(tmp_path)[0]
        vaf1 = np.loadtxt(os.path.join(d, "VAF_interval0.dat"), ndmin=2)
        vh1 = ckpt.load_native(d, 3)["vholder"]
        jlc.run(_jax_cfg(tmp_path, tmax=0.012, **iv), resume=True)
        vaf = np.loadtxt(os.path.join(d, "VAF_interval0.dat"), ndmin=2)
        assert vaf1.shape[0] == 2
        np.testing.assert_array_equal(vaf[:2], vaf1)
        np.testing.assert_array_equal(ckpt.load_native(d, 5)["vholder"], vh1)
    vaf = np.loadtxt(os.path.join(d, "VAF_interval0.dat"), ndmin=2)
    assert vaf.shape[0] == 3 and np.all(np.diff(vaf[:, 0]) > 0)
    np.testing.assert_allclose(
        np.loadtxt(os.path.join(d, "VZERO_timestep000005_interval0.dat")),
        np.loadtxt(os.path.join(d, "VZERO_timestep000003_interval0.dat")))


def test_cli_interval_flags(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "mdqtplasmasims_torch.cli", "cooling",
         "--n0", "32", "--tmax", "0.008", "--sample-freq", "2",
         "--vaf-intervals", "0.001,0.005", "--record-lccf", "true",
         "--device", "cpu", "--save-directory", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    names = {os.path.basename(n) for n in files(str(tmp_path))}
    assert {"VAF_interval0.dat", "VAF_interval1.dat",
            "J_interval0.dat"} <= names
