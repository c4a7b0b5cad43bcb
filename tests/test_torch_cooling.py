"""The port's flagship slice as a whole against the JAX package (CPU).

Both sides run ``laser_cooling.run`` on the same small config (N0=64,
tmax=0.01, sample_freq=2: 5 MD steps = 2 samples + 1 trailing step, so
the split sampling step and the off-grid span both run) from the same
initial state, the port fed JAX's own uniforms through its scheduler's
``rolls_fn`` (the key chain of scheduler.py:219-220).  JAX runs both
Pallas kernels in interpret mode.

Tolerances: R/V 2e-5 and psi 5e-5 absolute (tests/test_fused.py's bars);
sampled observables 1e-4 relative to each array's largest value (f32
sums in another order); .dat files the same after %g formatting up to
that tolerance.  Also: the port never imports JAX, and its CLI runs.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.experiments import laser_cooling as jlc
from mdqtplasmasims_tpu.io.datfiles import read_rows
from mdqtplasmasims_torch.bridge import state_from_numpy, state_to_numpy
from mdqtplasmasims_torch.experiments import laser_cooling as tlc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n0=64, tmax=0.01, sample_freq=2)


def _jax_rolls(key):
    """rolls_fn replaying the JAX scheduler's draws: per MD step
    ``key, sub = split(key)`` then ``uniform(sub, (n_ticks*5, npad))``."""
    box = [key]

    def rolls_fn(n_ticks, npad):
        box[0], sub = jax.random.split(box[0])
        return torch.from_numpy(np.array(
            jax.random.uniform(sub, (n_ticks * 5, npad), jnp.float32)))
    return rolls_fn


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    tmp_a = str(tmp_path_factory.mktemp("jax"))
    tmp_b = str(tmp_path_factory.mktemp("torch"))
    cfg_j = jlc.CoolingConfig(fused_interpret=True, use_pallas=False,
                              save_directory=tmp_a, **SMALL)
    state0 = jlc.initial_state(cfg_j)
    fin_j, res_j = jlc.run(cfg_j)
    cfg_t = tlc.CoolingConfig(save_directory=tmp_b, **SMALL)
    fin_t, res_t = tlc.run(cfg_t, state=state_from_numpy(state0,
                                                         device="cpu"),
                           device="cpu", rolls_fn=_jax_rolls(state0.key))
    return (fin_j, res_j, tmp_a), (fin_t, res_t, tmp_b)


def test_final_state_matches_jax(both_runs):
    (fj, _, _), (ft, _, _) = both_runs
    for name, atol in (("R", 2e-5), ("V", 2e-5), ("F", 2e-5),
                       ("t_part", 2e-5)):
        np.testing.assert_allclose(getattr(ft, name),
                                   np.asarray(getattr(fj, name)),
                                   atol=atol, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(ft.psi, np.asarray(fj.psi), atol=5e-5)
    assert ft.tick == int(fj.tick) == 5 * 25
    assert ft.t == float(fj.t)


def test_sampled_outputs_match_jax(both_runs):
    (_, rj, _), (_, rt, _) = both_runs
    oj, ot = rj["outs"], rt["outs"]
    assert set(ot) == {"t", "ekin", "epot", "vx_mean", "pvel", "vx_ions",
                       "pops"} <= set(oj)
    np.testing.assert_array_equal(ot["t"], np.asarray(oj["t"]))
    for k in ("ekin", "epot", "vx_mean", "pvel", "vx_ions", "pops"):
        a, b = ot[k], np.asarray(oj[k])
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max(), err_msg=k)
    np.testing.assert_allclose(rt["epot0"], rj["epot0"], rtol=1e-5)
    np.testing.assert_allclose(ot["pops"].sum(-1), 1.0, atol=1e-4)


def test_dat_and_checkpoint_trees_match_jax(both_runs):
    (_, _, tmp_a), (_, _, tmp_b) = both_runs
    fa, fb = _files(tmp_a), _files(tmp_b)
    assert sorted(fa) == sorted(fb)
    names = sorted(fa)
    assert any(n.endswith("energies.dat") for n in names)
    assert any("wvFns_timestep000004.dat" in n for n in names)
    for name in names:
        if name.endswith(".npz"):
            with np.load(fa[name]) as za, np.load(fb[name]) as zb:
                for k in ("R", "V", "psi", "counter", "c0", "t_part"):
                    np.testing.assert_allclose(zb[k], za[k], atol=5e-5,
                                               err_msg=f"{name}:{k}")
            continue
        a, b = read_rows(fa[name]), read_rows(fb[name])
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-4 * max(np.abs(a).max(), 1e-30),
                                   err_msg=name)


def test_unported_options_raise():
    """What the port still refuses: float64 on CUDA (a fold on CUDA mesh
    slots too), a mesh the members do not divide over (multi-device folds
    themselves are ported: tests/test_torch_mesh_run.py), and a CUDA run
    without a card (no fallback to the CPU)."""
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    cfg = tlc.CoolingConfig(**SMALL)
    f64 = tlc.CoolingConfig(dtype="float64", **SMALL)
    with pytest.raises(NotImplementedError, match="float64"):
        tlc.run(f64, device="cuda")
    with pytest.raises(NotImplementedError, match="float64"):
        tlc.run_ensemble(f64, 2, device="cuda")
    with pytest.raises(NotImplementedError, match="float64"):
        tlc.run_ensemble(f64, 2, mesh=make_mesh(2, 1, devices=["cuda"] * 2))
    mesh = make_mesh(3, 1, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="divide"):
        tlc.run_ensemble(cfg, 2, mesh=mesh)
    with pytest.raises(ValueError, match="divide"):
        tlc.run_sweep(cfg, [(-1.0, 1.0)], mesh=mesh)
    if not torch.cuda.is_available():
        for call in (lambda: tlc.run(cfg, device="cuda"),
                     lambda: tlc.run_ensemble(cfg, 2, device="cuda")):
            with pytest.raises(RuntimeError):
                call()


def test_float64_cpu_run_tracks_float32():
    """The same stepping path in float64 on the CPU (the twins run in the
    planes' dtype) stays within float32 noise of the float32 run from the
    same start with the same draws (uniforms are drawn in float32)."""
    cfg = tlc.CoolingConfig(**SMALL)
    start = state_to_numpy(tlc.initial_state(
        cfg, torch.Generator().manual_seed(3)))
    outs = {}
    for dt in ("float32", "float64"):
        th = torch.float64 if dt == "float64" else torch.float32
        _, res = tlc.run(tlc.CoolingConfig(dtype=dt, **SMALL), seed=4,
                         state=state_from_numpy(start, device="cpu",
                                                dtype=th), device="cpu")
        outs[dt] = res["outs"]
    for k in ("ekin", "epot", "pops"):
        b = outs["float64"][k]
        np.testing.assert_allclose(outs["float32"][k], b, rtol=0,
                                   atol=1e-3 * np.abs(b).max(), err_msg=k)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = sys.modules['jaxlib'] = None   # block\n"
        "import mdqtplasmasims_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 12, mods\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and ("
        "m == 'jax' or m.startswith('jax.') or m.startswith('jaxlib'))]\n"
        "assert not bad, bad[:5]\n"
        "from mdqtplasmasims_torch.experiments import laser_cooling as lc\n"
        "cfg = lc.CoolingConfig(n0=32, tmax=0.004, sample_freq=2,\n"
        "                       exact_n=False, checkpoint_every_segments=1)\n"
        "lc.run_sweep(cfg, [{'detuning': -1.0, 'om': 0.9},\n"
        "                   {'detuning': -0.5, 'om': 1.1}], device='cpu')\n"
        "lc.run(cfg, device='cpu')\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_cli_cooling_writes_energies(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "mdqtplasmasims_torch.cli", "cooling",
         "--n0", "64", "--tmax", "0.01", "--sample-freq", "2",
         "--device", "cpu", "--save-directory", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    found = [f for f in _files(str(tmp_path)) if f.endswith("energies.dat")]
    assert len(found) == 1
    rows = read_rows(os.path.join(str(tmp_path), found[0]), expect_cols=7)
    assert rows.shape[0] == 2 and np.isfinite(rows).all()


def test_md_step_matches_jax():
    """One full MD step of the scheduler (forces, then 25 fused ticks with
    the first-step drift) from the same state with the same uniforms."""
    cfg_j = jlc.CoolingConfig(fused_interpret=True, use_pallas=False,
                              **SMALL)
    state0 = jlc.initial_state(cfg_j)
    out_j = jlc.build_scheduler(cfg_j).md_step(state0)
    sched = tlc.build_scheduler(tlc.CoolingConfig(**SMALL), "cpu",
                                _jax_rolls(state0.key))
    out_t = sched.md_step(state_from_numpy(state0, device="cpu"))
    for name, atol in (("R", 2e-5), ("V", 2e-5), ("F", 2e-5),
                       ("t_part", 2e-5), ("psi", 5e-5)):
        np.testing.assert_allclose(getattr(out_t, name).numpy(),
                                   np.asarray(getattr(out_j, name)),
                                   atol=atol, rtol=1e-5, err_msg=name)
    assert out_t.tick == int(out_j.tick) == 25
    assert out_t.t == float(out_j.t)
