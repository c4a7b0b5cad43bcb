"""The port's three-state family against the JAX package (CPU).

``run``, ``run_ensemble`` and ``run_sweep`` of both packages on the same
small config (N0=48, 60 ticks in 3 segments) from the JAX start
velocities, the port fed JAX's own uniforms through ``rolls_fn``: the key
chain of three_state.py:69-71 there (one split per tick, ``uniform(sub,
(5, n))``), per member in a fold.  The sweep gets JAX's tables through
``bridge.qt_params_from_numpy``.

Tolerances: final V 2e-5 absolute (tests/test_fused.py's bar); the
per-segment records 1e-4 of each array's largest value; energies.dat the
same after %g formatting up to that.  Port-only properties (a fold member
against its own run, the identity sweep member, a mesh against the single
fold, ``dispatch_segments``) are bitwise.  The mirrored cases of
tests/test_experiments.py (TestThreeState, test_three_state_run_ensemble,
the three-state sweep case) and tests/test_parallel.py:270 run on the
port alone.
"""

import dataclasses
import glob
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.experiments import three_state as jts
from mdqtplasmasims_tpu.io.datfiles import read_rows
from mdqtplasmasims_tpu.units import SQRT_KELVIN_TO_PLASMA_VEL
from mdqtplasmasims_torch.bridge import qt_params_from_numpy
from mdqtplasmasims_torch.experiments import three_state as tts
from mdqtplasmasims_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

SMALL = dict(n0=48, tmax=0.6, sample_freq=20, temperature_k=0.01)
POINTS = [{"detuning": -0.5, "om": 0.5}, {"detuning": -2.0, "om": 1.0}]


@partial(jax.jit, static_argnames=("nt", "n"))
def _chain(key, nt, n):
    """``nt`` ticks of the JAX run's draws from ``key``: split once per
    tick, ``uniform(sub, (5, n))``.  Returns ``(key, [nt, 5, n])``."""
    def tick(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.uniform(sub, (5, n), jnp.float32)
    return jax.lax.scan(tick, key, None, length=nt)


def _jax_rolls(keys):
    """rolls_fn replaying the chains of ``keys`` (one key: lanes ``(n,)``;
    a list: member j's chain from key j, lanes ``(E, n)``)."""
    box = list(keys) if isinstance(keys, (list, tuple)) else [keys]
    single = not isinstance(keys, (list, tuple))

    def rolls_fn(nt, lanes):
        out = []
        for j in range(len(box)):
            box[j], r = _chain(box[j], nt, lanes[-1])
            out.append(np.array(r))
        u = out[0] if single else np.stack(out, axis=2)
        return torch.from_numpy(u)
    return rolls_fn


def _jax_start(key, cfg):
    """The start of ``jts.run`` / ``init_one``: (V [n0, 3], run key)."""
    kv, krun = jax.random.split(key)
    sigma = SQRT_KELVIN_TO_PLASMA_VEL * np.sqrt(cfg.temperature_k)
    V = jax.random.normal(kv, (cfg.n0, 3), jnp.float32) * jnp.asarray(
        sigma, jnp.float32)
    return np.array(V), krun


def _close(got, want, what):
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max(), err_msg=what)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    tmp_a = str(tmp_path_factory.mktemp("jax"))
    tmp_b = str(tmp_path_factory.mktemp("torch"))
    res_j = jts.run(jts.ThreeStateConfig(save_directory=tmp_a, **SMALL))
    cfg_t = tts.ThreeStateConfig(save_directory=tmp_b, **SMALL)
    V0, krun = _jax_start(jax.random.PRNGKey(cfg_t.job), cfg_t)
    res_t = tts.run(cfg_t, device="cpu", V=V0, rolls_fn=_jax_rolls(krun))
    return (res_j, tmp_a), (res_t, tmp_b)


def test_run_matches_jax(single):
    (rj, _), (rt, _) = single
    assert set(rt) == set(rj) == {"t", "ekin_x", "ground_pop", "V"}
    np.testing.assert_array_equal(rt["t"], rj["t"])
    assert rt["ekin_x"].shape == (3,) and rt["ekin_x"].dtype == np.float32
    _close(rt["ekin_x"], rj["ekin_x"], "ekin_x")
    _close(rt["ground_pop"], rj["ground_pop"], "ground_pop")
    np.testing.assert_allclose(rt["V"], rj["V"], atol=2e-5, rtol=0)
    assert rt["ground_pop"][-1] < 0.999          # the lasers pumped


def test_energies_tree_matches_jax(single):
    (_, tmp_a), (_, tmp_b) = single
    fa = sorted(glob.glob(os.path.join(tmp_a, "**", "*.dat"), recursive=True))
    fb = sorted(glob.glob(os.path.join(tmp_b, "**", "*.dat"), recursive=True))
    assert [os.path.relpath(p, tmp_a) for p in fa] == [
        os.path.relpath(p, tmp_b) for p in fb]
    assert len(fa) == 1 and fa[0].endswith(os.path.join("job1",
                                                        "energies.dat"))
    a, b = read_rows(fa[0], expect_cols=2), read_rows(fb[0], expect_cols=2)
    np.testing.assert_array_equal(b[:, 0], a[:, 0])
    _close(b[:, 1], a[:, 1], "energies.dat")


def _member_starts(cfg, seed, n):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    starts = [_jax_start(k, cfg) for k in keys]
    return np.stack([v for v, _ in starts]), [k for _, k in starts]


def test_run_ensemble_matches_jax(tmp_path):
    cfg_t = tts.ThreeStateConfig(save_directory=str(tmp_path / "t"), **SMALL)
    rj = jts.run_ensemble(jts.ThreeStateConfig(
        save_directory=str(tmp_path / "j"), **SMALL), 3, seed=2)
    V0, kruns = _member_starts(cfg_t, 2, 3)
    rt = tts.run_ensemble(cfg_t, 3, seed=2, device="cpu", V=V0,
                          rolls_fn=_jax_rolls(kruns))
    assert rt["ekin_x"].shape == (3, 3)
    _close(rt["ekin_x"], rj["ekin_x"], "ekin_x")
    _close(rt["ground_pop"], rj["ground_pop"], "ground_pop")
    np.testing.assert_allclose(rt["V"], rj["V"], atol=2e-5, rtol=0)
    for j in (1, 2, 3):
        a = glob.glob(str(tmp_path / "j" / "**" / f"job{j}" / "energies.dat"),
                      recursive=True)
        b = glob.glob(str(tmp_path / "t" / "**" / f"job{j}" / "energies.dat"),
                      recursive=True)
        assert len(a) == len(b) == 1
        assert (os.path.relpath(a[0], tmp_path / "j")
                == os.path.relpath(b[0], tmp_path / "t"))
        _close(read_rows(b[0]), read_rows(a[0]), f"job{j}")


def test_run_sweep_matches_jax(tmp_path):
    from mdqtplasmasims_tpu.core.qt import sweep_member_params
    from mdqtplasmasims_tpu.levels import three_state
    cfg_j = jts.ThreeStateConfig(save_directory=str(tmp_path / "j"), **SMALL)
    cfg_t = tts.ThreeStateConfig(save_directory=str(tmp_path / "t"), **SMALL)
    rj, mj = jts.run_sweep(cfg_j, POINTS, jobs_per_point=2, seed=4)
    _, pj = sweep_member_params(cfg_j, POINTS, 2,
                                three_state(1.0, 1.0, cfg_j.vkick),
                                jnp.float32, jnp.complex64)
    V0, kruns = _member_starts(cfg_t, 4, 4)
    rt, mt = tts.run_sweep(cfg_t, POINTS, jobs_per_point=2, seed=4,
                           device="cpu", V=V0, rolls_fn=_jax_rolls(kruns),
                           qt_params=qt_params_from_numpy(pj, device="cpu"))
    assert [(m.detuning, m.om, m.job) for m in mt] == [
        (m.detuning, m.om, m.job) for m in mj]
    _close(rt["ekin_x"], rj["ekin_x"], "ekin_x")
    _close(rt["ground_pop"], rj["ground_pop"], "ground_pop")
    np.testing.assert_allclose(rt["V"], rj["V"], atol=2e-5, rtol=0)
    # the members of the two points differ (another Hamiltonian)
    assert np.abs(rt["ground_pop"][0] - rt["ground_pop"][2]).max() > 1e-3
    rel = sorted(os.path.relpath(p, tmp_path / "j") for p in glob.glob(
        str(tmp_path / "j" / "**" / "energies.dat"), recursive=True))
    assert rel == sorted(os.path.relpath(p, tmp_path / "t") for p in glob.glob(
        str(tmp_path / "t" / "**" / "energies.dat"), recursive=True))
    assert len(rel) == 4


# ------------------------------------------------- the port on its own

def test_fold_member_equals_its_own_run_bitwise():
    """Member j of a fold, from the same start with the same uniforms,
    comes out as the single run does."""
    cfg = tts.ThreeStateConfig(**SMALL)
    V0, kruns = _member_starts(cfg, 7, 3)
    fold = tts.run_ensemble(cfg, 3, device="cpu", V=V0,
                            rolls_fn=_jax_rolls(kruns))
    for j in range(3):
        one = tts.run(cfg, device="cpu", V=V0[j],
                      rolls_fn=_jax_rolls(kruns[j]))
        np.testing.assert_array_equal(fold["ekin_x"][j], one["ekin_x"])
        np.testing.assert_array_equal(fold["V"][j], one["V"])


def test_doppler_cooling():
    """tests/test_experiments.py TestThreeState.test_doppler_cooling at a
    depth the host loop covers in seconds: x kinetic energy falls."""
    cfg = tts.ThreeStateConfig(n0=300, tmax=120.0, sample_freq=3000,
                               temperature_k=0.01)
    res = tts.run(cfg, device="cpu")
    assert res["ekin_x"].shape == (4,)
    assert res["ekin_x"][-1] < 0.97 * res["ekin_x"][0]
    assert np.all(np.diff(res["ekin_x"]) < 0)


def test_no_force_flag():
    cfg = tts.ThreeStateConfig(n0=100, tmax=5.0, sample_freq=100,
                               apply_force=False)
    res = tts.run(cfg, device="cpu")
    # without kicks the velocity distribution is untouched
    assert abs(res["ekin_x"][-1] - res["ekin_x"][0]) < 1e-9
    assert res["ground_pop"][-1] < 1.0


def test_dispatch_groups_bit_identical():
    """``dispatch_segments`` groups nothing in the port: any value gives
    the same run."""
    base = dict(n0=64, tmax=6.0, sample_freq=100, temperature_k=0.01)
    one = tts.run(tts.ThreeStateConfig(**base), device="cpu")
    split = tts.run(tts.ThreeStateConfig(**base, dispatch_segments=2),
                    device="cpu")
    np.testing.assert_array_equal(one["ekin_x"], split["ekin_x"])
    np.testing.assert_array_equal(one["V"], split["V"])


def test_roll_blocks_do_not_change_a_replayed_run(monkeypatch):
    """The uniforms are drawn a block of ticks at a time; with replayed
    draws the block size changes nothing."""
    cfg = tts.ThreeStateConfig(**SMALL)
    V0, krun = _jax_start(jax.random.PRNGKey(3), cfg)
    whole = tts.run(cfg, device="cpu", V=V0, rolls_fn=_jax_rolls(krun))
    monkeypatch.setattr(tts, "ROLL_BLOCK_FLOATS", 5 * cfg.n0 * 7)
    parts = tts.run(cfg, device="cpu", V=V0, rolls_fn=_jax_rolls(krun))
    np.testing.assert_array_equal(whole["ekin_x"], parts["ekin_x"])
    np.testing.assert_array_equal(whole["V"], parts["V"])


def test_three_state_run_ensemble(tmp_path):
    cfg = tts.ThreeStateConfig(n0=64, tmax=8.0, sample_freq=100,
                               dispatch_segments=2,
                               save_directory=str(tmp_path))
    res = tts.run_ensemble(cfg, n_jobs=3, seed=2, device="cpu")
    assert res["ekin_x"].shape == (3, 8)
    assert np.isfinite(res["ekin_x"]).all()
    assert not np.allclose(res["ekin_x"][0], res["ekin_x"][1])
    job_dirs = sorted(str(p.parent) for p in tmp_path.rglob("energies.dat"))
    assert len(job_dirs) == 3
    for d in job_dirs:
        e = np.loadtxt(os.path.join(d, "energies.dat")).reshape(-1, 2)
        assert e.shape[0] == 8
    # a member does not depend on the size of its fold
    more = tts.run_ensemble(dataclasses.replace(cfg, save_directory=None), 4,
                            seed=2, device="cpu")
    np.testing.assert_array_equal(more["ekin_x"][:3], res["ekin_x"])


def test_three_state_sweep_identity_and_layout(tmp_path):
    cfg = tts.ThreeStateConfig(n0=64, tmax=5.0, sample_freq=100,
                               dispatch_segments=10,
                               save_directory=str(tmp_path))
    res, mcfgs = tts.run_sweep(
        cfg, [{"detuning": cfg.detuning, "om": cfg.om},
              {"detuning": -2.0, "om": 1.0}], seed=4, device="cpu")
    ens = tts.run_ensemble(dataclasses.replace(cfg, save_directory=None), 1,
                           seed=4, device="cpu")
    np.testing.assert_array_equal(res["ekin_x"][0], ens["ekin_x"][0])
    assert [m.om for m in mcfgs] == [0.5, 1.0]
    # layout: Om<om*100>/Det<det*100>.../job<j>/energies.dat
    files = sorted(glob.glob(str(tmp_path / "Om*" / "Det*" / "job1"
                                 / "energies.dat")))
    assert len(files) == 2, files
    assert any("Om50/" in f for f in files), files     # cfg.om = 0.5
    assert any("Om100/" in f for f in files), files    # swept om = 1.0
    with pytest.raises(ValueError, match="override"):
        tts.run_sweep(cfg, [{"n0": 8}], device="cpu")
    with pytest.raises(ValueError, match="nonzero"):
        tts.run_sweep(tts.ThreeStateConfig(n0=8, om=0.0, tmax=1.0),
                      [{"om": 1.0}], device="cpu")


def test_member_sharded_ensemble_and_sweep_bitwise():
    """tests/test_parallel.py:270 on the port: the fold over the ens
    slots of a mesh equals the single fold bit for bit."""
    cfg = tts.ThreeStateConfig(n0=64, tmax=3.0, sample_freq=100,
                               dispatch_segments=3)
    mesh = make_mesh(4, 1, devices=["cpu"] * 4)
    a = tts.run_ensemble(cfg, 8, seed=4, device="cpu")
    b = tts.run_ensemble(cfg, 8, seed=4, mesh=mesh)
    np.testing.assert_array_equal(a["ekin_x"], b["ekin_x"])
    np.testing.assert_array_equal(a["V"], b["V"])
    pts = [{"detuning": d} for d in (-0.5, -1, -2, -4)]
    ra, _ = tts.run_sweep(cfg, pts, jobs_per_point=2, seed=4, device="cpu")
    rb, _ = tts.run_sweep(cfg, pts, jobs_per_point=2, seed=4, mesh=mesh)
    np.testing.assert_array_equal(ra["ekin_x"], rb["ekin_x"])
    assert not np.array_equal(ra["ground_pop"][0], ra["ground_pop"][6])


def test_guards():
    cfg = tts.ThreeStateConfig(n0=16, tmax=1.0, sample_freq=100)
    with pytest.raises(ValueError, match="ion shards"):
        tts.run_ensemble(cfg, 8, mesh=make_mesh(2, 2, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="divide"):
        tts.run_ensemble(cfg, 6, mesh=make_mesh(4, 1, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="want V"):
        tts.run(cfg, device="cpu", V=np.zeros((3, 3), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tts.run(cfg)                      # the default device is cuda


def test_float64_runs_and_tracks_float32():
    base = dict(n0=32, tmax=1.0, sample_freq=50)
    V0, krun = _jax_start(jax.random.PRNGKey(1),
                          tts.ThreeStateConfig(**base))
    out = {dt: tts.run(tts.ThreeStateConfig(dtype=dt, **base), device="cpu",
                       V=V0, rolls_fn=_jax_rolls(krun))
           for dt in ("float32", "float64")}
    assert out["float64"]["V"].dtype == np.float64
    np.testing.assert_allclose(out["float32"]["ekin_x"],
                               out["float64"]["ekin_x"], rtol=1e-4)


def test_doppler_limit_ekin_equals_jax():
    for det in (-0.5, -1.0, -3.0):
        assert tts.doppler_limit_ekin(det) == jts.doppler_limit_ekin(det)
