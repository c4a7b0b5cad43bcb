"""The port's frozen-start tagging family against the JAX package (CPU).

Both packages run ``frozen_tagging.run`` (all three variants),
``run_ensemble`` (exact-N and Poissonian folds) and ``run_sweep`` on the
same small config (N0=40, 50 MD steps of the reference's 0.002 past a pump
window of some 630 ticks, 3 output blocks and a 2-step tail; the quantum
step is the production one, so that no ion's norm inflates far from 1
inside the window and the float32 bars below keep their meaning) from the JAX start state,
the port fed JAX's own uniforms through ``rolls_fn`` / ``measure_fn``: the
key chain of scheduler.py:457-468 there (one split per windowed MD step,
the lane-major ``uniform(sub, (n, ratio*5))``) and of ``measure`` (one more
split, ``uniform(sub, (n,))``), per member in a fold.  JAX runs its XLA
force path (``use_pallas=False``), whose math the port's CPU twin shares.

Tolerances: R/V/F/t_part 2e-5 and psi 5e-5 absolute (tests/test_fused.py's
bars); output blocks 1e-4 of each array's largest value; ``spin_up``
equal; the .dat and checkpoint trees equal file for file (rows after %g up
to that tolerance).  Port-only properties (fold member against its own
run, identity sweep member, mesh against single fold, resume against the
uninterrupted run) are bitwise.  The cases of tests/test_experiments.py
(TestFrozenTagging, TestFrozenTagPoissonEnsemble, TestTaggingSweeps),
tests/test_scheduler.py:95/:129 and tests/test_parallel.py:236 are
mirrored on the port.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.core.init import frozen_gas_init, frozen_gas_positions
from mdqtplasmasims_tpu.core.qt import (random_s_superposition,
                                        sweep_member_params)
from mdqtplasmasims_tpu.experiments import frozen_tagging as jft
from mdqtplasmasims_tpu.io import checkpoint as jckpt
from mdqtplasmasims_tpu.io.datfiles import read_rows
from mdqtplasmasims_tpu.units import PlasmaUnits
from mdqtplasmasims_torch.bridge import (NumpyState, qt_params_from_numpy,
                                         state_from_numpy)
from mdqtplasmasims_torch.core.scheduler import lane_major_rolls
from mdqtplasmasims_torch.experiments import frozen_tagging as tft
from mdqtplasmasims_torch.io import checkpoint as tckpt
from mdqtplasmasims_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

SMALL = dict(n0=40, tstart=0.02, tmax=0.1, timestep=0.002, sample_freq=4,
             tpump_seconds=5e-8)
# the configs of the JAX package's own tests (a longer, coarser run)
LONG = dict(variant="422linear", n0=48, tstart=1.0, tmax=3.0, timestep=0.01,
            sample_freq=20, tpump_seconds=2e-7)
STATE_BARS = (("R", 2e-5), ("V", 2e-5), ("F", 2e-5), ("t_part", 2e-5),
              ("psi", 5e-5))
BLOCK_KEYS = ("energies", "pvel_x", "moments", "vaf", "long_kin")


class JaxDraws:
    """Replays the JAX run's key chain: ``rolls_fn`` and ``measure_fn`` of
    one job (``keys`` a single key) or of a fold (a list, one chain per
    member)."""

    def __init__(self, keys):
        self.single = not isinstance(keys, (list, tuple))
        self.keys = [keys] if self.single else list(keys)

    def _each(self, draw):
        out = []
        for j in range(len(self.keys)):
            self.keys[j], sub = jax.random.split(self.keys[j])
            out.append(np.array(draw(sub)))
        return out

    def rolls_fn(self, ratio, lanes):
        n = lanes[-1]
        out = self._each(lambda sub: jax.random.uniform(
            sub, (n, ratio * 5), jnp.float32).T.reshape(ratio, 5, n))
        return torch.from_numpy(out[0] if self.single
                                else np.stack(out, axis=2))

    def measure_fn(self, lanes):
        out = self._each(lambda sub: jax.random.uniform(
            sub, (lanes[-1],), jnp.float32))
        return torch.from_numpy(out[0] if self.single else np.stack(out))


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, fs in os.walk(root) for f in fs}


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _check_state(ft, fj, n=None):
    for name, atol in STATE_BARS:
        np.testing.assert_allclose(getattr(ft, name)[:n],
                                   np.asarray(getattr(fj, name))[:n],
                                   atol=atol, rtol=1e-5, err_msg=name)
    assert ft.tick == int(fj.tick)
    assert ft.t == float(fj.t)


def _check_results(rt, rj):
    assert set(rt["outs"]) == set(rj["outs"]) == set(BLOCK_KEYS) | {"t",
                                                                    "n_up"}
    for blocks_t, blocks_j in ((rt["outs"], rj["outs"]),
                               (rt["out_tag"], rj["out_tag"])):
        np.testing.assert_array_equal(blocks_t["t"], np.asarray(blocks_j["t"]))
        assert np.asarray(blocks_t["t"]).dtype == np.float32
        np.testing.assert_array_equal(blocks_t["n_up"],
                                      np.asarray(blocks_j["n_up"]))
        for k in BLOCK_KEYS:
            _close(blocks_t[k], blocks_j[k], k)
    np.testing.assert_array_equal(rt["spin_up"], rj["spin_up"])
    np.testing.assert_allclose(rt["vholder"], rj["vholder"], atol=2e-5)
    np.testing.assert_allclose(rt["epot0"], rj["epot0"], rtol=1e-5)
    assert rt["n_md_a"] == rj["n_md_a"]


def _check_trees(tmp_a, tmp_b, kde_rel=1e-4):
    """``kde_rel``: the bar of the vel_distX files, as a share of the
    largest bin.  The KDE's kernel is 0.002 wide, so a bin moves by some
    1e-2 of its height for a velocity difference at the 2e-5 bar; runs
    that agree in V to float32 rounding hold 1e-4, two packages' separate
    continuations of one checkpoint (V within the bar) hold 1e-3."""
    fa, fb = _files(tmp_a), _files(tmp_b)
    assert sorted(fa) == sorted(fb)
    for name in sorted(fa):
        if name.endswith(".npz"):
            with np.load(fa[name]) as za, np.load(fb[name]) as zb:
                assert set(za.files) == set(zb.files) >= {
                    "R", "V", "psi", "counter", "c0", "spin_up", "vholder",
                    "epot0"}
                for k in za.files:
                    np.testing.assert_allclose(zb[k], za[k], atol=5e-5,
                                               err_msg=f"{name}:{k}")
        elif "spinUpIons_" in name:
            assert open(fa[name]).read() == open(fb[name]).read(), name
        elif "vel_distX" in name:
            a, b = read_rows(fa[name]), read_rows(fb[name])
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=kde_rel * np.abs(a).max(),
                                       err_msg=name)
        else:
            _close(read_rows(fb[name]), read_rows(fa[name]), name)
    return sorted(fa)


# ------------------------------------------------------------ single run

@pytest.fixture(scope="module", params=list(tft.VARIANTS))
def both_runs(request, tmp_path_factory):
    tmp_a = str(tmp_path_factory.mktemp("jax"))
    tmp_b = str(tmp_path_factory.mktemp("torch"))
    cfg_j = jft.FrozenTagConfig(variant=request.param, use_pallas=False,
                                save_directory=tmp_a, **SMALL)
    cfg_t = tft.FrozenTagConfig(variant=request.param, save_directory=tmp_b,
                                **SMALL)
    state0 = jft.initial_state(cfg_j)
    fin_j, res_j = jft.run(cfg_j)
    draws = JaxDraws(state0.key)
    fin_t, res_t = tft.run(cfg_t, device="cpu", state=state0,
                           rolls_fn=draws.rolls_fn,
                           measure_fn=draws.measure_fn)
    return request.param, (fin_j, res_j, tmp_a), (fin_t, res_t, tmp_b)


def test_run_final_state_matches_jax(both_runs):
    variant, (fj, _, _), (ft, _, _) = both_runs
    _check_state(ft, fj)
    assert ft.tick == 50 * tft.FrozenTagConfig(variant=variant, **SMALL).ratio


def test_run_output_blocks_match_jax(both_runs):
    variant, (_, rj, _), (_, rt, _) = both_runs
    _check_results(rt, rj)
    assert rt["outs"]["t"].shape == (3,)
    assert rt["outs"]["pvel_x"].shape == (3, 4001)
    # the pump moved population out of the S superposition
    assert (np.abs(rt["final"].psi[:, 2:]) ** 2).sum() > 0.1


def test_run_trees_match_jax(both_runs):
    variant, (_, _, tmp_a), (_, _, tmp_b) = both_runs
    names = [os.path.basename(n) for n in _check_trees(tmp_a, tmp_b)]
    n_md_a = int(np.ceil(tft.FrozenTagConfig(variant=variant, **SMALL).tend
                         / 0.002))
    ac = "vSquareAutoCorr.dat" if variant == "408quad" else "VAF.dat"
    assert {"energies.dat", "taggedMoments.dat", ac,
            f"spinUpIons_timestep{n_md_a - 1:06d}.dat",
            "checkpoint_000049.npz", "conditions_timestep000049.dat",
            "ions_timestep000049.dat",
            "spinUpIonsList_timestep000049.dat"} <= set(names)
    assert ("VAF.dat" in names) != ("vSquareAutoCorr.dat" in names)
    labels = sorted(int(n[len("vel_distX_timestep"):-4]) for n in names
                    if n.startswith("vel_distX"))
    l0 = n_md_a + (4 - n_md_a % 4) - 1
    want = [l0 + 4 * k for k in range(3)]
    if variant != "422linear":      # the 408s' full row at the tag instant
        want = [n_md_a - 1] + want
    assert labels == want


# ------------------------------------------------------------- scheduler

def _sched_pair(cfg_j, cfg_t, draws):
    return (jft.build_scheduler(cfg_j),
            tft.build_scheduler(cfg_t, rolls_fn=draws.rolls_fn))


@pytest.mark.parametrize("variant", ["422linear", "408linear"])
def test_md_step_and_md_step_pure_match_jax(variant):
    """From the same state inside the pump window with replayed lane-major
    uniforms: one windowed step (every tick pumps), one pure step, and the
    very first step of a run (the 2nd-order first drift)."""
    cfg_j = jft.FrozenTagConfig(variant=variant, use_pallas=False,
                                **{**SMALL, "tstart": 0.0})
    cfg_t = tft.FrozenTagConfig(variant=variant, **{**SMALL, "tstart": 0.0})
    s0 = jft.initial_state(cfg_j)
    sj, st = _sched_pair(cfg_j, cfg_t, JaxDraws(s0.key))
    a_j = sj.md_step(s0)                     # tick 0: first-step drift
    a_t = st.md_step(state_from_numpy(s0, device="cpu"))
    _check_state(a_t_np := _np(a_t), a_j)
    assert not np.array_equal(a_t_np.psi, np.asarray(s0.psi))
    b_j, b_t = sj.md_step(a_j), st.md_step(a_t)      # all ticks in window
    _check_state(_np(b_t), b_j)
    c_j, c_t = sj.md_step_pure(b_j), st.md_step_pure(b_t)
    _check_state(_np(c_t), c_j)
    assert torch.equal(c_t.psi, b_t.psi) and c_t.tick == 3 * cfg_t.ratio


def _np(state):
    from mdqtplasmasims_torch.bridge import state_to_numpy
    return state_to_numpy(state)


def test_in_window_is_strict_and_in_the_state_dtype():
    cfg = tft.FrozenTagConfig(**SMALL)
    sched = tft.build_scheduler(cfg)
    ticks = [k for k in range(60 * cfg.ratio)
             if sched.in_window(k, torch.float32)]
    t = np.float32(np.arange(60 * cfg.ratio)) * np.float32(cfg.qdt)
    want = np.nonzero((t > np.float32(cfg.tstart))
                      & (t < np.float32(cfg.tend)))[0]
    assert ticks == list(want) and len(ticks) > 400


def test_frozen_scheduler_outside_window_is_pure_md():
    """tests/test_scheduler.py:95 and :129 on the port: outside the pump
    window psi and t_part are untouched, and md_step equals md_step_pure
    bit for bit."""
    cfg = tft.FrozenTagConfig(**{**SMALL, "tstart": 100.0})
    gen = torch.Generator().manual_seed(5)
    st = tft.initial_state(cfg, gen)
    st = dataclasses.replace(st, V=0.2 * torch.randn(st.V.shape,
                                                     generator=gen),
                             tick=40)
    sched = tft.build_scheduler(cfg, rolls_fn=lane_major_rolls(gen))
    a, b = sched.md_step(st), sched.md_step_pure(st)
    for name in ("R", "V", "F", "psi", "t_part"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.tick == b.tick == 40 + cfg.ratio and a.t == b.t
    assert torch.equal(a.psi, st.psi) and torch.equal(a.t_part, st.t_part)
    assert not torch.allclose(a.V, st.V)


def test_pump_window_gating():
    """Wavefunctions are frozen outside the pump window
    (TestFrozenTagging.test_pump_window_gating)."""
    cfg = tft.FrozenTagConfig(variant="422linear", n0=32, tstart=5.0,
                              tmax=0.3, tpump_seconds=1e-7)
    gen = torch.Generator().manual_seed(1)
    st = tft.initial_state(cfg, gen)
    out = tft.run_phase_a(cfg, tft.build_scheduler(
        cfg, rolls_fn=lane_major_rolls(gen)), st, 100)
    assert torch.equal(out.psi, st.psi)
    assert not torch.equal(out.R, st.R)


# ----------------------------------------------------------------- folds

def _jax_fold_start(cfg_j, seed, n_members, mask=None):
    """The stacked start of the JAX ``_run_batched`` and the members' run
    keys (its ``init_one``, F left to the port to seed)."""
    L = PlasmaUnits.box_length(cfg_j.n0)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_members)
    Rs, psis, kruns = [], [], []
    for j, key in enumerate(keys):
        k_init, k_run = jax.random.split(key)
        if mask is None:
            R, _, psi, _ = frozen_gas_init(k_init, cfg_j.n0,
                                           n_states=cfg_j.n_states,
                                           exact_n=True, dtype=jnp.float32)
        else:
            kr, kp = jax.random.split(k_init)
            mc = jnp.asarray(mask[j])[:, None]
            n_arr = mask.shape[1]
            R = frozen_gas_positions(kr, n_arr, L, jnp.float32) * mc
            psi = random_s_superposition(kp, n_arr, cfg_j.n_states,
                                         jnp.complex64) * mc
        Rs.append(np.array(R))
        psis.append(np.array(psi))
        kruns.append(k_run)
    R = np.stack(Rs)
    E, n = R.shape[:2]
    return NumpyState(R=R, V=np.zeros_like(R), F=np.zeros_like(R),
                      psi=np.stack(psis), t_part=np.zeros((E, n), np.float32),
                      tick=np.zeros(E, np.int32), t=np.zeros(E)), kruns


def _check_fold(res_t, res_j):
    assert len(res_t) == len(res_j)
    for rt, rj in zip(res_t, res_j):
        n = rj.get("n_ions")
        assert rt.get("n_ions") == n
        assert rt["final"].R.shape == np.asarray(rj["final"].R).shape
        _check_state(rt["final"], rj["final"], n)
        _check_results(rt, rj)


@pytest.mark.parametrize("exact_n", [True, False])
def test_run_ensemble_matches_jax(exact_n, tmp_path):
    kw = dict(SMALL, exact_n=exact_n)
    cfg_j = jft.FrozenTagConfig(use_pallas=False,
                                save_directory=str(tmp_path / "j"), **kw)
    cfg_t = tft.FrozenTagConfig(save_directory=str(tmp_path / "t"), **kw)
    res_j = jft.run_ensemble(cfg_j, 3, seed=6)
    mask = None if exact_n else tft._poisson_mask(cfg_t.n0, 3, 6)
    if mask is not None:
        np.testing.assert_array_equal(mask, np.asarray(
            jft._poisson_mask(cfg_j.n0, 3, 6)))
        assert len({int(m.sum()) for m in mask}) > 1
    start, kruns = _jax_fold_start(cfg_j, 6, 3, mask)
    draws = JaxDraws(kruns)
    res_t = tft.run_ensemble(cfg_t, 3, seed=6, device="cpu", states=start,
                             rolls_fn=draws.rolls_fn,
                             measure_fn=draws.measure_fn)
    _check_fold(res_t, res_j)
    names = _check_trees(str(tmp_path / "j"), str(tmp_path / "t"))
    assert sum(n.endswith("energies.dat") for n in names) == 3
    if mask is not None:
        for j, r in enumerate(res_t):
            cond = np.loadtxt(glob.glob(str(
                tmp_path / "t" / "*" / f"job{j + 1}"
                / "conditions_timestep000049.dat"))[0])
            assert cond.shape[0] == r["n_ions"] == int(mask[j].sum())


@pytest.mark.parametrize("exact_n", [True, False])
def test_run_sweep_matches_jax(exact_n, tmp_path):
    points = [{"detuning": -1.0, "om": 1.3}, {"detuning": -4.0},
              {"om": 0.5}]
    kw = dict(SMALL, exact_n=exact_n)
    cfg_j = jft.FrozenTagConfig(use_pallas=False,
                                save_directory=str(tmp_path / "j"), **kw)
    cfg_t = tft.FrozenTagConfig(save_directory=str(tmp_path / "t"), **kw)
    res_j, mj = jft.run_sweep(cfg_j, points, seed=8)
    _, pj = sweep_member_params(cfg_j, points, 1, cfg_j.scheme_unit(),
                                jnp.float32, jnp.complex64)
    mask = None if exact_n else tft._poisson_mask(cfg_t.n0, 3, 8)
    start, kruns = _jax_fold_start(cfg_j, 8, 3, mask)
    draws = JaxDraws(kruns)
    res_t, mt = tft.run_sweep(cfg_t, points, seed=8, device="cpu",
                              states=start, rolls_fn=draws.rolls_fn,
                              measure_fn=draws.measure_fn,
                              qt_params=qt_params_from_numpy(pj,
                                                             device="cpu"))
    assert [(m.detuning, m.om, m.job) for m in mt] == [
        (m.detuning, m.om, m.job) for m in mj]
    _check_fold(res_t, res_j)
    names = _check_trees(str(tmp_path / "j"), str(tmp_path / "t"))
    assert len({n.split(os.sep)[0] for n in names}) == 3   # a dir per point


# -------------------------------- the port on its own: TestFrozenTagging

def test_run_ensemble_matches_sequential(tmp_path):
    """A fold member reproduces its own single run bit for bit (same
    start, same uniforms), and the fold writes one tree per job."""
    cfg = tft.FrozenTagConfig(save_directory=str(tmp_path), **SMALL)
    gens = [torch.Generator().manual_seed(s) for s in (11, 12)]
    starts = [tft.initial_state(cfg, g) for g in gens]
    fold_start = NumpyState(
        *(np.stack([getattr(s, k).numpy() for s in starts])
          for k in ("R", "V", "F", "psi", "t_part")),
        tick=np.zeros(2, np.int32), t=np.zeros(2))
    keys = [jax.random.PRNGKey(21), jax.random.PRNGKey(22)]
    d = JaxDraws(keys)
    results = tft.run_ensemble(cfg, 2, seed=3, device="cpu",
                               states=fold_start, rolls_fn=d.rolls_fn,
                               measure_fn=d.measure_fn)
    assert len(results) == 2
    assert len(list(tmp_path.rglob("energies.dat"))) == 2
    for j in range(2):
        d1 = JaxDraws(keys[j])
        one = tft.run(dataclasses.replace(cfg, save_directory=None),
                      device="cpu", state=_np(starts[j]),
                      rolls_fn=d1.rolls_fn, measure_fn=d1.measure_fn)[1]
        np.testing.assert_array_equal(results[j]["spin_up"], one["spin_up"])
        for k in ("R", "V", "psi"):
            np.testing.assert_array_equal(getattr(results[j]["final"], k),
                                          getattr(one["final"], k), k)
        for k in BLOCK_KEYS:
            np.testing.assert_array_equal(results[j]["outs"][k],
                                          one["outs"][k], k)
    assert not np.allclose(results[0]["final"].R, results[1]["final"].R)


@pytest.mark.parametrize("variant", ["422linear", "408quad", "408linear"])
def test_smoke(variant, tmp_path):
    cfg = tft.FrozenTagConfig(variant=variant, n0=64, tstart=0.1, tmax=0.5,
                              tpump_seconds=1e-7, sample_freq=10,
                              save_directory=str(tmp_path))
    final, res = tft.run(cfg, device="cpu")
    frac = res["spin_up"].mean()
    if variant == "408quad":
        # the quad scheme (det=0, Om=2) pumps population OUT of the
        # spin-up states: expect a small tag fraction (can be 0 of 64)
        assert frac < 0.3
    else:
        assert 0.0 < frac < 1.0
    assert (np.abs(final.psi) ** 2)[:, 2:].sum() > 0
    files = {p.name for p in tmp_path.rglob("*.dat")}
    assert "energies.dat" in files and "taggedMoments.dat" in files
    assert ("vSquareAutoCorr.dat" if variant == "408quad"
            else "VAF.dat") in files
    # energy audit: the DIH kinetic energy is paid by the potential
    e = res["outs"]["energies"]
    assert np.abs(e[:, 4]).max() < 0.1 * e[-1, :3].sum()


@pytest.mark.parametrize("variant", ["422linear", "408linear"])
def test_tag_instant_row(variant, tmp_path):
    """A tau=0 VAF row at the tag instant for every variant, and in the
    408 variants a full output() row too."""
    cfg = tft.FrozenTagConfig(variant=variant, n0=64, tstart=0.1, tmax=0.5,
                              tpump_seconds=1e-7, sample_freq=10,
                              save_directory=str(tmp_path))
    final, res = tft.run(cfg, device="cpu")
    vaf = np.loadtxt(next(tmp_path.rglob("VAF.dat")))
    n_b = res["outs"]["t"].shape[0]
    assert vaf.shape[0] == n_b + 1
    t_tag = res["out_tag"]["t"]
    np.testing.assert_allclose(vaf[0, 0], t_tag, rtol=1e-6)
    np.testing.assert_allclose(vaf[0, 1], res["out_tag"]["vaf"], rtol=1e-5)
    assert vaf[1, 0] > vaf[0, 0]
    # the row's time is the reference's measurement tick
    np.testing.assert_allclose(t_tag, tft.tag_tick(cfg) * cfg.qdt, rtol=1e-6)
    energies = np.loadtxt(next(tmp_path.rglob("energies.dat")))
    moments = np.loadtxt(next(tmp_path.rglob("taggedMoments.dat")))
    extra = 1 if variant != "422linear" else 0
    assert energies.shape[0] == moments.shape[0] == n_b + extra
    if extra:
        np.testing.assert_allclose(energies[0, 0], t_tag, rtol=1e-6)


def test_resume_run_roundtrip(tmp_path):
    cfg = tft.FrozenTagConfig(variant="422linear", n0=48, tstart=0.1,
                              tmax=0.5, tpump_seconds=1e-7, sample_freq=10,
                              save_directory=str(tmp_path))
    final, res = tft.run(cfg, device="cpu")
    c0 = int(round(cfg.tmax / cfg.timestep)) - 1
    st, spin_up = tft.resume_run(cfg.job_dir(), c0, cfg, device="cpu")
    np.testing.assert_allclose(st.R.numpy(), final.R, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.V.numpy(), final.V, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(spin_up.numpy(), res["spin_up"])
    assert st.psi.shape == (48, 5) and st.tick > 0


CHAIN = dict(variant="422linear", n0=48, tstart=1.0, timestep=0.01,
             sample_freq=20, tpump_seconds=2e-7)


def _chain_dirs(tmp_path):
    return (tft.FrozenTagConfig(**CHAIN, tmax=3.1,
                                save_directory=str(tmp_path / "chained")),
            tft.FrozenTagConfig(**CHAIN, tmax=5.3,
                                save_directory=str(tmp_path / "full")))


def test_resume_continue_matches_uninterrupted(tmp_path):
    """run(resume=True) with an extended tmax reproduces the uninterrupted
    run bit for bit; both tmax values lie OFF the sample grid, so both
    windows end with tail MD steps the checkpoint must include."""
    cfg1, cfg_full = _chain_dirs(tmp_path)
    tft.run(cfg1, device="cpu")
    cfg2 = dataclasses.replace(cfg1, tmax=5.3)
    final2, res2 = tft.run(cfg2, resume=True, device="cpu")
    final_full, _ = tft.run(cfg_full, device="cpu")
    np.testing.assert_array_equal(final2.R, final_full.R)
    for fname in ("energies.dat", "taggedMoments.dat", "VAF.dat"):
        a = np.loadtxt(os.path.join(cfg1.job_dir(), fname))
        b = np.loadtxt(os.path.join(cfg_full.job_dir(), fname))
        np.testing.assert_array_equal(a, b, err_msg=fname)
    for lab in res2["labels"]:
        assert os.path.exists(os.path.join(
            cfg1.job_dir(), f"vel_distX_timestep{lab:06d}.dat")), lab
    c0f = int(round(cfg2.tmax / cfg2.timestep)) - 1
    n_chain, counter_chain = tckpt.read_ions(cfg1.job_dir(), c0f)
    assert n_chain == cfg1.n0
    assert counter_chain == np.loadtxt(
        os.path.join(cfg_full.job_dir(), "energies.dat")).shape[0]


def test_resume_from_ascii_and_newest_format_wins(tmp_path):
    """Without the native file the ASCII schema continues the job (psi,
    vholder and epot0 zero, as the reference's globals); a native
    checkpoint older than the newest ASCII one is not used."""
    cfg1, _ = _chain_dirs(tmp_path)
    tft.run(cfg1, device="cpu")
    d = cfg1.job_dir()
    tft.run(dataclasses.replace(cfg1, tmax=3.5), resume=True, device="cpu")
    os.remove(os.path.join(d, "checkpoint_000349.npz"))   # ASCII 349 newest
    rows = np.loadtxt(os.path.join(d, "energies.dat")).shape[0]
    final, res = tft.run(dataclasses.replace(cfg1, tmax=4.0), resume=True,
                         device="cpu")
    assert res["labels"] == [359, 379, 399] and res["epot0"] == 0.0
    assert not res["vholder"].any() and not final.psi.any()
    e = np.loadtxt(os.path.join(d, "energies.dat"))
    assert e.shape[0] == rows + 3
    np.testing.assert_allclose(np.diff(e[-4:, 0]), 0.2, rtol=1e-5)


def test_ensemble_resume_chains_every_job(tmp_path):
    cfg1 = tft.FrozenTagConfig(**CHAIN, tmax=3.0,
                               save_directory=str(tmp_path))
    tft.run_ensemble(cfg1, 3, seed=4, device="cpu")
    cfg2 = dataclasses.replace(cfg1, tmax=4.0)
    res = tft.run_ensemble(cfg2, 3, resume=True, device="cpu")
    assert len(res) == 3
    job_dirs = sorted(str(p.parent) for p in tmp_path.rglob("energies.dat"))
    assert len(job_dirs) == 3
    c0f = int(round(cfg2.tmax / cfg2.timestep)) - 1
    for d in job_dirs:
        e = np.loadtxt(os.path.join(d, "energies.dat"))
        n, counter = tckpt.read_ions(d, c0f)
        assert n == cfg1.n0 and counter == e.shape[0]
    with pytest.warns(UserWarning, match="mesh"):
        tft.run_ensemble(dataclasses.replace(cfg1, tmax=4.2), 3, resume=True,
                         mesh=make_mesh(3, 1, devices=["cpu"] * 3))


def test_resume_tail_only_extension(tmp_path):
    cfg1, _ = _chain_dirs(tmp_path)
    tft.run(cfg1, device="cpu")
    d = cfg1.job_dir()
    rows1 = np.loadtxt(os.path.join(d, "energies.dat")).shape[0]
    final2, res2 = tft.run(dataclasses.replace(cfg1, tmax=3.15), resume=True,
                           device="cpu")
    assert res2["labels"] == [] and res2["outs"] is None
    assert np.loadtxt(os.path.join(d, "energies.dat")).shape[0] == rows1
    n, counter = tckpt.read_ions(d, int(round(3.15 / cfg1.timestep)) - 1)
    assert n == cfg1.n0 and final2.tick == 315 * cfg1.ratio
    with pytest.raises(ValueError, match="already covers"):
        tft.run(dataclasses.replace(cfg1, tmax=3.15), resume=True,
                device="cpu")


def test_resume_before_tag_rejected(tmp_path):
    cfg = tft.FrozenTagConfig(variant="422linear", n0=32, tstart=2.0,
                              tmax=3.0, timestep=0.01, sample_freq=20,
                              tpump_seconds=2e-7,
                              save_directory=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tft.run(cfg, resume=True, device="cpu")
    with pytest.raises(ValueError, match="save_directory"):
        tft.run(dataclasses.replace(cfg, save_directory=None), resume=True,
                device="cpu")
    # a checkpoint from before the pump end must be refused: the schema
    # never persists mid-pump wavefunctions
    os.makedirs(cfg.job_dir(), exist_ok=True)
    tckpt.save_native(cfg.job_dir(), 50, R=np.zeros((32, 3)),
                      V=np.zeros((32, 3)),
                      psi=np.zeros((32, 5), np.complex64), counter=0,
                      spin_up=np.zeros(32, np.int64))
    with pytest.raises(ValueError, match="pump end"):
        tft.run(cfg, resume=True, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_resume_across_packages(writer, tmp_path):
    """A checkpoint written by either package is continued by the other:
    the same appended rows as the writer's own continuation (post-tag MD
    is deterministic), to the float32 bars."""
    kw = dict(CHAIN, tmax=3.1)
    cj = jft.FrozenTagConfig(use_pallas=False, **kw,
                             save_directory=str(tmp_path / "a"))
    ct = tft.FrozenTagConfig(**kw, save_directory=str(tmp_path / "a"))
    if writer == "jax":
        jft.run(cj)
    else:
        tft.run(ct, device="cpu")
    import shutil
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    cj2 = dataclasses.replace(cj, tmax=4.3)
    ct2 = dataclasses.replace(ct, tmax=4.3,
                              save_directory=str(tmp_path / "b"))
    fin_j, res_j = jft.run(cj2, resume=True)
    fin_t, res_t = tft.run(ct2, resume=True, device="cpu")
    assert res_t["labels"] == res_j["labels"] and len(res_t["labels"]) == 6
    np.testing.assert_allclose(fin_t.R, np.asarray(fin_j.R), atol=2e-5)
    np.testing.assert_allclose(fin_t.V, np.asarray(fin_j.V), atol=2e-5)
    assert res_t["epot0"] == res_j["epot0"] != 0.0
    np.testing.assert_array_equal(res_t["spin_up"], res_j["spin_up"])
    dir_j = dataclasses.replace(ct2, save_directory=str(tmp_path / "a"))
    _check_trees(dir_j.job_dir(), ct2.job_dir(), kde_rel=1e-3)
    assert (jckpt.read_ions(dir_j.job_dir(), 429)
            == tckpt.read_ions(ct2.job_dir(), 429))


# ----------------------- the port on its own: Poissonian folds, sweeps

def test_ones_mask_equals_unmasked():
    """The mask plumbing is physics-neutral: on the CPU twins an all-ones
    mask changes no bit."""
    cfg = tft.FrozenTagConfig(**SMALL)
    mcfgs = [dataclasses.replace(cfg, job=j + 1) for j in range(3)]
    a = tft._run_batched(cfg, mcfgs, 5, device="cpu")
    b = tft._run_batched(cfg, mcfgs, 5, device="cpu",
                         mask=np.ones((3, cfg.n0), np.float32))
    for j in range(3):
        for k in BLOCK_KEYS:
            np.testing.assert_allclose(a[j]["outs"][k], b[j]["outs"][k],
                                       rtol=5e-4, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(a[j]["spin_up"], b[j]["spin_up"])
        np.testing.assert_allclose(a[j]["final"].R, b[j]["final"].R,
                                   rtol=1e-3, atol=1e-4)


def test_padded_lanes_inert(monkeypatch):
    """Padded lanes stay exactly R=V=psi=0 through init, DIH MD, the pump
    window, measurement and recording, and every 1/N is the real count:
    a padded member equals its exact-shape run."""
    cfg = tft.FrozenTagConfig(**SMALL)
    mcfgs = [dataclasses.replace(cfg, job=j + 1) for j in range(2)]
    m = np.ones((2, cfg.n0), np.float32)
    m[0, 33:] = 0.0
    m[1, 28:] = 0.0
    raw = {}
    orig = tft._phases

    def spy(*a, **kw):
        out = orig(*a, **kw)
        raw["state"], raw["spin_up"], raw["vholder"] = out[0], out[1], out[5]
        return out
    monkeypatch.setattr(tft, "_phases", spy)
    res = tft._run_batched(cfg, mcfgs, 7, device="cpu", mask=m)
    assert res[0]["final"].R.shape[0] == 33
    assert res[1]["spin_up"].shape[0] == 28
    assert res[0]["n_ions"] == 33 and res[1]["n_ions"] == 28
    pad = torch.from_numpy(m == 0)
    st = raw["state"]
    for name in ("R", "V", "F", "psi"):
        assert not getattr(st, name)[pad].any(), name
    assert not raw["spin_up"][pad].any() and not raw["vholder"][pad].any()
    for r in res:
        for k in BLOCK_KEYS:
            assert np.isfinite(r["outs"][k]).all(), k
        assert 0 < r["outs"]["energies"][-1, 0] < 2.0
    # member 0 alone at its exact shape (33 ions in cfg's cell): the same
    # start lanes and the same uniforms, each ion's lane-major block cut
    # from the padded draw
    gen = torch.Generator().manual_seed(tft.member_seed(7, 0))
    start = tft._fold_start(cfg, [gen], torch.from_numpy(m[:1]))
    one = NumpyState(R=start.R[0, :33].numpy(), V=start.V[0, :33].numpy(),
                     F=np.zeros((33, 3), np.float32),
                     psi=start.psi[0, :33].numpy(),
                     t_part=np.zeros(33, np.float32), tick=0, t=0.0)

    class Cut:
        """member 0's draws of the padded fold, cut to its real lanes"""
        def __init__(self):
            self.rolls = lane_major_rolls(gen)

        def rolls_fn(self, ratio, lanes):
            return self.rolls(ratio, (cfg.n0,))[..., :33]

        def measure_fn(self, lanes):
            return tft.measure_rolls(gen)((cfg.n0,))[:33]
    cut = Cut()
    _, alone = tft.run(cfg, device="cpu", state=one, rolls_fn=cut.rolls_fn,
                       measure_fn=cut.measure_fn)
    np.testing.assert_array_equal(alone["spin_up"], res[0]["spin_up"])
    np.testing.assert_allclose(alone["final"].R, res[0]["final"].R,
                               atol=2e-5)
    for k in BLOCK_KEYS:
        _close(alone["outs"][k], res[0]["outs"][k], k)


def test_sweep_with_poisson_counts():
    """exact_n=False sweeps combine per-member tables with per-member
    Poissonian masks in one fold; at cfg's own (detuning, om) and the same
    seed the sweep reproduces run_ensemble bit for bit."""
    cfg = tft.FrozenTagConfig(**{**SMALL, "n0": 64}, exact_n=False)
    res, mcfgs = tft.run_sweep(cfg, [{"detuning": cfg.detuning,
                                      "om": cfg.om}], jobs_per_point=3,
                               seed=13, device="cpu")
    ens = tft.run_ensemble(cfg, 3, seed=13, device="cpu")
    n_js = [r["n_ions"] for r in res]
    assert n_js == [r["n_ions"] for r in ens] and len(set(n_js)) > 1
    for j in range(3):
        assert res[j]["spin_up"].shape[0] == n_js[j]
        np.testing.assert_array_equal(res[j]["outs"]["moments"],
                                      ens[j]["outs"]["moments"])
        np.testing.assert_array_equal(res[j]["spin_up"], ens[j]["spin_up"])


def test_poisson_fold_over_mesh():
    """Poissonian masks compose with member_sharded: the masked fold over
    the mesh's ens slots is bit-exact against the single fold."""
    cfg = tft.FrozenTagConfig(**{**SMALL, "n0": 48}, exact_n=False)
    a = tft.run_ensemble(cfg, 4, seed=21, device="cpu")
    b = tft.run_ensemble(cfg, 4, seed=21,
                         mesh=make_mesh(2, 1, devices=["cpu"] * 2))
    for j in range(4):
        assert a[j]["n_ions"] == b[j]["n_ions"]
        np.testing.assert_array_equal(a[j]["outs"]["moments"],
                                      b[j]["outs"]["moments"])
        np.testing.assert_array_equal(a[j]["spin_up"], b[j]["spin_up"])
        np.testing.assert_array_equal(a[j]["final"].R, b[j]["final"].R)


def test_run_ensemble_poisson_end_to_end(tmp_path):
    cfg = tft.FrozenTagConfig(**{**LONG, "n0": 64, "tmax": 2.0},
                              exact_n=False, save_directory=str(tmp_path))
    res = tft.run_ensemble(cfg, 6, seed=11, device="cpu")
    n_js = [r["n_ions"] for r in res]
    assert len(set(n_js)) > 1, f"members all drew N={n_js[0]}"
    assert abs(np.mean(n_js) - 64) < 64 * 0.5
    job_dirs = sorted(str(p.parent) for p in tmp_path.rglob("energies.dat"))
    assert len(job_dirs) == 6
    c0 = int(round(cfg.tmax / cfg.timestep)) - 1
    for d, r in zip(job_dirs, res):
        e = np.loadtxt(os.path.join(d, "energies.dat"))
        assert np.isfinite(e).all()
        cond = np.loadtxt(os.path.join(d,
                                       f"conditions_timestep{c0:06d}.dat"))
        assert cond.shape[0] == r["n_ions"]
        spins = np.loadtxt(os.path.join(
            d, f"spinUpIonsList_timestep{c0:06d}.dat"))
        assert spins.shape[0] == r["n_ions"]
        # DIH heats every member to the same correlation temperature
        # scale regardless of its drawn N
        assert 0.05 < e[-1, 1] < 2.0, (d, e[-1])


def test_frozen_sweep_identity_member_matches_ensemble():
    cfg = tft.FrozenTagConfig(**SMALL)
    res, mcfgs = tft.run_sweep(cfg, [{"detuning": cfg.detuning,
                                      "om": cfg.om}, {"detuning": -6.0}],
                               seed=2, device="cpu")
    ens = tft.run_ensemble(cfg, 1, seed=2, device="cpu")
    np.testing.assert_array_equal(res[0]["outs"]["moments"],
                                  ens[0]["outs"]["moments"])
    np.testing.assert_array_equal(res[0]["spin_up"], ens[0]["spin_up"])
    np.testing.assert_array_equal(res[0]["final"].psi, ens[0]["final"].psi)
    assert [m.detuning for m in mcfgs] == [cfg.detuning, -6.0]
    assert not np.array_equal(res[1]["final"].psi[: cfg.n0],
                              res[0]["final"].psi)


def test_frozen_sweep_detuning_changes_pumping(tmp_path):
    """Far-detuned pumping leaves the spin-up fraction near the unpumped
    50/50; near-resonant pumping polarizes away from it.  Each point
    writes its own detuning-encoded tree."""
    cfg = tft.FrozenTagConfig(**{**SMALL, "n0": 128, "tpump_seconds": 2e-7,
                                 "timestep": 0.01, "tmax": 0.4},
                              save_directory=str(tmp_path))
    res, _ = tft.run_sweep(cfg, [{"detuning": -1.0}, {"detuning": -12.0}],
                           seed=3, device="cpu")
    near = abs(res[0]["spin_up"].mean() - 0.5)
    far = abs(res[1]["spin_up"].mean() - 0.5)
    assert near > far + 0.02, (near, far)
    dirs = glob.glob(str(tmp_path / "*"))
    assert len(dirs) == 2
    for d in dirs:
        assert os.path.exists(os.path.join(d, "job1", "energies.dat"))


def test_member_sharded_ensemble_and_sweep_bitwise():
    """tests/test_parallel.py:236 on the port."""
    cfg = tft.FrozenTagConfig(**SMALL)
    mesh = make_mesh(4, 1, devices=["cpu"] * 4)
    a = tft.run_ensemble(cfg, 4, seed=2, device="cpu")
    b = tft.run_ensemble(cfg, 4, seed=2, mesh=mesh)
    for j in range(4):
        np.testing.assert_array_equal(a[j]["outs"]["moments"],
                                      b[j]["outs"]["moments"])
        np.testing.assert_array_equal(a[j]["spin_up"], b[j]["spin_up"])
    pts = [{"detuning": d} for d in (-4, -2, -1, 0)]
    ra, _ = tft.run_sweep(cfg, pts, seed=3, device="cpu")
    rb, _ = tft.run_sweep(cfg, pts, seed=3, mesh=mesh)
    for j in range(4):
        np.testing.assert_array_equal(ra[j]["spin_up"], rb[j]["spin_up"])
        np.testing.assert_array_equal(ra[j]["final"].psi,
                                      rb[j]["final"].psi)
    assert not np.array_equal(ra[0]["final"].psi, ra[3]["final"].psi)


def test_guards():
    cfg = tft.FrozenTagConfig(**SMALL)
    f64 = tft.FrozenTagConfig(dtype="float64", **SMALL)
    with pytest.raises(NotImplementedError, match="float64"):
        tft.run(f64, device="cuda")
    with pytest.raises(NotImplementedError, match="float64"):
        tft.run_ensemble(f64, 2, device="cuda")
    with pytest.raises(ValueError, match="ion shards"):
        tft.run_ensemble(cfg, 4, mesh=make_mesh(2, 2, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="divide"):
        tft.run_ensemble(cfg, 3, mesh=make_mesh(2, 1, devices=["cpu"] * 2))
    d = JaxDraws([jax.random.PRNGKey(0)] * 2)
    with pytest.raises(ValueError, match="mesh"):
        tft.run_ensemble(cfg, 2, mesh=make_mesh(2, 1, devices=["cpu"] * 2),
                         rolls_fn=d.rolls_fn)
    with pytest.raises(ValueError, match="override"):
        tft.run_sweep(cfg, [{"tstart": 1.0}], device="cpu")
    with pytest.raises(ValueError, match="first post-tag sample gate"):
        tft.run(dataclasses.replace(cfg, tmax=0.078), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tft.run(cfg)                      # the default device is cuda


def test_float64_cpu_run_tracks_float32():
    cfg = tft.FrozenTagConfig(**SMALL)
    start = _np(tft.initial_state(cfg, torch.Generator().manual_seed(3)))
    outs = {}
    for dt in ("float32", "float64"):
        d = JaxDraws(jax.random.PRNGKey(4))
        _, res = tft.run(tft.FrozenTagConfig(dtype=dt, **SMALL),
                         device="cpu", state=start, rolls_fn=d.rolls_fn,
                         measure_fn=d.measure_fn)
        outs[dt] = res
    assert outs["float64"]["final"].R.dtype == np.float64
    assert outs["float64"]["outs"]["t"].dtype == np.float64
    for k in ("energies", "vaf"):
        b = outs["float64"]["outs"][k]
        np.testing.assert_allclose(outs["float32"]["outs"][k], b, rtol=0,
                                   atol=1e-3 * np.abs(b).max(), err_msg=k)


def test_copied_constants_equal_the_jax_package():
    assert tft.VARIANTS == jft.VARIANTS
    assert tft.FROZEN_VARIANT_DEFAULTS == jft.FROZEN_VARIANT_DEFAULTS
    for v in tft.VARIANTS:
        a, b = tft.FrozenTagConfig(variant=v), jft.FrozenTagConfig(variant=v)
        assert (a.ratio, a.qdt, a.tpump, a.tend, a.n_states, a.detuning,
                a.om) == (b.ratio, b.qdt, b.tpump, b.tend, b.n_states,
                          b.detuning, b.om)
        assert tft.tag_tick(a) == jft.tag_tick(b)
        assert tft._gate_grid(a) == jft._gate_grid(b)
        assert tft._phase_b_plan(a) == jft._phase_b_plan(b)
    fa = {f.name: f.default for f in dataclasses.fields(tft.FrozenTagConfig)}
    fb = {f.name: f.default for f in dataclasses.fields(jft.FrozenTagConfig)}
    assert fa == fb
