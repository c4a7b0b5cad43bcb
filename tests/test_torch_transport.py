"""The port's transport family (mc_md_anisotropy) against the JAX package
(CPU).

Both packages run ``run``, ``run_ensemble`` and ``run_sweep`` (a (Gamma,
kappa) grid: per-member Gamma and a per-member ``ldeb [E]`` in the force
call) on the configuration of tests/test_experiments.py's TestTransport
(n=27, 400 MC steps in 4 chunks, 120 MD steps) from the same lattice
start, the port fed the JAX key chain through ``draws``
(test_torch_mc.JaxMcDraws: start velocities, Metropolis steps,
collisions, classical tags).  JAX runs its XLA force path, whose math the
port's CPU twin shares.

Tolerances: ``mc_accepted`` and the tags' effect exactly (the chains
agree), g(r) within one pair per bin, R/V 2e-5 absolute (the bars of
tests/test_fused.py), every other result array 1e-4 of its largest value;
the .dat trees file for file at the same bars (rows after %g; 2e-4 of
the largest value).
Port-only properties are bitwise: crash-resume at the crash points of
tests/test_experiments.py:446-477 (and more), a fold member against its
own run, a sweep's identity member against the ensemble member, a mesh
against the single fold.  Resume across the packages, both ways, from the
checkpoint at stage 5 (the anisotropic force: nothing is drawn after it).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.experiments import mc_md_anisotropy as jtr
from mdqtplasmasims_tpu.io.datfiles import read_rows
from mdqtplasmasims_torch.experiments import mc_md_anisotropy as ttr
from mdqtplasmasims_torch.experiments.laser_cooling import member_seed
from mdqtplasmasims_torch.parallel.mesh import make_mesh
from test_torch_mc import JaxMcDraws

torch.set_num_threads(1)

SMALL = dict(n=27, mc_steps=400, gr_every_mc=100, pre_record_md_steps=10,
             record_steps=40, gr_every_record=20, instant_aniso_steps=20,
             reequil_steps=10, aniso_relax_steps=20, aniso_time_us=0.2)
N_CHUNKS = 4
STATE = ("R", "V")
EXACT = ("mc_accepted", "gr_mc")


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, fs in os.walk(root) for f in fs}


def _close(got, want, what, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def gr_close(got, want, n, L, what="g(r)"):
    """g(r) rows within one pair per bin (a pair counted from both ions)
    of each other: float32 ``floor(r/dr)`` may bin a pair across an edge
    from XLA."""
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    assert got.shape == want.shape, what
    n_use = int(min(400, np.floor(L / 2 / 0.05)))
    i = np.arange(n_use)
    shell = np.where(i == 0, (n * 4 // 3) * np.pi * 0.05 ** 3,
                     n * 3.0 * 0.05 ** 3 * i * i)
    counts = np.abs(got - want)[:, :n_use] * shell
    assert counts.max() <= 2.0 + 1e-3, what
    assert (got[:, n_use:] == 0).all(), what


def check_results(rt, rj, n=27, L=None):
    L = L or (n * 4.0 * np.pi / 3.0) ** (1.0 / 3.0)
    assert set(rt) == set(rj), set(rt) ^ set(rj)
    for k in rj:
        want = np.asarray(rj[k])
        if k in EXACT:
            np.testing.assert_array_equal(rt[k], want, err_msg=k)
        elif k.startswith("gr"):
            gr_close(rt[k], want, n, L, k)
        elif k in STATE:
            np.testing.assert_allclose(rt[k], want, atol=2e-5, rtol=0,
                                       err_msg=k)
        else:
            _close(rt[k], want, k)


def check_trees(root_a, root_b, names=None, n=27):
    """The .dat files of two trees (all of them, or ``names``) hold the
    same rows at the bars of :func:`check_results`."""
    L = (n * 4.0 * np.pi / 3.0) ** (1.0 / 3.0)
    fa, fb = _files(root_a), _files(root_b)
    if names is None:
        assert sorted(fa) == sorted(fb)
        names = [k for k in sorted(fa) if not k.endswith(".npz")]
    for name in names:
        a, b = read_rows(fa[name]), read_rows(fb[name])
        if "pairPairCorr" in name:
            assert np.array_equal(a[:, 0], b[:, 0])
            gr_close(b[:, 1], a[:, 1], n, L, name)
        else:
            _close(b, a, name, rel=2e-4)
    return names


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    tmp_a = str(tmp_path_factory.mktemp("jax"))
    tmp_b = str(tmp_path_factory.mktemp("torch"))
    rj = jtr.run(jtr.MCTransportConfig(save_directory=tmp_a, **SMALL), seed=3)
    rt = ttr.run(ttr.MCTransportConfig(save_directory=tmp_b, **SMALL),
                 seed=3, device="cpu",
                 draws=JaxMcDraws(jax.random.PRNGKey(3), "transport",
                                  N_CHUNKS))
    return rj, rt, tmp_a, tmp_b


def test_run_matches_jax(both_runs):
    rj, rt, _, _ = both_runs
    check_results(rt, rj)
    assert rt["vaf"].shape == (40,) and rt["temps_inst"].shape == (20, 3)
    assert rt["gr_mc"].shape == (4, 400) and rt["moments"].shape == (40, 4,
                                                                      4)
    # VAF(0) = <v^2> ~ 3/gamma within thermal fluctuations
    assert 0.3 < rt["vaf"][0] < 3.0
    # the instantaneous rescale heats x by 15 % and cools y, z
    t0 = rt["temps_inst"][0]
    assert t0[0] > t0[1] and t0[0] > t0[2]


def test_run_tree_matches_jax(both_runs):
    _, _, tmp_a, tmp_b = both_runs
    names = {os.path.basename(n) for n in check_trees(tmp_a, tmp_b)}
    assert {"VAF.dat", "temperature.dat", "taggedVFourMoments.dat",
            "TemperaturesAlongAxesDuringForcePeriod.dat",
            "pairPairCorrStepNum300.dat"} <= names


def test_run_ensemble_matches_jax(tmp_path):
    cfg_j = jtr.MCTransportConfig(save_directory=str(tmp_path / "a"),
                                  **SMALL)
    cfg_t = ttr.MCTransportConfig(save_directory=str(tmp_path / "b"),
                                  **SMALL)
    rj = jtr.run_ensemble(cfg_j, 2, seed=1)
    keys = list(jax.random.split(jax.random.PRNGKey(1), 2))
    rt = ttr.run_ensemble(cfg_t, 2, seed=1, device="cpu",
                          draws=JaxMcDraws(keys, "transport", N_CHUNKS))
    for a, b in zip(rt, rj):
        check_results(a, b)
    assert not np.allclose(rt[0]["V"], rt[1]["V"])
    names = check_trees(str(tmp_path / "a"), str(tmp_path / "b"))
    assert sum(n.endswith("VAF.dat") for n in names) == 2


def test_run_sweep_matches_jax_with_per_member_ldeb(tmp_path):
    """A (Gamma, kappa) grid: each member's own Gamma and screening
    length (the force call gets ``ldeb [E]``)."""
    pts = [{"gamma": 3.0, "kappa": 0.5}, {"gamma": 5.0, "kappa": 0.3}]
    cfg_j = jtr.MCTransportConfig(save_directory=str(tmp_path / "a"),
                                  **SMALL)
    cfg_t = ttr.MCTransportConfig(save_directory=str(tmp_path / "b"),
                                  **SMALL)
    rj, mj = jtr.run_sweep(cfg_j, pts, seed=2)
    keys = list(jax.random.split(jax.random.PRNGKey(2), 2))
    rt, mt = ttr.run_sweep(cfg_t, pts, seed=2, device="cpu",
                           draws=JaxMcDraws(keys, "transport", N_CHUNKS))
    assert [(m.gamma, m.kappa) for m in mt] == [(m.gamma, m.kappa)
                                                 for m in mj]
    for a, b in zip(rt, rj):
        check_results(a, b)
    names = check_trees(str(tmp_path / "a"), str(tmp_path / "b"))
    assert {n.split(os.sep)[0] for n in names} == {
        "Gamma300Kappa50NumIons27", "Gamma500Kappa30NumIons27"}


# ------------------------------------------ the port on its own: bitwise

def test_fold_member_equals_its_own_run():
    cfg = ttr.MCTransportConfig(**SMALL)
    fold = ttr.run_ensemble(cfg, 2, seed=4, device="cpu")
    for j in range(2):
        one = ttr.run(dataclasses.replace(cfg, job=j + 1),
                      seed=member_seed(4, j), device="cpu")
        for k in one:
            np.testing.assert_array_equal(fold[j][k], one[k], err_msg=k)
    assert not np.array_equal(fold[0]["R"], fold[1]["R"])


def test_sweep_members_equal_ensemble_member_and_own_run():
    """The sweep's identity member equals the ensemble member bit for bit;
    the member at (Gamma, kappa) = (5, 0.3) equals its own run with that
    config: the per-member ``ldeb`` of the fold is the member's own."""
    cfg = ttr.MCTransportConfig(**SMALL)
    ens = ttr.run_ensemble(cfg, 2, seed=6, device="cpu")
    sw, mcfgs = ttr.run_sweep(cfg, [{}, {"gamma": 5.0, "kappa": 0.3}],
                              seed=6, device="cpu")
    for k in ens[0]:
        np.testing.assert_array_equal(sw[0][k], ens[0][k], err_msg=k)
    one = ttr.run(mcfgs[1], seed=member_seed(6, 1), device="cpu")
    for k in one:
        np.testing.assert_array_equal(sw[1][k], one[k], err_msg=k)
    assert not np.allclose(sw[1]["vaf"], ens[1]["vaf"])


def test_mesh_equals_single_fold():
    cfg = ttr.MCTransportConfig(**SMALL)
    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    a = ttr.run_ensemble(cfg, 4, seed=2, device="cpu")
    b = ttr.run_ensemble(cfg, 4, seed=2, mesh=mesh)
    pts = [{"gamma": g} for g in (2.0, 4.0)]
    c, _ = ttr.run_sweep(cfg, pts, seed=3, device="cpu")
    d, _ = ttr.run_sweep(cfg, pts, seed=3, mesh=mesh)
    for x, y in ((a, b), (c, d)):
        for rx, ry in zip(x, y):
            for k in rx:
                np.testing.assert_array_equal(rx[k], ry[k], err_msg=k)


RESUME = dict(SMALL, dtype="float64")


@pytest.mark.parametrize("crash_after", [2, 3, 6, 9])
def test_crash_resume_bit_identical(tmp_path, crash_after):
    """Crashes mid-MC (2, 3), mid-record (6) and before the anisotropic
    force (9): the resumed run equals the uninterrupted one bit for bit,
    and so does its .dat tree; a resume of a finished run rebuilds the
    results from its terminal checkpoint."""
    cfg1 = ttr.MCTransportConfig(**RESUME, save_directory=str(tmp_path / "a"),
                                 checkpoint_every_chunks=1)
    ref = ttr.run(cfg1, seed=3, device="cpu")
    cfg2 = dataclasses.replace(cfg1, save_directory=str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="simulated crash"):
        ttr.run(cfg2, seed=3, device="cpu",
                _crash_after_checkpoints=crash_after)
    res = ttr.run(cfg2, seed=3, device="cpu", resume=True)
    for k in ref:
        np.testing.assert_array_equal(ref[k], res[k], err_msg=k)
    a = sorted(p.relative_to(tmp_path / "a")
               for p in (tmp_path / "a").rglob("*.dat"))
    b = sorted(p.relative_to(tmp_path / "b")
               for p in (tmp_path / "b").rglob("*.dat"))
    assert a == b and a
    for rel in a:
        assert ((tmp_path / "a" / rel).read_bytes()
                == (tmp_path / "b" / rel).read_bytes()), rel
    res2 = ttr.run(cfg2, seed=3, device="cpu", resume=True)
    np.testing.assert_array_equal(res2["vaf"], ref["vaf"])


def test_resume_guards(tmp_path):
    """tests/test_experiments.py:479-496 on the port, and a checkpoint
    without the generator's state is refused while draws remain."""
    cfg = ttr.MCTransportConfig(**RESUME, save_directory=str(tmp_path),
                                checkpoint_every_chunks=2)
    with pytest.raises(ValueError, match="no pipeline checkpoint"):
        ttr.run(cfg, seed=3, device="cpu", resume=True)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ttr.run(cfg, seed=3, device="cpu", _crash_after_checkpoints=1)
    with pytest.raises(ValueError, match="refusing to splice"):
        ttr.run(cfg, seed=4, device="cpu", resume=True)
    with pytest.raises(ValueError, match="needs save_directory"):
        ttr.run(dataclasses.replace(cfg, save_directory=None), seed=3,
                device="cpu", resume=True)
    with pytest.raises(ValueError, match="needs save_directory"):
        ttr.run(dataclasses.replace(cfg, save_directory=None), seed=3,
                device="cpu")
    (path,) = [p for p in tmp_path.rglob("pipeline_checkpoint_*.npz")]
    with np.load(path) as z:
        kept = {k: z[k] for k in z.files if not k.startswith("torch_rng")}
    np.savez(path, **kept)
    with pytest.raises(ValueError, match="no generator state"):
        ttr.run(cfg, seed=3, device="cpu", resume=True)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_resume_across_packages(writer, tmp_path):
    """A checkpoint at stage 5 (no draws left: the force and relaxation
    stages are collisionless) written by either package is finished by
    the other; the results and tree equal the writer's own uninterrupted
    run at the float32 bars."""
    d = str(tmp_path / "run")
    cj = jtr.MCTransportConfig(**SMALL, save_directory=d,
                               checkpoint_every_chunks=1)
    ct = ttr.MCTransportConfig(**SMALL, save_directory=d,
                               checkpoint_every_chunks=1)
    full_j = jtr.MCTransportConfig(**SMALL,
                                   save_directory=str(tmp_path / "full"))
    full_t = ttr.MCTransportConfig(**SMALL,
                                   save_directory=str(tmp_path / "full"))
    with pytest.raises(RuntimeError, match="simulated crash"):
        if writer == "jax":
            jtr.run(cj, seed=3, _crash_after_checkpoints=9)
        else:
            ttr.run(ct, seed=3, device="cpu", _crash_after_checkpoints=9)
    (path,) = list((tmp_path / "run").rglob("pipeline_checkpoint_*.npz"))
    with np.load(path) as z:
        assert int(z["stage"]) == 5
    if writer == "jax":
        res = ttr.run(ct, seed=3, device="cpu", resume=True)
        ref = jtr.run(full_j, seed=3)
    else:
        res = jtr.run(cj, seed=3, resume=True)
        ref = ttr.run(full_t, seed=3, device="cpu")
    check_results({k: np.asarray(v) for k, v in res.items()}, ref)
    job = os.path.join("Gamma300Kappa50NumIons27", "job1")
    got = {n for n in _files(d) if not n.endswith(".npz")}
    want = set(_files(str(tmp_path / "full")))
    assert got == want and os.path.join(job, "VAF.dat") in got
    check_trees(d, str(tmp_path / "full"), sorted(got))


def test_guards():
    cfg = ttr.MCTransportConfig(**SMALL)
    f64 = ttr.MCTransportConfig(**RESUME)
    with pytest.raises(NotImplementedError, match="float64"):
        ttr.run(f64, device="cuda")
    with pytest.raises(NotImplementedError, match="float64"):
        ttr.run_ensemble(f64, 2, device="cuda")
    with pytest.raises(ValueError, match="override"):
        ttr.run_sweep(cfg, [{"n": 64}], device="cpu")
    with pytest.raises(ValueError, match="ion shards"):
        ttr.run_ensemble(cfg, 4, mesh=make_mesh(2, 2, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="mesh"):
        ttr.run_ensemble(cfg, 2, mesh=make_mesh(2, 1, devices=["cpu"] * 2),
                         draws=JaxMcDraws([jax.random.PRNGKey(0)] * 2,
                                          "transport", N_CHUNKS))
    with pytest.raises(ValueError, match="cubic"):
        ttr.run(dataclasses.replace(cfg, n=30), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ttr.run(cfg)                      # the default device is cuda


def test_stage_functions_match_jax():
    """The stage functions the pipeline runs, one by one from one float64
    state, the JAX key chain replayed: ``md_stage`` (collisions, the laser
    force, per-axis temperatures), ``record_stage`` (g(r), moments,
    temperatures, stored velocities) and ``mc_stage`` (one chunk against
    ``_mc_chunk_fn``); 1e-12, the accept count exact."""
    import jax.numpy as jnp
    from mdqtplasmasims_torch.core.pipeline import (AUTOC_KEYS, _cat,
                                                    fresh_state)
    cfg_j = jtr.MCTransportConfig(**RESUME)
    cfg_t = ttr.MCTransportConfig(**RESUME)
    rng = np.random.default_rng(5)
    R = rng.uniform(0, cfg_j.L, (27, 3))
    V = rng.normal(size=(27, 3)) * 0.6
    A = rng.normal(size=(27, 3)) * 0.1
    tags = rng.uniform(size=(4, 27)) < 0.5
    key = jax.random.PRNGKey(8)
    d = JaxMcDraws(jax.random.PRNGKey(0), "transport", 1)
    d.m[0]["run"] = key
    m = ttr.members_of(cfg_t, [cfg_t.gamma], [cfg_t.ldeb], d, single=True)

    def t(x):
        return torch.from_numpy(np.array(x))[None]

    (Rj, Vj, Aj, kj), rec_j = jtr.md_stage(
        cfg_j, *(jnp.asarray(x) for x in (R, V, A)), key, 20,
        collision_freq=20.0, add_laser_force=True, record="temp_axes")
    (Rt, Vt, At), rec_t = ttr.md_stage(cfg_t, m, t(R), t(V), t(A), 20,
                                       collision_freq=20.0,
                                       add_laser_force=True,
                                       record="temp_axes")
    for got, want in ((Rt, Rj), (Vt, Vj), (At, Aj), (rec_t, rec_j)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-12)
    assert np.array_equal(np.asarray(d.m[0]["run"]), np.asarray(kj))
    out_j = jtr.record_stage(cfg_j, Rj, Vj, Aj, kj,
                             tuple(jnp.asarray(x) for x in tags))
    st = fresh_state(torch.device("cpu"), ttr.ACC_KEYS)
    st.update(R=Rt, V=Vt, A=At, tags=torch.from_numpy(tags)[None])
    ttr.record_stage(cfg_t, m, st)
    assert (st["stage"], set(st["autoc"])) == (3, set(AUTOC_KEYS))
    out_t = [st[k] for k in "RVA"] + [_cat(st["acc"][k])
                                      for k in ttr.REC_KEYS]
    for got, want in zip(out_t, out_j[0][:3] + out_j[1:], strict=True):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-12)
    k_mc = jax.random.PRNGKey(9)
    d.m[0]["mc"] = [k_mc]
    Rm_j, acc_j, gr_j = jtr._mc_chunk_fn(cfg_j, Rj, k_mc, 150)
    st = fresh_state(torch.device("cpu"), ttr.ACC_KEYS)
    st["R"] = st_R = t(np.asarray(Rj))
    ttr.mc_stage(dataclasses.replace(cfg_t, mc_steps=150, gr_every_mc=150),
                 m, st)
    assert st["V"] is None and st["R"] is not st_R and st["stage"] == 1
    assert int(st["n_acc"][0]) == int(acc_j) > 0
    np.testing.assert_allclose(st["R"][0].numpy(), np.asarray(Rm_j), rtol=0,
                               atol=1e-12)
    (gr_t,) = st["acc"]["gr_mc"]
    np.testing.assert_array_equal(gr_t[0, 0].numpy(), np.asarray(gr_j))
