"""The port's MC-tagging family (mc_qt_tagging) against the JAX package
(CPU).

Both packages run ``run`` (422linear and 408quad), ``run_ensemble`` and
``run_sweep`` (a detuning grid; the sweep's tables cross through
``bridge.qt_params_from_numpy``) on the configuration of
tests/test_experiments.py's TestMCTagging crash test (n=27, 300 MC steps
in 3 chunks, 5 collisional MD steps, the variant's pump window for
``run``: 12 MD steps of 55 ticks for 422linear, 23 of 62 for 408quad; 20
recording steps; a 5-step window for the folds and where the port runs
alone) from the same lattice start, the port fed the JAX key chain
through ``draws`` (test_torch_mc.JaxMcDraws: start velocities,
Metropolis steps, collisions, start wavefunctions, the pump's tick-major
rolls, the measurement).  The quantum step is the production one.

Tolerances: ``mc_accepted`` and ``tags`` exactly, g(r) within one pair
per bin, R/V 2e-5 absolute (tests/test_fused.py's bars), every other
result array 1e-4 of its largest value; the .dat trees file for file at
the same bars (paths relative to each package's root: the 422 job
directory carries the date).  Port-only properties are bitwise:
crash-resume mid-MC, mid-pump and mid-record (the crash points of
tests/test_experiments.py:366-388), a fold member against its own run, a
sweep's identity member against the ensemble member, a mesh against the
single fold.  Resume across the packages, both ways, from the checkpoint
at stage 3 (the recording: nothing is drawn after the measurement).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.core.qt import (random_s_superposition,
                                        sweep_member_params)
from mdqtplasmasims_tpu.experiments import mc_qt_tagging as jmt
from mdqtplasmasims_tpu.ops.yukawa import yukawa_forces_potential as jforces
from mdqtplasmasims_torch.bridge import qt_params_from_numpy
from mdqtplasmasims_torch.experiments import mc_qt_tagging as tmt
from mdqtplasmasims_torch.experiments.laser_cooling import member_seed
from mdqtplasmasims_torch.parallel.mesh import make_mesh
from test_torch_mc import JaxMcDraws
from test_torch_transport import _close, _files, check_trees, gr_close

torch.set_num_threads(1)

SMALL = dict(n=27, mc_steps=300, mc_chunk_steps=100, pre_record_md_steps=5,
             record_steps=20, gr_every_record=10)
N_CHUNKS = 3
# the fold and sweep comparisons, the port-only tests and the cross-package
# resume: a 5-step pump window (275 ticks) keeps them short
FAST = dict(SMALL, variant="422linear", tpump_seconds=2e-8)
L27 = (27 * 4.0 * np.pi / 3.0) ** (1.0 / 3.0)


def check_results(rt, rj):
    assert set(rt) == set(rj), set(rt) ^ set(rj)
    for k in rj:
        want = np.asarray(rj[k])
        if k in ("mc_accepted", "tags"):
            np.testing.assert_array_equal(rt[k], want, err_msg=k)
        elif k == "grs":
            gr_close(rt[k], want, 27, L27, k)
        elif k in ("R", "V"):
            np.testing.assert_allclose(rt[k], want, atol=2e-5, rtol=0,
                                       err_msg=k)
        else:
            _close(rt[k], want, k)


def _keys(seed, n):
    return list(jax.random.split(jax.random.PRNGKey(seed), n))


@pytest.fixture(scope="module", params=["422linear", "408quad"])
def both_runs(request, tmp_path_factory):
    tmp_a = str(tmp_path_factory.mktemp("jax"))
    tmp_b = str(tmp_path_factory.mktemp("torch"))
    rj = jmt.run(jmt.MCTagConfig(variant=request.param, save_directory=tmp_a,
                                 **SMALL), seed=5)
    rt = tmt.run(tmt.MCTagConfig(variant=request.param, save_directory=tmp_b,
                                 **SMALL), seed=5, device="cpu",
                 draws=JaxMcDraws(jax.random.PRNGKey(5), "mc_tag", N_CHUNKS))
    return request.param, rj, rt, tmp_a, tmp_b


def test_run_matches_jax(both_runs):
    variant, rj, rt, _, _ = both_runs
    check_results(rt, rj)
    assert rt["dists"].shape == (20, 4001) and rt["vaf"].shape == (20,)
    assert 0.0 < rt["tags"].mean() < 1.0


def test_run_tree_matches_jax(both_runs):
    variant, _, _, tmp_a, tmp_b = both_runs
    names = {os.path.basename(n) for n in check_trees(tmp_a, tmp_b)}
    assert {"taggedMoments.dat", "vel_distX_timestep000000.dat",
            "vel_distX_timestep000019.dat", "pairPairCorrStepNum10.dat",
            "VAF.dat", "vFourthAutoCorr.dat", "temperature.dat"} <= names
    (job,) = {os.path.dirname(n) for n in _files(tmp_b)}
    assert ("Date" in job) == (variant == "422linear")


def test_run_ensemble_matches_jax(tmp_path):
    cfg_j = jmt.MCTagConfig(save_directory=str(tmp_path / "a"), **FAST)
    cfg_t = tmt.MCTagConfig(save_directory=str(tmp_path / "b"), **FAST)
    rj = jmt.run_ensemble(cfg_j, 2, seed=1)
    rt = tmt.run_ensemble(cfg_t, 2, seed=1, device="cpu",
                          draws=JaxMcDraws(_keys(1, 2), "mc_tag", N_CHUNKS))
    for a, b in zip(rt, rj):
        check_results(a, b)
    assert not np.array_equal(rt[0]["tags"], rt[1]["tags"])
    names = check_trees(str(tmp_path / "a"), str(tmp_path / "b"))
    assert sum(n.endswith("taggedMoments.dat") for n in names) == 2


def test_run_sweep_matches_jax(tmp_path):
    pts = [{"detuning": -1.0}, {"detuning": 0.0}]
    cfg_j = jmt.MCTagConfig(save_directory=str(tmp_path / "a"), **FAST)
    cfg_t = tmt.MCTagConfig(save_directory=str(tmp_path / "b"), **FAST)
    rj, mj = jmt.run_sweep(cfg_j, pts, seed=2)
    _, params = sweep_member_params(cfg_j, pts, 1, cfg_j.scheme_unit(),
                                    jnp.float32, jnp.complex64)
    rt, mt = tmt.run_sweep(cfg_t, pts, seed=2, device="cpu",
                           draws=JaxMcDraws(_keys(2, 2), "mc_tag", N_CHUNKS),
                           qt_params=qt_params_from_numpy(params,
                                                          device="cpu"))
    assert [m.detuning for m in mt] == [m.detuning for m in mj]
    for a, b in zip(rt, rj):
        check_results(a, b)
    names = check_trees(str(tmp_path / "a"), str(tmp_path / "b"))
    assert len({n.split(os.sep)[0] for n in names}) == 2


# ------------------------------------------ the port on its own: bitwise

def _equal(a, b):
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fold_member_equals_its_own_run():
    cfg = tmt.MCTagConfig(**FAST)
    fold = tmt.run_ensemble(cfg, 2, seed=4, device="cpu")
    for j in range(2):
        _equal(fold[j], tmt.run(dataclasses.replace(cfg, job=j + 1),
                                seed=member_seed(4, j), device="cpu"))
    assert not np.array_equal(fold[0]["R"], fold[1]["R"])


def test_sweep_identity_member_equals_ensemble_member():
    cfg = tmt.MCTagConfig(**FAST)
    ens = tmt.run_ensemble(cfg, 2, seed=6, device="cpu")
    sw, _ = tmt.run_sweep(cfg, [{}, {"detuning": -3.0}], seed=6,
                          device="cpu")
    _equal(sw[0], ens[0])
    assert not np.array_equal(sw[1]["tags"], ens[1]["tags"])


def test_mesh_equals_single_fold():
    """A 2-point sweep over 2 ens slots equals the single fold (the
    ensemble takes the same member_sharded path)."""
    cfg = tmt.MCTagConfig(**FAST)
    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    pts = [{"detuning": d} for d in (-3.0, -1.0)]
    a, _ = tmt.run_sweep(cfg, pts, seed=3, device="cpu")
    b, _ = tmt.run_sweep(cfg, pts, seed=3, mesh=mesh)
    for x, y in zip(a, b):
        _equal(x, y)


RESUME = dict(FAST, dtype="float64")


@pytest.mark.parametrize("crash_after", [2, 5, 8, 10])
def test_crash_resume_bit_identical(tmp_path, crash_after):
    """Crash points mid-MC (2), mid-pump (5, 8: the live state with psi,
    the per-ion clocks, tick, t and the generator) and mid-record (10):
    the resumed run equals the uninterrupted one bit for bit, and so does
    its tree."""
    cfg1 = tmt.MCTagConfig(**RESUME, save_directory=str(tmp_path / "a"),
                           checkpoint_every_chunks=1)
    ref = tmt.run(cfg1, seed=5, device="cpu")
    cfg2 = dataclasses.replace(cfg1, save_directory=str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="simulated crash"):
        tmt.run(cfg2, seed=5, device="cpu",
                _crash_after_checkpoints=crash_after)
    (path,) = list((tmp_path / "b").rglob("pipeline_checkpoint_*.npz"))
    with np.load(path) as z:
        stage = int(z["stage"])
        assert ("psi" in z.files) == (stage == 2)
    assert stage == {2: 0, 5: 2, 8: 2, 10: 3}[crash_after]
    res = tmt.run(cfg2, seed=5, device="cpu", resume=True)
    _equal(ref, res)
    a, b = _files(str(tmp_path / "a")), _files(str(tmp_path / "b"))
    dats = sorted(k for k in a if k.endswith(".dat"))
    assert dats == sorted(k for k in b if k.endswith(".dat")) and dats
    for rel in dats:
        assert open(a[rel], "rb").read() == open(b[rel], "rb").read(), rel


def test_resume_guards(tmp_path):
    cfg = tmt.MCTagConfig(**RESUME, save_directory=str(tmp_path),
                          checkpoint_every_chunks=1)
    with pytest.raises(ValueError, match="no pipeline checkpoint"):
        tmt.run(cfg, seed=5, device="cpu", resume=True)
    with pytest.raises(RuntimeError, match="simulated crash"):
        tmt.run(cfg, seed=5, device="cpu", _crash_after_checkpoints=6)
    with pytest.raises(ValueError, match="refusing to splice"):
        tmt.run(cfg, seed=6, device="cpu", resume=True)
    with pytest.raises(ValueError, match="refusing to splice"):
        tmt.run(dataclasses.replace(cfg, mc_steps=200), seed=5,
                device="cpu", resume=True)
    with pytest.raises(ValueError, match="needs save_directory"):
        tmt.run(dataclasses.replace(cfg, save_directory=None), seed=5,
                device="cpu", resume=True)
    (path,) = list(tmp_path.rglob("pipeline_checkpoint_*.npz"))
    with np.load(path) as z:
        kept = {k: z[k] for k in z.files if not k.startswith("torch_rng")}
    np.savez(path, **kept)                     # mid-pump, no generator
    with pytest.raises(ValueError, match="no generator state"):
        tmt.run(cfg, seed=5, device="cpu", resume=True)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_resume_across_packages(writer, tmp_path):
    """A checkpoint at stage 3 (after the measurement: the recording draws
    nothing) written by either package is finished by the other; the
    results and tree equal the writer's own uninterrupted run at the
    float32 bars."""
    kw = FAST
    d, full = str(tmp_path / "run"), str(tmp_path / "full")
    cj = jmt.MCTagConfig(**kw, save_directory=d, checkpoint_every_chunks=1)
    ct = tmt.MCTagConfig(**kw, save_directory=d, checkpoint_every_chunks=1)
    with pytest.raises(RuntimeError, match="simulated crash"):
        if writer == "jax":
            jmt.run(cj, seed=5, _crash_after_checkpoints=9)
        else:
            tmt.run(ct, seed=5, device="cpu", _crash_after_checkpoints=9)
    (path,) = list((tmp_path / "run").rglob("pipeline_checkpoint_*.npz"))
    with np.load(path) as z:
        assert int(z["stage"]) == 3 and "tags" in z.files
    if writer == "jax":
        res = tmt.run(ct, seed=5, device="cpu", resume=True)
        ref = jmt.run(jmt.MCTagConfig(**kw, save_directory=full), seed=5)
    else:
        res = jmt.run(cj, seed=5, resume=True)
        ref = tmt.run(tmt.MCTagConfig(**kw, save_directory=full), seed=5,
                      device="cpu")
    check_results({k: np.asarray(v) for k, v in res.items()}, ref)
    got = sorted(n for n in _files(d) if not n.endswith(".npz"))
    assert got == sorted(_files(full)) and got
    check_trees(d, full, got)


def test_guards():
    cfg = tmt.MCTagConfig(**SMALL)
    f64 = tmt.MCTagConfig(**SMALL, dtype="float64")
    with pytest.raises(NotImplementedError, match="float64"):
        tmt.run(f64, device="cuda")
    with pytest.raises(NotImplementedError, match="float64"):
        tmt.run_sweep(f64, [{"om": 1.0}], device="cuda")
    with pytest.raises(ValueError, match="override"):
        tmt.run_sweep(cfg, [{"gamma": 1.0}], device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        tmt.run_ensemble(cfg, 2, mesh=make_mesh(2, 1, devices=["cpu"] * 2),
                         draws=JaxMcDraws(_keys(0, 2), "mc_tag", N_CHUNKS))
    with pytest.raises(AssertionError):
        tmt.MCTagConfig(variant="422quad")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tmt.run(cfg)                      # the default device is cuda


def test_stage_functions_match_jax():
    """The stage functions the pipeline runs: ``_mc_scan`` (float64,
    1e-12, the accept count exact), then ``pump_phase`` and
    ``record_phase`` (float32, the bars above) from one state, the JAX key
    chain replayed."""
    from mdqtplasmasims_torch.core.pipeline import _cat, fresh_state
    from mdqtplasmasims_torch.state import SimState
    cpu = torch.device("cpu")
    cfg_j = jmt.MCTagConfig(**dict(RESUME, mc_steps=250))
    cfg_t = tmt.MCTagConfig(**dict(RESUME, mc_steps=250))
    key = jax.random.PRNGKey(12)
    d = JaxMcDraws(key, "mc_tag", 2)
    m = tmt._members(cfg_t, 1, d, single=True)
    R0 = np.random.default_rng(1).uniform(0, cfg_j.L, (27, 3))
    Rj, acc_j = jmt._mc_scan(cfg_j, jnp.asarray(R0),
                             jax.random.split(key, 5)[2])
    st = fresh_state(cpu, tmt.ACC_KEYS)
    st["R"] = torch.from_numpy(R0)[None]
    tmt._mc_scan(cfg_t, m, st)
    assert st["stage"] == 1 and int(st["n_acc"][0]) == int(acc_j) > 0
    np.testing.assert_allclose(st["R"][0].numpy(), np.asarray(Rj), rtol=0,
                               atol=1e-12)
    cfg_j = jmt.MCTagConfig(**FAST)
    cfg_t = tmt.MCTagConfig(**FAST)
    rng = np.random.default_rng(2)
    R = np.array(Rj, np.float32)
    V = (rng.normal(size=(27, 3)) * 0.6).astype(np.float32)
    psi = np.array(random_s_superposition(key, 27, 5, jnp.complex64))
    A = np.array(jforces(jnp.asarray(R), cfg_j.L, 2.0)[0])
    d.m[0]["run"] = key
    st_j = jmt.pump_phase(cfg_j, *(jnp.asarray(x) for x in (R, V, A, psi)),
                          jnp.zeros(27, jnp.float32), key)
    m = tmt._members(cfg_t, 1, d, single=True)
    R_, V_, A_, psi_ = (torch.from_numpy(x)[None] for x in (R, V, A, psi))
    st = fresh_state(cpu, tmt.ACC_KEYS)
    st["pump"] = SimState(R=R_, V=V_, F=A_, psi=psi_,
                          t_part=torch.zeros((1, 27)))
    st_t = tmt.pump_phase(cfg_t, m, st)
    assert "pump" not in st
    for name in ("R", "V", "F", "t_part", "psi"):
        np.testing.assert_allclose(getattr(st_t, name)[0].numpy(),
                                   np.asarray(getattr(st_j, name)),
                                   atol=5e-5 if name == "psi" else 2e-5,
                                   rtol=1e-5, err_msg=name)
    assert st_t.tick == int(st_j.tick) and st_t.t == float(st_j.t)
    tags = (np.abs(psi[:, 0]) > 0.5)
    out_j = jmt.record_phase(cfg_j, st_j.R, st_j.V, st_j.F, key,
                             jnp.asarray(tags))
    st.update(R=st_t.R, V=st_t.V, A=st_t.F, tags=torch.from_numpy(tags)[None])
    tmt.record_phase(cfg_t, m, st)
    assert (st["stage"], len(st["autoc"])) == (4, 4)
    grs, *rest = (_cat(st["acc"][k]) for k in tmt.ACC_KEYS)
    gr_close(grs[0].numpy(), np.asarray(out_j[1]), 27, L27)
    for got, want in zip([st[k] for k in "RVA"] + rest,
                         out_j[0][:3] + out_j[2:], strict=True):
        _close(got[0].numpy(), want, "record_phase")
