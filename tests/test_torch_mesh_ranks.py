"""The mesh as one process a slot (``parallel/ranks.py``) on the CPU: the
ranks meet over gloo and are held bit for bit to the single-controller
mesh (every slot stepped from one process), which is the reference the
card's NCCL ranks are held to as well.

* 2 ranks (``1 x 2`` gather and ring-N3L) and 4 ranks (``2 x 2`` gather,
  ``1 x 4`` ring-N3L) at N0 = 64 over three MD steps and a sample, with
  explicit rolls and with the in-kernel stream's twin;
* a Poissonian (masked) fold and a detuning sweep fold;
* checkpoints written by ranks resumed by the single-controller mesh and
  by the unsharded fold, and the other way, each against the
  uninterrupted run;
* the CLI's tree of ``cooling-ensemble --mesh-ens 2`` as ranks against
  the tree without a mesh, byte for byte;
* a replayed ``rolls_fn`` that pickles runs on the ranks (each draws from
  its own copy, across checkpoint groups); one that does not is refused;
  a rank that raises stops every rank and the caller gets its exception;
* the rank path's in-situ forces of a ``2 x 2`` step against the JAX
  package's ``make_sharded_fused_step`` on its virtual devices, at
  tests/test_torch_parallel.py's bar (rtol 2e-4, atol 1e-5).

The pools (one a slot layout) are shared by the whole file.
"""

import dataclasses
import functools
import glob
import os

import jax
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.experiments import laser_cooling as jlc
from mdqtplasmasims_tpu.parallel.ensemble import make_sharded_fused_step
from mdqtplasmasims_tpu.parallel.mesh import make_mesh as jmake_mesh
from mdqtplasmasims_torch import cli
from mdqtplasmasims_torch.experiments import laser_cooling as lc
from mdqtplasmasims_torch.parallel import mesh as pm
from mdqtplasmasims_torch.parallel import ranks
from mdqtplasmasims_torch.units import PlasmaUnits
from torch_rank_rolls import FailOnRank1, ReplayRolls

torch.set_num_threads(1)

FIELDS = ("R", "V", "F", "psi", "t_part")


@pytest.fixture(scope="module", autouse=True)
def _pools():
    yield
    ranks.stop_ranks()


def _mesh(K, I, as_ranks=True):
    return pm.make_mesh(K, I, devices=["cpu"] * (K * I), ranks=as_ranks)


def _cfg(tmp=None, **kw):
    kw.setdefault("n0", 64)
    kw.setdefault("tmax", 0.006)
    kw.setdefault("sample_freq", 2)
    return lc.CoolingConfig(save_directory=None if tmp is None else str(tmp),
                            **kw)


def _same(a, b, n_js=None) -> bool:
    """Two ``run_ensemble`` results bit for bit (the final host states on
    real lanes, every sample)."""
    (fa, oa), (fb, ob) = a, b
    for f in ("R", "V", "psi", "t_part"):
        x, y = getattr(fa, f), getattr(fb, f)
        if n_js is not None:
            x = [x[j][:nj] for j, nj in enumerate(n_js)]
            y = [y[j][:nj] for j, nj in enumerate(n_js)]
        if not all(np.asarray(p).tobytes() == np.asarray(q).tobytes()
                   for p, q in zip(x, y)):
            return False
    if (oa is None) != (ob is None):
        return False
    return oa is None or (oa.keys() == ob.keys() and all(
        oa[k].dtype == ob[k].dtype and oa[k].tobytes() == ob[k].tobytes()
        for k in oa))


@pytest.fixture
def rng_on_cpu(monkeypatch):
    """The in-kernel stream's twin on the CPU (the card's default)."""
    monkeypatch.setattr(lc, "_use_internal_rng",
                        lambda device, rolls_fn: rolls_fn is None)


@pytest.mark.parametrize("K,I,form", [(1, 2, "gather"), (1, 2, "ring_n3l"),
                                      (2, 2, "gather"), (1, 4, "ring_n3l")])
def test_ranks_equal_the_single_controller(K, I, form):
    cfg = _cfg()
    n = 2 * K
    one = lc.run_ensemble(cfg, n, seed=3, mesh=_mesh(K, I, False),
                          ion_forces=form)
    got = lc.run_ensemble(cfg, n, seed=3, mesh=_mesh(K, I), ion_forces=form)
    assert got[1]["ekin"].shape == (n, 1, 3)
    assert _same(got, one)


def test_ranks_in_kernel_stream_twin(rng_on_cpu):
    cfg = _cfg()
    one = lc.run_ensemble(cfg, 4, seed=5, mesh=_mesh(2, 2, False))
    got = lc.run_ensemble(cfg, 4, seed=5, mesh=_mesh(2, 2))
    assert _same(got, one)


@pytest.mark.parametrize("form", ["gather", "ring_n3l"])
def test_ranks_poissonian_fold(form):
    cfg = _cfg(exact_n=False)
    one = lc.run_ensemble(cfg, 2, seed=4, mesh=_mesh(1, 2, False),
                          ion_forces=form)
    got = lc.run_ensemble(cfg, 2, seed=4, mesh=_mesh(1, 2), ion_forces=form)
    _, _, n_js = lc._poisson_member_states(cfg, 2, 4, "cpu", round_to=2)
    assert _same(got, one, n_js)


def test_ranks_sweep_fold():
    cfg = _cfg()
    pts = [{"detuning": d} for d in (-0.5, -1.0, -2.0, -3.0)]
    one = lc.run_sweep(cfg, pts, seed=2, mesh=_mesh(2, 2, False))[:2]
    got = lc.run_sweep(cfg, pts, seed=2, mesh=_mesh(2, 2))[:2]
    assert _same(got, one)
    assert not np.array_equal(got[1]["pops"][0], got[1]["pops"][1])


def _files(root) -> dict:
    out = {}
    for p in glob.glob(os.path.join(str(root), "**", "*"), recursive=True):
        if os.path.isfile(p):
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


# (written by, resumed by): "ranks", "single" (the single-controller mesh)
# or "fold" (no mesh)
@pytest.mark.parametrize("K,I,src,dst", [
    (2, 1, "ranks", "single"), (2, 1, "ranks", "fold"),
    (2, 1, "fold", "ranks"), (2, 2, "ranks", "single"),
    (2, 2, "single", "ranks")])
def test_checkpoint_crossings(K, I, src, dst, tmp_path):
    """A window to tmax/2 resumed to tmax, written and resumed in other
    modes: the final state and every file both trees hold equal the
    uninterrupted run's (written as ranks)."""
    meshes = dict(ranks=_mesh(K, I), single=_mesh(K, I, False), fold=None)
    base = _cfg(tmp_path / "full", n0=48, tmax=0.008,
                checkpoint_every_segments=1)
    ref = lc.run_ensemble(base, K * 2, seed=6, mesh=meshes["ranks"],
                          device="cpu")
    cross = dataclasses.replace(base, save_directory=str(tmp_path / "x"))
    lc.run_ensemble(dataclasses.replace(cross, tmax=0.004), K * 2, seed=6,
                    mesh=meshes[src], device="cpu")
    got = lc.run_ensemble(cross, K * 2, seed=6, resume=True,
                          mesh=meshes[dst], device="cpu")
    for f in ("R", "V", "psi", "t_part"):
        assert np.array_equal(getattr(got[0], f), getattr(ref[0], f)), f
    a, b = _files(tmp_path / "full"), _files(tmp_path / "x")
    common = sorted(set(a) & set(b))
    assert len(common) > 5
    assert [k for k in common if a[k] != b[k]] == []


def test_cli_tree_as_ranks(tmp_path, monkeypatch):
    """``cooling-ensemble --mesh-ens 2`` with the mesh run as ranks
    writes the tree of the command without a mesh, byte for byte."""
    args = ["cooling-ensemble", "--n0", "48", "--tmax", "0.008",
            "--sample-freq", "2", "--checkpoint-every-segments", "1",
            "--jobs", "2", "--seed", "3", "--device", "cpu"]
    assert cli.main(args + ["--save-directory", str(tmp_path / "fold")]) == 0
    monkeypatch.setattr(pm, "make_mesh",
                        functools.partial(pm.make_mesh, ranks=True))
    assert cli.main(args + ["--save-directory", str(tmp_path / "ranks"),
                            "--mesh-ens", "2"]) == 0
    a, b = _files(tmp_path / "fold"), _files(tmp_path / "ranks")
    assert len(a) > 10 and a == b


def test_replayed_rolls_on_ranks(tmp_path):
    """A picklable ``rolls_fn`` runs on the ranks, each rank drawing from
    its own copy across checkpoint groups; one that does not pickle is
    refused before any rank runs."""
    cfg = _cfg(tmp_path / "one", tmax=0.012, checkpoint_every_segments=1)
    one = lc.run_ensemble(cfg, 2, mesh=_mesh(1, 2, False), device="cpu",
                          rolls_fn=ReplayRolls(8))
    got = lc.run_ensemble(dataclasses.replace(
        cfg, save_directory=str(tmp_path / "ranks")), 2, mesh=_mesh(1, 2),
        device="cpu", rolls_fn=ReplayRolls(8))
    assert one[1]["t"].shape[1] == 3 and _same(got, one)
    with pytest.raises(ValueError, match="must pickle"):
        lc.run_ensemble(_cfg(), 2, mesh=_mesh(1, 2), device="cpu",
                        rolls_fn=lambda nt, n: torch.rand(nt * 5, n))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("form", ["gather", "ring_n3l"])
def test_ranks_forces_match_jax_sharded_step(form):
    """One MD step of a ``2 x 2`` mesh as ranks from the JAX package's
    start: the in-situ forces equal those of the JAX package's
    ``make_sharded_fused_step`` on its virtual devices."""
    from mdqtplasmasims_tpu.core.init import frozen_gas_init
    from mdqtplasmasims_tpu.parallel.ensemble import (batched_initial_states,
                                                      shard_keys)
    from mdqtplasmasims_tpu.state import make_state
    jcfg = jlc.CoolingConfig(n0=64, use_pallas=False, fused_interpret=True)
    sched = dataclasses.replace(jlc.build_scheduler(jcfg), tile=128)

    def init_one(key):
        kinit, krun = jax.random.split(key)
        R, V, psi, _ = frozen_gas_init(kinit, jcfg.n0, n_states=12,
                                       exact_n=True)
        return make_state(R, V, psi, krun)
    keys = shard_keys(jax.random.PRNGKey(3), 2, 2)
    states = batched_initial_states(init_one, keys[:, 0])._replace(key=keys)
    ldeb = PlasmaUnits(jcfg.density, jcfg.ge).debye_length
    step = make_sharded_fused_step(sched, ldeb, jmake_mesh(2, 2), n_steps=1,
                                   ion_forces=form)
    want = np.asarray(jax.device_get(step(states)).F)
    cfg = _cfg(tmax=0.002, sample_freq=1)
    final, outs = lc.run_ensemble(cfg, 2, mesh=_mesh(2, 2), device="cpu",
                                  states=jax.device_get(states),
                                  ion_forces=form)
    assert outs["t"].shape == (2, 1)
    np.testing.assert_allclose(final.F, want, rtol=2e-4, atol=1e-5)


def test_a_rank_that_raises_stops_every_rank():
    """Rank 1 raises inside a collective run: the ranks are stopped, the
    caller gets the exception, and the next run starts a fresh pool."""
    mesh = _mesh(1, 2)
    pool = ranks.mesh_pool(mesh)
    with pytest.raises(FloatingPointError, match="rank 1 failed"):
        lc.run_ensemble(_cfg(), 1, mesh=mesh, device="cpu",
                        rolls_fn=FailOnRank1(1))
    assert all(not p.is_alive() for p in pool.procs)
    assert ranks.mesh_pool(mesh) is not pool
    one = lc.run_ensemble(_cfg(), 1, mesh=_mesh(1, 2, False),
                          rolls_fn=ReplayRolls(2))
    assert _same(lc.run_ensemble(_cfg(), 1, mesh=mesh,
                                 rolls_fn=ReplayRolls(2)), one)
