"""``run_ensemble(mesh=...)`` / ``run_sweep(mesh=...)`` end to end on a
mesh of CPU slots (the port's stand-in for the JAX package's virtual
devices, as tests/test_parallel_fused.py:299-466 runs the JAX mesh path):
the .dat trees, checkpoints and resume on the mesh, off-grid tmax, ASCII
resume onto an ion-sharded mesh, cross-mode resume both ways, Poissonian
members, a sweep, the CLI's mesh flags, and the ens-only mesh bitwise
equal to the unsharded fold (explicit rolls, and the in-kernel stream's
twin).  Port only: the JAX package's own mesh runs draw other uniforms
(its keys), so the bars here are bitwise equality between the port's
layouts and the file contracts the JAX tests pin.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from mdqtplasmasims_torch import cli
from mdqtplasmasims_torch.experiments import laser_cooling as lc
from mdqtplasmasims_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

FIELDS = ("R", "V", "psi", "t_part")


def cpu_mesh(k, i):
    return make_mesh(k, i, devices=["cpu"] * (k * i))


def _cfg(tmp, **kw):
    kw.setdefault("n0", 48)
    kw.setdefault("sample_freq", 5)
    return lc.CoolingConfig(save_directory=None if tmp is None else str(tmp),
                            **kw)


def _equal(a, b, n_js=None):
    """Final host states equal bit for bit (real lanes of Poissonian
    members: a padded lane's clock ticks on and is not checkpointed)."""
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if n_js is None:
            assert np.array_equal(x, y), f
        else:
            for j, nj in enumerate(n_js):
                assert np.array_equal(x[j][:nj], y[j][:nj]), f


def _dirs(root):
    return sorted(os.path.dirname(p)
                  for p in glob.glob(os.path.join(str(root), "**",
                                                  "energies.dat"),
                                     recursive=True))


@pytest.fixture
def rng_on_cpu(monkeypatch):
    monkeypatch.setattr(lc, "_use_internal_rng",
                        lambda device, rolls_fn: rolls_fn is None)


@pytest.mark.parametrize("form", ["rolls", "rng"])
def test_ens_only_mesh_bitwise_equals_fold(form, monkeypatch):
    if form == "rng":
        monkeypatch.setattr(lc, "_use_internal_rng",
                            lambda device, rolls_fn: rolls_fn is None)
    cfg = _cfg(None, tmax=0.04)
    f0, o0 = lc.run_ensemble(cfg, 2, seed=3, device="cpu")
    f1, o1 = lc.run_ensemble(cfg, 2, seed=3, mesh=cpu_mesh(2, 1))
    _equal(f0, f1)
    for k in o0:
        assert np.array_equal(o0[k], o1[k]), k


def test_run_ensemble_on_mesh_end_to_end_and_resume(tmp_path):
    """Files of a (2,2) gather run; a checkpointed window resumed on the
    same mesh is bitwise the uninterrupted run (ring_n3l)."""
    mesh = cpu_mesh(2, 2)
    cfg1 = _cfg(tmp_path / "a", tmax=0.02, checkpoint_every_segments=1)
    _, outs1 = lc.run_ensemble(cfg1, 2, seed=4, mesh=mesh)
    assert outs1["t"].shape == (2, 2)
    dirs = _dirs(tmp_path / "a")
    assert len(dirs) == 2
    for d in dirs:
        e = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
        assert e.shape[0] == 2 and np.isfinite(e).all()
        assert os.path.exists(os.path.join(d, "checkpoint_000004.npz"))
    cfg2 = dataclasses.replace(cfg1, tmax=0.04)
    final2, outs2 = lc.run_ensemble(cfg2, 2, seed=4, resume=True, mesh=mesh,
                                    ion_forces="ring_n3l")
    assert outs2["t"].shape == (2, 2)            # only the remaining half
    for d in dirs:
        assert np.loadtxt(os.path.join(d, "energies.dat")).shape[0] == 4
    assert not np.allclose(final2.R[0], final2.R[1])
    # on one schedule, a resumed chain is the uninterrupted run bit for bit
    whole, _ = lc.run_ensemble(_cfg(tmp_path / "b", tmax=0.04,
                                    checkpoint_every_segments=1), 2, seed=4,
                               mesh=mesh, ion_forces="ring_n3l")
    lc.run_ensemble(_cfg(tmp_path / "c", tmax=0.02,
                         checkpoint_every_segments=1), 2, seed=4, mesh=mesh,
                    ion_forces="ring_n3l")
    resumed, _ = lc.run_ensemble(_cfg(tmp_path / "c", tmax=0.04,
                                      checkpoint_every_segments=1), 2,
                                 seed=4, resume=True, mesh=mesh,
                                 ion_forces="ring_n3l")
    _equal(resumed, whole)


def test_offgrid_tmax_on_mesh(tmp_path):
    mesh = cpu_mesh(2, 1)
    cfg1 = _cfg(tmp_path, tmax=0.022)           # 11 steps: 2 samples + 1
    final1, _ = lc.run_ensemble(cfg1, 2, seed=4, mesh=mesh)
    assert final1.t[0] == pytest.approx(0.022, rel=1e-6)
    for d in _dirs(tmp_path):
        assert os.path.exists(os.path.join(d, "checkpoint_000010.npz"))
    cfg2 = dataclasses.replace(cfg1, tmax=0.04)
    final2, _ = lc.run_ensemble(cfg2, 2, seed=4, resume=True, mesh=mesh)
    assert final2.t[0] == pytest.approx(0.04, rel=1e-6)
    for d in _dirs(tmp_path):
        e = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
        assert e.shape[0] == 4
        np.testing.assert_allclose(np.diff(e[:, 0]), 0.01, rtol=1e-5)


def test_ascii_resume_onto_ion_sharded_mesh(tmp_path):
    cfg1 = _cfg(tmp_path, tmax=0.02)
    lc.run_ensemble(cfg1, 2, seed=4, device="cpu")
    for d in _dirs(tmp_path):
        for p in glob.glob(os.path.join(d, "checkpoint_*.npz")):
            os.remove(p)
    cfg2 = dataclasses.replace(cfg1, tmax=0.04)
    final2, outs2 = lc.run_ensemble(cfg2, 2, resume=True,
                                    mesh=cpu_mesh(2, 2))
    assert final2.t[0] == pytest.approx(0.04, rel=1e-6)
    assert outs2["t"].shape == (2, 2)
    for d in _dirs(tmp_path):
        e = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
        assert e.shape[0] == 4
        np.testing.assert_allclose(np.diff(e[:, 0]), 0.01, rtol=1e-5)


@pytest.mark.parametrize("first", ["fold", "mesh"])
def test_cross_mode_resume(tmp_path, first):
    """A single-fold checkpoint resumes on a mesh and a mesh checkpoint on
    the single fold; on an ens-only mesh the chain is bitwise the
    uninterrupted single fold."""
    mesh = cpu_mesh(2, 1)
    modes = {"fold": dict(device="cpu"), "mesh": dict(mesh=mesh)}
    second = "mesh" if first == "fold" else "fold"
    cfg1 = _cfg(tmp_path / "a", tmax=0.02, checkpoint_every_segments=1)
    lc.run_ensemble(cfg1, 2, seed=4, **modes[first])
    final, outs = lc.run_ensemble(dataclasses.replace(cfg1, tmax=0.04), 2,
                                  seed=4, resume=True, **modes[second])
    assert outs["t"].shape == (2, 2)
    whole, _ = lc.run_ensemble(_cfg(tmp_path / "b", tmax=0.04,
                                    checkpoint_every_segments=1), 2, seed=4,
                               device="cpu")
    _equal(final, whole)
    for d in _dirs(tmp_path / "a"):
        assert np.loadtxt(os.path.join(d, "energies.dat")).shape[0] == 4


def test_poisson_members_on_mesh(tmp_path):
    cfg = _cfg(None, tmax=0.02, exact_n=False)
    f0, o0 = lc.run_ensemble(cfg, 2, seed=6, device="cpu")
    f1, o1 = lc.run_ensemble(cfg, 2, seed=6, mesh=cpu_mesh(2, 1))
    _, n_js = lc.poisson_member_mask(cfg.n0, 2, 6)
    _equal(f0, f1, n_js)
    assert np.array_equal(o0["ekin"], o1["ekin"])
    # ion-sharded: lanes padded to the shard multiple, files sized to N
    cfg2 = dataclasses.replace(cfg, save_directory=str(tmp_path))
    f2, _ = lc.run_ensemble(cfg2, 2, seed=6, mesh=cpu_mesh(2, 2),
                            ion_forces="ring_n3l")
    assert f2.R.shape[1] % 2 == 0
    for j, nj in enumerate(n_js):
        assert not f2.R[j][nj:].any() and not f2.psi[j][nj:].any()
    n_seen = sorted(np.loadtxt(p).shape[0] for p in glob.glob(
        os.path.join(str(tmp_path), "**", "conditions_timestep*.dat"),
        recursive=True))
    assert n_seen == sorted(n_js)


def test_sweep_on_mesh_equals_fold(rng_on_cpu):
    cfg = _cfg(None, tmax=0.02)
    points = [{"detuning": -1.0, "om": 0.8}, {"detuning": -0.5, "om": 1.2}]
    f0, o0, _ = lc.run_sweep(cfg, points, seed=2, device="cpu")
    f1, o1, mc = lc.run_sweep(cfg, points, seed=2, mesh=cpu_mesh(2, 1))
    _equal(f0, f1)
    assert np.array_equal(o0["pops"], o1["pops"])
    assert [c.detuning for c in mc] == [-1.0, -0.5]


def test_cli_mesh_flags(tmp_path, capsys):
    rc = cli.main(["cooling-ensemble", "--jobs", "2", "--n0", "48",
                   "--tmax", "0.01", "--sample-freq", "5", "--device", "cpu",
                   "--mesh-ens", "2", "--mesh-ions", "2",
                   "--save-directory", str(tmp_path / "e")])
    assert rc == 0 and "mesh 2 x 2" in capsys.readouterr().out
    assert len(_dirs(tmp_path / "e")) == 2
    rc = cli.main(["cooling-sweep", "--det-sp-values=-1,-0.5", "--n0", "48",
                   "--tmax", "0.01", "--sample-freq", "5", "--device", "cpu",
                   "--mesh-ens", "2", "--save-directory",
                   str(tmp_path / "s")])
    assert rc == 0 and len(_dirs(tmp_path / "s")) == 2


def test_mesh_guards():
    cfg = _cfg(None, tmax=0.01)
    with pytest.raises(ValueError, match="divide"):
        lc.run_ensemble(cfg, 3, mesh=cpu_mesh(2, 1))
    with pytest.raises(ValueError, match="divide"):
        lc.run_ensemble(dataclasses.replace(cfg, n0=49), 2,
                        mesh=cpu_mesh(1, 2))
    with pytest.raises(ValueError, match="ion_forces"):
        lc.run_ensemble(cfg, 2, mesh=cpu_mesh(1, 2), ion_forces="ring")
