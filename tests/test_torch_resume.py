"""Checkpoints and resume of the port (CPU): a run split at a checkpoint
and resumed equals the uninterrupted run bit for bit, for ``run`` and
``run_ensemble``, on and off the sample grid; ASCII-checkpoint resume;
the fold's consistency errors (as the JAX package's
tests/test_experiments.py:703-898); and the generator-state rule (the
port's own state under ``torch_rng_state``, else a reseed with
``job*7919 + c0``).  Resume across the two packages is held in
tests/test_torch_resume_jax.py."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.io import checkpoint as ckpt
from mdqtplasmasims_torch.core.init import poisson_member_mask
from mdqtplasmasims_torch.core.scheduler import uniform_rolls
from mdqtplasmasims_torch.experiments import laser_cooling as tlc

torch.set_num_threads(1)

BASE = dict(n0=64, sample_freq=2)
STATE_KEYS = ("R", "V", "psi", "t_part")


def _files(root):
    return {os.path.relpath(p, root): p
            for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
            if os.path.isfile(p)}


def _assert_same_files(got, want, names):
    for name in names:
        if name.endswith(".npz"):
            with np.load(got[name]) as a, np.load(want[name]) as b:
                assert sorted(a.files) == sorted(b.files), name
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k],
                                                  err_msg=f"{name}:{k}")
        else:
            with open(got[name], "rb") as a, open(want[name], "rb") as b:
                assert a.read() == b.read(), name


def _assert_chain_equals_straight(dir_chain, dir_straight, final_c0):
    """The chained and the straight tree hold the same .dat outputs and
    the same terminal checkpoint at ``final_c0``, byte for byte (arrays
    for .npz); every other file the two share is identical too.  They
    differ only in where the intermediate checkpoints fell."""
    fc, fs = _files(dir_chain), _files(dir_straight)
    must = {n for n in fs if "timestep" not in n and not n.endswith(".npz")}
    must |= {n for n in fs if f"timestep{final_c0:06d}" in n
             or n.endswith(f"checkpoint_{final_c0:06d}.npz")}
    assert len(must) > 10 and must <= set(fc)
    _assert_same_files(fc, fs, sorted(set(fc) & set(fs)))


@pytest.mark.parametrize("tmax1,tmax2", [(0.008, 0.012), (0.01, 0.014)])
def test_run_resumed_equals_uninterrupted(tmp_path, tmax1, tmax2):
    """On the grid (4 + 2 steps) and off it (5 + 2 steps: the first
    window ends with an unsampled step, the second realigns with a
    one-step sampled span)."""
    cfg = tlc.CoolingConfig(tmax=tmax1, checkpoint_every_segments=1,
                            save_directory=str(tmp_path / "a"), **BASE)
    tlc.run(cfg, device="cpu")
    chain, res = tlc.run(dataclasses.replace(cfg, tmax=tmax2), resume=True,
                         device="cpu")
    assert res["outs"]["t"].shape == (1,)
    straight, _ = tlc.run(dataclasses.replace(
        cfg, tmax=tmax2, save_directory=str(tmp_path / "b")), device="cpu")
    for k in STATE_KEYS:
        np.testing.assert_array_equal(getattr(chain, k), getattr(straight, k))
    assert chain.tick == straight.tick == round(tmax2 / 0.002) * 25
    _assert_chain_equals_straight(str(tmp_path / "a"), str(tmp_path / "b"),
                                  round(tmax2 / 0.002) - 1)


def test_ensemble_resumed_equals_uninterrupted(tmp_path):
    cfg = tlc.CoolingConfig(tmax=0.008, exact_n=False,
                            checkpoint_every_segments=1,
                            save_directory=str(tmp_path / "a"), **BASE)
    tlc.run_ensemble(cfg, 2, seed=6, device="cpu")
    chain, outs = tlc.run_ensemble(dataclasses.replace(cfg, tmax=0.012), 2,
                                   seed=6, resume=True, device="cpu")
    assert outs["t"].shape == (2, 1)
    straight, _ = tlc.run_ensemble(dataclasses.replace(
        cfg, tmax=0.012, save_directory=str(tmp_path / "b")), 2, seed=6,
        device="cpu")
    # real lanes only: a padded lane's clock ticks on, and checkpoints keep
    # the member's real ions alone (as the JAX package's do)
    _, n_js = poisson_member_mask(64, 2, 6)
    for j, nj in enumerate(n_js):
        for k in STATE_KEYS:
            np.testing.assert_array_equal(getattr(chain, k)[j][:nj],
                                          getattr(straight, k)[j][:nj])
    _assert_chain_equals_straight(str(tmp_path / "a"), str(tmp_path / "b"), 5)
    # the port's generator state rides every native checkpoint, never "key"
    for p in glob.glob(str(tmp_path / "a" / "**" / "*.npz"), recursive=True):
        with np.load(p) as z:
            assert "torch_rng_state" in z.files and "key" not in z.files


def test_resume_without_generator_state_reseeds(tmp_path):
    """A checkpoint without the port's generator state (the JAX package's,
    or an ASCII one) continues with a generator seeded job*7919 + c0."""
    cfg = tlc.CoolingConfig(tmax=0.008, job=2, save_directory=str(tmp_path),
                            **BASE)
    tlc.run(cfg, device="cpu")
    d = os.path.dirname(glob.glob(str(tmp_path / "**" / "checkpoint_*.npz"),
                                  recursive=True)[0])
    path = os.path.join(d, "checkpoint_000003.npz")
    with np.load(path) as z:
        kept = {k: z[k] for k in z.files if not k.startswith("torch_rng")}
    np.savez(path, **kept)
    backup = {p: open(p, "rb").read() for p in _files(d).values()}
    cfg2 = dataclasses.replace(cfg, tmax=0.012)
    a, _ = tlc.run(cfg2, resume=True, device="cpu")
    for p, data in backup.items():          # rewind the directory
        with open(p, "wb") as f:
            f.write(data)
    for p in set(_files(d).values()) - set(backup):
        os.remove(p)
    b, _ = tlc.run(cfg2, resume=True, device="cpu", rolls_fn=uniform_rolls(
        torch.Generator().manual_seed(2 * 7919 + 3)))
    for k in STATE_KEYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_ascii_resume_keeps_each_members_count(tmp_path):
    cfg = tlc.CoolingConfig(tmax=0.008, exact_n=False,
                            save_directory=str(tmp_path), **BASE)
    tlc.run_ensemble(cfg, 2, seed=5, device="cpu")
    dirs = sorted(os.path.dirname(p) for p in glob.glob(
        str(tmp_path / "**" / "energies.dat"), recursive=True))
    n_js = [ckpt.read_ions(d, 3)[0] for d in dirs]
    assert n_js[0] != n_js[1]
    for p in glob.glob(str(tmp_path / "**" / "*.npz"), recursive=True):
        os.remove(p)
    final, outs = tlc.run_ensemble(dataclasses.replace(cfg, tmax=0.016), 2,
                                   resume=True, device="cpu")
    assert outs["t"].shape == (2, 2)
    np.testing.assert_allclose(final.t, 0.016, rtol=1e-6)
    for d, nj in zip(dirs, n_js):
        e = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
        assert e.shape[0] == 4 and np.isfinite(e).all()
        np.testing.assert_allclose(np.diff(e[:, 0]), 0.004, rtol=1e-4)
        R, _ = ckpt.read_conditions(d, 7)
        assert R.shape[0] == nj and ckpt.read_ions(d, 7) == (nj, 4)
    # single run: ASCII resume continues the sample numbering
    one = tlc.CoolingConfig(tmax=0.008, save_directory=str(tmp_path / "s"),
                            **BASE)
    tlc.run(one, device="cpu")
    for p in glob.glob(str(tmp_path / "s" / "**" / "*.npz"), recursive=True):
        os.remove(p)
    fin, res = tlc.run(dataclasses.replace(one, tmax=0.012), resume=True,
                       device="cpu")
    assert res["outs"]["t"].shape == (1,) and res["epot0"] == 0.0
    assert glob.glob(str(tmp_path / "s" / "**" / "vel_distX_time000002.dat"),
                     recursive=True)


def test_fold_resume_consistency_errors(tmp_path):
    cfg = tlc.CoolingConfig(tmax=0.008, save_directory=str(tmp_path), **BASE)
    tlc.run_ensemble(cfg, 2, seed=3, device="cpu")
    dirs = sorted(os.path.dirname(p) for p in glob.glob(
        str(tmp_path / "**" / "energies.dat"), recursive=True))
    cfg2 = dataclasses.replace(cfg, tmax=0.016)

    # a newer ASCII checkpoint for job 1 only
    R, V = ckpt.read_conditions(dirs[0], 3)
    psi = ckpt.read_wvfns(dirs[0], 3)
    n, counter = ckpt.read_ions(dirs[0], 3)
    ckpt.write_ions(dirs[0], 53, n, counter + 5)
    ckpt.write_conditions(dirs[0], 53, R, V)
    ckpt.write_wvfns(dirs[0], 53, psi)
    with pytest.raises(ValueError, match="newer than the native"):
        tlc.run_ensemble(cfg2, 2, resume=True, device="cpu")
    # ... and with the native files gone, ASCII checkpoints that disagree
    saved = {p: open(p, "rb").read() for p in glob.glob(
        str(tmp_path / "**" / "*.npz"), recursive=True)}
    for p in saved:
        os.remove(p)
    with pytest.raises(ValueError, match="inconsistent ASCII"):
        tlc.run_ensemble(cfg2, 2, resume=True, device="cpu")
    for name in ("ions", "conditions", "wvFns"):
        os.remove(os.path.join(dirs[0], f"{name}_timestep000053.dat"))
    for p, data in saved.items():
        with open(p, "wb") as f:
            f.write(data)

    # members at different counters
    path = os.path.join(dirs[1], "checkpoint_000003.npz")
    with np.load(path) as z:
        bumped = dict({k: z[k] for k in z.files}, counter=np.int64(7))
    np.savez(path, **bumped)
    with pytest.raises(ValueError, match="inconsistent checkpoint counters"):
        tlc.run_ensemble(cfg2, 2, resume=True, device="cpu")

    # job 2 loses all its checkpoints (both formats)
    for p in (glob.glob(os.path.join(dirs[1], "checkpoint_*.npz"))
              + glob.glob(os.path.join(dirs[1], "*_timestep*.dat"))):
        os.remove(p)
    with pytest.raises(ValueError, match="subset of jobs"):
        tlc.run_ensemble(cfg2, 2, resume=True, device="cpu")
