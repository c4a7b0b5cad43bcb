"""Resume across the two packages (CPU): the port continues a JAX native
checkpoint, with the uniforms replayed from that checkpoint's ``key``,
and writes the same tree as the JAX package's own resume; the JAX
package continues a port checkpoint (which carries no ``key``, so JAX
reseeds) with its sample numbering and counters intact.  For ``run`` and
for ``run_ensemble``.  JAX runs its Pallas kernels in interpret mode;
bars as in tests/test_torch_ensemble.py."""

import dataclasses
import glob
import os
import shutil

import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.experiments import laser_cooling as jlc
from mdqtplasmasims_tpu.io import checkpoint as ckpt
from mdqtplasmasims_torch.experiments import laser_cooling as tlc

from test_torch_ensemble import (assert_states_close, assert_trees_close,
                                 jax_rolls)

torch.set_num_threads(1)

WINDOW = dict(n0=64, sample_freq=2, tmax=0.008, checkpoint_every_segments=1)


def _jax_cfg(root, **kw):
    return jlc.CoolingConfig(fused_interpret=True, use_pallas=False,
                             save_directory=str(root), **dict(WINDOW, **kw))


def _key_of(directory, c0):
    return np.asarray(ckpt.load_native(directory, c0)["key"], np.uint32)


def _job_dirs(root):
    return sorted(os.path.dirname(p) for p in glob.glob(
        os.path.join(str(root), "**", "energies.dat"), recursive=True))


@pytest.mark.parametrize("family", ["run", "ensemble"])
def test_port_continues_jax_checkpoint_as_jax_does(tmp_path, family):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    cfg1 = _jax_cfg(jax_dir)
    cfg2 = dataclasses.replace(cfg1, tmax=0.012)
    if family == "run":
        jlc.run(cfg1)
        shutil.copytree(jax_dir, port_dir)
        fj, _ = jlc.run(cfg2, resume=True)
    else:
        jlc.run_ensemble(cfg1, 2, seed=1)
        shutil.copytree(jax_dir, port_dir)
        fj, _ = jlc.run_ensemble(cfg2, 2, seed=1, resume=True)
    key = jax_rolls(_key_of(_job_dirs(port_dir)[0], 3))
    cfg_t = tlc.CoolingConfig(save_directory=str(port_dir),
                              **dict(WINDOW, tmax=0.012))
    if family == "run":
        ft, res = tlc.run(cfg_t, resume=True, device="cpu", rolls_fn=key)
        assert res["outs"]["t"].shape == (1,)
        for k in ("R", "V", "t_part", "psi"):
            np.testing.assert_allclose(getattr(ft, k),
                                       np.asarray(getattr(fj, k)),
                                       atol=5e-5, rtol=1e-5, err_msg=k)
    else:
        ft, outs = tlc.run_ensemble(cfg_t, 2, resume=True, device="cpu",
                                    rolls_fn=key)
        assert outs["t"].shape == (2, 1)
        assert_states_close(ft, fj)
    assert_trees_close(str(jax_dir), str(port_dir))


@pytest.mark.parametrize("family", ["run", "ensemble"])
def test_jax_continues_port_checkpoint(tmp_path, family):
    cfg_t = tlc.CoolingConfig(save_directory=str(tmp_path),
                              **dict(WINDOW, exact_n=family == "run"))
    cfg2 = _jax_cfg(tmp_path, tmax=0.012, exact_n=family == "run")
    if family == "run":
        tlc.run(cfg_t, device="cpu")
        fj, res = jlc.run(cfg2, resume=True)
        assert res["outs"]["t"].shape[0] == 1
        assert float(fj.t) == pytest.approx(0.012, rel=1e-6)
    else:
        tlc.run_ensemble(cfg_t, 2, seed=2, device="cpu")
        fj, outs = jlc.run_ensemble(cfg2, 2, resume=True)
        assert outs["t"].shape == (2, 1)
        np.testing.assert_allclose(np.asarray(fj.t), 0.012, rtol=1e-6)
    for d in _job_dirs(tmp_path):
        e = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
        assert e.shape[0] == 3 and np.isfinite(e).all()
        np.testing.assert_allclose(np.diff(e[:, 0]), 0.004, rtol=1e-4)
        assert os.path.exists(os.path.join(d, "vel_distX_time000002.dat"))
        n3, c3 = ckpt.read_ions(d, 3)
        n5, c5 = ckpt.read_ions(d, 5)
        assert (c3, c5) == (2, 3) and n5 == n3
        # the port's checkpoints carry its generator state, never "key"
        z = ckpt.load_native(d, 1)
        assert "torch_rng_state" in z and "key" not in z
