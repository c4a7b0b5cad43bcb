"""The port's ensemble fold as a whole against the JAX package (CPU).

Both sides run ``run_ensemble`` (2 members, N0=64, tmax=0.01,
sample_freq=2: 5 MD steps = 2 samples + 1 trailing step folded into the
last group) from the same member states, the port fed JAX's uniforms
through ``rolls_fn``: per MD step the JAX fold splits every member key,
keeps ``ks[:, 0]`` and draws the rolls from ``ks[0, 1]``
(scheduler.py:322-335), which is the single-run chain on member 0's key.
JAX runs its Pallas kernels in interpret mode.  The Poissonian-N fold is
held the same way in tests/test_torch_ensemble_poisson.py, the sweep in
tests/test_torch_sweep.py.

Tolerances: tests/test_torch_cooling.py's (R/V 2e-5, psi 5e-5; samples
and .dat files 1e-4 of each array's largest value).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.experiments import laser_cooling as jlc
from mdqtplasmasims_tpu.io.datfiles import read_rows
from mdqtplasmasims_torch.bridge import states_from_numpy
from mdqtplasmasims_torch.experiments import laser_cooling as tlc

torch.set_num_threads(1)

SMALL = dict(n0=64, tmax=0.01, sample_freq=2)
OUT_KEYS = ("t", "ekin", "epot", "vx_mean", "pvel", "vx_ions", "pops")


def jax_rolls(key):
    """rolls_fn replaying the JAX chain from ``key``: per MD step
    ``key, sub = split(key)`` then ``uniform(sub, (n_ticks*5, lanes))``."""
    box = [key]

    def rolls_fn(n_ticks, lanes):
        box[0], sub = jax.random.split(box[0])
        return torch.from_numpy(np.array(
            jax.random.uniform(sub, (n_ticks * 5, lanes), jnp.float32)))
    return rolls_fn


def files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


def assert_states_close(ft, fj, n_js=None):
    for name, atol in (("R", 2e-5), ("V", 2e-5), ("t_part", 2e-5),
                       ("psi", 5e-5)):
        np.testing.assert_allclose(getattr(ft, name),
                                   np.asarray(getattr(fj, name)),
                                   atol=atol, rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(ft.tick, np.asarray(fj.tick))
    np.testing.assert_array_equal(ft.t, np.asarray(fj.t, np.float64))


def assert_outs_close(ot, oj):
    assert set(OUT_KEYS) <= set(oj) and set(ot) == set(OUT_KEYS)
    np.testing.assert_array_equal(ot["t"], np.asarray(oj["t"]))
    for k in OUT_KEYS[1:]:
        a, b = ot[k], np.asarray(oj[k])
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max(), err_msg=k)


def assert_trees_close(root_a, root_b):
    fa, fb = files(root_a), files(root_b)
    assert sorted(fa) == sorted(fb)
    for name in sorted(fa):
        if name.endswith(".npz"):
            with np.load(fa[name]) as za, np.load(fb[name]) as zb:
                for k in ("R", "V", "psi", "counter", "c0", "t_part",
                          "epot0"):
                    np.testing.assert_allclose(zb[k], za[k], atol=5e-5,
                                               rtol=1e-5,
                                               err_msg=f"{name}:{k}")
            continue
        a, b = read_rows(fa[name]), read_rows(fb[name])
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-4 * max(np.abs(a).max(), 1e-30),
                                   err_msg=name)


def jax_member_states(cfg_j, n_jobs, seed):
    """The JAX fold's exact-N start (laser_cooling.py:1124-1127)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_jobs)
    cfg_run = jlc.canonical_run_cfg(cfg_j)
    return jax.jit(jax.vmap(
        lambda k: jlc._initial_state_from_key(cfg_run, k)))(keys)


@pytest.fixture(scope="module")
def exact_runs(tmp_path_factory):
    tmp_a = str(tmp_path_factory.mktemp("jax"))
    tmp_b = str(tmp_path_factory.mktemp("torch"))
    cfg_j = jlc.CoolingConfig(fused_interpret=True, use_pallas=False,
                              save_directory=tmp_a, **SMALL)
    states0 = jax_member_states(cfg_j, 2, seed=3)
    fin_j, outs_j = jlc.run_ensemble(cfg_j, 2, seed=3)
    cfg_t = tlc.CoolingConfig(save_directory=tmp_b, **SMALL)
    fin_t, outs_t = tlc.run_ensemble(cfg_t, 2, seed=3, device="cpu",
                                     states=states0,
                                     rolls_fn=jax_rolls(states0.key[0]))
    return (fin_j, outs_j, tmp_a), (fin_t, outs_t, tmp_b)


def test_exact_n_final_states_match_jax(exact_runs):
    (fj, _, _), (ft, _, _) = exact_runs
    assert ft.R.shape == (2, 64, 3)
    assert_states_close(ft, fj)
    assert int(ft.tick[0]) == 5 * 25


def test_exact_n_outputs_match_jax(exact_runs):
    (_, oj, _), (_, ot, _) = exact_runs
    assert ot["ekin"].shape == (2, 2, 3)
    assert_outs_close(ot, oj)


def test_exact_n_trees_match_jax(exact_runs):
    (_, _, tmp_a), (_, _, tmp_b) = exact_runs
    names = sorted(files(tmp_a))
    assert sum(n.endswith("energies.dat") for n in names) == 2
    assert any("job2" in n and "checkpoint_000004.npz" in n for n in names)
    assert_trees_close(tmp_a, tmp_b)


def test_fold_init_restore_is_identity():
    cfg = tlc.CoolingConfig(n0=100)
    sched = tlc.build_scheduler(cfg, "cpu", rolls_fn=None)
    states = tlc.member_states(cfg, 3, seed=1, device="cpu")
    states = dataclasses.replace(states, V=torch.randn(3, 100, 3),
                                 F=torch.randn(3, 100, 3),
                                 t_part=torch.rand(3, 100), tick=50)
    carry = sched.soa_ens_init(states)
    npad = sched._npad(100)
    assert carry.R.shape == (3, 3 * npad) and carry.psi_re.shape == (
        16, 3 * npad)
    # member j's ions are lanes [j*npad, j*npad + n) of every plane
    torch.testing.assert_close(carry.R[:, npad:npad + 100], states.R[1].T,
                               rtol=0, atol=0)
    assert float(carry.R[:, 100:npad].abs().max()) == 0.0
    back = sched.soa_ens_restore(carry, states)
    for k in ("R", "V", "F", "psi", "t_part"):
        torch.testing.assert_close(getattr(back, k), getattr(states, k),
                                   rtol=0, atol=0)
    assert back.tick == 50


def test_fused_substeps_ensemble_matches_members_alone():
    """One fold step equals each member stepped alone with its block of
    the same uniforms (the per-ion update is independent)."""
    cfg = tlc.CoolingConfig(n0=64)
    draws = torch.Generator().manual_seed(9)
    sched = tlc.build_scheduler(cfg, "cpu", rolls_fn=None)
    npad = sched._npad(64)
    rolls = torch.rand((cfg.ratio * 5, 2 * npad), generator=draws)
    states = tlc.member_states(cfg, 2, seed=4, device="cpu")
    F = torch.randn((2, 64, 3), generator=draws)
    sched.rolls_fn = lambda nt, lanes: rolls
    fold = sched.fused_substeps_ensemble(states, F)
    for j in range(2):
        sched.rolls_fn = lambda nt, lanes: rolls[:, j * npad:(j + 1) * npad]
        one = tlc._member(states, j)
        carry = sched.soa_init(dataclasses.replace(one, F=F[j]))
        carry = sched.soa_md_step(carry, None, reuse_forces=True)
        alone = sched.soa_restore(carry, one)
        for k in ("R", "V", "psi", "t_part"):
            torch.testing.assert_close(getattr(fold, k)[j],
                                       getattr(alone, k), rtol=0, atol=0)


def test_fold_refuses_members_at_different_ticks():
    cfg_j = jlc.CoolingConfig(fused_interpret=True, use_pallas=False,
                              **SMALL)
    states0 = jax_member_states(cfg_j, 2, seed=0)
    bad = states0._replace(tick=jnp.asarray([0, 7], jnp.int32))
    with pytest.raises(ValueError, match="uniform tick"):
        states_from_numpy(bad, device="cpu")
    with pytest.raises(ValueError, match="uniform tick"):
        tlc.run_ensemble(tlc.CoolingConfig(**SMALL), 2, device="cpu",
                         states=bad)
