"""Kernels D and G (forces and the per-ion potential) through their JAX
entries, against the JAX package's XLA ``yukawa_forces_potential`` and a
numpy brute force (CPU).

The JAX package's D and G have no interpret mode and its own tests never
run them on the CPU, so the reference here is its XLA path, which
computes the same sums (tests/test_yukawa.py holds the two together on a
TPU).  On CPU tensors the port's entries run their twin, the plain
``yukawa_forces_potential``; the CUDA kernels are held to that twin in
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: F to 2e-5 of max|F| and the per-ion potential to 1e-5
relative (float32 pair sums in another order, the twin against float64
numpy); masked rows exactly 0.  Also ``best_forces_fn`` in every mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.ops import yukawa as jy
from mdqtplasmasims_tpu.units import PlasmaUnits
from mdqtplasmasims_torch.core.init import poisson_member_mask
from mdqtplasmasims_torch.ops import yukawa as ty

torch.set_num_threads(1)

LDEB = PlasmaUnits(2.0, 0.1).debye_length


def _brute(R, L, ldeb, mask=None):
    """float64 numpy: minimum image, 0 < r < L/2, masked sources and
    rows."""
    R = np.asarray(R, np.float64)
    d = R[:, None, :] - R[None, :, :]
    d -= L * np.round(d / L)
    r2 = (d * d).sum(-1)
    ok = (r2 > 0) & (r2 < (L / 2) ** 2)
    m = np.ones(len(R)) if mask is None else np.asarray(mask, np.float64)
    ok &= (m[None, :] > 0) & (m[:, None] > 0)
    r = np.sqrt(np.where(ok, r2, 1.0))
    ex = np.exp(-r / ldeb)
    ft = np.where(ok, (1 / r + 1 / ldeb) * ex / (r * r), 0.0)
    return (d * ft[..., None]).sum(1), np.where(ok, ex / r, 0.0).sum(1)


def _positions(n, seed):
    L = PlasmaUnits.box_length(n)
    R = np.random.default_rng(seed).uniform(0, L, (n, 3)).astype(np.float32)
    return R, L


def _assert_close(F, pot, Fr, potr, mask=None):
    F, Fr = np.asarray(F, np.float64), np.asarray(Fr, np.float64)
    assert np.abs(F - Fr).max() <= 2e-5 * np.abs(Fr).max()
    np.testing.assert_allclose(pot, potr, rtol=1e-5, atol=0)
    if mask is not None:
        dead = np.asarray(mask) == 0
        assert np.abs(F[dead]).max(initial=0.0) == 0.0
        assert np.abs(np.asarray(pot)[dead]).max(initial=0.0) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_d_entry_matches_jax_and_brute_force(masked):
    n = 200                                   # not a multiple of 128
    R, L = _positions(n, 1)
    mask = None
    if masked:
        mask = np.ones(n, np.float32)
        mask[::7] = 0.0
    tm = None if mask is None else torch.from_numpy(mask)
    F, pot = ty.yukawa_forces_potential_pallas(torch.from_numpy(R), L, LDEB,
                                               tm)
    Fj, potj = jy.yukawa_forces_potential(
        jnp.asarray(R), L, LDEB, None if mask is None else jnp.asarray(mask))
    Fb, potb = _brute(R, L, LDEB, mask)
    assert F.shape == (n, 3) and pot.shape == (n,)
    _assert_close(F.numpy(), pot.numpy(), np.asarray(Fj), np.asarray(potj),
                  mask)
    _assert_close(F.numpy(), pot.numpy(), Fb, potb, mask)
    F2, none = ty.yukawa_forces_potential_pallas(torch.from_numpy(R), L,
                                                 LDEB, tm, with_pot=False)
    assert none is None and torch.equal(F2, F)
    assert torch.equal(ty.yukawa_forces_pallas(torch.from_numpy(R), L, LDEB,
                                               tm), F)


@pytest.mark.parametrize("masks", ["none", "shared", "per_member"])
def test_g_entry_matches_jax_and_brute_force(masks):
    """Three members; Poissonian per-member counts padded to the largest
    (the fold's layout), one shared mask, or none."""
    m, n_js = poisson_member_mask(64, 3, seed=2)
    E, n = m.shape
    L = PlasmaUnits.box_length(64)
    R = np.random.default_rng(3).uniform(0, L, (E, n, 3)).astype(np.float32)
    mask = {"none": None, "shared": m[0],
            "per_member": m}[masks]
    if masks == "per_member":
        R *= m[..., None]
    F, pot = ty.yukawa_forces_potential_pallas_batched(
        torch.from_numpy(R), L, LDEB,
        mask=None if mask is None else torch.from_numpy(mask))
    assert F.shape == (E, n, 3) and pot.shape == (E, n)
    for j in range(E):
        mj = None if mask is None else mask[j] if mask.ndim == 2 else mask
        Fj, potj = jy.yukawa_forces_potential(
            jnp.asarray(R[j]), L, LDEB,
            None if mj is None else jnp.asarray(mj))
        _assert_close(F[j].numpy(), pot[j].numpy(), np.asarray(Fj),
                      np.asarray(potj), mj)
        _assert_close(F[j].numpy(), pot[j].numpy(), *_brute(R[j], L, LDEB,
                                                           mj), mj)
    if masks == "per_member":
        assert len(set(n_js)) > 1


def test_potential_entries_match_jax():
    """The per-particle potentials: D's entry against ``yukawa_potential``
    and G's per member, masked and not; on the CPU they are the plain
    path's values exactly (the .dat trees compared with JAX stay put)."""
    m, _ = poisson_member_mask(64, 3, seed=4)
    E, n = m.shape
    L = PlasmaUnits.box_length(64)
    R = np.random.default_rng(5).uniform(0, L, (E, n, 3)).astype(np.float32)
    Rt, mt = torch.from_numpy(R), torch.from_numpy(m)
    got = ty.yukawa_potential_pallas_batched(Rt, L, LDEB, mt)
    for j in range(E):
        want = float(jy.yukawa_potential(jnp.asarray(R[j]), L, LDEB,
                                         mask=jnp.asarray(m[j])))
        np.testing.assert_allclose(float(got[j]), want, rtol=1e-5)
        one = ty.yukawa_potential_pallas(Rt[j], L, LDEB, mt[j])
        assert torch.equal(one, ty.yukawa_potential(Rt[j], L, LDEB, mt[j]))
        assert torch.equal(one, got[j])
    plain = ty.yukawa_potential_pallas(Rt[0], L, LDEB)
    np.testing.assert_allclose(
        float(plain), float(jy.yukawa_potential(jnp.asarray(R[0]), L, LDEB)),
        rtol=1e-5)
    assert torch.equal(plain, ty.yukawa_potential(Rt[0], L, LDEB))
    np.testing.assert_allclose(
        ty.yukawa_potential_pallas_batched(Rt, L, LDEB).numpy(),
        np.asarray(jax.vmap(lambda r: jy.yukawa_potential(r, L, LDEB))(
            jnp.asarray(R))), rtol=1e-5)


@pytest.mark.parametrize("use_pallas", [None, True, False])
@pytest.mark.parametrize("n3l", [True, False])
def test_best_forces_fn_modes(use_pallas, n3l):
    """``R -> (F, pot | None)`` through the kernels' entries (their twins
    on the CPU): forces only, or with ``use_pallas=False`` (and by default
    on the CPU, as the JAX package's default off the TPU) forces and the
    potential, with or without the half-pair force path."""
    n = 150
    R, L = _positions(n, 6)
    mask = np.ones(n, np.float32)
    mask[::9] = 0.0
    fn = ty.best_forces_fn(n, L, LDEB, mask=torch.from_numpy(mask),
                           use_pallas=use_pallas, n3l=n3l)
    F, pot = fn(torch.from_numpy(R))
    Fj, potj = jy.best_forces_fn(n, L, LDEB, mask=jnp.asarray(mask),
                                 use_pallas=False)(jnp.asarray(R))
    if use_pallas:
        assert pot is None
    else:
        _assert_close(F.numpy(), pot.numpy(), np.asarray(Fj),
                      np.asarray(potj), mask)
    Fj = np.asarray(Fj)
    assert np.abs(F.numpy() - Fj).max() <= 2e-5 * np.abs(Fj).max()
    assert np.abs(F.numpy()[mask == 0]).max() == 0.0


def test_entries_reject_what_they_cannot_take():
    R = torch.zeros((2, 10, 3))
    with pytest.raises(ValueError, match="mask"):
        ty.yukawa_forces_potential_pallas_batched(R, 5.0, LDEB,
                                                  mask=torch.ones(3, 10))
    with pytest.raises(ValueError, match="device"):
        ty.yukawa_forces_potential_pallas(R[0].to("meta"), 5.0, LDEB)
