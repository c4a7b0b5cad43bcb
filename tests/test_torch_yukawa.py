"""Port vs JAX package: the Yukawa force kernel's plain twin against the
JAX half-pair Pallas kernel (interpret mode) and the XLA force/potential
path, on the same numpy inputs (the CUDA kernel is held to the twin in
tests/test_torch_cuda.py).

Tolerances: float32 forces 2e-5 of the largest force (test_yukawa.py:82's
bar: the kernels sum the pairs in different orders), float64 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.ops import yukawa as jy
from mdqtplasmasims_tpu.units import PlasmaUnits
from mdqtplasmasims_torch.ops import yukawa as ty

torch.set_num_threads(1)


def _system(n=300, npad=384, seed=0, dtype=np.float32):
    """Lane-layout positions of ``n`` real ions padded to ``npad``; one
    real ion in ten is masked out as well (its force must be exactly 0)."""
    rng = np.random.default_rng(seed)
    L = PlasmaUnits.box_length(n)
    ldeb = PlasmaUnits(2.0, 0.1).debye_length
    Rp = np.zeros((3, npad), dtype)
    Rp[:, :n] = rng.uniform(0, L, (3, n))
    mask = np.zeros((1, npad), dtype)
    mask[0, :n] = 1.0
    mask[0, :n:10] = 0.0
    return Rp, mask, L, ldeb


@pytest.mark.parametrize("npad", [384, 512])
def test_twin_matches_jax_n3l_kernel(npad):
    Rp, mask, L, ldeb = _system(npad=npad)
    Fj = np.asarray(jy.yukawa_forces_n3l_soa(jnp.asarray(Rp),
                                             jnp.asarray(mask), L, ldeb,
                                             interpret=True))
    Ft = ty.yukawa_forces_n3l_soa(torch.from_numpy(Rp),
                                  torch.from_numpy(mask), L, ldeb).numpy()
    scale = np.abs(Fj).max()
    np.testing.assert_allclose(Ft, Fj, rtol=0, atol=2e-5 * scale)
    dead = mask[0] == 0
    assert np.abs(Ft[:, dead]).max() == 0.0          # padded + masked lanes
    # Newton's third law holds for the full-pair sums as well
    assert np.abs(Ft.sum(1)).max() < 2e-5 * scale


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_twin_matches_xla_forces(dt):
    n = 300
    Rp, mask, L, ldeb = _system(n=n, dtype=dt)
    m = mask[0, :n]
    Fx, _ = jy.yukawa_forces_potential(jnp.asarray(Rp[:, :n].T),
                                       L, ldeb, mask=jnp.asarray(m),
                                       chunk=128)
    Ft = ty.yukawa_forces_n3l_soa_reference(torch.from_numpy(Rp),
                                            torch.from_numpy(mask), L, ldeb)
    Fx = np.asarray(Fx).T
    tol = 2e-5 if dt == np.float32 else 1e-10
    np.testing.assert_allclose(Ft.numpy()[:, :n], Fx, rtol=0,
                               atol=tol * np.abs(Fx).max())


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("masked", [False, True])
def test_forces_potential_match_jax(dt, masked):
    n = 300
    Rp, mask, L, ldeb = _system(n=n, dtype=dt)
    R = Rp[:, :n].T.copy()
    m = mask[0, :n].copy() if masked else None
    Fj, pj = jy.yukawa_forces_potential(
        jnp.asarray(R), L, ldeb, mask=None if m is None else jnp.asarray(m),
        chunk=128)
    Ft, pt = ty.yukawa_forces_potential(
        torch.from_numpy(R), L, ldeb,
        mask=None if m is None else torch.from_numpy(m), chunk=128)
    tol = 2e-5 if dt == np.float32 else 1e-10
    np.testing.assert_allclose(Ft.numpy(), np.asarray(Fj), rtol=0,
                               atol=tol * np.abs(np.asarray(Fj)).max())
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=tol)
    ej = float(jy.yukawa_potential(jnp.asarray(R), L, ldeb,
                                   None if m is None else jnp.asarray(m)))
    et = float(ty.yukawa_potential(torch.from_numpy(R), L, ldeb,
                                   None if m is None else torch.from_numpy(m)))
    np.testing.assert_allclose(et, ej, rtol=tol)
    np.testing.assert_allclose(
        ty.yukawa_forces(torch.from_numpy(R), L, ldeb).numpy(),
        np.asarray(jy.yukawa_forces(jnp.asarray(R), L, ldeb)), rtol=0,
        atol=tol * np.abs(np.asarray(Fj)).max())


def test_soa_force_tile_and_validation():
    for npad in (128, 384, 512, 896, 3584):
        assert ty.soa_force_tile(npad) == jy.soa_force_tile(npad)
    with pytest.raises(ValueError, match="128"):
        ty.soa_force_tile(200)
    Rp = torch.zeros((3, 128))
    with pytest.raises(ValueError, match="Rp"):
        ty.yukawa_forces_n3l_soa(Rp, torch.zeros((1, 256)), 5.0, 1.0)
    with pytest.raises(ValueError, match="dtype"):
        ty.yukawa_forces_n3l_soa(Rp, torch.zeros((1, 128), dtype=torch.float64),
                                 5.0, 1.0)

