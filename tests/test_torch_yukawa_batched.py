"""Port vs JAX package: the batched (ensemble) force kernel's plain twin
against the JAX batched half-pair Pallas kernels (interpret mode) on the
same numpy inputs (the CUDA kernel is held to the twin in
tests/test_torch_cuda.py and chip_smoke.py).

Tolerance: 2e-5 of the largest force (test_yukawa.py:82's bar: the
kernels sum the pairs in different orders); padded and masked lanes
exactly 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.core import init as jinit
from mdqtplasmasims_tpu.ops import yukawa as jy
from mdqtplasmasims_tpu.units import PlasmaUnits
from mdqtplasmasims_torch.core import init as tinit
from mdqtplasmasims_torch.ops import yukawa as ty

torch.set_num_threads(1)

E, N, NPAD = 3, 200, 256


def _fold(seed=0):
    """Folded ``Rp [3, E*NPAD]``, per-member masks ``[E, NPAD]`` (member j
    has N - 20*j real ions, and one real ion in ten masked out) and the
    shared mask ``[1, NPAD]``."""
    rng = np.random.default_rng(seed)
    L = PlasmaUnits.box_length(N)
    ldeb = PlasmaUnits(2.0, 0.1).debye_length
    masks = np.zeros((E, NPAD), np.float32)
    for j in range(E):
        masks[j, :N - 20 * j] = 1.0
        masks[j, j:N:10] = 0.0
    R = rng.uniform(0, L, (3, E, NPAD)).astype(np.float32)
    Rp = (R * masks[None]).reshape(3, E * NPAD)
    shared = np.zeros((1, NPAD), np.float32)
    shared[0, :N] = 1.0
    return Rp, masks, shared, L, ldeb


def _close(Ft, Fj):
    scale = np.abs(Fj).max()
    np.testing.assert_allclose(Ft, Fj, rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("which", ["shared", "per_member"])
def test_twin_matches_jax_batched_soa_kernel(which):
    Rp, masks, shared, L, ldeb = _fold()
    mk = shared if which == "shared" else masks
    Fj = np.asarray(jy.yukawa_forces_n3l_soa_batched(
        jnp.asarray(Rp), jnp.asarray(mk), E, L, ldeb, interpret=True))
    Ft = ty.yukawa_forces_n3l_soa_batched(torch.from_numpy(Rp),
                                          torch.from_numpy(mk), E, L,
                                          ldeb).numpy()
    _close(Ft, Fj)
    dead = (np.broadcast_to(mk, (E, NPAD)) == 0).reshape(E * NPAD)
    assert np.abs(Ft[:, dead]).max() == 0.0       # padded + masked lanes


def test_twin_matches_jax_per_member_inverse_screening():
    """Per-member 1/lambda (the kernel's inv_ldeb [E]) against the JAX
    kernel's ys-column-4 form, reached through an [E] ldeb array."""
    Rp, _, _, L, ldeb = _fold(seed=1)
    ldebs = np.asarray([ldeb, 0.8 * ldeb, 1.3 * ldeb], np.float32)
    R = Rp.reshape(3, E, NPAD)[:, :, :N].transpose(1, 2, 0)    # [E, N, 3]
    Fj = np.asarray(jy.yukawa_forces_n3l_pallas_batched(
        jnp.asarray(np.ascontiguousarray(R)), L, jnp.asarray(ldebs),
        tile=NPAD, interpret=True))                              # [E, N, 3]
    full = np.zeros((E, NPAD), np.float32)
    full[:, :N] = 1.0
    Rfull = np.zeros((3, E, NPAD), np.float32)
    Rfull[:, :, :N] = R.transpose(2, 0, 1)
    inv = torch.from_numpy((1.0 / ldebs).astype(np.float32))
    Ft = ty.yukawa_forces_n3l_soa_batched(
        torch.from_numpy(Rfull.reshape(3, E * NPAD)), torch.from_numpy(full),
        E, L, ldeb, inv_ldeb=inv).numpy().reshape(3, E, NPAD)
    _close(Ft[:, :, :N].transpose(1, 2, 0), Fj)
    assert np.abs(Ft[:, :, N:]).max() == 0.0
    # the members really see different screening lengths
    assert np.abs(Fj[0] - Fj[1]).max() > 1e-3 * np.abs(Fj).max()


def test_single_member_equals_unbatched_twin():
    Rp, _, shared, L, ldeb = _fold(seed=2)
    one = torch.from_numpy(np.ascontiguousarray(Rp[:, :NPAD]))
    m = torch.from_numpy(shared)
    a = ty.yukawa_forces_n3l_soa(one, m, L, ldeb)
    b = ty.yukawa_forces_n3l_soa_batched(one, m, 1, L, ldeb)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_batched_wrapper_validation():
    Rp, masks, _, L, ldeb = _fold()
    R, m = torch.from_numpy(Rp), torch.from_numpy(masks)
    with pytest.raises(ValueError, match="E\\*Np"):
        ty.yukawa_forces_n3l_soa_batched(R[:, :-1], m, E, L, ldeb)
    with pytest.raises(ValueError, match="mask_row"):
        ty.yukawa_forces_n3l_soa_batched(R, m[:2], E, L, ldeb)
    with pytest.raises(ValueError, match="inv_ldeb"):
        ty.yukawa_forces_n3l_soa_batched(R, m, E, L, ldeb,
                                         inv_ldeb=torch.ones(2))
    with pytest.raises(ValueError, match="dtype"):
        ty.yukawa_forces_n3l_soa_batched(R, m.double(), E, L, ldeb)


@pytest.mark.parametrize("seed", [0, 5, 21])
def test_poisson_counts_equal_jax(seed):
    mj, nj = jinit.poisson_member_mask(400, 6, seed)
    mt, nt = tinit.poisson_member_mask(400, 6, seed)
    assert nt == nj
    np.testing.assert_array_equal(mt, mj)
    mr, _ = tinit.poisson_member_mask(400, 6, seed, round_to=128)
    assert mr.shape[1] % 128 == 0 and mr.sum() == sum(nt)
