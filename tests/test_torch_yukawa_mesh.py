"""Port vs JAX package: the entries of the mesh path's force kernels E
(rows x gathered columns) and F (cross-block half pairs), and the XLA
source-set path ``yukawa_forces_potential(cols=)``, on the same numpy
inputs.  The JAX entries run their Pallas kernels in interpret mode (as
tests/test_parallel_fused.py runs them on the CPU); the port's run their
plain torch versions (the CUDA kernels are held to those on the card by
tests/test_torch_cuda.py and chip_smoke.py phases 15-16).

Tolerances: float64 rtol 1e-11 / atol 1e-12 (test_parallel_fused.py:
103-167's bar: the same pair math summed in another order); float32 2e-5
of the largest |F| (test_yukawa.py:82's bar).  Masked lanes exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.ops import yukawa as jy
from mdqtplasmasims_torch.ops import yukawa as ty
from mdqtplasmasims_torch.units import PlasmaUnits

torch.set_num_threads(1)

E, NPAD, N = 2, 128, 100
LDEB = PlasmaUnits(2.0, 0.1).debye_length


def _fold_rp(R):
    """[E, npad, 3] -> folded [3, E*npad] lanes."""
    return np.ascontiguousarray(R.transpose(2, 0, 1).reshape(3, -1))


def _blocks(seed, dtype, n_box=2 * N):
    """Two blocks A, B [E, NPAD, 3] in one box (padded lanes at 0), the
    shared mask [NPAD] and per-member masks [E, NPAD] (member j loses
    every (7+j)-th real ion)."""
    rng = np.random.default_rng(seed)
    L = PlasmaUnits.box_length(n_box)
    shared = np.zeros(NPAD)
    shared[:N] = 1.0
    per = np.stack([shared.copy() for _ in range(E)])
    for j in range(E):
        per[j, j:N:7 + j] = 0.0
    A = rng.uniform(0, L, (E, NPAD, 3)) * shared[None, :, None]
    B = rng.uniform(0, L, (E, NPAD, 3)) * shared[None, :, None]
    return [x.astype(dtype) for x in (A, B, shared, per)], L


def _check(got, want, dtype):
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("masks", ["shared", "per_member"])
def test_kernel_e_plain_matches_jax(dtype, masks):
    (A, B, shared, per), L = _blocks(1, dtype)
    cm = shared if masks == "shared" else per
    cols = np.concatenate([A, B], axis=1)                   # [E, 2*NPAD, 3]
    cmask = (np.concatenate([cm, cm], axis=-1))
    Fj = np.asarray(jy.yukawa_forces_soa_cols_batched(
        jnp.asarray(_fold_rp(A)), jnp.asarray(cols), jnp.asarray(cmask), E,
        L, LDEB, tile=128, interpret=True))
    Ft = ty.yukawa_forces_soa_cols_batched(
        torch.from_numpy(_fold_rp(A)), torch.from_numpy(cols),
        torch.from_numpy(cmask), E, L, LDEB).numpy()
    _check(Ft, Fj, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("masks", ["shared", "per_member"])
def test_kernel_f_plain_matches_jax(dtype, masks):
    (A, B, shared, per), L = _blocks(2, dtype)
    rows = shared[None] if masks == "shared" else per
    cmask = np.broadcast_to(shared if masks == "shared" else per[::-1],
                            (E, NPAD)).copy()
    Fj, Gj = jy.yukawa_forces_cross_n3l_soa_batched(
        jnp.asarray(_fold_rp(A)), jnp.asarray(rows), jnp.asarray(B),
        jnp.asarray(cmask), E, L, LDEB, tile=128, interpret=True)
    Ft, Gt = ty.yukawa_forces_cross_n3l_soa_batched(
        torch.from_numpy(_fold_rp(A)), torch.from_numpy(rows),
        torch.from_numpy(B), torch.from_numpy(cmask), E, L, LDEB)
    _check(Ft.numpy(), np.asarray(Fj), dtype)
    _check(Gt.numpy(), np.asarray(Gj), dtype)
    dead_rows = (np.broadcast_to(rows, (E, NPAD)) == 0).reshape(-1)
    assert np.abs(Ft.numpy()[:, dead_rows]).max() == 0.0
    assert np.abs(Gt.numpy()[cmask == 0]).max() == 0.0


def test_kernel_f_is_both_halves_of_kernel_e():
    """F's rows equal E(rows A, cols B) and its reaction equals E(rows B,
    cols A) on real lanes (float64, summation-order bar)."""
    (A, B, shared, _), L = _blocks(3, np.float64)
    t = torch.from_numpy
    cm = t(np.broadcast_to(shared, (E, NPAD)).copy())
    F, G = ty.yukawa_forces_cross_n3l_soa_batched(
        t(_fold_rp(A)), t(shared[None]), t(B), cm, E, L, LDEB)
    FA = ty.yukawa_forces_soa_cols_batched(t(_fold_rp(A)), t(B), cm, E, L,
                                           LDEB)
    FB = ty.yukawa_forces_soa_cols_batched(t(_fold_rp(B)), t(A), cm, E, L,
                                           LDEB)
    real = np.tile(shared, E) > 0
    _check(F.numpy()[:, real], FA.numpy()[:, real], np.float64)
    GB = FB.numpy().reshape(3, E, NPAD).transpose(1, 2, 0)
    _check(G.numpy()[:, :N], GB[:, :N], np.float64)


@pytest.mark.parametrize("masks", ["shared", "per_member"])
def test_kernel_e_on_the_own_lanes_is_kernel_c(masks):
    """With the member's own lanes as its columns, E's plain version gives
    C's on every real row bit for bit (the card's kernels share one j
    loop, so chip_smoke.py holds them to the same equality)."""
    (A, _, shared, per), L = _blocks(4, np.float32, n_box=N)
    mk = shared[None] if masks == "shared" else per
    t = torch.from_numpy
    Fc = ty.yukawa_forces_n3l_soa_batched(t(_fold_rp(A)), t(mk), E, L, LDEB)
    Fe = ty.yukawa_forces_soa_cols_batched(
        t(_fold_rp(A)), t(A), t(mk[0] if masks == "shared" else mk), E, L,
        LDEB)
    real = (np.broadcast_to(mk, (E, NPAD)) > 0).reshape(-1)
    assert torch.equal(Fe[:, real], Fc[:, real])


@pytest.mark.parametrize("masked", [False, True])
def test_forces_potential_with_cols_matches_jax(masked):
    (A, B, shared, _), L = _blocks(5, np.float64)
    R, cols = A[0, :N], np.concatenate([A[0, :N], B[0, :N]])
    mask = np.ones(2 * N)
    if masked:
        mask[::5] = 0.0
    m = mask if masked else None
    Fj, pj = jy.yukawa_forces_potential(
        jnp.asarray(R), L, LDEB, None if m is None else jnp.asarray(m),
        chunk=64, cols=jnp.asarray(cols))
    Ft, pt = ty.yukawa_forces_potential(
        torch.from_numpy(R), L, LDEB, None if m is None else
        torch.from_numpy(m), chunk=64, cols=torch.from_numpy(cols))
    np.testing.assert_allclose(Ft.numpy(), np.asarray(Fj), rtol=1e-11,
                               atol=1e-12)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-11,
                               atol=1e-12)


def test_mesh_kernel_entries_validate():
    (A, B, shared, per), L = _blocks(6, np.float32)
    t = torch.from_numpy
    Rp, cols = t(_fold_rp(A)), t(B)
    with pytest.raises(ValueError, match="cols"):
        ty.yukawa_forces_soa_cols_batched(Rp, cols[:1], t(shared), E, L,
                                          LDEB)
    with pytest.raises(ValueError, match="col_mask"):
        ty.yukawa_forces_soa_cols_batched(Rp, cols, t(shared[:-1]), E, L,
                                          LDEB)
    with pytest.raises(ValueError, match="mask_row"):
        ty.yukawa_forces_cross_n3l_soa_batched(Rp, t(per[:, :-1]), cols,
                                               t(per), E, L, LDEB)
    with pytest.raises(ValueError, match="dtype"):
        ty.yukawa_forces_soa_cols_batched(Rp, cols.double(), t(shared), E, L,
                                          LDEB)
