"""Port vs JAX package: ``yukawa_forces_n3l_pallas_batched``, the ``[E, N,
3]`` entry of kernel C (CPU: the port's plain twin against the JAX kernel in
interpret mode on the same numpy positions), as tests/test_yukawa.py:190
and :228 hold the JAX entry.  Tolerance: 2e-5 of the largest |F| (float32
pair sums in another order; tests/test_torch_yukawa.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.ops import yukawa as jy
from mdqtplasmasims_tpu.units import PlasmaUnits
from mdqtplasmasims_torch.ops import yukawa as ty

torch.set_num_threads(1)

N0 = 300


def _members(e, seed):
    L = PlasmaUnits.box_length(N0)
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, L, (e, N0, 3)).astype(np.float32), L,
            PlasmaUnits(density=2.0, Ge=0.1).debye_length)


@pytest.mark.parametrize("e", [1, 2, 3])
def test_batched_entry_matches_jax_kernel(e):
    R, L, ldeb = _members(e, 7)
    Fj = np.asarray(jy.yukawa_forces_n3l_pallas_batched(
        jnp.asarray(R), L, ldeb, tile=128, interpret=True))
    Ft = ty.yukawa_forces_n3l_pallas_batched(torch.from_numpy(R), L, ldeb,
                                             tile=128)
    assert Ft.shape == (e, N0, 3) and Ft.dtype == torch.float32
    np.testing.assert_allclose(Ft.numpy(), Fj, rtol=0,
                               atol=2e-5 * np.abs(Fj).max())
    # members stay uncoupled: each equals the single-system entry
    for k in range(e):
        F1 = ty.yukawa_forces_n3l_pallas(torch.from_numpy(R[k]), L, ldeb,
                                         tile=128)
        np.testing.assert_array_equal(Ft[k].numpy(), F1.numpy())


def test_batched_entry_per_member_screening_matches_jax():
    R, L, ldeb = _members(2, 11)
    ldebs = np.asarray([ldeb, 0.5 * ldeb], np.float32)
    Fj = np.asarray(jy.yukawa_forces_n3l_pallas_batched(
        jnp.asarray(R), L, jnp.asarray(ldebs), tile=128, interpret=True))
    Ft = ty.yukawa_forces_n3l_pallas_batched(
        torch.from_numpy(R), L, torch.from_numpy(ldebs), tile=128).numpy()
    np.testing.assert_allclose(Ft, Fj, rtol=0, atol=2e-5 * np.abs(Fj).max())
    for k in range(2):
        F1 = ty.yukawa_forces_n3l_pallas(torch.from_numpy(R[k]), L,
                                         float(ldebs[k]), tile=128).numpy()
        np.testing.assert_allclose(Ft[k], F1, rtol=1e-6, atol=1e-6)
    other = ty.yukawa_forces_n3l_pallas(torch.from_numpy(R[1]), L, ldeb,
                                        tile=128).numpy()
    assert np.abs(Ft[1] - other).max() > 1e-3


def test_batched_entry_validation():
    R, L, ldeb = _members(2, 3)
    with pytest.raises(ValueError, match="ldeb"):
        ty.yukawa_forces_n3l_pallas_batched(
            torch.from_numpy(R), L, torch.ones(3), tile=128)
    with pytest.raises(ValueError, match="device"):
        ty.yukawa_forces_n3l_pallas_batched(
            torch.from_numpy(R).to("meta"), L, ldeb)
