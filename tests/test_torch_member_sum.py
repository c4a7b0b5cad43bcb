"""The per-member sums over ions (``ops/member_sum``) and what goes
through them, on the CPU.

* ``member_sum``'s plain version (the CPU path) and ``ion_sum`` /
  ``ion_mean`` are exactly the torch reductions they stand for, so every
  CPU comparison with the JAX package keeps its bits; the rearrangement
  the CUDA path makes (reduced dims moved last, a mask broadcast) gives
  the same sums, exactly on integer-valued data;
* the routed observables over a fold ``[E, ...]`` against the JAX
  package's: temperatures, kinetic energies (masked and not), each
  member's potential from kernel G's entry, the tagged moments and the
  KDE, member by member; bars as tests/test_torch_tagging_ops.py
  (sums 2e-5 relative, KDE 1e-5 of the largest bin);
* each share-nothing family's fold of 4 over 2 and over 4 slots (in the
  slots' processes, the form it takes on several cards) equals its
  unsharded fold bit for bit.

The kernel itself (a member's bits in a fold of any width, against its
plain version and a float64 sum) is held on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.core import md as jmd
from mdqtplasmasims_tpu.core import tagging as jtag
from mdqtplasmasims_tpu.core import thermostat as jth
from mdqtplasmasims_tpu.ops import kde as jkde
from mdqtplasmasims_tpu.ops import yukawa as jy
from mdqtplasmasims_tpu.units import PlasmaUnits
from mdqtplasmasims_torch.core import md as tmd
from mdqtplasmasims_torch.core import tagging as ttag
from mdqtplasmasims_torch.core import thermostat as tth
from mdqtplasmasims_torch.experiments import (frozen_tagging,
                                              mc_md_anisotropy,
                                              mc_qt_tagging, three_state)
from mdqtplasmasims_torch.ops import kde as tkde
from mdqtplasmasims_torch.ops import member_sum as ms
from mdqtplasmasims_torch.ops import yukawa as ty
from mdqtplasmasims_torch.parallel import ensemble as pe
from mdqtplasmasims_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

SUM_RTOL = 2e-5


def _x(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1.3, shape).astype(np.float32))


# ---------------------------------------------------------- the sums

@pytest.mark.parametrize("shape", [(40,), (3, 40), (5, 2, 300)])
def test_member_sum_plain_is_torch_sum(shape):
    x = _x(shape)
    assert torch.equal(ms.member_sum(x), torch.sum(x, dim=-1))
    row = (_x(shape[-1:], 1) > 0).float()
    assert torch.equal(ms.member_sum(x, row), torch.sum(x * row, dim=-1))
    full = (_x(shape, 2) > 0).float()
    assert torch.equal(ms.member_sum(x, full), torch.sum(x * full, dim=-1))
    np.testing.assert_allclose(ms.member_sum(x).numpy(),
                               np.asarray(jnp.sum(jnp.asarray(x.numpy()),
                                                  axis=-1)),
                               rtol=SUM_RTOL, atol=1e-6)
    with pytest.raises(ValueError, match="want mask"):
        ms.member_sum(x, torch.ones(shape[-1] + 1))


@pytest.mark.parametrize("dim", [None, -1, 1, (-2, -1), (0, 2)])
def test_ion_sum_and_mean_are_the_torch_calls(dim):
    x = _x((4, 6, 3))
    want_s = torch.sum(x) if dim is None else torch.sum(x, dim=dim)
    want_m = torch.mean(x) if dim is None else torch.mean(x, dim=dim)
    assert torch.equal(ms.ion_sum(x, dim), want_s)
    assert torch.equal(ms.ion_mean(x, dim), want_m)
    m = (_x((4, 6, 3), 3) > 0).float()
    want = torch.sum(x * m) if dim is None else torch.sum(x * m, dim=dim)
    assert torch.equal(ms.ion_sum(x, dim, mask=m), want)


@pytest.mark.parametrize("dim,mask_shape", [
    ((-1,), None), ((1,), None), ((1, 2), None), ((0, 2), None),
    ((0, 1, 2), None), ((2,), (3,)), ((1,), (4, 6, 3)), ((0, 1), (6, 3))])
def test_rows_sum_rearranges_like_torch(dim, mask_shape):
    """The CUDA path's rearrangement (dims moved last, the mask broadcast
    and moved with them), here through the plain version: exactly
    torch's sums on integer-valued data, which any order adds exactly."""
    x = torch.from_numpy(np.random.default_rng(4).integers(
        -50, 50, (4, 6, 3)).astype(np.float32))
    dims = tuple(sorted(d % 3 for d in dim))
    m = (None if mask_shape is None else torch.from_numpy(
        np.random.default_rng(5).integers(0, 2, mask_shape).astype(
            np.float32)))
    got = ms._rows_sum(x, dims, m)
    want = torch.sum(x if m is None else x * m, dim=dims)
    assert torch.equal(got, want)


def test_member_sum_refuses_other_devices():
    with pytest.raises(ValueError, match="no member-sum kernel"):
        ms.member_sum(torch.empty((2, 4), device="meta"))


# ------------------------------------- the routed observables vs JAX

def _fold_v(E=3, n=200, seed=6):
    return np.random.default_rng(seed).normal(0, 0.6, (E, n, 3)).astype(
        np.float32)


def test_temperatures_of_a_fold_match_jax():
    V = _fold_v()
    for tf, jf in ((tth.temperature, jth.temperature),
                   (tth.temperature_per_axis, jth.temperature_per_axis)):
        got = tf(torch.from_numpy(V)).numpy()
        want = np.stack([np.asarray(jf(jnp.asarray(v))) for v in V])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


@pytest.mark.parametrize("masked", [False, True])
def test_kinetic_energies_match_jax(masked):
    V = _fold_v(1)[0]
    m = (np.arange(200) < 171).astype(np.float32)
    V = V * m[:, None]
    mt = torch.from_numpy(m) if masked else None
    mj = jnp.asarray(m) if masked else None
    got = tmd.kinetic_energies(torch.from_numpy(V), True, mask=mt)
    want = jmd.kinetic_energies(jnp.asarray(V), True, mask=mj)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=SUM_RTOL,
                                   atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_fold_potentials_match_jax(masked):
    n = 64
    L = PlasmaUnits.box_length(n)
    ldeb = PlasmaUnits(2.0, 0.1).debye_length
    R = np.random.default_rng(7).uniform(0, L, (2, n, 3)).astype(np.float32)
    mask = np.ones((2, n), np.float32)
    mask[1, 50:] = 0.0
    mt = torch.from_numpy(mask) if masked else None
    got = ty.yukawa_potential_pallas_batched(torch.from_numpy(R), L, ldeb,
                                             mask=mt).numpy()
    for j in range(2):
        want = jy.yukawa_potential(jnp.asarray(R[j]), L, ldeb,
                                   None if mt is None
                                   else jnp.asarray(mask[j]))
        np.testing.assert_allclose(got[j], float(want), rtol=SUM_RTOL)


def test_fold_tagged_moments_and_kde_match_jax():
    rng = np.random.default_rng(9)
    vx = rng.normal(0, 0.7, (3, 1, 250)).astype(np.float32)
    tags = rng.uniform(size=(3, 1, 250)) < 0.4
    got = ttag.tagged_moments(torch.from_numpy(vx), torch.from_numpy(tags))
    assert got.shape == (3, 1, 4)
    for j in range(3):
        want = jtag.tagged_moments(jnp.asarray(vx[j, 0]),
                                   jnp.asarray(tags[j, 0]))
        np.testing.assert_allclose(got[j, 0].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)
    v = vx[:, 0]
    w = tags[:, 0].astype(np.float32)
    bins = tkde.centered_bins(torch.float32)
    got = tkde.gaussian_kde(torch.from_numpy(v), bins, folded=False,
                            weights=torch.from_numpy(w)).numpy()
    for j in range(3):
        want = np.asarray(jkde.gaussian_kde(
            jnp.asarray(v[j]), jkde.centered_bins(jnp.float32),
            folded=False, weights=jnp.asarray(w[j])))
        np.testing.assert_allclose(got[j], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


# ------------------------ the share-nothing folds over 2 and 4 slots

_FROZEN = dict(n0=16, tstart=0.002, tmax=0.012, sample_freq=1,
               tpump_seconds=5e-9)
_MC = dict(n=27, mc_steps=100, pre_record_md_steps=2, record_steps=4,
           gr_every_record=2)
FAMILIES = dict(
    frozen_tagging=(frozen_tagging, frozen_tagging.FrozenTagConfig(
        **_FROZEN)),
    three_state=(three_state, three_state.ThreeStateConfig(
        n0=8, tmax=0.4, sample_freq=20)),
    transport=(mc_md_anisotropy, mc_md_anisotropy.MCTransportConfig(
        **_MC, gr_every_mc=100, instant_aniso_steps=2, reequil_steps=2,
        aniso_relax_steps=2, aniso_time_us=0.01)),
    mc_tagging=(mc_qt_tagging, mc_qt_tagging.MCTagConfig(
        **_MC, mc_chunk_steps=100, tpump_seconds=5e-9)))
_FOLDS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _end_workers():
    yield
    pe.stop_workers()


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a) or isinstance(a, np.ndarray):
        x, y = np.asarray(a), np.asarray(b)
        return (x.dtype == y.dtype and x.shape == y.shape
                and x.tobytes() == y.tobytes())
    return a == b or (a != a and b != b)


@pytest.mark.parametrize("slots", [2, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_share_nothing_fold_over_slots_is_the_unsharded_fold(
        family, slots, monkeypatch):
    module, cfg = FAMILIES[family]
    if family not in _FOLDS:
        _FOLDS[family] = module.run_ensemble(cfg, 4, seed=2, device="cpu")
    monkeypatch.setattr(pe, "mesh_is_multi_card", lambda mesh: True)
    mesh = make_mesh(slots, 1, devices=["cpu"] * slots)
    got = module.run_ensemble(cfg, 4, seed=2, mesh=mesh)
    assert _same(got, _FOLDS[family])
