"""The fold's sample in one pass (CPU): ``laser_cooling._sample_fold``
over ``[E, n, ...]`` against the member-by-member loop it replaced, written
out here as its plain twin (each member's kinetic energies, three KDEs and
list-indexed populations, stacked), bit for bit; a member's sample in folds
of other widths; and ``state_populations``' slice form against the
list-index sum.  float32, the flagship configuration's precision."""

import dataclasses
import math

import pytest
import torch

from mdqtplasmasims_torch.core.qt import state_populations
from mdqtplasmasims_torch.experiments import laser_cooling as lc
from mdqtplasmasims_torch.ops.kde import folded_bins
from mdqtplasmasims_torch.ops.structure import current_fourier
from mdqtplasmasims_torch.ops.yukawa import yukawa_potential_pallas_batched
from mdqtplasmasims_torch.units import PlasmaUnits

N0 = 40
MANIFOLDS = [lc.S_MANIFOLD, lc.P_MANIFOLD, lc.D_MANIFOLD]


def _member(states, j):
    return dataclasses.replace(states, **{f: getattr(states, f)[j] for f in (
        "R", "V", "F", "psi", "t_part")})


def _kinetic_plain(V, mask):
    if mask is None:
        vx_mean = torch.mean(V[:, 0])
        Vx = V[:, 0] - vx_mean
        ek = [torch.mean(0.5 * Vx ** 2), torch.mean(0.5 * V[:, 1] ** 2),
              torch.mean(0.5 * V[:, 2] ** 2)]
    else:
        n_eff = torch.sum(mask)
        vx_mean = torch.sum(V[:, 0] * mask) / n_eff
        Vx = V[:, 0] - vx_mean
        ek = [torch.sum(0.5 * Vx ** 2 * mask) / n_eff,
              torch.sum(0.5 * V[:, 1] ** 2 * mask) / n_eff,
              torch.sum(0.5 * V[:, 2] ** 2 * mask) / n_eff]
    return ek, vx_mean


def _kde_plain(v, bins, w, width=0.002):
    inv2w2 = 1.0 / (2.0 * width * width)
    d = bins[:, None] - v[None, :]
    k = torch.exp(-inv2w2 * d * d)
    s = bins[:, None] + v[None, :]
    k = k + torch.exp(-inv2w2 * s * s)
    if w is not None:
        k = k * w[None, :]
    return torch.sum(k, dim=-1) / (6.0 * math.sqrt(2.0 * math.pi) * width)


def _member_plain(st, cfg, bins, mask, epot, kvecs):
    """One member's sample as the member loop took it."""
    ek, vx_mean = _kinetic_plain(st.V, mask)
    vx = st.V[:, 0] - vx_mean
    pvel = torch.stack([_kde_plain(vx, bins, mask),
                        _kde_plain(st.V[:, 1], bins, mask),
                        _kde_plain(st.V[:, 2], bins, mask)])
    pop = st.psi.real ** 2 + st.psi.imag ** 2
    pops = [torch.sum(pop[:, list(idx)], dim=-1) for idx in MANIFOLDS]
    out = dict(ekin=torch.stack(ek), epot=epot, vx_mean=vx_mean, pvel=pvel,
               vx_ions=st.V[:, 0], pops=torch.stack(pops, -1))
    if cfg.record_snapshots or cfg.vaf_intervals or cfg.record_lccf:
        out["V"] = st.V
        if cfg.record_lccf:
            out["R"] = st.R
            out["J"] = current_fourier(st.R, st.V, kvecs)
    return out


def _fold_plain(mid, cfg, L, ldeb, bins, mask_t, kvecs):
    """The member-by-member loop ``_sample_fold`` ran before its one pass."""
    epots = yukawa_potential_pallas_batched(mid.R, L, ldeb, mask_t)
    per = [_member_plain(_member(mid, j), cfg, bins,
                         None if mask_t is None else mask_t[j], epots[j],
                         kvecs) for j in range(mid.R.shape[0])]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


def _mid(cfg, E, poisson, seed=3):
    """A sampled fold of E members away from its start: positions in the
    box, thermal velocities with a drift along x, excited wavefunctions;
    Poissonian members padded with zero lanes and their ``[E, n]`` mask."""
    g = torch.Generator().manual_seed(seed)
    if poisson:
        states, m, _ = lc._poisson_member_states(cfg, E, seed, "cpu")
        mask = torch.as_tensor(m).to(torch.float32)
    else:
        states, mask = lc.member_states(cfg, E, seed, "cpu"), None
    E, n = states.R.shape[:2]
    m3 = torch.ones((E, n, 1)) if mask is None else mask[..., None]
    S = states.psi.shape[-1]
    psi = torch.complex(torch.randn((E, n, S), generator=g),
                        torch.randn((E, n, S), generator=g))
    psi = psi / torch.linalg.vector_norm(psi, dim=-1, keepdim=True)
    V = 0.3 * torch.randn((E, n, 3), generator=g) + torch.tensor([0.05, 0, 0])
    return dataclasses.replace(
        states, V=V * m3, psi=psi * m3.to(psi.dtype), tick=26,
        t=26 * cfg.qdt), mask


def _sample_both(E, poisson, record):
    cfg = lc.CoolingConfig(n0=N0, **({record: True} if record else {}))
    L = PlasmaUnits.box_length(cfg.n0)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    bins = folded_bins(torch.float32)
    kvecs = lc._lccf_kvecs(cfg, "cpu")
    mid, mask = _mid(cfg, E, poisson)
    got = lc._sample_fold(mid, cfg, L, ldeb, bins, mask, kvecs)
    return got, _fold_plain(mid, cfg, L, ldeb, bins, mask, kvecs), mid


@pytest.mark.parametrize("record", [None, "record_snapshots", "record_lccf"])
@pytest.mark.parametrize("poisson", [False, True], ids=["pinned", "poisson"])
@pytest.mark.parametrize("E", [1, 3, 8])
def test_fold_sample_is_the_member_loop_bit_for_bit(E, poisson, record):
    got, want, mid = _sample_both(E, poisson, record)
    keys = {"ekin", "epot", "vx_mean", "pvel", "vx_ions", "pops"}
    if record:
        keys |= {"V"} | ({"R", "J"} if record == "record_lccf" else set())
    assert set(got) == set(want) == keys
    n = mid.R.shape[1]
    shapes = dict(ekin=(E, 3), epot=(E,), vx_mean=(E,), pvel=(E, 3, 2001),
                  vx_ions=(E, n), pops=(E, n, 3), V=(E, n, 3), R=(E, n, 3),
                  J=(E, 3, 1728))
    for k in keys:
        assert got[k].shape == shapes[k], k
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert (got["pvel"] > 0).any() and (got["pops"][..., 1] > 0).any()


@pytest.mark.parametrize("poisson", [False, True], ids=["pinned", "poisson"])
def test_a_members_sample_does_not_depend_on_the_folds_width(poisson):
    """Members 0-2 of a fold of 8 sampled in a fold of 3: the same bits."""
    cfg = lc.CoolingConfig(n0=N0, record_lccf=True)
    L = PlasmaUnits.box_length(cfg.n0)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    bins = folded_bins(torch.float32)
    kvecs = lc._lccf_kvecs(cfg, "cpu")
    mid, mask = _mid(cfg, 8, poisson)
    part = dataclasses.replace(mid, **{f: getattr(mid, f)[:3] for f in (
        "R", "V", "F", "psi", "t_part")})
    full = lc._sample_fold(mid, cfg, L, ldeb, bins, mask, kvecs)
    three = lc._sample_fold(part, cfg, L, ldeb, bins,
                            None if mask is None else mask[:3], kvecs)
    for k, v in three.items():
        assert torch.equal(v, full[k][:3]), k


def test_one_state_keeps_its_sample():
    """A lone ``[n, ...]`` state (run_compiled, run_compiled_span) takes
    the member loop's sample of that state, shapes included."""
    cfg = lc.CoolingConfig(n0=N0, record_lccf=True)
    L = PlasmaUnits.box_length(cfg.n0)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    bins = folded_bins(torch.float32)
    kvecs = lc._lccf_kvecs(cfg, "cpu")
    mid, _ = _mid(cfg, 1, False)
    one = _member(mid, 0)
    got = lc._sample_outputs(one, cfg, L, ldeb, bins, kvecs=kvecs)
    want = _member_plain(one, cfg, bins, None, got["epot"], kvecs)
    assert got["epot"].shape == ()
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("shape", [(12,), (N0, 12), (3, N0, 12),
                                   (8, 3500, 12)],
                         ids=["1d", "state", "fold3", "fold8_n3500"])
def test_population_slices_are_the_list_index_sum(shape):
    """The manifolds' elementwise level adds give the bits of torch's sum
    over the list-indexed levels, for one ion, one state and folds."""
    g = torch.Generator().manual_seed(5)
    psi = torch.complex(torch.randn(shape, generator=g),
                        torch.randn(shape, generator=g))
    pop = psi.real ** 2 + psi.imag ** 2
    got = state_populations(psi, MANIFOLDS)
    for idx, p in zip(MANIFOLDS, got):
        assert torch.equal(p, torch.sum(pop[..., list(idx)], dim=-1)), idx
    some = state_populations(psi, [(0, 3, 7, 8, 10), (5,)])
    assert torch.equal(some[0], torch.sum(pop[..., [0, 3, 7, 8, 10]], -1))
    assert torch.equal(some[1], pop[..., 5])
