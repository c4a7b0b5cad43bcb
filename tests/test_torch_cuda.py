"""The port's CUDA kernels against their plain torch twins on the card.

Needs an NVIDIA GPU: every test carries the ``cuda`` marker and skips
without one.  This file imports no JAX, so it also runs on a machine
without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerances as in tests/test_torch_yukawa.py / test_torch_fused.py: forces
2e-5 of the largest |F|, the per-ion potential 1e-5 of the largest sum;
ticks R/V/tp 2e-5, psi 5e-5 (+1e-4 relative), pad rows and padded lanes
exactly 0.  A lane whose jump test r0 < dp0 falls within float rounding
of dp0 may be decided differently by the two and then diverges; at most 2
such lanes of 3500 are allowed (3 per member for the in-kernel RNG, whose
twin draws the same Threefry stream).  The full flagship run, through
the in-kernel RNG as every CUDA run without a ``rolls_fn``, is held to
the JAX package's production physics bands (by the soak tool's own
extraction, tools/torch_soak.py), and the MC-tagging family's production
408quad pump window on the card to the same window on the CPU from the
same draws.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from mdqtplasmasims_torch.units import PlasmaUnits
from mdqtplasmasims_torch.core import qt_fused as tf
from mdqtplasmasims_torch.core.scheduler import uniform_rolls
from mdqtplasmasims_torch.experiments import laser_cooling as lc
from mdqtplasmasims_torch.ops import yukawa as ty

pytestmark = pytest.mark.cuda

N, NPAD = 3500, 3584            # the flagship lane layout
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _positions(dev, seed=0):
    L = PlasmaUnits.box_length(N)
    g = torch.Generator(device=dev).manual_seed(seed)
    Rp = torch.zeros((3, NPAD), device=dev)
    Rp[:, :N] = torch.rand((3, N), generator=g, device=dev) * L
    mask = torch.zeros((1, NPAD), device=dev)
    mask[0, :N] = 1.0
    return Rp, mask, L, PlasmaUnits(2.0, 0.1).debye_length


def test_force_kernel_matches_twin(cuda):
    Rp, mask, L, ldeb = _positions(cuda)
    mask[0, :N:10] = 0.0                 # masked real ions come out 0 too
    before = ty.yukawa_forces_n3l_soa.launches
    F1 = ty.yukawa_forces_n3l_soa(Rp, mask, L, ldeb)
    F2 = ty.yukawa_forces_n3l_soa(Rp, mask, L, ldeb)
    Fr = ty.yukawa_forces_n3l_soa_reference(Rp, mask, L, ldeb)
    torch.cuda.synchronize()
    assert ty.yukawa_forces_n3l_soa.launches == before + 2
    assert torch.equal(F1, F2)           # deterministic run to run
    assert float((F1 - Fr).abs().max()) < 2e-5 * float(Fr.abs().max())
    assert float(F1[:, mask[0] == 0].abs().max()) == 0.0


def test_force_kernel_rejects_what_it_cannot_take(cuda):
    Rp, mask, L, ldeb = _positions(cuda)
    with pytest.raises(ValueError, match="float32"):
        ty.yukawa_forces_n3l_soa(Rp.double(), mask.double(), L, ldeb)
    with pytest.raises(ValueError, match="contiguous"):
        ty.yukawa_forces_n3l_soa(Rp.T.contiguous().T, mask, L, ldeb)
    with pytest.raises(ValueError, match="128"):
        ty.yukawa_forces_n3l_soa(Rp[:, :200].contiguous(),
                                 mask[:, :200].contiguous(), L, ldeb)


def _rolls(dev):
    """A ``rolls_fn``: the scheduler then takes the explicit-rolls form."""
    return uniform_rolls(torch.Generator(device=dev).manual_seed(0))


def _planes(sched, dev, excited, seed):
    cfg = lc.CoolingConfig()
    g = torch.Generator(device=dev).manual_seed(seed)
    c = sched.soa_init(lc.initial_state(cfg, g))
    if excited:
        SP = sched.fused_spec.SP
        on = torch.zeros((1, NPAD), device=dev)
        on[0, :N] = 1.0
        pre = torch.zeros((SP, NPAD), device=dev)
        pim = torch.zeros((SP, NPAD), device=dev)
        pre[2, :N], pre[0, :N], pim[4, :N] = 0.7, 0.51, 0.5
        c = c._replace(
            V=0.3 * torch.randn((3, NPAD), generator=g, device=dev) * on,
            tp=torch.rand((1, NPAD), generator=g, device=dev) * on,
            psi_re=pre, psi_im=pim)
    Rp, mask, L, ldeb = _positions(dev)
    F = ty.yukawa_forces_n3l_soa(c.R, mask, L, ldeb)
    rolls = torch.rand((sched.ratio * 5, NPAD), generator=g, device=dev)
    return c, F, rolls


@pytest.mark.parametrize("case", ["ground", "excited",
                                  "excited_expansion_renormalize"])
def test_tick_kernel_matches_twin(cuda, case):
    cfg = lc.CoolingConfig()
    if case.endswith("renormalize"):
        cfg = dataclasses.replace(cfg, frac_of_sig=0.5, renormalize=True)
    sched = lc.build_scheduler(cfg, cuda, _rolls(cuda))
    c, F, rolls = _planes(sched, cuda, case != "ground", seed=1)
    first, tick0 = (True, 0) if case == "ground" else (False, 4321)
    args = (c.R, c.V, F, c.tp, c.psi_re, c.psi_im, rolls)
    before = tf.fused_md_substeps.launches
    out = tf.fused_md_substeps(sched.fused_spec, first, *args, tick0=tick0,
                               tables=sched.tables)
    ref = tf.fused_md_substeps_reference(sched.fused_spec, first, *args,
                                         sched.tables, tick0=tick0)
    torch.cuda.synchronize()
    assert tf.fused_md_substeps.launches == before + 1
    bad = torch.zeros(NPAD, dtype=torch.bool, device=cuda)
    for x, y, atol in zip(out, ref, (2e-5, 2e-5, 2e-5, 5e-5, 5e-5)):
        bad |= ((x - y).abs() > atol + 1e-4 * y.abs()).any(0)
    assert int(bad[:N].sum()) <= 2
    for x in out[3:]:
        assert float(x[12:].abs().max()) == 0.0
        assert float(x[:, N:].abs().max()) == 0.0
    if case != "ground":
        assert int((out[2][0, :N] < 25 * 8e-5).sum()) > 100   # jumps fired


def test_main_path_runs_through_both_kernels(cuda, tmp_path):
    """A short flagship-width run: 100 MD steps = 2 samples of 40 steps
    (39 full + the split 1|24-tick step each) + 20 trailing steps, through
    the in-kernel RNG; the potential of the start and of each sample from
    kernel D."""
    cfg = lc.CoolingConfig(tmax=0.2, save_directory=str(tmp_path))
    a0 = ty.yukawa_forces_n3l_soa.launches
    b0 = tf.fused_md_substeps.launches_rng
    d0 = ty.yukawa_forces_potential_pallas.launches
    e0 = tf.fused_md_substeps.launches
    final, res = lc.run(cfg, device="cuda")
    assert ty.yukawa_forces_n3l_soa.launches - a0 == 100
    assert tf.fused_md_substeps.launches_rng - b0 == 2 * 41 + 20
    assert ty.yukawa_forces_potential_pallas.launches - d0 == 3
    assert tf.fused_md_substeps.launches == e0
    outs = res["outs"]
    assert outs["ekin"].shape == (2, 3)
    assert torch.isfinite(torch.as_tensor(final.R)).all()
    assert abs(float(outs["pops"].sum(-1).mean()) - 1.0) < 0.05


def test_uniform_rolls_are_in_unit_interval(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    r = uniform_rolls(g)(25, NPAD)
    assert r.shape == (125, NPAD) and r.dtype == torch.float32
    assert float(r.min()) >= 0.0 and float(r.max()) < 1.0


def soak_metrics(res, final):
    """The cooling soak's summary numbers, by the soak tool's own
    extraction (tools/torch_soak.py, tools/soak.py's formulas)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_soak
    return torch_soak.cooling_metrics(res["outs"], final.psi)


def test_flagship_run_meets_soak_bands(cuda):
    """The whole flagship run (CoolingConfig() defaults: N0=3500, tmax=30,
    15,000 MD steps) on the card, held to the production-run physics
    bands the JAX package's soak meets (tests/test_physics_targets.py:
    238-254: DIH peak, post-DIH coupling, laser cooling, S/P/D shelving)."""
    final, res = lc.run(lc.CoolingConfig(), device="cuda")
    m = soak_metrics(res, final)
    assert 0.3 < m["dih_peak_t"] < 2.0, m
    assert 0.10 < m["dih_peak_ekin_x"] < 0.25, m
    assert 2.46 < m["gamma_dih"] < 4.59, m
    assert 0.4 < m["cooling_ratio"] < 0.85, m
    assert 0.45 < m["pop_s"] < 0.72, m
    assert 0.10 < m["pop_p"] < 0.30, m
    assert 0.10 < m["pop_d"] < 0.35, m


class _HostDraws:
    """A job's draws from one CPU generator (core/draws.MemberDraws), moved
    to ``device``: the card and the CPU then run on the same numbers."""

    def __init__(self, seed, device):
        from mdqtplasmasims_torch.core.draws import MemberDraws
        self.draws = MemberDraws([torch.Generator().manual_seed(seed)])
        self.device = device

    def __getattr__(self, name):
        draw = getattr(self.draws, name)
        return lambda *a: draw(*a).to(self.device)


MAX_TAG_FLIPS = 8      # of 4096: measurements within rounding of p_up


def test_mc_tag_pump_window_matches_cpu(cuda):
    """The production 408quad pump window of MCTagConfig() (n = 4096, 23
    pump MD steps = 1426 ticks of the plain engine at S=7) on the card and
    on the CPU, from one lattice start with thermal velocities and the same
    draws: the tags agree but for ions whose collapse or measurement
    uniform falls within float rounding of its threshold (a few of 4096),
    and so do the tag fractions and the mean spin-up probability."""
    from mdqtplasmasims_torch.core.pipeline import fresh_state, lattice_start
    from mdqtplasmasims_torch.experiments import mc_qt_tagging as mt
    cfg = mt.MCTagConfig()
    got = []
    for dev in (cuda, torch.device("cpu")):
        m = mt._members(cfg, 1, _HostDraws(3, dev), single=True)
        st = fresh_state(dev, mt.ACC_KEYS)
        st["R"], st["V"] = lattice_start(cfg, m, dev)
        st["A"] = m.forces(st["R"])
        ps = mt.pump_phase(cfg, m, st)
        p_up = cfg.spin_up_probability(ps.psi)
        got.append((mt._measure(cfg, m, ps.psi)[0].cpu(),
                    float(p_up.mean()), ps.V[0].cpu()))
    (tc, pc, vc), (th, ph, vh) = got
    flips = int((tc != th).sum())
    print(f"408quad pump window, n={cfg.n}: tag fraction card "
          f"{float(tc.float().mean()):.6f}, CPU {float(th.float().mean()):.6f}"
          f" ({flips} tags differ); mean p_up card {pc:.6f}, CPU {ph:.6f}; "
          f"max |V card - V CPU| {float((vc - vh).abs().max()):.3g}")
    assert flips <= MAX_TAG_FLIPS
    assert abs(pc - ph) < 1e-3
    assert float((vc - vh).abs().max()) < 1e-3


# ---- ensemble folds: kernel C and the per-lane tick variants ----

E_FOLD = 8


def _fold_positions(dev, per_member):
    from mdqtplasmasims_torch.core.init import poisson_member_mask
    L = PlasmaUnits.box_length(N)
    m, n_js = poisson_member_mask(N, E_FOLD, seed=3)
    npad = -(-max(NPAD, m.shape[1]) // 128) * 128
    masks = torch.zeros((E_FOLD, npad), device=dev)
    masks[:, :m.shape[1]] = torch.as_tensor(m, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    Rp = (torch.rand((3, E_FOLD, npad), generator=g, device=dev) * L
          * masks).reshape(3, E_FOLD * npad)
    if not per_member:
        masks = torch.zeros((1, npad), device=dev)
        masks[0, :min(n_js)] = 1.0
    return Rp, masks, L, PlasmaUnits(2.0, 0.1).debye_length


@pytest.mark.parametrize("case", ["per_member", "shared", "inv_ldeb"])
def test_batched_force_kernel_matches_twin(cuda, case):
    Rp, masks, L, ldeb = _fold_positions(cuda, case != "shared")
    il = None
    if case == "inv_ldeb":
        il = (1.0 / ldeb) * (1.0 + 0.05 * torch.arange(E_FOLD, device=cuda))
    before = ty.yukawa_forces_n3l_soa_batched.launches
    F1 = ty.yukawa_forces_n3l_soa_batched(Rp, masks, E_FOLD, L, ldeb, il)
    F2 = ty.yukawa_forces_n3l_soa_batched(Rp, masks, E_FOLD, L, ldeb, il)
    Fr = ty.yukawa_forces_n3l_soa_batched_reference(Rp, masks, E_FOLD, L,
                                                    ldeb, il)
    torch.cuda.synchronize()
    assert ty.yukawa_forces_n3l_soa_batched.launches == before + 2
    assert torch.equal(F1, F2)           # deterministic run to run
    assert float((F1 - Fr).abs().max()) < 2e-5 * float(Fr.abs().max())
    dead = (masks.expand(E_FOLD, -1) == 0).reshape(-1)
    assert float(F1[:, dead].abs().max()) == 0.0


def test_single_member_fold_equals_force_kernel(cuda):
    Rp, mask, L, ldeb = _positions(cuda)
    a = ty.yukawa_forces_n3l_soa(Rp, mask, L, ldeb)
    c = ty.yukawa_forces_n3l_soa_batched(Rp, mask, 1, L, ldeb)
    torch.cuda.synchronize()
    assert torch.equal(a, c)


def test_fold_kernels_reject_what_they_cannot_take(cuda):
    Rp, masks, L, ldeb = _fold_positions(cuda, True)
    with pytest.raises(ValueError, match="float32"):
        ty.yukawa_forces_n3l_soa_batched(Rp.double(), masks.double(),
                                         E_FOLD, L, ldeb)
    with pytest.raises(ValueError, match="mask_row"):
        ty.yukawa_forces_n3l_soa_batched(Rp, masks[:3], E_FOLD, L, ldeb)
    cfg = lc.CoolingConfig()
    sched = lc.build_scheduler(cfg, cuda, _rolls(cuda), per_lane_e0=True)
    c = sched.soa_init(lc.initial_state(cfg, torch.Generator(
        device=cuda).manual_seed(0)))
    rolls = torch.zeros((125, NPAD), device=cuda)
    args = (c.R, c.V, c.F, c.tp, c.psi_re, c.psi_im, rolls)
    with pytest.raises(ValueError, match="e0_lanes"):
        tf.fused_md_substeps(sched.fused_spec, False, *args,
                             tables=sched.tables)
    with pytest.raises(ValueError, match="e0_lanes"):
        tf.fused_md_substeps(sched.fused_spec, False, *args,
                             tables=sched.tables,
                             e0_lanes=torch.zeros((16, NPAD), device=cuda,
                                                  dtype=torch.float64))


@pytest.mark.parametrize("variant", ["e0", "om", "e0_om"])
@pytest.mark.parametrize("excited", [False, True])
def test_lane_tick_kernels_match_twin(cuda, variant, excited):
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    E = 4
    cfg = lc.CoolingConfig()
    pe0, pom = "e0" in variant, "om" in variant
    sched = lc.build_scheduler(cfg, cuda, _rolls(cuda), per_lane_e0=pe0,
                               per_lane_om=pom)
    spec = sched.fused_spec
    e0 = [lc.build_engine(dataclasses.replace(
        cfg, detuning=d, detuning_dp=dd)).scheme.e0
        for d, dd in ((-1.0, 1.0), (-0.5, 1.0), (-1.5, 0.6), (-0.8, 1.4))]
    om = [(1.0, 1.0), (0.8, 1.2), (1.2, 0.7), (0.5, 1.5)]
    e0p, omp = fold_sweep_lanes(spec, NPAD, e0 if pe0 else None,
                                om if pom else None, cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    c = sched.soa_ens_init(lc.member_states(cfg, E, 1, cuda))
    F = sched.soa_ens_forces_fn(E, N)(c.R)
    on = torch.zeros((E, NPAD), device=cuda)
    on[:, :N] = 1.0
    on = on.reshape(1, E * NPAD)
    if excited:
        pre = torch.zeros_like(c.psi_re)
        pim = torch.zeros_like(c.psi_im)
        pre[2], pre[0], pim[4] = 0.7 * on[0], 0.51 * on[0], 0.5 * on[0]
        c = c._replace(V=0.3 * torch.randn((3, E * NPAD), generator=g,
                                           device=cuda) * on,
                       tp=torch.rand((1, E * NPAD), generator=g,
                                     device=cuda) * on,
                       psi_re=pre, psi_im=pim)
    rolls = torch.rand((125, E * NPAD), generator=g, device=cuda)
    args = (c.R, c.V, F, c.tp, c.psi_re, c.psi_im, rolls)
    first, tick0 = (False, 4321) if excited else (True, 0)
    name = tf.launch_counter(spec)
    before = getattr(tf.fused_md_substeps, name)
    out = tf.fused_md_substeps(spec, first, *args, tick0=tick0,
                               tables=sched.tables, e0_lanes=e0p,
                               om_lanes=omp)
    ref = tf.fused_md_substeps_reference(spec, first, *args, sched.tables,
                                         tick0=tick0, e0_lanes=e0p,
                                         om_lanes=omp)
    torch.cuda.synchronize()
    assert name == "launches_per_lane_" + variant
    assert getattr(tf.fused_md_substeps, name) == before + 1
    bad = torch.zeros(E * NPAD, dtype=torch.bool, device=cuda)
    for x, y, atol in zip(out, ref, (2e-5, 2e-5, 2e-5, 5e-5, 5e-5)):
        bad |= ((x - y).abs() > atol + 1e-4 * y.abs()).any(0)
    assert int((bad & (on[0] > 0)).sum()) <= 2 * E
    for x in out[3:]:
        assert float(x[12:].abs().max()) == 0.0
        assert float(x[:, on[0] == 0].abs().max()) == 0.0


def test_ensemble_run_members_finite_and_heating(cuda, tmp_path):
    """Eight Poissonian members at flagship width for 500 MD steps: one
    batched force and one tick launch per MD step for the whole fold;
    every member finite, heating from the frozen start (disorder-induced
    heating), its S+P+D norm near 1, and its tree sized to its own N.
    The start's and each sample's potentials: one launch of kernel G."""
    cfg = lc.CoolingConfig(tmax=1.0, exact_n=False,
                           save_directory=str(tmp_path))
    a0 = ty.yukawa_forces_n3l_soa_batched.launches
    b0 = tf.fused_md_substeps.launches_rng
    g0 = ty.yukawa_forces_potential_pallas_batched.launches
    final, outs = lc.run_ensemble(cfg, E_FOLD, device="cuda")
    assert ty.yukawa_forces_n3l_soa_batched.launches - a0 == 500
    assert tf.fused_md_substeps.launches_rng - b0 == 12 * 41 + 20
    assert ty.yukawa_forces_potential_pallas_batched.launches - g0 == 13
    from mdqtplasmasims_torch.core.init import poisson_member_mask
    _, n_js = poisson_member_mask(N, E_FOLD, 0)
    for j, nj in enumerate(n_js):
        assert np.isfinite(final.R[j][:nj]).all()
        assert np.isfinite(final.psi[j][:nj]).all()
        ek = outs["ekin"][j].sum(-1)
        assert 0 < ek[0] < ek[-1]
        norm = outs["pops"][j][:, :nj].sum(-1).mean(-1)
        assert float(np.abs(norm - 1.0).max()) < 0.05


# ---- the in-kernel RNG form of kernel B, and kernels D and G ----

@pytest.mark.parametrize("variant", ["plain", "e0", "om", "e0_om"])
@pytest.mark.parametrize("excited", [False, True])
def test_rng_tick_kernels_match_twin(cuda, variant, excited):
    """Each RNG form against its twin, which draws the same Threefry
    stream in plain torch: one member (plain) or a 4-member sweep fold."""
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    E = 1 if variant == "plain" else 4
    cfg = lc.CoolingConfig()
    pe0, pom = "e0" in variant, "om" in variant
    sched = lc.build_scheduler(cfg, cuda, per_lane_e0=pe0, per_lane_om=pom)
    spec = sched.fused_spec
    assert spec.internal_rng               # the CUDA default
    e0 = [lc.build_engine(dataclasses.replace(
        cfg, detuning=d, detuning_dp=dd)).scheme.e0
        for d, dd in ((-1.0, 1.0), (-0.5, 1.0), (-1.5, 0.6), (-0.8, 1.4))]
    om = [(1.0, 1.0), (0.8, 1.2), (1.2, 0.7), (0.5, 1.5)]
    e0p, omp = fold_sweep_lanes(spec, NPAD, e0 if pe0 else None,
                                om if pom else None, cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    c = sched.soa_ens_init(lc.member_states(cfg, E, 1, cuda))
    F = sched.soa_ens_forces_fn(E, N)(c.R)
    on = (torch.arange(E * NPAD, device=cuda) % NPAD) < N
    if excited:
        pre = torch.zeros_like(c.psi_re)
        pim = torch.zeros_like(c.psi_im)
        pre[2], pre[0], pim[4] = 0.7 * on, 0.51 * on, 0.5 * on
        c = c._replace(V=0.3 * torch.randn((3, E * NPAD), generator=g,
                                           device=cuda) * on,
                       tp=torch.rand((1, E * NPAD), generator=g,
                                     device=cuda) * on,
                       psi_re=pre, psi_im=pim)
    seed = torch.tensor([20251016], dtype=torch.int32, device=cuda)
    first, tick0 = (False, 123457) if excited else (True, 0)
    args = (c.R, c.V, F, c.tp, c.psi_re, c.psi_im)
    name = tf.launch_counter(spec)
    assert name == "launches_rng" + ("" if E == 1 else "_per_lane_" + variant)
    before = getattr(tf.fused_md_substeps, name)
    out = tf.fused_md_substeps(spec, first, *args, tick0=tick0,
                               tables=sched.tables, e0_lanes=e0p,
                               om_lanes=omp, seed=seed)
    ref = tf.fused_md_substeps_reference(spec, first, *args, None,
                                         sched.tables, tick0=tick0,
                                         e0_lanes=e0p, om_lanes=omp,
                                         seed=seed)
    torch.cuda.synchronize()
    assert getattr(tf.fused_md_substeps, name) == before + 1
    bad = torch.zeros(E * NPAD, dtype=torch.bool, device=cuda)
    for x, y, atol in zip(out, ref, (2e-5, 2e-5, 2e-5, 5e-5, 5e-5)):
        bad |= ((x - y).abs() > atol + 1e-4 * y.abs()).any(0)
    assert int((bad & on).sum()) <= 3 * E
    for x in out[3:]:
        assert float(x[12:].abs().max()) == 0.0
        assert float(x[:, ~on].abs().max()) == 0.0
    if excited:                  # jumps fired, and on the same lanes
        jumped = out[2][0] < 25 * 8e-5
        assert int((jumped & on).sum()) > 100 * E
        assert int((jumped != (ref[2][0] < 25 * 8e-5)).sum()) <= 3 * E


def _held(F, pot, Fr, potr, dead):
    assert float((F - Fr).abs().max()) <= 2e-5 * float(Fr.abs().max())
    assert float((pot - potr).abs().max()) <= 1e-5 * float(potr.abs().max())
    if dead.any():
        assert float(F[dead].abs().max()) == 0.0
        assert float(pot[dead].abs().max()) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_potential_kernel_d_matches_twin(cuda, masked):
    L = PlasmaUnits.box_length(N)
    ldeb = PlasmaUnits(2.0, 0.1).debye_length
    g = torch.Generator(device=cuda).manual_seed(8)
    R = torch.rand((N, 3), generator=g, device=cuda) * L
    mask = torch.ones(N, device=cuda)
    mask[::10] = 0.0
    mk = mask if masked else None
    before = ty.yukawa_forces_potential_pallas.launches
    F, pot = ty.yukawa_forces_potential_pallas(R, L, ldeb, mk)
    Fr, potr = ty.yukawa_forces_potential(R, L, ldeb, mk)
    e = ty.yukawa_potential_pallas(R, L, ldeb, mk)
    torch.cuda.synchronize()
    assert ty.yukawa_forces_potential_pallas.launches == before + 2
    _held(F, pot, Fr, potr, mask == 0 if masked else mask < 0)
    er = 0.5 * potr.sum() / (mk.sum() if masked else N)
    assert abs(float(e - er)) <= 1e-5 * abs(float(er))


@pytest.mark.parametrize("per_member", [True, False])
def test_potential_kernel_g_matches_twin(cuda, per_member):
    from mdqtplasmasims_torch.core.init import poisson_member_mask
    L = PlasmaUnits.box_length(N)
    ldeb = PlasmaUnits(2.0, 0.1).debye_length
    m, n_js = poisson_member_mask(N, E_FOLD, seed=3)
    masks = torch.as_tensor(m, device=cuda)
    n = m.shape[1]
    g = torch.Generator(device=cuda).manual_seed(9)
    R = torch.rand((E_FOLD, n, 3), generator=g, device=cuda) * L
    R = R * masks[..., None]
    if not per_member:
        masks = torch.zeros(n, device=cuda)
        masks[:min(n_js)] = 1.0
    before = ty.yukawa_forces_potential_pallas_batched.launches
    F, pot = ty.yukawa_forces_potential_pallas_batched(R, L, ldeb,
                                                       mask=masks)
    e = ty.yukawa_potential_pallas_batched(R, L, ldeb, masks)
    torch.cuda.synchronize()
    assert ty.yukawa_forces_potential_pallas_batched.launches == before + 2
    for j in range(E_FOLD):
        mj = masks[j] if per_member else masks
        Fr, potr = ty.yukawa_forces_potential(R[j], L, ldeb, mj)
        _held(F[j], pot[j], Fr, potr, mj == 0)
        er = ty.yukawa_potential(R[j], L, ldeb, mj)
        assert abs(float(e[j] - er)) <= 1e-5 * abs(float(er))


@pytest.mark.parametrize("use_pallas", [None, True, False])
@pytest.mark.parametrize("n3l", [True, False])
def test_best_forces_fn_launches_a_kernel_in_every_mode(cuda, use_pallas,
                                                         n3l):
    """On the card every mode reaches a kernel: forces only from A (n3l)
    or D, or with ``use_pallas=False`` forces and the potential from D."""
    L = PlasmaUnits.box_length(N)
    ldeb = PlasmaUnits(2.0, 0.1).debye_length
    g = torch.Generator(device=cuda).manual_seed(10)
    R = torch.rand((N, 3), generator=g, device=cuda) * L
    mask = torch.ones(N, device=cuda)
    mask[::7] = 0.0
    counters = (ty.yukawa_forces_n3l_soa, ty.yukawa_forces_potential_pallas)
    before = [c.launches for c in counters]
    F, pot = ty.best_forces_fn(N, L, ldeb, mask=mask, use_pallas=use_pallas,
                               n3l=n3l)(R)
    Fr, potr = ty.yukawa_forces_potential(R, L, ldeb, mask)
    torch.cuda.synchronize()
    kernel_a = use_pallas is not False and n3l
    assert [c.launches - b for c, b in zip(counters, before)] == (
        [1, 0] if kernel_a else [0, 1])
    assert float((F - Fr).abs().max()) <= 2e-5 * float(Fr.abs().max())
    assert float(F[mask == 0].abs().max()) == 0.0
    if use_pallas is False:
        _held(F, pot, Fr, potr, mask == 0)
    else:
        assert pot is None


def _fold_lanes(R):
    return R.permute(2, 0, 1).reshape(3, -1).contiguous()


@pytest.mark.parametrize("per_member", [True, False])
def test_cols_kernel_e_matches_twin_and_c(cuda, per_member):
    """Kernel E at a mesh slot's shapes (2 members, rows 1792 against 4 x
    1792 columns) against its twin, run to run, and with a member's own
    lanes as its columns against kernel C on real rows: at these 3584
    lanes C takes the half-pair form, which sums each pair once in another
    order, so within 2e-5 of the largest |F| (bit for bit below
    ``HALF_MIN_NPAD``: test_pair_kernel_edge_shapes)."""
    Rp, masks, L, ldeb = _fold_positions(cuda, True)
    E, npad = 2, Rp.shape[1] // E_FOLD
    own = Rp.reshape(3, E_FOLD, npad)[:, :E].permute(1, 2, 0).contiguous()
    m = masks[:E] if per_member else masks[0]
    before = ty.yukawa_forces_soa_cols_batched.launches
    Fe = ty.yukawa_forces_soa_cols_batched(_fold_lanes(own), own, m, E, L,
                                           ldeb)
    Fc = ty.yukawa_forces_n3l_soa_batched(
        _fold_lanes(own), masks[:E] if per_member else masks[:1], E, L, ldeb)
    rows = _fold_lanes(own[:, :1792])
    cols = own[:, :1792].repeat(1, 4, 1).contiguous()
    cm = (m[..., :1792].repeat(*((1, 4) if per_member else (4,)))
          .contiguous())
    F1 = ty.yukawa_forces_soa_cols_batched(rows, cols, cm, E, L, ldeb)
    F2 = ty.yukawa_forces_soa_cols_batched(rows, cols, cm, E, L, ldeb)
    Fr = ty.yukawa_forces_soa_cols_batched_reference(rows, cols, cm, E, L,
                                                     ldeb)
    torch.cuda.synchronize()
    assert ty.yukawa_forces_soa_cols_batched.launches == before + 3
    real = (m.expand(E, npad) > 0).reshape(-1)
    assert ty.half_form(npad)
    assert _close(Fe[:, real], Fc[:, real], 2e-5)
    assert torch.equal(F1, F2)
    assert float((F1 - Fr).abs().max()) < 2e-5 * float(Fr.abs().max())


def test_cross_kernel_f_matches_twin(cuda):
    """Kernel F on two 1792-lane blocks of 2 members: its twin, bitwise
    run to run, masked lanes exactly 0."""
    Rp, masks, L, ldeb = _fold_positions(cuda, True)
    npad = Rp.shape[1] // E_FOLD
    R = Rp.reshape(3, E_FOLD, npad).permute(1, 2, 0)
    tail = slice(npad - 1792, npad)          # real and padded lanes
    A, B = R[:2, tail].contiguous(), R[2:4, tail].contiguous()
    ma, mb = masks[:2, tail].contiguous(), masks[2:4, tail].contiguous()
    assert (ma == 0).any() and (mb == 0).any()
    before = ty.yukawa_forces_cross_n3l_soa_batched.launches
    F1, G1 = ty.yukawa_forces_cross_n3l_soa_batched(_fold_lanes(A), ma, B,
                                                    mb, 2, L, ldeb)
    F2, G2 = ty.yukawa_forces_cross_n3l_soa_batched(_fold_lanes(A), ma, B,
                                                    mb, 2, L, ldeb)
    Fr, Gr = ty.yukawa_forces_cross_n3l_soa_batched_reference(
        _fold_lanes(A), ma, B, mb, 2, L, ldeb)
    torch.cuda.synchronize()
    assert ty.yukawa_forces_cross_n3l_soa_batched.launches == before + 2
    assert torch.equal(F1, F2) and torch.equal(G1, G2)
    scale = max(float(Fr.abs().max()), float(Gr.abs().max()))
    assert float((F1 - Fr).abs().max()) < 2e-5 * scale
    assert float((G1 - Gr).abs().max()) < 2e-5 * scale
    assert float(F1[:, ma.reshape(-1) == 0].abs().max()) == 0.0
    assert float(G1[mb == 0].abs().max()) == 0.0


@pytest.mark.parametrize("ion_forces", ["gather", "ring_n3l"])
def test_mesh_run_on_one_card(cuda, ion_forces):
    """run_ensemble over a 2 x 2 mesh of slots on the card launches its
    schedule's kernels, and an ens-only mesh equals the unsharded fold
    bit for bit."""
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    cfg = lc.CoolingConfig(n0=512, tmax=0.1, sample_freq=10)
    counter = (ty.yukawa_forces_soa_cols_batched if ion_forces == "gather"
               else ty.yukawa_forces_cross_n3l_soa_batched)
    before = counter.launches
    final, outs = lc.run_ensemble(cfg, 2, seed=1, ion_forces=ion_forces,
                                  mesh=make_mesh(2, 2, devices=[cuda] * 4))
    # per MD step: E on each of the 4 slots; F once per pair of ion blocks
    # of each of the 2 member rows (the antipodal hop runs on one shard)
    assert counter.launches - before == 50 * (4 if ion_forces == "gather"
                                              else 2)
    assert np.isfinite(final.R).all() and outs["t"].shape == (2, 5)
    f0, _ = lc.run_ensemble(cfg, 2, seed=1, device=cuda)
    f1, _ = lc.run_ensemble(cfg, 2, seed=1,
                            mesh=make_mesh(2, 1, devices=[cuda] * 2))
    for k in ("R", "V", "psi", "t_part"):
        assert np.array_equal(getattr(f0, k), getattr(f1, k))


# ---- the pair kernel at the edges of its tiling: every form (A, C, D, G,
# E, F) against its plain version, bitwise run to run, masked lanes 0 ----

EDGE_SHAPES = {                 # E members, row lanes, columns (E and F)
    "one_tile": (1, 128, 128),              # fewer columns than one chunk
    "empty_and_single_member": (3, 256, 384),
    "holes": (2, 512, 1024),
    "half_holes": (2, 2048, 2048),          # A and C in the half-pair form
}


def _edge_mask(case, e, n, seed):
    """``[e, n]`` real-lane masks: a 100-ion prefix; a member of padding
    only, one with a single ion and one with 200; or real lanes that are
    no prefix (every other lane at random, a whole 128-lane tile and an
    unaligned stretch cleared)."""
    m = torch.zeros((e, n))
    if case == "one_tile":
        m[:, :100] = 1.0
    elif case == "empty_and_single_member":
        m[1, 77] = 1.0
        m[2, :200] = 1.0
    else:
        g = torch.Generator().manual_seed(seed)
        m = (torch.rand((e, n), generator=g) < 0.5).float()
        m[:, 128:256] = 0.0
        m[:, 300:345] = 0.0
    return m


def _edge_inputs(dev, case):
    e, npad, ncols = EDGE_SHAPES[case]
    L = PlasmaUnits.box_length(npad)
    g = torch.Generator(device=dev).manual_seed(17)
    # masked lanes hold positions too: the kernel must ignore them
    Rp = torch.rand((3, e * npad), generator=g, device=dev) * L
    cols = torch.rand((e, ncols, 3), generator=g, device=dev) * L
    rm = _edge_mask(case, e, npad, 1).to(dev)
    cm = _edge_mask(case, e, ncols, 2).to(dev)
    return e, npad, Rp, rm, cols, cm, L, PlasmaUnits(2.0, 0.1).debye_length


def _close(x, ref, tol):
    return float((x - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.parametrize("case", list(EDGE_SHAPES))
@pytest.mark.parametrize("form", ["A", "C", "C_inv_ldeb", "D", "G", "E",
                                  "E_row_mask", "F"])
def test_pair_kernel_edge_shapes(cuda, form, case):
    e, npad, Rp, rm, cols, cm, L, ldeb = _edge_inputs(cuda, case)
    dead = (rm == 0).reshape(-1)
    R = Rp.reshape(3, e, npad).permute(1, 2, 0).contiguous()   # [e, npad, 3]
    if form == "A":
        for k in range(e):
            one, mk = R[k].T.contiguous(), rm[k:k + 1].contiguous()
            F1 = ty.yukawa_forces_n3l_soa(one, mk, L, ldeb)
            F2 = ty.yukawa_forces_n3l_soa(one, mk, L, ldeb)
            Fr = ty.yukawa_forces_n3l_soa_reference(one, mk, L, ldeb)
            assert torch.equal(F1, F2) and _close(F1, Fr, 2e-5)
            assert not F1[:, mk[0] == 0].any()
            Fc = ty.yukawa_forces_n3l_soa_batched(one, mk, 1, L, ldeb)
            assert torch.equal(F1, Fc)         # an E=1 fold is kernel A
    elif form in ("C", "C_inv_ldeb"):
        il = None
        if form == "C_inv_ldeb":
            il = (1.0 / ldeb) * (1.0 + 0.3 * torch.arange(e, device=cuda))
        F1 = ty.yukawa_forces_n3l_soa_batched(Rp, rm, e, L, ldeb, il)
        F2 = ty.yukawa_forces_n3l_soa_batched(Rp, rm, e, L, ldeb, il)
        Fr = ty.yukawa_forces_n3l_soa_batched_reference(Rp, rm, e, L, ldeb,
                                                        il)
        assert torch.equal(F1, F2) and _close(F1, Fr, 2e-5)
        assert not F1[:, dead].any()
        # kernel E on the members' own lanes: kernel C on real rows, bit
        # for bit where C sweeps the same rectangle
        Fe = ty.yukawa_forces_soa_cols_batched(Rp, R, rm, e, L, ldeb)
        if il is None and not ty.half_form(npad):
            assert torch.equal(Fe[:, ~dead], F1[:, ~dead])
        elif il is None:
            assert _close(Fe[:, ~dead], F1[:, ~dead], 2e-5)
    elif form == "D":
        for k in range(e):
            out1 = ty.yukawa_forces_potential_pallas(R[k], L, ldeb, rm[k],
                                                     tile=128)
            out2 = ty.yukawa_forces_potential_pallas(R[k], L, ldeb, rm[k],
                                                     tile=128)
            Fr, potr = ty.yukawa_forces_potential(R[k], L, ldeb, rm[k])
            assert all(torch.equal(a, b) for a, b in zip(out1, out2))
            _held(*out1, Fr, potr, rm[k] == 0)
    elif form == "G":
        out1 = ty.yukawa_forces_potential_pallas_batched(R, L, ldeb, 128, rm)
        out2 = ty.yukawa_forces_potential_pallas_batched(R, L, ldeb, 128, rm)
        assert all(torch.equal(a, b) for a, b in zip(out1, out2))
        for k in range(e):
            Fr, potr = ty.yukawa_forces_potential(R[k], L, ldeb, rm[k])
            _held(out1[0][k], out1[1][k], Fr, potr, rm[k] == 0)
    elif form in ("E", "E_row_mask"):
        kw = dict(row_mask=rm) if form == "E_row_mask" else {}
        F1 = ty.yukawa_forces_soa_cols_batched(Rp, cols, cm, e, L, ldeb, **kw)
        F2 = ty.yukawa_forces_soa_cols_batched(Rp, cols, cm, e, L, ldeb, **kw)
        Fr = ty.yukawa_forces_soa_cols_batched_reference(Rp, cols, cm, e, L,
                                                         ldeb, **kw)
        assert torch.equal(F1, F2) and _close(F1, Fr, 2e-5)
        if kw:
            assert not F1[:, dead].any()
    else:
        F1, G1 = ty.yukawa_forces_cross_n3l_soa_batched(Rp, rm, cols, cm, e,
                                                        L, ldeb)
        F2, G2 = ty.yukawa_forces_cross_n3l_soa_batched(Rp, rm, cols, cm, e,
                                                        L, ldeb)
        Fr, Gr = ty.yukawa_forces_cross_n3l_soa_batched_reference(
            Rp, rm, cols, cm, e, L, ldeb)
        assert torch.equal(F1, F2) and torch.equal(G1, G2)
        scale = max(float(Fr.abs().max()), float(Gr.abs().max()))
        assert float((F1 - Fr).abs().max()) <= 2e-5 * scale
        assert float((G1 - Gr).abs().max()) <= 2e-5 * scale
        assert not F1[:, dead].any() and not G1[cm == 0].any()
    torch.cuda.synchronize()


def test_half_pair_form_keeps_a_members_bits(cuda):
    """The half-pair form (3584 lanes): a member's forces are the same bits
    in folds of 1, 8 and 20 members and through kernel A, run to run, and
    within 2e-5 of the plain version; ``half_launches`` counts it."""
    L = PlasmaUnits.box_length(N)
    ldeb = PlasmaUnits(2.0, 0.1).debye_length
    g = torch.Generator(device=cuda).manual_seed(9)
    mask = torch.zeros((1, NPAD), device=cuda)
    mask[0, :N] = 1.0
    R = torch.rand((3, 20, NPAD), generator=g, device=cuda) * L * mask
    fold = lambda k: R[:, :k].reshape(3, k * NPAD).contiguous()
    bits = lambda x: x.view(torch.int32)
    before = (ty.yukawa_forces_n3l_soa.half_launches,
              ty.yukawa_forces_n3l_soa_batched.half_launches)
    F20 = ty.yukawa_forces_n3l_soa_batched(fold(20), mask, 20, L, ldeb)
    again = ty.yukawa_forces_n3l_soa_batched(fold(20), mask, 20, L, ldeb)
    F8 = ty.yukawa_forces_n3l_soa_batched(fold(8), mask, 8, L, ldeb)
    F1 = ty.yukawa_forces_n3l_soa_batched(fold(1), mask, 1, L, ldeb)
    FA = ty.yukawa_forces_n3l_soa(fold(1), mask, L, ldeb)
    ref = ty.yukawa_forces_n3l_soa_batched_reference(fold(20), mask, 20, L,
                                                     ldeb)
    torch.cuda.synchronize()
    assert (ty.yukawa_forces_n3l_soa.half_launches,
            ty.yukawa_forces_n3l_soa_batched.half_launches) == (
                before[0] + 1, before[1] + 4)
    assert torch.equal(bits(F20), bits(again))
    assert torch.equal(bits(F8), bits(F20[:, :8 * NPAD]))
    assert torch.equal(bits(F1), bits(F20[:, :NPAD]))
    assert torch.equal(bits(FA), bits(F1))
    assert _close(F20, ref, 2e-5)
    pads = (torch.arange(20 * NPAD, device=cuda) % NPAD) >= N
    assert float(F20[:, pads].abs().max()) == 0.0


# ---- the tick kernel (one ion across the lanes of a group): every form at
# every launch shape against its twin, bitwise run to run, and a whole
# launch against the same lanes launched in two parts ----

TICK_SHAPES = {                 # members, lanes per member, ions per member
    "np128": (1, 128, 100),
    "shard1792": (1, 1792, 875),
    "np3584": (1, NPAD, N),
    "fold8": (8, NPAD, N),
}
SWEEP_DETS = ((-1.0, 1.0), (-0.5, 1.0), (-1.5, 0.6), (-0.8, 1.4))
SWEEP_OMS = ((1.0, 1.0), (0.8, 1.2), (1.2, 0.7), (0.5, 1.5))


def _tick_inputs(dev, spec, members, npad, n_real, excited, seed):
    """Planes of ``members`` blocks of ``npad`` lanes, ``n_real`` ions each:
    a ground-state start, or a normalized excited one where jumps fire."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lanes = members * npad
    on = (torch.arange(lanes, device=dev) % npad) < n_real
    m = on.float()
    rand = lambda rows: torch.rand((rows, lanes), generator=g, device=dev)
    pre = torch.zeros((spec.SP, lanes), device=dev)
    pim = torch.zeros((spec.SP, lanes), device=dev)
    if excited:
        amp = torch.randn((2, spec.S, lanes), generator=g, device=dev)
        amp = amp / amp.pow(2).sum((0, 1)).sqrt()
        pre[:spec.S], pim[:spec.S] = amp[0] * m, amp[1] * m
    else:
        pre[0] = m
    planes = (rand(3) * 5.0 * m, (rand(3) - 0.5) * m, (rand(3) - 0.5) * m,
              rand(1) * m * float(excited), pre, pim)
    rolls = (None if spec.internal_rng else
             torch.rand((spec.ratio * 5, lanes), generator=g, device=dev))
    return on, planes, rolls


def _hold_tick_kernel(dev, spec, tables, members, npad, n_real, excited,
                      e0p=None, omp=None, seed=3):
    """Kernel against twin at the bars, pads exactly 0, bitwise repeat, and
    whole == two parts (the RNG form numbering each part with ``lane0``)."""
    on, planes, rolls = _tick_inputs(dev, spec, members, npad, n_real,
                                     excited, seed)
    lanes = members * npad
    word = torch.tensor([20261016], dtype=torch.int32, device=dev)
    lane0 = 1792 if spec.internal_rng and npad == 1792 else 0
    first, tick0 = (not excited), (7001 if excited else 0)

    def launch(lo, hi, fn=tf.fused_md_substeps):
        cut = lambda x: None if x is None else x[:, lo:hi].contiguous()
        kw = dict(tick0=tick0, e0_lanes=cut(e0p), om_lanes=cut(omp))
        if spec.internal_rng:
            kw.update(seed=word, lane0=lane0 + lo)
        if fn is tf.fused_md_substeps:
            return fn(spec, first, *map(cut, planes), cut(rolls),
                      tables=tables, **kw)
        return fn(spec, first, *map(cut, planes), cut(rolls), tables, **kw)

    name = tf.launch_counter(spec)
    before = getattr(tf.fused_md_substeps, name)
    out, again = launch(0, lanes), launch(0, lanes)
    assert getattr(tf.fused_md_substeps, name) == before + 2
    ref = launch(0, lanes, tf.fused_md_substeps_reference)
    torch.cuda.synchronize()
    bad = torch.zeros(lanes, dtype=torch.bool, device=dev)
    for x, y, atol in zip(out, ref, (2e-5, 2e-5, 2e-5, 5e-5, 5e-5)):
        bad |= ((x - y).abs() > atol + 1e-4 * y.abs()).any(0)
    assert int((bad & on).sum()) <= 3 * members
    for x in out[3:]:
        assert float(x[spec.S:].abs().max()) == 0.0
        assert float(x[:, ~on].abs().sum()) == 0.0
    assert all(torch.equal(x, y) for x, y in zip(out, again))
    if lanes % 256 == 0:
        parts = [launch(0, lanes // 2), launch(lanes // 2, lanes)]
        assert all(torch.equal(x, torch.cat([a, b], 1))
                   for x, a, b in zip(out, *parts))
    if excited and spec.ratio >= 24:       # jumps fired, on the twin's lanes
        jumped = out[2][0] < spec.ratio * spec.qdt
        assert int((jumped & on).sum()) > n_real * members // 50
        assert int((jumped != (ref[2][0] < spec.ratio * spec.qdt)).sum()) \
            <= 3 * members


@pytest.mark.parametrize("shape", list(TICK_SHAPES))
@pytest.mark.parametrize("variant", ["plain", "e0", "om", "e0_om"])
@pytest.mark.parametrize("rng", [False, True])
def test_tick_kernel_every_form_and_shape(cuda, rng, variant, shape):
    """Each of the eight S=12 forms at 128, 1792 and 3584 lanes and on an
    8-member fold: ground start with the first drift and excited starts, at
    25, 24 and 1 ticks."""
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    members, npad, n_real = TICK_SHAPES[shape]
    cfg = lc.CoolingConfig()
    pe0, pom = "e0" in variant, "om" in variant
    sched = lc.build_scheduler(cfg, cuda, None if rng else _rolls(cuda),
                               per_lane_e0=pe0, per_lane_om=pom)
    assert sched.fused_spec.internal_rng == rng
    e0 = [lc.build_engine(dataclasses.replace(
        cfg, detuning=SWEEP_DETS[k % 4][0],
        detuning_dp=SWEEP_DETS[k % 4][1])).scheme.e0 for k in range(members)]
    om = [SWEEP_OMS[k % 4] for k in range(members)]
    e0p, omp = fold_sweep_lanes(sched.fused_spec, npad, e0 if pe0 else None,
                                om if pom else None, cuda)
    for excited, ticks in ((False, 25), (True, 25), (True, 24), (True, 1)):
        spec = dataclasses.replace(sched.fused_spec, ratio=ticks)
        _hold_tick_kernel(cuda, spec, sched.tables, members, npad, n_real,
                          excited, e0p, omp)


def _small_spec(scheme, ratio=25, **kw):
    return tf.FusedTickSpec(scheme=scheme, h=0.00985, qdt=8e-5,
                            plas_to_quant_vel=1.327, gamma_to_einstein=123.1,
                            ratio=ratio, L=7.5, apply_force=scheme.has_force,
                            **kw)


def _small_scheme(name):
    from mdqtplasmasims_torch import levels
    return dict(
        three_state=levels.three_state,
        three_state_beat=lambda: dataclasses.replace(
            levels.three_state(), name="three_state_beat", tdep_rows=(1,),
            tdep_cols=(2,), tdep_coefs=(0.05,), tdep_freq=0.7),
        tag422=levels.tag422,
        tag408_linear=lambda: levels.tag408(-1.0, 0.5, True),
        tag408_circular=lambda: levels.tag408(-1.0, 0.5, False),
        # terms no pump has, on its compiled pattern's pairs: a kick on
        # the 408 linear pump, a beat note on the 422 pump
        tag408_kick=lambda: dataclasses.replace(
            levels.tag408(-1.0, 0.5, True), name="tag408_kick",
            force_a=(0, 1), force_b=(2, 5), force_w=(2e-3, -1e-3)),
        tag422_beat=lambda: dataclasses.replace(
            levels.tag422(), name="tag422_beat", tdep_rows=(1,),
            tdep_cols=(2,), tdep_coefs=(0.05,), tdep_freq=0.7))[name]()


@pytest.mark.parametrize("excited", [False, True])
@pytest.mark.parametrize("scheme_name", ["three_state", "three_state_beat",
                                         "tag422", "tag408_linear",
                                         "tag408_circular", "tag408_kick",
                                         "tag422_beat"])
def test_tick_kernel_small_schemes(cuda, scheme_name, excited):
    """The explicit S = 3, 5 and 7 forms (one thread an ion; with a
    beat-note term too, the complex-row path; at S = 5 and 7 the pump's
    compiled pattern, and a kick or a beat note on its pairs)."""
    scheme = _small_scheme(scheme_name)
    for ticks in (25, 1):
        spec = _small_spec(scheme, ticks)
        tables = tf.fused_tables(spec, cuda)
        _hold_tick_kernel(cuda, spec, tables, 1, 256, 200, excited)
        _hold_tick_kernel(cuda, spec, tables, 1, 3584, 3500, excited)


@pytest.mark.parametrize("variant", ["plain", "e0", "om", "e0_om"])
@pytest.mark.parametrize("scheme_name", ["tag422", "tag408_linear",
                                         "tag408_circular", "tag408_kick",
                                         "tag422_beat"])
def test_tick_kernel_patterns_equal_the_dense_form(cuda, scheme_name,
                                                   variant):
    """A scheme's compiled coupling pattern and the dense pattern's form
    (``coupling_pattern="dense"``) give the same bits on the same inputs,
    in every per-lane form (the sums skip zeros in order; every product
    that is subtracted is rounded by the source, not by the assembler)."""
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    scheme = _small_scheme(scheme_name)
    pe0, pom = "e0" in variant, "om" in variant
    spec = _small_spec(scheme, 25, per_lane_e0=pe0)
    if pom:
        spec = tf.rabi_scaled(spec)
    dense = dataclasses.replace(spec, coupling_pattern="dense")
    assert tf._kernel_plan(spec).pattern != tf._kernel_plan(dense).pattern
    e0p, omp = fold_sweep_lanes(
        spec, 1024, [scheme.e0 * f for f in (1.0, 0.5)] if pe0 else None,
        [(f, 0.0) for f in (1.0, 0.6)] if pom else None, cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    lanes = 2 * 1024
    rand = lambda rows: torch.rand((rows, lanes), generator=g, device=cuda)
    pre, pim = torch.zeros((2, spec.SP, lanes), device=cuda)
    src = scheme.jump_src                      # the excited states
    pre[0], pre[src[0]], pim[src[-1]] = 0.51, 0.7, 0.5
    args = (rand(3) * 5, rand(3) - 0.5, rand(3) - 0.5, rand(1), pre, pim,
            rand(spec.ratio * 5))
    tables = tf.fused_tables(spec, cuda)
    kw = dict(tables=tables, e0_lanes=e0p, om_lanes=omp)
    masked = tf.fused_md_substeps(spec, False, *args, **kw)
    full = tf.fused_md_substeps(dense, False, *args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(masked, full))


@pytest.mark.parametrize("variant", ["e0", "om", "e0_om"])
@pytest.mark.parametrize("scheme_name", ["three_state", "tag422", "tag408"])
def test_tick_kernel_small_per_lane_forms(cuda, scheme_name, variant):
    """The S = 3, 5 and 7 sweep forms as the three-state and tagging sweeps
    launch them (tf.rabi_scaled: the scheme's own coupling scaled by a
    lane's om), on a 4-member fold."""
    from mdqtplasmasims_torch import levels
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    scheme = dict(three_state=levels.three_state, tag422=levels.tag422,
                  tag408=lambda: levels.tag408(0.0, 2.0, False)
                  )[scheme_name]()
    pe0, pom = "e0" in variant, "om" in variant
    spec = _small_spec(scheme, 25, per_lane_e0=pe0)
    if pom:
        spec = tf.rabi_scaled(spec)
    e0 = [scheme.e0 * f for f in (1.0, 0.5, 2.0, -1.0)]
    om = [(f, 0.0) for f in (1.0, 0.6, 1.5, 0.3)]
    e0p, omp = fold_sweep_lanes(spec, 1024, e0 if pe0 else None,
                                om if pom else None, cuda)
    tables = tf.fused_tables(spec, cuda)
    _hold_tick_kernel(cuda, spec, tables, 4, 1024, 1000, True, e0p, omp)


@pytest.mark.parametrize("rng", [False, True])
def test_tick_kernel_dense_coupling_table(cuda, rng):
    """A coupling table with full rows (12 entries a row) takes the
    kernel's long-row path and still matches the twin."""
    from mdqtplasmasims_torch import levels
    gen = np.random.default_rng(3)
    sch = levels.with_recoil(levels.sr12_cooling(), 9.1e-4, 3.6e-4)
    extra = 0.05 * gen.normal(size=(12, 12))
    dense = dataclasses.replace(sch, coupling=sch.coupling + extra + extra.T)
    spec = _small_spec(dense, internal_rng=rng)
    assert tf._kernel_plan(spec).K == 12
    tables = tf.fused_tables(spec, cuda)
    for excited in (False, True):
        _hold_tick_kernel(cuda, spec, tables, 1, 1792, 875, excited)


def test_tick_kernel_refuses_complex_tables(cuda):
    from mdqtplasmasims_torch import levels
    sch = levels.sr12_cooling()
    bad = dataclasses.replace(sch, coupling=sch.coupling * (1 + 0.5j))
    spec = _small_spec(bad)
    z = lambda rows: torch.zeros((rows, 128), device=cuda)
    with pytest.raises(ValueError, match="real coupling"):
        tf.fused_md_substeps(spec, False, z(3), z(3), z(3), z(1), z(16),
                             z(16), z(125))


# ---- the frozen-start tagging and three-state families on the card

def _counts():
    from mdqtplasmasims_torch.core.qt_fused import LAUNCH_COUNTERS
    fns = dict(A=ty.yukawa_forces_n3l_soa, C=ty.yukawa_forces_n3l_soa_batched,
               D=ty.yukawa_forces_potential_pallas,
               G=ty.yukawa_forces_potential_pallas_batched,
               E=ty.yukawa_forces_soa_cols_batched,
               F=ty.yukawa_forces_cross_n3l_soa_batched)
    out = {k: f.launches for k, f in fns.items()}
    out["B"] = sum(getattr(tf.fused_md_substeps, a) for a in LAUNCH_COUNTERS)
    return out


def _moved(before):
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


def test_fold_force_entry_with_per_member_mask_matches_twin(cuda):
    """Kernel C through the ``[E, N, 3]`` entry with a holed ``[E, N]``
    mask: one launch, the plain version's values, masked ions exactly 0."""
    E, n = 4, 1500
    L = PlasmaUnits.box_length(n)
    ldeb = PlasmaUnits(2.0, 0.1).debye_length
    g = torch.Generator(device=cuda).manual_seed(3)
    mask = (torch.rand((E, n), generator=g, device=cuda) > 0.05).float()
    mask[1, 1200:] = 0.0
    R = torch.rand((E, n, 3), generator=g, device=cuda) * L * mask[..., None]
    before = _counts()
    F = ty.yukawa_forces_n3l_pallas_batched(R, L, ldeb, mask=mask)
    assert _moved(before) == {"C": 1}
    ref = ty.yukawa_forces_n3l_pallas_batched(R.cpu(), L, ldeb,
                                              mask=mask.cpu())
    np.testing.assert_allclose(F.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=2e-5 * float(ref.abs().max()))
    assert not F[mask == 0].any()
    Fb, pot = ty.best_forces_fn_batched(n, L, ldeb, mask=mask)(R)
    assert pot is None and torch.equal(Fb, F)


@pytest.mark.parametrize("variant", ["422linear", "408linear"])
def test_frozen_tag_run_and_fold_on_the_card(cuda, variant, tmp_path):
    """A short job and a Poissonian fold of 3 at N0=600: the launch counts
    (A per MD step + 1 and D per block + 2; C and G likewise for the whole
    fold; the tick kernel once per MD step that pumps, no E or F), inert
    padded lanes through the results' shapes, the tree, and a resume."""
    from mdqtplasmasims_torch.experiments import frozen_tagging as ft
    cfg = ft.FrozenTagConfig(variant=variant, n0=600, tstart=0.02, tmax=0.1,
                             sample_freq=4, tpump_seconds=5e-8,
                             save_directory=str(tmp_path))
    n_md_a, n_md, segs, _ = ft._phase_b_plan(cfg)
    sched = ft.build_scheduler(cfg)
    pumps = sum(np.subtract(*sched.window(k * cfg.ratio, torch.float32)) < 0
                for k in range(n_md_a))
    assert pumps > 0
    before = _counts()
    final, res = ft.run(cfg, device="cuda")
    assert _moved(before) == {"A": n_md + 1, "D": len(segs) + 2, "B": pumps}
    assert 0.0 < res["spin_up"].mean() < 1.0
    assert np.isfinite(res["outs"]["energies"]).all()
    e = res["outs"]["energies"]
    assert np.abs(e[:, 4]).max() < 0.1 * e[-1, :3].sum()
    before = _counts()
    _, res2 = ft.run(dataclasses.replace(cfg, tmax=0.12), resume=True,
                     device="cuda")
    assert _moved(before) == {"A": 10, "D": len(res2["labels"])}
    fold_cfg = dataclasses.replace(cfg, exact_n=False, save_directory=None)
    before = _counts()
    results = ft.run_ensemble(fold_cfg, 3, seed=2, device="cuda")
    assert _moved(before) == {"C": n_md + 1, "G": len(segs) + 2, "B": pumps}
    assert len({r["n_ions"] for r in results}) > 1
    for r in results:
        assert r["final"].R.shape[0] == r["n_ions"]
        assert np.isfinite(r["outs"]["moments"]).all()
    # the same fold over two mesh slots of the card, bit for bit
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    four = ft.run_ensemble(fold_cfg, 4, seed=2, device="cuda")
    mesh = ft.run_ensemble(fold_cfg, 4, seed=2,
                           mesh=make_mesh(2, 1, devices=[cuda] * 2))
    for a, b in zip(four, mesh):
        np.testing.assert_array_equal(a["spin_up"], b["spin_up"])
        np.testing.assert_array_equal(a["final"].psi, b["final"].psi)
    with pytest.raises(NotImplementedError, match="float64"):
        ft.run(dataclasses.replace(cfg, dtype="float64"), device="cuda")


def test_three_state_on_the_card(cuda):
    """The toy's ticks are the tick kernel's S=3 launches, one per segment
    here; its identity sweep member equals the ensemble member bit for bit
    on the card too, float64 is refused there, and the tick does not depend
    on the TF32 switch."""
    from mdqtplasmasims_torch.experiments import three_state as ts
    cfg = ts.ThreeStateConfig(n0=500, tmax=4.0, sample_freq=200)
    before = _counts()
    res = ts.run(cfg, device="cuda")
    assert _moved(before) == {"B": 2}
    assert tf.fused_md_substeps.launches_s3 >= 2
    swept, _ = ts.run_sweep(cfg, [{"detuning": cfg.detuning, "om": cfg.om},
                                  {"detuning": -2.0, "om": 1.0}], seed=4,
                            device="cuda")
    ens = ts.run_ensemble(cfg, 1, seed=4, device="cuda")
    assert _moved(before) == {"B": 6}
    assert np.isfinite(res["ekin_x"]).all() and res["ekin_x"].shape == (2,)
    np.testing.assert_array_equal(swept["ekin_x"][0], ens["ekin_x"][0])
    np.testing.assert_array_equal(swept["V"][0], ens["V"][0])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        again = ts.run_ensemble(cfg, 1, seed=4, device="cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    np.testing.assert_array_equal(again["V"], ens["V"])
    with pytest.raises(NotImplementedError, match="float64"):
        ts.run(dataclasses.replace(cfg, dtype="float64"), device="cuda")


def test_member_sum_kernel_bits_do_not_depend_on_the_width(cuda):
    """A member's sum over its ions (ops/member_sum) has the same bits in
    folds of 1, 8, 33 and 99 members, with and without a mask, and lies
    within n * 2^-24 * sum |x| of a float64 sum; the float64 form within
    n * 2^-53 * sum |x|."""
    from mdqtplasmasims_torch.ops import member_sum as ms
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((99, NPAD), generator=g, device=cuda)
    m = (torch.rand((99, NPAD), generator=g, device=cuda) < 0.9).float()
    for mask in (None, m, m[0]):
        full = ms.member_sum(x, mask)
        for E in (1, 8, 33):
            part = ms.member_sum(x[:E], None if mask is None
                                 else mask if mask.dim() == 1 else mask[:E])
            assert torch.equal(part, full[:E])
        y = (x if mask is None else x * mask).double()
        err = (full.double() - y.sum(-1)).abs()
        assert (err <= NPAD * 2.0 ** -24 * y.abs().sum(-1)).all()
    d = ms.member_sum(x.double())
    exact = torch.tensor([float(np.sum(r, dtype=np.longdouble))
                          for r in x.double().cpu().numpy()],
                         dtype=torch.float64)
    assert ((d.cpu() - exact).abs()
            <= NPAD * 2.0 ** -53 * x.double().abs().sum(-1).cpu()).all()


# the KDE kernel against the plain [B, n] broadcast-and-reduce: every term
# has the same float32 value on both sides (the same expression, the same
# expf), and both sums of a bin's n non-negative terms lie within
# n * 2^-24 of their float64 sum (relative, the terms being >= 0); the
# normalisation rounds once more on each side
KDE_RTOL = 2 * (N + 1) * 2.0 ** -24
KDE_ROWS = 297                  # the 99-member fold's sample: E x 3 axes


def _kde_rows(dev, rows=KDE_ROWS, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    v = 0.05 + 0.3 * torch.randn((rows, N), generator=g, device=dev)
    w = (torch.rand((rows, N), generator=g, device=dev) < 0.9).float()
    return v, w


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("folded", [True, False],
                         ids=["folded2001", "centered4001"])
def test_kde_kernel_matches_the_plain_kde(cuda, folded, weighted):
    """[297, 3500] velocities onto the cooling code's 2001 folded bins and
    the tagging families' 4001 centered bins, with and without weights:
    one launch, within :data:`KDE_RTOL` of the plain version bin by bin
    (exact zeros where every term underflows), deterministic run to run."""
    from mdqtplasmasims_torch.ops import kde
    v, w = _kde_rows(cuda)
    bins = kde.folded_bins(device=cuda) if folded \
        else kde.centered_bins(device=cuda)
    w = w if weighted else None
    before = kde.gaussian_kde.launches
    got = kde.gaussian_kde(v, bins, folded=folded, weights=w)
    assert kde.gaussian_kde.launches == before + 1
    assert got.shape == (KDE_ROWS, bins.shape[0])
    assert torch.equal(kde.gaussian_kde(v, bins, folded=folded, weights=w),
                       got)
    for lo in range(0, KDE_ROWS, 33):        # the plain version's memory
        sl = slice(lo, lo + 33)
        want = kde.gaussian_kde_reference(
            v[sl], bins, folded=folded, weights=None if w is None else w[sl])
        err = (got[sl] - want).abs()
        assert (err <= KDE_RTOL * want.abs()).all(), float(err.max())
    assert (got > 0).any() and (got == 0).any()


def test_kde_kernel_bits_do_not_depend_on_the_width(cuda):
    """A row's bins have the same bits in a call of 297 rows, of 8 rows and
    alone, weighted or not, folded or not (an order fixed by n alone)."""
    from mdqtplasmasims_torch.ops import kde
    v, w = _kde_rows(cuda, seed=6)
    for folded, bins in ((True, kde.folded_bins(device=cuda)),
                         (False, kde.centered_bins(device=cuda))):
        for weights in (None, w):
            full = kde.gaussian_kde(v, bins, folded=folded, weights=weights)
            eight = kde.gaussian_kde(v[:8], bins, folded=folded,
                                     weights=None if weights is None
                                     else weights[:8])
            assert torch.equal(eight, full[:8])
            one = kde.gaussian_kde(v[5], bins, folded=folded,
                                   weights=None if weights is None
                                   else weights[5])
            assert torch.equal(one, full[5])


# CUDA operations of one sample of a 99-member pinned fold: kernel G with
# its packing and its sums, the kinetic energies' copies, sums and
# elementwise operations, the KDE's stack and launch, the populations' 12
# elementwise operations and stack, the outputs' copy and stack; 45 with
# torch 2.11 (the member loop took ~62 a member)
SAMPLE_E99_LAUNCHES = 48


def test_fold_sample_is_one_pass_on_the_card(cuda):
    """One sample of a 99 x 3500 fold: at most
    :data:`SAMPLE_E99_LAUNCHES` CUDA operations and no host-to-device copy
    (nothing the host waits for), and each member's sample that of a fold
    of 8 bit for bit."""
    from torch.profiler import ProfilerActivity, profile
    from mdqtplasmasims_torch.ops.kde import folded_bins
    cfg = lc.CoolingConfig()
    L = PlasmaUnits.box_length(cfg.n0)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    states = lc.member_states(cfg, 99, 7, cuda)
    g = torch.Generator(device=cuda).manual_seed(8)
    V = 0.3 * torch.randn(states.V.shape, generator=g, device=cuda)
    psi = torch.complex(torch.randn(states.psi.shape, generator=g,
                                    device=cuda),
                        torch.randn(states.psi.shape, generator=g,
                                    device=cuda)) / 12 ** 0.5
    mid = dataclasses.replace(states, V=V, psi=psi)
    bins = folded_bins(device=cuda)
    lc._sample_fold(mid, cfg, L, ldeb, bins, None, None)      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        full = lc._sample_fold(mid, cfg, L, ldeb, bins, None, None)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"{len(ops)} CUDA operations in one E=99 sample")
    assert 0 < len(ops) <= SAMPLE_E99_LAUNCHES, ops
    assert not any("HtoD" in o for o in ops), ops
    eight = dataclasses.replace(mid, **{f: getattr(mid, f)[:8] for f in (
        "R", "V", "F", "psi", "t_part")})
    part = lc._sample_fold(eight, cfg, L, ldeb, bins, None, None)
    for k, v in part.items():
        assert torch.equal(v, full[k][:8]), k
