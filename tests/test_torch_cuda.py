"""The port's CUDA kernels against their plain torch twins on the card.

Needs an NVIDIA GPU: every test carries the ``cuda`` marker and skips
without one.  This file imports no JAX, so it also runs on a machine
without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerances as in tests/test_torch_yukawa.py / test_torch_fused.py: forces
2e-5 of the largest |F|; ticks R/V/tp 2e-5, psi 5e-5 (+1e-4 relative),
pad rows and padded lanes exactly 0.  A lane whose jump test r0 < dp0
falls within float rounding of dp0 may be decided differently by the two
and then diverges; at most 2 such lanes of 3500 are allowed.  The full
flagship run is held to the JAX package's production physics bands.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.units import PlasmaUnits
from mdqtplasmasims_torch.core import qt_fused as tf
from mdqtplasmasims_torch.core.scheduler import uniform_rolls
from mdqtplasmasims_torch.experiments import laser_cooling as lc
from mdqtplasmasims_torch.ops import yukawa as ty

pytestmark = pytest.mark.cuda

N, NPAD = 3500, 3584            # the flagship lane layout


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
    sched = lc.build_scheduler(cfg, cuda, rolls_fn=None)
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
    (39 full + the split 1|24-tick step each) + 20 trailing steps."""
    cfg = lc.CoolingConfig(tmax=0.2, save_directory=str(tmp_path))
    a0 = ty.yukawa_forces_n3l_soa.launches
    b0 = tf.fused_md_substeps.launches
    final, res = lc.run(cfg, device="cuda")
    assert ty.yukawa_forces_n3l_soa.launches - a0 == 100
    assert tf.fused_md_substeps.launches - b0 == 2 * 41 + 20
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
    """The cooling soak's summary numbers (tools/soak.py:71-91)."""
    outs = res["outs"]
    t = np.asarray(outs["t"], np.float64)
    ekx = np.asarray(outs["ekin"], np.float64)[:, 0]
    early, late = t <= 8.0, t >= 25.0
    i_peak = int(np.argmax(ekx[early]))
    pops = np.abs(np.asarray(final.psi)) ** 2
    return dict(
        dih_peak_t=float(t[early][i_peak]),
        dih_peak_ekin_x=float(ekx[early][i_peak]),
        gamma_dih=float(1.0 / (2 * np.mean(ekx[(t > 6) & (t < 10)]))),
        cooling_ratio=float(np.mean(ekx[late]) / ekx[early][i_peak]),
        pop_s=float(pops[:, :2].sum(-1).mean()),
        pop_p=float(pops[:, 2:6].sum(-1).mean()),
        pop_d=float(pops[:, 6:].sum(-1).mean()))


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
