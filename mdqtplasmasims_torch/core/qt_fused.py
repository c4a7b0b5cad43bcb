"""One MD step's quantum-substepped ticks as one kernel launch.

Counterpart of ``mdqtplasmasims_tpu/core/qt_fused.py``.  The SpeedUp
scheme runs ``ratio`` quantum ticks between force refreshes; each tick is
a leapfrog substep with fixed forces, then the quantum update of every
ion: Doppler shift (+ expansion detuning), the beat-note phase, the jump
test, an RK step of the renormalized non-Hermitian propagator, the
Ehrenfest kick, the jump collapse with its recoil, and optional
renormalization.

Layout: R/V/F ``[3, Np]``, the per-ion clock ``[1, Np]``, psi as real and
imaginary ``[SP, Np]`` planes (S padded to a multiple of 8; pad rows and
padded lanes stay exactly zero), uniforms ``[n_ticks*5, Np]`` in [0, 1)
(explicit rolls), or none: with ``internal_rng`` the kernel draws them
itself from a counter-based stream keyed by the run's seed word and the
absolute tick (core/rng.py; the JAX kernel's ``internal_rng`` uses the
TPU's hardware PRNG instead, whose bits no other device reproduces).
The level-scheme tables ride as ``vecs [SP, 8]`` (decay weight, e0, e1,
jump-source mask) and ``mats [4*SP, SP]`` (coupling | cumulative S-branch
destinations^T | cumulative D-branch destinations^T | lower-triangular
ones), packed exactly as the JAX kernel packs them.

Sweep folds (ensemble members with different laser parameters in one
launch) use two per-lane variants: ``per_lane_e0`` takes the diagonal
energies from an ``[SP, Np]`` plane (detunings enter only through e0),
and ``per_lane_om`` scales two base coupling patterns, ``scheme_sp`` (om=1,
om_dp=0) and ``scheme_dp`` (om=0, om_dp=1), by an ``[2, Np]`` (om, om_dp)
plane; its tables gain a fifth ``[SP, SP]`` block (the DP pattern).

:func:`fused_md_substeps` launches ``csrc/fused_ticks.cu`` for CUDA
tensors and runs :func:`fused_md_substeps_reference`, the plain torch
twin, for CPU tensors.  At S = 12 the kernel gives each state of an ion
to one lane of a warp and reads H row by row: the host turns the packed
coupling block, the beat-note terms and the Ehrenfest terms into one
sparse row per state (:func:`coupling_rows`, the lane table of
:func:`_kernel_plan`), once per spec.  At S = 3, 5 and 7 one thread holds
a whole ion and takes the scheme's tables by value (:func:`ion_table`,
dense S x S blocks made from the same lane table), with the scheme's
coupling pattern compiled in (:data:`ION_PATTERNS`, :func:`ion_pattern`).
:func:`launch_geometry` says how the lanes are laid out.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..levels import LevelScheme
from .rng import tick_uniforms

# capacity of the kernel's parameter block (csrc/fused_ticks.cu)
_MAX_TDEP = 4
_MAX_FORCE = 16
_KERNEL_S = (3, 5, 7, 12)      # state counts csrc/fused_ticks.cu is built for
_RNG_S = 12                    # the in-kernel RNG forms are built for sr12 only
_THREADS = 128                 # threads of a block of the kernel
_KREG = 3                      # row entries a lane of the kernel keeps in
#                                registers; longer rows stay in shared memory
_ION_KERNEL_S = (3, 5, 7)      # the state counts whose kernel gives each ion
_ION_THREADS = 32              # one thread, in blocks of one warp
_ROLL_STAGES = 4               # ticks of rolls the ion kernel has in flight

#: the patterns compiled into the ion kernel (``ION_PATTERNS`` in
#: csrc/fused_ticks.cu, in its order): ``(name, S, mask)``, bit ``s * S +
#: c`` of the mask the place (s, c) of H's static and beat-note rows, bit
#: ``S * S + s`` state s decaying (a nonzero decay weight).  A spec takes
#: the first of its S that covers the scheme's (:func:`ion_pattern`); the
#: dense pattern last serves any other scheme.
ION_PATTERNS = (("dense", 3, 0xfff),
                ("tag422_linear", 5, 0x18008888),
                ("dense", 5, 0x3fffffff),
                ("tag408_quad", 7, 0x78001010001010),
                ("tag408_linear", 7, 0x78001010405414),
                ("dense", 7, 0xffffffffffffff))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class FusedTickSpec:
    """Constants of the fused tick block."""

    scheme: LevelScheme
    h: float                 # quantum tick in gamma time
    qdt: float               # quantum tick in plasma time
    plas_to_quant_vel: float
    gamma_to_einstein: float
    ratio: int               # ticks per launch
    L: float
    apply_force: bool
    # expanding-frame detuning c1*t/sqrt(1+c2*t^2) added to the Doppler
    # shift, from the tick counter (laserCoolingPlusExpansionMDQTSpeedUp.cpp
    # :447); zero coefficients disable it
    exp_c1: float = 0.0
    exp_c2: float = 0.0
    # explicit norm division after every tick (SpeedUp.cpp:706-712)
    renormalize: bool = False
    # draw the uniforms in the kernel (core/rng.py's stream) from a seed
    # word and the absolute tick, instead of reading explicit rolls
    internal_rng: bool = False
    # diagonal energies from a per-lane [SP, Np] plane (detuning sweeps)
    per_lane_e0: bool = False
    # per-lane Rabi frequencies: H = om*C_sp + om_dp*C_dp + diag exactly
    # (every coupling, beat-note coefficient and force weight is linear in
    # its Rabi frequency); the base patterns are the scheme built at
    # (om, om_dp) = (1, 0) and (0, 1), scaled by an [2, Np] lane plane
    per_lane_om: bool = False
    scheme_sp: LevelScheme = None
    scheme_dp: LevelScheme = None
    # the ion kernel's compiled coupling pattern (S = 3, 5, 7) by name: ""
    # takes the first that covers the scheme (:func:`ion_pattern`); a named
    # one must cover it too ("dense" always does: the same bits)
    coupling_pattern: str = ""

    @property
    def S(self) -> int:
        return self.scheme.n_states

    @property
    def SP(self) -> int:      # padded state count
        return _round_up(self.S, 8)


@functools.lru_cache(maxsize=64)
def empty_pattern(scheme: LevelScheme) -> LevelScheme:
    """``scheme`` without couplings, beat notes or Ehrenfest terms: the DP
    pattern of a scheme driven by one laser (made once per scheme)."""
    return dataclasses.replace(
        scheme, name=scheme.name + "_empty",
        coupling=np.zeros_like(scheme.coupling), tdep_rows=(), tdep_cols=(),
        tdep_coefs=(), force_a=(), force_b=(), force_w=())


def rabi_scaled(spec: FusedTickSpec) -> FusedTickSpec:
    """``spec``'s per-lane Rabi form for a scheme driven by one laser (the
    tagging and three-state schemes): the SP pattern is the scheme itself
    and the DP pattern empty, so the lanes' ``(om_j / om_base, 0)`` scale
    every coupling and Ehrenfest weight of the scheme (all linear in om),
    and a lane at scale 1 computes what ``spec`` computes bit for bit."""
    return dataclasses.replace(spec, per_lane_om=True, scheme_sp=spec.scheme,
                               scheme_dp=empty_pattern(spec.scheme))


def check_real_couplings(spec: FusedTickSpec) -> None:
    """The tick unrolls complex arithmetic assuming purely real coupling
    tables (true for all four reference schemes); fail loudly otherwise.
    Checks the scheme and, with ``per_lane_om``, both base patterns."""
    schemes = [spec.scheme]
    if spec.per_lane_om:
        if spec.scheme_sp is None or spec.scheme_dp is None:
            raise ValueError("spec.per_lane_om requires scheme_sp/scheme_dp "
                             "base patterns")
        schemes += [spec.scheme_sp, spec.scheme_dp]
    for scheme in schemes:
        if np.abs(np.asarray(scheme.coupling).imag).max() != 0.0:
            raise ValueError("fused kernel requires a real coupling matrix; "
                             f"scheme {scheme.name} has complex entries")
        if any(complex(m).imag != 0.0 for m in scheme.tdep_coefs):
            raise ValueError("fused kernel requires real tdep coefficients; "
                             f"scheme {scheme.name} has complex entries")


def _tdep_scheme(spec: FusedTickSpec) -> LevelScheme:
    """Source of the beat-note terms: with the om split they come from the
    om_dp=1 pattern, scaled per lane by om_dp."""
    return spec.scheme_dp if spec.per_lane_om else spec.scheme


def pack_tables(spec: FusedTickSpec, dtype=np.float32):
    """``(vecs [SP, 8], mats [n*SP, SP])`` numpy tables, packed as
    mdqtplasmasims_tpu/core/qt_fused.py:405-426 packs them (float32
    there; float64 here feeds the float64 twin).  ``n`` is 5 with
    ``per_lane_om`` (block 0 the SP pattern, block 4 the DP pattern),
    else 4 (block 0 the scheme's coupling)."""
    S, SP, sch = spec.S, spec.SP, spec.scheme
    vecs = np.zeros((SP, 8), dtype)
    vecs[:S, 0] = sch.decay_w
    vecs[:S, 1] = sch.e0
    vecs[:S, 2] = sch.e1
    for s in sch.jump_src:
        vecs[s, 3] = 1.0
    mats = np.zeros(((5 if spec.per_lane_om else 4) * SP, SP), dtype)
    mats[:S, :S] = (spec.scheme_sp if spec.per_lane_om
                    else sch).coupling.real
    if spec.per_lane_om:
        mats[4 * SP:4 * SP + S, :S] = spec.scheme_dp.coupling.real
    # destination-cumulative tables, padded DEST rows saturated to 1 so a
    # uniform roll (< 1) never counts them in the categorical comparison
    mats[SP:2 * SP, :] = 1.0
    mats[2 * SP:3 * SP, :] = 1.0
    mats[SP:SP + S, :S] = np.cumsum(sch.jump_dest[:, 0, :], -1).T
    mats[2 * SP:2 * SP + S, :S] = np.cumsum(sch.jump_dest[:, 1, :], -1).T
    mats[3 * SP:4 * SP, :] = np.tril(np.ones((SP, SP), dtype))
    return vecs, mats


class FusedTables(NamedTuple):
    vecs: torch.Tensor       # [SP, 8]
    mats: torch.Tensor       # [4*SP, SP] ([5*SP, SP] with per_lane_om)


def fused_tables(spec: FusedTickSpec, device,
                 dtype=torch.float32) -> FusedTables:
    """The packed tables on ``device`` (made once per run: a host-to-device
    copy per MD step would stall the loop)."""
    check_real_couplings(spec)
    vecs, mats = pack_tables(
        spec, np.float64 if dtype == torch.float64 else np.float32)
    return FusedTables(torch.as_tensor(vecs).to(device),
                       torch.as_tensor(mats).to(device))


def fused_md_substeps_reference(spec: FusedTickSpec, first: bool,
                                R, V, F, tp, psi_re, psi_im, rolls,
                                tables: FusedTables, tick0: int = 0,
                                e0_lanes=None, om_lanes=None, seed=None,
                                lane0: int = 0):
    """Plain torch twin of the fused kernel: ``spec.ratio`` ticks on the
    planes, with the JAX kernel's arithmetic (core/qt_fused.py:155-343 of
    the JAX package) in the planes' dtype.  ``e0_lanes [SP, Np]`` and
    ``om_lanes [2, Np]`` feed the per-lane variants.  With
    ``spec.internal_rng`` the uniforms are the kernel's own stream for the
    seed word ``seed [1]`` on global lanes from ``lane0`` (``rolls`` is
    ignored).  Returns new ``(R, V, tp, psi_re, psi_im)``."""
    if spec.internal_rng:
        rolls = tick_uniforms(int(seed[0]), tick0, spec.ratio, R.shape[-1],
                              R.device, lane0).to(R.dtype)
    S, SP = spec.S, spec.SP
    sch = spec.scheme
    tsch = _tdep_scheme(spec)
    h, qdt, L = spec.h, spec.qdt, spec.L
    vecs, mats = tables
    w_c, e0_c, e1_c, mask_c = (vecs[:, k:k + 1] for k in range(4))
    # diagonal energies: the per-lane plane (detuning sweep) or the
    # scheme's shared column, the same broadcast either way
    e0_b = e0_lanes if spec.per_lane_e0 else e0_c
    C = mats[0:SP]
    cumS_T, cumD_T = mats[SP:2 * SP], mats[2 * SP:3 * SP]
    if spec.per_lane_om:
        Cdp = mats[4 * SP:5 * SP]
        om_r, omdp_r = om_lanes[0:1], om_lanes[1:2]
        # force terms are linear in their Rabi frequency by group
        groups = ((spec.scheme_sp, om_r), (spec.scheme_dp, omdp_r))
    else:
        groups = ((sch, None),)
    rows = torch.arange(SP, device=R.device)[:, None]
    half = 0.5 * qdt
    a, b = psi_re, psi_im

    def hpsi(a, b, u, cphi, sphi):
        diag_r = e0_b + e1_c * u
        if spec.per_lane_om:
            hr_a = om_r * (C @ a) + omdp_r * (Cdp @ a) + diag_r * a
            hr_b = om_r * (C @ b) + omdp_r * (Cdp @ b) + diag_r * b
        else:
            hr_a = C @ a + diag_r * a
            hr_b = C @ b + diag_r * b
        re = hr_a - (-0.5 * w_c) * b
        im = hr_b + (-0.5 * w_c) * a
        if tsch.tdep_rows:
            re, im = re.clone(), im.clone()
            for r, cl, m in zip(tsch.tdep_rows, tsch.tdep_cols,
                                tsch.tdep_coefs):
                mr = complex(m).real
                if spec.per_lane_om:
                    mr = omdp_r * mr
                # H[r,cl] = m e^{i phi}; H[cl,r] = m e^{-i phi}
                ar, br = a[r:r + 1], b[r:r + 1]
                ac, bc = a[cl:cl + 1], b[cl:cl + 1]
                re[r:r + 1] += mr * (cphi * ac - sphi * bc)
                im[r:r + 1] += mr * (cphi * bc + sphi * ac)
                re[cl:cl + 1] += mr * (cphi * ar + sphi * br)
                im[cl:cl + 1] += mr * (cphi * br - sphi * ar)
        return re, im

    def dp_of(a, b):
        return h * torch.sum(w_c * (a * a + b * b), dim=0, keepdim=True)

    def g_slope(a, b, u, cphi, sphi):
        pref = torch.rsqrt(1.0 - torch.clamp(dp_of(a, b), 0.0, 0.9))
        hre, him = hpsi(a, b, u, cphi, sphi)
        return ((pref * (a + h * him) - a) / h,
                (pref * (b - h * hre) - b) / h)

    for i in range(spec.ratio):
        # ---- leapfrog substep (forces fixed); the 2nd-order first drift
        # only on the run's first tick
        fs = 1.0 if (first and i == 0) else 0.0
        R = R + half * V + fs * half * half * F
        R = torch.where(R < 0, R + L, R)
        R = torch.where(R > L, R - L, R)
        V = V + qdt * F
        R = R + half * V + fs * half * half * F
        R = torch.where(R < 0, R + L, R)
        R = torch.where(R > L, R - L, R)

        # ---- quantum tick: the clock advances before the beat note ----
        tp = tp + qdt
        u = V[0:1] * spec.plas_to_quant_vel
        if spec.exp_c1:
            # expansion detuning at the tick's entry time (tick0+i)*qdt
            tpl = float(np.float32(tick0 + i)) * qdt
            u = u + (spec.exp_c1 * tpl
                     / math.sqrt(1.0 + spec.exp_c2 * tpl * tpl))
        if tsch.tdep_rows:
            ang = (tsch.tdep_freq * u) * (tp * spec.gamma_to_einstein)
            cphi, sphi = torch.cos(ang), torch.sin(ang)
        else:
            cphi = sphi = None
        r0, r1, r2, r3, r4 = (rolls[i * 5 + k:i * 5 + k + 1]
                              for k in range(5))

        jumped = r0 < dp_of(a, b)         # unclipped dp, strict <
        k1a, k1b = g_slope(a, b, u, cphi, sphi)
        k2a, k2b = g_slope(a + 0.5 * h * k1a, b + 0.5 * h * k1b,
                           u, cphi, sphi)
        k3a, k3b = g_slope(a + 0.5 * h * k2a, b + 0.5 * h * k2b,
                           u, cphi, sphi)
        k4a, k4b = g_slope(a + h * k3a, b + h * k3b, u, cphi, sphi)
        ae = a + (k1a + 3 * k2a + 3 * k3a + k4a) * (h / 8)
        be = b + (k1b + 3 * k2b + 3 * k3b + k4b) * (h / 8)

        # Ehrenfest kick from the tick's initial amplitudes:
        # Im(psi_a conj(psi_b)) = b_a a_b - a_a b_b
        kick_nj = torch.zeros_like(tp)
        for gsch, scale in groups:
            acc = torch.zeros_like(tp)
            for fa, fb, fw in zip(gsch.force_a, gsch.force_b,
                                  gsch.force_w):
                if fw == 0.0:          # the om splits zero the other group
                    continue
                acc = acc + fw * (b[fa:fa + 1] * a[fb:fb + 1]
                                  - a[fa:fa + 1] * b[fb:fb + 1])
            kick_nj = kick_nj + (acc if scale is None else scale * acc)
        kick_nj = kick_nj * h

        # ---- jump collapse ----
        src_cum = torch.cumsum((a * a + b * b) * mask_c, dim=0)
        tot = torch.clamp(src_cum[SP - 1:SP], min=1e-30)
        src = torch.clamp(torch.sum((r1 * tot >= src_cum).to(torch.int64),
                                    dim=0), max=S - 1)
        d_branch = r2 < sch.branch_d_prob
        dest_cum = torch.where(d_branch, cumD_T[:, src], cumS_T[:, src])
        dest = torch.clamp(torch.sum((r4 >= dest_cum).to(torch.int64),
                                     dim=0, keepdim=True), max=S - 1)
        a_j = (rows == dest).to(a.dtype)
        sign = torch.where(r3 < 0.5, 1.0, -1.0).to(a.dtype)
        kick_j = sign * torch.where(d_branch, torch.full_like(tp, sch.kick_d),
                                    torch.full_like(tp, sch.kick_s))
        if not sch.apply_recoil:
            kick_j = torch.zeros_like(kick_j)

        a = torch.where(jumped, a_j, ae)
        b = torch.where(jumped, torch.zeros_like(be), be)
        tp = torch.where(jumped, torch.zeros_like(tp), tp)
        if spec.renormalize:
            # guarded so pad lanes (norm 0) stay exactly zero
            nrm = torch.sqrt(torch.sum(a * a + b * b, dim=0, keepdim=True))
            inv = torch.where(nrm > 0.0, 1.0 / nrm, torch.zeros_like(nrm))
            a = a * inv
            b = b * inv
        if spec.apply_force and sch.has_force:
            V = torch.cat([V[0:1] + torch.where(jumped, kick_j, kick_nj),
                           V[1:3]])
    return R, V, tp, a, b


class _Params(ctypes.Structure):
    """Mirror of ``struct FusedParams`` in csrc/fused_ticks.cu."""
    _fields_ = ([(k, ctypes.c_int) for k in (
        "S", "SP", "n_ticks", "n_tdep", "n_force", "apply_kick",
        "apply_recoil", "renormalize", "has_exp", "per_lane_e0",
        "per_lane_om", "internal_rng")]
        + [(k, ctypes.c_float) for k in (
            "h", "half_h", "h8", "qdt", "half_qdt", "p2q", "g2e", "L",
            "exp_c1", "exp_c2", "tdep_freq", "branch_d", "kick_s",
            "kick_d")]
        + [("tdep_row", ctypes.c_int * _MAX_TDEP),
           ("tdep_col", ctypes.c_int * _MAX_TDEP),
           ("tdep_coef", ctypes.c_float * _MAX_TDEP),
           ("force_a", ctypes.c_int * _MAX_FORCE),
           ("force_b", ctypes.c_int * _MAX_FORCE),
           ("force_g", ctypes.c_int * _MAX_FORCE),
           ("force_w", ctypes.c_float * _MAX_FORCE)])


def _force_terms(spec: FusedTickSpec):
    """``(a, b, w, group)`` of every nonzero Ehrenfest force term: group 0
    is scaled by om, group 1 by om_dp (only with ``per_lane_om``; without
    it every term is in group 0 and unscaled)."""
    groups = ((spec.scheme_sp, spec.scheme_dp) if spec.per_lane_om
              else (spec.scheme,))
    return [(a, b, w, g) for g, sch in enumerate(groups)
            for a, b, w in zip(sch.force_a, sch.force_b, sch.force_w)
            if w != 0.0]


@functools.lru_cache(maxsize=64)
def _kernel_params(spec: FusedTickSpec) -> _Params:
    """The spec's constants as the kernel's parameter block.  Each float
    is the f32 rounding of the double the JAX kernel folds in
    (``jnp.float32(0.5 * qdt)`` etc.), so both kernels see equal
    constants."""
    sch, tsch = spec.scheme, _tdep_scheme(spec)
    if spec.S not in _KERNEL_S:
        raise ValueError(f"the CUDA tick kernel is built for S in "
                         f"{_KERNEL_S}, got {spec.S}")
    if spec.internal_rng and spec.S != _RNG_S:
        raise ValueError(f"the in-kernel RNG tick kernels are built for "
                         f"S={_RNG_S} only, got {spec.S}")
    forces = _force_terms(spec)
    if len(tsch.tdep_rows) > _MAX_TDEP or len(forces) > _MAX_FORCE:
        raise ValueError("scheme exceeds the tick kernel's term capacity")
    p = _Params(
        S=spec.S, SP=spec.SP, n_ticks=spec.ratio, n_tdep=len(tsch.tdep_rows),
        n_force=len(forces),
        apply_kick=int(spec.apply_force and sch.has_force),
        apply_recoil=int(sch.apply_recoil),
        renormalize=int(spec.renormalize), has_exp=int(spec.exp_c1 != 0.0),
        per_lane_e0=int(spec.per_lane_e0), per_lane_om=int(spec.per_lane_om),
        internal_rng=int(spec.internal_rng), h=spec.h, half_h=0.5 * spec.h,
        h8=spec.h / 8, qdt=spec.qdt, half_qdt=0.5 * spec.qdt,
        p2q=spec.plas_to_quant_vel, g2e=spec.gamma_to_einstein, L=spec.L,
        exp_c1=spec.exp_c1, exp_c2=spec.exp_c2, tdep_freq=tsch.tdep_freq,
        branch_d=sch.branch_d_prob, kick_s=sch.kick_s, kick_d=sch.kick_d)
    for k, (r, c, m) in enumerate(zip(tsch.tdep_rows, tsch.tdep_cols,
                                      tsch.tdep_coefs)):
        p.tdep_row[k], p.tdep_col[k], p.tdep_coef[k] = r, c, complex(m).real
    for k, (a, b, w, g) in enumerate(forces):
        p.force_a[k], p.force_b[k], p.force_w[k], p.force_g[k] = a, b, w, g
    return p


def coupling_rows(*blocks, extra=()):
    """Sparse rows of real coupling blocks that share one pattern.

    ``blocks`` are ``[rows, cols]`` arrays (one block, or the om split's
    C_sp and C_dp).  Returns ``(cols [rows, K] int32, coefs [len(blocks),
    rows, K])``: for row s the columns where any block is nonzero, in
    ascending order, and each block's entries there; K is the largest row
    count (at least 1) and shorter rows are padded with ``(s, 0.0)``.
    ``extra`` lists ``(row, column)`` places that belong to the pattern
    whatever the blocks hold there.  Summing ``coefs[j, s, k] * x[cols[s,
    k]]`` over k is block j's dense row sum with its zero terms left out.
    A block with a nonzero imaginary part is refused."""
    real = []
    for blk in blocks:
        blk = np.asarray(blk)
        if np.iscomplexobj(blk):
            if np.abs(blk.imag).max(initial=0.0) != 0.0:
                raise ValueError("the tick kernel needs a real coupling "
                                 "table; got complex entries")
            blk = blk.real
        real.append(blk)
    n_rows = real[0].shape[0]
    pattern = np.zeros(real[0].shape, bool)
    for blk in real:
        pattern |= blk != 0
    for r, c in extra:
        pattern[r, c] = True
    K = max(1, int(pattern.sum(1).max(initial=0)))
    cols = np.repeat(np.arange(n_rows, dtype=np.int32)[:, None], K, 1)
    coefs = np.zeros((len(real), n_rows, K), real[0].dtype)
    for s in range(n_rows):
        nz = np.flatnonzero(pattern[s])
        cols[s, :len(nz)] = nz
        for j, blk in enumerate(real):
            coefs[j, s, :len(nz)] = blk[s, nz]
    return cols, coefs


# planes of a lane-table row, K floats each (csrc/fused_ticks.cu)
ROW_PLANES = ("col", "c_sp", "c_dp", "tdep_m", "tdep_m_signed", "force_w",
              "force_group")


def lane_table_width(K: int) -> int:
    """Floats of a lane-table row: :data:`ROW_PLANES` of K entries."""
    return len(ROW_PLANES) * K


class LaunchGeometry(NamedTuple):
    lanes_per_ion: int       # lanes of a warp that own one ion (1: a thread)
    threads: int             # per block
    blocks: int
    shared_bytes: int        # dynamic shared memory per block


def launch_geometry(npad: int, S: int, K: int) -> LaunchGeometry:
    """How csrc/fused_ticks.cu is launched over ``npad`` lanes of an
    ``S``-state scheme whose longest coupling row has ``K`` entries.  At
    S = 3, 5, 7 one thread an ion in blocks of 32 threads (1000 ions: one
    warp on each of 32 SMs; 3584 lanes 112 blocks) and shared memory for a
    ring of four ticks' rolls.  At S = 12 a group of 16 lanes per ion (one
    state a lane), 128 threads a block, and shared memory for the two
    ``[SP, SP]`` destination tables plus, for rows too long for a lane's
    registers, the lane table."""
    if S in _ION_KERNEL_S:
        return LaunchGeometry(1, _ION_THREADS, npad // _ION_THREADS,
                              4 * _ROLL_STAGES * 5 * _ION_THREADS)
    G = 16                     # S = 12
    SP = _round_up(S, 8)
    rows = SP * lane_table_width(K) if K > _KREG else 0
    return LaunchGeometry(G, _THREADS, npad // (_THREADS // G),
                          4 * (2 * SP * SP + rows))


class KernelPlan(NamedTuple):
    """What a launch needs of a spec, made once per spec."""
    params: _Params
    K: int                   # entries of the longest coupling row
    lane_table: np.ndarray   # [SP, lane_table_width(K)] float32
    ion_table: np.ndarray    # [ion_table_width(S)] float32 at S = 3, 5, 7,
    #                          else None
    pattern: int             # the ion kernel's pattern mask, else 0


#: fields of the ion kernel's by-value tables (``IonTables`` in
#: csrc/fused_ticks.cu), in order, with their shapes: per state the decay
#: weight, e0, e1 and jump mask; ``[row, column]`` the static coupling (the
#: lane table's c_sp and c_dp planes), the beat-note m and m times its
#: phase sign; per state pair (s < c) in the order (0, 1), (0, 2), ...,
#: (S - 2, S - 1) the weight W of an Ehrenfest term W Im(psi_s
#: conj(psi_c)) and its group; ``[src, dest]`` the cumulative destination
#: tables of the S and D branch
ION_FIELDS = (("w", "S"), ("e0", "S"), ("e1", "S"), ("msk", "S"),
              ("c_sp", "SS"), ("c_dp", "SS"), ("tdep_m", "SS"),
              ("tdep_m_signed", "SS"), ("pair_w", "P"), ("pair_g", "P"),
              ("cum_s", "SS"), ("cum_d", "SS"))


def _ion_field_shape(code: str, S: int) -> tuple:
    return {"S": (S,), "SS": (S, S), "P": (S * (S - 1) // 2,)}[code]


def ion_table_width(S: int) -> int:
    """Floats of the ion kernel's tables (:data:`ION_FIELDS`)."""
    return sum(int(np.prod(_ion_field_shape(c, S))) for _, c in ION_FIELDS)


def ion_fields(table: np.ndarray, S: int) -> dict:
    """:data:`ION_FIELDS` of a flat ion table, by name."""
    out, at = {}, 0
    for name, code in ION_FIELDS:
        shape = _ion_field_shape(code, S)
        size = int(np.prod(shape))
        out[name] = table[at:at + size].reshape(shape)
        at += size
    return out


def ion_table(spec: FusedTickSpec, lane_table: np.ndarray,
              K: int) -> np.ndarray:
    """The ion kernel's tables (:data:`ION_FIELDS`, float32) of ``spec``:
    the packed vectors and destination tables, and the lane table's rows
    scattered into dense ``[S, S]`` blocks by their columns (padding
    entries hold zeros).  A pair's Ehrenfest weight is its entry on (s, c)
    minus its entry on (c, s), the two of one group
    (:func:`_kernel_plan` refuses two groups on one pair)."""
    S, SP = spec.S, spec.SP
    vecs, mats = pack_tables(spec)
    rows = lane_table.reshape(SP, len(ROW_PLANES), K)
    dense = np.zeros((len(ROW_PLANES) - 1, S, S), np.float32)
    for s in range(S):
        for k in range(K):
            c = int(rows[s, 0, k])
            if c >= S:
                raise ValueError(f"row {s} of the lane table reaches column "
                                 f"{c} of an {S}-state scheme")
            dense[:, s, c] += rows[s, 1:, k]
    fw, fg = dense[4], dense[5]
    pairs = [(s, c) for s in range(S) for c in range(s + 1, S)]
    pair_w = np.array([fw[s, c] - fw[c, s] for s, c in pairs], np.float32)
    pair_g = np.array([max(fg[s, c], fg[c, s]) for s, c in pairs],
                      np.float32)
    fields = dict(w=vecs[:S, 0], e0=vecs[:S, 1], e1=vecs[:S, 2],
                  msk=vecs[:S, 3], c_sp=dense[0], c_dp=dense[1],
                  tdep_m=dense[2], tdep_m_signed=dense[3], pair_w=pair_w,
                  pair_g=pair_g,
                  # mats blocks 1 and 2 are [dest, src]
                  cum_s=mats[SP:SP + S, :S].T, cum_d=mats[2 * SP:2 * SP + S,
                                                          :S].T)
    table = np.concatenate([np.asarray(fields[name], np.float32).ravel()
                            for name, _ in ION_FIELDS])
    assert table.shape == (ion_table_width(S),)
    return np.ascontiguousarray(table)


def pattern_mask(places, S: int, decaying=()) -> int:
    """The mask of a set of ``(row, column)`` places (bit ``s * S + c``) and
    of the decaying states (bit ``S * S + s``)."""
    return (sum(1 << (r * S + c) for r, c in set(places))
            + sum(1 << (S * S + s) for s in set(decaying)))


def ion_pattern(spec: FusedTickSpec, places) -> tuple:
    """``(name, mask)`` of the compiled pattern (:data:`ION_PATTERNS`) that
    ``spec`` launches with, ``places`` its scheme's (row, column) places:
    the one ``spec.coupling_pattern`` names, or the first of its S that
    covers them and the scheme's decaying states.  Refuses a named
    pattern that does not cover them."""
    decaying = np.flatnonzero(pack_tables(spec)[0][:spec.S, 0])
    want = pattern_mask(places, spec.S, decaying)
    for name, S, mask in ION_PATTERNS:
        if S != spec.S or spec.coupling_pattern not in ("", name):
            continue
        if want & ~mask == 0:
            return name, mask
    raise ValueError(f"no compiled coupling pattern {spec.coupling_pattern!r}"
                     f" of S={spec.S} covers the places {sorted(places)} and "
                     f"decaying states {list(decaying)} of scheme "
                     f"{spec.scheme.name}")


@functools.lru_cache(maxsize=64)
def _kernel_plan(spec: FusedTickSpec) -> KernelPlan:
    """The parameter block and the lane table of ``spec``.  Row s of the
    table is state s's row of H as K entries (:data:`ROW_PLANES`): the
    column c and the static coupling there (:func:`coupling_rows` of the
    packed table; with ``per_lane_om`` the SP and DP patterns on their
    merged columns); for a beat-note term on the pair, its coefficient m
    and m times the sign of the phase (H[r,c] = m e^{i phi}, H[c,r] = m
    e^{-i phi}); and the weight and group of an Ehrenfest term w Im(psi_a
    conj(psi_b)) on the pair, held by lane a against column b, or by lane
    b against column a with -w where only that place is in the pattern."""
    check_real_couplings(spec)
    params = _kernel_params(spec)
    SP = spec.SP
    _, mats = pack_tables(spec)
    blocks = [mats[:SP]]
    if spec.per_lane_om:
        blocks.append(mats[4 * SP:5 * SP])
    tdep = [(params.tdep_row[t], params.tdep_col[t], params.tdep_coef[t])
            for t in range(params.n_tdep)]
    forces = [(params.force_a[k], params.force_b[k], params.force_w[k],
               params.force_g[k]) for k in range(params.n_force)]
    places = {(int(r), int(c)) for blk in blocks
              for r, c in zip(*np.nonzero(blk))}
    places |= {pair for r, c, _ in tdep for pair in ((r, c), (c, r))}
    places |= {(a, b) for a, b, _, _ in forces
               if (a, b) not in places and (b, a) not in places}
    cols, coefs = coupling_rows(*blocks, extra=places)
    K = cols.shape[1]
    tab = np.zeros((SP, len(ROW_PLANES), K), np.float32)
    tab[:, 0] = cols
    tab[:, 1:1 + len(coefs)] = coefs.transpose(1, 0, 2)

    def entry(row, col):
        return row, slice(None), int(np.flatnonzero(cols[row] == col)[0])
    for r, c, m in tdep:
        tab[entry(r, c)][3:5] += (m, m)
        tab[entry(c, r)][3:5] += (m, -m)
    for a, b, w, g in forces:
        at, w = (entry(a, b), w) if b in cols[a] else (entry(b, a), -w)
        if tab[at][5] != 0.0 and tab[at][6] != g:
            raise ValueError("two Ehrenfest terms of different groups on "
                             f"the states ({a}, {b})")
        tab[at][5] += w
        tab[at][6] = g
    tab = tab.reshape(SP, -1)
    if spec.S not in _ION_KERNEL_S:
        return KernelPlan(params, K, tab, None, 0)
    return KernelPlan(params, K, tab, ion_table(spec, tab, K),
                      ion_pattern(spec, places)[1])


@functools.lru_cache(maxsize=64)
def _lane_table_on(spec: FusedTickSpec, device: torch.device):
    """The spec's lane table on ``device`` (one copy per spec and card)."""
    return torch.as_tensor(_kernel_plan(spec).lane_table).to(device)


# a spec is checked once: a failed check raises every time (lru_cache keeps
# no exception), a passed one is remembered
_checked = functools.lru_cache(maxsize=64)(check_real_couplings)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ticks")
    v, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_uint)
    lib.fused_ticks_launch.argtypes = ([v] * 14 + [i, v, ctypes.c_ulonglong]
                                       + [v] * 5 + [i, f, f, u, u, i, i, v])
    lib.fused_ticks_launch.restype = ctypes.c_int
    return lib


def fused_md_substeps(spec: FusedTickSpec, first: bool, R, V, F, tp,
                      psi_re, psi_im, rolls=None, tick0: int = 0,
                      tables: FusedTables = None, e0_lanes=None,
                      om_lanes=None, seed=None, lane0: int = 0):
    """One MD step's worth of quantum-substepped ticks.

    Shapes: R/V/F [3, Np], tp [1, Np], psi planes [SP, Np], rolls
    [spec.ratio*5, Np] uniforms in [0, 1).  ``first`` selects the
    reference's 2nd-order first drift (tick 0 of the run); ``tick0`` is
    the absolute run tick at entry (the expansion detuning's clock, and
    with ``internal_rng`` the stream's counter).  ``tables`` are
    :func:`fused_tables` (packed here when omitted).  ``e0_lanes [SP,
    Np]`` is required with ``spec.per_lane_e0`` and ``om_lanes [2, Np]``
    with ``spec.per_lane_om`` (and refused without).  With
    ``spec.internal_rng`` the run's seed word ``seed`` (a ``[1]`` int32
    tensor on R's device, read by the kernel through its pointer: no host
    sync) replaces ``rolls``; each is refused where the other is due.
    ``lane0`` (RNG form only) is the global lane of lane 0: a mesh slot
    draws the stream of the lanes it holds in its fold (core/rng.py).
    Returns new ``(R, V, tp, psi_re, psi_im)``.

    CUDA tensors (float32, contiguous, Np a multiple of 128) launch
    ``csrc/fused_ticks.cu`` and count the launch in the one counter of
    its form: ``fused_md_substeps.launches`` for explicit rolls and
    ``launches_rng`` for the in-kernel RNG, ``_s3``, ``_s5`` or ``_s7``
    added for a small scheme, each with the suffix ``_per_lane_e0``,
    ``_per_lane_om`` or ``_per_lane_e0_om`` for a per-lane variant
    (:data:`LAUNCH_COUNTERS`, :func:`launch_counter`).  The kernel's five
    outputs are row blocks of one allocation.  The spec's coupling check,
    parameter block and lane table are made once per spec (and card).  At
    S = 3, 5, 7 the kernel takes the scheme's tables by value from the
    spec's plan (:func:`ion_table`, packed as :func:`fused_tables` packs
    ``tables``) and the form of its coupling pattern (:func:`ion_pattern`;
    one launch counter for every pattern).  CPU tensors run
    :func:`fused_md_substeps_reference`."""
    _checked(spec)
    SP = spec.SP
    npad = R.shape[-1]
    want = {"R": (3, npad), "V": (3, npad), "F": (3, npad), "tp": (1, npad),
            "psi_re": (SP, npad), "psi_im": (SP, npad)}
    args = {"R": R, "V": V, "F": F, "tp": tp, "psi_re": psi_re,
            "psi_im": psi_im}
    for name, flag, x, shape in (
            ("rolls", not spec.internal_rng, rolls, (spec.ratio * 5, npad)),
            ("e0_lanes", spec.per_lane_e0, e0_lanes, (SP, npad)),
            ("om_lanes", spec.per_lane_om, om_lanes, (2, npad))):
        if flag != (x is not None):
            why = ("spec.internal_rng is unset" if name == "rolls"
                   else f"spec.per_lane_{name[:2]} is set")
            raise ValueError(f"{name} must be given exactly when {why} "
                             f"(the condition is {flag})")
        if flag:
            want[name], args[name] = shape, x
    for k, x in args.items():
        if tuple(x.shape) != want[k]:
            raise ValueError(f"{k} must be {list(want[k])}, got "
                             f"{list(x.shape)}")
        if x.device != R.device or x.dtype != R.dtype:
            raise ValueError(f"{k} must share R's device and dtype")
    if spec.internal_rng != (seed is not None):
        raise ValueError("seed must be given exactly when spec.internal_rng "
                         f"is set (it is {spec.internal_rng})")
    if lane0 and not spec.internal_rng:
        raise ValueError("lane0 numbers the in-kernel RNG's lanes; explicit "
                         "rolls are sliced by the caller instead")
    if not 0 <= lane0 < 2 ** 32:
        raise ValueError(f"lane0={lane0} outside the kernel's uint32 lanes")
    if seed is not None and (tuple(seed.shape) != (1,)
                             or seed.dtype != torch.int32
                             or seed.device != R.device):
        raise ValueError("seed must be a [1] int32 tensor on R's device")
    if tables is None:
        tables = fused_tables(spec, R.device, R.dtype)
    if R.device.type == "cpu":
        return fused_md_substeps_reference(spec, first, R, V, F, tp, psi_re,
                                           psi_im, rolls, tables, tick0,
                                           e0_lanes, om_lanes, seed, lane0)
    if R.device.type != "cuda":
        raise ValueError(f"no tick kernel for device {R.device}")
    if R.dtype != torch.float32:
        raise ValueError(f"the CUDA tick kernel is float32, got {R.dtype}")
    if npad % 128:
        raise ValueError(f"Np={npad} must be a multiple of 128")
    if not 0 <= tick0 < 2 ** 32:
        raise ValueError(f"tick0={tick0} outside the kernel's uint32 clock")
    tabs = (tables.vecs, tables.mats)
    if any(not x.is_contiguous() for x in (*args.values(), *tabs)):
        raise ValueError("fused_md_substeps needs contiguous tensors")
    if any(t.device != R.device or t.dtype != torch.float32 for t in tabs):
        raise ValueError("tables must be float32 on R's device")
    if tables.mats.shape[0] != (5 if spec.per_lane_om else 4) * SP:
        raise ValueError("tables were packed for another per_lane_om flag")
    plan = _kernel_plan(spec)
    lane_table = _lane_table_on(spec, R.device)
    geo = launch_geometry(npad, spec.S, plan.K)
    out = torch.empty((7 + 2 * SP, npad), dtype=R.dtype, device=R.device)
    outs = (out[0:3], out[3:6], out[6:7], out[7:7 + SP], out[7 + SP:])
    ptrs = [None if x is None else x.data_ptr()
            for x in (rolls, seed, e0_lanes, om_lanes)]
    lib = _lib()
    with _build.device_guard(R.device):
        err = lib.fused_ticks_launch(
            ctypes.addressof(plan.params),
            *(x.data_ptr() for x in (R, V, F, tp, psi_re, psi_im)),
            *ptrs, *(x.data_ptr() for x in tabs), lane_table.data_ptr(),
            plan.K, None if plan.ion_table is None
            else plan.ion_table.ctypes.data, plan.pattern,
            *(x.data_ptr() for x in outs),
            npad, 1.0 if first else 0.0, float(tick0), int(tick0),
            int(lane0), geo.blocks, geo.shared_bytes,
            _build.raw_stream(R.device))
    _build.check(lib, err, "fused_ticks_launch")
    name = launch_counter(spec)
    setattr(fused_md_substeps, name, getattr(fused_md_substeps, name) + 1)
    return outs


def launch_counter(spec: FusedTickSpec) -> str:
    """The attribute of :func:`fused_md_substeps` counting the launches of
    ``spec``'s kernel form: ``launches[_rng][_s<S>][_per_lane_..]``, the
    state count named for the small schemes (S = 3, 5, 7)."""
    lanes = "".join(f for f, on in (("_e0", spec.per_lane_e0),
                                    ("_om", spec.per_lane_om)) if on)
    return ("launches" + ("_rng" if spec.internal_rng else "")
            + ("" if spec.S == _RNG_S else f"_s{spec.S}")
            + ("_per_lane" + lanes if lanes else ""))


_LANE_FORMS = ("", "_per_lane_e0", "_per_lane_om", "_per_lane_e0_om")
#: launch counts, one per kernel form (see :func:`fused_md_substeps`)
LAUNCH_COUNTERS = (tuple(f"launches{r}{f}" for r in ("", "_rng")
                         for f in _LANE_FORMS)
                   + tuple(f"launches_s{S}{f}" for S in _KERNEL_S
                           if S != _RNG_S for f in _LANE_FORMS))
for _name in LAUNCH_COUNTERS:
    setattr(fused_md_substeps, _name, 0)
