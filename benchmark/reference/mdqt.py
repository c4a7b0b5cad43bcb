"""Plain reference of one MDQT output segment of the cooling family.

Written from the physics of laserCoolingPlusExpansionMDQTSpeedUp.cpp (the
SpeedUp scheme: forces once per MD step, a leapfrog drift/kick and a
quantum tick at every one of the step's ``ratio`` substeps) and from the
configuration file alone: the level scheme, the units and the uniform
stream are read from ``benchmark/configs/<name>.json``.  Plain torch in
any floating dtype (float64 for the reference, bfloat16 for the control),
on any device, with no kernel, no lane layout and no batching but the
ions of the checked members side by side.  It imports nothing of the
program.

* :func:`uniforms`: the configuration's stream, Threefry-2x32-20
  (Salmon et al., Random123) under key ``(word, 0)`` at counter ``(lane,
  3*tick + j)``; words 0-4 of a tick are its uniforms r0..r4, the top 24
  bits of each times 2**-24.
* :func:`pair_forces`: minimum-image Yukawa forces (and the per-ion
  potential sums) of one member, in row blocks.
* :func:`ticks`: ``n`` quantum substeps at fixed forces: the leapfrog
  substep, then the non-Hermitian evolution of psi by the scheme's
  3/8-rule Runge-Kutta step with the norm-loss prefactor, the jump test,
  the Ehrenfest or recoil kick and the collapse.
* :func:`observables`: one output sample of one member (the reference's
  output(): kinetic energies, mean vx, the folded Gaussian KDE of the
  three velocity components, per-ion manifold populations, the potential
  energy per ion).
* :func:`follow_segment`: ``steps`` MD steps of the checked members from
  a state, the last one split one tick in, and the sample there.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA

KDE_BINS = 2001          # 0 .. 5 at 0.0025 (SpeedUp.cpp:340-344)
KDE_STEP = 0.0025
KDE_WIDTH = 0.002        # SpeedUp.cpp:957-979


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 with 20 rounds on int64 tensors holding uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for r in range(20):
        rot = _ROT[r % 8]
        x0 = (x0 + x1) & _MASK
        x1 = (((x1 << rot) | (x1 >> (32 - rot))) & _MASK) ^ x0
        if r % 4 == 3:
            s = r // 4 + 1
            x0 = (x0 + ks[s % 3]) & _MASK
            x1 = (x1 + ks[(s + 1) % 3] + s) & _MASK
    return x0, x1


def uniforms(word: int, tick0: int, n_ticks: int,
             lanes: torch.Tensor) -> torch.Tensor:
    """``[n_ticks, 5, M]`` float64 uniforms of ticks ``tick0 ..`` on the
    global ``lanes [M]`` (int64)."""
    dev = lanes.device
    tick = torch.arange(tick0, tick0 + n_ticks, dtype=torch.int64,
                        device=dev)[:, None, None]
    j = torch.arange(3, dtype=torch.int64, device=dev)[None, :, None]
    y0, y1 = threefry2x32(int(word) & _MASK, 0, lanes[None, None, :],
                          (3 * tick + j) & _MASK)
    w = torch.stack([y0[:, 0], y1[:, 0], y0[:, 1], y1[:, 1], y0[:, 2]], 1)
    return (w >> 8).to(torch.float64) * 2.0 ** -24


def pair_forces(R: torch.Tensor, L: float, ldeb: float, block: int = 1024,
                with_pot: bool = False):
    """Forces ``[n, 3]`` on the ions of one member, f(r) = (1/r + 1/ldeb)
    exp(-r/ldeb) / r^2 times the separation, over every other ion within
    the half-box cutoff of the minimum image; with ``with_pot`` also the
    per-ion sums of exp(-r/ldeb)/r ``[n]``."""
    n = R.shape[0]
    rc2 = (L / 2.0) ** 2
    F = torch.zeros_like(R)
    pot = torch.zeros(n, dtype=R.dtype, device=R.device)
    for s in range(0, n, block):
        d = R[s:s + block, None, :] - R[None, :, :]
        d = d - L * torch.round(d / L)
        r2 = (d * d).sum(-1)
        ok = (r2 > 0) & (r2 < rc2)
        r2s = torch.where(ok, r2, torch.ones_like(r2))
        r = torch.sqrt(r2s)
        e = torch.exp(-r / ldeb)
        ft = torch.where(ok, (1.0 / r + 1.0 / ldeb) * e / r2s,
                         torch.zeros_like(r2))
        F[s:s + block] = (d * ft[..., None]).sum(1)
        if with_pot:
            pot[s:s + block] = torch.where(ok, e / r,
                                           torch.zeros_like(r2)).sum(1)
    return F, pot


class Scheme(NamedTuple):
    """The configuration's level scheme and units as tensors."""
    S: int
    w: torch.Tensor          # [S] decay weights
    e0: torch.Tensor         # [S]
    e1: torch.Tensor         # [S]
    C: torch.Tensor          # [S, S] real symmetric coupling
    jmask: torch.Tensor      # [S] 1 on the states a jump projects from
    cum_s: torch.Tensor      # [S_src, S_dest] cumulative, S branch
    cum_d: torch.Tensor      # [S_src, S_dest] cumulative, D branch
    tdep: tuple              # ((row, col, coef), ...)
    tdep_freq: float
    force: tuple             # ((a, b, w), ...)
    branch_d: float
    kick_s: float
    kick_d: float
    manifolds: tuple
    h: float
    qdt: float
    ratio: int
    L: float
    ldeb: float
    p2q: float
    g2e: float


def scheme_of(config: dict, dtype=torch.float64, device="cpu") -> Scheme:
    """The :class:`Scheme` of a configuration file's ``scheme`` and
    ``derived`` entries in ``dtype`` on ``device``."""
    s, d = config["scheme"], config["derived"]
    if d["exp_c1"] or d["exp_c2"] or config["physics"]["renormalize"]:
        raise ValueError("the reference covers the static frame without "
                         "renormalization only")
    S = s["n_states"]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)
    dest = np.asarray(s["jump_dest"], np.float64)          # [S, 2, S]
    jmask = np.zeros(S)
    jmask[list(s["jump_src"])] = 1.0
    return Scheme(
        S=S, w=t(s["decay_w"]), e0=t(s["e0"]), e1=t(s["e1"]),
        C=t(s["coupling"]), jmask=t(jmask),
        cum_s=t(np.cumsum(dest[:, 0, :], -1)),
        cum_d=t(np.cumsum(dest[:, 1, :], -1)),
        tdep=tuple(zip(s["tdep_rows"], s["tdep_cols"], s["tdep_coefs"])),
        tdep_freq=s["tdep_freq"],
        force=tuple(zip(s["force_a"], s["force_b"], s["force_w"])),
        branch_d=s["branch_d_prob"], kick_s=s["kick_s"], kick_d=s["kick_d"],
        manifolds=tuple(tuple(m) for m in s["manifolds"]),
        h=d["h"], qdt=d["qdt"], ratio=d["ratio"], L=d["L"], ldeb=d["ldeb"],
        p2q=d["plas_to_quant_vel"], g2e=d["gamma_to_einstein"])


class Ions(NamedTuple):
    """Ions of the checked members side by side: ``R, V [M, 3]``, psi as
    real and imaginary planes ``[M, S]``, the clock since the last jump
    ``tp [M]``, the global ``lanes [M]`` of the stream."""
    R: torch.Tensor
    V: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    tp: torch.Tensor
    lanes: torch.Tensor


def _hpsi(sc: Scheme, a, b, u, c, s):
    """H psi as planes: H = C + diag(e0 + e1 u) - (i/2) diag(w) plus the
    beat notes H[r, col] = m e^{i phi}, H[col, r] = m e^{-i phi}."""
    diag = sc.e0 + sc.e1 * u[:, None]
    re = a @ sc.C + diag * a + 0.5 * sc.w * b
    im = b @ sc.C + diag * b - 0.5 * sc.w * a
    if sc.tdep:
        re, im = re.clone(), im.clone()
        for r, col, m in sc.tdep:
            ar, br, ac, bc = a[:, r], b[:, r], a[:, col], b[:, col]
            re[:, r] += m * (c * ac - s * bc)
            im[:, r] += m * (c * bc + s * ac)
            re[:, col] += m * (c * ar + s * br)
            im[:, col] += m * (c * br - s * ar)
    return re, im


def _slope(sc: Scheme, a, b, u, c, s):
    """d psi / dt of the no-jump evolution over one tick, with the norm
    loss dp of the tick restored (pref = 1/sqrt(1 - dp), dp clipped to
    [0, 0.9])."""
    h = sc.h
    dp = h * ((a * a + b * b) * sc.w).sum(-1, keepdim=True)
    pref = torch.rsqrt(1.0 - torch.clamp(dp, 0.0, 0.9))
    re, im = _hpsi(sc, a, b, u, c, s)
    return (pref * (a + h * im) - a) / h, (pref * (b - h * re) - b) / h


def ticks(sc: Scheme, ions: Ions, F: torch.Tensor, tick0: int,
          n_ticks: int, word: int, first: bool) -> Ions:
    """``n_ticks`` quantum substeps at the fixed forces ``F [M, 3]``; the
    run's very first substep (``first``) drifts with the second-order
    force term."""
    R, V, a, b, tp, lanes = ions
    dt = R.dtype
    u_all = uniforms(word, tick0, n_ticks, lanes).to(dt)
    h, qdt, L = sc.h, sc.qdt, sc.L
    half = 0.5 * qdt
    S = sc.S
    eye = torch.eye(S, dtype=dt, device=R.device)
    one = torch.ones_like(tp)
    for i in range(n_ticks):
        fs = 1.0 if (first and i == 0) else 0.0
        R = R + half * V + fs * half * half * F
        R = torch.where(R < 0, R + L, torch.where(R > L, R - L, R))
        V = V + qdt * F
        R = R + half * V + fs * half * half * F
        R = torch.where(R < 0, R + L, torch.where(R > L, R - L, R))
        tp = tp + qdt
        u = V[:, 0] * sc.p2q
        ang = (sc.tdep_freq * u) * (tp * sc.g2e)
        c, s = torch.cos(ang), torch.sin(ang)
        r0, r1, r2, r3, r4 = u_all[i]
        pop = a * a + b * b
        jumped = r0 < h * (pop * sc.w).sum(-1)
        k1a, k1b = _slope(sc, a, b, u, c, s)
        k2a, k2b = _slope(sc, a + 0.5 * h * k1a, b + 0.5 * h * k1b, u, c, s)
        k3a, k3b = _slope(sc, a + 0.5 * h * k2a, b + 0.5 * h * k2b, u, c, s)
        k4a, k4b = _slope(sc, a + h * k3a, b + h * k3b, u, c, s)
        ae = a + (k1a + 3 * k2a + 3 * k3a + k4a) * (h / 8)
        be = b + (k1b + 3 * k2b + 3 * k3b + k4b) * (h / 8)
        # Ehrenfest kick from the tick's initial amplitudes:
        # w Im(psi_a conj psi_b)
        kick = torch.zeros_like(tp)
        for fa, fb, fw in sc.force:
            kick = kick + fw * (b[:, fa] * a[:, fb] - a[:, fa] * b[:, fb])
        kick = kick * h
        # collapse: the source state by its share of the projectable
        # population, the S or D branch, the destination by its
        # Clebsch-Gordan weight, and a recoil of either sign
        cum = torch.cumsum(pop * sc.jmask, -1)
        tot = torch.clamp(cum[:, -1:], min=1e-30)
        src = torch.clamp((r1[:, None] * tot >= cum).sum(-1), max=S - 1)
        dbr = r2 < sc.branch_d
        dcum = torch.where(dbr[:, None], sc.cum_d[src], sc.cum_s[src])
        dest = torch.clamp((r4[:, None] >= dcum).sum(-1), max=S - 1)
        recoil = (torch.where(r3 < 0.5, one, -one)
                  * torch.where(dbr, one * sc.kick_d, one * sc.kick_s))
        j = jumped[:, None]
        a = torch.where(j, eye[dest], ae)
        b = torch.where(j, torch.zeros_like(be), be)
        tp = torch.where(jumped, torch.zeros_like(tp), tp)
        V = torch.cat([(V[:, 0] + torch.where(jumped, recoil, kick))[:, None],
                       V[:, 1:]], 1)
    return Ions(R, V, a, b, tp, lanes)


def kde(v: torch.Tensor) -> torch.Tensor:
    """The folded Gaussian KDE of ``v [n]`` on the 2001 bins, normalized by
    1/(6 sqrt(2 pi) w) (SpeedUp.cpp:957-979)."""
    bins = torch.arange(KDE_BINS, dtype=v.dtype, device=v.device) * KDE_STEP
    g = 1.0 / (2.0 * KDE_WIDTH * KDE_WIDTH)
    out = torch.zeros_like(bins)
    for s in range(0, v.shape[0], 2048):
        x = v[None, s:s + 2048]
        out = out + (torch.exp(-g * (bins[:, None] - x) ** 2)
                     + torch.exp(-g * (bins[:, None] + x) ** 2)).sum(1)
    return out / (6.0 * math.sqrt(2.0 * math.pi) * KDE_WIDTH)


def observables(sc: Scheme, R, V, a, b) -> dict:
    """One output sample of one member's ``n`` ions (all real)."""
    n = R.shape[0]
    vx_mean = V[:, 0].mean()
    vx = V[:, 0] - vx_mean
    ekin = torch.stack([(0.5 * vx * vx).mean(), (0.5 * V[:, 1] ** 2).mean(),
                        (0.5 * V[:, 2] ** 2).mean()])
    _, pot = pair_forces(R, sc.L, sc.ldeb, with_pot=True)
    pop = a * a + b * b
    return dict(
        ekin=ekin, epot=0.5 * pot.sum() / n, vx_mean=vx_mean,
        pvel=torch.stack([kde(vx), kde(V[:, 1]), kde(V[:, 2])]),
        vx_ions=V[:, 0],
        pops=torch.stack([pop[:, list(m)].sum(-1) for m in sc.manifolds],
                         -1))


def follow_segment(sc: Scheme, ions: Ions, n_per: int, tick0: int,
                   steps: int, word: int) -> list:
    """``steps`` MD steps of the checked members from ``ions`` (members
    of ``n_per`` ions each, side by side) at the run's tick ``tick0``,
    the last step cut one tick in; returns each member's
    :func:`observables` there."""
    n_mem = ions.R.shape[0] // n_per
    tick = tick0
    for k in range(steps):
        F = torch.cat([pair_forces(ions.R[m * n_per:(m + 1) * n_per],
                                   sc.L, sc.ldeb)[0] for m in range(n_mem)])
        n = 1 if k == steps - 1 else sc.ratio
        ions = ticks(sc, ions, F, tick, n, word, first=(tick == 0))
        tick += n
    return [observables(sc, *(x[m * n_per:(m + 1) * n_per]
                              for x in ions[:4]))
            for m in range(n_mem)]
