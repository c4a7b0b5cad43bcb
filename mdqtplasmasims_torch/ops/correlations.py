"""Velocity autocorrelation suite and streaming VAF.

Counterpart of ``mdqtplasmasims_tpu/ops/correlations.py``.  The reference
computes the VAF and the v^2/v^3/v^4 autocorrelations from a stored
[3][N][T] velocity history with a serial O(T^2 N) post-pass
(MonteCarloFollowedByMDAndTempAnisotropy.cpp:655-807).  Here the same
quantities come from batched FFTs, O(N T log T), equal up to float
associativity:

    C_p[tau] = (1/(N (T-tau))) sum_{n,axis} sum_j s[j] s[j+tau] - const
    with s = v^p;  const = 0 (p=1,3), 3/Gamma^2 (p=2), 27/Gamma^4 (p=4).

The streaming variants (Zfunc/printVAF, laserCooling...SpeedUp.cpp:1100-1130;
x-only randomFrozenStartTag422Linear.cpp:904-927; v^2 "LongKin"
randomFrozenStartTag408Quad.cpp:944-967) are dot products against a saved
interval snapshot.
"""

from __future__ import annotations

from typing import Optional

import torch

from .member_sum import ion_mean, ion_sum


def _autocorr_sums(s: torch.Tensor) -> torch.Tensor:
    """sum_j s[j] s[j+tau] for tau in [0, T) via FFT.  s: [..., T]."""
    T = s.shape[-1]
    nfft = 2 * T
    f = torch.fft.rfft(s, n=nfft, dim=-1)
    return torch.fft.irfft(f * torch.conj(f), n=nfft, dim=-1)[..., :T]


def _equilibrium_const(power: int, gamma: float) -> float:
    return {2: 3.0 / gamma ** 2, 4: 27.0 / gamma ** 4}.get(power, 0.0)


def power_autocorr(vstore: torch.Tensor, power: int,
                   gamma: float = 1.0) -> torch.Tensor:
    """[T] autocorrelation of v^power from vstore [T, N, 3].

    power=1 -> VAF (recordVAF :655-693); 2 -> longitudinal-viscosity
    autocorr minus 3/Gamma^2 (:695-731); 3 -> v^3 autocorr (:733-769);
    4 -> v^4 autocorr minus 27/Gamma^4 (:771-807)."""
    T, n, _ = vstore.shape
    s = (vstore ** power).permute(1, 2, 0)          # [N, 3, T]
    c = ion_sum(_autocorr_sums(s), dim=(0, 1))      # [T]
    denom = n * (T - torch.arange(T, device=vstore.device))
    return c / denom - _equilibrium_const(power, gamma)


def autocorr_suite(vstore: torch.Tensor, gamma: float = 1.0):
    """All four power autocorrelations (VAF, v^2, v^3, v^4)."""
    return tuple(power_autocorr(vstore, k, gamma) for k in (1, 2, 3, 4))


def power_autocorr_direct(vstore: torch.Tensor, power: int,
                          gamma: float = 1.0) -> torch.Tensor:
    """O(T^2) direct evaluation (for validation against the FFT path)."""
    T, n, _ = vstore.shape
    s = vstore ** power
    res = torch.stack([ion_sum(s[:T - tau] * s[tau:]) / (n * (T - tau))
                       for tau in range(T)])
    return res - _equilibrium_const(power, gamma)


def streaming_vaf(v_now: torch.Tensor, v_interval_start: torch.Tensor,
                  x_only: bool = False,
                  weights: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zfunc: (1/N) sum_i v_i(t0).v_i(t), optionally x-only and/or
    restricted to a weighted subset (spin-up ions).  ``mask`` marks the
    member's real ions when the arrays carry padded lanes (a Poissonian
    fold): N becomes the real count (padded lanes are V=0, so they add
    nothing to the sum)."""
    if x_only:
        prod = v_interval_start * v_now
    else:
        prod = torch.sum(v_interval_start * v_now, dim=-1)
    if weights is not None:
        prod = prod * weights
    n_eff = v_now.shape[0] if mask is None else torch.sum(mask)
    return ion_sum(prod) / n_eff


def streaming_long_kin(vx_now: torch.Tensor, vx_start: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LongKin (randomFrozenStartTag408Quad.cpp:944-967): the v^2
    autocorrelation with the *current* mean square subtracted:
    (1/N) sum (vx0^2 - <vx^2>)(vx^2 - <vx^2>).  ``mask``: real-ion marker
    of a padded fold: both the mean square and the sum run over real lanes
    only (padded vx=0 lanes would bias <vx^2> low and add spurious
    (0-avg)^2 terms)."""
    vv_now, vv_start = vx_now * vx_now, vx_start * vx_start
    if mask is None:
        avg = ion_mean(vv_now)
        return ion_mean((vv_start - avg) * (vv_now - avg))
    n_eff = torch.sum(mask)
    avg = ion_sum(vv_now, mask=mask) / n_eff
    return ion_sum((vv_start - avg) * (vv_now - avg), mask=mask) / n_eff
