"""Structural diagnostics: the pair correlation g(r), the static
structure factor S(k) and the longitudinal current correlation function's
Fourier-space current J(k).

Counterpart of ``mdqtplasmasims_tpu/ops/structure.py``.  References:
  recordPairPairCorr  MonteCarloFollowedByMDAndTempAnisotropy.cpp:584-652
  LCCF / printJ       laserCoolingPlusExpansionMDQTSpeedUp.cpp:1040-1092
The JAX package computes all of them outside Pallas; here they are plain
torch on the inputs' device: g(r) an O(N^2) histogram chunked by rows,
S(k) and J(k) products in float64.
"""

from __future__ import annotations

import numpy as np
import torch


def pair_correlation(R: torch.Tensor, L: float, *, dr: float = 0.05,
                     n_bins: int = 400, chunk: int = 512) -> torch.Tensor:
    """Shell-normalized g(r) histogram of ``R [N, 3]``, bins of width dr in
    units of a, ``[n_bins]`` in R's dtype.

    Reproduces the reference normalization exactly, including its integer
    shell-volume approximation: bin 0 divides by N*(4/3)pi dr^3, bin i by
    N*3*dr^3*i^2 (MonteCarlo...cpp:626-635), and the r < L/2 cap via the
    bin-count limit.  Pairs are binned by ``floor(r/dr)`` in R's dtype, as
    the JAX package bins them; the counts are exact integers (a scatter-add
    in int64, no host sync)."""
    n = R.shape[0]
    n_use = int(min(n_bins, np.floor((L / 2.0) / dr)))
    hist = torch.zeros(n_use + 1, dtype=torch.int64, device=R.device)
    for s in range(0, n, chunk):
        d = R[s:s + chunk, None, :] - R[None, :, :]
        d = d - L * torch.round(d / L)
        dx, dy, dz = d.unbind(-1)
        r = torch.sqrt(dx * dx + dy * dy + dz * dz)
        idx = torch.floor(r / dr).to(torch.int64)
        valid = (r > 0) & (idx < n_use)
        idx = torch.where(valid, idx, torch.full_like(idx, n_use))
        hist.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx).reshape(-1))
    i = torch.arange(n_use, dtype=R.dtype, device=R.device)
    # bin 0: the reference's N*4/3 is C *integer* division (5461 for
    # N=4096, not 5461.33) before the double promotion
    shell = torch.where(i == 0,
                        torch.full_like(i, float(n * 4 // 3) * np.pi * dr ** 3),
                        n * 3.0 * dr ** 3 * i * i)
    g = hist[:n_use].to(R.dtype) / shell
    return torch.nn.functional.pad(g, (0, n_bins - n_use))


def static_structure_factor(R: torch.Tensor,
                            kvecs: torch.Tensor) -> torch.Tensor:
    """S[k] = |rho(k)|^2 / N with rho(k) = sum_j exp(i k.R_j), ``[K]`` in
    R's dtype: the density analog of :func:`current_fourier`, the sums of
    cos and sin of the phases in float64 on R's device.  S(k=0) = N by
    this definition (the forward term); callers drop the zero vector."""
    f64 = torch.float64
    phase = R.to(f64) @ kvecs.to(R.device, f64).T           # [N, K]
    re, im = torch.sum(torch.cos(phase), 0), torch.sum(torch.sin(phase), 0)
    return ((re * re + im * im) / R.shape[0]).to(R.dtype)


def k_grid(L: float, lambda_frac: int = 12) -> np.ndarray:
    """[K,3] wavevectors 2*pi*(kx,ky,kz)/L for integer triplets in
    [0, lambda_frac)^3 (laserCooling...SpeedUp.cpp:1046-1058)."""
    ks = np.arange(lambda_frac)
    kx, ky, kz = np.meshgrid(ks, ks, ks, indexing="ij")
    return (2.0 * np.pi / L) * np.stack(
        [kx.ravel(), ky.ravel(), kz.ravel()], axis=-1)


def current_fourier(R: torch.Tensor, V: torch.Tensor,
                    kvecs: torch.Tensor) -> torch.Tensor:
    """J[a, k] = sum_j V[a,j] exp(i k.R_j), ``[3, K]`` complex (the
    reference's O(N*12^3) triple loop, SpeedUp.cpp:1060-1065), as real
    products of V with cos and sin of the phases.  The products run in
    float64 on R's device, which no TF32 setting reaches; J comes back in
    the complex type of R's precision.  A fold's ``R, V [E, N, 3]`` give
    ``[E, 3, K]``, a member at a time: its float64 phases are ``[N, K]``
    (K = 12^3), and a whole fold's would hold E times that."""
    if R.dim() > 2:
        return torch.stack([current_fourier(r, v, kvecs)
                            for r, v in zip(R, V)])
    f64 = torch.float64
    phase = R.to(f64) @ kvecs.to(R.device, f64).T           # [N, K]
    Vt = V.to(f64).T
    J = torch.complex(Vt @ torch.cos(phase), Vt @ torch.sin(phase))
    return J.to(torch.complex128 if R.dtype == f64 else torch.complex64)
