"""The longitudinal current correlation function's Fourier-space current
J(k) (reference LCCF / printJ, laserCoolingPlusExpansionMDQTSpeedUp.cpp:
1040-1092).

Counterpart of ``k_grid`` and ``current_fourier`` in
``mdqtplasmasims_tpu/ops/structure.py`` (:58-64, :84-90).  The JAX package
computes the ``[3, N] x [N, K]`` complex product outside Pallas; here it
is a plain product on the inputs' device, in float64.
``pair_correlation`` and ``static_structure_factor`` come with the
Monte-Carlo family.
"""

from __future__ import annotations

import numpy as np
import torch


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
    the complex type of R's precision."""
    f64 = torch.float64
    phase = R.to(f64) @ kvecs.to(R.device, f64).T           # [N, K]
    Vt = V.to(f64).T
    J = torch.complex(Vt @ torch.cos(phase), Vt @ torch.sin(phase))
    return J.to(torch.complex128 if R.dtype == f64 else torch.complex64)
