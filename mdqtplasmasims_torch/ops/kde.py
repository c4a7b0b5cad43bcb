"""Gaussian-KDE velocity distributions.

Counterpart of ``mdqtplasmasims_tpu/ops/kde.py``: for every output the
reference accumulates a 2001- or 4001-bin Gaussian kernel sum over all
ions (laserCoolingPlusExpansionMDQTSpeedUp.cpp:957-979;
randomFrozenStartTag422Linear.cpp:800-853); here it is one ``[B, N]``
broadcast-and-reduce.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .member_sum import ion_sum

KDE_WIDTH = 0.002          # gaussian width


def folded_bins_np() -> np.ndarray:
    """Host (float64) copy of :func:`folded_bins` for the .dat writers."""
    return np.arange(2001) * 0.0025


def folded_bins(dtype=torch.float32, device=None) -> torch.Tensor:
    """2001 bins at 0.0025 spacing over [0, 5]
    (laserCooling...SpeedUp.cpp:340-344)."""
    return torch.arange(2001, dtype=dtype, device=device) * 0.0025


def centered_bins_np() -> np.ndarray:
    """Host (float64) copy of :func:`centered_bins` for the .dat writers."""
    return (np.arange(4001) - 2000) * 0.0025


def centered_bins(dtype=torch.float32, device=None) -> torch.Tensor:
    """4001 bins over [-5, 5] (randomFrozenStartTag422Linear.cpp:295-299)."""
    return (torch.arange(4001, dtype=dtype, device=device) - 2000) * 0.0025


def gaussian_kde(v: torch.Tensor, bins: torch.Tensor, *, folded: bool,
                 weights: Optional[torch.Tensor] = None,
                 width: float = KDE_WIDTH,
                 normalize: bool = True) -> torch.Tensor:
    """KDE of velocities ``v`` [N] onto ``bins`` [B] (``[..., B]`` for
    ``v [..., N]`` and ``weights [..., N]``: a fold's members at once).

    ``folded=True`` is the cooling code's symmetrized form
    ``exp(-(b-v)^2/2w^2) + exp(-(b+v)^2/2w^2)`` over non-negative bins
    (laserCooling...SpeedUp.cpp:969); ``folded=False`` is the plain kernel
    used with centered bins.  ``weights`` masks or weights ions (a
    spin-up subset).
    The reference normalization 1/(6*sqrt(2*pi*w^2)) is applied when
    ``normalize``."""
    inv2w2 = 1.0 / (2.0 * width * width)
    d = bins[:, None] - v[..., None, :]
    k = torch.exp(-inv2w2 * d * d)
    if folded:
        s = bins[:, None] + v[..., None, :]
        k = k + torch.exp(-inv2w2 * s * s)
    if weights is not None:
        k = k * weights[..., None, :]
    out = ion_sum(k, dim=-1)
    if normalize:
        out = out / (6.0 * math.sqrt(2.0 * math.pi) * width)
    return out
