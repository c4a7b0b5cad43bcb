"""Gaussian-KDE velocity distributions.

Counterpart of ``mdqtplasmasims_tpu/ops/kde.py``: for every output the
reference accumulates a 2001- or 4001-bin Gaussian kernel sum over all
ions (laserCoolingPlusExpansionMDQTSpeedUp.cpp:957-979;
randomFrozenStartTag422Linear.cpp:800-853).

* :func:`gaussian_kde` on a CUDA tensor ``v [..., n]`` (float32) launches
  ``csrc/kde.cu`` once for all its rows (a fold's members and axes at
  once): the ``[B, n]`` kernel matrix of a row never leaves the
  registers, each bin sums its row's ions in an order fixed by n alone
  (a member's bins have the same bits in a fold of any width), and the
  call adds one to ``gaussian_kde.launches``.
* On a CPU tensor it runs :func:`gaussian_kde_reference`, the plain
  ``[B, n]`` broadcast-and-reduce, one row at a time (a row's bits are
  those of a lone call, and a fold's matrix is never whole in memory).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from .. import _build
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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("kde")
    p, q, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    lib.kde_f32_launch.argtypes = [p, p, p, q, q, i, i, f, f, i, p, p]
    lib.kde_f32_launch.restype = ctypes.c_int
    return lib


def _norm(width: float) -> float:
    """The reference normalisation's divisor, 6 sqrt(2 pi) w."""
    return 6.0 * math.sqrt(2.0 * math.pi) * width


def gaussian_kde_reference(v: torch.Tensor, bins: torch.Tensor, *,
                           folded: bool,
                           weights: Optional[torch.Tensor] = None,
                           width: float = KDE_WIDTH,
                           normalize: bool = True) -> torch.Tensor:
    """The plain version of :func:`gaussian_kde`: the ``[..., B, n]`` kernel
    matrix in torch, summed over the ions."""
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
        out = out / _norm(width)
    return out


def gaussian_kde(v: torch.Tensor, bins: torch.Tensor, *, folded: bool,
                 weights: Optional[torch.Tensor] = None,
                 width: float = KDE_WIDTH,
                 normalize: bool = True) -> torch.Tensor:
    """KDE of velocities ``v`` [N] onto ``bins`` [B] (``[..., B]`` for
    ``v [..., N]`` and ``weights`` broadcast to it: a fold's members and
    axes at once).

    ``folded=True`` is the cooling code's symmetrized form
    ``exp(-(b-v)^2/2w^2) + exp(-(b+v)^2/2w^2)`` over non-negative bins
    (laserCooling...SpeedUp.cpp:969); ``folded=False`` is the plain kernel
    used with centered bins.  ``weights`` masks or weights ions (a
    spin-up subset).
    The reference normalization 1/(6*sqrt(2*pi*w^2)) is applied when
    ``normalize``.  A CUDA tensor launches the KDE kernel, a CPU tensor
    runs :func:`gaussian_kde_reference` row by row."""
    if weights is not None:
        weights = weights.to(v.dtype).expand(v.shape)
    if v.device.type == "cpu":
        kw = dict(folded=folded, width=width, normalize=normalize)
        if v.dim() == 1:
            return gaussian_kde_reference(v, bins, weights=weights, **kw)
        n = v.shape[-1]
        rows = v.reshape(-1, n)
        ws = [None] * rows.shape[0] if weights is None \
            else weights.reshape(-1, n)
        out = [gaussian_kde_reference(r, bins, weights=w, **kw)
               for r, w in zip(rows, ws)]
        return torch.stack(out).reshape(*v.shape[:-1], bins.shape[0])
    if v.device.type != "cuda":
        raise ValueError(f"no KDE kernel for device {v.device}")
    if v.dtype != torch.float32 or bins.dtype != torch.float32:
        raise ValueError(f"the KDE kernel takes float32, got {v.dtype} and "
                         f"{bins.dtype}")
    if bins.device != v.device or (weights is not None
                                   and weights.device != v.device):
        raise ValueError("v, bins and weights must share a device")
    n, nbins = v.shape[-1], bins.shape[0]
    lead = tuple(v.shape[:-1])
    rows = math.prod(lead)
    out = torch.empty(lead + (nbins,), dtype=v.dtype, device=v.device)
    if rows == 0 or nbins == 0:
        return out
    v = v.contiguous()
    w = None if weights is None else weights.contiguous()
    bins = bins.contiguous()
    lib = _lib()
    with _build.device_guard(v.device):
        err = lib.kde_f32_launch(
            v.data_ptr(), None if w is None else w.data_ptr(),
            bins.data_ptr(), rows, n, nbins, int(folded),
            -1.0 / (2.0 * width * width), _norm(width), int(normalize),
            out.data_ptr(), _build.raw_stream(v.device))
    _build.check(lib, err, "kde_f32_launch")
    _build.count_launch(gaussian_kde)
    return out


gaussian_kde.launches = 0
