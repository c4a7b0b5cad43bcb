"""Per-member sums over ions whose bits do not depend on the fold's width.

A fold's per-member observables (temperatures, kinetic and potential
energies, tagged moments, KDE bins, the three-state records) are sums over
each member's ions (on a card the KDE's are ``csrc/kde.cu``'s own, in the
same kind of fixed order).  torch's CUDA reductions over ``[E, n]`` choose their
thread layout from E, so a member's sum rounds differently in a fold of
another width: a fold spread over a mesh's slots would not give the
unsharded fold's bits, which the JAX package's mesh contract requires.

* :func:`member_sum`: ``x [..., n]`` -> ``[...]``, the sum over the last
  axis (optionally of ``x * mask``).  A CUDA tensor launches
  ``csrc/member_sum.cu`` (one block a row, a fixed order of additions that
  depends on n alone) and adds one to ``member_sum.launches``; a CPU
  tensor runs the plain torch reduction, so every CPU result keeps its
  bits.
* :func:`ion_sum` / :func:`ion_mean`: ``torch.sum`` / ``torch.mean`` over
  the given dims (all of them for ``dim=None``) in that form: on the CPU
  exactly the torch call, on a CUDA tensor the reduced dims moved last and
  summed by :func:`member_sum` (a mean divides by the count).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import _build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("member_sum")
    p, q = ctypes.c_void_p, ctypes.c_longlong
    for name in ("member_sum_f32_launch", "member_sum_f64_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, q, q, q, p, p]
        fn.restype = ctypes.c_int
    return lib


def member_sum_reference(x: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: torch's sum over the last axis."""
    return torch.sum(x if mask is None else x * mask, dim=-1)


def member_sum(x: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x [..., n]`` -> ``[...]``: each row's sum over its n lanes, of
    ``x * mask`` when ``mask`` (``[n]``, one row for all, or x's shape) is
    given.  On a CUDA tensor (float32 or float64) one launch of the
    member-sum kernel, whose result for a row depends on that row alone;
    on a CPU tensor :func:`member_sum_reference`."""
    if mask is not None and tuple(mask.shape) not in (tuple(x.shape[-1:]),
                                                      tuple(x.shape)):
        raise ValueError(f"want mask [{x.shape[-1]}] or {tuple(x.shape)}, "
                         f"got {tuple(mask.shape)}")
    if x.device.type == "cpu":
        return member_sum_reference(x, mask)
    if x.device.type != "cuda":
        raise ValueError(f"no member-sum kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the member-sum kernel takes float32 or float64, "
                         f"got {x.dtype}")
    if mask is not None and (mask.device != x.device
                             or mask.dtype != x.dtype):
        raise ValueError("x and mask must share device and dtype")
    n = x.shape[-1]
    lead = tuple(x.shape[:-1])
    rows = math.prod(lead)
    x = x.contiguous()
    out = torch.empty(lead, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    if mask is not None:
        mask = mask.contiguous()
    lib = _lib()
    fn = (lib.member_sum_f32_launch if x.dtype == torch.float32
          else lib.member_sum_f64_launch)
    with _build.device_guard(x.device):
        err = fn(x.data_ptr(), None if mask is None else mask.data_ptr(),
                 0 if mask is None or mask.dim() == 1 else n, rows, n,
                 out.data_ptr(), _build.raw_stream(x.device))
    _build.check(lib, err, "member_sum_launch")
    _build.count_launch(member_sum)
    return out


member_sum.launches = 0


def _dims(x: torch.Tensor, dim) -> tuple:
    if dim is None:
        return tuple(range(x.dim()))
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    return tuple(sorted(d % x.dim() for d in dims))


def _to_rows(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """``x`` with ``dims`` moved last and flattened into one axis."""
    keep = [d for d in range(x.dim()) if d not in dims]
    y = x.permute(*keep, *dims)
    return y.reshape(*y.shape[:len(keep)], -1)


def ion_sum(x: torch.Tensor, dim=None,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``torch.sum(x [* mask], dim)`` (every dim for ``dim=None``) whose
    value for each kept index depends only on its own lanes: on the CPU
    exactly that torch call, on a CUDA tensor :func:`member_sum` over the
    reduced dims moved last."""
    if x.device.type == "cpu":
        y = x if mask is None else x * mask
        return torch.sum(y) if dim is None else torch.sum(y, dim=dim)
    return _rows_sum(x, _dims(x, dim), mask)


def _rows_sum(x: torch.Tensor, dims: tuple,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`member_sum` over ``dims`` of x (of ``x * mask``, the mask
    broadcast to x): the reduced dims moved last."""
    if mask is not None:
        if dims == (x.dim() - 1,) and mask.dim() == 1:
            return member_sum(x, mask.to(x.dtype))
        mask = _to_rows(mask.to(x.dtype).expand_as(x), dims)
    return member_sum(_to_rows(x, dims), mask)


def ion_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``torch.mean(x, dim)`` in :func:`ion_sum`'s form: on the CPU exactly
    that torch call, on a CUDA tensor the sum divided by the count."""
    if x.device.type == "cpu":
        return torch.mean(x) if dim is None else torch.mean(x, dim=dim)
    dims = _dims(x, dim)
    return _rows_sum(x, dims) / math.prod(x.shape[d] for d in dims)
