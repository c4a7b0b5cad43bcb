"""Simulation state.

Counterpart of ``mdqtplasmasims_tpu/state.py``.  The tensors live on one
device; ``tick`` is a host int (the source of truth for simulation time),
so the MD loop never reads a counter back from the device.  Random draws
come from explicit ``torch.Generator`` objects held by the caller, so the
state carries no key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def tick_time(tick: int, qdt: float, dtype: torch.dtype) -> float:
    """``tick * qdt`` rounded as the JAX package computes it in ``dtype``
    (``tick.astype(dtype) * qdt``, scheduler.py soa_restore)."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return float(np_dtype(tick) * np_dtype(qdt))


@dataclasses.dataclass
class SimState:
    """Complete MDQT system state.

    ``R, V, F`` are ``[N, 3]``; ``psi`` is ``[N, S]`` complex; ``t_part`` is
    the per-ion clock since the last quantum jump (plasma units); ``tick``
    counts quantum timesteps since t=0 and ``t`` is the matching time."""

    R: torch.Tensor
    V: torch.Tensor
    F: torch.Tensor
    psi: torch.Tensor
    t_part: torch.Tensor
    tick: int = 0
    t: float = 0.0

    @property
    def n_ions(self) -> int:
        return self.R.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.R.dtype


def make_state(R, V, psi, *, device, dtype=torch.float32, tick: int = 0,
               t: float = 0.0, F=None, t_part=None) -> SimState:
    """Build a state from array-likes (numpy arrays or tensors)."""
    R = torch.as_tensor(R).to(device=device, dtype=dtype)
    V = torch.as_tensor(V).to(device=device, dtype=dtype)
    psi = torch.as_tensor(psi).to(device=device, dtype=complex_dtype(dtype))
    n = R.shape[0]
    F = (torch.zeros_like(R) if F is None
         else torch.as_tensor(F).to(device=device, dtype=dtype))
    t_part = (torch.zeros(n, device=device, dtype=dtype) if t_part is None
              else torch.as_tensor(t_part).to(device=device, dtype=dtype))
    return SimState(R=R.contiguous(), V=V.contiguous(), F=F.contiguous(),
                    psi=psi.contiguous(), t_part=t_part.contiguous(),
                    tick=int(tick), t=float(t))
