"""Classical MD pieces of the cooling family: leapfrog with periodic
re-insertion, and the per-axis kinetic energies.

Counterpart of ``mdqtplasmasims_tpu/core/md.py`` (leapfrog split steps:
laserCoolingPlusExpansionMDQTSpeedUp.cpp:356-430).  Layout-agnostic: the
functions are elementwise, so they take ``[N, 3]`` or ``[3, N]`` alike.
"""

from __future__ import annotations

from typing import Optional

import torch


def wrap_pbc(R: torch.Tensor, L: float) -> torch.Tensor:
    """Pac-man re-insertion after a drift (laserCooling...SpeedUp.cpp:381-389).

    A single +-L shift, not a modulo, as in the reference: a particle
    leaves the cell by less than L per drift."""
    R = torch.where(R < 0, R + L, R)
    return torch.where(R > L, R - L, R)


def step_R(R, V, F, dt_half: float, L: float, first_step: bool):
    """Half drift.  On the very first step (t == 0) the reference uses the
    2nd-order form R += dt*V + dt^2*F (laserCooling...SpeedUp.cpp:370-378)."""
    drift = dt_half * V
    if first_step:
        drift = drift + (dt_half * dt_half) * F
    return wrap_pbc(R + drift, L)


def leapfrog_substep(R, V, F, dt: float, L: float, first_step: bool = False):
    """One kick-drift-kick leapfrog step with *fixed* forces F (forces are
    refreshed once per full MD step, laserCooling...SpeedUp.cpp:418-430)."""
    R = step_R(R, V, F, 0.5 * dt, L, first_step)
    V = V + dt * F
    R = step_R(R, V, F, 0.5 * dt, L, first_step)
    return R, V


def kinetic_energies(V: torch.Tensor, subtract_mean_vx: bool = False,
                     mask: Optional[torch.Tensor] = None):
    """Per-axis mean kinetic energies of ``V [N, 3]`` (output():930-947).
    In the expansion frame the x-axis subtracts the ensemble-mean vx.
    Returns ``(ekx, eky, ekz, vx_mean)`` as 0-d tensors."""
    if mask is None:
        vx_mean = torch.mean(V[:, 0])
        Vx = V[:, 0] - vx_mean if subtract_mean_vx else V[:, 0]
        ek = [torch.mean(0.5 * Vx ** 2), torch.mean(0.5 * V[:, 1] ** 2),
              torch.mean(0.5 * V[:, 2] ** 2)]
    else:
        n_eff = torch.sum(mask)
        vx_mean = torch.sum(V[:, 0] * mask) / n_eff
        Vx = V[:, 0] - vx_mean if subtract_mean_vx else V[:, 0]
        ek = [torch.sum(0.5 * Vx ** 2 * mask) / n_eff,
              torch.sum(0.5 * V[:, 1] ** 2 * mask) / n_eff,
              torch.sum(0.5 * V[:, 2] ** 2 * mask) / n_eff]
    return ek[0], ek[1], ek[2], vx_mean
