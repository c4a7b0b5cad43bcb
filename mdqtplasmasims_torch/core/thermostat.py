"""Collision thermostat and temperature-anisotropy drives.

Counterpart of ``mdqtplasmasims_tpu/core/thermostat.py``.  References
(MonteCarloFollowedByMDAndTempAnisotropy.cpp):
  collision resample inside stepVelocities  :469-502
  anisotropizeVelocities                    :548-558
  anisotropic heating/cooling force (beta)  :488-498, constants :96-107

Every function takes one trajectory ``[N, 3]`` or a fold ``[E, N, 3]``;
a fold's per-member Gamma is an ``[E]`` tensor.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..ops.member_sum import ion_mean


def collide_and_kick(V_verlet: torch.Tensor,
                     draws: Optional[Tuple[torch.Tensor, torch.Tensor]], *,
                     dt: float, collision_freq: float,
                     gamma) -> torch.Tensor:
    """Collision branch of stepVelocities: with probability
    ``dt*collision_freq`` a particle's velocity is *replaced* by a fresh
    MB draw (spread sqrt(1/Gamma)) instead of the Verlet update.

    ``draws``: a uniform per ion and three unit normals, ``(u [..., N], z
    [..., N, 3])`` (core/draws.MemberDraws.md_step, which draws nothing
    when a step has no collisions: then None, with ``collision_freq``
    0).  ``gamma`` is a float or a per-member ``[E]`` tensor."""
    if collision_freq == 0.0:
        return V_verlet
    u, z = draws
    coll = u < dt * collision_freq
    if isinstance(gamma, torch.Tensor):
        vt = torch.sqrt(1.0 / gamma).to(V_verlet.dtype)[:, None, None]
    else:
        vt = math.sqrt(1.0 / gamma)
    fresh = z.to(V_verlet.dtype) * vt
    return torch.where(coll[..., None], fresh, V_verlet)


def laser_force(V: torch.Tensor, *, dt: float, beta: float, density: float,
                one_axis_only: bool = False) -> torch.Tensor:
    """Anisotropic heating/cooling force: dv = v*dt*1.234e-6*beta/sqrt(n)
    applied on x only, or energy-balanced (+1/2 on x, -1/4 on y,z)
    (MonteCarlo...cpp:488-498)."""
    c = dt * 1.234e-6 * beta / math.sqrt(density)
    axes = [1.0, 0.0, 0.0] if one_axis_only else [0.5, -0.25, -0.25]
    scale = torch.tensor(axes, dtype=V.dtype, device=V.device) * c
    return V + V * scale


def anisotropize_velocities(V: torch.Tensor,
                            temp_percent_diff: float) -> torch.Tensor:
    """Instantaneous rescale: x by sqrt(1+d), y/z by sqrt(1-d/2)
    (MonteCarlo...cpp:548-558)."""
    d = temp_percent_diff
    s = torch.tensor([math.sqrt(1.0 + d), math.sqrt(1.0 - d / 2.0),
                      math.sqrt(1.0 - d / 2.0)], dtype=V.dtype,
                     device=V.device)
    return V * s


def temperature(V: torch.Tensor) -> torch.Tensor:
    """<v^2> over all components (recordTemperature, :525-546); ``[E]`` for
    a fold."""
    return ion_mean(V * V, dim=(-2, -1))


def temperature_per_axis(V: torch.Tensor) -> torch.Tensor:
    """Per-axis <v_a^2> (recordTempForEachAxis, :560-581): ``[3]``, or
    ``[E, 3]`` for a fold."""
    return ion_mean(V * V, dim=-2)
