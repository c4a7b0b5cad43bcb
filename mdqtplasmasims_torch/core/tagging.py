"""Velocity tagging: classical moment-based and quantum projective.

Counterpart of ``mdqtplasmasims_tpu/core/tagging.py``.  References:
  classical 4-power tagging   MonteCarloFollowedByMDAndTempAnisotropy.cpp:810-921
  projective 408 tagging      MonteCarloFollowedByQTTagging408Quad.cpp:1021-1066
  projective 422 measurement  randomFrozenStartTag422Linear.cpp:568-627
  tagged-moment recorders     MonteCarlo...cpp:923-1028, 408Quad:1068-1141
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.member_sum import ion_sum


def tag_classical(vx: torch.Tensor, generator: Optional[torch.Generator],
                  gamma: float, rolls: Optional[torch.Tensor] = None):
    """The four classical taggings with P(tag) ~ 1/2 + c_k (vx/vT)^k.

    Returns (tag1, tag2, tag3, tag4) boolean tensors.  Odd powers saturate
    to tagged/untagged beyond +-3 vT; even powers fall back to a fair coin
    there (MonteCarlo...cpp:810-921).  The four uniforms are one ``(4,
    n)`` block drawn from ``generator`` on vx's device, or given as
    ``rolls``."""
    vt = math.sqrt(1.0 / gamma)
    if rolls is None:
        rolls = torch.rand((4, vx.shape[0]), generator=generator,
                           dtype=vx.dtype, device=vx.device)
    r1, r2, r3, r4 = rolls
    x = vx / vt
    inside = torch.abs(x) < 3.0

    p1 = 0.5 + x / 6.0
    tag1 = torch.where(inside, r1 < p1, x > 3.0)

    p2 = 0.5 / 9.0 * x * x
    tag2 = torch.where(inside, r2 < p2, r2 >= 0.5)

    p3 = 0.5 + 0.5 / 27.0 * x ** 3
    tag3 = torch.where(inside, r3 < p3, x > 3.0)

    p4 = 0.5 / 81.0 * x ** 4
    tag4 = torch.where(inside, r4 < p4, r4 >= 0.5)
    return tag1, tag2, tag3, tag4


def spin_up_probability_408(psi: torch.Tensor) -> torch.Tensor:
    """P(measure spin-up) for the 7-state 408 scheme: |1> and |3> count
    fully, |4> with weight 2/3, |5> with 1/3 (C-G weights of the P3/2
    sublevels; MonteCarlo...408Quad.cpp:1026-1062).  psi: [..., N, S]."""
    pop = psi.real ** 2 + psi.imag ** 2
    return (pop[..., 0] + pop[..., 2] + (2. / 3) * pop[..., 3]
            + (1. / 3) * pop[..., 4])


def spin_up_probability_422(psi: torch.Tensor) -> torch.Tensor:
    """P(spin-up) for the 5-state 422 scheme: |1> fully, |3> with 1/3,
    |4> with 2/3 (randomFrozenStartTag422Linear.cpp:568-610).  psi:
    [..., N, S]."""
    pop = psi.real ** 2 + psi.imag ** 2
    return pop[..., 0] + (1. / 3) * pop[..., 2] + (2. / 3) * pop[..., 3]


def projective_tag(psi: torch.Tensor, generator: Optional[torch.Generator],
                   scheme_name: str,
                   rolls: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single projective measurement: tag ~ Bernoulli(P(spin-up)), the
    uniforms from ``generator`` on psi's device or given as ``rolls``."""
    if scheme_name.startswith("tag408"):
        p = spin_up_probability_408(psi)
    elif scheme_name.startswith("tag422"):
        p = spin_up_probability_422(psi)
    else:
        raise ValueError(scheme_name)
    if rolls is None:
        rolls = torch.rand(p.shape, generator=generator, dtype=p.dtype,
                           device=p.device)
    return rolls < p


def tagged_moments(vx: torch.Tensor, tags: torch.Tensor,
                   subtract_equilibrium: bool = False,
                   gamma: float = 1.0) -> torch.Tensor:
    """[4] first..fourth moments of the tagged subset's vx (``[..., 4]``
    for ``vx``, ``tags`` of ``[..., N]``: the sums run over the last
    axis).  The pure-MD recorder subtracts the equilibrium values 1/Gamma
    (2nd) and 3/Gamma^2 (4th) (MonteCarlo...cpp:972-998); the tagging
    files do not."""
    w = tags.to(vx.dtype)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    m = torch.stack([ion_sum(w * vx ** k, dim=-1) / n
                     for k in (1, 2, 3, 4)], dim=-1)
    if subtract_equilibrium:
        m = m - torch.tensor([0.0, 1.0 / gamma, 0.0, 3.0 / gamma ** 2],
                             dtype=vx.dtype, device=vx.device)
    return m
