"""Frozen-gas initializer of the cooling family.

Counterpart of ``mdqtplasmasims_tpu/core/init.py:31-93``: uniform positions
in the L^3 cell, zero velocities, random S-manifold superpositions
(laserCoolingPlusExpansionMDQTSpeedUp.cpp:289-348).  ``exact_n=True`` pins
N = N0; otherwise N ~ Binomial(N9L, 1/729) is drawn on the host as the
reference does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..state import complex_dtype
from ..units import PlasmaUnits
from .qt import random_s_superposition


def sample_cell_count(rng: np.random.Generator, n0: int) -> int:
    """Number of ions falling in the unit cell when N9L = 729*N0 candidates
    are scattered over a 9L box (laserCooling...SpeedUp.cpp:299-308)."""
    L = PlasmaUnits.box_length(n0)
    n9l = int(9.0 ** 3 * L ** 3 * 3.0 / (4.0 * math.pi))  # = 729*N0
    return int(rng.binomial(n9l, 1.0 / 729.0))            # p = L^3/(9L)^3


def poisson_member_mask(n0: int, n_members: int, seed: int,
                        round_to: int = 1):
    """``[E, n_arr]`` real-ion mask with per-member Poissonian counts, the
    fixed-shape ensemble fold's stand-in for the reference's per-job init
    draw (one :func:`sample_cell_count` per array job, from
    ``np.random.default_rng(seed)``, so the counts equal the JAX
    package's for the same seed).  ``round_to`` rounds the padded lane
    count up.  Returns ``(mask float32 ndarray, counts list)``."""
    rng = np.random.default_rng(seed)
    n_js = [sample_cell_count(rng, n0) for _ in range(n_members)]
    n_arr = -(-max(n_js) // round_to) * round_to
    m = np.zeros((n_members, n_arr), np.float32)
    for j, nj in enumerate(n_js):
        m[j, :nj] = 1.0
    return m, n_js


def frozen_gas_init(generator: torch.Generator, n0: int, *,
                    n_states: int = 0, exact_n: bool = True,
                    dtype=torch.float32,
                    seed_for_count: Optional[int] = None,
                    n: Optional[int] = None):
    """Positions, velocities (=0) and wavefunctions for a frozen-gas start,
    drawn from ``generator`` on its device.  ``n`` draws that many ions in
    the n0 cell instead (a Poissonian fold's padded width).  Returns
    ``(R, V, psi, n_actual)``; ``psi`` is None when ``n_states`` is 0."""
    L = PlasmaUnits.box_length(n0)
    if n is None:
        n = (n0 if exact_n else
             sample_cell_count(np.random.default_rng(seed_for_count), n0))
    device = generator.device
    R = torch.rand((n, 3), generator=generator, dtype=dtype,
                   device=device) * L
    V = torch.zeros((n, 3), dtype=dtype, device=device)
    psi = (random_s_superposition(generator, n, n_states,
                                  complex_dtype(dtype))
           if n_states else None)
    return R, V, psi, n
