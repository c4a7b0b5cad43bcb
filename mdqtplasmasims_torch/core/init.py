"""System initializers.

Counterpart of ``mdqtplasmasims_tpu/core/init.py``:

1. Frozen-gas random cell of the cooling and frozen-start families:
   uniform positions in the L^3 cell, zero velocities, random S-manifold
   superpositions (laserCoolingPlusExpansionMDQTSpeedUp.cpp:289-348).
   ``exact_n=True`` pins N = N0; otherwise N ~ Binomial(N9L, 1/729) is
   drawn on the host as the reference does.
2. Cubic lattice + Maxwell-Boltzmann velocities of the Monte-Carlo
   families (MonteCarloFollowedByMDAndTempAnisotropy.cpp:173-203).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def frozen_gas_positions(generator: torch.Generator, n: int, L: float,
                         dtype=torch.float32) -> torch.Tensor:
    """n uniform positions in (0, L)^3, drawn from ``generator`` on its
    device."""
    return torch.rand((n, 3), generator=generator, dtype=dtype,
                      device=generator.device) * L


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
    R = frozen_gas_positions(generator, n, L, dtype)
    V = torch.zeros((n, 3), dtype=dtype, device=device)
    psi = (random_s_superposition(generator, n, n_states,
                                  complex_dtype(dtype))
           if n_states else None)
    return R, V, psi, n


def lattice_init(generator: Optional[torch.Generator], n: int, gamma: float,
                 L: float, dtype=torch.float32, device=None,
                 V: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cubic lattice positions (spacing ``L/side``, offset +0.5) and MB
    velocities with spread sqrt(1/Gamma)
    (MonteCarloFollowedByMDAndTempAnisotropy.cpp:173-203).  ``n`` must be
    a perfect cube.  The unit normals of V are drawn from ``generator`` on
    its device, or given as ``V [n, 3]`` (scaled here as drawn ones are);
    ``device`` defaults to the generator's."""
    side = round(n ** (1.0 / 3.0))
    if side ** 3 != n:
        raise ValueError(f"lattice_init needs a cubic N, got {n}")
    if device is None:
        device = generator.device
    idx = torch.arange(side, dtype=dtype, device=device)
    ii, jj, kk = torch.meshgrid(idx, idx, idx, indexing="ij")
    spacing = L / side
    R = torch.stack([ii.reshape(-1) * spacing + 0.5,
                     jj.reshape(-1) * spacing + 0.5,
                     kk.reshape(-1) * spacing + 0.5], dim=-1)
    if V is None:
        V = torch.randn((n, 3), generator=generator, dtype=dtype,
                        device=device)
    # the spread is rounded to dtype first, as the JAX package does
    vt = float(np.asarray(math.sqrt(1.0 / gamma), _np_dtype(dtype)))
    return R, torch.as_tensor(V).to(device=device, dtype=dtype) * vt


def mb_velocities(generator: torch.Generator, n: int, sigma: float,
                  dtype=torch.float32) -> torch.Tensor:
    """Maxwell-Boltzmann velocities with per-axis spread sigma, drawn on
    the generator's device."""
    z = torch.randn((n, 3), generator=generator, dtype=dtype,
                    device=generator.device)
    return z * float(np.asarray(sigma, _np_dtype(dtype)))


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32
