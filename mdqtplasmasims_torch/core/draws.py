"""The random draws of the Monte-Carlo families.

A job of ``experiments/mc_md_anisotropy.py`` or
``experiments/mc_qt_tagging.py`` draws seven kinds of random numbers:
start velocities, start wavefunctions, Metropolis chunks, collision kicks,
classical tags, pump ticks and the projective measurement.  Both families
ask one object for all of them, with a leading member axis (E = 1 for a
single job).  :class:`MemberDraws` draws each from one ``torch.Generator``
per member on that generator's device, in the order the stages ask; a
test replays another implementation's draws through an object with the
same methods (the JAX package's key chain, whose ``key_state`` then rides
the pipeline checkpoint as ``k_run``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .mc import McDraws, draw_mc
from .qt import random_s_superposition
from .scheduler import tick_major_rolls


class MemberDraws:
    """Member j's draws from ``generators[j]``, on that generator's
    device."""

    def __init__(self, generators: Sequence[torch.Generator]):
        self.generators = list(generators)

    def _stack(self, draw, dim: int = 0) -> torch.Tensor:
        return torch.stack([draw(g) for g in self.generators], dim=dim)

    def start_v(self, n: int, dtype) -> torch.Tensor:
        """``[E, n, 3]`` unit normals of the lattice start's velocities."""
        return self._stack(lambda g: torch.randn(
            (n, 3), generator=g, dtype=dtype, device=g.device))

    def psi(self, n: int, n_states: int, cdtype) -> torch.Tensor:
        """``[E, n, S]`` random S-manifold superpositions."""
        return self._stack(lambda g: random_s_superposition(g, n, n_states,
                                                            cdtype))

    def mc(self, n_steps: int, n: int, dtype) -> McDraws:
        """One Metropolis chunk, ``[T, E, ...]``."""
        return draw_mc(self.generators, n_steps, n, dtype)

    def md_step(self, n: int, dtype, collide: bool):
        """One velocity-Verlet step's collision draws ``(u [E, n], z [E,
        n, 3])``, or None (and nothing drawn) when the step has no
        collisions."""
        if not collide:
            return None
        u = self._stack(lambda g: torch.rand((n,), generator=g, dtype=dtype,
                                             device=g.device))
        z = self._stack(lambda g: torch.randn((n, 3), generator=g,
                                              dtype=dtype, device=g.device))
        return u, z

    def tags(self, n: int, dtype) -> torch.Tensor:
        """``[E, 4, n]`` uniforms of the four classical taggings."""
        return self._stack(lambda g: torch.rand((4, n), generator=g,
                                                dtype=dtype, device=g.device))

    def pump(self, ratio: int, lanes) -> torch.Tensor:
        """One pump MD step's ``[ratio, 5, E, n]`` uniforms, each member's
        drawn tick-major (``MCTagScheduler``'s ``rolls_fn``)."""
        return self._stack(lambda g: tick_major_rolls(g)(ratio, lanes[-1:]),
                           dim=2)

    def measure(self, lanes, dtype) -> torch.Tensor:
        """``[E, n]`` uniforms of the projective measurement."""
        return self._stack(lambda g: torch.rand(
            tuple(lanes[-1:]), generator=g, dtype=dtype, device=g.device))

    def key_state(self) -> Optional[np.ndarray]:
        """The replayed chain's key for a checkpoint's ``k_run``; None here
        (the generators' state rides the checkpoint instead)."""
        return None
