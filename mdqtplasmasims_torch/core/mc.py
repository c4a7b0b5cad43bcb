"""Metropolis Monte Carlo equilibrator for the Yukawa OCP.

Counterpart of ``mdqtplasmasims_tpu/core/mc.py`` (reference:
MonteCarloFollowedByMDAndTempAnisotropy.cpp:315-382, ``MonteCarloStep``,
duplicated in the MC-tagging family).  Single-particle trial moves
uniform in a sphere of radius ``max_r_step``; acceptance by the Boltzmann
factor of the single-counted energy change ``exp(-dU*Gamma)`` (the
reference's double-counted ``exp(-(diff/2)*Gamma)``, :355), ``dU`` from
one O(N) row of pair energies per step.

The chain is sequential (each accept changes the landscape of the next
move).  The JAX package runs it as XLA, so here it is plain torch, not a
kernel: a host loop of ~40 small ops per step over a leading member axis
``[E, N, 3]`` (per-member Gamma and screening length: the folds), with no
host sync per step (the move is applied with ``torch.where`` and
``index_copy_``).  A chunk's draws come in bulk before its loop
(:func:`draw_mc` from one generator per member), or from the caller
(:class:`McDraws`: a test replays the JAX package's per-step keys).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from .md import wrap_pbc
from ..ops.member_sum import ion_sum


class McDraws(NamedTuple):
    """A chunk's draws, step-major: the ion ``i [T, E]`` (int64), the
    unnormalized direction ``d [T, E, 3]`` (normals), the radius uniform
    ``ur [T, E]`` and the acceptance uniform ``ua [T, E]``.  The move is
    computed in the draws' float type and cast to the positions'."""
    i: torch.Tensor
    d: torch.Tensor
    ur: torch.Tensor
    ua: torch.Tensor


def draw_mc(generators: Sequence[torch.Generator], n_steps: int, n: int,
            dtype=torch.float32) -> McDraws:
    """``n_steps`` steps of draws for each member, member j from
    ``generators[j]`` on its device, in the order i, d, ur, ua."""
    per = []
    for g in generators:
        kw = dict(generator=g, device=g.device)
        per.append((torch.randint(0, n, (n_steps,), **kw),
                    torch.randn((n_steps, 3), dtype=dtype, **kw),
                    torch.rand((n_steps,), dtype=dtype, **kw),
                    torch.rand((n_steps,), dtype=dtype, **kw)))
    return McDraws(*(torch.stack(x, dim=1) for x in zip(*per)))


def _pair_u_rows(R: torch.Tensor, P: torch.Tensor, L: float,
                 ldeb: torch.Tensor, rcut2: float,
                 self_idx: torch.Tensor) -> torch.Tensor:
    """Yukawa potential of the points ``P [E, K, 3]`` against every
    particle of ``R [E, N, 3]`` with ion ``self_idx [E]`` masked:
    ``[E, K, N]`` (the JAX package's ``_pair_u_row``, one row per point;
    ``ldeb [E]``)."""
    d = P[:, :, None, :] - R[:, None, :, :]
    d = d - L * torch.round(d / L)
    dx, dy, dz = d.unbind(-1)
    r2 = dx * dx + dy * dy + dz * dz
    n = R.shape[1]
    cols = torch.arange(n, device=R.device)
    valid = (r2 < rcut2) & (cols != self_idx[:, None, None])
    r = torch.sqrt(torch.where(valid, r2, torch.ones_like(r2)))
    u = torch.exp(-r / ldeb[:, None, None]) / r
    return torch.where(valid, u, torch.zeros_like(u))


def _per_member(x, e: int, ref: torch.Tensor) -> torch.Tensor:
    """A float or per-member sequence/tensor -> ``[E]`` in ref's dtype and
    device (a float rounds to the dtype as the JAX package's weakly typed
    scalars do)."""
    t = torch.as_tensor(x, dtype=torch.float64).to(ref.device)
    return t.expand(e).to(ref.dtype) if t.dim() == 0 else t.to(ref.dtype)


@dataclasses.dataclass(frozen=True)
class MetropolisMC:
    """``ldeb`` (1/kappa) and ``gamma`` are floats or, for a fold, per-member
    sequences / ``[E]`` tensors."""

    L: float
    ldeb: Union[float, Sequence[float], torch.Tensor]
    gamma: Union[float, Sequence[float], torch.Tensor]
    max_r_step: float = 0.3   # MonteCarlo...cpp:81

    def sphere_move(self, d: torch.Tensor, ur: torch.Tensor) -> torch.Tensor:
        """Uniform displacement inside a sphere of radius max_r_step from
        normals ``d [..., 3]`` and uniforms ``ur [...]``."""
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        return d * self.max_r_step * (ur ** (1.0 / 3.0))[..., None]

    def run(self, R: torch.Tensor, generators=None, n_steps: int = 0,
            draws: Optional[McDraws] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``n_steps`` Metropolis moves of ``R [N, 3]`` (one generator) or
        of each member of ``R [E, N, 3]`` (one generator per member), or
        the steps of ``draws`` (:class:`McDraws`; for ``[N, 3]`` the
        member axis may be left out).  Returns ``(R, n_accepted)``, the
        count int32, ``[E]`` for a fold; no host sync."""
        fold = R.dim() == 3
        Rf = R if fold else R[None]
        e, n, _ = Rf.shape
        if draws is None:
            gens = (list(generators) if isinstance(generators, (list, tuple))
                    else [generators])
            draws = draw_mc(gens, n_steps, n, Rf.dtype)
        i, d, ur, ua = draws
        if i.dim() == 1:
            i, d, ur, ua = i[:, None], d[:, None], ur[:, None], ua[:, None]
        i = i.to(Rf.device)
        move = self.sphere_move(d, ur).to(device=Rf.device, dtype=Rf.dtype)
        ua = ua.to(Rf.device)
        gamma = _per_member(self.gamma, e, Rf)
        ldeb = _per_member(self.ldeb, e, Rf)
        rcut2 = (self.L / 2.0) ** 2
        base = torch.arange(e, device=Rf.device) * n
        flat = Rf.reshape(e * n, 3).clone()
        view = flat.view(e, n, 3)
        n_acc = torch.zeros(e, dtype=torch.int32, device=Rf.device)
        for k in range(i.shape[0]):
            rows = base + i[k]
            old = flat.index_select(0, rows)
            new = wrap_pbc(old + move[k], self.L)
            u = ion_sum(_pair_u_rows(view, torch.stack([old, new], 1),
                                     self.L, ldeb, rcut2, i[k]), dim=-1)
            du = u[:, 1] - u[:, 0]
            accept = (du < 0) | (ua[k] < torch.exp(-du * gamma))
            flat.index_copy_(0, rows, torch.where(accept[:, None], new, old))
            n_acc += accept
        return (view if fold else view[0]), (n_acc if fold else n_acc[0])
