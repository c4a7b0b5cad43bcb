"""Device meshes driven from one process.

Counterpart of ``mdqtplasmasims_tpu/parallel/mesh.py``.  The framework's
parallelism axes (SURVEY.md section 2) are

* ``ens``  — independent stochastic realizations (the reference's SLURM job
  array); pure data parallelism, no collectives;
* ``ions`` — sharding of each member's ion axis for the O(N^2) force
  kernel; the force refresh gathers (or circulates) positions over it.

The JAX package runs one program over a ``jax.sharding.Mesh`` with
``shard_map``.  The port is single-controller too: a :class:`Mesh` is a
``[n_ens, n_ions]`` grid of device *slots*, and one process steps every
slot in turn.  Several slots may name the same device: on the CPU that
stands in for the JAX package's virtual devices, and on one card it runs
the real shard shapes of a multi-card layout.  The only collectives,
``all_gather`` and ``ppermute`` over the ion axis, are explicit tensor
copies between slots.

Single device (the reference-parity mode) is mesh (1, 1).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..state import SimState

ENS_AXIS = "ens"
ION_AXIS = "ions"


def factor_devices(n: int, max_ion_shards: int = 4) -> Tuple[int, int]:
    """Split n devices into (ens, ions).  Ensemble parallelism needs no
    collectives, so the ion axis takes the *smallest* non-trivial factor
    (capped at max_ion_shards) and the ensemble axis the rest; e.g. 8 ->
    (ens=4, ions=2)."""
    ions = 1
    for cand in range(2, min(max_ion_shards, n) + 1):
        if n % cand == 0:
            ions = cand
            break
    return n // ions, ions


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``[n_ens, n_ions]`` grid of device slots; ``devices[k][i]`` holds
    member block k's ion shard i."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape`` gives them."""
        return {ENS_AXIS: len(self.devices), ION_AXIS: len(self.devices[0])}

    @property
    def home(self) -> torch.device:
        """Slot (0, 0)'s device: where the joined fold lives between
        segments and where the samples are taken."""
        return self.devices[0][0]

    def slots(self):
        """``(k, i, device)`` of every slot, ens-major."""
        return [(k, i, d) for k, row in enumerate(self.devices)
                for i, d in enumerate(row)]


def make_mesh(n_ens: Optional[int] = None, n_ions: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``n_ens x n_ions`` slots.  ``devices=None`` takes distinct
    visible cards (``cuda:0 ..``) and raises when there are fewer than
    ``n_ens * n_ions``; an explicit list (of ``torch.device``s or names)
    may repeat a device.  ``n_ens`` defaults to as many as the devices
    fill."""
    if devices is None:
        devices = [torch.device("cuda", j)
                   for j in range(torch.cuda.device_count())]
        if n_ens is not None and len(devices) < n_ens * n_ions:
            raise ValueError(
                f"a {n_ens} x {n_ions} mesh of distinct cards needs "
                f"{n_ens * n_ions}, {len(devices)} visible; pass devices= "
                "to place several slots on one device")
    devices = [torch.device(d) for d in devices]
    if n_ens is None:
        n_ens = len(devices) // n_ions
    if n_ens < 1 or n_ions < 1 or len(devices) < n_ens * n_ions:
        raise ValueError(f"{len(devices)} devices cannot fill a {n_ens} x "
                         f"{n_ions} mesh")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"mesh slots mix device types: {devices}")
    grid = tuple(tuple(devices[k * n_ions:(k + 1) * n_ions])
                 for k in range(n_ens))
    return Mesh(grid)


def split_grid(x: torch.Tensor, mesh: Mesh, ions: bool = True):
    """``[E, N, ...]`` (``ions``) or ``[E, ...]`` -> the ``[K][I]`` grid of
    slot blocks on their devices: member block k (and ion shard i)."""
    K, I = mesh.shape[ENS_AXIS], mesh.shape[ION_AXIS]
    E = x.shape[0]
    if E % K or (ions and x.shape[1] % I):
        raise ValueError(f"shape {tuple(x.shape)} does not divide over the "
                         f"mesh {mesh.shape}")
    e, n = E // K, (x.shape[1] // I if ions else None)
    return [[(x[k * e:(k + 1) * e, i * n:(i + 1) * n] if ions
              else x[k * e:(k + 1) * e]).to(d).contiguous()
             for i, d in enumerate(row)]
            for k, row in enumerate(mesh.devices)]


def split_state(states: SimState, mesh: Mesh) -> List[List[SimState]]:
    """Fold ``[E, N, ...]`` -> ``[K][I]`` grid of slot states ``[E/K,
    N/I, ...]`` (the JAX package's ``state_pspec``: members over ``ens``,
    ions over ``ions``; the tick is shared)."""
    parts = {f: split_grid(getattr(states, f), mesh)
             for f in ("R", "V", "F", "psi", "t_part")}
    return [[SimState(**{f: parts[f][k][i] for f in parts},
                      tick=states.tick, t=states.t)
             for i in range(len(row))]
            for k, row in enumerate(mesh.devices)]


def join_state(blocks: List[List[SimState]], device) -> SimState:
    """The inverse of :func:`split_state`, on ``device``."""
    def join(f):
        return torch.cat([torch.cat([getattr(b, f).to(device) for b in row],
                                    dim=1) for row in blocks], dim=0)
    b0 = blocks[0][0]
    return SimState(R=join("R"), V=join("V"), F=join("F"), psi=join("psi"),
                    t_part=join("t_part"), tick=b0.tick, t=b0.t)


def all_gather(shards: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """The ion axis's ``all_gather(tiled=True)``: every shard's slot gets
    the concatenation of all shards along ``dim`` (one copy per distinct
    device)."""
    out, by_dev = [], {}
    for s in shards:
        if s.device not in by_dev:
            by_dev[s.device] = torch.cat([x.to(s.device) for x in shards],
                                         dim)
        out.append(by_dev[s.device])
    return out


def ppermute(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The ring hop ``perm = [(i, i+1 mod k)]``: slot i+1 receives slot
    i's tensor (moved to its device)."""
    k = len(shards)
    return [shards[(i - 1) % k].to(shards[i].device) for i in range(k)]
