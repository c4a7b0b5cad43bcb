"""Ensemble + ion-sharded execution over a device mesh.

Counterpart of ``mdqtplasmasims_tpu/parallel/ensemble.py``.  Trajectories
are split over the mesh's ``ens`` axis and each member's ion axis may be
split over ``ions``; every slot advances its block of the fold through
the same kernels a single fold runs (the tick kernel and a force kernel
per MD step), and the force refresh couples the ion shards of a member
through the ion axis's collectives.  The per-slot work here serves both
ways a mesh runs: one process stepping all slots in lockstep, the
collectives copies between slots (parallel/mesh.py), or one process a
slot, as the JAX package's one SPMD program runs, the collectives
torch.distributed's (parallel/ranks.py).

Randomness: the fold keeps one generator and one seed word.  Each slot
draws the uniforms of the lanes it holds in the fold's *global* lane
numbering (:func:`shard_keys`): slot (k, i) holds lanes ``lane0 ..
lane0 + E_loc*Np`` with ``lane0 = (k*I + i) * E_loc * Np``.  The
in-kernel stream takes ``lane0`` as an argument; explicit rolls are drawn
once per MD step for all lanes and sliced per slot.  On an ens-only mesh
(I = 1) this numbering is the unsharded fold's, so every member's
trajectory is independent of how the members are laid out.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.scheduler import CoolingScheduler, fold_sweep_lanes
from ..ops.yukawa import (yukawa_forces_cross_n3l_soa_batched,
                          yukawa_forces_n3l_soa,
                          yukawa_forces_n3l_soa_batched,
                          yukawa_forces_potential,
                          yukawa_forces_soa_cols_batched)
from ..state import SimState
from .mesh import (ENS_AXIS, ION_AXIS, Mesh, all_gather, join_state,
                   ppermute, slot_block, split_state)


def batched_initial_states(init_one: Callable[[int], SimState],
                           seeds) -> SimState:
    """Stack ``init_one(seed)`` over per-job seeds -> SimState ``[E, ...]``."""
    members = [init_one(int(s)) for s in seeds]
    return SimState(**{f: torch.stack([getattr(m, f) for m in members])
                       for f in ("R", "V", "F", "psi", "t_part")},
                    tick=members[0].tick, t=members[0].t)


def shard_keys(word: int, n_ens: int, mesh: Mesh, npad: int):
    """The stream coordinates of every (member, ion shard) block, the
    counterpart of the JAX package's per-(job, shard) keys: ``(lane0
    [E, I], words [E, I])``, the global lane of the block's first lane
    (slot-major: ``((k*I + i)*E_loc + e)*npad`` for member ``k*E_loc +
    e``) and the in-kernel stream's seed word (the fold's, shared by all
    blocks, whose lanes keep the streams apart)."""
    K, I = mesh.shape[ENS_AXIS], mesh.shape[ION_AXIS]
    if n_ens % K:
        raise ValueError(f"{n_ens} members do not divide over {K} ens slots")
    e_loc = n_ens // K
    m = np.arange(n_ens)[:, None]
    i = np.arange(I)[None, :]
    lane0 = (((m // e_loc) * I + i) * e_loc + m % e_loc) * npad
    return lane0.astype(np.int64), np.full((n_ens, I), int(word), np.int64)


def _unfold_rows(Rp: torch.Tensor, e_loc: int, npad: int, n: int):
    """``[3, E*npad]`` lanes -> ``[E, n, 3]`` positions."""
    return Rp.reshape(3, e_loc, npad)[:, :, :n].permute(1, 2, 0)


def _plain_only(devices, what: str) -> None:
    """The XLA-path functions are plain torch, the CPU reference of the
    mesh path; on the card the mesh steps through kernels E and F
    (:func:`fused_local_stepper`)."""
    bad = sorted({str(d) for d in devices if torch.device(d).type != "cpu"})
    if bad:
        raise ValueError(f"{what} is the plain CPU reference of the mesh "
                         f"path, got {bad}; use make_sharded_fused_step or "
                         "run_ensemble(mesh=) on the card")


def sharded_forces_fn(L: float, ldeb: float, chunk: int = 512):
    """Row-sharded XLA-path forces: ``fn(R_shards)`` takes one member's
    ion shards ``[n_loc, 3]`` (one per ion slot) and returns each shard's
    ``(F, pot)`` rows against the all-gathered global positions.  CPU
    tensors only."""
    def fn(R_shards):
        _plain_only([R.device for R in R_shards], "sharded_forces_fn")
        R_full = all_gather(R_shards, 0)
        return [yukawa_forces_potential(R, L, ldeb, chunk=chunk, cols=Rf)
                for R, Rf in zip(R_shards, R_full)]
    return fn


def ring_forces_fn(L: float, ldeb: float, chunk: int = 512):
    """Ring-permute XLA-path forces: instead of gathering the global
    positions, position blocks circulate the ring (``ppermute``) and each
    shard accumulates its rows' partial forces; peak memory per slot
    O(N/k).  Same contract as :func:`sharded_forces_fn`."""
    def fn(R_shards):
        _plain_only([R.device for R in R_shards], "ring_forces_fn")
        F = [torch.zeros_like(R) for R in R_shards]
        pot = [torch.zeros_like(R[:, 0]) for R in R_shards]
        buf = list(R_shards)
        for _ in range(len(R_shards)):
            for m, R in enumerate(R_shards):
                Fi, poti = yukawa_forces_potential(R, L, ldeb, chunk=chunk,
                                                   cols=buf[m])
                F[m], pot[m] = F[m] + Fi, pot[m] + poti
            buf = ppermute(buf)
        return list(zip(F, pot))
    return fn


class _AllSlots:
    """The single controller's side of the mesh's collectives: every slot
    is in this process, so a list holds every shard of a member block and
    the collectives are copies between slots (parallel/mesh.py).  A rank
    of a rank mesh has the same methods over its one slot
    (parallel/ranks.py ``RankComm``)."""

    @staticmethod
    def slots(mesh: Mesh):
        return mesh.slots()

    all_gather = staticmethod(all_gather)

    @staticmethod
    def hop(*bufs):
        return tuple(ppermute(b) for b in bufs)


ALL_SLOTS = _AllSlots()


def ring_n3l_fused_forces(sched: CoolingScheduler, ldeb: float, e_loc: int,
                          npad: int, mrows: List[Optional[torch.Tensor]],
                          comm=ALL_SLOTS):
    """Cross-shard Newton's-third-law force schedule of one member block
    over the ion ring: each unordered pair of ion blocks is evaluated ONCE
    and the reaction rows ride the ring back to their owner shard, where
    the gather path pays both ordered halves of every cross-shard pair.

    Shard m's own block runs the batched force kernel C locally; a
    (positions, mask, reaction) buffer then circulates the ring
    (``comm.hop``).  At hop s shard m holds the block of shard (m - s)
    mod I and computes the cross tile once with kernel F
    (:func:`yukawa_forces_cross_n3l_soa_batched`): for hops s <= (I-1)//2
    always, at the antipodal hop of an even ring (s = I/2) only on the
    lower-index shard of each pair (the JAX package's SPMD program
    computes the tile on both and masks one; here the other shard skips
    the launch), so a member's ion blocks cost I*(I-1)/2 launches of F
    per MD step.  Later hops still permute, carrying each reaction buffer
    the full I hops home, where it joins the local forces.

    ``mrows[m] [1|E_loc, npad]`` marks shard m's real ions, None for a
    shard held elsewhere (a rank holds one).  Returns ``soa_forces(Rps)
    -> Fs`` over the shards held here, in shard order: each ``Rp [3,
    E_loc*npad]`` -> its row-masked ``F [3, E_loc*npad]``."""
    k = len(mrows)
    own = [m for m, mr in enumerate(mrows) if mr is not None]

    def soa_forces(Rps):
        F = [yukawa_forces_n3l_soa_batched(R, mrows[m], e_loc, sched.L, ldeb)
             for R, m in zip(Rps, own)]
        cms = [mrows[m].expand(e_loc, npad).contiguous() for m in own]
        row_masks = [cm.reshape(1, e_loc * npad) for cm in cms]
        if k == 1:
            return [F[0] * row_masks[0]]
        buf_R = [R.reshape(3, e_loc, npad).permute(1, 2, 0).contiguous()
                 for R in Rps]                            # [E, npad, 3]
        buf_m = cms
        buf_G = [torch.zeros_like(b) for b in buf_R]
        for s in range(1, k):
            buf_R, buf_m, buf_G = comm.hop(buf_R, buf_m, buf_G)
            if s > k // 2:
                continue                 # carry the reactions home
            for j, m in enumerate(own):
                if k % 2 == 0 and s == k // 2 and m > (m - s) % k:
                    continue                 # antipodal: once per pair
                Fc, G = yukawa_forces_cross_n3l_soa_batched(
                    Rps[j], mrows[m], buf_R[j], buf_m[j], e_loc, sched.L,
                    ldeb)
                F[j] = F[j] + Fc
                buf_G[j] = buf_G[j] + G
        # one more hop completes the ring: each reaction buffer reaches
        # the shard that owns its block
        buf_G, = comm.hop(buf_G)
        return [(F[j] + buf_G[j].permute(2, 0, 1).reshape(3, e_loc * npad))
                * row_masks[j] for j in range(len(own))]
    return soa_forces


def _gather_forces(sched: CoolingScheduler, ldeb: float, e_loc: int,
                   npad: int, mrows: List[Optional[torch.Tensor]],
                   comm=ALL_SLOTS):
    """The gather schedule of one member block: every shard's rows against
    the all-gathered positions of its members (kernel E), row-masked by
    the kernel (the JAX package's full-tile kernel has no row mask and its
    caller multiplies by it: padded and masked row lanes must stay inert
    as they feed back).  ``mrows`` as for :func:`ring_n3l_fused_forces`."""
    own = [m for m, mr in enumerate(mrows) if mr is not None]
    cms = [mrows[m].expand(e_loc, npad).contiguous() for m in own]
    col_masks = comm.all_gather(cms, 1)            # [E, I*npad] per slot

    def soa_forces(Rps):
        cols = comm.all_gather([R.reshape(3, e_loc, npad).permute(1, 2, 0)
                                for R in Rps], 1)  # [E, I*npad, 3]
        return [yukawa_forces_soa_cols_batched(R, c.contiguous(), cm, e_loc,
                                               sched.L, ldeb,
                                               row_mask=mrows[m])
                for R, c, cm, m in zip(Rps, cols, col_masks, own)]
    return soa_forces


def _mesh_stepper(sched: CoolingScheduler, mesh: Mesh, forces_for,
                  comm=ALL_SLOTS):
    """The lockstep loop shared by the mesh paths, over the slots
    ``comm`` holds (every slot; or one, a rank's).  ``forces_for(mrows,
    e_loc, npad, n_loc, masked)`` builds one member block's force
    schedule ``Rps -> Fs`` over its shards held here from the mask rows
    (None for a shard held elsewhere).  Returns ``run(blocks, n_steps,
    mask, sweep_e0, sweep_om, split_last)`` (see
    :func:`fused_local_stepper`) on a ``[K][I]`` grid whose slots held
    elsewhere are None."""
    K, I = mesh.shape[ENS_AXIS], mesh.shape[ION_AXIS]
    spec = sched.fused_spec
    slots = comm.slots(mesh)
    ks = sorted({k for k, _, _ in slots})
    shards = {k: [i for kk, i, _ in slots if kk == k] for k in ks}

    def run(blocks, n_steps: int, mask=None, sweep_e0=None, sweep_om=None,
            split_last: bool = False):
        k0, i0, _ = slots[0]
        e_loc, n_loc = blocks[k0][i0].R.shape[:2]
        npad = sched._npad(n_loc)
        width = e_loc * npad
        lane0 = shard_keys(0, K * e_loc, mesh, npad)[0][::e_loc]   # [K, I]
        mask_t = None if mask is None else torch.as_tensor(mask)
        mrows = [[None] * I for _ in range(K)]
        for k, i, dev in slots:
            mr = torch.zeros((1 if mask is None else e_loc, npad),
                             dtype=sched.dtype, device=dev)
            mr[:, :n_loc] = (1.0 if mask is None else
                             slot_block(mask_t, mesh, k, i).to(dev,
                                                               sched.dtype))
            mrows[k][i] = mr
        forces = {k: forces_for(mrows[k], e_loc, npad, n_loc,
                                mask is not None) for k in ks}
        lanes = {(k, i): fold_sweep_lanes(
            spec, npad,
            None if sweep_e0 is None else np.asarray(sweep_e0)[
                k * e_loc:(k + 1) * e_loc],
            None if sweep_om is None else np.asarray(sweep_om)[
                k * e_loc:(k + 1) * e_loc], dev)
            for k, i, dev in slots}
        carries = {(k, i): sched.soa_ens_init(blocks[k][i])
                   for k, i, _ in slots}

        def step(carries, n_ticks=None, reuse_forces=False):
            Fs = {}
            if not reuse_forces:
                for k in ks:
                    Fk = forces[k]([carries[(k, i)].R for i in shards[k]])
                    Fs.update({(k, i): F for i, F in zip(shards[k], Fk)})
            rolls = None
            if not spec.internal_rng:
                nt = sched._tick_spec(n_ticks).ratio
                rolls = sched.rolls_fn(nt, K * I * width).to(sched.dtype)
            out = {}
            for k, i, dev in slots:
                l0 = int(lane0[k, i])
                out[(k, i)] = sched.soa_md_step(
                    carries[(k, i)], None, *lanes[(k, i)], n_ticks=n_ticks,
                    reuse_forces=reuse_forces, forces=Fs.get((k, i)),
                    rolls=(None if rolls is None else
                           rolls[:, l0:l0 + width].to(dev).contiguous()),
                    lane0=l0)
            return out

        def restore(carries):
            out = [[None] * I for _ in range(K)]
            for k, i, _ in slots:
                out[k][i] = sched.soa_ens_restore(carries[(k, i)],
                                                  blocks[k][i])
            return out

        for _ in range(n_steps - 1 if split_last else n_steps):
            carries = step(carries)
        if not split_last:
            return restore(carries)
        carries = step(carries, n_ticks=1)
        mid = restore(carries)
        if sched.ratio > 1:
            carries = step(carries, n_ticks=sched.ratio - 1,
                           reuse_forces=True)
        return mid, restore(carries)
    return run


def fused_local_stepper(sched: CoolingScheduler, ldeb: float, mesh: Mesh,
                        ion_forces: str = "gather", comm=ALL_SLOTS):
    """The mesh's production stepper: ``local_run(blocks, n_steps,
    mask=None, sweep_e0=None, sweep_om=None, split_last=False)`` advances
    the ``[K][I]`` grid of slot states (:func:`~.mesh.split_state`) by
    ``n_steps`` MD steps, every slot's block folded into the kernels' lane
    layout.  Forces: when each member's ions are slot-local (I == 1, the
    production ensemble layout) kernel A for one member without a mask,
    else kernel C; with a sharded ion axis the ``"gather"`` schedule
    (kernel E against the all-gathered positions) or ``"ring_n3l"``
    (:func:`ring_n3l_fused_forces`, kernels C and F).  ``comm`` is whose
    slots are stepped and how they meet: every slot from this process
    (the default), or a rank's one slot (parallel/ranks.py), whose grid
    holds None elsewhere.

    ``mask [E, N]`` marks each member's real ions (Poissonian fold);
    masked lanes stay exactly inert.  ``sweep_e0 [E, S]`` / ``sweep_om [E,
    2]`` give members their own laser parameters (the scheduler's spec
    must carry the matching per-lane flags).  ``split_last=True`` splits
    the LAST MD step at the reference's output instant, one quantum tick
    in (laserCoolingPlusExpansionMDQTSpeedUp.cpp:1365-1368), and returns
    ``(blocks_mid, blocks_end)``."""
    if ion_forces not in ("gather", "ring_n3l"):
        raise ValueError(f"ion_forces must be 'gather' or 'ring_n3l', "
                         f"got {ion_forces!r}")
    def forces_for(mrows, e_loc, npad, n_loc, masked):
        if mesh.shape[ION_AXIS] == 1:
            mr = mrows[0]
            if e_loc == 1 and not masked:
                # one member per slot: the single-member kernel A
                return lambda Rps: [yukawa_forces_n3l_soa(Rps[0], mr,
                                                          sched.L, ldeb)]
            return lambda Rps: [yukawa_forces_n3l_soa_batched(
                Rps[0], mr, e_loc, sched.L, ldeb)]
        make = (ring_n3l_fused_forces if ion_forces == "ring_n3l"
                else _gather_forces)
        return make(sched, ldeb, e_loc, npad, mrows, comm)
    return _mesh_stepper(sched, mesh, forces_for, comm)


def make_sharded_fused_step(sched: CoolingScheduler, ldeb: float, mesh: Mesh,
                            n_steps: int = 1, with_mask: bool = False,
                            ion_forces: str = "gather"):
    """``[E, N, ...]`` SimState -> SimState over ``n_steps`` MD steps on
    the mesh's production path (:func:`fused_local_stepper`); the result
    is joined on the mesh's home device.  With ``with_mask`` the step
    takes ``(states, mask [E, N])`` for Poissonian members."""
    local = fused_local_stepper(sched, ldeb, mesh, ion_forces=ion_forces)

    def step(states, mask=None):
        if with_mask != (mask is not None):
            raise ValueError("pass mask exactly when built with_mask")
        return join_state(local(split_state(states, mesh), n_steps,
                                mask=mask), mesh.home)
    return step


def make_sharded_md_step(sched: CoolingScheduler, mesh: Mesh, L: float,
                         ldeb: float, forces: str = "gather"):
    """One MD step of an ``[E, N, ...]`` fold over the mesh with the XLA
    force path: each member's shards get their forces from
    :func:`sharded_forces_fn` (``"gather"``) or :func:`ring_forces_fn`
    (``"ring"``) and then run their ticks on their slots (the JAX
    package's ``make_sharded_md_step``, whose scheduler factory binds the
    force function; the port's scheduler takes the forces per step).  The
    plain CPU reference of :func:`make_sharded_fused_step`: a mesh with
    slots off the CPU is refused."""
    if forces not in ("gather", "ring"):
        raise ValueError(f"forces must be 'gather' or 'ring', got "
                         f"{forces!r}")
    _plain_only([d for _, _, d in mesh.slots()], "make_sharded_md_step")
    fn = (ring_forces_fn(L, ldeb) if forces == "ring"
          else sharded_forces_fn(L, ldeb))

    def forces_for(mrows, e_loc, npad, n_loc, masked):
        def soa_forces(Rps):
            shards = [_unfold_rows(R, e_loc, npad, n_loc) for R in Rps]
            Fs = [torch.zeros_like(R) for R in Rps]
            for j in range(e_loc):
                for F, (Fj, _) in zip(Fs, fn([s[j] for s in shards])):
                    F.view(3, e_loc, npad)[:, j, :n_loc] = Fj.T
            return Fs
        return soa_forces
    run = _mesh_stepper(sched, mesh, forces_for)

    def step(states: SimState) -> SimState:
        return join_state(run(split_state(states, mesh), 1), mesh.home)
    return step


def _tree_map(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, SimState):
        return SimState(**{f: _tree_map(fn, getattr(x, f))
                           for f in ("R", "V", "F", "psi", "t_part")},
                        tick=x.tick, t=x.t)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    return x


def _leaves(x):
    out = []
    _tree_map(lambda t: out.append(t) or t, x)
    return out


def mesh_is_multi_card(mesh: Mesh) -> bool:
    """Whether the mesh's slots lie on more than one CUDA card."""
    return len({d for _, _, d in mesh.slots() if d.type == "cuda"}) > 1


def start_workers(mesh: Mesh) -> float:
    """Start (or reuse) the process of every ens slot of ``mesh`` (the
    mesh's rank pool, parallel/ranks.py) and wait until each has its
    device; returns the seconds it took."""
    from .ranks import mesh_pool
    t0 = time.perf_counter()
    for got, (_, _, dev) in zip(mesh_pool(mesh).run(
            _bound_device, [()] * len(mesh.slots()), collective=False),
            mesh.slots()):
        if got != str(dev):
            raise RuntimeError(f"a slot worker of {dev} is bound to {got}")
    return time.perf_counter() - t0


def _bound_device(rank) -> str:
    return (f"cuda:{torch.cuda.current_device()}"
            if torch.cuda.is_initialized() else "cpu")


def stop_workers() -> None:
    """End every slot process (they also end with this process)."""
    from .ranks import stop_ranks
    stop_ranks()


# where member_sharded's slot workers write a trace of each block (None:
# no trace; see worker_traces)
_TRACE_DIR = None


@contextlib.contextmanager
def worker_traces(log_dir: str):
    """While the context is open, every block that ``member_sharded``
    runs in a slot worker process is traced there with
    ``profiling.device_trace`` into ``<log_dir>/slot<k>/trace.json`` (a
    worker's kernels are not in this process's trace)."""
    global _TRACE_DIR
    prev, _TRACE_DIR = _TRACE_DIR, log_dir
    try:
        yield
    finally:
        _TRACE_DIR = prev


def _run_block(rank, fn, args, trace_dir=None):
    """A slot process's task: ``fn`` on its block moved to the process's
    device (traced into ``trace_dir`` if given); the result on the
    host."""
    from ..profiling import device_trace
    dev = rank.device
    with (contextlib.nullcontext() if trace_dir is None
          else device_trace(trace_dir, device=dev)):
        out = fn(*_tree_map(lambda t: t.to(dev), args))
    return _tree_map(lambda t: t.cpu(), out)


def member_sharded(fn, mesh: Mesh, processes: bool = False):
    """Multi-slot form of a batched job array for the share-nothing
    families (transport, tagging, 3-state toy): wrap an ``[E]``-batched
    member function (every tensor of every argument and of the result
    carries the member axis leading) so that member block k runs on ens
    slot k; the results are joined on the mesh's home device.  Pure data
    parallelism, no collectives.  These families keep whole members on
    one slot, so a mesh with an ion axis is refused.

    The blocks run one after another from this process.  Where ``fn``
    only enqueues work (a launch) the cards of a multi-card mesh still
    run at once.  Where it is a whole fold, which ends in host fetches,
    ``processes=True`` runs each slot's block on a mesh of several cards
    in a worker process of its own on the slot's card (the mesh's rank
    pool, parallel/ranks.py: spawned once and kept): ``fn`` must then
    pickle (a module-level function or a ``functools.partial`` of one),
    its arguments and result cross to and from the host, and the workers'
    kernel launches are added to this process's launch counters.  A
    member's result depends only on its own inputs, never on where its
    block ran nor on its block's width (every per-member sum over ions is
    ops/member_sum's), so both ways give the unsharded fold's bits."""
    if mesh.shape[ION_AXIS] != 1:
        raise ValueError(
            "member_sharded shards members only; use make_mesh(n_ions=1) "
            f"(got {mesh.shape[ION_AXIS]} ion shards)")
    K = mesh.shape[ENS_AXIS]

    def wrapped(*args):
        e = _leaves(args[0])[0].shape[0]
        if e % K:
            raise ValueError(f"{e} members do not divide over {K} ens slots")
        b = e // K

        def block(k):
            return _tree_map(lambda t: t[k * b:(k + 1) * b], args)
        if processes and mesh_is_multi_card(mesh):
            from .ranks import mesh_pool
            # every block ends before a raise
            outs = mesh_pool(mesh).run(_run_block, [
                (fn, _tree_map(lambda t: t.cpu(), block(k)),
                 None if _TRACE_DIR is None
                 else os.path.join(_TRACE_DIR, f"slot{k}"))
                for k in range(K)], collective=False)
        else:
            outs = [fn(*_tree_map(lambda t: t.to(dev), block(k)))
                    for k, (dev,) in enumerate(mesh.devices)]
        parts = [_leaves(o) for o in outs]
        joined = iter([torch.cat([p[j].to(mesh.home) for p in parts], 0)
                       for j in range(len(parts[0]))])
        return _tree_map(lambda _: next(joined), outs[0])
    return wrapped
