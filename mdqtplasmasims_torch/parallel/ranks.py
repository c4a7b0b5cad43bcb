"""The mesh as one process a slot: the JAX package's ``shard_map`` program.

Counterpart of ``make_sharded_fused_step`` / ``fused_local_stepper`` /
``ring_n3l_fused_forces`` of ``mdqtplasmasims_tpu/parallel/ensemble.py``
run as SPMD.  A mesh of K x I slots (:attr:`.mesh.Mesh.as_ranks`) is K*I
processes, rank ``r`` on slot ``(k, i) = divmod(r, I)`` and its device,
each stepping its own block at the same time as the others:

* :class:`RankPool`: the processes, started with ``torch.multiprocessing``
  (``spawn``) once per slot layout and kept between calls (:func:`pool`),
  each told its tasks through a queue of its own.  A task is a picklable
  function of ``(rank, *args)``; its result and the kernel launches it
  made come back to this process.  If a rank raises in a task that uses
  collectives, every rank is stopped and the caller gets the exception.
  ``member_sharded``'s slot workers (parallel/ensemble.py) are the same
  processes.
* :class:`RankComm`: a rank's ion axis.  The process group (NCCL on
  cards, gloo on the CPU) meets through a ``FileStore`` in a temporary
  directory of the pool, and member block k's ion shards form a group of
  their own.  ``all_gather`` is ``all_gather_into_tensor`` on that group,
  a ring hop one ``batch_isend_irecv`` (i -> i+1 mod I) of every buffer
  that travels; the samples and the final state are gathered to rank 0.
  Copies do not change bits, so a rank mesh gives the single-controller
  mesh's results bit for bit.
* :func:`run_cooling`: ``run_compiled_sharded`` on the ranks.  Each rank
  runs the per-slot work of the single-controller stepper for its slot
  (parallel/ensemble.py ``_mesh_stepper``, with this module's
  collectives); at each output gate the ``mid`` blocks are gathered to
  rank 0, joined and sampled there (kernel G on rank 0's device), as the
  single-controller mesh samples the joined fold.  Explicit rolls: every
  rank draws the fold's full ``[nt, 5, K*I*width]`` from a copy of the
  same ``rolls_fn`` and keeps its slice, so a ``rolls_fn`` must pickle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import traceback
import uuid
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from .. import _build
from ..state import SimState
from .mesh import ENS_AXIS, ION_AXIS, Mesh, join_state, slot_state

#: the live pools, by their slots' devices
_POOLS: dict = {}

#: how long a rank waits in a collective for the others before it fails
#: (a rank that died or raised: the pool then stops them all)
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


def _portable(e: Exception, rank: int) -> Exception:
    """``e`` with the rank's traceback as a note, or a RuntimeError of it
    when ``e`` does not pickle."""
    tb = "".join(traceback.format_exception(e))
    try:
        e.add_note(f"raised in mesh rank {rank}:\n{tb}")
        pickle.dumps(e)
        return e
    except Exception:                    # noqa: BLE001 - any pickling fault
        return RuntimeError(f"mesh rank {rank} raised:\n{tb}")


class _Rank:
    """A rank process's own state: its place, its device, its process
    groups (made at the first task that needs them) and the ``rolls_fn``
    of the run it serves."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 store: str):
        self.rank, self.world, self.device, self.store = (rank, world,
                                                          device, store)
        self.ready = False
        self.groups: dict = {}
        self.rolls_token, self.rolls_fn = None, None

    def ion_group(self, K: int, I: int, k: int):
        """Member block k's ion group on a K x I layout (None for I = 1:
        no collective on the ion axis)."""
        if not self.ready:
            dist.init_process_group(
                "nccl" if self.device.type == "cuda" else "gloo",
                init_method=f"file://{self.store}", world_size=self.world,
                rank=self.rank, timeout=COLLECTIVE_TIMEOUT)
            self.ready = True
        if (K, I) not in self.groups:
            if K * I != self.world:
                raise ValueError(f"a {K} x {I} layout on {self.world} ranks")
            # every rank makes every group, in the same order
            self.groups[(K, I)] = [
                dist.new_group(list(range(b * I, (b + 1) * I)),
                               timeout=COLLECTIVE_TIMEOUT) if I > 1
                else None for b in range(K)]
        return self.groups[(K, I)][k]

    def rolls(self, payload):
        """The run's ``rolls_fn``: ``payload = (token, pickled fn)``; a
        token seen before keeps this rank's copy, which has drawn on."""
        if payload is None:
            return None
        token, blob = payload
        if blob is not None or token != self.rolls_token:
            self.rolls_token, self.rolls_fn = token, pickle.loads(blob)
        return self.rolls_fn


def _rank_main(rank: int, world: int, device: str, inbox, outbox,
               store: str, n_threads: int) -> None:
    torch.set_num_threads(n_threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    me = _Rank(rank, world, dev, store)
    while True:
        task = inbox.get()
        if task is None:
            break
        fn, args = task
        before = _build.launch_snapshot()
        try:
            res = fn(me, *args)
            outbox.put((rank, True, res, _build.launch_delta(before)))
        except Exception as e:                    # noqa: BLE001
            # the task's fault goes to the caller; this rank serves on
            outbox.put((rank, False, _portable(e, rank),
                        _build.launch_delta(before)))
    if me.ready:
        dist.destroy_process_group()


class RankPool:
    """One process per slot of a layout, ``devices[r]`` rank r's device."""

    def __init__(self, devices):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.devices = tuple(torch.device(d) for d in devices)
        self.dir = tempfile.mkdtemp(prefix="mdqt-ranks-")
        self.outbox = ctx.Queue()
        self.inbox, self.procs = [], []
        for r, dev in enumerate(self.devices):
            q = ctx.Queue()
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                r, len(self.devices), str(dev), q, self.outbox,
                os.path.join(self.dir, "store"), torch.get_num_threads()))
            p.start()
            self.inbox.append(q)
            self.procs.append(p)

    def run(self, fn: Callable, args: List[tuple],
            collective: bool = True) -> list:
        """``fn(rank, *args[r])`` on every rank r; their results in rank
        order, their launches added to this process's counters.  A rank
        that raises: with ``collective`` (the others may wait on it) every
        rank is stopped at once and the exception raised; without, the
        first exception is raised after every rank has answered."""
        if len(args) != len(self.procs):
            raise ValueError(f"{len(args)} argument tuples for "
                             f"{len(self.procs)} ranks")
        for q, a in zip(self.inbox, args):
            q.put((fn, a))
        out, errors, pending = [None] * len(args), [], set(range(len(args)))
        while pending:
            try:
                r, ok, res, launches = self.outbox.get(timeout=0.5)
            except queue.Empty:
                dead = {r: self.procs[r].exitcode for r in pending
                        if not self.procs[r].is_alive()}
                if dead:
                    self.close(kill=True)
                    raise RuntimeError(f"mesh ranks ended before answering "
                                       f"(rank: exit code) {dead}")
                continue
            pending.discard(r)
            _build.add_launches(launches)
            if ok:
                out[r] = res
                continue
            if collective:
                self.close(kill=True)
                raise res
            errors.append(res)
        if errors:
            raise errors[0]
        return out

    def close(self, kill: bool = False) -> None:
        """End the ranks (at once with ``kill``) and forget the pool."""
        for key, p in list(_POOLS.items()):
            if p is self:
                del _POOLS[key]
        for q, p in zip(self.inbox, self.procs):
            if kill:
                p.terminate()
            elif p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(timeout=None if kill else 60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self.dir, ignore_errors=True)


def pool(devices) -> RankPool:
    """The live pool of one process per device of ``devices`` (a slot
    layout, repeats allowed), started on first use."""
    key = tuple(str(torch.device(d)) for d in devices)
    if key not in _POOLS:
        _POOLS[key] = RankPool(key)
    return _POOLS[key]


def mesh_pool(mesh: Mesh) -> RankPool:
    """The pool of ``mesh``'s slots, rank r on slot ``divmod(r, I)``."""
    return pool([d for _, _, d in mesh.slots()])


def stop_ranks() -> None:
    """End every pool's processes (they also end with this process)."""
    while _POOLS:
        next(iter(_POOLS.values())).close()


# ---- a rank's ion axis

_all_gather_single = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor")


def _pack(b: SimState) -> torch.Tensor:
    """A block's fields as one flat real tensor (psi as its real view)."""
    return torch.cat([b.R.reshape(-1), b.V.reshape(-1), b.F.reshape(-1),
                      torch.view_as_real(b.psi).reshape(-1),
                      b.t_part.reshape(-1)])


def _unpack(flat: torch.Tensor, like: SimState) -> SimState:
    sizes = [like.R.numel(), like.V.numel(), like.F.numel(),
             2 * like.psi.numel(), like.t_part.numel()]
    R, V, F, psi, tp = torch.split(flat, sizes)
    return SimState(R=R.reshape(like.R.shape), V=V.reshape(like.V.shape),
                    F=F.reshape(like.F.shape),
                    psi=torch.view_as_complex(psi.reshape(*like.psi.shape,
                                                          2)),
                    t_part=tp.reshape(like.t_part.shape), tick=like.tick,
                    t=like.t)


class RankComm:
    """Rank ``(k, i)``'s side of the mesh's collectives, in the form the
    single controller's copies take (parallel/ensemble.py): lists over the
    slots held here, which is one."""

    def __init__(self, mesh: Mesh, me: _Rank):
        self.K, self.I = mesh.shape[ENS_AXIS], mesh.shape[ION_AXIS]
        self.rank, self.device = me.rank, me.device
        self.k, self.i = divmod(me.rank, self.I)
        if mesh.devices[self.k][self.i] != me.device:
            raise ValueError(f"rank {me.rank} runs on {me.device}, its slot "
                             f"is on {mesh.devices[self.k][self.i]}")
        self.group = me.ion_group(self.K, self.I, self.k)
        base = self.k * self.I
        self.next = base + (self.i + 1) % self.I
        self.prev = base + (self.i - 1) % self.I

    def slots(self, mesh: Mesh):
        return [(self.k, self.i, self.device)]

    def all_gather(self, xs, dim: int):
        """The ion axis's ``all_gather(tiled=True)`` of this rank's one
        shard along ``dim``."""
        x, = xs
        x = x.contiguous()
        out = torch.empty((self.I * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _all_gather_single(out, x, group=self.group)
        g = out.view(self.I, *x.shape).movedim(0, dim)
        return [g.reshape(*x.shape[:dim], self.I * x.shape[dim],
                          *x.shape[dim + 1:])]

    def hop(self, *bufs):
        """One ring hop of every buffer list given (each of one tensor):
        shard i sends to i+1 and receives from i-1 (mod I), all in one
        ``batch_isend_irecv``."""
        sends = [x.contiguous() for x, in bufs]
        recvs = [torch.empty_like(x) for x in sends]
        ops = []
        for s, r in zip(sends, recvs):
            ops.append(dist.P2POp(dist.isend, s, self.next, self.group))
            ops.append(dist.P2POp(dist.irecv, r, self.prev, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple([r] for r in recvs)

    def join(self, grid):
        """Every rank's block gathered to rank 0 and joined there
        (:func:`.mesh.join_state` on its device); None on the others."""
        b = grid[self.k][self.i]
        flat = _pack(b)
        parts = ([torch.empty_like(flat) for _ in range(self.K * self.I)]
                 if self.rank == 0 else None)
        dist.gather(flat, parts, dst=0)
        if self.rank:
            return None
        return join_state([[_unpack(parts[k * self.I + i], b)
                            for i in range(self.I)] for k in range(self.K)],
                          self.device)


def _on(x, device):
    from .ensemble import _tree_map
    return _tree_map(lambda t: t.to(device), x)


def _rolls_payload(sched) -> Optional[tuple]:
    """What the ranks need of the scheduler's ``rolls_fn``: None with the
    in-kernel stream, else ``(token, pickled fn)``; the token is the
    run's (kept on the scheduler), so ranks that saw it keep their copy
    drawing on, unless the fn is a generator's (:func:`uniform_rolls`),
    whose state is sent anew each call from this process's copy."""
    if sched.fused_spec.internal_rng:
        return None
    from ..core.scheduler import UniformRolls
    token = getattr(sched, "_rank_token", None)
    fresh = token is None or isinstance(sched.rolls_fn, UniformRolls)
    if token is None:
        token = sched._rank_token = uuid.uuid4().hex
    if not fresh:
        return token, None
    try:
        return token, pickle.dumps(sched.rolls_fn)
    except Exception as e:               # noqa: BLE001 - any pickling fault
        raise ValueError(
            "a mesh that runs as ranks draws each rank's explicit rolls "
            "from its own copy of the rolls_fn, which must pickle (a "
            "module-level function, a picklable object or a "
            f"functools.partial of one): {e}") from e


def _cooling_task(me: _Rank, job: dict, block: SimState):
    """A rank's part of :func:`run_cooling`; rank 0 returns the joined
    final state, the samples and its rolls generator's state on the
    host, the others None."""
    from ..core.scheduler import CoolingScheduler, UniformRolls
    from ..experiments.laser_cooling import sharded_segments
    from ..profiling import device_trace
    from .ensemble import fused_local_stepper
    mesh, dev = job["mesh"], me.device
    comm = RankComm(mesh, me)
    seed = job["seed"]
    sched = CoolingScheduler(**job["sched"], device=dev,
                             rolls_fn=me.rolls(job["rolls"]),
                             seed=None if seed is None else seed.to(dev))
    grid = [[None] * comm.I for _ in range(comm.K)]
    grid[comm.k][comm.i] = _on(block, dev)
    local = fused_local_stepper(sched, job["ldeb"], mesh,
                                ion_forces=job["ion_forces"], comm=comm)
    trace = job["trace_dir"]
    with (contextlib.nullcontext() if trace is None else
          device_trace(os.path.join(trace, f"slot{me.rank}"), device=dev)):
        states, outs = sharded_segments(
            job["cfg"], sched, local, grid, comm.join,
            dev if me.rank == 0 else None, job["n_segments"], **job["kw"])
    if me.rank:
        return None
    gen = (sched.rolls_fn.generator.get_state()
           if isinstance(sched.rolls_fn, UniformRolls) else None)
    return _on(states, "cpu"), _on(outs, "cpu"), gen


def run_cooling(cfg, sched, mesh: Mesh, states: SimState, n_segments: int,
                ldeb: float, ion_forces: str = "gather", **kw):
    """``run_compiled_sharded``'s segments on the mesh's ranks: ``states``
    (any device) split into the slots' blocks, each sent to its rank,
    ``kw`` (mask, sweep tables, ``seg_len``, ``tail``) to all.  Returns
    ``(states, outs)`` on the mesh's home device, as the single
    controller does; a generator-drawn ``rolls_fn``'s generator is left
    where rank 0's copy ended."""
    from ..core.scheduler import UniformRolls
    from .ensemble import _TRACE_DIR
    K, I = mesh.shape[ENS_AXIS], mesh.shape[ION_AXIS]
    skip = {"device", "rolls_fn", "seed"}
    job = dict(
        mesh=mesh, cfg=cfg, ldeb=ldeb, ion_forces=ion_forces,
        n_segments=n_segments, trace_dir=_TRACE_DIR,
        kw={k: (v.cpu() if torch.is_tensor(v) else v) for k, v in kw.items()},
        sched={f.name: getattr(sched, f.name)
               for f in dataclasses.fields(sched) if f.name not in skip},
        seed=None if sched.seed is None else sched.seed.cpu(),
        rolls=_rolls_payload(sched))
    blocks = [(job, slot_state(states, mesh, k, i, device="cpu"))
              for k in range(K) for i in range(I)]
    final, outs, gen = mesh_pool(mesh).run(_cooling_task, blocks)[0]
    if gen is not None and isinstance(sched.rolls_fn, UniformRolls):
        sched.rolls_fn.generator.set_state(gen)
    return _on(final, mesh.home), _on(outs, mesh.home)
