"""The cooling fold: the production group loop of
``experiments/laser_cooling.run_ensemble``, one ``run_compiled_ensemble``
call of ``checkpoint_every_segments`` output segments at a time, each
group's outputs fetched to the host as ``run_ensemble`` fetches them
(laser_cooling.py:1042-1043), no trees written; with the workload's
``mesh = (K, I)`` the same groups over a mesh of K x I cards, one rank
process a card (``run_compiled_sharded``).  ``run_ensemble`` runs to tmax
and cannot stop at a window's end, so the loop is held here; the fold
keeps stepping past tmax when the window is longer than a job.

The comparison follows three segments of the window (``harness/check.py``)
with ``reference/mdqt.py``."""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from harness import cell, check

LIMITS = check.CLOCK_LIMITS
NUMBERS = check.NUMBERS
CONTROL = torch.bfloat16    # below the configuration's float32


def start_fold(config: dict, members: int, seed: int, device):
    """The frozen-gas start of ``members`` members of n0 ions, made on
    ``device`` from ``seed`` in a few large draws: uniform positions in the
    cell, ions at rest, each in a random superposition of the two S
    sublevels (laserCoolingPlusExpansionMDQTSpeedUp.cpp:289-332)."""
    from mdqtplasmasims_torch.state import SimState
    n, L = config["physics"]["n0"], config["derived"]["L"]
    S = config["scheme"]["n_states"]
    g = torch.Generator(device=device).manual_seed(seed)
    R = torch.rand((members, n, 3), generator=g, device=device) * L
    r1, r2, s1, s2 = torch.rand((4, members, n), generator=g, device=device)
    one = torch.ones_like(r1)
    psi = torch.zeros((members, n, S), dtype=torch.complex64, device=device)
    psi[..., 0] = torch.sqrt(r1)
    psi[..., 1] = torch.complex(
        torch.where(s2 < 0.5, -one, one) * torch.sqrt((1 - r1) * r2),
        torch.where(s1 < 0.5, -one, one) * torch.sqrt((1 - r1) * (1 - r2)))
    zero = torch.zeros_like(R)
    return SimState(R=R, V=zero, F=zero.clone(), psi=psi,
                    t_part=torch.zeros_like(r1), tick=0, t=0.0)


class Program:
    """The system under test: the port's cooling fold on ``device``, or
    with ``mesh = (K, I)`` over a mesh of K x I distinct cards that runs
    as one rank process per card (``parallel/ranks.py``)."""

    def __init__(self, config: dict, device, word: int, mesh=None):
        from mdqtplasmasims_torch.experiments import laser_cooling
        self.lc = laser_cooling
        self.device = torch.device(device)
        self.cfg = laser_cooling.CoolingConfig(**config["physics"])
        self.sched = laser_cooling.build_scheduler(self.cfg, device)
        self.sched.seed = torch.tensor([word], dtype=torch.int32,
                                       device=device)
        self.group = self.cfg.checkpoint_every_segments
        self.mesh = None
        if mesh:
            from mdqtplasmasims_torch.parallel.mesh import make_mesh
            K, I = mesh
            self.mesh = make_mesh(K, I, ranks=True, devices=(
                None if self.device.type == "cuda" else [device] * (K * I)))
            self.mesh_shape = (K, I)

    @property
    def ticks_per_group(self) -> int:
        return self.group * self.cfg.sample_freq * self.sched.ratio

    def capture(self, members: list, segment: int, E: int) -> None:
        """From now on, keep in every group the state of the checked
        ``members`` at the start of its output segment ``segment``, as the
        program steps it: on one card through the scheduler's fold entry
        (``soa_ens_init``, called at each segment's start), on a rank
        mesh in each rank through the stepper it builds for the group."""
        self._members = list(members)
        if self.mesh is not None:
            from mdqtplasmasims_torch.parallel.ranks import mesh_pool
            pool = mesh_pool(self.mesh)
            K, I = self.mesh_shape
            pool.run(_rank_capture, [(self._members, segment, E, K, I)]
                     * len(pool.procs), collective=False)
            return
        init = self.sched.soa_ens_init
        idx = torch.as_tensor(self._members, device=self.device)
        self._calls, self._captured = 0, None

        def entry(states):
            if self._calls == segment and states.R.shape[0] == E:
                self._captured = _take(states, idx)
            self._calls += 1
            return init(states)
        self.sched.soa_ens_init = entry

    def captured(self):
        """The checked members' state at the start of the captured segment
        of the last group (None if that segment never started)."""
        if self.mesh is None:
            return self._captured
        from mdqtplasmasims_torch.parallel.ranks import mesh_pool
        pool = mesh_pool(self.mesh)
        parts = [p for got in pool.run(_rank_captured, [()] * len(
            pool.procs), collective=False) for p in got]
        return _assemble(parts, len(self._members), self.mesh_shape[1])

    def run_group(self, fold):
        """One group of the production loop and its fetch."""
        self._calls, self._captured = 0, None
        if self.mesh is None:
            fold, outs = self.lc.run_compiled_ensemble(
                self.cfg, self.sched, fold, self.group)
        else:
            fold, outs = self.lc.run_compiled_sharded(
                self.cfg, self.sched, self.mesh, fold, self.group)
        return fold, {k: v.cpu().numpy() for k, v in outs.items()}

    def traced(self, trace_dir: str):
        """The profiler over this process's card, or over every rank's
        (``trace_dir/slot<r>/``)."""
        from mdqtplasmasims_torch.parallel.ensemble import worker_traces
        from mdqtplasmasims_torch.profiling import device_trace
        if self.mesh is None:
            return device_trace(trace_dir, device=self.device)
        return worker_traces(trace_dir)

    def trace_events(self, trace_dir: str) -> list:
        """The traced window's events, the ranks' merged on the wall
        clock."""
        from harness import trace as tr
        if self.mesh is None:
            return tr.load(os.path.join(trace_dir, "trace.json"))
        return [e for d in sorted(os.listdir(trace_dir))
                for e in tr.load_wall(os.path.join(trace_dir, d,
                                                   "trace.json"))]

    def memory_peak(self) -> int:
        """The peak of allocated device memory on the fullest card."""
        if self.device.type != "cuda":
            return 0
        peak = torch.cuda.max_memory_allocated()
        if self.mesh is not None:
            from mdqtplasmasims_torch.parallel.ranks import mesh_pool
            pool = mesh_pool(self.mesh)
            peak = max([peak] + pool.run(_rank_peak, [()] * len(
                pool.procs), collective=False))
        return int(peak)

    def close(self) -> None:
        """Ends the rank processes, if any, and waits for them."""
        if self.mesh is not None:
            from mdqtplasmasims_torch.parallel.ranks import stop_ranks
            stop_ranks()

    @contextlib.contextmanager
    def segment_clock(self, events: list):
        """Records a CUDA event on the current stream at the end of every
        output segment this process samples (after the fold's sample, the
        segment's last work), read only after the window, so the host
        never waits on it."""
        orig = self.lc._sample_fold

        def timed(*a, **k):
            out = orig(*a, **k)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            return out
        self.lc._sample_fold = timed
        try:
            yield
        finally:
            self.lc._sample_fold = orig


def _rank_peak(me) -> int:
    """A rank's peak of allocated memory on its card."""
    return int(torch.cuda.max_memory_allocated(me.device))


def _take(states, idx):
    """Rows ``idx`` of a fold's state, copied."""
    from mdqtplasmasims_torch.state import SimState
    return SimState(**{f: getattr(states, f).index_select(0, idx).clone()
                       for f in ("R", "V", "F", "psi", "t_part")},
                    tick=int(states.tick), t=float(states.t))


_RANK_CAPTURE = {}


def _rank_capture(me, members: list, segment: int, E: int, K: int,
                  I: int) -> None:
    """In rank ``me`` (slot ``divmod(rank, I)``: member block k, ion shard
    i): wraps the stepper each group builds (``parallel.ensemble.
    fused_local_stepper``, imported by the rank's task at each call), so
    that at the start of output segment ``segment`` of every group the
    rank keeps its shard of the checked members in its block."""
    from mdqtplasmasims_torch.parallel import ensemble
    k, i = divmod(me.rank, I)
    e = E // K
    mine = [(m, j - k * e) for m, j in enumerate(members)
            if k * e <= j < (k + 1) * e]
    make = _RANK_CAPTURE.setdefault("make", ensemble.fused_local_stepper)

    def stepper(*a, **kw):
        local = make(*a, **kw)
        calls = [0]
        _RANK_CAPTURE.pop("got", None)

        def counted(blocks, *b, **c):
            blk = blocks[k][i]
            if calls[0] == segment and mine and blk.R.shape[0] == e:
                idx = torch.as_tensor([r for _, r in mine],
                                      device=blk.R.device)
                _RANK_CAPTURE["got"] = ([m for m, _ in mine], i,
                                        _take(blk, idx))
            calls[0] += 1
            return local(blocks, *b, **c)
        return counted
    ensemble.fused_local_stepper = stepper


def _rank_captured(me) -> list:
    """This rank's kept shards ``(member position, shard, state)``, on the
    host."""
    from mdqtplasmasims_torch.state import SimState
    if "got" not in _RANK_CAPTURE:
        return []
    pos, i, st = _RANK_CAPTURE["got"]
    return [(m, i, SimState(**{f: getattr(st, f)[n:n + 1].cpu() for f in
                               ("R", "V", "F", "psi", "t_part")},
                            tick=st.tick, t=st.t))
            for n, m in enumerate(pos)]


def _assemble(parts: list, members: int, shards: int):
    """The checked members' state from the ranks' shards, members in the
    checked order and each member's ion shards joined; None unless every
    shard of every member came."""
    from mdqtplasmasims_torch.state import SimState
    got = {(m, i): st for m, i, st in parts}
    if len(got) != members * shards:
        return None
    rows = [[got[m, i] for i in range(shards)] for m in range(members)]
    first = rows[0][0]
    if any(st.tick != first.tick for row in rows for st in row):
        return None
    return SimState(**{f: torch.cat([torch.cat([getattr(st, f) for st in row],
                                               1) for row in rows], 0)
                       for f in ("R", "V", "F", "psi", "t_part")},
                    tick=first.tick, t=first.t)


def window(prog: Program, fold, seconds: float, device,
           trace_groups: int = 0, trace_dir: str = None) -> dict:
    """Groups until the first group end after ``seconds``.  With
    ``trace_groups``, the groups after the first are traced (the window
    runs on until they are done)."""
    cuda = torch.device(device).type == "cuda"
    events, kept = [], []
    first = last = None
    groups, traced = 0, None
    with contextlib.ExitStack() as stack:
        if cuda:
            stack.enter_context(prog.segment_clock(events))
            start = torch.cuda.Event(enable_timing=True)
        cell.sync(device)
        t0 = time.perf_counter()
        if cuda:
            start.record()
        prof = contextlib.ExitStack()
        while True:
            if trace_groups and groups == 1:
                prof.enter_context(prog.traced(trace_dir))
            begin = fold
            fold, outs = prog.run_group(fold)
            kept.append(outs)        # as run_ensemble keeps every group's
            first = first or (begin, outs)
            last = (begin, outs)
            groups += 1
            if trace_groups and groups == 1 + trace_groups:
                prof.close()
                traced = trace_groups
            if (time.perf_counter() - t0 >= seconds
                    and (not trace_groups or traced)):
                break
        cell.sync(device)
        wall = time.perf_counter() - t0
    seg_ms = []
    if cuda:
        marks = [start] + events
        seg_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    finite = sum(all(np.isfinite(v).all() for v in o.values()) for o in kept)
    steps = prog.group * prog.cfg.sample_freq
    return dict(wall_s=wall, groups=groups, md_steps=groups * steps,
                segment_ms=seg_ms, bad_groups=groups - finite,
                first=first, last=last, final=fold, mid=prog.captured(),
                traced_md_steps=(traced or 0) * steps,
                traced_segments=(traced or 0) * prog.group)


def followed(w: dict, checked: list, mid: int, per_group: int,
             per_segment: int) -> dict:
    """What the comparison follows of a window ``w``: the
    :class:`check.Segment` s (``start``; ``stage`` unless the window held
    one group; ``mid``, segment ``mid`` of the last group, where the
    group has more than one) and ``final``, the window's last state with
    the ticks counted to it."""
    rows = list(range(len(checked)))
    stage = (w["groups"] - 1) * per_group
    segs = [check.Segment("start", w["first"][0], checked, w["first"][1], 0,
                          0)]
    if w["groups"] > 1:
        segs.append(check.Segment("stage", w["last"][0], checked,
                                  w["last"][1], 0, stage))
    if mid:
        segs.append(check.Segment("mid", w["mid"], rows, w["last"][1], mid,
                                  stage + mid * per_segment))
    return dict(segments=segs, final=(w["final"], w["groups"] * per_group))


class Driver:
    """A run of a fold cell: the workload's ``members`` (and ``mesh``),
    ``trace_groups`` traced after the window's first group, one member
    checked in each of ``check_members`` blocks of the fold."""

    def __init__(self, config: dict, workload: dict, seed: int, device,
                 scratch: str):
        self.config, self.device, self.seed = config, device, seed
        self.members = workload["members"]
        self.trace_groups = workload["trace_groups"]
        self.prog = Program(config, device, cell.seed_word(seed),
                            workload.get("mesh"))
        self.checked = check.checked_members(seed, self.members,
                                             workload["check_members"])
        self.mid = check.mid_segment(seed, self.prog.group)

    def warm_up(self) -> None:
        self.start = start_fold(self.config, self.members, self.seed,
                                self.device)
        self.prog.run_group(self.start)     # builds and loads every kernel

    def window(self, seconds: float, trace_dir: str = None) -> dict:
        self.prog.capture(self.checked, self.mid, self.members)
        self.w = window(self.prog, self.start, seconds, self.device,
                        trace_groups=self.trace_groups if trace_dir else 0,
                        trace_dir=trace_dir)
        self.per_group = self.prog.ticks_per_group
        return dict(checked=self.checked, mid_segment=self.mid,
                    **{k: v for k, v in self.w.items()
                       if k not in ("first", "last", "final", "mid")})

    def trace_events(self, trace_dir: str) -> list:
        return self.prog.trace_events(trace_dir)

    def memory_peak(self) -> int:
        return self.prog.memory_peak()

    def close(self) -> None:
        self.prog.close()

    def followed(self) -> dict:
        return followed(self.w, self.checked, self.mid, self.per_group,
                        self.prog.cfg.sample_freq * self.prog.sched.ratio)


def compare(run: dict, followed: dict, seed: int, device,
            control=None) -> tuple:
    """The followed segments against the float64 reference, and the
    clocks."""
    worst, ctrl = check.compare(run["config"], followed["segments"],
                                run["checked"], cell.seed_word(seed), device,
                                control)
    worst.update(check.clocks(run["config"], followed["segments"],
                              followed["final"]))
    return worst, ctrl
