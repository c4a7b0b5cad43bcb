"""The flagship job as the CLI's ``cooling`` command runs it: one
``laser_cooling.run(cfg, seed=, state=, device=)`` call a job
(cli.py:327-336), writing the reference-schema ``.dat`` tree (the
``energies.dat`` row, ``vel_dist{X,Y,Z}`` and ``statePopulationsVsV`` of
every sample), a native checkpoint after every group of
``checkpoint_every_segments`` segments and the terminal checkpoint, as one
SLURM array task of the reference does (exampleSlurmFile.slurm:3,16).

Jobs run back to back, one at a time, job j from the harness's own start
drawn from ``(seed, j)`` into its own directory ``job<j+1>`` under the
run's scratch; the window ends at the first job end after ``seconds``.
Traced, it traces one group of the window's second job with the write
and the checkpoint that follow it, each ``write_outputs`` and
``checkpoint.save_native`` call under the harness's own span
``bench.write``.

The comparison reads the trees once the window has closed, then deletes
them: three segments followed by ``reference/mdqt.py`` and compared with
the sample the job wrote into its files for them (``start``, the first
job's first segment; ``stage``, the first segment of the last job's last
group, from the state ``run`` handed to ``run_compiled``; ``mid``, one of
that group's others drawn from the seed, from the state captured at
``CoolingScheduler.soa_init``), every job's tree counted against the
schema (``tree_gap``) and its terminal checkpoint read back against the
job's final state (``ckpt_gap``).  The stream's word of each job is the
one ``run`` drew, read off the scheduler it built."""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
import shutil
import time

import numpy as np
import torch

from harness import cell, check, registry
from harness.spans import WRITE

# tree_gap counts files and rows missing or extra: none may be.  ckpt_gap
# is the terminal checkpoint against the job's final state, each value
# relative to itself: the native .npz keeps the float32 bits (0), the
# reference-schema files %g's six significant digits, whose rounding
# moves a value by at most half a unit of its sixth digit, 5e-6 of it.
LIMITS = {**check.CLOCK_LIMITS, "tree_gap": 0, "ckpt_gap": 5e-6}
NUMBERS = check.NUMBERS
CONTROL = torch.bfloat16    # below the configuration's float32

KDE_ROWS = 2001          # the vel_dist files' rows (0 .. 5 at 0.0025)
VZERO_FILES = 13         # the terminal checkpoint's interval snapshots


def job_seeds(seed: int, j: int) -> tuple:
    """The start's seed and the run's seed of job ``j``."""
    a, b = np.random.default_rng([seed, 4, j]).integers(0, 2 ** 62, 2)
    return int(a), int(b)


def _one(state, copy: bool = False):
    """A single run's state ``[n, ...]`` as a fold of one member."""
    from mdqtplasmasims_torch.state import SimState
    return SimState(**{f: (getattr(state, f)[None].clone() if copy
                           else getattr(state, f)[None])
                       for f in ("R", "V", "F", "psi", "t_part")},
                    tick=int(state.tick), t=float(state.t))


def _rows(path: str) -> np.ndarray:
    """A table the job wrote, or None where it is missing or unreadable."""
    try:
        return np.loadtxt(path, ndmin=2)
    except (OSError, ValueError):
        return None


def _lines(path: str) -> int:
    with open(path, "rb") as f:
        return f.read().count(b"\n")


def _rel_gap(got, want) -> float:
    """The largest gap of ``got`` from ``want``, each value relative to
    itself (0 where both are 0; infinite where the shapes differ)."""
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        return float("inf")
    if np.iscomplexobj(want):
        return max(_rel_gap(np.real(got), want.real),
                   _rel_gap(np.imag(got), want.imag))
    g, w = got.astype(np.float64), want.astype(np.float64)
    d = np.abs(g - w)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(d == 0, 0.0, d / np.abs(w))
    return float(np.max(r, initial=0.0)) if np.isfinite(r).all() else \
        float("inf")


class Driver:
    """A run of a job cell: the configuration's job, ``members`` 1."""

    def __init__(self, config: dict, workload: dict, seed: int, device,
                 scratch: str):
        from mdqtplasmasims_torch.experiments import laser_cooling
        self.lc = laser_cooling
        self.config, self.seed = config, seed
        self.device = torch.device(device)
        self.scratch = scratch
        self.root = os.path.join(scratch, "trees")
        self.cfg = laser_cooling.CoolingConfig(**config["physics"])
        cfg = self.cfg
        self.steps = int(round(cfg.tmax / cfg.timestep))
        self.f = cfg.sample_freq
        self.samples = self.steps // self.f
        if self.samples * self.f != self.steps:
            raise ValueError("the job's tmax lies off the sample grid")
        self.ticks = config["derived"]["ratio"] * self.f   # a segment's
        self.group = cfg.checkpoint_every_segments or self.samples
        self.groups = -(-self.samples // self.group)
        self.last = self.group * (self.groups - 1)
        self.mid = check.mid_segment(seed, self.samples - self.last)
        self.traced_group = min(1, self.groups - 1)
        self.fold = registry.driver("cooling_fold")
        self.jobs = []
        self._prof = None

    def _run(self, j: int, directory: str, seeds: tuple, tmax=None):
        """Job ``j`` from the start drawn from ``seeds[0]``, with the run
        seeded from ``seeds[1]``, into ``directory``: ``(start, final,
        outs)``."""
        start = self.fold.start_fold(self.config, 1, seeds[0], self.device)
        start = dataclasses.replace(start, **{
            f: getattr(start, f)[0] for f in ("R", "V", "F", "psi",
                                              "t_part")})
        cfg = dataclasses.replace(self.cfg, job=j + 1,
                                  save_directory=directory,
                                  tmax=tmax or self.cfg.tmax)
        final, res = self.lc.run(cfg, seed=seeds[1], state=start,
                                 device=self.device)
        return start, final, res["outs"]

    def warm_up(self) -> None:
        """One job cut to one group, into a directory removed after."""
        warm = os.path.join(self.scratch, "warm")
        seeds = np.random.default_rng([self.seed, 5]).integers(0, 2 ** 62, 2)
        self._run(-1, warm, tuple(int(s) for s in seeds),
                  tmax=self.group * self.f * self.cfg.timestep)
        shutil.rmtree(warm)

    @contextlib.contextmanager
    def _hooks(self, trace_dir):
        """The harness's wrappers around the program's own calls, for the
        window only: the scheduler a job builds (its stream's word, the
        ``mid`` state at ``soa_init``), each ``run_compiled`` group (the
        ``stage`` state; the trace's start), and on traced runs each
        write and checkpoint (the ``bench.write`` span; the trace's
        end)."""
        lc, ck = self.lc, self.lc.ckpt
        saved = (lc.build_scheduler, lc.run_compiled, lc.write_outputs,
                 ck.save_native)
        build, compiled, write, save = saved

        def built(*a, **k):
            sched = build(*a, **k)
            self._sched = sched
            init = sched.soa_init

            def entry(state):
                if (self._group == self.groups - 1
                        and self._inits == self.mid and self.mid):
                    self._mid = _one(state, copy=True)
                self._inits += 1
                return init(state)
            sched.soa_init = entry
            return sched

        def group(cfg, sched, state, n):
            g, self._group, self._inits = self._calls, self._calls, 0
            self._calls += 1
            if g == self.groups - 1:
                self._stage = state
            if self._tracing and g == self.traced_group:
                from mdqtplasmasims_torch.profiling import device_trace
                self._prof = contextlib.ExitStack()
                self._prof.enter_context(device_trace(trace_dir,
                                                      device=self.device))
                self._traced_segments = n
            return compiled(cfg, sched, state, n)

        def spanned(fn, closes):
            def call(*a, **k):
                with torch.profiler.record_function(WRITE):
                    out = fn(*a, **k)
                if closes:
                    self._close_trace()
                return out
            return call

        lc.build_scheduler, lc.run_compiled = built, group
        if trace_dir:
            lc.write_outputs = spanned(write, False)
            ck.save_native = spanned(save, True)
        try:
            yield
        finally:
            (lc.build_scheduler, lc.run_compiled, lc.write_outputs,
             ck.save_native) = saved
            self._close_trace()

    def _close_trace(self) -> None:
        if self._prof is not None:
            self._prof.close()
            self._prof = None
            self.traced = True

    def window(self, seconds: float, trace_dir: str = None) -> dict:
        self.traced, self._traced_segments = False, 0
        with self._hooks(trace_dir):
            cell.sync(self.device)
            t0 = time.perf_counter()
            j = 0
            while True:
                self._calls = self._group = self._inits = 0
                self._stage = self._mid = None
                self._tracing = trace_dir is not None and j == 1
                start, final, outs = self._run(j, self.root,
                                               job_seeds(self.seed, j))
                self._close_trace()     # the traced group was the last
                self.jobs.append(dict(start=start, final=final, outs=outs,
                                      word=int(self._sched.seed.item()),
                                      stage=self._stage, mid=self._mid))
                # the first job's start and the last job's states are
                # followed; the others' are let go
                if j:
                    self.jobs[-2].update(stage=None, mid=None)
                if j > 1:
                    self.jobs[-2]["start"] = None
                j += 1
                if (time.perf_counter() - t0 >= seconds
                        and (trace_dir is None or self.traced)):
                    break
            cell.sync(self.device)
            wall = time.perf_counter() - t0
        bad = sum(self._bad_groups(job.pop("outs")) for job in self.jobs)
        traced = self._traced_segments if self.traced else 0
        return dict(wall_s=wall, groups=j * self.groups,
                    md_steps=j * self.steps, bad_groups=bad,
                    traced_md_steps=traced * self.f, traced_segments=traced)

    def _bad_groups(self, outs) -> int:
        """Groups of a job whose fetched outputs hold a value that is not
        finite."""
        return sum(not all(np.isfinite(v[s:s + self.group]).all()
                           for v in outs.values())
                   for s in range(0, self.samples, self.group))

    def trace_events(self, trace_dir: str) -> list:
        from harness import trace as tr
        return tr.load(os.path.join(trace_dir, "trace.json"))

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated())

    def close(self) -> None:
        """Nothing to release: what the jobs wrote lies under the run's
        scratch until :meth:`followed` has read it."""

    # ---- after the window: the trees ----

    def _job_dir(self, j: int):
        found = glob.glob(os.path.join(self.root, "*", f"job{j + 1}"))
        return found[0] if len(found) == 1 else None

    def _expected(self) -> dict:
        """The tree of a job: each file's name and its rows (None: not
        counted)."""
        n0, c0 = self.cfg.n0, self.steps - 1
        files = {"energies.dat": None,
                 f"ions_timestep{c0:06d}.dat": None,
                 f"conditions_timestep{c0:06d}.dat": n0,
                 f"wvFns_timestep{c0:06d}.dat": n0,
                 f"checkpoint_{c0:06d}.npz": None}
        files.update({f"VZERO_timestep{c0:06d}_interval{k}.dat": n0
                      for k in range(VZERO_FILES)})
        files.update({f"checkpoint_{(g + 1) * self.group * self.f - 1:06d}"
                      ".npz": None for g in range(self.groups - 1)})
        for k in range(self.samples):
            for a in "XYZ":
                files[f"vel_dist{a}_time{k:06d}.dat"] = KDE_ROWS
            files[f"statePopulationsVsVTime{k:06d}.dat"] = n0
        return files

    def _sample_times(self) -> np.ndarray:
        """The time of each sample: one tick into its segment's last MD
        step."""
        k = np.arange(self.samples)
        tick = (k * self.f + self.f - 1) * self.config["derived"]["ratio"] + 1
        return tick * self.config["derived"]["qdt"]

    def tree_gap(self, d) -> int:
        """Files missing or extra in the job's directory ``d``, rows
        missing or extra in its tables, ``energies.dat`` rows whose time
        is not their sample's, and an ``ions`` file that does not give
        n0 and the sample count."""
        want = self._expected()
        if d is None:
            return len(want) + self.samples
        have = set(os.listdir(d))
        gap = len(set(want) ^ have)
        for name, rows in want.items():
            if rows is not None and name in have:
                gap += abs(_lines(os.path.join(d, name)) - rows)
        e = _rows(os.path.join(d, "energies.dat"))
        if e is None or e.shape[1] != 7:
            return gap + self.samples
        t = self._sample_times()
        gap += abs(e.shape[0] - self.samples)
        m = min(e.shape[0], self.samples)
        gap += int(np.sum(np.abs(e[:m, 0] - t[:m]) > 1e-5 * t[:m]))
        try:
            with open(os.path.join(d, f"ions_timestep{self.steps - 1:06d}"
                                      ".dat")) as fh:
                gap += fh.read().split() != [str(self.cfg.n0),
                                             str(self.samples)]
        except OSError:
            pass
        return gap

    def ckpt_gap(self, d, final) -> float:
        """The terminal checkpoint (native and reference schema) read
        back against the job's final state; infinite where it is
        missing or unreadable."""
        c0 = self.steps - 1
        if d is None:
            return float("inf")
        try:
            with np.load(os.path.join(d, f"checkpoint_{c0:06d}.npz")) as z:
                native = {k: z[k] for k in ("R", "V", "psi", "t_part",
                                            "counter")}
        except (OSError, KeyError, ValueError):
            return float("inf")
        cond = _rows(os.path.join(d, f"conditions_timestep{c0:06d}.dat"))
        wv = _rows(os.path.join(d, f"wvFns_timestep{c0:06d}.dat"))
        if cond is None or wv is None or cond.shape[1] != 6 or \
                wv.shape[1] % 2:
            return float("inf")
        gaps = [_rel_gap(native[k], getattr(final, k))
                for k in ("R", "V", "psi", "t_part")]
        gaps += [0.0 if int(native["counter"]) == self.samples else np.inf,
                 _rel_gap(cond[:, :3], final.R), _rel_gap(cond[:, 3:],
                                                          final.V),
                 _rel_gap(wv[:, 0::2] + 1j * wv[:, 1::2], final.psi)]
        return max(gaps)

    def read_sample(self, d, k: int) -> dict:
        """Sample ``k`` as the job wrote it, ``[1, 1, ...]`` a quantity
        (one member, one sample); NaN where a file is missing or out of
        its schema."""
        n = self.cfg.n0
        out = dict(ekin=np.full(3, np.nan), epot=np.nan, vx_mean=np.nan,
                   pvel=np.full((3, KDE_ROWS), np.nan),
                   vx_ions=np.full(n, np.nan), pops=np.full((n, 3), np.nan))
        if d is not None:
            e = _rows(os.path.join(d, "energies.dat"))
            if e is not None and e.shape[0] > k and e.shape[1] == 7:
                out.update(ekin=e[k, 1:4], epot=e[k, 4], vx_mean=e[k, 6])
            for i, a in enumerate("XYZ"):
                v = _rows(os.path.join(d, f"vel_dist{a}_time{k:06d}.dat"))
                if v is not None and v.shape == (KDE_ROWS, 2):
                    out["pvel"][i] = v[:, 1]
            p = _rows(os.path.join(d, f"statePopulationsVsVTime{k:06d}.dat"))
            if p is not None and p.shape == (n, 4):
                out.update(vx_ions=p[:, 0], pops=p[:, 1:])
        return {key: np.asarray(v)[None, None] for key, v in out.items()}

    def followed(self) -> dict:
        """The segments, clocks and tree numbers of the window's jobs,
        each job's tree deleted once read."""
        tree, ckpt = 0, 0.0
        first, last = self.jobs[0], self.jobs[-1]
        for j, job in enumerate(self.jobs):
            d = self._job_dir(j)
            tree += self.tree_gap(d)
            ckpt = max(ckpt, self.ckpt_gap(d, job["final"]))
            if j == 0:
                s0 = self.read_sample(d, 0)
            if j == len(self.jobs) - 1:
                stage = self.read_sample(d, self.last)
                mid = self.read_sample(d, self.last + self.mid)
            if d is not None:
                shutil.rmtree(d)
        shutil.rmtree(self.root, ignore_errors=True)
        per = self.ticks
        start = check.Segment("start", _one(first["start"]), [0], s0, 0, 0)
        stage_at = None if last["stage"] is None else _one(last["stage"])
        tail = [check.Segment("stage", stage_at, [0], stage, 0,
                              self.last * per)]
        if self.mid:
            tail.append(check.Segment("mid", last["mid"], [0], mid, 0,
                                      (self.last + self.mid) * per))
        own = check.Segment("start", _one(last["start"]), [0], None, 0, 0)
        return dict(parts=[([start], first["word"]), (tail, last["word"])],
                    clocks=[own] + tail,
                    final=(last["final"], self.samples * per),
                    tree_gap=tree, ckpt_gap=ckpt)


def compare(run: dict, followed: dict, seed: int, device,
            control=None) -> tuple:
    """The followed segments against the float64 reference (the first
    job's under its word, the last job's under its own), the clocks of
    the last job, and the trees."""
    worst, ctrl = {}, ({} if control is not None else None)
    for segments, word in followed["parts"]:
        w, c = check.compare(run["config"], segments, [0], word, device,
                             control)
        for acc, got in ((worst, w), (ctrl, c)):
            if acc is not None:
                for k, v in got.items():
                    acc[k] = max(acc.get(k, 0.0), v)
    worst.update(check.clocks(run["config"], followed["clocks"],
                              followed["final"]))
    worst.update(tree_gap=followed["tree_gap"],
                 ckpt_gap=followed["ckpt_gap"])
    return worst, ctrl
