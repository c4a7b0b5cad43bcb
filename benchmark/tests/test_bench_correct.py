"""``correct`` on whole runs at the tiny size on the CPU: a sound run of
every cell passes its limits and the control (the reference in the
precision below the configuration's, bfloat16 for cooling, in the
program's place) fails them; each fault planted in a cooling cell's timed
path fails them."""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

import rank_faults
from conftest import tiny_form
from harness import cell, check, registry

import mdqtplasmasims_torch.experiments.laser_cooling as lc
from mdqtplasmasims_torch.bridge import state_to_numpy
from mdqtplasmasims_torch.core.scheduler import CoolingScheduler
from mdqtplasmasims_torch.io.datfiles import DatWriter
from mdqtplasmasims_torch.parallel.mesh import make_mesh, slot_block
from mdqtplasmasims_torch.state import tick_time

# every cell of BENCHMARK.json, then every workload file kept out of it
# (the four-card cool3500_e100_ranks4), each at its driver's tiny form
_IN = [w["name"] for w in registry.spec()["workloads"]]
CELLS = _IN + [n for n in registry.names("workloads") if n not in _IN]
ONE_CARD = ["cool3500_e99"]
JOB = "cool3500_e1_tree"
SEED = 2 ** 31 + 12345


def run(name, seed=SEED, trace=False, seconds=0.0):
    with tempfile.TemporaryDirectory() as d:
        r, f = cell.measure(name, seed, seconds, trace, "cpu", 0.0, d)
    return cell.verify(r, f, seed, "cpu"), f


def form(tiny, name):
    """The tiny form of cell ``name``'s driver."""
    return tiny_form(tiny.workload(name)["driver"])


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(tiny, name):
    r, f = run(name)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    tf = form(tiny, name)
    sound = tf.SOUND
    assert r["groups"] == sound["groups"]
    assert r["md_steps"] == sound["md_steps"]
    assert r["memory_peak_bytes"] == 0          # no card: nothing read
    assert tf.followed(f) == sound["followed"]
    for k, v in sound["checks"].items():
        assert r["checks"][k]["value"] == v, k


def test_a_sound_job_window_of_two_jobs_reads_and_deletes_both_trees(
        tiny, monkeypatch):
    jobs = []
    orig = lc.run

    def counted(*a, **k):
        jobs.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(lc, "run", counted)
    monkeypatch.setattr(cell.time, "perf_counter",
                        lambda: 0.0 if len(jobs) < 3 else 1.0)
    with tempfile.TemporaryDirectory() as d:
        r, f = cell.measure(JOB, SEED, 0.5, False, "cpu", 0.0, d)
        assert os.listdir(d) == []
    cell.verify(r, f, SEED, "cpu")
    assert r["groups"] == 6 and r["md_steps"] == 48
    assert [s.tick for segs, _ in f["parts"] for s in segs] == [0, 400, 500]
    # the first job's start and the last job's segments, each job's word
    words = [w for _, w in f["parts"]]
    assert words[0] != words[1]
    assert r["correct"], r["checks"]


def test_a_sound_run_of_two_groups_follows_three_segments(tiny, monkeypatch):
    groups = []
    fold = registry.driver("cooling_fold")
    orig = fold.Program.run_group

    def counted(self, states):
        groups.append(1)
        return orig(self, states)
    monkeypatch.setattr(fold.Program, "run_group", counted)
    monkeypatch.setattr(cell.time, "perf_counter",
                        lambda: 0.0 if len(groups) < 3 else 1.0)
    r, f = run("cool3500_e99", seconds=0.5)
    assert r["groups"] == 2
    assert [s.name for s in f["segments"]] == ["start", "stage", "mid"]
    assert [s.tick for s in f["segments"]] == [0, 200, 300]
    assert r["correct"], r["checks"]
    assert r["checks"]["unmoved"]["value"] == 0


@pytest.mark.parametrize("members,mesh", [(99, None), (100, (4, 1)),
                                          (100, (2, 2))])
def test_every_block_of_a_full_fold_is_checked(members, mesh):
    """At the cells' own member counts (states only): over many seeds the
    checked members fall one in each rank's block of the mesh, and every
    run of E/2 consecutive members (a fold with half its members left
    out) holds one."""
    ids = torch.arange(members)[:, None].expand(members, 8)
    for seed in range(2 ** 31, 2 ** 31 + 400):
        got = check.checked_members(seed, members, 4)
        assert len(set(got)) == 4
        if mesh:
            m = make_mesh(*mesh, devices=["cpu"] * (mesh[0] * mesh[1]))
            blocks = [set(slot_block(ids, m, k, 0)[:, 0].tolist())
                      for k in range(mesh[0])]
            assert all(block & set(got) for block in blocks)
        for lo in range(members - members // 2 + 1):
            assert set(range(lo, lo + members // 2)) & set(got)
    seen = {j for s in range(400) for j in check.checked_members(
        s, members, 4)}
    assert len(seen) > 0.9 * members


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tiny, name):
    wl = tiny.workload(name)
    with tempfile.TemporaryDirectory() as d:
        r, f = cell.measure(name, SEED, 0.0, False, "cpu", 0.0, d)
    drv = registry.driver(wl["driver"])
    _, ctrl = drv.compare(r, f, SEED, torch.device("cpu"),
                          control=drv.CONTROL)
    ok, table = check.judge(ctrl, wl["limits"])
    assert not ok, table


def _step_unchanged(monkeypatch):
    monkeypatch.setattr(CoolingScheduler, "soa_md_step",
                        lambda self, carry, *a, **k: carry)


def _half_the_ions(monkeypatch):
    ke = lc.kinetic_energies

    def half(V, subtract_mean_vx=False, mask=None):
        return ke(V[: V.shape[0] // 2], subtract_mean_vx, None)
    monkeypatch.setattr(lc, "kinetic_energies", half)


def _answer_altered(monkeypatch):
    so = lc._sample_outputs

    def altered(*a, **k):
        out = so(*a, **k)
        out["vx_ions"] = out["vx_ions"].clone()
        out["vx_ions"][0] += 0.5
        return out
    monkeypatch.setattr(lc, "_sample_outputs", altered)


def _group_returns_its_input(monkeypatch):
    orig = lc.run_compiled_ensemble

    def unchanged(cfg, sched, states, n, **kw):
        return states, orig(cfg, sched, states, n, **kw)[1]
    monkeypatch.setattr(lc, "run_compiled_ensemble", unchanged)


def _forged_clock(cfg, sched, start, end, n):
    tick = int(start.tick) + n * cfg.sample_freq * sched.ratio
    return dataclasses.replace(end, tick=tick,
                               t=tick_time(tick, sched.qdt, end.R.dtype))


def _segments_skipped(monkeypatch):
    # the first segment of a group run, its sample repeated for the rest,
    # the clock set as if every segment had run
    orig = lc.run_compiled_ensemble

    def skipped(cfg, sched, states, n, **kw):
        end, outs = orig(cfg, sched, states, 1, **kw)
        return (_forged_clock(cfg, sched, states, end, n),
                {k: torch.cat([v] * n, 1) for k, v in outs.items()})
    monkeypatch.setattr(lc, "run_compiled_ensemble", skipped)


def _fewer_steps(monkeypatch):
    # half the MD steps of every segment, the clock set as if all had run
    orig = lc.run_compiled_ensemble

    def fewer(cfg, sched, states, n, **kw):
        end, outs = orig(cfg, sched, states, n,
                         seg_len=cfg.sample_freq // 2, **kw)
        return _forged_clock(cfg, sched, states, end, n), outs
    monkeypatch.setattr(lc, "run_compiled_ensemble", fewer)


def _half_the_members(monkeypatch):
    # the first half of the fold steps; the rest keeps its state and
    # repeats the first half's samples
    orig = lc.run_compiled_ensemble

    def half(cfg, sched, states, n, **kw):
        E = states.R.shape[0]
        h = E // 2
        part = dataclasses.replace(states, **{
            f: getattr(states, f)[:h] for f in ("R", "V", "F", "psi",
                                                "t_part")})
        end, outs = orig(cfg, sched, part, n, **kw)
        whole = dataclasses.replace(end, **{
            f: torch.cat([getattr(end, f), getattr(states, f)[h:]])
            for f in ("R", "V", "F", "psi", "t_part")})
        return whole, {k: torch.cat([v] + [v[-1:]] * (E - h))
                       for k, v in outs.items()}
    monkeypatch.setattr(lc, "run_compiled_ensemble", half)


def _sample_files_skipped(monkeypatch):
    # the writer leaves out the files of the job's second sample
    write = DatWriter.write

    def skipping(self, name, arr):
        if "time000001" not in name.lower():
            write(self, name, arr)
    monkeypatch.setattr(DatWriter, "write", skipping)


def _previous_sample_written(monkeypatch):
    # sample k's files and energies row hold sample k-1's values
    write = lc.write_outputs
    held = {}

    def shifted(directory, cfg, outs, *a, **k):
        prev = {key: v[-1:] for key, v in held.get(directory, outs).items()}
        held[directory] = outs
        late = {key: (v if key == "t" else
                      np.concatenate([prev[key], v[:-1]]))
                for key, v in outs.items()}
        return write(directory, cfg, late, *a, **k)
    monkeypatch.setattr(lc, "write_outputs", shifted)


def _job_stops_after_its_first_group(monkeypatch):
    # the first group runs; each later one hands back its input with the
    # clock set as if it had run, and the first group's samples
    orig = lc.run_compiled
    first = {}

    def stopped(cfg, sched, state, n):
        if not first or first["sched"] is not sched:
            end, outs = orig(cfg, sched, state, n)
            first.update(sched=sched, outs=outs)
            return end, outs
        tick = int(state.tick) + n * cfg.sample_freq * sched.ratio
        return (dataclasses.replace(state, tick=tick, t=tick_time(
                    tick, sched.qdt, state.R.dtype)),
                {k: v[:n] for k, v in first["outs"].items()})
    monkeypatch.setattr(lc, "run_compiled", stopped)


def _energies_one_row_short(monkeypatch):
    append = DatWriter.append
    cut = set()

    def short(self, name, arr):
        if name == "energies.dat" and self.dir not in cut:
            cut.add(self.dir)
            arr = np.asarray(arr)[1:]
        append(self, name, arr)
    monkeypatch.setattr(DatWriter, "append", short)


def _terminal_checkpoint_of_the_start(monkeypatch):
    run_job, write = lc.run, lc.write_terminal_checkpoint
    start = {}

    def remember(cfg, *a, state=None, **k):
        start["state"] = state_to_numpy(state)
        return run_job(cfg, *a, state=state, **k)

    def of_start(directory, cfg, final, *a, **k):
        return write(directory, cfg, start["state"], *a, **k)
    monkeypatch.setattr(lc, "run", remember)
    monkeypatch.setattr(lc, "write_terminal_checkpoint", of_start)


FOLD_FAULTS = [_group_returns_its_input, _segments_skipped, _fewer_steps,
               _half_the_members]
JOB_FAULTS = [_sample_files_skipped, _previous_sample_written,
              _job_stops_after_its_first_group, _energies_one_row_short,
              _terminal_checkpoint_of_the_start]
PATH_FAULTS = [_step_unchanged, _half_the_ions, _answer_altered]


@pytest.mark.parametrize("name", ONE_CARD)
@pytest.mark.parametrize("fault", PATH_FAULTS + FOLD_FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, name, fault):
    fault(monkeypatch)
    r, _ = run(name)
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


@pytest.mark.parametrize("fault", PATH_FAULTS + JOB_FAULTS)
def test_a_broken_job_is_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    r, _ = run(JOB)
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


@pytest.mark.parametrize("fault", sorted(rank_faults.FAULTS))
def test_a_broken_rank_is_not_correct(tiny, monkeypatch, fault):
    from mdqtplasmasims_torch.parallel import ranks
    monkeypatch.setattr(ranks, "_cooling_task", rank_faults.task)
    monkeypatch.setenv("BENCH_RANK_FAULT", fault)
    r, _ = run("cool3500_e100_ranks4")
    assert not r["correct"] and r["failed"] >= 1, r["checks"]
