"""The metric readers' arithmetic on synthetic runs and traces."""

import math

import pytest

from harness import cell, registry, roofline, trace

CONFIG = registry.config("sr12_n3500")


def ev(name, ts, dur, cat="kernel", **args):
    return dict(ph="X", name=name, ts=ts, dur=dur, cat=cat, args=args)


def test_percentile_is_the_nearest_rank_over_every_segment():
    assert cell.percentile(range(1, 101), 95) == 95
    assert cell.percentile([3.0], 95) == 3.0
    seg = [30.0] * 90 + [31.0] * 5 + [80.0] * 5
    run = dict(segment_ms=seg)
    assert registry.reader("segment_ms_p95")(run) == 31.0
    assert registry.reader("segment_ms_p95")(dict(segment_ms=[])) is None


def test_rate_is_every_update_over_the_whole_window():
    run = dict(config=CONFIG, members=99, md_steps=4000, wall_s=32.0)
    want = 99 * 3500 * 25 * 4000 / 32.0
    assert registry.reader("updates_per_s")(run) == pytest.approx(want)


def test_union_and_idle_share():
    ops = [ev("a", 0, 10), ev("b", 5, 10), ev("c", 30, 10)]
    assert trace.union_us(ops) == 25
    b = trace.trace_breakdown(ops + [ev("cudaLaunchKernel", 0, 1,
                                        cat="cuda_runtime")], steps=5)
    assert b["busy_ms"] == pytest.approx(0.025)
    assert b["window_ms"] == pytest.approx(0.040)
    run = dict(breakdown=b)
    assert registry.reader("device_idle_pct")(run) == pytest.approx(37.5)


def test_idle_gaps_are_named_by_the_host_event_that_covers_them():
    events = [ev("k1", 0, 10), ev("k2", 20, 10), ev("k3", 100, 10),
              ev("aten::stack", 8, 14, cat="cpu_op"),
              ev("cudaStreamSynchronize", 29, 2, cat="cuda_runtime")]
    gaps = dict(trace.idle_gaps(events))
    assert gaps["aten::stack"] == pytest.approx(10e-6)
    assert gaps["host (between operators)"] == pytest.approx(70e-6)


def test_roofline_shares_count_the_problem_not_the_launches():
    steps, members = 40, 99
    pairs = 99 * 3500 * 3499 // 2
    least = 40 * pairs * 31 / 67e12 + pairs * 33 / 67e12
    assert roofline.segment_pair_bound_s(CONFIG, members, steps) \
        == pytest.approx(least)
    tick = 99 * 3500 * 1756 / 67e12
    plane = 4 * 81 * 99 * 3584 / 3.35e12       # the one-tick launch's bytes
    ticks = 999 * tick + plane
    assert plane > tick
    assert roofline.segment_tick_bound_s(CONFIG, members, steps) \
        == pytest.approx(ticks, rel=1e-12)
    # the kernels take ten times their least time
    events = [ev("void yukawa_pair_kernel<false, false>(float)", 0,
                 1e7 * least),
              ev("void fused_ticks_kernel<12, 16>(TickConsts)", 0,
                 1e7 * ticks),
              ev("void at::native::add_kernel", 0, 2000.0)]
    run = dict(trace=events, config=CONFIG, members=members,
               traced_segments=1, traced_md_steps=steps)
    assert registry.reader("pair_roofline")(run) == pytest.approx(10.0)
    assert registry.reader("tick_roofline")(run) == pytest.approx(10.0)
    assert registry.reader("glue_ms_per_step")(run) == pytest.approx(2 / 40)
    assert registry.reader("launches_per_step")(run) == pytest.approx(3 / 40)


def test_a_reader_with_nothing_to_read_returns_nothing():
    run = dict(trace=[ev("void at::native::add_kernel", 0, 5.0)],
               config=CONFIG, members=1, traced_segments=1,
               traced_md_steps=40)
    assert registry.reader("pair_roofline")(run) is None
    assert registry.reader("tick_roofline")(run) is None
    assert math.isclose(registry.reader("glue_ms_per_step")(run), 5e-3 / 40)


def test_a_fold_cells_readers_are_its_bases():
    bench = registry.spec()
    folds = [m["name"] for m in bench["per_layer"] + bench["end_to_end"]
             if m["name"].endswith(".fold") or m["name"].startswith("fold_")]
    assert folds
    run = dict(config=CONFIG, members=99, md_steps=400, wall_s=3.0,
               traced_segments=1, traced_md_steps=40,
               breakdown=dict(window_ms=2.0, busy_ms=1.0),
               trace=[ev("void yukawa_pair_kernel<false, false>", 0, 9e4),
                      ev("void fused_ticks_kernel<12>", 0, 9e4),
                      ev("void at::native::add_kernel", 0, 10.0)])
    for name in folds:
        base = name[:-len(".fold")] if name.endswith(".fold") else name[5:]
        assert registry.reader(name)(run) == registry.reader(base)(run)


def test_a_job_cells_readers_are_its_bases():
    bench = registry.spec()
    jobs = [m["name"] for m in bench["per_layer"]
            if m["name"].endswith(".job")]
    assert len(jobs) == 7
    run = dict(config=CONFIG, members=1, md_steps=400, wall_s=3.0,
               traced_segments=10, traced_md_steps=400,
               breakdown=dict(window_ms=2.0, busy_ms=1.0),
               trace=[ev("void yukawa_pair_kernel<false, false>", 0, 9e4),
                      ev("void fused_ticks_kernel<12>", 0, 9e4),
                      ev("bench.write", 9e4, 50.0, cat="user_annotation"),
                      ev("mdqt.md_step", 0, 10.0, cat="user_annotation")])
    for name in jobs:
        got = registry.reader(name)(run)
        assert got is not None and got == registry.reader(
            name[:-len(".job")])(run), name
