"""The span readers' arithmetic on synthetic traces."""

import pytest

from harness import registry, spans, trace
from test_bench_metrics import ev

READERS = ("sample_idle_ms_per_step", "step_idle_ms_per_step",
           "other_idle_ms_per_step", "sample_host_ms_per_step",
           "step_host_ms_per_step", "sample_launches_per_member",
           "sample_waits_per_member")


def span(name, ts, dur):
    return ev(name, ts, dur, cat="user_annotation")


def launch(ts, correlation):
    return ev("cudaLaunchKernel", ts, 1, cat="cuda_runtime",
              correlation=correlation)


def traced(events, steps=1, members=1):
    return dict(trace=events, traced_md_steps=steps, members=members,
                breakdown=trace.trace_breakdown(events, steps))


def read(name, run):
    return registry.reader(name)(run)


def test_the_idle_parts_add_up_to_the_windows_idle():
    events = [ev("k1", 0, 10), ev("k2", 30, 10), ev("k3", 90, 10),
              span(spans.STEP, 10, 15), span(spans.SAMPLE, 40, 40),
              # the card's copy of a span is not the host's
              ev(spans.SAMPLE, 30, 60, cat="gpu_user_annotation")]
    run = traced(events, steps=2)
    parts = [read(n + ".fold", run) for n in READERS[:3]]
    assert parts == pytest.approx([40e-3 / 2, 15e-3 / 2, 15e-3 / 2])
    idle = (read("device_idle_pct.fold", run) / 100
            * run["breakdown"]["window_ms"] / 2)
    assert sum(parts) == pytest.approx(idle)


def test_a_gap_across_a_spans_edge_is_split():
    events = [ev("k1", 0, 10), ev("k2", 50, 10), span(spans.SAMPLE, 20, 40),
              span(spans.STEP, 5, 10)]
    run = traced(events)
    assert read("sample_idle_ms_per_step", run) == pytest.approx(30e-3)
    assert read("step_idle_ms_per_step", run) == pytest.approx(5e-3)
    assert read("other_idle_ms_per_step", run) == pytest.approx(5e-3)


def test_a_step_inside_a_sample_counts_as_the_sample():
    events = [ev("k1", 0, 10), ev("k2", 50, 10), span(spans.SAMPLE, 10, 40),
              span(spans.STEP, 20, 10)]
    run = traced(events)
    assert read("sample_idle_ms_per_step", run) == pytest.approx(40e-3)
    assert read("step_idle_ms_per_step", run) == 0.0
    assert read("other_idle_ms_per_step", run) == 0.0


def test_host_waits_are_taken_out_of_host_time():
    sync = "cudaStreamSynchronize"
    events = [span(spans.SAMPLE, 0, 100), span(spans.STEP, 200, 20),
              ev(sync, 20, 30, cat="cuda_runtime"),
              ev(sync, 90, 30, cat="cuda_runtime"),     # across the edge
              ev(sync, 150, 10, cat="cuda_runtime"),    # outside both
              ev("cudaLaunchKernel", 205, 5, cat="cuda_runtime")]
    run = traced(events, steps=2, members=2)
    assert read("sample_host_ms_per_step", run) == pytest.approx(60e-3 / 2)
    assert read("step_host_ms_per_step", run) == pytest.approx(20e-3 / 2)
    # two waits start in the one sample span of two members
    assert read("sample_waits_per_member", run) == pytest.approx(1.0)


def test_a_kernel_counts_toward_the_span_that_launched_it():
    events = [span(spans.SAMPLE, 0, 50), span(spans.SAMPLE, 300, 10),
              launch(10, 7), ev("late", 200, 10, correlation=7),
              launch(60, 8), ev("early", 20, 10, correlation=8),
              launch(20, 9), ev("copy", 30, 5, cat="gpu_memcpy",
                                correlation=9)]
    run = traced(events, members=2)
    # one kernel over two sample spans x two members
    assert read("sample_launches_per_member.fold", run) == pytest.approx(
        1 / 4)


@pytest.mark.parametrize("name", READERS)
def test_every_span_reader_returns_nothing_without_spans(name):
    kernels = [ev("k", 0, 10, correlation=1), launch(0, 1),
               ev("cudaStreamSynchronize", 11, 2, cat="cuda_runtime")]
    assert read(name, traced(kernels)) is None
    assert read(name + ".fold", dict(traced_md_steps=40, members=99)) is None


def test_the_sample_readers_return_nothing_with_step_spans_alone():
    run = traced([ev("k", 0, 10), span(spans.STEP, 10, 10)])
    for name in READERS:
        got = read(name, run)
        assert (got is None) == name.startswith("sample_"), name


def test_the_writers_host_and_idle_time_per_sample():
    sync = "cudaStreamSynchronize"
    events = [ev("k1", 0, 10), ev("k2", 100, 10),
              span(spans.WRITE, 20, 60), span(spans.WRITE, 30, 10),
              ev(sync, 70, 20, cat="cuda_runtime")]      # across the edge
    run = dict(traced(events, steps=8), traced_segments=2)
    # the card is idle from 10 to 100; the spans cover 20 to 80
    assert read("write_idle_ms_per_sample", run) == pytest.approx(60e-3 / 2)
    assert read("write_host_ms_per_sample", run) == pytest.approx(50e-3 / 2)
    for name in ("write_idle_ms_per_sample", "write_host_ms_per_sample"):
        assert read(name, traced([ev("k", 0, 10)])) is None
