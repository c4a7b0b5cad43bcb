"""The port's program spans (``profiling.span``): off outside a trace,
recorded inside ``profiling.device_trace`` around each MD step and each
fold sample, and without effect on what the program computes."""

import json

import pytest
import torch

from mdqtplasmasims_torch import profiling
from mdqtplasmasims_torch.core.scheduler import uniform_rolls
from mdqtplasmasims_torch.experiments import laser_cooling as lc

CFG = lc.CoolingConfig(n0=48, sample_freq=4, tmax=0.016)


def tiny_fold():
    """Two members of 48 ions, two output segments of 4 MD steps."""
    fold = lc.member_states(CFG, 2, 3, "cpu")
    sched = lc.build_scheduler(
        CFG, "cpu", uniform_rolls(torch.Generator().manual_seed(5)))
    return lc.run_compiled_ensemble(CFG, sched, fold, 2)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The tiny fold under a CPU trace: its result and the trace's
    events."""
    d = tmp_path_factory.mktemp("spans")
    with profiling.device_trace(str(d), device="cpu"):
        got = tiny_fold()
    with open(d / "trace.json") as f:
        return got, json.load(f)["traceEvents"]


def test_spans_off_enter_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with spans off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    state, outs = tiny_fold()
    assert outs["ekin"].shape[:2] == (2, 2)


def test_a_trace_holds_each_md_step_and_sample_as_a_span(traced):
    _, events = traced
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    steps = [e for e in notes if e["name"] == "mdqt.md_step"]
    samples = [e for e in notes if e["name"] == "mdqt.sample"]
    # each segment: 3 whole MD steps, the last one split around its sample
    assert len(steps) == 2 * (4 + 1) and len(samples) == 2
    assert len(notes) == len(steps) + len(samples)
    for s in samples:
        assert not any(s["ts"] <= e["ts"] < s["ts"] + s["dur"]
                       for e in steps)


def test_spans_leave_the_outputs_and_the_state_bitwise_alike(traced):
    (state, outs), _ = traced
    state0, outs0 = tiny_fold()
    assert outs.keys() == outs0.keys()
    for k in outs0:
        assert torch.equal(outs[k], outs0[k]), k
    for f in ("R", "V", "F", "psi", "t_part"):
        assert torch.equal(getattr(state, f), getattr(state0, f)), f
    assert (state.tick, state.t) == (state0.tick, state0.t)


def test_device_trace_restores_the_spans_flag(tmp_path):
    assert profiling.span("x") is profiling.span("y")
    with profiling.device_trace(str(tmp_path / "a"), device="cpu"):
        assert profiling.span("x") is not profiling.span("x")
    assert profiling.span("x") is profiling.span("y")
    with pytest.raises(ValueError):
        with profiling.device_trace(str(tmp_path / "b"), device="cpu"):
            raise ValueError("inside the trace")
    assert profiling.span("x") is profiling.span("y")
