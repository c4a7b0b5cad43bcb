"""The program's spans in a traced window: the card's idle time, the
host's time and its launches and waits under each.

``mdqtplasmasims_torch.profiling.span`` records a span as a
``user_annotation`` event of the profiler's trace, on the clock of the
kernels, inside ``profiling.device_trace`` only: ``mdqt.md_step`` around
each MD step (``CoolingScheduler.soa_md_step``), ``mdqt.sample`` around
each sample of a fold (``laser_cooling._sample_fold``).  A trace of a
program without them has none, and every reader here then returns
None.  The window is ``trace.trace_breakdown``'s, so the idle parts add
up to ``device_idle_pct``'s idle time.

``bench.write`` is the harness's own span (``drivers/cooling_job.py``),
a ``record_function`` around each ``write_outputs`` and
``checkpoint.save_native`` call of a traced job: the tree writer."""

from __future__ import annotations

import bisect

from .trace import HOST_WAITS, device_ops

SAMPLE, STEP = "mdqt.sample", "mdqt.md_step"
WRITE = "bench.write"


def _complete(events) -> list:
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _merge(events) -> list:
    """The union of the events' intervals, sorted and disjoint."""
    out = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _intersect(xs, ys) -> list:
    """Where two sorted disjoint interval lists overlap."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(xs, ys) -> list:
    """``xs`` less ``ys`` (sorted disjoint interval lists)."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def _inside(intervals, t: float) -> bool:
    k = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return k >= 0 and intervals[k][0] <= t <= intervals[k][1]


def spans(events, name: str) -> list:
    """The host's ``name`` spans (the card's ``gpu_user_annotation``
    copies left out)."""
    return [e for e in _complete(events)
            if e.get("cat") == "user_annotation" and e["name"] == name]


def _covered(events, name: str) -> list:
    return _merge(spans(events, name))


def _idle(events) -> list:
    """The traced window's idle intervals: the window less the union of
    the card's operations."""
    every = _complete(events)
    t_lo = min(e["ts"] for e in every)
    t_hi = max(e["ts"] + e["dur"] for e in every)
    return _subtract([(t_lo, t_hi)], _merge(device_ops(events)))


def _idle_us(events) -> dict:
    """The traced window's idle time, in microseconds, split by the spans
    over it: ``SAMPLE``, ``STEP`` (outside every sample span) and ``None``
    (under neither)."""
    sample = _covered(events, SAMPLE)
    step = _subtract(_covered(events, STEP), sample)
    idle = _idle(events)
    parts = {SAMPLE: _length(_intersect(idle, sample)),
             STEP: _length(_intersect(idle, step))}
    parts[None] = _length(idle) - parts[SAMPLE] - parts[STEP]
    return parts


def idle_ms_per_step(run: dict, part):
    """Idle milliseconds per traced MD step under the ``part`` spans
    (``SAMPLE`` or ``STEP``), or under neither (``None``); None where the
    trace has no such span (no span at all, for ``None``)."""
    events = run.get("trace") or []
    names = (SAMPLE, STEP) if part is None else (part,)
    if not any(spans(events, n) for n in names):
        return None
    return _idle_us(events)[part] / 1e3 / run["traced_md_steps"]


def idle_ms(run: dict, name: str):
    """Milliseconds of the traced window in which the card is idle under
    ``name`` spans; None without such spans."""
    events = run.get("trace") or []
    covered = _covered(events, name)
    if not covered:
        return None
    return _length(_intersect(_idle(events), covered)) / 1e3


def host_ms(run: dict, name: str):
    """Milliseconds of the host inside ``name`` spans, less its waits for
    a card there (``trace.HOST_WAITS``); None without such spans."""
    events = run.get("trace") or []
    covered = _covered(events, name)
    if not covered:
        return None
    held = _merge(e for e in _complete(events) if e["name"] in HOST_WAITS)
    return (_length(covered) - _length(_intersect(covered, held))) / 1e3


def host_ms_per_step(run: dict, name: str):
    """Milliseconds per traced MD step of the host inside ``name`` spans,
    less its waits for a card there; None without such spans."""
    host = host_ms(run, name)
    return None if host is None else host / run["traced_md_steps"]


def per_member(run: dict, count):
    """``count(events, covered)`` of the intervals the ``SAMPLE`` spans
    cover, over those spans x the run's members; None without them."""
    events = run.get("trace") or []
    n = len(spans(events, SAMPLE))
    if not n:
        return None
    return count(events, _covered(events, SAMPLE)) / (n * run["members"])


def launches(events, covered) -> int:
    """Kernels whose launch (the CUDA runtime call with the kernel's
    ``correlation``) started inside ``covered``, wherever the kernel
    ran."""
    at = {e["args"]["correlation"]: e["ts"] for e in _complete(events)
          if e.get("cat") == "cuda_runtime"
          and "correlation" in e.get("args", {})}
    starts = (at.get(e.get("args", {}).get("correlation"))
              for e in device_ops(events) if e.get("cat") == "kernel")
    return sum(1 for t in starts if t is not None and _inside(covered, t))


def waits(events, covered) -> int:
    """The host's waits for a card (``trace.HOST_WAITS``) that started
    inside ``covered``."""
    return sum(1 for e in _complete(events)
               if e["name"] in HOST_WAITS and _inside(covered, e["ts"]))
