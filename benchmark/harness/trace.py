"""Reduction of a Chrome trace of ``torch.profiler`` (CPU and CUDA
activity) to the traced window's numbers.

``union_us``, ``top_ops`` and ``trace_breakdown`` are copied from
tools/torch_soak.py:635-707 (``_union_us``, ``_top_ops``,
``trace_breakdown``); ``load_wall`` from tools/torch_mesh_cards.py.
``kernel_ms``, ``busy_s`` and ``idle_gaps`` are the benchmark's own."""

from __future__ import annotations

import bisect
import json

# the host's waits for a card in a trace's CUDA runtime events
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def load_wall(path: str) -> list:
    """A trace's complete events with ``ts`` on the wall clock (the
    trace's ``baseTimeNanoseconds`` added), so that the traces of several
    processes share one time axis (tools/torch_mesh_cards.py:586-594,
    ``wall_clock_events``)."""
    with open(path) as f:
        t = json.load(f)
    off = t.get("baseTimeNanoseconds", 0) / 1e3
    return [dict(e, ts=e["ts"] + off) for e in t["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def union_us(ops) -> float:
    """Microseconds covered by the union of the events' intervals."""
    busy, end = 0.0, float("-inf")
    for e in sorted(ops, key=lambda e: e["ts"]):
        a, b = max(e["ts"], end), e["ts"] + e["dur"]
        busy += max(0.0, b - a)
        end = max(end, b)
    return busy


def top_ops(ops, n_top: int) -> list:
    by_name = {}
    for e in ops:
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n_top]
    return [dict(name=k[:120], count=n, ms=t / 1e3) for k, (n, t) in top]


def device_ops(events) -> list:
    return [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in DEVICE_CATS]


def trace_breakdown(events, steps: int, n_top: int = 5) -> dict:
    """A Chrome trace's ``traceEvents`` of ``steps`` steps: the window,
    the device operations' busy share and top ``n_top``, the host's waits
    for a card and the copies to the host per step, and per card its busy
    share, its first and last kernel and its own top operations."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ops = [e for e in spans if e.get("cat") in DEVICE_CATS]
    t_lo = min((e["ts"] for e in spans), default=0.0)
    t_hi = max((e["ts"] + e["dur"] for e in spans), default=0.0)
    window = t_hi - t_lo
    busy = union_us(ops)
    per = {}
    for e in ops:
        if "device" in e.get("args", {}):
            per.setdefault(int(e["args"]["device"]), []).append(e)
    cards = {}
    for d, evs in sorted(per.items()):
        kernels = [e for e in evs if e.get("cat") == "kernel"] or evs
        first = min(e["ts"] for e in kernels)
        last = max(e["ts"] + e["dur"] for e in kernels)
        b = union_us(evs)
        cards[str(d)] = dict(busy_ms=b / 1e3,
                             busy_share=b / window if window else 0.0,
                             first_ms=(first - t_lo) / 1e3,
                             last_ms=(last - t_lo) / 1e3,
                             ops_per_step=len(evs) / steps,
                             top=top_ops(evs, n_top))
    waits = sum(1 for e in spans if e.get("name") in HOST_WAITS)
    return dict(steps=steps, window_ms=window / 1e3, busy_ms=busy / 1e3,
                busy_share=busy / window if window else 0.0,
                device_ops_per_step=len(ops) / steps,
                device_us_per_step=busy / steps,
                host_waits_per_step=waits / steps,
                top=top_ops(ops, n_top), cards=cards)


def kernel_ms(events, match, device=None) -> tuple:
    """``(ms, count)`` of the CUDA kernels whose name ``match`` accepts
    (on card ``device`` alone, if given)."""
    ks = [e for e in device_ops(events)
          if e.get("cat") == "kernel" and match(e["name"])
          and (device is None
               or int(e.get("args", {}).get("device", -1)) == device)]
    return sum(e["dur"] for e in ks) / 1e3, len(ks)


def busy_s(breakdown: dict) -> float:
    """Seconds in which an operation ran on a card, averaged over the
    cards of the trace."""
    cards = breakdown["cards"].values()
    if not cards:
        return breakdown["busy_ms"] / 1e3
    return sum(c["busy_ms"] for c in cards) / len(cards) / 1e3


def idle_gaps(events, n_top: int = 10) -> list:
    """The device's idle time between its operations, named by what the
    host was doing: each gap goes to the host event (an operator or a CUDA
    runtime call) that overlaps it most, or to ``host (between
    operators)`` where none covers half of it.  ``[[name, seconds], ...]``
    summed by name, the largest ``n_top``."""
    ops = sorted(device_ops(events), key=lambda e: e["ts"])
    host = sorted((e for e in events if e.get("ph") == "X" and "dur" in e
                   and e.get("cat") in ("cpu_op", "cuda_runtime",
                                        "cuda_driver")),
                  key=lambda e: e["ts"])
    gaps, end = [], None
    for e in ops:
        if end is not None and e["ts"] > end:
            gaps.append((end, e["ts"]))
        end = e["ts"] + e["dur"] if end is None else max(end,
                                                         e["ts"] + e["dur"])
    starts = [e["ts"] for e in host]
    by_name = {}
    for a, b in gaps:
        best, cover = "host (between operators)", 0.5 * (b - a)
        # host events that start within 50 ms before the gap
        for e in host[bisect.bisect_left(starts, a - 5e4):
                      bisect.bisect_left(starts, b)]:
            ov = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
            if ov > cover:
                best, cover = e["name"][:80], ov
        by_name[best] = by_name.get(best, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:n_top]]
