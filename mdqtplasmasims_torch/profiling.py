"""Tracing / profiling utilities.

The reference's only observability is ``cout << k`` progress prints and
timing notes in comments (SURVEY.md section 5).  Here profiling is a
module of its own: phase wall-clock timers with derived throughput
metrics, and a thin wrapper over ``torch.profiler`` for device traces.

The port's own copy of ``mdqtplasmasims_tpu/profiling.py`` on torch:
``PhaseTimer.phase(block_on=...)`` synchronizes the CUDA devices of the
tensors it is given (as ``jax.block_until_ready`` does there), and
:func:`device_trace` records CPU and CUDA activity into a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):       # NamedTuple states too
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree) -> None:
    """Wait for the work queued on the CUDA device of every tensor in
    ``tree`` (a tensor, or dicts, lists and tuples of them); CPU tensors
    are ready when they exist."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


@dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase; blocks on device work so the
    numbers mean what they say."""

    phases: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.phases.values()) or 1.0
        lines = [f"{n:30s} {t:9.3f}s  x{self.counts[n]:<5d} "
                 f"{100 * t / total:5.1f}%"
                 for n, t in sorted(self.phases.items(),
                                    key=lambda kv: -kv[1])]
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps({"phases": self.phases, "counts": self.counts})


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """``torch.profiler`` over the block, written as a Chrome trace
    (``trace.json``, open in chrome://tracing or Perfetto) into
    ``log_dir``; yields the profiler (``key_averages()``, ``events()``).

    ``device="cuda"`` records CPU and CUDA activity and waits at the end
    for every visible card (``"cuda:k"`` for card k alone), and raises
    when no CUDA device is there; ``device="cpu"`` records the CPU only."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace(device='cuda'): no CUDA device")
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if len(acts) > 1:
            index = torch.device(device).index
            for j in (range(torch.cuda.device_count()) if index is None
                      else (index,)):
                torch.cuda.synchronize(j)
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def throughput(n_ions: int, n_ticks: int, seconds: float) -> dict:
    """Standard metrics for an MDQT run segment."""
    return {
        "ion_qt_updates_per_sec": n_ions * n_ticks / seconds,
        "us_per_quantum_tick": seconds / max(n_ticks, 1) * 1e6,
        "seconds": seconds,
    }


def card_name(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, the label every card
    number carries; "cpu" for a CPU device."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def record_table(path: str, name: str, table: dict, device) -> None:
    """Merge ``{name: table}``, with the card's :func:`card_name`, into the
    JSON object at ``path`` (made if absent), keeping its other entries."""
    cur = {}
    if os.path.exists(path):
        with open(path) as f:
            cur = json.load(f)
    cur[name] = dict(table, card=card_name(device))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cur, f, indent=1, sort_keys=True)
