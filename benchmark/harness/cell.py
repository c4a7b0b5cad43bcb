"""One run of a cell: set-up, the measured window, the comparison.

The program a cell runs is its workload's ``"driver"``,
``drivers/<name>.py`` (:func:`registry.driver`), which defines

* ``Driver(config, workload, seed, device, scratch)``, the system under
  test built for one run, with ``warm_up()`` (the set-up's work: the
  start from ``seed``, every kernel built and loaded); ``window(seconds,
  trace_dir)``, the measured work until its first unit of work ends after
  ``seconds``, tracing what the driver traces when ``trace_dir`` is given,
  which returns the run record's counts (``wall_s``, ``groups``,
  ``md_steps``, ``bad_groups``, ``traced_md_steps``, ``traced_segments``
  and what the driver's readers read besides); ``trace_events(trace_dir)``;
  ``memory_peak()``; ``close()``; and ``followed()``, called once the
  driver is closed: what the comparison follows;
* ``compare(run, followed, seed, device, control)``: the compared numbers
  of a run, and with ``control`` (a dtype) the control's;
* ``NUMBERS``: the names of the numbers ``compare`` returns that a
  workload's ``limits`` may name (the cooling drivers' six are
  ``check.NUMBERS``);
* ``LIMITS``: the limits the driver fixes, beside the workload's, on the
  other numbers ``compare`` returns;
* ``CONTROL``: the control's dtype, the nearest precision below the one
  the configuration states (``calibrate.py`` and the CPU tests read it).

Scratch space (a run's trees, its trace) lies under ``scratch``.  A
driver's tiny form for the CPU tests is ``tests/tiny/<name>.py``.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from . import check, registry


def seed_word(seed: int) -> int:
    """The run's 31-bit word of the tick kernel's stream, from ``seed``."""
    return int(np.random.default_rng([seed, 1]).integers(1, 2 ** 31 - 1))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def driver_of(name: str, workload: dict):
    """The driver module that ``workloads/<name>.json`` names."""
    if "driver" not in workload:
        raise ValueError(f"workloads/{name}.json names no \"driver\": each "
                         "workload names the file of drivers/ that runs it")
    return registry.driver(workload["driver"])


def measure(name: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, scratch: str) -> tuple:
    """Set-up and window of a run of cell ``name``: ``(run, followed)``,
    the run record the metric readers read and what the comparison
    follows."""
    wl = registry.workload(name)
    config = registry.config(wl["config"])
    drv = driver_of(name, wl).Driver(config, wl, seed, device, scratch)
    try:
        drv.warm_up()
        sync(device)
        setup_s = time.perf_counter() - t_start
        trace_dir = os.path.join(scratch, "trace")
        w = drv.window(seconds, trace_dir if trace else None)
        run = dict(name=name, config=config, workload=wl,
                   members=wl["members"], setup_s=setup_s,
                   memory_peak_bytes=drv.memory_peak(), **w)
        if trace:
            from . import trace as tr
            run["trace"] = drv.trace_events(trace_dir)
            run["breakdown"] = tr.trace_breakdown(run["trace"],
                                                  w["traced_md_steps"])
    finally:
        drv.close()
    return run, drv.followed()


def verify(run: dict, followed: dict, seed: int, device,
           control=None) -> dict:
    """The comparison of what the window ``followed`` with the reference,
    once the program's state is freed: adds ``correct``, ``failed``,
    ``checks`` (each limited number beside its limit), ``worst`` and
    ``check_s`` to ``run``; with ``control`` (a dtype) also ``control``,
    the control's numbers."""
    wl = run["workload"]
    drv = driver_of(run["name"], wl)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    worst, ctrl = drv.compare(run, followed, seed, torch.device(device),
                              control)
    ok, table = check.judge(worst, {**wl["limits"], **drv.LIMITS})
    run.update(correct=ok and run["bad_groups"] == 0, checks=table,
               worst=worst, control=ctrl, check_s=time.perf_counter() - t0,
               failed=run["bad_groups"] + (0 if ok else 1))
    return run


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]
