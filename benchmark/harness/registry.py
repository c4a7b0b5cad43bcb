"""Finds the benchmark's parts by name, so that a configuration, a cell
or a metric is added as a file and an entry of ``BENCHMARK.json``:

* ``configs/<name>.json``: a configuration (its physics, units, level
  scheme, guarantees and frozen work counts);
* ``workloads/<name>.json``: a cell's traffic (the configuration it runs,
  the driver that runs it, its members, traced work, checked members and
  the limits of its comparison);
* ``drivers/<name>.py``: a cell's program, the system under test as the
  workload's ``"driver"`` runs it (the interface: ``harness/cell.py``);
* ``metrics/<name>.py``: a metric's reader, ``read(run) -> float | None``
  (None: nothing to read in this run, and the metric is left out).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def names(kind: str) -> list:
    """The names of the files in ``configs``, ``workloads``, ``drivers``
    or ``metrics``."""
    ext = ".py" if kind in ("drivers", "metrics") else ".json"
    return sorted(f[:-len(ext)] for f in os.listdir(os.path.join(HERE, kind))
                  if f.endswith(ext) and not f.startswith("_"))


def config(name: str) -> dict:
    return _json(os.path.join(HERE, "configs", name + ".json"))


def workload(name: str) -> dict:
    return _json(os.path.join(HERE, "workloads", name + ".json"))


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    """The module ``drivers/<name>.py``, loaded once a process as
    ``drivers.<name>`` (so that what it sends to worker processes pickles
    by that name); there is no default driver."""
    path = os.path.join(HERE, "drivers", name + ".py")
    key = "drivers." + name
    mod = sys.modules.get(key)
    if mod is not None and getattr(mod, "__file__", None) == path:
        return mod
    if not os.path.exists(path):
        raise ValueError(f"no driver {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def spec(path: str = None) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return _json(path or os.path.join(REPO, "BENCHMARK.json"))


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced.  A metric with ``workloads``
    belongs to the cells it lists; a per-layer metric without it to every
    cell that reports the end-to-end metric it ``moves``."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
