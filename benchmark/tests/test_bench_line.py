"""The result line's schema, and the modules a run and the reference
load."""

import json
import os
import subprocess
import sys
import tempfile

import pytest

import run as bench_run
from harness import cell, registry

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_contracts_keys(tiny, monkeypatch, trace):
    import torch
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    name = "cool3500_e99"
    with tempfile.TemporaryDirectory() as d:
        r, segments = cell.measure(name, 99, 0.0, trace, "cpu", 0.0, d)
    metrics = registry.cell_metrics(registry.spec(), name, trace)
    cell.verify(r, segments, 99, "cpu")
    line = bench_run.result_line(r, metrics, trace)
    line = json.loads(json.dumps(line))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    names = {m["name"] for m in metrics}
    assert set(line["metrics"]) <= names
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        b = line["breakdown"]
        assert set(b) == {"device_ops", "idle_gaps"}
        assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == names


PARENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "e99_parent_tiny.json")
# what changes from run to run: the clocks, and the trace's timings
VOLATILE = ("setup_s", "wall_s", "check_s", "trace", "breakdown")


@pytest.mark.parametrize("trace", [False, True])
def test_the_fold_driver_repeats_the_harness_it_came_from(tiny, monkeypatch,
                                                          trace):
    """``cool3500_e99`` through ``drivers/cooling_fold.py`` gives the run
    record and the last line that the harness gave before the fold moved
    behind the driver seam (recorded at the tiny size on the CPU, kept in
    ``e99_parent_tiny.json``), but for the workload's new ``"driver"`` and
    what a run's clocks and trace timings change."""
    import torch
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    with open(PARENT) as f:
        want = json.load(f)["trace" if trace else "untraced"]
    name, seed = "cool3500_e99", 2 ** 31 + 12345
    with tempfile.TemporaryDirectory() as d:
        r, segments = cell.measure(name, seed, 0.0, trace, "cpu", 0.0, d)
    cell.verify(r, segments, seed, "cpu")
    line = json.loads(json.dumps(bench_run.result_line(
        r, registry.cell_metrics(registry.spec(), name, trace), trace)))
    assert sorted(r) == want["record_keys"]
    record = json.loads(json.dumps({k: v for k, v in r.items()
                                    if k not in VOLATILE + ("config",)}))
    assert record.pop("workload").pop("driver") == "cooling_fold"
    assert record == {k: v for k, v in want["record"].items()
                      if k != "workload"}
    assert r["workload"] == {**want["record"]["workload"],
                             "driver": "cooling_fold"}
    assert list(line) == want["line_keys"]
    line["metrics"] = {k: v["unit"] for k, v in line["metrics"].items()}
    for k in ("busy_s", "window_s"):
        if k in line["device"]:
            line["device"][k] = None
    if "breakdown" in line:
        line["breakdown"] = sorted(line["breakdown"])
    assert line == want["line"]


JOB_PARENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "e1_tree_parent_tiny.json")


@pytest.mark.parametrize("trace", [False, True])
def test_the_job_driver_repeats_its_recorded_run(tiny, monkeypatch, trace):
    """``cool3500_e1_tree`` gives the run record and the last line it gave
    when its driver declared no ``NUMBERS`` and the tiny forms lay in
    ``conftest.py`` (recorded at the tiny size on the CPU, kept in
    ``e1_tree_parent_tiny.json``), but for what a run's clocks and trace
    timings change."""
    import torch
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    with open(JOB_PARENT) as f:
        want = json.load(f)["trace" if trace else "untraced"]
    name, seed = "cool3500_e1_tree", 2 ** 31 + 12345
    with tempfile.TemporaryDirectory() as d:
        r, followed = cell.measure(name, seed, 0.0, trace, "cpu", 0.0, d)
    cell.verify(r, followed, seed, "cpu")
    line = json.loads(json.dumps(bench_run.result_line(
        r, registry.cell_metrics(registry.spec(), name, trace), trace)))
    assert sorted(r) == want["record_keys"]
    assert json.loads(json.dumps({k: v for k, v in r.items()
                                  if k not in VOLATILE + ("config",)})) \
        == want["record"]
    assert list(line) == want["line_keys"]
    line["metrics"] = {k: v["unit"] for k, v in line["metrics"].items()}
    for k in ("busy_s", "window_s"):
        if k in line["device"]:
            line["device"][k] = None
    if "breakdown" in line:
        line["breakdown"] = sorted(line["breakdown"])
    assert line == want["line"]


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = [{HERE!r}, "
         f"{os.path.dirname(HERE)!r}]; {code}; import json; print(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, env=dict(
            os.environ, USE_FLAX="0"))
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = ",".join(f"registry.reader({m!r})" for m in registry.names(
        "metrics"))
    top = _loaded(
        "import run; from harness import cell, check, registry, roofline, "
        "trace; from reference import mdqt; "
        "[registry.driver(d) for d in registry.names('drivers')]; "
        "from mdqtplasmasims_torch.experiments import laser_cooling; "
        "from mdqtplasmasims_torch import profiling; "
        f"[{names}]")
    assert "mdqtplasmasims_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "mdqtplasmasims_tpu"}


def test_the_reference_loads_nothing_of_either_package():
    top = _loaded("from reference import mdqt")
    assert not top & {"jax", "jaxlib", "flax", "mdqtplasmasims_tpu",
                      "mdqtplasmasims_torch"}
