"""A family enters as files: a stub family with none of cooling's keys
(a configuration, a driver with its ``NUMBERS`` and ``LIMITS``, a
workload that limits only the stub's own number, two readers, a tiny
form whose patch no cooling cell could run under, and entries in
``BENCHMARK.json``) is dropped into a copy of the benchmark, and the
copy's own tests pass on it unedited, the stub among the generic cells
and calibrate.py's readings and out of cooling's table tests."""

import filecmp
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

from harness import registry

STUB = "stub_rows"
CELL = "stub_rows_e1"

DRIVER = '''"""A stub family: rows of tanh(x @ w) from the seed, in the
configuration's dtype on the CPU, every row once a unit of work; compared
with a plain float64 recomputation in numpy."""

import time

import numpy as np
import torch

NUMBERS = ("gap",)
LIMITS = {"rows_gap": 0}
CONTROL = torch.bfloat16


def inputs(config, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    n, k = config["rows"], config["width"]
    x = torch.randn((n, k), generator=g, dtype=torch.float64)
    w = torch.randn((k, k), generator=g, dtype=torch.float64) / k ** 0.5
    return x.to(dtype), w.to(dtype)


class Driver:
    def __init__(self, config, workload, seed, device, scratch):
        self.config, self.seed = config, seed
        self.dtype = getattr(torch, config["dtype"])

    def warm_up(self):
        self.x, self.w = inputs(self.config, self.seed, self.dtype)
        self.y = torch.tanh(self.x @ self.w)

    def window(self, seconds, trace_dir=None):
        t0, units = time.perf_counter(), 0
        while True:
            self.y = torch.tanh(self.x @ self.w)
            units += 1
            if time.perf_counter() - t0 >= seconds:
                break
        return dict(wall_s=time.perf_counter() - t0, groups=units,
                    md_steps=units, rows=self.config["rows"],
                    bad_groups=int(not torch.isfinite(self.y).all()),
                    traced_md_steps=0, traced_segments=0)

    def trace_events(self, trace_dir):
        return []

    def memory_peak(self):
        return 0

    def close(self):
        pass

    def followed(self):
        return dict(rows=self.y.numpy())


def compare(run, followed, seed, device, control=None):
    x, w = inputs(run["config"], seed, torch.float64)
    ref = np.tanh(x.numpy() @ w.numpy())

    def gap(y):
        return float(np.max(np.abs(np.asarray(y, np.float64) - ref)))
    got = followed["rows"]
    worst = dict(gap=gap(got), rows_gap=abs(got.shape[0] - ref.shape[0]))
    ctrl = None
    if control is not None:
        xl, wl = inputs(run["config"], seed, control)
        ctrl = dict(gap=gap(torch.tanh(xl @ wl).to(torch.float64)))
    return worst, ctrl
'''

TINY = '''"""The stub family's tiny form: 64 rows, and a patch that a
cooling cell could not run under."""

SOUND = dict(groups=1, md_steps=1, followed=["rows"],
             checks=dict(rows_gap=0))


def tiny_config(config):
    return dict(config, rows=64)


def tiny_workload(workload):
    return dict(workload)


def patch(monkeypatch):
    import mdqtplasmasims_torch.experiments.laser_cooling as lc

    def refused(*a, **k):
        raise AssertionError("the stub family's patch reached a cooling cell")
    monkeypatch.setattr(lc, "CoolingConfig", refused)


def followed(f):
    return sorted(f)
'''

FILES = {
    f"configs/{STUB}.json": json.dumps(dict(
        name=STUB, source="the benchmark's own tests", rows=4096, width=64,
        dtype="float32")),
    f"drivers/{STUB}.py": DRIVER,
    f"workloads/{CELL}.json": json.dumps(dict(
        config=STUB, driver=STUB, members=1, limits=dict(gap=1e-4))),
    "metrics/stub_rows_per_s.py":
        "def read(run):\n    return run['groups'] * run['rows'] / "
        "run['wall_s']\n",
    "metrics/stub_unit_ms.py":
        "def read(run):\n    return 1e3 * run['wall_s'] / run['groups']\n",
    f"tests/tiny/{STUB}.py": TINY,
}

ENTRIES = dict(
    configs=[dict(name=STUB, source="the benchmark's own tests",
                  file=f"benchmark/configs/{STUB}.json", reduced=[],
                  why="a second family, with none of cooling's keys")],
    workloads=[dict(name=CELL, config=STUB, traffic="e1", chips=1,
                    why="one pass over the rows a unit of work")],
    end_to_end=[dict(name="stub_rows_per_s", unit="rows/s", better="higher",
                     bound=0.05, source="host_clock", workloads=[CELL])],
    per_layer=[dict(name="stub_unit_ms", unit="ms", better="lower",
                    source="program_counter", layer="stub rows",
                    moves="stub_rows_per_s", workloads=[CELL])])


def copy_benchmark(dst: str) -> None:
    """``benchmark/`` and ``BENCHMARK.json`` of this checkout into
    ``dst``."""
    shutil.copytree(registry.HERE, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    shutil.copy(os.path.join(registry.REPO, "BENCHMARK.json"), dst)


def drop_stub(root: str) -> None:
    """The stub family's files and entries, into the copy at ``root``."""
    for rel, text in FILES.items():
        path = os.path.join(root, "benchmark", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        bench = json.load(f)
    for key, entries in ENTRIES.items():
        bench[key] += entries
    with open(spec_path, "w") as f:
        json.dump(bench, f, indent=1)


def run_tests(root: str, xml: str) -> subprocess.CompletedProcess:
    """The copy's own tests but this file and the planted faults, in a
    process of its own with the checkout's packages on the path; the
    outcomes in the JUnit file ``xml``."""
    tests = os.path.join(root, "benchmark", "tests")
    cmd = [sys.executable, "-m", "pytest", tests, "-q", "-p",
           "no:cacheprovider", "-k", "not broken", "--junitxml", xml,
           "--ignore", os.path.join(tests, "test_bench_family.py")]
    if importlib.util.find_spec("xdist"):
        cmd += ["-n", "4"]
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.pathsep.join(
                   [registry.REPO, os.environ.get("PYTHONPATH", "")]))
    return subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)


def outcomes(xml: str) -> dict:
    """Each test's name (``test_x[id]``) and its outcome."""
    out = {}
    for case in ET.parse(xml).getroot().iter("testcase"):
        kinds = [c.tag for c in case] + ["passed"]
        out[case.get("name")] = next(
            k for k in kinds if k in ("failure", "error", "skipped",
                                      "passed"))
    return out


def changed(root: str) -> set:
    """The files of the copy that are not the checkout's, or differ."""
    here, bench = registry.REPO, registry.HERE
    out = set()
    if not filecmp.cmp(os.path.join(root, "BENCHMARK.json"),
                       os.path.join(here, "BENCHMARK.json"), shallow=False):
        out.add("BENCHMARK.json")
    for top in (os.path.join(root, "benchmark"), bench):
        for d, dirs, files in os.walk(top):
            dirs[:] = [x for x in dirs if x != "__pycache__"]
            for f in files:
                rel = os.path.relpath(os.path.join(d, f), top)
                a = os.path.join(root, "benchmark", rel)
                b = os.path.join(bench, rel)
                if not (os.path.exists(a) and os.path.exists(b)
                        and filecmp.cmp(a, b, shallow=False)):
                    out.add("benchmark/" + rel)
    return out


def test_a_second_family_enters_as_files(tmp_path):
    root = str(tmp_path / "checkout")
    copy_benchmark(root)
    drop_stub(root)
    xml = str(tmp_path / "out.xml")
    res = run_tests(root, xml)
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-2000:]
    got = outcomes(xml)
    assert not {n for n, k in got.items() if k != "passed"}, got
    for test in ("test_a_sound_run_is_correct",
                 "test_the_control_is_not_correct",
                 "test_a_reading_has_the_cells_metrics_and_its_control"):
        assert f"{test}[{CELL}]" in got
        assert f"{test}[cool3500_e99]" in got
    tables = {n for n in got if n.startswith("test_frozen_tables_are_")}
    assert tables == {"test_frozen_tables_are_the_ports[sr12_n3500]",
                      "test_frozen_tables_are_the_jax_packages[sr12_n3500]"}
    assert changed(root) == {"BENCHMARK.json"} | {
        "benchmark/" + rel for rel in FILES}
