"""BENCHMARK.json and the files it names: every part is found by its
name, a new file is found without an edit, names and units keep to the
allowed characters."""

import json
import os
import re
import shutil
import tempfile

import pytest
import torch

from harness import cell, registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = registry.spec()


def test_every_config_workload_and_metric_loads_by_name():
    for c in BENCH["configs"]:
        assert registry.config(c["name"])["name"] == c["name"]
        assert os.path.exists(os.path.join(registry.REPO, c["file"]))
    for w in BENCH["workloads"]:
        wl = registry.workload(w["name"])
        assert wl["config"] == w["config"]
        drv = registry.driver(wl["driver"])
        assert callable(drv.Driver) and callable(drv.compare)
        # a workload limits only its driver's numbers, never one the
        # driver's own LIMITS fix
        assert set(wl["limits"]) <= set(drv.NUMBERS), w["name"]
        assert not set(drv.NUMBERS) & set(drv.LIMITS)
        assert isinstance(drv.CONTROL, torch.dtype)
        assert drv.CONTROL.is_floating_point
        assert os.path.exists(os.path.join(registry.HERE, "tests", "tiny",
                                           wl["driver"] + ".py"))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.reader(m["name"]))
    assert set(registry.names("configs")) == {c["name"]
                                              for c in BENCH["configs"]}


# a driver of the least work: one unit a window, one number compared
DRIVER = """
LIMITS = {"gap": 0.0}


class Driver:
    def __init__(self, config, workload, seed, device, scratch):
        self.seed = seed

    def warm_up(self):
        pass

    def window(self, seconds, trace_dir=None):
        return dict(wall_s=1.0, groups=1, md_steps=1, bad_groups=0,
                    traced_md_steps=0, traced_segments=0)

    def trace_events(self, trace_dir):
        return []

    def memory_peak(self):
        return 0

    def close(self):
        pass

    def followed(self):
        return dict(seed=self.seed)


def compare(run, followed, seed, device, control=None):
    return dict(n=0.5, gap=float(followed["seed"] != seed)), None
"""


@pytest.mark.parametrize("kind,text", [
    ("configs", None), ("workloads", None),
    ("metrics", "def read(run):\n    return 1.0\n"),
    ("drivers", DRIVER)])
def test_a_dropped_file_is_found_without_an_edit(tmp_path, monkeypatch,
                                                 kind, text):
    root = tmp_path / "benchmark"
    shutil.copytree(registry.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(registry, "HERE", str(root))
    folder = root / kind
    if kind == "drivers":
        # a driver and a workload naming it: run by cell.measure and
        # cell.verify as they stand
        (folder / "added_one.py").write_text(text)
        (root / "workloads" / "added_one.json").write_text(json.dumps(dict(
            config="sr12_n3500", driver="added_one", members=1,
            limits=dict(n=1.0))))
        assert "added_one" in registry.names(kind)
        with tempfile.TemporaryDirectory() as d:
            r, f = cell.measure("added_one", 7, 0.0, False, "cpu", 0.0, d)
        cell.verify(r, f, 7, "cpu")
        assert r["correct"] and r["groups"] == 1, r["checks"]
        assert r["checks"] == {"n": dict(value=0.5, limit=1.0),
                               "gap": dict(value=0.0, limit=0.0)}
    elif text is None:
        src = sorted(folder.iterdir())[0]
        data = json.loads(src.read_text())
        (folder / "added_one.json").write_text(json.dumps(data))
        assert "added_one" in registry.names(kind)
        getattr(registry, kind[:-1])("added_one")
    else:
        (folder / "added_one.py").write_text(text)
        assert "added_one" in registry.names(kind)
        assert registry.reader("added_one")({}) == 1.0


def test_a_workload_without_a_driver_is_refused(monkeypatch):
    wl = dict(registry.workload("cool3500_e99"))
    del wl["driver"]
    monkeypatch.setattr(registry, "workload", lambda name: wl)
    with pytest.raises(ValueError, match="names no \"driver\""):
        cell.measure("cool3500_e99", 7, 0.0, False, "cpu", 0.0, "unused")


def test_an_unknown_driver_is_refused():
    with pytest.raises(ValueError, match="no driver 'absent'"):
        registry.driver("absent")


def test_names_units_and_keys_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for x in names + [m["name"] for m in metrics]:
        assert NAME.match(x), x
    assert len(set(names)) == len(names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("device_trace", "host_clock")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert len(registry.cell_metrics(BENCH, w["name"], False)) >= 2
        assert registry.cell_metrics(BENCH, w["name"], True)
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert os.path.getsize(os.path.join(registry.REPO,
                                        "BENCHMARK.json")) < 64 * 1024


def test_per_layer_metrics_without_workloads_follow_their_moves():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b",
                                            "workloads": ["x"]}],
             "per_layer": [{"name": "p", "moves": "b"},
                           {"name": "q", "moves": "a", "workloads": ["y"]}]}
    assert [m["name"] for m in registry.cell_metrics(bench, "x", True)] \
        == ["p"]
    assert [m["name"] for m in registry.cell_metrics(bench, "y", True)] \
        == ["q"]
    assert [m["name"] for m in registry.cell_metrics(bench, "y", False)] \
        == ["a"]
