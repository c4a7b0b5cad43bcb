"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``.

Puts the benchmark's folder, the checkout and this folder on the path,
and gives the tests a tiny form of each cell (``tiny``): its driver's
``tiny/<driver>.py``."""

import importlib
import os
import sys

import pytest
import torch

# one thread a process: the workers and a mesh cell's rank processes
# (which take this process's count) share the machine's cores
torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
HERE = os.path.dirname(TESTS)
sys.path[:0] = [HERE, os.path.dirname(HERE), TESTS]


def tiny_form(driver: str):
    """The module ``tiny/<driver>.py``."""
    return importlib.import_module("tiny." + driver)


@pytest.fixture
def tiny(monkeypatch):
    """Every cell at its driver's tiny form on the CPU (a mesh cell's
    ranks on CPU slots over gloo); each configuration at the form of the
    drivers that run it; a form's ``patch`` applied when the test first
    loads its driver, so that one family's patch never reaches another's
    cells; yields the registry."""
    from harness import registry
    config, workload, driver = (registry.config, registry.workload,
                                registry.driver)
    drivers = {n: workload(n)["driver"] for n in registry.names("workloads")}
    forms = {d: tiny_form(d) for d in set(drivers.values())}
    shrink = {}
    for n, d in drivers.items():
        fn = forms[d].tiny_config
        assert shrink.setdefault(workload(n)["config"], fn) is fn, \
            f"{n}: its configuration has another driver's tiny form"

    def tiny_config(name):
        return shrink[name](config(name))

    def tiny_workload(name):
        w = workload(name)
        return forms[w["driver"]].tiny_workload(w)
    patched = set()

    def patched_driver(name):
        mod = driver(name)
        if name in forms and name not in patched:
            patched.add(name)
            forms[name].patch(monkeypatch)
        return mod
    monkeypatch.setattr(registry, "config", tiny_config)
    monkeypatch.setattr(registry, "workload", tiny_workload)
    monkeypatch.setattr(registry, "driver", patched_driver)
    yield registry
