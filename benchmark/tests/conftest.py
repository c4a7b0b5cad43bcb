"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``.

Puts the benchmark's folder and the checkout on the path, and gives the
tests a tiny form of each cell (``tiny``): 48 ions a member, at most 3
members (4 on a mesh), 4 MD steps a segment, 2 segments a group, a job of
6 segments (tmax 0.048), one traced group, the
port's plain CPU versions with the tick kernel's own stream (the uniforms'
form the card takes)."""

import copy
import math
import os
import sys

import pytest
import torch

# one thread a process: the workers and a mesh cell's rank processes
# (which take this process's count) share the machine's cores
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

TINY_N0 = 48


def tiny_config(config: dict) -> dict:
    c = copy.deepcopy(config)
    c["physics"].update(n0=TINY_N0, sample_freq=4,
                        checkpoint_every_segments=2, tmax=0.048)
    c["derived"]["L"] = (TINY_N0 * 4 * math.pi / 3) ** (1 / 3)
    c["derived"]["npad"] = 512
    return c


@pytest.fixture
def tiny(monkeypatch):
    """Every cell at the tiny size on the CPU (a mesh cell's ranks on CPU
    slots over gloo, 4 members); yields the registry."""
    from harness import registry
    import mdqtplasmasims_torch.experiments.laser_cooling as lc
    config, workload = registry.config, registry.workload

    def tiny_workload(name):
        w = dict(workload(name))
        w.update(members=4 if "mesh" in w else min(w["members"], 3),
                 trace_groups=1)
        return w
    monkeypatch.setattr(registry, "config",
                        lambda name: tiny_config(config(name)))
    monkeypatch.setattr(registry, "workload", tiny_workload)
    monkeypatch.setattr(lc, "_use_internal_rng", lambda device, rolls: True)
    yield registry
