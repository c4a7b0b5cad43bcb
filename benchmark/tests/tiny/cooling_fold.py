"""The cooling drivers' tiny form: 48 ions a member, at most 3 members (4
on a mesh), 4 MD steps a segment, 2 segments a group, a job of 6 segments
(tmax 0.048), one traced group, the port's plain CPU versions with the
tick kernel's own stream (the uniforms' form the card takes).  A fold at
this size runs one group when given no time."""

import copy
import math

TINY_N0 = 48
SOUND = dict(groups=1, md_steps=8, followed=["start", "mid"],
             checks=dict(tick_gap=0))


def tiny_config(config: dict) -> dict:
    c = copy.deepcopy(config)
    c["physics"].update(n0=TINY_N0, sample_freq=4,
                        checkpoint_every_segments=2, tmax=0.048)
    c["derived"]["L"] = (TINY_N0 * 4 * math.pi / 3) ** (1 / 3)
    c["derived"]["npad"] = 512
    return c


def tiny_workload(workload: dict) -> dict:
    w = dict(workload)
    w.update(members=4 if "mesh" in w else min(w["members"], 3),
             trace_groups=1)
    return w


def patch(monkeypatch) -> None:
    import mdqtplasmasims_torch.experiments.laser_cooling as lc
    monkeypatch.setattr(lc, "_use_internal_rng", lambda device, rolls: True)


def followed(f: dict) -> list:
    return [s.name for s in f["segments"]]
