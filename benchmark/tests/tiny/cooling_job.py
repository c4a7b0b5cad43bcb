"""The cooling job's tiny form: the fold's (``tiny/cooling_fold.py``); a
job at this size runs its 6 segments in 3 groups."""

from tiny.cooling_fold import patch, tiny_config, tiny_workload

__all__ = ["SOUND", "followed", "patch", "tiny_config", "tiny_workload"]

SOUND = dict(groups=3, md_steps=24, followed=["start", "stage", "mid"],
             checks=dict(tick_gap=0))


def followed(f: dict) -> list:
    return [s.name for segs, _ in f["parts"] for s in segs]
