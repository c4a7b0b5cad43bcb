"""``device_idle_pct`` of a job cell, whose rate is ``updates_per_s``."""

from harness.registry import reader

read = reader("device_idle_pct")
