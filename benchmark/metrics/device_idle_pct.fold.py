"""``device_idle_pct`` of a fold cell, whose rate is ``fold_updates_per_s``."""

from harness.registry import reader

read = reader("device_idle_pct")
