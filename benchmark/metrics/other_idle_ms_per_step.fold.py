"""``other_idle_ms_per_step`` of a fold cell, whose rate is
``fold_updates_per_s``."""

from harness.registry import reader

read = reader("other_idle_ms_per_step")
