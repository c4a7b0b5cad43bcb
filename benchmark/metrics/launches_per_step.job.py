"""``launches_per_step`` of a job cell, whose rate is ``updates_per_s``."""

from harness.registry import reader

read = reader("launches_per_step")
