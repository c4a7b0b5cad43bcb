"""``pair_roofline`` of a job cell, whose rate is ``updates_per_s``."""

from harness.registry import reader

read = reader("pair_roofline")
