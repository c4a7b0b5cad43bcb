"""``step_host_ms_per_step`` of a job cell, whose rate is ``updates_per_s``."""

from harness.registry import reader

read = reader("step_host_ms_per_step")
