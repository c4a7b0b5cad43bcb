"""``write_host_ms_per_sample`` of a job cell, whose rate is
``updates_per_s``."""

from harness.registry import reader

read = reader("write_host_ms_per_sample")
