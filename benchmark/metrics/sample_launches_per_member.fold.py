"""``sample_launches_per_member`` of a fold cell, whose rate is
``fold_updates_per_s``."""

from harness.registry import reader

read = reader("sample_launches_per_member")
