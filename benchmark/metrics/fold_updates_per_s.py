"""Ion-QT-updates per second of a fold's window, as ``updates_per_s``
counts them: every member's real ions.  Its own metric, because the
fold's host-paced sample loop spreads it wider than a single job's rate."""

from harness.registry import reader

read = reader("updates_per_s")
