"""Ion-QT-updates per second of a rank mesh's window, as ``updates_per_s``
counts them.  Its own metric: rank 0's host sample loop paces the
mesh, and its spread must not set the bound of the one-card rates."""

from harness.registry import reader

read = reader("updates_per_s")
