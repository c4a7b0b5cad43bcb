"""Reference-compatible .dat file emission.

Every observable in the reference is appended to tab-separated ASCII files
with ``%lg`` (= ``%g``, 6 significant digits) formatting; schema documented
in README.md:103-142 of the reference.

The port's own copy of ``mdqtplasmasims_tpu/io/datfiles.py`` without its
optional C codec (that extension belongs to the JAX package): the
pure-Python ``%g`` path, which writes the same bytes.
"""

from __future__ import annotations

import os

import numpy as np


def format_rows(arr: np.ndarray) -> str:
    """Tab-separated %g rows, one trailing newline per row."""
    arr = np.atleast_1d(np.asarray(arr))
    if arr.ndim == 1:
        arr = arr[:, None]
    return "".join("\t".join("%g" % v for v in row) + "\n" for row in arr)


def append_rows(path: str, arr: np.ndarray) -> None:
    with open(path, "a") as f:
        f.write(format_rows(arr))


def write_rows(path: str, arr: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(format_rows(arr))


def read_rows(path: str, expect_cols: int | None = None) -> np.ndarray:
    """Whitespace-separated float table (fscanf-compatible).

    Unlike the reference's ``fscanf`` loops — which silently misparse a
    truncated or column-mangled file — every defect raises a
    ``ValueError`` naming the file and the problem (SURVEY §5's
    failure-detection gap).  ``expect_cols`` additionally pins the
    column count (checkpoint schemas have fixed widths)."""
    try:
        arr = np.loadtxt(path, ndmin=2)
    except FileNotFoundError:
        raise
    except Exception as e:
        raise ValueError(f"{path}: unreadable float table ({e})") from e
    if arr.size == 0:
        raise ValueError(f"{path}: empty or non-numeric table")
    if expect_cols is not None and arr.shape[1] != expect_cols:
        raise ValueError(
            f"{path}: expected {expect_cols} columns, found "
            f"{arr.shape[1]} — wrong schema or corrupted rows")
    return arr


class DatWriter:
    """Output-file manager bound to one run directory."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def append(self, name: str, arr) -> None:
        append_rows(self.path(name), np.asarray(arr))

    def write(self, name: str, arr) -> None:
        write_rows(self.path(name), np.asarray(arr))

    def write_text(self, name: str, text: str) -> None:
        with open(self.path(name), "w") as f:
            f.write(text)
