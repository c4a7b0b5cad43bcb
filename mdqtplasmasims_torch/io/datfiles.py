"""Reference-compatible .dat file emission.

Every observable in the reference is appended to tab-separated ASCII files
with ``%lg`` (= ``%g``, 6 significant digits) formatting; schema documented
in README.md:103-142 of the reference.

The port's own copy of ``mdqtplasmasims_tpu/io/datfiles.py`` with a codec
of its own: ``format_rows`` formats through ``csrc/datio.c``, built at
first use with the host C compiler (``_build.load("datio")``; a failed
build raises with the compiler's log).  ``format_rows_py``, the Python
``%g`` loop, is its plain version and writes the same bytes.

``read_rows`` stays on ``np.loadtxt``.  The JAX package's codec also
parses (``parse_floats``), but it skips every byte that does not start a
number, so a table with a stray word in it would read as numbers; here
such a file raises.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

# "%g" writes at most 13 characters ("-1.23457e+308"), plus one separator
_FIELD = 14


def _table(arr) -> np.ndarray:
    """``arr`` as the C-contiguous float64 table the writer formats: rank 0
    is one row of one column, rank 1 one column."""
    arr = np.asarray(arr)
    if arr.ndim > 2 or np.iscomplexobj(arr):
        raise TypeError("format_rows expects a real array of rank <= 2, got "
                        f"{arr.dtype} of rank {arr.ndim}")
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    return arr.reshape(-1, 1) if arr.ndim < 2 else arr


@functools.lru_cache(maxsize=None)
def _codec():
    from .. import _build
    fn = _build.load("datio").format_rows
    fn.restype = ctypes.c_size_t
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
                   ctypes.c_void_p, ctypes.c_size_t]
    return fn


def format_rows(arr: np.ndarray) -> str:
    """Tab-separated %g rows, one trailing newline per row (the codec)."""
    table = _table(arr)
    nrow, ncol = table.shape
    out = np.empty(nrow * max(ncol, 1) * _FIELD, np.uint8)
    n = _codec()(table.ctypes.data, nrow, ncol, out.ctypes.data, out.size)
    if n == ctypes.c_size_t(-1).value:
        raise RuntimeError("datio.format_rows overran its buffer")
    return out[:n].tobytes().decode("ascii")


def format_rows_py(arr: np.ndarray) -> str:
    """The plain version of :func:`format_rows`: Python's ``"%g" % v``."""
    arr = np.atleast_1d(np.asarray(arr))
    if arr.ndim == 1:
        arr = arr[:, None]
    return "".join("\t".join("%g" % v for v in row) + "\n" for row in arr)


def append_rows(path: str, arr: np.ndarray, fmt=format_rows) -> None:
    with open(path, "a") as f:
        f.write(fmt(arr))


def write_rows(path: str, arr: np.ndarray, fmt=format_rows) -> None:
    with open(path, "w") as f:
        f.write(fmt(arr))


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
    """Output-file manager bound to one run directory; ``fmt`` formats
    the rows (:func:`format_rows`, or :func:`format_rows_py`)."""

    def __init__(self, directory: str, fmt=format_rows):
        self.dir = directory
        self.fmt = fmt
        os.makedirs(directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def append(self, name: str, arr) -> None:
        append_rows(self.path(name), np.asarray(arr), self.fmt)

    def write(self, name: str, arr) -> None:
        write_rows(self.path(name), np.asarray(arr), self.fmt)

    def write_text(self, name: str, text: str) -> None:
        with open(self.path(name), "w") as f:
            f.write(text)
