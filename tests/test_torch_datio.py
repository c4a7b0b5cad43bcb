"""The port's ``%g`` codec (``csrc/datio.c`` through
``io/datfiles.format_rows``) against the Python ``%g`` path.

The codec must write the same bytes as ``format_rows_py`` (the port's plain
version) and as the JAX package's ``format_rows`` on its Python path (the
one it takes without its optional C extension, whose printf writes
``-nan``; the comparison holds it there).  Inputs are the
kinds the writers hand in: float64, float32, int and bool arrays of rank
0-2, empty tables, Fortran-ordered and strided views, and the edge values
of ``%g`` (signed zeros, infinities, NaNs of either sign, denormals,
rounding ties, the switch to an exponent, 1e+-300).  The codec's short
path is also held to its own snprintf path on millions of values, and a
hypothesis test runs over float64 bit patterns.  Bars: byte equality.
"""

import ctypes
import os
from unittest import mock

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mdqtplasmasims_tpu.io import datfiles as jdat
from mdqtplasmasims_torch import _build
from mdqtplasmasims_torch.io import datfiles as tdat


def assert_same_bytes(arr):
    got = tdat.format_rows(arr)
    assert got == tdat.format_rows_py(arr)
    with mock.patch.object(jdat, "_native", None):
        assert got == jdat.format_rows(arr)


def _random(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "float64":
        return rng.normal(size=shape) * 10.0 ** rng.integers(-30, 30, shape)
    if kind == "float32":
        return (rng.normal(size=shape)
                * 10.0 ** rng.integers(-30, 30, shape)).astype(np.float32)
    if kind == "int":
        return rng.integers(-10 ** 9, 10 ** 9, shape)
    return rng.random(shape) < 0.5


@pytest.mark.parametrize("kind", ["float64", "float32", "int", "bool"])
@pytest.mark.parametrize("shape", [(), (7,), (5, 4), (0, 3), (3, 0), (0,)])
def test_random_arrays_match_python(kind, shape):
    assert_same_bytes(_random(kind, shape, sum(shape) + len(kind)))


@pytest.mark.parametrize("view", ["fortran", "strided", "transposed",
                                  "column", "negative_stride"])
def test_views_match_python(view):
    base = _random("float64", (9, 8), 4)
    arr = {"fortran": np.asfortranarray(base),
           "strided": base[::2, 1::3],
           "transposed": base.T,
           "column": base[:, 3],
           "negative_stride": base[::-1, ::-2]}[view]
    assert not arr.flags.c_contiguous or view == "column"
    assert_same_bytes(arr)


EDGES = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
         np.copysign(np.nan, -1.0), 5e-324, -5e-324, 2.2250738585072014e-308,
         1.5e-310, 1234565.0, 999999.5, 0.5, 2.5, 1e-05, 1e-04,
         9.99999e-05, 9.999995e-05, 0.0001, 0.00012345650000000001,
         123456.5, 999999.0, 1000000.0, 1e300, -1e300, 1e-300,
         1.7976931348623157e308,
         1e22, 1e23, 1e-17, 1e-18, 1e27, 1e28, 0.1, 1.0, -1.0, 3.0,
         100000.0, 99999.95, 0.30000000000000004, 123456789.0]


@pytest.mark.parametrize("value", EDGES, ids=lambda v: repr(v))
def test_edge_values_match_python(value):
    assert_same_bytes(np.array([[value, -value], [value, 1.0]]))


def test_named_results():
    rows = tdat.format_rows(np.array([1234565.0, 999999.5, 5e-324, -0.0,
                                      np.copysign(np.nan, -1.0), 1e-05,
                                      1e-04, -np.inf]))
    assert rows.split("\n")[:-1] == ["1.23456e+06", "1e+06", "4.94066e-324",
                                     "-0", "nan", "1e-05", "0.0001", "-inf"]


@settings(max_examples=400, deadline=None)
@given(st.lists(st.integers(0, 2 ** 64 - 1), min_size=1, max_size=24))
def test_bit_patterns_match_python(words):
    assert_same_bytes(np.array(words, np.uint64).view(np.float64).reshape(
        -1, 2 if len(words) % 2 == 0 else 1))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(allow_nan=True, allow_infinity=True),
                min_size=0, max_size=30))
def test_floats_match_python(values):
    assert_same_bytes(np.array(values, np.float64))


def _c_rows(fn, x):
    """One column of ``x`` through the library's ``fn`` (bytes)."""
    x = np.ascontiguousarray(x, np.float64).reshape(-1)
    out = np.empty(x.size * 14, np.uint8)
    f = getattr(_build.load("datio"), fn)
    f.restype = ctypes.c_size_t
    f.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
                  ctypes.c_void_p, ctypes.c_size_t]
    n = f(x.ctypes.data, x.size, 1, out.ctypes.data, out.size)
    return out[:n].tobytes()


def test_short_path_matches_snprintf_on_millions():
    """The short path (six digits from one correctly rounded scaling) and
    snprintf("%g") agree on random bit patterns, values across every
    exponent the short path takes, decimals with few digits and their
    neighbours one ulp away, and exact ties."""
    rng = np.random.default_rng(9)
    n = 400_000
    few = rng.integers(0, 10 ** 7, n) / 10.0 ** rng.integers(-10, 12, n)
    sets = [rng.integers(0, 2 ** 64, n, dtype=np.uint64).view(np.float64),
            rng.normal(size=n) * 10.0 ** rng.integers(-20, 30, n),
            few, np.nextafter(few, np.inf), np.nextafter(few, -np.inf),
            (rng.integers(0, 10 ** 7, n) + 0.5)
            * 10.0 ** rng.integers(-8, 8, n)]
    for x in sets:
        assert _c_rows("format_rows", x) == _c_rows("format_rows_printf", x)
    # and Python on a slice of each
    for x in sets:
        assert_same_bytes(x[:20_000])


@pytest.mark.parametrize("arr", [np.zeros((2, 2, 2)), np.ones(3) * 1j,
                                 np.zeros((2, 3), np.complex64)],
                         ids=["rank3", "complex128", "complex64"])
def test_rank3_and_complex_raise(arr):
    with pytest.raises(TypeError):
        tdat.format_rows(arr)


def test_second_build_reuses_library(monkeypatch):
    tdat.format_rows(np.ones(2))                  # built (or found) once
    path = _build.library_path("datio")
    mtime = os.path.getmtime(path)

    def no_compiler(*a, **k):
        raise AssertionError("the compiler ran again")
    monkeypatch.setattr(_build.subprocess, "run", no_compiler)
    lib = _build.load.__wrapped__("datio")        # past the lru cache
    assert lib.format_rows is not None
    assert os.path.getmtime(path) == mtime


def test_failed_build_raises_with_the_log(monkeypatch, tmp_path):
    """No quiet fallback to Python: a source that does not compile raises
    with the compiler's message, through ``format_rows`` too."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "datio.c").write_text("size_t format_rows(  /* broken */\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="failed for datio.c") as e:
        _build.load.__wrapped__("datio")
    assert "error" in str(e.value)
    _build.load.cache_clear()
    tdat._codec.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed for datio.c"):
            tdat.format_rows(np.ones(3))
    finally:
        monkeypatch.undo()
        _build.load.cache_clear()
        tdat._codec.cache_clear()
    assert tdat.format_rows(np.ones(1)) == "1\n"


def test_writer_tree_through_either_formatter(tmp_path):
    """``DatWriter`` with the codec and with the Python path write the
    same files byte for byte."""
    data = _random("float64", (40, 13), 2)
    for sub, fmt in (("c", tdat.format_rows), ("py", tdat.format_rows_py)):
        w = tdat.DatWriter(str(tmp_path / sub), fmt)
        w.write("a.dat", data)
        w.append("b.dat", data[:3])
        w.append("b.dat", data[3:5])
    for name in ("a.dat", "b.dat"):
        assert ((tmp_path / "c" / name).read_bytes()
                == (tmp_path / "py" / name).read_bytes())
