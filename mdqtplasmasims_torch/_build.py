"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface.  On first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``_build/`` (listed in .gitignore), keyed on a hash of the source and the
flags, and loaded with ``ctypes``.  A fresh checkout therefore builds
everything it runs from its own sources.  The build log (``-Xptxas -v``:
registers, shared memory and spills per kernel) sits beside the library.

Nothing here runs at import time; the CPU tests import the wrappers but
never reach a build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# IEEE f32 throughout: no --use_fast_math (the kernels are held to the
# plain torch versions at 2e-5..5e-5, which fast exp/sin/div would break)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: seconds spent in nvcc by this process, per library (for chip_smoke.py)
build_seconds: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure."""
    path = library_path(name)
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        with open(path[:-3] + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, path)      # atomic publish: concurrent builds
    return ctypes.CDLL(path)


def build_log(name: str) -> str:
    """The nvcc output of the library ``load(name)`` uses ('' if it was
    built by another process that kept no log)."""
    log = library_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher of ``lib``
    (every csrc library exports ``mdqt_error_string``)."""
    if err != 0:
        lib.mdqt_error_string.restype = ctypes.c_char_p
        lib.mdqt_error_string.argtypes = [ctypes.c_int]
        msg = lib.mdqt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
