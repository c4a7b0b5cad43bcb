"""Build and load the hand-written native code of ``csrc/``.

Each ``csrc/<name>.cu`` (a CUDA kernel library) or ``csrc/<name>.c`` (the
host's ``.dat`` codec) has a plain C interface.  On first use it is
compiled, ``.cu`` with ``nvcc`` for ``sm_90a`` and ``.c`` with the host C
compiler (``cc``, or ``$CC``), into a shared library under ``_build/``
(listed in .gitignore), keyed on a hash of the source and the flags,
published atomically and loaded with ``ctypes``.  A fresh checkout
therefore builds everything it runs from its own sources.  The build log
(for nvcc ``-Xptxas -v``: registers, shared memory and spills per kernel)
sits beside the library.

Nothing here runs at import time; the CPU tests import the wrappers but
never reach a build.
"""

from __future__ import annotations

import contextlib
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
CC_FLAGS = ("-O2", "-shared", "-fPIC")

#: seconds spent in the compiler by this process, per library (for
#: chip_smoke.py)
build_seconds: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _cc() -> str:
    for cand in (os.environ.get("CC"), shutil.which("cc"),
                 shutil.which("gcc")):
        if cand:
            return cand
    raise RuntimeError("no host C compiler found: install cc or set CC")


def _source(name: str) -> str:
    """``csrc/<name>.cu`` or ``csrc/<name>.c``, whichever exists."""
    for ext in (".cu", ".c"):
        src = os.path.join(CSRC, name + ext)
        if os.path.exists(src):
            return src
    raise FileNotFoundError(f"no {name}.cu or {name}.c in {CSRC}")


def _flags(src: str) -> tuple:
    return NVCC_FLAGS if src.endswith(".cu") else CC_FLAGS


def library_path(name: str) -> str:
    src = _source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(src)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` or ``.c``; raises
    with the compiler's log on failure."""
    src, path = _source(name), library_path(name)
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        compiler = _nvcc() if src.endswith(".cu") else _cc()
        cmd = [compiler, *_flags(src), "-o", tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        with open(path[:-3] + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed for "
                               f"{os.path.basename(src)}:\n{log}")
        os.replace(tmp, path)      # atomic publish: concurrent builds
    return ctypes.CDLL(path)


def build_log(name: str) -> str:
    """The compiler output of the library ``load(name)`` uses ('' if it was
    built by another process that kept no log)."""
    log = library_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


_SAME_DEVICE = contextlib.nullcontext()


def device_guard(device):
    """Context in which ``device`` (a CUDA ``torch.device``) is the current
    one, as a launch on its stream needs; nothing to enter when it already
    is (``torch.cuda.device`` costs the host some 20 us a launch)."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(device)


def raw_stream(device) -> int:
    """The handle of ``device``'s current stream, for a launcher's stream
    argument (the Stream object ``torch.cuda.current_stream`` builds costs
    the host some 25 us a launch)."""
    import torch
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return (get(index) if get is not None
            else torch.cuda.current_stream(index).cuda_stream)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher of ``lib``
    (every csrc library exports ``mdqt_error_string``)."""
    if err != 0:
        lib.mdqt_error_string.restype = ctypes.c_char_p
        lib.mdqt_error_string.argtypes = [ctypes.c_int]
        msg = lib.mdqt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
