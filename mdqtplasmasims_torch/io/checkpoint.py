"""Checkpoint / resume with the reference's ASCII state API plus a fast
native .npz format.

The port's own copy of ``mdqtplasmasims_tpu/io/checkpoint.py`` (the port
imports nothing of the JAX package), so both packages read and write the
same files.

Reference schema (laserCoolingPlusExpansionMDQTSpeedUp.cpp:725-916;
README.md:132-142):
  ions_timestep%06d.dat        N <tab> counter
  conditions_timestep%06d.dat  R[0] R[1] R[2] V[0] V[1] V[2]  (%lg, trailing tab)
  wvFns_timestep%06d.dat       Re/Im pairs for all S amplitudes per row
  VZERO_timestep%06d_interval%d.dat   VAF interval velocity snapshots
  spinUpIonsList_timestep%06d.dat     one 0/1 per row (tagging family)
On restore the simulation clock is reconstructed as
``t = (c0 - 9)*TIMESTEP + 0.02`` (line 789).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .datfiles import format_rows, read_rows


def restore_time(c0: int, timestep: float = 0.002) -> float:
    return (float(c0) - 9.0) * timestep + 0.02


# ---------------------------------------------------------------- ASCII ----

def write_ions(directory: str, c0: int, n: int, counter: int) -> None:
    with open(os.path.join(directory, f"ions_timestep{c0:06d}.dat"), "w") as f:
        f.write(f"{n}\t{counter}")


def read_ions(directory: str, c0: int):
    path = os.path.join(directory, f"ions_timestep{c0:06d}.dat")
    with open(path) as f:
        parts = f.read().split()
    try:
        n, counter = parts
        return int(n), int(counter)
    except ValueError as e:
        raise ValueError(
            f"{path}: expected two integers '<N> <counter>', found "
            f"{parts!r}") from e


def write_conditions(directory: str, c0: int, R: np.ndarray, V: np.ndarray) -> None:
    rows = np.concatenate([np.asarray(R), np.asarray(V)], axis=1)
    # reference row format has a trailing tab: "%lg\t...%lg\t\n" (line 747)
    text = "".join("\t".join("%g" % v for v in row) + "\t\n" for row in rows)
    with open(os.path.join(directory, f"conditions_timestep{c0:06d}.dat"), "w") as f:
        f.write(text)


def read_conditions(directory: str, c0: int, expect_n: Optional[int] = None):
    """``expect_n`` (the count from the paired ions_ file) catches the
    classic half-written-checkpoint defect: conditions_ rows disagreeing
    with ions_'s N."""
    path = os.path.join(directory, f"conditions_timestep{c0:06d}.dat")
    arr = read_rows(path, expect_cols=6)
    if expect_n is not None and arr.shape[0] != expect_n:
        raise ValueError(
            f"{path}: {arr.shape[0]} ion rows but the paired "
            f"ions_timestep{c0:06d}.dat declares N={expect_n} — "
            "truncated or mismatched checkpoint")
    return arr[:, :3], arr[:, 3:6]


def write_wvfns(directory: str, c0: int, psi: np.ndarray) -> None:
    psi = np.asarray(psi)
    flat = np.empty((psi.shape[0], 2 * psi.shape[1]))
    flat[:, 0::2] = psi.real
    flat[:, 1::2] = psi.imag
    text = "".join("".join("%g\t" % v for v in row) + "\n" for row in flat)
    with open(os.path.join(directory, f"wvFns_timestep{c0:06d}.dat"), "w") as f:
        f.write(text)


def read_wvfns(directory: str, c0: int,
               expect_n: Optional[int] = None) -> np.ndarray:
    path = os.path.join(directory, f"wvFns_timestep{c0:06d}.dat")
    arr = read_rows(path)
    if arr.shape[1] % 2:
        raise ValueError(
            f"{path}: odd column count {arr.shape[1]} — wavefunction "
            "rows must be Re/Im pairs")
    if expect_n is not None and arr.shape[0] != expect_n:
        raise ValueError(
            f"{path}: {arr.shape[0]} wavefunction rows for N="
            f"{expect_n} ions — truncated or mismatched checkpoint")
    return arr[:, 0::2] + 1j * arr[:, 1::2]


def write_vzero(directory: str, c0: int, vholder: np.ndarray,
                fmt=format_rows) -> None:
    """vholder: [n_intervals, N, 3] velocity snapshots (zeros when VAF
    intervals are disabled, matching the SpeedUp main where Zfunc is
    commented out); ``fmt`` formats the rows."""
    for k in range(vholder.shape[0]):
        path = os.path.join(directory, f"VZERO_timestep{c0:06d}_interval{k}.dat")
        with open(path, "w") as f:
            f.write(fmt(vholder[k]))


def read_vzero(directory: str, c0: int, n_intervals: int) -> np.ndarray:
    out = []
    for k in range(n_intervals):
        path = os.path.join(directory,
                            f"VZERO_timestep{c0:06d}_interval{k}.dat")
        try:
            out.append(read_rows(path, expect_cols=3))
        except FileNotFoundError as e:
            raise ValueError(
                f"{path}: missing VZERO snapshot for interval {k} "
                f"(checkpoint c0={c0} declares {n_intervals} intervals — "
                "VAF continuation cannot restore Vholder)") from e
    if len({a.shape[0] for a in out}) > 1:
        raise ValueError(
            f"VZERO_timestep{c0:06d}_interval*.dat in {directory}: "
            f"interval snapshots disagree on ion count "
            f"({[a.shape[0] for a in out]})")
    return np.stack(out)


def write_spinup_list(directory: str, c0: int, spin_up: np.ndarray) -> None:
    path = os.path.join(directory, f"spinUpIonsList_timestep{c0:06d}.dat")
    with open(path, "w") as f:
        f.write("".join(f"{int(s)}\n" for s in np.asarray(spin_up)))


def read_spinup_list(directory: str, c0: int) -> np.ndarray:
    path = os.path.join(directory, f"spinUpIonsList_timestep{c0:06d}.dat")
    try:
        arr = np.loadtxt(path, dtype=np.int64).reshape(-1)
    except FileNotFoundError:
        raise
    except Exception as e:
        raise ValueError(
            f"{path}: unreadable spin-up list (want one 0/1 per row): "
            f"{e}") from e
    if arr.size and not np.isin(arr, (0, 1)).all():
        raise ValueError(
            f"{path}: spin-up list contains values other than 0/1 — "
            "corrupted tagging checkpoint")
    return arr


# --------------------------------------------------------------- native ----

def save_native(directory: str, c0: int, *, R, V, psi=None, counter=0,
                vholder=None, spin_up=None, extra: Optional[dict] = None) -> str:
    """Single-file .npz checkpoint (fast path alongside the ASCII schema)."""
    path = os.path.join(directory, f"checkpoint_{c0:06d}.npz")
    payload = dict(R=np.asarray(R), V=np.asarray(V), c0=np.int64(c0),
                   counter=np.int64(counter))
    if psi is not None:
        payload["psi"] = np.asarray(psi)
    if vholder is not None:
        payload["vholder"] = np.asarray(vholder)
    if spin_up is not None:
        payload["spin_up"] = np.asarray(spin_up)
    for k, v in (extra or {}).items():
        payload[k] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)       # atomic publish
    return path


def load_native(directory: str, c0: int) -> dict:
    path = os.path.join(directory, f"checkpoint_{c0:06d}.npz")
    try:
        with np.load(path) as z:
            out = {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise
    except Exception as e:
        # zipfile.BadZipFile / EOFError / pickle errors from a corrupt
        # or half-written archive — name the file and the defect instead
        # of surfacing numpy's opaque traceback.  (Half-written files
        # should not exist at all: save_native publishes atomically via
        # os.replace — a corrupt archive means external damage.)
        raise ValueError(
            f"{path}: corrupt or truncated native checkpoint ({e}); "
            "delete it to fall back to the newest intact ASCII/native "
            "checkpoint") from e
    for k in ("R", "V"):
        if k not in out:
            raise ValueError(
                f"{path}: native checkpoint missing required array "
                f"'{k}' (found {sorted(out)})")
    if out["R"].shape != out["V"].shape:
        raise ValueError(
            f"{path}: R shape {out['R'].shape} != V shape "
            f"{out['V'].shape} — corrupt native checkpoint")
    return out


def latest_ascii_checkpoint(directory: str) -> Optional[int]:
    """Highest c0 among the ASCII ``ions_timestep*.dat`` checkpoints —
    the schema a reference binary advances when it continues a framework
    run (interop chaining), so resume paths compare it against the
    newest native .npz and take whichever is later."""
    import glob
    import re
    cs = [int(m.group(1))
          for p in glob.glob(os.path.join(directory, "ions_timestep*.dat"))
          if (m := re.search(r"ions_timestep(\d+)\.dat$", p))]
    return max(cs) if cs else None


def save_pipeline_checkpoint(directory: str, seq: int, family: str,
                             payload: dict) -> str:
    """Atomic-publish a staged-pipeline crash checkpoint and prune older
    ones (newest-only: the pipeline families replay forward from one
    snapshot, so keeping history would only grow the job directory).

    The staged experiment families (transport, MC->QT tagging) have no
    reference checkpoint format to interop with — the reference's
    ``writeConditions`` appears only in the cooling and frozen-tag
    programs (grep over the reference C++ code) and a crash there loses the
    whole multi-hour job.  This native-only format is the framework's
    beyond-parity L7 coverage for them.  ``payload`` values must be host
    arrays/scalars; ``family`` guards against resuming a directory with
    the wrong experiment."""
    import glob
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"pipeline_checkpoint_{seq:06d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, family=np.str_(family), seq=np.int64(seq), **payload)
    os.replace(tmp, path)       # atomic publish
    for p in glob.glob(os.path.join(directory, "pipeline_checkpoint_*.npz")):
        if p != path:
            try:
                os.remove(p)
            except OSError:
                pass            # concurrent cleanup — the publish stands
    return path


def load_pipeline_checkpoint(directory: str, family: str) -> Optional[dict]:
    """Newest staged-pipeline checkpoint in ``directory`` or None.
    Raises with a diagnostic when the newest file is corrupt or belongs
    to a different experiment family."""
    import glob
    import re
    best, best_seq = None, -1
    for p in glob.glob(os.path.join(directory, "pipeline_checkpoint_*.npz")):
        if (m := re.search(r"pipeline_checkpoint_(\d+)\.npz$", p)):
            if int(m.group(1)) > best_seq:
                best, best_seq = p, int(m.group(1))
    if best is None:
        return None
    try:
        with np.load(best) as z:
            out = {k: z[k] for k in z.files}
    except Exception as e:
        raise ValueError(
            f"{best}: corrupt or truncated pipeline checkpoint ({e}); "
            "delete it to restart the run from scratch") from e
    got = str(out.get("family", ""))
    if got != family:
        raise ValueError(
            f"{best}: checkpoint belongs to the '{got}' pipeline, not "
            f"'{family}' — wrong save_directory?")
    return out


def latest_native_checkpoint(directory: str) -> Optional[int]:
    """Highest c0 among the native ``checkpoint_*.npz`` files (the
    counterpart of :func:`latest_ascii_checkpoint` for newest-wins
    cross-format discovery)."""
    import glob
    import re
    cs = [int(m.group(1))
          for p in glob.glob(os.path.join(directory, "checkpoint_*.npz"))
          if (m := re.search(r"checkpoint_(\d+)\.npz$", p))]
    return max(cs) if cs else None
