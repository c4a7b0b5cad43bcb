#!/usr/bin/env python3
"""The validation matrix against the C++ programs, on the PyTorch + CUDA
port: the port's counterpart of ``tools/validate_all.py``, with the
``tools/cross_validate_*.py`` steps folded in.

    python tools/torch_validate_all.py [--only STEP[,STEP..]] [--list]
                                       [--out DIR] [--device cuda|cpu]

The reference side is read, not run.  The JAX runner's archived logs
(``artifacts/validate_all/logs/<step>.log``) hold the C++ programs' pooled
statistics as numbers: the ``observable  ref (mean+-sd)  framework  z``
tables, the ``<label>: ref X vs mine|fw Y`` lines and the ``final S/P/D:
ref [...]`` lines.  :func:`parse_step` reads them, with the JAX side's
logged numbers beside them, and the reference's pool size k from the JAX
report's ``argv`` / ``env`` (``artifacts/validate_all/report.json``).

The port side runs each step at the JAX tool's own configuration, k and
seeds (a fold of k members, seed 0, is jobs 1..k; transport pooled seed
7), through the port's ``run_ensemble`` (one ``run`` for the one-job
curve), and pools the same per-job statistics (this file's copies of the
JAX tools' functions) to the same gates:

==================  =====================================================
frozen_pooled_*     every \\|z\\| < 3, pooled tag fraction within 20 %
dih_pooled          every scalar \\|z\\| < 3
expansion           final S/P/D within 0.05, late <vx> drift within
                    50 % or 0.02
flagship            final S/P/D within 0.08
mc_tag_*            tagged <vx^2> within 30 %, tag fraction within
                    max(0.02, 30 %), temperature within 10 %; 408quad:
                    selectivity > 1.1
transport_pooled    at most 2 of 28 raw \\|z\\| >= 2, each \\|z\\| < 3.02
                    (no ANCOVA credit: the log lacks the reference's
                    per-job data)
transport_curve     g(r) peak within 20 %, hole edge within 2 bins, T
                    within 25 %
==================  =====================================================

z = (m_ref - m_fw) / sqrt(s_ref^2/k + s_fw^2/k), the JAX tools' formula
from the two pools' means and sample standard deviations.  Checks that
need the reference's curves or binaries (per-sample curve z, the VAF and
energy curve differences, ``three_state``, the two resume interops) are
recorded with ``"gated": false`` and their reason; ``analysis_physics``
is ``tools/torch_validate_analysis.py``'s section E.

On the card the runs are float32 (the kernels are float32; float64 on
CUDA raises); the JAX tools ran XLA float64 on the CPU.  Writes
``report.json`` and ``MATRIX.md`` into ``--out`` (``--only`` keeps the
other steps of a report already there); exit 0 when every gated step
passes, 1 otherwise, 2 without a card unless ``--device cpu`` (float64
twins, for the tests; ``--tiny`` cuts every step for a quick run).
Imports torch, numpy and ``mdqtplasmasims_torch`` (and
``tools/torch_soak.py``'s build, metadata and launch counters,
``tools/torch_validate_analysis.py``'s ``summary_z``) only.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import sys
import time

import numpy as np
import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import torch_soak  # noqa: E402  (puts the repository root on sys.path)
from torch_validate_analysis import summary_z as pool_z  # noqa: E402

REPO = torch_soak.ROOT
ARCHIVE = os.path.join(REPO, "artifacts", "validate_all")
LOGS = os.path.join(ARCHIVE, "logs")
OUT = os.path.join(REPO, "artifacts", "validate_all_torch")
ANALYSIS_REPORT = os.path.join(REPO, "artifacts", "validate_analysis_torch",
                               "report.json")

# ---- the JAX tools' configurations

# cross_validate_frozen_pooled.py:39
FROZEN = dict(n0=600, tstart=1.0, tmax=2.0, sample_freq=10)
# cross_validate_dih_pooled.py:41; cross_validate_expansion.py:37
DIH = dict(n0=600, tmax=6.0, sample_freq=20)
EXPANSION = dict(DIH, frac_of_sig=1.0)
# validate_all.py:95-110 (jobs 1-3) read by cross_validate_flagship.py:59
FLAGSHIP = dict(n0=256, tmax=2.0, sample_freq=10)
# cross_validate_mc_tag.py:65-67
MC_TAG = dict(n=216, mc_steps=20000, pre_record_md_steps=100,
              record_steps=300)
# cross_validate_transport_pooled.py:69-81, 283-293
TRANSPORT = dict(n=512, kappa=0.5, gamma=3.0, density=0.4, mc_steps=30000,
                 gr_every_mc=10000, pre_record_md_steps=200,
                 record_steps=600, gr_every_record=100,
                 instant_aniso_steps=400, reequil_steps=200,
                 aniso_time_us=4.0, aniso_relax_steps=400, timestep=0.005)
TRANSPORT_SEED = 7
# cross_validate_transport.py:43
TRANSPORT_CURVE = dict(n=512, kappa=0.5, gamma=3.0, density=0.4,
                       mc_steps=30000, gr_every_mc=10000,
                       pre_record_md_steps=200, record_steps=600,
                       gr_every_record=100, instant_aniso_steps=200,
                       reequil_steps=100, aniso_relax_steps=100)

VAF_LAGS = (20, 60, 120, 240)          # cross_validate_transport_pooled.py
POW_LAGS = (20, 60, 120)
THERMAL = 1.0 / 3.0                    # 1/Gamma at Gamma = 3

# --tiny: every step cut for a quick run on the CPU (k = 2)
TINY_JOBS = 2
_TINY_COOL = dict(n0=16, tmax=0.04, sample_freq=4)
_TINY_MC = dict(n=27, mc_steps=200, mc_chunk_steps=100,
                pre_record_md_steps=5, record_steps=20, gr_every_record=10,
                tpump_seconds=2e-8)
_TINY_TRANSPORT = dict(n=27, mc_steps=200, gr_every_mc=100,
                       pre_record_md_steps=5, record_steps=250,
                       gr_every_record=50, instant_aniso_steps=120,
                       reequil_steps=5, aniso_time_us=0.1,
                       aniso_relax_steps=120)
TINY = {
    "frozen_pooled_422": dict(n0=16, tstart=0.02, tmax=0.1, sample_freq=4,
                              tpump_seconds=5e-8),
    "frozen_pooled_408": dict(n0=16, tstart=0.02, tmax=0.1, sample_freq=4,
                              tpump_seconds=5e-8),
    "dih_pooled": dict(_TINY_COOL, tmax=3.2, timestep=0.1, sample_freq=1),
    "expansion": _TINY_COOL,
    "flagship": _TINY_COOL,
    "mc_tag_408quad": _TINY_MC,
    "mc_tag_408linear": _TINY_MC,
    "transport_pooled": _TINY_TRANSPORT,
    "transport_curve": dict(_TINY_TRANSPORT, record_steps=100),
}

# ---- the reference side: the JAX runner's archive

_TABLE = re.compile(r"^\s*(\S+)\s+([-+][\d.]+) \+- ([\d.]+)\s+"
                    r"([-+][\d.]+) \+- ([\d.]+)\s+([-+][\d.]+)\s*$")
_NUM = r"[-+]?\d+(?:\.\d+)?"
_VS = re.compile(rf"^\s*([^:]+?):\s+ref\s+(\[[^\]]*\]|{_NUM})\s+vs\s+"
                 rf"(?:mine|fw)\s+(\[[^\]]*\]|{_NUM})")
_JOBS_LINE = re.compile(r"running (\d+) reference jobs")

# the reference's pool size where the JAX report's argv/env does not
# state it: validate_all.py's preps (flagship jobs 1-3, 408quad 8 jobs),
# cross_validate_mc_tag408linear.py's njobs default, one job for the curve
DEFAULT_K = {"flagship": 3, "mc_tag_408quad": 8, "mc_tag_408linear": 8,
             "transport_curve": 1}


def _value(s: str):
    if s.startswith("["):
        return [float(x) for x in s[1:-1].split()]
    return float(s)


def parse_log(text: str) -> dict:
    """The numbers of one archived log: ``table`` (per observable the
    reference's and the JAX side's mean and sd and the logged z), ``vs``
    (per label the reference's and the JAX side's value) and ``lines``
    (every non-empty line, for the checks recorded without a gate)."""
    table, vs = {}, {}
    for line in text.splitlines():
        m = _TABLE.match(line)
        if m:
            table[m.group(1)] = dict(
                ref_mean=float(m.group(2)), ref_sd=float(m.group(3)),
                jax_mean=float(m.group(4)), jax_sd=float(m.group(5)),
                jax_z=float(m.group(6)))
            continue
        m = _VS.match(line)
        if m:
            vs[m.group(1).strip()] = dict(ref=_value(m.group(2)),
                                          jax=_value(m.group(3)))
    return dict(table=table, vs=vs,
                lines=[ln.strip() for ln in text.splitlines() if ln.strip()])


def jax_report() -> dict:
    with open(os.path.join(ARCHIVE, "report.json")) as f:
        return {r["name"]: r for r in json.load(f)["steps"]}


def reference_k(name: str, entry: dict) -> tuple:
    """``(k, source)``: the reference's pool size from the JAX report's
    entry (``env`` XVAL_JOBS, pooled transport's ``argv``), else the
    JAX runner's own default (:data:`DEFAULT_K`)."""
    env = entry.get("env") or {}
    if "XVAL_JOBS" in env:
        return int(env["XVAL_JOBS"]), "report.json env XVAL_JOBS"
    argv = entry.get("argv") or []
    if name == "transport_pooled" and len(argv) > 1:
        return int(argv[1]), "report.json argv[1]"
    return DEFAULT_K[name], "the JAX runner's default (validate_all.py)"


def parse_step(name: str) -> dict:
    """The archived reference of step ``name``: the parsed log, k and
    where each came from."""
    path = os.path.join(LOGS, f"{name}.log")
    with open(path) as f:
        text = f.read()
    parsed = parse_log(text)
    k, k_source = reference_k(name, jax_report()[name])
    logged = _JOBS_LINE.search(text)
    return dict(log=os.path.relpath(path, REPO), k=k, k_source=k_source,
                k_logged=int(logged.group(1)) if logged else None,
                table=parsed["table"], vs=parsed["vs"])


def log_lines(name: str, prefix: str) -> list:
    """The archived log's lines of step ``name`` that start with
    ``prefix`` (the JAX side's numbers of an ungated check)."""
    with open(os.path.join(LOGS, f"{name}.log")) as f:
        return [ln.strip() for ln in f if ln.strip().startswith(prefix)]


# ---- the pool comparison

# the logs print means and sds to 4 decimals: half a unit of the last place
LOG_HALF_UNIT = 5e-5


def z_range(m_ref: float, s_ref: float, k_ref: int, m_fw: float, s_fw: float,
            k_fw: int, ref_half: float = LOG_HALF_UNIT,
            fw_half: float = 0.0) -> tuple:
    """The least and the largest :func:`pool_z` over every pool whose
    printed numbers round to these: each mean and sd moved by up to
    ``ref_half`` (the reference's) or ``fw_half`` (the other side's)."""
    zs = [pool_z(m_ref + a, max(s_ref + b, 0.0), k_ref, m_fw + c,
                 max(s_fw + d, 0.0), k_fw)
          for a in (-ref_half, ref_half) for b in (-ref_half, ref_half)
          for c in (-fw_half, fw_half) for d in (-fw_half, fw_half)]
    return min(zs), max(zs)


def pool(jobs: list, keys) -> dict:
    """Per key the port's pool: mean, sample sd and k over ``jobs``."""
    out = {}
    for key in keys:
        x = np.array([j[key] for j in jobs], np.float64)
        out[key] = dict(mean=float(x.mean()),
                        sd=float(x.std(ddof=1)) if len(x) > 1 else 0.0,
                        k=len(x))
    return out


OPS = {"abs_lt": lambda v, lim: abs(v) < lim,
       "lt": lambda v, lim: v < lim,
       "le": lambda v, lim: v <= lim,
       "gt": lambda v, lim: v > lim}


def gate(name: str, value: float, op: str, limit: float, source: str
         ) -> dict:
    """One gate with its verdict (``OPS[op](value, limit)``)."""
    return dict(name=name, value=float(value), op=op, limit=float(limit),
                ok=bool(OPS[op](float(value), float(limit))), source=source,
                gated=True)


def ungated(name: str, reason: str, jax_logged=None) -> dict:
    return dict(name=name, gated=False, reason=reason,
                jax_logged=jax_logged or [])


def z_gates(ref: dict, port: dict, keys, limit: float, source: str) -> list:
    """Per observable the z of the reference's pool against the port's,
    each gated at ``|z| < limit``, with the range z spans over the
    rounding of the reference's printed mean and sd (``z_rounding``)."""
    out = []
    for key in keys:
        r, p = ref["table"][key], port[key]
        args = (r["ref_mean"], r["ref_sd"], ref["k"], p["mean"], p["sd"],
                p["k"])
        out.append(dict(gate(f"z {key}", pool_z(*args), "abs_lt", limit,
                             source),
                        observable=key, z_rounding=list(z_range(*args))))
    return out


# ---- the JAX tools' per-job statistics (the port's copies)

def frozen_job_stats(variant: str, res: dict) -> dict:
    """cross_validate_frozen_pooled.py:75-94 on one job's results: the tag
    fraction, tagged <vx> and <vx^2> at the first row and the last, and the
    tau = 0 VAF.  Row 0 of the reference's taggedMoments.dat is the tag
    instant for the 408 variants but the first post-tag sample for
    422linear."""
    tag, outs = res["out_tag"], res["outs"]
    m_first = (tag["moments"] if variant != "422linear"
               else outs["moments"][0])
    return dict(frac=float(np.asarray(res["spin_up"]).mean()),
                m1_tag=float(m_first[0]), m2_tag=float(m_first[1]),
                m1_end=float(outs["moments"][-1][0]),
                m2_end=float(outs["moments"][-1][1]),
                vaf0=float(tag["vaf"]))


FROZEN_KEYS = ("frac", "m1_tag", "m2_tag", "m1_end", "m2_end", "vaf0")


def scalars(t: np.ndarray, ekx: np.ndarray) -> dict:
    """cross_validate_dih_pooled.py:70: per-job DIH curve scalars from one
    EkinX(t) trace."""
    pk = int(np.argmax(ekx[t <= 2.0]))
    peak = float(ekx[pk])
    lo = ekx[(t > t[pk]) & (t <= t[pk] + 1.5)].min()
    return dict(peak_ekx=peak, t_peak=float(t[pk]),
                dip_ratio=float(lo / peak),
                gamma_dih=float(1.0 / (2.0 * ekx[(t > 3.0)].mean())))


DIH_KEYS = ("peak_ekx", "t_peak", "dip_ratio", "gamma_dih")


def spd_of_psi(psi) -> np.ndarray:
    """cross_validate_expansion.py:139-142: the ion-mean S, P and D
    populations of one job's final wavefunctions ``[N, 12]``."""
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        D_MANIFOLD, P_MANIFOLD, S_MANIFOLD)
    pop = np.abs(np.asarray(psi)) ** 2
    return np.array([pop[:, list(S_MANIFOLD)].sum(-1).mean(),
                     pop[:, list(P_MANIFOLD)].sum(-1).mean(),
                     pop[:, list(D_MANIFOLD)].sum(-1).mean()])


def late_drift(vx_rows) -> float:
    """cross_validate_expansion.py:169-172: the late-time <vx> of the
    pooled (job-mean) ``<vx>(t)`` rows: the mean over the last third."""
    vx = np.mean(np.asarray(vx_rows, np.float64), axis=0)
    n = vx.shape[0]
    return float(vx[slice(max(0, n - n // 3), n)].mean())


def flagship_spd(pops: np.ndarray) -> np.ndarray:
    """cross_validate_flagship.py:80: one job's ion-mean S/P/D at its last
    sample from its per-sample populations ``[samples, N, 3]``."""
    return np.asarray(pops[-1].mean(0), np.float64)


def mc_tag_job_stats(res: dict) -> dict:
    """cross_validate_mc_tag.py:69-71: the tagged <vx^2> at the start of
    the recording, the tag fraction, the mean temperature and the
    normalized VAF of one job."""
    vaf = np.asarray(res["vaf"], np.float64)
    return dict(vx2=float(res["moments"][0, 1]),
                frac=float(np.asarray(res["tags"]).mean()),
                temp=float(np.asarray(res["temps"]).mean()),
                vaf=vaf / vaf[0])


def _aniso(rows: np.ndarray) -> np.ndarray:
    """A(t) = <vx^2> - (<vy^2>+<vz^2>)/2 from rows that end in vx2, vy2,
    vz2 (a t/vx2/vy2/vz2 table, or per-axis records ``[..., 3]``)."""
    return rows[..., -3] - 0.5 * (rows[..., -2] + rows[..., -1])


def _hole_edge(g: np.ndarray) -> float:
    """Correlation-hole edge in bin units: linear interpolation of the
    first upward g = 0.5 crossing."""
    i = int(np.argmax(g > 0.5))
    if i == 0:
        return 0.0
    g0, g1 = g[i - 1], g[i]
    return float(i - 1 + (0.5 - g0) / max(g1 - g0, 1e-12))


def fw_job_stats(res: dict, record_steps: int = TRANSPORT["record_steps"]
                 ) -> dict:
    """cross_validate_transport_pooled.py:217-253 on one job's results
    (the JAX package's keys): the recording temperature, the normalized
    autocorrelations at the lag grid, g(r)'s peak and hole edge, the four
    tag powers' late moments (and tag-instant m2), the three anisotropy
    stages' A."""
    s = {}
    s["t_mean"] = float(np.asarray(res["temps"]).mean())
    for key, out, lags in (("vaf", "vaf", VAF_LAGS),
                           ("v2", "long_visc", POW_LAGS),
                           ("v3", "v_cube", POW_LAGS),
                           ("v4", "v_fourth", POW_LAGS)):
        c = np.asarray(res[out])
        for lag in lags:
            s[f"{key}[{lag}]"] = float(c[lag] / c[0])
    g = np.asarray(res["gr_record"][-1])
    s["gr_peak"] = float(g.max())
    s["gr_hole"] = _hole_edge(g)
    m = np.asarray(res["moments"])           # [steps, 4 tags, 4 moments]
    late = m[-record_steps // 4:]
    for p in range(1, 5):
        s[f"tag{p}_m1"] = float(late[:, p - 1, 0].mean())
        s[f"tag{p}_m2"] = float(late[:, p - 1, 1].mean())
        s[f"tag{p}_m2_0"] = float(m[0, p - 1, 1])
    a = _aniso(np.asarray(res["temps_inst"]))       # [steps, 3] records
    s["inst_A_early"] = float(a[:50].mean())
    s["inst_A_late"] = float(a[-100:].mean())
    s["inst_A0"] = float(a[0])
    s["force_A_end"] = float(_aniso(np.asarray(res["temps_force"]))
                             [-50:].mean())
    s["relax_A_end"] = float(_aniso(np.asarray(res["temps_relax"]))
                             [-100:].mean())
    return s


def transport_keys(stats: dict) -> list:
    """The 28 compared keys: the per-job covariates left out."""
    return [k for k in stats if not k.endswith("_m2_0") and k != "inst_A0"]


def curve_stats(res: dict) -> dict:
    """cross_validate_transport.py:62-75 on one job: g(r)'s first peak and
    hole edge bin at the last record snapshot, the mean temperature."""
    g = np.asarray(res["gr_record"][-1], np.float64)
    return dict(gr_peak=float(g.max()), hole_bin=int(np.argmax(g > 0.5)),
                temp=float(np.asarray(res["temps"]).mean()))


# ---- the steps (each returns its config, the port's pool, gates,
# ungated checks)

_NO_CURVES = ("the reference's per-job curves are not in the archive "
              "(only its pooled summary); waits for the C++ sources")


def step_frozen(variant: str, name: str, ref: dict, device, dtype, k, over):
    from mdqtplasmasims_torch.experiments import frozen_tagging as ft
    cfg = ft.FrozenTagConfig(variant=variant, dtype=dtype,
                             **dict(FROZEN, **over))
    jobs = [frozen_job_stats(variant, r) for r in
            ft.run_ensemble(cfg, k, seed=0, device=device)]
    port = pool(jobs, FROZEN_KEYS)
    src = "cross_validate_frozen_pooled.py:17-18,105"
    gates = z_gates(ref, port, FROZEN_KEYS, 3.0, src)
    fa = ref["vs"]["pooled tag fraction"]["ref"]
    fb = port["frac"]["mean"]
    gates.append(gate("pooled tag fraction rel diff",
                      abs(fa - fb) / max(fa, 1e-9), "lt", 0.20, src))
    return cfg, port, gates, []


def step_dih(name, ref, device, dtype, k, over):
    from mdqtplasmasims_torch.experiments import laser_cooling as lc
    cfg = lc.CoolingConfig(dtype=dtype, **dict(DIH, **over))
    _, outs = lc.run_ensemble(cfg, k, seed=0, device=device)
    jobs = [scalars(np.asarray(outs["t"][j], np.float64),
                    np.asarray(outs["ekin"][j], np.float64)[:, 0])
            for j in range(k)]
    port = pool(jobs, DIH_KEYS)
    gates = z_gates(ref, port, DIH_KEYS, 3.0,
                    "cross_validate_dih_pooled.py:18,146")
    return cfg, port, gates, [ungated(
        "EkinX(t) per-sample z by DIH era (|z| < 3)", _NO_CURVES,
        log_lines(name, "rise") + log_lines(name, "peak ")
        + log_lines(name, "oscillation") + log_lines(name, "plateau"))]


def step_expansion(name, ref, device, dtype, k, over):
    from mdqtplasmasims_torch.experiments import laser_cooling as lc
    cfg = lc.CoolingConfig(dtype=dtype, **dict(EXPANSION, **over))
    final, outs = lc.run_ensemble(cfg, k, seed=0, device=device)
    spd = np.array([spd_of_psi(final.psi[j]) for j in range(k)])
    drift = late_drift([outs["vx_mean"][j] for j in range(k)])
    port = dict(spd=dict(mean=spd.mean(0).tolist(), per_job=spd.tolist(),
                         k=k), late_vx_drift=dict(mean=drift, k=k))
    src = "cross_validate_expansion.py:182-186"
    spd_ref = np.array(ref["vs"]["final S/P/D"]["ref"])
    d_ref = ref["vs"]["late <vx> drift"]["ref"]
    gates = [gate("final S/P/D max |diff|",
                  np.abs(spd_ref - spd.mean(0)).max(), "lt", 0.05, src)]
    # the drift passes when |ref| < 1e-3, within 50 % of ref, or within 0.02
    limit = max(0.5 * abs(d_ref), 0.02) if abs(d_ref) >= 1e-3 else math.inf
    gates.append(gate("late <vx> drift |diff|", abs(drift - d_ref), "lt",
                      limit, src))
    return cfg, port, gates, [ungated(
        "pooled Ekin_tot(t) and Epot(t) per-sample z (|z| < 3)", _NO_CURVES,
        log_lines(name, "pooled Ekin_tot") + log_lines(name, "pooled Epot"))]


def step_flagship(name, ref, device, dtype, k, over):
    from mdqtplasmasims_torch.experiments import laser_cooling as lc
    cfg = lc.CoolingConfig(dtype=dtype, **dict(FLAGSHIP, **over))
    _, outs = lc.run_ensemble(cfg, k, seed=0, device=device)
    spd = np.array([flagship_spd(outs["pops"][j]) for j in range(k)])
    port = dict(spd=dict(mean=spd.mean(0).tolist(), per_job=spd.tolist(),
                         k=k))
    spd_ref = np.array(ref["vs"]["final S/P/D"]["ref"])
    gates = [gate("final S/P/D max |diff|",
                  np.abs(spd_ref - spd.mean(0)).max(), "lt", 0.08,
                  "cross_validate_flagship.py:91")]
    return cfg, port, gates, [ungated(
        "total-Ekin and Epot median relative difference (< 0.1)",
        _NO_CURVES, log_lines(name, "total-Ekin") + log_lines(name, "Epot"))]


def step_mc_tag(variant: str, name, ref, device, dtype, k, over):
    from mdqtplasmasims_torch.analysis import weighted_pooled_mean
    from mdqtplasmasims_torch.experiments import mc_qt_tagging as mt
    cfg = mt.MCTagConfig(variant=variant, dtype=dtype,
                         **dict(MC_TAG, **over))
    jobs = [mc_tag_job_stats(r) for r in
            mt.run_ensemble(cfg, k, seed=0, device=device)]
    vm = weighted_pooled_mean([j["vx2"] for j in jobs],
                              [j["frac"] for j in jobs])
    fm = float(np.mean([j["frac"] for j in jobs]))
    tm = float(np.mean([j["temp"] for j in jobs]))
    port = dict(pooled_tagged_vx2=dict(mean=vm, k=k),
                pooled_tag_fraction=dict(mean=fm, k=k),
                mean_temperature=dict(mean=tm, k=k),
                selectivity=dict(mean=vm / THERMAL, k=k),
                per_job={key: [j[key] for j in jobs]
                         for key in ("vx2", "frac", "temp")})
    vs = ref["vs"]
    vr = vs["pooled tagged <vx^2>"]["ref"]
    fr = vs["pooled tag fraction"]["ref"]
    tr = vs["mean temperature"]["ref"]
    src = "cross_validate_mc_tag.py:83-97"
    gates = [gate("pooled tagged <vx^2> rel diff", abs(vr - vm) / vr, "lt",
                  0.30, src),
             gate("pooled tag fraction |diff|", abs(fr - fm), "lt",
                  max(0.02, 0.3 * fr), src),
             gate("mean temperature rel diff", abs(tr - tm) / tr, "lt", 0.10,
                  src)]
    if variant == "408quad":
        gates.append(gate("tag selectivity <vx^2>_tag/thermal", vm / THERMAL,
                          "gt", 1.1, src))
    return cfg, port, gates, [ungated(
        "normalized VAF max diff, first 200 lags (< 0.15)", _NO_CURVES,
        log_lines(name, "normalized VAF"))]


def step_transport_pooled(name, ref, device, dtype, k, over):
    from mdqtplasmasims_torch.experiments import mc_md_anisotropy as tr
    cfg = tr.MCTransportConfig(dtype=dtype, **dict(TRANSPORT, **over))
    jobs = [fw_job_stats(r, cfg.record_steps) for r in
            tr.run_ensemble(cfg, k, seed=TRANSPORT_SEED, device=device)]
    keys = transport_keys(jobs[0])
    port = pool(jobs, keys)
    src = "cross_validate_transport_pooled.py:337-357"
    zs = {g["observable"]: g["value"]
          for g in z_gates(ref, port, keys, 2.0, src)}
    misses = {key: z for key, z in zs.items() if abs(z) >= 2.0}
    port["z"] = zs
    gates = [gate("observables with raw |z| >= 2", len(misses), "le", 2,
                  src),
             gate("largest raw |z|", max(abs(z) for z in zs.values()),
                  "abs_lt", 3.02, src)]
    return cfg, port, gates, [ungated(
        "ANCOVA-matched z (fluctuation mechanism)",
        "needs the reference's per-job values (covariates), which the log "
        "does not hold; without it the rule is the JAX tool's or stricter",
        log_lines(name, "POOLED TRANSPORT"))]


def step_transport_curve(name, ref, device, dtype, k, over):
    from mdqtplasmasims_torch.experiments import mc_md_anisotropy as tr
    cfg = tr.MCTransportConfig(dtype=dtype, **dict(TRANSPORT_CURVE, **over))
    s = curve_stats(tr.run(cfg, device=device))
    port = {key: dict(mean=v, k=1) for key, v in s.items()}
    vs = ref["vs"]
    peak = vs["g(r) first peak"]["ref"]
    hole = vs["correlation-hole edge bin"]["ref"]
    temp = vs["mean temperature"]["ref"]
    src = "cross_validate_transport.py:65,69,75"
    gates = [gate("g(r) first peak rel diff", abs(s["gr_peak"] - peak) / peak,
                  "lt", 0.2, src),
             gate("correlation-hole edge bin |diff|",
                  abs(s["hole_bin"] - hole), "le", 2, src),
             gate("mean temperature rel diff", abs(s["temp"] - temp) / temp,
                  "lt", 0.25, src)]
    return cfg, port, gates, [ungated(
        "normalized VAF max diff, first 300 lags (< 0.15)", _NO_CURVES,
        log_lines(name, "normalized VAF"))]


# (name, the JAX tool, runner or None) in the JAX runner's order
STEPS = [
    ("transport_pooled", "cross_validate_transport_pooled.py",
     step_transport_pooled),
    ("transport_curve", "cross_validate_transport.py",
     step_transport_curve),
    ("three_state", "cross_validate_three_state.py", None),
    ("flagship", "cross_validate_flagship.py", step_flagship),
    ("mc_tag_408quad", "cross_validate_mc_tag.py",
     functools.partial(step_mc_tag, "408quad")),
    ("mc_tag_408linear", "cross_validate_mc_tag408linear.py",
     functools.partial(step_mc_tag, "408linear")),
    ("resume_interop", "cross_validate_resume.py", None),
    ("frozen_resume_interop", "cross_validate_frozen_resume.py", None),
    ("analysis_physics", "validate_analysis.py", None),
    ("frozen_pooled_422", "cross_validate_frozen_pooled.py",
     functools.partial(step_frozen, "422linear")),
    ("frozen_pooled_408", "cross_validate_frozen_pooled.py",
     functools.partial(step_frozen, "408linear")),
    ("dih_pooled", "cross_validate_dih_pooled.py", step_dih),
    ("expansion", "cross_validate_expansion.py", step_expansion),
]
GATED = [name for name, _, fn in STEPS if fn is not None]

NOT_RUN = {
    "three_state": "compares the toy's cooling curve with the reference "
                   "binary's energies.dat, which the archive does not hold; "
                   "waits for the C++ sources",
    "resume_interop": "continues the reference binary from the port's "
                      "checkpoints and back; needs the compiled C++ "
                      "program; waits for the C++ sources",
    "frozen_resume_interop": "continues the frozen-tag reference binary "
                             "from the port's checkpoints and back; needs "
                             "the compiled C++ program; waits for "
                             "the C++ sources",
}

# gated misses of the card's run that ROADMAP.md Queue 3 records as
# findings (step, gate) -> where; chip_smoke.py phase 36 passes a miss
# only when the archived report carries it with its fault
FAULTS = {
    ("frozen_pooled_422", "z m1_tag"): "ROADMAP.md Queue 3 item 6",
    ("transport_pooled", "largest raw |z|"): "ROADMAP.md Queue 3 item 7",
}


def mark_faults(entry: dict) -> dict:
    """Each missed gate of ``entry`` that :data:`FAULTS` records gets its
    ``fault``; the verdicts stay as they are."""
    for g in entry.get("gates", ()):
        where = FAULTS.get((entry["name"], g["name"]))
        if where and not g["ok"]:
            g["fault"] = where
    return entry


PRECISION = ("float32 on the card (the hand kernels are float32; float64 "
             "on CUDA raises); the JAX tool ran XLA float64 on the CPU")


def seeds_of(name: str, k: int) -> str:
    if name == "transport_pooled":
        return f"run_ensemble(seed={TRANSPORT_SEED}) of {k}"
    if name == "transport_curve":
        return "run(job=1)"
    return f"jobs 1..{k} (run_ensemble seed 0: member j starts as job j+1)"


def run_step(name: str, device, dtype: str, tiny: bool = False) -> dict:
    """One gated step: the archived reference, the port's pool at the JAX
    tool's configuration, k and seeds (``tiny``: :data:`TINY`'s cut and
    k = 2), every gate and ungated check, the wall and the launches."""
    from mdqtplasmasims_torch.ops.member_sum import member_sum
    tool, fn = {n: (t, f) for n, t, f in STEPS}[name]
    ref = parse_step(name)
    k = TINY_JOBS if tiny and ref["k"] > 1 else ref["k"]
    over = TINY[name] if tiny else {}
    reset, read = torch_soak._launch_counters()
    torch_soak.sync_cards(device)
    reset()
    t0 = time.perf_counter()
    cfg, port, gates, extra = fn(name, ref, device, dtype, k, over)
    torch_soak.sync_cards(device)
    wall = time.perf_counter() - t0
    launches = {key: v for key, v in read().items() if v}
    if member_sum.launches:
        launches["member_sum"] = member_sum.launches
    return dict(name=name, jax_tool=f"tools/{tool}", gated=True,
                config={f: getattr(cfg, f) for f in
                        cfg.__dataclass_fields__
                        if f != "save_directory"},
                cut=over, k=k, seeds=seeds_of(name, k), dtype=dtype,
                precision=PRECISION if dtype == "float32" else
                "float64 twins on the CPU (the tests' path)",
                reference=ref, port=port, gates=gates, ungated=extra,
                ok=all(g["ok"] for g in gates), wall_s=wall,
                launches=launches)


def not_run_step(name: str) -> dict:
    tool = {n: t for n, t, _ in STEPS}[name]
    entry = dict(name=name, jax_tool=f"tools/{tool}", gated=False)
    if name == "analysis_physics":
        entry["reason"] = ("the analysis layer's validation is "
                           "tools/torch_validate_analysis.py (section E: "
                           "the pooled Green-Kubo D against the reference's "
                           "pool); not run again here")
        if os.path.exists(ANALYSIS_REPORT):
            with open(ANALYSIS_REPORT) as f:
                e = json.load(f).get("E_cross_code", {})
            entry["linked"] = dict(
                report=os.path.relpath(ANALYSIS_REPORT, REPO),
                z=e.get("z"), ok=e.get("ok"), k=e.get("k"))
    else:
        entry["reason"] = NOT_RUN[name]
    entry["jax_logged"] = log_lines(name, "")[-3:]
    return entry


def max_abs_z(entry: dict):
    zs = [abs(g["value"]) for g in entry.get("gates", ())
          if g["name"].startswith("z ")]
    zs += [abs(z) for z in entry.get("port", {}).get("z", {}).values()]
    return (max(zs), len(zs)) if zs else None


def matrix_md(rows: list, out: str) -> None:
    md = ["# Validation matrix on the port (tools/torch_validate_all.py)",
          "", "| step | result | wall | max abs z (n) |", "|---|---|---|---|"]
    for r in rows:
        if not r["gated"]:
            res, wall = "not gated", "-"
        else:
            res = "PASS" if r["ok"] else "FAIL"
            faults = sorted({g["fault"] for g in r["gates"] if "fault" in g})
            if faults:
                res += f" ({', '.join(faults)})"
            wall = f"{r['wall_s']:.1f}s"
        mz = max_abs_z(r)
        md.append(f"| {r['name']} | {res} | {wall} | "
                  f"{f'{mz[0]:.2f} ({mz[1]})' if mz else '-'} |")
    md += ["", "Reference numbers: artifacts/validate_all/logs/ (the C++ "
           "programs' pooled statistics); the port's pools, gates and "
           "reasons: report.json beside this file."]
    with open(os.path.join(out, "MATRIX.md"), "w") as f:
        f.write("\n".join(md) + "\n")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated step names")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (float64 twins, for tests)")
    ap.add_argument("--tiny", action="store_true",
                    help="every step cut, k = 2 (a quick run; not the "
                         "recorded gates)")
    args = ap.parse_args(argv)
    names = [n for n, _, _ in STEPS]
    if args.only:
        args.only = args.only.split(",")
        unknown = set(args.only) - set(names)
        if unknown:
            ap.error(f"unknown steps: {sorted(unknown)}")
    return args


def run(args) -> dict:
    """Every step asked for on ``args.device``, written into the report at
    ``args.out`` as it finishes (``--only`` keeps the report's other
    steps); returns the report."""
    device = torch.device(args.device)
    dtype = "float32" if device.type == "cuda" else "float64"
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "report.json")
    plan = [n for n, _, _ in STEPS if not args.only or n in args.only]
    results = {}
    if args.only and os.path.exists(path):
        with open(path) as f:
            results = {r["name"]: r for r in json.load(f)["steps"]}
    meta = torch_soak.run_meta(device)
    t_all = time.perf_counter()
    report = {}
    for name in [n for n, _, _ in STEPS]:
        if name not in plan:
            continue
        if name in GATED:
            print(f"== {name}", flush=True)
            entry = run_step(name, device, dtype, args.tiny)
            if not args.tiny:
                mark_faults(entry)
            print(f"    -> {'PASS' if entry['ok'] else 'FAIL'} "
                  f"({entry['wall_s']:.1f} s, {meta['card']})", flush=True)
            for g in entry["gates"]:
                if not g["ok"]:
                    print(f"    miss: {g['name']} = {g['value']:.4g} "
                          f"({g['op']} {g['limit']:g})"
                          f"{'; ' + g['fault'] if 'fault' in g else ''}",
                          flush=True)
        else:
            entry = not_run_step(name)
        results[name] = entry
        rows = [results[n] for n, _, _ in STEPS if n in results]
        report = dict(ok=all(r["ok"] for r in rows if r["gated"]),
                      tiny=args.tiny, device=meta, dtype=dtype,
                      wall_s=time.perf_counter() - t_all, steps=rows)
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
        matrix_md(rows, args.out)
    return report


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.list:
        for name, tool, fn in STEPS:
            print(f"{name:24s} tools/{tool}"
                  f"{'' if fn else '  (not gated here)'}")
        return 0
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("torch_validate_all: no CUDA device; the matrix runs on an "
                  "NVIDIA GPU (--device cpu for the float64 twins)",
                  file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"libraries built in {torch_soak.build_libraries():.1f} s",
              flush=True)
    report = run(args)
    print(f"wrote {os.path.join(args.out, 'report.json')} "
          f"({report['wall_s']:.0f} s, {report['device']['card']}, "
          f"{report['dtype']})")
    print("VALIDATE ALL (port)", "PASS" if report["ok"] else "FAIL")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
