#!/usr/bin/env python3
"""The JAX package's known-physics targets (``tests/test_physics_targets.py``)
run through the PyTorch + CUDA port on one NVIDIA GPU, at the tests' own
sizes, into ``artifacts/physics_targets_torch/report.json``.

    python tools/torch_physics_targets.py [--out DIR]

The targets, each through the port's normal entry points:

- :func:`dih_curve`: disorder-induced heating (``run_dih`` of the JAX
  test): PlasmaUnits(2.0, 0.1), N ions from the JAX test's own start
  (``jax.random.uniform(PRNGKey(3), (N, 3), float64, 0, L)``, kept as
  ``tests/fixtures/dih_start_seed3_n<N>.npy``), V = 0, and per step one
  force call (``ops/yukawa.yukawa_forces_n3l_pallas``: kernel A on a CUDA
  tensor, its twin on the CPU, on N lanes rounded up to 128),
  ``core/md.leapfrog_substep`` with dt =
  0.002, T = mean(|V|^2)/3.  ``plain=True`` takes the plain all-pairs
  ``ops/yukawa.yukawa_forces_potential`` instead (the float64 reference
  of the f32-vs-f64 budget on the card, where the kernel is float32);
- :func:`eit_populations`: the 12-level EIT resonance: sr12_cooling(-1,
  1, 1, 1), h = dt_plasma = 0.01, no force, 120 ions at each of v =
  -1.43, -0.9, 0, 0.9, 1.43 gamma/k from state 0, 3000 ticks through
  ``core/scheduler.free_ion_ticks`` (the tick kernel's explicit-roll
  S = 12 form on the card), the uniforms ``[T, 5, n]`` from a
  ``torch.Generator`` on the device (seed :data:`EIT_SEED`), one launch
  per :data:`EIT_CHUNK` ticks;
- :func:`dark_state_dip`: the dark-state dip of the written
  ``statePopulationsVsVTime*.dat``: ``laser_cooling.run`` of
  ``CoolingConfig(n0=256, tmax=3, sample_freq=50)`` at (detSP, detDP) =
  (-1, 1) and (-0.5, 1) (seed 1, the config's job), the P population
  binned against |v| gamma/k by the JAX test's recipe (:func:`dip_profile`);
- :func:`tagged_class`: the tagged velocity class: ``frozen_tagging.
  run_sweep`` of the 422linear pump over det = -1, 0, +1, 2 jobs a point,
  seed 1, the members' tag moments pooled by ``analysis.sweep_table``.

Each ``*_misses`` function transcribes one JAX test's asserts and returns
the ones a result misses.  The report holds every value those asserts
read, the DIH curves, the EIT populations, the dip profiles, the tagged
<vx> and spin-up fractions, each target's wall (host clock from a synced
card to its return) and kernel launches, the card's ``nvidia-smi`` name
and power limit, ``misses`` and ``ok``.  The last 20 population files of
each dip run are copied to ``<out>/dip_<detSP>_<detDP>/``, so the tests
read real files.

Runs on CUDA (exit 2 without a card, 1 on any miss); every function
takes ``device="cpu"`` and size overrides for the tests.
Imports torch, numpy and ``mdqtplasmasims_torch`` (and
``tools/torch_soak.py``'s build, metadata and launch counters) only.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import torch_soak  # noqa: E402  (puts the repository root on sys.path)

ROOT = torch_soak.ROOT
OUT = os.path.join(ROOT, "artifacts", "physics_targets_torch")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")

nan = float("nan")

DIH_DT = 0.002
DIH_DENSITY, DIH_GE = 2.0, 0.1
DIH_RUN = (512, 2000)             # TestDIH.test_dih_temperature_curve
DIH_BUDGET = (256, 800)           # TestDIH.test_f32_matches_f64_within_budget
DIH_TILE = 128                    # lanes: N rounded up to a multiple of 128

EIT_V = (-1.43, -0.9, 0.0, 0.9, 1.43)
EIT_NTRAJ = 120
EIT_TICKS = 3000
EIT_CHUNK = 1000                  # ticks per launch of the tick kernel
EIT_SEED = 0

# (detSP, detDP, n_right): TestCurveLevel.test_dark_state_dip_tracks_detuning
DIP_CASES = ((-1.0, 1.0, 2), (-0.5, 1.0, 3))
DIP_CONFIG = dict(n0=256, tmax=3.0, sample_freq=50)
DIP_FILES = 20                    # the files pooled (t > 1)

TAG_CONFIG = dict(variant="422linear", n0=512, tstart=2.0, tmax=2.5,
                  timestep=0.01, sample_freq=40, tpump_seconds=3e-7)
TAG_DETS = (-1.0, 0.0, 1.0)
TAG_JOBS, TAG_SEED = 2, 1


def dih_start(n0: int) -> np.ndarray:
    """The JAX test's DIH start for ``n0`` ions (float64 ``[n0, 3]``)."""
    return np.load(os.path.join(FIXTURES, f"dih_start_seed3_n{n0}.npy"))


# ---- disorder-induced heating

def dih_curve(n0: int, n_steps: int, dtype=torch.float32, start=None,
              device="cuda", plain: bool = False) -> np.ndarray:
    """T after each of ``n_steps`` leapfrog steps from the frozen start
    ``start`` (float64 ``[n0, 3]``, cast to ``dtype``; the fixture by
    default): float64 ``[n_steps]`` (one fetch at the end)."""
    from mdqtplasmasims_torch.core.md import leapfrog_substep
    from mdqtplasmasims_torch.ops.yukawa import (yukawa_forces_n3l_pallas,
                                                 yukawa_forces_potential)
    from mdqtplasmasims_torch.units import PlasmaUnits
    pu = PlasmaUnits(DIH_DENSITY, DIH_GE)
    L = PlasmaUnits.box_length(n0)
    ldeb = pu.debye_length
    start = dih_start(n0) if start is None else np.asarray(start)
    R = torch.as_tensor(start, device=device).to(dtype)
    V = torch.zeros_like(R)
    T = []
    for _ in range(n_steps):
        F = (yukawa_forces_potential(R, L, ldeb)[0] if plain
             else yukawa_forces_n3l_pallas(R, L, ldeb, tile=DIH_TILE))
        R, V = leapfrog_substep(R, V, F, DIH_DT, L, False)
        T.append(torch.mean(torch.sum(V * V, 1)) / 3)
    return torch.stack(T).cpu().numpy().astype(np.float64)


def dih_values(T) -> dict:
    """What ``test_dih_temperature_curve``'s asserts read of T."""
    T = np.asarray(T)
    late, mid = T[1500:], T[500:1200]
    return dict(t_peak=float((np.argmax(T[:800]) + 1) * DIH_DT),
                T_peak=float(T[:800].max()),
                gamma_final=float(1.0 / late.mean()) if late.size else nan,
                T_dip=float(mid.min()) if mid.size else nan)


def dih_misses(T) -> list:
    """tests/test_physics_targets.py:53-61."""
    v = dih_values(T)
    out = []
    if not 0.3 < v["t_peak"] < 2.0:
        out.append(f"DIH peak at t={v['t_peak']}")
    if not 0.30 < v["T_peak"] < 0.55:
        out.append(f"DIH peak T={v['T_peak']}")
    if not 2.4 < v["gamma_final"] < 3.3:
        out.append(f"DIH final Gamma={v['gamma_final']}")
    if not v["T_dip"] < 0.95 * v["T_peak"]:
        out.append(f"no DIH dip: min {v['T_dip']} after peak {v['T_peak']}")
    return out


def budget_values(T64, T32) -> dict:
    """What ``test_f32_matches_f64_within_budget``'s asserts read."""
    T64, T32 = np.asarray(T64), np.asarray(T32)
    scale = T64.max()
    late = (abs(T64[500:].mean() - T32[500:].mean()) / scale
            if len(T64) > 500 else nan)
    return dict(early=float(np.abs(T64[:200] - T32[:200]).max() / scale),
                late=float(late))


def budget_misses(T64, T32) -> list:
    """tests/test_physics_targets.py:103-109."""
    v = budget_values(T64, T32)
    return ([f"f32 early error {v['early']}"] if not v["early"] < 0.01
            else []) + ([f"f32 late error {v['late']}"]
                        if not v["late"] < 0.05 else [])


# ---- the EIT dark-state resonance

def eit_populations(device="cuda", ntraj: int = EIT_NTRAJ,
                    ticks: int = EIT_TICKS, chunk: int = EIT_CHUNK,
                    seed: int = EIT_SEED, dtype=torch.float32) -> dict:
    """P (levels 2:6) and D (levels 6:12) populations after ``ticks``
    free-ion ticks, per velocity of :data:`EIT_V`, each the mean over
    ``ntraj`` trajectories; ``v_fixed`` says the ticks left every vx bit
    for bit."""
    from mdqtplasmasims_torch.core.qt import QTEngine
    from mdqtplasmasims_torch.core.scheduler import (free_ion_spec,
                                                     free_ion_ticks)
    from mdqtplasmasims_torch.levels import sr12_cooling
    dev = torch.device(device)
    eng = QTEngine(sr12_cooling(-1.0, 1.0, 1.0, 1.0), h=0.01,
                   dt_plasma=0.01, apply_force=False)
    spec = free_ion_spec(eng, chunk)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    v = torch.as_tensor(np.repeat(EIT_V, ntraj), dtype=dtype, device=dev)
    n = v.numel()
    psi = torch.zeros((12, n), dtype=cdt, device=dev)
    psi[0] = 1.0
    tp = torch.zeros(n, dtype=dtype, device=dev)
    vx = v
    g = torch.Generator(device=dev).manual_seed(seed)
    for k in range(0, ticks, chunk):
        rolls = torch.rand((min(chunk, ticks - k), 5, n), generator=g,
                           dtype=dtype, device=dev)
        vx, psi, tp = free_ion_ticks(spec, vx, psi, tp, rolls)
    pop = (psi.real ** 2 + psi.imag ** 2).cpu().numpy().astype(np.float64)
    per_v = lambda x: x.reshape(len(EIT_V), ntraj).mean(-1).tolist()
    return dict(v=list(EIT_V), ntraj=ntraj, ticks=ticks, chunk=chunk,
                seed=seed, pop_p=per_v(pop[2:6].sum(0)),
                pop_d=per_v(pop[6:12].sum(0)),
                v_fixed=bool(torch.equal(vx, v)))


def eit_misses(pop_p, pop_d) -> list:
    """tests/test_physics_targets.py:89-93."""
    out = []
    for i_res, i_off in ((0, 1), (4, 3)):       # +-1.43 vs +-0.9
        if not pop_p[i_res] < 0.75 * pop_p[i_off]:
            out.append(f"EIT P at v={EIT_V[i_res]}: {pop_p[i_res]} vs "
                       f"{pop_p[i_off]}")
        if not pop_d[i_res] > 1.3 * pop_d[i_off]:
            out.append(f"EIT D at v={EIT_V[i_res]}: {pop_d[i_res]} vs "
                       f"{pop_d[i_off]}")
    if not pop_d[0] > 1.5 * pop_d[2]:
        out.append(f"EIT D resonance vs v=0: {pop_d[0]} vs {pop_d[2]}")
    return out


# ---- the dark-state dip in the written files

def dip_config(det_sp: float, det_dp: float, out_dir, **over):
    from mdqtplasmasims_torch.experiments.laser_cooling import CoolingConfig
    return CoolingConfig(**dict(DIP_CONFIG, detuning=det_sp,
                                detuning_dp=det_dp,
                                save_directory=out_dir, **over))


def dip_name(det_sp: float, det_dp: float) -> str:
    return f"dip_{det_sp:g}_{det_dp:g}"


def dip_files(job_dir: str) -> list:
    """The population files the JAX test pools: the last 20 (t > 1)."""
    return sorted(glob.glob(os.path.join(
        job_dir, "statePopulationsVsVTime*.dat")))[-DIP_FILES:]


def dip_rows(files) -> np.ndarray:
    """The files' rows pooled (velocity, S, P, D populations)."""
    return np.concatenate([np.loadtxt(f) for f in files])


def dip_profile(files, p2q: float):
    """The JAX test's P(|v|) profile (tests/test_physics_targets.py:
    161-172): the files' rows pooled, |v| * ``p2q`` in gamma/k, 30 bins
    over 0-3, NaN where a bin holds 10 ions or fewer.  Returns
    ``(centers, profile)``."""
    rows = dip_rows(files)
    v_q = np.abs(rows[:, 0]) * p2q
    pop_p = rows[:, 2]
    bins = np.linspace(0, 3.0, 31)
    which = np.digitize(v_q, bins)
    prof = np.array([pop_p[which == i].mean()
                     if (which == i).sum() > 10 else np.nan
                     for i in range(1, len(bins))])
    return 0.5 * (bins[1:] + bins[:-1]), prof


def v_resonance(det_sp: float, det_dp: float) -> float:
    from mdqtplasmasims_torch.units import K_RATIO_1033
    return abs(det_dp - det_sp) / (1.0 + K_RATIO_1033)


def dip_values(centers, prof, v_res: float) -> dict:
    """The dip the JAX test finds (tests/test_physics_targets.py:175-189):
    the window's size, the local minima in it, the one nearest v_res and
    the inner shoulder's mean (None where there is none)."""
    centers, prof = np.asarray(centers), np.asarray(prof, dtype=float)
    window = np.isfinite(prof) & (np.abs(centers - v_res) <= 0.45)
    cand = [int(i) for i in np.flatnonzero(window)
            if 0 < i < len(prof) - 1
            and np.isfinite(prof[i - 1]) and np.isfinite(prof[i + 1])
            and prof[i] < prof[i - 1] and prof[i] < prof[i + 1]]
    i_dip = min(cand, key=lambda i: abs(centers[i] - v_res), default=None)
    shoulder = np.isfinite(prof) & (centers < v_res - 0.3) & \
        (centers > v_res - 0.9)
    return dict(window=int(window.sum()), candidates=cand, i_dip=i_dip,
                v_dip=None if i_dip is None else float(centers[i_dip]),
                shoulder=(float(prof[shoulder].mean()) if shoulder.any()
                          else None))


def dip_misses(centers, prof, v_res: float, n_right: int) -> list:
    """tests/test_physics_targets.py:174-202."""
    centers, prof = np.asarray(centers), np.asarray(prof, dtype=float)
    d = dip_values(centers, prof, v_res)
    if d["window"] < 4:
        return ["resonance window lacks statistics"]
    if d["i_dip"] is None:
        return ["no local dip inside the resonance window"]
    i_dip, v_dip = d["i_dip"], d["v_dip"]
    out = []
    if not abs(v_dip - v_res) <= 0.25:
        out.append(f"dip at {v_dip} for v_res {v_res}")
    if not (d["shoulder"] is not None and prof[i_dip] < 0.75 * d["shoulder"]):
        out.append(f"dip {prof[i_dip]} vs shoulder {d['shoulder']}")
    right = np.isfinite(prof) & (centers > v_dip) & (centers <= v_dip + 0.4)
    if right.sum() >= n_right - 1 and not prof[right].max() > prof[i_dip]:
        out.append(f"no recovery above the dip at {v_dip}")
    return out


def dark_state_dip(det_sp: float, det_dp: float, out_dir: str,
                   device="cuda", seed=None, **over) -> dict:
    """``laser_cooling.run`` of :func:`dip_config` into ``out_dir`` (seed
    ``cfg.job``, 1, unless ``seed`` is given) and the JAX test's profile
    of its files; ``v2`` is the pooled rows' mean vx^2 (plasma units)."""
    from mdqtplasmasims_torch.experiments.laser_cooling import (build_engine,
                                                                run)
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = dip_config(det_sp, det_dp, out_dir, **over)
    _, wall, launches = torch_soak._timed(
        device, lambda: run(cfg, seed=seed, device=device))
    p2q = build_engine(cfg).plas_to_quant_vel
    job = glob.glob(os.path.join(out_dir, "*", "job1"))[0]
    files = dip_files(job)
    centers, prof = dip_profile(files, p2q)
    v_res = v_resonance(det_sp, det_dp)
    return dict(det_sp=det_sp, det_dp=det_dp, n0=cfg.n0, tmax=cfg.tmax,
                seed=cfg.job if seed is None else seed,
                v2=float(np.mean(dip_rows(files)[:, 0] ** 2)),
                p2q=p2q, v_res=v_res, centers=centers.tolist(),
                profile=[None if not np.isfinite(x) else float(x)
                         for x in prof],
                **dip_values(centers, prof, v_res), job_dir=job,
                files=[os.path.basename(f) for f in files],
                file_bytes=[os.path.getsize(f) for f in files],
                wall_s=wall, launches=launches)


def profile_array(prof) -> np.ndarray:
    """A report's profile (None for NaN) as a float array."""
    return np.array([np.nan if x is None else x for x in prof], float)


# ---- the tagged velocity class

def tagged_class(device="cuda", dets=TAG_DETS, jobs_per_point: int = TAG_JOBS,
                 seed: int = TAG_SEED, **over) -> dict:
    """The 422linear frozen-tag sweep over ``dets``: per detuning the pooled
    tagged <vx> (``rows``) and spin-up fraction (``spin_up``)."""
    from mdqtplasmasims_torch.analysis import sweep_table
    from mdqtplasmasims_torch.experiments.frozen_tagging import (
        FrozenTagConfig, run_sweep)
    cfg = FrozenTagConfig(**dict(TAG_CONFIG, **over))
    (res, mcfgs), wall, launches = torch_soak._timed(
        device, lambda: run_sweep(cfg, [{"detuning": d} for d in dets],
                                  jobs_per_point=jobs_per_point, seed=seed,
                                  device=device))
    rows = sweep_table(mcfgs, [r["out_tag"]["moments"][0] for r in res],
                       keys=("detuning",))
    frac = sweep_table(mcfgs, [r["spin_up"].mean() for r in res],
                       keys=("detuning",))
    return dict(config=dict(TAG_CONFIG, **over), dets=list(dets),
                jobs_per_point=jobs_per_point, seed=seed, rows=rows,
                spin_up=frac, wall_s=wall, launches=launches)


def tagged_vx(rows) -> dict:
    return {r["detuning"]: r["mean"] for r in rows}


def tagged_misses(vx: dict) -> list:
    """tests/test_physics_targets.py:443-450."""
    out = []
    if not vx[-1.0] > 0.1:
        out.append(f"tagged <vx> at det=-1: {vx[-1.0]}")
    if not vx[1.0] < -0.1:
        out.append(f"tagged <vx> at det=+1: {vx[1.0]}")
    if not abs(vx[0.0]) < 0.12:
        out.append(f"tagged <vx> at resonance: {vx[0.0]}")
    if not abs(vx[-1.0] + vx[1.0]) < 0.5 * abs(vx[-1.0] - vx[1.0]):
        out.append(f"tagged <vx> not antisymmetric: {vx}")
    return out


# ---- the report

def _curve(n0, n_steps, dtype, device, plain=False) -> dict:
    T, wall, launches = torch_soak._timed(
        device, lambda: dih_curve(n0, n_steps, dtype, device=device,
                                  plain=plain))
    return dict(n0=n0, n_steps=n_steps, dtype=str(dtype).split(".")[-1],
                forces=("plain yukawa_forces_potential" if plain
                        else "yukawa_forces_n3l_pallas"), T=T.tolist(),
                wall_s=wall, launches=launches)


def report_misses(rep: dict) -> list:
    """Every JAX assert a report misses (empty: all met)."""
    out = dih_misses(rep["dih"]["T"])
    out += budget_misses(rep["dih_budget"]["f64"]["T"],
                         rep["dih_budget"]["f32"]["T"])
    out += eit_misses(rep["eit"]["pop_p"], rep["eit"]["pop_d"])
    if not rep["eit"]["v_fixed"]:
        out.append("the EIT ticks moved vx")
    for det_sp, det_dp, n_right in DIP_CASES:
        d = rep["dip"][dip_name(det_sp, det_dp)]
        out += [f"{dip_name(det_sp, det_dp)}: {m}" for m in dip_misses(
            d["centers"], profile_array(d["profile"]), d["v_res"], n_right)]
    out += tagged_misses(tagged_vx(rep["tagged"]["rows"]))
    return out


def run_targets(device, work_dir: str, out=None, dih=DIH_RUN,
                budget=DIH_BUDGET, eit=None, dip=None, tag=None) -> dict:
    """Every target on ``device``: the report (without writing it).  The
    dip trees go to ``work_dir/dip_<detSP>_<detDP>/`` and, with ``out``,
    their last files to ``out/dip_<detSP>_<detDP>/``.
    ``eit``, ``dip`` and ``tag`` are size overrides of
    :func:`eit_populations`, :func:`dark_state_dip` and
    :func:`tagged_class` (the tests' tiny runs)."""
    rep = dict(device=torch_soak.run_meta(device))
    rep["dih"] = _curve(*dih, torch.float32, device)
    rep["dih"].update(dih_values(rep["dih"]["T"]))
    rep["dih_budget"] = dict(
        f32=_curve(*budget, torch.float32, device),
        f64=_curve(*budget, torch.float64, device, plain=True))
    rep["dih_budget"].update(budget_values(rep["dih_budget"]["f64"]["T"],
                                           rep["dih_budget"]["f32"]["T"]))
    e, wall, launches = torch_soak._timed(
        device, lambda: eit_populations(device, **(eit or {})))
    rep["eit"] = dict(e, wall_s=wall, launches=launches)
    rep["dip"] = {}
    for det_sp, det_dp, _ in DIP_CASES:
        name = dip_name(det_sp, det_dp)
        d = dark_state_dip(det_sp, det_dp, os.path.join(work_dir, name),
                           device, **(dip or {}))
        if out is not None:
            dest = os.path.join(out, name)
            shutil.rmtree(dest, ignore_errors=True)
            os.makedirs(dest)
            for f in d["files"]:
                shutil.copy2(os.path.join(d["job_dir"], f), dest)
        del d["job_dir"]
        rep["dip"][name] = d
    rep["tagged"] = tagged_class(device, **(tag or {}))
    rep["walls_s"] = dict(
        dih=rep["dih"]["wall_s"],
        dih_budget=(rep["dih_budget"]["f32"]["wall_s"]
                    + rep["dih_budget"]["f64"]["wall_s"]),
        eit=rep["eit"]["wall_s"],
        dip=sum(d["wall_s"] for d in rep["dip"].values()),
        tagged=rep["tagged"]["wall_s"])
    return rep


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT,
                    help="report.json and the dip files (default: "
                    "%(default)s)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (for tests)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("torch_physics_targets: no CUDA device; the targets run "
                  "on an NVIDIA GPU (--device cpu for the twins)",
                  file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"libraries built in {torch_soak.build_libraries():.1f} s",
              flush=True)
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as work:    # the dip runs' trees
        rep = run_targets(device, work, args.out)
    rep["misses"] = report_misses(rep)
    rep["ok"] = not rep["misses"]
    path = os.path.join(args.out, "report.json")
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps(dict(walls_s=rep["walls_s"], misses=rep["misses"])))
    print("wrote", path, f"({rep['device']['card']})")
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
