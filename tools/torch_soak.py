#!/usr/bin/env python3
"""Production soak of the PyTorch + CUDA port on one NVIDIA GPU: one full
reference-scale run per experiment family, its .dat tree written, and the
headline physics numbers extracted to ``artifacts/soak_torch/summary.json``,
which ``tests/test_torch_soak.py`` holds to the bands of
``tests/test_physics_targets.py::TestFullScaleSoak`` and to the JAX
package's archive (``artifacts/soak/summary.json``, ``tools/soak.py``).

    python tools/torch_soak.py [name ...] [--out-dir DIR] [--summary PATH]

The families and their configurations are ``tools/soak.py``'s (the
reference programs' own operating points), plus the renormalized and the
N0 = 14000 cooling runs that ``TestFullScaleSoak`` reads:

- ``cooling``: ``CoolingConfig(n0=3500, tmax=30, sample_freq=40)``;
  ``cooling_renorm`` the same with ``renormalize=True``;
  ``cooling_n14000`` with ``n0=14000``;
- ``cooling_poisson_ensemble``: 8 Poissonian members (``exact_n=False``,
  ``seed=1``, a checkpoint every 75 segments); ``cooling_mesh_ensemble``:
  8 members per card on ``make_mesh(n_cards, 1)``;
- ``frozen`` / ``frozen_408quad``: ``FrozenTagConfig`` 422linear / 408quad
  at N0 = 3500, ``tstart=15``, ``tmax=25``;
- ``mc_tag`` / ``mc_tag_422``: ``MCTagConfig`` 408quad / 422linear at
  n = 4096 (100k MC steps, 1500 recorded steps);
- ``transport``: ``MCTransportConfig(n=4096)`` (200k MC steps, the full
  staged pipeline);
- ``three_state``: ``ThreeStateConfig(n0=1000)`` (tmax = 45000, 4.5 M
  ticks through the tick kernel's S = 3 form, one launch per 1000 ticks).

Each family is written into the summary as soon as it finishes, so a run
cut short loses only the family it was running; ``_meta`` holds the
card's ``nvidia-smi`` name and power limit, the torch and CUDA versions,
the source revision (``git rev-parse HEAD``, or "archive" outside a
checkout) and the date.  Each entry holds ``wall_s`` (host
clock from a synced card to the run's return, its tree included) and the
kernels' ``launches`` during the run.  The trees go to ``--out-dir``
(default ``$TMPDIR/soak_torch``), never into the repository; only the
files of :data:`ARCHIVED_FILES` (the cooling run's ``energies.dat``, the
transport run's ``VAF.dat`` and ``temperature.dat``) are copied into
``--archive-dir`` (default ``artifacts/soak_torch``) in the tree's
layout.

The kernel libraries and the codec are built before the first family is
timed.  Eight diagnostics run when named: ``chain_trace`` traces 300
Metropolis steps at the transport configuration with
``profiling.device_trace`` (the card's busy share, the top device
operations), ``md_trace_n14000`` 200 MD steps of the N0 = 14000 cooling
configuration, ``three_state_trace`` 200 launches (200,000 ticks) of the
``three_state`` job, ``tag_pool`` runs each tagging family as a fold of 8
jobs (per-member and pooled tag fractions), and ``xval_408quad`` pools a
fold of 64 408quad jobs at ``tools/cross_validate_mc_tag.py``'s
configuration with its z-scores against the archived reference and JAX
pools, ``three_state_seeds`` runs the ``three_state`` configuration
as a fold of 8 seeds (the spread of its final Ekin_x and cooling factor),
``campaign99`` runs the reference's 99-job campaign uncut through
``tools/torch_campaign99.py`` (one 99-member fold of the flagship), and
``campaign99_trace`` traces one group of its 10 segments (400 MD steps
at E = 99) and times the fold's start; each is stored as ``_<name>``.

Every family function takes ``device`` and keyword overrides of its
configuration, so the tests run the same code at a tiny size on the CPU;
the metric extraction is plain numpy on the run's results, with
``tools/soak.py``'s keys and formulas.  Runs on CUDA only: exits 2
without a card.  Imports torch, numpy and ``mdqtplasmasims_torch`` only.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SUMMARY = os.path.join(ROOT, "artifacts", "soak_torch", "summary.json")
ARCHIVE = os.path.dirname(SUMMARY)
# the files of a family's tree the archive keeps, in the tree's layout
# (``<family>/<param dir>/job1/``, as the JAX package's artifacts/soak):
# tests/test_torch_physics_targets.py fits the cooling slope to the one
# and the Green-Kubo D to the others
ARCHIVED_FILES = {"cooling": ("energies.dat",),
                  "transport": ("VAF.dat", "temperature.dat")}

# tools/soak.py's operating points
COOLING = dict(n0=3500, tmax=30.0, sample_freq=40)
FROZEN = dict(n0=3500, tstart=15.0, tmax=25.0)
MC_N = 4096


# ---- metric extraction (plain numpy, tools/soak.py's formulas)

def _dih_windows(t, ekx) -> dict:
    """DIH peak in t <= 8 and the late (t >= 25) cooling ratio of one EkinX
    curve (tools/soak.py:69-82)."""
    early, late = t <= 8.0, t >= 25.0
    i_peak = int(np.argmax(ekx[early]))
    peak = ekx[early][i_peak]
    return dict(dih_peak_t=float(t[early][i_peak]),
                dih_peak_ekin_x=float(peak),
                ekin_x_late=float(np.mean(ekx[late])),
                cooling_ratio=float(np.mean(ekx[late]) / peak))


def cooling_metrics(outs: dict, psi) -> dict:
    """One cooling run's summary numbers from its outputs and final psi
    (tools/soak.py:69-91)."""
    t = np.asarray(outs["t"], np.float64)
    ekx = np.asarray(outs["ekin"], np.float64)[:, 0]
    pops = np.abs(np.asarray(psi)) ** 2
    return dict(
        _dih_windows(t, ekx),
        gamma_dih=float(1.0 / (2 * np.mean(ekx[(t > 6) & (t < 10)]))),
        pop_s=float(pops[:, :2].sum(-1).mean()),
        pop_p=float(pops[:, 2:6].sum(-1).mean()),
        pop_d=float(pops[:, 6:].sum(-1).mean()))


def norm_max_dev(psi) -> float:
    """max over ions of | ||psi||^2 - 1 |."""
    p = np.asarray(psi).astype(np.complex128)
    return float(np.abs((np.abs(p) ** 2).sum(-1) - 1.0).max())


def ensemble_metrics(outs: dict) -> dict:
    """The member-mean EkinX curve's DIH peak and cooling ratio
    (tools/soak.py:228-252)."""
    t = np.asarray(outs["t"], np.float64)[0]
    ekx = np.asarray(outs["ekin"], np.float64)[:, :, 0].mean(0)
    m = _dih_windows(t, ekx)
    del m["ekin_x_late"]
    return m


def member_counts(base: str, tmax: float, timestep: float) -> list:
    """Each member's N from its tree's last ``conditions_timestep*.dat``
    (tools/soak.py:241-243)."""
    c0 = int(round(tmax / timestep)) - 1
    return sorted(int(np.loadtxt(p, ndmin=2).shape[0]) for p in glob.glob(
        os.path.join(base, "*", "job*", f"conditions_timestep{c0:06d}.dat")))


def frozen_metrics(final, res: dict, variant: str) -> dict:
    """Frozen-start tagging (tools/soak.py:95-137): the tag fraction and
    the tagged moments at the tag; for 422linear also the tau=0 VAF and
    the tagged ions' final vx, for 408quad the tau=0 longitudinal
    kinetic-energy autocorrelation."""
    spin_up = np.asarray(res["spin_up"], bool)
    mom = np.asarray(res["out_tag"]["moments"], np.float64)
    if variant == "408quad":
        return dict(tag_fraction=float(spin_up.mean()),
                    tagged_vx2_at_tag=float(mom[1]),
                    long_kin_tau0=float(np.asarray(
                        res["out_tag"]["long_kin"])))
    vx_tag = np.asarray(final.V, np.float64)[spin_up, 0]
    return dict(tag_fraction=float(spin_up.mean()),
                tagged_vx_at_tag=float(mom[0]),
                tagged_vx2_at_tag=float(mom[1]),
                vaf_tau0=float(np.asarray(res["out_tag"]["vaf"])),
                tagged_vx_final=float(vx_tag.mean()),
                frac_tagged_positive_vx=float((vx_tag > 0).mean()))


def mc_tag_metrics(res: dict, gamma: float, variant: str) -> dict:
    """MC tagging (tools/soak.py:140-176): the tag fraction and record
    temperature; for 408quad also the selectivity and the VAF's decay."""
    tags = np.asarray(res["tags"], bool)
    temps = np.asarray(res["temps"], np.float64)
    out = dict(tag_fraction=float(tags.mean()),
               mean_record_temp=float(temps.mean()))
    if variant == "408quad":
        moments = np.asarray(res["moments"], np.float64)     # [T, 4]
        vaf = np.asarray(res["vaf"], np.float64)
        out.update(gamma=gamma, tagged_vx2_initial=float(moments[0, 1]),
                   selectivity=float(moments[0, 1] * gamma),
                   vaf_norm_min=float((vaf / vaf[0]).min()))
    return out


def transport_metrics(res: dict, gamma: float) -> dict:
    """Transport (tools/soak.py:179-199)."""
    temps = np.asarray(res["temps"], np.float64)
    ti = np.asarray(res["temps_inst"], np.float64)           # [steps, 3]
    vaf = np.asarray(res["vaf"], np.float64)
    tail = ti[-500:].mean(0)
    return dict(gamma=gamma, mean_record_temp=float(temps.mean()),
                vaf_norm_min=float((vaf / vaf[0]).min()),
                aniso_spread_initial=float(ti[0].max() - ti[0].min()),
                aniso_spread_relaxed=float(tail.max() - tail.min()))


def three_state_metrics(ekin_x, doppler: float) -> dict:
    """Three-state toy (tools/soak.py:202-219)."""
    ek = np.asarray(ekin_x, np.float64)
    n_late = max(1, len(ek) // 10)
    return dict(ekin_x_initial=float(ek[0]),
                ekin_x_final=float(ek[-n_late:].mean()),
                doppler_limit=float(doppler),
                cooling_factor=float(ek[0] / ek[-n_late:].mean()))


# ---- the families

def _launch_counters():
    """chip_smoke.py's counters of every kernel form (reset, read)."""
    import chip_smoke
    return chip_smoke.reset_counts, chip_smoke.read_counts


def sync_cards(device) -> None:
    """Wait for every visible card (a mesh's slots may lie on several);
    nothing to wait for on the CPU."""
    if torch.device(device).type == "cuda":
        for j in range(torch.cuda.device_count()):
            torch.cuda.synchronize(j)


def _timed(device, fn):
    """``fn()``'s result, its host-clock seconds from synced cards to its
    return (every family ends in a host fetch), and the launches."""
    reset, read = _launch_counters()
    sync_cards(device)
    reset()
    t0 = time.perf_counter()
    out = fn()
    sync_cards(device)
    wall = time.perf_counter() - t0
    return out, wall, {k: v for k, v in read().items() if v}


def _fresh(out_dir: str, name: str) -> str:
    """An empty tree directory for one family (a rerun never appends)."""
    d = os.path.join(out_dir, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def cooling_config(save_directory, **over):
    from mdqtplasmasims_torch.experiments.laser_cooling import CoolingConfig
    return CoolingConfig(**dict(COOLING, save_directory=save_directory,
                                **over))


def _cooling(name: str, fixed: dict):
    def soak(out_dir, device="cuda", **over):
        from mdqtplasmasims_torch.experiments.laser_cooling import run
        cfg = cooling_config(_fresh(out_dir, name), **dict(fixed, **over))
        (final, res), wall, launches = _timed(
            device, lambda: run(cfg, device=device))
        m = dict(n0=cfg.n0, tmax=cfg.tmax, wall_s=wall,
                 **cooling_metrics(res["outs"], final.psi))
        if cfg.renormalize:
            m["final_norm_max_dev"] = norm_max_dev(final.psi)
        return dict(m, launches=launches)
    soak.__name__ = f"soak_{name}"
    soak.__doc__ = f"``{name}``: CoolingConfig({COOLING}, {fixed})."
    return soak


soak_cooling = _cooling("cooling", {})
soak_cooling_renorm = _cooling("cooling_renorm", dict(renormalize=True))
soak_cooling_n14000 = _cooling("cooling_n14000", dict(n0=14000))


def soak_cooling_poisson_ensemble(out_dir, device="cuda", **over):
    """8 jobs, each with its own N ~ Binomial(729 N0, 1/729), folded into
    one program with per-member masks (tools/soak.py:222-256)."""
    from mdqtplasmasims_torch.experiments.laser_cooling import run_ensemble
    base = _fresh(out_dir, "cooling_poisson")
    cfg = cooling_config(base, **dict(dict(
        exact_n=False, checkpoint_every_segments=75), **over))
    (final, outs), wall, launches = _timed(
        device, lambda: run_ensemble(cfg, n_jobs=8, seed=1, device=device))
    n_js = member_counts(base, cfg.tmax, cfg.timestep)
    return dict(n_jobs=8, n0=cfg.n0, tmax=cfg.tmax, wall_s=wall,
                member_ns=n_js, member_n_spread=int(n_js[-1] - n_js[0]),
                **ensemble_metrics(outs), launches=launches)


def _slots(device, devices) -> list:
    """A mesh's slot devices: ``devices`` (a list that may repeat one), or
    by default every visible card, or one slot on a CPU ``device``."""
    if devices is not None:
        return list(devices)
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", j)
                for j in range(torch.cuda.device_count())]
    return [torch.device(device)]


def soak_cooling_mesh_ensemble(out_dir, device="cuda", devices=None,
                               jobs_per_slot=8, ranks=None, **over):
    """``run_ensemble(mesh=make_mesh(len(devices), 1, devices))`` with
    ``jobs_per_slot`` members per slot, trees and periodic checkpoints
    (tools/soak.py:259-285); ``devices`` as :func:`_slots`, ``ranks`` as
    ``make_mesh``'s.  The trees are removed after the run (the metrics
    come from its outputs; 32 members' trees are some 2.3 GiB)."""
    from mdqtplasmasims_torch.experiments.laser_cooling import run_ensemble
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    devices = _slots(device, devices)
    mesh = make_mesh(len(devices), 1, devices=devices, ranks=ranks)
    base = _fresh(out_dir, "cooling_mesh")
    cfg = cooling_config(base, **dict(dict(
        checkpoint_every_segments=75), **over))
    n_jobs = jobs_per_slot * len(devices)
    (final, outs), wall, launches = _timed(
        device, lambda: run_ensemble(cfg, n_jobs=n_jobs, seed=1, mesh=mesh))
    shutil.rmtree(base, ignore_errors=True)
    ticks = n_jobs * cfg.n0 * int(round(cfg.tmax / cfg.timestep)) * cfg.ratio
    return dict(n_devices=len({str(d) for d in devices}),
                slots=[str(d) for d in devices], n_jobs=n_jobs, n0=cfg.n0,
                tmax=cfg.tmax, wall_s=wall, agg_updates_per_sec=ticks / wall,
                **ensemble_metrics(outs), launches=launches)


def cooling_ion_mesh(out_dir, device="cuda", devices=None,
                     ion_forces="gather", ranks=None, **over):
    """The ``cooling_n14000`` run as one member whose ions are sharded over
    a ``1 x len(devices)`` mesh (``run_ensemble(cfg, 1, mesh=...,
    ion_forces=...)``, kernels E or C and F), with its tree; its
    :func:`cooling_metrics` as ``cooling_n14000``'s; ``devices`` as
    :func:`_slots`, ``ranks`` as ``make_mesh``'s."""
    from mdqtplasmasims_torch.experiments.laser_cooling import run_ensemble
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    devices = _slots(device, devices)
    mesh = make_mesh(1, len(devices), devices=devices, ranks=ranks)
    base = _fresh(out_dir, f"cooling_ions_{ion_forces}")
    cfg = cooling_config(base, **dict(dict(n0=14000), **over))
    (final, outs), wall, launches = _timed(
        device, lambda: run_ensemble(cfg, n_jobs=1, seed=1, mesh=mesh,
                                     ion_forces=ion_forces))
    shutil.rmtree(base, ignore_errors=True)
    return dict(n0=cfg.n0, tmax=cfg.tmax, ion_forces=ion_forces,
                slots=[str(d) for d in devices], wall_s=wall,
                **cooling_metrics({k: v[0] for k, v in outs.items()},
                                  final.psi[0]),
                launches=launches)


def frozen_config(variant: str, save_directory, **over):
    from mdqtplasmasims_torch.experiments.frozen_tagging import (
        FrozenTagConfig)
    return FrozenTagConfig(**dict(FROZEN, variant=variant,
                                  save_directory=save_directory, **over))


def _frozen(name: str, variant: str, tree: str):
    def soak(out_dir, device="cuda", **over):
        from mdqtplasmasims_torch.experiments.frozen_tagging import run
        cfg = frozen_config(variant, _fresh(out_dir, tree), **over)
        (final, res), wall, launches = _timed(
            device, lambda: run(cfg, device=device))
        return dict(n0=cfg.n0, tstart=cfg.tstart, tmax=cfg.tmax,
                    wall_s=wall, **frozen_metrics(final, res, variant),
                    launches=launches)
    soak.__name__ = f"soak_{name}"
    soak.__doc__ = f"``{name}``: FrozenTagConfig({variant!r}, {FROZEN})."
    return soak


soak_frozen = _frozen("frozen", "422linear", "frozen")
soak_frozen_408quad = _frozen("frozen_408quad", "408quad", "frozen408q")


def _mc_tag(name: str, variant: str, tree: str):
    def soak(out_dir, device="cuda", **over):
        from mdqtplasmasims_torch.experiments.mc_qt_tagging import (
            MCTagConfig, run)
        cfg = MCTagConfig(**dict(dict(variant=variant, n=MC_N,
                                      save_directory=_fresh(out_dir, tree)),
                                 **over))
        res, wall, launches = _timed(device, lambda: run(cfg, device=device))
        return dict(n=cfg.n, mc_steps=cfg.mc_steps, wall_s=wall,
                    **mc_tag_metrics(res, cfg.gamma, variant),
                    launches=launches)
    soak.__name__ = f"soak_{name}"
    soak.__doc__ = f"``{name}``: MCTagConfig({variant!r}, n={MC_N})."
    return soak


soak_mc_tag = _mc_tag("mc_tag", "408quad", "mc_tag")
soak_mc_tag_422 = _mc_tag("mc_tag_422", "422linear", "mc_tag422")


def soak_transport(out_dir, device="cuda", **over):
    """``MCTransportConfig(n=4096)``: 200k MC steps and the staged MD."""
    from mdqtplasmasims_torch.experiments.mc_md_anisotropy import (
        MCTransportConfig, run)
    cfg = MCTransportConfig(**dict(dict(
        n=MC_N, save_directory=_fresh(out_dir, "transport")), **over))
    res, wall, launches = _timed(device, lambda: run(cfg, device=device))
    return dict(n=cfg.n, mc_steps=cfg.mc_steps, wall_s=wall,
                **transport_metrics(res, cfg.gamma), launches=launches)


def _member_mesh(devices):
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    return None if devices is None else make_mesh(len(devices), 1,
                                                  devices=devices)


def frozen_fold(out_dir, device="cuda", n_jobs=8, devices=None, **over):
    """The ``frozen`` job (422linear) as one fold of ``n_jobs`` members
    (seed 1, no trees), over ``make_mesh(len(devices), 1, devices)`` when
    ``devices`` is given: each member's tag fraction."""
    from mdqtplasmasims_torch.experiments import frozen_tagging as ft
    cfg = frozen_config("422linear", None, **over)
    res, wall, launches = _timed(device, lambda: ft.run_ensemble(
        cfg, n_jobs, seed=1, mesh=_member_mesh(devices), device=device))
    return dict(n0=cfg.n0, tstart=cfg.tstart, tmax=cfg.tmax, n_jobs=n_jobs,
                slots=None if devices is None else [str(d) for d in devices],
                member_fractions=[float(np.asarray(r["spin_up"]).mean())
                                  for r in res],
                wall_s=wall, launches=launches)


def transport_fold(out_dir, device="cuda", n_jobs=4, devices=None, **over):
    """The ``transport`` job as one fold of ``n_jobs`` members (seed 1, no
    trees), over ``make_mesh(len(devices), 1, devices)`` when ``devices``
    is given: each member's :func:`transport_metrics`."""
    from mdqtplasmasims_torch.experiments.mc_md_anisotropy import (
        MCTransportConfig, run_ensemble)
    cfg = MCTransportConfig(**dict(dict(n=MC_N), **over))
    res, wall, launches = _timed(device, lambda: run_ensemble(
        cfg, n_jobs, seed=1, mesh=_member_mesh(devices), device=device))
    return dict(n=cfg.n, mc_steps=cfg.mc_steps, md_steps=cfg.md_steps,
                n_jobs=n_jobs,
                slots=None if devices is None else [str(d) for d in devices],
                members=[transport_metrics(r, cfg.gamma) for r in res],
                wall_s=wall, launches=launches)


def soak_three_state(out_dir, device="cuda", **over):
    """``ThreeStateConfig(n0=1000)`` to tmax = 45000."""
    from mdqtplasmasims_torch.experiments.three_state import (
        ThreeStateConfig, doppler_limit_ekin, run)
    cfg = ThreeStateConfig(**dict(dict(
        n0=1000, save_directory=_fresh(out_dir, "three_state")), **over))
    res, wall, launches = _timed(device, lambda: run(cfg, device=device))
    return dict(n0=cfg.n0, tmax=cfg.tmax, wall_s=wall,
                **three_state_metrics(res["ekin_x"],
                                      doppler_limit_ekin(cfg.detuning,
                                                         cfg.om)),
                launches=launches)


FAMILIES = {
    "cooling": soak_cooling,
    "cooling_renorm": soak_cooling_renorm,
    "cooling_n14000": soak_cooling_n14000,
    "cooling_poisson_ensemble": soak_cooling_poisson_ensemble,
    "cooling_mesh_ensemble": soak_cooling_mesh_ensemble,
    "frozen": soak_frozen,
    "frozen_408quad": soak_frozen_408quad,
    "mc_tag": soak_mc_tag,
    "mc_tag_422": soak_mc_tag_422,
    "transport": soak_transport,
    "three_state": soak_three_state,
}
DEFAULT_FAMILIES = tuple(FAMILIES)


def tag_pool(out_dir, device="cuda", n_jobs=8, frozen_over=None,
             mc_over=None) -> dict:
    """Each tagging family's job as a fold of ``n_jobs`` members (seed 1,
    no trees), the same configurations as its soak: per-member tag
    fractions, the pooled fraction and its binomial standard error, the
    spread that one job's fraction has around the pool."""
    from mdqtplasmasims_torch.experiments import frozen_tagging as ft
    from mdqtplasmasims_torch.experiments import mc_qt_tagging as mt
    runs = {}
    for fam, variant in (("frozen", "422linear"),
                         ("frozen_408quad", "408quad")):
        cfg = frozen_config(variant, None, **(frozen_over or {}))
        runs[fam] = (cfg.n0, lambda cfg=cfg: [r["spin_up"] for r in (
            ft.run_ensemble(cfg, n_jobs, seed=1, device=device))])
    for fam, variant in (("mc_tag", "408quad"), ("mc_tag_422", "422linear")):
        cfg = mt.MCTagConfig(**dict(dict(variant=variant, n=MC_N),
                                    **(mc_over or {})))
        runs[fam] = (cfg.n, lambda cfg=cfg: [r["tags"] for r in (
            mt.run_ensemble(cfg, n_jobs, seed=1, device=device))])
    out = {}
    for fam, (n, fn) in runs.items():
        tags, wall, launches = _timed(device, fn)
        fr = np.asarray([np.asarray(t, bool).mean() for t in tags])
        pooled = float(np.mean(np.concatenate(
            [np.asarray(t, bool).ravel() for t in tags])))
        out[fam] = dict(n=n, n_jobs=n_jobs, member_fractions=fr.tolist(),
                        pooled=pooled, pooled_se=float(np.sqrt(
                            pooled * (1 - pooled) / (n * n_jobs))),
                        member_sd=float(fr.std(ddof=1)), wall_s=wall,
                        launches=launches)
    return out


# tools/cross_validate_mc_tag.py's configuration (the compiled reference
# shrunk to N = 216; the 408quad pump's defaults: tpump = 1e-7 s, det = 0,
# Om = 2) and the pooled tag fractions of 8 jobs archived there
XVAL_408QUAD = dict(variant="408quad", n=216, mc_steps=20000,
                    pre_record_md_steps=100, record_steps=300)
XVAL_POOLS = {
    "reference (RESULTS.md:415)": 0.0394,
    "reference (artifacts/validate_all/logs/mc_tag_408quad.log)": 0.0422,
    "JAX package (RESULTS.md:415)": 0.0405,
    "JAX package (artifacts/validate_all/logs/mc_tag_408quad.log)": 0.0370,
}
XVAL_POOL_IONS = 8 * 216


def xval_408quad(out_dir, device="cuda", n_jobs=64, **over) -> dict:
    """The port's pooled 408quad tag fraction at
    :data:`XVAL_408QUAD` as one fold of ``n_jobs`` members (seed 1, no
    trees), and its z-score against each pool of :data:`XVAL_POOLS`: the
    difference over the root sum of both binomial standard errors (8 jobs
    of 216 ions a pool)."""
    from mdqtplasmasims_torch.experiments import mc_qt_tagging as mt
    cfg = mt.MCTagConfig(**dict(XVAL_408QUAD, **over))
    tags, wall, launches = _timed(device, lambda: [
        r["tags"] for r in mt.run_ensemble(cfg, n_jobs, seed=1,
                                           device=device)])
    flat = np.concatenate([np.asarray(t, bool).ravel() for t in tags])
    pooled = float(flat.mean())
    se = float(np.sqrt(pooled * (1 - pooled) / flat.size))
    z = {k: (pooled - p) / float(np.sqrt(se ** 2 + p * (1 - p)
                                          / XVAL_POOL_IONS))
         for k, p in XVAL_POOLS.items()}
    return dict(n=cfg.n, n_jobs=n_jobs, mc_steps=cfg.mc_steps,
                pooled=pooled, pooled_se=se, z=z,
                member_fractions=[float(np.asarray(t, bool).mean())
                                  for t in tags],
                wall_s=wall, launches=launches)


def three_state_seeds(out_dir, device="cuda", n_jobs=8, **over) -> dict:
    """The ``three_state`` soak's configuration as one fold of ``n_jobs``
    independent members (seed 1, no trees): each member's
    :func:`three_state_metrics`, and the spread of ``ekin_x_final`` and
    of the cooling factor between seeds, against which one run's values
    (the JAX package's archive, the port's) are compared."""
    from mdqtplasmasims_torch.experiments.three_state import (
        ThreeStateConfig, doppler_limit_ekin, run_ensemble)
    cfg = ThreeStateConfig(**dict(dict(n0=1000), **over))
    res, wall, launches = _timed(device, lambda: run_ensemble(
        cfg, n_jobs, seed=1, device=device))
    doppler = doppler_limit_ekin(cfg.detuning, cfg.om)
    members = [three_state_metrics(ek, doppler)
               for ek in np.asarray(res["ekin_x"])]
    out = dict(n0=cfg.n0, tmax=cfg.tmax, n_jobs=n_jobs, wall_s=wall,
               launches=launches)
    for key in ("ekin_x_final", "cooling_factor"):
        x = np.asarray([m[key] for m in members])
        out[key] = x.tolist()
        out[key + "_mean"] = float(x.mean())
        out[key + "_sd"] = float(x.std(ddof=1))
    return out


def build_libraries() -> float:
    """Build and load the kernel libraries and the .dat codec before any
    family is timed; returns the seconds it took."""
    from mdqtplasmasims_torch.core import qt_fused
    from mdqtplasmasims_torch.io import datfiles
    from mdqtplasmasims_torch.ops import yukawa
    t0 = time.perf_counter()
    for lib in (yukawa._lib, qt_fused._lib, datfiles._codec):
        lib()
    return time.perf_counter() - t0


# ---- the archive

def archive_files(name: str, out_dir: str, archive_dir: str) -> list:
    """Copy family ``name``'s :data:`ARCHIVED_FILES` from its tree under
    ``out_dir`` into the same layout under ``archive_dir``; returns the
    copies' paths."""
    out = []
    for fname in ARCHIVED_FILES.get(name, ()):
        for src in glob.glob(os.path.join(out_dir, name, "*", "job*",
                                          fname)):
            dest = os.path.join(archive_dir,
                                os.path.relpath(src, out_dir))
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            shutil.copy2(src, dest)
            out.append(dest)
    return out


def run_meta(device) -> dict:
    """The card (``nvidia-smi`` name and power limit), versions, source
    revision and date."""
    from mdqtplasmasims_torch.profiling import card_name
    card = card_name(device)
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                             capture_output=True, text=True, timeout=30,
                             check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        rev = "archive"
    return dict(card=card, device=(torch.cuda.get_device_name(0)
                                   if card != "cpu" else "cpu"),
                torch=torch.__version__, cuda=torch.version.cuda, git=rev,
                date=time.strftime("%Y-%m-%d"))


def update_summary(path: str, family: str, metrics: dict,
                   meta: dict) -> None:
    """Write one entry (and ``_meta``) into the summary at once, atomically,
    keeping the entries already there."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cur = {}
    if os.path.exists(path):
        with open(path) as f:
            cur = json.load(f)
    cur[family] = metrics
    cur["_meta"] = meta
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cur, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    print(f"[soak] {family}: {json.dumps(metrics)}", flush=True)


def _union_us(ops) -> float:
    """Microseconds covered by the union of the events' intervals."""
    busy, end = 0.0, float("-inf")
    for e in sorted(ops, key=lambda e: e["ts"]):
        a, b = max(e["ts"], end), e["ts"] + e["dur"]
        busy += max(0.0, b - a)
        end = max(end, b)
    return busy


def _top_ops(ops, n_top: int) -> list:
    by_name = {}
    for e in ops:
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n_top]
    return [dict(name=k[:120], count=n, ms=t / 1e3) for k, (n, t) in top]


# the host's waits for a card in a trace's CUDA runtime events (a tensor's
# .item() or .cpu() is a copy and a stream synchronize)
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def trace_breakdown(events, steps: int, n_top: int = 5) -> dict:
    """A Chrome trace's ``traceEvents`` of ``steps`` steps: the window,
    the device operations' busy share and top ``n_top``, the host's waits
    for a card and the copies to the host per step, and per card
    (``cards``, by the device index the kernel events carry) its busy
    share, its first and last kernel and its own top operations;
    ``common_ms`` is the window in which every card had begun and none
    had finished its kernels."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ops = [e for e in spans if e.get("cat") in ("kernel", "gpu_memcpy",
                                                "gpu_memset")]
    t_lo = min((e["ts"] for e in spans), default=0.0)
    t_hi = max((e["ts"] + e["dur"] for e in spans), default=0.0)
    window = t_hi - t_lo
    busy = _union_us(ops)
    per = {}
    for e in ops:
        if "device" in e.get("args", {}):
            per.setdefault(int(e["args"]["device"]), []).append(e)
    cards = {}
    for d, evs in sorted(per.items()):
        kernels = [e for e in evs if e.get("cat") == "kernel"] or evs
        first = min(e["ts"] for e in kernels)
        last = max(e["ts"] + e["dur"] for e in kernels)
        b = _union_us(evs)
        cards[str(d)] = dict(busy_ms=b / 1e3,
                             busy_share=b / window if window else 0.0,
                             first_ms=(first - t_lo) / 1e3,
                             last_ms=(last - t_lo) / 1e3,
                             ops_per_step=len(evs) / steps,
                             top=_top_ops(evs, n_top))
    common = (min(c["last_ms"] for c in cards.values())
              - max(c["first_ms"] for c in cards.values())) if cards else 0.0
    waits = sum(1 for e in spans if e.get("name") in HOST_WAITS)
    dtoh = sum(1 for e in ops if "DtoH" in e.get("name", "")
               or "Device -> Pageable" in e.get("name", "")
               or "Device -> Pinned" in e.get("name", ""))
    return dict(steps=steps, window_ms=window / 1e3, busy_ms=busy / 1e3,
                busy_share=busy / window if window else 0.0,
                device_ops_per_step=len(ops) / steps,
                device_us_per_step=busy / steps,
                host_waits_per_step=waits / steps,
                copies_to_host_per_step=dtoh / steps,
                top=_top_ops(ops, n_top), cards=cards,
                common_ms=max(0.0, common),
                common_share=max(0.0, common) * 1e3 / window if window
                else 0.0)


def _trace(device, fn, steps: int, n_top: int = 5) -> dict:
    """``fn()`` untraced, then under ``profiling.device_trace``: its host
    ms per step and :func:`trace_breakdown` of the traced run."""
    from mdqtplasmasims_torch.profiling import device_trace
    _, untraced, _ = _timed(device, fn)
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp, device=device):
            fn()
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    return dict(untraced_ms_per_step=1e3 * untraced / steps,
                **trace_breakdown(events, steps, n_top))


def trace_chain(steps: int, device="cuda") -> dict:
    """:func:`_trace` over ``steps`` Metropolis steps of one transport job
    (n = 4096 from the lattice start)."""
    from mdqtplasmasims_torch.core.init import lattice_init
    from mdqtplasmasims_torch.core.mc import MetropolisMC, draw_mc
    from mdqtplasmasims_torch.experiments.mc_md_anisotropy import (
        MCTransportConfig)
    cfg = MCTransportConfig(n=MC_N)
    g = torch.Generator(device=torch.device(device)).manual_seed(1)
    R, _ = lattice_init(g, cfg.n, cfg.gamma, cfg.L)
    mc = MetropolisMC(L=cfg.L, ldeb=cfg.ldeb, gamma=cfg.gamma,
                      max_r_step=cfg.max_r_step)
    R, _ = mc.run(R[None].contiguous(), draws=draw_mc([g], 20, cfg.n))
    draws = draw_mc([g], steps, cfg.n)
    return dict(n=cfg.n, **_trace(device, lambda: mc.run(R, draws=draws),
                                  steps))


def trace_md(steps: int, device="cuda", n0: int = 14000) -> dict:
    """:func:`_trace` over ``steps`` MD steps (one sample, no tree) of the
    ``cooling_n14000`` configuration: kernels A and B'rng at N0 = 14000."""
    from mdqtplasmasims_torch.experiments.laser_cooling import run
    cfg = cooling_config(None, n0=n0, sample_freq=steps)
    cfg = dataclasses.replace(cfg, tmax=steps * cfg.timestep)
    run(dataclasses.replace(cfg, tmax=cfg.timestep, sample_freq=1),
        device=device)                                        # warm-up
    return dict(n0=n0, **_trace(device, lambda: run(cfg, device=device),
                                steps))


def trace_three_state(launches: int, device="cuda", n0: int = 1000,
                      **over) -> dict:
    """:func:`_trace` over ``launches`` blocks of ticks (one tick-kernel
    launch each, no tree) of the ``three_state`` configuration."""
    from mdqtplasmasims_torch.experiments.three_state import (
        ThreeStateConfig, run)
    cfg = ThreeStateConfig(**dict(dict(n0=n0), **over))
    cfg = dataclasses.replace(cfg, tmax=launches * cfg.sample_freq * cfg.dt)
    run(dataclasses.replace(cfg, tmax=cfg.sample_freq * cfg.dt),
        device=device)                                        # warm-up
    return dict(n0=n0, **_trace(device, lambda: run(cfg, device=device),
                                launches))


def closest_pairs(R: torch.Tensor, L: float) -> list:
    """Each member's closest pair of ions under minimum image, ``R [E, n,
    3]`` in a cell of side ``L`` (one member's distance matrix at a
    time)."""
    out = []
    for x in R:
        d = x[:, None, :] - x[None, :, :]
        r2 = (d - L * torch.round(d / L)).square().sum(-1)
        r2.fill_diagonal_(float("inf"))
        out.append(float(r2.min().sqrt()))
    return out


def campaign99(out_dir, device="cuda", n_jobs: int = 99, **over) -> dict:
    """The reference's 99-job campaign, ``tools/torch_campaign99.py``'s
    :func:`campaign_run` (no trees; ``over``: CoolingConfig overrides),
    with two per-member diagnostics beside the JAX script's
    numbers: ``ekin_x_final``, each member's EkinX at the last sample (the
    values whose standard deviation is ``job_spread_t30``), and
    ``start_closest_pair``, the closest pair of ions in each member's
    start (the same draws, ``member_states``, made again after the run):
    a uniform frozen-gas start that puts two ions within ~0.01 a of each
    other gives them a Coulomb energy that its member's EkinX carries to
    the end."""
    import torch_campaign99 as tc
    from mdqtplasmasims_torch.experiments.laser_cooling import member_states
    from mdqtplasmasims_torch.units import PlasmaUnits
    m, _, outs = tc.campaign_run(device, n_jobs, **over)
    cfg = tc.campaign_config(**over)
    start = member_states(cfg, n_jobs, tc.SEED, device)
    return dict(m, ekin_x_final=np.asarray(outs["ekin"])[:, -1, 0].tolist(),
                start_closest_pair=closest_pairs(
                    start.R, PlasmaUnits.box_length(cfg.n0)))


def trace_campaign99(segments: int = 10, device="cuda",
                     n_jobs: int = 99, **over) -> dict:
    """:func:`_trace` over ``segments`` output segments of the campaign
    (one group of ``checkpoint_every_segments`` = 10 uncut: 400 MD steps
    of the 99-member fold, its samples and its fetch), the ten device
    operations that took most time, and ``start_s``, the host seconds of
    the fold's start (``member_states``: the members drawn one by one)."""
    import torch_campaign99 as tc
    from mdqtplasmasims_torch.experiments.laser_cooling import member_states
    cfg = tc.campaign_config(**over)
    seg = cfg.sample_freq * cfg.timestep

    def run(k):
        return tc.campaign(device, n_jobs, tc.SEED,
                           **dict(over, tmax=k * seg))
    run(1)                                                    # warm-up
    _, start_s, _ = _timed(device, lambda: member_states(
        cfg, n_jobs, tc.SEED, device))
    return dict(n_jobs=n_jobs, n0=cfg.n0, segments=segments,
                start_s=start_s,
                **_trace(device, lambda: run(segments),
                         segments * cfg.sample_freq, n_top=10))


# diagnostics, run only when named; stored as ``_<name>``
EXTRAS = {
    "chain_trace": lambda out_dir: trace_chain(300),
    "md_trace_n14000": lambda out_dir: trace_md(200),
    "three_state_trace": lambda out_dir: trace_three_state(200),
    "tag_pool": tag_pool,
    "xval_408quad": xval_408quad,
    "three_state_seeds": three_state_seeds,
    "campaign99": campaign99,
    "campaign99_trace": lambda out_dir: trace_campaign99(),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("names", nargs="*", metavar="family",
                   help=f"families among {', '.join(FAMILIES)} (default: "
                   f"all of them) or diagnostics among "
                   f"{', '.join(EXTRAS)}")
    p.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(),
                                                     "soak_torch"),
                   help="where the .dat trees go (default: %(default)s)")
    p.add_argument("--summary", default=SUMMARY,
                   help="the summary to update (default: %(default)s)")
    p.add_argument("--archive-dir", default=ARCHIVE,
                   help="where the families' archived files go (default: "
                   "%(default)s)")
    args = p.parse_args(argv)
    unknown = sorted(set(args.names) - set(FAMILIES) - set(EXTRAS))
    if unknown:
        p.error(f"unknown names {unknown}")
    if not torch.cuda.is_available():
        print("torch_soak: no CUDA device; the soak runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meta = run_meta("cuda")
    print(f"[soak] card: {meta['card']}; torch {meta['torch']}, CUDA "
          f"{meta['cuda']}; source {meta['git']}; libraries built in "
          f"{build_libraries():.1f} s", flush=True)
    for name in args.names or DEFAULT_FAMILIES:
        print(f"[soak] running {name} ...", flush=True)
        t0 = time.perf_counter()
        if name in FAMILIES:
            update_summary(args.summary, name,
                           FAMILIES[name](args.out_dir, device="cuda"), meta)
            for path in archive_files(name, args.out_dir, args.archive_dir):
                print(f"[soak] archived {path} ({os.path.getsize(path)} B)",
                      flush=True)
        else:
            update_summary(args.summary, "_" + name,
                           EXTRAS[name](args.out_dir), meta)
        print(f"[soak] {name} done in {time.perf_counter() - t0:.1f} s "
              f"({meta['card']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
