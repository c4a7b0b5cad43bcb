#!/usr/bin/env python3
"""The port's device mesh on distinct cards: the JAX package's multi-chip
layouts (``mdqtplasmasims_tpu/parallel``; README.md's ``run_ensemble(cfg,
n_jobs=32, mesh=make_mesh())``, the ion-sharded gather and half-ring
schedules, the share-nothing families' member axis) run by
``mdqtplasmasims_torch`` on every visible CUDA card, each held bit for bit
to the same call with its slots on one card.

    python tools/torch_mesh_cards.py [--out DIR] [--sections S ...]

Every mesh here has four slots, slot j on card ``j mod n_cards``: on four
cards each slot has a card of its own.  The sections, in order:

- ``bitwise``: the cooling mesh (a) ens-only ``4 x 1`` (8 jobs, N0 =
  3500, tmax = 1); (b) ion-sharded ``2 x 2`` (2 jobs, N0 = 3500) and
  ``1 x 4`` (one member, N0 = 14000, 250 MD steps), ``gather`` and
  ``ring_n3l``; (c) checkpoints: a four-card checkpoint resumed on the
  cards (against the uninterrupted run on the cards) and as a one-card
  fold, and a one-card fold's checkpoint resumed on the cards (and a
  ``2 x 2`` gather window resumed on the cards); (d) the CLI's
  ``cooling-ensemble --mesh-ens K --device cuda`` (K the cards) against
  the same command without ``--mesh-ens``, tree for tree.  (a) and (b)
  are held to the same call with the mesh's slots on card 0, (a), (c)
  and (d) to the unsharded run as well: the force kernels' column split
  (``ops.yukawa.pair_split``) does not depend on a fold's width, so a
  member has the same bits in a slot's block and in the whole fold.
- ``share_nothing``: each share-nothing family (frozen tagging, the
  three-state toy, transport, MC tagging) at a cut depth as a ``4 x 1``
  fold on the cards (``member_sharded``: a worker process a slot for the
  folds that end in host fetches, the toy's single launches in turn),
  against the same fold on one card, bit for bit, and against the
  unsharded fold (where they differ: ``unsharded_fold``).
- ``production``: ``tools/torch_soak.py``'s ``cooling_mesh_ensemble``
  (32 jobs, 8 a slot, N0 = 3500, tmax = 30, trees and checkpoints every
  75 segments), ``cooling_ion_mesh`` (the ``cooling_n14000`` run on a
  ``1 x 4`` ion mesh, ``gather`` and ``ring_n3l``), ``frozen_fold`` (the
  ``frozen`` job as a fold of 8) and ``transport_fold`` (a fold of 4 cut
  to 2000 Metropolis steps, the production MD stages kept), each on the
  cards and (each run named in ``one_card``) with every slot on card 0,
  held to the bands of
  ``tests/test_physics_targets.py::TestFullScaleSoak`` against the
  port's archived one-card ``cooling`` entry
  (``artifacts/soak_torch/summary.json``).
- ``traces``: ``profiling.device_trace`` over 200 MD steps of the
  ``4 x 1`` (32 jobs) and ``1 x 4`` (N0 = 14000, gather) cooling meshes'
  production loop (``run_compiled_sharded``) and over a frozen fold of 8
  cut to tmax = 2 on the cards: per card its busy share, first and last
  operation and top operations, the host ms per MD step, the host's waits
  for a card per MD step; for the frozen fold the window in which all
  cards worked at once.

``report.json`` (in ``--out``, default ``artifacts/mesh_cards_torch``) is
written after every section; it holds every card's ``nvidia-smi`` name
and power limit, the peer-access map and ``nvidia-smi topo -m``, each
run's wall and launches, ``bitwise`` flags, ``bands`` and ``ok``.  Exits
2 with fewer than two distinct CUDA devices, 1 when a flag or a band
fails.  ``--device cpu`` runs the sections on four repeated CPU slots
(the tests' form, at the sizes they give).  Imports torch, numpy and
``mdqtplasmasims_torch`` only.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
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
for _p in (ROOT, os.path.join(ROOT, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch_soak as soak  # noqa: E402

REPORT_DIR = os.path.join(ROOT, "artifacts", "mesh_cards_torch")
SLOTS = 4
SEED = 5

# chip_smoke.py's transport cut (2000 MC steps, 751 MD steps)
TRANSPORT_CUT = dict(mc_steps=2000, gr_every_mc=1000,
                     pre_record_md_steps=100, record_steps=200,
                     gr_every_record=100, instant_aniso_steps=200,
                     reequil_steps=100, aniso_time_us=0.5,
                     aniso_relax_steps=100)

#: the sizes of every section (the tests pass smaller ones)
SIZES = dict(
    ens=dict(cfg=dict(n0=3500, tmax=1.0), n_jobs=8),
    ions=(dict(K=2, I=2, n_jobs=2, cfg=dict(n0=3500, tmax=1.0)),
          dict(K=1, I=4, n_jobs=1, cfg=dict(n0=14000, tmax=0.5))),
    resume=dict(cfg=dict(n0=3500, tmax=1.0, checkpoint_every_segments=3),
                half=0.5, n_jobs=8, ions_jobs=2),
    cli=dict(args=("--n0", "3500", "--tmax", "0.4",
                   "--checkpoint-every-segments", "5"), jobs_per_card=2),
    share_nothing=dict(
        frozen_tagging=(dict(n0=3500, tstart=0.3, tmax=1.0), 8),
        three_state=(dict(n0=1000, tmax=200.0), 8),
        transport=(dict(n=4096, **TRANSPORT_CUT), 4),
        mc_tagging=(dict(variant="408quad", n=4096, mc_steps=2000,
                         record_steps=200), 4)),
    production=dict(cooling_mesh={}, jobs_per_slot=8, n14000={}, frozen={},
                    frozen_jobs=8,
                    transport=dict(mc_steps=2000, gr_every_mc=1000),
                    transport_jobs=4,
                    # the runs also taken with every slot on card 0 (the
                    # 32-job ensemble's 125 s there is left out)
                    one_card=("cooling_n14000", "frozen_fold",
                              "transport_fold")),
    traces=dict(steps=200, ens=dict(n_jobs=32, cfg=dict(n0=3500)),
                ions=dict(n_jobs=1, cfg=dict(n0=14000)),
                frozen=dict(tstart=1.0, tmax=2.0), frozen_jobs=8),
)

# tests/test_physics_targets.py::TestFullScaleSoak's bands against the
# archived one-card ``cooling`` entry: test_cooling_mesh_ensemble (:282)
# and test_cooling_beyond_reference_scale (:292); test_frozen_tagging's
# tag fraction (:306)
MESH_ENSEMBLE_BANDS = dict(dih_peak_t=0.5, cooling_ratio=0.08)
N14000_BANDS = dict(dih_peak_ekin_x=0.02, cooling_ratio=0.06, pop_s=0.03)
N14000_WALL_S = 900.0
TAG_FRACTION = (0.30, 0.55)
# the acceptance of concurrency: every card ran kernels in one window of
# at least this share of the traced frozen fold's span
COMMON_SHARE = 0.5


# ---- helpers

def cards_of(device) -> list:
    """The distinct devices the meshes use: every visible card, or the
    one CPU device."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", j)
                for j in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def slot_devices(cards, n: int = SLOTS) -> list:
    """Slot j of an ``n``-slot mesh on card ``j mod len(cards)``."""
    return [cards[j % len(cards)] for j in range(n)]


def same(a, b) -> bool:
    """Bit for bit equality of two results (arrays by their bytes, dicts,
    lists, tuples and NamedTuples item by item)."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == b.keys() and all(same(a[k], b[k])
                                                 for k in a))
    if torch.is_tensor(a) or torch.is_tensor(b):
        return same(torch.as_tensor(a).cpu().numpy(),
                    torch.as_tensor(b).cpu().numpy())
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        x, y = np.asarray(a), np.asarray(b)
        return (x.dtype == y.dtype and x.shape == y.shape
                and x.tobytes() == y.tobytes())
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
                and len(a) == len(b) and all(same(x, y)
                                             for x, y in zip(a, b)))
    return bool(a == b) or (a != a and b != b)          # NaN == NaN


def differ(a, b, path="") -> list:
    """``(path, max |a - b|)`` of every array where two results of one
    structure differ (None where the values do not subtract)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return [d for k in a for d in differ(a[k], b.get(k), f"{path}.{k}")]
    if (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
            and len(a) == len(b)):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in differ(x, y, f"{path}[{i}]")]
    if same(a, b):
        return []
    try:
        x = torch.as_tensor(a).cpu().double()
        y = torch.as_tensor(b).cpu().double()
        return [(path, float((x - y).abs().max()))]
    except (TypeError, ValueError, RuntimeError):
        return [(path, None)]


def same_trees(a: str, b: str, common_only: bool = False) -> dict:
    """Two directory trees file for file: ``equal`` when every file (with
    ``common_only``, every file both hold) has the same bytes."""
    def files(root):
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, fs in os.walk(root) for f in fs}
    fa, fb = files(a), files(b)
    names = sorted(fa & fb) if common_only else sorted(fa | fb)
    differ = []
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if not (os.path.exists(pa) and os.path.exists(pb)):
            differ.append(name)
            continue
        with open(pa, "rb") as f, open(pb, "rb") as g:
            if f.read() != g.read():
                differ.append(name)
    return dict(equal=bool(names) and not differ, files=len(names),
                differ=differ[:10])


# ---- section 1: the cooling mesh, bit for bit

def _cooling_cfg(**kw):
    from mdqtplasmasims_torch.experiments.laser_cooling import CoolingConfig
    return CoolingConfig(**kw)


def _final_and_outs(res):
    final, outs = res
    return dict(final={k: getattr(final, k)
                       for k in ("R", "V", "psi", "t_part")}, outs=outs)


def ens_only(cards, sizes) -> dict:
    """(a) ``4 x 1`` on the cards vs the same mesh on one card and vs the
    unsharded fold, bit for bit."""
    from mdqtplasmasims_torch.experiments.laser_cooling import run_ensemble
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    home, s = cards[0], sizes["ens"]
    cfg = _cooling_cfg(**s["cfg"])
    kinds = dict(cards=dict(mesh=make_mesh(4, 1, slot_devices(cards))),
                 one_card=dict(mesh=make_mesh(4, 1, [home] * SLOTS)),
                 fold=dict(device=home))
    runs, rec = {}, {}
    for name, kw in kinds.items():
        res, wall, launches = soak._timed(home, lambda kw=kw: run_ensemble(
            cfg, s["n_jobs"], seed=SEED, **kw))
        runs[name] = _final_and_outs(res)
        rec[name] = dict(wall_s=wall, launches=launches)
    return dict(config=dict(s["cfg"], n_jobs=s["n_jobs"], mesh="4x1"),
                runs=rec,
                bitwise_cards_vs_one_card=same(runs["cards"],
                                               runs["one_card"]),
                bitwise_cards_vs_fold=same(runs["cards"], runs["fold"]))


def ion_sharded(cards, sizes) -> dict:
    """(b) the ion-sharded meshes, gather and ring-N3L, on the cards vs
    on one card."""
    from mdqtplasmasims_torch.experiments.laser_cooling import run_ensemble
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    home, out = cards[0], {}
    for s in sizes["ions"]:
        K, I = s["K"], s["I"]
        cfg = _cooling_cfg(**s["cfg"])
        for form in ("gather", "ring_n3l"):
            runs, rec = {}, {}
            for name, devs in (("cards", slot_devices(cards, K * I)),
                               ("one_card", [home] * (K * I))):
                mesh = make_mesh(K, I, devs)
                res, wall, launches = soak._timed(home, lambda mesh=mesh: (
                    run_ensemble(cfg, s["n_jobs"], seed=SEED, mesh=mesh,
                                 ion_forces=form)))
                runs[name] = _final_and_outs(res)
                rec[name] = dict(wall_s=wall, launches=launches)
            out[f"{K}x{I}_{form}"] = dict(
                config=dict(s["cfg"], n_jobs=s["n_jobs"], mesh=f"{K}x{I}",
                            ion_forces=form),
                runs=rec,
                bitwise_cards_vs_one_card=same(runs["cards"],
                                               runs["one_card"]))
    return out


def checkpoints(cards, sizes, work) -> dict:
    """(c) a window to ``half * tmax`` resumed to tmax: written on the
    cards and resumed on the cards, or as a one-card fold; written by a
    one-card fold and resumed on the cards.  Each crossing is held to the
    uninterrupted run on the cards (final state, and every file the two
    trees both hold), as is the uninterrupted fold; the same for a ``2 x
    2`` gather mesh written and resumed on the cards."""
    from mdqtplasmasims_torch.experiments.laser_cooling import run_ensemble
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    home, s = cards[0], sizes["resume"]
    base = _cooling_cfg(**s["cfg"])
    half = dataclasses.replace(base, tmax=base.tmax * s["half"])
    meshes = {"cards": make_mesh(4, 1, slot_devices(cards)), "fold": None}
    root = os.path.join(work, "resume")

    def d(name):
        p = os.path.join(root, name)
        shutil.rmtree(p, ignore_errors=True)
        return p

    def go(cfg, name, n_jobs, mesh, resume=False):
        return run_ensemble(dataclasses.replace(
            cfg, save_directory=os.path.join(root, name)), n_jobs,
            seed=SEED, resume=resume, mesh=mesh, device=home)

    def final(res):
        return _final_and_outs(res)["final"]

    def check(name, ref_name, res, ref):
        trees = same_trees(os.path.join(root, ref_name),
                           os.path.join(root, name), common_only=True)
        return dict(trees=trees, bitwise_final=same(final(res), ref),
                    bitwise_common_files=trees["equal"])

    E, E2 = s["n_jobs"], s["ions_jobs"]
    ends = {}
    for layout in meshes:
        d(f"full_{layout}")
        ends[layout] = go(base, f"full_{layout}", E, meshes[layout])
        d(f"half_{layout}")
        go(half, f"half_{layout}", E, meshes[layout])
    out = {"uninterrupted_fold": check("full_fold", "full_cards",
                                       ends["fold"], final(ends["cards"]))}
    # name: (written by, resumed on)
    for name, (src, dst) in (("cards_to_cards", ("cards", "cards")),
                             ("cards_to_fold", ("cards", "fold")),
                             ("fold_to_cards", ("fold", "cards"))):
        shutil.copytree(os.path.join(root, f"half_{src}"), d(name))
        res, wall, launches = soak._timed(home, lambda name=name, dst=dst: go(
            base, name, E, meshes[dst], resume=True))
        out[name] = dict(check(name, "full_cards", res, final(ends["cards"])),
                         wall_s=wall, launches=launches)
    m22 = make_mesh(2, 2, slot_devices(cards))
    ref22 = final(go(base, d("full_2x2"), E2, m22))
    go(half, d("cards_2x2"), E2, m22)
    res = go(base, "cards_2x2", E2, m22, resume=True)
    out["cards_to_cards_2x2_gather"] = check("cards_2x2", "full_2x2", res,
                                             ref22)
    return dict(config=dict(s["cfg"], half_tmax=half.tmax, n_jobs=E,
                            n_jobs_2x2=E2), cases=out)


def cli_tree(cards, sizes, work, device) -> dict:
    """(d) ``cooling-ensemble --mesh-ens K --device cuda`` (K the distinct
    cards, 2 K jobs) against the same command without ``--mesh-ens``:
    both trees byte for byte.  On the CPU the mesh is K = 4 CPU slots and
    each command runs with ``--device cpu``."""
    from mdqtplasmasims_torch import cli
    s = sizes["cli"]
    on_cards = torch.device(device).type == "cuda"
    K = len(cards) if on_cards else SLOTS
    jobs = s["jobs_per_card"] * K
    dev = "cuda" if on_cards else str(device)
    runs, dirs = {}, {}
    for name, extra in (("cards", ["--mesh-ens", str(K)]), ("fold", [])):
        dirs[name] = os.path.join(work, "cli", name)
        shutil.rmtree(dirs[name], ignore_errors=True)
        argv = ["cooling-ensemble", *s["args"], "--jobs", str(jobs),
                "--seed", str(SEED), "--save-directory", dirs[name],
                "--device", dev, *extra]
        _, wall, launches = soak._timed(device,
                                        lambda argv=argv: cli.main(argv))
        runs[name] = dict(argv=argv, wall_s=wall, launches=launches)
    trees = same_trees(dirs["cards"], dirs["fold"])
    return dict(mesh_ens=K, jobs=jobs, runs=runs, trees=trees,
                bitwise_tree=trees["equal"])


def bitwise_section(cards, sizes, work, device) -> dict:
    return dict(a_ens_only=ens_only(cards, sizes),
                b_ion_sharded=ion_sharded(cards, sizes),
                c_checkpoints=checkpoints(cards, sizes, work),
                d_cli=cli_tree(cards, sizes, work, device))


# ---- section 2: the share-nothing families

def _family(name):
    from mdqtplasmasims_torch.experiments import (frozen_tagging,
                                                  mc_md_anisotropy,
                                                  mc_qt_tagging, three_state)
    return {"frozen_tagging": (frozen_tagging,
                               frozen_tagging.FrozenTagConfig),
            "three_state": (three_state, three_state.ThreeStateConfig),
            "transport": (mc_md_anisotropy,
                          mc_md_anisotropy.MCTransportConfig),
            "mc_tagging": (mc_qt_tagging, mc_qt_tagging.MCTagConfig)}[name]


def share_nothing_section(cards, sizes, work, device) -> dict:
    """Each family's ``run_ensemble`` as a ``4 x 1`` fold on the cards
    against the same fold on one card, bit for bit; and where (and by how
    much) it differs from the unsharded fold (``unsharded_fold``: on a
    card a slot's block takes its members' sums over ions with torch's
    reductions over its own ``[E, n]`` tensors, whose thread layout
    follows E, so the reduced outputs can differ in the last bits).
    The slots' worker processes are started first, their start timed
    apart (``workers_start_s``)."""
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    from mdqtplasmasims_torch.parallel.ensemble import start_workers
    home, out = cards[0], {}
    mesh = make_mesh(4, 1, slot_devices(cards))
    workers_s = start_workers(mesh)
    for name, (over, n_jobs) in sizes["share_nothing"].items():
        module, cls = _family(name)
        cfg = cls(**over)
        runs, rec = {}, {}
        for kind, kw in (
                ("cards", dict(mesh=mesh)),
                ("one_card", dict(mesh=make_mesh(4, 1, [home] * SLOTS))),
                ("fold", dict(device=home))):
            runs[kind], wall, launches = soak._timed(
                home, lambda kw=kw: module.run_ensemble(
                    cfg, n_jobs, seed=SEED, **kw))
            rec[kind] = dict(wall_s=wall, launches=launches)
        diffs = differ(runs["cards"], runs["fold"])
        out[name] = dict(config=dict(over, n_jobs=n_jobs), runs=rec,
                         bitwise_cards_vs_one_card=same(runs["cards"],
                                                        runs["one_card"]),
                         unsharded_fold=dict(equal=not diffs,
                                             differ=diffs[:20]))
    return dict(workers_start_s=workers_s, families=out)


# ---- section 3: the production layouts

def _band(value, ref, limit) -> dict:
    return dict(value=value, archived=ref, limit=limit,
                ok=bool(abs(value - ref) < limit))


def archived_cooling() -> dict:
    """The port's archived one-card ``cooling`` soak entry."""
    with open(soak.SUMMARY) as f:
        return json.load(f)["cooling"]


def production_section(cards, sizes, work, device) -> dict:
    """The JAX package's multi-chip layouts at full size on the cards and
    with every slot on card 0, with the bands."""
    from mdqtplasmasims_torch.parallel.ensemble import start_workers
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    home, p = cards[0], sizes["production"]
    on = dict(cards=slot_devices(cards), one_card=[home] * SLOTS)
    workers_s = start_workers(make_mesh(4, 1, on["cards"]))
    ref = archived_cooling()

    def kinds(run):
        return ("cards", "one_card") if run in p["one_card"] else ("cards",)
    out = dict(cooling_mesh_ensemble={}, cooling_n14000={}, frozen_fold={},
               transport_fold={})
    for kind in kinds("cooling_mesh_ensemble"):
        out["cooling_mesh_ensemble"][kind] = soak.soak_cooling_mesh_ensemble(
            work, device, devices=on[kind], jobs_per_slot=p["jobs_per_slot"],
            **p["cooling_mesh"])
    for form in ("gather", "ring_n3l"):
        out["cooling_n14000"][form] = {
            kind: soak.cooling_ion_mesh(work, device, devices=on[kind],
                                        ion_forces=form, **p["n14000"])
            for kind in kinds("cooling_n14000")}
    for kind in kinds("frozen_fold"):
        out["frozen_fold"][kind] = soak.frozen_fold(
            work, device, p["frozen_jobs"], devices=on[kind], **p["frozen"])
    for kind in kinds("transport_fold"):
        out["transport_fold"][kind] = soak.transport_fold(
            work, device, p["transport_jobs"], devices=on[kind],
            **p["transport"])
    bands = {}
    for kind in kinds("cooling_mesh_ensemble"):
        m = out["cooling_mesh_ensemble"][kind]
        bands[f"cooling_mesh_ensemble_{kind}"] = dict(
            {k: _band(m[k], ref[k], lim)
             for k, lim in MESH_ENSEMBLE_BANDS.items()},
            n_jobs=dict(value=m["n_jobs"], ok=m["n_jobs"] >= 8))
    for kind in kinds("cooling_n14000"):
        for form in ("gather", "ring_n3l"):
            b = out["cooling_n14000"][form][kind]
            bands[f"cooling_n14000_{form}_{kind}"] = dict(
                {k: _band(b[k], ref[k], lim)
                 for k, lim in N14000_BANDS.items()},
                wall_s=dict(value=b["wall_s"], limit=N14000_WALL_S,
                            ok=b["wall_s"] < N14000_WALL_S))
    for kind in kinds("frozen_fold"):
        fr = out["frozen_fold"][kind]["member_fractions"]
        bands[f"frozen_fold_{kind}"] = dict(tag_fraction=dict(
            value=fr, limit=TAG_FRACTION,
            ok=all(TAG_FRACTION[0] < x < TAG_FRACTION[1] for x in fr)))
    out["bands"] = bands
    out["workers_start_s"] = workers_s
    out["archived_cooling"] = {k: ref[k] for k in (
        "dih_peak_t", "dih_peak_ekin_x", "cooling_ratio", "pop_s", "wall_s")}
    if "frozen_fold" in p["one_card"]:
        out["bitwise_frozen_cards_vs_one_card"] = (
            out["frozen_fold"]["cards"]["member_fractions"]
            == out["frozen_fold"]["one_card"]["member_fractions"])
    if "transport_fold" in p["one_card"]:
        out["bitwise_transport_cards_vs_one_card"] = same(
            out["transport_fold"]["cards"]["members"],
            out["transport_fold"]["one_card"]["members"])
    return out


# ---- section 4: traces

def cooling_mesh_trace(cards, K, I, n_jobs, steps, ion_forces="gather",
                       **over) -> dict:
    """``profiling.device_trace`` over ``steps`` MD steps (a sample every
    40) of ``run_compiled_sharded``, the production loop of
    ``run_ensemble(mesh=)``, on a ``K x I`` mesh on the cards."""
    from mdqtplasmasims_torch.core.scheduler import uniform_rolls
    from mdqtplasmasims_torch.experiments import laser_cooling as lc
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    home = cards[0]
    mesh = make_mesh(K, I, slot_devices(cards, K * I))
    cfg = lc.CoolingConfig(**over)
    gen = torch.Generator(device=home).manual_seed(1)
    rng = lc._use_internal_rng(home, None)
    sched = lc.build_scheduler(cfg, home, None if rng else uniform_rolls(gen))
    if rng:
        sched.seed = torch.tensor([1], dtype=torch.int32, device=home)
    states = lc.member_states(cfg, n_jobs, 1, home)
    n_seg = max(1, steps // cfg.sample_freq)
    tr = soak._trace(home, lambda: lc.run_compiled_sharded(
        cfg, sched, mesh, states, n_seg, ion_forces=ion_forces),
        n_seg * cfg.sample_freq)
    return dict(mesh=f"{K}x{I}", n_jobs=n_jobs, n0=cfg.n0,
                ion_forces=ion_forces,
                host_ms_per_md_step=tr["untraced_ms_per_step"], **tr)


def wall_clock_events(path: str) -> list:
    """A Chrome trace's complete events with ``ts`` on the wall clock (us
    since the epoch: the trace's ``baseTimeNanoseconds`` added), so that
    the traces of several processes share one time axis."""
    with open(path) as f:
        trace = json.load(f)
    off = trace.get("baseTimeNanoseconds", 0) / 1e3
    return [dict(e, ts=e["ts"] + off) for e in trace["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def frozen_trace(cards, n_jobs, over) -> dict:
    """The frozen fold of ``n_jobs`` on the ``4 x 1`` mesh of the cards,
    each slot's block traced in its worker process (``worker_traces``),
    the traces merged on the wall clock; a first traced fold starts the
    workers' profilers and is not kept.  ``at_once``: every card ran the
    fold's kernels in one common window of at least
    :data:`COMMON_SHARE` of the traced fold's span (``window_ms``, the
    workers' first event to their last).  ``traced_wall_ms``, the host
    clock around the traced call, also holds the workers' trace export
    and is not the fold's wall; ``untraced_s`` is."""
    from mdqtplasmasims_torch.experiments import frozen_tagging as ft
    from mdqtplasmasims_torch.parallel.ensemble import (start_workers,
                                                        worker_traces)
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    cfg = soak.frozen_config("422linear", None, **over)
    mesh = make_mesh(4, 1, slot_devices(cards))
    workers_s = start_workers(mesh)
    n_md = int(round(cfg.tmax / cfg.timestep))

    def fold():
        return ft.run_ensemble(cfg, n_jobs, seed=1, mesh=mesh)
    _, untraced, launches = soak._timed(cards[0], fold)
    with tempfile.TemporaryDirectory() as tmp:
        with worker_traces(os.path.join(tmp, "warm")):
            fold()
        run_dir = os.path.join(tmp, "run")
        soak.sync_cards(cards[0])
        t0 = time.time_ns()
        with worker_traces(run_dir):
            fold()
        soak.sync_cards(cards[0])
        wall_us = (time.time_ns() - t0) / 1e3
        events = [e for d in (sorted(os.listdir(run_dir))
                              if os.path.isdir(run_dir) else [])
                  for e in wall_clock_events(os.path.join(run_dir, d,
                                                          "trace.json"))]
    tr = soak.trace_breakdown(events, n_md)
    n_cards = len({str(d) for d in cards})
    return dict(n0=cfg.n0, tstart=cfg.tstart, tmax=cfg.tmax, n_jobs=n_jobs,
                workers_start_s=workers_s, untraced_s=untraced,
                launches=launches, traced_wall_ms=wall_us / 1e3, **tr,
                at_once=bool(len(tr["cards"]) == n_cards
                             and tr["common_share"] >= COMMON_SHARE))


def traces_section(cards, sizes, work, device) -> dict:
    t = sizes["traces"]
    return dict(
        cooling_4x1=cooling_mesh_trace(cards, 4, 1, t["ens"]["n_jobs"],
                                       t["steps"], **t["ens"]["cfg"]),
        cooling_1x4=cooling_mesh_trace(cards, 1, 4, t["ions"]["n_jobs"],
                                       t["steps"], **t["ions"]["cfg"]),
        frozen_fold=frozen_trace(cards, t["frozen_jobs"], t["frozen"]))


SECTIONS = dict(bitwise=bitwise_section, share_nothing=share_nothing_section,
                production=production_section, traces=traces_section)


# ---- the report

def card_table(cards) -> list:
    """Each card's index, ``nvidia-smi`` name and power limit and torch
    name; on the CPU one entry named "cpu"."""
    if cards[0].type != "cuda":
        return [dict(index=0, name="cpu", power_limit=None)]
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    out = []
    for row in rows:
        idx, name, limit = (x.strip() for x in row.split(","))
        out.append(dict(index=int(idx), name=name, power_limit=limit,
                        card=f"{name}, {limit}",
                        torch_name=torch.cuda.get_device_name(int(idx))))
    return out


def links(cards) -> dict:
    """Peer access between every ordered pair of cards and the link map
    as ``nvidia-smi topo -m``, ``topo -p2p n`` and ``nvlink -s`` print it
    (each where the machine lets it run)."""
    if cards[0].type != "cuda":
        return dict(peer_access={}, topology="cpu")
    n = len(cards)
    peer = {f"{i}->{j}": bool(torch.cuda.can_device_access_peer(i, j))
            for i in range(n) for j in range(n) if i != j}
    topo = {}
    for args in (("topo", "-m"), ("topo", "-p2p", "n"), ("nvlink", "-s")):
        try:
            topo[" ".join(args)] = subprocess.run(
                ["nvidia-smi", *args], capture_output=True, text=True,
                timeout=60, check=True).stdout
        except (OSError, subprocess.SubprocessError) as e:
            topo[" ".join(args)] = f"unavailable: {e}"
    return dict(peer_access=peer, topology=topo)


def flags(tree, path="") -> dict:
    """Every ``bitwise*`` boolean of the report, by its path."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if not path and k == "flags":
                continue
            p = f"{path}.{k}" if path else k
            if k.startswith("bitwise") and isinstance(v, bool):
                out[p] = v
            else:
                out.update(flags(v, p))
    return out


def band_misses(report) -> list:
    bands = report.get("production", {}).get("bands", {})
    return [f"{run}.{k}" for run, b in bands.items() for k, v in b.items()
            if not v["ok"]]


def write_report(path: str, report: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def run(device="cuda", out_dir=REPORT_DIR, sections=tuple(SECTIONS),
        sizes=None, work=None) -> dict:
    """Run ``sections`` on every card of ``device`` (four CPU slots on the
    CPU) and write ``report.json`` into ``out_dir`` after each; returns
    the report."""
    sizes = copy.deepcopy(SIZES if sizes is None else sizes)
    cards = cards_of(device)
    report = dict(meta=dict(
        devices=card_table(cards), n_devices=len(cards),
        slots=[str(d) for d in slot_devices(cards)], **links(cards),
        torch=torch.__version__, cuda=torch.version.cuda,
        date=time.strftime("%Y-%m-%d"), sections=list(sections)))
    path = os.path.join(out_dir, "report.json")
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        for name in sections:
            t0 = time.perf_counter()
            report[name] = SECTIONS[name](cards, sizes, tmp, device)
            report.setdefault("section_s", {})[name] = (time.perf_counter()
                                                        - t0)
            report["flags"] = flags(report)
            report["band_misses"] = band_misses(report)
            frozen = report.get("traces", {}).get("frozen_fold")
            report["ok"] = (all(report["flags"].values())
                            and not report["band_misses"]
                            and (frozen is None or frozen["at_once"]))
            write_report(path, report)
            false = [k for k, v in report["flags"].items() if not v]
            print(f"[mesh-cards] {name} done in "
                  f"{report['section_s'][name]:.1f} s; flags false: "
                  f"{false}; band misses: {report['band_misses']}",
                  flush=True)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=REPORT_DIR,
                   help="directory of report.json (default: %(default)s)")
    p.add_argument("--sections", nargs="*", default=list(SECTIONS),
                   choices=list(SECTIONS))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda: every visible card (at least two); cpu: "
                   "four CPU slots")
    p.add_argument("--work", default=None,
                   help="where the runs' trees go (a temporary directory "
                   "inside it; default: $TMPDIR)")
    args = p.parse_args(argv)
    if args.device == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 2:
            print(f"torch_mesh_cards: {n} CUDA device(s); the mesh on "
                  "distinct cards needs at least two", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"[mesh-cards] libraries built in {soak.build_libraries():.1f}"
              " s", flush=True)
    report = run(args.device, args.out, tuple(args.sections), work=args.work)
    print(json.dumps(dict(ok=report["ok"], flags_false=[
        k for k, v in report["flags"].items() if not v],
        band_misses=report["band_misses"],
        cards=[d.get("card", d["name"]) for d in report["meta"]["devices"]]
    )))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
