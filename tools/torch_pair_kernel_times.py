#!/usr/bin/env python3
"""Time the PyTorch + CUDA port's kernels (the Yukawa pair kernels A, C, D,
G, E, F of mdqtplasmasims_torch/csrc/yukawa_forces.cu and every form of the
tick kernel B of csrc/fused_ticks.cu) and the runs that launch them, on one
NVIDIA GPU, for one or several source trees in turns.

    python tools/torch_pair_kernel_times.py
    python tools/torch_pair_kernel_times.py --trees OTHER . . OTHER \\
        [--kernels-only] [--flagship] [--bits DIR] [--out times.json]

Each tree is a checkout of this repository (for another commit:
``mkdir OTHER && git archive <commit> | tar -x -C OTHER``).  Every turn is
a fresh process whose working directory is the tree, so it builds and
loads that tree's kernels; two versions are compared inside one command on
one card, in turns (other, this, this, other), never across commands.

A turn calls only the measured tree's public entries (the wrappers of
``ops/yukawa.py``, ``fused_md_substeps`` with the spec and tables of
``build_scheduler``, ``laser_cooling.run``, ``run_ensemble`` and
``run_sweep``, ``make_mesh``), on inputs this script makes, and times them
with this
script's tree's clock (``chip_smoke.cuda_ms``: the median of 30 CUDA-event
timings, the host kept ahead of the card), so a tree measured here needs
nothing but those entries.  It reports
  * ``ms`` of each kernel at the shapes chip_smoke.py uses (A and D: 3500
    ions in 3584 lanes; C and G: an 8-member Poissonian fold; E and F: a
    mesh slot's shapes, 875 ions in 1792 lanes per shard, E row-masked as
    the tree's gather schedule does it: by the kernel where the entry has
    ``row_mask``, else by a multiply after it; ``C_ring``: kernel C on one
    such shard, as the ring schedule launches it; ``C_E99``: the 99-job
    campaign's fold, 99 x 3500 ions in 3584 lanes); the tick kernel from
    an excited start, 25 ticks: ``B`` (explicit rolls) and ``B_rng`` (the
    in-kernel stream) at 3584 lanes, ``B_rng_1792`` on a mesh shard (875
    ions in 1792 lanes, ``lane0`` 1792), the six per-lane forms on a
    4-member fold (``B_e0_E4`` .. ``B_rng_e0_om_E4``), ``B_rng_E8`` and
    ``B_rng_E16`` on folds of 8 and 16 members; the S = 3, 5 and 7 forms
    at their families' main-path shapes (``chip_smoke.small_tick_forms``:
    ``B_s3`` 1000 ions in 1024 lanes x 1000 ticks, its sweep forms
    ``B_s3_e0`` .. ``B_s3_e0_om`` on 4 members x 838 ticks, ``B_s5*`` and
    ``B_s7*``), ``B_s3_32ions`` .. ``B_s7_32ions``, each plain form on 32
    ions, and every S = 5 / 7 form at one tick (``B_s5_T1`` ..) and on a
    fold of 8 members (``B_s5_E8`` ..);
  * ``idle_ms``: ``B`` and ``B_rng`` at 3584 lanes from an idle card (the
    wrapper's host time included, ``chip_smoke.cuda_ms(head_start=False)``);
  * ``wall_s`` (unless ``--kernels-only``): the host-clock seconds of
    ``run(CoolingConfig(n0=3500, tmax=2.0))`` without a .dat tree (best
    and median of 3), of the 8-member Poissonian ``run_ensemble`` to
    tmax=1.0 without trees (best and median of 3), of the 2 x 2
    ``run_sweep`` to tmax=1.0 with trees, and of chip_smoke.py's two 2 x 4
    mesh runs (``run_ensemble`` of 2 members, tmax=1.0, with trees; gather
    and ring-N3L); with ``--flagship`` also ``CoolingConfig()`` (tmax=30)
    once without and once with the .dat tree.

With ``--bits DIR`` each turn also keeps the outputs of every pair-kernel
form on fixed inputs (:func:`pair_bits`), and the last line says, per
form and shape, whether each tree's bits equal the first tree's.

The last line is one JSON object with the card and every turn (``--out``
writes it to a file as well).  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tick_kernel_ms(torch, cs, lc, dev, g) -> tuple:
    """Device ms of every form of the tick kernel (and the idle-card ms of
    the two single-member forms), through ``fused_md_substeps``."""
    import dataclasses
    from mdqtplasmasims_torch.core import qt_fused as tf
    from mdqtplasmasims_torch.core.scheduler import (fold_sweep_lanes,
                                                     uniform_rolls)
    cfg = lc.CoolingConfig()
    seed = torch.tensor([987654321], dtype=torch.int32, device=dev)
    dets = [(-1.0, 1.0), (-0.5, 1.0), (-1.5, 0.6), (-0.8, 1.4)]
    oms = [(1.0, 1.0), (0.8, 1.2), (1.2, 0.7), (0.5, 1.5)]
    sweep_e0 = [lc.build_engine(dataclasses.replace(
        cfg, detuning=a, detuning_dp=b)).scheme.e0 for a, b in dets]

    ms, idle = {}, {}
    forms = [("B", False, False, False, 1, 3584, 3500),
             ("B_rng", True, False, False, 1, 3584, 3500),
             ("B_rng_1792", True, False, False, 1, 1792, 875),
             ("B_rng_E8", True, False, False, 8, 3584, 3500),
             ("B_rng_E16", True, False, False, 16, 3584, 3500)]
    for rng in (False, True):
        for tag, pe0, pom in (("e0", True, False), ("om", False, True),
                              ("e0_om", True, True)):
            forms.append((f"B_{'rng_' if rng else ''}{tag}_E4", rng, pe0, pom,
                          4, 3584, 3500))
    for key, rng, pe0, pom, members, npad, n_real in forms:
        sched = lc.build_scheduler(cfg, dev, None if rng else uniform_rolls(g),
                                   per_lane_e0=pe0, per_lane_om=pom)
        spec = sched.fused_spec
        assert spec.internal_rng == rng
        _, args = cs.excited_planes(torch, g, spec.SP, members, npad, n_real)
        e0p, omp = fold_sweep_lanes(spec, npad, sweep_e0 if pe0 else None,
                                    oms if pom else None, dev)
        kw = dict(tick0=4321, tables=sched.tables, e0_lanes=e0p, om_lanes=omp)
        if rng:
            kw.update(seed=seed, lane0=1792 if npad == 1792 else 0)
        else:
            kw.update(rolls=torch.rand((spec.ratio * 5, members * npad),
                                       generator=g, device=dev))
        fn = lambda: tf.fused_md_substeps(spec, False, *args, **kw)
        ms[key] = cs.cuda_ms(torch, fn)
        if key in ("B", "B_rng"):
            idle[key] = cs.cuda_ms(torch, fn, head_start=False)
    return ms, idle


def small_tick_kernel_ms(torch, cs, dev, g) -> dict:
    """Device ms of the S = 3, 5 and 7 forms of the tick kernel at the
    shapes :func:`chip_smoke.small_tick_forms` gives them, from the start
    its phase 4b uses (free ions, the excited states populated), and of
    the plain S = 3, 5, 7 forms on 32 ions in 128 lanes (``_32ions``);
    the S = 5 and 7 forms also at one tick (``_T1``: the launch's fixed
    part) and on a fold of 8 members (``_E8``; a sweep form's points
    repeated)."""
    import dataclasses
    import itertools
    from mdqtplasmasims_torch.core import qt_fused as tf
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    ms = {}
    forms = list(cs.small_tick_forms().items())
    small = dict(forms)
    for S in (3, 5, 7):
        plain = small[f"fused_ticks_s{S}"]
        forms.append((f"fused_ticks_s{S}_32ions",
                      (plain[0], 1, 32, 128, None, None)))
    for name, form in list(forms):
        spec, E, n, npad, e0, om = form
        if spec.S == 3 or name.endswith("32ions"):
            continue
        forms.append((name + "_T1", (dataclasses.replace(spec, ratio=1), E,
                                     n, npad, e0, om)))
        eight = lambda x: None if x is None else list(
            itertools.islice(itertools.cycle(x), 8))
        forms.append((name + "_E8", (spec, 8, n, npad, eight(e0),
                                     eight(om))))
    for name, (spec, E, n, npad, e0, om) in forms:
        key = "B_" + name[len("fused_ticks_"):].replace("_per_lane", "")
        _, (_, V, _, tp, pre, pim) = cs.excited_planes(
            torch, g, spec.SP, E, npad, n, cs.excited_rows(spec))
        zeros, V = torch.zeros((3, E * npad), device=dev), V * 2.0
        e0p, omp = fold_sweep_lanes(spec, npad, e0, om, dev)
        rolls = torch.rand((spec.ratio * 5, E * npad), generator=g,
                           device=dev)
        tables = tf.fused_tables(spec, dev)
        ms[key] = cs.cuda_ms(torch, lambda: tf.fused_md_substeps(
            spec, False, zeros, V, zeros, tp, pre, pim, rolls,
            tables=tables, e0_lanes=e0p, om_lanes=omp))
    return ms


def pair_bits(torch, ty, dev) -> dict:
    """The outputs of every pair-kernel form on fixed inputs (made on the
    CPU from one seed, so every tree gets the same), at the shapes the
    paths give them: A at 512 and 1792 lanes and the flagship's 3584; C on
    the validation's 16 x 512, the flagship fold of 3 x 256 and 8 x 3584,
    the frozen pools' 8 x 640 (600 ions), the ring shard's 1792 (875
    ions), with holed per-member masks and 1/lambda at 2 x 1920 and 2 x
    2048; D at 3500 ions; G on an 8 x 3500 fold; E and F at a mesh slot's
    shapes."""
    g = torch.Generator().manual_seed(2026)
    L, ldeb = 15.3, 0.9
    cuda = lambda x: x.to(dev).contiguous()

    def fold(e, npad, n):
        m = torch.zeros((1, npad))
        m[0, :n] = 1.0
        R = torch.rand((3, e, npad), generator=g) * L * m
        return cuda(R.reshape(3, e * npad)), cuda(m)

    out = {}
    for npad, n in ((512, 512), (1792, 875), (3584, 3500)):
        Rp, m = fold(1, npad, n)
        out[f"A_{npad}"] = ty.yukawa_forces_n3l_soa(Rp, m, L, ldeb)
    for e, npad, n in ((16, 512, 512), (3, 256, 256), (8, 640, 600),
                       (1, 1792, 875), (8, 3584, 3500)):
        Rp, m = fold(e, npad, n)
        out[f"C_{e}x{npad}"] = ty.yukawa_forces_n3l_soa_batched(Rp, m, e, L,
                                                               ldeb)
    for npad in (1920, 2048):
        m = (torch.rand((2, npad), generator=g) < 0.9).float()
        m[:, 640:704] = 0.0
        Rp = cuda(torch.rand((3, 2 * npad), generator=g) * L)
        il = cuda(torch.tensor([1.0 / ldeb, 1.1 / ldeb]))
        out[f"C_holes_2x{npad}"] = ty.yukawa_forces_n3l_soa_batched(
            Rp, cuda(m), 2, L, ldeb, il)
    R = cuda(torch.rand((3500, 3), generator=g) * L)
    out["D_F"], out["D_pot"] = ty.yukawa_forces_potential_pallas(R, L, ldeb)
    RE = cuda(torch.rand((8, 3500, 3), generator=g) * L)
    out["G_F"], out["G_pot"] = ty.yukawa_forces_potential_pallas_batched(
        RE, L, ldeb)
    rows, rm = fold(1, 1792, 875)
    cols = cuda(torch.rand((1, 4 * 1792, 3), generator=g) * L)
    cm = cuda((torch.rand((1, 4 * 1792), generator=g) < 0.5).float())
    out["E"] = ty.yukawa_forces_soa_cols_batched(rows, cols, cm, 1, L, ldeb)
    out["F_F"], out["F_G"] = ty.yukawa_forces_cross_n3l_soa_batched(
        rows, rm, cols[:, :1792].contiguous(), cm[:, :1792].contiguous(),
        1, L, ldeb)
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def one_turn(kernels_only: bool, flagship: bool = False,
             bits_out: str = None) -> dict:
    """Measure the tree in the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    # the clock and the shard-shaped inputs of this script's own tree
    spec = importlib.util.spec_from_file_location(
        "own_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from mdqtplasmasims_torch.core.init import poisson_member_mask
    from mdqtplasmasims_torch.experiments import laser_cooling as lc
    from mdqtplasmasims_torch.ops import yukawa as ty
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    from mdqtplasmasims_torch.units import PlasmaUnits

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = lc.CoolingConfig()
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    L = PlasmaUnits.box_length(cfg.n0)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(71)
    clock = lambda fn: cs.cuda_ms(torch, fn)
    ms = {}

    n, npad = 3500, 3584
    mask = torch.zeros((1, npad), device=dev)
    mask[0, :n] = 1.0
    Rp = torch.rand((3, npad), generator=g, device=dev) * L * mask
    ms["A"] = clock(lambda: ty.yukawa_forces_n3l_soa(Rp, mask, L, ldeb))
    R = Rp[:, :n].T.contiguous()
    ms["D"] = clock(lambda: ty.yukawa_forces_potential_pallas(R, L, ldeb))

    E = 8
    m, _ = poisson_member_mask(n, E, seed=7)
    members = torch.as_tensor(m, device=dev)
    RE = torch.rand((E, m.shape[1], 3), generator=g, device=dev) * L
    RE = RE * members[..., None]
    npad8 = -(-max(npad, m.shape[1]) // 128) * 128
    masks = torch.zeros((E, npad8), device=dev)
    masks[:, :m.shape[1]] = members
    Rp8 = torch.zeros((3, E, npad8), device=dev)
    Rp8[:, :, :m.shape[1]] = RE.permute(2, 0, 1)
    Rp8 = Rp8.reshape(3, E * npad8)
    ms["C"] = clock(lambda: ty.yukawa_forces_n3l_soa_batched(
        Rp8, masks, E, L, ldeb))
    R99 = (torch.rand((3, 99, npad), generator=g, device=dev) * L
           * mask).reshape(3, 99 * npad)
    ms["C_E99"] = clock(lambda: ty.yukawa_forces_n3l_soa_batched(
        R99, mask, 99, L, ldeb))
    ms["G"] = clock(lambda: ty.yukawa_forces_potential_pallas_batched(
        RE, L, ldeb, mask=members))

    e_loc, shard = cs.MESH_E_LOC, cs.MESH_NPAD
    cols, cmask, _ = cs._shard_blocks(torch, g, L, e_loc, cs.MESH_I, shard)
    A, B = cols[:, :shard].contiguous(), cols[:, shard:2 * shard].contiguous()
    ma, mb = cmask[:1, :shard].contiguous(), cmask[:, shard:2 * shard]
    rows, mb = cs._lanes(A), mb.contiguous()
    cols_entry = ty.yukawa_forces_soa_cols_batched
    if "row_mask" in inspect.signature(cols_entry).parameters:
        ms["E"] = clock(lambda: cols_entry(rows, cols, cmask, e_loc, L, ldeb,
                                           row_mask=ma))
    else:
        ms["E"] = clock(lambda: cols_entry(rows, cols, cmask, e_loc, L, ldeb)
                        * ma)
    ms["F"] = clock(lambda: ty.yukawa_forces_cross_n3l_soa_batched(
        rows, ma, B, mb, e_loc, L, ldeb))
    ms["C_ring"] = clock(lambda: ty.yukawa_forces_n3l_soa_batched(
        rows, ma, e_loc, L, ldeb))
    if bits_out:
        torch.save(pair_bits(torch, ty, dev), bits_out)
    tick_ms, idle = tick_kernel_ms(torch, cs, lc, dev, g)
    ms.update(tick_ms)
    ms.update(small_tick_kernel_ms(torch, cs, dev, g))
    out = dict(ms=ms, idle_ms=idle)
    if kernels_only:
        return out

    wall = {}
    lc.run(lc.CoolingConfig(n0=3500, tmax=0.1), device="cuda")    # warm up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lc.run(lc.CoolingConfig(n0=3500, tmax=2.0), device="cuda")
        times.append(time.perf_counter() - t0)    # run ends in a host fetch
    wall["run_tmax2_best"] = min(times)
    wall["run_tmax2_median"] = statistics.median(times)
    ens = lc.CoolingConfig(n0=3500, tmax=1.0, exact_n=False)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lc.run_ensemble(ens, 8, device="cuda")
        times.append(time.perf_counter() - t0)
    wall["ensemble8_best"] = min(times)
    wall["ensemble8_median"] = statistics.median(times)
    points = [{"detuning": d, "om": o} for d in (-1.0, -0.5)
              for o in (0.8, 1.2)]
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lc.run_sweep(lc.CoolingConfig(n0=3500, tmax=1.0, save_directory=tmp),
                     points, device="cuda")
        wall["sweep_2x2_trees"] = time.perf_counter() - t0
    mesh = make_mesh(cs.MESH_K, cs.MESH_I,
                     devices=[torch.device("cuda", 0)] * 8)
    for ion_forces in ("gather", "ring_n3l"):
        with tempfile.TemporaryDirectory() as tmp:
            mcfg = lc.CoolingConfig(n0=3500, tmax=1.0,
                                    checkpoint_every_segments=6,
                                    save_directory=tmp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lc.run_ensemble(mcfg, 2, seed=5, mesh=mesh,
                            ion_forces=ion_forces)
            wall["mesh_" + ion_forces] = time.perf_counter() - t0
    if flagship:
        with tempfile.TemporaryDirectory() as tmp:
            for key, where in (("flagship_no_tree", None),
                               ("flagship_tree", tmp)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lc.run(lc.CoolingConfig(save_directory=where), device="cuda")
                wall[key] = time.perf_counter() - t0
    out["wall_s"] = wall
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="source trees to measure, in this order")
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--flagship", action="store_true",
                    help="also time CoolingConfig() (tmax=30) without and "
                         "with the .dat tree")
    ap.add_argument("--out", help="also write the result to this file")
    ap.add_argument("--bits", metavar="DIR",
                    help="also keep every pair-kernel form's outputs on "
                         "fixed inputs (pair_bits) of each turn in DIR and "
                         "report which equal the first tree's bit for bit")
    ap.add_argument("--bits-out", help=argparse.SUPPRESS)
    ap.add_argument("--turn", action="store_true",
                    help="measure the working directory's tree (internal)")
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(one_turn(args.kernels_only, args.flagship,
                                  args.bits_out)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    turns = []
    if args.bits:
        os.makedirs(args.bits, exist_ok=True)
    for i, tree in enumerate(args.trees):
        cmd = [sys.executable, os.path.abspath(__file__), "--turn"]
        cmd += [f for f, on in (("--kernels-only", args.kernels_only),
                                ("--flagship", args.flagship)) if on]
        if args.bits:
            cmd += ["--bits-out", os.path.abspath(
                os.path.join(args.bits, f"turn{i}.pt"))]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode or 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res.update(tree=tree, turn_seconds=time.perf_counter() - t0)
        turns.append(res)
        print(f"[{tree}] " + ", ".join(
            f"{k} {v:.4f}" for k, v in {**res["ms"],
                                        **res.get("wall_s", {})}.items()),
              flush=True)
    result = {"card": card, "turns": turns}
    if args.bits:
        import torch
        outs = [torch.load(os.path.join(args.bits, f"turn{i}.pt"))
                for i in range(len(args.trees))]
        result["bits_equal_first_tree"] = same = [
            {k: bool(torch.equal(o[k].view(torch.int32),
                                 outs[0][k].view(torch.int32)))
             for k in outs[0]} for o in outs]
        for tree, eq in zip(args.trees, same):
            print(f"[{tree}] bitwise equal to {args.trees[0]}'s: "
                  + ", ".join(f"{k} {v}" for k, v in eq.items()), flush=True)
    result = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(result + "\n")
    print(f"card: {card}")
    print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
