#!/usr/bin/env python3
"""Time the PyTorch + CUDA port's Yukawa pair kernels (A, C, D, G, E, F of
mdqtplasmasims_torch/csrc/yukawa_forces.cu) and the runs that launch them,
on one NVIDIA GPU, for one or several source trees in turns.

    python tools/torch_pair_kernel_times.py
    python tools/torch_pair_kernel_times.py --trees OTHER . . OTHER \\
        [--kernels-only] [--out times.json]

Each tree is a checkout of this repository (for another commit:
``mkdir OTHER && git archive <commit> | tar -x -C OTHER``).  Every turn is
a fresh process whose working directory is the tree, so it builds and
loads that tree's kernels; two versions are compared inside one command on
one card, in turns (other, this, this, other), never across commands.

A turn calls only the measured tree's public entries (the wrappers of
``ops/yukawa.py``, ``laser_cooling.run`` and ``run_ensemble``,
``make_mesh``), on inputs this script makes, and times them with this
script's tree's clock (``chip_smoke.cuda_ms``: the median of 30 CUDA-event
timings, the host kept ahead of the card), so a tree measured here needs
nothing but those entries.  It reports
  * ``ms`` of each kernel at the shapes chip_smoke.py uses (A and D: 3500
    ions in 3584 lanes; C and G: an 8-member Poissonian fold; E and F: a
    mesh slot's shapes, 875 ions in 1792 lanes per shard, E row-masked as
    the tree's gather schedule does it: by the kernel where the entry has
    ``row_mask``, else by a multiply after it; ``C_ring``: kernel C on one
    such shard, as the ring schedule launches it);
  * ``wall_s`` (unless ``--kernels-only``): the host-clock seconds of
    ``run(CoolingConfig(n0=3500, tmax=2.0))`` without a .dat tree (best
    and median of 3) and of chip_smoke.py's two 2 x 4 mesh runs
    (``run_ensemble`` of 2 members, tmax=1.0, with trees; gather and
    ring-N3L).

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


def one_turn(kernels_only: bool) -> dict:
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
    out = dict(ms=ms)
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
    out["wall_s"] = wall
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="source trees to measure, in this order")
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--out", help="also write the result to this file")
    ap.add_argument("--turn", action="store_true",
                    help="measure the working directory's tree (internal)")
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(one_turn(args.kernels_only)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    turns = []
    for tree in args.trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--turn"]
        if args.kernels_only:
            cmd.append("--kernels-only")
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
    result = json.dumps({"card": card, "turns": turns})
    if args.out:
        with open(args.out, "w") as f:
            f.write(result + "\n")
    print(f"card: {card}")
    print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
