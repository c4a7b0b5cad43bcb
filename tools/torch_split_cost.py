#!/usr/bin/env python3
"""What the pair kernels' member-independent column split costs, on one
NVIDIA GPU.

    python tools/torch_split_cost.py [--widths 8 32 99] [--out FILE]

``ops.yukawa.pair_split`` chunks a launch's columns from (rows, columns)
alone, so that a member's row sums have one order in a fold of any width
(a mesh slot's block of the fold gives the unsharded fold's bits).  The
split it replaced (``widening_split`` here) widened the chunks as the fold
grew, down to one chunk, which saved the second pass and its scratch on
wide folds.  For each width E this times kernels C (forces) and G (forces
and potential) on a fold of E members of the flagship's 3500 ions in 3584
lanes (uniform positions, seed 0), once with each split, in one process
on one card (``chip_smoke.cuda_ms``: the device clock, median of 30), and
holds each member of the fold bit for bit to the same member launched
alone (E = 1) under each split.

Prints one line per (kernel, E), the card's ``nvidia-smi`` name and power
limit, and as the last line one JSON object of every reading.  Exits 2
without a CUDA device.  Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

N0 = 3500


def widening_split(npad: int, ncols: int, e: int):
    """The column split before it became member-independent: enough chunks
    that the whole fold's grid reaches TARGET_BLOCKS."""
    from mdqtplasmasims_torch.ops import yukawa as ty
    row_blocks = (npad // ty.ROW_TILE) * e
    want = min(-(-ty.TARGET_BLOCKS // row_blocks), ncols // ty.COL_TILE)
    chunk = ty._round_up(-(-ncols // want), ty.COL_TILE)
    return ty.PairSplit(chunk, (npad // ty.ROW_TILE, -(-ncols // chunk), e))


@contextlib.contextmanager
def split_rule(rule):
    """Launch the pair kernels with ``rule`` in place of ``pair_split``
    (None: the port's own)."""
    from mdqtplasmasims_torch.ops import yukawa as ty
    own = ty.pair_split
    ty.pair_split = rule or own
    try:
        yield
    finally:
        ty.pair_split = own


def fold_inputs(e: int, dev):
    """``e`` members of N0 uniform ions: the SoA lanes ``[3, e*npad]`` with
    the shared row mask, and the same positions as ``[e, N0, 3]``."""
    from mdqtplasmasims_torch.ops.yukawa import soa_force_tile
    from mdqtplasmasims_torch.units import PlasmaUnits
    L = PlasmaUnits.box_length(N0)
    npad = -(-N0 // 128) * 128
    soa_force_tile(npad)
    rng = np.random.default_rng(0)
    R = torch.as_tensor(rng.uniform(0.0, L, (e, N0, 3)),
                        dtype=torch.float32, device=dev)
    Rp = torch.zeros((3, e, npad), dtype=torch.float32, device=dev)
    Rp[:, :, :N0] = R.permute(2, 0, 1)
    rows = torch.zeros((1, npad), dtype=torch.float32, device=dev)
    rows[0, :N0] = 1.0
    return Rp.reshape(3, e * npad).contiguous(), rows, R, npad, L


def readings(e: int, dev, cs) -> dict:
    from mdqtplasmasims_torch.experiments.laser_cooling import CoolingConfig
    from mdqtplasmasims_torch.ops import yukawa as ty
    from mdqtplasmasims_torch.units import PlasmaUnits
    cfg = CoolingConfig(n0=N0)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    Rp, rows, R, npad, L = fold_inputs(e, dev)
    out = {}
    for name, rule in (("member_split", None),
                       ("widening_split", widening_split)):
        with split_rule(rule):
            split = ty.pair_split(npad, npad, e)
            c = lambda: ty.yukawa_forces_n3l_soa_batched(Rp, rows, e, L, ldeb)
            g = lambda: ty.yukawa_forces_potential_pallas_batched(R, L, ldeb)
            F, (Fg, pot) = c(), g()
            alone = all(
                torch.equal(F[:, j * npad:(j + 1) * npad],
                            ty.yukawa_forces_n3l_soa_batched(
                                Rp[:, j * npad:(j + 1) * npad].contiguous(),
                                rows, 1, L, ldeb))
                for j in (0, e - 1))
            alone_g = all(
                torch.equal(Fg[j], ty.yukawa_forces_potential_pallas_batched(
                    R[j:j + 1].contiguous(), L, ldeb)[0][0])
                for j in (0, e - 1))
            out[name] = dict(chunk=split.chunk, chunks=split.grid[1],
                             blocks=split.grid[0] * split.grid[1] * e,
                             C_ms=cs.cuda_ms(torch, c),
                             G_ms=cs.cuda_ms(torch, g),
                             C_member_equals_alone=alone,
                             G_member_equals_alone=alone_g)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--widths", type=int, nargs="+", default=[8, 32, 99])
    p.add_argument("--out", help="also write the JSON object to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_split_cost: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"], capture_output=True,
        text=True, timeout=60, check=True).stdout.strip()
    res = dict(card=card, n0=N0, widths={})
    for e in args.widths:
        r = res["widths"][str(e)] = readings(e, dev, cs)
        for k in ("C", "G"):
            m, w = r["member_split"], r["widening_split"]
            print(f"[split-cost] {k} E={e}: member split {m[k + '_ms']:.4f} "
                  f"ms ({m['chunks']} chunks, member == alone "
                  f"{m[k + '_member_equals_alone']}), widening split "
                  f"{w[k + '_ms']:.4f} ms ({w['chunks']} chunks, member == "
                  f"alone {w[k + '_member_equals_alone']}); ratio "
                  f"{m[k + '_ms'] / w[k + '_ms']:.3f}", flush=True)
    print(f"[split-cost] card: {card}")
    line = json.dumps(res, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    ok = all(r["member_split"][f"{k}_member_equals_alone"]
             for r in res["widths"].values() for k in ("C", "G"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
