"""Rabi-frequency (OmDP) scan of the 1033 repump on one NVIDIA GPU — the
whole scan in ONE fold (the PyTorch + CUDA port's counterpart of
``examples/rabi_sweep.py``).

The reference explores laser powers the same way it explores detunings:
edit the compile-time constants ``Om``/``OmDP`` (SpeedUp.cpp:68-69) and
rebuild the binary per point, 8 h of walltime each.  Here the
Hamiltonian is linear in each Rabi frequency, so the tick kernel's
per-lane om form scales two fixed base coupling patterns by per-lane
(om, om_dp) rows and the whole scan folds into one ensemble
(``laser_cooling.run_sweep``): each point costs one more member.

Physics: OmDP sets the 1033 repump rate out of the D5/2 shelf.  Weak
repump piles population into D (shelving); strong repump empties it and
deepens/broadens the EIT dark state.  The steady-state D population
falls monotonically with OmDP (it exits 1 otherwise).

Usage: python examples/torch_rabi_sweep.py [outdir] [--device cpu]
       [--summary PATH]

Measured (NVIDIA H100 80GB HBM3, 700.00 W; seed 2; the table archived
in ``artifacts/examples_torch/summary.json``): 4 OmDP points at N=2048,
tmax=6 in 2.7-3.4 s wall over two calls (the process's first CUDA work
included); the steady-state D population falls 0.710 -> 0.409 -> 0.227
-> 0.194 as OmDP goes 0.25 -> 2.0.
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

OM_DP = [0.25, 0.5, 1.0, 2.0]
CONFIG = dict(n0=2048, tmax=6.0, sample_freq=50)
SEED = 2


def main(out=None, device="cuda", **overrides) -> dict:
    """Run the scan (trees into ``out``; none when None) and return its
    table: per OmDP the steady-state S, P and D populations (the last
    half of the samples)."""
    from mdqtplasmasims_torch.experiments.laser_cooling import (CoolingConfig,
                                                                run_sweep)
    cfg = CoolingConfig(**dict(CONFIG, save_directory=out, **overrides))
    t0 = time.perf_counter()
    _, outs, member_cfgs = run_sweep(cfg, [{"om_dp": o} for o in OM_DP],
                                     seed=SEED, device=device)
    wall = time.perf_counter() - t0
    pops = np.asarray(outs["pops"])          # [E, T, N, 3] (per ion)
    half = pops.shape[1] // 2
    rows = [dict(om_dp=m.om_dp, **dict(zip(
        "spd", (float(x) for x in pops[j, half:].mean(axis=(0, 1))))))
        for j, m in enumerate(member_cfgs)]
    return dict(config=dict(CONFIG, **overrides), seed=SEED, wall_s=wall,
                rows=rows)


def physics_misses(table: dict) -> list:
    """Empty when the D population falls monotonically with OmDP."""
    d = np.array([r["d"] for r in table["rows"]])
    return ([] if np.all(np.diff(d) < 0) else
            [f"D-shelf population not falling with repump power: {d}"])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="dataRabiScan")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--summary", default=None,
                    help="merge the table into this JSON file")
    args = ap.parse_args()
    table = main(args.out, args.device)
    print(f"[sweep] {len(OM_DP)} OmDP points in one fold: "
          f"{table['wall_s']:.1f} s wall on {args.device}\n")
    print(f"{'OmDP':>6s} {'S':>7s} {'P':>7s} {'D':>7s}   (steady state, "
          "last half of run)")
    for r in table["rows"]:
        print(f"{r['om_dp']:6.2f} {r['s']:7.3f} {r['p']:7.3f} {r['d']:7.3f}")
    if args.summary:
        from mdqtplasmasims_torch.profiling import record_table
        record_table(args.summary, "rabi_sweep", table, args.device)
    misses = physics_misses(table)
    print("\n".join(misses) or "\nD-shelf population falls monotonically "
          "with repump power — the 1033 repump physics, one fold for the "
          "scan.")
    sys.exit(1 if misses else 0)
