"""Command-line runner of the port (the cooling family so far).

    python -m mdqtplasmasims_torch.cli cooling --n0 3500 --tmax 30 \
        --save-directory dataLaserCool/ --job 1 --device cuda
    python -m mdqtplasmasims_torch.cli cooling-ensemble --jobs 8 \
        --save-directory dataLaserCool/ --device cuda
    python -m mdqtplasmasims_torch.cli cooling-sweep --det-sp-values=-1,-0.5 \
        --om-values 0.8,1.2 --cross --save-directory sweep/ --device cuda

Flags are generated from :class:`CoolingConfig` exactly as the JAX
package's ``mdqt cooling``/``cooling-ensemble``/``cooling-sweep`` generate
them (without its multi-device mesh flags); ``--device`` picks the torch
device (``cuda`` launches the hand-written kernels, ``cpu`` runs their
plain torch versions).
"""

from __future__ import annotations

import argparse
import sys
import time

from mdqtplasmasims_tpu.cli import (_add_dataclass_args, _build_cfg,
                                    _sweep_points)


def _common(p, cls) -> None:
    _add_dataclass_args(p, cls)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")


def main(argv=None) -> int:
    from .experiments import laser_cooling as lc

    parser = argparse.ArgumentParser(prog="mdqt-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _common(sub.add_parser("cooling", help="flagship laser-cooling run"),
            lc.CoolingConfig)
    pe = sub.add_parser("cooling-ensemble",
                        help="E independent cooling trajectories in one fold")
    _common(pe, lc.CoolingConfig)
    pe.add_argument("--jobs", type=int, default=8)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--resume", action="store_true",
                    help="rebuild the fold from the newest checkpoint "
                         "common to all job directories")
    ps = sub.add_parser(
        "cooling-sweep",
        help="a laser-parameter grid (detSP/detDP/OmSP/OmDP) as ONE fold")
    _common(ps, lc.CoolingConfig)
    for flag, what in (("--det-sp-values", "detSP grid, e.g. -1.0,-0.5"),
                       ("--det-dp-values", "detDP grid"),
                       ("--om-values", "OmSP grid"),
                       ("--om-dp-values", "OmDP grid")):
        ps.add_argument(flag, type=str, default=None, metavar="CSV",
                        help=what + " (zipped, or crossed with --cross)")
    ps.add_argument("--cross", action="store_true",
                    help="full cartesian product of the given grids")
    ps.add_argument("--jobs-per-point", type=int, default=1)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--resume", action="store_true")
    ns = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    cfg = _build_cfg(lc.CoolingConfig, ns)
    t0 = time.perf_counter()
    if ns.cmd == "cooling":
        lc.run(cfg, device=ns.device)
        what = "1 run"
    elif ns.cmd == "cooling-ensemble":
        lc.run_ensemble(cfg, ns.jobs, ns.seed, resume=ns.resume,
                        device=ns.device)
        what = f"{ns.jobs} trajectories in one fold"
    else:
        grids = {}
        for key, csv in (("detuning", ns.det_sp_values),
                         ("detuning_dp", ns.det_dp_values),
                         ("om", ns.om_values), ("om_dp", ns.om_dp_values)):
            if csv is not None:
                grids[key] = [float(x) for x in csv.split(",") if x]
        if not grids:
            parser.error("give at least one of --det-sp-values/"
                         "--det-dp-values/--om-values/--om-dp-values")
        points = _sweep_points(parser, grids, ns.cross)
        lc.run_sweep(cfg, points, jobs_per_point=ns.jobs_per_point,
                     seed=ns.seed, resume=ns.resume, device=ns.device)
        what = f"{len(points)} points x {ns.jobs_per_point} jobs in one fold"
    print(f"[{ns.cmd}] {what} on {ns.device} in "
          f"{time.perf_counter() - t0:.1f}s"
          + (f" -> {cfg.save_directory}" if cfg.save_directory else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
