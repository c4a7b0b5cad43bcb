"""Command-line runner of the port (the cooling family so far).

    python -m mdqtplasmasims_torch.cli cooling --n0 3500 --tmax 30 \
        --save-directory dataLaserCool/ --job 1 --device cuda
    python -m mdqtplasmasims_torch.cli cooling-ensemble --jobs 8 \
        --save-directory dataLaserCool/ --device cuda
    python -m mdqtplasmasims_torch.cli cooling-sweep --det-sp-values=-1,-0.5 \
        --om-values 0.8,1.2 --cross --save-directory sweep/ --device cuda
    python -m mdqtplasmasims_torch.cli cooling-ensemble --jobs 4 \
        --mesh-ens 2 --mesh-ions 2 --device cpu

Flags are generated from :class:`CoolingConfig` exactly as the JAX
package's ``mdqt cooling``/``cooling-ensemble``/``cooling-sweep`` generate
them; ``--device`` picks the torch device (``cuda`` launches the
hand-written kernels, ``cpu`` runs their plain torch versions).
``--mesh-ens K`` (and ``--mesh-ions I``) spread an ensemble or sweep over
a K x I mesh of device slots (parallel/mesh.py): distinct cards with
``--device cuda``, CPU slots with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
import types
import typing


def _parse_bool(s: str) -> bool:
    v = s.lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def _add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    """One flag per field of the config dataclass ``cls`` (the JAX
    package's CLI generates the same flags)."""
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        name = "--" + f.name.replace("_", "-")
        t = hints.get(f.name, str)
        origin = typing.get_origin(t)
        if origin in (typing.Union, types.UnionType):   # Optional / X | None
            args = [a for a in typing.get_args(t) if a is not type(None)]
            t = args[0] if args else str
        default = f.default if f.default is not dataclasses.MISSING else None
        if t is bool:
            parser.add_argument(name, type=_parse_bool, default=default,
                                metavar="BOOL")
        elif t is tuple or origin is tuple:
            parser.add_argument(name, type=lambda s: tuple(
                float(x) for x in s.split(",") if x), default=default,
                metavar="CSV")
        elif t in (int, float, str):
            parser.add_argument(name, type=t, default=default)
        # unsupported field types are construction-time only


def _sweep_points(parser, grids: dict, cross: bool):
    """CSV grids -> sweep-point dicts: full cartesian product under
    ``cross``, else zipped (length-1 grids broadcast as constants)."""
    if cross:
        points = [{}]
        for key, vals in grids.items():
            points = [{**p, key: v} for p in points for v in vals]
        return points
    n_pts = max(len(v) for v in grids.values())
    for key, vals in grids.items():
        if len(vals) == 1:
            grids[key] = vals * n_pts           # broadcast constants
        elif len(vals) != n_pts:
            parser.error("zipped sweep needs equal-length grids "
                         "(use --cross for a product)")
    return [{k: grids[k][i] for k in grids} for i in range(n_pts)]


def _build_cfg(cls, ns: argparse.Namespace):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if hasattr(ns, f.name) and getattr(ns, f.name) is not None:
            kwargs[f.name] = getattr(ns, f.name)
    return cls(**kwargs)


def _common(p, cls) -> None:
    _add_dataclass_args(p, cls)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")


def _add_mesh_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--mesh-ens", type=int, default=0, metavar="K",
                        help="spread members over the K slots of a mesh "
                             "ens axis (members must divide evenly)")
    parser.add_argument("--mesh-ions", type=int, default=1, metavar="I",
                        help="additionally shard each member's ion axis "
                             "over I slots (the mesh has K*I slots)")


def _mesh_from_flags(ns: argparse.Namespace):
    """The K x I mesh of ``--mesh-ens/--mesh-ions``: distinct cards on
    ``--device cuda``, CPU slots on ``--device cpu``; None without
    ``--mesh-ens``."""
    if not ns.mesh_ens:
        return None
    from .parallel.mesh import make_mesh
    k, i = ns.mesh_ens, ns.mesh_ions
    devices = None if ns.device.startswith("cuda") else [ns.device] * (k * i)
    return make_mesh(k, i, devices=devices)


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
    _add_mesh_args(pe)
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
    _add_mesh_args(ps)
    ns = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    cfg = _build_cfg(lc.CoolingConfig, ns)
    t0 = time.perf_counter()
    if ns.cmd == "cooling":
        lc.run(cfg, device=ns.device)
        what = "1 run"
    elif ns.cmd == "cooling-ensemble":
        lc.run_ensemble(cfg, ns.jobs, ns.seed, resume=ns.resume,
                        mesh=_mesh_from_flags(ns), device=ns.device)
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
                     seed=ns.seed, resume=ns.resume,
                     mesh=_mesh_from_flags(ns), device=ns.device)
        what = f"{len(points)} points x {ns.jobs_per_point} jobs in one fold"
    mesh = getattr(ns, "mesh_ens", 0)
    print(f"[{ns.cmd}] {what} on {ns.device}"
          + (f" (mesh {mesh} x {ns.mesh_ions})" if mesh else "")
          + f" in {time.perf_counter() - t0:.1f}s"
          + (f" -> {cfg.save_directory}" if cfg.save_directory else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
