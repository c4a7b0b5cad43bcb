"""Command-line runner of the port: the cooling, three-state,
frozen-start tagging, transport and MC-tagging families.

    python -m mdqtplasmasims_torch.cli cooling --n0 3500 --tmax 30 \
        --save-directory dataLaserCool/ --job 1 --device cuda
    python -m mdqtplasmasims_torch.cli cooling --tmax 60 --resume \
        --save-directory dataLaserCool/ --job 1
    python -m mdqtplasmasims_torch.cli cooling --jobs 4 \
        --save-directory dataLaserCool/
    python -m mdqtplasmasims_torch.cli cooling-ensemble --jobs 8 \
        --save-directory dataLaserCool/ --device cuda
    python -m mdqtplasmasims_torch.cli cooling-sweep --det-sp-values=-1,-0.5 \
        --om-values 0.8,1.2 --cross --save-directory sweep/ --device cuda
    python -m mdqtplasmasims_torch.cli cooling-ensemble --jobs 4 \
        --mesh-ens 2 --mesh-ions 2 --device cpu
    python -m mdqtplasmasims_torch.cli three-state --n0 1000 --tmax 450 \
        --save-directory dataThreeState/
    python -m mdqtplasmasims_torch.cli frozen-tag --variant 422linear \
        --batch-jobs 8 --exact-n false --save-directory dataFrozenTag/
    python -m mdqtplasmasims_torch.cli frozen-tag --tmax 30 --resume \
        --save-directory dataFrozenTag/ --job 1
    python -m mdqtplasmasims_torch.cli frozen-tag-sweep --det-values=-3,-1 \
        --om-values 1.3 --jobs-per-point 4 --save-directory sweepTag/
    python -m mdqtplasmasims_torch.cli three-state-sweep \
        --det-values=-2,-1,-0.5 --om-values 0.5,1 --cross --mesh-ens 2
    python -m mdqtplasmasims_torch.cli transport --batch-jobs 8 \
        --save-directory dataTransport/
    python -m mdqtplasmasims_torch.cli transport-sweep --gamma-values 1,3,10 \
        --kappa-values 0.5,1 --cross --save-directory sweepTransport/
    python -m mdqtplasmasims_torch.cli mc-tag --variant 408quad \
        --checkpoint-every-chunks 1 --save-directory dataMCTag/ --job 1
    python -m mdqtplasmasims_torch.cli mc-tag --variant 408quad --resume \
        --checkpoint-every-chunks 1 --save-directory dataMCTag/ --job 1
    python -m mdqtplasmasims_torch.cli mc-tag-sweep --det-values=-1,0 \
        --save-directory sweepMCTag/

Flags are generated from each family's config dataclass exactly as the JAX
package's ``mdqt`` commands of the same names generate them (``--jobs``,
``--batch-jobs``, ``--resume``, ``--det-values``, ``--om-values``,
``--cross``, ``--jobs-per-point``, ``--seed``, the mesh flags); ``--device`` picks the torch device (``cuda`` launches the
hand-written kernels, ``cpu`` runs their plain torch versions).
``cooling --resume`` continues from the job directory's newest checkpoint
and ``cooling --jobs K`` runs jobs 1..K one after the other in this
process, as the JAX CLI does; ``transport --resume`` and ``mc-tag
--resume`` continue a job's staged pipeline from its newest pipeline
checkpoint (published with ``--checkpoint-every-chunks K``).
``--mesh-ens K`` (and ``--mesh-ions I``) spread an ensemble or sweep over
a K x I mesh of device slots (parallel/mesh.py): distinct cards with
``--device cuda``, run as one process a card over NCCL
(parallel/ranks.py), CPU slots stepped from this process with
``--device cpu``.

Two host commands read a tree once it is written, with the JAX CLI's
flags; they are dispatched before any experiment family (or torch's CUDA)
is imported:

    python -m mdqtplasmasims_torch.cli analyze dataLaserCool/<params>/job1
    python -m mdqtplasmasims_torch.cli analyze dataLaserCool/<params> --json
    python -m mdqtplasmasims_torch.cli plot dataLaserCool/<params>/job1 \
        -o quicklook.png

``analyze`` prints analysis.analyze_job's report (a directory holding
``job*`` subdirectories is analyzed as an ensemble, pooled across jobs);
``plot`` renders quicklook.render's PNG (needs matplotlib).  Installed,
the command is ``mdqt-torch``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import inspect
import json
import os
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


def _add_mesh_args(parser: argparse.ArgumentParser,
                   ions: bool = False) -> None:
    """``--mesh-ens`` and, for the cooling fold (``ions``), ``--mesh-ions``;
    the other families keep whole members on a slot."""
    parser.add_argument("--mesh-ens", type=int, default=0, metavar="K",
                        help="spread members over the K slots of a mesh "
                             "ens axis (members must divide evenly)")
    if ions:
        parser.add_argument("--mesh-ions", type=int, default=1, metavar="I",
                            help="additionally shard each member's ion axis "
                                 "over I slots (the mesh has K*I slots)")


def _mesh_from_flags(ns: argparse.Namespace):
    """The K x I mesh of ``--mesh-ens/--mesh-ions``: distinct cards on
    ``--device cuda`` (run as ranks), CPU slots on ``--device cpu``; None
    without ``--mesh-ens``."""
    if not ns.mesh_ens:
        return None
    from .parallel.mesh import make_mesh
    k, i = ns.mesh_ens, getattr(ns, "mesh_ions", 1)
    devices = None if ns.device.startswith("cuda") else [ns.device] * (k * i)
    return make_mesh(k, i, devices=devices)


def _version_string() -> str:
    from . import __version__
    try:
        from importlib.metadata import version
        return version("mdqtplasmasims_tpu")      # the distribution's name
    except Exception:          # running from a source tree, not installed
        return __version__ + "+src"


def _add_host_subcommands(sub) -> None:
    """The host-only subcommands, plot and analyze (the JAX CLI's)."""
    pp = sub.add_parser(
        "plot",
        help="render the quicklook PNG summary of a job directory's "
             ".dat output tree (any family; see quicklook.py)")
    pp.add_argument("job_dir")
    pp.add_argument("-o", "--out", default=None,
                    help="output PNG (default <job_dir>/quicklook.png)")

    pa = sub.add_parser(
        "analyze",
        help="numeric summary of a job directory's .dat tree: energies/"
             "audit, temperatures, Green-Kubo D, L+T dispersion, S(k), "
             "g(r), tagged moments (analysis.analyze_job)")
    pa.add_argument("job_dir")
    pa.add_argument("--timestep", type=float, default=0.002,
                    help="MD step in omega_E^-1 for the dispersion time "
                         "axis (default 0.002)")
    pa.add_argument("--max-shell", type=int, default=None,
                    help="largest integer |k|^2 shell for dispersion/S(k)")
    pa.add_argument("--skip", type=int, default=0,
                    help="initial J samples to drop (e.g. the DIH "
                         "transient)")
    pa.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the report as JSON instead of text")


def _dispatch_host(ns, parser) -> int:
    """Run a host-only subcommand (returns 0; errors via parser.error)."""
    if ns.cmd == "plot":
        from .quicklook import render
        try:
            print(render(ns.job_dir, ns.out))
        except ValueError as e:
            parser.error(str(e))
        return 0
    from .analysis import (analyze_ensemble, analyze_job,
                           format_ensemble_report, format_job_report)
    # a parameter directory (job* subdirs) pools across jobs
    ensemble = bool(glob.glob(os.path.join(ns.job_dir, "job*")))
    analyze = analyze_ensemble if ensemble else analyze_job
    try:
        rep = analyze(ns.job_dir, timestep=ns.timestep,
                      max_shell=ns.max_shell, skip=ns.skip)
    except ValueError as e:
        parser.error(str(e))
    if ns.as_json:
        print(json.dumps(rep, indent=1))
    else:
        print(format_ensemble_report(rep) if ensemble
              else format_job_report(rep))
    return 0


def _add_cooling_commands(sub, lc) -> None:
    pc = sub.add_parser("cooling", help="flagship laser-cooling run")
    _common(pc, lc.CoolingConfig)
    pc.add_argument("--jobs", type=int, default=0, metavar="K",
                    help="run jobs 1..K one after the other in this process "
                         "(the SLURM-array replacement)")
    pc.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint (the "
                         "reference's newRun=0 walltime chaining)")
    pe = sub.add_parser("cooling-ensemble",
                        help="E independent cooling trajectories in one fold")
    _common(pe, lc.CoolingConfig)
    pe.add_argument("--jobs", type=int, default=8)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--resume", action="store_true",
                    help="rebuild the fold from the newest checkpoint "
                         "common to all job directories")
    _add_mesh_args(pe, ions=True)
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
    _add_mesh_args(ps, ions=True)


#: a sweep's grid flags: (config field, flag, help)
LASER_GRID = (("detuning", "--det-values", "detuning grid, e.g. -3,-1,0"),
              ("om", "--om-values", "Rabi grid, same length (zipped) or "
               "crossed with --cross"))
PHASE_GRID = (("gamma", "--gamma-values", "Gamma grid, e.g. 1,3,10,30"),
              ("kappa", "--kappa-values", "kappa grid, same length (zipped) "
               "or crossed with --cross"))


def _add_family_commands(sub, name: str, cls, resume: bool,
                         grid=LASER_GRID) -> None:
    """``<name>`` (one job, ``--jobs`` one after the other, ``--batch-jobs``
    as one fold) and ``<name>-sweep`` (a grid of ``grid``'s fields as one
    fold: (detuning, om) for the tagging families and the three-state
    toy, (Gamma, kappa) for transport), with the JAX CLI's flags."""
    p = sub.add_parser(name)
    _common(p, cls)
    p.add_argument("--jobs", type=int, default=0, metavar="K",
                   help="run jobs 1..K one after the other in this process "
                        "(the SLURM-array replacement)")
    if resume:
        p.add_argument("--resume", action="store_true",
                       help="continue from the newest checkpoint (the "
                            "reference's newRun=0 walltime chaining; "
                            "frozen-tag resumes post-tag recording)")
    p.add_argument("--batch-jobs", type=int, default=0, metavar="K",
                   help="run K jobs as one fold on the device (vs --jobs "
                        "one after the other)")
    _add_mesh_args(p)
    pq = sub.add_parser(
        name + "-sweep",
        help=f"run a ({', '.join(f for f, _, _ in grid)}) grid as ONE fold; "
             "the reference rebuilds the binary per point")
    _common(pq, cls)
    for _, flag, what in grid:
        pq.add_argument(flag, type=str, default=None, metavar="CSV",
                        help=what)
    pq.add_argument("--cross", action="store_true",
                    help="full cartesian product of the given grids")
    pq.add_argument("--jobs-per-point", type=int, default=1)
    pq.add_argument("--seed", type=int, default=0)
    _add_mesh_args(pq)


def _grids(parser, ns, flags):
    """The sweep points of the ``(config key, namespace attribute)`` pairs
    ``flags`` that were given."""
    grids = {key: [float(x) for x in getattr(ns, attr).split(",") if x]
             for key, attr in flags if getattr(ns, attr) is not None}
    if not grids:
        parser.error("give at least one of " + "/".join(
            "--" + attr.replace("_", "-") for _, attr in flags))
    return _sweep_points(parser, grids, ns.cross)


def _run_cooling(parser, ns, lc, t0) -> str:
    cfg = _build_cfg(lc.CoolingConfig, ns)
    if ns.cmd == "cooling":
        # --resume applies to each job of --jobs
        jobs = ([dataclasses.replace(cfg, job=j)
                 for j in range(1, ns.jobs + 1)] if ns.jobs > 1 else [cfg])
        for k, job_cfg in enumerate(jobs, 1):
            lc.run(job_cfg, resume=ns.resume, device=ns.device)
            if len(jobs) > 1:
                print(f"[cooling] job {k}/{len(jobs)} at "
                      f"{time.perf_counter() - t0:.1f}s")
        return f"{len(jobs)} run" + ("s" if len(jobs) > 1 else "")
    if ns.cmd == "cooling-ensemble":
        lc.run_ensemble(cfg, ns.jobs, ns.seed, resume=ns.resume,
                        mesh=_mesh_from_flags(ns), device=ns.device)
        return f"{ns.jobs} trajectories in one fold"
    points = _grids(parser, ns, (("detuning", "det_sp_values"),
                                 ("detuning_dp", "det_dp_values"),
                                 ("om", "om_values"),
                                 ("om_dp", "om_dp_values")))
    lc.run_sweep(cfg, points, jobs_per_point=ns.jobs_per_point,
                 seed=ns.seed, resume=ns.resume,
                 mesh=_mesh_from_flags(ns), device=ns.device)
    return f"{len(points)} points x {ns.jobs_per_point} jobs in one fold"


def _run_family(parser, ns, module, cfg, t0, grid=LASER_GRID) -> str:
    """``module`` is one of experiments.three_state, frozen_tagging,
    mc_md_anisotropy, mc_qt_tagging: ``run``, ``run_ensemble`` and
    ``run_sweep`` take the same arguments in all four, apart from
    ``resume`` (the staged families' folds publish no checkpoint)."""
    if ns.cmd.endswith("-sweep"):
        points = _grids(parser, ns, [(f, flag[2:].replace("-", "_"))
                                     for f, flag, _ in grid])
        module.run_sweep(cfg, points, jobs_per_point=ns.jobs_per_point,
                         seed=ns.seed, mesh=_mesh_from_flags(ns),
                         device=ns.device)
        return f"{len(points)} points x {ns.jobs_per_point} jobs in one fold"
    kw = {"resume": True} if getattr(ns, "resume", False) else {}
    if (ns.batch_jobs > 1 and kw and "resume" not in
            inspect.signature(module.run_ensemble).parameters):
        parser.error(f"{ns.cmd} --resume continues single jobs (--job, "
                     "--jobs); a --batch-jobs fold publishes no checkpoint")
    if ns.batch_jobs > 1:
        module.run_ensemble(cfg, ns.batch_jobs, mesh=_mesh_from_flags(ns),
                            device=ns.device, **kw)
        return f"{ns.batch_jobs} batched trajectories"
    if ns.jobs > 1:
        # --resume applies per job where the family supports it
        for j in range(1, ns.jobs + 1):
            module.run(dataclasses.replace(cfg, job=j), device=ns.device,
                       **kw)
            print(f"[{ns.cmd}] job {j}/{ns.jobs} at "
                  f"{time.perf_counter() - t0:.1f}s")
        return f"{ns.jobs} runs"
    module.run(cfg, device=ns.device, **kw)
    return "1 run"


def _families() -> dict:
    """Command prefix -> (module, config class, has --resume, sweep grid)
    of the families besides cooling."""
    from .experiments import (frozen_tagging, mc_md_anisotropy,
                              mc_qt_tagging, three_state)
    return {
        "three-state": (three_state, three_state.ThreeStateConfig, False,
                        LASER_GRID),
        "frozen-tag": (frozen_tagging, frozen_tagging.FrozenTagConfig, True,
                       LASER_GRID),
        "transport": (mc_md_anisotropy, mc_md_anisotropy.MCTransportConfig,
                      True, PHASE_GRID),
        "mc-tag": (mc_qt_tagging, mc_qt_tagging.MCTagConfig, True,
                   LASER_GRID),
    }


def build_parser(families=None) -> argparse.ArgumentParser:
    """The parser of every subcommand and flag (``families`` as
    :func:`_families` gives them)."""
    from .experiments import laser_cooling
    parser = argparse.ArgumentParser(prog="mdqt-torch")
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {_version_string()}")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_cooling_commands(sub, laser_cooling)
    for name, (_, cls, resume, grid) in (families or _families()).items():
        _add_family_commands(sub, name, cls, resume, grid)
    _add_host_subcommands(sub)            # listed in --help; run in main
    return parser


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    # plot / analyze are host commands: dispatch them before the
    # experiment families (and torch's CUDA) are imported
    first_pos = next((a for a in args if not a.startswith("-")), None)
    if first_pos in ("plot", "analyze"):
        parser = argparse.ArgumentParser(prog="mdqt-torch")
        _add_host_subcommands(parser.add_subparsers(dest="cmd",
                                                    required=True))
        return _dispatch_host(parser.parse_args(args), parser)

    from .experiments import laser_cooling
    families = _families()
    parser = build_parser(families)
    ns = parser.parse_args(args)
    t0 = time.perf_counter()
    if ns.cmd.startswith("cooling"):
        what = _run_cooling(parser, ns, laser_cooling, t0)
        save_directory = ns.save_directory
    else:
        module, cls, _, grid = families[ns.cmd.removesuffix("-sweep")]
        cfg = _build_cfg(cls, ns)
        what = _run_family(parser, ns, module, cfg, t0, grid)
        save_directory = cfg.save_directory
    mesh = getattr(ns, "mesh_ens", 0)
    print(f"[{ns.cmd}] {what} on {ns.device}"
          + (f" (mesh {mesh} x {getattr(ns, 'mesh_ions', 1)})" if mesh
             else "")
          + f" in {time.perf_counter() - t0:.1f}s"
          + (f" -> {save_directory}" if save_directory else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
