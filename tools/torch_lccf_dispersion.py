#!/usr/bin/env python3
"""Longitudinal collective-mode dispersion from the LCCF output of the
PyTorch + CUDA port: the port's counterpart of
``tools/lccf_dispersion.py``.

    python tools/torch_lccf_dispersion.py [--n0 1024] [--tmax 40]
        [--out DIR]

It runs a laser-free flagship configuration (om = om_dp = 0: a pure
Yukawa OCP that disorder-induced-heats to Gamma ~ 2.5 and then evolves
freely) through ``experiments.laser_cooling.run`` on one NVIDIA GPU,
seed 1, with ``record_lccf``: every MD step one launch of kernel A and
one of the tick kernel with its in-kernel RNG (B'rng, whose coupling is
zero here), every sample one launch of kernel D and J(k, t) on the 12^3
integer-k grid, written to ``J_interval0.dat``.  :func:`dispersion` then
extracts the longitudinal mode dispersion omega_L(k) with
``analysis.lccf_spectrum`` (and the transverse shear branch omega_T(k),
0 where no propagating mode resolves) and compares each k-shell's peak
with the Debye-screened cold-plasmon law

    omega(k) = omega_pl * k / sqrt(k^2 + kappa^2),
    omega_pl = sqrt(3) omega_E,  kappa = sqrt(3 Ge).

Writes ``dispersion.json`` (the JAX tool's keys, plus the card's name
and power limit and the kernels' launches) into ``--out``, as the JAX
tool does.  Runs on CUDA (exit 2 without a card) unless ``--device
cpu`` is given.  Imports torch, numpy and ``mdqtplasmasims_torch`` (and
``tools/torch_soak.py``'s build, metadata and launch counters) only.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import shutil
import sys
import tempfile

import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import torch_soak  # noqa: E402  (puts the repository root on sys.path)

SEED = 1


def lccf_config(args):
    """The JAX tool's laser-free ``CoolingConfig`` from the arguments."""
    from mdqtplasmasims_torch.experiments.laser_cooling import CoolingConfig
    return CoolingConfig(n0=args.n0, tmax=args.tmax,
                         sample_freq=args.sample_freq,
                         om=0.0, om_dp=0.0,          # lasers off: free OCP
                         record_lccf=True, save_directory=args.out)


def run_flagship(cfg, device) -> tuple:
    """``run(cfg, seed=1)`` on ``device`` into a fresh ``cfg.save_directory``:
    ``(job_dir, wall s from a synced card to the run's return, the
    kernels' launches)``."""
    from mdqtplasmasims_torch.experiments.laser_cooling import run
    shutil.rmtree(cfg.save_directory, ignore_errors=True)
    _, wall, launches = torch_soak._timed(
        device, lambda: run(cfg, seed=SEED, device=device))
    return glob.glob(os.path.join(cfg.save_directory, "*", "job1"))[0], \
        wall, launches


def dispersion(job_dir: str, cfg, args, wall: float) -> dict:
    """The dispersion of the run in ``job_dir``: ``lccf_spectrum`` after
    ``args.skip_time``, each shell's longitudinal peak against the
    screened cold-plasmon law and its shear peak omega_T, printed as the
    JAX tool prints them; returns ``dispersion.json``'s dict."""
    from mdqtplasmasims_torch.analysis import lccf_spectrum
    from mdqtplasmasims_torch.units import PlasmaUnits
    skip = int(args.skip_time / (cfg.timestep * cfg.sample_freq))
    spec = lccf_spectrum(job_dir, timestep=cfg.timestep,
                         max_shell=args.max_shell, skip=skip)
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    kappa = pu.kappa
    dw = spec["omega"][1] - spec["omega"][0]
    print(f"# N0={cfg.n0} L={L:.2f}a kappa={kappa:.3f} "
          f"omega_pl={math.sqrt(3):.3f} omega_E  "
          f"(wall {wall:.1f}s, {len(spec['k_int2'])} shells, "
          f"d_omega={dw:.3f})")
    print("# |n|^2   k [1/a]   omega_peak   omega_theory   ratio   omega_T")
    rows = []
    for q, kn, pk, pt in zip(spec["k_int2"], spec["k"],
                             spec["omega_peak"], spec["omega_peak_t"]):
        k = 2.0 * math.pi * kn / L
        th = math.sqrt(3.0) * k / math.sqrt(k * k + kappa * kappa)
        rows.append(dict(n2=int(q), k=k, omega_peak=float(pk),
                         omega_theory=th, ratio=float(pk) / th,
                         omega_peak_t=float(pt)))
        # omega_T: shear-wave branch (0 = no propagating mode resolved;
        # expected at the post-DIH Gamma ~ 2.5 — transverse sound needs
        # Gamma >~ 5)
        print(f"  {q:5d}   {k:7.3f}   {pk:10.3f}   {th:12.3f}   "
              f"{pk / th:5.3f}   {pt:7.3f}")
    return dict(n0=cfg.n0, tmax=cfg.tmax, kappa=kappa, d_omega=float(dw),
                wall_s=wall, rows=rows)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n0", type=int, default=1024)
    ap.add_argument("--tmax", type=float, default=40.0)
    ap.add_argument("--sample-freq", type=int, default=40)
    ap.add_argument("--skip-time", type=float, default=8.0,
                    help="initial transient (DIH) to drop, in 1/omega_E")
    ap.add_argument("--max-shell", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "lccf_dispersion_torch"),
                    help="the run's tree (default: %(default)s)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (for tests)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("torch_lccf_dispersion: no CUDA device; the run goes on "
                  "an NVIDIA GPU (--device cpu for the twins)",
                  file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"libraries built in {torch_soak.build_libraries():.1f} s",
              flush=True)
    cfg = lccf_config(args)
    meta = torch_soak.run_meta(device)
    job, wall, launches = run_flagship(cfg, device)
    out = dict(dispersion(job, cfg, args, wall), device=meta,
               launches=launches)
    path = os.path.join(args.out, "dispersion.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path, f"({meta['card']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
