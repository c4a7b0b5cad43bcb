#!/usr/bin/env python3
"""The dark-state dip target of ``tools/torch_physics_targets.py`` at
seeds 1-17 on one NVIDIA GPU: a diagnostic of the JAX test's recipe at
N0 = 256, not a target.

    python tools/torch_dip_seed_scan.py [--out PATH]

``tests/test_physics_targets.py::TestCurveLevel::
test_dark_state_dip_tracks_detuning`` reads the dip of one cooling run
(the config's job seed, 1) from its last 20 population files, a recipe
its own comment calls seed-sensitive at this size.  This runs the
target's ``dark_state_dip`` at seeds 1-17 for both (detSP, detDP) cases
and writes, per case and seed, the JAX asserts' misses, the dip's place,
the pooled mean vx^2, the profile and the run's launches to
``artifacts/physics_targets_torch/dip_seeds.json``.
``tools/jax_dip_seed_scan.py`` writes the JAX package's scan of the same
seeds on the CPU (``jax_dip_seeds.json``), and
tests/test_torch_physics_targets.py compares the two samples: the seeds
meeting every assert, and the dip's depth (:func:`dip_depth`).

Runs on CUDA (exit 2 without a card); :func:`scan` takes
``device="cpu"`` and the size overrides of the tests.  Imports torch,
numpy and ``mdqtplasmasims_torch`` (through the targets tool) only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import torch_physics_targets as tpt  # noqa: E402
import torch_soak  # noqa: E402

SEEDS = range(1, 18)
OUT = os.path.join(tpt.OUT, "dip_seeds.json")
JAX_OUT = os.path.join(tpt.OUT, "jax_dip_seeds.json")


def dip_depth(centers, prof, v_res: float) -> float:
    """The lowest bin within 0.25 gamma/k of v_res (the JAX test's bar on
    the dip's place) over the inner shoulder's mean (its bar on the
    depth): a continuous reading of the dip, defined whether or not the
    recipe finds a strict local minimum."""
    centers, prof = np.asarray(centers), tpt.profile_array(prof)
    near = np.isfinite(prof) & (np.abs(centers - v_res) <= 0.25)
    shoulder = tpt.dip_values(centers, prof, v_res)["shoulder"]
    return float(prof[near].min() / shoulder)


def scan(seeds, work_dir: str, device="cuda", **over) -> dict:
    """Per dip case and seed: the JAX asserts' misses, the dip's place, the
    pooled mean vx^2, the profile and the launches."""
    out = {}
    for det_sp, det_dp, n_right in tpt.DIP_CASES:
        name = tpt.dip_name(det_sp, det_dp)
        out[name] = {}
        for seed in seeds:
            d = tpt.dark_state_dip(det_sp, det_dp,
                                   os.path.join(work_dir, name), device,
                                   seed=seed, **over)
            out[name][str(seed)] = dict(
                misses=tpt.dip_misses(d["centers"],
                                      tpt.profile_array(d["profile"]),
                                      d["v_res"], n_right),
                v_dip=d["v_dip"], v2=d["v2"], profile=d["profile"],
                launches=d["launches"], wall_s=d["wall_s"])
    return out


def passes(records: dict) -> dict:
    """Per dip case ``(seeds meeting every JAX assert, seeds)``."""
    return {name: (sum(not r["misses"] for r in recs.values()), len(recs))
            for name, recs in records.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT, help="default: %(default)s")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_dip_seed_scan: no CUDA device; the scan runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    print(f"libraries built in {torch_soak.build_libraries():.1f} s",
          flush=True)
    with tempfile.TemporaryDirectory() as work:
        rec = scan(SEEDS, work, "cuda")
    rec = dict(device=torch_soak.run_meta("cuda"), seeds=rec)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(dict(passes=passes(rec["seeds"]))))
    print("wrote", args.out, f"({rec['device']['card']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
