"""The JAX package's dark-state dip target at seeds 1-17, on the CPU: the
reference side of ``tools/torch_dip_seed_scan.py``.

    JAX_PLATFORMS=cpu python tools/jax_dip_seed_scan.py [--workers 4]

``tests/test_physics_targets.py::TestCurveLevel::
test_dark_state_dip_tracks_detuning`` runs one N0=256 cooling run per
(detSP, detDP) at the config's job seed (1) and reads its dip from the
last 20 population files, a recipe its own comment calls seed-sensitive
at this size.  This runs the same ``run`` (``use_pallas=False``, as the
test) at seeds 1-17 for both cases, applies the test's recipe and
asserts (the port tool's transcriptions, ``dip_profile`` and
``dip_misses``, held to the test's lines by
tests/test_torch_physics_targets.py) and writes, per case and seed, the
misses, the dip's place, the pooled mean vx^2 and the profile to
``artifacts/physics_targets_torch/jax_dip_seeds.json``: the rate at
which the JAX package itself meets the asserts, beside which
tests/test_torch_physics_targets.py holds the port's scan on the card.
"""

import argparse
import concurrent.futures
import glob
import json
import multiprocessing
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "artifacts", "physics_targets_torch",
                   "jax_dip_seeds.json")
SEEDS = range(1, 18)


def one(case_seed):
    """The JAX test's run and recipe for one ((detSP, detDP, n_right),
    seed)."""
    (det_sp, det_dp, n_right), seed = case_seed
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_physics_targets as tpt
    from mdqtplasmasims_tpu.experiments.laser_cooling import (
        CoolingConfig, build_engine, run)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = CoolingConfig(n0=256, tmax=3.0, sample_freq=50,
                            use_pallas=False, detuning=det_sp,
                            detuning_dp=det_dp, save_directory=tmp)
        run(cfg, seed=seed)
        files = tpt.dip_files(glob.glob(os.path.join(tmp, "*", "job1"))[0])
        centers, prof = tpt.dip_profile(files, build_engine(cfg)
                                        .plas_to_quant_vel)
        v_res = tpt.v_resonance(det_sp, det_dp)
        return (tpt.dip_name(det_sp, det_dp), str(seed), dict(
            misses=tpt.dip_misses(centers, prof, v_res, n_right),
            v_dip=tpt.dip_values(centers, prof, v_res)["v_dip"],
            v2=float(np.mean(tpt.dip_rows(files)[:, 0] ** 2)),
            profile=[float(x) if np.isfinite(x) else None for x in prof]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_physics_targets as tpt
    jobs = [(case, seed) for case in tpt.DIP_CASES for seed in SEEDS]
    out = {tpt.dip_name(c[0], c[1]): {} for c in tpt.DIP_CASES}
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.workers,
                                                mp_context=spawn) as pool:
        for name, seed, rec in pool.map(one, jobs):
            out[name][seed] = rec
            print(name, seed, rec["v_dip"], rec["misses"], flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
