#!/usr/bin/env python3
"""Transport pooled's anisotropy stages replayed in float64 on the host: is
the port's float32 arithmetic what moves its relaxed anisotropy?

    python tools/torch_transport_replay.py [--out DIR] [--device cuda|cpu]
                                           [--tiny]

Runs ``tools/torch_validate_all.py``'s ``transport_pooled`` fold (the JAX
tool's configuration, k = 16, seed 7) and keeps each recorded anisotropy
stage of the pipeline (``mc_md_anisotropy.md_stage`` with
``record="temp_axes"``: the instantaneous rescale, the laser force, the
relaxation; each deterministic from its start).  Each stage then runs
again in float64 on the host from the fold's own start of it (the same
members, steps and options; forces recomputed).  Per observable of
``fw_job_stats`` that a stage gives, the report holds the fold's and the
replay's member values and the mean of their differences with its
standard error, and per stage the largest |A_fold(t) - A_f64(t)|.  This
splits the float32 arithmetic from the random stream; on the CPU in
float64 the differences are 0.

Writes ``report.json`` into ``--out`` (default
``artifacts/transport_replay_torch``); exit 2 without a card unless
``--device cpu`` (float64 twins, for the tests; ``--tiny``: the matrix
tool's cut, k = 2).  Imports torch, numpy and ``mdqtplasmasims_torch``
(and ``tools/torch_validate_all.py``, ``tools/torch_soak.py``) only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

import numpy as np
import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import torch_soak  # noqa: E402
import torch_validate_all as tva  # noqa: E402

OUT = os.path.join(torch_soak.ROOT, "artifacts", "transport_replay_torch")

# the recorded stages in order and the observables each stage's A(t)
# gives (fw_job_stats' windows)
ANISO_WINDOWS = (
    {"inst_A_early": slice(None, 50), "inst_A_late": slice(-100, None)},
    {"force_A_end": slice(-50, None)},
    {"relax_A_end": slice(-100, None)})


@contextlib.contextmanager
def kept_stages():
    """While open, each recorded anisotropy stage of the transport
    pipeline is appended to the yielded list: its members, start
    ``(R, V, A)``, steps, options and record."""
    from mdqtplasmasims_torch.experiments import mc_md_anisotropy as tr
    own, kept = tr.md_stage, []

    def keeping(cfg, m, R, V, A, n_steps, **kw):
        out = own(cfg, m, R, V, A, n_steps, **kw)
        if kw.get("record") == "temp_axes":
            kept.append((m, R, V, A, n_steps, kw, out[1]))
        return out
    tr.md_stage = keeping
    try:
        yield kept
    finally:
        tr.md_stage = own


def replay(cfg, kept: list) -> dict:
    """Each kept stage again in float64 on the host from the fold's own
    start of it; per observable the fold's and the replay's member values
    and their mean difference with its standard error, per stage the
    largest |A_fold(t) - A_f64(t)|."""
    from mdqtplasmasims_torch.core.pipeline import Members, _forces, md_stage
    out = {}
    for windows, (m, R, V, _, n, kw, rec) in zip(ANISO_WINDOWS, kept):
        m64 = Members(m.gamma, m.ldeb, m.draws,
                      _forces(cfg, m.ldeb, m.E == 1))
        R64, V64 = (x.detach().to("cpu", torch.float64) for x in (R, V))
        _, rec64 = md_stage(cfg, m64, R64, V64, m64.forces(R64), n, **kw)
        a_fold, a64 = (tva._aniso(x) for x in
                       (rec.detach().double().cpu().numpy(), rec64.numpy()))
        for key, sl in windows.items():
            f, d = a_fold[:, sl].mean(1), a64[:, sl].mean(1)
            diff = f - d
            out[key] = dict(
                fold=f.tolist(), float64=d.tolist(),
                mean_diff=float(diff.mean()),
                se_diff=float(diff.std(ddof=1) / math.sqrt(len(diff)))
                if len(diff) > 1 else 0.0)
        out[f"max_curve_diff_{'_'.join(windows)}"] = float(
            np.abs(a_fold - a64).max())
    return out


def run(args) -> dict:
    from mdqtplasmasims_torch.experiments import mc_md_anisotropy as tr
    device = torch.device(args.device)
    dtype = "float32" if device.type == "cuda" else "float64"
    over = tva.TINY["transport_pooled"] if args.tiny else {}
    k = tva.TINY_JOBS if args.tiny else tva.parse_step("transport_pooled")["k"]
    cfg = tr.MCTransportConfig(dtype=dtype, **dict(tva.TRANSPORT, **over))
    torch_soak.sync_cards(device)
    t0 = time.perf_counter()
    with kept_stages() as kept:
        res = tr.run_ensemble(cfg, k, seed=tva.TRANSPORT_SEED, device=device)
    torch_soak.sync_cards(device)
    t1 = time.perf_counter()
    stages = replay(cfg, kept)
    t2 = time.perf_counter()
    jobs = [tva.fw_job_stats(r, cfg.record_steps) for r in res]
    keys = [key for w in ANISO_WINDOWS for key in w]
    return dict(device=torch_soak.run_meta(device), dtype=dtype,
                tiny=args.tiny, cut=over, k=k,
                seeds=tva.seeds_of("transport_pooled", k),
                fold=tva.pool(jobs, keys), replay=stages,
                fold_wall_s=t1 - t0, replay_wall_s=t2 - t1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (float64 twins, for tests)")
    ap.add_argument("--tiny", action="store_true",
                    help="the matrix tool's cut, k = 2 (a quick run)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("torch_transport_replay: no CUDA device (--device cpu for "
                  "the float64 twins)", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"libraries built in {torch_soak.build_libraries():.1f} s",
              flush=True)
    rep = run(args)
    for key, r in rep["replay"].items():
        if isinstance(r, dict):
            print(f"[replay] {key}: fold {np.mean(r['fold']):.6g}, float64 "
                  f"{np.mean(r['float64']):.6g}, diff {r['mean_diff']:.3g} "
                  f"+- {r['se_diff']:.3g}", flush=True)
        else:
            print(f"[replay] {key}: {r:.3g}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "report.json")
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)
    print(f"wrote {path} (fold {rep['fold_wall_s']:.1f} s, replay "
          f"{rep['replay_wall_s']:.1f} s, {rep['device']['card']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
