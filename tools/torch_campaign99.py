#!/usr/bin/env python3
"""The reference's 99-job production campaign on one NVIDIA GPU: the
PyTorch + CUDA port's counterpart of ``tools/campaign99.py``.

    python tools/torch_campaign99.py

The reference's production workload is a 99-way SLURM array of the
flagship N0=3500 / tmax=30 laser-cooling run (exampleSlurmFile.slurm:3).
This runs the whole array as one 99-member fold of
``run_ensemble(CoolingConfig(n0=3500, tmax=30, sample_freq=40,
checkpoint_every_segments=10), n_jobs=99, seed=7)``, the JAX script's
configuration: every MD step is one launch of the batched force kernel
(kernel C) and one of the tick kernel with its in-kernel RNG (B'rng) over
all 99 x 3584 lanes, and every sample one launch of the batched potential
kernel (G).  ``checkpoint_every_segments=10`` writes nothing here (no
``save_directory``); it groups the fold's output fetches, so the card
holds at most 10 segments of per-sample outputs.

The ion count is pinned (``exact_n=True``, CoolingConfig's default), as
in the JAX script: its docstring speaks of Poissonian counts, but it
leaves ``exact_n`` at the default, and the archived physics it is held
to (RESULTS.md:214-231) came from the script as written.  The
Poissonian fold at production depth is the soak's 8-member
``cooling_poisson_ensemble``.

It prints the JAX script's line (wall, aggregate ion-QT-updates/s, the
DIH peak of the member-mean EkinX, the cooling ratio and the spread of
the members' final EkinX), then one JSON line with :func:`campaign`'s
dict.  The kernel libraries are built before the run is timed.  Runs on
CUDA only (exit 2 without a card); :func:`campaign` takes ``device="cpu"``
for the tests.  Imports torch, numpy and ``mdqtplasmasims_torch`` (and
``tools/torch_soak.py``'s timing and launch counters) only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import torch_soak  # noqa: E402  (puts the repository root on sys.path)

# tools/campaign99.py's configuration
CAMPAIGN = dict(n0=3500, tmax=30.0, sample_freq=40,
                checkpoint_every_segments=10)
N_JOBS = 99
SEED = 7


def campaign_config(**over):
    """``CoolingConfig(**CAMPAIGN)`` with keyword overrides."""
    from mdqtplasmasims_torch.experiments.laser_cooling import CoolingConfig
    return CoolingConfig(**dict(CAMPAIGN, **over))


def campaign_metrics(outs: dict, cfg, n_jobs: int, wall: float) -> dict:
    """The campaign's numbers from the fold's outputs, statement for
    statement tools/campaign99.py:31-40: the DIH peak (t <= 8) of the
    member-mean EkinX, the cooling ratio (t >= 25 over the peak), the
    spread of the members' EkinX at the last sample (t = 30 uncut), and
    the aggregate ion-QT-updates/s over ``wall``."""
    ekx = np.asarray(outs["ekin"], np.float64)[:, :, 0]
    t = np.asarray(outs["t"], np.float64)[0]
    early, late = t <= 8.0, t >= 25.0
    i_pk = int(np.argmax(ekx.mean(0)[early]))
    ticks = n_jobs * cfg.n0 * int(round(cfg.tmax / cfg.timestep)) * cfg.ratio
    return dict(wall_s=wall, agg_updates_per_s=ticks / wall,
                dih_peak_t=float(t[early][i_pk]),
                dih_peak_ekin_x=float(ekx.mean(0)[early][i_pk]),
                cooling_ratio=float(ekx.mean(0)[late].mean()
                                    / ekx.mean(0)[early][i_pk]),
                job_spread_t30=float(ekx[:, -1].std()))


def campaign_line(m: dict) -> str:
    """tools/campaign99.py's printed line from :func:`campaign_metrics`."""
    return (f"{m['n_jobs']}-job campaign: wall {m['wall_s']:.0f}s, agg "
            f"{m['agg_updates_per_s']/1e6:.0f}M updates/s, DIH peak "
            f"t={m['dih_peak_t']:.2f} EkinX={m['dih_peak_ekin_x']:.3f}, "
            f"cooling ratio {m['cooling_ratio']:.3f}, job spread at t=30: "
            f"{m['job_spread_t30']:.4f}")


def campaign_run(device="cuda", n_jobs: int = N_JOBS, seed: int = SEED, *,
                 states=None, rolls_fn=None, **over):
    """Run the campaign (``over``: CoolingConfig overrides; ``states`` and
    ``rolls_fn`` go to ``run_ensemble``, for tests that replay another
    implementation's start and draws): ``(metrics, final, outs)``.  The
    wall runs from a synced card to ``run_ensemble``'s return, which ends
    in a host fetch; the metrics add the kernels' launches in the run and
    the card's peak allocated memory (None on the CPU)."""
    from mdqtplasmasims_torch.experiments.laser_cooling import run_ensemble
    cfg = campaign_config(**over)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    (final, outs), wall, launches = torch_soak._timed(
        device, lambda: run_ensemble(cfg, n_jobs, seed, device=device,
                                     states=states, rolls_fn=rolls_fn))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    m = dict(n_jobs=n_jobs, n0=cfg.n0, tmax=cfg.tmax,
             **campaign_metrics(outs, cfg, n_jobs, wall),
             launches=launches, max_memory_allocated=peak)
    return m, final, outs


def campaign(device="cuda", n_jobs: int = N_JOBS, seed: int = SEED,
             **kw) -> dict:
    """:func:`campaign_run`'s metrics alone."""
    return campaign_run(device, n_jobs, seed, **kw)[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_campaign99: no CUDA device; the campaign runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meta = torch_soak.run_meta("cuda")
    print(f"card: {meta['card']}; libraries built in "
          f"{torch_soak.build_libraries():.1f} s", file=sys.stderr)
    m = campaign()
    print(campaign_line(m))
    print(json.dumps(m), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
