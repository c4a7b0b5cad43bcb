#!/usr/bin/env bash
# The reference chains 8-hour SLURM walltime windows per job by
# restarting with newRun=0, c0=<last timestep> (README.md:51-53).  On the
# PyTorch + CUDA port (the counterpart of walltime_chaining.sh) the same
# workflow is two invocations of the same command — the second with
# --resume and a larger --tmax, continuing from the first window's
# checkpoint.
set -euo pipefail

OUT="${1:-dataTag422}"

# window 1: DIH, pump window, tag, record to t=12
python -m mdqtplasmasims_torch.cli frozen-tag \
    --variant 422linear --n0 3500 --tstart 10 --tmax 12 \
    --save-directory "$OUT" --device cuda

# window 2: continue post-tag recording to t=25 from the checkpoint
python -m mdqtplasmasims_torch.cli frozen-tag \
    --variant 422linear --n0 3500 --tstart 10 --tmax 25 \
    --save-directory "$OUT" --resume --device cuda

# the cooling flagship chains identically (cooling --resume /
# cooling-ensemble --resume)
