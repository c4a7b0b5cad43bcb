#!/usr/bin/env bash
# The reference's exampleSlurmFile.slurm on one NVIDIA GPU (the PyTorch +
# CUDA port's counterpart of run_ensemble.sh): instead of a 10-99-way
# SLURM job array (one binary, 4 OpenMP threads, 8 h walltime per job),
# the whole ensemble runs as one fold on the card in one process.
#
# Reference workflow:            This port:
#   #SBATCH --array=1-16           --jobs 16 (one fold on the card: every
#   srun runFile $TASK_ID          MD step one launch of each kernel over
#   8 h per job                    all members' ions)
#   aggregate .dat offline         same job<k>/ tree + analysis.py helpers
set -euo pipefail

JOBS="${1:-16}"
OUT="${2:-dataLaserCool}"

# --mesh-ens K (and --mesh-ions I) spread the jobs over a K x I mesh of
# cards; the share-nothing families take the same flag on their
# batched/sweep subcommands.
python -m mdqtplasmasims_torch.cli cooling-ensemble \
    --jobs "$JOBS" \
    --n0 3500 --tmax 30 --save-directory "$OUT" --device cuda

python - <<PY
from mdqtplasmasims_torch.analysis import ensemble_temperature_curve, job_dirs
import glob
param_dir = sorted(glob.glob("$OUT/*"))[0]
curve = ensemble_temperature_curve(param_dir)
print(f"{len(job_dirs(param_dir))} jobs aggregated; "
      f"T(t={curve[-1,0]:.1f}) = {curve[-1,1]:.4f} E_c/k_B")
PY
