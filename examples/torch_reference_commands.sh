#!/usr/bin/env bash
# One-to-one migration map on one NVIDIA GPU (the PyTorch + CUDA port's
# counterpart of reference_commands.sh): each of the reference's 11
# compiled programs and how to run the equivalent experiment through
# `python -m mdqtplasmasims_torch.cli` (the `mdqt-torch` command).  In the
# reference every parameter change meant editing constants and recompiling
# (README.md:40-55); here everything is a CLI flag, and `--jobs K` replaces
# the SLURM array (sequential in-process; see torch_run_ensemble.sh for
# the one-fold ensemble of the cooling family).
#
# All physics defaults (detuning, Rabi frequency, pump window, ...) match
# the constants compiled into the corresponding reference file, so a bare
# invocation reproduces that program's behavior.  `--device cuda` launches
# the hand-written kernels (the default; `--device cpu` runs their plain
# torch twins).
set -euo pipefail

# laserCoolingPlusExpansionMDQTSpeedUp.cpp  (flagship; the README's
# N0=3500 / tmax=30 production run)
python -m mdqtplasmasims_torch.cli cooling --n0 3500 --tmax 30 \
    --save-directory dataLaserCool/ --job 1 --device cuda

# LaserCoolingPlusExpansionMDQT.cpp  (pre-SpeedUp generation: same physics
# per README.md:30, plus its interval-VAF and LCCF diagnostics)
python -m mdqtplasmasims_torch.cli cooling --n0 3500 --tmax 30 \
    --vaf-intervals 3,5,7,9,11,13,15,17,19,21,23,25,27 \
    --record-lccf true --save-directory dataLaserCoolOld/ --device cuda

# laserCoolingPlasmaMagnesium.cpp  (byte-identical duplicate of the
# flagship — verified by diff; same command as the flagship)

# MonteCarloFollowedByMDAndTempAnisotropy.cpp  (classical transport +
# temperature-anisotropy relaxation)
python -m mdqtplasmasims_torch.cli transport --n 4096 --gamma 3 \
    --kappa 0.5 --save-directory dataTransport/ --jobs 8 --device cuda

# MonteCarloFollowedByQTTagging408Linear.cpp / 408Quad / 422Linear
python -m mdqtplasmasims_torch.cli mc-tag --variant 408linear --jobs 8 \
    --save-directory dataSpinTagLin/ --device cuda
python -m mdqtplasmasims_torch.cli mc-tag --variant 408quad --jobs 8 \
    --save-directory dataSpinTagQuad/ --device cuda
python -m mdqtplasmasims_torch.cli mc-tag --variant 422linear --jobs 8 \
    --save-directory dataSpinTag422/ --device cuda

# randomFrozenStartTag408Linear.cpp / 408Quad / 422Linear
python -m mdqtplasmasims_torch.cli frozen-tag --variant 408linear \
    --jobs 8 --save-directory data408/ --device cuda
python -m mdqtplasmasims_torch.cli frozen-tag --variant 408quad \
    --jobs 8 --save-directory data408quad/ --device cuda
python -m mdqtplasmasims_torch.cli frozen-tag --variant 422linear \
    --jobs 8 --save-directory data422/ --device cuda

# laserCoolNoPlasmaThreeState.cpp  (free-ion 3-level Doppler cooling demo)
python -m mdqtplasmasims_torch.cli three-state --detuning -0.5 --om 0.5 \
    --save-directory dataThreeState/ --device cuda
