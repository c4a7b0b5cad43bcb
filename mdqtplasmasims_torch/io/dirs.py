"""Parameter-encoded output directory naming.

The port's own copy of ``mdqtplasmasims_tpu/io/dirs.py`` (the port imports
nothing of the JAX package).

The reference encodes run parameters into directory names as fixed-point
integers — effectively its experiment-tracking system (README.md:71-87).
Reproduced exactly for discoverability/interop:

  cooling  (laserCoolingPlusExpansionMDQTSpeedUp.cpp:1153):
    Ge%dDensity%dE+11Sig0%dTe%dSigFrac%dDetSP%dDetDP%dOmSP%dOmDP%dNumIons%d
  frozen tagging (randomFrozenStartTag422Linear.cpp:955):
    PumpTime%dPumpStart%dDet%dOm%dDensity%dGe%dNumIons%d
  MC transport (MonteCarloFollowedByMDAndTempAnisotropy.cpp:1043):
    Gamma%dKappa%dNumIons%d
  MC tagging (MonteCarloFollowedByQTTagging408Linear.cpp:1153):
    Gamma%dKappa%dNumIons%dPumpTime%dDet%dOm%dDensity%d
  three-state toy (laserCoolNoPlasmaThreeState.cpp:371-374):
    Om%d/Det%dNumIons%dInitialTemp%duK

All use C unsigned casts of scaled doubles (truncation toward zero after the
scale); job subdirectories are ``job%d/``.
"""

from __future__ import annotations

import os


def _u(x: float) -> int:
    """C (unsigned) cast of a double: truncate toward zero."""
    return int(x)


def cooling_dir(base: str, *, ge, density, sig0, te, frac_of_sig, detuning,
                detuning_dp, om, om_dp, n0, job) -> str:
    name = (f"Ge{_u(100 * ge)}Density{_u(density * 1000)}E+11"
            f"Sig0{_u(10 * sig0)}Te{_u(te)}SigFrac{_u(frac_of_sig * 100)}"
            f"DetSP{_u(detuning * 100)}DetDP{_u(detuning_dp * 100)}"
            f"OmSP{_u(om * 100)}OmDP{_u(om_dp * 100)}NumIons{_u(n0)}")
    return os.path.join(base, name, f"job{job}")


def frozen_tag_dir(base: str, *, tpump_seconds, tstart, detuning, om,
                   density, ge, n0, job) -> str:
    name = (f"PumpTime{_u(1e9 * tpump_seconds)}PumpStart{_u(tstart)}"
            f"Det{_u(100 * abs(detuning))}Om{_u(100 * om)}"
            f"Density{_u(10 * density)}Ge{_u(1000 * ge)}NumIons{_u(n0)}")
    return os.path.join(base, name, f"job{job}")


def mc_transport_dir(base: str, *, gamma, kappa, n, job) -> str:
    name = f"Gamma{_u(gamma * 100)}Kappa{_u(kappa * 100)}NumIons{_u(n)}"
    return os.path.join(base, name, f"job{job}")


def mc_tag_dir(base: str, *, gamma, kappa, n, tpump_seconds, detuning, om,
               density, job, date_stamp: str | None = None) -> str:
    """``date_stamp`` reproduces the 422 variant's ``Date%m%d%y`` suffix
    (MonteCarloFollowedByQTTagging422Linear.cpp:1127-1134, strcat'd onto
    the param name before mkdir); the 408 variants have it commented out
    (e.g. 408Quad.cpp:1162-1165), so callers pass None there."""
    name = (f"Gamma{_u(gamma * 100)}Kappa{_u(kappa * 100)}NumIons{_u(n)}"
            f"PumpTime{_u(1e9 * tpump_seconds)}Det{_u(100 * abs(detuning))}"
            f"Om{_u(100 * om)}Density{_u(10 * density)}")
    if date_stamp is not None:
        name += date_stamp
    return os.path.join(base, name, f"job{job}")


def three_state_dir(base: str, *, om, detuning, n0, temperature_k, job) -> str:
    return os.path.join(
        base, f"Om{_u(om * 100)}",
        f"Det{_u(detuning * 100)}NumIons{_u(n0)}"
        f"InitialTemp{_u(temperature_k * 1_000_000)}uK",
        f"job{job}")
