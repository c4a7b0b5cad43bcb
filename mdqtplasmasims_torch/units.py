"""Unit systems and derived constants for the MDQT plasma framework.

The port's own copy of ``mdqtplasmasims_tpu/units.py`` (the port imports
nothing of the JAX package); the constants are held equal to it by
tests/test_torch_selfcontained.py.

The simulation couples two clocks and two velocity scales:

* **Plasma units** — lengths in the Wigner-Seitz radius ``a``, times in the
  inverse Einstein frequency ``1/omega_E``, velocities in ``a*omega_E``.
* **Quantum units** — times in the inverse S->P linewidth ``1/gamma``,
  velocities in ``gamma/k`` (Doppler shifts measured in linewidths).

The conversion factors are transcribed from the reference programs (values
cited per file:line of the reference C++ programs):

* ``gamToEinsteinFreq = 174.07/sqrt(density)`` for the 408-nm/Sr+ system
  (gamma = 1.41e8 s^-1), laserCoolingPlusExpansionMDQTSpeedUp.cpp:79, and
  ``174.07*0.894/sqrt(density)`` for the 422-nm system (gamma = 1.26e8 s^-1),
  randomFrozenStartTag422Linear.cpp:66.
* ``plasVelToQuantVel = 1.1821*density^(1/6)`` (x0.967 for 422 nm),
  laserCoolingPlusExpansionMDQTSpeedUp.cpp:85, randomFrozenStartTag422Linear.cpp:74.
* quantum/MD timestep ratio: ``ceil(34.81/sqrt(density))`` for the flagship
  cooling code (MD dt = 0.002/omega_E, quantum dt = 0.01/gamma),
  laserCoolingPlusExpansionMDQTSpeedUp.cpp:83; ``round(34.81*0.894/sqrt(d))``
  for the frozen 422 code (randomFrozenStartTag422Linear.cpp:72);
  ``round(87/sqrt(n))`` for the MC-tagging family which uses MD dt = 0.005
  (MonteCarloFollowedByQTTagging408Quad.cpp:111).
* pump time seconds -> omega_E*t: ``tpump = tpumpreal*813490*sqrt(density)``
  (randomFrozenStartTag422Linear.cpp:78).
* photon recoil ``vKick = 0.001208/plasVelToQuantVel`` (408 nm, flagship
  laserCoolingPlusExpansionMDQTSpeedUp.cpp:148) and ``0.001257/...`` (422 nm,
  randomFrozenStartTag422Linear.cpp:117); D->P (1033 nm) recoil is
  ``vKick*kRat`` with ``kRat = 0.395`` (lines 147-149).
"""

from __future__ import annotations

import dataclasses
import math

# omega_E*t per second at density = 1 (in 1e14 m^-3):
# randomFrozenStartTag422Linear.cpp:78
SECONDS_TO_EINSTEIN_TIME = 813490.0

# gamma_{408} / omega_E at density = 1: laserCoolingPlusExpansionMDQTSpeedUp.cpp:79
GAMMA408_TO_EINSTEIN = 174.07
# gamma_{422}/gamma_{408} = 1.26e8/1.41e8: randomFrozenStartTag422Linear.cpp:66
GAMMA422_FACTOR = 0.894
# k_{422}/k_{408} wavevector correction: randomFrozenStartTag422Linear.cpp:74
K422_FACTOR = 0.967

# a*omega_E -> gamma/k velocity conversion at density = 1:
# laserCoolingPlusExpansionMDQTSpeedUp.cpp:85
PLAS_TO_QUANT_VEL = 1.1821

# photon recoil hbar*k/m in quantum velocity units (gamma/k):
VKICK_408_QUANTUM = 0.001208  # laserCoolingPlusExpansionMDQTSpeedUp.cpp:148
VKICK_422_QUANTUM = 0.001257  # randomFrozenStartTag422Linear.cpp:117
K_RATIO_1033 = 0.395          # k_{1033}/k_{408}: laserCoolingPlusExpansionMDQTSpeedUp.cpp:147

# MB velocity spread prefactor sqrt(T[K]) -> plasma units used by the
# three-state toy: laserCoolNoPlasmaThreeState.cpp:83
SQRT_KELVIN_TO_PLASMA_VEL = 1.0508


@dataclasses.dataclass(frozen=True)
class PlasmaUnits:
    """Classical Yukawa-OCP scales for a given density / screening.

    ``density`` is in units of 1e14 m^-3 (reference convention).  ``Ge`` is
    the electron coupling parameter; the Debye length is ``1/sqrt(3*Ge)`` in
    units of ``a`` (laserCoolingPlusExpansionMDQTSpeedUp.cpp:295).  The MC/MD
    transport family instead specifies ``kappa = a/lambda_D`` directly
    (MonteCarloFollowedByMDAndTempAnisotropy.cpp:67) — use
    :func:`PlasmaUnits.from_kappa`.
    """

    density: float
    Ge: float = 0.1

    @classmethod
    def from_kappa(cls, kappa: float, density: float = 1.0) -> "PlasmaUnits":
        return cls(density=density, Ge=kappa * kappa / 3.0)

    @property
    def kappa(self) -> float:
        return math.sqrt(3.0 * self.Ge)

    @property
    def debye_length(self) -> float:
        """Debye length in units of a (laserCooling...SpeedUp.cpp:295)."""
        return 1.0 / math.sqrt(3.0 * self.Ge)

    @staticmethod
    def box_length(n0: int) -> float:
        """Cubic cell size holding n0 ions at unit density in units of a
        (laserCoolingPlusExpansionMDQTSpeedUp.cpp:297)."""
        return (n0 * 4.0 * math.pi / 3.0) ** (1.0 / 3.0)


@dataclasses.dataclass(frozen=True)
class QTUnits:
    """Quantum<->plasma conversions for one laser system.

    ``gamma_to_einstein`` converts a time in 1/omega_E to a time in 1/gamma,
    ``plas_to_quant_vel`` converts a*omega_E velocities to gamma/k units.
    """

    density: float
    gamma_factor: float = 1.0  # 1.0 for 408 nm, 0.894 for 422 nm
    k_factor: float = 1.0      # 1.0 for 408 nm, 0.967 for 422 nm

    @property
    def gamma_to_einstein(self) -> float:
        return GAMMA408_TO_EINSTEIN * self.gamma_factor / math.sqrt(self.density)

    @property
    def plas_to_quant_vel(self) -> float:
        return PLAS_TO_QUANT_VEL * self.density ** (1.0 / 6.0) * self.k_factor

    # --- timestep ratios -------------------------------------------------
    def ratio_cooling(self) -> int:
        """Quantum substeps per MD step for the flagship cooling code
        (MD dt 0.002, quantum dt 0.01/gamma): ceil(34.81/sqrt(density)),
        laserCoolingPlusExpansionMDQTSpeedUp.cpp:83."""
        return int(math.ceil(34.81 * self.gamma_factor / math.sqrt(self.density)))

    def ratio_frozen(self) -> int:
        """Same quantity but rounded, as used by the frozen-start tagging
        family (randomFrozenStartTag422Linear.cpp:72)."""
        return int(round(34.81 * self.gamma_factor / math.sqrt(self.density)))

    def ratio_mc_tagging(self) -> int:
        """Quantum substeps per MD step for the MC-equilibrated tagging
        family (MD dt 0.005): round(87/sqrt(n)) for 408 nm
        (MonteCarloFollowedByQTTagging408Quad.cpp:111) scaled by the
        gamma factor for 422 nm."""
        return int(round(87.0 * self.gamma_factor / math.sqrt(self.density)))


def qt_units_408(density: float) -> QTUnits:
    return QTUnits(density=density)


def qt_units_422(density: float) -> QTUnits:
    return QTUnits(density=density, gamma_factor=GAMMA422_FACTOR, k_factor=K422_FACTOR)


def pump_window_einstein(tpump_seconds: float, density: float) -> float:
    """Optical-pumping duration in omega_E*t (randomFrozenStartTag422Linear.cpp:78)."""
    return tpump_seconds * SECONDS_TO_EINSTEIN_TIME * math.sqrt(density)


def expansion_detuning(t: float, density: float, sig0: float, Te: float,
                       frac_of_sig: float) -> float:
    """Time-dependent detuning of the expanding-frame cooling lasers, in
    units of gamma (laserCoolingPlusExpansionMDQTSpeedUp.cpp:447)."""
    return (0.0126 * frac_of_sig * Te * t
            / (math.sqrt(density) * sig0
               * math.sqrt(1.0 + 0.00014314 * t * t * Te / (density * sig0 * sig0))))
