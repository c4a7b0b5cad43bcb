"""Level-scheme tables for the quantum-trajectory engine.

The port's own copy of ``mdqtplasmasims_tpu/levels.py`` (the port imports
nothing of the JAX package); its tables are held equal to the JAX
package's by tests/test_torch_selfcontained.py.

The reference implements four separate ``qstep()`` variants (12-state Sr+
cooling, 7-state 408-nm tagging, 5-state 422-nm tagging, 3-state toy).  Here
each becomes *data*: a :class:`LevelScheme` bundling

* ``decay_w[s]``     — diagonal decay weights; the jump probability per
  quantum tick is ``dp = h * sum_s decay_w[s]*|psi_s|^2`` and the
  non-Hermitian decay Hamiltonian is ``-i/2 * diag(decay_w)``.
* ``e0[s], e1[s]``   — diagonal (rotating-frame) energies ``e0 + e1*u`` with
  ``u = v_quant + expansion_detuning``.
* ``coupling[s,s]``  — static laser-coupling matrix (Hermitian, both
  triangles included).
* time-dependent couplings (the two D->P channels that beat against the
  counter-propagating pair in the 12-state scheme) as index/coefficient
  tables with phase ``exp(i * tdep_freq * u * t_gamma)``.
* Ehrenfest-force terms ``kick = h * sum_k force_w[k]*Im(psi_a psi_b^*)``.
* jump tables: which states a jump projects from, the S-vs-D branching
  ratio, and the destination distribution per (source, branch).
* recoil magnitudes (zero for the tagging schemes, which pump without
  momentum kicks — verified against the reference, see SURVEY.md L4).

All tables are plain numpy, built once per configuration; the engine bakes
them into the tick kernel's tables (core/qt_fused.py) as constants.

Sources (file:line of the reference C++ programs):
  12-state: laserCoolingPlusExpansionMDQTSpeedUp.cpp:1163-1215 (cs/gs and
            operators), 438-717 (qstep), 146-149 (recoil constants).
  7-state:  MonteCarloFollowedByQTTagging408Quad.cpp:1174-1193 (cs/gs),
            554-755 (qstep); the *Linear* variant differs only in the
            coupling matrix (MonteCarloFollowedByQTTagging408Linear.cpp:597).
  5-state:  randomFrozenStartTag422Linear.cpp:965-976 (cs/gs), 390-566 (qstep).
  3-state:  laserCoolNoPlasmaThreeState.cpp:384-387 (cs/gs), 140-293 (qstep).

NOTE on gs conventions: the 12-state SpeedUp code stores *amplitudes*
(gs = sqrt(rate)) and squares them where rates are needed, while the 5/7-state
tagging codes store *rates* directly and take sqrt() for couplings.  The
tables below are expressed uniformly in **rates**, transcribed so that every
derived quantity (decay_w, coupling, jump probabilities, force weights)
matches the corresponding reference file exactly.

NOTE on the pre-SpeedUp generation: LaserCoolingPlusExpansionMDQT.cpp (the
original file, superseded per reference README.md:30) builds gs as *rates*
(:1198-1216) and uses gs (not gs^2) in the jump operator and collapse
chains — which is algebraically IDENTICAL to the SpeedUp amplitudes under
gs_rate = gs_amp^2.  The only behavioral physics delta is the DP Ehrenfest
kick prefactor: OmDP/sqrt(decayRatio) (old :502) vs OmDP/decayRatio
(SpeedUp :503), i.e. the old DP optical force is sqrt(dr)~1/4 of the
SpeedUp one.  Select it with ``sr12_cooling(gs_convention="pre_speedup")``
or ``CoolingConfig(physics="pre_speedup")``; the old file's *diagnostics*
(interval VAF, LCCF) are CoolingConfig.vaf_intervals / record_lccf.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Branching ratio of D-state decay to S-state decay for the P manifold.
DECAY_RATIO_D52_408 = 0.0617   # laserCoolingPlusExpansionMDQTSpeedUp.cpp:146
DECAY_RATIO_422 = 0.0754       # randomFrozenStartTag422Linear.cpp:116
DECAY_RATIO_422_MC = 0.0753    # MonteCarloFollowedByQTTagging422Linear.cpp


@dataclasses.dataclass(frozen=True, eq=False)
class LevelScheme:
    # eq=False: identity-based hash so schemes can ride in hashed
    # (cached) configs (the table arrays are not hashable)
    """Static data defining one atom-light system for the QT engine."""

    name: str
    n_states: int
    decay_w: np.ndarray          # [S] float
    e0: np.ndarray               # [S] float
    e1: np.ndarray               # [S] float
    coupling: np.ndarray         # [S,S] complex (Hermitian)
    # time-dependent coupling entries: H[r,c] += coef * exp(i*tdep_freq*u*t_gamma)
    tdep_rows: Tuple[int, ...]
    tdep_cols: Tuple[int, ...]
    tdep_coefs: Tuple[complex, ...]
    tdep_freq: float
    # Ehrenfest force: kick = h * sum_k w_k * Im(psi[a_k] * conj(psi[b_k]))
    force_a: Tuple[int, ...]
    force_b: Tuple[int, ...]
    force_w: Tuple[float, ...]
    # jump tables
    jump_src: Tuple[int, ...]          # states a jump can project from
    branch_d_prob: float               # P(decay into D) = r/(1+r)
    jump_dest: np.ndarray              # [S, 2, S]: P(dest | src, branch) b=0:S, b=1:D
    # recoil
    kick_s: float = 0.0
    kick_d: float = 0.0
    apply_recoil: bool = False

    @property
    def has_force(self) -> bool:
        return self.apply_recoil or len(self.force_w) > 0


def _dest_table(n: int, entries: dict) -> np.ndarray:
    """Build [S,2,S] destination table from {(src, branch): [(dest, p), ...]}."""
    tab = np.zeros((n, 2, n), dtype=np.float64)
    for (src, br), dests in entries.items():
        for dest, p in dests:
            tab[src, br, dest] += p
    return tab


def sr12_cooling(detuning: float = -1.0, detuning_dp: float = 1.0,
                 om: float = 1.0, om_dp: float = 1.0,
                 decay_ratio: float = DECAY_RATIO_D52_408,
                 gs_convention: str = "speedup") -> LevelScheme:
    """12-state Sr+ S1/2 + P1/2(4) + D5/2(6) cooling scheme.

    State order (laserCoolingPlusExpansionMDQTSpeedUp.cpp:156-167):
      0: S -1/2   1: S +1/2
      2: P +3/2   3: P +1/2   4: P -1/2   5: P -3/2
      6..11: D -5/2 .. +5/2

    ``gs_convention`` selects the generation of the reference physics:
    ``"speedup"`` (default) follows laserCoolingPlusExpansionMDQTSpeedUp
    (the current file per reference README.md:30); ``"pre_speedup"``
    reproduces the original LaserCoolingPlusExpansionMDQT.cpp.  The two
    differ ONLY in the DP Ehrenfest-kick prefactor — OmDP/decayRatio
    (SpeedUp.cpp:503) vs OmDP/sqrt(decayRatio) (old :502), a sqrt(dr)~1/4
    smaller DP force in the old generation.  All other apparent deltas
    (gs as rates vs amplitudes, gs vs gs^2 in the jump operator and
    collapse chains) cancel algebraically under gs_rate = gs_amp^2:
    old :481/:518/:534-579/:586-700 == SpeedUp :484-486/:1201-1205/
    :525-567/:573-703 exactly.
    """
    S = 12
    dr = decay_ratio
    # decay rates per channel (gs^2 of laserCooling...SpeedUp.cpp:1181-1198)
    # channels (dest, src): rate
    g2 = {
        (1, 2): 1.0, (1, 3): 2. / 3, (0, 3): 1. / 3, (0, 4): 2. / 3,
        (1, 4): 1. / 3, (0, 5): 1.0,
        (6, 5): dr * 2. / 3, (7, 5): dr * 4. / 15, (8, 5): dr * 1. / 15,
        (7, 4): dr * 2. / 5, (8, 4): dr * 2. / 5, (9, 4): dr * 1. / 5,
        (8, 3): dr * 1. / 5, (9, 3): dr * 2. / 5, (10, 3): dr * 2. / 5,
        (9, 2): dr * 1. / 15, (10, 2): dr * 4. / 15, (11, 2): dr * 2. / 3,
    }
    decay_w = np.zeros(S)
    for (_, src), rate in g2.items():
        decay_w[src] += rate           # each P state totals 1 + dr

    # diagonal energies (lines 506-511): u = v_quant + expansion detuning
    e0 = np.zeros(S)
    e1 = np.zeros(S)
    e0[2:6] = -detuning
    e1[2] = e1[3] = -1.0               # beam from the right
    e1[4] = e1[5] = +1.0               # beam from the left
    e0[6:12] = -detuning + detuning_dp
    kr = 0.3950                        # kRat, line 147
    e1[6] = e1[7] = (1.0 - kr)
    e1[10] = e1[11] = (kr - 1.0)
    e1[8] = e1[9] = -(1.0 + kr)

    # static couplings (lines 1206-1215): SP channels k in {0,2,4,5} with
    # coefficient -gs*Om/2; DP channels k in {6,9,12,14,15,17} with
    # -gs*OmDP/(2*sqrt(dr)).  cs[k] = |dest><src| so the coupling term is
    # -... * cs[k]^T = -...*|src><dest| plus its Hermitian conjugate.
    C = np.zeros((S, S), dtype=np.complex128)

    def couple(a, b, coef):
        C[a, b] += coef
        C[b, a] += np.conj(coef)

    couple(2, 1, -np.sqrt(g2[(1, 2)]) * om / 2)       # cs[0]^T: |3><2|
    couple(3, 0, -np.sqrt(g2[(0, 3)]) * om / 2)       # cs[2]^T
    couple(4, 1, -np.sqrt(g2[(1, 4)]) * om / 2)       # cs[4]^T
    couple(5, 0, -np.sqrt(g2[(0, 5)]) * om / 2)       # cs[5]^T
    dp_coef = om_dp / (2.0 * np.sqrt(dr))
    couple(5, 6, -np.sqrt(g2[(6, 5)]) * dp_coef)      # cs[6]^T: |6><7|
    couple(4, 7, -np.sqrt(g2[(7, 4)]) * dp_coef)      # cs[9]^T
    couple(3, 8, -np.sqrt(g2[(8, 3)]) * dp_coef)      # cs[12]^T
    couple(3, 10, -np.sqrt(g2[(10, 3)]) * dp_coef)    # cs[14]^T
    couple(2, 9, -np.sqrt(g2[(9, 2)]) * dp_coef)      # cs[15]^T
    couple(2, 11, -np.sqrt(g2[(11, 2)]) * dp_coef)    # cs[17]^T

    # time-dependent DP couplings (line 508): -OmDP/2 * gs/sqrt(dr) *
    # |9><6| and |10><5| (1-based) with phase exp(i*2*(1+kRat)*u*t_gamma).
    tdep_rows = (8, 9)
    tdep_cols = (5, 4)
    tdep_coefs = (complex(-np.sqrt(g2[(8, 5)]) * dp_coef),
                  complex(-np.sqrt(g2[(9, 4)]) * dp_coef))
    tdep_freq = 2.0 * (1.0 + kr)

    # Ehrenfest force (line 503).  kick is in plasma velocity units; the
    # vKick factors are supplied by the experiment via kick_s/kick_d, so the
    # force weights here carry everything *except* vKick:
    #   kick = h * [ kick_s*Om*sum(...) + kick_d*(OmDP/dr)*sum(...) ].
    # We fold kick_s/kick_d in when the scheme is instantiated with recoil
    # constants — see with_recoil().
    force_terms_sp = [(1, 2, np.sqrt(g2[(1, 2)]) * om),
                      (0, 3, np.sqrt(g2[(0, 3)]) * om),
                      (1, 4, -np.sqrt(g2[(1, 4)]) * om),
                      (0, 5, -np.sqrt(g2[(0, 5)]) * om)]
    assert gs_convention in ("speedup", "pre_speedup"), gs_convention
    dp_force = om_dp / (dr if gs_convention == "speedup" else np.sqrt(dr))
    force_terms_dp = [(8, 5, np.sqrt(g2[(8, 5)]) * dp_force),
                      (9, 4, np.sqrt(g2[(9, 4)]) * dp_force),
                      (10, 3, np.sqrt(g2[(10, 3)]) * dp_force),
                      (11, 2, np.sqrt(g2[(11, 2)]) * dp_force),
                      (6, 5, -np.sqrt(g2[(6, 5)]) * dp_force),
                      (7, 4, -np.sqrt(g2[(7, 4)]) * dp_force),
                      (8, 3, -np.sqrt(g2[(8, 3)]) * dp_force),
                      (9, 2, -np.sqrt(g2[(9, 2)]) * dp_force)]

    # jump destination tables (lines 573-703).  Source P sublevel chosen
    # prop. to population; S-vs-D branch with fixed prob dr/(1+dr); then
    # C-G-weighted destination rolls.
    dests = {
        (2, 0): [(1, 1.0)],
        (3, 0): [(0, g2[(0, 3)]), (1, 1.0 - g2[(0, 3)])],
        (4, 0): [(1, g2[(1, 4)]), (0, 1.0 - g2[(1, 4)])],
        (5, 0): [(0, 1.0)],
        (2, 1): [(11, g2[(11, 2)] / dr), (10, g2[(10, 2)] / dr),
                 (9, 1.0 - (g2[(11, 2)] + g2[(10, 2)]) / dr)],
        (3, 1): [(10, g2[(10, 3)] / dr), (9, g2[(9, 3)] / dr),
                 (8, 1.0 - (g2[(10, 3)] + g2[(9, 3)]) / dr)],
        (4, 1): [(9, g2[(9, 4)] / dr), (8, g2[(8, 4)] / dr),
                 (7, 1.0 - (g2[(9, 4)] + g2[(8, 4)]) / dr)],
        (5, 1): [(8, g2[(8, 5)] / dr), (7, g2[(7, 5)] / dr),
                 (6, 1.0 - (g2[(8, 5)] + g2[(7, 5)]) / dr)],
    }

    return LevelScheme(
        name=("sr12_cooling" if gs_convention == "speedup"
              else "sr12_cooling_pre_speedup"),
        n_states=S, decay_w=decay_w, e0=e0, e1=e1,
        coupling=C, tdep_rows=tdep_rows, tdep_cols=tdep_cols,
        tdep_coefs=tdep_coefs, tdep_freq=tdep_freq,
        force_a=tuple(a for a, _, _ in force_terms_sp + force_terms_dp),
        force_b=tuple(b for _, b, _ in force_terms_sp + force_terms_dp),
        force_w=tuple(w for _, _, w in force_terms_sp + force_terms_dp),
        jump_src=(2, 3, 4, 5), branch_d_prob=dr / (dr + 1.0),
        jump_dest=_dest_table(S, dests),
    )


def with_recoil(scheme: LevelScheme, kick_s: float, kick_d: float = 0.0) -> LevelScheme:
    """Attach photon-recoil magnitudes (plasma velocity units) to a scheme.

    The Ehrenfest force weights are scaled by the recoil: SP terms by
    ``kick_s`` and DP terms by ``kick_d`` (identified by whether either index
    is in the S manifold {0,1} for sr12, or all by kick_s otherwise) —
    matching laserCoolingPlusExpansionMDQTSpeedUp.cpp:503 where the SP sum is
    multiplied by vKick and the DP sum by vKickDP.
    """
    fw = []
    for a, b, w in zip(scheme.force_a, scheme.force_b, scheme.force_w):
        is_sp = a <= 1 or b <= 1
        fw.append(w * (kick_s if is_sp else kick_d))
    return dataclasses.replace(scheme, force_w=tuple(fw), kick_s=kick_s,
                               kick_d=kick_d, apply_recoil=True)


def tag408(detuning: float, om: float, linear: bool,
           decay_ratio: float = DECAY_RATIO_D52_408) -> LevelScheme:
    """7-state 408-nm tagging scheme: S1/2(2) + P3/2(4) + lumped D.

    State order (MonteCarloFollowedByQTTagging408Quad.cpp:126-132):
      0: S -1/2  1: S +1/2  2: P +3/2  3: P +1/2  4: P -1/2  5: P -3/2  6: D

    ``linear=True`` -> counter-propagating sigma+/sigma- pair driving 4
    channels (MonteCarloFollowedByQTTagging408Linear.cpp:597);
    ``linear=False`` -> single beam driving 2 channels (408Quad.cpp:596).
    Optical pumping only: no Ehrenfest force, no recoil (kick computed but
    never applied in the reference).
    """
    S = 7
    dr = decay_ratio
    g = {  # rates, (dest, src): MonteCarlo...408Quad.cpp:1174-1193
        (0, 2): 1.0, (0, 3): 2. / 3, (0, 4): 1. / 3,
        (1, 3): 1. / 3, (1, 4): 2. / 3, (1, 5): 1.0,
        (6, 2): dr, (6, 3): dr, (6, 4): dr, (6, 5): dr,
    }
    decay_w = np.zeros(S)
    for (_, src), rate in g.items():
        decay_w[src] += rate

    e0 = np.zeros(S)
    e1 = np.zeros(S)
    e0[2:6] = -detuning
    e1[2] = e1[3] = -1.0
    e1[4] = e1[5] = +1.0

    C = np.zeros((S, S), dtype=np.complex128)

    def couple(a, b, coef):
        C[a, b] += coef
        C[b, a] += np.conj(coef)

    # hamCouplingTermSP (drive terms |S><P|): Quad drives 2<->6, 1<->5;
    # Linear adds 2<->4 and 1<->3 (1-based state labels).
    couple(1, 5, -om / 2 * np.sqrt(g[(1, 5)]))
    couple(0, 4, -om / 2 * np.sqrt(g[(0, 4)]))
    if linear:
        couple(1, 3, -om / 2 * np.sqrt(g[(1, 3)]))
        couple(0, 2, -om / 2 * np.sqrt(g[(0, 2)]))

    dests = {  # MonteCarlo...408Quad.cpp:695-745
        (2, 0): [(0, 1.0)],
        (3, 0): [(0, g[(0, 3)]), (1, 1.0 - g[(0, 3)])],
        (4, 0): [(0, g[(0, 4)]), (1, 1.0 - g[(0, 4)])],
        (5, 0): [(1, 1.0)],
        (2, 1): [(6, 1.0)], (3, 1): [(6, 1.0)],
        (4, 1): [(6, 1.0)], (5, 1): [(6, 1.0)],
    }

    return LevelScheme(
        name="tag408_linear" if linear else "tag408_quad",
        n_states=S, decay_w=decay_w, e0=e0, e1=e1, coupling=C,
        tdep_rows=(), tdep_cols=(), tdep_coefs=(), tdep_freq=0.0,
        force_a=(), force_b=(), force_w=(),
        jump_src=(2, 3, 4, 5), branch_d_prob=dr / (dr + 1.0),
        jump_dest=_dest_table(S, dests),
    )


def tag422(detuning: float = -1.0, om: float = 1.3,
           decay_ratio: float = DECAY_RATIO_422) -> LevelScheme:
    """5-state 422-nm tagging scheme: S1/2(2) + P1/2(2) + lumped D.

    State order (randomFrozenStartTag422Linear.cpp:123-127):
      0: S -1/2  1: S +1/2  2: P +1/2  3: P -1/2  4: D
    Counter-propagating pair drives 2<->3 and 1<->4 (1-based).
    Pumping only: no force, no recoil.
    """
    S = 5
    dr = decay_ratio
    g = {  # rates (randomFrozenStartTag422Linear.cpp:971-976)
        (1, 2): 2. / 3, (1, 3): 1. / 3, (0, 3): 2. / 3, (0, 2): 1. / 3,
        (4, 2): dr, (4, 3): dr,
    }
    decay_w = np.zeros(S)
    for (_, src), rate in g.items():
        decay_w[src] += rate

    e0 = np.zeros(S)
    e1 = np.zeros(S)
    e0[2:4] = -detuning
    e1[2] = -1.0
    e1[3] = +1.0

    C = np.zeros((S, S), dtype=np.complex128)
    C[1, 2] = C[2, 1] = -om / 2 * np.sqrt(g[(1, 2)])
    C[0, 3] = C[3, 0] = -om / 2 * np.sqrt(g[(0, 3)])

    # jump rolls (randomFrozenStartTag422Linear.cpp:509-556): the S-decay
    # destination roll uses the *rate* gs[0]=2/3 (resp gs[2]) directly.
    dests = {
        (2, 0): [(1, g[(1, 2)]), (0, 1.0 - g[(1, 2)])],
        (3, 0): [(0, g[(0, 3)]), (1, 1.0 - g[(0, 3)])],
        (2, 1): [(4, 1.0)], (3, 1): [(4, 1.0)],
    }

    return LevelScheme(
        name="tag422_linear", n_states=S, decay_w=decay_w, e0=e0, e1=e1,
        coupling=C, tdep_rows=(), tdep_cols=(), tdep_coefs=(), tdep_freq=0.0,
        force_a=(), force_b=(), force_w=(),
        jump_src=(2, 3), branch_d_prob=dr / (dr + 1.0),
        jump_dest=_dest_table(S, dests),
    )


def three_state(detuning: float = -0.5, om: float = 0.5,
                vkick: float = 0.0012076) -> LevelScheme:
    """3-state toy: one ground state, two excited states driven by
    counter-propagating beams (laserCoolNoPlasmaThreeState.cpp:94-101).

    State order: 0: ground, 1: excited (left beam), 2: excited (right beam).
    Both decay channels terminate on the ground state; jumps always project
    to |0> with a +-vkick recoil.
    """
    S = 3
    decay_w = np.array([0.0, 1.0, 1.0])
    e0 = np.array([0.0, -detuning, -detuning])
    e1 = np.array([0.0, +1.0, -1.0])

    C = np.zeros((S, S), dtype=np.complex128)
    C[0, 2] = C[2, 0] = -om / 2    # sqrt(gs[0]) = 1
    C[0, 1] = C[1, 0] = -om / 2

    dests = {(1, 0): [(0, 1.0)], (2, 0): [(0, 1.0)],
             (1, 1): [(0, 1.0)], (2, 1): [(0, 1.0)]}

    return LevelScheme(
        name="three_state", n_states=S, decay_w=decay_w, e0=e0, e1=e1,
        coupling=C, tdep_rows=(), tdep_cols=(), tdep_coefs=(), tdep_freq=0.0,
        # kick = vKick*Om*(Im rho13 - Im rho12)*dt (line 189)
        force_a=(0, 0), force_b=(2, 1), force_w=(vkick * om, -vkick * om),
        jump_src=(1, 2), branch_d_prob=0.0,
        jump_dest=_dest_table(S, dests),
        kick_s=vkick, kick_d=vkick, apply_recoil=True,
    )
