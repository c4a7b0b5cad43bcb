"""The yardstick of the kernels' shares: the card's published peaks and
the work a step needs, counted from the problem.

Copied from chip_smoke.py:340-372 (``bound``, ``half_pairs``; the
operation counts ``PAIR_OPS`` and ``POT_OPS`` and the tick's count now sit
frozen in each configuration's ``work`` entry, with their derivation)."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet at the 700 W limit: FP32 outside the tensor
# cores and HBM3 bandwidth; every kernel of the program is FP32 SIMT
H100_FP32_OPS = 67e12
H100_HBM_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of ``ops`` FP32
    operations at the FP32 peak and ``nbytes`` at the memory rate."""
    return max(ops / H100_FP32_OPS, nbytes / H100_HBM_BYTES)


def half_pairs(counts) -> int:
    """Unordered pairs of real ions over members of ``counts`` ions
    (Newton's third law: each pair once)."""
    return sum(int(n) * (int(n) - 1) // 2 for n in counts)


def segment_pair_bound_s(config: dict, members: int, steps: int) -> float:
    """Least time of one output segment's pair work: a force evaluation at
    every one of its ``steps`` MD steps and one potential evaluation at the
    sample, over ``members`` members of n0 real ions (the positions and
    forces planes of the padded lanes read and written once a launch)."""
    w, n0 = config["work"], config["physics"]["n0"]
    pairs = half_pairs([n0] * members)
    lanes = members * config["derived"]["npad"]
    plane = 4 * w["pair_plane_rows"] * lanes
    return (steps * bound_s(pairs * w["pair_ops"], plane)
            + bound_s(pairs * (w["pair_ops"] + w["pot_ops"]), plane))


def segment_tick_bound_s(config: dict, members: int, steps: int) -> float:
    """Least time of one output segment's ticks: ``steps`` MD steps of
    ``ratio`` ticks for every real ion, in the launches a segment makes
    (``steps - 1`` whole steps and the sampled step cut one tick in), each
    reading and writing the state planes of its lanes once."""
    w, d = config["work"], config["derived"]
    ions = members * config["physics"]["n0"]
    plane = 4 * w["tick_plane_rows"] * members * d["npad"]
    per_tick = ions * w["tick_ops"]
    ratio = d["ratio"]
    return ((steps - 1) * bound_s(ratio * per_tick, plane)
            + bound_s(per_tick, plane) + bound_s((ratio - 1) * per_tick,
                                                 plane))
