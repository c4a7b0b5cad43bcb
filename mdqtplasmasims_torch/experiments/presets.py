"""Named experiment presets: the exact default configurations of each of
the reference's 11 programs (README.md:40-55 and per-file globals).

The port's own copy of ``mdqtplasmasims_tpu/experiments/presets.py``: the
same names, built on the port's config dataclasses, so
``run(presets.pre_speedup(save_directory=...), device="cuda")`` runs the
reference's original program on the card.

``laserCoolingPlasmaMagnesium.cpp`` is a byte-identical copy of the SpeedUp
flagship (verified: `diff` is empty — SURVEY.md file inventory), so it maps
to the same preset.
"""

from __future__ import annotations

from .frozen_tagging import FrozenTagConfig
from .laser_cooling import CoolingConfig
from .mc_md_anisotropy import MCTransportConfig
from .mc_qt_tagging import MCTagConfig
from .three_state import ThreeStateConfig


def north_star(**kw) -> CoolingConfig:
    """laserCoolingPlusExpansionMDQTSpeedUp.cpp defaults — the N0=3500,
    density=2, tmax=30 benchmark configuration (BASELINE.md)."""
    return CoolingConfig(**kw)


# byte-identical duplicate of the flagship in the reference tree
magnesium = north_star

def pre_speedup(**kw) -> CoolingConfig:
    """LaserCoolingPlusExpansionMDQT.cpp as compiled: the old-generation
    DP Ehrenfest-kick convention (physics="pre_speedup",
    LaserCoolingPlusExpansionMDQT.cpp:502) plus its active interval
    diagnostics (13 VAF intervals at t=3,5,...,27 and the LCCF J(k)
    stream, :1252-1362)."""
    kw.setdefault("physics", "pre_speedup")
    kw.setdefault("vaf_intervals", tuple(range(3, 28, 2)))
    kw.setdefault("record_lccf", True)
    return CoolingConfig(**kw)


def transport(**kw) -> MCTransportConfig:
    """MonteCarloFollowedByMDAndTempAnisotropy.cpp defaults."""
    return MCTransportConfig(**kw)


def mc_tag_408_linear(**kw) -> MCTagConfig:
    return MCTagConfig(variant="408linear", **kw)


def mc_tag_408_quad(**kw) -> MCTagConfig:
    return MCTagConfig(variant="408quad", **kw)


def mc_tag_422_linear(**kw) -> MCTagConfig:
    return MCTagConfig(variant="422linear", **kw)


def frozen_tag_408_linear(**kw) -> FrozenTagConfig:
    # pump defaults come from FROZEN_VARIANT_DEFAULTS via __post_init__
    return FrozenTagConfig(variant="408linear", **kw)


def frozen_tag_408_quad(**kw) -> FrozenTagConfig:
    return FrozenTagConfig(variant="408quad", **kw)


def frozen_tag_422_linear(**kw) -> FrozenTagConfig:
    return FrozenTagConfig(variant="422linear", **kw)


def three_state_toy(**kw) -> ThreeStateConfig:
    return ThreeStateConfig(**kw)


PRESETS = {
    "north-star": north_star,
    "magnesium": magnesium,
    "pre-speedup": pre_speedup,
    "transport": transport,
    "mc-tag-408-linear": mc_tag_408_linear,
    "mc-tag-408-quad": mc_tag_408_quad,
    "mc-tag-422-linear": mc_tag_422_linear,
    "frozen-tag-408-linear": frozen_tag_408_linear,
    "frozen-tag-408-quad": frozen_tag_408_quad,
    "frozen-tag-422-linear": frozen_tag_422_linear,
    "three-state": three_state_toy,
}
