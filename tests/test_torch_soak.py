"""The port's production soak (tools/torch_soak.py), held to the reference.

* ``TestTorchSoak`` reruns every assert of
  ``tests/test_physics_targets.py::TestFullScaleSoak`` (the production-run
  physics bands the JAX package's TPU soak meets) on the port's archive,
  ``artifacts/soak_torch/summary.json``, written on the card by
  ``tools/torch_soak.py``: the class is inherited, so there is one copy of
  the bands.  It skips when the archive is absent.
* ``test_physics_matches_jax_archive`` compares each family's physics keys
  present in both archives with the tolerances ``TestFullScaleSoak``
  already uses between two runs of the same physics (DIH peak time 0.5,
  its height 0.02, the cooling ratio 0.06 for single runs and 0.08 for
  ensembles, the S population 0.03, the 422 tag fraction 0.06 and the
  408quad one 0.01), and the three-state toy's late Ekin_x at
  :data:`THREE_STATE_EKIN_TOL`, set from its spread between seeds.
  Walls are never compared: the JAX archive's are a TPU's.
* ``test_family_soak_on_cpu`` runs each family's soak function on the CPU
  at a tiny size through the same code the card runs, and checks that its
  summary entry has every key ``TestFullScaleSoak`` reads.
"""

import json
import math
import os
import sys

import numpy as np
import pytest

from test_physics_targets import TestFullScaleSoak as _Bands

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_soak  # noqa: E402

PORT_SUMMARY = os.path.join(ROOT, "artifacts", "soak_torch", "summary.json")
JAX_SUMMARY = os.path.join(ROOT, "artifacts", "soak", "summary.json")


@pytest.fixture(scope="module")
def soak():
    """The port's archive (tools/torch_soak.py on the card)."""
    if not os.path.exists(PORT_SUMMARY):
        pytest.skip("no port soak archive; run tools/torch_soak.py on the "
                    "card")
    with open(PORT_SUMMARY) as f:
        return json.load(f)


class TestTorchSoak(_Bands):
    """``TestFullScaleSoak``'s asserts, unchanged, on the port's archive."""


# ---- the port's archive against the JAX package's

_SINGLE = {"dih_peak_t": 0.5, "dih_peak_ekin_x": 0.02, "cooling_ratio": 0.06,
           "pop_s": 0.03}
_ENSEMBLE = dict(_SINGLE, cooling_ratio=0.08)
# ekin_x_final of ThreeStateConfig(n0=1000), one run against another: 3
# standard deviations of the difference of two independent runs, 3 *
# sqrt(2) * 4.94e-6, the standard deviation between 8 seeds of the port
# on the card (the archive's ``_three_state_seeds``, tools/torch_soak.py)
THREE_STATE_SEED_SD = 4.94e-6
THREE_STATE_EKIN_TOL = 3 * math.sqrt(2) * THREE_STATE_SEED_SD
_TOLERANCES = {
    "cooling": _SINGLE, "cooling_renorm": _SINGLE, "cooling_n14000": _SINGLE,
    "cooling_poisson_ensemble": _ENSEMBLE, "cooling_mesh_ensemble": _ENSEMBLE,
    "frozen": {"tag_fraction": 0.06}, "mc_tag_422": {"tag_fraction": 0.06},
    "frozen_408quad": {"tag_fraction": 0.01}, "mc_tag": {"tag_fraction": 0.01},
    "three_state": {"ekin_x_final": THREE_STATE_EKIN_TOL},
}


def _jax_archive() -> dict:
    with open(JAX_SUMMARY) as f:
        return json.load(f)


_CASES = [(fam, key, tol) for fam, keys in _TOLERANCES.items()
          for key, tol in keys.items()
          if key in _jax_archive().get(fam, {})]


def test_every_tolerance_has_a_case():
    """Each family of the table compares at least one key (the JAX
    archive holds them all)."""
    assert {f for f, _, _ in _CASES} == set(_TOLERANCES)


@pytest.mark.parametrize("family,key,tol", _CASES,
                         ids=[f"{f}-{k}" for f, k, _ in _CASES])
def test_physics_matches_jax_archive(soak, family, key, tol):
    if family not in soak:
        pytest.skip(f"{family} not in the port's archive")
    port, ref = soak[family][key], _jax_archive()[family][key]
    assert abs(port - ref) < tol, (family, key, port, ref)


def test_three_state_tolerance_is_the_archived_seed_spread(soak):
    """The stated spread is the archived fold of seeds' (to the 3
    digits written), and that fold ran the soak's configuration."""
    seeds = soak["_three_state_seeds"]
    assert seeds["n_jobs"] >= 8
    assert (seeds["n0"], seeds["tmax"]) == (soak["three_state"]["n0"],
                                            soak["three_state"]["tmax"])
    assert abs(seeds["ekin_x_final_sd"] - THREE_STATE_SEED_SD) < 5e-9
    assert len(seeds["ekin_x_final"]) == seeds["n_jobs"]


def test_archive_meta_names_the_card(soak):
    meta = soak["_meta"]
    assert meta["card"] != "cpu" and "," in meta["card"], meta
    assert {"torch", "cuda", "git", "date"} <= set(meta), meta
    for fam in (f for f in soak if not f.startswith("_")):
        assert fam in torch_soak.FAMILIES and soak[fam]["wall_s"] > 0, fam


# ---- every family's soak function on the CPU at a tiny size

_COOL = dict(n0=32, tmax=0.04, sample_freq=2)
_FROZEN = dict(n0=32, tstart=0.02, tmax=0.1, sample_freq=4,
               tpump_seconds=5e-8)
_MC = dict(n=27, mc_steps=200, pre_record_md_steps=5, record_steps=20,
           gr_every_record=10)
TINY = {
    "cooling": _COOL,
    "cooling_renorm": _COOL,
    "cooling_n14000": dict(_COOL, n0=48),
    "cooling_poisson_ensemble": dict(_COOL, checkpoint_every_segments=5),
    "cooling_mesh_ensemble": dict(_COOL, checkpoint_every_segments=5),
    "frozen": _FROZEN,
    "frozen_408quad": _FROZEN,
    "mc_tag": dict(_MC, mc_chunk_steps=100, tpump_seconds=2e-8),
    "mc_tag_422": dict(_MC, mc_chunk_steps=100, tpump_seconds=2e-8),
    "transport": dict(_MC, gr_every_mc=100, instant_aniso_steps=5,
                      reequil_steps=5, aniso_relax_steps=5,
                      aniso_time_us=0.1),
    "three_state": dict(n0=16, tmax=1.0, sample_freq=50),
}

# the keys TestFullScaleSoak reads of each family
BAND_KEYS = {
    "cooling": {"n0", "tmax", "dih_peak_t", "dih_peak_ekin_x", "gamma_dih",
                "cooling_ratio", "pop_s", "pop_p", "pop_d"},
    "cooling_renorm": {"final_norm_max_dev", "dih_peak_ekin_x",
                       "cooling_ratio"},
    "cooling_n14000": {"wall_s", "dih_peak_ekin_x", "cooling_ratio",
                       "pop_s"},
    "cooling_poisson_ensemble": {"member_ns", "member_n_spread",
                                 "dih_peak_t", "cooling_ratio"},
    "cooling_mesh_ensemble": {"n_jobs", "tmax", "dih_peak_t",
                              "cooling_ratio"},
    "frozen": {"n0", "tstart", "tag_fraction", "tagged_vx_at_tag",
               "tagged_vx2_at_tag", "vaf_tau0"},
    "frozen_408quad": {"tag_fraction", "tagged_vx2_at_tag"},
    "mc_tag": {"tag_fraction", "mean_record_temp", "gamma", "selectivity",
               "vaf_norm_min"},
    "mc_tag_422": {"tag_fraction"},
    "transport": {"mean_record_temp", "gamma", "vaf_norm_min",
                  "aniso_spread_relaxed", "aniso_spread_initial"},
    "three_state": {"cooling_factor", "ekin_x_final", "doppler_limit"},
}

# tiny runs end before the DIH windows (t <= 8, 6 < t < 10, t >= 25) fill:
# those means are of empty slices
_EMPTY_WINDOWS = {"ekin_x_late", "cooling_ratio", "gamma_dih"}


def test_tiny_table_covers_every_family():
    assert set(TINY) == set(BAND_KEYS) == set(torch_soak.FAMILIES)
    assert set(torch_soak.DEFAULT_FAMILIES) == set(TINY)


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
@pytest.mark.parametrize("family", sorted(TINY))
def test_family_soak_on_cpu(family, tmp_path):
    m = torch_soak.FAMILIES[family](str(tmp_path / "trees"), device="cpu",
                                    **TINY[family])
    assert BAND_KEYS[family] <= set(m), sorted(BAND_KEYS[family] - set(m))
    assert m["wall_s"] > 0 and m["launches"] == {}    # no kernel on the CPU
    for k, v in m.items():
        if k not in _EMPTY_WINDOWS and isinstance(v, float):
            assert math.isfinite(v), (k, v)
    if family == "cooling_renorm":
        assert m["final_norm_max_dev"] < 1e-5
    if family == "cooling_poisson_ensemble":
        assert len(m["member_ns"]) == 8 and m["member_n_spread"] >= 0
    # the summary keeps every entry written before it, and _meta
    path = str(tmp_path / "summary.json")
    meta = torch_soak.run_meta("cpu")
    torch_soak.update_summary(path, "earlier", {"x": 1}, meta)
    torch_soak.update_summary(path, family, m, meta)
    with open(path) as f:
        got = json.load(f)
    assert got["earlier"] == {"x": 1} and got["_meta"] == meta
    assert np.allclose(got[family]["wall_s"], m["wall_s"])


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_tag_pool_on_cpu(tmp_path):
    """The pooled tag fractions of the four tagging families' folds."""
    pool = torch_soak.tag_pool(str(tmp_path), device="cpu", n_jobs=2,
                               frozen_over=_FROZEN,
                               mc_over=TINY["mc_tag"])
    assert set(pool) == {"frozen", "frozen_408quad", "mc_tag", "mc_tag_422"}
    for fam, p in pool.items():
        assert len(p["member_fractions"]) == 2 and p["launches"] == {}, fam
        assert 0.0 <= p["pooled"] <= 1.0 and p["pooled_se"] >= 0.0, fam
        assert abs(np.mean(p["member_fractions"]) - p["pooled"]) < 1e-12


def test_xval_408quad_on_cpu(tmp_path):
    """The pooled 408quad fold and its z-scores (a tiny fold)."""
    x = torch_soak.xval_408quad(str(tmp_path), device="cpu", n_jobs=2,
                                **{k: v for k, v in TINY["mc_tag"].items()
                                   if k != "tpump_seconds"})
    assert x["n"] == 27 and len(x["member_fractions"]) == 2
    assert abs(np.mean(x["member_fractions"]) - x["pooled"]) < 1e-12
    assert set(x["z"]) == set(torch_soak.XVAL_POOLS)
    for k, p in torch_soak.XVAL_POOLS.items():
        se = np.sqrt(x["pooled_se"] ** 2 + p * (1 - p) / (8 * 216))
        assert abs(x["z"][k] - (x["pooled"] - p) / se) < 1e-9


def test_three_state_seeds_on_cpu(tmp_path):
    """The three-state fold of seeds: per-member metrics, their mean and
    spread (a tiny fold)."""
    x = torch_soak.three_state_seeds(str(tmp_path), device="cpu", n_jobs=3,
                                     **TINY["three_state"])
    assert x["n_jobs"] == 3 and x["launches"] == {}
    for key in ("ekin_x_final", "cooling_factor"):
        v = np.asarray(x[key])
        assert v.shape == (3,) and np.isfinite(v).all(), key
        assert abs(v.mean() - x[key + "_mean"]) < 1e-15, key
        assert abs(v.std(ddof=1) - x[key + "_sd"]) < 1e-15, key
    assert len(set(x["ekin_x_final"])) == 3     # the members differ


def test_traces_on_cpu():
    """The trace entries' keys (on the CPU the trace holds no device
    operation: busy 0)."""
    chain = torch_soak.trace_chain(5, device="cpu")
    md = torch_soak.trace_md(2, device="cpu", n0=32)
    for t in (chain, md):
        assert t["steps"] in (5, 2) and t["untraced_ms_per_step"] > 0
        assert t["busy_ms"] == 0.0 and t["top"] == [] and t["window_ms"] > 0
    assert chain["n"] == 4096 and md["n0"] == 32


def test_three_state_trace_on_cpu():
    """``three_state_trace`` (``profiling.device_trace`` over a window of
    the three-state job's tick-kernel launches) at a tiny size: its keys,
    the launch count it divides by, and a window without device
    operations."""
    t = torch_soak.trace_three_state(2, device="cpu", n0=16, sample_freq=50)
    assert t["n0"] == 16 and t["steps"] == 2
    assert t["untraced_ms_per_step"] > 0 and t["window_ms"] > 0
    assert t["busy_ms"] == 0.0 and t["busy_share"] == 0.0 and t["top"] == []
    assert "three_state_trace" in torch_soak.EXTRAS
