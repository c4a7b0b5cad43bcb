"""The port's 99-job campaign (tools/torch_campaign99.py) against the JAX
package's (tools/campaign99.py).

* The tool's configuration is the JAX script's, read from its source with
  ``ast`` (the script runs the campaign when imported).
* The JAX script's own reduction statements, executed on seeded outputs,
  print exactly the tool's :func:`campaign_line`.
* A tiny campaign (3 members, N0=64, tmax=0.4, sample_freq=4: 200 MD
  steps in 5 groups of 10 segments) through the tool on the CPU against
  the JAX package's ``run_ensemble`` from JAX's stacked start, the port
  fed JAX's key-chain uniforms (tests/test_torch_ensemble.py's
  ``jax_rolls``): the metrics and the EkinX samples agree at that file's
  f32 bar (1e-4 of the largest value).  Over 5000 ticks the f32 rounding
  of psi drifts past the 5-step bar of the populations; no metric reads
  them.  ``run_ensemble`` called directly gives the tool's outputs bit
  for bit.
* The archive's ``_campaign99`` (the uncut campaign on the card, through
  ``tools/torch_soak.py campaign99``) meets the flagship's soak bands and
  the JAX campaign's physics (RESULTS.md:228-231) within the tolerances
  tests/test_torch_soak.py uses between two ensembles.  Its spread of the
  members' final EkinX is 0.0821, not the JAX run's 0.0053: two members
  start with a pair of ions within 0.01 a, and their EkinX stays far
  above the others' (a close start pair heats the JAX package the same
  way: :func:`test_close_start_pair_heats_both_packages_alike`).  The
  spread of the other 97 is held to the JAX run's.
"""

import ast
import contextlib
import io
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_ensemble import jax_member_states, jax_rolls
from test_torch_soak import _ENSEMBLE, PORT_SUMMARY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_campaign99 as tc  # noqa: E402
from mdqtplasmasims_tpu.experiments import laser_cooling as jlc  # noqa: E402
from mdqtplasmasims_torch.bridge import state_from_numpy  # noqa: E402
from mdqtplasmasims_torch.experiments import laser_cooling as tlc  # noqa

JAX_SCRIPT = os.path.join(ROOT, "tools", "campaign99.py")


def _script():
    with open(JAX_SCRIPT) as f:
        return ast.parse(f.read())


def _call(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == name)


def test_configuration_is_the_jax_scripts():
    tree = _script()
    cfg = _call(tree, "CoolingConfig")
    assert not cfg.args
    assert tc.CAMPAIGN == {k.arg: ast.literal_eval(k.value)
                           for k in cfg.keywords}
    ens = _call(tree, "run_ensemble")
    kw = {k.arg: ast.literal_eval(k.value) for k in ens.keywords}
    assert [a.id for a in ens.args] == ["cfg"]
    assert (tc.N_JOBS, tc.SEED) == (kw.pop("n_jobs"), kw.pop("seed"))
    assert not kw
    # pinned N in both: the JAX script leaves exact_n at its default
    port = tc.campaign_config()
    assert port.exact_n and jlc.CoolingConfig().exact_n
    assert port.save_directory is None
    assert (port.n0, port.tmax, port.sample_freq,
            port.checkpoint_every_segments) == (3500, 30.0, 40, 10)


def _reduction_statements(tree):
    """The JAX script's statements after ``wall = ...`` (numpy only)."""
    body = tree.body
    i = next(k for k, s in enumerate(body) if isinstance(s, ast.Assign)
             and any(getattr(t, "id", None) == "wall" for t in s.targets))
    return ast.Module(body=body[i + 1:], type_ignores=[])


def _seeded_outs(rng, n_jobs, cfg):
    """Outputs shaped as the campaign's: the sample times of the schedule,
    an EkinX that rises to a peak and cools, with per-member scatter."""
    n_s = int(round(cfg.tmax / cfg.timestep)) // cfg.sample_freq
    k = np.arange(1, n_s + 1)
    t = (k * cfg.sample_freq - 1 + 1.0 / cfg.ratio) * cfg.timestep
    curve = 0.17 * (t / 0.96) * np.exp(1.0 - t / 0.96) + 0.1 * (t > 0.96)
    ekin = (curve[None, :, None] * (1.0 + 0.05 * rng.standard_normal(
        (n_jobs, n_s, 3)))).astype(np.float32)
    return dict(t=np.broadcast_to(t, (n_jobs, n_s)).astype(np.float32),
                ekin=ekin)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reduction_prints_the_jax_scripts_line(seed):
    rng = np.random.default_rng(seed)
    cfg_j = jlc.CoolingConfig(**tc.CAMPAIGN)
    cfg = tc.campaign_config()
    assert (cfg.ratio, cfg.timestep) == (cfg_j.ratio, cfg_j.timestep)
    outs = _seeded_outs(rng, tc.N_JOBS, cfg)
    wall = float(rng.uniform(50.0, 900.0))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        exec(compile(_reduction_statements(_script()), JAX_SCRIPT, "exec"),
             dict(np=np, outs=outs, cfg=cfg_j, wall=wall))
    m = dict(n_jobs=tc.N_JOBS,
             **tc.campaign_metrics(outs, cfg, tc.N_JOBS, wall))
    assert buf.getvalue() == tc.campaign_line(m) + "\n"
    assert m["wall_s"] == wall and 0.5 < m["dih_peak_t"] < 1.5


# ---- a tiny campaign, the tool against the JAX package

SMALL = dict(n0=64, tmax=0.4, sample_freq=4)
N_SMALL = 3


@pytest.fixture(scope="module")
def small_runs():
    cfg_j = jlc.CoolingConfig(fused_interpret=True, use_pallas=False,
                              **dict(tc.CAMPAIGN, **SMALL))
    states0 = jax_member_states(cfg_j, N_SMALL, seed=tc.SEED)
    fin_j, outs_j = jlc.run_ensemble(cfg_j, N_SMALL, seed=tc.SEED)
    outs_j = {k: np.asarray(v) for k, v in outs_j.items()}
    m, fin_t, outs_t = tc.campaign_run(
        "cpu", N_SMALL, tc.SEED, states=states0,
        rolls_fn=jax_rolls(states0.key[0]), **SMALL)
    direct = tlc.run_ensemble(tc.campaign_config(**SMALL), N_SMALL,
                              tc.SEED, device="cpu", states=states0,
                              rolls_fn=jax_rolls(states0.key[0]))
    return (fin_j, outs_j), (m, fin_t, outs_t), direct


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_small_campaign_metrics_match_jax(small_runs):
    (_, outs_j), (m, _, outs_t), _ = small_runs
    assert (m["n_jobs"], m["n0"], m["tmax"]) == (N_SMALL, 64, 0.4)
    assert m["launches"] == {} and m["max_memory_allocated"] is None
    assert outs_t["ekin"].shape == (N_SMALL, 50, 3)
    np.testing.assert_array_equal(outs_t["t"], outs_j["t"])
    bar = 1e-4 * np.abs(outs_j["ekin"]).max()
    np.testing.assert_allclose(outs_t["ekin"], outs_j["ekin"], rtol=0,
                               atol=bar)
    mj = tc.campaign_metrics(outs_j, tc.campaign_config(**SMALL), N_SMALL,
                             m["wall_s"])
    assert m["dih_peak_t"] == mj["dih_peak_t"]
    assert m["agg_updates_per_s"] == mj["agg_updates_per_s"]
    for key in ("dih_peak_ekin_x", "job_spread_t30"):
        assert abs(m[key] - mj[key]) <= bar, (key, m[key], mj[key])
    # no sample reaches t >= 25: the ratio is the mean of none, in both
    assert np.isnan(m["cooling_ratio"]) and np.isnan(mj["cooling_ratio"])
    assert len(set(outs_t["ekin"][:, -1, 0].tolist())) == N_SMALL


def test_small_campaign_positions_match_jax(small_runs):
    """R, V and the particle clocks at tests/test_torch_ensemble.py's
    float32 bar after 200 MD steps (psi is held through EkinX: its
    rounding drifts past 5e-5)."""
    (fin_j, _), (_, fin_t, _), _ = small_runs
    for name in ("R", "V", "t_part"):
        np.testing.assert_allclose(getattr(fin_t, name),
                                   np.asarray(getattr(fin_j, name)),
                                   atol=2e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(fin_t.tick, np.asarray(fin_j.tick))


def test_tool_equals_run_ensemble(small_runs):
    _, (_, fin_t, outs_t), (fin_d, outs_d) = small_runs
    assert set(outs_t) == set(outs_d)
    for k in outs_t:
        np.testing.assert_array_equal(outs_t[k], outs_d[k], err_msg=k)
    for name in ("R", "V", "psi", "t_part", "tick", "t"):
        np.testing.assert_array_equal(getattr(fin_t, name),
                                      getattr(fin_d, name), err_msg=name)


# ---- the archive: the uncut campaign on the card

# tests/test_physics_targets.py::TestFullScaleSoak.test_cooling_flagship,
# the keys the campaign has
FLAGSHIP_BANDS = {"dih_peak_t": (0.3, 2.0), "dih_peak_ekin_x": (0.10, 0.25),
                  "cooling_ratio": (0.4, 0.85)}
# the JAX campaign (RESULTS.md:228-231), with tests/test_torch_soak.py's
# tolerances between two ensembles; the spread of 99 members' final EkinX
# within a factor 1.5 of the JAX run's 0.0053 either way
JAX_CAMPAIGN = {"dih_peak_t": 0.96, "dih_peak_ekin_x": 0.170,
                "cooling_ratio": 0.627}
SPREAD_BAND = (0.0035, 0.0080)
# A uniform frozen-gas start can put two ions within a hundredth of a
# Wigner-Seitz radius a of each other; their Coulomb energy (~1/r) then
# stays with their member, whose EkinX at t=30 leaves the others'.  In the
# archive, members 25 and 88 start with pairs at 0.0051 and 0.0096 a and
# end 163 and 26 robust standard deviations above the median; the next
# closest pair, 0.0164 a, ends within 2.  R_CLOSE sits between the two;
# 99 uniform starts of 3500 ions hold 99 * 1745 * R_CLOSE**3 ~ 0.3 such
# members on average (1745 r**3: the expected pairs closer than r in one
# start, 3500**2 / 2 pairs in a cell of 3500 * 4 pi / 3 a**3).
R_CLOSE = 0.012
OUTLIER_SD = 5.0
# one launch of C a MD step, of B'rng a MD step and one more a sample
# (the sampling step split at the output instant), of G a sample + epot0
CAMPAIGN_LAUNCHES = {"yukawa_forces_batched": 15000,
                     "fused_ticks_rng": 15375,
                     "yukawa_forces_potential_batched": 376}


@pytest.fixture(scope="module")
def archived():
    if not os.path.exists(PORT_SUMMARY):
        pytest.skip("no port soak archive")
    with open(PORT_SUMMARY) as f:
        soak = json.load(f)
    if "_campaign99" not in soak:
        pytest.skip("no _campaign99 in the archive; run tools/torch_soak.py "
                    "campaign99 on the card")
    return soak


def test_archived_campaign_is_the_full_campaign(archived):
    c = archived["_campaign99"]
    assert (c["n_jobs"], c["n0"], c["tmax"]) == (99, 3500, 30.0)
    assert c["launches"] == CAMPAIGN_LAUNCHES
    assert c["wall_s"] > 0 and c["max_memory_allocated"] > 0
    assert "," in archived["_meta"]["card"]


@pytest.mark.parametrize("key", sorted(FLAGSHIP_BANDS))
def test_archived_campaign_in_flagship_bands(archived, key):
    lo, hi = FLAGSHIP_BANDS[key]
    assert lo < archived["_campaign99"][key] < hi


@pytest.mark.parametrize("key", sorted(JAX_CAMPAIGN))
def test_archived_campaign_matches_jax_campaign(archived, key):
    port = archived["_campaign99"][key]
    assert abs(port - JAX_CAMPAIGN[key]) < _ENSEMBLE[key], (key, port)


def test_archived_spread_is_the_members_std(archived):
    """``job_spread_t30`` is the standard deviation of the archived
    per-member final EkinX (the JAX script's ``ekx[:, -1].std()``)."""
    c = archived["_campaign99"]
    ek = np.asarray(c["ekin_x_final"])
    assert ek.shape == (99,) and len(c["start_closest_pair"]) == 99
    assert abs(ek.std() - c["job_spread_t30"]) < 1e-9


def test_archived_spread_of_members_without_a_close_start_pair(archived):
    """The spread of the members whose start holds no pair closer than
    :data:`R_CLOSE`: the JAX campaign's 0.0053 within a factor 1.5.  The
    whole fold's spread (0.0821 in the archive) is not: see
    :func:`test_archived_outliers_start_with_a_close_pair`."""
    c = archived["_campaign99"]
    ek = np.asarray(c["ekin_x_final"])
    far = np.asarray(c["start_closest_pair"]) >= R_CLOSE
    lo, hi = SPREAD_BAND
    assert far.sum() >= 90 and lo <= ek[far].std() <= hi, ek[far].std()


def test_archived_outliers_start_with_a_close_pair(archived):
    """Every member whose final EkinX lies more than :data:`OUTLIER_SD`
    robust standard deviations (1.4826 median absolute deviations) from
    the members' median started with two ions closer than
    :data:`R_CLOSE`, and every member that did is such an outlier."""
    c = archived["_campaign99"]
    ek = np.asarray(c["ekin_x_final"])
    close = np.asarray(c["start_closest_pair"]) < R_CLOSE
    med = np.median(ek)
    sd = 1.4826 * np.median(np.abs(ek - med))
    out = np.abs(ek - med) > OUTLIER_SD * sd
    np.testing.assert_array_equal(out, close)


def test_close_start_pair_heats_both_packages_alike():
    """A start with two ions 0.005 a apart (as member 25 of the archived
    campaign's start has, 0.0051 a): the pair flies apart and its EkinX
    rises some hundredfold in the JAX package and in the port alike, at
    tests/test_torch_ensemble.py's bar (N0=64, 20 MD steps, the port fed
    JAX's draws)."""
    close = dict(n0=64, tmax=0.04, sample_freq=4)
    cfg_j = jlc.CoolingConfig(fused_interpret=True, use_pallas=False,
                              **close)
    s0 = jlc.initial_state(cfg_j)
    R = np.array(s0.R)
    R[1] = R[0] + np.array([-0.005 if R[0, 0] > 1.0 else 0.005, 0.0, 0.0],
                           R.dtype)
    s0 = s0._replace(R=jnp.asarray(R))
    fin_j, res_j = jlc.run(cfg_j, state=s0)
    fin_t, res_t = tlc.run(tlc.CoolingConfig(**close),
                           state=state_from_numpy(s0, device="cpu"),
                           device="cpu", rolls_fn=jax_rolls(s0.key))
    ej, et = np.asarray(res_j["outs"]["ekin"]), res_t["outs"]["ekin"]
    assert ej[:, 0].min() > 10.0          # a frozen start's is ~0.01
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-4 * np.abs(ej).max())
    for name in ("R", "V"):
        np.testing.assert_allclose(getattr(fin_t, name),
                                   np.asarray(getattr(fin_j, name)),
                                   atol=2e-5, rtol=1e-5, err_msg=name)


def test_archived_campaign_trace(archived):
    if "_campaign99_trace" not in archived:
        pytest.skip("no _campaign99_trace in the archive")
    tr = archived["_campaign99_trace"]
    assert (tr["n_jobs"], tr["n0"], tr["segments"]) == (99, 3500, 10)
    assert tr["steps"] == 400 and 0.0 < tr["busy_share"] <= 1.0
    assert tr["start_s"] > 0 and len(tr["top"]) == 10
