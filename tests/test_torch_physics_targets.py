"""The JAX package's known-physics targets (tests/test_physics_targets.py:
``TestDIH``, ``TestCurveLevel``, ``TestAnalysisPhysics.
test_soak_green_kubo_d`` and ``TestTaggedVelocityClass``) held on the
port through ``tools/torch_physics_targets.py`` and the port's soak.

On the CPU, against the JAX package:

* the DIH starts (``tests/fixtures/dih_start_seed3_n512.npy`` and
  ``..._n256.npy``) are JAX's ``jax.random.uniform(PRNGKey(3), (N, 3),
  float64, 0, L)`` bit for bit;
* ``test_f32_matches_f64_within_budget``'s asserts on the port's twin of
  kernel A (N=256 x 800 steps in both dtypes from the fixture);
* the port's float64 DIH curve (N=512, 200 steps) against JAX's
  ``run_dih(512, 200, float64)`` pointwise, at :data:`DIH_F64_BAR` of T's
  maximum (measured 3.3e-16);
* ``TestTaggedVelocityClass``'s asserts on ``tagged_class("cpu")`` at
  the test's own configuration;
* ``core/scheduler.free_ion_ticks`` with the S = 12 tables (the EIT
  target's route: no force, explicit rolls) against JAX's
  ``QTEngine.step_sm`` tick by tick, at tests/test_fused.py:91-101's bars;
* every function of the tool at a tiny size: the report carries every
  key the archive tests read; so does ``tools/torch_dip_seed_scan.py``.

On the card's archive (skipped while it is absent, as
tests/test_torch_soak.py skips): ``artifacts/physics_targets_torch/
report.json`` and its dip files held to the JAX tests' asserts, copied
verbatim with their line numbers (the JAX tests read paths or run JAX
fixed in their module); the card's dip at seeds 1-17
(``dip_seeds.json``) beside the JAX package's (``jax_dip_seeds.json``);
and the port soak's archived ``energies.dat``
(cooling) and ``VAF.dat`` + ``temperature.dat`` (transport) held to
``test_cooling_slope_from_energies_dat`` and ``test_soak_green_kubo_d``.
"""

import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu import levels as jlv
from mdqtplasmasims_tpu import units as junits
from mdqtplasmasims_tpu.core import qt as jqt
from mdqtplasmasims_torch import levels as tlv
from mdqtplasmasims_torch.core import qt as tqt
from mdqtplasmasims_torch.core import scheduler as tsched
from test_physics_targets import run_dih

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)

import torch_dip_seed_scan as tds  # noqa: E402
import torch_physics_targets as tpt  # noqa: E402

torch.set_num_threads(1)

ARCHIVE = os.path.join(ROOT, "artifacts", "physics_targets_torch")
REPORT = os.path.join(ARCHIVE, "report.json")
SOAK = os.path.join(ROOT, "artifacts", "soak_torch")
# the port's float64 DIH curve against JAX's, pointwise, of T's maximum
DIH_F64_BAR = 1e-12


# ---- on the CPU, against the JAX package

@pytest.mark.parametrize("n0", [512, 256])
def test_dih_start_fixture_is_jax_draw(n0):
    L = junits.PlasmaUnits.box_length(n0)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (n0, 3),
                                         jnp.float64, 0, L))
    got = tpt.dih_start(n0)
    assert got.dtype == np.float64 and got.shape == (n0, 3)
    assert got.tobytes() == want.tobytes()


def test_f32_matches_f64_within_budget_on_the_port():
    """tests/test_physics_targets.py:95-109's asserts on the port's twin."""
    T64 = tpt.dih_curve(256, 800, torch.float64, device="cpu")
    T32 = tpt.dih_curve(256, 800, torch.float32, device="cpu")
    scale = T64.max()
    # early times: trajectories still coherent
    assert np.abs(T64[:200] - T32[:200]).max() / scale < 0.01
    # late times: time-averaged temperature agrees
    assert abs(T64[500:].mean() - T32[500:].mean()) / scale < 0.05
    assert tpt.budget_misses(T64, T32) == []


@pytest.fixture(scope="module")
def jax_dih_200():
    """JAX's float64 DIH curve over the first 200 steps at N=512."""
    return run_dih(512, 200, jnp.float64)


def test_port_float64_dih_matches_jax(jax_dih_200):
    T = tpt.dih_curve(512, 200, torch.float64, device="cpu")
    assert T.shape == jax_dih_200.shape
    assert (np.abs(T - jax_dih_200).max()
            < DIH_F64_BAR * jax_dih_200.max())


def test_tagged_class_on_cpu_meets_the_jax_asserts():
    """tests/test_physics_targets.py:430-450 through the port's sweep."""
    t = tpt.tagged_class("cpu")
    assert t["config"] == dict(variant="422linear", n0=512, tstart=2.0,
                               tmax=2.5, timestep=0.01, sample_freq=40,
                               tpump_seconds=3e-7)
    assert (t["dets"], t["jobs_per_point"], t["seed"]) == (
        [-1.0, 0.0, 1.0], 2, 1)
    vx = tpt.tagged_vx(t["rows"])
    # class selection: red pump tags the +v class and vice versa
    assert vx[-1.0] > 0.1, vx
    assert vx[1.0] < -0.1, vx
    # resonance: no class preference (scatter at N0=512 x 2 ~ 0.04)
    assert abs(vx[0.0]) < 0.12, vx
    # antisymmetry of the selection (same seeds both signs)
    assert abs(vx[-1.0] + vx[1.0]) < 0.5 * abs(vx[-1.0] - vx[1.0]), vx
    assert tpt.tagged_misses(vx) == []
    assert [r["n"] for r in t["spin_up"]] == [2, 2, 2]


S12_N, S12_T = 40, 12
S12_KW = dict(h=0.01, dt_plasma=0.01, apply_force=False)


def _s12_inputs(seed=3):
    """Excited start amplitudes, velocities around the EIT grid, clocks,
    ``[T, 5, N]`` uniforms with small jump draws (jumps fire) and some
    collapse draws at the largest float32 below 1 (the saturated pad
    entries of the cumulative tables must never be picked)."""
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=(12, S12_N)) + 1j * rng.normal(size=(12, S12_N))
    psi /= np.sqrt((np.abs(psi) ** 2).sum(0, keepdims=True))
    vx = rng.normal(0, 1.0, S12_N).astype(np.float32)
    tp = np.abs(rng.normal(0, 1.0, S12_N)).astype(np.float32)
    rolls = rng.uniform(size=(S12_T, 5, S12_N)).astype(np.float32)
    rolls[:, 0] *= 0.05
    top = np.nextafter(np.float32(1), np.float32(0))
    rolls[::3, 1, ::4] = top
    rolls[1::3, 4, ::5] = top
    return psi.astype(np.complex64), vx, tp, rolls


def test_free_ion_ticks_s12_match_jax_step_sm(monkeypatch):
    """The EIT route: ``free_ion_ticks`` with the S = 12 tables of
    sr12_cooling(-1, 1, 1, 1) and no force, one launch of 12 ticks (the
    plain twin here), against JAX's ``step_sm`` tick by tick on the same
    uniforms (vx and t_part 2e-5, psi 5e-5 + 1e-4 relative, as
    tests/test_fused.py:91-101); vx bit for bit unchanged; the launch's
    pad rows and padded lanes exactly zero."""
    psi, vx, tp, rolls = _s12_inputs()
    eng = tqt.QTEngine(tlv.sr12_cooling(-1.0, 1.0, 1.0, 1.0), **S12_KW)
    spec = tsched.free_ion_spec(eng, S12_T)
    assert (spec.S, spec.SP, spec.apply_force) == (12, 16, False)
    seen = []
    real = tsched.fused_md_substeps

    def record(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out
    monkeypatch.setattr(tsched, "fused_md_substeps", record)
    got = [x.numpy() for x in tsched.free_ion_ticks(
        spec, *(torch.from_numpy(x) for x in (vx, psi, tp, rolls)))]
    (_, V, tpo, pre, pim), = seen
    npad = V.shape[1]
    assert npad == 128
    for plane in (pre, pim):
        assert not plane[12:].any() and not plane[:, S12_N:].any()
    assert not V[1:].any() and not V[0, S12_N:].any()
    je = jqt.QTEngine(jlv.sr12_cooling(-1.0, 1.0, 1.0, 1.0), **S12_KW)
    step = jax.jit(lambda a, b, c, r: je.step_sm(a, b, c, rolls=r))
    st = (jnp.asarray(psi), jnp.asarray(vx), jnp.asarray(tp))
    for k in range(S12_T):
        st = step(*st, jnp.asarray(rolls[k]))
    psi_j, vx_j, tp_j = (np.asarray(x) for x in st)
    for what, g, w, atol in zip(("vx", "psi", "t_part"), got,
                                (vx_j, psi_j, tp_j), (2e-5, 5e-5, 2e-5)):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w, atol=atol, rtol=1e-4, err_msg=what)
    np.testing.assert_array_equal(got[0], vx)
    assert int((got[2] < S12_T * 0.01).sum()) >= 10        # jumps fired


def test_eit_chunks_are_one_launch_each_and_leave_vx(monkeypatch):
    """``eit_populations`` launches once per chunk of ticks (the last one
    short) and leaves every vx as it was."""
    launches = []
    real = tsched.free_ion_ticks

    def count(spec, vx, psi, tp, rolls, *a):
        launches.append(rolls.shape[0])
        return real(spec, vx, psi, tp, rolls, *a)
    monkeypatch.setattr(tsched, "free_ion_ticks", count)
    e = tpt.eit_populations("cpu", ntraj=3, ticks=25, chunk=10)
    assert launches == [10, 10, 5]
    assert e["v_fixed"] and len(e["pop_p"]) == len(e["pop_d"]) == 5
    assert all(0.0 <= p <= 1.0 for p in e["pop_p"] + e["pop_d"])


# the keys the archive tests read, by section of the report
REPORT_KEYS = {
    "dih": {"n0", "n_steps", "T", "launches", "t_peak", "T_peak",
            "gamma_final", "T_dip", "wall_s"},
    "eit": {"v", "ntraj", "ticks", "chunk", "pop_p", "pop_d", "v_fixed",
            "launches", "wall_s"},
    "tagged": {"config", "dets", "rows", "spin_up", "launches", "wall_s"},
}
DIP_KEYS = {"det_sp", "det_dp", "n0", "tmax", "seed", "v2", "p2q", "v_res",
            "centers", "profile", "files", "file_bytes", "wall_s",
            "launches"}


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_every_target_tiny_on_cpu(tmp_path):
    """``run_targets`` at a tiny size: every section and key the archive
    tests read, the dip files copied, no launch on the CPU, and
    ``report_misses`` reads the report."""
    rep = tpt.run_targets(
        "cpu", str(tmp_path / "work"), str(tmp_path / "out"),
        dih=(256, 12), budget=(256, 8), eit=dict(ntraj=2, ticks=6, chunk=4),
        dip=dict(n0=32, tmax=0.04, sample_freq=2),
        tag=dict(n0=32, tstart=0.02, tmax=0.3, sample_freq=4,
                 tpump_seconds=5e-8))
    for sec, keys in REPORT_KEYS.items():
        assert keys <= set(rep[sec]), (sec, keys - set(rep[sec]))
    assert {"f32", "f64", "early", "late"} <= set(rep["dih_budget"])
    assert rep["dih_budget"]["f64"]["dtype"] == "float64"
    assert rep["device"]["card"] == "cpu"
    assert set(rep["dip"]) == {"dip_-1_1", "dip_-0.5_1"}
    for name, d in rep["dip"].items():
        assert DIP_KEYS <= set(d), DIP_KEYS - set(d)
        copied = sorted(os.listdir(tmp_path / "out" / name))
        assert copied == d["files"] and len(copied) == 10
    for sec in ("dih", "eit", "tagged"):
        assert rep[sec]["launches"] == {}
    assert set(rep["walls_s"]) == {"dih", "dih_budget", "eit", "dip",
                                   "tagged"}
    assert isinstance(tpt.report_misses(rep), list)


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_dip_seed_scan_tiny_on_cpu(tmp_path):
    """``tools/torch_dip_seed_scan.py``'s scan at a tiny size: per case
    and seed the keys the seed tests read, the misses those of the
    target's run at that seed, and ``passes`` counting them; its ``main``
    refuses to run without a card."""
    over = dict(n0=32, tmax=0.04, sample_freq=2)
    rec = tds.scan([1, 2], str(tmp_path), "cpu", **over)
    assert set(rec) == {"dip_-1_1", "dip_-0.5_1"}
    for (det_sp, det_dp, n_right), (name, seeds) in zip(tpt.DIP_CASES,
                                                        rec.items()):
        assert name == tpt.dip_name(det_sp, det_dp) and set(seeds) == {
            "1", "2"}
        d = tpt.dark_state_dip(det_sp, det_dp, str(tmp_path / "one"), "cpu",
                               seed=2, **over)
        assert seeds["2"]["profile"] == d["profile"]
        assert seeds["2"]["misses"] == tpt.dip_misses(
            d["centers"], tpt.profile_array(d["profile"]), d["v_res"],
            n_right)
        assert {"v_dip", "v2", "launches", "wall_s"} <= set(seeds["2"])
    assert all(n == 2 and 0 <= k <= 2 for k, n in tds.passes(rec).values())
    out = tmp_path / "dip_seeds.json"        # no card here: refused
    assert tds.main(["--out", str(out)]) == 2 and not out.exists()


def test_dip_depth_reads_the_window_and_shoulder():
    """``dip_depth``: the lowest finite bin within 0.25 of v_res over the
    JAX recipe's inner-shoulder mean (centres v_res-0.9 .. v_res-0.3)."""
    centers = 0.05 + 0.1 * np.arange(30)
    prof = np.full(30, 0.2)
    prof[5:8] = (0.3, 0.1, 0.5)         # shoulder of v_res = 1.3: 0.3
    prof[11] = np.nan                    # 1.15: inside the window, NaN
    prof[12], prof[14], prof[16] = 0.06, 0.03, 0.01     # 1.25, 1.45, 1.65
    depth = tds.dip_depth(centers, [None if np.isnan(x) else x
                                    for x in prof], 1.3)
    assert depth == 0.03 / np.mean([0.2, 0.3, 0.1, 0.5, 0.2, 0.2])


def test_dip_profile_is_the_jax_recipe(tmp_path):
    """``dip_profile`` bins as the JAX test does (tests/test_physics_
    targets.py:161-172): 30 bins over 0-3, NaN at 10 ions or fewer."""
    rng = np.random.default_rng(0)
    files = []
    for k in range(3):
        rows = np.column_stack([rng.normal(0, 1, 200), rng.uniform(size=200),
                                rng.uniform(size=200), rng.uniform(size=200)])
        files.append(str(tmp_path / f"statePopulationsVsVTime{k:06d}.dat"))
        np.savetxt(files[-1], rows)
    centers, prof = tpt.dip_profile(files, 1.5)
    rows = np.concatenate([np.loadtxt(f) for f in files])
    v = np.abs(rows[:, 0]) * 1.5
    which = np.digitize(v, np.linspace(0, 3.0, 31))
    for i in range(30):
        sel = which == i + 1
        if sel.sum() > 10:
            assert prof[i] == rows[sel, 2].mean()
        else:
            assert np.isnan(prof[i])
    assert np.allclose(centers, 0.05 + 0.1 * np.arange(30))


# ---- the card's archive

@pytest.fixture(scope="module")
def report():
    if not os.path.exists(REPORT):
        pytest.skip("no card record; run tools/torch_physics_targets.py on "
                    "the card")
    with open(REPORT) as f:
        return json.load(f)


def test_archived_report_is_the_card_run(report):
    card = report["device"]["card"]
    assert card != "cpu" and "," in card, card
    assert tpt.report_misses(report) == report["misses"]
    assert report["ok"] == (not report["misses"])
    assert report["dih"]["launches"]["yukawa_forces"] >= 2000
    assert report["dih_budget"]["f32"]["launches"]["yukawa_forces"] >= 800
    assert report["dih_budget"]["f64"]["launches"] == {}
    assert report["eit"]["launches"]["fused_ticks"] > 0
    for d in report["dip"].values():
        assert d["launches"]["fused_ticks_rng"] > 0
    assert report["tagged"]["launches"]["fused_ticks_s5_per_lane_e0"] > 0


def test_phase33_launch_counts_are_the_card_runs(report):
    """chip_smoke.py's exact launch counts of phase 33's dip runs and
    tagged class (``cooling_fold_counts``, ``frozen_sweep_counts``) are
    those the card's report recorded."""
    import chip_smoke
    for name, d in report["dip"].items():
        assert chip_smoke.cooling_fold_counts(
            tpt.dip_config(d["det_sp"], d["det_dp"], None),
            "fused_ticks_rng") == d["launches"], name
    from mdqtplasmasims_torch.experiments.frozen_tagging import (
        FrozenTagConfig)
    assert chip_smoke.frozen_sweep_counts(
        torch, FrozenTagConfig(**report["tagged"]["config"])) \
        == report["tagged"]["launches"]


def test_archived_dip_run_is_byte_for_byte(tmp_path):
    """chip_smoke.py's ``archived_dip_run``: a tree holding the archived
    population files is the archived run; one byte changed, or a file
    fewer, is not."""
    import shutil
    import chip_smoke
    name = "dip_-0.5_1"
    job = tmp_path / name / "Ge10" / "job1"
    shutil.copytree(os.path.join(ARCHIVE, name), job)
    assert chip_smoke.archived_dip_run(tpt, str(tmp_path), name)
    last = sorted(job.iterdir())[-1]
    text = last.read_bytes()
    last.write_bytes(text[:-2] + (b"0" if text[-2:-1] != b"0" else b"1")
                     + text[-1:])
    assert not chip_smoke.archived_dip_run(tpt, str(tmp_path), name)
    last.unlink()
    assert not chip_smoke.archived_dip_run(tpt, str(tmp_path), name)


def test_archived_dih_temperature_curve(report):
    """tests/test_physics_targets.py:47-61 on the card's curve (float32
    through kernel A, from the JAX test's start)."""
    assert (report["dih"]["n0"], report["dih"]["n_steps"]) == (512, 2000)
    T = np.asarray(report["dih"]["T"])
    t_peak = (np.argmax(T[:800]) + 1) * 0.002
    assert 0.3 < t_peak < 2.0
    assert 0.30 < T[:800].max() < 0.55
    gamma_final = 1.0 / T[1500:].mean()
    assert 2.4 < gamma_final < 3.3
    # kinetic-energy oscillation: a dip after the first peak
    assert T[500:1200].min() < 0.95 * T[:800].max()


def test_archived_f32_matches_f64_within_budget(report):
    """tests/test_physics_targets.py:95-109 on the card's pair (float32
    through kernel A; float64 through the plain all-pairs version)."""
    b = report["dih_budget"]
    assert (b["f32"]["n0"], b["f32"]["n_steps"]) == (256, 800)
    assert (b["f64"]["n0"], b["f64"]["n_steps"]) == (256, 800)
    T64, T32 = np.asarray(b["f64"]["T"]), np.asarray(b["f32"]["T"])
    scale = T64.max()
    # early times: trajectories still coherent
    assert np.abs(T64[:200] - T32[:200]).max() / scale < 0.01
    # late times: time-averaged temperature agrees
    assert abs(T64[500:].mean() - T32[500:].mean()) / scale < 0.05


def test_archived_dih_matches_jax_early(report, jax_dih_200):
    """The card's float32 curve's first 200 steps against JAX's float64
    ``run_dih(512, 200)`` at the budget's 0.01 of the maximum."""
    T = np.asarray(report["dih"]["T"])[:200]
    assert np.abs(T - jax_dih_200).max() / jax_dih_200.max() < 0.01


def test_archived_eit_dark_state_resonance(report):
    """tests/test_physics_targets.py:63-93's asserts on the card's
    populations (the S = 12 explicit form, 3000 ticks, 120 ions a v)."""
    e = report["eit"]
    assert e["v"] == [-1.43, -0.9, 0.0, 0.9, 1.43]
    assert (e["ntraj"], e["ticks"]) == (120, 3000) and e["v_fixed"]
    popP, popD = e["pop_p"], e["pop_d"]
    for i_res, i_off in ((0, 1), (4, 3)):       # +-1.43 vs +-0.9
        assert popP[i_res] < 0.75 * popP[i_off]
        assert popD[i_res] > 1.3 * popD[i_off]
    assert popD[0] > 1.5 * popD[2]               # resonance vs v=0


def _jax_dip_asserts(prof, det_sp, det_dp, n_right):
    """tests/test_physics_targets.py:174-202, verbatim, on a profile."""
    from mdqtplasmasims_tpu.units import K_RATIO_1033
    bins = np.linspace(0, 3.0, 31)
    centers = 0.5 * (bins[1:] + bins[:-1])

    v_res = abs(det_dp - det_sp) / (1.0 + K_RATIO_1033)
    window = np.isfinite(prof) & (np.abs(centers - v_res) <= 0.45)
    assert window.sum() >= 4, "resonance window lacks statistics"
    # the dip is a LOCAL minimum riding the thermal-tail falloff: a
    # plain window argmin latches onto the falling tail's edge, so
    # find local minima (lower than both neighbors) in the window
    # and take the one nearest the resonance
    cand = [i for i in np.flatnonzero(window)
            if 0 < i < len(prof) - 1
            and np.isfinite(prof[i - 1]) and np.isfinite(prof[i + 1])
            and prof[i] < prof[i - 1] and prof[i] < prof[i + 1]]
    assert cand, "no local dip inside the resonance window"
    i_dip = min(cand, key=lambda i: abs(centers[i] - v_res))
    v_dip = centers[i_dip]
    assert abs(v_dip - v_res) <= 0.25, (v_dip, v_res)
    # dip depth vs the inner shoulder (the outer side rides the
    # thermal-tail falloff, so anchor on the resonance's low-|v|
    # side, which is populated); n_right bins of head-room
    shoulder = np.isfinite(prof) & (centers < v_res - 0.3) & \
        (centers > v_res - 0.9)
    assert prof[i_dip] < 0.75 * prof[shoulder].mean(), \
        (prof[i_dip], prof[shoulder].mean())
    # and it is a LOCAL dip, not the tail: some bin at higher |v|
    # inside the data range recovers above the dip
    right = np.isfinite(prof) & (centers > v_dip) & \
        (centers <= v_dip + 0.4)
    if right.sum() >= n_right - 1:
        assert prof[right].max() > prof[i_dip]


def _meets_jax_asserts(prof, case) -> bool:
    try:
        _jax_dip_asserts(tpt.profile_array(prof), *case)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("det_sp,det_dp,n_right",
                         [(-1.0, 1.0, 2), (-0.5, 1.0, 3)])
def test_archived_dark_state_dip_tracks_detuning(report, det_sp, det_dp,
                                                 n_right):
    """tests/test_physics_targets.py:133-202 on the card run's last 20
    population files (N0=256, tmax=3, seed 1), archived under
    ``dip_<detSP>_<detDP>/``: the profile by the JAX test's recipe, then
    its asserts."""
    from mdqtplasmasims_tpu.experiments.laser_cooling import (CoolingConfig,
                                                              build_engine)
    name = tpt.dip_name(det_sp, det_dp)
    rec = report["dip"][name]
    assert (rec["n0"], rec["tmax"], rec["seed"]) == (256, 3.0, 1)
    cfg = CoolingConfig(n0=256, tmax=3.0, sample_freq=50,
                        use_pallas=False, detuning=det_sp,
                        detuning_dp=det_dp)
    p2q = build_engine(cfg).plas_to_quant_vel
    assert p2q == rec["p2q"]
    files = sorted(glob.glob(os.path.join(
        ARCHIVE, name, "statePopulationsVsVTime*.dat")))[-20:]
    assert [os.path.basename(f) for f in files] == rec["files"]
    assert len(files) == 20
    # tests/test_physics_targets.py:164-172
    rows = np.concatenate([np.loadtxt(f) for f in files])
    v_q = np.abs(rows[:, 0]) * p2q       # gamma/k units, folded
    pop_p = rows[:, 2]
    bins = np.linspace(0, 3.0, 31)
    which = np.digitize(v_q, bins)
    prof = np.array([pop_p[which == i].mean()
                     if (which == i).sum() > 10 else np.nan
                     for i in range(1, len(bins))])
    np.testing.assert_array_equal(prof, tpt.profile_array(rec["profile"]))
    _jax_dip_asserts(prof, det_sp, det_dp, n_right)


@pytest.fixture(scope="module")
def jax_dip_seeds():
    with open(tds.JAX_OUT) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def card_dip_seeds():
    if not os.path.exists(tds.OUT):
        pytest.skip("no card record of the dip's seed scan; run "
                    "tools/torch_dip_seed_scan.py on the card")
    with open(tds.OUT) as f:
        return json.load(f)


def test_jax_dip_seed_record(jax_dip_seeds):
    """The JAX package's scan (tools/jax_dip_seed_scan.py): seeds 1-17 of
    both cases, each record's misses those of the JAX asserts on its
    profile, and seed 1, the JAX test's own, meeting them."""
    for det_sp, det_dp, n_right in tpt.DIP_CASES:
        recs = jax_dip_seeds[tpt.dip_name(det_sp, det_dp)]
        assert sorted(recs, key=int) == [str(s) for s in range(1, 18)]
        for seed, r in recs.items():
            assert _meets_jax_asserts(r["profile"], (det_sp, det_dp,
                                                     n_right)) \
                == (not r["misses"]), seed
        assert not recs["1"]["misses"]


# the two scans' samples are held equal at this significance
SEED_SCAN_ALPHA = 0.05


@pytest.mark.parametrize("det_sp,det_dp,n_right",
                         [(-1.0, 1.0, 2), (-0.5, 1.0, 3)])
def test_archived_dip_seed_rate_matches_jax(report, card_dip_seeds,
                                            jax_dip_seeds, det_sp, det_dp,
                                            n_right):
    """The card's dip at seeds 1-17 (tools/torch_dip_seed_scan.py; its
    seed 1 the target's run, bit for bit) beside the JAX package's at the
    same seeds: the seeds meeting every JAX assert (each record's misses
    those of the verbatim asserts) are not fewer on the card by Fisher's
    exact test, and the dip's depth (``dip_depth``) is not shifted by a
    two-sided Mann-Whitney test, each at :data:`SEED_SCAN_ALPHA`."""
    from scipy import stats
    name, case = tpt.dip_name(det_sp, det_dp), (det_sp, det_dp, n_right)
    card = card_dip_seeds["seeds"][name]
    assert "," in card_dip_seeds["device"]["card"]
    assert sorted(card, key=int) == [str(s) for s in tds.SEEDS]
    assert card["1"]["profile"] == report["dip"][name]["profile"]
    ok = {}
    for who, recs in (("card", card), ("jax", jax_dip_seeds[name])):
        ok[who] = [_meets_jax_asserts(r["profile"], case)
                   for r in recs.values()]
        assert ok[who] == [not r["misses"] for r in recs.values()]
    k, kj, n = sum(ok["card"]), sum(ok["jax"]), len(ok["card"])
    assert stats.fisher_exact([[k, n - k], [kj, n - kj]],
                              alternative="less").pvalue \
        >= SEED_SCAN_ALPHA, (k, kj, n)
    v_res = tpt.v_resonance(det_sp, det_dp)
    depth = {who: [tds.dip_depth(report["dip"][name]["centers"],
                                 r["profile"], v_res) for r in recs.values()]
             for who, recs in (("card", card), ("jax", jax_dip_seeds[name]))}
    assert stats.mannwhitneyu(depth["card"], depth["jax"]).pvalue \
        >= SEED_SCAN_ALPHA, depth


def test_archived_tagged_vx_antisymmetric_in_detuning(report):
    """tests/test_physics_targets.py:430-450's asserts on the card's
    sweep (kernel C, B's S = 5 per-lane e0 form and G)."""
    t = report["tagged"]
    assert t["config"] == dict(variant="422linear", n0=512, tstart=2.0,
                               tmax=2.5, timestep=0.01, sample_freq=40,
                               tpump_seconds=3e-7)
    vx = {r["detuning"]: r["mean"] for r in t["rows"]}
    # class selection: red pump tags the +v class and vice versa
    assert vx[-1.0] > 0.1, vx
    assert vx[1.0] < -0.1, vx
    # resonance: no class preference (scatter at N0=512 x 2 ~ 0.04)
    assert abs(vx[0.0]) < 0.12, vx
    # antisymmetry of the selection (same seeds both signs)
    assert abs(vx[-1.0] + vx[1.0]) < 0.5 * abs(vx[-1.0] - vx[1.0]), vx


def test_archived_cooling_slope_from_energies_dat():
    """tests/test_physics_targets.py:204-230's asserts on the port soak's
    archived production energies.dat (N=3500, tmax=30 on the card)."""
    fs = glob.glob(os.path.join(SOAK, "cooling", "**", "energies.dat"),
                   recursive=True)
    if not fs:
        pytest.skip("no archived production energies.dat of the port")
    assert len(fs) == 1 and "NumIons3500" in fs[0]
    e = np.loadtxt(fs[0]).reshape(-1, 7)
    t, tx, ty = e[:, 0], 2 * e[:, 1], 2 * e[:, 2]
    assert abs(t[-1] - 30.0) < 0.1
    i_pk = int(np.argmax(tx[:len(tx) // 3]))
    assert 0.3 < t[i_pk] < 2.0            # DIH peak at omega_p t ~ 1
    sel = t >= 5.0
    rate, logt0 = np.polyfit(t[sel], np.log(tx[sel]), 1)
    rate = -rate
    assert 0.005 < rate < 0.030, rate
    # fit quality: residuals of the exponential small vs the decay
    resid = np.log(tx[sel]) - (logt0 - rate * t[sel])
    assert resid.std() < 0.08
    # monotone on the smoothed curve: every 5-plasma-time block mean
    # decreases
    blocks = [tx[(t >= a) & (t < a + 5)].mean()
              for a in (5, 10, 15, 20, 25)]
    assert all(b1 > b2 for b1, b2 in zip(blocks, blocks[1:]))
    # 1D cooling: x sits below y through the cooled era
    assert (tx[sel] < ty[sel]).mean() > 0.8
    # end-to-peak-era ratio matches the archived soak band
    assert 0.5 < tx[-1] / tx[(t > 3) & (t < 8)].mean() < 0.9


def test_archived_soak_green_kubo_d():
    """tests/test_physics_targets.py:377-396's asserts on the port soak's
    transport VAF (Gamma=3, kappa=0.5, N=4096 on the card), through the
    JAX package's ``green_kubo_diffusion`` (the port's gives the same)."""
    from mdqtplasmasims_tpu.analysis import green_kubo_diffusion
    from mdqtplasmasims_torch import analysis as tan
    jd = os.path.join(SOAK, "transport", "Gamma300Kappa50NumIons4096",
                      "job1")
    if not os.path.exists(os.path.join(jd, "VAF.dat")):
        pytest.skip("the port's transport soak files are not archived")
    gk = green_kubo_diffusion(os.path.join(jd, "VAF.dat"))
    assert 0.70 < gk["d"] < 0.95, gk
    assert gk["drift"] < 0.10, gk
    t_rec = float(np.loadtxt(os.path.join(jd, "temperature.dat")).mean())
    assert abs(gk["vaf0"] - 3.0 * t_rec) < 0.02, (gk["vaf0"], t_rec)
    port = tan.green_kubo_diffusion(os.path.join(jd, "VAF.dat"))
    for k in ("d", "drift", "vaf0"):
        assert abs(port[k] - gk[k]) <= 1e-12 * abs(gk[k]), k


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_soak_archives_the_files_these_tests_read(tmp_path):
    """``tools/torch_soak.py``'s archive step on tiny CPU runs: the cooling
    run's ``energies.dat`` and the transport run's ``VAF.dat`` and
    ``temperature.dat`` land in the tree's layout (the paths the two
    soak tests above read), byte for byte; other families copy nothing."""
    import torch_soak
    trees, dest = str(tmp_path / "trees"), str(tmp_path / "archive")
    torch_soak.soak_cooling(trees, device="cpu", n0=16, tmax=0.008,
                            sample_freq=2)
    torch_soak.soak_transport(
        trees, device="cpu", n=8, mc_steps=40, gr_every_mc=20,
        pre_record_md_steps=2, record_steps=4, gr_every_record=2,
        instant_aniso_steps=2, reequil_steps=2, aniso_relax_steps=2,
        aniso_time_us=0.05)
    got = {}
    for name in ("cooling", "transport", "frozen"):
        got[name] = sorted(os.path.relpath(p, dest) for p in
                           torch_soak.archive_files(name, trees, dest))
    assert got["cooling"] == [os.path.join(
        "cooling", "Ge10Density2000E+11Sig040Te19SigFrac0DetSP-100DetDP100"
        "OmSP100OmDP100NumIons16", "job1", "energies.dat")]
    jd = os.path.join("transport", "Gamma300Kappa50NumIons8", "job1")
    assert got["transport"] == [os.path.join(jd, "VAF.dat"),
                                os.path.join(jd, "temperature.dat")]
    assert got["frozen"] == []
    for rel in got["cooling"] + got["transport"]:
        with open(os.path.join(trees, rel), "rb") as a, \
                open(os.path.join(dest, rel), "rb") as b:
            assert a.read() == b.read(), rel
