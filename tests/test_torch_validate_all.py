"""``tools/torch_validate_all.py`` against ``tools/validate_all.py``'s
archive and the ``tools/cross_validate_*.py`` tools (CPU, float64).

* The parser: for every step with a pooled table, the parsed reference and
  JAX numbers give back the logged z (and the JAX report's) within 0.05
  through the JAX tools' formula; spot values read exactly; the reference's
  pool size k from the JAX report, equal to the count the log states.
* The per-job statistics: each of the tool's functions equals the JAX
  tool's on the same input to 1e-12 (transport ``fw_job_stats``,
  ``_aniso`` and ``_hole_edge`` on the JAX package's tiny transport fold;
  dih ``scalars``; the frozen and MC-tag per-job moments and expansion's
  drift and S/P/D, with the JAX tools' module constants or configs patched
  small and their results captured where they are computed).
* The pool comparison: ``pool_z`` and ``z_gates`` equal the JAX package's
  ``two_sample_z`` / the frozen tool's ``zscore`` / ``compare_job_pools``.
* The whole tool on the CPU at ``--tiny`` (k = 2): every step in the
  report, finite statistics, every gate evaluated; no card -> exit 2.
* The card's record, ``artifacts/validate_all_torch/report.json``: every
  gated verdict re-derived from its stored numbers, its reference numbers
  the parsed logs', the JAX tools' configurations and k, an NVIDIA card.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from mdqtplasmasims_torch import analysis as tan
from mdqtplasmasims_tpu import analysis as janalysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import cross_validate_dih_pooled as jdih  # noqa: E402
import cross_validate_expansion as jexp  # noqa: E402
import cross_validate_frozen_pooled as jfrozen  # noqa: E402
import cross_validate_mc_tag as jmc  # noqa: E402
import cross_validate_transport_pooled as jtr  # noqa: E402
import torch_validate_all as tva  # noqa: E402

torch.set_num_threads(1)

ARCHIVE = os.path.join(tva.OUT, "report.json")
TABLED = ("transport_pooled", "frozen_pooled_422", "frozen_pooled_408",
          "dih_pooled")
# the labels of the archived ``ref X vs Y`` lines each gated step reads
VS_LABELS = {
    "frozen_pooled_422": ("pooled tag fraction",),
    "frozen_pooled_408": ("pooled tag fraction",),
    "expansion": ("final S/P/D", "late <vx> drift"),
    "flagship": ("final S/P/D",),
    "mc_tag_408quad": ("pooled tagged <vx^2>", "pooled tag fraction",
                       "mean temperature"),
    "mc_tag_408linear": ("pooled tagged <vx^2>", "pooled tag fraction",
                         "mean temperature"),
    "transport_curve": ("g(r) first peak", "correlation-hole edge bin",
                        "mean temperature"),
}
WANT_K = {"transport_pooled": 16, "frozen_pooled_422": 8,
          "frozen_pooled_408": 8, "dih_pooled": 4, "expansion": 4,
          "flagship": 3, "mc_tag_408quad": 8, "mc_tag_408linear": 8,
          "transport_curve": 1}


def to_numpy(x):
    """A result tree (dicts, lists, JAX arrays) with numpy leaves."""
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    if hasattr(x, "shape"):
        return np.asarray(x)
    return x


def assert_same(got: dict, want: dict, keys=None):
    keys = sorted(want) if keys is None else keys
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=0, atol=1e-12, err_msg=k)


class FrameLocals:
    """A module's ``print`` replaced by one that keeps the calling frame's
    locals: the JAX tools compute some per-job statistics inline in
    ``main``; this reads them where they were computed."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kw):
        self.calls.append((" ".join(str(a) for a in args),
                           dict(sys._getframe(1).f_locals)))

    def at(self, prefix: str) -> dict:
        return next(loc for text, loc in self.calls
                    if text.startswith(prefix))


# ---- the parser

# observables whose printed 4-decimal numbers leave z wider than +-0.05
# (a sd of a few 1e-4 against a mean difference of 1e-4 or 2e-4)
ROUNDED_WIDE = {("transport_pooled", k) for k in (
    "vaf[20]", "vaf[60]", "v2[20]", "v3[20]")}


@pytest.mark.parametrize("name", TABLED)
def test_parsed_table_reproduces_the_logged_z(name):
    ref = tva.parse_step(name)
    zs = tva.jax_report()[name]["z_scores"]
    assert ref["table"] and set(ref["table"]) == set(zs)
    for key, r in ref["table"].items():
        args = (r["ref_mean"], r["ref_sd"], ref["k"], r["jax_mean"],
                r["jax_sd"], ref["k"])
        z = tva.pool_z(*args)
        lo, hi = tva.z_range(*args, fw_half=tva.LOG_HALF_UNIT)
        assert lo - 0.005 <= r["jax_z"] <= hi + 0.005, (key, z, r)
        if (name, key) in ROUNDED_WIDE:
            assert hi - lo > 0.1, (key, lo, hi)
        else:
            assert abs(z - r["jax_z"]) < 0.05, (key, z, r)
        assert r["jax_z"] == zs[key]


@pytest.mark.parametrize("name,key,want", [
    ("transport_pooled", "t_mean", -0.66),
    ("frozen_pooled_422", "m1_tag", -1.87),
    ("frozen_pooled_408", "frac", 0.47),
    ("dih_pooled", "peak_ekx", -2.21)])
def test_spot_z_from_the_parsed_numbers(name, key, want):
    ref = tva.parse_step(name)
    r = ref["table"][key]
    assert abs(tva.pool_z(r["ref_mean"], r["ref_sd"], ref["k"],
                          r["jax_mean"], r["jax_sd"], ref["k"]) - want) < 0.05


def test_spot_values_read_exactly():
    t = tva.parse_step("transport_pooled")["table"]["t_mean"]
    assert (t["ref_mean"], t["ref_sd"]) == (0.3281, 0.0121)
    assert (t["jax_mean"], t["jax_sd"]) == (0.3307, 0.0098)
    assert tva.parse_step("flagship")["vs"]["final S/P/D"] == dict(
        ref=[0.594, 0.183, 0.228], jax=[0.604, 0.183, 0.219])
    f = tva.parse_step("frozen_pooled_422")
    assert f["vs"]["pooled tag fraction"] == dict(ref=0.4324, jax=0.4337)
    assert f["table"]["frac"]["ref_mean"] == 0.4324
    e = tva.parse_step("expansion")["vs"]
    assert e["late <vx> drift"] == dict(ref=-0.0084, jax=-0.0086)
    assert e["final S/P/D"]["ref"] == [0.59, 0.191, 0.226]
    assert tva.parse_step("transport_curve")["vs"][
        "correlation-hole edge bin"] == dict(ref=17.0, jax=17.0)


@pytest.mark.parametrize("name", sorted(WANT_K))
def test_reference_pool_size(name):
    ref = tva.parse_step(name)
    assert ref["k"] == WANT_K[name]
    if ref["k_logged"] is not None:
        assert ref["k_logged"] == ref["k"]
    for label in VS_LABELS.get(name, ()):
        assert set(ref["vs"][label]) == {"ref", "jax"}, label


# ---- the per-job statistics against the JAX tools'

TINY_TRANSPORT = tva.TINY["transport_pooled"]


@pytest.fixture(scope="module")
def jax_transport():
    """The JAX package's tiny transport fold (seed 7, two jobs)."""
    from mdqtplasmasims_tpu.experiments import mc_md_anisotropy as jm
    cfg = jm.MCTransportConfig(dtype="float64", **TINY_TRANSPORT)
    return [to_numpy(r) for r in jm.run_ensemble(cfg, 2, seed=7)]


@pytest.mark.parametrize("job", [0, 1])
def test_transport_job_stats_equal_jax_tools(jax_transport, job,
                                             monkeypatch):
    rec = TINY_TRANSPORT["record_steps"]
    monkeypatch.setattr(jtr, "RECORD_STEPS", rec)
    res = jax_transport[job]
    want = jtr.fw_job_stats(res)
    got = tva.fw_job_stats(res, rec)
    assert list(got) == list(want)
    assert_same(got, want)
    assert len(tva.transport_keys(got)) == 28


@pytest.mark.parametrize("stage", ["temps_inst", "temps_force",
                                   "temps_relax", "gr_record"])
def test_transport_helpers_equal_jax_tools(jax_transport, stage):
    for res in jax_transport:
        x = np.asarray(res[stage], np.float64)
        if stage == "gr_record":
            for g in x:
                assert tva._hole_edge(g) == jtr._hole_edge(g)
            continue
        rows = np.concatenate([np.arange(len(x))[:, None] * 0.005, x], 1)
        np.testing.assert_array_equal(tva._aniso(rows), jtr._aniso(rows))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dih_scalars_equal_jax_tools(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(1, 301) * 0.02
    ekx = (0.16 * (1 - np.exp(-t / 0.3)) * (1 + 0.2 * np.sin(4 * t)
                                             * np.exp(-t / 2))
           + 0.01 * rng.random(t.shape))
    got, want = tva.scalars(t, ekx), jdih.scalars(t, ekx)
    assert list(got) == list(want) == list(tva.DIH_KEYS)
    assert_same(got, want)


@pytest.mark.parametrize("variant", ["422linear", "408linear"])
def test_frozen_job_stats_equal_jax_tools(variant, monkeypatch):
    from mdqtplasmasims_tpu.experiments import frozen_tagging as jft
    cut = tva.TINY["frozen_pooled_422"]
    for name, key in (("N0", "n0"), ("TSTART", "tstart"), ("TMAX", "tmax"),
                      ("SAMPLE_FREQ", "sample_freq")):
        monkeypatch.setattr(jfrozen, name, cut[key])
    cfg0, run0, kept = jft.FrozenTagConfig, jft.run, []
    monkeypatch.setattr(jft, "FrozenTagConfig", lambda **kw: cfg0(
        tpump_seconds=cut["tpump_seconds"], **kw))
    monkeypatch.setattr(jft, "run", lambda cfg: kept.append(run0(cfg))
                        or kept[-1])
    want = jfrozen.fw_job_stats(variant, 1)
    got = tva.frozen_job_stats(variant, to_numpy(kept[0][1]))
    assert list(got) == list(want) == list(tva.FROZEN_KEYS)
    assert_same(got, want)


def _fake_mc_tag_family(root: str, jobs: int) -> str:
    """A reference family directory in the layout ``ref_job`` reads
    (cross_validate_mc_tag.py:42-55), arbitrary numbers."""
    rng = np.random.default_rng(5)
    fam = os.path.join(root, "fam")
    for j in range(1, jobs + 1):
        d = os.path.join(fam, f"job{j}")
        os.makedirs(d)
        np.savetxt(os.path.join(d, "taggedMoments.dat"), rng.random((3, 5)))
        np.savetxt(os.path.join(d, "temperature.dat"), rng.random(20))
        np.savetxt(os.path.join(d, "VAF.dat"),
                   np.stack([np.arange(20.0), 1 + rng.random(20)], -1))
        np.savetxt(os.path.join(d, "vel_distX_timestep000100.dat"),
                   np.stack([np.linspace(-1, 1, 11), rng.random(11)], -1))
    return fam


@pytest.mark.parametrize("variant", ["408quad"])
def test_mc_tag_job_stats_equal_jax_tools(variant, tmp_path, monkeypatch):
    from mdqtplasmasims_tpu.experiments import mc_qt_tagging as jmt
    cut = {k: v for k, v in tva.TINY["mc_tag_408quad"].items()}
    cfg0, run0, kept = jmt.MCTagConfig, jmt.run, []
    monkeypatch.setattr(jmt, "MCTagConfig", lambda **kw: cfg0(
        **dict(kw, **cut)))
    monkeypatch.setattr(jmt, "run", lambda cfg: kept.append(run0(cfg))
                        or kept[-1])
    frames = FrameLocals()
    monkeypatch.setattr(jmc, "print", frames, raising=False)
    jmc.main(_fake_mc_tag_family(str(tmp_path), 2), variant=variant)
    loc = frames.at("CROSS-VALIDATION")
    mine = loc["mine"]
    got = [tva.mc_tag_job_stats(to_numpy(r)) for r in kept]
    assert len(got) == len(mine) == 2
    for g, w in zip(got, mine):
        assert list(g) == list(w)
        assert_same(g, w)
    vm = tan.weighted_pooled_mean([g["vx2"] for g in got],
                                  [g["frac"] for g in got])
    assert abs(vm - loc["vm"]) < 1e-12
    assert abs(np.mean([g["frac"] for g in got]) - loc["fm"]) < 1e-12
    assert abs(np.mean([g["temp"] for g in got]) - loc["tm"]) < 1e-12


def _fake_expansion_family(workdir: str, jobs: int, rows: int) -> None:
    """Complete reference jobs in the layout cross_validate_expansion.py
    reads (energies.dat: t ekx eky ekz epot audit vxmean; a population
    file), so its ``main`` reuses them and runs only its own side."""
    rng = np.random.default_rng(6)
    for j in range(1, jobs + 1):
        d = os.path.join(workdir, "refdata_exp", "fam", f"job{j}")
        os.makedirs(d)
        e = rng.random((rows, 7))
        e[:, 0] = np.arange(1, rows + 1) * 0.008
        np.savetxt(os.path.join(d, "energies.dat"), e)
        np.savetxt(os.path.join(d, "statePopulationsVsVTime000005.dat"),
                   rng.random((9, 4)))


def test_expansion_drift_and_spd_equal_jax_tools(tmp_path, monkeypatch):
    from mdqtplasmasims_tpu.experiments import laser_cooling as jlc
    cut = tva.TINY["expansion"]
    for name, v in (("N0", cut["n0"]), ("TMAX", cut["tmax"]),
                    ("SAMPLE_FREQ", cut["sample_freq"]), ("JOBS", 2)):
        monkeypatch.setattr(jexp, name, v)
    rows = int(round(cut["tmax"] / 0.002)) // cut["sample_freq"]
    _fake_expansion_family(str(tmp_path), 2, rows)
    monkeypatch.setattr(jexp, "patch_and_compile", lambda wd: "unused")
    run0, kept = jlc.run, []
    monkeypatch.setattr(jlc, "run", lambda cfg: kept.append(run0(cfg))
                        or kept[-1])
    frames = FrameLocals()
    monkeypatch.setattr(jexp, "print", frames, raising=False)
    monkeypatch.setattr(sys, "argv", ["cross_validate_expansion.py",
                                      str(tmp_path)])
    jexp.main()
    loc = frames.at("late <vx> drift")
    assert len(kept) == 2
    for (final, _), spd in zip(kept, loc["fw_spd"]):
        np.testing.assert_allclose(tva.spd_of_psi(np.asarray(final.psi)),
                                   spd, rtol=0, atol=1e-12)
    drift = tva.late_drift([r[:, 5] for r in loc["fw_rows"]])
    assert abs(drift - loc["drift_fw"]) < 1e-12
    # the rows are the JAX runs' own <vx>(t)
    for (_, res), row in zip(kept, loc["fw_rows"]):
        np.testing.assert_array_equal(
            np.asarray(res["outs"]["vx_mean"], np.float64)[:rows], row[:, 5])


# ---- the pool comparison

@pytest.mark.parametrize("seed,ka,kb,shift", [
    (0, 8, 8, 0.0), (1, 16, 16, 0.3), (2, 4, 4, -1.0), (3, 8, 5, 0.1)])
def test_pool_z_equals_two_sample_z(seed, ka, kb, shift):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=ka), rng.normal(size=kb) + shift
    z = tva.pool_z(a.mean(), a.std(ddof=1), ka, b.mean(), b.std(ddof=1), kb)
    assert abs(z - janalysis.two_sample_z(a, b)) < 1e-12
    assert abs(z - jfrozen.zscore(a, b)) < 1e-12


@pytest.mark.parametrize("seed,z_max,shift", [
    (0, 3.0, 0.0), (1, 3.0, 1.5), (2, 2.0, 0.5), (3, 2.0, 0.0)])
def test_z_gates_equal_compare_job_pools(seed, z_max, shift, capsys):
    rng = np.random.default_rng(seed)
    keys = ("x", "y", "w")
    refs = [{k: float(v) for k, v in zip(keys, rng.normal(size=3))}
            for _ in range(8)]
    fws = [{k: float(v) + shift * (k == "y")
            for k, v in zip(keys, rng.normal(size=3))} for _ in range(8)]
    table = {}
    for k in keys:
        a = np.array([r[k] for r in refs])
        table[k] = dict(ref_mean=float(a.mean()), ref_sd=float(a.std(ddof=1)))
    gates = tva.z_gates(dict(k=8, table=table), tva.pool(fws, keys), keys,
                        z_max, "")
    for g, k in zip(gates, keys):
        assert abs(g["value"] - janalysis.two_sample_z(
            [r[k] for r in refs], [f[k] for f in fws])) < 1e-12
    assert all(g["ok"] for g in gates) == janalysis.compare_job_pools(
        refs, fws, keys, z_max=z_max)


# ---- the whole tool on the CPU

@pytest.fixture(scope="module")
def tiny_report(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("validate_all"))
    rc = tva.main(["--device", "cpu", "--tiny", "--out", out])
    with open(os.path.join(out, "report.json")) as f:
        rep = json.load(f)
    with open(os.path.join(out, "MATRIX.md")) as f:
        return rc, rep, f.read()


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


@pytest.mark.parametrize("name", [n for n, _, _ in tva.STEPS])
def test_tiny_run_reports_every_step(tiny_report, name):
    rc, rep, md = tiny_report
    assert rc == (0 if rep["ok"] else 1)
    assert rep["tiny"] and rep["dtype"] == "float64"
    assert [s["name"] for s in rep["steps"]] == [n for n, _, _ in tva.STEPS]
    entry = {s["name"]: s for s in rep["steps"]}[name]
    assert f"| {name} |" in md
    if name not in tva.GATED:
        assert not entry["gated"] and entry["reason"]
        return
    assert entry["k"] == (2 if WANT_K[name] > 1 else 1)
    assert entry["cut"] == tva.TINY[name]
    assert entry["reference"] == json.loads(json.dumps(tva.parse_step(name)))
    assert _finite(entry["port"]) and entry["gates"]
    for g in entry["gates"]:
        assert g["gated"] and math.isfinite(g["value"])
        assert g["ok"] == tva.OPS[g["op"]](g["value"], g["limit"])
    assert entry["ok"] == all(g["ok"] for g in entry["gates"])
    assert all(not u["gated"] and u["reason"] for u in entry["ungated"])
    # on the CPU every kernel's plain version runs: no launch is counted
    assert entry["launches"] == {}


def test_refuses_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tva.main(["--out", str(tmp_path)]) == 2
    assert not os.listdir(tmp_path)


def test_only_keeps_the_other_steps(tmp_path):
    out = str(tmp_path)
    tva.main(["--device", "cpu", "--tiny", "--only", "three_state",
              "--out", out])
    tva.main(["--device", "cpu", "--only", "resume_interop", "--out", out])
    with open(os.path.join(out, "report.json")) as f:
        rep = json.load(f)
    assert [s["name"] for s in rep["steps"]] == ["three_state",
                                                 "resume_interop"]


# ---- the card's record

@pytest.fixture(scope="module")
def archived():
    with open(ARCHIVE) as f:
        return json.load(f)


def test_archive_names_the_card(archived):
    card = archived["device"]["card"]
    assert card.startswith("NVIDIA") and card.endswith("W"), card
    assert archived["dtype"] == "float32" and not archived["tiny"]
    assert [s["name"] for s in archived["steps"]] == [n for n, _, _ in
                                                      tva.STEPS]


CONFIGS = {"frozen_pooled_422": dict(tva.FROZEN, variant="422linear"),
           "frozen_pooled_408": dict(tva.FROZEN, variant="408linear"),
           "dih_pooled": tva.DIH, "expansion": tva.EXPANSION,
           "flagship": tva.FLAGSHIP,
           "mc_tag_408quad": dict(tva.MC_TAG, variant="408quad"),
           "mc_tag_408linear": dict(tva.MC_TAG, variant="408linear"),
           "transport_pooled": tva.TRANSPORT,
           "transport_curve": tva.TRANSPORT_CURVE}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_archive_rederives_every_gated_verdict(archived, name):
    entry = {s["name"]: s for s in archived["steps"]}[name]
    ref = tva.parse_step(name)
    assert entry["reference"] == json.loads(json.dumps(ref))
    assert entry["gated"] and entry["cut"] == {}
    assert entry["k"] == ref["k"] == WANT_K[name]
    assert entry["dtype"] == "float32"
    assert {k: entry["config"][k] for k in CONFIGS[name]} == CONFIGS[name]
    for g in entry["gates"]:
        assert g["ok"] == tva.OPS[g["op"]](g["value"], g["limit"])
        if g["name"].startswith("z "):
            key = g["observable"]
            r, p = ref["table"][key], entry["port"][key]
            assert p["k"] == ref["k"]
            assert g["value"] == pytest.approx(tva.pool_z(
                r["ref_mean"], r["ref_sd"], ref["k"], p["mean"], p["sd"],
                p["k"]), abs=1e-12)
    if name == "transport_pooled":
        zs = entry["port"]["z"]
        assert len(zs) == 28
        for key, z in zs.items():
            r, p = ref["table"][key], entry["port"][key]
            assert z == pytest.approx(tva.pool_z(
                r["ref_mean"], r["ref_sd"], ref["k"], p["mean"], p["sd"],
                p["k"]), abs=1e-12)
        misses = [z for z in zs.values() if abs(z) >= 2]
        assert entry["gates"][0]["value"] == len(misses)
        assert entry["gates"][1]["value"] == max(abs(z) for z in zs.values())
    assert entry["ok"] == all(g["ok"] for g in entry["gates"])
    assert entry["launches"], "the step ran no kernel on the card"


def test_archive_misses_are_queue3_faults(archived):
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = f.read()
    for entry in archived["steps"]:
        for g in entry.get("gates", ()):
            if g["ok"]:
                assert "fault" not in g
                continue
            assert g["fault"] == tva.FAULTS[(entry["name"], g["name"])]
            item = g["fault"].rsplit(" ", 1)[-1]
            assert f"{item}. **Fault" in roadmap and entry["name"] in roadmap
