"""The port's host tools against the JAX package's (CPU): ``analysis``,
``quicklook``, the CLI's ``analyze`` and ``plot``, and ``profiling``.

The trees are the port's own, written on the CPU at the sizes the
families' port tests use: a cooling run with VAF intervals and the LCCF
stream (10 samples, enough for the dispersion), a 2-job cooling parameter
directory, a frozen-start tagging job, a transport job and an MC-tagging
job.  Both packages read the same directory.  Both are numpy on the host,
so the reports are expected equal; floats are held to 1e-12 relative.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu import analysis as ja
from mdqtplasmasims_tpu import cli as jcli
from mdqtplasmasims_tpu import profiling as jprof
from mdqtplasmasims_tpu import quicklook as jq
from mdqtplasmasims_torch import analysis as ta
from mdqtplasmasims_torch import cli as tcli
from mdqtplasmasims_torch import profiling as tprof
from mdqtplasmasims_torch import quicklook as tq
from mdqtplasmasims_torch.experiments import (frozen_tagging,
                                              mc_md_anisotropy,
                                              mc_qt_tagging)
from mdqtplasmasims_torch.experiments import laser_cooling as tlc

torch.set_num_threads(1)

FAMILIES = ("cooling", "ensemble", "frozen_tag", "transport", "mc_tag")


def _job(root):
    return sorted(os.path.dirname(p) for p in glob.glob(
        os.path.join(root, "**", "energies.dat"), recursive=True)
        + glob.glob(os.path.join(root, "**", "VAF.dat"), recursive=True))[0]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    out = {}
    tlc.run(tlc.CoolingConfig(n0=64, tmax=0.04, sample_freq=2,
                              vaf_intervals=(0.001, 0.02), record_lccf=True,
                              save_directory=str(root / "cooling")),
            device="cpu")
    out["cooling"] = _job(str(root / "cooling"))
    tlc.run_ensemble(tlc.CoolingConfig(n0=64, tmax=0.01, sample_freq=2,
                                       save_directory=str(root / "ensemble")),
                     2, device="cpu")
    out["ensemble"] = os.path.dirname(_job(str(root / "ensemble")))
    frozen_tagging.run(frozen_tagging.FrozenTagConfig(
        n0=16, tstart=0.02, tmax=0.1, sample_freq=4, tpump_seconds=5e-8,
        exact_n=False, save_directory=str(root / "frozen_tag")),
        device="cpu")
    out["frozen_tag"] = _job(str(root / "frozen_tag"))
    mc_md_anisotropy.run(mc_md_anisotropy.MCTransportConfig(
        n=8, mc_steps=40, gr_every_mc=20, pre_record_md_steps=2,
        record_steps=4, gr_every_record=2, instant_aniso_steps=2,
        reequil_steps=2, aniso_relax_steps=2, aniso_time_us=0.05,
        save_directory=str(root / "transport")), device="cpu")
    out["transport"] = _job(str(root / "transport"))
    mc_qt_tagging.run(mc_qt_tagging.MCTagConfig(
        variant="422linear", n=8, mc_steps=40, mc_chunk_steps=20,
        pre_record_md_steps=2, record_steps=4, gr_every_record=2,
        tpump_seconds=1e-8, save_directory=str(root / "mc_tag")),
        device="cpu")
    out["mc_tag"] = _job(str(root / "mc_tag"))
    return out


def assert_same(a, b, path="report"):
    """Equal structures; floats to 1e-12 relative."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), path
        for k in b:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=path)
    elif isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12, abs=0) or (
            np.isnan(a) and np.isnan(b)), path
    else:
        assert a == b, path


@pytest.mark.parametrize("family", FAMILIES)
def test_analyze_reports_equal(trees, family):
    d = trees[family]
    if family == "ensemble":
        rt, rj = ta.analyze_ensemble(d), ja.analyze_ensemble(d)
        assert len(rt["jobs"]) == 2
        assert ta.format_ensemble_report(rt) == ja.format_ensemble_report(rj)
    else:
        kw = dict(max_shell=6)
        rt, rj = ta.analyze_job(d, **kw), ja.analyze_job(d, **kw)
        assert ta.format_job_report(rt) == ja.format_job_report(rj)
    assert_same(rt, rj)
    assert_same(json.loads(json.dumps(rt)), json.loads(json.dumps(rj)))


def test_cooling_report_sections(trees):
    rep = ta.analyze_job(trees["cooling"], max_shell=6)
    assert {"energies", "diffusion", "dispersion", "structure"} <= set(rep)
    assert rep["diffusion"]["d"] > 0 and not rep["notes"]


class _Member:
    """A run_sweep member config stand-in: the swept fields only."""

    def __init__(self, detuning, om):
        self.detuning, self.om = detuning, om


def _case(name, trees, rng):
    """(args, kwargs) for one public function of analysis.py."""
    ens, cool = trees["ensemble"], trees["cooling"]
    if name == "job_dirs":
        return (ens,), {}
    if name == "average_dat":
        return (ens, "energies.dat"), {}
    if name == "stack_dat":
        return (ens, "statePopulationsVsVTime000001.dat"), {}
    if name in ("ensemble_energies", "ensemble_temperature_curve"):
        return (ens,), {}
    if name == "two_sample_z":
        return (rng.normal(size=9), rng.normal(0.3, 1.2, size=12)), {}
    if name == "two_sample_z_columns":
        return (rng.normal(size=(9, 5)), rng.normal(0.2, 1.1, (7, 5))), {}
    if name == "weighted_pooled_mean":
        return (rng.normal(size=8), rng.integers(1, 50, 8)), {}
    if name == "compare_job_pools":
        keys = ("d", "s_peak")
        refs = [{k: float(rng.normal()) for k in keys} for _ in range(6)]
        fws = [{k: float(rng.normal(0.1)) for k in keys} for _ in range(5)]
        return (refs, fws, keys), {"z_max": 2.5}
    if name == "sweep_table":
        cfgs = [_Member(d, o) for d in (-1.0, -0.5) for o in (0.8, 1.2)
                for _ in range(3)]
        return (cfgs, rng.normal(size=len(cfgs)), ("detuning", "om")), {}
    if name == "state_population_profile":
        return (cool,), {"vmax": 0.5, "nbins": 6, "min_count": 3}
    if name == "lccf_spectrum":
        return (cool,), {"max_shell": 8, "skip": 1}
    if name == "green_kubo_diffusion":
        t = np.arange(40) * 0.02
        vaf = np.exp(-t / 0.3) * np.cos(3 * t) + 0.01 * rng.normal(size=40)
        segs = np.concatenate([np.stack([t, vaf], -1),
                               np.stack([t + 0.5, vaf * 0.9], -1)])
        return (segs,), {"plateau_frac": 0.3}
    if name == "structure_factor_shells":
        return (rng.uniform(0, 5.0, (40, 3)), 5.0), {"lambda_frac": 5,
                                                     "max_shell": 9}
    if name == "structure_factor_from_checkpoint":
        return (cool,), {"max_shell": 6}
    raise KeyError(name)


PUBLIC = ["job_dirs", "average_dat", "stack_dat", "ensemble_energies",
          "ensemble_temperature_curve", "two_sample_z",
          "two_sample_z_columns", "weighted_pooled_mean",
          "compare_job_pools", "sweep_table", "state_population_profile",
          "lccf_spectrum", "green_kubo_diffusion",
          "structure_factor_shells", "structure_factor_from_checkpoint"]


def test_every_public_function_is_covered():
    names = {n for n, v in vars(ja).items()
             if callable(v) and not n.startswith("_")
             and getattr(v, "__module__", "") == ja.__name__}
    assert names == set(PUBLIC) | {"analyze_job", "format_job_report",
                                   "analyze_ensemble",
                                   "format_ensemble_report"}
    assert all(callable(getattr(ta, n)) for n in names)


@pytest.mark.parametrize("name", PUBLIC)
def test_public_function_equal(trees, name, capsys):
    args, kw = _case(name, trees, np.random.default_rng(len(name)))
    got = getattr(ta, name)(*args, **kw)
    printed = capsys.readouterr().out
    want = getattr(ja, name)(*args, **kw)
    assert capsys.readouterr().out == printed
    assert_same(got, want)


@pytest.mark.parametrize("family", FAMILIES)
def test_quicklook_panels_equal(trees, family):
    d = trees[family]
    if family == "ensemble":
        d = os.path.join(d, "job1")
    titles = [t for t, _ in tq.collect_panels(d)]
    assert titles and titles == [t for t, _ in jq.collect_panels(d)]
    for fn in ("_latest", "_earliest"):
        assert (getattr(tq, fn)(d, "*.dat") == getattr(jq, fn)(d, "*.dat"))


def test_render_writes_png(trees, tmp_path):
    pytest.importorskip("matplotlib")
    out = tq.render(trees["cooling"], str(tmp_path / "q.png"))
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("family", ["cooling", "ensemble", "transport"])
@pytest.mark.parametrize("as_json", [True, False], ids=["json", "text"])
def test_cli_analyze_prints_what_jax_prints(trees, family, as_json, capsys):
    argv = ["analyze", trees[family], "--max-shell", "5"] + (
        ["--json"] if as_json else [])
    assert tcli.main(argv) == 0
    got = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert got == capsys.readouterr().out and got


def test_cli_plot(trees, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "plot.png")
    assert tcli.main(["plot", trees["transport"], "-o", out]) == 0
    assert capsys.readouterr().out.strip() == out and os.path.exists(out)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit) as e:
        tcli.main(["plot", str(empty)])
    assert e.value.code == 2
    assert "no recognized .dat observables" in capsys.readouterr().err


def test_cli_analyze_empty_dir_errors(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["analyze", str(tmp_path)])
    assert e.value.code == 2
    assert "no recognized .dat output" in capsys.readouterr().err


@pytest.mark.parametrize("args", [(3500, 375000, 15.2), (64, 0, 0.5)])
def test_throughput_equal(args):
    assert tprof.throughput(*args) == jprof.throughput(*args)


def test_phase_timer_counts_and_reports():
    t = tprof.PhaseTimer()
    x = torch.ones(3)
    for _ in range(3):
        with t.phase("step", block_on={"x": x, "pair": (x, 1)}):
            x = x + 1
    with t.phase("write"):
        pass
    assert t.counts == {"step": 3, "write": 1}
    assert all(v >= 0 for v in t.phases.values())
    rep = t.report().splitlines()
    assert len(rep) == 2 and rep[0].startswith("step") and "x3" in rep[0]
    assert json.loads(t.as_json())["counts"] == t.counts


def test_device_trace_cpu_writes_a_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "tr"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "tr" / "trace.json"
    assert path.exists() and "traceEvents" in json.loads(path.read_text())
    assert any("mm" in e.key for e in prof.key_averages())


def test_device_trace_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with tprof.device_trace(str(tmp_path), device="cuda"):
            pass
    assert not os.listdir(tmp_path)
