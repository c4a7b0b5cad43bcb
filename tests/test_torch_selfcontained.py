"""The port stands alone: it imports nothing of JAX or of the JAX package.

* A fresh interpreter whose import system refuses ``jax`` and
  ``mdqtplasmasims_tpu`` imports every module of ``mdqtplasmasims_torch``
  and ``chip_smoke``, then runs a tiny ``run()`` and fold of every ported
  family (cooling, three-state, frozen-start tagging, transport,
  MC-tagging) on the CPU, and the host tools: a tree written through the
  ``%g`` codec, ``analyze_job``, ``collect_panels`` (without matplotlib),
  ``PhaseTimer`` and the ``pre_speedup`` preset's ``run``, two
  families of the production soak (``tools/torch_soak.py``), a tiny
  99-job campaign (``tools/torch_campaign99.py``) and the analysis layer's
  tools (``tools/torch_validate_analysis.py``: trajectories, sections A,
  C, D and E; ``tools/torch_lccf_dispersion.py``), the physics targets
  (``tools/torch_physics_targets.py``) and the examples
  (``examples/torch_*.py``) at a tiny size.
* No source file of the port (nor chip_smoke.py, the port's tools,
  tools/torch_*.py, or its examples, examples/torch_*.py) has an import
  statement naming either.
* The port's own copies of the level tables, the unit constants, the
  ``%g`` writer, the directory encoders, the CLI helpers, the families'
  config defaults, the preset table and the report formats equal the JAX
  package's originals (exactly: they are copies).
"""

import dataclasses
import glob
import os
import re
import subprocess
import sys
import typing
from typing import Optional

import numpy as np
import pytest

from mdqtplasmasims_tpu import cli as jcli
from mdqtplasmasims_tpu import levels as jlevels
from mdqtplasmasims_tpu import units as junits
from mdqtplasmasims_tpu.io import datfiles as jdat
from mdqtplasmasims_tpu.io import dirs as jdirs
from mdqtplasmasims_torch import cli as tcli
from mdqtplasmasims_torch import levels as tlevels
from mdqtplasmasims_torch import units as tunits
from mdqtplasmasims_torch.io import datfiles as tdat
from mdqtplasmasims_torch.io import dirs as tdirs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFUSING_RUN = r'''
import glob, importlib.abc, os, pkgutil, sys, tempfile

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mdqtplasmasims_tpu"):
            raise ModuleNotFoundError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import mdqtplasmasims_torch
names = [m.name for m in pkgutil.walk_packages(mdqtplasmasims_torch.__path__,
                                               "mdqtplasmasims_torch.")]
for name in names:
    __import__(name)
import chip_smoke
from mdqtplasmasims_torch.experiments.laser_cooling import (
    CoolingConfig, run, run_ensemble)
with tempfile.TemporaryDirectory() as tmp:
    cfg = CoolingConfig(n0=32, tmax=0.008, sample_freq=2,
                        save_directory=tmp)
    final, res = run(cfg, device="cpu")
    assert res["outs"]["t"].shape == (2,)
    run_ensemble(cfg, 2, device="cpu")
# every module the tagging families added is among ``names``; drive them too
new = {"core.tagging", "ops.correlations", "experiments.three_state",
       "experiments.frozen_tagging"}
assert {"mdqtplasmasims_torch." + m for m in new} <= set(names), names
from mdqtplasmasims_torch.experiments import frozen_tagging, three_state
from mdqtplasmasims_torch.ops.correlations import autocorr_suite
from mdqtplasmasims_torch.core.tagging import tag_classical
from mdqtplasmasims_torch.cli import main
import torch
with tempfile.TemporaryDirectory() as tmp:
    toy = three_state.ThreeStateConfig(n0=16, tmax=1.0, sample_freq=50,
                                       save_directory=tmp)
    assert three_state.run(toy, device="cpu")["ekin_x"].shape == (2,)
    three_state.run_sweep(toy, [{"detuning": -1.0}, {"om": 1.0}],
                          device="cpu")
    tag = frozen_tagging.FrozenTagConfig(
        n0=16, tstart=0.02, tmax=0.1, sample_freq=4, tpump_seconds=5e-8,
        exact_n=False, save_directory=tmp)
    final, res = frozen_tagging.run(tag, device="cpu")
    assert res["outs"]["t"].shape == (3,)
    frozen_tagging.run_ensemble(tag, 2, device="cpu")
    frozen_tagging.run_sweep(tag, [{"detuning": -2.0}], jobs_per_point=2,
                             device="cpu")
    assert main(["frozen-tag", "--n0", "16", "--tstart", "0.02", "--tmax",
                 "0.12", "--sample-freq", "4", "--tpump-seconds", "5e-8",
                 "--exact-n", "false", "--resume", "--device", "cpu",
                 "--save-directory", tmp]) == 0
assert len(autocorr_suite(torch.randn(8, 5, 3))) == 4
# the Monte-Carlo families' modules are among ``names``; drive them too
new = {"core.mc", "core.thermostat", "core.draws", "core.pipeline",
       "experiments.mc_md_anisotropy", "experiments.mc_qt_tagging"}
assert {"mdqtplasmasims_torch." + m for m in new} <= set(names), names
from mdqtplasmasims_torch.experiments import mc_md_anisotropy, mc_qt_tagging
with tempfile.TemporaryDirectory() as tmp:
    tr = mc_md_anisotropy.MCTransportConfig(
        n=8, mc_steps=40, gr_every_mc=20, pre_record_md_steps=2,
        record_steps=4, gr_every_record=2, instant_aniso_steps=2,
        reequil_steps=2, aniso_relax_steps=2, aniso_time_us=0.05,
        save_directory=tmp)
    assert mc_md_anisotropy.run(tr, device="cpu")["vaf"].shape == (4,)
    mc_md_anisotropy.run_sweep(tr, [{"kappa": 1.0}, {"gamma": 2.0}],
                               device="cpu")
    tg = mc_qt_tagging.MCTagConfig(
        variant="422linear", n=8, mc_steps=40, mc_chunk_steps=20,
        pre_record_md_steps=2, record_steps=4, gr_every_record=2,
        tpump_seconds=1e-8, checkpoint_every_chunks=1, save_directory=tmp)
    assert mc_qt_tagging.run(tg, device="cpu")["tags"].shape == (8,)
    assert mc_qt_tagging.run(tg, device="cpu", resume=True)["vaf"].shape \
        == (4,)
    mc_qt_tagging.run_ensemble(tg, 2, device="cpu")
assert len(tag_classical(torch.randn(9), torch.Generator().manual_seed(0),
                         2.0)) == 4
# the host tools, the presets and the codec are among ``names``; drive them
new = {"experiments.presets", "analysis", "quicklook", "profiling"}
assert {"mdqtplasmasims_torch." + m for m in new} <= set(names), names
import numpy as np
from mdqtplasmasims_torch import analysis, profiling, quicklook
from mdqtplasmasims_torch.experiments import presets
from mdqtplasmasims_torch.io.datfiles import (DatWriter, format_rows,
                                              format_rows_py)
arr = np.array([[1234565.0, -0.0, np.nan], [5e-324, 1e-05, -np.inf]])
assert format_rows(arr) == format_rows_py(arr)
timer = profiling.PhaseTimer()
with tempfile.TemporaryDirectory() as tmp:
    DatWriter(tmp).write("VAF.dat", np.stack([np.arange(8) * 0.1,
                                              np.exp(-np.arange(8.0))], -1))
    rep = analysis.analyze_job(tmp)
    assert rep["diffusion"]["d"] > 0, rep
    assert [t for t, _ in quicklook.collect_panels(tmp)] == [
        "Velocity autocorrelation"]
    assert "matplotlib" not in sys.modules
    cfg = presets.pre_speedup(n0=16, tmax=0.008, sample_freq=2,
                              vaf_intervals=(0.001,), save_directory=tmp)
    with timer.phase("pre_speedup", block_on=torch.ones(1)):
        final, res = run(cfg, device="cpu")
    assert res["outs"]["J"].shape[:2] == (2, 3)
    job = analysis.job_dirs(os.path.dirname(glob.glob(
        os.path.join(tmp, "*", "job1"))[0]))[0]
    assert {"energies", "structure"} <= set(analysis.analyze_job(job))
    assert main(["analyze", job, "--json"]) == 0
assert timer.counts == {"pre_speedup": 1}
# the port's production soak (tools/torch_soak.py) at a tiny size
sys.path.insert(0, os.path.join(os.getcwd(), "tools"))
import torch_soak
with tempfile.TemporaryDirectory() as tmp:
    m = torch_soak.soak_cooling(tmp, device="cpu", n0=16, tmax=0.008,
                                sample_freq=2)
    assert {"dih_peak_t", "pop_s", "wall_s"} <= set(m), m
    m = torch_soak.soak_transport(
        tmp, device="cpu", n=8, mc_steps=40, gr_every_mc=20,
        pre_record_md_steps=2, record_steps=4, gr_every_record=2,
        instant_aniso_steps=2, reequil_steps=2, aniso_relax_steps=2,
        aniso_time_us=0.05)
    assert "aniso_spread_relaxed" in m, m
# the port's 99-job campaign (tools/torch_campaign99.py) at a tiny size
import torch_campaign99
m = torch_campaign99.campaign(device="cpu", n_jobs=2, n0=16, tmax=0.008,
                              sample_freq=2)
assert m["n_jobs"] == 2 and "job_spread_t30" in m, m
assert torch_campaign99.campaign_line(m).startswith("2-job campaign: ")
# the analysis layer's tools (tools/torch_validate_analysis.py,
# tools/torch_lccf_dispersion.py) at a tiny size
import torch_lccf_dispersion
import torch_validate_analysis as tva
with tempfile.TemporaryDirectory() as tmp:
    args = tva.parse_args(["--sections", "ACD", "--record-steps", "80",
                           "--work-dir", tmp, "--device", "cpu"])
    trajs = {k: tva.md_trajectory(64, *k[:2], seed=k[2], mc_steps=200,
                                  equil_steps=5, device="cpu",
                                  dtype=torch.float64,
                                  record_steps=kw["record_steps"])
             for k, kw in tva.trajectory_plan(args).items()}
    rep = tva.analyze(trajs, args)
    assert set(rep) == {"A_gk_vs_msd", "C_sk_gofr", "D_dispersion",
                        "section_walls_s"}, rep
    e = tva.section_e(args, "cpu", "float64", n=8, mc_steps=40,
                      gr_every_mc=20, pre_record_md_steps=2, record_steps=8,
                      gr_every_record=4, instant_aniso_steps=2,
                      reequil_steps=2, aniso_relax_steps=2,
                      aniso_time_us=0.05)
    assert e["k"] == 16 and e["dtype"] == "float64", e
    assert torch_lccf_dispersion.main([
        "--n0", "16", "--tmax", "0.04", "--sample-freq", "2",
        "--skip-time", "0.004", "--device", "cpu", "--out", tmp]) == 0
# the physics targets (tools/torch_physics_targets.py) and the examples
# (examples/torch_*.py) at a tiny size
import torch_physics_targets as tpt
import torch_dip_seed_scan
assert tpt.eit_populations("cpu", ntraj=2, ticks=4, chunk=4)["v_fixed"]
assert tpt.dih_curve(256, 3, device="cpu").shape == (3,)
sys.path.insert(0, os.path.join(os.getcwd(), "examples"))
import torch_dark_state_sweep, torch_rabi_sweep, torch_tag_class_sweep
with tempfile.TemporaryDirectory() as tmp:
    for mod, over in ((torch_dark_state_sweep, {}), (torch_rabi_sweep, {})):
        table = mod.main(tmp, device="cpu", n0=16, tmax=0.008,
                         sample_freq=2, **over)
        assert len(table["rows"]) >= 3, table
    table = torch_tag_class_sweep.main(device="cpu", n0=16, tstart=0.02,
                                       tmax=0.16, sample_freq=4,
                                       tpump_seconds=5e-8)
    assert len(table["rows"]) == 5, table
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mdqtplasmasims_tpu"))
assert not bad, bad
print("modules", len(names))
'''


def test_port_runs_with_jax_refused():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _REFUSING_RUN], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 28      # every module imported


def _sources():
    pkg = os.path.join(ROOT, "mdqtplasmasims_torch")
    tools = glob.glob(os.path.join(ROOT, "tools", "torch_*.py"))
    assert {os.path.basename(p) for p in tools} >= {
        "torch_soak.py", "torch_campaign99.py", "torch_validate_analysis.py",
        "torch_lccf_dispersion.py", "torch_physics_targets.py",
        "torch_dip_seed_scan.py"}
    examples = glob.glob(os.path.join(ROOT, "examples", "torch_*.py"))
    assert {os.path.basename(p) for p in examples} == {
        "torch_dark_state_sweep.py", "torch_rabi_sweep.py",
        "torch_tag_class_sweep.py"}
    out = [os.path.join(ROOT, "chip_smoke.py"), *tools, *examples]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_import_statement_names_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(from|import) (mdqtplasmasims_tpu|jax)\b")
    hits = [f"{os.path.relpath(p, ROOT)}:{i}: {line.rstrip()}"
            for p in _sources()
            for i, line in enumerate(open(p), 1) if pat.match(line)]
    assert not hits, "\n".join(hits)


@pytest.mark.parametrize("name", sorted(
    k for k, v in vars(junits).items()
    if k.isupper() and isinstance(v, (int, float))))
def test_unit_constants_equal(name):
    assert getattr(tunits, name) == getattr(junits, name)


@pytest.mark.parametrize("density", [0.5, 2.0, 3.7])
def test_unit_conversions_equal(density):
    pa, pb = junits.PlasmaUnits(density, 0.1), tunits.PlasmaUnits(density,
                                                                  0.1)
    assert (pa.kappa, pa.debye_length) == (pb.kappa, pb.debye_length)
    assert (junits.PlasmaUnits.box_length(3500)
            == tunits.PlasmaUnits.box_length(3500))
    for f in ("qt_units_408", "qt_units_422"):
        qa, qb = getattr(junits, f)(density), getattr(tunits, f)(density)
        assert (qa.gamma_to_einstein, qa.plas_to_quant_vel,
                qa.ratio_cooling(), qa.ratio_frozen(),
                qa.ratio_mc_tagging()) == (
            qb.gamma_to_einstein, qb.plas_to_quant_vel, qb.ratio_cooling(),
            qb.ratio_frozen(), qb.ratio_mc_tagging())
    assert (junits.pump_window_einstein(2e-6, density)
            == tunits.pump_window_einstein(2e-6, density))
    assert (junits.expansion_detuning(3.0, density, 4.0, 19.0, 0.5)
            == tunits.expansion_detuning(3.0, density, 4.0, 19.0, 0.5))


_SCHEMES = {
    "sr12 speedup": lambda m: m.sr12_cooling(-1.0, 1.0, 1.0, 1.0),
    "sr12 pre_speedup": lambda m: m.sr12_cooling(
        -0.7, 0.6, 1.3, 0.8, gs_convention="pre_speedup"),
    "sr12 with recoil": lambda m: m.with_recoil(
        m.sr12_cooling(-1.0, 1.0, 0.0, 1.0), 0.01, 0.004),
    "tag408 linear": lambda m: m.tag408(-0.5, 0.7, True),
    "tag408 quad": lambda m: m.tag408(-0.5, 0.7, False),
    "tag422": lambda m: m.tag422(),
    "three_state": lambda m: m.three_state(),
}


@pytest.mark.parametrize("which", sorted(_SCHEMES))
def test_level_tables_equal(which):
    a, b = _SCHEMES[which](jlevels), _SCHEMES[which](tlevels)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


def test_dat_format_bytes_equal():
    rng = np.random.default_rng(0)
    for arr in (rng.normal(size=(7, 4)) * 10.0 ** rng.integers(-9, 9, (7, 4)),
                rng.normal(size=5), np.array([0.0, -0.0, 1e300, 3.0])):
        assert tdat.format_rows(arr) == jdat.format_rows(arr)


def test_cooling_dir_equal():
    kw = dict(ge=0.1, density=2.0, sig0=4.0, te=19.0, frac_of_sig=0.5,
              detuning=-1.0, detuning_dp=1.0, om=1.0, om_dp=1.0, n0=3500,
              job=3)
    assert tdirs.cooling_dir("base", **kw) == jdirs.cooling_dir("base", **kw)


@dataclasses.dataclass(frozen=True)
class _Toy:
    n0: int = 3500
    tmax: float = 30.0
    renormalize: bool = False
    vaf_intervals: tuple = ()
    save_directory: Optional[str] = None
    frozen: typing.Any = None


@pytest.mark.parametrize("argv", [
    [], ["--n0", "64", "--tmax", "0.5", "--renormalize", "yes"],
    ["--vaf-intervals", "3,5.5", "--save-directory", "d"]])
def test_cli_helpers_equal(argv):
    import argparse
    cfgs = []
    for mod in (jcli, tcli):
        p = argparse.ArgumentParser()
        mod._add_dataclass_args(p, _Toy)
        cfgs.append(mod._build_cfg(_Toy, p.parse_args(argv)))
    assert cfgs[0] == cfgs[1]
    grids = {"detuning": [-1.0, -0.5], "om": [0.8, 1.2, 1.4]}
    for cross in (True, False):
        if not cross:
            grids = {"detuning": [-1.0, -0.5], "om": [0.8]}
        assert tcli._sweep_points(None, dict(grids), cross) == \
            jcli._sweep_points(None, dict(grids), cross)


def test_mc_family_dirs_equal():
    kw = dict(gamma=3.0, kappa=0.5, n=4096, job=2)
    assert (tdirs.mc_transport_dir("base", **kw)
            == jdirs.mc_transport_dir("base", **kw))
    kw = dict(gamma=3.0, kappa=0.5, n=4096, tpump_seconds=5e-8,
              detuning=-1.0, om=1.3, density=2.0, job=1,
              date_stamp="Date101626")
    assert tdirs.mc_tag_dir("base", **kw) == jdirs.mc_tag_dir("base", **kw)


def test_three_state_and_frozen_tag_dirs_equal():
    kw = dict(om=0.5, detuning=-0.5, n0=1000, temperature_k=0.01, job=2)
    assert (tdirs.three_state_dir("base", **kw)
            == jdirs.three_state_dir("base", **kw))
    kw = dict(tpump_seconds=1e-7, tstart=15.0, detuning=-1.0, om=1.3,
              density=2.0, ge=0.1, n0=3500, job=4)
    assert (tdirs.frozen_tag_dir("base", **kw)
            == jdirs.frozen_tag_dir("base", **kw))


@pytest.mark.parametrize("family", ["three_state", "frozen_tagging",
                                    "mc_md_anisotropy", "mc_qt_tagging"])
def test_family_config_defaults_equal(family):
    """The families' config dataclasses are copies: the same fields in the
    same order with the same defaults (so the CLIs generate the same
    flags), and the same derived scalars."""
    import importlib
    j = importlib.import_module(f"mdqtplasmasims_tpu.experiments.{family}")
    t = importlib.import_module(f"mdqtplasmasims_torch.experiments.{family}")
    name = {"three_state": "ThreeStateConfig",
            "frozen_tagging": "FrozenTagConfig",
            "mc_md_anisotropy": "MCTransportConfig",
            "mc_qt_tagging": "MCTagConfig"}[family]
    fj = [(f.name, f.default) for f in dataclasses.fields(getattr(j, name))]
    ft = [(f.name, f.default) for f in dataclasses.fields(getattr(t, name))]
    assert fj == ft
    if family == "frozen_tagging":
        assert t.VARIANTS == j.VARIANTS
        assert t.FROZEN_VARIANT_DEFAULTS == j.FROZEN_VARIANT_DEFAULTS
    elif family == "mc_md_anisotropy":
        cj, ct = j.MCTransportConfig(), t.MCTransportConfig()
        assert (cj.aniso_establish_steps, cj.L, cj.ldeb) == (
            ct.aniso_establish_steps, ct.L, ct.ldeb)
    elif family == "mc_qt_tagging":
        assert t.VARIANT_DEFAULTS == j.VARIANT_DEFAULTS
        for v in t.VARIANT_DEFAULTS:
            cj, ct = j.MCTagConfig(variant=v), t.MCTagConfig(variant=v)
            assert (cj.ratio, cj.qdt, cj.pump_md_steps, cj.n_states, cj.L,
                    cj.tpump_seconds, cj.detuning, cj.om) == (
                ct.ratio, ct.qdt, ct.pump_md_steps, ct.n_states, ct.L,
                ct.tpump_seconds, ct.detuning, ct.om)
            for f in ("coupling", "decay_w", "e0", "e1"):
                np.testing.assert_array_equal(getattr(cj.scheme(), f),
                                              getattr(ct.scheme(), f))
    else:
        assert t.doppler_limit_ekin(-0.5) == j.doppler_limit_ekin(-0.5)
        cj, ct = j.ThreeStateConfig(), t.ThreeStateConfig()
        sj, st = j.build_engine(cj), t.build_engine(ct)
        assert (sj.h, sj.dt_plasma, sj.apply_force) == (st.h, st.dt_plasma,
                                                        st.apply_force)
        np.testing.assert_array_equal(sj.scheme.coupling, st.scheme.coupling)


def test_preset_table_equal():
    from mdqtplasmasims_tpu.experiments import presets as jp
    from mdqtplasmasims_torch.experiments import presets as tp
    assert list(tp.PRESETS) == list(jp.PRESETS)
    for name in jp.PRESETS:
        a, b = jp.PRESETS[name](), tp.PRESETS[name]()
        for f in dataclasses.fields(b):
            assert getattr(b, f.name) == getattr(a, f.name), (name, f.name)


_REPORT = {
    "job_dir": "d/job1", "notes": ["dispersion skipped: too few"],
    "energies": {"n_samples": 3, "t_first": 0.0, "t_last": 1.5,
                 "ekin_final": [0.1, 0.2, 0.3], "audit_final": -0.25,
                 "audit_max_abs": 0.5},
    "temperature": {"t_final": [1.0, 2.0, 3.5], "anisotropy_final": 0.25,
                    "n_samples": 3},
    "diffusion": {"d": 0.0123, "drift": 0.04, "n_segments": 3,
                  "vaf0": 1.5, "source": "VAF.dat"},
    "dispersion": {"k_int2": [1, 2], "omega_peak": [1.25, 1.5],
                   "omega_peak_t": [0.0, 0.75], "d_omega": 0.125},
    "structure": {"s_peak": 2.5, "k_peak": 6.75, "checkpoint": 99},
    "gofr": {"peak_g": 1.5, "peak_r": 1.75, "source": "g.dat"},
    "tagged": {"n_samples": 2, "first": [0.5, 1.0], "final": [0.25, 0.5]}}


def test_report_formats_equal():
    from mdqtplasmasims_tpu import analysis as ja
    from mdqtplasmasims_torch import analysis as ta
    assert ta.format_job_report(_REPORT) == ja.format_job_report(_REPORT)
    ens = {"param_dir": "d", "jobs": [_REPORT, {"job_dir": "d/job2",
                                                "notes": ["skipped: x"]}],
           "pooled": {"diffusion.d": {"mean": 0.5, "sd": 0.25, "n": 2}}}
    assert (ta.format_ensemble_report(ens)
            == ja.format_ensemble_report(ens))
