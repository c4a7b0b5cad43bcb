"""The port stands alone: it imports nothing of JAX or of the JAX package.

* A fresh interpreter whose import system refuses ``jax`` and
  ``mdqtplasmasims_tpu`` imports every module of ``mdqtplasmasims_torch``
  and ``chip_smoke``, then runs a tiny cooling ``run()`` and ensemble on
  the CPU.
* No source file of the port (nor chip_smoke.py) has an import statement
  naming either.
* The port's own copies of the level tables, the unit constants, the
  ``%g`` writer and the CLI helpers equal the JAX package's originals
  (exactly: they are copies).
"""

import dataclasses
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
import importlib.abc, pkgutil, sys, tempfile

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
    assert int(proc.stdout.split()[-1]) >= 20      # every module imported


def _sources():
    pkg = os.path.join(ROOT, "mdqtplasmasims_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
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
