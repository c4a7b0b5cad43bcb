"""The port's examples (``examples/torch_*.py`` and ``examples/torch_*.sh``,
the counterparts of the JAX package's ``examples/``).

* Each example's ``main(device="cpu")`` runs at a tiny size through the
  same code the card runs and returns its table (one row per sweep
  point); its ``physics_misses`` flags a table that breaks the example's
  physics and passes one that keeps it.
* Every ``python -m mdqtplasmasims_torch.cli`` line of the three shell
  scripts parses through the port's parser (``cli.build_parser``), on
  ``--device cuda``, and ``torch_run_ensemble.sh``'s heredoc reads a tiny
  ensemble tree through the port's ``analysis``.
* The card's tables (``artifacts/examples_torch/summary.json``, skipped
  while absent) hold the physics each example's docstring claims, at the
  examples' full sizes.
"""

import json
import os
import re
import shlex
import subprocess
import sys

import numpy as np
import pytest
import torch

from mdqtplasmasims_torch import cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
sys.path.insert(0, EXAMPLES)

import torch_dark_state_sweep as dark  # noqa: E402
import torch_rabi_sweep as rabi  # noqa: E402
import torch_tag_class_sweep as tag  # noqa: E402

torch.set_num_threads(1)

SUMMARY = os.path.join(ROOT, "artifacts", "examples_torch", "summary.json")
_COOL = dict(n0=32, tmax=0.02, sample_freq=2)
TINY = {
    "dark_state_sweep": (dark, _COOL, len(dark.SWEEP)),
    "rabi_sweep": (rabi, _COOL, len(rabi.OM_DP)),
    "tag_class_sweep": (tag, dict(n0=32, tstart=0.02, tmax=0.16,
                                  sample_freq=4, tpump_seconds=5e-8),
                        len(tag.DETS)),
}
ROW_KEYS = {
    "dark_state_sweep": {"det_sp", "det_dp", "v_res", "v_dip", "depth",
                         "centers", "profile"},
    "rabi_sweep": {"om_dp", "s", "p", "d"},
    "tag_class_sweep": {"det", "vx", "vx_sd", "spin_up", "spin_up_sd", "n"},
}


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
@pytest.mark.parametrize("name", sorted(TINY))
def test_example_main_tiny_on_cpu(name, tmp_path):
    mod, over, n_rows = TINY[name]
    out = str(tmp_path / "tree") if name == "dark_state_sweep" else None
    table = mod.main(out, device="cpu", **over)
    assert len(table["rows"]) == n_rows
    for r in table["rows"]:
        assert ROW_KEYS[name] <= set(r), ROW_KEYS[name] - set(r)
    assert table["wall_s"] > 0 and table["config"] == dict(mod.CONFIG,
                                                          **over)
    assert isinstance(mod.physics_misses(table), list)
    if out is not None:
        assert os.listdir(out)             # the trees stay where asked


def _dark_row(v_res, v_dip):
    return dict(det_sp=-1.0, det_dp=1.0, v_res=v_res, v_dip=v_dip)


def test_physics_misses_flag_what_the_docstrings_exclude():
    assert dark.physics_misses({"rows": [_dark_row(1.43, 1.55)]}) == []
    assert dark.physics_misses({"rows": [_dark_row(1.43, 1.95)]})
    assert dark.physics_misses({"rows": [_dark_row(1.43, None)]})
    falling = [dict(om_dp=o, d=d) for o, d in zip(rabi.OM_DP,
                                                  (0.7, 0.5, 0.3, 0.2))]
    assert rabi.physics_misses({"rows": falling}) == []
    falling[2]["d"] = 0.6
    assert len(rabi.physics_misses({"rows": falling})) == 1
    good = [dict(det=d, vx=-0.2 * np.sign(d) if d else 0.05)
            for d in tag.DETS]
    assert tag.physics_misses({"rows": good}) == []
    good[0]["vx"], good[2]["vx"] = -0.01, 0.2
    assert len(tag.physics_misses({"rows": good})) == 2


def _cli_lines(script):
    """The ``python -m mdqtplasmasims_torch.cli`` command lines of a shell
    script, continuations joined, its ``VAR="${n:-default}"`` values
    substituted."""
    text = open(os.path.join(EXAMPLES, script)).read().replace("\\\n", " ")
    env = dict(re.findall(r'^(\w+)="\$\{\d+:-([^}]*)\}"', text, re.M))
    lines = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("python -m mdqtplasmasims_torch.cli"):
            for k, v in env.items():
                line = line.replace(f'"${k}"', v)
            lines.append(shlex.split(line)[3:])
    return lines


SCRIPTS = {"torch_reference_commands.sh": 10, "torch_run_ensemble.sh": 1,
           "torch_walltime_chaining.sh": 2}
CASES = [(s, i) for s, n in SCRIPTS.items() for i in range(n)]


def test_every_script_line_is_found():
    for script, n in SCRIPTS.items():
        assert len(_cli_lines(script)) == n, script
        text = open(os.path.join(EXAMPLES, script)).read()
        assert "mdqtplasmasims_tpu" not in text, script


@pytest.mark.parametrize("script,i", CASES, ids=[f"{s}-{i}" for s, i in CASES])
def test_script_line_parses_through_the_ports_parser(script, i):
    argv = _cli_lines(script)[i]
    ns = tcli.build_parser().parse_args(argv)
    assert ns.device == "cuda" and ns.cmd == argv[0]
    if not ns.cmd.startswith("cooling"):
        families = tcli._families()
        cfg = tcli._build_cfg(families[ns.cmd][1], ns)
        assert cfg.save_directory == ns.save_directory


def test_run_ensemble_heredoc_reads_the_ports_tree(tmp_path):
    """``torch_run_ensemble.sh``'s aggregation on a tiny ensemble tree
    written by the port's CLI on the CPU."""
    out = str(tmp_path / "dataLaserCool")
    assert tcli.main(["cooling-ensemble", "--jobs", "2", "--n0", "16",
                      "--tmax", "0.008", "--sample-freq", "2", "--device",
                      "cpu", "--save-directory", out]) == 0
    text = open(os.path.join(EXAMPLES, "torch_run_ensemble.sh")).read()
    code = text.split("<<PY\n")[1].split("\nPY\n")[0].replace("$OUT", out)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("2 jobs aggregated; T(t=")


# ---- the card's tables

@pytest.fixture(scope="module")
def summary():
    if not os.path.exists(SUMMARY):
        pytest.skip("no card tables; run examples/torch_*.py --summary on "
                    "the card")
    with open(SUMMARY) as f:
        return json.load(f)


def test_archived_tables_are_full_size_card_runs(summary):
    assert set(summary) == set(TINY)
    for name, (mod, _, n_rows) in TINY.items():
        t = summary[name]
        assert t["card"] != "cpu" and "," in t["card"], t["card"]
        assert t["config"] == mod.CONFIG and t["seed"] == mod.SEED
        assert len(t["rows"]) == n_rows and mod.physics_misses(t) == []


def test_archived_dark_state_dips_track_the_resonance(summary):
    """Every point: a local P dip within 0.45 gamma/k of v_res =
    |detDP - detSP|/(1 + kRat)."""
    from mdqtplasmasims_torch.units import K_RATIO_1033
    rows = summary["dark_state_sweep"]["rows"]
    assert [(r["det_sp"], r["det_dp"]) for r in rows] == [
        tuple(p) for p in dark.SWEEP]
    for r in rows:
        v_res = abs(r["det_dp"] - r["det_sp"]) / (1.0 + K_RATIO_1033)
        assert abs(r["v_res"] - v_res) < 1e-12
        prof = np.array([np.nan if x is None else x for x in r["profile"]])
        i = dark.nearest_local_dip(np.asarray(r["centers"]), prof, v_res)
        assert i is not None and abs(r["centers"][i] - v_res) <= 0.45, r
        assert prof[i] < prof[i - 1] and prof[i] < prof[i + 1]
        assert r["v_dip"] == r["centers"][i] and r["depth"] < 1.0


def test_archived_rabi_d_falls_with_om_dp(summary):
    rows = summary["rabi_sweep"]["rows"]
    assert [r["om_dp"] for r in rows] == rabi.OM_DP
    d_pop = np.array([r["d"] for r in rows])
    assert np.all(np.diff(d_pop) < 0), d_pop
    for r in rows:
        assert abs(r["s"] + r["p"] + r["d"] - 1.0) < 0.02, r


def test_archived_tag_class_antisymmetric(summary):
    """<vx> > 0 at det -2 and -1, < 0 at +1 and +2, |<vx>| < 0.12 (the
    JAX test's resonance bar) at 0."""
    vx = {r["det"]: r["vx"] for r in summary["tag_class_sweep"]["rows"]}
    assert sorted(vx) == tag.DETS
    assert vx[-2.0] > 0 and vx[-1.0] > 0, vx
    assert vx[1.0] < 0 and vx[2.0] < 0, vx
    assert abs(vx[0.0]) < 0.12, vx
