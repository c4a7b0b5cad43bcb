"""``tools/torch_lccf_dispersion.py`` against ``tools/lccf_dispersion.py``
(CPU).

* The port's tool runs a laser-free flagship on the CPU (N0=64, tmax=0.1:
  50 MD steps, 25 J(k) samples) and writes its ``dispersion.json``; the
  JAX tool's ``main`` runs on a copy of that tree (its
  ``laser_cooling.run`` monkeypatched to copy it, the same ``sys.argv``):
  every row of the two ``dispersion.json`` files agrees to 1e-12, and
  ``kappa`` and ``d_omega`` too.  The port's tree itself is held to the
  JAX package's by tests/test_torch_intervals.py.
* The configuration is the JAX tool's: lasers off, ``record_lccf``, seed
  1; the tool refuses to start without a card unless asked for the CPU.
* The card's record, ``artifacts/lccf_torch/dispersion.json`` (skipped
  until it exists): the JAX tool's keys, an NVIDIA card and its power
  limit, and the lowest four shells' ratio in section D's band.
"""

import json
import os
import shutil
import sys

import pytest
import torch

from mdqtplasmasims_tpu.experiments import laser_cooling as jlc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import lccf_dispersion as jld  # noqa: E402
import torch_lccf_dispersion as tld  # noqa: E402

torch.set_num_threads(1)

ARCHIVE = os.path.join(ROOT, "artifacts", "lccf_torch", "dispersion.json")
ARGV = ["--n0", "64", "--tmax", "0.1", "--sample-freq", "2",
        "--skip-time", "0.008", "--max-shell", "20"]
JAX_KEYS = {"n0", "tmax", "kappa", "d_omega", "wall_s", "rows"}
ROW_KEYS = {"n2", "k", "omega_peak", "omega_theory", "ratio",
            "omega_peak_t"}


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port"))
    assert tld.main(ARGV + ["--device", "cpu", "--out", out]) == 0
    with open(os.path.join(out, "dispersion.json")) as f:
        return out, json.load(f)


def test_dispersion_rows_match_jax_tool(port_run, tmp_path, monkeypatch):
    out, got = port_run
    jout = str(tmp_path / "jax")

    def copy_tree(cfg, seed=None):
        assert seed == tld.SEED and cfg.save_directory == jout
        for name in os.listdir(out):
            if name != "dispersion.json":
                shutil.copytree(os.path.join(out, name),
                                os.path.join(jout, name))

    monkeypatch.setattr(jlc, "run", copy_tree)
    monkeypatch.setattr(sys, "argv", ["lccf_dispersion.py", *ARGV,
                                      "--out", jout])
    jld.main()
    with open(os.path.join(jout, "dispersion.json")) as f:
        ref = json.load(f)
    assert JAX_KEYS <= set(got) and set(ref) == JAX_KEYS
    assert (got["n0"], got["tmax"]) == (ref["n0"], ref["tmax"])
    for k in ("kappa", "d_omega"):
        assert got[k] == pytest.approx(ref[k], rel=1e-12, abs=0)
    assert len(got["rows"]) == len(ref["rows"]) > 4
    for a, b in zip(got["rows"], ref["rows"]):
        assert set(a) == set(b) == ROW_KEYS
        assert a["n2"] == b["n2"]
        for k in ROW_KEYS - {"n2"}:
            assert a[k] == pytest.approx(b[k], rel=1e-12, abs=1e-300), k


def test_port_run_is_laser_free(port_run):
    out, got = port_run
    args = tld.parse_args(ARGV + ["--out", out])
    cfg = tld.lccf_config(args)
    assert (cfg.om, cfg.om_dp, cfg.record_lccf) == (0.0, 0.0, True)
    assert (cfg.n0, cfg.tmax, cfg.sample_freq) == (64, 0.1, 2)
    assert got["device"]["card"] == "cpu" and got["launches"] == {}
    (job,) = [os.path.join(d, "job1") for d in [
        os.path.join(out, x) for x in os.listdir(out)] if os.path.isdir(d)]
    assert os.path.exists(os.path.join(job, "J_interval0.dat"))


def test_defaults_are_the_jax_tools():
    args = tld.parse_args([])
    assert (args.n0, args.tmax, args.sample_freq, args.skip_time,
            args.max_shell, args.device) == (1024, 40.0, 40, 8.0, 20, "cuda")


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tld.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.fixture(scope="module")
def archive():
    if not os.path.exists(ARCHIVE):
        pytest.skip("no card record; run tools/torch_lccf_dispersion.py on "
                    "the card")
    with open(ARCHIVE) as f:
        return json.load(f)


def test_archive_keys_and_card(archive):
    assert JAX_KEYS <= set(archive)
    assert all(set(r) == ROW_KEYS for r in archive["rows"])
    assert (archive["n0"], archive["tmax"]) == (1024, 40.0)
    card = archive["device"]["card"]
    assert card.startswith("NVIDIA") and card.endswith(" W"), card
    assert all(archive["launches"][k] > 0 for k in (
        "yukawa_forces", "fused_ticks_rng", "yukawa_forces_potential"))


def test_archive_lowest_shells_in_band(archive):
    rows = sorted(archive["rows"], key=lambda r: r["n2"])[:4]
    assert len(rows) == 4
    assert all(0.72 <= r["ratio"] <= 1.25 for r in rows), [
        r["ratio"] for r in rows]
