"""``tools/torch_transport_replay.py``: transport pooled's anisotropy
stages replayed in float64 on the host (CPU, float64).

* At ``--tiny`` on the CPU the fold already runs in float64, so the
  replay is the fold's own arithmetic: every member value and every curve
  equal, every difference 0; no card -> exit 2.
* The card's record, ``artifacts/transport_replay_torch/report.json``: the
  matrix tool's configuration, k and seed; the replay's fold values are
  the fold's own per-job statistics, and those of the validation matrix's
  archived ``transport_pooled`` pool (the fold is deterministic on the
  card); an NVIDIA card.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_transport_replay as ttr  # noqa: E402
import torch_validate_all as tva  # noqa: E402

torch.set_num_threads(1)

KEYS = [key for w in ttr.ANISO_WINDOWS for key in w]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("replay"))
    assert ttr.main(["--device", "cpu", "--tiny", "--out", out]) == 0
    with open(os.path.join(out, "report.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("key", KEYS)
def test_tiny_replay_is_the_fold_in_float64(tiny, key):
    assert tiny["dtype"] == "float64" and tiny["k"] == tva.TINY_JOBS
    assert tiny["cut"] == tva.TINY["transport_pooled"]
    r = tiny["replay"][key]
    assert r["fold"] == r["float64"] and len(r["fold"]) == tiny["k"]
    assert r["mean_diff"] == 0.0 and r["se_diff"] == 0.0
    assert np.mean(r["fold"]) == pytest.approx(tiny["fold"][key]["mean"],
                                               abs=1e-12)


def test_tiny_replay_curves_equal(tiny):
    curves = {k: v for k, v in tiny["replay"].items()
              if k.startswith("max_curve_diff")}
    assert len(curves) == len(ttr.ANISO_WINDOWS)
    assert all(v == 0.0 for v in curves.values())


def test_refuses_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ttr.main(["--out", str(tmp_path)]) == 2
    assert not os.listdir(tmp_path)


@pytest.fixture(scope="module")
def archived():
    with open(os.path.join(ttr.OUT, "report.json")) as f:
        return json.load(f)


def test_archive_names_the_card(archived):
    card = archived["device"]["card"]
    assert card.startswith("NVIDIA") and card.endswith("W"), card
    assert archived["dtype"] == "float32" and not archived["tiny"]
    assert archived["cut"] == {}
    assert archived["k"] == tva.parse_step("transport_pooled")["k"] == 16


def test_archive_replay_matches_the_fold(archived):
    """The float64 replay's fold values are the fold's own per-job
    statistics (the stage records the tool read), and the validation
    matrix's archived pool of the same fold."""
    with open(os.path.join(tva.OUT, "report.json")) as f:
        matrix = {s["name"]: s for s in json.load(f)["steps"]}
    port = matrix["transport_pooled"]["port"]
    for key in KEYS:
        r = archived["replay"][key]
        assert len(r["fold"]) == len(r["float64"]) == archived["k"]
        assert np.mean(r["fold"]) == pytest.approx(
            archived["fold"][key]["mean"], abs=1e-6)
        assert archived["fold"][key]["mean"] == pytest.approx(
            port[key]["mean"], abs=1e-6)
