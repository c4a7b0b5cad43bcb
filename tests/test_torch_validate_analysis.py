"""``tools/torch_validate_analysis.py`` against ``tools/validate_analysis.py``
(CPU, float64).

* The numpy helpers (``hmp_d``, ``fft_msd``, ``sinc_transform_of_g``) equal
  the JAX tool's bit for bit.
* The trajectories' MD stage, ``md_record`` at N=64 (20 collisional and 50
  recording MD steps) from the JAX tool's start after 2000 Metropolis
  steps, with the JAX tool's collision keys replayed
  (:class:`JaxToolDraws`), equals the JAX tool's ``md_trajectory`` to
  1e-9 (V, displacements, positions, the realized temperature).
* ``analyze`` and the JAX tool's ``section_ad`` on the same trajectories
  (the port's CPU trajectories at N=64, 200 recording steps, 400 at Gamma=50,
  fed to the JAX side by monkeypatching its ``md_trajectory``): every
  number of sections A-D within 1e-9 relative, every ``ok`` flag equal.
* Section E's z from summary statistics equals ``analysis.two_sample_z``
  and gives the archived z = -0.643 on the archived numbers.
* The card's record, ``artifacts/validate_analysis_torch/report.json``
  (skipped until it exists): every gate of the JAX tool, the JAX
  archive's keys, an NVIDIA card and its power limit.
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.core import init as jinit
from mdqtplasmasims_tpu.core.mc import MetropolisMC as JMC
from mdqtplasmasims_torch import analysis as tan
from mdqtplasmasims_torch.units import PlasmaUnits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_validate_analysis as tva  # noqa: E402
import validate_analysis as jva  # noqa: E402

torch.set_num_threads(1)

ARCHIVE = os.path.join(ROOT, "artifacts", "validate_analysis_torch",
                       "report.json")
N = 64
REC = 200
# every ion moved: on the exact lattice pair distances of exactly L/2 meet
# the force cutoff and the minimum image, which the packages round apart
MC = 2000


def _t(x):
    return torch.from_numpy(np.array(x))


class JaxToolDraws:
    """The JAX tool's MD key chain (tools/validate_analysis.py:141-166) as
    ``md_record``'s ``draws``: the MD steps split the seed's key itself
    (not the third key of ``split(PRNGKey(seed), 3)``), once a step, and
    a collisional step draws from the second half."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def md_step(self, n, dtype, collide):
        self.key, kc = jax.random.split(self.key)
        if not collide:
            return None
        kroll, kv = jax.random.split(kc)
        return (_t(jax.random.uniform(kroll, (n,)))[None],
                _t(jax.random.normal(kv, (n, 3), jnp.float64))[None])


def jax_tool_start(n, gamma, kappa, mc_steps, seed):
    """The JAX tool's start after the chain (validate_analysis.py:159-163).
    From the exact lattice the chain's first moves compare pair distances
    of exactly L/2 with the cutoff, which the two packages' roundings
    decide differently; tests/test_torch_mc.py holds the chain itself
    under replay from random starts, and ``test_chain_start`` the port's
    start."""
    L = jva_box(n)
    k_lat, k_mc, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    R, V = jinit.lattice_init(k_lat, n, gamma, L, dtype=jnp.float64)
    R, _ = jax.jit(JMC(L=L, ldeb=1.0 / kappa, gamma=gamma).run,
                   static_argnums=2)(R, k_mc, mc_steps)
    return _t(R), _t(V)


def jva_box(n):
    return (n * 4.0 * np.pi / 3.0) ** (1.0 / 3.0)


# ------------------------------------------------------------------ helpers

@pytest.mark.parametrize("gamma", [0.5, 3.0, 13.018123231671142, 175.0])
def test_hmp_d_equal(gamma):
    assert tva.hmp_d(gamma) == jva.hmp_d(gamma)


@pytest.mark.parametrize("T,n", [(7, 3), (64, 5), (301, 2)])
def test_fft_msd_equal(T, n):
    dr = np.cumsum(np.random.default_rng(T).normal(size=(T, n, 3)), 0)
    for a, b in zip(tva.fft_msd(dr, 0.005), jva.fft_msd(dr, 0.005)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bins", [40, 127])
def test_sinc_transform_equal(bins):
    rng = np.random.default_rng(bins)
    g = rng.uniform(0.0, 2.0, bins)
    k = np.sort(rng.uniform(0.5, 7.0, 30))
    np.testing.assert_array_equal(tva.sinc_transform_of_g(g, k),
                                  jva.sinc_transform_of_g(g, k))


# ------------------------------------------------------------- trajectories

def test_md_record_matches_jax_with_replayed_keys():
    kw = dict(mc_steps=MC, equil_steps=20, record_steps=50, seed=11,
              dt=0.005, cache_dir=None)
    ref = jva.md_trajectory(N, 3.0, 0.5, **kw)
    R, V = jax_tool_start(N, 3.0, 0.5, MC, 11)
    got = tva.md_record(R, V, 3.0, 0.5, equil_steps=20, record_steps=50,
                        draws=JaxToolDraws(11), dt=0.005)
    for name, a, b in zip(("vs", "dr", "rs"), got[:3], ref[:3]):
        assert a.shape == b.shape == (50, N, 3) and a.dtype == np.float64
        err = float(np.abs(a - b).max())
        assert err <= 1e-9 * max(1.0, float(np.abs(b).max())), (name, err)
    assert got[3] == ref[3]
    assert abs(got[4] - ref[4]) <= 1e-9 * ref[4]


def test_chain_start():
    """The port's start: the lattice with the normals given, then the
    chain with the draws given, each as its own module gives them."""
    from mdqtplasmasims_torch.core.draws import MemberDraws
    from mdqtplasmasims_torch.core.init import lattice_init
    from mdqtplasmasims_torch.core.mc import MetropolisMC
    g = torch.Generator().manual_seed(5)
    R, V = tva.chain_start(27, 3.0, 0.5, 200, MemberDraws([g]), "cpu",
                           torch.float64)
    g2 = torch.Generator().manual_seed(5)
    L = PlasmaUnits.box_length(27)
    R0, V0 = lattice_init(g2, 27, 3.0, L, dtype=torch.float64)
    R1, acc = MetropolisMC(L=L, ldeb=2.0, gamma=3.0).run(R0, [g2], 200)
    assert torch.equal(V, V0) and torch.equal(R, R1) and 0 < int(acc) < 200


def test_trajectory_draws_from_its_seed():
    """Without ``draws`` a trajectory is a function of its seed; the cache
    returns it unchanged and keys on the device and dtype."""
    kw = dict(mc_steps=10, equil_steps=5, record_steps=6, device="cpu",
              dtype=torch.float64)
    a = tva.md_trajectory(27, 3.0, 0.5, seed=11, **kw)
    b = tva.md_trajectory(27, 3.0, 0.5, seed=11, **kw)
    c = tva.md_trajectory(27, 3.0, 0.5, seed=12, **kw)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])


def test_trajectory_cache(tmp_path):
    kw = dict(mc_steps=10, equil_steps=5, record_steps=6, seed=11,
              device="cpu", dtype=torch.float64, cache_dir=str(tmp_path))
    a = tva.md_trajectory(27, 3.0, 0.5, **kw)
    (name,) = os.listdir(tmp_path)
    assert name.endswith("_cpu_float64.npz"), name
    b = tva.md_trajectory(27, 3.0, 0.5, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------- analysis

@pytest.fixture(scope="module")
def trajs():
    """The port's CPU trajectories of every (Gamma, kappa, seed) that
    section_ad reads, at N=64 with a short chain."""
    plan = tva.trajectory_plan(types.SimpleNamespace(
        fast=False, record_steps=REC, sections="ABCD"))
    assert sorted(plan) == sorted([(3.0, 0.5, 11), (50.0, 0.5, 13),
                                   (3.0, 0.1, 12), (5.0, 0.1, 14),
                                   (10.0, 0.1, 15), (20.0, 0.1, 16)])
    return {key: tva.md_trajectory(
        N, *key[:2], seed=key[2], mc_steps=MC,
        equil_steps=kw["equil_steps"] // 10,
        record_steps=kw["record_steps"], device="cpu", dtype=torch.float64)
        for key, kw in plan.items()}


def _close(a, b, path, skip=()):
    if isinstance(b, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in b:
            if k not in skip:
                _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(b, (bool, np.bool_)):
        assert bool(a) == bool(b), path
    else:
        assert abs(a - b) <= 1e-9 * abs(b), (path, a, b)


# where the JAX tool's ``section_ad`` writes its J(k) files
# (tools/validate_analysis.py:319, :375)
JAX_J_DIR = "/tmp/validate_analysis_cache"


class _MovedOs:
    """``os`` for the JAX tool with :data:`JAX_J_DIR` moved to ``base``, so
    its J(k) files go to the test's own directory."""

    def __init__(self, base):
        self.path = types.SimpleNamespace(
            **{k: getattr(os.path, k) for k in dir(os.path)
               if not k.startswith("_")})
        self.path.join = lambda a, *p: os.path.join(
            base if a == JAX_J_DIR else a, *p)

    def __getattr__(self, name):
        return getattr(os, name)


def test_analysis_matches_jax_sections(trajs, tmp_path, monkeypatch):
    def fake(n, gamma, kappa, *, mc_steps, equil_steps, record_steps, seed,
             dt=0.005, cache_dir=None):
        traj = trajs[(gamma, kappa, seed)]
        assert traj[0].shape[0] == record_steps and dt == tva.DT
        return traj

    monkeypatch.setattr(jva, "md_trajectory", fake)
    jax_dir = tmp_path / "jax"
    monkeypatch.setattr(jva, "os", _MovedOs(str(jax_dir)))
    ref = {}
    ok = jva.section_ad(types.SimpleNamespace(fast=False, record_steps=REC),
                        ref)
    port_dir = tmp_path / "port"
    got = tva.analyze(trajs, types.SimpleNamespace(
        fast=False, record_steps=REC, sections="ABCD",
        work_dir=str(port_dir)))
    assert set(got.pop("section_walls_s")) == set("ABCD")
    assert list(got) == list(ref)
    # the JAX tool records its configured N; the port the trajectory's
    assert (got["A_gk_vs_msd"]["n"], ref["A_gk_vs_msd"]["n"]) == (N, 512)
    for sec in ref:
        _close(got[sec], ref[sec], sec, skip=("n",))
    assert all(got[s]["ok"] for s in got) == ok
    # the J(k) files are the JAX tool's byte for byte
    for job in ("dispersion_job", "dispersion_job_g50"):
        with open(os.path.join(port_dir, job, "J_interval0.dat")) as f, \
                open(os.path.join(jax_dir, job, "J_interval0.dat")) as g:
            a, b = f.read(), g.read()
        assert a.count("\n") == b.count("\n")
        mism = sum(x != y for x, y in zip(a.splitlines(), b.splitlines()))
        # float64 J(k) from two implementations: a last %.8g digit may
        # round the other way in a rare row
        assert mism <= 1e-4 * a.count("\n"), mism


def test_analysis_sections_subset(trajs, tmp_path):
    """``--sections ACD`` (chip_smoke's cut) reads two trajectories and
    gives A, C and D as the whole run does."""
    args = types.SimpleNamespace(fast=False, record_steps=REC,
                                 sections="ACD", work_dir=str(tmp_path))
    plan = tva.trajectory_plan(args)
    assert sorted(plan) == [(3.0, 0.5, 11), (50.0, 0.5, 13)]
    got = tva.analyze({k: trajs[k] for k in plan}, args)
    assert list(got) == ["A_gk_vs_msd", "C_sk_gofr", "D_dispersion",
                         "section_walls_s"]


def test_fast_sizes():
    args = tva.parse_args(["--fast", "--device", "cpu"])
    assert tva.sizes(args) == dict(n=216, record_steps=1200,
                                   mc_steps=6000, mc_steps_shear=6000)
    plan = tva.trajectory_plan(tva.parse_args([]))
    assert plan[(50.0, 0.5, 13)] == dict(mc_steps=60000, equil_steps=800,
                                         record_steps=16000)
    assert plan[(20.0, 0.1, 16)] == dict(mc_steps=30000, equil_steps=400,
                                         record_steps=8000)


# ---------------------------------------------------------------- section E

def test_summary_z_equals_two_sample_z():
    rng = np.random.default_rng(21)
    for ka, kb in ((16, 16), (8, 13)):
        a, b = rng.normal(0.35, 0.014, ka), rng.normal(0.352, 0.012, kb)
        z = tva.summary_z(a.mean(), a.std(ddof=1), ka, b.mean(),
                          b.std(ddof=1), kb)
        assert z == pytest.approx(tan.two_sample_z(a, b), rel=1e-12)


def test_summary_z_on_the_archived_pools():
    with open(tva.JAX_REPORT) as f:
        e = json.load(f)["E_cross_code"]
    z = tva.summary_z(e["d_ref_mean"], e["d_ref_sd"], e["k"],
                      e["d_fw_mean"], e["d_fw_sd"], e["k"])
    assert round(z, 3) == -0.643 and z == pytest.approx(e["z"], rel=1e-12)


def test_reference_pool_from_the_archive(tmp_path):
    k, m, s, src = tva.reference_pool(str(tmp_path / "absent"))
    assert (k, m, s) == (16, 0.3485778533779762, 0.013717017943120483)
    assert src.startswith("artifacts/validate_analysis/report.json")


def test_reference_pool_from_a_workdir(tmp_path):
    rng = np.random.default_rng(3)
    ds = []
    for j in range(3):
        d = tmp_path / "refdata" / "p" / f"job{j + 1}"
        d.mkdir(parents=True)
        rows = np.stack([np.arange(40) * 0.005,
                         np.exp(-np.arange(40) * rng.uniform(0.05, 0.1))],
                        -1)
        np.savetxt(d / "VAF.dat", rows)
        ds.append(tan.green_kubo_diffusion(np.loadtxt(d / "VAF.dat")[:20],
                                           plateau_frac=0.3)["d"])
    k, m, s, _ = tva.reference_pool(str(tmp_path))
    assert (k, m, s) == (3, np.mean(ds), np.std(ds, ddof=1))


# ------------------------------------------------------------------ archive

@pytest.fixture(scope="module")
def archive():
    if not os.path.exists(ARCHIVE):
        pytest.skip("no card record; run tools/torch_validate_analysis.py "
                    "on the card")
    with open(ARCHIVE) as f:
        return json.load(f)


def test_archive_gate_a(archive):
    assert abs(archive["A_gk_vs_msd"]["ratio"] - 1.0) < 0.15


def test_archive_gate_b(archive):
    b = archive["B_hmp_anchor"]
    assert all(0.7 < p["ratio"] < 1.4 for p in b["points"]
               if p["gamma"] >= 10.0)
    assert -1.7 < b["exponent"] < -1.0
    assert b["screening_ratio"] > 0.95


def test_archive_gate_c(archive):
    assert archive["C_sk_gofr"]["max_abs_err"] < 0.05


def test_archive_gate_d(archive):
    d = archive["D_dispersion"]
    assert len(d["rows"]) == 4
    assert all(0.72 < r["ratio"] < 1.25 for r in d["rows"])
    d_om = 2.0 * np.pi / (archive["record_steps"] * tva.DT)
    assert all(r["omega_t"] <= 2.5 * d_om * (1 + 1e-12) for r in d["rows"])
    assert d["gamma50_shear"]


def test_archive_gate_e(archive):
    assert abs(archive["E_cross_code"]["z"]) < 2.0


def test_archive_keys_and_card(archive):
    with open(tva.JAX_REPORT) as f:
        jax_rep = json.load(f)
    assert set(jax_rep) <= set(archive)
    for sec, v in jax_rep.items():
        if isinstance(v, dict):
            assert set(v) <= set(archive[sec]), sec
    assert not archive["fast"] and archive["ok"]
    assert archive["dtype"] == "float32"
    card = archive["device"]["card"]
    assert card.startswith("NVIDIA") and card.endswith(" W"), card
    # every trajectory made in this run, none served from the cache: kernel
    # A once per MD step + once a trajectory; section E's fold through C
    n_md = sum(1 + t["equil_steps"] + t["record_steps"]
               for t in archive["trajectories"])
    assert archive["launches"]["trajectories"] == {"yukawa_forces": n_md}
    assert archive["launches"]["E"]["yukawa_forces_batched"] > 0
