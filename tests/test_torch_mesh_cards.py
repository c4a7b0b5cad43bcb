"""The port's mesh on distinct cards (``tools/torch_mesh_cards.py``).

On the CPU: ``member_sharded``'s worker processes (one a slot, the form
it takes when the slots lie on several cards) give each share-nothing
family the bits of the unsharded fold; a failing block raises only after
every block has ended; the workers' kernel launches reach this process's
counters; the tool's sections run on four CPU slots at a tiny size and
its trace breakdown reads per-card windows.  The archive test holds
``artifacts/mesh_cards_torch/report.json``, the tool's run on four cards.
The ``cuda`` test needs at least two cards.
"""

import json
import os
import sys

import pytest
import torch

from mdqtplasmasims_torch import _build
from mdqtplasmasims_torch.parallel import ensemble as pe
from mdqtplasmasims_torch.parallel.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_mesh_cards as tmc  # noqa: E402

torch.set_num_threads(1)

REPORT = os.path.join(ROOT, "artifacts", "mesh_cards_torch", "report.json")

_COOL = dict(n0=16, tmax=0.002, sample_freq=1)
_FROZEN = dict(n0=16, tstart=0.002, tmax=0.012, sample_freq=1,
               tpump_seconds=5e-9)
# a chain of 100 Metropolis steps: from the lattice start, fewer leave
# pairs at exactly half the cell, whose forces a fold and a lone member
# round apart on the CPU
_MC = dict(n=27, mc_steps=100, pre_record_md_steps=2, record_steps=4,
           gr_every_record=2)
_TRANSPORT = dict(_MC, gr_every_mc=100, instant_aniso_steps=2,
                  reequil_steps=2, aniso_relax_steps=2, aniso_time_us=0.01)
_MC_TAG = dict(_MC, mc_chunk_steps=100, tpump_seconds=5e-9)
_THREE_STATE = dict(n0=8, tmax=0.4, sample_freq=20)
#: the tool's sections at a size the CPU runs in seconds
TINY = dict(
    ens=dict(cfg=_COOL, n_jobs=4),
    ions=(dict(K=1, I=4, n_jobs=1, cfg=_COOL),),
    resume=dict(cfg=dict(_COOL, tmax=0.004, checkpoint_every_segments=1),
                half=0.5, n_jobs=4, ions_jobs=2),
    cli=dict(args=("--n0", "16", "--tmax", "0.002", "--sample-freq", "1",
                   "--checkpoint-every-segments", "1"), jobs_per_card=1),
    share_nothing=dict(three_state=(_THREE_STATE, 4)),
    production=dict(cooling_mesh=dict(_COOL, checkpoint_every_segments=1),
                    jobs_per_slot=1, n14000=_COOL, frozen=_FROZEN,
                    frozen_jobs=4, transport=_TRANSPORT, transport_jobs=4,
                    one_card=("cooling_mesh_ensemble", "cooling_n14000",
                              "frozen_fold", "transport_fold")),
    traces=dict(steps=1, ens=dict(n_jobs=4, cfg=dict(_COOL)),
                ions=dict(n_jobs=1, cfg=dict(_COOL)), frozen=_FROZEN,
                frozen_jobs=4),
)
#: each share-nothing family at a tiny size, with its fold's members
SHARE_NOTHING = dict(frozen_tagging=(_FROZEN, 4),
                     three_state=(_THREE_STATE, 4),
                     transport=(_TRANSPORT, 4), mc_tagging=(_MC_TAG, 4))
FAMILIES = sorted(SHARE_NOTHING)


@pytest.fixture(scope="module", autouse=True)
def _end_workers():
    yield
    pe.stop_workers()


@pytest.fixture
def multi_card(monkeypatch):
    """Make ``member_sharded`` take its multi-card form (a worker process
    a slot) on CPU slots."""
    monkeypatch.setattr(pe, "mesh_is_multi_card", lambda mesh: True)


@pytest.mark.parametrize("family", FAMILIES)
def test_member_sharded_workers_bitwise(family, multi_card):
    """Each share-nothing family's fold over four CPU slots, in the slots'
    worker processes where the family asks for them (the three-state
    toy's blocks are single launches, run in turn), equals the unsharded
    fold bit for bit, and the workers' launches reach this process."""
    module, cls = tmc._family(family)
    over, n_jobs = SHARE_NOTHING[family]
    cfg = cls(**over)
    fold = module.run_ensemble(cfg, n_jobs, seed=3, device="cpu")
    mesh = make_mesh(4, 1, devices=["cpu"] * 4)
    assert tmc.same(module.run_ensemble(cfg, n_jobs, seed=3, mesh=mesh),
                    fold)


def _pid_block(x):
    return torch.full_like(x, os.getpid()), x * 2


def _failing_block(x):
    if int(x[0]) == 0:
        raise RuntimeError("block 0 failed")
    return x


def test_member_sharded_blocks_in_slot_processes(multi_card):
    """``processes=True`` on a multi-card mesh runs block k in slot k's
    worker process (one a slot, kept for later calls); otherwise every
    block runs in this process; the joined result is the blocks' in slot
    order either way."""
    mesh = make_mesh(4, 1, devices=["cpu"] * 4)
    x = torch.arange(8.0)
    pids = []
    for processes in (True, False, True):
        who, out = pe.member_sharded(_pid_block, mesh,
                                     processes=processes)(x)
        assert torch.equal(out, x * 2)
        blocks = [int(p) for p in who[::2]]
        assert who.tolist() == [p for p in blocks for _ in range(2)]
        if processes:
            assert len(set(blocks)) == 4 and os.getpid() not in blocks
            pids.append(blocks)
        else:
            assert set(blocks) == {os.getpid()}
    assert pids[0] == pids[1]
    assert pe.start_workers(mesh) >= 0.0


def test_member_sharded_worker_raises_after_every_block(multi_card):
    mesh = make_mesh(4, 1, devices=["cpu"] * 4)
    with pytest.raises(RuntimeError, match="block 0 failed"):
        pe.member_sharded(_failing_block, mesh,
                          processes=True)(torch.arange(4.0))


@pytest.mark.parametrize("family,replay", [
    ("frozen_tagging", "rolls_fn"), ("frozen_tagging", "measure_fn"),
    ("transport", "draws"), ("mc_tagging", "draws")])
def test_replayed_draws_refuse_a_multi_card_mesh(family, replay, multi_card):
    """A replayed stream (``rolls_fn`` / ``measure_fn``, ``draws``) is one
    fold's and cannot cross into the slots' worker processes: a mesh
    refuses it before any block runs."""
    module, cls = tmc._family(family)
    over, n_jobs = SHARE_NOTHING[family]
    mesh = make_mesh(4, 1, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="split over a mesh"):
        module.run_ensemble(cls(**over), n_jobs, seed=3, mesh=mesh,
                            **{replay: lambda *a: None})


def test_mesh_is_multi_card():
    assert not pe.mesh_is_multi_card(make_mesh(4, 1, devices=["cpu"] * 4))
    cuda = [torch.device("cuda", j) for j in (0, 0, 1, 1)]
    assert pe.mesh_is_multi_card(make_mesh(4, 1, devices=cuda))
    assert not pe.mesh_is_multi_card(make_mesh(2, 1, devices=cuda[:2]))


def test_launches_cross_processes():
    """A counter's launches since a snapshot, added to this process's
    counter of the same name (a slot worker's launches)."""
    from mdqtplasmasims_torch.ops import yukawa as ty

    def fn():
        pass
    fn.launches = 0
    before = _build.launch_snapshot()
    for _ in range(3):
        _build.count_launch(fn)
    key = f"{__name__}:{fn.__qualname__}.launches"
    assert _build.launch_delta(before) == {key: 3}
    n = ty.yukawa_forces_n3l_soa.launches
    _build.add_launches(
        {"mdqtplasmasims_torch.ops.yukawa:yukawa_forces_n3l_soa.launches": 5})
    assert ty.yukawa_forces_n3l_soa.launches == n + 5
    ty.yukawa_forces_n3l_soa.launches = n


@pytest.mark.parametrize("section", sorted(tmc.SECTIONS))
def test_tool_section_on_cpu_slots(section, tmp_path):
    """Each section of the tool on four CPU slots at a tiny size: the
    report is written, every bitwise flag holds (on one device the
    layouts must agree), and each run carries its wall."""
    rep = tmc.run("cpu", str(tmp_path), (section,), sizes=TINY,
                  work=str(tmp_path))
    with open(tmp_path / "report.json") as f:
        assert json.load(f)["flags"] == rep["flags"]
    assert rep["meta"]["devices"] == [dict(index=0, name="cpu",
                                           power_limit=None)]
    assert rep["meta"]["slots"] == ["cpu"] * 4
    assert all(rep["flags"].values()), rep["flags"]
    body = rep[section]
    if section == "bitwise":
        # (a) both modes vs one card, the ranks vs the fold, (b) one 1 x 4
        # mesh's two forms in both modes, (c) seven crossings' final state
        # and files, (d) the tree
        assert len(rep["flags"]) == 3 + 4 + 14 + 1
        assert body["d_cli"]["trees"]["files"] > 0
        assert sorted(body["c_checkpoints"]["cases"]) == sorted([
            "uninterrupted_fold", "cards_to_cards", "cards_to_fold",
            "fold_to_cards", "cards_to_cards_single",
            "cards_single_to_cards", "cards_to_cards_2x2_gather"])
        assert set(body["a_ens_only"]["runs"]) == {
            "cards", "cards_single", "one_card", "fold"}
    elif section == "share_nothing":
        assert sorted(body["families"]) == ["three_state"]
        r = body["families"]["three_state"]
        assert r["unsharded_fold"] == dict(equal=True, differ=[])
        assert r["runs"]["cards"]["wall_s"]
        assert body["workers_start_s"] >= 0.0
    elif section == "production":
        assert body["cooling_mesh_ensemble"]["cards"]["n_jobs"] == 4
        assert set(body["cooling_n14000"]) == {"gather", "ring_n3l"}
        assert set(body["cooling_n14000"]["gather"]) == {
            "cards", "cards_single", "one_card"}
        assert len(body["frozen_fold"]["cards"]["member_fractions"]) == 4
        assert len(body["transport_fold"]["one_card"]["members"]) == 4
        assert set(body["bands"]) == {
            f"{run}_{kind}" for kind in ("cards", "one_card")
            for run in ("cooling_mesh_ensemble", "cooling_n14000_gather",
                        "cooling_n14000_ring_n3l", "frozen_fold")}
    else:
        for name in ("cooling_4x1", "cooling_1x4", "cooling_4x1_single",
                     "cooling_1x4_single"):
            assert body[name]["steps"] > 0 and body[name]["window_ms"] > 0
            assert body[name]["host_ms_per_md_step"] > 0
        # the ranks, each traced in its own process
        assert len(body["cooling_4x1"]["ranks"]) == 4
        assert all(r["host_busy_ms_per_md_step"] > 0
                   for r in body["cooling_1x4"]["ranks"].values())
        # one device: the frozen fold runs in turn here, with no worker
        # process to trace its blocks
        fz = body["frozen_fold"]
        assert fz["traced_wall_ms"] > 0 and fz["cards"] == {}
        assert not fz["at_once"]


def test_tool_refuses_fewer_than_two_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmc.main(["--out", "unused"]) == 2
    assert "at least two" in capsys.readouterr().err


def test_trace_breakdown_reads_each_card():
    """Two cards' kernels in a 100 us window: card 0 busy 10-90, card 1
    30-60 and 70-100; every card at work from 30 to 90."""
    def k(dev, ts, dur, name="k"):
        return dict(ph="X", cat="kernel", name=name, ts=ts, dur=dur,
                    args=dict(device=dev))
    events = [dict(ph="X", cat="cpu_op", name="run", ts=0, dur=100),
              k(0, 10, 80), k(1, 30, 30), k(1, 70, 30),
              dict(ph="X", cat="cuda_runtime", name="cudaStreamSynchronize",
                   ts=95, dur=1)]
    b = tmc.soak.trace_breakdown(events, steps=2)
    assert b["cards"]["0"]["busy_share"] == pytest.approx(0.8)
    assert b["cards"]["1"]["busy_share"] == pytest.approx(0.6)
    assert b["common_ms"] == pytest.approx(0.06)
    assert b["common_share"] == pytest.approx(0.6)
    assert b["host_waits_per_step"] == 0.5
    assert b["busy_share"] == pytest.approx(0.9)


def _report():
    if not os.path.exists(REPORT):
        pytest.skip("the four-card report is not archived yet")
    with open(REPORT) as f:
        return json.load(f)


def test_archived_report_ran_on_four_h100s():
    rep = _report()
    devs = rep["meta"]["devices"]
    assert len({d["index"] for d in devs}) >= 4
    assert all("H100" in d["name"] and d["power_limit"] for d in devs)
    assert rep["meta"]["slots"] == [f"cuda:{j}" for j in range(4)]
    assert set(rep["meta"]["sections"]) == set(tmc.SECTIONS)


def test_archived_report_every_bitwise_flag():
    """Every bitwise flag of the four-card run holds, and the tool's own
    verdict with it: (a) both modes against one card, the ranks against
    the unsharded fold, (b) four ion-sharded runs in both modes, (c)
    seven crossings, (d) the CLI tree, each share-nothing family against
    one card and against the unsharded fold, the production folds
    against one card and the cooling runs' two modes."""
    rep = _report()
    f = rep["flags"]
    assert len(f) == 3 + 8 + 14 + 1 + 8 + 5 and all(f.values()), f
    assert set(rep["share_nothing"]["families"]) == set(FAMILIES)
    assert rep["ok"] is True and not rep["band_misses"]


def test_archived_report_bands():
    rep = _report()
    bands = rep["production"]["bands"]
    assert not rep["band_misses"]
    for name in ("cooling_mesh_ensemble_cards", "cooling_n14000_gather_cards",
                 "cooling_n14000_ring_n3l_cards", "frozen_fold_cards"):
        assert all(v["ok"] for v in bands[name].values()), name
    cme = rep["production"]["cooling_mesh_ensemble"]["cards"]
    assert cme["n_jobs"] == 32 and cme["tmax"] == 30.0
    for form in ("gather", "ring_n3l"):
        b = rep["production"]["cooling_n14000"][form]["cards"]
        assert b["n0"] == 14000 and b["tmax"] == 30.0 and b["wall_s"] < 900
    fr = rep["production"]["frozen_fold"]["cards"]["member_fractions"]
    assert len(fr) == 8 and all(0.30 < x < 0.55 for x in fr)


def test_archived_report_frozen_cards_at_once():
    """The traced four-card frozen fold: all four cards ran its kernels in
    one common window of at least half of its wall, both the traced
    fold's span (its workers' first event to their last, the tool's
    ``at_once``) and the same fold's wall untraced."""
    rep = _report()
    tr = rep["traces"]["frozen_fold"]
    assert len(tr["cards"]) >= 4 and tr["at_once"] is True
    assert tr["common_ms"] >= 0.5 * tr["window_ms"]
    assert tr["common_ms"] >= 0.5 * 1e3 * tr["untraced_s"]
    fold = rep["production"]["frozen_fold"]
    assert fold["cards"]["wall_s"] > 0 and fold["one_card"]["wall_s"] > 0
    for name in ("cooling_4x1", "cooling_1x4", "cooling_4x1_single",
                 "cooling_1x4_single"):
        t = rep["traces"][name]
        assert len(t["cards"]) >= 4 and t["host_ms_per_md_step"] > 0


@pytest.mark.cuda
def test_distinct_cards_equal_one_card():
    """A cut ens-only and ion-sharded cooling mesh and a frozen fold on
    distinct cards, bit for bit the same call with its slots on card 0."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs at least two CUDA cards")
    cards = tmc.cards_of("cuda")
    sizes = dict(tmc.SIZES, ens=dict(cfg=dict(n0=3500, tmax=0.2), n_jobs=8),
                 ions=(dict(K=2, I=2, n_jobs=2,
                            cfg=dict(n0=3500, tmax=0.2)),),
                 share_nothing=dict(frozen_tagging=(
                     dict(n0=3500, tstart=0.1, tmax=0.3), 8)))
    ens = tmc.ens_only(cards, sizes)
    assert ens["bitwise_cards_vs_one_card"] and ens["bitwise_cards_vs_fold"]
    for r in tmc.ion_sharded(cards, sizes).values():
        assert r["bitwise_cards_vs_one_card"]
    for r in tmc.share_nothing_section(cards, sizes, None,
                                       "cuda")["families"].values():
        assert r["bitwise_cards_vs_one_card"]
