"""The port's mesh layer (parallel/) against the JAX package's, which runs
on its 8 virtual CPU devices (tests/conftest.py); the port's mesh is a
grid of CPU slots driven from one process.

* ``ring_n3l_fused_forces`` (I = 2, 3, 4) against the JAX ring schedule
  (Pallas interpret mode) and the unsharded force twin: float32, 2e-5 of
  the largest |F| (summation order);
* ``sharded_forces_fn`` / ``ring_forces_fn`` on (1, 8) against JAX's:
  float64, rtol/atol 1e-12 (test_parallel.py's bar);
* ``make_sharded_fused_step`` layout invariance over (4,1), (2,1), (1,1):
  bitwise, with explicit rolls and with the in-kernel stream's twin;
* the in-situ forces of a (2,2) step, gather and ring_n3l, against JAX's
  unsharded ``yukawa_forces_potential``: rtol 2e-4 / atol 1e-5
  (test_parallel_fused.py:243-264's bar);
* ``make_sharded_md_step``, ``member_sharded``, ``shard_keys`` and the
  ``lane0`` argument of the in-kernel stream;
* the XLA-path functions refuse tensors off the CPU, and the ring
  schedule computes each pair of ion blocks once (I*(I-1)/2 calls of
  the cross kernel; forces within 2e-5 of max|F| of the unsharded twin).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.extend.random import threefry_2x32
from jax.sharding import PartitionSpec as P

from mdqtplasmasims_tpu.experiments import laser_cooling as jlc
from mdqtplasmasims_tpu.ops import yukawa as jy
from mdqtplasmasims_tpu.parallel import ensemble as jens
from mdqtplasmasims_tpu.parallel.mesh import ION_AXIS as JION
from mdqtplasmasims_tpu.parallel.mesh import make_mesh as jmake_mesh
from mdqtplasmasims_torch.core import qt_fused as tf
from mdqtplasmasims_torch.core.rng import tick_uniforms
from mdqtplasmasims_torch.core.scheduler import uniform_rolls
from mdqtplasmasims_torch.experiments import laser_cooling as lc
from mdqtplasmasims_torch.ops import yukawa as ty
from mdqtplasmasims_torch.parallel import ensemble as tens
from mdqtplasmasims_torch.parallel.mesh import (
    factor_devices, join_state, make_mesh, split_state)
from mdqtplasmasims_torch.units import PlasmaUnits

torch.set_num_threads(1)

needs_devices = pytest.mark.skipif(len(jax.devices()) < 8,
                                   reason="needs 8 virtual devices")
LDEB = PlasmaUnits(2.0, 0.1).debye_length


def cpu_mesh(k, i):
    return make_mesh(k, i, devices=["cpu"] * (k * i))


def _fold_rp(R):
    e, npad, _ = R.shape
    return np.ascontiguousarray(R.transpose(2, 0, 1).reshape(3, e * npad))


@needs_devices
@pytest.mark.parametrize("n_ions", [2, 3, 4])
def test_ring_n3l_forces_match_jax(n_ions):
    cfg_j = jlc.CoolingConfig(n0=48 * n_ions, use_pallas=False,
                              fused_interpret=True)
    sched_j = dataclasses.replace(jlc.build_scheduler(cfg_j), tile=128)
    e, n_loc, npad = 2, 48, 128
    rng = np.random.default_rng(5)
    L = sched_j.L
    mask = np.zeros(n_ions * npad, np.float32)
    for s in range(n_ions):
        mask[s * npad:s * npad + n_loc] = 1.0
    R = (rng.uniform(0, L, (e, n_ions * npad, 3)) * mask[None, :, None]
         ).astype(np.float32)
    mrows = np.zeros((1, npad), np.float32)
    mrows[0, :n_loc] = 1.0

    def local(R_block):
        fn = jens.ring_n3l_fused_forces(sched_j, LDEB, e, npad,
                                        jnp.asarray(mrows))
        F = fn(jnp.swapaxes(jnp.swapaxes(R_block, 1, 2), 0, 1).reshape(
            3, -1))
        return jnp.swapaxes(F.reshape(3, e, npad), 0, 1)
    Fj = np.asarray(shard_map(local, mesh=jmake_mesh(1, n_ions),
                              in_specs=(P(None, JION),),
                              out_specs=P(None, None, JION),
                              check_vma=False)(jnp.asarray(R)))
    sched_t = lc.build_scheduler(lc.CoolingConfig(n0=48 * n_ions), "cpu",
                                 rolls_fn=lambda *a: None)
    assert sched_t.L == L
    fn = tens.ring_n3l_fused_forces(sched_t, LDEB, e, npad,
                                    [torch.from_numpy(mrows)] * n_ions)
    Ft = fn([torch.from_numpy(_fold_rp(R[:, s * npad:(s + 1) * npad]))
             for s in range(n_ions)])
    Ft = np.concatenate([F.numpy().reshape(3, e, npad).transpose(1, 0, 2)
                         for F in Ft], axis=2)               # [E, 3, I*npad]
    ref = ty.yukawa_forces_n3l_soa_batched(
        torch.from_numpy(_fold_rp(R)),
        torch.from_numpy(mask[None]), e, L, LDEB).numpy()
    ref = ref.reshape(3, e, -1).transpose(1, 0, 2)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(Ft, Fj * mask, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(Ft, ref, rtol=0, atol=2e-5 * scale)


@needs_devices
@pytest.mark.parametrize("which", ["gather", "ring"])
def test_xla_sharded_forces_match_jax(which):
    n = 96
    L = PlasmaUnits.box_length(n)
    R = np.random.default_rng(1).uniform(0, L, (n, 3))
    jfn = (jens.sharded_forces_fn if which == "gather"
           else jens.ring_forces_fn)(L, LDEB)
    Fj, pj = shard_map(jfn, mesh=jmake_mesh(1, 8), in_specs=P("ions"),
                       out_specs=(P("ions"), P("ions")))(jnp.asarray(R))
    tfn = (tens.sharded_forces_fn if which == "gather"
           else tens.ring_forces_fn)(L, LDEB)
    out = tfn(list(torch.from_numpy(R).chunk(8)))
    Ft = torch.cat([f for f, _ in out]).numpy()
    pt = torch.cat([p for _, p in out]).numpy()
    np.testing.assert_allclose(Ft, np.asarray(Fj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pt, np.asarray(pj), rtol=1e-12, atol=1e-12)
    Fr, _ = jy.yukawa_forces_potential(jnp.asarray(R), L, LDEB)
    np.testing.assert_allclose(Ft, np.asarray(Fr), rtol=1e-12, atol=1e-12)


@pytest.fixture
def rng_on_cpu(monkeypatch):
    """Run the in-kernel stream's twin on the CPU (the CUDA default)."""
    monkeypatch.setattr(lc, "_use_internal_rng",
                        lambda device, rolls_fn: rolls_fn is None)


def _sched(cfg, form, seed=9):
    if form == "rng":
        sched = lc.build_scheduler(cfg, "cpu")
        sched.seed = torch.tensor([seed], dtype=torch.int32)
        return sched
    return lc.build_scheduler(cfg, "cpu", rolls_fn=uniform_rolls(
        torch.Generator().manual_seed(seed)))


@pytest.mark.parametrize("form", ["rolls", "rng"])
def test_fused_step_layout_invariance(form, rng_on_cpu):
    cfg = lc.CoolingConfig(n0=48)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    start = lc.member_states(cfg, 4, 7, "cpu")
    outs = []
    for k in (4, 2, 1):
        sched = _sched(cfg, form)
        assert sched.fused_spec.internal_rng == (form == "rng")
        step = tens.make_sharded_fused_step(sched, ldeb, cpu_mesh(k, 1),
                                            n_steps=3)
        outs.append(step(start))
    for other in outs[1:]:
        for f in ("R", "V", "F", "t_part", "psi"):
            assert torch.equal(getattr(outs[0], f), getattr(other, f)), f
        assert other.tick == 3 * cfg.ratio
    assert not torch.equal(outs[0].R, start.R)
    # the unsharded fold draws the same streams
    sched = _sched(cfg, form)
    carry = sched.soa_ens_init(start)
    fn = sched.soa_ens_forces_fn(4, 48)
    for _ in range(3):
        carry = sched.soa_ens_md_step(carry, fn)
    assert torch.equal(sched.soa_ens_restore(carry, start).psi, outs[0].psi)


@pytest.mark.parametrize("ion_forces", ["gather", "ring_n3l"])
def test_ion_sharded_forces_in_situ(ion_forces):
    cfg = lc.CoolingConfig(n0=64)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    sched = _sched(cfg, "rolls")
    start = lc.member_states(cfg, 2, 3, "cpu")
    step = tens.make_sharded_fused_step(sched, ldeb, cpu_mesh(2, 2),
                                        n_steps=1, ion_forces=ion_forces)
    out = step(start)
    assert out.tick == cfg.ratio
    for i in range(2):
        Fr, _ = jy.yukawa_forces_potential(
            jnp.asarray(start.R[i].numpy()), sched.L, ldeb)
        np.testing.assert_allclose(out.F[i].numpy(), np.asarray(Fr),
                                   rtol=2e-4, atol=1e-5)


def test_gather_and_ring_steps_agree_with_a_mask():
    """A Poissonian (per-member masks) (2,2) step: the two schedules agree
    (f32 summation order) and masked lanes stay exactly inert."""
    cfg = lc.CoolingConfig(n0=64, exact_n=False)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    states, mask, n_js = lc._poisson_member_states(cfg, 2, 4, "cpu",
                                                   round_to=2)
    out = {}
    for fr in ("gather", "ring_n3l"):
        step = tens.make_sharded_fused_step(_sched(cfg, "rolls"), ldeb,
                                            cpu_mesh(2, 2), with_mask=True,
                                            ion_forces=fr)
        out[fr] = step(states, mask)
    scale = out["gather"].F.abs().max()
    torch.testing.assert_close(out["ring_n3l"].F, out["gather"].F, rtol=0,
                               atol=2e-5 * float(scale))
    for j, nj in enumerate(n_js):
        for f in ("R", "V", "F", "psi"):
            assert not getattr(out["ring_n3l"], f)[j, nj:].any()


def test_xla_sharded_md_step(rng_on_cpu):
    """make_sharded_md_step: gather and ring give the same step (f64,
    1e-11), and its forces are the unsharded ones."""
    cfg = lc.CoolingConfig(n0=64, dtype="float64")
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    start = lc.member_states(cfg, 2, 5, "cpu")
    out = {fr: tens.make_sharded_md_step(_sched(cfg, "rng"), cpu_mesh(2, 4),
                                         PlasmaUnits.box_length(64), ldeb,
                                         forces=fr)(start)
           for fr in ("gather", "ring")}
    for f in ("R", "V", "F", "t_part", "psi"):
        torch.testing.assert_close(getattr(out["ring"], f),
                                   getattr(out["gather"], f), rtol=1e-11,
                                   atol=1e-12)
    for i in range(2):
        Fr, _ = ty.yukawa_forces_potential(start.R[i],
                                           PlasmaUnits.box_length(64), ldeb)
        torch.testing.assert_close(out["gather"].F[i], Fr, rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("which", ["gather", "ring", "md_step"])
def test_xla_path_refuses_tensors_off_the_cpu(which):
    """The XLA-path functions are the mesh path's plain CPU reference:
    tensors (or mesh slots) on another device are refused, not run in
    plain torch there."""
    R = [torch.empty((8, 3), device="meta")] * 2
    with pytest.raises(ValueError, match="plain CPU reference"):
        if which == "md_step":
            tens.make_sharded_md_step(_sched(lc.CoolingConfig(n0=16), "rolls"),
                                      make_mesh(2, 1, devices=["meta"] * 2),
                                      1.0, LDEB)
        else:
            (tens.sharded_forces_fn if which == "gather"
             else tens.ring_forces_fn)(1.0, LDEB)(R)


@pytest.mark.parametrize("n_ions", [2, 3, 4])
def test_ring_n3l_launches_once_per_block_pair(n_ions, monkeypatch):
    """The ring schedule computes each unordered pair of a member's ion
    blocks once: I*(I-1)/2 cross-tile calls per force refresh (the
    antipodal hop of an even ring runs on one shard of each pair), and
    the forces are the unsharded ones."""
    calls = []
    cross = tens.yukawa_forces_cross_n3l_soa_batched

    def counted(*args):
        calls.append(1)
        return cross(*args)
    monkeypatch.setattr(tens, "yukawa_forces_cross_n3l_soa_batched", counted)
    e, n_loc, npad = 1, 40, 128
    sched = lc.build_scheduler(lc.CoolingConfig(n0=n_loc * n_ions), "cpu",
                               rolls_fn=lambda *a: None)
    mrow = torch.zeros((1, npad))
    mrow[0, :n_loc] = 1.0
    R = torch.from_numpy(np.random.default_rng(2).uniform(
        0, sched.L, (n_ions, n_loc, 3)).astype(np.float32))
    Rps = []
    for s in range(n_ions):
        Rp = torch.zeros((3, npad))
        Rp[:, :n_loc] = R[s].T
        Rps.append(Rp)
    Fs = tens.ring_n3l_fused_forces(sched, LDEB, e, npad,
                                    [mrow] * n_ions)(Rps)
    assert len(calls) == n_ions * (n_ions - 1) // 2
    Ft = torch.cat([F[:, :n_loc].T for F in Fs])
    Fr, _ = ty.yukawa_forces_potential(R.reshape(-1, 3), sched.L, LDEB)
    torch.testing.assert_close(Ft, Fr, rtol=0,
                               atol=2e-5 * float(Fr.abs().max()))


def test_member_sharded():
    def batched(x, extra):
        return {"sum": x.sum(-1) + extra["b"], "pair": (x * 2, x[:, :1])}
    x = torch.arange(24.0).reshape(8, 3)
    extra = {"b": torch.arange(8.0)}
    want = batched(x, extra)
    got = tens.member_sharded(batched, cpu_mesh(4, 1))(x, extra)
    assert torch.equal(got["sum"], want["sum"])
    assert all(torch.equal(a, b) for a, b in zip(got["pair"], want["pair"]))
    with pytest.raises(ValueError, match="ion"):
        tens.member_sharded(batched, cpu_mesh(2, 2))
    with pytest.raises(ValueError, match="divide"):
        tens.member_sharded(batched, cpu_mesh(3, 1))(x, extra)


def test_shard_keys_and_split_join():
    lane0, words = tens.shard_keys(77, 4, cpu_mesh(2, 1), 512)
    np.testing.assert_array_equal(lane0[:, 0], np.arange(4) * 512)
    assert (words == 77).all()
    lane0, _ = tens.shard_keys(77, 4, cpu_mesh(2, 2), 128)
    # slot (k, i) holds members k*2, k*2+1 of shard i, slot-major
    np.testing.assert_array_equal(lane0, [[0, 256], [128, 384],
                                          [512, 768], [640, 896]])
    assert len(np.unique(lane0)) == lane0.size
    st = lc.member_states(lc.CoolingConfig(n0=32), 4, 1, "cpu")
    back = join_state(split_state(st, cpu_mesh(2, 2)), "cpu")
    for f in ("R", "V", "F", "psi", "t_part"):
        assert torch.equal(getattr(back, f), getattr(st, f))
    assert factor_devices(8) == (4, 2) and factor_devices(7) == (7, 1)
    with pytest.raises(ValueError, match="divide"):
        split_state(st, cpu_mesh(3, 1))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="distinct cards"):
            make_mesh(2, 1)


def test_lane0_stream():
    """``lane0`` = 0 is the unsharded stream; a slot's lanes from lane0
    are the fold's lanes from lane0; distinct slots draw distinct
    streams; the words are Threefry's (JAX's threefry_2x32) on the global
    lane counter."""
    word, t0, nt, npad = 123456789, 4321, 3, 256
    base = tick_uniforms(word, t0, nt, 2 * npad)
    assert torch.equal(tick_uniforms(word, t0, nt, npad, lane0=0),
                       base[:, :npad])
    slot = tick_uniforms(word, t0, nt, npad, lane0=npad)
    assert torch.equal(slot, base[:, npad:])
    assert not torch.equal(slot, base[:, :npad])
    n = np.arange(npad, 2 * npad, dtype=np.uint32)
    c = np.full(npad, 3 * t0, np.uint32)
    y = np.asarray(threefry_2x32(jnp.asarray([word, 0], jnp.uint32),
                                 jnp.asarray(np.concatenate([n, c]))))
    np.testing.assert_array_equal(
        slot[0].numpy(), (y[:npad] >> 8).astype(np.float32) * 2.0 ** -24)


def test_lane0_tick_twin_matches_fold(rng_on_cpu):
    """The tick twin at lane0 on half a fold == the fold's other half."""
    cfg = lc.CoolingConfig(n0=48)
    sched = _sched(cfg, "rng", seed=4)
    carry = sched.soa_ens_init(lc.member_states(cfg, 2, 2, "cpu"))
    spec, npad = sched.fused_spec, carry.R.shape[1] // 2
    F = torch.zeros_like(carry.R)
    whole = tf.fused_md_substeps(spec, True, carry.R, carry.V, F, carry.tp,
                                 carry.psi_re, carry.psi_im, tick0=0,
                                 tables=sched.tables, seed=sched.seed)
    half = [x[:, npad:].contiguous() for x in (
        carry.R, carry.V, F, carry.tp, carry.psi_re, carry.psi_im)]
    part = tf.fused_md_substeps(spec, True, *half, tick0=0,
                                tables=sched.tables, seed=sched.seed,
                                lane0=npad)
    for a, b in zip(part, whole):
        assert torch.equal(a, b[:, npad:])
    with pytest.raises(ValueError, match="lane0"):
        tf.fused_md_substeps(spec, True, *half, tick0=0, tables=sched.tables,
                             seed=sched.seed, lane0=-1)
