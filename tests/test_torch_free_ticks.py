"""The tick kernel's launches for ions that feel no force
(``core/scheduler.free_ion_ticks``): the three-state toy's ticks (S = 3,
kicks and recoils on vx) and the tagging pumps' windows (S = 5 and 7, vx
fixed), through the kernel's plain twin on the CPU, against the JAX
package's ``QTEngine.step_sm`` run tick by tick on the same uniforms: one
fold without a sweep, and sweep folds whose members carry their own
(detuning, om) through the kernel's per-lane forms (e0, om, e0 + om),
the JAX side with ``sweep_qt_params`` tables and, for the toy, its om
force scale (experiments/three_state.py:265-295 there).

Tolerances are tests/test_fused.py:91-101's: vx and t_part 2e-5, psi 5e-5
(+1e-4 relative), float32.  Port-only properties are bitwise: a pump
leaves vx as it was, and a sweep member at the base (detuning, om)
equals the same member run without a sweep."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.core import qt as jqt
from mdqtplasmasims_tpu import levels as jlv
from mdqtplasmasims_torch import levels as tlv
from mdqtplasmasims_torch.bridge import qt_params_from_numpy
from mdqtplasmasims_torch.core import qt as tqt
from mdqtplasmasims_torch.core import qt_fused as tf
from mdqtplasmasims_torch.core.scheduler import (fold_sweep_lanes,
                                                 free_ion_spec,
                                                 free_ion_ticks, member_sweep,
                                                 sweep_lanes)
from mdqtplasmasims_torch.experiments import frozen_tagging as tft

torch.set_num_threads(1)

VKICK = 0.0012076
# name -> (scheme(levels, detuning, om), kicks on vx)
SCHEMES = {
    "three_state": (lambda lv, d, o: lv.three_state(d, o, VKICK), True),
    "tag422": (lambda lv, d, o: lv.tag422(d, o), False),
    "tag408_quad": (lambda lv, d, o: lv.tag408(d, o, False), False),
    "tag408_linear": (lambda lv, d, o: lv.tag408(d, o, True), False),
}
BASE = (-1.0, 1.3)                   # the config's own (detuning, om)
VARIANTS = {
    "plain": [BASE, BASE],
    "e0": [BASE, (-0.4, 1.3), (-2.5, 1.3)],
    "om": [BASE, (-1.0, 0.7), (-1.0, 2.0)],
    "e0_om": [BASE, (-0.4, 0.7), (-2.5, 2.0)],
}
KW = dict(h=0.01, dt_plasma=0.01, plas_to_quant_vel=1.3,
          gamma_to_einstein=1.0)
N, T = 40, 12


def _inputs(S, E, seed):
    """Start amplitudes with the excited states populated, velocities,
    clocks and ``[T, 5, E, N]`` uniforms whose jump draws are small (jumps
    fire on many ticks)."""
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=(E, S, N)) + 1j * rng.normal(size=(E, S, N))
    psi /= np.sqrt((np.abs(psi) ** 2).sum(1, keepdims=True))
    vx = rng.normal(0, 0.4, (E, N)).astype(np.float32)
    tp = np.abs(rng.normal(0, 1.0, (E, N))).astype(np.float32)
    rolls = rng.uniform(size=(T, 5, E, N)).astype(np.float32)
    rolls[:, 0] *= 0.02
    return psi.astype(np.complex64), vx, tp, rolls


def _port(name, points, psi, vx, tp, rolls):
    """The port's one launch: the engine of the base scheme, the sweep's
    tables through ``sweep_lanes`` (JAX's, carried by the bridge)."""
    make, force = SCHEMES[name]
    base = make(tlv, *BASE)
    eng = tqt.QTEngine(base, apply_force=force, **KW)
    dets, oms = (np.asarray(x, np.float32) for x in zip(*points))
    pj = jax.vmap(lambda d, o: jqt.sweep_qt_params(
        make(jlv, 1.0, 1.0), d, o, jnp.float32, jnp.complex64))(
            jnp.asarray(dets), jnp.asarray(oms))
    e0, om = sweep_lanes(base, BASE[1], qt_params_from_numpy(pj, device="cpu"),
                         [o for _, o in points])
    spec = free_ion_spec(eng, T, e0 is not None, om is not None)
    out = free_ion_ticks(spec, *(torch.from_numpy(x) for x in (vx, psi, tp,
                                                              rolls)), e0, om)
    return spec, e0, om, [x.numpy() for x in out], pj, oms


def _jax(name, points, psi, vx, tp, rolls, pj, oms):
    """``step_sm`` of the JAX package tick by tick, the members vmapped;
    a sweep with its tables (and the toy's om force scale)."""
    make, force = SCHEMES[name]
    je = jqt.QTEngine(make(jlv, *BASE), apply_force=force, **KW)
    sweep = points is not VARIANTS["plain"]
    scale = jnp.asarray(oms / np.float32(BASE[1]), jnp.float32)

    @jax.jit
    def step(a, b, c, r):
        if not sweep:
            return jax.vmap(lambda a, b, c, r: je.step_sm(a, b, c, rolls=r))(
                a, b, c, r)
        return jax.vmap(lambda a, b, c, r, p, f: je.step_sm(
            a, b, c, rolls=r, params=p, force_scale=f if force else None))(
                a, b, c, r, pj, scale)
    st = (jnp.asarray(psi), jnp.asarray(vx), jnp.asarray(tp))
    for k in range(T):
        st = step(*st, jnp.asarray(rolls[k]).transpose(1, 0, 2))
    psi_j, vx_j, tp_j = (np.asarray(x) for x in st)
    return vx_j, psi_j, tp_j


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", list(SCHEMES))
def test_free_ion_ticks_match_jax_step_sm(name, variant):
    points = VARIANTS[variant]
    S = SCHEMES[name][0](tlv, *BASE).n_states
    psi, vx, tp, rolls = _inputs(S, len(points), seed=len(name) + S)
    spec, e0, om, got, pj, oms = _port(name, points, psi, vx, tp, rolls)
    # the per-lane form follows what the sweep varies
    assert (spec.per_lane_e0, spec.per_lane_om) == (
        "e0" in variant, "om" in variant)
    assert tf.launch_counter(spec) == (
        f"launches_s{S}" + ("" if variant == "plain" else
                            "_per_lane_" + variant))
    want = _jax(name, points, psi, vx, tp, rolls, pj, oms)
    for what, g, w, atol in zip(("vx", "psi", "t_part"), got, want,
                                (2e-5, 5e-5, 2e-5)):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w, atol=atol, rtol=1e-4, err_msg=what)
    assert int((got[2] < T * KW["dt_plasma"]).sum()) >= 10   # jumps fired
    if SCHEMES[name][1]:
        assert np.abs(got[0] - vx).max() > 0                  # kicks landed
    else:                          # the pump's fixed vx, bit for bit
        np.testing.assert_array_equal(got[0], vx)
    if variant != "plain":         # the members' Hamiltonians differ
        assert np.abs(got[1][1] - got[1][0]).max() > 1e-3


@pytest.mark.parametrize("name", list(SCHEMES))
def test_base_member_of_a_sweep_equals_the_plain_launch_bitwise(name):
    """A sweep member at the base (detuning, om) goes through the e0+om
    form with the base's own e0 and a Rabi scale of 1: it equals the same
    member launched alone through the plain form, bit for bit."""
    points = VARIANTS["e0_om"]
    S = SCHEMES[name][0](tlv, *BASE).n_states
    psi, vx, tp, rolls = _inputs(S, len(points), seed=5)
    _, _, _, swept, _, _ = _port(name, points, psi, vx, tp, rolls)
    _, _, _, alone, _, _ = _port(name, [BASE], psi[:1], vx[:1], tp[:1],
                                 np.ascontiguousarray(rolls[:, :, :1]))
    for a, b in zip(swept, alone):
        np.testing.assert_array_equal(a[:1], b)


def test_sweep_lanes_refuses_what_the_kernel_cannot_scale():
    base = tlv.tag422(*BASE)
    params = tqt.sweep_qt_params(tlv.tag422(1.0, 1.0), [-1.0, -2.0],
                                 [1.3, 0.9], torch.float32, torch.complex64,
                                 "cpu")
    e0, om = sweep_lanes(base, BASE[1], params, [1.3, 0.9])
    assert e0.shape == (2, 5)
    np.testing.assert_allclose(om.numpy(), [1.0, 0.9 / 1.3], rtol=1e-7)
    bent = params._replace(coupling=params.coupling * 1.01)
    with pytest.raises(ValueError, match="scaled"):
        sweep_lanes(base, BASE[1], bent, [1.3, 0.9])
    with pytest.raises(ValueError, match="nonzero base om"):
        sweep_lanes(tlv.tag422(-1.0, 0.0), 0.0, params, [1.3, 0.9])
    same = tqt.sweep_qt_params(tlv.tag422(1.0, 1.0), [-1.0], [1.3],
                               torch.float32, torch.complex64, "cpu")
    assert sweep_lanes(base, BASE[1], same, [1.3]) == (None, None)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", list(SCHEMES))
def test_member_sweep_equals_the_sweeps_tables(name, variant):
    """The families' tables, read off each member's own scheme, equal
    those ``sweep_lanes`` takes from the sweep's ``sweep_qt_params``
    tables, bit for bit (None where nothing varies)."""
    make = SCHEMES[name][0]
    points = VARIANTS[variant]
    base = make(tlv, *BASE)
    dets, oms = zip(*points)
    params = tqt.sweep_qt_params(make(tlv, 1.0, 1.0), list(dets), list(oms),
                                 torch.float32, torch.complex64, "cpu")
    got = member_sweep(base, BASE[1], [make(tlv, d, o) for d, o in points],
                       oms, torch.float32, "cpu")
    want = sweep_lanes(base, BASE[1], params, oms)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == torch.float32 and torch.equal(g, w)
    assert (got[0] is None, got[1] is None) == (
        "e0" not in variant, "om" not in variant)
    with pytest.raises(ValueError, match="nonzero base om"):
        member_sweep(make(tlv, BASE[0], 0.0), 0.0, [base], [BASE[1]],
                     torch.float32, "cpu")


def test_fold_sweep_lanes_takes_tensors_in_any_dtype():
    """Tensors of any float type pack as the arrays do: the one lane
    order of every per-lane form (member j's block at lanes j*npad, every
    lane of the block its member's value, pad rows zero)."""
    spec = free_ion_spec(tqt.QTEngine(tlv.tag422(*BASE), **KW), T, True, True)
    rng = np.random.default_rng(3)
    e0, om = rng.normal(size=(3, 5)), rng.normal(size=(3, 2))
    ref = fold_sweep_lanes(spec, 128, e0, om)
    for dt in (torch.float32, torch.float64):
        got = fold_sweep_lanes(spec, 128, torch.from_numpy(e0).to(dt),
                               torch.from_numpy(om).to(dt), dtype=dt)
        for g, r in zip(got, ref):
            assert g.dtype == dt
            torch.testing.assert_close(g.float(), r, rtol=0, atol=0)
    e0p, omp = ref
    assert e0p.shape == (spec.SP, 3 * 128) and omp.shape == (2, 3 * 128)
    assert not e0p[5:].any()
    np.testing.assert_array_equal(e0p[:5, 128:256].numpy(), np.repeat(
        e0[1].astype(np.float32)[:, None], 128, 1))


@pytest.mark.parametrize("edge", ["opens", "closes"])
def test_window_edges_inside_an_md_step(edge):
    """A pump window that opens or closes inside an MD step launches only
    its own ticks ``[k0, k1)``: the step equals the plain engine's ticks
    gated one by one (the reference's per-tick window test), and the
    ticks outside leave psi and t_part as they were."""
    cfg = tft.FrozenTagConfig(n0=64, tstart=0.02, tmax=0.1, sample_freq=4,
                              tpump_seconds=5e-8)
    gen = torch.Generator().manual_seed(9)
    st = tft.initial_state(cfg, gen)
    sched = tft.build_scheduler(cfg, rolls_fn=lambda r, lanes: torch.rand(
        (r, 5) + tuple(lanes), generator=gen))
    edge_t = cfg.tstart if edge == "opens" else cfg.tend
    tick = int(edge_t / cfg.qdt) - cfg.ratio // 2
    st = dataclasses.replace(st, tick=tick)
    k0, k1 = sched.window(tick, torch.float32)
    assert 0 < k1 - k0 < cfg.ratio          # a partial window
    assert (k0 > 0) == (edge == "opens") and (k1 < cfg.ratio) == (
        edge == "closes")
    state = dict(gen=gen.get_state())
    got = sched.md_step(st)
    gen.set_state(state["gen"])
    rolls = torch.rand((cfg.ratio, 5, cfg.n0), generator=gen)
    psi, vx, tp = st.psi.T, got.V[:, 0], st.t_part
    for k in range(cfg.ratio):
        if sched.in_window(tick + k, torch.float32):
            psi, _, tp = sched.engine.step_sm(psi, vx, tp, rolls=rolls[k])
    np.testing.assert_allclose(got.psi.T.numpy(), psi.numpy(), atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(got.t_part.numpy(), tp.numpy(), atol=2e-5)
    assert not torch.equal(got.psi, st.psi)
