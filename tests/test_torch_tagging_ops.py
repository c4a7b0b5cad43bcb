"""Port vs JAX package, module by module, for what the tagging families
add: ``core/tagging``, ``ops/correlations``, the centered KDE bins and the
weighted unfolded KDE, ``core/init.frozen_gas_positions``, the sweep fold's
tables (``sweep_qt_params``, ``sweep_member_params``,
``bridge.qt_params_from_numpy``), ``step_sm`` over a member axis, and the
``[E, N, 3]`` force entry with a per-member mask.  CPU, the same numpy
inputs through both sides, every dtype pinned.

Tolerances: elementwise functions 1e-6 relative; FFT autocorrelations 1e-5
of the array's largest value, against the JAX package and against
``power_autocorr_direct``; the engine's float32 bars of
tests/test_fused.py (vx/t_part 2e-5, psi 5e-5); forces 2e-5 of the
largest |F|.  A batched ``step_sm`` and a batched force call equal their
member-by-member calls bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.core import init as jinit
from mdqtplasmasims_tpu.core import qt as jqt
from mdqtplasmasims_tpu.core import tagging as jtag
from mdqtplasmasims_tpu.levels import tag408, tag422, three_state
from mdqtplasmasims_tpu.ops import correlations as jcorr
from mdqtplasmasims_tpu.ops import kde as jkde
from mdqtplasmasims_tpu.ops import yukawa as jy
from mdqtplasmasims_tpu.units import PlasmaUnits
from mdqtplasmasims_torch.bridge import qt_params_from_numpy
from mdqtplasmasims_torch.core import init as tinit
from mdqtplasmasims_torch.core import qt as tqt
from mdqtplasmasims_torch.core import tagging as ttag
from mdqtplasmasims_torch.ops import correlations as tcorr
from mdqtplasmasims_torch.ops import kde as tkde
from mdqtplasmasims_torch.ops import yukawa as ty

torch.set_num_threads(1)

RTOL = 1e-6


def _psi(rng, n, S):
    psi = rng.normal(size=(n, S)) + 1j * rng.normal(size=(n, S))
    return (psi / np.linalg.norm(psi, axis=1, keepdims=True)).astype(
        np.complex64)


# ---------------------------------------------------------------- tagging

@pytest.mark.parametrize("gamma", [1.0, 3.0])
def test_tag_classical_matches_jax(gamma):
    """The same (4, n) block of uniforms gives the same four taggings,
    inside and outside +-3 vT."""
    key = jax.random.PRNGKey(5)
    n = 4000
    vx = np.random.default_rng(1).normal(0, 1.6 / np.sqrt(gamma), n).astype(
        np.float32)
    assert (np.abs(vx) * np.sqrt(gamma) > 3).sum() > 20
    want = jtag.tag_classical(jnp.asarray(vx), key, gamma)
    rolls = torch.from_numpy(np.array(jax.random.uniform(key, (4, n))))
    got = ttag.tag_classical(torch.from_numpy(vx), None, gamma, rolls=rolls)
    for k in range(4):
        assert got[k].dtype == torch.bool
        # a roll within float32 rounding of its threshold may flip
        assert (got[k].numpy() != np.asarray(want[k])).sum() <= 1, k
    drawn = ttag.tag_classical(torch.from_numpy(vx),
                               torch.Generator().manual_seed(2), gamma)
    assert 0.3 < drawn[0].float().mean() < 0.7


@pytest.mark.parametrize("which", ["408", "422"])
def test_spin_up_probability_and_projective_tag_match_jax(which):
    S = 7 if which == "408" else 5
    psi = _psi(np.random.default_rng(3), 500, S)
    fj = getattr(jtag, f"spin_up_probability_{which}")
    ft = getattr(ttag, f"spin_up_probability_{which}")
    p = ft(torch.from_numpy(psi))
    assert p.dtype == torch.float32
    np.testing.assert_allclose(p.numpy(), np.asarray(fj(jnp.asarray(psi))),
                               rtol=RTOL, atol=1e-7)
    # a fold's [E, N, S] gives each member's own probabilities
    np.testing.assert_array_equal(
        ft(torch.from_numpy(psi.reshape(5, 100, S))).reshape(-1).numpy(),
        p.numpy())
    key = jax.random.PRNGKey(9)
    name = "tag408_quad" if which == "408" else "tag422_linear"
    want = np.asarray(jtag.projective_tag(jnp.asarray(psi), key, name))
    rolls = torch.from_numpy(np.array(jax.random.uniform(key, (500,))))
    got = ttag.projective_tag(torch.from_numpy(psi), None, name, rolls=rolls)
    assert (got.numpy() != want).sum() <= 1
    with pytest.raises(ValueError):
        ttag.projective_tag(torch.from_numpy(psi), None, "sr12")
    drawn = ttag.projective_tag(torch.from_numpy(psi),
                                torch.Generator().manual_seed(1), name)
    assert 0.1 < drawn.float().mean() < 0.9


@pytest.mark.parametrize("subtract", [False, True])
def test_tagged_moments_match_jax(subtract):
    rng = np.random.default_rng(4)
    vx = rng.normal(0, 0.7, 300).astype(np.float32)
    tags = rng.uniform(size=300) < 0.4
    want = jtag.tagged_moments(jnp.asarray(vx), jnp.asarray(tags), subtract,
                               2.0)
    got = ttag.tagged_moments(torch.from_numpy(vx), torch.from_numpy(tags),
                              subtract, 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    none = ttag.tagged_moments(torch.from_numpy(vx),
                               torch.zeros(300, dtype=torch.bool))
    np.testing.assert_array_equal(none.numpy(), np.zeros(4, np.float32))


# ----------------------------------------------------------- correlations

def _vstore(T=24, n=40):
    return np.random.default_rng(6).normal(0, 0.8, (T, n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("power", [1, 2, 3, 4])
def test_power_autocorr_matches_jax_and_direct(power):
    v = _vstore()
    got = tcorr.power_autocorr(torch.from_numpy(v), power, 1.5).numpy()
    direct = tcorr.power_autocorr_direct(torch.from_numpy(v), power,
                                         1.5).numpy()
    want = np.asarray(jcorr.power_autocorr(jnp.asarray(v), power, 1.5))
    jdirect = np.asarray(jcorr.power_autocorr_direct(jnp.asarray(v), power,
                                                     1.5))
    assert got.shape == (24,) and got.dtype == np.float32
    scale = max(np.abs(want).max(), np.abs(jdirect).max())
    for name, ref in (("jax fft", want), ("direct", direct),
                      ("jax direct", jdirect)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_autocorr_suite_matches_jax():
    v = _vstore(16, 30)
    got = tcorr.autocorr_suite(torch.from_numpy(v), 2.0)
    want = jcorr.autocorr_suite(jnp.asarray(v), 2.0)
    assert len(got) == 4
    for k in range(4):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    sums = tcorr._autocorr_sums(torch.from_numpy(v[:, 0, 0]))
    np.testing.assert_allclose(
        sums.numpy(), np.asarray(jcorr._autocorr_sums(jnp.asarray(v[:, 0,
                                                                    0]))),
        rtol=0, atol=1e-5 * float(sums.abs().max()))


@pytest.mark.parametrize("masked", [False, True])
def test_streaming_vaf_and_long_kin_match_jax(masked):
    rng = np.random.default_rng(8)
    n = 200
    m = (np.arange(n) < 170).astype(np.float32)
    v0 = rng.normal(0, 0.5, (n, 3)).astype(np.float32) * m[:, None]
    v1 = rng.normal(0, 0.5, (n, 3)).astype(np.float32) * m[:, None]
    w = (rng.uniform(size=n) < 0.5).astype(np.float32)
    mk_j = jnp.asarray(m) if masked else None
    mk_t = torch.from_numpy(m) if masked else None
    t0, t1, tw = (torch.from_numpy(x) for x in (v0, v1, w))
    j0, j1, jw = (jnp.asarray(x) for x in (v0, v1, w))
    cases = [
        (tcorr.streaming_vaf(t1, t0, mask=mk_t),
         jcorr.streaming_vaf(j1, j0, mask=mk_j)),
        (tcorr.streaming_vaf(t1[:, 0], t0[:, 0], x_only=True, mask=mk_t),
         jcorr.streaming_vaf(j1[:, 0], j0[:, 0], x_only=True, mask=mk_j)),
        (tcorr.streaming_vaf(t1, t0, weights=tw, mask=mk_t),
         jcorr.streaming_vaf(j1, j0, weights=jw, mask=mk_j)),
        (tcorr.streaming_long_kin(t1[:, 0], t0[:, 0], mask=mk_t),
         jcorr.streaming_long_kin(j1[:, 0], j0[:, 0], mask=mk_j)),
    ]
    for got, want in cases:
        assert got.dim() == 0 and got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=2e-5,
                                   atol=1e-7)
    if masked:
        # the real count normalizes: the masked value of the padded arrays
        # is the unmasked value of the real lanes alone
        np.testing.assert_allclose(
            float(tcorr.streaming_long_kin(t1[:, 0], t0[:, 0], mask=mk_t)),
            float(tcorr.streaming_long_kin(t1[:170, 0], t0[:170, 0])),
            rtol=1e-5)


# -------------------------------------------------------------------- kde

def test_centered_bins_and_weighted_unfolded_kde_match_jax():
    np.testing.assert_array_equal(tkde.centered_bins_np(),
                                  jkde.centered_bins_np())
    bins = tkde.centered_bins(torch.float32)
    np.testing.assert_array_equal(bins.numpy(),
                                  np.asarray(jkde.centered_bins(jnp.float32)))
    assert tkde.centered_bins(torch.float64).dtype == torch.float64
    rng = np.random.default_rng(2)
    v = rng.normal(0, 0.3, 150).astype(np.float32)
    w = (rng.uniform(size=150) < 0.5).astype(np.float32)
    want = np.asarray(jkde.gaussian_kde(jnp.asarray(v),
                                        jkde.centered_bins(jnp.float32),
                                        folded=False, weights=jnp.asarray(w)))
    got = tkde.gaussian_kde(torch.from_numpy(v), bins, folded=False,
                            weights=torch.from_numpy(w)).numpy()
    assert got.shape == (4001,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert got.max() > 0


def test_frozen_gas_positions():
    L = PlasmaUnits.box_length(200)
    R = tinit.frozen_gas_positions(torch.Generator().manual_seed(3), 200, L)
    Rj = np.asarray(jinit.frozen_gas_positions(jax.random.PRNGKey(3), 200, L))
    assert R.shape == Rj.shape == (200, 3) and R.dtype == torch.float32
    assert 0 <= float(R.min()) and float(R.max()) < L
    assert abs(float(R.mean()) - L / 2) < 0.1 * L
    again = tinit.frozen_gas_init(torch.Generator().manual_seed(3), 200)[0]
    np.testing.assert_array_equal(R.numpy(), again.numpy())


# ------------------------------------------------------ sweep fold tables

UNIT = {"three_state": lambda m=None: three_state(1.0, 1.0),
        "tag422": lambda m=None: tag422(1.0, 1.0),
        "tag408_quad": lambda m=None: tag408(1.0, 1.0, False)}
DETS = [-1.0, -0.3, 2.5]
OMS = [1.3, 0.4, 2.0]


@pytest.mark.parametrize("name", list(UNIT))
def test_sweep_qt_params_match_jax(name):
    scheme = UNIT[name]()
    one_j = jqt.sweep_qt_params(scheme, -0.7, 1.4, jnp.float32,
                                jnp.complex64)
    one_t = tqt.sweep_qt_params(scheme, -0.7, 1.4, torch.float32,
                                torch.complex64, "cpu")
    many_j = jax.vmap(lambda d, o: jqt.sweep_qt_params(
        scheme, d, o, jnp.float32, jnp.complex64))(
            jnp.asarray(DETS, jnp.float32), jnp.asarray(OMS, jnp.float32))
    many_t = tqt.sweep_qt_params(scheme, DETS, OMS, torch.float32,
                                 torch.complex64, "cpu")
    S = scheme.n_states
    assert many_t.e0.shape == (3, S) and many_t.coupling.shape == (3, S, S)
    assert many_t.decay_w.shape == (S,)          # shared tables: unbatched
    for f in jqt.QTParams._fields:
        np.testing.assert_array_equal(getattr(one_t, f).numpy(),
                                      np.asarray(getattr(one_j, f)), f)
    for f in ("e0", "coupling"):
        np.testing.assert_array_equal(getattr(many_t, f).numpy(),
                                      np.asarray(getattr(many_j, f)), f)
    # the bridge carries JAX's batched tables over leaf by leaf
    carried = qt_params_from_numpy(many_j, device="cpu")
    for f in jqt.QTParams._fields:
        assert torch.equal(getattr(carried, f), getattr(many_t, f)), f
    single = qt_params_from_numpy(one_j, device="cpu")
    assert torch.equal(single.coupling, one_t.coupling)
    broken = many_j._replace(decay_w=many_j.decay_w.at[1, 1].add(1.0))
    with pytest.raises(ValueError, match="decay_w"):
        qt_params_from_numpy(broken, device="cpu")


def test_sweep_member_params_match_jax():
    from mdqtplasmasims_tpu.experiments.frozen_tagging import (
        FrozenTagConfig as JCfg)
    from mdqtplasmasims_torch.experiments.frozen_tagging import (
        FrozenTagConfig as TCfg)
    points = [{"detuning": -1.0}, {"om": 0.6}, {"detuning": -4.0, "om": 2.0}]
    mj, pj = jqt.sweep_member_params(JCfg(n0=32), points, 2,
                                     JCfg().scheme_unit(), jnp.float32,
                                     jnp.complex64)
    mt, pt = tqt.sweep_member_params(TCfg(n0=32), points, 2,
                                     TCfg().scheme_unit(), torch.float32,
                                     torch.complex64, "cpu")
    assert [(m.detuning, m.om, m.job) for m in mt] == [
        (m.detuning, m.om, m.job) for m in mj]
    assert len(mt) == 6
    np.testing.assert_array_equal(pt.e0.numpy(), np.asarray(pj.e0))
    np.testing.assert_array_equal(pt.coupling.numpy(),
                                  np.asarray(pj.coupling))
    with pytest.raises(ValueError, match="override"):
        tqt.sweep_member_params(TCfg(n0=32), [{"n0": 64}], 1,
                                TCfg().scheme_unit(), torch.float32,
                                torch.complex64, "cpu")


def _fold_inputs(scheme, E, n, seed):
    rng = np.random.default_rng(seed)
    S = scheme.n_states
    psi = rng.normal(size=(E, S, n)) + 1j * rng.normal(size=(E, S, n))
    psi = (psi / np.linalg.norm(psi, axis=1, keepdims=True)).astype(
        np.complex64)
    vx = rng.normal(0, 0.4, (E, n)).astype(np.float32)
    tp = np.abs(rng.normal(0, 1.0, (E, n))).astype(np.float32)
    rolls = rng.uniform(size=(6, 5, E, n)).astype(np.float32)
    rolls[:, 0] *= 0.02
    return psi, vx, tp, rolls


@pytest.mark.parametrize("n", [37, 96])
@pytest.mark.parametrize("name", list(UNIT))
def test_batched_step_sm_equals_single_calls_bitwise(name, n):
    """Six chained ticks of a fold of three members with their own
    (detuning, om) tables and kick scales, against the three members
    stepped alone; also with tables shared by the fold."""
    scheme = UNIT[name]()
    kw = dict(h=0.01, dt_plasma=0.01, plas_to_quant_vel=1.3,
              gamma_to_einstein=1.0, apply_force=True)
    eng = tqt.QTEngine(scheme, **kw)
    psi, vx, tp, rolls = _fold_inputs(scheme, 3, n, 11)
    many = tqt.sweep_qt_params(scheme, DETS, OMS, torch.float32,
                               torch.complex64, "cpu")
    fs = torch.tensor(OMS)
    for params, scale in ((many, fs), (None, None)):
        fold = tuple(torch.from_numpy(x) for x in (psi, vx, tp))
        for k in range(6):
            fold = eng.step_sm(
                *fold, rolls=torch.from_numpy(rolls[k]), params=params,
                force_scale=None if scale is None else scale[:, None])
        assert int((fold[2] < 0.05).sum()) > 3              # jumps fired
        for e in range(3):
            one = tuple(torch.from_numpy(x[e]) for x in (psi, vx, tp))
            p_e = (None if params is None else tqt.sweep_qt_params(
                scheme, DETS[e], OMS[e], torch.float32, torch.complex64,
                "cpu"))
            for k in range(6):
                one = eng.step_sm(
                    *one, rolls=torch.from_numpy(rolls[k][:, e]), params=p_e,
                    force_scale=None if scale is None else OMS[e])
            for a, b, what in zip(fold, one, ("psi", "vx", "t_part")):
                assert torch.equal(a[e], b), (what, e)


@pytest.mark.parametrize("name", list(UNIT))
def test_batched_step_sm_matches_jax_vmap(name):
    scheme = UNIT[name]()
    kw = dict(h=0.01, dt_plasma=0.01, plas_to_quant_vel=1.3,
              gamma_to_einstein=1.0, apply_force=True)
    je, te = jqt.QTEngine(scheme, **kw), tqt.QTEngine(scheme, **kw)
    psi, vx, tp, rolls = _fold_inputs(scheme, 3, 64, 12)
    pj = jax.vmap(lambda d, o: jqt.sweep_qt_params(
        scheme, d, o, jnp.float32, jnp.complex64))(
            jnp.asarray(DETS, jnp.float32), jnp.asarray(OMS, jnp.float32))
    pt = qt_params_from_numpy(pj, device="cpu")
    sj = (jnp.asarray(psi), jnp.asarray(vx), jnp.asarray(tp))
    st = tuple(torch.from_numpy(x) for x in (psi, vx, tp))
    step = jax.vmap(lambda a, b, c, r, p, f: je.step_sm(
        a, b, c, rolls=r, params=p, force_scale=f))
    for k in range(6):
        sj = step(*sj, jnp.asarray(rolls[k]).transpose(1, 0, 2), pj,
                  jnp.asarray(OMS, jnp.float32))
        st = te.step_sm(*st, rolls=torch.from_numpy(rolls[k]), params=pt,
                        force_scale=torch.tensor(OMS)[:, None])
    np.testing.assert_allclose(st[0].numpy(), np.asarray(sj[0]), atol=5e-5)
    np.testing.assert_allclose(st[1].numpy(), np.asarray(sj[1]), atol=2e-5)
    np.testing.assert_allclose(st[2].numpy(), np.asarray(sj[2]), atol=2e-5)


# -------------------------------- the [E, N, 3] entry, per-member masks

def _masked_members(e, n0, seed):
    L = PlasmaUnits.box_length(n0)
    rng = np.random.default_rng(seed)
    R = rng.uniform(0, L, (e, n0, 3)).astype(np.float32)
    mask = np.ones((e, n0), np.float32)
    for j in range(e):
        mask[j, n0 - 7 * (j + 1):] = 0.0          # a different tail each
    mask[0, 5] = 0.0                              # and a hole inside
    return R * mask[..., None], mask, L, PlasmaUnits(2.0, 0.1).debye_length


def test_batched_force_entry_per_member_mask():
    """One call over the fold with a holed ``[E, N]`` mask: each member
    equals its own ``[N, 3]`` call bit for bit, masked rows are exactly 0,
    a masked ion exerts nothing, and the result matches the JAX entry
    lifted over the members (its kernel in interpret mode)."""
    R, mask, L, ldeb = _masked_members(3, 300, 5)
    Rt, mt = torch.from_numpy(R), torch.from_numpy(mask)
    F = ty.yukawa_forces_n3l_pallas_batched(Rt, L, ldeb, tile=128, mask=mt)
    assert F.shape == (3, 300, 3)
    for j in range(3):
        one = ty.yukawa_forces_n3l_pallas(Rt[j], L, ldeb, mask=mt[j],
                                          tile=128)
        assert torch.equal(F[j], one), j
        assert not F[j][mask[j] == 0].any()
    moved = Rt.clone()
    moved[0, 5] = torch.tensor([1.0, 2.0, 3.0])   # a masked ion elsewhere
    assert torch.equal(
        ty.yukawa_forces_n3l_pallas_batched(moved, L, ldeb, tile=128,
                                            mask=mt), F)
    shared = ty.yukawa_forces_n3l_pallas_batched(Rt, L, ldeb, tile=128,
                                                 mask=mt[2])
    assert torch.equal(shared[2], F[2]) and not torch.equal(shared[0], F[0])
    want = np.asarray(jax.vmap(lambda r, m: jy.yukawa_forces_n3l_pallas(
        r, L, ldeb, mask=m, tile=128, interpret=True))(jnp.asarray(R),
                                                       jnp.asarray(mask)))
    np.testing.assert_allclose(F.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="mask"):
        ty.yukawa_forces_n3l_pallas_batched(Rt, L, ldeb, mask=mt[:2])


@pytest.mark.parametrize("use_pallas", [None, True, False])
def test_best_forces_fn_batched_equals_member_calls(use_pallas):
    """The fold's chooser gives every member what ``best_forces_fn`` gives
    it alone: the same form of result (potential or None) and, on the CPU,
    the same bits."""
    R, mask, L, ldeb = _masked_members(2, 200, 6)
    Rt, mt = torch.from_numpy(R), torch.from_numpy(mask)
    F, pot = ty.best_forces_fn_batched(200, L, ldeb, mask=mt,
                                       use_pallas=use_pallas)(Rt)
    for j in range(2):
        F1, pot1 = ty.best_forces_fn(200, L, ldeb, mask=mt[j],
                                     use_pallas=use_pallas)(Rt[j])
        assert torch.equal(F[j], F1)
        assert (pot is None) == (pot1 is None) == bool(use_pallas)
        if pot is not None:
            assert torch.equal(pot[j], pot1)
