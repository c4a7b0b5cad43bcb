"""What the tick kernel's launch needs of the host: the sparse coupling
rows, the lane table, the per-spec cache and the launch geometry
(mdqtplasmasims_torch/core/qt_fused.py), on the CPU.

The CUDA kernel (csrc/fused_ticks.cu) gives each state of an ion to one
lane of a group and reads its tables lane by lane (S = 12), or each ion
to one thread with the scheme's tables by value and its coupling pattern
compiled in (S = 3, 5, 7).  ``lane_model`` below is that data flow in
numpy (a lane axis, shuffles as index lookups, xor butterflies, the scan,
the ballots; at S = 3, 5, 7 ``ion_model``: a state axis summed in state
order over the pattern's places), fed by the same lane or ion table the
kernel gets; it is held to the plain twin at the
kernel's own bars (R/V/tp 2e-5, psi 5e-5 + 1e-4 relative, pads exactly
0), so a wrong index, sign or padding entry in the table fails here,
without a card."""

import dataclasses

import numpy as np
import pytest
import torch

from mdqtplasmasims_torch.core import qt_fused as tf
from mdqtplasmasims_torch.experiments import laser_cooling as tlc
from mdqtplasmasims_torch.levels import (sr12_cooling, tag408, tag422,
                                         three_state, with_recoil)

torch.set_num_threads(1)

H, QDT, P2Q, G2E = 0.00985, 8e-5, 1.327, 123.1
f32 = np.float32


def _spec(scheme, ratio=4, **kw):
    base = dict(scheme=scheme, h=H, qdt=QDT, plas_to_quant_vel=P2Q,
                gamma_to_einstein=G2E, ratio=ratio, L=7.5, apply_force=True)
    base.update(kw)
    return tf.FusedTickSpec(**base)


def _om_spec(ratio=4, **kw):
    ssp, sdp = tlc.om_split_schemes(tlc.CoolingConfig(n0=64))
    return _spec(with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4), ratio,
                 per_lane_om=True, scheme_sp=ssp, scheme_dp=sdp, **kw)


SCHEMES = {
    "sr12_speedup": lambda: sr12_cooling(),
    "sr12_pre_speedup": lambda: sr12_cooling(gs_convention="pre_speedup"),
    "sr12_sp_pattern": lambda: sr12_cooling(om=1.0, om_dp=0.0),
    "sr12_dp_pattern": lambda: sr12_cooling(om=0.0, om_dp=1.0),
    "three_state": lambda: three_state(),
    # a beat-note term on the two excited states: the S = 3 kernel's
    # complex-row path (no reference three-state scheme has one)
    "three_state_beat": lambda: dataclasses.replace(
        three_state(), name="three_state_beat", tdep_rows=(1,),
        tdep_cols=(2,), tdep_coefs=(0.05,), tdep_freq=0.7),
    "tag408_linear": lambda: tag408(-1.0, 0.5, True),
    "tag408_circular": lambda: tag408(-1.0, 0.5, False),
    "tag422": lambda: tag422(),
    # an Ehrenfest term on a coupled pair of the 408 linear pump (the ion
    # kernel's masked pair loop) and a beat note on a coupled pair of the
    # 422 pump (its masked complex row); no reference pump has either
    "tag408_kick": lambda: dataclasses.replace(
        tag408(-1.0, 0.5, True), name="tag408_kick", force_a=(0, 1),
        force_b=(2, 5), force_w=(2e-3, -1e-3)),
    "tag422_beat": lambda: dataclasses.replace(
        tag422(), name="tag422_beat", tdep_rows=(1,), tdep_cols=(2,),
        tdep_coefs=(0.05,), tdep_freq=0.7),
}


def _dense(cols, coefs):
    """The dense block a row list stands for."""
    out = np.zeros((cols.shape[0], cols.shape[0]), coefs.dtype)
    for s in range(cols.shape[0]):
        for k in range(cols.shape[1]):
            out[s, cols[s, k]] += coefs[s, k]
    return out


@pytest.mark.parametrize("name", list(SCHEMES))
def test_row_lists_rebuild_the_packed_coupling_block(name):
    spec = _spec(SCHEMES[name]())
    _, mats = tf.pack_tables(spec)
    block = mats[:spec.SP]
    cols, coefs = tf.coupling_rows(block)
    np.testing.assert_array_equal(_dense(cols, coefs[0]), block)
    counts = (block != 0).sum(1)
    assert cols.shape[1] == max(1, counts.max())        # K: the longest row
    assert cols.shape[1] <= 3                           # the register path
    for s in range(spec.SP):
        c = int(counts[s])
        assert list(cols[s, :c]) == sorted(cols[s, :c])     # ascending
        assert np.all(cols[s, c:] == s) and np.all(coefs[0, s, c:] == 0.0)


def test_row_lists_of_the_om_split_share_one_pattern():
    spec = _om_spec()
    _, mats = tf.pack_tables(spec)
    SP = spec.SP
    cols, coefs = tf.coupling_rows(mats[:SP], mats[4 * SP:5 * SP])
    np.testing.assert_array_equal(_dense(cols, coefs[0]), mats[:SP])
    np.testing.assert_array_equal(_dense(cols, coefs[1]), mats[4 * SP:])
    # disjoint parts of the full scheme's coupling: at most 3 in a row
    assert cols.shape[1] == 3
    assert not np.any((coefs[0] != 0) & (coefs[1] != 0))
    full = tf.pack_tables(_spec(sr12_cooling()))[1][:SP]
    np.testing.assert_allclose(_dense(cols, coefs[0] + coefs[1]), full,
                               rtol=1e-7)


def test_dense_table_gives_full_rows_and_round_trips():
    rng = np.random.default_rng(0)
    S = 12
    block = rng.normal(size=(S, S)).astype(f32)
    block = block + block.T
    cols, coefs = tf.coupling_rows(block)
    assert cols.shape == (S, S) and np.all(cols == np.arange(S))
    np.testing.assert_array_equal(_dense(cols, coefs[0]), block)
    # an empty table still has one (padding) entry a row
    cols, coefs = tf.coupling_rows(np.zeros((8, 8), f32))
    assert cols.shape == (8, 1) and not coefs.any()


def test_complex_tables_are_refused():
    block = np.zeros((8, 8), np.complex64)
    block[0, 1] = block[1, 0] = 0.5
    cols, coefs = tf.coupling_rows(block)          # complex type, real values
    assert coefs.dtype == np.float32 and coefs[0, 0, 0] == 0.5
    block[0, 1], block[1, 0] = 0.5j, -0.5j
    with pytest.raises(ValueError, match="real coupling"):
        tf.coupling_rows(block)
    sch = sr12_cooling()
    bad = dataclasses.replace(sch, coupling=sch.coupling * (1 + 0.5j))
    with pytest.raises(ValueError, match="real coupling"):
        tf._kernel_plan(_spec(bad))
    planes = [torch.zeros((r, 128)) for r in (3, 3, 3, 1, 16, 16, 20)]
    for _ in range(2):                  # refused every time, not only once
        with pytest.raises(ValueError, match="real coupling"):
            tf.fused_md_substeps(_spec(bad), False, *planes)


@pytest.mark.parametrize("field, value", [
    ("h", 0.5 * H), ("qdt", 2 * QDT), ("ratio", 5), ("L", 8.0),
    ("apply_force", False), ("exp_c1", 0.01), ("renormalize", True),
    ("internal_rng", True), ("per_lane_e0", True), ("scheme", None)])
def test_plan_is_cached_per_spec(field, value):
    sch = sr12_cooling()
    a, b = _spec(sch), _spec(sch)
    assert a is not b and a == b
    plan = tf._kernel_plan(a)
    assert tf._kernel_plan(b) is plan                   # equal specs: one plan
    assert tf._kernel_plan(b).params is plan.params
    assert tf._lane_table_on(a, torch.device("cpu")) is tf._lane_table_on(
        b, torch.device("cpu"))
    if field == "scheme":               # another scheme object, same numbers
        value = sr12_cooling()
    other = tf._kernel_plan(dataclasses.replace(a, **{field: value}))
    assert other is not plan and other.params is not plan.params
    np.testing.assert_array_equal(other.lane_table, plan.lane_table)


def test_plan_of_the_om_split_differs_from_the_plain_one():
    plain, split = tf._kernel_plan(_spec(sr12_cooling())), tf._kernel_plan(
        _om_spec())
    K = plain.K
    assert split.K == K == 3
    tabs = [x.lane_table.reshape(16, len(tf.ROW_PLANES), K)
            for x in (plain, split)]
    # the same columns, the coefficients split over the two patterns
    np.testing.assert_array_equal(tabs[1][:, 0], tabs[0][:, 0])
    assert tabs[1][:, 2].any() and not tabs[0][:, 2].any()
    np.testing.assert_allclose(tabs[1][:, 1] + tabs[1][:, 2], tabs[0][:, 1],
                               rtol=1e-7)
    # beat notes and Ehrenfest weights ride on the same entries in both
    np.testing.assert_allclose(tabs[1][:, 3:5], tabs[0][:, 3:5], rtol=1e-7)
    np.testing.assert_array_equal(tabs[1][:, 5] != 0, tabs[0][:, 5] != 0)
    # 4 Ehrenfest terms of group 0 (x om), 8 of group 1 (x om_dp)
    weighted = tabs[1][:, 5] != 0
    assert weighted.sum() == 12 and not tabs[0][:, 6].any()
    assert (tabs[1][:, 6][weighted] == 1).sum() == 8


def test_terms_ride_on_the_row_entries():
    """Each beat-note term sits on both of its states' rows with opposite
    phase signs, each Ehrenfest term on one entry of its pair, and rows
    grow only where a term's pair is no coupling entry."""
    plan = tf._kernel_plan(_spec(sr12_cooling()))
    p, K = plan.params, plan.K
    tab = plan.lane_table.reshape(16, len(tf.ROW_PLANES), K)
    cols = tab[:, 0].astype(int)
    for t in range(p.n_tdep):
        r, cl, m = p.tdep_row[t], p.tdep_col[t], p.tdep_coef[t]
        (k,), (j,) = np.flatnonzero(cols[r] == cl), np.flatnonzero(
            cols[cl] == r)
        assert tuple(tab[r, 3:5, k]) == (m, m)
        assert tuple(tab[cl, 3:5, j]) == (m, -m)
    assert np.count_nonzero(tab[:, 3]) == 2 * p.n_tdep
    total = 0.0
    for k in range(p.n_force):
        a, b, w = p.force_a[k], p.force_b[k], p.force_w[k]
        held = [tab[a, 5, j] for j in np.flatnonzero(cols[a] == b)] + [
            -tab[b, 5, j] for j in np.flatnonzero(cols[b] == a)]
        assert sorted(held, key=abs)[-1] == w and np.count_nonzero(held) == 1
        total += abs(w)
    np.testing.assert_allclose(np.abs(tab[:, 5]).sum(), total, rtol=1e-6)
    # a term on a pair with no coupling adds an entry (three_state row 1)
    sch = three_state()
    more = dataclasses.replace(sch, force_a=sch.force_a + (1,),
                               force_b=sch.force_b + (2,),
                               force_w=sch.force_w + (1e-3,))
    wide = tf._kernel_plan(_spec(more))
    base = tf._kernel_plan(_spec(sch))
    assert (base.K, wide.K) == (2, 2)
    t3 = wide.lane_table.reshape(8, len(tf.ROW_PLANES), 2)
    assert list(t3[1, 0]) == [0, 2] and t3[1, 1, 1] == 0 and t3[1, 5, 1] == \
        np.float32(1e-3)


@pytest.mark.parametrize("npad, S, K, want", [
    (3584, 12, 3, (16, 128, 448, 2048)),
    (1792, 12, 3, (16, 128, 224, 2048)),
    (4 * 3584, 12, 3, (16, 128, 1792, 2048)),
    (3584, 12, 12, (16, 128, 448, 2048 + 4 * 16 * 84)),
    (128, 7, 2, (1, 32, 4, 2560)),
    (4096, 7, 2, (1, 32, 128, 2560)),
    (128, 5, 1, (1, 32, 4, 2560)),
    (3584, 5, 1, (1, 32, 112, 2560)),
    (256, 3, 2, (1, 32, 8, 2560)),
])
def test_launch_geometry_reads_only_its_arguments(npad, S, K, want):
    geo = tf.launch_geometry(npad, S, K)
    assert tuple(geo) == want
    assert geo.blocks * (geo.threads // geo.lanes_per_ion) == npad
    # a group holds one state a lane; at S = 3, 5, 7 a thread holds the ion
    assert (geo.lanes_per_ion == 1) == (S in (3, 5, 7))
    assert geo.lanes_per_ion >= S or geo.lanes_per_ion == 1
    tf._kernel_plan(_spec(sr12_cooling()))        # other state of the module
    assert tf.launch_geometry(npad, S, K) == geo
    assert tf.lane_table_width(K) == 7 * K


def test_more_terms_than_lanes_still_fit():
    """Ehrenfest terms ride on row entries, so their number is not bound by
    the group's width (S = 3: 4 lanes); two on one pair add up."""
    sch = three_state()
    many = dataclasses.replace(sch, force_a=(0,) * 5, force_b=(1,) * 5,
                               force_w=(1e-3,) * 5)
    plan = tf._kernel_plan(_spec(many))
    tab = plan.lane_table.reshape(8, len(tf.ROW_PLANES), plan.K)
    assert plan.params.n_force == 5
    np.testing.assert_allclose(tab[0, 5, 0], 5e-3, rtol=1e-6)
    assert np.count_nonzero(tab[:, 5]) == 1


@pytest.mark.parametrize("name", ["sr12_speedup", "three_state",
                                  "tag408_linear"])
def test_sparse_row_sum_equals_dense_sum_bit_for_bit(name):
    """Adding the table's zeros changes no value: the sparse sum over a
    row's entries in column order is the dense float32 sum, bit for bit."""
    spec = _spec(SCHEMES[name]())
    _, mats = tf.pack_tables(spec)
    block = mats[:spec.SP]
    cols, coefs = tf.coupling_rows(block)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(spec.SP, 257)).astype(f32)
    dense = np.zeros_like(x)
    for c in range(spec.SP):                  # column order, float32
        dense = dense + block[:, c:c + 1] * x[c:c + 1]
    sparse = np.zeros_like(x)
    for k in range(cols.shape[1]):
        sparse = sparse + coefs[0][:, k:k + 1] * x[cols[:, k]]
    assert dense.dtype == sparse.dtype == np.float32
    np.testing.assert_array_equal(sparse, dense)


# ---- the kernel's data flow, lane by lane, in numpy ----

def ion_model(spec, first, R, V, F, tp, pre, pim, rolls, tick0=0,
              e0_lanes=None, om_lanes=None):
    """csrc/fused_ticks.cu's ion kernel (S = 3, 5, 7; one thread an ion):
    arrays are ``[n]`` per state, the tables the plan's ion table, every
    sum over states taken in state order (dp over the pattern's decaying
    states, the Ehrenfest sum over its pairs s < c where the spec kicks),
    H phi in column order over the places of the plan's compiled pattern
    and the decay terms of its decaying states, the collapse's result
    taken only where an ion jumps."""
    plan = tf._kernel_plan(spec)
    p, S, SP = plan.params, spec.S, spec.SP
    on = lambda s, k: bool((plan.pattern >> (s * S + k)) & 1)
    decays = lambda s: bool((plan.pattern >> (S * S + s)) & 1)
    t = tf.ion_fields(plan.ion_table, S)
    n = R.shape[1]
    c = lambda x: f32(x)
    pom = spec.per_lane_om
    om, omdp = (om_lanes[0], om_lanes[1]) if pom else (c(1), c(1))
    e0 = (e0_lanes[:S] if spec.per_lane_e0
          else np.broadcast_to(t["e0"][:, None], (S, n)))
    coef = [[om * t["c_sp"][s, k] + omdp * t["c_dp"][s, k] if pom
             else t["c_sp"][s, k] for k in range(S)] for s in range(S)]
    tm = [[omdp * t["tdep_m"][s, k] if pom else t["tdep_m"][s, k]
           for k in range(S)] for s in range(S)]
    tms = [[omdp * t["tdep_m_signed"][s, k] if pom
            else t["tdep_m_signed"][s, k] for k in range(S)]
           for s in range(S)]
    pairs = [(s, k) for s in range(S) for k in range(s + 1, S)]
    pw = [np.where(t["pair_g"][j] != 0, omdp, om) * t["pair_w"][j] if pom
          else t["pair_w"][j] for j in range(len(pairs))]
    w, e1, msk = t["w"], t["e1"], t["msk"]

    def wrap(x):
        x = np.where(x < 0, x + c(p.L), x)
        return np.where(x > c(p.L), x - c(p.L), x)

    r, v, f = R.copy(), V.copy(), F.copy()
    tp = tp[0].copy()
    a = [pre[s].copy() for s in range(S)]
    b = [pim[s].copy() for s in range(S)]
    hq, h, inv_h = c(p.half_qdt), c(p.h), c(1) / c(p.h)
    for i in range(p.n_ticks):
        rl = rolls[i * 5:i * 5 + 5]
        fsq = c(c(1.0 if (first and i == 0) else 0.0) * hq) * hq
        r = wrap(r + hq * v + fsq * f)
        v = v + c(p.qdt) * f
        r = wrap(r + hq * v + fsq * f)
        tp = tp + c(p.qdt)
        u = v[0] * c(p.p2q)
        if p.has_exp:
            tpl = c(c(tick0) + c(i)) * c(p.qdt)
            u = u + c(c(p.exp_c1) * tpl) / np.sqrt(
                c(1) + c(p.exp_c2) * tpl * tpl, dtype=f32)
        beat = p.n_tdep > 0
        if beat:
            ang = (c(p.tdep_freq) * u) * (tp * c(p.g2e))
            cphi, sphi = np.cos(ang), np.sin(ang)
            cr = [[coef[s][k] + tm[s][k] * cphi for k in range(S)]
                  for s in range(S)]
            ci = [[tms[s][k] * sphi for k in range(S)] for s in range(S)]
        diag = [e0[s] + e1[s] * u for s in range(S)]

        def slope(sa, sb):
            dps = c(0)
            for s in range(S):
                if decays(s):
                    dps = dps + w[s] * (sa[s] * sa[s] + sb[s] * sb[s])
            pref = c(1) / np.sqrt(c(1) - np.clip(h * dps, c(0), c(0.9)))
            ka, kb = [], []
            for s in range(S):
                re = im = c(0)
                for k in range(S):
                    if not on(s, k):
                        continue
                    if beat:
                        re = re + (cr[s][k] * sa[k] - ci[s][k] * sb[k])
                        im = im + (cr[s][k] * sb[k] + ci[s][k] * sa[k])
                    else:
                        re = re + coef[s][k] * sa[k]
                        im = im + coef[s][k] * sb[k]
                re, im = re + diag[s] * sa[s], im + diag[s] * sb[s]
                hw = c(-0.5) * w[s]
                if decays(s):
                    re, im = re - hw * sb[s], im + hw * sa[s]
                ka.append((pref * (sa[s] + h * im) - sa[s]) * inv_h)
                kb.append((pref * (sb[s] - h * re) - sb[s]) * inv_h)
            return ka, kb, dps

        ka, kb, dp0 = slope(a, b)
        acca, accb = ka, kb
        stage = lambda x, k, m: [x[s] + m * k[s] for s in range(S)]
        ka, kb, _ = slope(stage(a, ka, c(p.half_h)), stage(b, kb, c(p.half_h)))
        acca = [acca[s] + c(3) * ka[s] for s in range(S)]
        accb = [accb[s] + c(3) * kb[s] for s in range(S)]
        ka, kb, _ = slope(stage(a, ka, c(p.half_h)), stage(b, kb, c(p.half_h)))
        acca = [acca[s] + c(3) * ka[s] for s in range(S)]
        accb = [accb[s] + c(3) * kb[s] for s in range(S)]
        ka, kb, _ = slope(stage(a, ka, h), stage(b, kb, h))
        acca = [acca[s] + ka[s] for s in range(S)]
        accb = [accb[s] + kb[s] for s in range(S)]

        kick = c(0)
        for j, (s, k) in enumerate(pairs):
            if (S == 3 or p.apply_kick) and (on(s, k) or on(k, s)):
                kick = kick + pw[j] * (b[s] * a[k] - a[s] * b[k])
        kick_nj = kick * h
        jumped = rl[0] < h * dp0
        cum, run = [], None
        for s in range(S):
            x = (a[s] * a[s] + b[s] * b[s]) * msk[s]
            run = x if run is None else run + x
            cum.append(run)
        tot = np.maximum(cum[-1], c(1e-30))
        src = np.minimum(sum((rl[1] * tot >= cum[s]).astype(int)
                             for s in range(S)), S - 1)
        d_branch = rl[2] < c(p.branch_d)
        dest = np.minimum(sum((rl[4] >= np.where(
            d_branch, t["cum_d"][src, d], t["cum_s"][src, d])).astype(int)
            for d in range(S)), S - 1)
        kick_j = (np.where(rl[3] < c(0.5), c(1), c(-1))
                  * np.where(d_branch, c(p.kick_d), c(p.kick_s))
                  if p.apply_recoil else np.zeros_like(tp))
        a = [np.where(jumped, (dest == s).astype(f32),
                      a[s] + acca[s] * c(p.h8)) for s in range(S)]
        b = [np.where(jumped, c(0), b[s] + accb[s] * c(p.h8))
             for s in range(S)]
        tp = np.where(jumped, c(0), tp)
        if p.renormalize:
            nn = c(0)
            for s in range(S):
                nn = nn + (a[s] * a[s] + b[s] * b[s])
            nrm = np.sqrt(nn)
            inv = np.where(nrm > 0, c(1) / np.where(nrm > 0, nrm, c(1)), c(0))
            a, b = [x * inv for x in a], [x * inv for x in b]
        if p.apply_kick:
            v = v.copy()
            v[0] = v[0] + np.where(jumped, kick_j, kick_nj)
    outs = [r, v, tp[None], np.zeros((SP, n), f32), np.zeros((SP, n), f32)]
    outs[3][:S], outs[4][:S] = a, b
    for x in (r, v, tp, *a, *b):
        assert x.dtype == np.float32
    return outs


def lane_model(spec, first, R, V, F, tp, pre, pim, rolls, tick0=0,
               e0_lanes=None, om_lanes=None):
    """csrc/fused_ticks.cu's tick loop with a lane axis: arrays are
    ``[G, n]``, lane s of every ion's group along axis 0; a shuffle from
    lane ``idx[s]`` is ``x[idx]``.  At S = 3, 5, 7 the kernel's own data
    flow, :func:`ion_model`."""
    if tf.launch_geometry(128, spec.S, 1).lanes_per_ion == 1:
        return ion_model(spec, first, R, V, F, tp, pre, pim, rolls, tick0,
                         e0_lanes, om_lanes)
    plan = tf._kernel_plan(spec)
    p, K, tab = plan.params, plan.K, plan.lane_table
    S, SP = spec.S, spec.SP
    G = tf.launch_geometry(128, S, K).lanes_per_ion
    vecs, mats = tf.pack_tables(spec)
    n = R.shape[1]
    s = np.arange(G)[:, None]
    live = s < S
    c = lambda x: f32(x)
    w, e1, msk = (vecs[:G, k:k + 1] for k in (0, 2, 3))
    e0 = e0_lanes[:G] if spec.per_lane_e0 else vecs[:G, 1:2]
    pom = spec.per_lane_om
    om, omdp = (om_lanes[0:1], om_lanes[1:2]) if pom else (c(1), c(1))
    hw = c(-0.5) * w
    tab = tab.reshape(SP, len(tf.ROW_PLANES), K)[:G]
    col = tab[:, 0].astype(int)                              # [G, K]
    plane = lambda j, k: tab[:, j, k:k + 1]
    coef = [om * plane(1, k) + omdp * plane(2, k) if pom else plane(1, k)
            for k in range(K)]
    scale = omdp if pom else c(1)
    tm = [scale * plane(3, k) for k in range(K)]
    tms = [scale * plane(4, k) for k in range(K)]
    # SP terms (group 0) x om, DP terms x om_dp
    fw = [np.where(plane(6, k) != 0, omdp, om) * plane(5, k) if pom
          else plane(5, k) for k in range(K)]
    cumS, cumD = mats[SP:2 * SP].T, mats[2 * SP:3 * SP].T      # [src, dest]

    def gsum(v):
        m = G // 2
        while m >= 1:
            v = v + v[np.arange(G) ^ m]
            m //= 2
        return v

    def wrap(x):
        x = np.where(x < 0, x + c(p.L), x)
        return np.where(x > c(p.L), x - c(p.L), x)

    axis = s < 3
    pick3 = np.minimum(np.arange(G), 2)
    r = np.where(axis, R[pick3], c(0))
    v = np.where(axis, V[pick3], c(0))
    f = np.where(axis, F[pick3], c(0))
    tp = np.broadcast_to(tp, (G, n)).copy()
    pick = np.minimum(np.arange(G), SP - 1)
    a = np.where(live, pre[pick], c(0))
    b = np.where(live, pim[pick], c(0))
    hq, h, inv_h = c(p.half_qdt), c(p.h), c(1) / c(p.h)
    for i in range(p.n_ticks):
        rl = rolls[i * 5:i * 5 + 5]
        roll_s, roll_4 = rl[np.minimum(np.arange(G), 3)], rl[4:5]
        fsq = c(c(1.0 if (first and i == 0) else 0.0) * hq) * hq
        r = wrap(r + hq * v + fsq * f)
        v = v + c(p.qdt) * f
        r = wrap(r + hq * v + fsq * f)
        tp = tp + c(p.qdt)
        u = v[np.zeros(G, int)] * c(p.p2q)
        if p.has_exp:
            tpl = c(c(tick0) + c(i)) * c(p.qdt)
            u = u + c(c(p.exp_c1) * tpl) / np.sqrt(
                c(1) + c(p.exp_c2) * tpl * tpl, dtype=f32)
        ang = (c(p.tdep_freq) * u) * (tp * c(p.g2e))
        cphi, sphi = np.cos(ang), np.sin(ang)
        diag = e0 + e1 * u

        cr = [coef[k] + tm[k] * cphi for k in range(K)]
        ci = [tms[k] * sphi for k in range(K)]

        def slope(sa, sb):
            dps = gsum(w * (sa * sa + sb * sb))
            pref = c(1) / np.sqrt(c(1) - np.clip(h * dps, c(0), c(0.9)))
            re, im = np.zeros_like(sa), np.zeros_like(sb)
            kick = np.zeros_like(sa)
            for k in range(K):
                pa, pb = sa[col[:, k]], sb[col[:, k]]
                re = re + (cr[k] * pa - ci[k] * pb)
                im = im + (cr[k] * pb + ci[k] * pa)
                kick = kick + fw[k] * (sb * pa - sa * pb)
            re, im = re + diag * sa, im + diag * sb
            re, im = re - hw * sb, im + hw * sa
            return ((pref * (sa + h * im) - sa) * inv_h,
                    (pref * (sb - h * re) - sb) * inv_h, dps, kick)

        ka, kb, dp0, kick_part = slope(a, b)
        acca, accb = ka, kb
        ka, kb, _, _ = slope(a + c(p.half_h) * ka, b + c(p.half_h) * kb)
        acca, accb = acca + c(3) * ka, accb + c(3) * kb
        ka, kb, _, _ = slope(a + c(p.half_h) * ka, b + c(p.half_h) * kb)
        acca, accb = acca + c(3) * ka, accb + c(3) * kb
        ka, kb, _, _ = slope(a + h * ka, b + h * kb)
        acca, accb = acca + ka, accb + kb

        kick_nj = gsum(kick_part) * h
        r0 = roll_s[np.zeros(G, int)]
        jumped = r0 < h * dp0
        r1, r2, r3 = (roll_s[np.full(G, k)] for k in (1, 2, 3))
        cum = (a * a + b * b) * msk
        d = 1
        while d < G:
            below = cum[np.maximum(np.arange(G) - d, 0)]
            cum = np.where(s >= d, cum + below, cum)
            d *= 2
        tot = np.maximum(cum[np.full(G, S - 1)], c(1e-30))
        src = np.minimum((live & (r1 * tot >= cum)).sum(0), S - 1)
        d_branch = r2 < c(p.branch_d)
        look = np.where(d_branch, cumD[src][:, :G].T, cumS[src][:, :G].T)
        dest = np.minimum((live & (roll_4 >= look)).sum(0), S - 1)
        kick_j = (np.where(r3 < c(0.5), c(1), c(-1))
                  * np.where(d_branch, c(p.kick_d), c(p.kick_s))
                  if p.apply_recoil else np.zeros_like(r3))
        a = np.where(jumped, (s == dest).astype(f32), a + acca * c(p.h8))
        b = np.where(jumped, c(0), b + accb * c(p.h8))
        tp = np.where(jumped, c(0), tp)
        if p.renormalize:
            nrm = np.sqrt(gsum(a * a + b * b))
            inv = np.where(nrm > 0, c(1) / np.where(nrm > 0, nrm, c(1)), c(0))
            a, b = a * inv, b * inv
        if p.apply_kick:
            v = np.where(s == 0, v + np.where(jumped, kick_j, kick_nj), v)
    outs = [np.zeros((3, n), f32), np.zeros((3, n), f32), tp[0:1],
            np.zeros((SP, n), f32), np.zeros((SP, n), f32)]
    outs[0][:], outs[1][:] = r[:3], v[:3]
    outs[3][:S], outs[4][:S] = a[:S], b[:S]
    for x in (r, v, a, b, tp):
        assert x.dtype == np.float32
    return outs


def _planes(S, SP, n_real, npad, ratio, excited, seed):
    rng = np.random.default_rng(seed)
    on = (np.arange(npad) < n_real).astype(f32)[None]
    psi = np.zeros((SP, npad), np.complex128)
    if excited and S == 12:
        psi[2], psi[4], psi[0] = 0.7, 0.5j, 0.51
    elif excited:
        psi[:S] = (rng.normal(size=(S, npad))
                   + 1j * rng.normal(size=(S, npad)))
        psi /= np.sqrt((np.abs(psi) ** 2).sum(0))
    else:
        r1, r2 = rng.uniform(size=(2, npad))
        psi[0] = np.sqrt(r1)
        psi[1] = np.sqrt(1 - r1) * (np.sqrt(r2) + 1j * np.sqrt(1 - r2))
    lanes = lambda x: (x * on).astype(f32)
    return dict(R=lanes(rng.uniform(0, 7.5, (3, npad))),
                V=lanes(rng.normal(0, 0.3, (3, npad))),
                F=lanes(rng.normal(0, 0.5, (3, npad))),
                tp=lanes(np.abs(rng.normal(0, 1, (1, npad)))),
                psi_re=lanes(psi.real), psi_im=lanes(psi.imag),
                rolls=rng.uniform(size=(ratio * 5, npad)).astype(f32))


ARGS = ("R", "V", "F", "tp", "psi_re", "psi_im", "rolls")
BARS = (2e-5, 2e-5, 2e-5, 5e-5, 5e-5)


def _hold(spec, p, n_real, first, tick0, e0p=None, omp=None, jumps=0):
    twin = tf.fused_md_substeps(
        spec, first, *(torch.from_numpy(p[k]) for k in ARGS), tick0=tick0,
        e0_lanes=None if e0p is None else torch.from_numpy(e0p),
        om_lanes=None if omp is None else torch.from_numpy(omp))
    model = lane_model(spec, first, *(p[k] for k in ARGS), tick0=tick0,
                       e0_lanes=e0p, om_lanes=omp)
    for name, m, t, atol in zip(ARGS, model, twin, BARS):
        np.testing.assert_allclose(m, t.numpy(), atol=atol, rtol=1e-4,
                                   err_msg=name)
    for m in model[3:]:
        assert not m[spec.S:].any() and not m[:, n_real:].any()
    assert int((model[2][0, :n_real] < spec.ratio * QDT).sum()) >= jumps


@pytest.mark.parametrize("excited", [False, True])
@pytest.mark.parametrize("variant", ["plain", "expansion_renormalize",
                                     "no_force"])
def test_lane_model_sr12_matches_twin(variant, excited):
    kw = dict(plain={}, no_force=dict(apply_force=False),
              expansion_renormalize=dict(exp_c1=0.0423, exp_c2=8.5e-5,
                                         renormalize=True))[variant]
    ratio = 20 if excited else 5
    spec = _spec(with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4), ratio, **kw)
    p = _planes(12, 16, 100, 128, ratio, excited, seed=11)
    _hold(spec, p, 100, not excited, 0 if not excited else 3700,
          jumps=1 if excited else 0)


@pytest.mark.parametrize("excited", [False, True])
@pytest.mark.parametrize("variant", ["e0", "om", "e0_om"])
def test_lane_model_per_lane_forms_match_twin(variant, excited):
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    ratio, E, npad = 8, 2, 128
    pe0, pom = "e0" in variant, "om" in variant
    spec = (_om_spec(ratio, per_lane_e0=pe0) if pom else _spec(
        with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4), ratio, per_lane_e0=pe0))
    cfg = tlc.CoolingConfig(n0=64)
    e0 = np.stack([tlc.build_engine(dataclasses.replace(
        cfg, detuning=d, detuning_dp=dd)).scheme.e0
        for d, dd in ((-1.0, 1.0), (-0.4, 0.25))]).astype(f32)
    om = np.asarray([(0.7, 1.3), (1.25, 0.6)], f32)
    e0p, omp = (None if x is None else x.numpy() for x in fold_sweep_lanes(
        spec, npad, e0 if pe0 else None, om if pom else None))
    p = _planes(12, 16, E * npad, E * npad, ratio, excited, seed=12)
    _hold(spec, p, E * npad, not excited, 0 if not excited else 900, e0p,
          omp, jumps=1 if excited else 0)


@pytest.mark.parametrize("name", ["three_state", "three_state_beat",
                                  "tag408_linear", "tag422", "tag408_kick",
                                  "tag422_beat"])
def test_lane_model_small_schemes_match_twin(name):
    """S = 3 (with and without a beat-note term), 5, 7 (the pumps, and
    each with a term no pump has: a beat note, an Ehrenfest kick), one
    thread an ion with the scheme's pattern compiled in: 2 or no Ehrenfest
    terms."""
    sch = SCHEMES[name]()
    spec = _spec(sch, 10, apply_force=sch.has_force)
    p = _planes(spec.S, spec.SP, 120, 128, 10, True, seed=13)
    _hold(spec, p, 120, True, 0, jumps=1)


@pytest.mark.parametrize("variant", ["e0", "om", "e0_om"])
@pytest.mark.parametrize("name", ["three_state", "tag408_linear", "tag422"])
def test_lane_model_small_per_lane_forms_match_twin(name, variant):
    """The per-lane forms at S = 3, 5, 7 as the three-state and tagging
    sweeps launch them: each member's own e0 plane, and the scheme's own
    coupling and Ehrenfest weights scaled by a lane's om (tf.rabi_scaled:
    an empty DP pattern, om_dp = 0)."""
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    sch = SCHEMES[name]()
    pe0, pom = "e0" in variant, "om" in variant
    spec = _spec(sch, 10, apply_force=sch.has_force, per_lane_e0=pe0)
    if pom:
        spec = tf.rabi_scaled(spec)
    E, npad = 2, 128
    e0 = np.stack([sch.e0, 1.7 * sch.e0]).astype(f32)
    om = np.asarray([(1.0, 0.0), (0.6, 0.0)], f32)
    e0p, omp = (None if x is None else x.numpy() for x in fold_sweep_lanes(
        spec, npad, e0 if pe0 else None, om if pom else None))
    p = _planes(spec.S, spec.SP, E * npad, E * npad, 10, True, seed=15)
    _hold(spec, p, E * npad, True, 0, e0p, omp, jumps=1)


def _whole_parts_base(sch, variant, ratio, seed):
    """The ion kernel's data flow for ``sch`` in one of its four forms: a
    whole launch equals the same lanes launched in two parts bit for bit
    (no sum crosses ions), and a fold whose members sit at the base (the
    scheme's own e0, om scale 1.0 with an empty DP pattern) computes what
    the plain form computes, bit for bit."""
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    pe0, pom = "e0" in variant, "om" in variant
    plain = _spec(sch, ratio, apply_force=sch.has_force)
    spec = dataclasses.replace(plain, per_lane_e0=pe0)
    if pom:
        spec = tf.rabi_scaled(spec)
    E, npad = 2, 128
    p = _planes(spec.S, spec.SP, E * npad, E * npad, ratio, True, seed=seed)
    args = [p[k] for k in ARGS]

    def lanes(e0, om):
        return (None if x is None else x.numpy() for x in fold_sweep_lanes(
            spec, npad, e0 if pe0 else None, om if pom else None))
    e0p, omp = lanes(np.stack([sch.e0, 1.7 * sch.e0]).astype(f32),
                     np.asarray([(1.0, 0.0), (0.6, 0.0)], f32))
    whole = ion_model(spec, True, *args, e0_lanes=e0p, om_lanes=omp)
    cut = lambda x, lo, hi: None if x is None else np.ascontiguousarray(
        x[:, lo:hi])
    parts = [ion_model(spec, True, *(cut(x, lo, hi) for x in args),
                       e0_lanes=cut(e0p, lo, hi), om_lanes=cut(omp, lo, hi))
             for lo, hi in ((0, 96), (96, E * npad))]
    for w, a, b in zip(whole, *parts):
        np.testing.assert_array_equal(w, np.concatenate([a, b], 1))
    assert int((whole[2][0] < ratio * QDT).sum()) >= 1       # jumps ran
    e0b, omb = lanes(np.stack([sch.e0] * E).astype(f32),
                     np.asarray([(1.0, 0.0)] * E, f32))
    base = ion_model(spec, True, *args, e0_lanes=e0b, om_lanes=omb)
    ref = ion_model(plain, True, *args)
    for x, y in zip(base, ref):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("variant", ["plain", "e0", "om", "e0_om"])
def test_ion_model_s3_whole_equals_parts_and_base_equals_plain(variant):
    """The S = 3 kernel's data flow (one thread an ion) in all four forms:
    whole equals parts and base equals plain, bit for bit
    (:func:`_whole_parts_base`)."""
    _whole_parts_base(three_state(), variant, 12, 16)


@pytest.mark.parametrize("variant", ["plain", "e0", "om", "e0_om"])
@pytest.mark.parametrize("name", ["tag422", "tag408_circular",
                                  "tag408_linear"])
def test_ion_model_s5_s7_whole_equals_parts_and_base_equals_plain(name,
                                                                  variant):
    """The pumps' forms (S = 5, 7, their patterns compiled in) in all four
    forms: whole equals parts and base equals plain, bit for bit."""
    _whole_parts_base(SCHEMES[name](), variant, 10, 17)


def _cu_patterns():
    """``ION_PATTERNS`` of csrc/fused_ticks.cu as ``(name, S, mask)``."""
    import os
    import re
    src = os.path.join(os.path.dirname(tf.__file__), os.pardir, "csrc",
                       "fused_ticks.cu")
    with open(src) as f:
        text = f.read()
    block = text[text.index("#define ION_PATTERNS(P)"):]
    block = block[:block.index("\n\n")]
    return tuple((n, int(S), int(m, 16)) for n, S, m in re.findall(
        r"P\((\w+), (\d+), (0x[0-9a-f]+)ull\)", block))


def test_host_patterns_mirror_the_kernel_list():
    """The host's pattern list is the kernel's, entry for entry and in
    order (the host takes the first that covers a scheme), each S ends on
    its dense pattern, and no two patterns of an S are equal."""
    assert _cu_patterns() == tf.ION_PATTERNS
    for S in (3, 5, 7):
        mine = [(n, m) for n, s, m in tf.ION_PATTERNS if s == S]
        assert mine[-1] == ("dense", (1 << (S * S + S)) - 1)
        assert len({m for _, m in mine}) == len(mine)
        assert all(m < 1 << (S * S + S) for _, m in mine)


# a scheme of S = 5 or 7 whose coupling is dense: no pump's pattern
def _dense_scheme(S):
    sch = tag422() if S == 5 else tag408(-1.0, 0.5, True)
    c = 0.1 * np.random.default_rng(S).normal(size=(S, S))
    return dataclasses.replace(sch, name=f"dense{S}", coupling=c + c.T)


@pytest.mark.parametrize("name, scheme, want", [
    ("tag422", tag422, "tag422_linear"),
    ("tag422_om_1.7", lambda: tag422(-2.0, 1.7), "tag422_linear"),
    ("tag408_quad", lambda: tag408(-1.0, 0.5, False), "tag408_quad"),
    ("tag408_linear", lambda: tag408(-1.0, 0.5, True), "tag408_linear"),
    ("three_state", three_state, "dense"),
    ("dense5", lambda: _dense_scheme(5), "dense"),
    ("dense7", lambda: _dense_scheme(7), "dense"),
    # the quad pump's coupling with a ground state that decays
    ("tag408_quad_decay0", lambda: dataclasses.replace(
        tag408(-1.0, 0.5, False), name="tag408_quad_decay0",
        decay_w=tag408(-1.0, 0.5, False).decay_w + np.eye(7)[0]), "dense"),
])
def test_schemes_pick_their_compiled_pattern(name, scheme, want):
    """The pumps take their own patterns (the places of their coupling and
    their decaying states exactly), in every form; any other scheme of S =
    5, 7 the dense one; a named pattern that covers the scheme is taken,
    one that does not is refused."""
    sch = scheme()
    masks = {(n, S): m for n, S, m in tf.ION_PATTERNS}
    mask = masks[(want, sch.n_states)]
    for spec in (_spec(sch), _spec(sch, per_lane_e0=True),
                 tf.rabi_scaled(_spec(sch)),
                 tf.rabi_scaled(_spec(sch, per_lane_e0=True))):
        assert tf._kernel_plan(spec).pattern == mask
    if want != "dense":
        places = zip(*np.nonzero(sch.coupling))
        assert tf.pattern_mask(places, sch.n_states,
                               np.flatnonzero(sch.decay_w)) == mask
    dense = tf._kernel_plan(_spec(sch, coupling_pattern="dense"))
    assert dense.pattern == masks[("dense", sch.n_states)]
    np.testing.assert_array_equal(dense.ion_table,
                                  tf._kernel_plan(_spec(sch)).ion_table)
    if name == "tag408_linear":
        with pytest.raises(ValueError, match="covers"):
            tf._kernel_plan(_spec(sch, coupling_pattern="tag408_quad"))
    if name == "tag408_quad":         # a pattern that covers it: taken
        wide = tf._kernel_plan(_spec(sch, coupling_pattern="tag408_linear"))
        assert wide.pattern == masks[("tag408_linear", 7)]


def test_ion_table_width_of_the_pump_schemes():
    """190 floats at S = 5 and 364 at S = 7 (760 and 1,456 bytes: the
    kernel parameter's room is 4 KiB), the .cu's formula, and the plans'
    tables of that length."""
    assert tf.ion_table_width(5) == 190 and tf.ion_table_width(7) == 364
    for S in (3, 5, 7):
        assert tf.ion_table_width(S) == 4 * S + 6 * S * S + S * (S - 1)
    for sch in (tag422(), tag408(-1.0, 0.5, False)):
        plan = tf._kernel_plan(_spec(sch))
        assert plan.ion_table.shape == (tf.ion_table_width(sch.n_states),)
        assert plan.ion_table.dtype == np.float32
    assert tf._kernel_plan(_spec(sr12_cooling())).ion_table is None


@pytest.mark.parametrize("variant", ["plain", "e0", "om", "e0_om"])
@pytest.mark.parametrize("name", ["tag422", "tag408_circular",
                                  "tag408_linear", "tag408_kick",
                                  "tag422_beat"])
def test_masked_ion_model_equals_dense_bit_for_bit(name, variant):
    """A compiled pattern skips the coupling's zeros in column order (and
    the Ehrenfest sum's zero pairs), which leaves the dense sums' bits:
    the pattern's form equals the dense form, bit for bit, in every form,
    with a kick and with a beat note."""
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    sch = SCHEMES[name]()
    pe0, pom = "e0" in variant, "om" in variant
    spec = _spec(sch, 10, apply_force=sch.has_force, per_lane_e0=pe0)
    if pom:
        spec = tf.rabi_scaled(spec)
    dense = dataclasses.replace(spec, coupling_pattern="dense")
    assert tf._kernel_plan(spec).pattern != tf._kernel_plan(dense).pattern
    E, npad = 2, 128
    e0p, omp = (None if x is None else x.numpy() for x in fold_sweep_lanes(
        spec, npad, np.stack([sch.e0, 1.7 * sch.e0]).astype(f32) if pe0
        else None, np.asarray([(1.0, 0.0), (0.6, 0.0)], f32) if pom
        else None))
    p = _planes(spec.S, spec.SP, E * npad, E * npad, 10, True, seed=18)
    args = [p[k] for k in ARGS]
    masked = ion_model(spec, True, *args, e0_lanes=e0p, om_lanes=omp)
    full = ion_model(dense, True, *args, e0_lanes=e0p, om_lanes=omp)
    for x, y in zip(masked, full):
        np.testing.assert_array_equal(x, y)
    if sch.has_force:                   # the kick ran and moved V
        assert not np.array_equal(masked[1], p["V"])


def test_lane_model_dense_table_matches_twin():
    """A table with full rows (K = S: the kernel's shared-memory path)."""
    rng = np.random.default_rng(3)
    sch = with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4)
    extra = 0.05 * rng.normal(size=(12, 12))
    dense = dataclasses.replace(sch, coupling=sch.coupling + extra + extra.T)
    spec = _spec(dense, 6)
    assert tf._kernel_plan(spec).K == 12
    p = _planes(12, 16, 128, 128, 6, True, seed=14)
    _hold(spec, p, 128, False, 50, jumps=1)
