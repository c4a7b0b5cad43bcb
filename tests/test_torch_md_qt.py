"""Port vs JAX package: MD pieces, the QT engine, the initializer and the
KDE (CPU, plain torch against plain JAX on the same numpy inputs).

Tolerances: float32 R/V 2e-5 and psi 5e-5 (the bars of
tests/test_fused.py:91-101; the two frameworks sum in different orders),
float64 1e-12 (the same arithmetic up to reordering)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.core import init as jinit
from mdqtplasmasims_tpu.core import md as jmd
from mdqtplasmasims_tpu.core import qt as jqt
from mdqtplasmasims_tpu.levels import sr12_cooling, with_recoil
from mdqtplasmasims_tpu.ops import kde as jkde
from mdqtplasmasims_tpu.units import PlasmaUnits
from mdqtplasmasims_torch.core import init as tinit
from mdqtplasmasims_torch.core import md as tmd
from mdqtplasmasims_torch.core import qt as tqt
from mdqtplasmasims_torch.ops import kde as tkde

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, torch.float32, jnp.float32, 2e-5, 5e-5),
          "float64": (np.float64, torch.float64, jnp.float64, 1e-12, 1e-12)}


def _excited_psi(n, S, rng, np_c):
    """Random amplitudes with a populated P manifold, so jumps fire."""
    psi = np.zeros((n, S), np_c)
    psi[:, :6] = rng.normal(size=(n, 6)) + 1j * rng.normal(size=(n, 6))
    return psi / np.linalg.norm(psi, axis=1, keepdims=True)


@pytest.mark.parametrize("dt_name", ["float32", "float64"])
@pytest.mark.parametrize("first", [False, True])
def test_leapfrog_substep_matches_jax(dt_name, first):
    np_t, th_t, j_t, atol, _ = DTYPES[dt_name]
    rng = np.random.default_rng(1)
    n, L = 200, 6.0
    # positions near both faces so the single +-L wrap is exercised
    R = rng.uniform(-0.01, L + 0.01, (n, 3)).astype(np_t)
    V = rng.normal(0, 3.0, (n, 3)).astype(np_t)
    F = rng.normal(0, 50.0, (n, 3)).astype(np_t)
    dt = 0.01
    Rj, Vj = jmd.leapfrog_substep(jnp.asarray(R, j_t), jnp.asarray(V, j_t),
                                  jnp.asarray(F, j_t), dt, L, first)
    Rt, Vt = tmd.leapfrog_substep(torch.from_numpy(R), torch.from_numpy(V),
                                  torch.from_numpy(F), dt, L, first)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=atol, rtol=0)
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), atol=atol, rtol=0)
    Rw = rng.uniform(-2.0, L + 2.0, (n, 3)).astype(np_t)
    np.testing.assert_array_equal(
        tmd.wrap_pbc(torch.from_numpy(Rw), L).numpy(),
        np.asarray(jmd.wrap_pbc(jnp.asarray(Rw, j_t), L)))


@pytest.mark.parametrize("dt_name", ["float32", "float64"])
@pytest.mark.parametrize("masked", [False, True])
def test_kinetic_energies_match_jax(dt_name, masked):
    np_t, _, j_t, _, _ = DTYPES[dt_name]
    rng = np.random.default_rng(2)
    V = rng.normal(0.3, 1.0, (300, 3)).astype(np_t)
    mask = (rng.uniform(size=300) < 0.8).astype(np_t) if masked else None
    for sub in (False, True):
        ej = jmd.kinetic_energies(jnp.asarray(V, j_t), sub,
                                  None if mask is None
                                  else jnp.asarray(mask, j_t))
        et = tmd.kinetic_energies(torch.from_numpy(V), sub,
                                  None if mask is None
                                  else torch.from_numpy(mask))
        rtol = 1e-6 if np_t == np.float32 else 1e-13
        for a, b in zip(et, ej):
            np.testing.assert_allclose(float(a), float(b), rtol=rtol)


def _engine_pair(renormalize=False):
    scheme = with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4)
    kw = dict(h=0.00985, dt_plasma=8e-5, plas_to_quant_vel=1.327,
              gamma_to_einstein=123.1, apply_force=True,
              renormalize=renormalize)
    return jqt.QTEngine(scheme, **kw), tqt.QTEngine(scheme, **kw)


@pytest.mark.parametrize("dt_name", ["float32", "float64"])
@pytest.mark.parametrize("renormalize", [False, True])
def test_step_sm_matches_jax(dt_name, renormalize):
    """Ten chained sr12 ticks with explicit rolls from an excited start
    (jumps fire on many ions; the beat-note rows and the expansion
    detuning are live)."""
    np_t, th_t, j_t, atol, patol = DTYPES[dt_name]
    np_c = np.complex64 if np_t == np.float32 else np.complex128
    je, te = _engine_pair(renormalize)
    rng = np.random.default_rng(3)
    n, S = 128, 12
    psi = _excited_psi(n, S, rng, np_c).T.copy()        # [S, N]
    vx = rng.normal(0, 0.4, n).astype(np_t)
    tp = np.abs(rng.normal(0, 1.0, n)).astype(np_t)
    pj, vj, tj = (jnp.asarray(psi), jnp.asarray(vx, j_t),
                  jnp.asarray(tp, j_t))
    pt, vt, tt = (torch.from_numpy(psi), torch.from_numpy(vx),
                  torch.from_numpy(tp))
    n_jumps = 0
    for k in range(10):
        rolls = rng.uniform(size=(5, n)).astype(np_t)
        rolls[0] *= 0.01          # jump test draws near dp ~ 1e-2
        pj, vj, tj = je.step_sm(pj, vj, tj, exp_det=0.01 * k,
                                rolls=jnp.asarray(rolls, j_t))
        pt, vt, tt = te.step_sm(pt, vt, tt, rolls=torch.from_numpy(rolls),
                                exp_det=0.01 * k)
        n_jumps += int(np.sum(np.asarray(tj) == 0))
    assert n_jumps > 50
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=patol,
                               rtol=0)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=atol, rtol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=atol, rtol=0)


def test_step_wrapper_and_generator_draws():
    """The [N,S] wrapper matches step_sm, and generator draws work."""
    _, te = _engine_pair()
    rng = np.random.default_rng(4)
    psi = torch.from_numpy(_excited_psi(64, 12, rng, np.complex64))
    vx = torch.zeros(64)
    tp = torch.zeros(64)
    rolls = torch.rand((5, 64), generator=torch.Generator().manual_seed(0))
    a = te.step(psi, vx, tp, rolls=rolls)
    b = te.step_sm(psi.T, vx, tp, rolls=rolls)
    torch.testing.assert_close(a[0], b[0].T, rtol=0, atol=0)
    g = te.step(psi, vx, tp, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(g[0], a[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="exactly one"):
        te.step_sm(psi.T, vx, tp)


def test_state_populations_and_superposition():
    rng = np.random.default_rng(5)
    psi = _excited_psi(50, 12, rng, np.complex64)
    man = [(0, 1), (2, 3, 4, 5), tuple(range(6, 12))]
    pj = jqt.state_populations(jnp.asarray(psi), man)
    pt = tqt.state_populations(torch.from_numpy(psi), man)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    s = tqt.random_s_superposition(torch.Generator().manual_seed(1), 500, 12)
    assert s.dtype == torch.complex64
    norm = torch.sum(s.real ** 2 + s.imag ** 2, dim=1)
    torch.testing.assert_close(norm, torch.ones(500), rtol=0, atol=1e-6)
    assert float(torch.abs(s[:, 2:]).max()) == 0.0


@pytest.mark.parametrize("exact_n", [True, False])
def test_frozen_gas_init(exact_n):
    n0 = 300
    L = PlasmaUnits.box_length(n0)
    R, V, psi, n = tinit.frozen_gas_init(torch.Generator().manual_seed(2),
                                         n0, n_states=12, exact_n=exact_n,
                                         seed_for_count=7)
    # the Poissonian count is drawn on the host exactly as the JAX package
    # draws it
    *_, n_jax = jinit.frozen_gas_init(jax.random.PRNGKey(0), n0,
                                      n_states=12, exact_n=exact_n,
                                      seed_for_count=7)
    assert n == n_jax
    assert R.shape == (n, 3) and psi.shape == (n, 12)
    assert float(R.min()) >= 0.0 and float(R.max()) <= L
    assert float(torch.abs(V).max()) == 0.0
    for seed in range(3):
        assert (tinit.sample_cell_count(np.random.default_rng(seed), n0)
                == jinit.sample_cell_count(np.random.default_rng(seed), n0))


@pytest.mark.parametrize("weighted", [False, True])
def test_gaussian_kde_matches_jax(weighted):
    rng = np.random.default_rng(6)
    v = rng.normal(0, 0.05, 400).astype(np.float32)
    w = (rng.uniform(size=400) < 0.7).astype(np.float32) if weighted else None
    kj = jkde.gaussian_kde(jnp.asarray(v), jkde.folded_bins(jnp.float32),
                           folded=True,
                           weights=None if w is None else jnp.asarray(w))
    kt = tkde.gaussian_kde(torch.from_numpy(v), tkde.folded_bins(),
                           folded=True,
                           weights=None if w is None else torch.from_numpy(w))
    scale = float(np.abs(np.asarray(kj)).max())
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=0,
                               atol=2e-5 * scale)
    np.testing.assert_array_equal(tkde.folded_bins().numpy(),
                                  np.asarray(jkde.folded_bins(jnp.float32)))
    np.testing.assert_array_equal(tkde.folded_bins_np(),
                                  jkde.folded_bins_np())


@pytest.mark.parametrize("renorm", [False, True])
def test_step_sm_matches_reference_oracle(renorm):
    """The torch engine against the literal numpy transcription of the
    reference's 12-state qstep (tests/reference_qstep.py): float64, 100
    ticks with jumps, Ehrenfest and recoil kicks, expansion detuning and
    beat notes, identical rolls — as tests/test_qt_engine.py:185-236
    holds the JAX engine."""
    from reference_qstep import qstep

    qdt, g2e, p2q, vk, vkdp, dr = 8e-5, 123.1, 1.327, 9.1e-4, 3.6e-4, 0.0617
    frac, te, dens, sig0 = 0.5, 19.0, 2.0, 4.0
    scheme = with_recoil(sr12_cooling(-1.0, 1.0, 1.0, 1.0, decay_ratio=dr),
                         kick_s=vk, kick_d=vkdp)
    eng = tqt.QTEngine(scheme, h=qdt * g2e, dt_plasma=qdt,
                       plas_to_quant_vel=p2q, gamma_to_einstein=g2e,
                       apply_force=True, renormalize=renorm)
    n, T = 24, 100
    rng = np.random.default_rng(42)
    psi0 = rng.normal(size=(n, 12)) + 1j * rng.normal(size=(n, 12))
    psi0[:, 6:] *= 0.3
    psi0 /= np.linalg.norm(psi0, axis=1, keepdims=True)
    v0, tp0 = rng.uniform(-0.8, 0.8, n), rng.uniform(0.0, 2.0, n)
    rolls = rng.uniform(size=(T, 5, n))

    def exp_det_of(t):
        return (0.0126 * frac * te * t / (np.sqrt(dens) * sig0 * np.sqrt(
            1 + 0.00014314 * t * t * te / (dens * sig0 * sig0))))

    psi, vx, tp = (torch.from_numpy(psi0.T.copy()), torch.from_numpy(v0),
                   torch.from_numpy(tp0))
    for k in range(T):
        psi, vx, tp = eng.step_sm(psi, vx, tp, torch.from_numpy(rolls[k]),
                                  exp_det=exp_det_of(k * qdt))
    for i in range(n):
        w, v, tpart = psi0[i].copy(), v0[i], tp0[i]
        for k in range(T):
            w, v, tpart = qstep(
                w, v, tpart, rolls[k, :, i], detuning=-1.0, detuningDP=1.0,
                Om=1.0, OmDP=1.0, dr=dr, plasVelToQuantVel=p2q,
                gamToEinsteinFreq=g2e, dtQuant=qdt, vKick=vk, vKickDP=vkdp,
                fracOfSig=frac, Te=te, density=dens, sig0=sig0, t=k * qdt,
                reNormalizewvFns=renorm, dest_state_order=True)
        np.testing.assert_allclose(psi[:, i].numpy(), w, atol=1e-10)
        np.testing.assert_allclose(float(vx[i]), v, atol=1e-12)
        np.testing.assert_allclose(float(tp[i]), tpart, atol=1e-12)
