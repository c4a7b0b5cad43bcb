"""Port vs JAX package: the fused tick kernel's plain twin against the JAX
Pallas kernel (interpret mode, explicit rolls) on the same numpy inputs,
mirroring tests/test_fused.py (the CUDA kernel is held to the twin in
tests/test_torch_cuda.py).

The schemes are the four the kernel is built for (S = 12, 5, 3, 7).
Tolerances are tests/test_fused.py:91-101's: R/V 2e-5, tp 2e-5, psi 5e-5
(float32, reordered sums), pad rows and padded lanes exactly zero;
float64 1e-10 against the JAX per-tick XLA path."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.core import md as jmd
from mdqtplasmasims_tpu.core import qt as jqt
from mdqtplasmasims_tpu.core import qt_fused as jf
from mdqtplasmasims_tpu.levels import (sr12_cooling, tag408, tag422,
                                       three_state, with_recoil)
from mdqtplasmasims_tpu.units import PlasmaUnits
from mdqtplasmasims_torch.core import qt_fused as tf

torch.set_num_threads(1)

H, QDT, P2Q, G2E = 0.00985, 8e-5, 1.327, 123.1
# flagship-like expansion coefficients: frac_of_sig=0.5, te=19, density=2,
# sig0=4 (tests/test_fused.py:118-120)
C1 = 0.0126 * 0.5 * 19.0 / (np.sqrt(2.0) * 4.0)
C2 = 0.00014314 * 19.0 / (2.0 * 16.0)


def _specs(scheme, ratio, L, apply_force=True, exp=False, renorm=False):
    kw = dict(scheme=scheme, h=H, qdt=QDT, plas_to_quant_vel=P2Q,
              gamma_to_einstein=G2E, ratio=ratio, L=L,
              apply_force=apply_force, exp_c1=C1 if exp else 0.0,
              exp_c2=C2 if exp else 0.0, renormalize=renorm)
    return jf.FusedTickSpec(internal_rng=False, **kw), tf.FusedTickSpec(**kw)


def _planes(n, npad, S, SP, ratio, excited, seed, dtype=np.float32):
    """Padded lane planes from numpy: R, V, F, tp, psi re/im, rolls."""
    rng = np.random.default_rng(seed)
    L = PlasmaUnits.box_length(n)

    def pad(x, rows):
        out = np.zeros((rows, npad), dtype)
        out[:x.shape[0], :n] = x
        return out
    psi = np.zeros((S, n), np.complex128)
    if excited:
        # populated P manifold: jumps fire on most ticks (test_fused.py:61-65;
        # the three-state toy's excited states are 1 and 2)
        psi[2], psi[4 if S > 4 else 1], psi[0] = 0.7, 0.5j, 0.51
    else:
        r1, r2 = rng.uniform(size=(2, n))
        psi[0] = np.sqrt(r1)
        psi[1] = np.sqrt(1 - r1) * (np.sqrt(r2) + 1j * np.sqrt(1 - r2))
    return dict(
        R=pad(rng.uniform(0, L, (3, n)), 3),
        V=pad(rng.normal(0, 0.3, (3, n)), 3),
        F=pad(rng.normal(0, 0.5, (3, n)), 3),
        tp=pad(np.abs(rng.normal(0, 1, (1, n))), 1),
        psi_re=pad(psi.real, SP), psi_im=pad(psi.imag, SP),
        rolls=rng.uniform(size=(ratio * 5, npad)).astype(dtype)), L


def _run_both(jspec, tspec, p, first=False, tick0=0):
    Ro, Vo, tpo, preo, pimo = jf.fused_md_substeps(
        jspec, jnp.full((1, 1), float(first), jnp.float32),
        *(jnp.asarray(p[k]) for k in ("R", "V", "F", "tp", "psi_re",
                                      "psi_im")),
        rolls=jnp.asarray(p["rolls"]),
        tick0=jnp.full((1, 1), tick0, jnp.float32), tile=128,
        interpret=True)
    jout = [np.asarray(x) for x in (Ro, Vo, tpo, preo, pimo)]
    tout = tf.fused_md_substeps(
        tspec, first, *(torch.from_numpy(p[k]) for k in (
            "R", "V", "F", "tp", "psi_re", "psi_im", "rolls")), tick0=tick0)
    return jout, [x.numpy() for x in tout]


def _assert_close(jout, tout, S, n):
    for name, j, t, atol in zip(("R", "V", "tp", "psi_re", "psi_im"),
                                jout, tout, (2e-5, 2e-5, 2e-5, 5e-5, 5e-5)):
        np.testing.assert_allclose(t[:, :n], j[:, :n], atol=atol,
                                   rtol=1e-4, err_msg=name)
    for t in tout[3:]:                 # pad rows and padded lanes
        assert np.abs(t[S:]).max(initial=0.0) == 0.0
        assert np.abs(t[:, n:]).max() == 0.0


@pytest.mark.parametrize("scheme_name", ["sr12", "tag422", "three_state",
                                         "tag408"])
@pytest.mark.parametrize("excited_start", [False, True])
def test_twin_matches_jax_kernel(scheme_name, excited_start):
    """S = 12, 5, 3 (the toy's kicks and recoils on) and 7."""
    n, npad = 96, 128
    ratio = 20 if excited_start else 5
    scheme, force = {
        "sr12": (with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4), True),
        "tag422": (tag422(), False),
        "three_state": (three_state(-0.5, 0.5, 0.0012076), True),
        "tag408": (tag408(-1.0, 2.0, linear=False), False)}[scheme_name]
    L = PlasmaUnits.box_length(n)
    jspec, tspec = _specs(scheme, ratio, L, apply_force=force)
    p, _ = _planes(n, npad, scheme.n_states, tspec.SP, ratio, excited_start,
                   seed=1)
    jout, tout = _run_both(jspec, tspec, p, first=True)
    _assert_close(jout, tout, scheme.n_states, n)
    if excited_start:   # the collapse path really ran
        assert np.sum(tout[2][0, :n] < ratio * QDT) >= 5


@pytest.mark.parametrize("renorm", [False, True])
def test_twin_expansion_and_renormalize(renorm):
    n, npad, ratio, tick0 = 96, 128, 12, 3700
    scheme = with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4)
    L = PlasmaUnits.box_length(n)
    jspec, tspec = _specs(scheme, ratio, L, exp=True, renorm=renorm)
    p, _ = _planes(n, npad, 12, 16, ratio, True, seed=2)
    jout, tout = _run_both(jspec, tspec, p, tick0=tick0)
    _assert_close(jout, tout, 12, n)
    if renorm:
        norm = np.sum(tout[3][:12, :n] ** 2 + tout[4][:12, :n] ** 2, 0)
        np.testing.assert_allclose(norm, 1.0, atol=1e-5)


def test_twin_float64_matches_jax_xla_path():
    """The twin in float64 against the JAX per-tick path (leapfrog_substep
    + QTEngine.step_sm, as tests/test_fused.py's xla_reference) in float64,
    with the expansion detuning and a first drift."""
    n, npad, ratio, tick0 = 64, 128, 6, 0
    scheme = with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4)
    L = PlasmaUnits.box_length(n)
    _, tspec = _specs(scheme, ratio, L, exp=True)
    p, _ = _planes(n, npad, 12, 16, ratio, True, seed=3, dtype=np.float64)
    p["rolls"][0::5] *= 0.01           # jump draws near dp ~ 1e-2
    engine = jqt.QTEngine(scheme, h=H, dt_plasma=QDT, plas_to_quant_vel=P2Q,
                          gamma_to_einstein=G2E, apply_force=True)
    R, V, F = (jnp.asarray(p[k][:, :n]) for k in ("R", "V", "F"))
    tp = jnp.asarray(p["tp"][0, :n])
    psi = jnp.asarray(p["psi_re"][:12, :n] + 1j * p["psi_im"][:12, :n])
    for i in range(ratio):
        R, V = jmd.leapfrog_substep(R, V, F, QDT, L, i == 0)
        t = float(np.float32(tick0 + i)) * QDT
        psi, vx, tp = engine.step_sm(
            psi, V[0], tp, rolls=jnp.asarray(p["rolls"][i * 5:i * 5 + 5, :n]),
            exp_det=C1 * t / np.sqrt(1.0 + C2 * t * t))
        V = V.at[0].set(vx)
    out = tf.fused_md_substeps(tspec, True, *(torch.from_numpy(p[k]) for k in (
        "R", "V", "F", "tp", "psi_re", "psi_im", "rolls")), tick0=tick0)
    for t, j in zip(out, (R, V, tp[None], psi.real, psi.imag)):
        np.testing.assert_allclose(t.numpy()[:j.shape[0], :n], np.asarray(j),
                                   rtol=0, atol=1e-10)


def test_pack_tables_saturates_pad_destinations():
    scheme = with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4)
    _, tspec = _specs(scheme, 2, 10.0)
    vecs, mats = tf.pack_tables(tspec)
    assert vecs.shape == (16, 8) and mats.shape == (64, 16)
    np.testing.assert_array_equal(mats[16 + 12:32], 1.0)
    np.testing.assert_array_equal(mats[32 + 12:48], 1.0)
    np.testing.assert_array_equal(mats[48:], np.tril(np.ones((16, 16))))
    np.testing.assert_array_equal(vecs[[2, 3, 4, 5], 3], 1.0)


@pytest.mark.parametrize("where", ["coupling", "tdep"])
def test_rejects_complex_couplings(where):
    scheme = sr12_cooling()
    if where == "coupling":
        C = scheme.coupling.copy()
        C[2, 1] += 0.3j
        C[1, 2] -= 0.3j
        bad = dataclasses.replace(scheme, coupling=C)
    else:
        bad = dataclasses.replace(
            scheme, tdep_coefs=(scheme.tdep_coefs[0] + 0.1j,
                                scheme.tdep_coefs[1]))
    _, spec = _specs(bad, 2, 10.0)
    z3, z1 = torch.zeros((3, 128)), torch.zeros((1, 128))
    zS, rolls = torch.zeros((16, 128)), torch.zeros((10, 128))
    with pytest.raises(ValueError, match="real"):
        tf.fused_md_substeps(spec, False, z3, z3, z3, z1, zS, zS, rolls)


def test_rejects_bad_shapes():
    scheme = with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4)
    _, spec = _specs(scheme, 2, 10.0)
    z3, z1 = torch.zeros((3, 128)), torch.zeros((1, 128))
    zS = torch.zeros((16, 128))
    with pytest.raises(ValueError, match="rolls"):
        tf.fused_md_substeps(spec, False, z3, z3, z3, z1, zS, zS,
                             torch.zeros((5, 128)))
    with pytest.raises(ValueError, match="psi_re"):
        tf.fused_md_substeps(spec, False, z3, z3, z3, z1,
                             torch.zeros((12, 128)), zS, torch.zeros((10, 128)))



def test_twin_matches_reference_oracle():
    """The fused twin (the main path's plain version of the tick kernel)
    in float64 against the literal transcription of the reference's
    12-state qstep (tests/reference_qstep.py), with identical rolls over
    60 ticks from tick 700: expansion detuning, beat notes, jumps and
    kicks.  F = 0, so the leapfrog leaves vx to the quantum kicks."""
    from reference_qstep import qstep

    dr, vk, vkdp, frac, te, dens, sig0 = 0.0617, 9.1e-4, 3.6e-4, 0.5, 19.0, \
        2.0, 4.0
    scheme = with_recoil(sr12_cooling(decay_ratio=dr), kick_s=vk,
                         kick_d=vkdp)
    c1 = 0.0126 * frac * te / (np.sqrt(dens) * sig0)
    c2 = 0.00014314 * te / (dens * sig0 ** 2)
    n, npad, T, tick0 = 20, 32, 60, 700
    L = PlasmaUnits.box_length(n)
    spec = tf.FusedTickSpec(scheme=scheme, h=QDT * G2E, qdt=QDT,
                            plas_to_quant_vel=P2Q, gamma_to_einstein=G2E,
                            ratio=T, L=L, apply_force=True, exp_c1=c1,
                            exp_c2=c2)
    rng = np.random.default_rng(7)
    psi0 = rng.normal(size=(n, 12)) + 1j * rng.normal(size=(n, 12))
    psi0[:, 6:] *= 0.3
    psi0 /= np.linalg.norm(psi0, axis=1, keepdims=True)
    v0, tp0 = rng.uniform(-0.8, 0.8, n), rng.uniform(0.0, 2.0, n)
    rolls = rng.uniform(size=(T * 5, npad))

    def pad(x, rows):
        out = np.zeros((rows, npad))
        out[:x.shape[0], :n] = x
        return torch.from_numpy(out)
    V = pad(np.stack([v0, np.zeros(n), np.zeros(n)]), 3)
    _, Vo, tpo, pre, pim = tf.fused_md_substeps(
        spec, False, pad(rng.uniform(0, L, (3, n)), 3), V,
        torch.zeros((3, npad), dtype=torch.float64), pad(tp0[None], 1),
        pad(psi0.T.real, 16), pad(psi0.T.imag, 16),
        torch.from_numpy(rolls), tick0=tick0)
    for i in range(n):
        w, v, tpart = psi0[i].copy(), v0[i], tp0[i]
        for k in range(T):
            w, v, tpart = qstep(
                w, v, tpart, rolls[k * 5:k * 5 + 5, i], detuning=-1.0,
                detuningDP=1.0, Om=1.0, OmDP=1.0, dr=dr,
                plasVelToQuantVel=P2Q, gamToEinsteinFreq=G2E, dtQuant=QDT,
                vKick=vk, vKickDP=vkdp, fracOfSig=frac, Te=te,
                density=dens, sig0=sig0, t=(tick0 + k) * QDT,
                dest_state_order=True)
        np.testing.assert_allclose(pre[:12, i].numpy() + 1j
                                   * pim[:12, i].numpy(), w, atol=1e-10)
        np.testing.assert_allclose(float(Vo[0, i]), v, atol=1e-12)
        np.testing.assert_allclose(float(tpo[0, i]), tpart, atol=1e-12)
    assert float(pre[12:].abs().max()) == float(pre[:, n:].abs().max()) == 0
