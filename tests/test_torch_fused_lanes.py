"""Port vs JAX package: the per-lane (sweep) variants of the fused tick
twin against the JAX Pallas kernel (interpret mode, explicit rolls) on a
3-member fold whose members carry different detunings (per_lane_e0) and
Rabi frequencies (per_lane_om), mirroring tests/test_fused.py:466-557.
The CUDA variants are held to the twin in tests/test_torch_cuda.py.

Tolerances are tests/test_fused.py:91-101's: R/V/tp 2e-5, psi 5e-5
(float32, reordered sums), pad rows and padded lanes exactly zero."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.core import qt_fused as jf
from mdqtplasmasims_tpu.core.scheduler import fold_sweep_lanes as j_fold
from mdqtplasmasims_tpu.levels import tag422
from mdqtplasmasims_tpu.units import PlasmaUnits
from mdqtplasmasims_torch.core import qt_fused as tf
from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
from mdqtplasmasims_torch.experiments import laser_cooling as tlc

torch.set_num_threads(1)

E, N, NPAD = 3, 96, 128
H, QDT, P2Q, G2E = 0.00985, 8e-5, 1.327, 123.1
DETS = [(-1.0, 1.0), (-0.4, 0.25), (-1.6, 1.3)]
OMS = [(1.0, 1.0), (0.7, 1.3), (1.25, 0.6)]
CFG = tlc.CoolingConfig(n0=N)


def _specs(ratio, per_lane_e0=False, per_lane_om=False):
    L = PlasmaUnits.box_length(N)
    ssp, sdp = tlc.om_split_schemes(CFG) if per_lane_om else (None, None)
    kw = dict(scheme=tlc.build_engine(CFG).scheme, h=H, qdt=QDT,
              plas_to_quant_vel=P2Q, gamma_to_einstein=G2E, ratio=ratio, L=L,
              apply_force=True, per_lane_e0=per_lane_e0,
              per_lane_om=per_lane_om, scheme_sp=ssp, scheme_dp=sdp)
    return jf.FusedTickSpec(internal_rng=False, **kw), tf.FusedTickSpec(**kw)


def _sweep():
    e0 = np.stack([tlc.build_engine(dataclasses.replace(
        CFG, detuning=a, detuning_dp=b)).scheme.e0 for a, b in DETS])
    return e0.astype(np.float32), np.asarray(OMS, np.float32)


def _planes(ratio, excited, seed):
    """Folded lane planes from numpy: E member blocks of NPAD lanes, N real
    ions each."""
    rng = np.random.default_rng(seed)
    L = PlasmaUnits.box_length(N)
    on = np.zeros((E, NPAD))
    on[:, :N] = 1.0
    on = on.reshape(1, E * NPAD)

    def lanes(x):
        return (x * on).astype(np.float32)
    psi = np.zeros((16, E * NPAD), np.complex128)
    if excited:            # populated P manifold: jumps fire
        psi[2], psi[4], psi[0] = 0.7, 0.5j, 0.51
    else:
        r1, r2 = rng.uniform(size=(2, E * NPAD))
        psi[0] = np.sqrt(r1)
        psi[1] = np.sqrt(1 - r1) * (np.sqrt(r2) + 1j * np.sqrt(1 - r2))
    return dict(R=lanes(rng.uniform(0, L, (3, E * NPAD))),
                V=lanes(rng.normal(0, 0.3, (3, E * NPAD))),
                F=lanes(rng.normal(0, 0.5, (3, E * NPAD))),
                tp=lanes(np.abs(rng.normal(0, 1, (1, E * NPAD)))),
                psi_re=lanes(psi.real), psi_im=lanes(psi.imag),
                rolls=rng.uniform(size=(ratio * 5, E * NPAD)).astype(
                    np.float32))


ARGS = ("R", "V", "F", "tp", "psi_re", "psi_im", "rolls")


def _port(tspec, p, first, tick0, e0p, omp):
    out = tf.fused_md_substeps(
        tspec, first, *(torch.from_numpy(p[k]) for k in ARGS), tick0=tick0,
        e0_lanes=None if e0p is None else torch.from_numpy(e0p),
        om_lanes=None if omp is None else torch.from_numpy(omp))
    return [x.numpy() for x in out]


def _assert_close(jout, tout):
    real = np.zeros((E, NPAD), bool)
    real[:, :N] = True
    real = real.reshape(-1)
    for name, j, t, atol in zip(("R", "V", "tp", "psi_re", "psi_im"), jout,
                                tout, (2e-5, 2e-5, 2e-5, 5e-5, 5e-5)):
        np.testing.assert_allclose(t[:, real], j[:, real], atol=atol,
                                   rtol=1e-4, err_msg=name)
    for t in tout[3:]:                 # pad rows and padded lanes
        assert np.abs(t[12:]).max() == 0.0
        assert np.abs(t[:, ~real]).max() == 0.0


@pytest.mark.parametrize("variant", ["e0", "om", "e0_om"])
@pytest.mark.parametrize("excited", [False, True])
def test_lane_twin_matches_jax_kernel(variant, excited):
    ratio = 12 if excited else 5
    pe0, pom = "e0" in variant, "om" in variant
    jspec, tspec = _specs(ratio, pe0, pom)
    sweep_e0, sweep_om = _sweep()
    e0p, omp = (None if x is None else x.numpy() for x in fold_sweep_lanes(
        tspec, NPAD, sweep_e0 if pe0 else None, sweep_om if pom else None))
    p = _planes(ratio, excited, seed=3)
    first, tick0 = (not excited), (0 if not excited else 2400)
    jout = jf.fused_md_substeps(
        jspec, jnp.full((1, 1), float(first), jnp.float32),
        *(jnp.asarray(p[k]) for k in ARGS[:6]), rolls=jnp.asarray(p["rolls"]),
        tick0=jnp.full((1, 1), tick0, jnp.float32),
        e0_lanes=None if e0p is None else jnp.asarray(e0p),
        om_lanes=None if omp is None else jnp.asarray(omp), tile=NPAD,
        interpret=True)
    tout = _port(tspec, p, first, tick0, e0p, omp)
    _assert_close([np.asarray(x) for x in jout], tout)
    if excited:        # the collapse path really ran
        assert np.sum(tout[2][0, :N] < ratio * QDT) >= 5
    # the members really differ: member 0 vs member 1 amplitudes
    assert np.abs(tout[3][:, :N] - tout[3][:, NPAD:NPAD + N]).max() > 1e-6


def test_fold_sweep_lanes_equals_jax():
    jspec, tspec = _specs(2, True, True)
    sweep_e0, sweep_om = _sweep()
    je0, jom = j_fold(jspec, NPAD, sweep_e0=jnp.asarray(sweep_e0),
                      sweep_om=jnp.asarray(sweep_om))
    te0, tom = fold_sweep_lanes(tspec, NPAD, sweep_e0, sweep_om)
    np.testing.assert_array_equal(te0.numpy(), np.asarray(je0))
    np.testing.assert_array_equal(tom.numpy(), np.asarray(jom))
    assert te0.shape == (16, E * NPAD) and tom.shape == (2, E * NPAD)


def test_uniform_e0_plane_equals_plain_twin():
    """A per-lane plane filled with the scheme's own e0 changes nothing."""
    _, tspec = _specs(6)
    _, lspec = _specs(6, per_lane_e0=True)
    e0 = np.repeat(tspec.scheme.e0[None].astype(np.float32), E, 0)
    e0p, _ = fold_sweep_lanes(lspec, NPAD, e0)
    p = _planes(6, True, seed=4)
    base = _port(tspec, p, False, 100, None, None)
    out = _port(lspec, p, False, 100, e0p.numpy(), None)
    for a, b in zip(base, out):
        np.testing.assert_array_equal(a, b)


def test_unit_rabi_lanes_on_split_schemes_equal_full_scheme():
    """(om, om_dp) = (1, 1) on every lane of the split schemes is the full
    scheme (H is linear in each Rabi frequency), up to float32 reordering."""
    _, tspec = _specs(8)
    _, ospec = _specs(8, per_lane_om=True)
    _, omp = fold_sweep_lanes(ospec, NPAD, None, np.ones((E, 2), np.float32))
    p = _planes(8, True, seed=5)
    base = _port(tspec, p, False, 100, None, None)
    out = _port(ospec, p, False, 100, None, omp.numpy())
    _assert_close(base, out)


def test_tables_and_kernel_parameters_of_the_om_split():
    _, ospec = _specs(4, per_lane_om=True)
    ssp, sdp = ospec.scheme_sp, ospec.scheme_dp
    vecs, mats = tf.pack_tables(ospec)
    assert mats.shape == (80, 16)
    np.testing.assert_array_equal(mats[:12, :12],
                                  ssp.coupling.real.astype(np.float32))
    np.testing.assert_array_equal(mats[64:76, :12],
                                  sdp.coupling.real.astype(np.float32))
    p = tf._kernel_params(ospec)
    groups = list(p.force_g)[:p.n_force]
    # sr12: 4 SP terms scaled by om, 8 DP terms scaled by om_dp
    assert (p.n_force, groups.count(0), groups.count(1)) == (12, 4, 8)
    assert p.per_lane_om == 1 and p.per_lane_e0 == 0
    # beat notes from the om_dp=1 pattern
    assert list(p.tdep_row)[:p.n_tdep] == list(sdp.tdep_rows)
    np.testing.assert_allclose(list(p.tdep_coef)[:p.n_tdep],
                               [complex(m).real for m in sdp.tdep_coefs],
                               rtol=1e-7)


def test_lane_inputs_are_validated():
    _, tspec = _specs(2)
    _, lspec = _specs(2, per_lane_e0=True)
    p = {k: torch.from_numpy(v) for k, v in _planes(2, False, 6).items()}
    args = [p[k] for k in ARGS]
    with pytest.raises(ValueError, match="e0_lanes"):
        tf.fused_md_substeps(lspec, False, *args)
    with pytest.raises(ValueError, match="e0_lanes"):
        tf.fused_md_substeps(lspec, False, *args,
                             e0_lanes=torch.zeros((16, NPAD)))
    with pytest.raises(ValueError, match="e0_lanes"):
        tf.fused_md_substeps(tspec, False, *args,
                             e0_lanes=torch.zeros((16, E * NPAD)))
    with pytest.raises(ValueError, match="scheme_sp"):
        tf.fused_md_substeps(dataclasses.replace(tspec, per_lane_om=True),
                             False, *args, om_lanes=torch.ones((2, E * NPAD)))
    # the in-kernel RNG forms are built for sr12 (S=12) only; the per-lane
    # forms for every state count of the kernel
    with pytest.raises(ValueError, match="S=12"):
        tf._kernel_params(dataclasses.replace(tspec, scheme=tag422(),
                                              internal_rng=True))
    assert tf._kernel_params(dataclasses.replace(
        tspec, scheme=tag422(), per_lane_e0=True)).per_lane_e0 == 1
