"""Port vs JAX package: ``QTEngine.step_sm(params=, force_scale=)`` (a sweep
member's own detuning and Rabi frequency on a unit scheme, CPU, the same
numpy inputs and uniforms through both engines), and the master-equation
checks of tests/test_qt_engine.py:74-115 run against the port's engine.

Tolerances: float32 vx/t_part 2e-5 and psi 5e-5 (the bars of
tests/test_fused.py:91-101), float64 1e-12; trajectory averages against
the density matrix 0.03-0.04 (3000 trajectories, as the JAX package's
test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.core import qt as jqt
from mdqtplasmasims_tpu.levels import tag408, tag422, three_state
from mdqtplasmasims_torch.core import qt as tqt
from test_qt_engine import lindblad_rk4

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, jnp.float32, 2e-5, 5e-5),
          "float64": (np.float64, jnp.float64, 1e-12, 1e-12)}
UNIT = {"three_state": lambda: three_state(1.0, 1.0),
        "tag422": lambda: tag422(1.0, 1.0),
        "tag408_linear": lambda: tag408(1.0, 1.0, True)}


@pytest.mark.parametrize("dt_name", ["float32", "float64"])
@pytest.mark.parametrize("name", list(UNIT))
def test_step_sm_params_and_force_scale_match_jax(name, dt_name):
    """Eight chained ticks on the unit scheme with a member's (detuning,
    om) handed in as ``params`` (JAX: ``sweep_qt_params``) and the
    Ehrenfest kick scaled by om."""
    np_t, j_t, atol, patol = DTYPES[dt_name]
    np_c = np.complex64 if np_t == np.float32 else np.complex128
    th_c = torch.complex64 if np_t == np.float32 else torch.complex128
    th_t = torch.float32 if np_t == np.float32 else torch.float64
    scheme = UNIT[name]()
    det, om = -0.7, 1.4
    kw = dict(h=0.01, dt_plasma=0.01, plas_to_quant_vel=1.3,
              gamma_to_einstein=1.0, apply_force=True)
    je, te = jqt.QTEngine(scheme, **kw), tqt.QTEngine(scheme, **kw)
    pj = jqt.sweep_qt_params(scheme, det, om, j_t,
                             jnp.complex64 if np_t == np.float32
                             else jnp.complex128)
    base = tqt._params(scheme, th_t, th_c, "cpu")
    pt = base._replace(e0=det * base.e0, coupling=om * base.coupling)
    np.testing.assert_allclose(pt.e0.numpy(), np.asarray(pj.e0), rtol=1e-6)
    np.testing.assert_allclose(pt.coupling.numpy(), np.asarray(pj.coupling),
                               rtol=1e-6)
    rng = np.random.default_rng(4)
    n, S = 96, scheme.n_states
    psi = rng.normal(size=(S, n)) + 1j * rng.normal(size=(S, n))
    psi = (psi / np.linalg.norm(psi, axis=0)).astype(np_c)
    vx = rng.normal(0, 0.4, n).astype(np_t)
    tp = np.abs(rng.normal(0, 1.0, n)).astype(np_t)
    sj = (jnp.asarray(psi), jnp.asarray(vx, j_t), jnp.asarray(tp, j_t))
    st = (torch.from_numpy(psi), torch.from_numpy(vx), torch.from_numpy(tp))
    plain = st
    for _ in range(8):
        rolls = rng.uniform(size=(5, n)).astype(np_t)
        rolls[0] *= 0.02
        sj = je.step_sm(*sj, rolls=jnp.asarray(rolls, j_t), params=pj,
                        force_scale=om)
        st = te.step_sm(*st, rolls=torch.from_numpy(rolls), params=pt,
                        force_scale=om)
        plain = te.step_sm(*plain, rolls=torch.from_numpy(rolls))
    assert int(np.sum(np.asarray(sj[2]) < 0.08)) > 5        # jumps fired
    for got, want, tol in zip(st, sj, (patol, atol, atol)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   rtol=0)
    # the override really took: the unit scheme alone goes elsewhere
    assert np.abs(plain[0].numpy() - st[0].numpy()).max() > 1e-3
    # [N,S] wrapper passes both through
    rolls = torch.from_numpy(rng.uniform(size=(5, n)).astype(np_t))
    a = te.step(st[0].T, st[1], st[2], rolls, params=pt, force_scale=om)
    b = te.step_sm(*st, rolls=rolls, params=pt, force_scale=om)
    assert torch.equal(a[0].T, b[0]) and torch.equal(a[1], b[1])


def test_force_scale_scales_only_the_ehrenfest_kick():
    scheme = three_state(-0.5, 0.5)
    eng = tqt.QTEngine(scheme, h=0.01, dt_plasma=0.01)
    rng = np.random.default_rng(5)
    n = 64
    psi = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    psi = torch.from_numpy(psi / np.linalg.norm(psi, axis=0))
    vx = torch.zeros(n, dtype=torch.float64)
    tp = torch.zeros(n, dtype=torch.float64)
    rolls = torch.from_numpy(rng.uniform(size=(5, n)))
    rolls[0, ::2] = 0.0                 # every other ion jumps
    one = eng.step_sm(psi, vx, tp, rolls)
    two = eng.step_sm(psi, vx, tp, rolls, force_scale=2.0)
    jumped = one[2] == 0
    assert jumped.sum() == n // 2
    assert torch.equal(one[0], two[0])
    np.testing.assert_allclose(two[1][~jumped].numpy(),
                               2.0 * one[1][~jumped].numpy(), rtol=1e-12)
    assert torch.equal(two[1][jumped], one[1][jumped])       # recoils


def _trajectory_pops(scheme, v, dt, nsteps, n_traj, seed=0):
    """Mean populations per tick of ``n_traj`` trajectories of the port's
    engine from the first state (tests/test_qt_engine.py's
    ``run_trajectories``)."""
    eng = tqt.QTEngine(scheme, h=dt, dt_plasma=dt, plas_to_quant_vel=1.0,
                       gamma_to_einstein=1.0, apply_force=False)
    g = torch.Generator().manual_seed(seed)
    psi = torch.zeros((scheme.n_states, n_traj), dtype=torch.complex128)
    psi[0] = 1.0
    vx = torch.full((n_traj,), v, dtype=torch.float64)
    tp = torch.zeros(n_traj, dtype=torch.float64)
    params = tqt._params(scheme, torch.float64, torch.complex128, "cpu")
    pops = []
    for _ in range(nsteps):
        psi, vx, tp = eng.step_sm(psi, vx, tp, generator=g, params=params)
        pops.append((psi.real ** 2 + psi.imag ** 2).mean(1).numpy())
    return np.array(pops)


@pytest.mark.parametrize("name,scheme,v,nsteps,skip,tol", [
    ("three_state", lambda: three_state(-0.5, 0.5), 0.3, 1500, 300, 0.03),
    ("tag422", lambda: tag422(-1.0, 1.3), 0.5, 1200, 200, 0.04),
    ("tag408_quad", lambda: tag408(0.0, 2.0, linear=False), 0.2, 1000, 200,
     0.04),
    ("tag408_linear", lambda: tag408(-2.5, 0.7, linear=True), 0.4, 1000, 200,
     0.04)])
def test_port_engine_agrees_with_master_equation(name, scheme, v, nsteps,
                                                 skip, tol):
    scheme = scheme()
    pops = _trajectory_pops(scheme, v, 0.01, nsteps, 3000)
    me = lindblad_rk4(scheme, v=v, dt=0.01, nsteps=nsteps)
    assert np.max(np.abs(pops[skip:] - me[skip:])) < tol
