"""The Monte-Carlo families' building blocks against the JAX package (CPU).

Each test feeds both packages the same inputs (seeded numpy or JAX draws)
and holds the port to the bar it states:

* ``lattice_init`` (positions exactly, velocities from JAX's normals
  exactly), the thermostat (collisions with JAX's draws replayed, the
  laser force, the rescale exactly; both temperatures to 1e-15
  relative in float64 and 5e-7 in float32, the summation order) and
  ``velocity_verlet_step`` (1e-12 in float64);
* ``MetropolisMC`` over 300-400 steps at n = 27 and 64 in float64, JAX's
  per-step draws replayed (:class:`JaxMcDraws`): the accept count equal
  and R within 1e-12; a fold of members with their own Gamma and
  screening length bitwise equal to each member's own chain; the physics
  checks of tests/test_classical.py:177-199 on the port's own chain;
* ``pair_correlation`` (float64: every bin equal; float32: within one
  pair count per bin) and ``static_structure_factor`` (1e-4 relative in
  float32, 1e-10 in float64);
* ``MCTagScheduler.md_step`` with JAX's ``[ratio, 5, n]`` rolls replayed,
  at the bars of tests/test_fused.py:91-101 (R/V/t_part 2e-5, psi 5e-5);
* the per-member ``ldeb [E]`` of the ``[E, N, 3]`` force entries on the
  CPU: equal bit for bit to member-by-member calls with each member's
  own float ldeb.

:class:`JaxMcDraws` (the JAX package's key chain of the two families'
``run`` and of their folds) is shared with tests/test_torch_transport.py
and tests/test_torch_mc_tagging.py.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu.core import init as jinit
from mdqtplasmasims_tpu.core import md as jmd
from mdqtplasmasims_tpu.core import thermostat as jth
from mdqtplasmasims_tpu.core.mc import MetropolisMC as JMC
from mdqtplasmasims_tpu.core.qt import random_s_superposition
from mdqtplasmasims_tpu.experiments import mc_qt_tagging as jmt
from mdqtplasmasims_tpu.ops import structure as jst
from mdqtplasmasims_tpu.ops.yukawa import yukawa_forces_potential as jforces
from mdqtplasmasims_tpu.state import make_state as jmake_state
from mdqtplasmasims_torch.core import init as tinit
from mdqtplasmasims_torch.core import md as tmd
from mdqtplasmasims_torch.core import thermostat as tth
from mdqtplasmasims_torch.core.draws import MemberDraws
from mdqtplasmasims_torch.core.mc import McDraws, MetropolisMC, draw_mc
from mdqtplasmasims_torch.experiments import mc_qt_tagging as tmt
from mdqtplasmasims_torch.ops import structure as tst
from mdqtplasmasims_torch.ops import yukawa as ty
from mdqtplasmasims_torch.state import SimState

torch.set_num_threads(1)

DT = {"float32": (jnp.float32, torch.float32),
      "float64": (jnp.float64, torch.float64)}


def box(n):
    return (n * 4.0 * np.pi / 3.0) ** (1.0 / 3.0)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x)).to(dtype) if dtype else \
        torch.from_numpy(np.array(x))


def jax_mc_steps(key, n_steps, n):
    """The JAX chain's per-step draws (core/mc.py:51-77 there), as
    :class:`McDraws` with no member axis: ``split(key, n_steps)``, then
    per step ``kp, km, ka`` -> ion, ``kd, kr`` -> direction and radius,
    ``ka`` -> acceptance, at the dtypes JAX draws them (float64, int64
    under the tests' x64)."""
    def one(k):
        kp, km, ka = jax.random.split(k, 3)
        kd, kr = jax.random.split(km)
        return (jax.random.randint(kp, (), 0, n), jax.random.normal(kd, (3,)),
                jax.random.uniform(kr), jax.random.uniform(ka))
    i, d, ur, ua = jax.vmap(one)(jax.random.split(key, n_steps))
    return McDraws(_t(i, torch.int64), _t(d), _t(ur), _t(ua))


class JaxMcDraws:
    """Replays the key chain of the JAX package's ``run`` of either family
    (``keys`` one key) or of its fold (a list, one key per member), as the
    port's ``draws`` (core/draws.MemberDraws's methods): per member
    ``split(key, 4)`` (transport: k_lat, k_mc, k_tag, k_run) or ``split(key,
    5)`` (mc-tag: k_lat, k_psi, k_mc, k_tag, k_run); the chunk keys
    ``split(k_mc, n_chunks)``; one ``split`` of k_run per MD step (the
    collisions from its second half), per pump MD step (the ``[ratio, 5,
    n]`` rolls) and at the measurement (k_run becomes the first half)."""

    def __init__(self, keys, family, n_chunks):
        self.single = not isinstance(keys, (list, tuple))
        self.m = []
        for key in ([keys] if self.single else keys):
            if family == "transport":
                k_lat, k_mc, k_tag, k_run = jax.random.split(key, 4)
                k_psi = None
            else:
                k_lat, k_psi, k_mc, k_tag, k_run = jax.random.split(key, 5)
            self.m.append(dict(lat=k_lat, psi=k_psi, tag=k_tag, run=k_run,
                               mc=list(jax.random.split(k_mc, n_chunks))))

    def _stack(self, draw, dim=0):
        return torch.stack([torch.from_numpy(np.array(draw(m)))
                            for m in self.m], dim=dim)

    def _split_run(self, m):
        m["run"], sub = jax.random.split(m["run"])
        return sub

    def start_v(self, n, dtype):
        jd = DT[str(dtype).split(".")[1]][0]
        return self._stack(lambda m: jax.random.normal(m["lat"], (n, 3), jd))

    def psi(self, n, n_states, cdtype):
        jc = jnp.complex64 if cdtype == torch.complex64 else jnp.complex128
        return self._stack(lambda m: random_s_superposition(m["psi"], n,
                                                            n_states, jc))

    def mc(self, n_steps, n, dtype):
        per = [jax_mc_steps(m["mc"].pop(0), n_steps, n) for m in self.m]
        return McDraws(*(torch.stack(x, 1) for x in zip(*per)))

    def md_step(self, n, dtype, collide):
        subs = [self._split_run(m) for m in self.m]
        if not collide:
            return None
        jd = DT[str(dtype).split(".")[1]][0]
        pairs = [jax.random.split(kc) for kc in subs]
        u = torch.stack([_t(jax.random.uniform(kr, (n,))) for kr, _ in pairs])
        z = torch.stack([_t(jax.random.normal(kv, (n, 3), jd))
                         for _, kv in pairs])
        return u, z

    def tags(self, n, dtype):
        return self._stack(lambda m: jax.random.uniform(m["tag"], (4, n)))

    def pump(self, ratio, lanes):
        n = lanes[-1]
        return self._stack(lambda m: jax.random.uniform(
            self._split_run(m), (ratio, 5, n), jnp.float32), dim=2)

    def measure(self, lanes, dtype):
        jd = DT[str(dtype).split(".")[1]][0]

        def draw(m):
            key2, k_meas = jax.random.split(m["run"])
            m["run"] = key2
            return jax.random.uniform(k_meas, (lanes[-1],), jd)
        return self._stack(draw)

    def key_state(self):
        return np.asarray(self.m[0]["run"]) if self.single else None


# ------------------------------------------------------------------ init

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,gamma", [(27, 3.0), (64, 0.7)])
def test_lattice_init_matches_jax(n, gamma, dtype):
    jd, td = DT[dtype]
    L = box(n)
    key = jax.random.PRNGKey(n)
    Rj, Vj = jinit.lattice_init(key, n, gamma, L, dtype=jd)
    z = torch.from_numpy(np.array(jax.random.normal(key, (n, 3), jd)))
    Rt, Vt = tinit.lattice_init(None, n, gamma, L, td, "cpu", V=z)
    np.testing.assert_array_equal(Rt.numpy(), np.asarray(Rj))
    np.testing.assert_array_equal(Vt.numpy(), np.asarray(Vj))
    g = torch.Generator().manual_seed(1)
    R2, V2 = tinit.lattice_init(g, n, gamma, L, td)
    assert torch.equal(R2, Rt) and V2.dtype == td
    assert abs(float(V2.var()) - 1.0 / gamma) < 0.6 / gamma
    with pytest.raises(ValueError, match="cubic"):
        tinit.lattice_init(g, 30, gamma, L)
    sig = tinit.mb_velocities(torch.Generator().manual_seed(2), 4000, 0.5)
    assert sig.shape == (4000, 3) and abs(float(sig.std()) - 0.5) < 0.02


# ------------------------------------------------------------ thermostat

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_thermostat_matches_jax(dtype):
    jd, td = DT[dtype]
    rng = np.random.default_rng(3)
    V = rng.normal(size=(64, 3)) * 0.6
    Vj, Vt = jnp.asarray(V, jd), torch.from_numpy(V).to(td)
    key = jax.random.PRNGKey(4)
    for cf in (0.25, 40.0):
        want = jth.collide_and_kick(Vj, key, dt=0.005, collision_freq=cf,
                                    gamma=3.0)
        kroll, kv = jax.random.split(key)
        draws = (_t(jax.random.uniform(kroll, (64,))),
                 _t(jax.random.normal(kv, (64, 3), jd)))
        got = tth.collide_and_kick(Vt, draws, dt=0.005, collision_freq=cf,
                                   gamma=3.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(np.asarray(want), V.astype(jd))
    # nothing drawn without collisions
    g = torch.Generator().manual_seed(5)
    s0 = g.get_state()
    none = MemberDraws([g]).md_step(64, td, False)
    assert tth.collide_and_kick(Vt, none, dt=0.005, collision_freq=0.0,
                                gamma=3.0) is Vt
    assert torch.equal(g.get_state(), s0)
    for one_axis in (False, True):
        np.testing.assert_array_equal(
            tth.laser_force(Vt, dt=0.005, beta=26000.0, density=0.4,
                            one_axis_only=one_axis).numpy(),
            np.asarray(jth.laser_force(Vj, dt=0.005, beta=26000.0,
                                       density=0.4,
                                       one_axis_only=one_axis)))
    np.testing.assert_array_equal(
        tth.anisotropize_velocities(Vt, 0.15).numpy(),
        np.asarray(jth.anisotropize_velocities(Vj, 0.15)))
    ulp = 1e-15 if dtype == "float64" else 5e-7
    np.testing.assert_allclose(tth.temperature(Vt).numpy(),
                               np.asarray(jth.temperature(Vj)), rtol=ulp)
    np.testing.assert_allclose(tth.temperature_per_axis(Vt).numpy(),
                               np.asarray(jth.temperature_per_axis(Vj)),
                               rtol=ulp)


def test_thermostat_fold_matches_members():
    """A fold ``[E, N, 3]`` with per-member Gamma equals its members."""
    g = torch.Generator().manual_seed(6)
    V = torch.randn((3, 27, 3), generator=g)
    u, z = torch.rand((3, 27), generator=g), torch.randn((3, 27, 3),
                                                        generator=g)
    gam = torch.tensor([1.0, 3.0, 10.0], dtype=torch.float64)
    fold = tth.collide_and_kick(V, (u, z), dt=0.005, collision_freq=40.0,
                                gamma=gam)
    for j, gj in enumerate((1.0, 3.0, 10.0)):
        one = tth.collide_and_kick(V[j], (u[j], z[j]), dt=0.005,
                                   collision_freq=40.0, gamma=gj)
        assert torch.equal(fold[j], one)
        assert torch.equal(tth.temperature(V)[j], tth.temperature(V[j]))
        assert torch.equal(tth.temperature_per_axis(V)[j],
                           tth.temperature_per_axis(V[j]))


def test_velocity_verlet_step_matches_jax():
    n, L, ldeb = 64, box(64), 2.0
    rng = np.random.default_rng(7)
    R, V, A = (rng.uniform(0, L, (n, 3)), rng.normal(size=(n, 3)),
               rng.normal(size=(n, 3)) * 0.1)
    want = jmd.velocity_verlet_step(
        jnp.asarray(R), jnp.asarray(V), jnp.asarray(A), 0.005, L,
        lambda R: jforces(R, L, ldeb)[0])
    got = tmd.velocity_verlet_step(
        *(torch.from_numpy(x) for x in (R, V, A)), 0.005, L,
        lambda R: ty.yukawa_forces_potential(R, L, ldeb)[0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


# -------------------------------------------------------------- the chain

@pytest.mark.parametrize("n,n_steps,gamma,kappa", [(27, 400, 3.0, 0.5),
                                                   (64, 300, 10.0, 1.0)])
def test_metropolis_matches_jax_with_replayed_draws(n, n_steps, gamma,
                                                    kappa):
    L = box(n)
    R0 = jax.random.uniform(jax.random.PRNGKey(n), (n, 3), jnp.float64, 0, L)
    key = jax.random.PRNGKey(11)
    Rj, acc_j = JMC(L=L, ldeb=1 / kappa, gamma=gamma).run(R0, key, n_steps)
    Rt, acc_t = MetropolisMC(L=L, ldeb=1 / kappa, gamma=gamma).run(
        _t(R0), draws=jax_mc_steps(key, n_steps, n))
    assert int(acc_t) == int(acc_j) and 0 < int(acc_t) < n_steps
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0,
                               atol=1e-12)


def test_metropolis_fold_equals_each_members_chain():
    """Per-member Gamma, ldeb, ion draws: member j of the fold is its own
    chain bit for bit (float32, the port's own draws)."""
    n, L = 64, box(64)
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
    R0 = torch.rand((3, n, 3), generator=gens[0]) * L
    draws = draw_mc(gens, 200, n)
    gam, ld = (1.0, 3.0, 10.0), (2.0, 1.0, 3.3)
    Rf, accf = MetropolisMC(L=L, ldeb=ld, gamma=gam).run(R0, draws=draws)
    for j in range(3):
        # contiguous, as a member's own draws come (a strided operand takes
        # torch's scalar loop, whose pow is not the vector loop's)
        one = McDraws(*(x[:, j].contiguous() for x in draws))
        Rj, accj = MetropolisMC(L=L, ldeb=ld[j], gamma=gam[j]).run(
            R0[j], draws=one)
        assert torch.equal(Rf[j], Rj) and int(accf[j]) == int(accj)
    assert len(set(accf.tolist())) == 3


def test_mc_lowers_energy_and_builds_correlation_hole():
    """tests/test_classical.py:177-190 on the port's own chain."""
    n, gamma, kappa = 64, 10.0, 0.5
    L = box(n)
    g = torch.Generator().manual_seed(0)
    R = torch.rand((n, 3), generator=g, dtype=torch.float64) * L
    ep0 = float(ty.yukawa_potential(R, L, 1 / kappa))
    R2, acc = MetropolisMC(L=L, ldeb=1 / kappa, gamma=gamma).run(
        R, torch.Generator().manual_seed(1), 5000)
    ep1 = float(ty.yukawa_potential(R2, L, 1 / kappa))
    assert ep1 < ep0
    assert 0.05 < float(acc) / 5000 < 0.99
    gr = tst.pair_correlation(R2, L, chunk=32).numpy()
    assert gr[:8].max() < 0.5   # correlation hole at small r


def test_mc_detailed_balance_roundtrip():
    """tests/test_classical.py:192-199: at gamma -> 0 acceptance -> 1."""
    n = 27
    L = box(n)
    R = torch.rand((n, 3), generator=torch.Generator().manual_seed(2),
                   dtype=torch.float64) * L
    _, acc = MetropolisMC(L=L, ldeb=2.0, gamma=1e-6).run(
        R, torch.Generator().manual_seed(3), 1000)
    assert float(acc) / 1000 > 0.99


# ------------------------------------------------------------- structure

@pytest.mark.parametrize("n", [27, 216])
def test_pair_correlation_matches_jax(n):
    L = box(n)
    R = np.random.default_rng(n).uniform(0, L, (n, 3))
    want = np.asarray(jst.pair_correlation(jnp.asarray(R), L, chunk=64))
    got = tst.pair_correlation(torch.from_numpy(R), L, chunk=64).numpy()
    assert got.shape == (400,) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # float32: a pair may land across a bin edge from XLA's -- one count
    R32 = R.astype(np.float32)
    w32 = np.asarray(jst.pair_correlation(jnp.asarray(R32), L))
    g32 = tst.pair_correlation(torch.from_numpy(R32), L).numpy()
    n_use = int(min(400, np.floor(L / 2 / 0.05)))
    i = np.arange(n_use)
    shell = np.where(i == 0, (n * 4 // 3) * np.pi * 0.05 ** 3,
                     n * 3.0 * 0.05 ** 3 * i * i)
    counts = np.abs(g32 - w32)[:n_use] * shell
    assert counts.max() <= 2.0 + 1e-3      # one pair, counted both ways
    assert (g32[n_use:] == 0).all()


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4),
                                        ("float64", 1e-10)])
def test_static_structure_factor_matches_jax(dtype, rtol):
    jd, td = DT[dtype]
    n = 64
    L = box(n)
    R = np.random.default_rng(9).uniform(0, L, (n, 3))
    kv = jst.k_grid(L, 4)
    want = np.asarray(jst.static_structure_factor(jnp.asarray(R, jd),
                                                  jnp.asarray(kv, jd)))
    got = tst.static_structure_factor(torch.from_numpy(R).to(td),
                                      torch.from_numpy(kv))
    assert got.dtype == td and got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * n)
    assert abs(float(got[0]) - n) < 1e-3


# ------------------------------------------------------------- scheduler

@pytest.mark.parametrize("variant", ["422linear", "408quad"])
def test_mc_tag_scheduler_matches_jax(variant):
    """Two pump MD steps from the same state, JAX's ``[ratio, 5, n]``
    rolls replayed; R/V/F/t_part 2e-5, psi 5e-5 (tests/test_fused.py's
    bars), tick and t exactly."""
    cfg_j = jmt.MCTagConfig(variant=variant, n=27)
    cfg_t = tmt.MCTagConfig(variant=variant, n=27)
    L = cfg_j.L
    key = jax.random.PRNGKey(3)
    kr, kv, kp, kr2 = jax.random.split(key, 4)
    R = jax.random.uniform(kr, (27, 3), jnp.float32, 0, L)
    V = jax.random.normal(kv, (27, 3), jnp.float32) * 0.6
    psi = random_s_superposition(kp, 27, cfg_j.n_states, jnp.complex64)
    F = jforces(R, L, 2.0)[0]
    sj = jmt._make_scheduler(cfg_j)
    st_j = jmake_state(R, V, psi, kr2)._replace(F=F)
    chain = [kr2]

    def rolls_fn(ratio, lanes):
        chain[0], sub = jax.random.split(chain[0])
        return _t(jax.random.uniform(sub, (ratio, 5, lanes[-1]),
                                     jnp.float32))
    m = tmt._members(cfg_t, 1, types.SimpleNamespace(pump=rolls_fn),
                     single=True)
    sched = dataclasses.replace(
        tmt._make_scheduler(cfg_t, m),
        forces_fn=lambda R: ty.yukawa_forces_potential(R, L, 2.0))
    s_t = SimState(R=_t(R), V=_t(V), F=_t(F), psi=_t(psi),
                   t_part=torch.zeros(27))
    for _ in range(2):
        st_j = sj.md_step(st_j)
        s_t = sched.md_step(s_t)
        for name, atol in (("R", 2e-5), ("V", 2e-5), ("F", 2e-5),
                           ("t_part", 2e-5), ("psi", 5e-5)):
            np.testing.assert_allclose(getattr(s_t, name).numpy(),
                                       np.asarray(getattr(st_j, name)),
                                       atol=atol, rtol=1e-5, err_msg=name)
        assert s_t.tick == int(st_j.tick) and s_t.t == float(st_j.t)
    assert (np.abs(s_t.psi.numpy()[:, 2:]) ** 2).sum() > 0


def test_member_draws_order_and_fold_independence():
    """A member's stream does not depend on its fold: member 1 of a
    3-member MemberDraws equals a 1-member one on the same generator,
    kind by kind (each with its member axis)."""
    def draws(seeds):
        return MemberDraws([torch.Generator().manual_seed(s) for s in seeds])
    a, b = draws([1, 2, 3]), draws([2])
    kinds = ((lambda d: d.start_v(8, torch.float32), 0),
             (lambda d: d.mc(5, 8, torch.float32).d, 1),
             (lambda d: d.md_step(8, torch.float32, True)[1], 0),
             (lambda d: d.tags(8, torch.float32), 0),
             (lambda d: d.psi(8, 5, torch.complex64), 0),
             (lambda d: d.pump(3, (1, 8)), 2),
             (lambda d: d.measure((1, 8), torch.float32), 0))
    for kind, axis in kinds:
        assert torch.equal(kind(a).narrow(axis, 1, 1), kind(b))
    assert a.md_step(8, torch.float32, False) is None
    assert a.key_state() is None


# --------------------------------------------- per-member ldeb on the CPU

@pytest.mark.parametrize("use_pallas", [None, True, False])
def test_batched_force_entries_take_per_member_ldeb(use_pallas):
    """``best_forces_fn_batched`` and
    ``yukawa_forces_potential_pallas_batched`` with ``ldeb [E]`` on the CPU
    equal member-by-member calls with each member's own float ldeb, bit
    for bit (the sweep fold's force refresh)."""
    n, L = 64, box(64)
    ldebs = (2.0, 1.0 / 0.3, 1.25)
    g = torch.Generator().manual_seed(8)
    R = torch.rand((3, n, 3), generator=g) * L
    ld = torch.tensor(ldebs, dtype=torch.float64)
    F, pot = ty.best_forces_fn_batched(n, L, ld, use_pallas=use_pallas)(R)
    for j, lj in enumerate(ldebs):
        Fj, pj = ty.best_forces_fn(n, L, lj, use_pallas=use_pallas)(R[j])
        assert torch.equal(F[j], Fj)
        assert (pot is None) == (pj is None)
        if pot is not None:
            assert torch.equal(pot[j], pj)
    F2, p2 = ty.yukawa_forces_potential_pallas_batched(R, L, ld)
    for j, lj in enumerate(ldebs):
        Fj, pj = ty.yukawa_forces_potential(R[j], L, lj)
        assert torch.equal(F2[j], Fj) and torch.equal(p2[j], pj)
    assert not torch.allclose(F2[0], ty.yukawa_forces_potential(
        R[0], L, ldebs[1])[0])
    with pytest.raises(ValueError, match="ldeb"):
        ty.yukawa_forces_potential_pallas_batched(R, L, ld[:2])
