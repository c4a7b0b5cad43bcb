"""The plain reference against the port's plain CPU versions at a tiny
size, both in float64, and the cooling configurations' frozen tables
against the port's own derivation and against the JAX package's
(``levels.py``, ``units.py``), which the port was ported from and checked
against.  Another family brings its own table tests as a file."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from harness import check, registry
from reference import mdqt
from tiny.cooling_fold import TINY_N0, tiny_config

import mdqtplasmasims_torch.experiments.laser_cooling as lc
from mdqtplasmasims_torch.core.rng import tick_uniforms
from mdqtplasmasims_torch.ops.kde import folded_bins
from mdqtplasmasims_torch.ops.yukawa import yukawa_forces_potential
from mdqtplasmasims_torch.state import make_state

WORD = 123456789


# the cooling configurations, by what the table tests compare: every
# configuration file with a level scheme and physics that build a
# CoolingConfig (another family's configuration has keys of its own)
_FIELDS = {f.name for f in dataclasses.fields(lc.CoolingConfig)}
CONFIGS = [n for n in registry.names("configs")
           if "scheme" in registry.config(n)
           and "n0" in registry.config(n).get("physics", {})
           and set(registry.config(n)["physics"]) <= _FIELDS]


def test_every_configuration_a_cooling_driver_runs_has_its_tables():
    """Each configuration that a workload of a driver comparing cooling's
    numbers runs is among the table tests' cases."""
    ran = set()
    for name in registry.names("workloads"):
        wl = registry.workload(name)
        if set(registry.driver(wl["driver"]).NUMBERS) == set(check.NUMBERS):
            ran.add(wl["config"])
    assert ran and ran <= set(CONFIGS), (ran, CONFIGS)

# Prints the JAX package's scheme and units of a configuration's physics
# as JSON (run in a process of its own, so that no test's process loads
# JAX)
_JAX_TABLES = """
import json, sys
import numpy as np
from mdqtplasmasims_tpu.experiments import laser_cooling as lc
from mdqtplasmasims_tpu.units import PlasmaUnits
phys = json.loads(sys.argv[1])
cfg = lc.CoolingConfig(**phys)
eng = lc.build_engine(cfg)
s = eng.scheme
u = PlasmaUnits(cfg.density, cfg.ge)
out = dict(
    decay_w=s.decay_w, e0=s.e0, e1=s.e1, coupling_re=s.coupling.real,
    coupling_im=s.coupling.imag, jump_dest=s.jump_dest,
    tdep_rows=s.tdep_rows, tdep_cols=s.tdep_cols,
    tdep_coefs_re=[complex(c).real for c in s.tdep_coefs],
    tdep_coefs_im=[complex(c).imag for c in s.tdep_coefs],
    tdep_freq=s.tdep_freq, force_a=s.force_a, force_b=s.force_b,
    force_w=s.force_w, jump_src=s.jump_src, branch_d_prob=s.branch_d_prob,
    kick_s=s.kick_s, kick_d=s.kick_d, n_states=s.n_states,
    L=PlasmaUnits.box_length(cfg.n0), ldeb=u.debye_length, ratio=cfg.ratio,
    qdt=cfg.qdt, h=eng.h, plas_to_quant_vel=eng.plas_to_quant_vel,
    gamma_to_einstein=eng.gamma_to_einstein)
out = {k: np.asarray(v).tolist() for k, v in out.items()}
out["manifolds"] = [list(lc.S_MANIFOLD), list(lc.P_MANIFOLD),
                    list(lc.D_MANIFOLD)]
print(json.dumps(out))
"""


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_tables_are_the_jax_packages(name):
    pytest.importorskip("jax")
    c = registry.config(name)
    root = os.path.dirname(registry.HERE)
    out = subprocess.run(
        [sys.executable, "-c", _JAX_TABLES, json.dumps(c["physics"])],
        capture_output=True, text=True, check=True, cwd=root,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 PYTHONPATH=os.pathsep.join(
                     [root, os.environ.get("PYTHONPATH", "")])))
    jax = json.loads(out.stdout.splitlines()[-1])
    s, d = c["scheme"], c["derived"]
    same = dict(rtol=1e-14, atol=0)
    for k in ("decay_w", "e0", "e1", "jump_dest", "force_w",
              "branch_d_prob", "kick_s", "kick_d", "tdep_freq"):
        np.testing.assert_allclose(s[k], jax[k], err_msg=k, **same)
    np.testing.assert_allclose(s["coupling"], jax["coupling_re"], **same)
    assert not np.any(jax["coupling_im"])
    np.testing.assert_allclose(s["tdep_coefs"], jax["tdep_coefs_re"], **same)
    assert not np.any(jax["tdep_coefs_im"])
    for k in ("n_states", "tdep_rows", "tdep_cols", "force_a", "force_b",
              "jump_src", "manifolds"):
        assert json.dumps(s[k]) == json.dumps(jax[k]), k
    for k in ("L", "ldeb", "ratio", "qdt", "h", "plas_to_quant_vel",
              "gamma_to_einstein"):
        np.testing.assert_allclose(d[k], jax[k], err_msg=k, **same)


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_tables_are_the_ports(name, monkeypatch):
    monkeypatch.setattr(lc, "_use_internal_rng", lambda device, rolls: True)
    c = registry.config(name)
    cfg = lc.CoolingConfig(**c["physics"])
    sched = lc.build_scheduler(cfg, "cpu")
    spec, sch, d, s = sched.fused_spec, sched.fused_spec.scheme, \
        c["derived"], c["scheme"]
    assert (d["L"], d["ldeb"], d["ratio"], d["qdt"], d["h"]) == (
        spec.L, sched.ldeb, spec.ratio, spec.qdt, spec.h)
    assert (d["plas_to_quant_vel"], d["gamma_to_einstein"], d["npad"]) == (
        spec.plas_to_quant_vel, spec.gamma_to_einstein,
        sched._npad(cfg.n0))
    for k in ("decay_w", "e0", "e1", "jump_dest"):
        np.testing.assert_array_equal(s[k], getattr(sch, k))
    np.testing.assert_array_equal(s["coupling"], sch.coupling.real)
    assert not np.any(sch.coupling.imag)
    assert s["force_w"] == list(sch.force_w)
    assert (s["kick_s"], s["kick_d"], s["branch_d_prob"]) == (
        sch.kick_s, sch.kick_d, sch.branch_d_prob)
    assert s["tdep_coefs"] == [complex(x).real for x in sch.tdep_coefs]


def test_uniforms_are_the_kernels_stream():
    lanes = torch.arange(3584 * 2, 3584 * 2 + 700, dtype=torch.int64)
    mine = mdqt.uniforms(WORD, 1000, 3, lanes)
    port = tick_uniforms(WORD, 1000, 3, 700, lane0=3584 * 2)
    assert torch.equal(mine.reshape(15, 700).to(torch.float32), port)


def _state(seed=7):
    c = tiny_config(registry.config("sr12_n3500"))
    st = registry.driver("cooling_fold").start_fold(c, 1, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    V = 0.3 * torch.randn((TINY_N0, 3), generator=g, dtype=torch.float64)
    return c, make_state(st.R[0], V, st.psi[0], device="cpu",
                         dtype=torch.float64)


def test_pair_forces_and_potential_are_the_ports():
    c, st = _state()
    L, ldeb = c["derived"]["L"], c["derived"]["ldeb"]
    F, pot = mdqt.pair_forces(st.R, L, ldeb, block=7, with_pot=True)
    Fp, potp = yukawa_forces_potential(st.R, L, ldeb)
    torch.testing.assert_close(F, Fp, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(pot, potp, rtol=1e-12, atol=1e-12)


def test_one_md_step_is_the_ports(monkeypatch):
    monkeypatch.setattr(lc, "_use_internal_rng", lambda device, rolls: True)
    c, st = _state(11)
    cfg = lc.CoolingConfig(**dict(c["physics"], dtype="float64"))
    sched = lc.build_scheduler(cfg, "cpu")
    sched.seed = torch.tensor([WORD], dtype=torch.int32)
    sc = mdqt.scheme_of(c)
    ions = mdqt.Ions(st.R, st.V, st.psi.real.clone(), st.psi.imag.clone(),
                     st.t_part, torch.arange(TINY_N0, dtype=torch.int64))
    for _ in range(3):               # the first step drifts to second order
        F = mdqt.pair_forces(ions.R, sc.L, sc.ldeb)[0]
        ions = mdqt.ticks(sc, ions, F, st.tick, sc.ratio, WORD,
                          first=st.tick == 0)
        st = sched.md_step(st)
        torch.testing.assert_close(ions.R, st.R, rtol=1e-11, atol=1e-11)
        torch.testing.assert_close(ions.V, st.V, rtol=1e-11, atol=1e-11)
        torch.testing.assert_close(ions.a, st.psi.real, rtol=1e-9,
                                   atol=1e-11)
        torch.testing.assert_close(ions.b, st.psi.imag, rtol=1e-9,
                                   atol=1e-11)
        torch.testing.assert_close(ions.tp, st.t_part)


def test_observables_are_the_ports():
    c, st = _state(5)
    sc = mdqt.scheme_of(c)
    cfg = lc.CoolingConfig(**dict(c["physics"], dtype="float64"))
    mine = mdqt.observables(sc, st.R, st.V, st.psi.real, st.psi.imag)
    port = lc._sample_outputs(st, cfg, sc.L, sc.ldeb,
                              folded_bins(torch.float64))
    for k in ("ekin", "epot", "vx_mean", "pvel", "vx_ions", "pops"):
        torch.testing.assert_close(mine[k], port[k].to(torch.float64),
                                   rtol=1e-10, atol=1e-12)
