"""QT-only toy: 3-level laser cooling of free (non-interacting) ions.

Counterpart of ``mdqtplasmasims_tpu/experiments/three_state.py``
(laserCoolNoPlasmaThreeState.cpp): N0 ions with Maxwell-Boltzmann
velocities at ``temperature_k``, ground-state wavefunctions, evolved by
the 3-state QT engine with counter-propagating beams along x (recoil kicks
applied when ``apply_force``).  No Coulomb forces; time is in 1/gamma
units (dt = 0.01).  Output: mean x kinetic energy every ``sample_freq``
ticks (energies.dat: t, EkinX; reference output(), lines 296-347).

The ticks go through the tick kernel (core/qt_fused.fused_md_substeps at
S = 3; its plain twin on the CPU) as free ions: one launch per block of
ticks (:func:`roll_block`) for all ions of a run, or for all members of a
fold (``E x npad`` lanes, n0 padded to a multiple of 128), a sweep's
members through the kernel's per-lane forms.  Each tick is the JAX
package's ``QTEngine.step_sm`` tick.  The per-segment records stay on the
device until the run ends (one host fetch per run).  The kernel is
float32: float64 runs on the CPU only.

Randomness: explicit ``torch.Generator`` objects.  A run draws its start
velocities and then its jump uniforms from one generator; member j of a
fold has a generator of its own, seeded with laser_cooling.member_seed
``(seed, j)``, so a member comes out the same in a fold of any size (as
the JAX package's per-member keys make it).  The uniforms of a block of
ticks come from one ``torch.rand`` per generator; ``rolls_fn`` replaces
the draw (tests replay the JAX package's key chain through it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.pipeline import check_device
from ..core.qt import QTEngine, QTParams, sweep_member_cfgs
from ..core.scheduler import (free_ion_spec, free_ion_ticks, member_sweep,
                              sweep_lanes)
from ..io.datfiles import DatWriter
from ..io.dirs import three_state_dir
from ..levels import three_state
from ..state import complex_dtype
from ..units import SQRT_KELVIN_TO_PLASMA_VEL
from .laser_cooling import member_seed

#: most uniforms one ``rolls_fn`` call draws (floats; 64 MiB in float32)
ROLL_BLOCK_FLOATS = 2 ** 24


@dataclasses.dataclass(frozen=True)
class ThreeStateConfig:
    n0: int = 1000
    detuning: float = -0.5
    om: float = 0.5
    temperature_k: float = 0.01
    tmax: float = 45000.0
    dt: float = 0.01
    sample_freq: int = 1000
    apply_force: bool = True
    vkick: float = 0.0012076       # laserCoolNoPlasmaThreeState.cpp:88
    # segments per device dispatch in the JAX package; the port launches
    # per roll block, so the value changes nothing (kept so that both
    # packages take the same configuration and flags)
    dispatch_segments: int = 500
    job: int = 1
    dtype: str = "float32"
    save_directory: Optional[str] = None

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32

    @property
    def n_segments(self) -> int:
        return int(self.tmax / self.dt) // self.sample_freq

    @property
    def t_axis(self) -> np.ndarray:
        return (np.arange(1, self.n_segments + 1) * self.sample_freq) * self.dt


def build_engine(cfg: ThreeStateConfig) -> QTEngine:
    return QTEngine(three_state(cfg.detuning, cfg.om, cfg.vkick),
                    h=cfg.dt, dt_plasma=cfg.dt, plas_to_quant_vel=1.0,
                    gamma_to_einstein=1.0, apply_force=cfg.apply_force)


def tick_rolls(generators) -> Callable:
    """``rolls_fn(n_ticks, lanes) -> [n_ticks, 5, *lanes]`` uniforms in
    [0, 1), drawn on the generators' device (no host sync): ``lanes =
    (n,)`` from one ``torch.Generator``, or ``(E, n)`` from a list of E,
    member j's block from generator j."""
    def draw(g, n_ticks, n):
        return torch.rand((n_ticks, 5, n), generator=g, dtype=torch.float32,
                          device=g.device)

    def rolls_fn(n_ticks: int, lanes) -> torch.Tensor:
        if isinstance(generators, torch.Generator):
            return draw(generators, n_ticks, *lanes)
        return torch.stack([draw(g, n_ticks, lanes[1]) for g in generators],
                           dim=2)
    return rolls_fn


def roll_block(cfg: ThreeStateConfig, lanes) -> int:
    """Ticks of one launch and one ``rolls_fn`` draw for ``lanes`` (the
    ions of a run, ``(n,)``, or of a fold, ``(E, n)``): a segment's
    ``sample_freq`` ticks, or fewer where their uniforms would pass
    :data:`ROLL_BLOCK_FLOATS`."""
    return max(1, min(cfg.sample_freq,
                      ROLL_BLOCK_FLOATS // (5 * int(np.prod(lanes)))))


def run_compiled(cfg: ThreeStateConfig, vx, psi_sm, t_part,
                 rolls_fn: Callable, n_segments: int, sweep=(None, None),
                 mesh=None):
    """``n_segments`` segments of ``sample_freq`` ticks from ``vx [..., n]``,
    ``psi_sm [..., S, n]`` (state-major) and ``t_part [..., n]``, one run
    or a fold with the member axis leading.  ``sweep``: ``(e0 [E, S] |
    None, om [E] | None)``, the members' own diagonal energies and Rabi
    scales ``om_j / cfg.om`` (core/scheduler.member_sweep; the kernel
    scales the coupling and the om-linear Ehrenfest kick by it).  ``mesh``
    spreads the members over the mesh's ``ens`` slots.  Each block of
    ticks is one launch of the tick kernel (per slot: on several cards
    the host enqueues the slots' launches one after the other and the
    cards run them at once).  Returns ``((vx, psi_sm,
    t_part), recs)`` with ``recs [..., n_segments, 2]`` on the device: per
    segment ``mean(0.5 vx^2)`` and ``mean(|psi_0|^2)`` over the real
    ions."""
    lanes = tuple(vx.shape)
    dtype = vx.dtype
    block = roll_block(cfg, lanes)
    spec = free_ion_spec(build_engine(cfg), block, sweep[0] is not None,
                         sweep[1] is not None)

    def ticks(vx, psi_sm, tp, rolls, e0, om):
        # rolls [..., nt, 5, n] (members leading, the form member_sharded
        # splits) -> the draw order [nt, 5, ..., n]
        return free_ion_ticks(spec, vx, psi_sm, tp,
                              rolls.movedim((-3, -2), (0, 1)), e0, om)

    if mesh is not None:
        from ..parallel.ensemble import member_sharded
        ticks = member_sharded(ticks, mesh)
    recs = []
    for _ in range(n_segments):
        done = 0
        while done < cfg.sample_freq:
            nt = min(block, cfg.sample_freq - done)
            # [nt, 5, *lanes] -> members (if any) leading
            rolls = rolls_fn(nt, lanes).to(dtype).movedim((0, 1), (-3, -2))
            vx, psi_sm, t_part = ticks(vx, psi_sm, t_part, rolls, *sweep)
            done += nt
        recs.append(torch.stack(
            [torch.mean(0.5 * vx ** 2, dim=-1),
             torch.mean(torch.abs(psi_sm[..., 0, :]) ** 2, dim=-1)], dim=-1))
    recs = (torch.stack(recs, dim=-2) if recs
            else torch.zeros(lanes[:-1] + (0, 2), dtype=dtype,
                             device=vx.device))
    return (vx, psi_sm, t_part), recs


def _initial_v(cfg: ThreeStateConfig, generator: torch.Generator):
    sigma = SQRT_KELVIN_TO_PLASMA_VEL * np.sqrt(cfg.temperature_k)
    return torch.randn((cfg.n0, 3), generator=generator,
                       dtype=cfg.torch_dtype,
                       device=generator.device) * float(sigma)


def _start(cfg: ThreeStateConfig, V: torch.Tensor):
    """Ground-state wavefunctions (state-major) and zero ion clocks for
    the velocities ``V [..., n0, 3]``."""
    lead = tuple(V.shape[:-2])
    psi_sm = torch.zeros(lead + (3, cfg.n0), dtype=complex_dtype(V.dtype),
                         device=V.device)
    psi_sm[..., 0, :] = 1.0
    return psi_sm, torch.zeros(lead + (cfg.n0,), dtype=V.dtype,
                               device=V.device)


def _given_v(cfg: ThreeStateConfig, V, device, lead=()) -> torch.Tensor:
    V = torch.as_tensor(np.array(V)).to(device=device, dtype=cfg.torch_dtype)
    if tuple(V.shape) != tuple(lead) + (cfg.n0, 3):
        raise ValueError(f"want V {tuple(lead) + (cfg.n0, 3)}, got "
                         f"{tuple(V.shape)}")
    return V


def _write_energies(cfg: ThreeStateConfig, ekin_x: np.ndarray) -> None:
    d = three_state_dir(cfg.save_directory, om=cfg.om, detuning=cfg.detuning,
                        n0=cfg.n0, temperature_k=cfg.temperature_k,
                        job=cfg.job)
    DatWriter(d).append("energies.dat", np.stack([cfg.t_axis, ekin_x], -1))


def run(cfg: ThreeStateConfig, seed: Optional[int] = None, device="cuda",
        V=None, rolls_fn: Optional[Callable] = None):
    """One job on ``device``.  Returns ``dict(t, ekin_x, ground_pop, V)``
    (host numpy) and appends ``energies.dat`` under ``cfg.save_directory``.
    The start velocities and the jump uniforms come from one generator on
    ``device`` seeded with ``seed`` (default ``cfg.job``); ``V [n0, 3]``
    replaces the drawn start and ``rolls_fn`` the drawn uniforms
    (:func:`tick_rolls`)."""
    device = torch.device(device)
    check_device(cfg, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.job if seed is None else seed)
    V = (_initial_v(cfg, generator) if V is None
         else _given_v(cfg, V, device))
    psi_sm, tp = _start(cfg, V)
    (vx, _, _), recs = run_compiled(cfg, V[:, 0], psi_sm, tp,
                                    rolls_fn or tick_rolls(generator),
                                    cfg.n_segments)
    V = V.clone()
    V[:, 0] = vx
    recs = recs.cpu().numpy()               # the run's one fetch
    results = dict(t=cfg.t_axis, ekin_x=recs[:, 0], ground_pop=recs[:, 1],
                   V=V.cpu().numpy())
    if cfg.save_directory is not None:
        _write_energies(cfg, recs[:, 0])
    return results


def _run_fold(cfg: ThreeStateConfig, member_cfgs, seed: int, mesh, device,
              V, rolls_fn, sweep=(None, None)):
    """The fold behind :func:`run_ensemble` and :func:`run_sweep`: member
    j draws its start and then its uniforms from a generator seeded with
    ``member_seed(seed, j)``."""
    device = torch.device(mesh.home if mesh is not None else device)
    check_device(cfg, device)
    E = len(member_cfgs)
    generators = [torch.Generator(device=device).manual_seed(
        member_seed(seed, j)) for j in range(E)]
    V = (torch.stack([_initial_v(cfg, g) for g in generators]) if V is None
         else _given_v(cfg, V, device, lead=(E,)))
    psi_sm, tp = _start(cfg, V)
    (vx, _, _), recs = run_compiled(cfg, V[..., 0], psi_sm, tp,
                                    rolls_fn or tick_rolls(generators),
                                    cfg.n_segments, sweep=sweep, mesh=mesh)
    V = V.clone()
    V[..., 0] = vx
    recs = recs.cpu().numpy()               # [E, n_segments, 2], one fetch
    results = dict(t=cfg.t_axis, ekin_x=recs[:, :, 0],
                   ground_pop=recs[:, :, 1], V=V.cpu().numpy())
    for j, mcfg in enumerate(member_cfgs):
        if mcfg.save_directory is not None:
            _write_energies(mcfg, recs[j, :, 0])
    return results


def run_ensemble(cfg: ThreeStateConfig, n_jobs: int, seed: int = 0,
                 mesh=None, device="cuda", V=None,
                 rolls_fn: Optional[Callable] = None):
    """Batched job array: ``n_jobs`` independent jobs as one fold (the
    ions are independent already, so this is one launch over all members'
    lanes per block of ticks, with per-job output rows).  Writes each
    job's energies.dat; returns the stacked results dict (``ekin_x [E,
    n_segments]``, ...).  ``mesh`` spreads the jobs over the mesh's
    ``ens`` slots; ``V [E, n0, 3]`` and ``rolls_fn`` as in :func:`run`."""
    member_cfgs = [dataclasses.replace(cfg, job=j + 1) for j in range(n_jobs)]
    return _run_fold(cfg, member_cfgs, seed, mesh, device, V, rolls_fn)


def run_sweep(cfg: ThreeStateConfig, points, jobs_per_point: int = 1,
              seed: int = 0, mesh=None, device="cuda", V=None,
              rolls_fn: Optional[Callable] = None,
              qt_params: Optional[QTParams] = None):
    """A laser (detuning, om) grid as ONE fold.

    The reference compiles detuning/Om into the binary
    (laserCoolNoPlasmaThreeState.cpp:85-87) and rebuilds per point.  The
    toy Hamiltonian is linear in both knobs, so each member carries its
    own tables into the tick kernel's per-lane forms (core/scheduler.
    member_sweep): its own scheme's e0, and cfg's coupling and Ehrenfest
    kick (both om-linear; jump recoils are fixed at vkick) scaled by om /
    cfg.om.

    ``points``: dicts with keys among ``detuning``/``om``.
    ``jobs_per_point`` replicates each point with independent seeds;
    member order is point-major.  Writes each member's energies.dat under
    its own Om/detuning-encoded directory.  ``qt_params`` replaces the
    tables built from the points (``[E]``-batched, bridge.
    qt_params_from_numpy; core/scheduler.sweep_lanes checks that its
    couplings are cfg's scaled).  Returns ``(results, member_cfgs)`` with
    results as in :func:`run_ensemble`."""
    dev = torch.device(mesh.home if mesh is not None else device)
    member_cfgs = sweep_member_cfgs(cfg, points, jobs_per_point)
    # the engine's scheme bakes coupling = -om/2 and force_w = vkick*cfg.om;
    # the kernel scales both to each member's om
    base, oms = build_engine(cfg).scheme, [m.om for m in member_cfgs]
    if qt_params is None:
        sweep = member_sweep(base, cfg.om, [build_engine(m).scheme
                                            for m in member_cfgs], oms,
                             cfg.torch_dtype, dev)
    else:
        sweep = sweep_lanes(base, cfg.om, qt_params, oms)
    results = _run_fold(cfg, member_cfgs, seed, mesh, device, V, rolls_fn,
                        sweep=sweep)
    return results, member_cfgs


def doppler_limit_ekin(detuning: float, om: float = 0.0) -> float:
    """Textbook Doppler-limit x kinetic energy (in gamma/k velocity units),
    expressed directly as <v_x^2>/2 for recoil 0.0012076 and unit gamma.
    A sanity scale, not an exact target (the 3-level scheme differs O(1)
    from two-level)."""
    d = abs(detuning)
    # standard result: kB T = hbar g/4 * (1 + (2d/g)^2)/(2d/g)
    kbt = 0.25 * (1.0 + (2 * d) ** 2) / (2 * d)   # in hbar*gamma
    # v^2 = kB T / m -> in (gamma/k)^2 units: kbt * (recoil vkick)
    return 0.5 * kbt * 0.0012076
