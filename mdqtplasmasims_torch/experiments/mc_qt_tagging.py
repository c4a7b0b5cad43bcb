"""MC-equilibrated quantum-trajectory velocity tagging.

Counterpart of ``mdqtplasmasims_tpu/experiments/mc_qt_tagging.py``
(MonteCarloFollowedByQTTagging{408Linear,408Quad,422Linear}.cpp, call
stack SURVEY.md 3.3): cubic lattice + MB velocities, a Metropolis anneal,
collisional velocity-Verlet MD, then an optical-pumping phase (``ratio``
quantum ticks then one MD step, per pump MD step), a projective tag, and
a collisionless recording phase emitting tagged moments + the tagged KDE
velocity distribution, g(r), temperature and the stored-velocity
autocorrelation suite.

Stages (a host loop each, on the run's device): 0 lattice start + the
Metropolis chain (core/mc.py, plain torch) on the fixed ``mc_chunk_steps``
grid; 1 collisional MD; 2 the pump window (core/scheduler.MCTagScheduler:
per pump MD step its ticks as one launch of the tick kernel at the fixed
vx, every member of a fold in it, then one MD step) and the measurement;
3 the
recording and the FFT autocorrelation suite.  Every MD step is one force
launch: kernel A for a job, kernel C for a fold.  A job is a fold of one
member (core/pipeline.py, the staged runner both Monte-Carlo families
share), so a fold member comes out as its own run does; ``run``
publishes native pipeline checkpoints, mid-pump included (psi, the
per-ion clocks, tick, t and the generator), and resumes from them bit
for bit.

Randomness (core/draws.MemberDraws): a job draws, in this order, from one
generator seeded with ``seed`` (default ``cfg.job``): the start
velocities' normals; per Metropolis chunk its ions, directions, radii and
acceptance uniforms; per collisional MD step a uniform and three normals
per ion; the start wavefunctions (at the pump window's start); per pump
MD step its ``[ratio, 5, n]`` tick uniforms; the measurement's uniforms.
Member j of a fold draws the same from its own generator seeded with
laser_cooling.member_seed ``(seed, j)``.  ``draws`` replaces the
generators (tests replay the JAX package's key chain through it).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.draws import MemberDraws
from ..core.pipeline import (Members, _cat, check_device, equilibrate,
                             fresh_state, host_cat, mc_chunks, members_of,
                             no_publish, open_pipeline, pair_correlations,
                             pipeline_key, record_chunks, restore_generator,
                             restore_state, to_numpy)
from ..core.qt import QTEngine, QTParams, sweep_member_cfgs
from ..core.scheduler import MCTagScheduler, member_sweep, sweep_lanes
from ..core.tagging import (spin_up_probability_408, spin_up_probability_422,
                            tagged_moments)
from ..core.thermostat import temperature
from ..core.md import velocity_verlet_step
from ..io.datfiles import DatWriter
from ..io.dirs import mc_tag_dir
from ..levels import DECAY_RATIO_422_MC, tag408, tag422
from ..ops.kde import centered_bins, centered_bins_np, gaussian_kde
from ..state import SimState, complex_dtype
from ..units import (QTUnits, GAMMA422_FACTOR, K422_FACTOR,
                     pump_window_einstein)
from .laser_cooling import _rng_extra, member_seed

VARIANT_DEFAULTS = {  # (tpump_seconds, detuning, om) per reference file
    "408linear": (2e-7, -2.5, 0.7),
    "408quad": (1e-7, 0.0, 2.0),
    "422linear": (5e-8, -1.0, 1.3),
}
ACC_KEYS = ("grs", "moments", "dists", "temps", "vstore")


@dataclasses.dataclass(frozen=True)
class MCTagConfig:
    variant: str = "408quad"
    n: int = 4096                 # perfect cube
    kappa: float = 0.5
    gamma: float = 3.0
    density: float = 2.0
    tpump_seconds: Optional[float] = None
    detuning: Optional[float] = None
    om: Optional[float] = None
    mc_steps: int = 100_000
    mc_chunk_steps: int = 10_000   # Metropolis dispatch/checkpoint chunk
    pre_record_md_steps: int = 200
    record_steps: int = 1500
    collision_freq: float = 0.25
    timestep: float = 0.005
    gr_every_record: int = 100
    # crash checkpointing (native-only; the reference never checkpoints
    # the MC-tagging programs, SURVEY.md §5).  >0 = publish a pipeline
    # checkpoint every K MC/record chunks, through the pump window, and at
    # every stage boundary (needs save_directory); 0 = off.
    checkpoint_every_chunks: int = 0
    job: int = 1
    dtype: str = "float32"        # "float64" runs on the CPU only
    dist_every: int = 1           # reference writes vel_dist every step
    save_directory: Optional[str] = None

    def __post_init__(self):
        assert self.variant in VARIANT_DEFAULTS
        d = VARIANT_DEFAULTS[self.variant]
        if self.tpump_seconds is None:
            object.__setattr__(self, "tpump_seconds", d[0])
        if self.detuning is None:
            object.__setattr__(self, "detuning", d[1])
        if self.om is None:
            object.__setattr__(self, "om", d[2])

    @property
    def is_422(self) -> bool:
        return self.variant == "422linear"

    @property
    def units(self) -> QTUnits:
        return QTUnits(self.density,
                       gamma_factor=GAMMA422_FACTOR if self.is_422 else 1.0,
                       k_factor=K422_FACTOR if self.is_422 else 1.0)

    @property
    def ratio(self) -> int:
        # round(87*gamma_factor/sqrt(n)): 408Quad.cpp:111, 422Linear.cpp:116
        return self.units.ratio_mc_tagging()

    @property
    def qdt(self) -> float:
        return self.timestep / self.ratio

    @property
    def pump_md_steps(self) -> int:
        tpump = pump_window_einstein(self.tpump_seconds, self.density)
        return int(round(tpump / self.timestep))

    @property
    def n_states(self) -> int:
        return 5 if self.is_422 else 7

    @property
    def L(self) -> float:
        return (self.n * 4.0 * np.pi / 3.0) ** (1.0 / 3.0)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32

    @property
    def np_dtype(self):
        return np.float64 if self.dtype == "float64" else np.float32

    @property
    def md_steps(self) -> int:
        """MD steps of a whole run (each one force launch)."""
        return self.pre_record_md_steps + self.pump_md_steps + self.record_steps

    def scheme(self):
        if self.is_422:
            return tag422(self.detuning, self.om,
                          decay_ratio=DECAY_RATIO_422_MC)
        return tag408(self.detuning, self.om,
                      linear=(self.variant == "408linear"))

    def scheme_unit(self):
        """The variant's scheme at detuning=om=1: the base pattern that
        sweep folds scale per member (core/qt.sweep_qt_params)."""
        if self.is_422:
            return tag422(1.0, 1.0, decay_ratio=DECAY_RATIO_422_MC)
        return tag408(1.0, 1.0, linear=(self.variant == "408linear"))

    def spin_up_probability(self, psi):
        return (spin_up_probability_422(psi) if self.is_422
                else spin_up_probability_408(psi))


def _members(cfg: MCTagConfig, n_members: int, draws,
             single: bool = False) -> Members:
    return members_of(cfg, [cfg.gamma] * n_members,
                      [1.0 / cfg.kappa] * n_members, draws, single)


def pump_engine(cfg: MCTagConfig) -> QTEngine:
    """The pump's quantum engine: cfg's scheme at the quantum step, no
    force on the ions."""
    u = cfg.units
    return QTEngine(cfg.scheme(), h=cfg.qdt * u.gamma_to_einstein,
                    dt_plasma=cfg.qdt, plas_to_quant_vel=u.plas_to_quant_vel,
                    gamma_to_einstein=u.gamma_to_einstein, apply_force=False)


def _make_scheduler(cfg: MCTagConfig, m: Members,
                    sweep=(None, None)) -> MCTagScheduler:
    return MCTagScheduler(engine=pump_engine(cfg),
                          forces_fn=lambda R: (m.forces(R), None), L=cfg.L,
                          dt=cfg.timestep, ratio=cfg.ratio,
                          rolls_fn=m.draws.pump, sweep_e0=sweep[0],
                          sweep_om=sweep[1])


def _pump_chunk(sched: MCTagScheduler, state: SimState,
                n_md_steps: int) -> SimState:
    """``n_md_steps`` pump MD steps on a live state.  Chunk boundaries do
    not change the run (the draws follow the steps), so the resumable
    runner can cut the pump window anywhere."""
    for _ in range(n_md_steps):
        state = sched.md_step(state)
    return state


def pump_phase(cfg: MCTagConfig, m: Members, st: dict,
               publish=no_publish, sweep=(None, None)) -> SimState:
    """pumpMDTimeSteps x [ratio qsteps; MDStep]
    (MonteCarlo...408Quad.cpp:1230-1235) from the live pump state
    ``st["pump"]`` (the start wavefunctions drawn, at t = 0, when there is
    none) at pump MD step ``st["chunk"]``.  With checkpoints on, the
    window goes in 8 chunks, each published; returns the window's end
    state and drops the live one from ``st``.  ``sweep`` gives the members
    their own pump detuning and Rabi frequency: ``(e0 [E, S] | None, om
    [E] | None)`` of core/scheduler.member_sweep (run_sweep)."""
    if st.get("pump") is None:
        psi = m.draws.psi(cfg.n, cfg.n_states,
                          complex_dtype(cfg.torch_dtype)).to(st["device"])
        st["pump"] = SimState(
            R=st["R"], V=st["V"], F=st["A"], psi=psi,
            t_part=torch.zeros((m.E, cfg.n), dtype=cfg.torch_dtype,
                               device=st["device"]))
    sched = _make_scheduler(cfg, m, sweep)
    cs = (max(1, -(-cfg.pump_md_steps // 8))
          if cfg.checkpoint_every_chunks > 0 else cfg.pump_md_steps)
    done = st["chunk"]
    while done < cfg.pump_md_steps:
        k = min(cs, cfg.pump_md_steps - done)
        st["pump"] = _pump_chunk(sched, st["pump"], k)
        done += k
        if done < cfg.pump_md_steps:
            publish(2, done)
    return st.pop("pump")


def _measure(cfg: MCTagConfig, m: Members, psi) -> torch.Tensor:
    p = cfg.spin_up_probability(psi)
    return m.draws.measure(tuple(p.shape), p.dtype).to(p.device) < p


def _make_record_chunk(cfg: MCTagConfig, m: Members):
    """One ``gr_every_record``-step recording chunk: g(r) of the incoming
    configuration, then per step the tagged moments + tagged KDE
    distribution + temperature before the MD step, the velocities after
    it.  ``chunk(R, V, A, tags [E, N]) -> ((R, V, A), (g [E, 1, 400],
    moments [E, T, 4], dists [E, T, 4001], temps [E, T], vstore [E, T, N,
    3]))``."""
    dt = cfg.timestep

    def chunk(R, V, A, tags):
        bins = centered_bins(R.dtype, R.device)
        w = tags.to(R.dtype)
        g = pair_correlations(R, cfg.L)[:, None]
        outs = []
        for _ in range(cfg.gr_every_record):
            vx = V[..., 0]
            rec = (tagged_moments(vx, tags),
                   gaussian_kde(vx, bins, folded=False, weights=w),
                   temperature(V))
            R, V, A = velocity_verlet_step(R, V, A, dt, cfg.L, m.forces)
            outs.append(rec + (V,))
        return (R, V, A), (g,) + tuple(torch.stack(x, 1) for x in zip(*outs))
    return chunk


def record_phase(cfg: MCTagConfig, m: Members, st: dict,
                 publish=no_publish) -> None:
    """Stage 3: the collisionless recording in chunks of
    :func:`_make_record_chunk`, then the FFT autocorrelation suite."""
    record_chunks(cfg, m, st, _make_record_chunk(cfg, m), ACC_KEYS, 3,
                  publish)


def _mc_scan(cfg: MCTagConfig, m: Members, st: dict,
             publish=no_publish) -> None:
    """Stage 0: the lattice start and the Metropolis anneal on the fixed
    chunk grid (``max(1, mc_steps // mc_chunk_steps)`` chunks of
    ``mc_steps // n_chunks`` steps: 350 steps in chunks of 100 run
    348)."""
    mc_chunks(cfg, m, st, max(1, cfg.mc_steps // cfg.mc_chunk_steps),
              publish)


def _pipeline(cfg: MCTagConfig, m: Members, st: dict, publish=no_publish,
              sweep=(None, None)) -> dict:
    """The staged pipeline of a job or a fold from ``st`` (fresh or a
    restored checkpoint; ``st["pump"]`` a live mid-pump state).
    ``publish(stage, chunk, with_vstore)`` is called where the checkpoints
    go (labeled with the NEXT (stage, chunk) to execute; stage 2's chunk
    counts pump MD steps).  Returns member-first device tensors."""
    if st["stage"] == 0:
        _mc_scan(cfg, m, st, publish)
    if st["stage"] == 1:
        equilibrate(cfg, m, st, publish)
    # ---- stage 2: the optical pump window (resumable at any MD step),
    # then the projective spin measurement
    if st["stage"] == 2:
        ps = pump_phase(cfg, m, st, publish, sweep)
        st["tags"] = _measure(cfg, m, ps.psi)
        st["R"], st["V"], st["A"] = ps.R, ps.V, ps.F
        publish(3, 0)
        st["stage"], st["chunk"] = 3, 0
    if st["stage"] == 3:
        record_phase(cfg, m, st, publish)
    return dict(mc_accepted=st["n_acc"], tags=st["tags"],
                **{k: _cat(st["acc"][k]) for k in ACC_KEYS if k != "vstore"},
                **st["autoc"], R=st["R"], V=st["V"])


def run(cfg: MCTagConfig, seed: Optional[int] = None, *,
        resume: bool = False, device="cuda", draws=None,
        _crash_after_checkpoints: Optional[int] = None) -> dict:
    """Execute the MC -> MD -> pump -> tag -> record pipeline on
    ``device``; returns all observables as host arrays (the JAX package's
    keys) and writes reference-schema .dat files when save_directory is
    set.

    With ``cfg.checkpoint_every_chunks`` > 0 (requires save_directory)
    the run publishes a native pipeline checkpoint every K MC/record
    chunks, through the pump window, and at every stage boundary;
    ``resume=True`` continues from the newest one (this package's or the
    JAX package's), bit-identical to the uninterrupted run (the live
    pump state and the generator ride the checkpoint).  ``draws`` replays
    another source of randomness (module docstring)."""
    device = torch.device(device)
    check_device(cfg, device)
    seed = cfg.job if seed is None else seed
    generator = torch.Generator(device=device).manual_seed(seed)
    m = _members(cfg, 1, draws or MemberDraws([generator]), single=True)
    out_dir = _job_dir(cfg) if cfg.save_directory is not None else None
    meta = dict(variant=cfg.variant, n=cfg.n, gamma=cfg.gamma,
                kappa=cfg.kappa, mc_steps=cfg.mc_steps,
                record_steps=cfg.record_steps,
                pump_md_steps=cfg.pump_md_steps, seed=seed)
    pub, z = open_pipeline(cfg, out_dir, "mc_tag", meta, resume,
                           _crash_after_checkpoints)
    st = fresh_state(device, ACC_KEYS)
    if z is not None:
        restore_state(z, st, cfg, device)
        if "psi" in z:               # mid-pump snapshot: a live state
            dt = cfg.torch_dtype
            st["pump"] = SimState(
                R=st["R"], V=st["V"], F=st["A"],
                psi=torch.as_tensor(np.asarray(z["psi"]))[None].to(
                    device, complex_dtype(dt)),
                t_part=torch.as_tensor(np.asarray(z["t_part"]))[None].to(
                    device, dt),
                tick=int(z["tick"]), t=float(z["t"]))
        restore_generator(z, generator, draws, st["stage"] <= 2, out_dir)

    def publish(stage, chunk, with_vstore=False):
        if pub is None:
            return
        acc = {k: host_cat(v) for k, v in st["acc"].items()
               if v and (k != "vstore" or with_vstore)}
        rng = _rng_extra(generator) if draws is None else {}
        ps = st.get("pump")
        if ps is not None:
            pub.save(stage, chunk, R=ps.R[0], V=ps.V[0], A=ps.F[0],
                     psi=ps.psi[0], t_part=ps.t_part[0],
                     k_run=pipeline_key(m), tick=np.int32(ps.tick),
                     t=cfg.np_dtype(ps.t), mc_accepted=st["n_acc"][0],
                     **acc, **rng)
            return
        pub.save(stage, chunk, R=st["R"][0], V=st["V"][0],
                 A=None if st["A"] is None else st["A"][0],
                 k_run=pipeline_key(m), mc_accepted=st["n_acc"][0],
                 tags=None if st["tags"] is None else st["tags"][0],
                 **{k: v[0] for k, v in st["autoc"].items()}, **acc, **rng)

    results = to_numpy(_pipeline(cfg, m, st, publish), 0)
    if cfg.save_directory is not None:
        _write_outputs(cfg, results)
    return results


def _run_batched(cfg: MCTagConfig, member_cfgs, seed: int,
                 sweep=(None, None), mesh=None, device="cuda",
                 draws=None):
    """The whole pipeline over the member axis: one batched force launch
    (kernel C) per MD step and one tick-kernel launch per pump MD step
    serve every member; one fetch; each member's .dat tree under its own
    param-encoded directory.  ``sweep``: ``(e0 [E, S] | None, om [E] |
    None)``, a sweep fold's per-member tables of the tick kernel's
    per-lane forms (core/scheduler.member_sweep).  ``mesh`` runs member
    block k on ens slot k (parallel/ensemble.member_sharded, no
    collectives)."""
    device = torch.device(mesh.home if mesh is not None else device)
    check_device(cfg, device)
    if mesh is not None and draws is not None:
        raise ValueError("draws replay one fold's stream and cannot be "
                         "split over a mesh")

    def fold(idx, e0, om):
        dev = idx.device
        src = draws or MemberDraws([torch.Generator(device=dev).manual_seed(
            member_seed(seed, j)) for j in idx.tolist()])
        m = _members(cfg, len(idx), src)
        return _pipeline(cfg, m, fresh_state(dev, ACC_KEYS),
                         sweep=(e0, om))

    args = (torch.arange(len(member_cfgs), device=device), *sweep)
    fn = fold
    if mesh is not None:
        from ..parallel.ensemble import member_sharded
        fn = member_sharded(fold, mesh)
    batched = fn(*args)
    results = []
    for j, mcfg in enumerate(member_cfgs):
        res = to_numpy(batched, j)
        results.append(res)
        if mcfg.save_directory is not None:
            _write_outputs(mcfg, res)
    return results


def run_ensemble(cfg: MCTagConfig, n_jobs: int, seed: int = 0, mesh=None,
                 device="cuda", draws=None):
    """Batched MC->MD->pump->tag->record job array (the reference's SLURM
    array over MonteCarloFollowedByQTTagging* jobs).  Per-job .dat trees
    land in ``job<k>/``; returns the per-job results list.  ``mesh``
    spreads jobs over the mesh's ``ens`` slots."""
    member_cfgs = [dataclasses.replace(cfg, job=j + 1)
                   for j in range(n_jobs)]
    return _run_batched(cfg, member_cfgs, seed, mesh=mesh, device=device,
                        draws=draws)


def run_sweep(cfg: MCTagConfig, points, jobs_per_point: int = 1,
              seed: int = 0, mesh=None, device="cuda", draws=None,
              qt_params: Optional[QTParams] = None):
    """A pump-laser (detuning, om) grid as ONE fold.

    The reference compiles the pump detuning and Rabi frequency into each
    tagging binary (MonteCarloFollowedByQTTagging408Quad.cpp:96-100) and
    rebuilds per point.  The pump Hamiltonian is linear in both knobs, so
    each member carries its own tables (its own scheme's e0, cfg's
    coupling scaled by om / cfg.om; core/scheduler.member_sweep) through
    the fold's pump window: every grid point costs one more member, and
    the shared stages (MC anneal, MD, recording, FFT suite) batch with it.

    ``points``: dicts with keys among ``detuning``/``om`` (unset fields
    keep cfg's value).  ``jobs_per_point`` replicates each point with
    independent seeds; member order is point-major.  With
    ``cfg.save_directory`` set, each member writes the full reference
    .dat tree under its own detuning/om-encoded directory.  ``qt_params``
    replaces the tables built from the points (``[E]``-batched,
    bridge.qt_params_from_numpy; core/scheduler.sweep_lanes checks that
    its couplings are cfg's scaled).  Returns ``(results,
    member_cfgs)``."""
    dev = torch.device(mesh.home if mesh is not None else device)
    check_device(cfg, dev)
    member_cfgs = sweep_member_cfgs(cfg, points, jobs_per_point)
    oms = [m.om for m in member_cfgs]
    sweep = (member_sweep(cfg.scheme(), cfg.om,
                          [m.scheme() for m in member_cfgs], oms,
                          cfg.torch_dtype, dev) if qt_params is None
             else sweep_lanes(cfg.scheme(), cfg.om, qt_params, oms))
    results = _run_batched(cfg, member_cfgs, seed, sweep=sweep, mesh=mesh,
                           device=device, draws=draws)
    return results, member_cfgs


def _job_dir(cfg: MCTagConfig) -> str:
    # the 422 main stamps the run date into the directory name
    # (MonteCarloFollowedByQTTagging422Linear.cpp:1127-1134)
    stamp = time.strftime("Date%m%d%y") if cfg.is_422 else None
    return mc_tag_dir(cfg.save_directory, gamma=cfg.gamma,
                      kappa=cfg.kappa, n=cfg.n,
                      tpump_seconds=cfg.tpump_seconds,
                      detuning=cfg.detuning, om=cfg.om,
                      density=cfg.density, job=cfg.job, date_stamp=stamp)


def _write_outputs(cfg: MCTagConfig, res: dict) -> None:
    w = DatWriter(_job_dir(cfg))
    t_axis = np.arange(cfg.record_steps) * cfg.timestep
    bins = centered_bins_np()
    w.append("taggedMoments.dat",
             np.concatenate([t_axis[:, None], res["moments"]], axis=1))
    for k in range(0, cfg.record_steps, cfg.dist_every):
        w.write(f"vel_distX_timestep{k:06d}.dat",
                np.stack([bins, res["dists"][k]], -1))
    n_gr = int((cfg.L / 2.0) / 0.05)   # reference's r < L/2 row cap
    rr = np.arange(n_gr) * 0.05
    for i, g in enumerate(res["grs"]):
        w.write(f"pairPairCorrStepNum{i * cfg.gr_every_record}.dat",
                np.stack([rr, g[:n_gr]], -1))
    w.write("temperature.dat", res["temps"][:, None])
    for name, arr in (("VAF", res["vaf"]),
                      ("longViscAutoCorr", res["long_visc"]),
                      ("vCubeAutoCorr", res["v_cube"]),
                      ("vFourthAutoCorr", res["v_fourth"])):
        w.write(f"{name}.dat", np.stack([t_axis, arr], -1))
