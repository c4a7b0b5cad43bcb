"""Pure classical transport study: MC equilibration -> collisional MD ->
tagged-moment + autocorrelation recording -> temperature-anisotropy
relaxation (instantaneous rescale and slow anisotropic-force versions).

Counterpart of ``mdqtplasmasims_tpu/experiments/mc_md_anisotropy.py``
(MonteCarloFollowedByMDAndTempAnisotropy.cpp, call stack SURVEY.md 3.2).
Stages (a host loop each, on the run's device): 0 lattice start +
Metropolis chain with a g(r) snapshot at the start of every
``gr_every_mc`` chunk (core/mc.py, plain torch); 1 collisional
velocity-Verlet MD; 2 classical tags + collisionless recording (g(r) per
``gr_every_record`` chunk; tagged moments and temperature before each MD
step, velocities stored after it) and the FFT autocorrelation suite; 3
instantaneous anisotropy + relaxation; 4 collisional re-equilibration; 5
the anisotropic laser force; 6 its relaxation.  Every MD step is one
force launch: kernel A for a job (ops/yukawa.best_forces_fn), kernel C
for a fold (best_forces_fn_batched, with a per-member ``ldeb [E]`` in a
(Gamma, kappa) sweep); the stored velocities stay on the device.

A job is a fold of one member: the stages run on ``[E, N, 3]`` tensors
(core/pipeline.py, the staged runner both Monte-Carlo families share), so
a fold member comes out as its own run does.  ``run`` publishes
native pipeline checkpoints (``checkpoint_every_chunks``) and resumes
from them bit for bit.

Randomness: explicit ``torch.Generator`` objects (core/draws.MemberDraws).
A job draws, in this order, from one generator seeded with ``seed``
(default ``cfg.job``): the start velocities' normals; per Metropolis
chunk its ions, directions, radii and acceptance uniforms; per
collisional MD step a uniform and three normals per ion; the four
classical tags' uniforms.  Member j of a fold draws the same from its own
generator seeded with laser_cooling.member_seed ``(seed, j)``, so member
j of ``run_ensemble(seed=s)`` equals ``run(seed=member_seed(s, j))``.  The
generator's state rides the checkpoint as ``torch_rng_state``.
``draws`` replaces the generators (tests replay the JAX package's key
chain through it).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..core.draws import MemberDraws
from ..core.pipeline import (Members, _cat, check_device, equilibrate,
                             fresh_state, host_cat, make_md_stage, mc_chunks,
                             md_stage, members_of, no_publish, open_pipeline,
                             pair_correlations, pipeline_key, record_chunks,
                             restore_generator, restore_state, to_numpy)
from ..core.tagging import tag_classical, tagged_moments
from ..core.thermostat import anisotropize_velocities, temperature
from ..io.datfiles import DatWriter
from ..io.dirs import mc_transport_dir
from .laser_cooling import _rng_extra, member_seed

ACC_KEYS = ("gr_mc", "gr_record", "moments", "temps", "vstore")


@dataclasses.dataclass(frozen=True)
class MCTransportConfig:
    """Inputs of MonteCarloFollowedByMDAndTempAnisotropy.cpp:62-107."""

    n: int = 4096                 # must be a perfect cube
    kappa: float = 0.5
    gamma: float = 3.0
    density: float = 0.4          # 1e14 m^-3 (units only)
    collision_freq: float = 0.25
    mc_steps: int = 200_000
    max_r_step: float = 0.3
    timestep: float = 0.005
    pre_record_md_steps: int = 200
    record_steps: int = 2500      # numVelAutoCorrsSteps
    instant_aniso_steps: int = 2500
    reequil_steps: int = 500
    temp_percent_diff: float = 0.15
    beta: float = 26000.0
    aniso_time_us: float = 10.0   # anisotropyEstablishmentTime
    aniso_relax_steps: int = 2000
    one_axis_force: bool = False
    gr_every_mc: int = 10_000
    gr_every_record: int = 100
    # crash checkpointing (native-only: the reference never checkpoints
    # this program, SURVEY.md §5).  >0 = publish a pipeline checkpoint
    # every K MC/record chunks and at every stage boundary (needs
    # save_directory); 0 = off.
    checkpoint_every_chunks: int = 0
    job: int = 1
    dtype: str = "float32"        # "float64" runs on the CPU only
    save_directory: Optional[str] = None

    @property
    def aniso_establish_steps(self) -> int:
        # MonteCarlo...cpp:106
        return int(round(0.8 * self.aniso_time_us * np.sqrt(self.density)
                         / self.timestep))

    @property
    def L(self) -> float:
        return (self.n * 4.0 * np.pi / 3.0) ** (1.0 / 3.0)

    @property
    def ldeb(self) -> float:
        return 1.0 / self.kappa

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32

    @property
    def np_dtype(self):
        return np.float64 if self.dtype == "float64" else np.float32

    @property
    def md_steps(self) -> int:
        """MD steps of a whole run (each one force launch)."""
        return (self.pre_record_md_steps + self.record_steps
                + self.instant_aniso_steps + self.reequil_steps
                + self.aniso_establish_steps + self.aniso_relax_steps)


REC_KEYS = ("gr_record", "moments", "temps", "vstore")


def _make_record_chunk(cfg, m: Members) -> Callable:
    """One ``gr_every_record``-step recording chunk: g(r) of the incoming
    configuration, then per step the tagged moments (all four taggings,
    equilibrium values subtracted) and the temperature *before* the MD
    step, the velocities *after* it (the reference order, main
    :1095-1104).  Returns ``chunk(R, V, A, tags [E, 4, N]) -> ((R, V, A),
    (g [E, 1, 400], moments [E, T, 4, 4], temps [E, T], vstore [E, T, N,
    3]))``."""
    step = make_md_stage(cfg, m, collision_freq=0.0)

    def chunk(R, V, A, tags):
        eq = torch.tensor([[0.0, 1.0 / g, 0.0, 3.0 / g ** 2]
                           for g in m.gamma], dtype=R.dtype,
                          device=R.device)[:, None, :]
        g = pair_correlations(R, cfg.L)[:, None]
        moments, temps, vs = [], [], []
        for _ in range(cfg.gr_every_record):
            moments.append(tagged_moments(V[:, None, :, 0], tags) - eq)
            temps.append(temperature(V))
            R, V, A = step(R, V, A)
            vs.append(V)
        return (R, V, A), (g, torch.stack(moments, 1), torch.stack(temps, 1),
                           torch.stack(vs, 1))
    return chunk


def mc_stage(cfg, m: Members, st: dict, publish=no_publish) -> None:
    """Stage 0: the lattice start and the Metropolis chain in
    ``gr_every_mc``-step chunks, a g(r) snapshot of each chunk's incoming
    configuration (the reference's g(r)-every-10k-MC-steps cadence, main
    :1069-1078; the first snapshot is the lattice)."""
    mc_chunks(cfg, m, st, max(1, cfg.mc_steps // cfg.gr_every_mc), publish,
              gr_key="gr_mc", max_r_step=cfg.max_r_step)


def record_stage(cfg, m: Members, st: dict, publish=no_publish) -> None:
    """Stage 2: the four classical tags (drawn unless ``st`` holds them),
    the collisionless recording (main :1095-1104) in chunks of
    :func:`_make_record_chunk`, then the FFT autocorrelation suite."""
    if st["tags"] is None:
        rolls = m.draws.tags(cfg.n, st["V"].dtype).to(st["device"])
        st["tags"] = torch.stack([torch.stack(tag_classical(
            st["V"][j, :, 0], None, g, rolls=rolls[j]))
            for j, g in enumerate(m.gamma)])
    record_chunks(cfg, m, st, _make_record_chunk(cfg, m), REC_KEYS, 2,
                  publish)


def _pipeline(cfg: MCTransportConfig, m: Members, st: dict,
              publish=no_publish) -> dict:
    """The staged pipeline of a job or a fold from ``st`` (a fresh start:
    ``stage`` 0, or a restored checkpoint).  ``publish(stage, chunk,
    with_vstore)`` is called where the checkpoints go (labeled with the
    NEXT (stage, chunk) to execute).  Returns member-first device
    tensors."""
    acc, stage_rec = st["acc"], st["stage_rec"]
    if st["stage"] == 0:
        mc_stage(cfg, m, st, publish)
    if st["stage"] == 1:
        equilibrate(cfg, m, st, publish)
    if st["stage"] == 2:
        record_stage(cfg, m, st, publish)

    # ---- stages 3-6: instantaneous anisotropy + relaxation, collisional
    # re-equilibration, the anisotropic force, its relaxation
    if st["stage"] == 3:
        st["V"] = anisotropize_velocities(st["V"], cfg.temp_percent_diff)
        (st["R"], st["V"], st["A"]), stage_rec["temps_inst"] = md_stage(
            cfg, m, st["R"], st["V"], st["A"], cfg.instant_aniso_steps,
            record="temp_axes")
        publish(4, 0)
        st["stage"] = 4
    if st["stage"] == 4:
        (st["R"], st["V"], st["A"]), _ = md_stage(
            cfg, m, st["R"], st["V"], st["A"], cfg.reequil_steps,
            collision_freq=cfg.collision_freq)
        publish(5, 0)
        st["stage"] = 5
    if st["stage"] == 5:
        (st["R"], st["V"], st["A"]), stage_rec["temps_force"] = md_stage(
            cfg, m, st["R"], st["V"], st["A"], cfg.aniso_establish_steps,
            add_laser_force=True, record="temp_axes")
        publish(6, 0)
        st["stage"] = 6
    if st["stage"] == 6:
        (st["R"], st["V"], st["A"]), stage_rec["temps_relax"] = md_stage(
            cfg, m, st["R"], st["V"], st["A"], cfg.aniso_relax_steps,
            record="temp_axes")
        publish(7, 0)
        st["stage"] = 7

    return dict(gr_mc=_cat(acc["gr_mc"]), gr_record=_cat(acc["gr_record"]),
                mc_accepted=st["n_acc"], moments=_cat(acc["moments"]),
                temps=_cat(acc["temps"]), **st["autoc"], **stage_rec,
                R=st["R"], V=st["V"])


def run(cfg: MCTransportConfig, seed: Optional[int] = None, *,
        resume: bool = False, device="cuda", draws=None,
        _crash_after_checkpoints: Optional[int] = None) -> dict:
    """Execute the full staged pipeline on ``device``; returns all
    observables as host arrays (the JAX package's keys) and writes the
    reference-schema .dat files when save_directory is set.

    With ``cfg.checkpoint_every_chunks`` > 0 (requires save_directory)
    the run publishes a native pipeline checkpoint every K MC/record
    chunks and at every stage boundary; ``resume=True`` continues from
    the newest one (this package's or the JAX package's), bit-identical
    to the uninterrupted run: the generator's state rides the checkpoint
    and every chunk draws the same blocks.  ``draws`` replays another
    source of randomness (module docstring)."""
    device = torch.device(device)
    check_device(cfg, device)
    seed = cfg.job if seed is None else seed
    generator = torch.Generator(device=device).manual_seed(seed)
    m = members_of(cfg, [cfg.gamma], [cfg.ldeb],
                   draws or MemberDraws([generator]), single=True)
    out_dir = (mc_transport_dir(cfg.save_directory, gamma=cfg.gamma,
                                kappa=cfg.kappa, n=cfg.n, job=cfg.job)
               if cfg.save_directory is not None else None)
    meta = dict(n=cfg.n, gamma=cfg.gamma, kappa=cfg.kappa,
                mc_steps=cfg.mc_steps, record_steps=cfg.record_steps,
                instant_aniso_steps=cfg.instant_aniso_steps, seed=seed)
    pub, z = open_pipeline(cfg, out_dir, "transport", meta, resume,
                           _crash_after_checkpoints)
    st = fresh_state(device, ACC_KEYS)
    if z is not None:
        restore_state(z, st, cfg, device,
                      ("temps_inst", "temps_force", "temps_relax"))
        restore_generator(z, generator, draws, st["stage"] <= 4, out_dir)

    def publish(stage, chunk, with_vstore=False):
        if pub is None:
            return
        acc = {k: host_cat(v) for k, v in st["acc"].items()
               if v and (k != "vstore" or with_vstore)}
        one = {k: v[0] for k, v in (*st["autoc"].items(),
                                    *st["stage_rec"].items())}
        pub.save(stage, chunk, R=st["R"][0], V=st["V"][0],
                 A=None if st["A"] is None else st["A"][0],
                 k_run=pipeline_key(m), mc_accepted=st["n_acc"][0],
                 tags=None if st["tags"] is None else st["tags"][0],
                 **one, **acc,
                 **(_rng_extra(generator) if draws is None else {}))

    results = to_numpy(_pipeline(cfg, m, st, publish), 0)
    if cfg.save_directory is not None:
        _write_outputs(cfg, results)
    return results


def _run_batched(cfg: MCTransportConfig, member_cfgs, seed: int,
                 mesh=None, device="cuda", draws=None):
    """The whole pipeline over the member axis, one batched force launch
    (kernel C) per MD step for all members; one fetch; each member's .dat
    tree under its own param-encoded directory.  ``mesh`` runs member
    block k on ens slot k (parallel/ensemble.member_sharded, no
    collectives; on several cards each block in a worker process on
    its slot's card, the blocks at once)."""
    device = torch.device(mesh.home if mesh is not None else device)
    check_device(cfg, device)
    if mesh is not None and draws is not None:
        raise ValueError("draws replay one fold's stream and cannot be "
                         "split over a mesh")

    f64 = dict(dtype=torch.float64, device=device)
    args = (torch.arange(len(member_cfgs), device=device),
            torch.tensor([c.gamma for c in member_cfgs], **f64),
            torch.tensor([c.ldeb for c in member_cfgs], **f64))
    fn = functools.partial(_fold, cfg, seed, draws)
    if mesh is not None:
        from ..parallel.ensemble import member_sharded
        fn = member_sharded(fn, mesh, processes=True)
    batched = fn(*args)
    results = []
    for j, mcfg in enumerate(member_cfgs):
        res = to_numpy(batched, j)
        results.append(res)
        if mcfg.save_directory is not None:
            _write_outputs(mcfg, res)
    return results


def _fold(cfg: MCTransportConfig, seed: int, draws, idx, gammas, ldebs):
    """The pipeline of members ``idx`` on idx's device (the form
    member_sharded splits)."""
    dev = idx.device
    src = draws or MemberDraws([torch.Generator(device=dev).manual_seed(
        member_seed(seed, j)) for j in idx.tolist()])
    m = members_of(cfg, gammas.tolist(), ldebs.tolist(), src)
    return _pipeline(cfg, m, fresh_state(dev, ACC_KEYS))


def run_ensemble(cfg: MCTransportConfig, n_jobs: int, seed: int = 0,
                 mesh=None, device="cuda", draws=None):
    """Batched job array for the transport pipeline (the reference's SLURM
    array over MonteCarloFollowedByMDAndTempAnisotropy jobs): every stage
    over a fold of ``n_jobs`` members.  Per-job .dat trees in ``job<k>/``;
    returns the per-job results list.  ``mesh`` spreads jobs over the
    mesh's ``ens`` slots (n_jobs must divide evenly)."""
    member_cfgs = [dataclasses.replace(cfg, job=j + 1)
                   for j in range(n_jobs)]
    return _run_batched(cfg, member_cfgs, seed, mesh=mesh, device=device,
                        draws=draws)


def run_sweep(cfg: MCTransportConfig, points, jobs_per_point: int = 1,
              seed: int = 0, mesh=None, device="cuda", draws=None):
    """A (Gamma, kappa) phase-diagram grid as ONE fold.

    The reference explores the Yukawa phase diagram by editing the
    compile-time constants ``Gamma``/``kappa``
    (MonteCarloFollowedByMDAndTempAnisotropy.cpp:64-65) and rebuilding
    the binary per point.  Here both are per-member values: Gamma scales
    the start, the Metropolis acceptance, the thermostat kicks and the
    equilibrium-moment subtractions; kappa rides the force kernel as a
    per-member 1/ldeb (kernel C's ``inv_ldeb [E]``), so every point costs
    one more member.

    ``points``: dicts with keys among ``gamma``/``kappa`` (unset fields
    keep cfg's value).  ``jobs_per_point`` replicates each point with
    independent seeds (job numbers 1..jobs_per_point inside the point's
    Gamma/kappa-encoded directory).  Member order is point-major.
    Returns ``(results, member_cfgs)``."""
    allowed = {"gamma", "kappa"}
    member_cfgs = []
    for pt in points:
        ov = dict(pt)
        bad = set(ov) - allowed
        if bad:
            # only the per-member physics can vary inside one fold; n,
            # timestep and the step counts shape every member's arrays
            raise ValueError(f"sweep points can only override "
                             f"{sorted(allowed)}, got {sorted(bad)}")
        for r in range(jobs_per_point):
            member_cfgs.append(dataclasses.replace(cfg, job=r + 1, **ov))
    results = _run_batched(cfg, member_cfgs, seed, mesh=mesh, device=device,
                           draws=draws)
    return results, member_cfgs


def _write_outputs(cfg: MCTransportConfig, res: dict) -> None:
    d = mc_transport_dir(cfg.save_directory, gamma=cfg.gamma,
                         kappa=cfg.kappa, n=cfg.n, job=cfg.job)
    w = DatWriter(d)
    dr = 0.05
    # the reference writes only int((L/2)/dr) rows (the r < L/2 cap,
    # MonteCarlo...cpp:627/649), not the full 400-slot array
    n_gr = int((cfg.L / 2.0) / dr)
    rr = np.arange(n_gr) * dr

    for i, g in enumerate(res["gr_mc"]):
        w.write(f"pairPairCorrStepNum{i * cfg.gr_every_mc}.dat",
                np.stack([rr, g[:n_gr]], -1))
    # record-phase g(r) snapshots (the reference reuses the same filename
    # pattern with the record-step index, MonteCarlo...cpp:1099)
    for i, g in enumerate(res["gr_record"]):
        w.write(f"pairPairCorrStepNum{i * cfg.gr_every_record}.dat",
                np.stack([rr, g[:n_gr]], -1))
    t_axis = np.arange(cfg.record_steps) * cfg.timestep
    for name, arr in (("VAF", res["vaf"]),
                      ("longViscAutoCorr", res["long_visc"]),
                      ("vCubeAutoCorr", res["v_cube"]),
                      ("vFourthAutoCorr", res["v_fourth"])):
        w.write(f"{name}.dat", np.stack([t_axis, arr], -1))
    w.write("temperature.dat", res["temps"][:, None])
    names = ("taggedVOneMoments", "taggedVTwoMoments", "taggedVThreeMoments",
             "taggedVFourMoments")
    for k, name in enumerate(names):
        w.write(f"{name}.dat",
                np.concatenate([t_axis[:, None], res["moments"][:, k]], -1))
    for fname, arr in (("TemperaturesAlongAxesInstantaneous.dat",
                        res["temps_inst"]),
                       ("TemperaturesAlongAxesDuringForcePeriod.dat",
                        res["temps_force"]),
                       ("TemperaturesAlongAxesAfterForcePeriod.dat",
                        res["temps_relax"])):
        steps = np.arange(arr.shape[0]) * cfg.timestep
        w.write(fname, np.concatenate([steps[:, None], arr], -1))
