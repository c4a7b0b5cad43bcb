"""The staged, resumable runner shared by the two Monte-Carlo families
(experiments/mc_md_anisotropy.py: transport, experiments/mc_qt_tagging.py:
MC tagging).

A job is a fold of one member: every stage runs on ``[E, N, 3]`` tensors
(:class:`Members` carries each member's Gamma, screening length, draws
and force call), so a fold member comes out as its own run does.  A
pipeline's mutable state is one dict (:func:`fresh_state`): the stage
and chunk to execute next, R / V / A, the accepted-move counts, the tags
and the accumulated per-chunk outputs.  The stage functions here (the
Metropolis chunks, collisional MD, the recording chunks with the FFT
autocorrelation suite) advance it and call ``publish(stage, chunk,
with_vstore=False)`` where a checkpoint goes, labelled with the NEXT
(stage, chunk) to execute; :class:`PipelinePublisher` writes them and
:func:`restore_state` / :func:`restore_generator` read them back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.correlations import power_autocorr
from ..ops.structure import pair_correlation
from ..ops.yukawa import best_forces_fn, best_forces_fn_batched
from .init import lattice_init
from .mc import MetropolisMC
from .md import velocity_verlet_step
from .thermostat import (collide_and_kick, laser_force, temperature,
                         temperature_per_axis)

AUTOC_KEYS = ("vaf", "long_visc", "v_cube", "v_fourth")


def check_device(cfg, device: torch.device) -> None:
    if cfg.torch_dtype == torch.float64 and device.type != "cpu":
        raise NotImplementedError("float64 runs on the CPU only; the CUDA "
                                  "kernels are float32 (ROADMAP.md)")


def _forces(cfg, ldeb: Sequence[float], single: bool) -> Callable:
    """``R [E, N, 3] -> A [E, N, 3]``: kernel A for a job (``single``),
    one launch of kernel C for a fold with each member's ``ldeb`` (a
    float64 ``[E]`` tensor: the kernel's 1/ldeb, and the twins' float, are
    rounded from it as from a job's float), their twins on the CPU."""
    if single:
        fn = best_forces_fn(cfg.n, cfg.L, ldeb[0])
        return lambda R: fn(R[0])[0][None]
    per_device = {}

    def forces(R):
        if R.device not in per_device:
            per_device[R.device] = best_forces_fn_batched(
                cfg.n, cfg.L, torch.tensor(ldeb, dtype=torch.float64,
                                           device=R.device))
        return per_device[R.device](R)[0]
    return forces


@dataclasses.dataclass
class Members:
    """What a job (E = 1) or a fold of E members carries through the
    stages: each member's Gamma and screening length, the draws
    (core/draws.MemberDraws or a replay), and the force call of the
    ``[E, N, 3]`` positions."""

    gamma: tuple
    ldeb: tuple
    draws: object
    forces: Callable
    _gamma_t: dict = dataclasses.field(default_factory=dict)

    @property
    def E(self) -> int:
        return len(self.gamma)

    def gamma_t(self, device) -> torch.Tensor:
        """Per-member Gamma, float64 ``[E]`` on ``device``, made once (the
        thermostat's spread is taken in float64 and rounded, as a float
        Gamma is)."""
        if device not in self._gamma_t:
            self._gamma_t[device] = torch.tensor(
                self.gamma, dtype=torch.float64, device=device)
        return self._gamma_t[device]


def members_of(cfg, gammas, ldebs, draws, single: bool = False) -> Members:
    return Members(tuple(float(g) for g in gammas),
                   tuple(float(x) for x in ldebs), draws,
                   _forces(cfg, tuple(float(x) for x in ldebs), single))


def lattice_start(cfg, m: Members, device):
    """``[E, n, 3]`` lattice positions and MB velocities, member j's with
    its own Gamma."""
    z = m.draws.start_v(cfg.n, cfg.torch_dtype).to(device)
    RV = [lattice_init(None, cfg.n, g, cfg.L, cfg.torch_dtype, device, V=z[j])
          for j, g in enumerate(m.gamma)]
    return (torch.stack([r for r, _ in RV]), torch.stack([v for _, v in RV]))


def pair_correlations(R: torch.Tensor, L: float) -> torch.Tensor:
    """``[E, 400]`` g(r) of each member of ``R [E, N, 3]``."""
    return torch.stack([pair_correlation(R[j], L) for j in range(R.shape[0])])


def make_md_stage(cfg, m: Members, *, collision_freq: float,
                  add_laser_force: bool = False) -> Callable:
    """One velocity-Verlet MD step with the thermostat / laser options,
    ``(R, V, A) -> (R, V, A)`` on ``[E, N, 3]``.  Every step asks the
    draws for its collisions (none drawn when ``collision_freq`` is 0), as
    the JAX package splits its key every step."""
    dt = cfg.timestep

    def step(R, V, A):
        R, V, A = velocity_verlet_step(R, V, A, dt, cfg.L, m.forces)
        kick = m.draws.md_step(R.shape[1], R.dtype, collision_freq != 0.0)
        V = collide_and_kick(V, kick, dt=dt, collision_freq=collision_freq,
                             gamma=m.gamma_t(R.device))
        if add_laser_force:
            V = laser_force(V, dt=dt, beta=cfg.beta, density=cfg.density,
                            one_axis_only=cfg.one_axis_force)
        return R, V, A
    return step


def md_stage(cfg, m: Members, R, V, A, n_steps: int,
             collision_freq: float = 0.0, add_laser_force: bool = False,
             record: str = "none"):
    """``n_steps`` of velocity-Verlet.  ``record``: none | temp |
    temp_axes, the value after each step, ``[E, n_steps(, 3)]``.  Returns
    ``((R, V, A), rec | None)``."""
    step = make_md_stage(cfg, m, collision_freq=collision_freq,
                         add_laser_force=add_laser_force)
    rec = []
    for _ in range(n_steps):
        R, V, A = step(R, V, A)
        if record == "temp":
            rec.append(temperature(V))
        elif record == "temp_axes":
            rec.append(temperature_per_axis(V))
    return (R, V, A), (torch.stack(rec, 1) if rec else None)


def no_publish(stage: int, chunk: int, with_vstore: bool = False) -> None:
    """The ``publish`` of a run without checkpoints."""


def mc_chunks(cfg, m: Members, st: dict, n_chunks: int,
              publish: Callable = no_publish, gr_key: Optional[str] = None,
              max_r_step: float = MetropolisMC.max_r_step) -> None:
    """Stage 0: the lattice start (unless ``st`` holds positions), then the
    Metropolis chain from chunk ``st["chunk"]`` of ``n_chunks``, each of
    ``cfg.mc_steps // n_chunks`` steps; the accepted moves add to
    ``st["n_acc"]``.  ``gr_key``: the accumulator that takes g(r) of each
    chunk's incoming configuration.  Publishes every
    ``checkpoint_every_chunks`` chunks and after the last; leaves ``st`` at
    stage 1."""
    if st["R"] is None:
        st["R"], st["V"] = lattice_start(cfg, m, st["device"])
    if st["n_acc"] is None:
        st["n_acc"] = torch.zeros(m.E, dtype=torch.int32, device=st["device"])
    mc = MetropolisMC(L=cfg.L, ldeb=m.ldeb, gamma=m.gamma,
                      max_r_step=max_r_step)
    every = cfg.checkpoint_every_chunks
    for i in range(st["chunk"], n_chunks):
        R = st["R"]
        if gr_key is not None:
            st["acc"][gr_key].append(pair_correlations(R, cfg.L)[:, None])
        st["R"], acc = mc.run(R, draws=m.draws.mc(cfg.mc_steps // n_chunks,
                                                  R.shape[1], R.dtype))
        st["n_acc"] = st["n_acc"] + acc
        last = i + 1 == n_chunks
        if every > 0 and (last or (i + 1) % every == 0):
            publish(1 if last else 0, 0 if last else i + 1)
    st["stage"], st["chunk"] = 1, 0


def equilibrate(cfg, m: Members, st: dict,
                publish: Callable = no_publish) -> None:
    """Stage 1: ``pre_record_md_steps`` of collisional MD from the chain's
    positions (the first force call here); leaves ``st`` at stage 2."""
    if st["A"] is None:
        st["A"] = m.forces(st["R"])
    (st["R"], st["V"], st["A"]), _ = md_stage(
        cfg, m, st["R"], st["V"], st["A"], cfg.pre_record_md_steps,
        collision_freq=cfg.collision_freq)
    publish(2, 0)
    st["stage"], st["chunk"] = 2, 0


def record_chunks(cfg, m: Members, st: dict, chunk: Callable, keys,
                  stage: int, publish: Callable = no_publish) -> None:
    """The collisionless recording stage ``stage`` from chunk
    ``st["chunk"]`` of ``record_steps // gr_every_record``: ``chunk(R, V,
    A, tags) -> ((R, V, A), outputs)``, each output appended to
    ``st["acc"][key]`` (``keys`` end with ``vstore``, the stored
    velocities); then the FFT autocorrelation suite of the stored
    velocities into ``st["autoc"]``.  Publishes every
    ``checkpoint_every_chunks`` chunks (the stored velocities included)
    and at the end; leaves ``st`` at ``stage + 1``."""
    assert cfg.record_steps % cfg.gr_every_record == 0
    n_rec = cfg.record_steps // cfg.gr_every_record
    every = cfg.checkpoint_every_chunks
    for i in range(st["chunk"], n_rec):
        (st["R"], st["V"], st["A"]), outs = chunk(st["R"], st["V"], st["A"],
                                                  st["tags"])
        for k, o in zip(keys, outs, strict=True):
            st["acc"][k].append(o)
        if every > 0 and i + 1 < n_rec and (i + 1) % every == 0:
            publish(stage, i + 1, with_vstore=True)
    vstore = _cat(st["acc"]["vstore"])
    for k, name in enumerate(AUTOC_KEYS, 1):
        st["autoc"][name] = torch.stack([power_autocorr(vstore[j], k, g)
                                         for j, g in enumerate(m.gamma)])
    publish(stage + 1, 0)
    st["stage"], st["chunk"] = stage + 1, 0


class PipelinePublisher:
    """Crash-checkpoint publisher for the staged experiment families
    (io/checkpoint.save_pipeline_checkpoint: atomic, newest-only).
    Tensors are fetched to the host; None values are left out.
    ``crash_after`` is a test hook: raise after the K-th publish to
    simulate a walltime kill at a known point."""

    def __init__(self, directory: str, family: str, meta: dict,
                 crash_after: Optional[int] = None):
        from ..io.checkpoint import save_pipeline_checkpoint
        self._save = save_pipeline_checkpoint
        self.directory = directory
        self.family = family
        self.meta = {k: np.asarray(v) for k, v in meta.items()}
        self.seq = 0
        self._crash_after = crash_after

    def save(self, stage: int, chunk: int, **arrays) -> None:
        payload = dict(self.meta, stage=np.int64(stage),
                       chunk=np.int64(chunk))
        payload.update({k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                            else v)
                        for k, v in arrays.items() if v is not None})
        self.seq += 1
        self._save(self.directory, self.seq, self.family, payload)
        if self._crash_after is not None and self.seq >= self._crash_after:
            raise RuntimeError(
                f"simulated crash after pipeline checkpoint {self.seq} "
                "(test hook)")


def check_pipeline_meta(z: dict, directory: str, **fields) -> None:
    """Refuse to resume a pipeline checkpoint written under a different
    configuration: a silent splice across mismatched physics would be
    worse than restarting."""
    for k, want in fields.items():
        got = z.get(k)
        if isinstance(want, str):
            ok = got is not None and str(got) == want
        else:
            ok = got is not None and np.allclose(np.asarray(got),
                                                 np.asarray(want))
        if not ok:
            raise ValueError(
                f"{directory}: pipeline checkpoint was written with "
                f"{k}={got}, this run is configured with {k}={want} — "
                "refusing to splice")


def open_pipeline(cfg, out_dir: Optional[str], family: str, meta: dict,
                  resume: bool, crash_after: Optional[int] = None):
    """A run's checkpoint publisher (None when ``checkpoint_every_chunks``
    is 0) and, for ``resume``, the newest checkpoint of ``out_dir``
    checked against ``meta`` (else None)."""
    from ..io.checkpoint import load_pipeline_checkpoint
    pub = None
    if cfg.checkpoint_every_chunks > 0:
        if out_dir is None:
            raise ValueError("checkpoint_every_chunks needs "
                             "save_directory")
        pub = PipelinePublisher(out_dir, family, meta,
                                crash_after=crash_after)
    if not resume:
        return pub, None
    if out_dir is None:
        raise ValueError("resume=True needs save_directory")
    z = load_pipeline_checkpoint(out_dir, family)
    if z is None:
        raise ValueError(
            f"{out_dir}: no pipeline checkpoint to resume from "
            "(runs publish them when checkpoint_every_chunks > 0)")
    check_pipeline_meta(z, out_dir, **meta)
    if pub is not None:
        pub.seq = int(z["seq"])
    return pub, z


def _cat(chunks) -> torch.Tensor:
    """Accumulated member-first chunks (device tensors and/or restored
    ones) joined along the time axis."""
    return torch.cat(list(chunks), dim=1)


def host_cat(chunks) -> np.ndarray:
    """:func:`_cat` of a job (E = 1), on the host: the checkpoint's and the
    JAX package's chunk-major layout."""
    return _cat(chunks)[0].cpu().numpy()


def pipeline_key(m: Members) -> np.ndarray:
    """A checkpoint's ``k_run``: the replayed chain's key, or a placeholder
    key (the JAX package's loader reads one; with it, only a cut with no
    draws left continues there as here)."""
    k = m.draws.key_state()
    return np.zeros(2, np.uint32) if k is None else np.asarray(k)


def restore_generator(z: dict, generator: torch.Generator, draws,
                      draws_left: bool, directory: str) -> None:
    """Continue the checkpoint's generator stream.  A checkpoint without
    one (the JAX package's, or a replayed run's) is refused while the
    remaining stages still draw, unless the caller replays the draws."""
    if "torch_rng_state" in z:
        kind = str(z.get("torch_rng_device", "cpu"))
        if kind != generator.device.type:
            raise ValueError(f"{directory}: the checkpoint's generator state "
                             f"is from a {kind} generator; this run draws "
                             f"on {generator.device.type}")
        generator.set_state(torch.from_numpy(np.array(z["torch_rng_state"])))
    elif draws_left and draws is None:
        raise ValueError(f"{directory}: the pipeline checkpoint carries no "
                         "generator state and the stages left still draw; "
                         "resume it with the writer, or pass draws=")


def fresh_state(device, acc_keys) -> dict:
    """A pipeline's mutable state before stage 0."""
    return dict(device=device, stage=0, chunk=0, R=None, V=None, A=None,
                n_acc=None, tags=None, acc={k: [] for k in acc_keys},
                autoc={}, stage_rec={})


def restore_state(z: dict, st: dict, cfg, device,
                  stage_rec_keys=()) -> None:
    """Fill ``st`` from a pipeline checkpoint of a job (E = 1)."""
    dt = cfg.torch_dtype

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x))[None].to(device, dtype)
    st["stage"], st["chunk"] = int(z["stage"]), int(z["chunk"])
    st["R"], st["V"] = t(z["R"], dt), t(z["V"], dt)
    st["A"] = t(z["A"], dt) if "A" in z else None
    st["n_acc"] = t(z["mc_accepted"], torch.int32).reshape(1)
    if "tags" in z:
        st["tags"] = t(z["tags"])
    for k in st["acc"]:
        if k in z:
            st["acc"][k] = [t(z[k])]
    for k in AUTOC_KEYS:
        if k in z:
            st["autoc"][k] = t(z[k])
    for k in stage_rec_keys:
        if k in z:
            st["stage_rec"][k] = t(z[k])


def to_numpy(res: dict, j: Optional[int] = None) -> dict:
    return {k: (v if j is None else v[j]).cpu().numpy()
            for k, v in res.items()}
