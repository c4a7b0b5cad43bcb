"""The comparison that decides ``correct``.

The program's trajectory is chaotic and its jumps are drawn from a stream,
so the reference cannot follow a whole window from the seed: it follows one
output segment at a time from a state of the program's own run (the
plasma's positions, velocities, wavefunctions and clocks), with the stream's
own uniforms, and the sample at the segment's end is compared.  Three
segments are followed in every run, for members drawn from the seed, one
in each of the cell's blocks of the fold (:func:`checked_members`):

* ``start``: the window's first segment, from the benchmark's own start
  (t = 0), so nothing of the program enters the reference's input;
* ``stage``: the first segment of the window's last group, from the state
  the program's run handed to that group;
* ``mid``: a segment drawn from the seed among the others of the last
  group, from the checked members' state at its start, captured as the
  program ran.

Each compared number is the worst over the checked members and the
segments, and each has its limit in the cell's workload file.  Besides,
the program's own clocks are held to the harness's count
(:func:`clocks`): the tick of each followed state and of the window's
final state, the time of each, and whether the state handed to the last
group moved from the start at all."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reference import mdqt

# The clocks' limits: a tick is counted exactly; the time is the tick
# times the quantum step, rounded in float32 by the program.
CLOCK_LIMITS = {"tick_gap": 0, "t_gap": 1e-6, "unmoved": 0}


class Segment(NamedTuple):
    """One followed segment: the program's state at its start (None if it
    never came), the rows of the checked members in that state, the
    group's fetched outputs ``[E, samples, ...]``, the sample that ends
    the segment, and the tick the harness counted to its start."""
    name: str
    state: object
    rows: list
    outs: dict
    sample: int
    tick: int


def checked_members(seed: int, members: int, k: int) -> list:
    """One member drawn from ``seed`` in each of ``k`` equal blocks of the
    fold (block b: members ``b*E//k`` up to ``(b+1)*E//k``).  With the
    blocks of a rank mesh's ens axis, every rank's block is checked; with
    ``k >= 4``, every run of E/2 consecutive members holds a whole block,
    so a fold with half its members left out is always caught."""
    rng = np.random.default_rng([seed, 2])
    k = min(k, members)
    edges = [b * members // k for b in range(k + 1)]
    return [int(rng.integers(lo, hi)) for lo, hi in zip(edges, edges[1:])]


def mid_segment(seed: int, group: int) -> int:
    """The segment of the last group followed besides its first: one of
    ``1 .. group-1``, drawn from ``seed`` (0 for a group of one)."""
    if group < 2:
        return 0
    return int(np.random.default_rng([seed, 3]).integers(1, group))


def ions_of(state, rows: list, members: list, npad: int, dtype,
            device) -> mdqt.Ions:
    """The checked members' ions of a program state ``[E', n, ...]`` side
    by side (member ``members[m]`` at row ``rows[m]``), as the
    reference's planes in ``dtype``, with their global lanes (member j's
    ion i on lane ``j*npad + i``)."""
    idx = torch.as_tensor(rows, device=state.R.device)
    n = state.R.shape[1]

    def take(x):
        return x.index_select(0, idx).to(device)
    psi = take(state.psi).reshape(-1, state.psi.shape[-1])
    lanes = (torch.as_tensor(members, dtype=torch.int64)[:, None] * npad
             + torch.arange(n, dtype=torch.int64)[None, :]).reshape(-1)
    return mdqt.Ions(
        R=take(state.R).reshape(-1, 3).to(dtype),
        V=take(state.V).reshape(-1, 3).to(dtype),
        a=psi.real.to(dtype), b=psi.imag.to(dtype),
        tp=take(state.t_part).reshape(-1).to(dtype),
        lanes=lanes.to(device))


def numbers(got: dict, ref: dict) -> dict:
    """One member's sample against the reference's: each quantity's gap,
    relative to the reference's own scale."""
    def a(x):
        return np.asarray(x.detach().to(torch.float64).cpu()
                          if isinstance(x, torch.Tensor) else x, np.float64)
    r = {k: a(v) for k, v in ref.items()}
    g = {k: a(got[k]) for k in r}
    vth = np.sqrt(2.0 * r["ekin"][0])
    dvx = g["vx_ions"] - r["vx_ions"]
    return dict(
        ekin=float(np.max(np.abs(g["ekin"] - r["ekin"]) / np.abs(r["ekin"]))),
        epot=float(abs(g["epot"] - r["epot"]) / abs(r["epot"])),
        vx_mean=float(abs(g["vx_mean"] - r["vx_mean"]) / vth),
        pvel=float(np.max(np.abs(g["pvel"] - r["pvel"])) / np.max(r["pvel"])),
        vx_ions=float(np.sqrt(np.mean(dvx ** 2))
                      / np.sqrt(np.mean(r["vx_ions"] ** 2))),
        pops=float(np.mean(np.abs(g["pops"] - r["pops"]))))


def follow(config: dict, state, rows: list, members: list, tick: int,
           word: int, dtype, device) -> list:
    """The reference's samples (one dict per checked member) of the
    segment that starts at ``state`` at the counted ``tick``."""
    sc = mdqt.scheme_of(config, dtype, device)
    ions = ions_of(state, rows, members, config["derived"]["npad"], dtype,
                   device)
    return mdqt.follow_segment(sc, ions, state.R.shape[1], tick,
                               config["physics"]["sample_freq"], word)


NUMBERS = ("ekin", "epot", "vx_mean", "pvel", "vx_ions", "pops")


def _worst(acc: dict, nums: dict) -> None:
    for k, v in nums.items():
        acc[k] = max(acc.get(k, 0.0), v if np.isfinite(v) else np.inf)


def compare(config: dict, segments: list, members: list, word: int,
            device="cpu", control=None) -> tuple:
    """The worst of :func:`numbers` over the :class:`Segment` s and the
    checked ``members``, against the float64 reference; a segment whose
    state never came reads infinite.  With ``control`` (a dtype), also the
    worst of the reference computed in that dtype in the program's place.
    Returns ``(program, control or None)``."""
    prog, ctrl = {}, {} if control is not None else None
    for seg in segments:
        if seg.state is None:
            _worst(prog, {k: np.inf for k in NUMBERS})
            continue
        refs = follow(config, seg.state, seg.rows, members, seg.tick, word,
                      torch.float64, device)
        for j, ref in zip(members, refs):
            _worst(prog, numbers({k: seg.outs[k][j, seg.sample]
                                  for k in ref}, ref))
        if control is not None:
            for lo, ref in zip(follow(config, seg.state, seg.rows, members,
                                      seg.tick, word, control, device),
                               refs):
                _worst(ctrl, numbers(lo, ref))
    return prog, ctrl


def clocks(config: dict, segments: list, final) -> dict:
    """The program's clocks against the harness's count: ``tick_gap``, the
    largest gap between a followed state's tick (and the window's
    ``final = (state, counted ticks)``) and the count; ``t_gap``, the
    largest gap of their times from tick x quantum step, relative to it;
    ``unmoved``, 1 if a state counted past the start has the start's
    positions, else 0."""
    qdt = config["derived"]["qdt"]
    states = [(s.state, s.tick, s.rows) for s in segments
              if s.state is not None] + [(final[0], final[1], None)]
    tick = max(abs(int(st.tick) - n) for st, n, _ in states)
    t = max(abs(float(st.t) - n * qdt) / max(n * qdt, qdt)
            for st, n, _ in states)
    start = next((s for s in segments if s.tick == 0
                  and s.state is not None), None)
    unmoved = 0
    if start is not None:
        R0 = start.state.R[torch.as_tensor(start.rows,
                                           device=start.state.R.device)]
        for s in segments:
            if s.tick and s.state is not None:
                R = s.state.R[torch.as_tensor(s.rows,
                                              device=s.state.R.device)]
                unmoved = max(unmoved, int(torch.equal(R.cpu(), R0.cpu())))
    return dict(tick_gap=tick, t_gap=t, unmoved=unmoved)


def judge(worst: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})`` over the limited numbers;
    a number that is not finite fails."""
    table = {k: dict(value=worst[k], limit=lim) for k, lim in limits.items()}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
