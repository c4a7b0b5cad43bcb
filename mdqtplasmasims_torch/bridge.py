"""States carried across between the JAX package and the port.

A JAX ``SimState`` (or anything with the same fields, e.g. the numpy
pytree ``laser_cooling.run`` returns) becomes a port :class:`SimState` on
a chosen device, and back.  Only numpy crosses the boundary, so this
module needs neither framework's other side: ``np.asarray`` reads a JAX
array without importing JAX here.  The PRNG key of a JAX state has no
counterpart (the port draws from explicit ``torch.Generator`` objects)
and is dropped.  :func:`qt_params_from_numpy` carries a sweep fold's
per-member engine tables the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .state import SimState, make_state


class NumpyState(NamedTuple):
    """Host copy of a :class:`SimState` (the fields of the JAX SimState
    minus the key)."""

    R: np.ndarray
    V: np.ndarray
    F: np.ndarray
    psi: np.ndarray
    t_part: np.ndarray
    tick: int
    t: float


def state_from_numpy(src, *, device, dtype=torch.float32) -> SimState:
    """Port state from a JAX ``SimState`` or :class:`NumpyState`."""
    # np.array copies: a JAX array's numpy view is read-only
    return make_state(np.array(src.R), np.array(src.V), np.array(src.psi),
                      device=device, dtype=dtype, F=np.array(src.F),
                      t_part=np.array(src.t_part),
                      tick=int(np.asarray(src.tick)),
                      t=float(np.asarray(src.t)))


def states_from_numpy(src, *, device, dtype=torch.float32) -> SimState:
    """Ensemble fold ``[E, n, ...]`` from a stacked JAX ``SimState`` or
    :class:`NumpyState`.  The members must share one tick (the fold's
    precondition); F and t_part default to zeros."""
    from .core.scheduler import check_uniform_tick
    tick, t = np.asarray(src.tick), np.asarray(src.t)
    check_uniform_tick(tick)
    R = np.array(src.R)
    F = getattr(src, "F", None)
    t_part = getattr(src, "t_part", None)
    return make_state(R, np.array(src.V), np.array(src.psi), device=device,
                      dtype=dtype,
                      F=np.zeros_like(R) if F is None else np.array(F),
                      t_part=(np.zeros(R.shape[:2], R.dtype) if t_part is None
                              else np.array(t_part)),
                      tick=int(tick.flat[0]), t=float(t.flat[0]))


def state_to_numpy(state: SimState) -> NumpyState:
    """Host numpy copy of a port state (one device sync)."""
    return NumpyState(R=state.R.cpu().numpy(), V=state.V.cpu().numpy(),
                      F=state.F.cpu().numpy(), psi=state.psi.cpu().numpy(),
                      t_part=state.t_part.cpu().numpy(), tick=state.tick,
                      t=state.t)


def qt_params_from_numpy(src, *, device, dtype=torch.float32):
    """Port ``QTParams`` from the JAX package's (any object with the same
    six array fields), on ``device`` in ``dtype`` and its complex
    counterpart.  An ``[E]``-batched source (core/qt.sweep_member_params
    there, every leaf with the member axis leading) keeps the axis on
    ``e0 [E, S]`` and ``coupling [E, S, S]``, the two tables a sweep
    varies; the decay rates and jump tables, which no sweep touches, must
    agree across the members and come out unbatched, as the port's
    ``step_sm`` reads them."""
    from .core.qt import QTParams
    from .state import complex_dtype
    batched = np.asarray(src.e0).ndim == 2

    def leaf(name, dt, varies=False):
        a = np.array(getattr(src, name))
        if batched and not varies:
            if (a != a[:1]).any():
                raise ValueError(f"QTParams.{name} differs between the "
                                 "members; only e0 and coupling may")
            a = a[0]
        return torch.as_tensor(a).to(device=device, dtype=dt)
    cdt = complex_dtype(dtype)
    return QTParams(decay_w=leaf("decay_w", dtype),
                    e0=leaf("e0", dtype, True), e1=leaf("e1", dtype),
                    coupling=leaf("coupling", cdt, True),
                    jump_src_mask=leaf("jump_src_mask", dtype),
                    jump_dest_cum=leaf("jump_dest_cum", dtype))
