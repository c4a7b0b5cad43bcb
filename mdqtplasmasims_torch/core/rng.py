"""The in-kernel uniform stream of the tick kernel, as plain torch.

The JAX package's device path draws its jump uniforms inside the fused
tick kernel from the TPU's hardware PRNG (core/qt_fused.py:111-130 and
:251-260 of the JAX package, ``internal_rng``).  Those bits cannot be
reproduced off the TPU, so the port defines its own counter-based
stream, which ``csrc/fused_ticks.cu`` computes per ion and tick and this
module computes for the kernel's plain twin and the tests:

* Threefry-2x32 with 20 rounds (Random123; the same function as JAX's
  ``threefry_2x32``);
* key ``(word, 0)`` with ``word`` the run's 31-bit seed word, counter
  ``(n, 3*tick + j)`` for ``j = 0, 1, 2``, where ``n`` is the global lane
  index (``lane0`` plus the lane within the launch: a mesh slot holds
  lanes ``lane0 ..`` of its fold's global numbering) and ``tick`` the
  absolute run tick, so the stream depends on neither the launch geometry,
  the block index nor the split of a fold between slots, and no two
  (lane, tick) pairs share a counter within a run shorter than 2**32/3
  ticks;
* words 0-4 of the three outputs are the tick's uniforms r0..r4, each
  the top 24 bits of its word times 2**-24 (as the JAX kernel forms them,
  :254-259), so u < 1 always holds: the jump collapse relies on that
  against the saturated pad rows of its destination tables.

The arithmetic runs on int64 tensors holding uint32 values (torch has no
full uint32 arithmetic), masked back to 32 bits after every add and
shift.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)   # Random123 R_32x2
_PARITY = 0x1BD11BDA                           # Skein key-schedule parity


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32-20 of counters ``(x0, x1)`` under key ``(k0, k1)``.
    Arguments are ints or int64 tensors holding uint32 values (they
    broadcast); returns the two output words the same way."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for r in range(20):
        rot = _ROTATIONS[r % 8]
        x0 = (x0 + x1) & _MASK
        x1 = ((x1 << rot) | (x1 >> (32 - rot))) & _MASK
        x1 = x1 ^ x0
        if r % 4 == 3:             # key injection after every 4 rounds
            s = r // 4 + 1
            x0 = (x0 + ks[s % 3]) & _MASK
            x1 = (x1 + ks[(s + 1) % 3] + s) & _MASK
    return x0, x1


def tick_uniforms(word: int, tick0: int, n_ticks: int, npad: int,
                  device=None, lane0: int = 0) -> torch.Tensor:
    """The uniforms the RNG form of the tick kernel draws for ticks
    ``tick0 .. tick0+n_ticks-1`` on global lanes ``lane0 .. lane0+npad-1``,
    laid out as the explicit rolls are: ``[n_ticks*5, npad]`` float32, row
    ``i*5 + k`` is tick i's r_k."""
    n = torch.arange(lane0, lane0 + npad, dtype=torch.int64,
                     device=device)[None, None, :] & _MASK
    tick = torch.arange(tick0, tick0 + n_ticks, dtype=torch.int64,
                        device=device)[:, None, None]
    j = torch.arange(3, dtype=torch.int64, device=device)[None, :, None]
    y0, y1 = threefry2x32(int(word) & _MASK, 0, n,
                          (3 * tick + j) & _MASK)      # [n_ticks, 3, npad]
    words = torch.stack([y0[:, 0], y1[:, 0], y0[:, 1], y1[:, 1], y0[:, 2]],
                        dim=1)                          # [n_ticks, 5, npad]
    u = (words >> 8).to(torch.float32) * 2.0 ** -24
    return u.reshape(n_ticks * 5, npad)
