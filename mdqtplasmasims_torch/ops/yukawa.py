"""All-pairs Yukawa (screened-Coulomb) forces and potential.

Counterpart of ``mdqtplasmasims_tpu/ops/yukawa.py``.  Physics:

    force:      f(r) = (1/r + 1/lDeb) * exp(-r/lDeb) / r^2 * dr_vec
                (laserCooling...SpeedUp.cpp:224)
    potential:  u(r) = exp(-r/lDeb)/r            (Epotential :268)
    minimum-image convention, half-box cutoff Rcut = L/2, r > 0.

* ``yukawa_forces_potential`` / ``yukawa_forces`` / ``yukawa_potential``:
  plain torch, row-chunked, ``[N, 3]`` layout; the potential is taken at
  sample time.
* ``yukawa_forces_n3l_soa``: the main path's once-per-MD-step force
  refresh in the lane layout ``[3, Np]``.  On a CUDA tensor it launches
  the hand-written kernel ``csrc/yukawa_forces.cu``; on a CPU tensor it
  runs :func:`yukawa_forces_n3l_soa_reference`, the plain twin.
* ``yukawa_forces_n3l_soa_batched``: the same for an ensemble fold
  ``[3, E*Np]`` (member blocks contiguous on the lane axis), with a
  shared or per-member real-ion mask and an optional per-member 1/lambda;
  one launch of the same kernel with a member grid axis, or
  :func:`yukawa_forces_n3l_soa_batched_reference` on the CPU.  From
  ``HALF_MIN_NPAD`` lanes a member on, these two take the half-pair form,
  each pair of a member once (:func:`half_pair_split`).
* ``yukawa_forces_potential_pallas`` (and ``yukawa_forces_pallas``,
  ``yukawa_potential_pallas``) / ``yukawa_forces_potential_pallas_batched``
  (``yukawa_potential_pallas_batched``): the JAX package's entries of its
  full-tile kernels D and G, forces **and** the per-ion potential, in the
  ``[N, 3]`` / ``[E, N, 3]`` layout.  On a CUDA tensor they launch the
  potential form of the same kernel; on a CPU tensor they run
  :func:`yukawa_forces_potential`, their twin.  The sample-time potential
  goes through them.
* ``best_forces_fn``: the JAX package's ``R -> (F, pot | None)`` chooser
  over those entries (so a CUDA tensor always reaches a kernel);
  ``best_forces_fn_batched`` the same for a fold ``[E, N, 3]`` with
  per-member masks (kernels C and G, one launch for all members).
* ``yukawa_forces_soa_cols_batched`` (kernel E) and
  ``yukawa_forces_cross_n3l_soa_batched`` (kernel F): the mesh path's
  force kernels (parallel/ensemble.py): a shard's rows against the
  all-gathered columns of its members, and each pair of two different ion
  blocks once with the column reactions; CUDA tensors launch
  ``csrc/yukawa_forces.cu``, CPU tensors their ``*_reference`` twins.
  ``yukawa_forces_potential(cols=)`` is the plain source-set path the
  XLA-path mesh functions use.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from .member_sum import ion_sum


def yukawa_forces_potential(R: torch.Tensor, L: float, ldeb: float,
                            mask: Optional[torch.Tensor] = None,
                            chunk: int = 512,
                            cols: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forces [N,3] and per-ion potential sums [N].

    ``sum(pot)/(2*N)`` equals the reference's Epot per particle.  ``cols``
    optionally supplies a different source set (the all-gathered global
    positions when ``R`` is an ion shard, parallel/ensemble.py);
    ``mask`` marks real ions of the source set, and without ``cols`` it
    also gates the rows."""
    n = R.shape[0]
    rcut2 = (L / 2.0) ** 2
    Rc = R if cols is None else cols
    F = torch.empty_like(R)
    pot = torch.empty(n, dtype=R.dtype, device=R.device)
    for s in range(0, n, chunk):
        Ri = R[s:s + chunk]
        d = Ri[:, None, :] - Rc[None, :, :]            # [c, Nc, 3]
        d = d - L * torch.round(d / L)
        r2 = torch.sum(d * d, dim=-1)
        valid = (r2 > 0) & (r2 < rcut2)
        if mask is not None:
            valid = valid & (mask[None, :] > 0)
        r = torch.sqrt(torch.where(valid, r2, torch.ones_like(r2)))
        expf = torch.exp(-r / ldeb)
        ft = torch.where(valid, (1.0 / r + 1.0 / ldeb) * expf / r2,
                         torch.zeros_like(r2))
        F[s:s + chunk] = torch.sum(d * ft[..., None], dim=1)
        pot[s:s + chunk] = torch.sum(
            torch.where(valid, expf / r, torch.zeros_like(r2)), dim=1)
    if mask is not None and cols is None:
        F = F * mask[:, None]
        pot = pot * mask
    return F, pot


def yukawa_forces(R, L, ldeb, mask=None, chunk: int = 512) -> torch.Tensor:
    return yukawa_forces_potential(R, L, ldeb, mask, chunk)[0]


def yukawa_potential(R, L, ldeb, mask=None, chunk: int = 512):
    """Potential energy per particle (0-d tensor), reference Epotential()."""
    _, pot = yukawa_forces_potential(R, L, ldeb, mask, chunk)
    if mask is None:
        return 0.5 * ion_sum(pot) / R.shape[0]
    return 0.5 * ion_sum(pot, mask=mask) / torch.sum(mask)


def soa_force_tile(npad: int) -> int:
    """Largest force-tile width that divides an already-padded lane count
    (the SoA loop pads with the QT tile, a multiple of 128)."""
    for t in (512, 256, 128):
        if npad % t == 0:
            return t
    raise ValueError(f"npad {npad} not a multiple of 128")


def yukawa_forces_n3l_soa_reference(Rp: torch.Tensor, mask_row: torch.Tensor,
                                    L: float, ldeb: float,
                                    chunk: int = 256,
                                    inv_ldeb=None) -> torch.Tensor:
    """Plain torch twin of the force kernel: ``F [3, Np]`` from ``Rp [3, Np]``
    and ``mask_row [1, Np]``, the same tile math as the JAX kernel
    (_half_pair_tile), chunked over rows.  Works in Rp's dtype.
    ``inv_ldeb`` (a 0-d tensor) replaces ``1/ldeb`` as the kernel's
    per-member value."""
    npad = Rp.shape[1]
    rcut2 = (L / 2.0) ** 2
    if inv_ldeb is None:
        inv_ldeb = 1.0 / ldeb
    m = mask_row[0] > 0
    F = torch.empty_like(Rp)
    for s in range(0, npad, chunk):
        d = Rp[:, s:s + chunk, None] - Rp[:, None, :]   # [3, c, Np]
        d = d - L * torch.round(d * (1.0 / L))
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        valid = (r2 > 0) & (r2 < rcut2) & m[None, :] & m[s:s + chunk, None]
        r2s = torch.where(valid, r2, torch.ones_like(r2))
        inv_r = torch.rsqrt(r2s)
        r = r2s * inv_r
        ft = torch.where(valid, torch.exp(-r * inv_ldeb)
                         * (inv_r + inv_ldeb) * inv_r * inv_r,
                         torch.zeros_like(r2))
        F[:, s:s + chunk] = torch.sum(d * ft[None], dim=2)
    return F


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# The launch geometry of csrc/yukawa_forces.cu (its ROW_TILE, COL_TILE and
# WARPS): a block of WARPS warps owns ROW_TILE rows and sweeps a chunk of
# columns, COL_TILE (32 per warp) at a time.
ROW_TILE = 64
COL_TILE = 128
WARPS = 4
# blocks wanted for one member: 32 warps for each of the H100's 132 x 4
# warp schedulers, some three times what an SM holds at once (10 blocks of
# 46-47 registers per thread), so that the last wave of blocks is a small
# share of the launch; a fold of E members launches E times as many
TARGET_BLOCKS = 132 * 4 * 32 // WARPS


class PairSplit(NamedTuple):
    """How one launch of the pair kernel cuts its rows x columns work."""
    chunk: int                      # columns per chunk
    grid: Tuple[int, int, int]      # (row tiles, column chunks, members)

    @property
    def warps(self) -> int:
        return WARPS * self.grid[0] * self.grid[1] * self.grid[2]


def pair_split(npad: int, ncols: int, e: int) -> PairSplit:
    """The column chunking of a launch over ``e`` members of ``npad`` rows
    x ``ncols`` columns: enough chunks (each a multiple of COL_TILE) that
    one member's grid reaches TARGET_BLOCKS where the columns allow it.
    A function of (npad, ncols) alone, never of ``e`` or the masks: the
    chunking fixes the order of every row sum, so a member's forces have
    the same bits in a fold of any width (a mesh slot's block and the
    unsharded fold, an E=1 fold and kernel A), and kernel E on a member's
    own lanes agrees bit for bit with kernel C where C sweeps the same
    rectangle (below :data:`HALF_MIN_NPAD` lanes; from there on
    :func:`half_pair_split` cuts A and C)."""
    if npad <= 0 or npad % ROW_TILE or ncols <= 0 or ncols % COL_TILE:
        raise ValueError(f"want npad a positive multiple of {ROW_TILE} and "
                         f"ncols of {COL_TILE}, got {npad} and {ncols}")
    if not 1 <= e <= 65535:
        raise ValueError(f"want 1 <= E <= 65535 members, got {e}")
    want = min(-(-TARGET_BLOCKS // (npad // ROW_TILE)), ncols // COL_TILE)
    chunk = _round_up(-(-ncols // want), COL_TILE)
    return PairSplit(chunk, (npad // ROW_TILE, -(-ncols // chunk), e))


# members of at least this many lanes take the half-pair form of kernels A
# and C (csrc/yukawa_forces.cu): below it a member's launch is set by its
# fixed cost and its last wave rather than by its pairs, and every shape
# keeps the full rectangle's bits
HALF_MIN_NPAD = 2048


def half_form(npad: int, with_pot: bool = False) -> bool:
    """Whether a launch of kernel A or C over members of ``npad`` lanes
    takes the half-pair form: forces only, and ``npad`` at least
    :data:`HALF_MIN_NPAD`; the potential forms D and G never do."""
    return not with_pot and npad >= HALF_MIN_NPAD


class HalfSplit(NamedTuple):
    """How the half-pair form cuts one member's triangle of row tiles:
    block b takes row tile ``t, k = blocks[b]`` against the columns
    ``[t * ROW_TILE + k * chunk, + chunk)`` (cut at npad), so that chunk 0
    of a row tile starts at its own diagonal tile."""
    chunk: int                          # columns per block
    blocks: Tuple[Tuple[int, int], ...]     # (row tile, chunk), i-major
    chunks: int     # of row tile 0, the most: the row-sum scratch's slabs


def half_pair_split(npad: int) -> HalfSplit:
    """The block decomposition of the half-pair form for members of
    ``npad`` lanes: each pair of row tiles (I, J >= I) once, in the JAX
    package's ``_n3l_pairs`` order (i-major, J ascending), a block taking
    a chunk of ``chunk / ROW_TILE`` of them from one row tile; the chunk is
    the triangle's columns over TARGET_BLOCKS rounded up to a multiple of
    COL_TILE, so that one member's grid comes near TARGET_BLOCKS where the
    triangle is large enough and takes the finest chunk where it is not.
    A function of ``npad`` alone, as :func:`pair_split` is of its shape: a
    member's forces have the same bits in a fold of any width, and an E=1
    fold is kernel A."""
    if npad <= 0 or npad % COL_TILE:
        raise ValueError(f"want npad a positive multiple of {COL_TILE}, got "
                         f"{npad}")
    tiles = npad // ROW_TILE
    pair_cols = tiles * (tiles + 1) // 2 * ROW_TILE
    chunk = _round_up(-(-pair_cols // TARGET_BLOCKS), COL_TILE)
    per = chunk // ROW_TILE
    return HalfSplit(chunk, tuple((t, k) for t in range(tiles)
                                  for k in range(-(-(tiles - t) // per))),
                     -(-tiles // per))


def half_scratch_floats(split: HalfSplit, npad: int,
                        e: int) -> Tuple[int, int]:
    """Floats of the half form's scratch: the row sums ``part_f [chunks,
    3, E*npad]`` and the reactions ``part_g [E, row tiles, 3, npad]`` (a
    row tile's reactions on the columns past its diagonal tile)."""
    return (split.chunks * 3 * e * npad,
            e * (npad // ROW_TILE) * 3 * npad)


@functools.lru_cache(maxsize=None)
def _half_plan(npad: int, device) -> Tuple[HalfSplit, torch.Tensor]:
    """:func:`half_pair_split` and its blocks as the kernel reads them
    (``int32 [blocks, 2]`` on ``device``), made once per shape."""
    split = half_pair_split(npad)
    return split, torch.tensor(split.blocks, dtype=torch.int32,
                               device=device)


def row_scratch_floats(split: PairSplit, npad: int, nv: int) -> int:
    """Floats of the row-sum scratch ``part_f [chunks, nv, E*npad]`` (nv =
    3, or 4 with the potential); none with one chunk, whose blocks write
    the outputs themselves."""
    _, chunks, e = split.grid
    return 0 if chunks == 1 else chunks * nv * e * npad


def reaction_scratch_floats(split: PairSplit, npc: int) -> int:
    """Floats of kernel F's reaction scratch ``part_g [E, row tiles, npc,
    3]``."""
    tiles, _, e = split.grid
    return e * tiles * npc * 3


def _row_scratch(split: PairSplit, npad: int, nv: int, device):
    n = row_scratch_floats(split, npad, nv)
    return (None if n == 0
            else torch.empty((n,), dtype=torch.float32, device=device))


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("yukawa_forces")
    p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.yukawa_forces_launch.argtypes = [p, p, i, p, p, p, p, p, p, i, i, i,
                                         i, f, f, f, f, p]
    lib.yukawa_forces_launch.restype = ctypes.c_int
    lib.yukawa_forces_cols_launch.argtypes = [p, p, i, p, p, i, p, p, i, i, i,
                                              i, f, f, f, f, p]
    lib.yukawa_forces_cols_launch.restype = ctypes.c_int
    lib.yukawa_cross_launch.argtypes = [p, p, i, p, p, i, p, p, p, p, i, i, i,
                                        i, f, f, f, f, p]
    lib.yukawa_cross_launch.restype = ctypes.c_int
    return lib


def _launch_forces(Rp: torch.Tensor, mask_row: torch.Tensor, e: int,
                   L: float, ldeb: float, inv_ldeb: Optional[torch.Tensor],
                   with_pot: bool):
    """One launch of ``yukawa_forces_launch`` (kernels A, C, D, G) on
    checked CUDA operands: ``(F [3, E*Np], pot [E*Np] | None)``."""
    npad = Rp.shape[1] // e
    split = pair_split(npad, npad, e)   # checks the shape for both forms
    F = torch.empty_like(Rp)
    pot = (torch.empty((e * npad,), dtype=torch.float32, device=Rp.device)
           if with_pot else None)
    if half_form(npad, with_pot):
        # one scratch: part_f's floats, then part_g's
        half, blocks = _half_plan(npad, Rp.device)
        n_rows, n_react = half_scratch_floats(half, npad, e)
        scratch = torch.empty((n_rows + n_react,), dtype=torch.float32,
                              device=Rp.device)
        chunk, part = half.chunk, scratch.data_ptr()
        react, table = part + 4 * n_rows, blocks.data_ptr()
        n_blocks = blocks.shape[0]
    else:
        scratch = _row_scratch(split, npad, 4 if with_pot else 3, Rp.device)
        chunk, part, react, table, n_blocks = (split.chunk, _ptr(scratch),
                                               None, None, 0)
    lib = _lib()
    with _build.device_guard(Rp.device):
        err = lib.yukawa_forces_launch(
            Rp.data_ptr(), mask_row.data_ptr(),
            npad if mask_row.shape[0] > 1 else 0, _ptr(inv_ldeb),
            F.data_ptr(), _ptr(pot), part, react, table, n_blocks, npad, e,
            chunk, float(L), float(1.0 / L), float((L / 2.0) ** 2),
            float(1.0 / ldeb), _build.raw_stream(Rp.device))
    _build.check(lib, err, "yukawa_forces_launch")
    return F, pot


def yukawa_forces_n3l_soa(Rp: torch.Tensor, mask_row: torch.Tensor,
                          L: float, ldeb: float) -> torch.Tensor:
    """Forces straight from the lane layout: ``Rp [3, Np]`` (padded, as the
    SoA MD loop carries it) and ``mask_row [1, Np]`` marking real ions.
    Returns ``F [3, Np]``; padded lanes are exactly 0.

    CUDA tensors (float32, contiguous, Np a multiple of 128) launch
    ``csrc/yukawa_forces.cu`` and add one to ``yukawa_forces_n3l_soa.
    launches``, and from :data:`HALF_MIN_NPAD` lanes on, where the launch
    takes the half-pair form (each pair once, :func:`half_pair_split`), to
    ``.half_launches``; CPU tensors run the plain twin."""
    npad = Rp.shape[1] if Rp.dim() == 2 else -1
    if Rp.shape != (3, npad) or mask_row.shape != (1, npad):
        raise ValueError(f"want Rp [3, Np] and mask_row [1, Np], got "
                         f"{tuple(Rp.shape)} and {tuple(mask_row.shape)}")
    if mask_row.device != Rp.device or mask_row.dtype != Rp.dtype:
        raise ValueError("Rp and mask_row must share device and dtype")
    if Rp.device.type == "cpu":
        return yukawa_forces_n3l_soa_reference(Rp, mask_row, L, ldeb)
    if Rp.device.type != "cuda":
        raise ValueError(f"no force kernel for device {Rp.device}")
    if Rp.dtype != torch.float32:
        raise ValueError(f"the CUDA force kernel is float32, got {Rp.dtype}")
    if not (Rp.is_contiguous() and mask_row.is_contiguous()):
        raise ValueError("Rp and mask_row must be contiguous")
    soa_force_tile(npad)               # Np must be a multiple of 128
    F, _ = _launch_forces(Rp, mask_row, 1, L, ldeb, None, False)
    _build.count_launch(yukawa_forces_n3l_soa)
    if half_form(npad):
        _build.count_launch(yukawa_forces_n3l_soa, "half_launches")
    return F


yukawa_forces_n3l_soa.launches = 0
yukawa_forces_n3l_soa.half_launches = 0     # those of the half-pair form


def yukawa_forces_n3l_soa_batched_reference(
        Rp: torch.Tensor, mask_row: torch.Tensor, e: int, L: float,
        ldeb: float, inv_ldeb: Optional[torch.Tensor] = None,
        chunk: int = 256) -> torch.Tensor:
    """Plain torch twin of the batched force kernel: member by member,
    the tile math of :func:`yukawa_forces_n3l_soa_reference` on that
    member's lane block.  ``inv_ldeb [E]`` overrides ``1/ldeb`` per
    member."""
    npad = Rp.shape[1] // e
    F = torch.empty_like(Rp)
    for k in range(e):
        lanes = slice(k * npad, (k + 1) * npad)
        m = mask_row[k if mask_row.shape[0] > 1 else 0][None]
        F[:, lanes] = yukawa_forces_n3l_soa_reference(
            Rp[:, lanes], m, L, ldeb, chunk,
            inv_ldeb=None if inv_ldeb is None else inv_ldeb[k])
    return F


def yukawa_forces_n3l_soa_batched(Rp: torch.Tensor, mask_row: torch.Tensor,
                                  e: int, L: float, ldeb: float,
                                  inv_ldeb: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Job-batched forces straight from the folded lane layout: ``Rp [3,
    E*Np]`` (member blocks contiguous on the lane axis, as the ensemble
    loop carries them) and ``mask_row`` marking real ions, ``[1, Np]``
    shared by the members or ``[E, Np]`` per member (Poissonian counts).
    ``inv_ldeb [E]`` gives each member its own 1/lambda (the JAX kernel's
    ys column 4); otherwise all use ``1/ldeb``.  Returns ``F [3, E*Np]``;
    padded lanes are exactly 0.

    CUDA tensors (float32, contiguous, Np a multiple of 128) launch
    ``csrc/yukawa_forces.cu`` over the grid of :func:`pair_split`, or from
    :data:`HALF_MIN_NPAD` lanes on over each member's triangle of
    :func:`half_pair_split` (each pair once), and add one to
    ``yukawa_forces_n3l_soa_batched.launches`` (and then to
    ``.half_launches``); CPU tensors run the plain twin."""
    if Rp.dim() != 2 or Rp.shape[0] != 3 or e < 1 or Rp.shape[1] % e:
        raise ValueError(f"want Rp [3, E*Np] with E={e}, got "
                         f"{tuple(Rp.shape)}")
    npad = Rp.shape[1] // e
    if tuple(mask_row.shape) not in ((1, npad), (e, npad)):
        raise ValueError(f"want mask_row [1, {npad}] or [{e}, {npad}], got "
                         f"{tuple(mask_row.shape)}")
    extra = [mask_row] + ([] if inv_ldeb is None else [inv_ldeb])
    if inv_ldeb is not None and tuple(inv_ldeb.shape) != (e,):
        raise ValueError(f"want inv_ldeb [{e}], got {tuple(inv_ldeb.shape)}")
    if any(x.device != Rp.device or x.dtype != Rp.dtype for x in extra):
        raise ValueError("Rp, mask_row and inv_ldeb must share device and "
                         "dtype")
    if Rp.device.type == "cpu":
        return yukawa_forces_n3l_soa_batched_reference(Rp, mask_row, e, L,
                                                       ldeb, inv_ldeb)
    if Rp.device.type != "cuda":
        raise ValueError(f"no force kernel for device {Rp.device}")
    if Rp.dtype != torch.float32:
        raise ValueError(f"the CUDA force kernel is float32, got {Rp.dtype}")
    if not all(x.is_contiguous() for x in [Rp] + extra):
        raise ValueError("Rp, mask_row and inv_ldeb must be contiguous")
    soa_force_tile(npad)               # Np must be a multiple of 128
    F, _ = _launch_forces(Rp, mask_row, e, L, ldeb, inv_ldeb, False)
    _build.count_launch(yukawa_forces_n3l_soa_batched)
    if half_form(npad):
        _build.count_launch(yukawa_forces_n3l_soa_batched, "half_launches")
    return F


yukawa_forces_n3l_soa_batched.launches = 0
yukawa_forces_n3l_soa_batched.half_launches = 0


def _pair_ft(d: torch.Tensor, valid: torch.Tensor, inv_ldeb):
    """Force factor of each pair of ``d [3, ...]`` (the kernels' tile math,
    0 where not ``valid``)."""
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    r2s = torch.where(valid, r2, torch.ones_like(r2))
    inv_r = torch.rsqrt(r2s)
    r = r2s * inv_r
    return torch.where(valid, torch.exp(-r * inv_ldeb)
                       * (inv_r + inv_ldeb) * inv_r * inv_r,
                       torch.zeros_like(r2))


def _rows_cols_pairs(rows: torch.Tensor, C: torch.Tensor, L: float):
    """Minimum-image separations ``[3, nr, nc]`` of ``rows [3, nr]`` from
    ``C [3, nc]`` and their ``0 < r^2 < (L/2)^2`` test."""
    d = rows[:, :, None] - C[:, None, :]
    d = d - L * torch.round(d * (1.0 / L))
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    return d, (r2 > 0) & (r2 < (L / 2.0) ** 2)


def _cols_operands(Rp, cols, col_mask, e: int, what: str):
    """Check the rows x cols operands of kernels E and F; returns (npad,
    ncols, the column masks as ``[E, ncols]``)."""
    if Rp.dim() != 2 or Rp.shape[0] != 3 or e < 1 or Rp.shape[1] % e:
        raise ValueError(f"{what}: want Rp [3, E*Np] with E={e}, got "
                         f"{tuple(Rp.shape)}")
    if cols.dim() != 3 or cols.shape[0] != e or cols.shape[2] != 3:
        raise ValueError(f"{what}: want cols [{e}, ncols, 3], got "
                         f"{tuple(cols.shape)}")
    ncols = cols.shape[1]
    if tuple(col_mask.shape) not in ((ncols,), (e, ncols)):
        raise ValueError(f"{what}: want col_mask [{ncols}] or [{e}, "
                         f"{ncols}], got {tuple(col_mask.shape)}")
    if any(x.device != Rp.device or x.dtype != Rp.dtype
           for x in (cols, col_mask)):
        raise ValueError(f"{what}: Rp, cols and col_mask must share device "
                         "and dtype")
    if Rp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no force kernel for device {Rp.device}")
    return Rp.shape[1] // e, ncols, col_mask.expand(e, ncols)


def _cuda_operands(what: str, *xs) -> None:
    if xs[0].dtype != torch.float32:
        raise ValueError(f"the CUDA force kernel is float32, got "
                         f"{xs[0].dtype}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{what}: operands must be contiguous")


def _row_mask_operand(row_mask, Rp, e: int, npad: int, what: str) -> None:
    """Check the rows' mask of kernel E or F (``what`` names kernel and
    argument)."""
    if tuple(row_mask.shape) not in ((1, npad), (e, npad)):
        raise ValueError(f"{what}: want [1, {npad}] or [{e}, {npad}], got "
                         f"{tuple(row_mask.shape)}")
    if row_mask.device != Rp.device or row_mask.dtype != Rp.dtype:
        raise ValueError(f"{what} must share Rp's device and dtype")


def yukawa_forces_soa_cols_batched_reference(
        Rp: torch.Tensor, cols: torch.Tensor, col_mask: torch.Tensor, e: int,
        L: float, ldeb: float, chunk: int = 256,
        row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch twin of kernel E: every row lane of member k against
    ``cols[k]`` where ``col_mask`` is set, the tile math of
    :func:`yukawa_forces_n3l_soa_reference`; with ``row_mask [1|E, Np]``
    the rows it clears come out 0."""
    npad, _, cm = _cols_operands(Rp, cols, col_mask, e, "cols reference")
    F = torch.empty_like(Rp)
    for k in range(e):
        C = cols[k].T
        for s in range(k * npad, (k + 1) * npad, chunk):
            top = min(s + chunk, (k + 1) * npad)
            d, valid = _rows_cols_pairs(Rp[:, s:top], C, L)
            ft = _pair_ft(d, valid & (cm[k][None, :] > 0), 1.0 / ldeb)
            F[:, s:top] = torch.sum(d * ft[None], dim=2)
    if row_mask is not None:
        F = F * row_mask.expand(e, npad).reshape(1, e * npad)
    return F


def yukawa_forces_soa_cols_batched(Rp: torch.Tensor, cols: torch.Tensor,
                                   col_mask: torch.Tensor, e: int, L: float,
                                   ldeb: float,
                                   row_mask: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Kernel E: row forces from the folded lane layout against an
    explicit column set: ``Rp [3, E*Np]`` local ion-shard rows (member
    blocks contiguous), ``cols [E, ncols, 3]`` the source positions (the
    all-gathered ion set of each member), ``col_mask`` marking real source
    ions, ``[ncols]`` shared or ``[E, ncols]`` per member.  Full pairs
    (the reaction half lives on another shard).  Without ``row_mask`` the
    rows carry no mask, as in the JAX package's entry: padded row lanes
    may hold garbage, and a caller whose padded lanes feed back zeroes them
    afterwards.  ``row_mask [1|E, Np]`` does that here: the result is the
    unmasked one times the mask, and the kernel skips row tiles the mask
    clears.  Returns ``F [3, E*Np]``.

    CUDA tensors (float32, contiguous, Np and ncols multiples of 128)
    launch ``csrc/yukawa_forces.cu`` over the grid of :func:`pair_split`
    and add one to ``yukawa_forces_soa_cols_batched.launches``; CPU
    tensors run :func:`yukawa_forces_soa_cols_batched_reference`."""
    npad, ncols, _ = _cols_operands(Rp, cols, col_mask, e, "kernel E")
    if row_mask is not None:
        _row_mask_operand(row_mask, Rp, e, npad, "kernel E row_mask")
    if Rp.device.type == "cpu":
        return yukawa_forces_soa_cols_batched_reference(
            Rp, cols, col_mask, e, L, ldeb, row_mask=row_mask)
    _cuda_operands("kernel E", Rp, cols, col_mask,
                   *(() if row_mask is None else (row_mask,)))
    soa_force_tile(npad)
    soa_force_tile(ncols)
    split = pair_split(npad, ncols, e)
    F = torch.empty_like(Rp)
    part = _row_scratch(split, npad, 3, Rp.device)
    lib = _lib()
    with _build.device_guard(Rp.device):
        err = lib.yukawa_forces_cols_launch(
            Rp.data_ptr(), _ptr(row_mask),
            npad if row_mask is not None and row_mask.shape[0] > 1 else 0,
            cols.data_ptr(), col_mask.data_ptr(),
            ncols if col_mask.dim() == 2 else 0, F.data_ptr(), _ptr(part),
            npad, ncols, e, split.chunk, float(L), float(1.0 / L),
            float((L / 2.0) ** 2), float(1.0 / ldeb),
            _build.raw_stream(Rp.device))
    _build.check(lib, err, "yukawa_forces_cols_launch")
    _build.count_launch(yukawa_forces_soa_cols_batched)
    return F


yukawa_forces_soa_cols_batched.launches = 0


def yukawa_forces_cross_n3l_soa_batched_reference(
        Rp: torch.Tensor, mask_row: torch.Tensor, cols: torch.Tensor,
        col_mask: torch.Tensor, e: int, L: float, ldeb: float,
        chunk: int = 256):
    """Plain torch twin of kernel F: each (row, col) pair of member k's
    row block and ``cols[k]`` once, valid where both masks are set; row
    sums and the negated column sums."""
    npad, npc, cm = _cols_operands(Rp, cols, col_mask, e, "cross reference")
    rm = mask_row.expand(e, npad)
    F = torch.empty_like(Rp)
    G = torch.zeros((e, npc, 3), dtype=Rp.dtype, device=Rp.device)
    for k in range(e):
        C = cols[k].T
        for s in range(0, npad, chunk):
            lanes = slice(k * npad + s, k * npad + min(s + chunk, npad))
            d, valid = _rows_cols_pairs(Rp[:, lanes], C, L)
            valid = (valid & (cm[k][None, :] > 0)
                     & (rm[k, s:s + chunk][:, None] > 0))
            f = d * _pair_ft(d, valid, 1.0 / ldeb)[None]
            F[:, lanes] = torch.sum(f, dim=2)
            G[k] -= torch.sum(f, dim=1).T
    return F, G


def yukawa_forces_cross_n3l_soa_batched(Rp: torch.Tensor,
                                        mask_row: torch.Tensor,
                                        cols: torch.Tensor,
                                        col_mask: torch.Tensor, e: int,
                                        L: float, ldeb: float):
    """Kernel F: half-pair forces between a folded row block and a
    different column block of the same members (the ring-N3L schedule's
    visiting shard): ``Rp [3, E*Np]`` rows, ``mask_row [1|E, Np]``,
    ``cols [E, npc, 3]`` and ``col_mask [npc]|[E, npc]``.  Each (row, col)
    pair is evaluated ONCE; returns ``(F [3, E*Np], G [E, npc, 3])``, G
    the Newton's-third-law reaction on the column ions (negated column
    sums, to ride back to their owner shard).  Masked lanes on either side
    contribute nothing.

    CUDA tensors (float32, contiguous, Np and npc multiples of 128) launch
    the reaction form of ``csrc/yukawa_forces.cu`` over the grid of
    :func:`pair_split` and its fixed-order second pass over the per-chunk
    row partials and the per-row-tile reaction partials (no atomics:
    bitwise deterministic) and add one to
    ``yukawa_forces_cross_n3l_soa_batched.launches``; CPU tensors run
    :func:`yukawa_forces_cross_n3l_soa_batched_reference`."""
    npad, npc, _ = _cols_operands(Rp, cols, col_mask, e, "kernel F")
    _row_mask_operand(mask_row, Rp, e, npad, "kernel F mask_row")
    if Rp.device.type == "cpu":
        return yukawa_forces_cross_n3l_soa_batched_reference(
            Rp, mask_row, cols, col_mask, e, L, ldeb)
    _cuda_operands("kernel F", Rp, mask_row, cols, col_mask)
    soa_force_tile(npad)
    soa_force_tile(npc)
    split = pair_split(npad, npc, e)
    F = torch.empty_like(Rp)
    G = torch.empty((e, npc, 3), dtype=torch.float32, device=Rp.device)
    part_f = _row_scratch(split, npad, 3, Rp.device)
    part_g = torch.empty((reaction_scratch_floats(split, npc),),
                         dtype=torch.float32, device=Rp.device)
    lib = _lib()
    with _build.device_guard(Rp.device):
        err = lib.yukawa_cross_launch(
            Rp.data_ptr(), mask_row.data_ptr(),
            npad if mask_row.shape[0] > 1 else 0, cols.data_ptr(),
            col_mask.data_ptr(), npc if col_mask.dim() == 2 else 0,
            F.data_ptr(), G.data_ptr(), _ptr(part_f), part_g.data_ptr(),
            npad, npc, e, split.chunk, float(L), float(1.0 / L),
            float((L / 2.0) ** 2), float(1.0 / ldeb),
            _build.raw_stream(Rp.device))
    _build.check(lib, err, "yukawa_cross_launch")
    _build.count_launch(yukawa_forces_cross_n3l_soa_batched)
    return F, G


yukawa_forces_cross_n3l_soa_batched.launches = 0


def _pack_lanes(R: torch.Tensor, mask: Optional[torch.Tensor], tile: int):
    """``[E, n, 3]`` positions and an optional ``[n]``/``[E, n]`` mask ->
    the kernels' lane layout: ``Rp [3, E*Np]`` (member blocks contiguous)
    and mask rows ``[1, Np]`` (shared) or ``[E, Np]``, Np = n padded to a
    multiple of ``tile`` (the JAX package's ``pack_soa`` padding)."""
    e, n, _ = R.shape
    npad = _round_up(max(n, tile), tile)
    Rp = torch.zeros((3, e, npad), dtype=R.dtype, device=R.device)
    Rp[:, :, :n] = R.permute(2, 0, 1)
    m = (torch.ones((1, n), dtype=R.dtype, device=R.device) if mask is None
         else mask.reshape(-1, n).to(R.dtype))
    rows = torch.zeros((m.shape[0], npad), dtype=R.dtype, device=R.device)
    rows[:, :n] = m
    return Rp.reshape(3, e * npad), rows, npad


def _forces_potential_lanes(R: torch.Tensor, L: float, ldeb,
                            mask: Optional[torch.Tensor], tile: int,
                            with_pot: bool):
    """One launch of the potential form of ``csrc/yukawa_forces.cu`` for
    ``R [E, n, 3]`` on the card: ``(F [E, n, 3], pot [E, n] | None)``.
    ``ldeb`` is a float or a per-member ``[E]`` tensor (:func:`_inv_ldeb`)."""
    if R.dtype != torch.float32:
        raise ValueError(f"the CUDA force kernel is float32, got {R.dtype}")
    if mask is not None and (mask.device != R.device
                             or mask.shape[-1] != R.shape[1]):
        raise ValueError("mask must lie on R's device and have one entry "
                         "per ion")
    soa_force_tile(tile)               # a multiple of 128
    e, n, _ = R.shape
    Rp, rows, npad = _pack_lanes(R, mask, tile)
    ldeb, inv = _inv_ldeb(ldeb, R)
    F, pot = _launch_forces(Rp, rows, e, L, ldeb, inv, with_pot)
    F = F.reshape(3, e, npad)[:, :, :n].permute(1, 2, 0)
    return F, None if pot is None else pot.reshape(e, npad)[:, :n]


def _check_device(R: torch.Tensor) -> None:
    if R.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no force kernel for device {R.device}")


def _inv_ldeb(ldeb, R: torch.Tensor):
    """A float ``ldeb`` -> ``(ldeb, None)``; a per-member ``[E]`` tensor of
    screening lengths (kappa sweeps) -> ``(1.0, inv_ldeb [E])`` in R's
    dtype on R's device, the kernel's per-member 1/lambda."""
    if not isinstance(ldeb, torch.Tensor):
        return ldeb, None
    e = R.shape[0]
    if tuple(ldeb.shape) != (e,):
        raise ValueError(f"want ldeb a float or [{e}], got "
                         f"{tuple(ldeb.shape)}")
    return 1.0, (1.0 / ldeb).to(dtype=R.dtype, device=R.device).contiguous()


def _member_ldeb(ldeb, j: int):
    """Member j's screening length as a float (the CPU twins' member-by-
    member path)."""
    return float(ldeb[j]) if isinstance(ldeb, torch.Tensor) else ldeb


def yukawa_forces_potential_pallas(R: torch.Tensor, L: float, ldeb: float,
                                   mask: Optional[torch.Tensor] = None,
                                   tile: int = 512, with_pot: bool = True):
    """Forces and (``with_pot``) the per-ion potential sums of ``R [N,
    3]``: ``(F [N, 3], pot [N] | None)``, the JAX package's entry of kernel
    D.  ``mask [N]`` marks real ions; masked rows come out exactly 0.

    A CUDA tensor (float32) launches the potential form of
    ``csrc/yukawa_forces.cu`` (lanes padded to a multiple of ``tile``, a
    multiple of 128) and adds one to
    ``yukawa_forces_potential_pallas.launches``; a CPU tensor runs
    :func:`yukawa_forces_potential`, the twin."""
    _check_device(R)
    if R.device.type == "cpu":
        F, pot = yukawa_forces_potential(R, L, ldeb, mask)
        return F, pot if with_pot else None
    F, pot = _forces_potential_lanes(R[None], L, ldeb, mask, tile, with_pot)
    _build.count_launch(yukawa_forces_potential_pallas)
    return F[0], None if pot is None else pot[0]


yukawa_forces_potential_pallas.launches = 0


def yukawa_forces_pallas(R, L, ldeb, mask=None, tile: int = 512):
    return yukawa_forces_potential_pallas(R, L, ldeb, mask, tile,
                                          with_pot=False)[0]


def yukawa_potential_pallas(R, L, ldeb, mask=None, tile: int = 512):
    """Potential energy per particle (0-d tensor on R's device, no host
    sync) through kernel D: ``0.5 * sum(pot) / n_eff``."""
    _, pot = yukawa_forces_potential_pallas(R, L, ldeb, mask, tile)
    n_eff = torch.sum(mask) if mask is not None else R.shape[0]
    return 0.5 * ion_sum(pot) / n_eff


def yukawa_forces_potential_pallas_batched(
        R: torch.Tensor, L: float, ldeb, tile: int = 512,
        mask: Optional[torch.Tensor] = None):
    """``R [E, N, 3]`` ensemble positions -> ``(F [E, N, 3], pot [E,
    N])``, the JAX package's entry of kernel G.  ``mask`` (``[N]`` shared,
    or ``[E, N]`` per member: Poissonian counts) marks real ions; masked
    rows come out exactly 0.  ``ldeb`` is a float, or a per-member ``[E]``
    tensor of screening lengths (kappa sweeps): the kernel reads each
    member's 1/ldeb, the twin takes each member's ldeb as a float.

    A CUDA tensor (float32) launches the potential form of
    ``csrc/yukawa_forces.cu`` once over the grid of :func:`pair_split`,
    the masks read with kernel C's member stride, and adds one to
    ``yukawa_forces_potential_pallas_batched.launches``; a CPU tensor runs
    :func:`yukawa_forces_potential` member by member."""
    _check_device(R)
    e, n, _ = R.shape
    if mask is not None and tuple(mask.shape) not in ((n,), (e, n)):
        raise ValueError(f"want mask [{n}] or [{e}, {n}], got "
                         f"{tuple(mask.shape)}")
    if isinstance(ldeb, torch.Tensor) and tuple(ldeb.shape) != (e,):
        raise ValueError(f"want ldeb a float or [{e}], got "
                         f"{tuple(ldeb.shape)}")
    if R.device.type == "cpu":
        per = [yukawa_forces_potential(R[j], L, _member_ldeb(ldeb, j),
                                       _member_mask(mask, j))
               for j in range(e)]
        return (torch.stack([f for f, _ in per]),
                torch.stack([u for _, u in per]))
    F, pot = _forces_potential_lanes(R, L, ldeb, mask, tile, True)
    _build.count_launch(yukawa_forces_potential_pallas_batched)
    return F, pot


yukawa_forces_potential_pallas_batched.launches = 0


def _member_mask(mask, j):
    return None if mask is None else mask[j] if mask.dim() == 2 else mask


def yukawa_potential_pallas_batched(R, L, ldeb, mask=None, tile: int = 512):
    """Each member's potential energy per particle, ``[E]`` on R's device
    (no host sync), from one launch of kernel G on the card; on the CPU
    :func:`yukawa_potential` member by member (the same values the
    unbatched path gives)."""
    if R.device.type == "cpu":
        return torch.stack([yukawa_potential(R[j], L, ldeb,
                                             _member_mask(mask, j))
                            for j in range(R.shape[0])])
    _, pot = yukawa_forces_potential_pallas_batched(R, L, ldeb, tile, mask)
    if mask is None:
        return 0.5 * ion_sum(pot, dim=1) / R.shape[1]
    m = mask.to(pot.dtype).expand(pot.shape)
    return 0.5 * ion_sum(pot, dim=1) / torch.sum(m, dim=1)


def yukawa_forces_n3l_pallas(R: torch.Tensor, L: float, ldeb: float,
                             mask: Optional[torch.Tensor] = None,
                             tile: int = 512) -> torch.Tensor:
    """Force-only ``R [N, 3] -> F [N, 3]`` through
    :func:`yukawa_forces_n3l_soa` (kernel A on the card, its twin on the
    CPU), the JAX package's entry of the half-pair kernel."""
    _check_device(R)
    n = R.shape[0]
    Rp, rows, _ = _pack_lanes(R[None], mask, tile)
    return yukawa_forces_n3l_soa(Rp, rows, L, ldeb)[:, :n].T


def yukawa_forces_n3l_pallas_batched(R: torch.Tensor, L: float, ldeb,
                                     tile: int = 512,
                                     mask: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """Force-only ``R [E, N, 3] -> F [E, N, 3]``: one launch of
    :func:`yukawa_forces_n3l_soa_batched` (kernel C on the card, its twin
    on the CPU) over the members' lanes, the JAX package's ensemble entry
    of the half-pair kernel (which it reaches by lifting the ``[N, 3]``
    entry over the member axis).  ``mask`` (``[N]`` shared, or ``[E, N]``
    per member: Poissonian counts) marks real ions; masked ions neither
    feel nor exert a force, and their rows come out exactly 0.  ``ldeb``
    is a float, or a per-member ``[E]`` tensor of screening lengths (kappa
    sweeps): the kernel then reads each member's own 1/ldeb."""
    _check_device(R)
    e, n, _ = R.shape
    if mask is not None and (tuple(mask.shape) not in ((n,), (e, n))
                             or mask.device != R.device):
        raise ValueError(f"want mask [{n}] or [{e}, {n}] on R's device, got "
                         f"{tuple(mask.shape)} on {mask.device}")
    Rp, rows, npad = _pack_lanes(R, mask, tile)
    ldeb, inv = _inv_ldeb(ldeb, R)
    F = yukawa_forces_n3l_soa_batched(Rp, rows, e, L, ldeb, inv)
    return F.reshape(3, e, npad)[:, :, :n].permute(1, 2, 0)


def best_forces_fn(n: int, L: float, ldeb: float, mask=None,
                   use_pallas: Optional[bool] = None,
                   tile: Optional[int] = None, n3l: bool = True):
    """An ``R -> (F, pot_per_ion | None)`` callable, as the JAX package's.
    R's device alone picks kernel or twin: a CUDA tensor launches a
    kernel, a CPU tensor runs its twin.  ``use_pallas`` picks the form of
    the result, as the JAX package's picks its entry: forces only (pot
    None) from the half-pair kernel A (``n3l``) or kernel D without its
    potential (``n3l=False``); or, with ``use_pallas=False`` (the JAX
    package's XLA entry), forces and the per-ion potential from kernel D.
    The default is forces only on CUDA and the potential-carrying form on
    the CPU, as the JAX package's default differs between the TPU and the
    CPU.  ``n`` is the ion count the JAX package sizes its tile from; here
    the tile defaults to 512 whatever ``n``."""
    tile = 512 if tile is None else tile

    def forces(R):
        with_pot = (R.device.type != "cuda" if use_pallas is None
                    else not use_pallas)
        if with_pot:
            return yukawa_forces_potential_pallas(R, L, ldeb, mask, tile)
        if n3l:
            return yukawa_forces_n3l_pallas(R, L, ldeb, mask, tile), None
        return yukawa_forces_potential_pallas(R, L, ldeb, mask, tile,
                                              with_pot=False)
    return forces


def best_forces_fn_batched(n: int, L: float, ldeb, mask=None,
                           use_pallas: Optional[bool] = None,
                           tile: Optional[int] = None):
    """:func:`best_forces_fn` for a fold: an ``R [E, N, 3] -> (F [E, N,
    3], pot [E, N] | None)`` callable that serves all members with one
    launch, as the JAX package gets by lifting its ``[N, 3]`` chooser over
    the member axis.  ``mask`` is ``[N]`` or per member ``[E, N]``;
    ``ldeb`` a float or per member ``[E]`` (kappa sweeps; a float64
    tensor keeps each member's ldeb exactly as its own ``[N, 3]`` call
    takes it).
    Forces only come from kernel C, forces with the per-ion potential from
    kernel G; the choice between the two forms and between kernel and twin
    is :func:`best_forces_fn`'s, so on a CPU tensor every member gets
    exactly what its own ``[N, 3]`` call gives."""
    tile = 512 if tile is None else tile

    def forces(R):
        with_pot = (R.device.type != "cuda" if use_pallas is None
                    else not use_pallas)
        if with_pot:
            return yukawa_forces_potential_pallas_batched(R, L, ldeb, tile,
                                                          mask)
        return yukawa_forces_n3l_pallas_batched(R, L, ldeb, tile, mask), None
    return forces
