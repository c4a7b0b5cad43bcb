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
  :func:`yukawa_forces_n3l_soa_batched_reference` on the CPU.
* ``yukawa_forces_potential_pallas`` (and ``yukawa_forces_pallas``,
  ``yukawa_potential_pallas``) / ``yukawa_forces_potential_pallas_batched``
  (``yukawa_potential_pallas_batched``): the JAX package's entries of its
  full-tile kernels D and G, forces **and** the per-ion potential, in the
  ``[N, 3]`` / ``[E, N, 3]`` layout.  On a CUDA tensor they launch the
  potential form of the same kernel; on a CPU tensor they run
  :func:`yukawa_forces_potential`, their twin.  The sample-time potential
  goes through them.
* ``best_forces_fn``: the JAX package's ``R -> (F, pot | None)`` chooser
  over those entries (so a CUDA tensor always reaches a kernel).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build


def yukawa_forces_potential(R: torch.Tensor, L: float, ldeb: float,
                            mask: Optional[torch.Tensor] = None,
                            chunk: int = 512
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forces [N,3] and per-ion potential sums [N].

    ``sum(pot)/(2*N)`` equals the reference's Epot per particle.  ``mask``
    marks real ions: it gates the source set and the rows."""
    n = R.shape[0]
    rcut2 = (L / 2.0) ** 2
    F = torch.empty_like(R)
    pot = torch.empty(n, dtype=R.dtype, device=R.device)
    for s in range(0, n, chunk):
        Ri = R[s:s + chunk]
        d = Ri[:, None, :] - R[None, :, :]             # [c, N, 3]
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
    if mask is not None:
        F = F * mask[:, None]
        pot = pot * mask
    return F, pot


def yukawa_forces(R, L, ldeb, mask=None, chunk: int = 512) -> torch.Tensor:
    return yukawa_forces_potential(R, L, ldeb, mask, chunk)[0]


def yukawa_potential(R, L, ldeb, mask=None, chunk: int = 512):
    """Potential energy per particle (0-d tensor), reference Epotential()."""
    _, pot = yukawa_forces_potential(R, L, ldeb, mask, chunk)
    if mask is None:
        return 0.5 * torch.sum(pot) / R.shape[0]
    return 0.5 * torch.sum(pot * mask) / torch.sum(mask)


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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("yukawa_forces")
    p, f = ctypes.c_void_p, ctypes.c_float
    lib.yukawa_forces_launch.argtypes = [p, p, p, ctypes.c_int, f, f, f, f, p]
    lib.yukawa_forces_launch.restype = ctypes.c_int
    i = ctypes.c_int
    lib.yukawa_forces_batched_launch.argtypes = [p, p, i, p, p, i, i, f, f,
                                                 f, f, p]
    lib.yukawa_forces_batched_launch.restype = ctypes.c_int
    lib.yukawa_forces_pot_launch.argtypes = [p, p, i, p, p, p, i, i, f, f, f,
                                             f, p]
    lib.yukawa_forces_pot_launch.restype = ctypes.c_int
    return lib


def yukawa_forces_n3l_soa(Rp: torch.Tensor, mask_row: torch.Tensor,
                          L: float, ldeb: float) -> torch.Tensor:
    """Forces straight from the lane layout: ``Rp [3, Np]`` (padded, as the
    SoA MD loop carries it) and ``mask_row [1, Np]`` marking real ions.
    Returns ``F [3, Np]``; padded lanes are exactly 0.

    CUDA tensors (float32, contiguous, Np a multiple of 128) launch
    ``csrc/yukawa_forces.cu`` and add one to ``yukawa_forces_n3l_soa.
    launches``; CPU tensors run the plain twin."""
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
    F = torch.empty((3, npad), dtype=torch.float32, device=Rp.device)
    lib = _lib()
    with torch.cuda.device(Rp.device):
        err = lib.yukawa_forces_launch(
            Rp.data_ptr(), mask_row.data_ptr(), F.data_ptr(), npad,
            float(L), float(1.0 / L), float((L / 2.0) ** 2),
            float(1.0 / ldeb), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "yukawa_forces_launch")
    yukawa_forces_n3l_soa.launches += 1
    return F


yukawa_forces_n3l_soa.launches = 0


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
    ``csrc/yukawa_forces.cu`` over an (Np/64, E) grid and add one to
    ``yukawa_forces_n3l_soa_batched.launches``; CPU tensors run the plain
    twin."""
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
    F = torch.empty_like(Rp)
    lib = _lib()
    with torch.cuda.device(Rp.device):
        err = lib.yukawa_forces_batched_launch(
            Rp.data_ptr(), mask_row.data_ptr(),
            npad if mask_row.shape[0] > 1 else 0,
            None if inv_ldeb is None else inv_ldeb.data_ptr(),
            F.data_ptr(), npad, e, float(L), float(1.0 / L),
            float((L / 2.0) ** 2), float(1.0 / ldeb),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "yukawa_forces_batched_launch")
    yukawa_forces_n3l_soa_batched.launches += 1
    return F


yukawa_forces_n3l_soa_batched.launches = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


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


def _forces_potential_lanes(R: torch.Tensor, L: float, ldeb: float,
                            mask: Optional[torch.Tensor], tile: int,
                            with_pot: bool):
    """One launch of the potential form of ``csrc/yukawa_forces.cu`` for
    ``R [E, n, 3]`` on the card: ``(F [E, n, 3], pot [E, n] | None)``."""
    if R.dtype != torch.float32:
        raise ValueError(f"the CUDA force kernel is float32, got {R.dtype}")
    if mask is not None and (mask.device != R.device
                             or mask.shape[-1] != R.shape[1]):
        raise ValueError("mask must lie on R's device and have one entry "
                         "per ion")
    soa_force_tile(tile)               # a multiple of 128
    e, n, _ = R.shape
    Rp, rows, npad = _pack_lanes(R, mask, tile)
    F = torch.empty_like(Rp)
    pot = (torch.empty((e * npad,), dtype=torch.float32, device=R.device)
           if with_pot else None)
    lib = _lib()
    with torch.cuda.device(R.device):
        err = lib.yukawa_forces_pot_launch(
            Rp.data_ptr(), rows.data_ptr(), npad if rows.shape[0] > 1 else 0,
            None, F.data_ptr(), None if pot is None else pot.data_ptr(), npad,
            e, float(L), float(1.0 / L), float((L / 2.0) ** 2),
            float(1.0 / ldeb), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "yukawa_forces_pot_launch")
    F = F.reshape(3, e, npad)[:, :, :n].permute(1, 2, 0)
    return F, None if pot is None else pot.reshape(e, npad)[:, :n]


def _check_device(R: torch.Tensor) -> None:
    if R.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no force kernel for device {R.device}")


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
    yukawa_forces_potential_pallas.launches += 1
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
    return 0.5 * torch.sum(pot) / n_eff


def yukawa_forces_potential_pallas_batched(
        R: torch.Tensor, L: float, ldeb: float, tile: int = 512,
        mask: Optional[torch.Tensor] = None):
    """``R [E, N, 3]`` ensemble positions -> ``(F [E, N, 3], pot [E,
    N])``, the JAX package's entry of kernel G.  ``mask`` (``[N]`` shared,
    or ``[E, N]`` per member: Poissonian counts) marks real ions; masked
    rows come out exactly 0.

    A CUDA tensor (float32) launches the potential form of
    ``csrc/yukawa_forces.cu`` once over an (Np/64, E) grid, the masks read
    with kernel C's member stride, and adds one to
    ``yukawa_forces_potential_pallas_batched.launches``; a CPU tensor runs
    :func:`yukawa_forces_potential` member by member."""
    _check_device(R)
    e, n, _ = R.shape
    if mask is not None and tuple(mask.shape) not in ((n,), (e, n)):
        raise ValueError(f"want mask [{n}] or [{e}, {n}], got "
                         f"{tuple(mask.shape)}")
    if R.device.type == "cpu":
        per = [yukawa_forces_potential(R[j], L, ldeb, _member_mask(mask, j))
               for j in range(e)]
        return (torch.stack([f for f, _ in per]),
                torch.stack([u for _, u in per]))
    F, pot = _forces_potential_lanes(R, L, ldeb, mask, tile, True)
    yukawa_forces_potential_pallas_batched.launches += 1
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
        return 0.5 * torch.sum(pot, dim=1) / R.shape[1]
    m = mask.to(pot.dtype).expand(pot.shape)
    return 0.5 * torch.sum(pot, dim=1) / torch.sum(m, dim=1)


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
