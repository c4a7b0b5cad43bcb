"""The half-pair form of kernels A and C (csrc/yukawa_forces.cu) as the
host decides it and as the kernel walks it, on the CPU.

From ``HALF_MIN_NPAD`` lanes a member on, the forces-only launch evaluates
each pair of row tiles (I, J >= I) once: block b takes row tile
``t, k = half_pair_split(npad).blocks[b]`` against the columns ``[t * 64 +
k * chunk, + chunk)``, its 4 warps 32-column tiles of them; a tile past
the row tile's own diagonal tile gives the row sums to the rows and the
negated column sums (the reactions) to ``part_g [E, tiles, 3, npad]``, the
diagonal tile gives row sums only.  The second pass sums, for ion i of row
tile t, the reactions of row tiles 0 .. t-1 and then its row tile's chunks
in order.  ``half_model`` below is that data flow in float64 torch, fed the
twin's pair terms and scratch filled with NaN, so that a wrong index, a
slot read but never written or a pair counted twice fails here, without a
card.
"""

import ast
import inspect

import numpy as np
import pytest
import torch

from mdqtplasmasims_torch.ops import yukawa as ty

torch.set_num_threads(1)

NPADS = [2048, 3584, 4096, 14080]
SCHEDULERS = 132 * 4
GRID_X_MAX = 2 ** 31 - 1


def _warp_tiles(split, npad):
    """(member-local rows, first column, reaction?) of every 32-column
    tile the half form sweeps, block by block and warp by warp, as the
    kernel's loop bounds give them."""
    out = []
    for t, k in split.blocks:
        diag = (t + 1) * ty.ROW_TILE
        begin = diag - ty.ROW_TILE + k * split.chunk
        end = min(begin + split.chunk, npad)
        for warp in range(ty.WARPS):
            for j0 in range(begin + 32 * warp, end, ty.COL_TILE):
                out.append((t, j0, j0 >= diag))
    return out


@pytest.mark.parametrize("npad", NPADS)
def test_every_pair_is_swept_once(npad):
    """Every ordered pair of lanes (i, j) gets its term exactly once, as
    i's row sum or as the reaction on i from a block of j's row tile; a
    pair of two row tiles is evaluated once (one sweep gives both terms),
    a pair inside one row tile twice, once from each row (the diagonal
    tile swept whole, its reaction left out).  Counted on blocks of 32 x
    32 lanes, which the kernel treats alike lane by lane."""
    split = ty.half_pair_split(npad)
    nb = npad // 32
    terms = np.zeros((nb, nb), dtype=np.int64)
    sweeps = np.zeros((nb, nb), dtype=np.int64)
    for t, j0, react in _warp_tiles(split, npad):
        c = j0 // 32
        assert react == (c // 2 > t)       # no reaction on the diagonal
        for r in (2 * t, 2 * t + 1):        # the threads' rows l and l + 32
            terms[r, c] += 1
            sweeps[min(r, c), max(r, c)] += 1
            if react:
                terms[c, r] += 1
    assert (terms == 1).all()
    tile = np.arange(nb) // 2
    inside = tile[:, None] == tile[None, :]
    upper = np.triu(np.ones((nb, nb), dtype=bool))
    # inside a diagonal tile the blocks (r, c) and (c, r) are both swept,
    # each pair from both of its rows; elsewhere one sweep serves both
    want = np.where(inside, np.where(np.eye(nb, dtype=bool), 1, 2), 1)
    assert (sweeps[upper] == want[upper]).all()
    assert (sweeps[~upper] == 0).all()


@pytest.mark.parametrize("npad", NPADS)
def test_blocks_follow_the_jax_triangle(npad):
    """The blocks walk the JAX package's ``_n3l_pairs`` triangle (i-major,
    J ascending) in chunks of ``chunk / 64`` tiles: row tile t has
    ``ceil((tiles - t) / per)`` of them, the first at its diagonal."""
    split = ty.half_pair_split(npad)
    tiles, per = npad // ty.ROW_TILE, split.chunk // ty.ROW_TILE
    want = [(t, k) for t in range(tiles)
            for k in range(-(-(tiles - t) // per))]
    assert list(split.blocks) == want
    assert split.chunk % ty.COL_TILE == 0 and per % 2 == 0
    assert split.chunks == -(-tiles // per)
    pairs = [(t, t + per * k + s) for t, k in split.blocks
             for s in range(per) if t + per * k + s < tiles]
    assert pairs == [(i, j) for i in range(tiles) for j in range(i, tiles)]


@pytest.mark.parametrize("npad", NPADS)
def test_half_split_reads_npad_only(npad):
    """One decomposition a shape, whatever the masks or the fold's width:
    it is what keeps a member's forces bitwise equal in folds of 1, 8 and
    99 and an E=1 fold bitwise kernel A (in the manner of
    test_torch_yukawa_split.py's ``pair_split`` test).  ``half_pair_split``
    sees one integer and reads nothing but the kernel's geometry; the
    launcher hands it (through ``_half_plan``) the member's lanes and
    nothing else."""
    fn = ty.half_pair_split
    assert list(inspect.signature(fn).parameters) == ["npad"]
    assert fn.__closure__ is None and not hasattr(fn, "cache_info")
    assert set(fn.__code__.co_names) <= {
        "ROW_TILE", "COL_TILE", "TARGET_BLOCKS", "_round_up", "HalfSplit",
        "ValueError", "tuple", "range"}
    assert ty.half_pair_split(npad) == ty.half_pair_split(int(npad))
    tree = ast.parse(inspect.getsource(ty._launch_forces))
    calls = {node.func.id: [ast.unparse(a) for a in node.args]
             for node in ast.walk(tree) if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Name)}
    assert calls["_half_plan"] == ["npad", "Rp.device"]
    assert calls["half_form"] == ["npad", "with_pot"]


@pytest.mark.parametrize("npad", NPADS)
def test_half_split_fills_the_card_and_its_grid(npad):
    """One member's blocks give every warp scheduler work (kernel A at
    E=1) and stay within CUDA's grid; the chunk is the finest that keeps
    one member's grid near TARGET_BLOCKS."""
    split = ty.half_pair_split(npad)
    blocks = len(split.blocks)
    assert ty.WARPS * blocks >= SCHEDULERS and blocks <= GRID_X_MAX
    if split.chunk > ty.COL_TILE:
        finer = split.chunk - ty.COL_TILE
        tiles, per = npad // ty.ROW_TILE, finer // ty.ROW_TILE
        assert sum(-(-(tiles - t) // per)
                   for t in range(tiles)) > ty.TARGET_BLOCKS


@pytest.mark.parametrize("npad", NPADS)
def test_half_scratch_holds_what_the_kernel_indexes(npad):
    """The largest offsets the half form writes and its second pass reads:
    a block's row sums at ``(k * 3 + c) * E*npad + lane``, a reaction at
    ``((e * tiles + t) * 3 + c) * npad + j``."""
    split = ty.half_pair_split(npad)
    tiles = npad // ty.ROW_TILE
    for e in (1, 8, 99):
        rows, react = ty.half_scratch_floats(split, npad, e)
        lanes = e * npad
        assert rows == ((split.chunks - 1) * 3 + 2) * lanes + lanes
        assert react == (((e - 1) * tiles + tiles - 1) * 3 + 2) * npad + npad


@pytest.mark.parametrize("npad", [128, 640, 1792, 1920, 2048, 2176, 3584,
                                  14080])
def test_the_form_engages_from_the_threshold(npad):
    """Forces only at ``HALF_MIN_NPAD`` lanes and more (the frozen pools'
    640 and the ring shard's 1792 keep the full rectangle); the potential
    forms (D, G) never."""
    assert ty.half_form(npad) == (npad >= ty.HALF_MIN_NPAD == 2048)
    assert not ty.half_form(npad, with_pot=True)


def test_the_entries_count_the_half_form():
    """A and C count the launches of the half form apart, on the form the
    launcher takes (``half_form`` of the member's lanes)."""
    for fn in (ty.yukawa_forces_n3l_soa, ty.yukawa_forces_n3l_soa_batched):
        assert fn.half_launches == 0
        src = inspect.getsource(fn)
        assert "if half_form(npad):" in src
        assert f'_build.count_launch({fn.__name__}, "half_launches")' in src


def _reduce_reads(npad, e, E, i, c):
    """What the second pass reads for component c of ion i of member e in
    a fold of E members: ("g", row tile, offset) for each reaction, then
    ("f", chunk, offset) for each row partial, in its order."""
    split = ty.half_pair_split(npad)
    tiles, per = npad // ty.ROW_TILE, split.chunk // ty.ROW_TILE
    lanes, t = E * npad, i // ty.ROW_TILE
    reads = [("g", s, ((e * tiles + s) * 3 + c) * npad + i)
             for s in range(t)]
    reads += [("f", k, (k * 3 + c) * lanes + e * npad + i)
              for k in range(-(-(tiles - t) // per))]
    return reads


@pytest.mark.parametrize("npad", NPADS)
def test_an_ions_order_does_not_depend_on_the_fold(npad):
    """Ion i of a member sums the same terms in the same order (ascending
    partner tile: the reactions of row tiles 0 .. t-1, then its own row
    tile's chunks) in a fold of 1, 8 or 99 members; only the member's
    offset in the scratch moves."""
    rng = np.random.default_rng(npad)
    tiles = npad // ty.ROW_TILE
    per = ty.half_pair_split(npad).chunk // ty.ROW_TILE
    for i in [int(x) for x in rng.integers(0, npad, 12)] + [0, npad - 1]:
        t = i // ty.ROW_TILE
        for c in range(3):
            one = _reduce_reads(npad, 0, 1, i, c)
            assert [r[:2] for r in one] == (
                [("g", s) for s in range(t)]
                + [("f", k) for k in range(-(-(tiles - t) // per))])
            for E in (8, 99):
                e = int(rng.integers(0, E))
                wide = _reduce_reads(npad, e, E, i, c)
                assert [r[:2] for r in wide] == [r[:2] for r in one]
                for (kind, s, at1), (_, _, at) in zip(one, wide):
                    moved = (e * tiles * 3 * npad if kind == "g" else
                             (s * 3 + c) * (E - 1) * npad + e * npad)
                    assert at - at1 == moved


def half_model(Rp, mask_row, e, L, ldeb, inv_ldeb=None):
    """The half form's data flow in Rp's dtype: the blocks of
    ``half_pair_split``, each row tile skipped when its rows are padding
    and each 32-column tile when its columns are, the row sums written to
    ``part_f``'s slab of the block's chunk, the reactions past the
    diagonal tile to ``part_g``, then the second pass's sums.  The
    scratch starts as NaN, as the kernel's ``torch.empty`` holds garbage."""
    npad = Rp.shape[1] // e
    split = ty.half_pair_split(npad)
    tiles, lanes, R = npad // ty.ROW_TILE, e * npad, ty.ROW_TILE
    n_rows, n_react = ty.half_scratch_floats(split, npad, e)
    part_f = torch.full((n_rows,), float("nan"), dtype=Rp.dtype)
    part_g = torch.full((n_react,), float("nan"), dtype=Rp.dtype)
    for m in range(e):
        mk = mask_row[m if mask_row.shape[0] > 1 else 0] > 0
        il = 1.0 / ldeb if inv_ldeb is None else inv_ldeb[m]
        X = Rp[:, m * npad:(m + 1) * npad]
        for t, k in split.blocks:
            diag = (t + 1) * R
            begin = diag - R + k * split.chunk
            end = min(begin + split.chunk, npad)
            rows = slice(t * R, diag)
            g0 = ((m * tiles + t) * 3) * npad
            f0 = k * 3 * lanes + m * npad + t * R
            if not mk[rows].any():
                for c in range(3):
                    part_f[f0 + c * lanes:f0 + c * lanes + R] = 0.0
                    part_g[g0 + c * npad + max(begin, diag):
                           g0 + c * npad + end] = 0.0
                continue
            d, valid = ty._rows_cols_pairs(X[:, rows], X[:, begin:end], L)
            valid = valid & mk[rows, None] & mk[None, begin:end]
            f = d * ty._pair_ft(d, valid, il)[None]        # [3, 64, cols]
            live = torch.stack([mk[j0:j0 + 32].any()
                                for j0 in range(begin, end, 32)])
            f = f * live.repeat_interleave(32)[None, None].to(f.dtype)
            for c in range(3):
                part_f[f0 + c * lanes:f0 + c * lanes + R] = f[c].sum(1)
                lo = max(begin, diag)
                part_g[g0 + c * npad + lo:g0 + c * npad + end] = \
                    -f[c, :, lo - begin:].sum(0)
    # the second pass: ascending partner tile
    q = torch.arange(3 * lanes)
    c, ln = q // lanes, q % lanes
    i = ln % npad
    t = i // R
    n_chunks = -(-(tiles - t) // (split.chunk // R))
    F = torch.zeros(3 * lanes, dtype=Rp.dtype)
    for s in range(tiles):
        at = ((ln // npad * tiles + s) * 3 + c) * npad + i
        F = F + torch.where(s < t, part_g[at.clamp(max=n_react - 1)], 0.0)
    for k in range(split.chunks):
        at = (k * 3 + c) * lanes + ln
        F = F + torch.where(k < n_chunks, part_f[at.clamp(max=n_rows - 1)],
                            0.0)
    return F.reshape(3, lanes)


def _case(e, npad, kind, seed):
    """Positions in ``[3, E*npad]`` (padded lanes hold positions too: the
    kernel must ignore them) and real-ion masks: a shared 3500-of-npad
    prefix, per-member Poissonian-like prefixes, or per-member holes (every
    other lane at random, a whole 64-lane row tile and an unaligned stretch
    cleared); with ``inv_ldeb [E]`` for the kappa sweeps."""
    rng = np.random.default_rng(seed)
    L = 15.0
    Rp = torch.as_tensor(rng.uniform(0, L, (3, e * npad)))
    if kind == "shared":
        m = np.zeros((1, npad))
        m[0, :npad - 84] = 1.0
    elif kind == "prefixes":
        m = np.zeros((e, npad))
        for j in range(e):
            m[j, :npad - 40 - 61 * j] = 1.0
    else:
        m = (rng.random((e, npad)) < 0.5).astype(float)
        m[:, 640:704] = 0.0
        m[:, 1000:1111] = 0.0
        m[:, -200:] = 0.0
    il = (None if kind != "holes" else
          torch.as_tensor(1.0 / 0.9 * (1.0 + 0.3 * np.arange(e))))
    return Rp, torch.as_tensor(m), L, il


@pytest.mark.parametrize("e,npad,kind", [(3, 2048, "shared"),
                                         (2, 2048, "holes"),
                                         (2, 2176, "prefixes"),
                                         (1, 8320, "shared")])
def test_the_scratch_and_its_second_pass_give_the_twins_forces(e, npad,
                                                              kind):
    """``half_model`` in float64 equals the batched twin to 1e-12 of the
    largest |F|, masked lanes exactly 0, no scratch slot read unwritten;
    the last case takes chunks of four row tiles (the second pass's
    ``ceil`` at 8320 lanes)."""
    Rp, mask, L, il = _case(e, npad, kind, seed=npad + e)
    F = half_model(Rp, mask, e, L, 0.9, il)
    ref = ty.yukawa_forces_n3l_soa_batched_reference(Rp, mask, e, L, 0.9, il)
    assert torch.isfinite(F).all()
    assert float((F - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    dead = (mask.expand(e, npad) == 0).reshape(-1)
    assert not F[:, dead].any()
    if npad == 8320:
        assert ty.half_pair_split(npad).chunk == 4 * ty.ROW_TILE
