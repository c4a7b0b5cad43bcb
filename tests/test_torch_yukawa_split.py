"""What Python decides for the pair kernel of csrc/yukawa_forces.cu (CPU):
the column chunking of a launch (``pair_split``), the scratch sizes the
launcher indexes, and the row-mask keyword of kernel E's entry.

The kernel itself runs only on the card (tests/test_torch_cuda.py); here
the launch geometry is replayed in Python as the kernel walks it: grid
(row tiles, column chunks, members), a block's WARPS warps taking 32-column
tiles ``chunk_start + 32 * warp + COL_TILE * s`` of their chunk.
"""

import ast
import inspect

import numpy as np
import pytest
import torch

from mdqtplasmasims_torch.experiments import laser_cooling as tlc
from mdqtplasmasims_torch.ops import yukawa as ty

torch.set_num_threads(1)

# (npad, ncols, E): the flagship member alone and in 8- and 16-member
# folds, a mesh slot's gather launch with one and two members, its ring
# launches (kernels C and F), and two small shapes
SHAPES = [(3584, 3584, 1), (3584, 3584, 8), (3584, 3584, 16),
          (1792, 7168, 1), (1792, 7168, 2), (1792, 1792, 1), (128, 128, 1),
          (128, 512, 3)]
FLAGSHIP_AND_MESH = SHAPES[0], SHAPES[3], SHAPES[5]
# CUDA's limits on gridDim.x and on gridDim.y / gridDim.z
GRID_X_MAX, GRID_YZ_MAX = 2 ** 31 - 1, 65535
SCHEDULERS = 132 * 4


def _tiles_swept(split, ncols):
    """First column of every 32-column tile a launch sweeps, block by block
    and warp by warp, as the kernel's loop bounds give them."""
    starts = []
    for c in range(split.grid[1]):
        begin, end = c * split.chunk, min((c + 1) * split.chunk, ncols)
        for warp in range(ty.WARPS):
            starts += range(begin + 32 * warp, end, ty.COL_TILE)
    return starts


@pytest.mark.parametrize("npad,ncols,e", SHAPES)
def test_split_covers_every_column_once(npad, ncols, e):
    split = ty.pair_split(npad, ncols, e)
    seen = np.zeros(ncols, dtype=int)
    for j0 in _tiles_swept(split, ncols):
        seen[j0:j0 + 32] += 1
    assert (seen == 1).all()
    assert split.grid[0] * ty.ROW_TILE == npad and split.grid[2] == e


@pytest.mark.parametrize("npad,ncols,e", SHAPES)
def test_split_chunks_are_multiples_of_the_tile(npad, ncols, e):
    split = ty.pair_split(npad, ncols, e)
    assert split.chunk > 0 and split.chunk % ty.COL_TILE == 0
    last = ncols - (split.grid[1] - 1) * split.chunk
    assert 0 < last <= split.chunk and last % ty.COL_TILE == 0
    assert ty.COL_TILE == 32 * ty.WARPS      # one 32-column tile per warp


@pytest.mark.parametrize("npad,ncols,e", SHAPES)
def test_split_stays_inside_the_grid_limits(npad, ncols, e):
    tiles, chunks, members = ty.pair_split(npad, ncols, e).grid
    assert 1 <= tiles <= GRID_X_MAX
    assert 1 <= chunks <= GRID_YZ_MAX and 1 <= members <= GRID_YZ_MAX


@pytest.mark.parametrize("nv", [3, 4])
@pytest.mark.parametrize("npad,ncols,e", SHAPES)
def test_scratch_holds_what_the_launcher_indexes(npad, ncols, e, nv):
    """The largest offsets the kernel writes: a block's row partial at
    ``(chunk * nv + c) * E*npad + lane`` when there are several chunks,
    and kernel F's reaction partial at ``((member * tiles + tile) * ncols
    + j) * 3 + c``."""
    split = ty.pair_split(npad, ncols, e)
    tiles, chunks, _ = split.grid
    lanes = e * npad
    want_rows = 0 if chunks == 1 else ((chunks - 1) * nv + nv - 1) * lanes \
        + lanes
    assert ty.row_scratch_floats(split, npad, nv) == want_rows
    want_react = (((e - 1) * tiles + tiles - 1) * ncols + ncols - 1) * 3 + 3
    assert ty.reaction_scratch_floats(split, ncols) == want_react


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that a wrapper takes
    its CUDA branch as far as ``pair_split``."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Split(Exception):
    """Raised in place of ``pair_split``: carries its three integers."""


def _split_args(monkeypatch, entry, *operands):
    """The integers ``entry`` hands ``pair_split`` for ``operands``."""
    def record(npad, ncols, e):
        raise _Split(npad, ncols, e)
    monkeypatch.setattr(ty, "pair_split", record)
    with pytest.raises(_Split) as seen:
        entry(*(torch.Tensor._make_subclass(_OnCard, x)
                if isinstance(x, torch.Tensor) else x for x in operands))
    return seen.value.args


@pytest.mark.parametrize("npad,ncols,e", SHAPES)
def test_split_depends_on_the_launch_shape_only(monkeypatch, npad, ncols, e):
    """One shape, one chunking, whatever the masks: it is what keeps kernel
    E on a member's own lanes bitwise equal to kernel C, and an E=1 fold
    to kernel A.  ``pair_split`` sees three integers and reads nothing but
    the kernel's geometry constants; the wrappers of A, C and E hand it
    (rows, columns, members) of their operands for a full mask, a mask
    with holes and an empty one."""
    fn = ty.pair_split
    assert list(inspect.signature(fn).parameters) == ["npad", "ncols", "e"]
    assert fn.__closure__ is None and not hasattr(fn, "cache_info")
    assert set(fn.__code__.co_names) <= {
        "ROW_TILE", "COL_TILE", "TARGET_BLOCKS", "_round_up", "PairSplit",
        "ValueError", "min"}
    g = torch.Generator().manual_seed(npad + ncols + e)
    Rp = torch.rand((3, e * npad), generator=g)
    cols = torch.rand((e, ncols, 3), generator=g)
    own = Rp.reshape(3, e, npad).permute(1, 2, 0).contiguous()
    L, ldeb = 5.0, 0.3
    for fill in ("full", "holes", "empty"):
        rm, cm = (dict(full=torch.ones, empty=torch.zeros)[fill](shape)
                  if fill != "holes" else
                  (torch.rand(shape, generator=g) < 0.5).float()
                  for shape in ((e, npad), (e, ncols)))
        # C, and E on the members' own lanes: the same three integers
        c = _split_args(monkeypatch, ty.yukawa_forces_n3l_soa_batched, Rp,
                        rm, e, L, ldeb)
        assert c == (npad, npad, e)
        assert _split_args(monkeypatch, ty.yukawa_forces_soa_cols_batched,
                           Rp, own, rm, e, L, ldeb) == c
        # E on its gathered columns, with and without the row mask
        for kw_mask in (None, rm):
            assert _split_args(
                monkeypatch, lambda *a: ty.yukawa_forces_soa_cols_batched(
                    *a, row_mask=kw_mask if kw_mask is None else
                    torch.Tensor._make_subclass(_OnCard, kw_mask)),
                Rp, cols, cm, e, L, ldeb) == (npad, ncols, e)
        if e == 1:      # A is the E=1 launch of C
            assert _split_args(monkeypatch, ty.yukawa_forces_n3l_soa, Rp,
                               rm, L, ldeb) == c


def _calls(func_name, callee):
    """Argument names of every call of ``callee`` inside the wrapper
    ``func_name`` of ops/yukawa.py."""
    tree = ast.parse(inspect.getsource(getattr(ty, func_name)))
    return [[a.id if isinstance(a, ast.Name) else ast.dump(a)
             for a in node.args]
            for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "id", None) == callee]


@pytest.mark.parametrize("wrapper,want", [
    # A, C, D, G: a member's own lanes are its columns
    ("_launch_forces", ["npad", "npad", "e"]),
    ("yukawa_forces_soa_cols_batched", ["npad", "ncols", "e"]),
    ("yukawa_forces_cross_n3l_soa_batched", ["npad", "npc", "e"])])
def test_wrappers_split_on_their_operands_shapes(wrapper, want):
    """Every launch takes its chunking from (rows, columns, members) of
    its operands, never from a mask or a count of real ions: with ncols ==
    npad kernel E's call is kernel C's."""
    assert _calls(wrapper, "pair_split") == [want]


@pytest.mark.parametrize("entry,e_arg", [
    ("yukawa_forces_n3l_soa", ast.dump(ast.Constant(1))),
    ("yukawa_forces_n3l_soa_batched", "e")])
def test_single_and_batched_entries_share_one_launch(entry, e_arg):
    """Kernel A is the E=1 launch of kernel C's launcher."""
    (args,) = _calls(entry, "_launch_forces")
    assert args[:3] == ["Rp", "mask_row", e_arg]


@pytest.mark.parametrize("npad,ncols,e", SHAPES)
def test_split_is_a_members_own(npad, ncols, e):
    """The chunking does not depend on the fold's width, so a member's row
    sums have one order in a fold of any width: a mesh slot's block of a
    fold and the unsharded fold give a member the same bits."""
    one = ty.pair_split(npad, ncols, 1)
    for width in (e, 2, 8, 99, 65535):
        split = ty.pair_split(npad, ncols, width)
        assert split.chunk == one.chunk
        assert split.grid == one.grid[:2] + (width,)


@pytest.mark.parametrize("npad,ncols,e", FLAGSHIP_AND_MESH)
def test_split_fills_the_schedulers(npad, ncols, e):
    assert ty.pair_split(npad, ncols, e).warps >= SCHEDULERS


@pytest.mark.parametrize("npad,ncols,e", [(100, 128, 1), (128, 100, 1),
                                          (128, 128, 0), (128, 128, 65536),
                                          (0, 128, 1)])
def test_split_rejects_what_the_kernel_cannot_take(npad, ncols, e):
    with pytest.raises(ValueError):
        ty.pair_split(npad, ncols, e)


def _cols_case(e, npad, ncols, seed):
    rng = np.random.default_rng(seed)
    L = 9.0
    Rp = torch.as_tensor(rng.uniform(0, L, (3, e * npad)), dtype=torch.float64)
    cols = torch.as_tensor(rng.uniform(0, L, (e, ncols, 3)),
                           dtype=torch.float64)
    cmask = torch.as_tensor(rng.random((e, ncols)) < 0.7, dtype=torch.float64)
    return Rp, cols, cmask, L


@pytest.mark.parametrize("shared", [True, False])
def test_cols_entry_row_mask_is_the_multiply(shared):
    """``row_mask=`` gives the unmasked forces times the mask, holes and
    all: what the gather schedule's multiply gave."""
    e, npad = 2, 128
    Rp, cols, cmask, L = _cols_case(e, npad, 256, seed=3)
    rng = np.random.default_rng(4)
    rm = torch.as_tensor(rng.random((1 if shared else e, npad)) < 0.6,
                         dtype=torch.float64)
    F = ty.yukawa_forces_soa_cols_batched(Rp, cols, cmask, e, L, 0.8)
    Fm = ty.yukawa_forces_soa_cols_batched(Rp, cols, cmask, e, L, 0.8,
                                           row_mask=rm)
    want = F * rm.expand(e, npad).reshape(1, e * npad)
    assert torch.equal(Fm, want)
    assert float(Fm[:, want[0] == 0].abs().max()) == 0.0


def test_cols_entry_checks_its_row_mask():
    Rp, cols, cmask, L = _cols_case(2, 128, 128, seed=5)
    with pytest.raises(ValueError, match="row_mask"):
        ty.yukawa_forces_soa_cols_batched(
            Rp, cols, cmask, 2, L, 0.8,
            row_mask=torch.ones((3, 128), dtype=torch.float64))
    with pytest.raises(ValueError, match="dtype"):
        ty.yukawa_forces_soa_cols_batched(
            Rp, cols, cmask, 2, L, 0.8,
            row_mask=torch.ones((1, 128), dtype=torch.float32))


@pytest.mark.parametrize("entry", ["run", "run_ensemble", "run_sweep",
                                   "resume_state"])
def test_public_entries_run_on_the_card_unless_asked(entry):
    sig = inspect.signature(getattr(tlc, entry))
    assert sig.parameters["device"].default == "cuda"
