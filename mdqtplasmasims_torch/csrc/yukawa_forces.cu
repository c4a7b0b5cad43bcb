// Yukawa pair forces (and optionally the per-ion potential) in the lane
// layout, one ion block per ensemble member: F [3, E*Np] (pot [E*Np]) from
// Rp [3, E*Np] and real-ion masks (mdqtplasmasims_torch/ops/yukawa.py
// wraps it).
//
// Replaces six TPU kernels of mdqtplasmasims_tpu/ops/yukawa.py:
//   A  _yukawa_n3l_kernel          (one member; yukawa_forces_launch, E = 1)
//   C  _yukawa_n3l_kernel_batched  (E members; yukawa_forces_launch)
//   D  _yukawa_kernel              (one member, + potential;
//                                   yukawa_forces_launch with pot, E = 1)
//   G  _yukawa_kernel_batched      (E members, + potential;
//                                   yukawa_forces_launch with pot)
//   E  _yukawa_kernel_rows_cols_batched  (rows x a given column set;
//                                   yukawa_forces_cols_launch)
//   F  _yukawa_cross_n3l_kernel_batched  (two different ion blocks, each
//                                   pair once; yukawa_cross_launch)
// A and C were half-pair tiles on a triangle grid with reaction sums
// scatter-added outside; D and G full tiles (both triangles) that also
// sum the potential.  This computes the same force
//     F_i = sum_j (1/r + 1/lambda) exp(-r/lambda) / r^2 * d_ij
// under the minimum image, over pairs with 0 < r^2 < (L/2)^2 whose i and
// j are both real ions of the same member (padded lanes come out exactly
// 0), and with POT the potential pot_i = sum_j exp(-r/lambda) / r over the
// same pairs (the JAX kernel masks the j side and multiplies rows by the
// mask afterwards, :228-231; masking both sides here gives the same
// values, masked rows exactly 0).  D and G are the POT form of this
// kernel: it already summed both triangles per row, so the potential is
// one more accumulator and the expf is shared.  Member e's ions are lanes
// [e*Np, (e+1)*Np) of every row; its mask row is mask[e*mask_stride ...]
// (stride 0: one [1, Np] row shared by all members); its 1/lambda is
// inv_ldeb_e[e] when that array is given (the per-member screening of
// kappa sweeps), else the scalar inv_ldeb.
//
// E (the ion-sharded gather path: a shard's rows against the all-gathered
// columns of its member) is the same kernel with another column operand:
// the columns are read through strides (cols [E, ncols, 3] there, the
// member's own lanes for A/C/D/G).  Its rows carry a mask only when the
// caller hands one over (the JAX entry has none and its caller multiplies
// by the row mask afterwards; a masked row comes out exactly 0 either
// way).  The sweep and the arithmetic are one code path, so E with the
// member's own lanes as its columns gives kernel C's forces on every real
// row bit for bit where C sweeps the rectangle too (below 2048 lanes: HALF
// below).
//
// F (the ring-N3L path: rows of one ion shard against the visiting block
// of another shard of the same member) is the REACT form: each (row,
// column) pair is evaluated ONCE, the row sums as in every form, and the
// column sums of each row tile (the JAX kernel's own g buffer, reduced
// over the row-tile axis) come out NEGATED in G: the reaction on the
// visiting ions.
//
// What bounds these on the H100: instruction slots, not arithmetic peak
// and not bytes.  A pair is some 40-65 instructions (three rintf, an rsqrtf
// and an expf in one dependent chain), the inputs are a few tens of KB,
// and the card starts 132 SMs x 4 schedulers = 528 warp instructions per
// cycle.  The launches are small: one member at the flagship Np=3584 is a
// 3584 x 3584 rectangle (12.8M lane pairs), a mesh slot's E launch 1792 x
// 7168, its F launch 1792 x 1792, and on the mesh only 875 of every 1792
// lanes hold an ion.  So a form is fast when (1) every scheduler holds
// several warps whatever the shape, (2) each warp has several independent
// chains in flight, and (3) tiles of padding cost nothing.
//
// Design, one template for every form (yukawa_pair_kernel<POT, REACT,
// HALF>):
//  - The work of a member is its rows x columns rectangle, cut both ways:
//    grid (row tiles, column chunks, members).  A block of 4 warps owns a
//    ROW_TILE = 64 row tile; each thread carries 2 rows (lane, lane + 32),
//    so one column read serves two independent pair chains.  The block's
//    column chunk is swept in tiles of 32 columns, warp w taking tiles w,
//    w + 4, ...  The chunk length (a multiple of COL_TILE = 128, one tile
//    per warp) is chosen by the Python wrapper from (npad, ncols) alone
//    (ops/yukawa.py: pair_split), never from E, so that a member's row
//    sums are the same in a fold of any width; it aims at 32 warps per
//    scheduler for one member, some three waves of resident blocks, so
//    that the last wave is a small share: 1568 blocks for E (128-column
//    chunks, the finest), 392 for F and for C at a mesh shard's 1792
//    lanes, E times a member's blocks for an E-member fold.
//  - A warp stages its 32 columns as one float4 (x, y, z, mask) each in
//    its own 512 B of shared memory (no block barrier in the sweep).  At
//    step k lane l reads column (l + k) mod 32: one conflict-free 128-bit
//    load per two pairs.
//  - Padding is skipped on the masks the kernel is given: a warp votes
//    (__ballot_sync) on its 32 column masks and skips a tile with none
//    set; a block whose 64 row masks are all 0 writes zeros and returns.
//    A mask with holes is handled pair by pair as before.  Skipping is
//    bitwise neutral (a skipped tile would add exact zeros).
//  - Row sums: a thread sums its rows over its warp's tiles in sweep order;
//    warps 1-3 pass their partials through shared memory and warp 0 adds
//    them in warp order.  With one column chunk the block writes F (and
//    pot) itself; with several it writes its partial to the wrapper's
//    scratch part_f [chunks, 3|4, E*npad] and a second pass
//    (yukawa_reduce_slabs) sums the chunks in order.
//  - REACT (kernel F): the rotating schedule gives the column reactions
//    without a tile in shared memory.  Lane l carries the running sum of
//    column (l + k) mod 32 at step k, adds its two rows' terms, and hands
//    it to lane l - 1 with one __shfl_sync per component; after 32 steps
//    the sum of column c has met all 64 rows of the tile, rows c, c - 1,
//    ... in a fixed order, and sits in lane c.  It goes (negated) to
//    part_g [E, row tiles, npc, 3], which the same second pass sums over
//    the row tiles in order.  Skipped tiles write zeros there.
//  - HALF (kernels A and C from HALF_MIN_NPAD = 2048 lanes a member): each
//    pair of a member once.  The member's npad / 64 row tiles form the JAX
//    package's _n3l_pairs triangle of tile pairs (I, J >= I); block b
//    takes row tile t = half[b].x against the columns [64 t + k chunk,
//    + chunk), k = half[b].y, so a row tile's chunks start at its own
//    diagonal tile.  The table half [blocks] (int2) comes from the wrapper,
//    made from npad alone (ops/yukawa.py: half_pair_split; the triangle's
//    columns over TARGET_BLOCKS rounded up to COL_TILE: 812 blocks of
//    128 columns a member at 3584 lanes, 1596 of its 3136 tile pairs), as
//    the JAX kernel reads scalar-prefetched tables: decoding b in the
//    kernel costs a loop over the row tiles or a square root per block.
//    The diagonal tile is swept whole, its reaction left out (each of its
//    pairs twice, once from each row: 51 % of the rectangle's pair work
//    at 3584 lanes, against 50 % for its strict triangle, which would
//    need a third sweep and a compare per pair).  Every other 32-column
//    tile carries REACT's rotating column sums, negated into part_g [E,
//    row tiles, 3, npad] (component planes: a warp's 32 lanes store 128
//    contiguous bytes); the block's row sums go to slab k of part_f
//    [chunks, 3, E*npad].  The second pass gives ion i of row tile t the
//    reactions of row tiles 0, ..., t - 1 and then its own row tile's
//    chunks in order: ascending partner tile, one order given npad.  Below
//    2048 lanes a member's launch is set by its fixed cost and its last
//    wave rather than by its pairs (A at 512 lanes: 0.0156 ms, 0.4 % of
//    its bound), the full form keeps the bits of every shape the
//    validation archive replays (8 x 600 ions in 640 lanes, 3 x 256), the
//    N=512 trajectories and the ring shard's 1792 lanes.
//  - No float atomics anywhere, and every sum has one fixed order given
//    (npad, ncols): all outputs are bitwise equal run to run (PARITY.md
//    delta 5), a member's are the same in a fold of any width (an E=1
//    launch of C is bitwise A), and E with a member's own lanes as its
//    columns is bitwise C on real rows below 2048 lanes (same split, same
//    sweep); from there on C sweeps the triangle, E the rectangle, and
//    they agree to some 3e-7 of the largest |F|.
//
// Registers and static shared memory (nvcc 12.8 -O3 -Xptxas -v, sm_90a;
// chip_smoke.py prints them at each build and fails on a spill): forces
// 40 registers and 4352 B (47 before the HALF parameter, the same bits),
// the half form 56 and 4352 B, forces + potential 48 and 5120 B, the
// REACT form 47 and 4352 B, the second pass 32 and none; no spills.  So
// 10 blocks (40 warps) fit on an SM, 9 of the half form.
//
// Measured (tools/torch_pair_kernel_times.py, device time between two
// events, median of 30; NVIDIA H100 80GB HBM3, 700.00 W): A 0.036 ms, D
// 0.047 ms (3500 ions in 3584 lanes); C 0.205 ms, G 0.218 ms (an 8-member
// Poissonian fold); E 0.024 ms (row-masked), F 0.018 ms, C 0.018 ms at a
// mesh shard's 875 ions in 1792 lanes.  A member's 12.8M lane pairs take
// about 25 us, some 65 scheduler cycles per pair and warp: the forms are
// bound by the instructions of a pair (rintf as magic-number adds moved C
// by 4 %, so not by the conversion/MUFU pipe), and a single member's
// launch by its fixed cost besides (two launches, the last wave: about 10
// us of A).  Rows per thread, in one command in turns on that card: four
// rows (128-row tiles, 56-72 registers) gave A 0.037, D 0.049, C 0.201, G
// 0.216, E 0.030, F 0.024, C on a shard 0.022 ms: two rows lose 2 % on the
// 8-member fold and win 19-23 % at a mesh shard's shapes, where a 64-row
// tile makes twice the blocks of a small launch and the skipped padding
// is cut finer.  The half form, in turns with the full one in one command
// (second pass included): A 0.0320 ms (0.0366), C 0.1265 ms (0.1961) on
// the 8-member fold, C 1.4312 ms (2.3340) on 99 x 3500 ions: 0.61 of the
// time for 0.52 of the pair work, the rest the reactions' adds and
// shuffles (some 5 instructions on a pair's 40-65), the scratch (at E=99
// about 180 MB written and read once) and the second pass.
//
// Numerics match the JAX kernel's tile math (_half_pair_tile):
// round-half-even minimum image (rintf, as jnp.round), strict r2 > 0 and
// r2 < rcut2, the rsqrt form of 1/r.  Built without --use_fast_math.
#include <cuda_runtime.h>

#define WARPS 4
#define THREADS (32 * WARPS)
#define RPT 2                      // rows per thread
#define ROW_TILE (32 * RPT)        // rows per block
#define COL_TILE (32 * WARPS)      // columns of one sweep of a block's warps
#define FULL_WARP 0xffffffffu

// The force factor ft of one pair (0 for an invalid pair) and, with POT,
// its potential term; dx/dy/dz come back minimum-imaged.
template <bool POT>
__device__ __forceinline__ float pair_ft(float& dx, float& dy, float& dz,
                                         bool mij, float L, float inv_L,
                                         float rcut2, float il, float& u) {
  dx -= L * rintf(dx * inv_L);
  dy -= L * rintf(dy * inv_L);
  dz -= L * rintf(dz * inv_L);
  const float r2 = dx * dx + dy * dy + dz * dz;
  const bool valid = mij && (r2 > 0.f) && (r2 < rcut2);
  const float r2s = valid ? r2 : 1.f;
  const float inv_r = rsqrtf(r2s);
  const float r = r2s * inv_r;
  const float ex = valid ? expf(-r * il) : 0.f;
  if (POT) u += ex * inv_r;
  return ex * (inv_r + il) * inv_r * inv_r;
}

// One warp's 32 staged columns against the thread's RPT rows: the row sums
// into f*/u and, with RX, each column's sum, handed on with its column
// (after the 32 steps lane l holds column l's).  HALF starts a step's
// column sum at -0, which the first add folds away (-0 + x is x); kernel
// F keeps its +0 and its bits.
template <bool POT, bool RX, bool HALF>
__device__ __forceinline__ void sweep(
    const float4* st, int lane, const float (&xi)[RPT],
    const float (&yi)[RPT], const float (&zi)[RPT], const bool (&mi)[RPT],
    float L, float inv_L, float rcut2, float il, float (&fx)[RPT],
    float (&fy)[RPT], float (&fz)[RPT], float (&u)[RPT], float& gx,
    float& gy, float& gz) {
#pragma unroll 2
  for (int k = 0; k < 32; ++k) {
    const float4 c = st[(lane + k) & 31];
    const bool mc = c.w > 0.f;
    float sx = HALF ? -0.f : 0.f, sy = sx, sz = sx;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float dx = xi[r] - c.x;
      float dy = yi[r] - c.y;
      float dz = zi[r] - c.z;
      const float ft = pair_ft<POT>(dx, dy, dz, mi[r] && mc, L, inv_L,
                                    rcut2, il, u[r]);
      const float px = dx * ft, py = dy * ft, pz = dz * ft;
      fx[r] += px;
      fy[r] += py;
      fz[r] += pz;
      if (RX) {
        sx += px;
        sy += py;
        sz += pz;
      }
    }
    if (RX) {          // the column's sum moves on with its column
      gx = __shfl_sync(FULL_WARP, gx + sx, (lane + 1) & 31);
      gy = __shfl_sync(FULL_WARP, gy + sy, (lane + 1) & 31);
      gz = __shfl_sync(FULL_WARP, gz + sz, (lane + 1) & 31);
    }
  }
}

// Grid (npad / ROW_TILE, column chunks, E), or with HALF (blocks of a
// member's triangle, 1, E).
// Rows: member e's lanes of Rp [3, E*npad], masked by rmask[e*rmask_stride
// + i] (rmask NULL: no row mask); with HALF block b takes row tile
// half[b].x.
// Columns: element j of member e, component c at
// cols[e*col_member + c*col_comp + j*col_elem], j < ncols, masked by
// cmask[e*cmask_stride + j]; this block takes j in [blockIdx.y * chunk,
// + chunk), with HALF [tile * ROW_TILE + half[b].y * chunk, + chunk).
// Row sums go to F / pot with one chunk, else to part_f [chunks, 3|4,
// E*npad] (with HALF always, slab half[b].y); with REACT the negated
// column sums of this row tile go to part_g [E, row tiles, ncols, 3], with
// HALF to part_g [E, row tiles, 3, npad] but for the diagonal tile's.
template <bool POT, bool REACT, bool HALF>
__global__ void __launch_bounds__(THREADS)
yukawa_pair_kernel(const float* __restrict__ Rp,
                   const float* __restrict__ rmask, int rmask_stride,
                   const float* __restrict__ cols, int col_member,
                   int col_comp, int col_elem, int ncols, int chunk,
                   const float* __restrict__ cmask, int cmask_stride,
                   const float* __restrict__ inv_ldeb_e,
                   const int2* __restrict__ half,
                   float* __restrict__ F, float* __restrict__ pot,
                   float* __restrict__ part_f, float* __restrict__ part_g,
                   int npad, int n_members, float L, float inv_L,
                   float rcut2, float inv_ldeb) {
  constexpr int NV = POT ? 4 : 3;
  __shared__ float4 stage[WARPS][32];
  __shared__ float red[WARPS - 1][NV][ROW_TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.z;
  const size_t row = (size_t)n_members * npad;    // stride between x, y, z
  // (row tile, chunk) of this block
  const int2 tc = HALF ? half[blockIdx.x]
                       : make_int2(blockIdx.x, blockIdx.y);
  const int i0 = tc.x * ROW_TILE + lane;          // this thread's first row
  const size_t q0 = (size_t)e * npad + i0;        // its lane in the fold
  float* out = !HALF && gridDim.y == 1 ? F
                                       : part_f + (size_t)tc.y * NV * row;
  float* out_u = gridDim.y == 1 ? pot : out + 3 * row;
  // HALF: a row tile's chunks start at its diagonal tile, whose columns
  // (j < diag) carry no reaction
  const int diag = HALF ? (tc.x + 1) * ROW_TILE : 0;
  const int j_begin = (HALF ? diag - ROW_TILE : 0) + tc.y * chunk;
  const int j_end = min(j_begin + chunk, ncols);
  float* P = REACT ? part_g + ((size_t)e * gridDim.x + blockIdx.x) * ncols * 3
           : HALF  ? part_g + ((size_t)e * (npad / ROW_TILE) + tc.x) * 3 * npad
                   : nullptr;
  // component c of column j's reaction at P[pj(j) + c * pc]
  const size_t pc = HALF ? npad : 1;
  auto pj = [](int j) { return HALF ? (size_t)j : 3 * (size_t)j; };

  float xi[RPT], yi[RPT], zi[RPT];
  bool mi[RPT];
  bool any_row = false;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    xi[r] = Rp[q0 + 32 * r];
    yi[r] = Rp[row + q0 + 32 * r];
    zi[r] = Rp[2 * row + q0 + 32 * r];
    mi[r] = rmask ? rmask[(size_t)e * rmask_stride + i0 + 32 * r] > 0.f
                  : true;
    any_row |= mi[r];
  }
  // every warp of the block holds the same ROW_TILE rows, so all agree
  if (__ballot_sync(FULL_WARP, any_row) == 0) {
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        out[q0 + 32 * r] = 0.f;
        out[row + q0 + 32 * r] = 0.f;
        out[2 * row + q0 + 32 * r] = 0.f;
        if (POT) out_u[q0 + 32 * r] = 0.f;
      }
    }
    if (REACT)
      for (int j = 3 * j_begin + threadIdx.x; j < 3 * j_end; j += THREADS)
        P[j] = 0.f;
    if (HALF)
      for (int j = max(j_begin, diag) + threadIdx.x; j < j_end; j += THREADS)
        P[j] = P[npad + j] = P[2 * (size_t)npad + j] = 0.f;
    return;
  }

  const float il = inv_ldeb_e ? inv_ldeb_e[e] : inv_ldeb;
  const float* C = cols + (size_t)e * col_member;
  const float* CM = cmask + (size_t)e * cmask_stride;
  float fx[RPT], fy[RPT], fz[RPT], u[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) fx[r] = fy[r] = fz[r] = u[r] = 0.f;

  for (int j0 = j_begin + 32 * warp; j0 < j_end; j0 += COL_TILE) {
    const int j = j0 + lane;
    const float m = CM[j];
    const bool rx = REACT || (HALF && j0 >= diag);
    if (__ballot_sync(FULL_WARP, m > 0.f) == 0) {      // a tile of padding
      if (rx) P[pj(j)] = P[pj(j) + pc] = P[pj(j) + 2 * pc] = 0.f;
      continue;
    }
    const size_t jc = (size_t)j * col_elem;
    __syncwarp();                     // the last tile's reads are done
    stage[warp][lane] = make_float4(C[jc], C[col_comp + jc],
                                    C[2 * (size_t)col_comp + jc], m);
    __syncwarp();
    float gx = 0.f, gy = 0.f, gz = 0.f;
    if (rx)
      sweep<POT, true, HALF>(stage[warp], lane, xi, yi, zi, mi, L, inv_L,
                             rcut2, il, fx, fy, fz, u, gx, gy, gz);
    else
      sweep<POT, false, HALF>(stage[warp], lane, xi, yi, zi, mi, L, inv_L,
                              rcut2, il, fx, fy, fz, u, gx, gy, gz);
    if (rx) {            // after 32 steps lane l holds column l's sum
      P[pj(j)] = -gx;
      P[pj(j) + pc] = -gy;
      P[pj(j) + 2 * pc] = -gz;
    }
  }

  // the block's row sums: warp 0's partial plus warps 1, 2, 3 in order
  if (warp > 0) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      red[warp - 1][0][lane + 32 * r] = fx[r];
      red[warp - 1][1][lane + 32 * r] = fy[r];
      red[warp - 1][2][lane + 32 * r] = fz[r];
      if (POT) red[warp - 1][NV - 1][lane + 32 * r] = u[r];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
#pragma unroll
      for (int w = 0; w < WARPS - 1; ++w) {
        fx[r] += red[w][0][lane + 32 * r];
        fy[r] += red[w][1][lane + 32 * r];
        fz[r] += red[w][2][lane + 32 * r];
        if (POT) u[r] += red[w][NV - 1][lane + 32 * r];
      }
      out[q0 + 32 * r] = fx[r];
      out[row + q0 + 32 * r] = fy[r];
      out[2 * row + q0 + 32 * r] = fz[r];
      if (POT) out_u[q0 + 32 * r] = u[r];
    }
  }
}

// The second pass: n_outer groups of n_slab slabs of `per` floats each,
// summed over the slabs in order: out[o * per + i] = sum_b part[(o * n_slab
// + b) * per + i].  The first n_a outputs go to out_a, the rest to out_b.
// Rows: one group of the column chunks' partials, F then pot.  Reactions:
// a group per member of its row tiles' partials.
struct Slabs {
  const float* part;
  float* out_a;
  float* out_b;
  size_t n_a, per;
  int n_slab, n_outer;
};

// The half form's second pass (F non-NULL): component c of ion i of member
// e, in row tile t, is the reactions of row tiles 0, 1, ..., t - 1
// (part_g [E, tiles, 3, npad]) and then the row partials of its own row
// tile's chunks 0, 1, ..., ceil((tiles - t) / per_chunk) - 1 (part_f
// [chunks, 3, E*npad]), summed in that order: ascending partner tile.
struct HalfSlabs {
  const float* part_f;
  const float* part_g;
  float* F;
  int npad, n_members, per_chunk;     // per_chunk: row tiles a chunk spans
};

__global__ void yukawa_reduce_slabs(Slabs rows, Slabs cols, HalfSlabs h) {
  const size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (h.F) {
    const size_t lanes = (size_t)h.n_members * h.npad;
    if (q >= 3 * lanes) return;
    const size_t c = q / lanes, l = q % lanes;
    const int i = (int)(l % h.npad), t = i / ROW_TILE;
    const int tiles = h.npad / ROW_TILE;
    const float* g = h.part_g + ((l / h.npad) * tiles * 3 + c) * h.npad + i;
    const float* f = h.part_f + c * lanes + l;
    const int chunks = (tiles - t + h.per_chunk - 1) / h.per_chunk;
    float sum = 0.f;
    for (int s = 0; s < t; ++s) sum += g[(size_t)s * 3 * h.npad];
    for (int k = 0; k < chunks; ++k) sum += f[(size_t)k * 3 * lanes];
    h.F[q] = sum;
    return;
  }
  const Slabs s = blockIdx.y == 0 ? rows : cols;
  if (q >= s.per * s.n_outer) return;
  const float* p = s.part + (q / s.per) * s.n_slab * s.per + q % s.per;
  float sum = 0.f;
  for (int b = 0; b < s.n_slab; ++b) sum += p[b * s.per];
  if (q < s.n_a) s.out_a[q] = sum;
  else s.out_b[q - s.n_a] = sum;
}

namespace {

struct PairLaunch {
  const float* Rp;
  const float* rmask;
  int rmask_stride;
  const float* cols;
  int col_member, col_comp, col_elem, ncols, chunk;
  const float* cmask;
  int cmask_stride;
  const float* inv_ldeb_e;
  float* F;
  float* pot;       // non-NULL: the potential form
  float* part_f;    // [chunks, 3|4, E*npad], needed with several chunks
  float* G;         // non-NULL: the reaction form (kernel F)
  float* part_g;    // [E, npad / ROW_TILE, ncols, 3]; the half form's
                    // [E, npad / ROW_TILE, 3, npad]
  const int2* half; // non-NULL: the half form's (row tile, chunk) a block
  int n_half;       // its blocks of a member
  int npad, n_members;
  float L, inv_L, rcut2, inv_ldeb;
};

int launch_pairs(const PairLaunch& a, cudaStream_t st) {
  if (a.npad <= 0 || a.npad % ROW_TILE != 0 || a.ncols <= 0 ||
      a.ncols % COL_TILE != 0 || a.chunk <= 0 || a.chunk % COL_TILE != 0 ||
      a.n_members < 1 || a.n_members > 65535 ||
      (a.rmask_stride != 0 && a.rmask_stride != a.npad) ||
      (a.cmask_stride != 0 && a.cmask_stride != a.ncols) ||
      (a.pot && a.G) || (a.G && !a.part_g) ||
      (a.half && (a.pot || a.G || a.n_half <= 0 || a.ncols != a.npad ||
                  !a.part_f || !a.part_g)))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = a.half ? 1 : (a.ncols + a.chunk - 1) / a.chunk;
  const int n_tiles = a.npad / ROW_TILE;
  if (n_chunks > 65535 || (n_chunks > 1 && !a.part_f))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.half ? a.n_half : n_tiles, n_chunks, a.n_members);
#define PAIR_ARGS                                                          \
  a.Rp, a.rmask, a.rmask_stride, a.cols, a.col_member, a.col_comp,        \
      a.col_elem, a.ncols, a.chunk, a.cmask, a.cmask_stride, a.inv_ldeb_e, \
      a.half, a.F, a.pot, a.part_f, a.part_g, a.npad, a.n_members, a.L,    \
      a.inv_L, a.rcut2, a.inv_ldeb
  if (a.pot)
    yukawa_pair_kernel<true, false, false><<<grid, THREADS, 0, st>>>(
        PAIR_ARGS);
  else if (a.G)
    yukawa_pair_kernel<false, true, false><<<grid, THREADS, 0, st>>>(
        PAIR_ARGS);
  else if (a.half)
    yukawa_pair_kernel<false, false, true><<<grid, THREADS, 0, st>>>(
        PAIR_ARGS);
  else
    yukawa_pair_kernel<false, false, false><<<grid, THREADS, 0, st>>>(
        PAIR_ARGS);
#undef PAIR_ARGS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (n_chunks == 1 && !a.G && !a.half))
    return (int)err;
  const size_t lanes = (size_t)a.n_members * a.npad;
  const size_t nv = a.pot ? 4 : 3;
  const HalfSlabs h = {a.part_f, a.part_g, a.half ? a.F : nullptr, a.npad,
                       a.n_members, a.chunk / ROW_TILE};
  // with one chunk the rows are written already: an empty job
  const Slabs rows = {a.part_f, a.F, a.pot, 3 * lanes, nv * lanes,
                      n_chunks, n_chunks > 1 ? 1 : 0};
  const size_t per_g = (size_t)a.ncols * 3;
  const Slabs cols = {a.part_g, a.G, nullptr, per_g * a.n_members, per_g,
                      n_tiles, a.n_members};
  const size_t n_rows = a.half ? 3 * lanes : rows.per * rows.n_outer;
  const size_t n_cols = a.G ? cols.per * cols.n_outer : 0;
  const size_t n_max = n_rows > n_cols ? n_rows : n_cols;
  yukawa_reduce_slabs<<<dim3((unsigned)((n_max + 255) / 256), a.G ? 2 : 1),
                        256, 0, st>>>(rows, cols, h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernels A, C, D, G: E members against their own lanes.  Rp/F [3,
// E*npad], pot [E*npad] or NULL (forces only); mask [E, npad]
// (mask_stride = npad) or [1, npad] (mask_stride = 0); inv_ldeb_e [E] or
// NULL (scalar inv_ldeb); columns in chunks of `chunk`; part_f the
// caller's scratch [chunks, 3|4, E*npad] (NULL with one chunk).  The half
// form (forces only): half [n_half] the blocks' (row tile, chunk), part_f
// [chunks, 3, E*npad] and part_g [E, npad / 64, 3, npad] the caller's
// scratch; half NULL: the full rectangle
int yukawa_forces_launch(const float* Rp, const float* mask, int mask_stride,
                         const float* inv_ldeb_e, float* F, float* pot,
                         float* part_f, float* part_g, const int* half,
                         int n_half, int npad, int n_members, int chunk,
                         float L, float inv_L, float rcut2, float inv_ldeb,
                         void* stream) {
  const PairLaunch a = {Rp, mask, mask_stride, Rp, npad, n_members * npad, 1,
                        npad, chunk, mask, mask_stride, inv_ldeb_e, F, pot,
                        part_f, nullptr, part_g, (const int2*)half, n_half,
                        npad, n_members, L, inv_L, rcut2, inv_ldeb};
  return launch_pairs(a, (cudaStream_t)stream);
}

// Kernel E: rows Rp/F [3, E*npad], masked by row_mask [E|1, npad] unless
// NULL, against cols [E, ncols, 3] masked by col_mask [E, ncols]
// (col_mask_stride = ncols) or [ncols] (0)
int yukawa_forces_cols_launch(const float* Rp, const float* row_mask,
                              int row_mask_stride, const float* cols,
                              const float* col_mask, int col_mask_stride,
                              float* F, float* part_f, int npad, int ncols,
                              int n_members, int chunk, float L, float inv_L,
                              float rcut2, float inv_ldeb, void* stream) {
  const PairLaunch a = {Rp, row_mask, row_mask_stride, cols, ncols * 3, 1, 3,
                        ncols, chunk, col_mask, col_mask_stride, nullptr, F,
                        nullptr, part_f, nullptr, nullptr, nullptr, 0, npad,
                        n_members, L, inv_L, rcut2, inv_ldeb};
  return launch_pairs(a, (cudaStream_t)stream);
}

// Kernel F: rows Rp/F [3, E*npad] masked by mask [E|1, npad] against cols
// [E, npc, 3] masked by col_mask [E, npc] (col_mask_stride = npc) or [npc]
// (0); G [E, npc, 3] the negated column sums; part_g [E, npad/64, npc, 3]
// and part_f the caller's scratch
int yukawa_cross_launch(const float* Rp, const float* mask, int mask_stride,
                        const float* cols, const float* col_mask,
                        int col_mask_stride, float* F, float* G,
                        float* part_f, float* part_g, int npad, int npc,
                        int n_members, int chunk, float L, float inv_L,
                        float rcut2, float inv_ldeb, void* stream) {
  if (!mask || !G) return (int)cudaErrorInvalidValue;
  const PairLaunch a = {Rp, mask, mask_stride, cols, npc * 3, 1, 3, npc,
                        chunk, col_mask, col_mask_stride, nullptr, F, nullptr,
                        part_f, G, part_g, nullptr, 0, npad, n_members, L,
                        inv_L, rcut2, inv_ldeb};
  return launch_pairs(a, (cudaStream_t)stream);
}

const char* mdqt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
