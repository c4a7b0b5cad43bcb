// Yukawa pair forces (and optionally the per-ion potential) in the lane
// layout, one ion block per ensemble member: F [3, E*Np] (pot [E*Np]) from
// Rp [3, E*Np] and real-ion masks (mdqtplasmasims_torch/ops/yukawa.py
// wraps it).
//
// Replaces six TPU kernels of mdqtplasmasims_tpu/ops/yukawa.py:
//   A  _yukawa_n3l_kernel          (one member; yukawa_forces_launch)
//   C  _yukawa_n3l_kernel_batched  (E members; yukawa_forces_batched_launch)
//   D  _yukawa_kernel              (one member, + potential;
//                                   yukawa_forces_pot_launch, E = 1)
//   G  _yukawa_kernel_batched      (E members, + potential;
//                                   yukawa_forces_pot_launch)
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
// member's own lanes for A/C/D/G) and the rows carry no mask (the caller
// masks them, as the JAX package's caller does).  The j loop and the
// arithmetic are one code path, so E with the member's own lanes as its
// columns gives kernel C's forces on every real row bit for bit.
//
// F (the ring-N3L path: rows of one ion shard against the visiting block
// of another shard of the same member) evaluates each (row, column) pair
// ONCE: row sums accumulate per thread; the column reactions of a block's
// 64 rows are summed in shared memory in a fixed row order and written as
// one partial per (row block, column) to a buffer, which a second pass
// sums over the row blocks in order (the JAX kernel's own g buffer,
// reduced over the row-tile axis).  No float atomics, so F and G are
// bitwise deterministic run to run (the repo's deterministic-forces
// property).  G holds the NEGATED column sums: the reaction on the
// visiting ions.
//
// What bounds these on the H100: arithmetic (about 30 FP32 operations, one
// expf and one rsqrtf per pair; 12.8M ordered pairs per member at the
// flagship Np=3584) and occupancy: one thread per ion gives Np/64 = 56
// blocks of 64 threads per member.  One member (A) leaves 76 of the 132
// SMs idle; E=8 members (C) give 448 blocks, all resident in one wave at
// 3-4 blocks (6-8 warps of a possible 64) per SM, so every SM works but
// each runs at about a tenth of its warp slots and latency stays exposed.
// A mesh slot's E or F launch at 1792 rows per member gives 28 blocks per
// member: the card is mostly idle.  F adds three shared-memory stores per
// pair and a 64-term sum per (row block, column).
//
// Design: grid (Np/64, E); one thread per ion i; member e's j positions
// stream through shared memory in tiles of THREADS; each thread sums over
// ALL j of its member (both triangles).  No atomics and no reaction
// buffer, so every output is one fixed-order sum and the forces are
// bitwise deterministic run to run.  A is the E=1 case of the same kernel,
// so an E=1 launch with a shared mask is bitwise equal to A.  This
// evaluates each pair twice; the half-pair (Newton's third law) schedule,
// j-splitting across threads for occupancy, and wgmma/TMA staging are
// later performance work.
//
// Registers (nvcc 12.8 -O3 -Xptxas -v, sm_90a): 32 per thread in both
// forms of the force kernel, no spills, 1 KB shared memory per block; at
// 64 threads that allows 32 resident blocks per SM, so C's and G's 448
// blocks fit in one wave.  F's pass 1: 49 registers, 25,472 B of shared
// memory (8 resident blocks per SM); pass 2: 32.  chip_smoke.py prints
// the counts of each build.
//
// Numerics match the JAX kernel's tile math (_half_pair_tile):
// round-half-even minimum image (rintf, as jnp.round), strict r2 > 0 and
// r2 < rcut2, the rsqrt form of 1/r.  Built without --use_fast_math.
#include <cuda_runtime.h>

#define THREADS 64
#define CROSS_TJ 32          // F: columns per shared-memory reaction tile

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

// Rows: member e's lanes of Rp [3, E*npad] (rmask NULL: no row mask).
// Columns: element j of member e, component c at
// cols[e*col_member + c*col_comp + j*col_elem], j < ncols, masked by
// cmask[e*cmask_stride + j].
template <bool POT>
__global__ void __launch_bounds__(THREADS)
yukawa_forces_kernel(const float* __restrict__ Rp,
                     const float* __restrict__ rmask, int rmask_stride,
                     const float* __restrict__ cols, int col_member,
                     int col_comp, int col_elem, int ncols,
                     const float* __restrict__ cmask, int cmask_stride,
                     const float* __restrict__ inv_ldeb_e,
                     float* __restrict__ F, float* __restrict__ pot,
                     int npad, int n_members, float L, float inv_L,
                     float rcut2, float inv_ldeb) {
  __shared__ float sx[THREADS], sy[THREADS], sz[THREADS], sm[THREADS];
  const int t = threadIdx.x;
  const int e = blockIdx.y;
  const size_t row = (size_t)n_members * npad;    // stride between x, y, z
  const float* X = Rp + (size_t)e * npad;
  const float* C = cols + (size_t)e * col_member;
  const float* CM = cmask + (size_t)e * cmask_stride;
  const float il = inv_ldeb_e ? inv_ldeb_e[e] : inv_ldeb;
  const int i = blockIdx.x * THREADS + t;   // npad % THREADS == 0
  const float xi = X[i], yi = X[row + i], zi = X[2 * row + i];
  const bool mi = rmask ? rmask[(size_t)e * rmask_stride + i] > 0.f : true;
  float fx = 0.f, fy = 0.f, fz = 0.f, u = 0.f;
  for (int j0 = 0; j0 < ncols; j0 += THREADS) {
    __syncthreads();
    const size_t j = (size_t)(j0 + t) * col_elem;
    sx[t] = C[j];
    sy[t] = C[col_comp + j];
    sz[t] = C[2 * (size_t)col_comp + j];
    sm[t] = CM[j0 + t];
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < THREADS; ++k) {
      float dx = xi - sx[k];
      float dy = yi - sy[k];
      float dz = zi - sz[k];
      const float ft = pair_ft<POT>(dx, dy, dz, mi && (sm[k] > 0.f), L,
                                    inv_L, rcut2, il, u);
      fx += dx * ft;
      fy += dy * ft;
      fz += dz * ft;
    }
  }
  float* G = F + (size_t)e * npad;
  G[i] = fx;
  G[row + i] = fy;
  G[2 * row + i] = fz;
  if (POT) pot[(size_t)e * npad + i] = u;
}

// F, pass 1: grid (npad/THREADS, E).  Row sums of member e's rows into F;
// the block's column reactions -sum_i f_ij, one per (row block, column),
// into part [E, n_row_blocks, npc, 3].
__global__ void __launch_bounds__(THREADS)
yukawa_cross_kernel(const float* __restrict__ Rp,
                    const float* __restrict__ rmask, int rmask_stride,
                    const float* __restrict__ cols,
                    const float* __restrict__ cmask, int cmask_stride,
                    float* __restrict__ F, float* __restrict__ part,
                    int npad, int npc, int n_members, float L, float inv_L,
                    float rcut2, float inv_ldeb) {
  __shared__ float sx[CROSS_TJ], sy[CROSS_TJ], sz[CROSS_TJ], sm[CROSS_TJ];
  // [3][CROSS_TJ][THREADS + 1]: row stride 65 keeps both the per-row
  // stores and the per-column sums free of bank conflicts
  __shared__ float gs[3 * CROSS_TJ * (THREADS + 1)];
  const int t = threadIdx.x;
  const int e = blockIdx.y;
  const int nrb = gridDim.x;
  const size_t row = (size_t)n_members * npad;
  const float* X = Rp + (size_t)e * npad;
  const float* C = cols + (size_t)e * npc * 3;
  const float* CM = cmask + (size_t)e * cmask_stride;
  const int i = blockIdx.x * THREADS + t;
  const float xi = X[i], yi = X[row + i], zi = X[2 * row + i];
  const bool mi = rmask[(size_t)e * rmask_stride + i] > 0.f;
  float* P = part + ((size_t)e * nrb + blockIdx.x) * npc * 3;
  float fx = 0.f, fy = 0.f, fz = 0.f, u = 0.f;
  for (int j0 = 0; j0 < npc; j0 += CROSS_TJ) {
    __syncthreads();
    if (t < CROSS_TJ) {
      const size_t j = (size_t)(j0 + t) * 3;
      sx[t] = C[j];
      sy[t] = C[j + 1];
      sz[t] = C[j + 2];
      sm[t] = CM[j0 + t];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < CROSS_TJ; ++k) {
      float dx = xi - sx[k];
      float dy = yi - sy[k];
      float dz = zi - sz[k];
      const float ft = pair_ft<false>(dx, dy, dz, mi && (sm[k] > 0.f), L,
                                      inv_L, rcut2, inv_ldeb, u);
      const float gx = dx * ft, gy = dy * ft, gz = dz * ft;
      fx += gx;
      fy += gy;
      fz += gz;
      gs[(0 * CROSS_TJ + k) * (THREADS + 1) + t] = gx;
      gs[(1 * CROSS_TJ + k) * (THREADS + 1) + t] = gy;
      gs[(2 * CROSS_TJ + k) * (THREADS + 1) + t] = gz;
    }
    __syncthreads();
    // 3*CROSS_TJ column sums over the block's rows, each in row order
    for (int q = t; q < 3 * CROSS_TJ; q += THREADS) {
      const float* g = gs + q * (THREADS + 1);
      float s = 0.f;
      for (int r = 0; r < THREADS; ++r) s += g[r];
      const int c = q / CROSS_TJ, k = q % CROSS_TJ;
      P[(size_t)(j0 + k) * 3 + c] = -s;
    }
  }
  float* Fo = F + (size_t)e * npad;
  Fo[i] = fx;
  Fo[row + i] = fy;
  Fo[2 * row + i] = fz;
}

// F, pass 2: G[e, j, c] = sum over row blocks b (in order) of part[e, b,
// j, c]; one thread per output value.
__global__ void yukawa_cross_reduce(const float* __restrict__ part,
                                    float* __restrict__ G, int nrb,
                                    int npc, int n_members) {
  const size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per = (size_t)npc * 3;
  if (q >= per * n_members) return;
  const size_t e = q / per, jc = q % per;
  const float* p = part + e * nrb * per + jc;
  float s = 0.f;
  for (int b = 0; b < nrb; ++b) s += p[b * per];
  G[q] = s;
}

extern "C" {

// E members, forces and (pot non-NULL) the potential: Rp/F [3, E*npad],
// pot [E*npad]; mask [E, npad] (mask_stride = npad) or [1, npad]
// (mask_stride = 0); inv_ldeb_e [E] or NULL (scalar inv_ldeb)
int yukawa_forces_pot_launch(const float* Rp, const float* mask,
                             int mask_stride, const float* inv_ldeb_e,
                             float* F, float* pot, int npad, int n_members,
                             float L, float inv_L, float rcut2,
                             float inv_ldeb, void* stream) {
  if (npad <= 0 || npad % THREADS != 0 || n_members < 1 ||
      n_members > 65535 || (mask_stride != 0 && mask_stride != npad))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(npad / THREADS, n_members);
  const int comp = n_members * npad;
  cudaStream_t st = (cudaStream_t)stream;
  if (pot)
    yukawa_forces_kernel<true><<<grid, THREADS, 0, st>>>(
        Rp, mask, mask_stride, Rp, npad, comp, 1, npad, mask, mask_stride,
        inv_ldeb_e, F, pot, npad, n_members, L, inv_L, rcut2, inv_ldeb);
  else
    yukawa_forces_kernel<false><<<grid, THREADS, 0, st>>>(
        Rp, mask, mask_stride, Rp, npad, comp, 1, npad, mask, mask_stride,
        inv_ldeb_e, F, nullptr, npad, n_members, L, inv_L, rcut2, inv_ldeb);
  return (int)cudaGetLastError();
}

// E members, forces only (kernel C)
int yukawa_forces_batched_launch(const float* Rp, const float* mask,
                                 int mask_stride, const float* inv_ldeb_e,
                                 float* F, int npad, int n_members, float L,
                                 float inv_L, float rcut2, float inv_ldeb,
                                 void* stream) {
  return yukawa_forces_pot_launch(Rp, mask, mask_stride, inv_ldeb_e, F,
                                  nullptr, npad, n_members, L, inv_L, rcut2,
                                  inv_ldeb, stream);
}

// one member (kernel A): Rp/F [3, npad], mask [1, npad]
int yukawa_forces_launch(const float* Rp, const float* mask, float* F,
                         int npad, float L, float inv_L, float rcut2,
                         float inv_ldeb, void* stream) {
  return yukawa_forces_batched_launch(Rp, mask, 0, nullptr, F, npad, 1, L,
                                      inv_L, rcut2, inv_ldeb, stream);
}

// kernel E: rows Rp/F [3, E*npad] (no row mask) against cols [E, ncols, 3]
// masked by col_mask [E, ncols] (col_mask_stride = ncols) or [ncols]
// (col_mask_stride = 0)
int yukawa_forces_cols_launch(const float* Rp, const float* cols,
                              const float* col_mask, int col_mask_stride,
                              float* F, int npad, int ncols, int n_members,
                              float L, float inv_L, float rcut2,
                              float inv_ldeb, void* stream) {
  if (npad <= 0 || npad % THREADS != 0 || ncols <= 0 ||
      ncols % THREADS != 0 || n_members < 1 || n_members > 65535 ||
      (col_mask_stride != 0 && col_mask_stride != ncols))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(npad / THREADS, n_members);
  yukawa_forces_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      Rp, nullptr, 0, cols, ncols * 3, 1, 3, ncols, col_mask,
      col_mask_stride, nullptr, F, nullptr, npad, n_members, L, inv_L, rcut2,
      inv_ldeb);
  return (int)cudaGetLastError();
}

// kernel F: rows Rp/F [3, E*npad] masked by mask_row [E|1, npad] against
// cols [E, npc, 3] masked by col_mask [E, npc] (col_mask_stride = npc) or
// [npc] (0); G [E, npc, 3] the negated column sums; part [E, npad/64, npc,
// 3] the caller's scratch
int yukawa_cross_launch(const float* Rp, const float* mask, int mask_stride,
                        const float* cols, const float* col_mask,
                        int col_mask_stride, float* F,
                        float* G, float* part, int npad, int npc,
                        int n_members, float L, float inv_L, float rcut2,
                        float inv_ldeb, void* stream) {
  if (npad <= 0 || npad % THREADS != 0 || npc <= 0 || npc % CROSS_TJ != 0 ||
      n_members < 1 || n_members > 65535 ||
      (mask_stride != 0 && mask_stride != npad) ||
      (col_mask_stride != 0 && col_mask_stride != npc))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nrb = npad / THREADS;
  yukawa_cross_kernel<<<dim3(nrb, n_members), THREADS, 0, st>>>(
      Rp, mask, mask_stride, cols, col_mask, col_mask_stride, F, part, npad,
      npc, n_members, L, inv_L, rcut2, inv_ldeb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n_out = (size_t)n_members * npc * 3;
  yukawa_cross_reduce<<<(unsigned)((n_out + 255) / 256), 256, 0, st>>>(
      part, G, nrb, npc, n_members);
  return (int)cudaGetLastError();
}

const char* mdqt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
