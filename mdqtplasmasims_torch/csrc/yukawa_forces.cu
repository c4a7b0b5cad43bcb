// Yukawa pair forces (and optionally the per-ion potential) in the lane
// layout, one ion block per ensemble member: F [3, E*Np] (pot [E*Np]) from
// Rp [3, E*Np] and real-ion masks (mdqtplasmasims_torch/ops/yukawa.py
// wraps it).
//
// Replaces four TPU kernels of mdqtplasmasims_tpu/ops/yukawa.py:
//   A  _yukawa_n3l_kernel          (one member; yukawa_forces_launch)
//   C  _yukawa_n3l_kernel_batched  (E members; yukawa_forces_batched_launch)
//   D  _yukawa_kernel              (one member, + potential;
//                                   yukawa_forces_pot_launch, E = 1)
//   G  _yukawa_kernel_batched      (E members, + potential;
//                                   yukawa_forces_pot_launch)
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
// one more accumulator and the expf is shared.  Member e's ions are lanes [e*Np, (e+1)*Np) of every row; its mask
// row is mask[e*mask_stride ...] (stride 0: one [1, Np] row shared by all
// members); its 1/lambda is inv_ldeb_e[e] when that array is given (the
// per-member screening of kappa sweeps), else the scalar inv_ldeb.
//
// What bounds it on the H100: arithmetic (about 30 FP32 operations, one
// expf and one rsqrtf per ordered pair; 12.8M ordered pairs per member at
// the flagship Np=3584) and occupancy: one thread per ion gives Np/64 =
// 56 blocks of 64 threads per member.  One member (A) leaves 76 of the 132
// SMs idle; E=8 members (C) give 448 blocks, all resident in one wave at
// 3-4 blocks (6-8 warps of a possible 64) per SM, so every SM works but
// each runs at about a tenth of its warp slots and latency stays exposed.
//
// Design: grid (Np/64, E); one thread per ion i; member e's j positions
// stream through shared memory in tiles of THREADS; each thread sums over
// ALL j of its member (both triangles).  No atomics and no reaction
// buffer, so every output is one fixed-order sum and the forces are
// bitwise deterministic run to run (the repo's deterministic-forces
// property).  A is the E=1 case of the same kernel, so an E=1 launch with
// a shared mask is bitwise equal to A.  This evaluates each pair twice;
// the half-pair (Newton's third law) schedule, j-splitting across threads
// for occupancy, and wgmma/TMA staging are later performance work.
//
// Registers (nvcc 12.8 -O3 -Xptxas -v, sm_90a): 32 per thread (40 with
// POT), no spills, 1 KB shared memory per block; at 64 threads that allows
// 32 resident blocks per SM, so C's and G's 448 blocks fit in one wave.
//
// Numerics match the JAX kernel's tile math (_half_pair_tile):
// round-half-even minimum image (rintf, as jnp.round), strict r2 > 0 and
// r2 < rcut2, the rsqrt form of 1/r.  Built without --use_fast_math.
#include <cuda_runtime.h>

#define THREADS 64

template <bool POT>
__global__ void __launch_bounds__(THREADS)
yukawa_forces_kernel(const float* __restrict__ Rp,
                     const float* __restrict__ mask, int mask_stride,
                     const float* __restrict__ inv_ldeb_e,
                     float* __restrict__ F, float* __restrict__ pot,
                     int npad, int n_members, float L, float inv_L,
                     float rcut2, float inv_ldeb) {
  __shared__ float sx[THREADS], sy[THREADS], sz[THREADS], sm[THREADS];
  const int t = threadIdx.x;
  const int e = blockIdx.y;
  const size_t row = (size_t)n_members * npad;    // stride between x, y, z
  const float* X = Rp + (size_t)e * npad;
  const float* M = mask + (size_t)e * mask_stride;
  const float il = inv_ldeb_e ? inv_ldeb_e[e] : inv_ldeb;
  const int i = blockIdx.x * THREADS + t;   // npad % THREADS == 0
  const float xi = X[i], yi = X[row + i], zi = X[2 * row + i];
  const bool mi = M[i] > 0.f;
  float fx = 0.f, fy = 0.f, fz = 0.f, u = 0.f;
  for (int j0 = 0; j0 < npad; j0 += THREADS) {
    __syncthreads();
    sx[t] = X[j0 + t];
    sy[t] = X[row + j0 + t];
    sz[t] = X[2 * row + j0 + t];
    sm[t] = M[j0 + t];
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < THREADS; ++k) {
      float dx = xi - sx[k];
      float dy = yi - sy[k];
      float dz = zi - sz[k];
      dx -= L * rintf(dx * inv_L);
      dy -= L * rintf(dy * inv_L);
      dz -= L * rintf(dz * inv_L);
      const float r2 = dx * dx + dy * dy + dz * dz;
      const bool valid = mi && (sm[k] > 0.f) && (r2 > 0.f) && (r2 < rcut2);
      const float r2s = valid ? r2 : 1.f;
      const float inv_r = rsqrtf(r2s);
      const float r = r2s * inv_r;
      const float ex = valid ? expf(-r * il) : 0.f;
      const float ft = ex * (inv_r + il) * inv_r * inv_r;
      fx += dx * ft;
      fy += dy * ft;
      fz += dz * ft;
      if (POT) u += ex * inv_r;
    }
  }
  float* G = F + (size_t)e * npad;
  G[i] = fx;
  G[row + i] = fy;
  G[2 * row + i] = fz;
  if (POT) pot[(size_t)e * npad + i] = u;
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
  cudaStream_t st = (cudaStream_t)stream;
  if (pot)
    yukawa_forces_kernel<true><<<grid, THREADS, 0, st>>>(
        Rp, mask, mask_stride, inv_ldeb_e, F, pot, npad, n_members, L, inv_L,
        rcut2, inv_ldeb);
  else
    yukawa_forces_kernel<false><<<grid, THREADS, 0, st>>>(
        Rp, mask, mask_stride, inv_ldeb_e, F, nullptr, npad, n_members, L,
        inv_L, rcut2, inv_ldeb);
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

const char* mdqt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
