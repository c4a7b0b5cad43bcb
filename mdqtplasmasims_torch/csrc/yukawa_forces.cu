// Yukawa pair forces in the lane layout: F [3, Np] from Rp [3, Np] and a
// real-ion mask [Np] (mdqtplasmasims_torch/ops/yukawa.py wraps it).
//
// Replaces the TPU kernel mdqtplasmasims_tpu/ops/yukawa.py:
// _yukawa_n3l_kernel (half-pair tiles on a triangle grid, reaction sums
// scatter-added outside).  It computes the same force
//     F_i = sum_j (1/r + 1/lambda) exp(-r/lambda) / r^2 * d_ij
// under the minimum image, over pairs with 0 < r^2 < (L/2)^2 whose i and
// j are both real ions (padded lanes come out exactly 0).
//
// What bounds it on the H100: arithmetic (about 30 FP32 operations, one
// expf and one rsqrtf per ordered pair; 12.8M ordered pairs at the
// flagship Np=3584) and, at that size, occupancy: one thread per ion
// gives only Np/64 = 56 blocks of 64 threads for 132 SMs.
//
// Design: one thread per ion i; the j positions stream through shared
// memory in tiles of THREADS; each thread sums over ALL j (both
// triangles).  No atomics and no reaction buffer, so every output is one
// fixed-order sum and the forces are bitwise deterministic run to run
// (the repo's deterministic-forces property).  This evaluates each pair
// twice; the half-pair (Newton's third law) schedule, j-splitting across
// threads for occupancy, and wgmma/TMA staging are later performance work.
//
// Registers (nvcc 12.8 -O3 -Xptxas -v, sm_90a): 32 per thread, no spills,
// 1 KB shared memory per block.
//
// Numerics match the JAX kernel's tile math (_half_pair_tile):
// round-half-even minimum image (rintf, as jnp.round), strict r2 > 0 and
// r2 < rcut2, the rsqrt form of 1/r.  Built without --use_fast_math.
#include <cuda_runtime.h>

#define THREADS 64

__global__ void __launch_bounds__(THREADS)
yukawa_forces_kernel(const float* __restrict__ Rp,
                     const float* __restrict__ mask,
                     float* __restrict__ F, int npad, float L, float inv_L,
                     float rcut2, float inv_ldeb) {
  __shared__ float sx[THREADS], sy[THREADS], sz[THREADS], sm[THREADS];
  const int t = threadIdx.x;
  const int i = blockIdx.x * THREADS + t;   // npad % THREADS == 0
  const float xi = Rp[i], yi = Rp[npad + i], zi = Rp[2 * npad + i];
  const bool mi = mask[i] > 0.f;
  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int j0 = 0; j0 < npad; j0 += THREADS) {
    __syncthreads();
    sx[t] = Rp[j0 + t];
    sy[t] = Rp[npad + j0 + t];
    sz[t] = Rp[2 * npad + j0 + t];
    sm[t] = mask[j0 + t];
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
      const float ft =
          valid ? expf(-r * inv_ldeb) * (inv_r + inv_ldeb) * inv_r * inv_r
                : 0.f;
      fx += dx * ft;
      fy += dy * ft;
      fz += dz * ft;
    }
  }
  F[i] = fx;
  F[npad + i] = fy;
  F[2 * npad + i] = fz;
}

extern "C" {

int yukawa_forces_launch(const float* Rp, const float* mask, float* F,
                         int npad, float L, float inv_L, float rcut2,
                         float inv_ldeb, void* stream) {
  if (npad <= 0 || npad % THREADS != 0) return (int)cudaErrorInvalidValue;
  yukawa_forces_kernel<<<npad / THREADS, THREADS, 0,
                         (cudaStream_t)stream>>>(Rp, mask, F, npad, L, inv_L,
                                                 rcut2, inv_ldeb);
  return (int)cudaGetLastError();
}

const char* mdqt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
