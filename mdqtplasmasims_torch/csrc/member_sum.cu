// Per-member sums over ions: out[r] = sum_j x[r, j] (* mask[r, j]) for
// x [rows, n] contiguous, one row per ensemble member (or per member and
// component); mdqtplasmasims_torch/ops/member_sum.py wraps it.
//
// Replaces no TPU kernel.  The JAX package reduces a fold's per-member
// observables (temperatures, kinetic and potential energies, tagged
// moments, KDE bins, records) with XLA's reductions and requires a fold
// spread over a mesh to give the unsharded fold's bits
// (tests/test_parallel.py TestMemberShardedFamilies).  torch's CUDA
// reductions over [E, n] choose their thread layout from E, so a member's
// sum rounds differently in folds of other widths.  Here the order of
// every row's additions is fixed by n and the block size alone: one block
// a row, BLOCK threads, thread t adds lanes t, t + BLOCK, t + 2 BLOCK, ...
// in that order, then the block adds the BLOCK partial sums along a fixed
// tree in shared memory.  Nothing depends on the number of rows or on a
// row's index, so a member's sum has the same bits in a fold of any width
// and as a lone run.
//
// The product with the mask is rounded before it is added (__fmul_rn /
// __dmul_rn: no fused multiply-add), as torch's x * mask then sum rounds
// it.
//
// What bounds it on the H100: bytes.  Each input value is read once and
// does one add; at [8, 3584] that is 115 KB (0.03 us at 3.35 TB/s), so
// the launch itself, a few microseconds, is what a call costs.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
member_sum_kernel(const T* __restrict__ x, const T* __restrict__ mask,
                  long long mask_stride, long long n, T* __restrict__ out) {
  __shared__ T part[BLOCK];
  const long long row = blockIdx.x;
  const T* xr = x + row * n;
  const T* mr = mask ? mask + row * mask_stride : nullptr;
  T acc = T(0);
  if (mr) {
    for (long long j = threadIdx.x; j < n; j += BLOCK)
      acc += mul_rn(xr[j], mr[j]);
  } else {
    for (long long j = threadIdx.x; j < n; j += BLOCK) acc += xr[j];
  }
  part[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int s = BLOCK / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[row] = part[0];
}

template <typename T>
int launch(const void* x, const void* mask, long long mask_stride,
           long long rows, long long n, void* out, void* stream) {
  if (rows <= 0) return 0;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  member_sum_kernel<T><<<(unsigned)rows, BLOCK, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)mask, mask_stride, n, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, n] float32, mask null or [rows, n] (mask_stride n) or one [n]
// row for every row (mask_stride 0); out [rows].
int member_sum_f32_launch(const void* x, const void* mask,
                          long long mask_stride, long long rows, long long n,
                          void* out, void* stream) {
  return launch<float>(x, mask, mask_stride, rows, n, out, stream);
}

// The same in float64.
int member_sum_f64_launch(const void* x, const void* mask,
                          long long mask_stride, long long rows, long long n,
                          void* out, void* stream) {
  return launch<double>(x, mask, mask_stride, rows, n, out, stream);
}

const char* mdqt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
