// Gaussian-KDE velocity distributions: out[r, b] = norm^-1 * sum_i k(r, b, i)
// for velocities v [rows, n] onto bins [B], with
//   k = exp(c (b - v_i)^2) [+ exp(c (b + v_i)^2) folded] [* w_i weighted],
// c = -1/(2 width^2); one row per member and axis (a fold's sample is E x 3
// rows).  mdqtplasmasims_torch/ops/kde.py wraps it.
//
// Replaces no TPU kernel: the JAX package leaves the KDE to XLA, which
// writes the [B, n] kernel matrix of each row through memory.  Here it
// never leaves the registers: a block holds BINS bins of one row, its
// threads split the row's ions into GROUPS groups (ion i to group i mod
// GROUPS), the ions are staged through shared memory TILE at a time, and
// each thread adds its bin's terms of its group's ions in increasing order.
// The GROUPS partial sums of a bin are then added in group order.  That
// order is fixed by n alone: nothing depends on the number of rows or on a
// row's index, and nothing is added atomically, so a member's bins have
// the same bits in a fold of any width and as a lone run.  The output
// [rows, B] is all that is written.
//
// Each term is the plain torch version's float32 expression (ops/kde.py):
// d = b - v; (c d) d; expf (the IEEE-accurate one: no --use_fast_math, no
// __expf); the folded term added; the product with the weight rounded
// before it is added (__fmul_rn: no fused multiply-add); the sum divided
// by the normalisation when asked.  The tails of the Gaussian are not cut:
// every ion meets every bin.
//
// What bounds it on the H100: FP32 work.  Per row, bin and ion: 2 expf
// and 8 other FP32 operations folded (1 expf and 4 plain), one more with
// weights; at [297, 3500] x 2001 bins (the 99-member fold's sample) that
// is 2.1e9 terms, each expf several instructions on the FMA pipes and one
// on the special-function unit.

#include <cuda_runtime.h>

namespace {

constexpr int BINS = 64;                 // bins a block
constexpr int GROUPS = 4;                // ion groups a block
constexpr int BLOCK = BINS * GROUPS;     // threads a block
constexpr int TILE = 1024;               // ions staged at a time

static_assert(TILE % GROUPS == 0, "a tile keeps each ion in its group");

template <bool FOLDED, bool WEIGHTED>
__global__ void __launch_bounds__(BLOCK)
kde_kernel(const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ bins, long long n, int nbins,
           float c, float norm, int normalize, float* __restrict__ out) {
  __shared__ float sv[TILE];
  __shared__ float sw[WEIGHTED ? TILE : 1];
  __shared__ float part[GROUPS][BINS];
  const int j = threadIdx.x % BINS;
  const int g = threadIdx.x / BINS;      // warp-uniform: reads broadcast
  const long long row = blockIdx.x;
  const int bin = blockIdx.y * BINS + j;
  const float b = bin < nbins ? bins[bin] : 0.0f;
  const float* vr = v + row * n;
  const float* wr = WEIGHTED ? w + row * n : nullptr;
  float acc = 0.0f;
  for (long long base = 0; base < n; base += TILE) {
    const int len = (int)(n - base < TILE ? n - base : TILE);
    __syncthreads();                     // the last tile is read
    for (int i = threadIdx.x; i < len; i += BLOCK) {
      sv[i] = vr[base + i];
      if (WEIGHTED) sw[i] = wr[base + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int i = g; i < len; i += GROUPS) {
      const float x = sv[i];
      const float d = b - x;
      float k = expf(__fmul_rn(c, d) * d);
      if (FOLDED) {
        const float s = b + x;
        k = k + expf(__fmul_rn(c, s) * s);
      }
      if (WEIGHTED) k = __fmul_rn(k, sw[i]);
      acc = acc + k;
    }
  }
  part[g][j] = acc;
  __syncthreads();
  if (g == 0 && bin < nbins) {
    float s = part[0][j];
#pragma unroll
    for (int q = 1; q < GROUPS; ++q) s = s + part[q][j];
    out[row * nbins + bin] = normalize ? s / norm : s;
  }
}

template <bool FOLDED, bool WEIGHTED>
int launch(const float* v, const float* w, const float* bins, long long rows,
           long long n, int nbins, float c, float norm, int normalize,
           float* out, cudaStream_t stream) {
  const dim3 grid((unsigned)rows, (unsigned)((nbins + BINS - 1) / BINS));
  kde_kernel<FOLDED, WEIGHTED><<<grid, BLOCK, 0, stream>>>(
      v, w, bins, n, nbins, c, norm, normalize, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// v [rows, n] float32, w null or [rows, n], bins [nbins]; out [rows, nbins].
// c = -1/(2 width^2), norm the divisor applied when normalize is nonzero.
int kde_f32_launch(const void* v, const void* w, const void* bins,
                   long long rows, long long n, int nbins, int folded,
                   float c, float norm, int normalize, void* out,
                   void* stream) {
  if (rows <= 0 || nbins <= 0) return 0;
  if (rows > 0x7fffffffLL || (nbins + BINS - 1) / BINS > 65535)
    return (int)cudaErrorInvalidValue;
  const float* vf = (const float*)v;
  const float* wf = (const float*)w;
  const float* bf = (const float*)bins;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (folded) {
    return wf ? launch<true, true>(vf, wf, bf, rows, n, nbins, c, norm,
                                   normalize, of, s)
              : launch<true, false>(vf, wf, bf, rows, n, nbins, c, norm,
                                    normalize, of, s);
  }
  return wf ? launch<false, true>(vf, wf, bf, rows, n, nbins, c, norm,
                                  normalize, of, s)
            : launch<false, false>(vf, wf, bf, rows, n, nbins, c, norm,
                                   normalize, of, s);
}

const char* mdqt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
