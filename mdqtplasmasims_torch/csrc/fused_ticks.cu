// One MD step of quantum-substepped ticks, all ions in one launch
// (mdqtplasmasims_torch/core/qt_fused.py wraps it).
//
// Replaces the TPU kernel mdqtplasmasims_tpu/core/qt_fused.py:
// _make_kernel (its explicit-rolls variant).  Per ion and tick: leapfrog
// substep with fixed forces (2nd-order first drift at tick 0 of the run,
// single +-L wrap after each half drift); clock tp += qdt; Doppler u (+
// expansion detuning at (tick0+i)*qdt); beat-note phase from the advanced
// clock; jump test r0 < dp0 on the unclipped dp; one RK step of the
// renormalized non-Hermitian propagator (stages at a+h/2 k1, a+h/2 k2,
// a+h k3, weights (k1+3k2+3k3+k4) h/8, stage dp clipped to [0, 0.9]);
// Ehrenfest kick from the tick's initial amplitudes (non-jumped ions);
// jump collapse (cumulative source sum, categorical source, S/D branch,
// categorical destination over tables whose pad rows are saturated to 1,
// +-recoil, tp = 0); optional renormalization guarded for zero norms.
//
// What bounds it on the H100: per ion and tick about 4000 dependent FP32
// operations (four 12x12 real matvecs per RK stage pair, the beat-note and
// force terms) with only a few bytes of state traffic, so it is bound by
// each thread's chain of dependent FP32 instructions.  At the flagship
// Np=3584 one thread per ion is 28 blocks of 128 threads on 132 SMs: the
// card is mostly idle.
// Spreading one ion's states over several lanes (or batching ensembles
// along the lane axis) to fill the SMs is the first thing a performance
// change should attack.
//
// Design: one thread per ion keeps R, V, F, tp and its S (re, im)
// amplitudes plus the RK stage vectors in registers (S is a template
// parameter, so the state loops unroll; runtime-indexed terms use
// select loops rather than indexing register arrays).  The level tables
// (vecs [SP,8], mats [4SP,SP]) are staged in shared memory once per
// block; the beat-note and force term lists ride in the by-value
// parameter block.  Uniforms are read from the explicit rolls
// [n_ticks*5, Np].  IEEE f32 throughout (no fast math).
//
// Registers (nvcc 12.8 -O3 -Xptxas -v, sm_90a): S=12 (sr12, the main
// path) 255 per thread with 208 B spill stores / 352 B spill loads; S=7
// 128, S=5 96, S=3 72.  The S=12 spills (likely the loop-invariant
// coupling loads hoisted into registers across ticks) are the second
// thing a performance change should look at.
#include <cuda_runtime.h>

#define THREADS 128
#define MAX_TDEP 4
#define MAX_FORCE 16

struct FusedParams {
  int S, SP, n_ticks, n_tdep, n_force;
  int apply_kick, apply_recoil, renormalize, has_exp;
  float h, half_h, h8, qdt, half_qdt, p2q, g2e, L;
  float exp_c1, exp_c2, tdep_freq, branch_d, kick_s, kick_d;
  int tdep_row[MAX_TDEP], tdep_col[MAX_TDEP];
  float tdep_coef[MAX_TDEP];
  int force_a[MAX_FORCE], force_b[MAX_FORCE];
  float force_w[MAX_FORCE];
};

// x[k] for a runtime k without indexing a register array
template <int S>
__device__ __forceinline__ float pick(const float (&x)[S], int k) {
  float v = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) v = (s == k) ? x[s] : v;
  return v;
}

template <int S>
__device__ __forceinline__ void add_at(float (&x)[S], int k, float v) {
#pragma unroll
  for (int s = 0; s < S; ++s) x[s] = (s == k) ? x[s] + v : x[s];
}

__device__ __forceinline__ float wrap(float r, float L) {
  r = (r < 0.f) ? r + L : r;
  return (r > L) ? r - L : r;
}

// One RK slope of the renormalized propagator at stage input (sa, sb):
// k = (pref * (phi - i h H phi) - phi) / h, pref = rsqrt(1 - clip(dp)).
template <int S>
__device__ __forceinline__ void g_slope(const FusedParams& p,
                                        const float* __restrict__ vec,
                                        const float* __restrict__ C, int SP,
                                        const float (&sa)[S],
                                        const float (&sb)[S], float u,
                                        float cphi, float sphi, float (&ka)[S],
                                        float (&kb)[S]) {
  float dp = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) dp += vec[s * 8] * (sa[s] * sa[s] + sb[s] * sb[s]);
  dp = p.h * dp;
  const float pref = rsqrtf(1.f - fminf(fmaxf(dp, 0.f), 0.9f));
  // H phi = (C + diag(e0 + e1 u) - i/2 diag(w)) phi  (+ beat-note terms)
  float re[S], im[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    float hra = 0.f, hrb = 0.f;
#pragma unroll
    for (int c = 0; c < S; ++c) {
      const float m = C[r * SP + c];
      hra += m * sa[c];
      hrb += m * sb[c];
    }
    const float diag = vec[r * 8 + 1] + vec[r * 8 + 2] * u;
    hra += diag * sa[r];
    hrb += diag * sb[r];
    const float hw = -0.5f * vec[r * 8];
    re[r] = hra - hw * sb[r];
    im[r] = hrb + hw * sa[r];
  }
  // H[r,c] = m e^{i phi}, H[c,r] = m e^{-i phi}
  // (constant trip counts keep the parameter-block reads at fixed offsets)
#pragma unroll
  for (int k = 0; k < MAX_TDEP; ++k) {
    if (k >= p.n_tdep) break;
    const int r = p.tdep_row[k], c = p.tdep_col[k];
    const float m = p.tdep_coef[k];
    const float ar = pick(sa, r), br = pick(sb, r);
    const float ac = pick(sa, c), bc = pick(sb, c);
    add_at(re, r, m * (cphi * ac - sphi * bc));
    add_at(im, r, m * (cphi * bc + sphi * ac));
    add_at(re, c, m * (cphi * ar + sphi * br));
    add_at(im, c, m * (cphi * br - sphi * ar));
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    ka[s] = (pref * (sa[s] + p.h * im[s]) - sa[s]) / p.h;
    kb[s] = (pref * (sb[s] - p.h * re[s]) - sb[s]) / p.h;
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS)
fused_ticks_kernel(const FusedParams p, const float* __restrict__ R,
                   const float* __restrict__ V, const float* __restrict__ F,
                   const float* __restrict__ tp_in,
                   const float* __restrict__ pre,
                   const float* __restrict__ pim,
                   const float* __restrict__ rolls,
                   const float* __restrict__ vecs,
                   const float* __restrict__ mats, float* __restrict__ Ro,
                   float* __restrict__ Vo, float* __restrict__ tpo,
                   float* __restrict__ preo, float* __restrict__ pimo,
                   int npad, float first, float tick0) {
  extern __shared__ float smem[];
  const int SP = p.SP;
  const int n_tab = SP * 8 + 4 * SP * SP;
  for (int k = threadIdx.x; k < n_tab; k += THREADS)
    smem[k] = (k < SP * 8) ? vecs[k] : mats[k - SP * 8];
  __syncthreads();
  const float* vec = smem;                       // [SP, 8]
  const float* C = smem + SP * 8;                // [SP, SP]
  const float* cumS = C + SP * SP;               // [dest, src]
  const float* cumD = cumS + SP * SP;

  const int n = blockIdx.x * THREADS + threadIdx.x;   // npad % THREADS == 0
  float x = R[n], y = R[npad + n], z = R[2 * npad + n];
  float vx = V[n], vy = V[npad + n], vz = V[2 * npad + n];
  const float fx = F[n], fy = F[npad + n], fz = F[2 * npad + n];
  float tp = tp_in[n];
  float a[S], b[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a[s] = pre[s * npad + n];
    b[s] = pim[s * npad + n];
  }
  const float hq = p.half_qdt, L = p.L;

  for (int i = 0; i < p.n_ticks; ++i) {
    // ---- leapfrog substep (forces fixed) ----
    const float fsq = (((first > 0.f && i == 0) ? 1.f : 0.f) * hq) * hq;
    x = wrap(x + hq * vx + fsq * fx, L);
    y = wrap(y + hq * vy + fsq * fy, L);
    z = wrap(z + hq * vz + fsq * fz, L);
    vx = vx + p.qdt * fx;
    vy = vy + p.qdt * fy;
    vz = vz + p.qdt * fz;
    x = wrap(x + hq * vx + fsq * fx, L);
    y = wrap(y + hq * vy + fsq * fy, L);
    z = wrap(z + hq * vz + fsq * fz, L);

    // ---- quantum tick: the clock advances before the beat note ----
    tp = tp + p.qdt;
    float u = vx * p.p2q;
    if (p.has_exp) {
      const float tpl = (tick0 + (float)i) * p.qdt;
      u = u + (p.exp_c1 * tpl) * rsqrtf(1.f + p.exp_c2 * tpl * tpl);
    }
    float cphi = 0.f, sphi = 0.f;
    if (p.n_tdep > 0) sincosf((p.tdep_freq * u) * (tp * p.g2e), &sphi, &cphi);
    const float* rl = rolls + (size_t)(i * 5) * npad + n;
    const float r0 = rl[0], r1 = rl[npad], r2 = rl[2 * npad],
                r3 = rl[3 * npad], r4 = rl[4 * npad];

    float dp0 = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) dp0 += vec[s * 8] * (a[s] * a[s] + b[s] * b[s]);
    const bool jumped = r0 < p.h * dp0;

    // ---- RK step: acc = k1 + 3 k2 + 3 k3 + k4 ----
    float acca[S], accb[S], ka[S], kb[S], sa[S], sb[S];
    g_slope<S>(p, vec, C, SP, a, b, u, cphi, sphi, ka, kb);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acca[s] = ka[s];
      accb[s] = kb[s];
      sa[s] = a[s] + p.half_h * ka[s];
      sb[s] = b[s] + p.half_h * kb[s];
    }
    g_slope<S>(p, vec, C, SP, sa, sb, u, cphi, sphi, ka, kb);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acca[s] = acca[s] + 3.f * ka[s];
      accb[s] = accb[s] + 3.f * kb[s];
      sa[s] = a[s] + p.half_h * ka[s];
      sb[s] = b[s] + p.half_h * kb[s];
    }
    g_slope<S>(p, vec, C, SP, sa, sb, u, cphi, sphi, ka, kb);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acca[s] = acca[s] + 3.f * ka[s];
      accb[s] = accb[s] + 3.f * kb[s];
      sa[s] = a[s] + p.h * ka[s];
      sb[s] = b[s] + p.h * kb[s];
    }
    g_slope<S>(p, vec, C, SP, sa, sb, u, cphi, sphi, ka, kb);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acca[s] = acca[s] + ka[s];
      accb[s] = accb[s] + kb[s];
    }

    // ---- Ehrenfest kick from the initial amplitudes:
    // Im(psi_a conj(psi_b)) = b_a a_b - a_a b_b
    float kick_nj = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_FORCE; ++k) {
      if (k >= p.n_force) break;
      const int fa = p.force_a[k], fb = p.force_b[k];
      kick_nj = kick_nj + p.force_w[k] * (pick(b, fa) * pick(a, fb) -
                                           pick(a, fa) * pick(b, fb));
    }
    kick_nj = kick_nj * p.h;

    // ---- jump collapse ----
    float cum[S];
    float run = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      run = run + (a[s] * a[s] + b[s] * b[s]) * vec[s * 8 + 3];
      cum[s] = run;
    }
    const float tot = fmaxf(cum[S - 1], 1e-30f);
    int src = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) src += (r1 * tot >= cum[s]) ? 1 : 0;
    src = min(src, S - 1);
    const bool d_branch = r2 < p.branch_d;
    const float* dc = d_branch ? cumD : cumS;
    int dest = 0;
    for (int d = 0; d < S; ++d) dest += (r4 >= dc[d * SP + src]) ? 1 : 0;
    dest = min(dest, S - 1);
    const float kick_j =
        p.apply_recoil
            ? ((r3 < 0.5f) ? 1.f : -1.f) * (d_branch ? p.kick_d : p.kick_s)
            : 0.f;

    // ---- merge ----
#pragma unroll
    for (int s = 0; s < S; ++s) {
      a[s] = jumped ? ((s == dest) ? 1.f : 0.f) : a[s] + acca[s] * p.h8;
      b[s] = jumped ? 0.f : b[s] + accb[s] * p.h8;
    }
    tp = jumped ? 0.f : tp;
    if (p.renormalize) {
      float nn = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) nn += a[s] * a[s] + b[s] * b[s];
      const float nrm = sqrtf(nn);
      const float inv = (nrm > 0.f) ? 1.f / nrm : 0.f;   // pad lanes stay 0
#pragma unroll
      for (int s = 0; s < S; ++s) {
        a[s] = a[s] * inv;
        b[s] = b[s] * inv;
      }
    }
    if (p.apply_kick) vx = vx + (jumped ? kick_j : kick_nj);
  }

  Ro[n] = x;
  Ro[npad + n] = y;
  Ro[2 * npad + n] = z;
  Vo[n] = vx;
  Vo[npad + n] = vy;
  Vo[2 * npad + n] = vz;
  tpo[n] = tp;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    preo[s * npad + n] = a[s];
    pimo[s * npad + n] = b[s];
  }
  for (int s = S; s < SP; ++s) {     // pad rows stay exactly zero
    preo[s * npad + n] = 0.f;
    pimo[s * npad + n] = 0.f;
  }
}

extern "C" {

int fused_ticks_launch(const FusedParams* p, const float* R, const float* V,
                       const float* F, const float* tp, const float* pre,
                       const float* pim, const float* rolls,
                       const float* vecs, const float* mats, float* Ro,
                       float* Vo, float* tpo, float* preo, float* pimo,
                       int npad, float first, float tick0, void* stream) {
  if (npad <= 0 || npad % THREADS != 0 || p->n_ticks < 1 ||
      p->n_tdep > MAX_TDEP || p->n_force > MAX_FORCE || p->SP < p->S)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(p->SP * 8 + 4 * p->SP * p->SP) * sizeof(float);
  const dim3 grid(npad / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(SV)                                                          \
  fused_ticks_kernel<SV><<<grid, THREADS, smem, st>>>(                      \
      *p, R, V, F, tp, pre, pim, rolls, vecs, mats, Ro, Vo, tpo, preo, pimo, \
      npad, first, tick0)
  switch (p->S) {
    case 3: LAUNCH(3); break;
    case 5: LAUNCH(5); break;
    case 7: LAUNCH(7); break;
    case 12: LAUNCH(12); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

const char* mdqt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
