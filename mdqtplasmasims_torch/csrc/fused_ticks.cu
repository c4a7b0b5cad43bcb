// One MD step of quantum-substepped ticks, all ions in one launch
// (mdqtplasmasims_torch/core/qt_fused.py wraps it).
//
// Replaces the TPU kernel mdqtplasmasims_tpu/core/qt_fused.py:
// _make_kernel, in its explicit-rolls form and in its internal_rng form
// (uniforms drawn inside the kernel, see RNG below).  Per ion and tick: leapfrog
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
// [n_ticks*5, Np], or drawn in the kernel (RNG).  IEEE f32 throughout (no
// fast math).
//
// RNG (template flag; the JAX kernel's internal_rng, which uses the TPU's
// hardware PRNG, qt_fused.py:111-130, :251-260): the TPU's bits cannot be
// matched, so the port defines its own counter-based stream
// (mdqtplasmasims_torch/core/rng.py is its plain twin).  Threefry-2x32-20
// (Random123) with key (seed word, 0), the word a [1] int32 device tensor
// drawn once per run and read here through its pointer (no host sync), and
// counter (global lane n, 3*tick + j), j = 0, 1, 2, tick the absolute run
// tick tick_base + i and n = lane0 + the lane within the launch (lane0 is
// the first lane a mesh slot holds in its fold's global lane numbering, 0
// for an unsharded fold, so slots launched apart draw the streams their
// lanes would draw in one launch): words 0-4 of the three outputs are r0..r4, each the
// top 24 bits times 2^-24, so u < 1 (the collapse relies on it against the
// saturated pad rows).  The stream depends on neither THREADS, the block
// index nor how a fold's lanes are split between launches.  The draw sits after the RK step and the Ehrenfest sum, so its
// words are not live across the unrolled state loops; the jump test r0 <
// h*dp0 still uses the tick's initial amplitudes.  Each tick costs three
// Threefry calls (60 rounds of add/rotate/xor) and saves the five 4-byte
// loads per ion of the rolls plus the torch.rand launch that wrote them
// (125 x Np x 4 B per MD step written and read back).
//
// Sweep variants (the JAX kernel's per_lane_e0 / per_lane_om flags), two
// template flags instantiated for S=12 only (sr12 is the one scheme that
// folds sweeps):
//   PE0  the diagonal energies come from an [SP, Np] lane plane (each
//        ensemble member's detunings) instead of the vecs column;
//   POM  H = om*C_sp + om_dp*C_dp + diag with (om, om_dp) from an [2, Np]
//        lane plane: C_sp is table block 0, C_dp a fifth [SP, SP] block;
//        the beat-note terms are the DP pattern's, scaled by om_dp; the
//        Ehrenfest terms carry a group tag (0: SP, scaled by om; 1: DP,
//        scaled by om_dp; sr12 has 4 + 8 of them) and are summed per group.
// The lane values are constant across the ticks.  Each block stages them
// once in shared memory ([S][THREADS] e0 and [2][THREADS] om planes); the
// tick loop reads e0 from there rather than holding 12 more values per
// thread in the already full register file, and om, om_dp ride in two
// registers.  Shared memory is (SP*8 + 5*SP*SP + (S+2)*THREADS) floats at
// most: 12.5 KiB for sr12.
//
// Registers (nvcc 12.8 -O3 -Xptxas -v, sm_90a): S=12 (sr12, the main
// path) 255 per thread with 208 B spill stores / 352 B spill loads; S=7
// 128, S=5 96, S=3 72.  Sweep variants (S=12, all at 255 registers):
// PE0 208 / 328 B, POM 1224 / 2048 B, PE0+POM 1200 / 2028 B of spill
// stores / loads: the second matvec of POM overflows the register file
// and runs ~1.75x the plain variant's time.  The RNG forms (255 registers
// each) spill a little less than their explicit counterparts: plain 192 /
// 336 B, PE0 192 / 300 B, POM 1112 / 1972 B, PE0+POM 1172 / 2000 B.  The
// S=12 spills (likely the loop-invariant coupling loads hoisted into
// registers across ticks) are the second thing a performance change
// should look at.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define MAX_TDEP 4
#define MAX_FORCE 16

struct FusedParams {
  int S, SP, n_ticks, n_tdep, n_force;
  int apply_kick, apply_recoil, renormalize, has_exp;
  int per_lane_e0, per_lane_om, internal_rng;
  float h, half_h, h8, qdt, half_qdt, p2q, g2e, L;
  float exp_c1, exp_c2, tdep_freq, branch_d, kick_s, kick_d;
  int tdep_row[MAX_TDEP], tdep_col[MAX_TDEP];
  float tdep_coef[MAX_TDEP];
  int force_a[MAX_FORCE], force_b[MAX_FORCE], force_g[MAX_FORCE];
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

// Threefry-2x32 with 20 rounds (Random123's threefry2x32_R(20)): the
// counter (x0, x1) is encrypted in place under the key (k0, k1)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int r = 0; r < 20; ++r) {
    x0 += x1;
    x1 = (x1 << rot[r % 8]) | (x1 >> (32 - rot[r % 8]));
    x1 ^= x0;
    if (r % 4 == 3) {          // key injection after every 4 rounds
      const int s = r / 4 + 1;
      x0 += ks[s % 3];
      x1 += ks[(s + 1) % 3] + (uint32_t)s;
    }
  }
}

// top 24 bits of a word as a uniform in [0, 1)
__device__ __forceinline__ float unit24(uint32_t w) {
  return (float)(w >> 8) * 5.9604644775390625e-08f;   // 2^-24
}

__device__ __forceinline__ float wrap(float r, float L) {
  r = (r < 0.f) ? r + L : r;
  return (r > L) ? r - L : r;
}

// The per-lane planes of a thread: e0[s * THREADS] (PE0), om/omdp (POM)
struct LaneVals {
  const float* e0;
  float om, omdp;
};

// One RK slope of the renormalized propagator at stage input (sa, sb):
// k = (pref * (phi - i h H phi) - phi) / h, pref = rsqrt(1 - clip(dp)).
template <int S, bool PE0, bool POM>
__device__ __forceinline__ void g_slope(const FusedParams& p,
                                        const float* __restrict__ vec,
                                        const float* __restrict__ C,
                                        const float* __restrict__ Cdp, int SP,
                                        const LaneVals& lv,
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
    if (POM) {   // om * (C_sp phi) + om_dp * (C_dp phi)
      float dra = 0.f, drb = 0.f;
#pragma unroll
      for (int c = 0; c < S; ++c) {
        const float m = Cdp[r * SP + c];
        dra += m * sa[c];
        drb += m * sb[c];
      }
      hra = lv.om * hra + lv.omdp * dra;
      hrb = lv.om * hrb + lv.omdp * drb;
    }
    const float e0 = PE0 ? lv.e0[r * THREADS] : vec[r * 8 + 1];
    const float diag = e0 + vec[r * 8 + 2] * u;
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
    const float m = POM ? lv.omdp * p.tdep_coef[k] : p.tdep_coef[k];
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

template <int S, bool PE0, bool POM, bool RNG>
__global__ void __launch_bounds__(THREADS)
fused_ticks_kernel(const FusedParams p, const float* __restrict__ R,
                   const float* __restrict__ V, const float* __restrict__ F,
                   const float* __restrict__ tp_in,
                   const float* __restrict__ pre,
                   const float* __restrict__ pim,
                   const float* __restrict__ rolls,
                   const int* __restrict__ seed,
                   const float* __restrict__ e0_lanes,
                   const float* __restrict__ om_lanes,
                   const float* __restrict__ vecs,
                   const float* __restrict__ mats, float* __restrict__ Ro,
                   float* __restrict__ Vo, float* __restrict__ tpo,
                   float* __restrict__ preo, float* __restrict__ pimo,
                   int npad, float first, float tick0, uint32_t tick_base,
                   uint32_t lane0) {
  extern __shared__ float smem[];
  const int SP = p.SP;
  const int n_tab = SP * 8 + (POM ? 5 : 4) * SP * SP;
  for (int k = threadIdx.x; k < n_tab; k += THREADS)
    smem[k] = (k < SP * 8) ? vecs[k] : mats[k - SP * 8];
  const float* vec = smem;                       // [SP, 8]
  const float* C = smem + SP * 8;                // [SP, SP]
  const float* cumS = C + SP * SP;               // [dest, src]
  const float* cumD = cumS + SP * SP;
  const float* Cdp = C + 4 * SP * SP;            // [SP, SP] (POM only)

  const int n = blockIdx.x * THREADS + threadIdx.x;   // npad % THREADS == 0
  // this block's lane planes: e0 [S][THREADS], then (om, om_dp) [2][THREADS]
  float* lanes = smem + n_tab;
  if (PE0) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      lanes[s * THREADS + threadIdx.x] = e0_lanes[(size_t)s * npad + n];
  }
  float* oml = lanes + (PE0 ? S * THREADS : 0);
  if (POM) {
    oml[threadIdx.x] = om_lanes[n];
    oml[THREADS + threadIdx.x] = om_lanes[npad + n];
  }
  __syncthreads();
  LaneVals lv;
  lv.e0 = lanes + threadIdx.x;
  lv.om = POM ? oml[threadIdx.x] : 1.f;
  lv.omdp = POM ? oml[THREADS + threadIdx.x] : 1.f;
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
  const uint32_t key = RNG ? (uint32_t)seed[0] : 0u;

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
    float r0 = 0.f, r1 = 0.f, r2 = 0.f, r3 = 0.f, r4 = 0.f;
    if constexpr (!RNG) {
      const float* rl = rolls + (size_t)(i * 5) * npad + n;
      r0 = rl[0];
      r1 = rl[npad];
      r2 = rl[2 * npad];
      r3 = rl[3 * npad];
      r4 = rl[4 * npad];
    }

    float dp0 = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) dp0 += vec[s * 8] * (a[s] * a[s] + b[s] * b[s]);

    // ---- RK step: acc = k1 + 3 k2 + 3 k3 + k4 ----
    float acca[S], accb[S], ka[S], kb[S], sa[S], sb[S];
    g_slope<S, PE0, POM>(p, vec, C, Cdp, SP, lv, a, b, u, cphi, sphi, ka, kb);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acca[s] = ka[s];
      accb[s] = kb[s];
      sa[s] = a[s] + p.half_h * ka[s];
      sb[s] = b[s] + p.half_h * kb[s];
    }
    g_slope<S, PE0, POM>(p, vec, C, Cdp, SP, lv, sa, sb, u, cphi, sphi, ka,
                         kb);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acca[s] = acca[s] + 3.f * ka[s];
      accb[s] = accb[s] + 3.f * kb[s];
      sa[s] = a[s] + p.half_h * ka[s];
      sb[s] = b[s] + p.half_h * kb[s];
    }
    g_slope<S, PE0, POM>(p, vec, C, Cdp, SP, lv, sa, sb, u, cphi, sphi, ka,
                         kb);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acca[s] = acca[s] + 3.f * ka[s];
      accb[s] = accb[s] + 3.f * kb[s];
      sa[s] = a[s] + p.h * ka[s];
      sb[s] = b[s] + p.h * kb[s];
    }
    g_slope<S, PE0, POM>(p, vec, C, Cdp, SP, lv, sa, sb, u, cphi, sphi, ka,
                         kb);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acca[s] = acca[s] + ka[s];
      accb[s] = accb[s] + kb[s];
    }

    // ---- Ehrenfest kick from the initial amplitudes:
    // Im(psi_a conj(psi_b)) = b_a a_b - a_a b_b
    // (POM: summed per group, SP terms x om and DP terms x om_dp)
    float kick_nj = 0.f, kick_dp = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_FORCE; ++k) {
      if (k >= p.n_force) break;
      const int fa = p.force_a[k], fb = p.force_b[k];
      const float term = p.force_w[k] * (pick(b, fa) * pick(a, fb) -
                                         pick(a, fa) * pick(b, fb));
      if (POM && p.force_g[k])
        kick_dp = kick_dp + term;
      else
        kick_nj = kick_nj + term;
    }
    if (POM) kick_nj = lv.om * kick_nj + lv.omdp * kick_dp;
    kick_nj = kick_nj * p.h;

    if constexpr (RNG) {   // this tick's uniforms from the counter stream
      const uint32_t c1 = 3u * (tick_base + (uint32_t)i);
      const uint32_t gl = lane0 + (uint32_t)n;   // global lane
      uint32_t x0 = gl, x1 = c1;
      threefry2x32(key, 0u, x0, x1);
      r0 = unit24(x0);
      r1 = unit24(x1);
      x0 = gl;
      x1 = c1 + 1u;
      threefry2x32(key, 0u, x0, x1);
      r2 = unit24(x0);
      r3 = unit24(x1);
      x0 = gl;
      x1 = c1 + 2u;
      threefry2x32(key, 0u, x0, x1);
      r4 = unit24(x0);
    }
    const bool jumped = r0 < p.h * dp0;       // unclipped dp, strict <

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

// rolls [n_ticks*5, npad] (explicit form) or seed [1] (internal_rng form;
// tick_base is then the absolute run tick at entry and lane0 the global
// lane of lane 0)
int fused_ticks_launch(const FusedParams* p, const float* R, const float* V,
                       const float* F, const float* tp, const float* pre,
                       const float* pim, const float* rolls, const int* seed,
                       const float* e0_lanes, const float* om_lanes,
                       const float* vecs, const float* mats, float* Ro,
                       float* Vo, float* tpo, float* preo, float* pimo,
                       int npad, float first, float tick0, unsigned tick_base,
                       unsigned lane0, void* stream) {
  const int pe0 = p->per_lane_e0 != 0, pom = p->per_lane_om != 0;
  const int rng = p->internal_rng != 0;
  if (npad <= 0 || npad % THREADS != 0 || p->n_ticks < 1 ||
      p->n_tdep > MAX_TDEP || p->n_force > MAX_FORCE || p->SP < p->S ||
      (pe0 && !e0_lanes) || (pom && !om_lanes) || (rng && !seed) ||
      (!rng && !rolls))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(p->SP * 8 + (pom ? 5 : 4) * p->SP * p->SP +
               ((pe0 ? p->S : 0) + (pom ? 2 : 0)) * THREADS) *
      sizeof(float);
  const dim3 grid(npad / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(SV, E0, OM, RG)                                          \
  fused_ticks_kernel<SV, E0, OM, RG><<<grid, THREADS, smem, st>>>(      \
      *p, R, V, F, tp, pre, pim, rolls, seed, e0_lanes, om_lanes, vecs, \
      mats, Ro, Vo, tpo, preo, pimo, npad, first, tick0, tick_base, lane0)
  // the RNG form is built for sr12 (the cooling family) only
  switch (p->S * 8 + rng * 4 + pe0 * 2 + pom) {
    case 3 * 8: LAUNCH(3, false, false, false); break;
    case 5 * 8: LAUNCH(5, false, false, false); break;
    case 7 * 8: LAUNCH(7, false, false, false); break;
    case 12 * 8: LAUNCH(12, false, false, false); break;
    case 12 * 8 + 2: LAUNCH(12, true, false, false); break;
    case 12 * 8 + 1: LAUNCH(12, false, true, false); break;
    case 12 * 8 + 3: LAUNCH(12, true, true, false); break;
    case 12 * 8 + 4: LAUNCH(12, false, false, true); break;
    case 12 * 8 + 6: LAUNCH(12, true, false, true); break;
    case 12 * 8 + 5: LAUNCH(12, false, true, true); break;
    case 12 * 8 + 7: LAUNCH(12, true, true, true); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

const char* mdqt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
