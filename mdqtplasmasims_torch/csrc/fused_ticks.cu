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
// What bounds it on the H100: neither bytes nor the FP32 peak.  A launch
// moves ~0.5 MB and an ion's tick is a chain of some 2000 cycles of
// dependent FP32, shuffle and integer instructions (four RK slopes, each a
// reduction over the states and a reciprocal square root; twenty Threefry
// rounds; a sincosf).  The TPU kernel runs that chain over (8,
// 128) tiles of ions with dense S x S products on the vector unit; one
// thread per ion, its first translation, left 104 of the card's 132 SMs
// empty at 3584 ions, one warp on each busy scheduler, 255 registers and
// spills.  So the time is set by how many warps each scheduler can switch
// between and by how many instructions a tick takes.
//
// Two designs.  At S = 3, 5 and 7 (the three-state toy: 1000 ions, 1000
// dependent ticks a launch; the tagging pumps: 3500-4096 ions, 22-62) one
// thread holds a whole ion, its sums are in-thread adds, the shared tables
// sit in the constant bank and the scheme's coupling pattern is compiled
// in; one warp's in-order instruction stream bounds it, not the card's
// rates (fused_ticks_ion_kernel below).
// At S = 12 G = 16 lanes of a warp own one ion (two ions a warp) and lane
// s of the group owns state s (lanes s >= S idle on zeros).  3584 ions
// are 1792 warps, 3.4 on each of the card's 528 schedulers.  A lane keeps
// its own amplitude, slope, stage and accumulator: a dozen floats where a
// thread kept seven arrays of 24.
//   * Sparse rows.  H reaches the kernel as per-row lists (the lane
//     table, built by the host from the packed table: K (column,
//     coefficient) entries in ascending column order, padded with (s, 0)).
//     Lane s loads its row once, before the tick loop, into registers, and
//     a slope's H phi is K x 2 shuffles and K x 4 FMAs (K = 3 for every
//     reference scheme).  Skipping the table's zeros in column order
//     leaves the dense sum's value.  A denser table (K > 3) takes the WIDE
//     instantiation, which keeps the lists in shared memory and loops over
//     them.
//   * The beat-note terms H[r,c] = m e^{i phi}, H[c,r] = m e^{-i phi} are
//     entries of rows r and c too: once a tick each lane forms its row's
//     complex coefficients (static + m cos phi, +-m sin phi), so a slope
//     fetches no amplitude twice.  The Ehrenfest terms sit on the same
//     pairs: lane s weights Im(psi_s conj(psi_c)) with the neighbours the
//     first slope fetched anyway, then one sum over the group.  The card
//     moves one warp shuffle per clock and SM, a quarter of the rate of
//     its other instructions, so a wide fold pays for shuffles before
//     FP32 operations: 46 a tick here (66 with the terms fetched apart;
//     every form 7-9 % faster for it).
//   * Sums over states (dp of each slope, the norm, the Ehrenfest sum) are
//     xor butterflies over the group, the cumulative source sum a scan,
//     the categorical counts ballots.  Every order depends on the lane's
//     index in its group only, so an ion's result depends on neither its
//     block, the half of the warp that holds it, lane0, nor how a fold is
//     cut into launches.
//   * Work that differs between lanes is dealt out: the leapfrog's three
//     axes to lanes 0-2, the three Threefry calls of a tick to lanes 0-2,
//     the explicit rolls r0-r3 to lanes 0-3.  Work that is the same for a
//     group (clock, phase, sincosf) every lane does: it costs a warp one
//     instruction stream either way.
//   * The collapse (scan, two table lookups, ballots) sits behind a warp
//     vote: it runs only in ticks in which an ion of the warp jumped.
//   * The per-lane forms need no shared planes: e0 is one register of lane
//     s, and the om forms' two patterns (C_sp, C_dp: disjoint parts of the
//     scheme's coupling) are one merged list whose coefficients om * c_sp +
//     om_dp * c_dp are formed once before the tick loop, so an om form
//     runs the plain form's instructions.
//   * Shared memory holds the two destination tables (transposed to [src]
//     [dest], so the lanes of a group read neighbouring words): 2 SP^2
//     floats, 2 KiB for sr12.  The planes are read and written directly:
//     a block's 8 ions fill one 32-byte sector per row.
//   * The slopes' division by the constant h is a multiplication by 1/h,
//     rounded once on the host: the eight IEEE divisions of a tick (each a
//     reciprocal, refinement steps and a range check) were half of all the
//     kernel executed (B'rng at 3584 lanes 0.079 ms with them, 0.044 ms
//     without, NVIDIA H100 80GB HBM3, 700 W).  A slope then differs from
//     the plain version's by at most one more rounding (1 ulp).
// IEEE f32 otherwise (no fast math).
//
// RNG (template flag; the JAX kernel's internal_rng, which uses the TPU's
// hardware PRNG, qt_fused.py:111-130, :251-260): the TPU's bits cannot be
// matched, so the port defines its own counter-based stream
// (mdqtplasmasims_torch/core/rng.py is its plain twin).  Threefry-2x32-20
// (Random123) with key (seed word, 0), the word a [1] int32 device tensor
// drawn once per run and read here through its pointer (no host sync), and
// counter (global lane n, 3*tick + j), j = 0, 1, 2, tick the absolute run
// tick tick_base + i and n = lane0 + the ion's lane within the launch's
// planes (lane0 is the first lane a mesh slot holds in its fold's global
// lane numbering, 0 for an unsharded fold, so slots launched apart draw the
// streams their lanes would draw in one launch): words 0-4 of the three
// outputs are r0..r4, each the top 24 bits times 2^-24, so u < 1 (the
// collapse relies on it against the saturated pad rows).  Lane j of the
// group computes call j; the words travel by shuffle.  The stream depends
// on neither the block size, the block index nor how a fold's lanes are
// split between launches.
//
// Sweep variants (the JAX kernel's per_lane_e0 / per_lane_om flags), two
// template flags instantiated for every state count (S=12: the cooling
// sweeps; S=3: the three-state sweeps; S=5 and 7: the tagging pumps'
// sweeps):
//   PE0  the diagonal energies come from an [SP, Np] lane plane (each
//        ensemble member's detunings) instead of the vecs column;
//   POM  H = om*C_sp + om_dp*C_dp + diag with (om, om_dp) from an [2, Np]
//        lane plane; the beat-note terms are the DP pattern's, scaled by
//        om_dp; the Ehrenfest terms carry a group tag (0: SP, scaled by
//        om; 1: DP, scaled by om_dp).
// The lane values are constant across the ticks.  The tagging and
// three-state sweeps vary (detuning, om) of one laser: e0 is the member's
// own diagonal, and the om form runs with the scheme's own coupling as the
// SP pattern, an empty DP pattern and (om_j / om_base, 0) on the lanes,
// so every coupling and Ehrenfest weight scales with om_j / om_base and a
// member at the base (scale 1) computes what the plain form computes.
//
// Free ions (the three-state toy) and the tagging pumps (a fixed vx, no
// force, no recoil) take the plain forms with F = 0 and a dummy R: the
// leapfrog then leaves v bit for bit (v + qdt * 0), and with apply_kick = 0
// nothing else writes it.  No template flag: the pumps' schemes have no
// force terms, so the forms are the same code.
//
// Registers, spills and shared memory of every form: nvcc -Xptxas -v, in
// the build log beside the library (chip_smoke.py prints them).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define THREADS 128
#define MAX_TDEP 4
#define MAX_FORCE 16
#define KREG 3            // row entries a lane keeps in registers
#define FULL 0xffffffffu

// The spec's constants (qt_fused.py's _Params mirrors it).  The term lists
// reach the kernel through the lane table.
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

// What the kernel reads of them, by value
struct TickConsts {
  int SP, n_ticks, n_tdep, K, W;
  int apply_kick, apply_recoil, renormalize, has_exp;
  float h, half_h, h8, qdt, half_qdt, p2q, g2e, L;
  float exp_c1, exp_c2, tdep_freq, branch_d, kick_s, kick_d;
  float inv_h;            // 1/h, rounded to f32 on the host
};

// A lane-table row holds K entries of lane s's row of H, as seven planes of
// K floats: the column c; the static coupling (c_sp | c_dp; without POM the
// scheme's own in c_sp); the beat-note coefficient m of H[s,c] = m e^{+-i
// phi} and m times the sign of its phase; the weight of the Ehrenfest term
// on the pair (s, c) and its group
#define ROW_PLANES 7
__host__ __device__ constexpr int lane_table_width(int K) {
  return ROW_PLANES * K;
}

// compile-time flags for the slope lambda
struct FirstSlope { static constexpr bool value = true; };
struct LaterSlope { static constexpr bool value = false; };

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

// Sum over the G lanes of a group, the same bits on every lane: an xor
// butterfly (a + b == b + a exactly, so both partners of a step agree)
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int m = G / 2; m >= 1; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// How many of a group's lanes (the G lanes from `base`) voted yes
template <int G>
__device__ __forceinline__ int group_count(bool yes, int base) {
  const unsigned all = __ballot_sync(FULL, yes);
  return __popc((all >> base) & ((G == 32) ? FULL : ((1u << G) - 1u)));
}

template <int S, int G, bool PE0, bool POM, bool RNG, bool WIDE>
__global__ void __launch_bounds__(THREADS)
fused_ticks_kernel(const TickConsts p, const float* __restrict__ R,
                   const float* __restrict__ V, const float* __restrict__ F,
                   const float* __restrict__ tp_in,
                   const float* __restrict__ pre,
                   const float* __restrict__ pim,
                   const float* __restrict__ rolls,
                   const int* __restrict__ seed,
                   const float* __restrict__ e0_lanes,
                   const float* __restrict__ om_lanes,
                   const float* __restrict__ vecs,
                   const float* __restrict__ mats,
                   const float* __restrict__ lane_tab,
                   float* __restrict__ Ro, float* __restrict__ Vo,
                   float* __restrict__ tpo, float* __restrict__ preo,
                   float* __restrict__ pimo, int npad, float first,
                   float tick0, uint32_t tick_base, uint32_t lane0) {
  static_assert(G >= S && G >= 4 && G <= 32 && (G & (G - 1)) == 0 &&
                    THREADS % G == 0,
                "a group holds one state per lane and at least r0..r3");
  extern __shared__ float smem[];
  const int SP = p.SP, K = p.K, W = p.W;
  float* cumS = smem;                    // [src, dest]
  float* cumD = smem + SP * SP;
  float* srow = cumD + SP * SP;          // the lane table (WIDE only)
  for (int k = threadIdx.x; k < SP * SP; k += THREADS) {
    const int src = k / SP, d = k % SP;  // mats blocks 1, 2 are [dest, src]
    cumS[k] = mats[(SP + d) * SP + src];
    cumD[k] = mats[(2 * SP + d) * SP + src];
  }
  if (WIDE)       // rows longer than KREG stay in shared memory
    for (int k = threadIdx.x; k < SP * W; k += THREADS) srow[k] = lane_tab[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int s = lane & (G - 1);                    // this lane's state
  const int base = lane & ~(G - 1);                // the group's first lane
  const int n = blockIdx.x * (THREADS / G) + threadIdx.x / G;   // the ion
  const bool live = s < S;

  // ---- this lane's constants (s < G <= SP: pad rows hold zeros) ----
  const float w = vecs[s * 8], e1 = vecs[s * 8 + 2], msk = vecs[s * 8 + 3];
  const float e0 = PE0 ? e0_lanes[(size_t)s * npad + n] : vecs[s * 8 + 1];
  const float hw = -0.5f * w;
  const float om = POM ? om_lanes[n] : 1.f;
  const float omdp = POM ? om_lanes[npad + n] : 1.f;
  const bool beat = p.n_tdep > 0;
  // Entry k of this lane's row, scaled for this ion (POM: SP parts x om, DP
  // parts x om_dp; the beat notes are the DP pattern's)
  auto entry = [&](const float* q, int k, int& c, float& m, float& t,
                   float& ts, float& fw) {
    c = base + (int)q[k];
    m = POM ? om * q[K + k] + omdp * q[2 * K + k] : q[K + k];
    t = POM ? omdp * q[3 * K + k] : q[3 * K + k];
    ts = POM ? omdp * q[4 * K + k] : q[4 * K + k];
    fw = POM ? ((q[6 * K + k] != 0.f) ? omdp : om) * q[5 * K + k]
             : q[5 * K + k];
  };
  int col[KREG];
  float coef[KREG], tm[KREG], tms[KREG], fwk[KREG];
#pragma unroll
  for (int k = 0; k < KREG; ++k) {
    col[k] = lane;
    coef[k] = tm[k] = tms[k] = fwk[k] = 0.f;
    if (!WIDE && k < K)
      entry(lane_tab + s * W, k, col[k], coef[k], tm[k], tms[k], fwk[k]);
  }

  // ---- state: lane s < 3 holds axis s of R, V, F; every lane the clock
  // and its own amplitude ----
  const bool axis = s < 3;
  const size_t ax = (size_t)min(s, 2) * npad + n;
  float r = axis ? R[ax] : 0.f;
  float v = axis ? V[ax] : 0.f;
  const float f = axis ? F[ax] : 0.f;
  float tp = tp_in[n];
  float a = live ? pre[(size_t)s * npad + n] : 0.f;
  float b = live ? pim[(size_t)s * npad + n] : 0.f;
  const float hq = p.half_qdt, L = p.L;
  const uint32_t key = RNG ? (uint32_t)seed[0] : 0u;

  for (int i = 0; i < p.n_ticks; ++i) {
    // explicit rolls: lanes 0-3 fetch r0-r3, every lane r4
    float roll_s = 0.f, roll_4 = 0.f;
    if constexpr (!RNG) {
      const float* rl = rolls + (size_t)(i * 5) * npad + n;
      roll_s = rl[(size_t)min(s, 3) * npad];
      roll_4 = rl[(size_t)4 * npad];
    }

    // ---- leapfrog substep (forces fixed), one axis a lane ----
    const float fsq = (((first > 0.f && i == 0) ? 1.f : 0.f) * hq) * hq;
    r = wrap(r + hq * v + fsq * f, L);
    v = v + p.qdt * f;
    r = wrap(r + hq * v + fsq * f, L);

    // ---- quantum tick: the clock advances before the beat note ----
    tp = tp + p.qdt;
    float u = __shfl_sync(FULL, v, base) * p.p2q;
    if (p.has_exp) {
      const float tpl = (tick0 + (float)i) * p.qdt;
      u = u + (p.exp_c1 * tpl) * rsqrtf(1.f + p.exp_c2 * tpl * tpl);
    }
    float cphi = 0.f, sphi = 0.f;
    if (p.n_tdep > 0) sincosf((p.tdep_freq * u) * (tp * p.g2e), &sphi, &cphi);
    const float diag = e0 + e1 * u;
    // this tick's row of H: static part + m e^{+-i phi}
    float cr[KREG], ci[KREG];
#pragma unroll
    for (int k = 0; k < KREG; ++k) {
      cr[k] = coef[k] + tm[k] * cphi;
      ci[k] = tms[k] * sphi;
    }

    // One RK slope of the renormalized propagator at stage input (sa, sb):
    // k = (pref * (phi - i h H phi) - phi) * (1/h), pref = rsqrt(1 - clip(dp)),
    // H phi = (C + diag(e0 + e1 u) - i/2 diag(w)) phi with the beat notes
    // in C.  Returns sum_s w_s |phi_s|^2.  The first slope's input is the
    // tick's initial amplitudes, so its fetched neighbours also give the
    // lane's share of the Ehrenfest sum, Im(psi_s conj(psi_c)) = b_s a_c -
    // a_s b_c per weighted pair (s, c).
    float kick_part = 0.f;
    auto slope = [&](auto which, float sa, float sb, float& ka,
                     float& kb) -> float {
      constexpr bool FIRST = decltype(which)::value;
      const float dps = group_sum<G>(w * (sa * sa + sb * sb));
      const float dp = p.h * dps;
      const float pref = rsqrtf(1.f - fminf(fmaxf(dp, 0.f), 0.9f));
      float re = 0.f, im = 0.f;
      if constexpr (!WIDE) {
#pragma unroll
        for (int k = 0; k < KREG; ++k) {
          const float pa = __shfl_sync(FULL, sa, col[k]);
          const float pb = __shfl_sync(FULL, sb, col[k]);
          if (beat) {
            re += cr[k] * pa - ci[k] * pb;
            im += cr[k] * pb + ci[k] * pa;
          } else {
            re += coef[k] * pa;
            im += coef[k] * pb;
          }
          if constexpr (FIRST) kick_part += fwk[k] * (sb * pa - sa * pb);
        }
      } else {
        for (int k = 0; k < K; ++k) {
          int c;
          float m, t, ts, fw;
          entry(srow + s * W, k, c, m, t, ts, fw);
          const float pa = __shfl_sync(FULL, sa, c);
          const float pb = __shfl_sync(FULL, sb, c);
          const float crk = m + t * cphi, cik = ts * sphi;
          re += crk * pa - cik * pb;
          im += crk * pb + cik * pa;
          if constexpr (FIRST) kick_part += fw * (sb * pa - sa * pb);
        }
      }
      re += diag * sa;
      im += diag * sb;
      re = re - hw * sb;
      im = im + hw * sa;
      ka = (pref * (sa + p.h * im) - sa) * p.inv_h;
      kb = (pref * (sb - p.h * re) - sb) * p.inv_h;
      return dps;
    };

    // ---- RK step: acc = k1 + 3 k2 + 3 k3 + k4 ----
    float ka, kb;
    const float dp0 = slope(FirstSlope{}, a, b, ka, kb);
    float acca = ka, accb = kb;
    float sa = a + p.half_h * ka, sb = b + p.half_h * kb;
    slope(LaterSlope{}, sa, sb, ka, kb);
    acca = acca + 3.f * ka;
    accb = accb + 3.f * kb;
    sa = a + p.half_h * ka;
    sb = b + p.half_h * kb;
    slope(LaterSlope{}, sa, sb, ka, kb);
    acca = acca + 3.f * ka;
    accb = accb + 3.f * kb;
    sa = a + p.h * ka;
    sb = b + p.h * kb;
    slope(LaterSlope{}, sa, sb, ka, kb);
    acca = acca + ka;
    accb = accb + kb;

    // ---- Ehrenfest kick from the tick's initial amplitudes ----
    const float kick_nj =
        p.apply_kick ? group_sum<G>(kick_part) * p.h : 0.f;

    // ---- this tick's uniforms: lane j of the group runs Threefry call j
    uint32_t x0 = 0u, x1 = 0u;
    float r0;
    if constexpr (RNG) {
      x0 = lane0 + (uint32_t)n;                    // global lane
      x1 = 3u * (tick_base + (uint32_t)i) + (uint32_t)min(s, 2);
      threefry2x32(key, 0u, x0, x1);
      r0 = unit24(__shfl_sync(FULL, x0, base));
    } else {
      r0 = __shfl_sync(FULL, roll_s, base);
    }
    const bool jumped = r0 < p.h * dp0;       // unclipped dp, strict <

    // ---- jump collapse, in the ticks an ion of this warp jumps ----
    int dest = 0;
    float kick_j = 0.f;
    if (__any_sync(FULL, jumped)) {
      float r1, r2, r3, r4;
      if constexpr (RNG) {
        r1 = unit24(__shfl_sync(FULL, x1, base));
        r2 = unit24(__shfl_sync(FULL, x0, base + 1));
        r3 = unit24(__shfl_sync(FULL, x1, base + 1));
        r4 = unit24(__shfl_sync(FULL, x0, base + 2));
      } else {
        r1 = __shfl_sync(FULL, roll_s, base + 1);
        r2 = __shfl_sync(FULL, roll_s, base + 2);
        r3 = __shfl_sync(FULL, roll_s, base + 3);
        r4 = roll_4;
      }
      float cum = (a * a + b * b) * msk;           // inclusive scan over s
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        const float below = __shfl_up_sync(FULL, cum, d, G);
        cum = (s >= d) ? cum + below : cum;
      }
      const float tot =
          fmaxf(__shfl_sync(FULL, cum, base + S - 1), 1e-30f);
      const int src =
          min(group_count<G>(live && r1 * tot >= cum, base), S - 1);
      const bool d_branch = r2 < p.branch_d;
      const float* dc = d_branch ? cumD : cumS;
      dest = min(group_count<G>(live && r4 >= dc[src * SP + s], base), S - 1);
      kick_j = p.apply_recoil
                   ? ((r3 < 0.5f) ? 1.f : -1.f) *
                         (d_branch ? p.kick_d : p.kick_s)
                   : 0.f;
    }

    // ---- merge ----
    a = jumped ? ((s == dest) ? 1.f : 0.f) : a + acca * p.h8;
    b = jumped ? 0.f : b + accb * p.h8;
    tp = jumped ? 0.f : tp;
    if (p.renormalize) {
      const float nrm = sqrtf(group_sum<G>(a * a + b * b));
      const float inv = (nrm > 0.f) ? 1.f / nrm : 0.f;   // pad lanes stay 0
      a = a * inv;
      b = b * inv;
    }
    if (p.apply_kick) v = (s == 0) ? v + (jumped ? kick_j : kick_nj) : v;
  }

  if (axis) {
    Ro[ax] = r;
    Vo[ax] = v;
  }
  if (s == 0) tpo[n] = tp;
  for (int row = s; row < SP; row += G) {     // pad rows stay exactly zero
    const bool mine = live && row == s;
    preo[(size_t)row * npad + n] = mine ? a : 0.f;
    pimo[(size_t)row * npad + n] = mine ? b : 0.f;
  }
}

// ---- S = 3, 5, 7: one thread an ion ----
//
// The small schemes' launches are latency-bound, not rate-bound: the
// three-state toy runs 1000 ions (32 warps) through 1000 dependent ticks,
// the tagging pumps 3500-4096 ions through 22-62.  In a group of lanes an
// ion's every state is one serial stream of dependent instructions with
// shuffles on it (a butterfly for each slope's dp, the neighbours' fetches;
// 1,500-2,000 cycles a tick at S = 5, 7 with G = 8, 1,100-1,250 at S = 3
// with G = 4, on the H100).  A few complex amplitudes are a few dozen
// floats, so a thread holds its whole ion:
//   * every sum over states (dp of each slope, the Ehrenfest sum, the
//     collapse's cumulative sum, the norm) is an in-thread add in state
//     order, and an ion's result depends on neither its block nor how a
//     fold is cut into launches;
//   * H phi is the S x S product in column order over the places of the
//     scheme's coupling pattern, compiled in (the template's mask: bit
//     s * S + c is the place (s, c); ION_PATTERNS below).  The pumps
//     couple 4 or 8 of 25 or 49 places, so a dense product would issue
//     some 98 FFMA a slope for 4-8 terms.  The mask's bits S * S + s name
//     the states that decay (w_s != 0; 2 of 5, 4 of 7 in the pumps): the
//     slopes' dp sums and decay terms skip the others.  Skipping a zero
//     in order leaves the dense sum's value (0 x phi added to a sum leaves
//     it), so every pattern that covers a scheme computes the same bits;
//     the all-ones pattern serves any other scheme of these sizes;
//   * the tables the ions share (the coupling, beat-note and Ehrenfest
//     weights, w, e0, e1, the jump mask and both destination tables) are
//     kernel parameters (IonTables): an FFMA reads them from the constant
//     bank.  The per-lane e0 and om are loaded once before the tick loop;
//     the om forms merge om * c_sp + om_dp * c_dp once, as above, so a
//     member at scale 1 computes what the plain form computes.  A pattern
//     with more than ION_HOLD places (the dense S = 5, 7 forms) forms the
//     merged entries again each tick from a copy of (om, om_dp) the
//     compiler cannot hoist, so its registers stay bounded;
//   * the rolls of tick i + 3 start on their way (cp.async, coalesced rows
//     of the [T*5, npad] plane) while tick i runs, into a ring of four
//     ticks in shared memory that each thread fills and reads for itself:
//     a load from device memory outlasts a tick, and a register copy of a
//     value still on its way would wait for it;
//   * the collapse runs under the ion's own `jumped` (no vote): a few
//     percent of the ticks; the Ehrenfest sum only where the spec kicks
//     (a branch the whole launch takes alike; the pumps do not kick);
//   * 32 threads a block, so 1000 ions are 32 blocks on 32 SMs, one warp
//     a scheduler, 3584 lanes 112 blocks and 4096 lanes 128.
// What bounds it: one warp's stream, tick after tick.  At S = 3 a tick
// issues some 410-420 instructions (at most one a cycle), and its
// loop-carried chain (four slopes, each a sum of squares, a clip and a
// reciprocal square root ahead of the next stage: 53 dependent
// instructions) takes some 277 cycles; in order, the warp stalls on the
// chain between the independent work, ~655 cycles a tick on an H100
// (tools/tick_kernel_sass.py reads both floors from the machine code; 32
// ions take as long as 1000).  The pumps' forms issue 452-461 (S = 5) and
// 591-632 (S = 7) instructions a tick over a 264- / 298-cycle chain, some
// 780 / 1,030 cycles a tick; a launch of theirs also pays the 7.5-8 us
// that one tick alone takes (its start, the first loads, the stores).
#define ION_THREADS 32
#define ROLL_STAGES 4            // ticks of rolls in flight (a shared ring)
#define ION_SMEM (ROLL_STAGES * 5 * ION_THREADS * (int)sizeof(float))
#define ION_HOLD 16              // places whose per-ion entries stay in
                                 // registers across the ticks

// The patterns compiled in, (name, S, mask), in the order the host takes
// the first that covers a scheme (qt_fused.py's ION_PATTERNS mirrors this
// list; tests/test_torch_fused_layout.py holds the two equal): the
// three-state toy's S = 3 dense; the 422-nm pump (2<->3, 1<->4, 1-based;
// the P states decay); the 408-nm quad pump (2<->6, 1<->5) and its linear
// form (also 2<->4, 1<->3; the four P states decay); the dense forms of
// S = 5 and 7
#define ION_PATTERNS(P)                      \
  P(dense, 3, 0xfffull)                      \
  P(tag422_linear, 5, 0x18008888ull)         \
  P(dense, 5, 0x3fffffffull)                 \
  P(tag408_quad, 7, 0x78001010001010ull)     \
  P(tag408_linear, 7, 0x78001010405414ull)   \
  P(dense, 7, 0xffffffffffffffull)

__host__ __device__ constexpr bool on_place(uint64_t M, int S, int s,
                                            int c) {
  return (M >> (s * S + c)) & 1ull;
}

__host__ __device__ constexpr bool decays(uint64_t M, int S, int s) {
  return (M >> (S * S + s)) & 1ull;
}

__host__ __device__ constexpr int popcount64(uint64_t M) {
  return M ? (int)(M & 1ull) + popcount64(M >> 1) : 0;
}

// The tables every ion shares, in the flat float32 order qt_fused.py's
// ion_table writes (ION_FIELDS there): per state w, e0, e1, jump mask;
// [row][column] static coupling (c_sp | c_dp, as the lane table's planes),
// beat-note m and m times its phase sign; per state pair (0,1), (0,2),
// ..., (S-2,S-1) the Ehrenfest weight W of Im(psi_s conj(psi_c)) and its
// group; [src][dest] cumulative destination tables of the S and D branches
template <int S>
struct IonTables {
  float w[S], e0[S], e1[S], msk[S];
  float c_sp[S][S], c_dp[S][S], tm[S][S], tms[S][S];
  float pair_w[S * (S - 1) / 2], pair_g[S * (S - 1) / 2];
  float cum_s[S][S], cum_d[S][S];
};
__host__ __device__ constexpr int ion_table_width(int S) {
  return 4 * S + 6 * S * S + S * (S - 1);
}
static_assert(sizeof(IonTables<3>) == sizeof(float) * ion_table_width(3) &&
                  sizeof(IonTables<5>) == sizeof(float) * ion_table_width(5) &&
                  sizeof(IonTables<7>) == sizeof(float) * ion_table_width(7),
              "IonTables is the flat table, float for float");

// rsqrtf of x in [0.1, 1]: the same approximate reciprocal square root
// (MUFU.RSQ) without rsqrtf's rescaling of subnormal arguments, which
// none in this range is: the same bits, three dependent instructions
// fewer on each slope
__device__ __forceinline__ float rsqrt_01(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ``T`` ticks of one ion held in this thread's registers; M: the coupling
// pattern (ION_PATTERNS); BEAT: the scheme has beat-note terms (a complex
// row a tick)
template <int S, uint64_t M, bool PE0, bool POM, bool BEAT>
__device__ __forceinline__ void ion_ticks(
    const TickConsts& p, const IonTables<S>& t, int n, int npad,
    const float* __restrict__ rolls, const float* __restrict__ e0_lanes,
    const float* __restrict__ om_lanes, float first, float tick0,
    float* ring, float (&r)[3], float (&v)[3], const float (&f)[3],
    float& tp, float (&a)[S], float (&b)[S]) {
  constexpr int P = S * (S - 1) / 2;
  constexpr bool HOLD = popcount64(M & ((1ull << (S * S)) - 1)) <= ION_HOLD;
  // A pattern's sums start from a zero the compiler cannot see: from a
  // literal 0 it would fold 0 + c x to c x and fuse the next term's
  // product with that one instead of with the sum, a rounding the dense
  // pattern's sums (an FFMA on every coefficient) do not make
  float zero = 0.f;
  if constexpr (M != (1ull << (S * S + S)) - 1)
    asm volatile("" : "+f"(zero));
  // At S = 5, 7 each product subtracted from a value (and v + qdt f, whose
  // product the compiler hoists out of the loop) is rounded once, by the
  // source's own fmaf, and a slope k, later added to the accumulator, is a
  // product rounded apart (__fmul_rn): the compiler fuses x + y z itself
  // but leaves x - y z, and a product it cannot fuse where it is made, to
  // the assembler, which fuses them or not by the code around them, so
  // two forms (a pattern and the dense one) could round them apart.  S = 3
  // keeps the expressions, and the machine code, it was measured with.
  constexpr bool FUSED = S != 3;
  // ---- this ion's constants: the constant bank's, or merged per ion ----
  const float om = POM ? om_lanes[n] : 1.f;
  const float omdp = POM ? om_lanes[npad + n] : 1.f;
  float e0[S], coef[S][S], tm[S][S], tms[S][S], pw[P];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    e0[s] = PE0 ? e0_lanes[(size_t)s * npad + n] : t.e0[s];
#pragma unroll
    for (int c = 0; c < S; ++c) {
      coef[s][c] = POM ? om * t.c_sp[s][c] + omdp * t.c_dp[s][c]
                       : t.c_sp[s][c];
      tm[s][c] = POM ? omdp * t.tm[s][c] : t.tm[s][c];
      tms[s][c] = POM ? omdp * t.tms[s][c] : t.tms[s][c];
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k)
    pw[k] = POM ? ((t.pair_g[k] != 0.f) ? omdp : om) * t.pair_w[k]
                : t.pair_w[k];
  const float hq = p.half_qdt, L = p.L;
  const int T = p.n_ticks;

  // tick min(i, T-1)'s five uniforms into ring slot i % ROLL_STAGES, one
  // cp.async group (coalesced 128-byte rows of the [T*5, npad] plane)
  auto fetch = [&](int i) {
    const float* q = rolls + (size_t)(min(i, T - 1) * 5) * npad + n;
    const unsigned slot = (unsigned)__cvta_generic_to_shared(
        ring + (i % ROLL_STAGES) * 5 * ION_THREADS);
#pragma unroll
    for (int k = 0; k < 5; ++k)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       slot + 4u * (unsigned)(k * ION_THREADS)),
                   "l"(q + (size_t)k * npad)
                   : "memory");
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  auto tick = [&](int i, const float (&rl)[5]) {
    if constexpr (POM && !HOLD) {
      // a dense pattern's merged entries, formed again from a copy of
      // (om, om_dp) that the compiler may not hoist out of the loop: the
      // same bits as above, no registers held across the ticks
      float o = om, od = omdp;
      asm volatile("" : "+f"(o), "+f"(od));
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int c = 0; c < S; ++c) {
          coef[s][c] = o * t.c_sp[s][c] + od * t.c_dp[s][c];
          tm[s][c] = od * t.tm[s][c];
          tms[s][c] = od * t.tms[s][c];
        }
    }
    // ---- leapfrog substep (forces fixed) ----
    const float fsq = (((first > 0.f && i == 0) ? 1.f : 0.f) * hq) * hq;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      r[d] = wrap(r[d] + hq * v[d] + fsq * f[d], L);
      if constexpr (FUSED)
        v[d] = fmaf(p.qdt, f[d], v[d]);
      else
        v[d] = v[d] + p.qdt * f[d];
      r[d] = wrap(r[d] + hq * v[d] + fsq * f[d], L);
    }
    // ---- quantum tick: the clock advances before the beat note ----
    tp = tp + p.qdt;
    float u = v[0] * p.p2q;
    if (p.has_exp) {
      const float tpl = (tick0 + (float)i) * p.qdt;
      u = u + (p.exp_c1 * tpl) * rsqrtf(1.f + p.exp_c2 * tpl * tpl);
    }
    float cr[S][S], ci[S][S];
    if constexpr (BEAT) {
      float cphi, sphi;
      sincosf((p.tdep_freq * u) * (tp * p.g2e), &sphi, &cphi);
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int c = 0; c < S; ++c) {
          cr[s][c] = coef[s][c] + tm[s][c] * cphi;
          ci[s][c] = tms[s][c] * sphi;
        }
    }
    float diag[S];
#pragma unroll
    for (int s = 0; s < S; ++s) diag[s] = e0[s] + t.e1[s] * u;

    // One RK slope at stage input (sa, sb), as the group kernel's; returns
    // sum_s w_s |phi_s|^2
    auto slope = [&](const float (&sa)[S], const float (&sb)[S],
                     float (&ka)[S], float (&kb)[S]) -> float {
      float dps = zero;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (!FUSED || decays(M, S, s))
          dps += t.w[s] * (sa[s] * sa[s] + sb[s] * sb[s]);
      const float dp = p.h * dps;
      const float pref = rsqrt_01(1.f - fminf(fmaxf(dp, 0.f), 0.9f));
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float re = zero, im = zero;
#pragma unroll
        for (int c = 0; c < S; ++c) {
          if (!on_place(M, S, s, c)) continue;    // no term of the pattern
          if constexpr (BEAT) {
            if constexpr (FUSED)
              re += fmaf(cr[s][c], sa[c], -(ci[s][c] * sb[c]));
            else
              re += cr[s][c] * sa[c] - ci[s][c] * sb[c];
            im += cr[s][c] * sb[c] + ci[s][c] * sa[c];
          } else {
            re += coef[s][c] * sa[c];
            im += coef[s][c] * sb[c];
          }
        }
        re += diag[s] * sa[s];
        im += diag[s] * sb[s];
        const float hw = -0.5f * t.w[s];
        if constexpr (FUSED) {
          if (decays(M, S, s)) {
            re = fmaf(-hw, sb[s], re);
            im = im + hw * sa[s];
          }
          ka[s] = __fmul_rn(fmaf(pref, sa[s] + p.h * im, -sa[s]), p.inv_h);
          kb[s] = __fmul_rn(fmaf(pref, fmaf(-p.h, re, sb[s]), -sb[s]),
                            p.inv_h);
        } else {                  // S = 3 (dense): every state's term
          re = re - hw * sb[s];
          im = im + hw * sa[s];
          ka[s] = (pref * (sa[s] + p.h * im) - sa[s]) * p.inv_h;
          kb[s] = (pref * (sb[s] - p.h * re) - sb[s]) * p.inv_h;
        }
      }
      return dps;
    };

    // ---- RK step: acc = k1 + 3 k2 + 3 k3 + k4 ----
    float ka[S], kb[S], sa[S], sb[S], acca[S], accb[S];
    const float dp0 = slope(a, b, ka, kb);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acca[s] = ka[s];
      accb[s] = kb[s];
      sa[s] = a[s] + p.half_h * ka[s];
      sb[s] = b[s] + p.half_h * kb[s];
    }
    slope(sa, sb, ka, kb);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acca[s] = acca[s] + 3.f * ka[s];
      accb[s] = accb[s] + 3.f * kb[s];
      sa[s] = a[s] + p.half_h * ka[s];
      sb[s] = b[s] + p.half_h * kb[s];
    }
    slope(sa, sb, ka, kb);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acca[s] = acca[s] + 3.f * ka[s];
      accb[s] = accb[s] + 3.f * kb[s];
      sa[s] = a[s] + p.h * ka[s];
      sb[s] = b[s] + p.h * kb[s];
    }
    slope(sa, sb, ka, kb);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acca[s] = acca[s] + ka[s];
      accb[s] = accb[s] + kb[s];
    }

    // ---- Ehrenfest kick from the tick's initial amplitudes, pair order,
    // over the pattern's pairs; only where the spec kicks (the pumps do
    // not; S = 3, whose toy kicks, keeps the unconditional sum it was
    // measured with) --
    float kick = zero;
    if (S == 3 || p.apply_kick) {
      int k = 0;
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int c = s + 1; c < S; ++c, ++k)
          if (on_place(M, S, s, c) || on_place(M, S, c, s)) {
            if constexpr (FUSED)
              kick += pw[k] * fmaf(b[s], a[c], -(a[s] * b[c]));
            else
              kick += pw[k] * (b[s] * a[c] - a[s] * b[c]);
          }
    }
    const float kick_nj = p.apply_kick ? kick * p.h : 0.f;
    const bool jumped = rl[0] < p.h * dp0;      // unclipped dp, strict <

    // ---- jump collapse, for this ion only when it jumps ----
    int dest = 0;
    float kick_j = 0.f;
    if (jumped) {
      float cum[S], run = 0.f;                  // inclusive sum over s
#pragma unroll
      for (int s = 0; s < S; ++s) {
        run = (s == 0) ? (a[s] * a[s] + b[s] * b[s]) * t.msk[s]
                       : run + (a[s] * a[s] + b[s] * b[s]) * t.msk[s];
        cum[s] = run;
      }
      const float tot = fmaxf(cum[S - 1], 1e-30f);
      int src = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) src += (rl[1] * tot >= cum[s]) ? 1 : 0;
      src = min(src, S - 1);
      const bool d_branch = rl[2] < p.branch_d;
#pragma unroll
      for (int d = 0; d < S; ++d) {
        float cs = t.cum_s[0][d], cd = t.cum_d[0][d];
#pragma unroll
        for (int k = 1; k < S; ++k) {
          cs = (src == k) ? t.cum_s[k][d] : cs;
          cd = (src == k) ? t.cum_d[k][d] : cd;
        }
        dest += (rl[4] >= (d_branch ? cd : cs)) ? 1 : 0;
      }
      dest = min(dest, S - 1);
      kick_j = p.apply_recoil
                   ? ((rl[3] < 0.5f) ? 1.f : -1.f) *
                         (d_branch ? p.kick_d : p.kick_s)
                   : 0.f;
    }

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
    if (p.apply_kick) v[0] = v[0] + (jumped ? kick_j : kick_nj);
  };

  // the rolls of tick i + ROLL_STAGES - 1 start on their way while tick i
  // runs; each thread reads only the slots it filled.  A slot read at tick
  // i is refilled at tick i + 1, after tick i's merge has consumed what was
  // read from it (rl[0] decides `jumped`; the rest is read and used under
  // it), so the refill cannot reach a read still outstanding.
  for (int k = 0; k < ROLL_STAGES - 1; ++k) fetch(k);
#pragma unroll 1
  for (int i = 0; i < T; ++i) {
    fetch(i + ROLL_STAGES - 1);
    asm volatile("cp.async.wait_group %0;" ::"n"(ROLL_STAGES - 1) : "memory");
    float rl[5];
    const float* slot = ring + (i % ROLL_STAGES) * 5 * ION_THREADS;
#pragma unroll
    for (int k = 0; k < 5; ++k) rl[k] = slot[k * ION_THREADS];
    tick(i, rl);
  }
  // the last ROLL_STAGES - 1 groups (tick T - 1 again, never read) land
  // before the thread leaves
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <int S, uint64_t M, bool PE0, bool POM>
__global__ void __launch_bounds__(ION_THREADS)
fused_ticks_ion_kernel(const TickConsts p, const IonTables<S> t,
                       const float* __restrict__ R,
                       const float* __restrict__ V,
                       const float* __restrict__ F,
                       const float* __restrict__ tp_in,
                       const float* __restrict__ pre,
                       const float* __restrict__ pim,
                       const float* __restrict__ rolls,
                       const float* __restrict__ e0_lanes,
                       const float* __restrict__ om_lanes,
                       float* __restrict__ Ro, float* __restrict__ Vo,
                       float* __restrict__ tpo, float* __restrict__ preo,
                       float* __restrict__ pimo, int npad, float first,
                       float tick0) {
  const int n = blockIdx.x * ION_THREADS + threadIdx.x;   // the ion
  float r[3], v[3], f[3], a[S], b[S];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    r[d] = R[(size_t)d * npad + n];
    v[d] = V[(size_t)d * npad + n];
    f[d] = F[(size_t)d * npad + n];
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a[s] = pre[(size_t)s * npad + n];
    b[s] = pim[(size_t)s * npad + n];
  }
  float tp = tp_in[n];
  extern __shared__ float ring[];    // [ROLL_STAGES][5][ION_THREADS]
  if (p.n_tdep > 0)
    ion_ticks<S, M, PE0, POM, true>(p, t, n, npad, rolls, e0_lanes,
                                    om_lanes, first, tick0, ring + threadIdx.x,
                                    r, v, f, tp, a, b);
  else
    ion_ticks<S, M, PE0, POM, false>(p, t, n, npad, rolls, e0_lanes,
                                     om_lanes, first, tick0,
                                     ring + threadIdx.x, r, v, f, tp, a, b);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    Ro[(size_t)d * npad + n] = r[d];
    Vo[(size_t)d * npad + n] = v[d];
  }
  tpo[n] = tp;
  for (int row = 0; row < p.SP; ++row) {      // pad rows stay exactly zero
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      x = (row == s) ? a[s] : x;
      y = (row == s) ? b[s] : y;
    }
    preo[(size_t)row * npad + n] = x;
    pimo[(size_t)row * npad + n] = y;
  }
}

// lanes of a warp that own one ion: a thread at S = 3, 5, 7 (the ion
// kernel), 16 lanes at S = 12 (the group kernel)
static int lanes_per_ion(int S) { return S <= 7 ? 1 : 16; }

extern "C" {

// rolls [n_ticks*5, npad] (explicit form) or seed [1] (internal_rng form;
// tick_base is then the absolute run tick at entry and lane0 the global
// lane of lane 0).  lane_tab [SP, lane_table_width(K)] holds each lane's
// row of H (K entries; the beat-note and Ehrenfest terms ride on them);
// at S = 3, 5, 7 the kernel takes ion_tab instead, a host array of
// ion_table_width(S) floats (IonTables) passed by value, and pattern, the
// mask of one of ION_PATTERNS' entries for that S (the host picks one that
// covers the scheme's places; another is refused).  blocks and smem_bytes
// are the caller's launch geometry, checked against the kernel's own.
int fused_ticks_launch(const FusedParams* p, const float* R, const float* V,
                       const float* F, const float* tp, const float* pre,
                       const float* pim, const float* rolls, const int* seed,
                       const float* e0_lanes, const float* om_lanes,
                       const float* vecs, const float* mats,
                       const float* lane_tab, int K, const float* ion_tab,
                       unsigned long long pattern, float* Ro, float* Vo,
                       float* tpo, float* preo, float* pimo, int npad,
                       float first, float tick0,
                       unsigned tick_base, unsigned lane0, int blocks,
                       int smem_bytes, void* stream) {
  const int pe0 = p->per_lane_e0 != 0, pom = p->per_lane_om != 0;
  const int rng = p->internal_rng != 0;
  const int G = lanes_per_ion(p->S), SP = p->SP;
  if (npad <= 0 || npad % THREADS != 0 || p->n_ticks < 1 ||
      p->n_tdep > MAX_TDEP || SP < p->S || SP < G ||
      K < 1 || K > SP || !lane_tab || (pe0 && !e0_lanes) ||
      (pom && !om_lanes) || (rng && !seed) || (!rng && !rolls))
    return (int)cudaErrorInvalidValue;
  const int W = lane_table_width(K);
  TickConsts c;
  c.SP = SP; c.n_ticks = p->n_ticks; c.n_tdep = p->n_tdep; c.K = K; c.W = W;
  c.apply_kick = p->apply_kick; c.apply_recoil = p->apply_recoil;
  c.renormalize = p->renormalize; c.has_exp = p->has_exp;
  c.inv_h = 1.0f / p->h;
  c.h = p->h; c.half_h = p->half_h; c.h8 = p->h8; c.qdt = p->qdt;
  c.half_qdt = p->half_qdt; c.p2q = p->p2q; c.g2e = p->g2e; c.L = p->L;
  c.exp_c1 = p->exp_c1; c.exp_c2 = p->exp_c2; c.tdep_freq = p->tdep_freq;
  c.branch_d = p->branch_d; c.kick_s = p->kick_s; c.kick_d = p->kick_d;
  cudaStream_t st = (cudaStream_t)stream;
  if (G == 1) {              // one thread an ion; no RNG form at these S
    if (rng || !ion_tab || blocks != npad / ION_THREADS ||
        smem_bytes != ION_SMEM)
      return (int)cudaErrorInvalidValue;
#define ION_LAUNCH(SV, MV, E0, OM)                                        \
  fused_ticks_ion_kernel<SV, MV, E0, OM>                                  \
      <<<blocks, ION_THREADS, ION_SMEM, st>>>(                            \
      c, t, R, V, F, tp, pre, pim, rolls, e0_lanes, om_lanes, Ro, Vo, tpo, \
      preo, pimo, npad, first, tick0)
#define ION_FORMS(NAME, SV, MV)                                           \
  if (p->S == SV && pattern == MV) {                                      \
    IonTables<SV> t;                                                      \
    memcpy(&t, ion_tab, sizeof t);                                        \
    switch (pe0 * 2 + pom) {                                              \
      case 0: ION_LAUNCH(SV, MV, false, false); break;                    \
      case 2: ION_LAUNCH(SV, MV, true, false); break;                     \
      case 1: ION_LAUNCH(SV, MV, false, true); break;                     \
      default: ION_LAUNCH(SV, MV, true, true); break;                     \
    }                                                                     \
    return (int)cudaGetLastError();                                       \
  }
    ION_PATTERNS(ION_FORMS)
#undef ION_FORMS
#undef ION_LAUNCH
    return (int)cudaErrorInvalidValue;          // no such pattern compiled
  }
  const int need =
      (int)sizeof(float) * (2 * SP * SP + (K > KREG ? SP * W : 0));
  if (blocks != npad / (THREADS / G) || smem_bytes != need)
    return (int)cudaErrorInvalidValue;
#define ARGS                                                              \
  c, R, V, F, tp, pre, pim, rolls, seed, e0_lanes, om_lanes, vecs, mats,  \
      lane_tab, Ro, Vo, tpo, preo, pimo, npad, first, tick0, tick_base,   \
      lane0
#define LAUNCH(SV, GV, E0, OM, RG)                                        \
  if (K > KREG)                                                           \
    fused_ticks_kernel<SV, GV, E0, OM, RG, true>                          \
        <<<blocks, THREADS, smem_bytes, st>>>(ARGS);                      \
  else                                                                    \
    fused_ticks_kernel<SV, GV, E0, OM, RG, false>                         \
        <<<blocks, THREADS, smem_bytes, st>>>(ARGS)
  // the per-lane forms, and the RNG forms (the cooling family's sr12)
  switch (p->S * 8 + rng * 4 + pe0 * 2 + pom) {
    case 12 * 8: LAUNCH(12, 16, false, false, false); break;
    case 12 * 8 + 2: LAUNCH(12, 16, true, false, false); break;
    case 12 * 8 + 1: LAUNCH(12, 16, false, true, false); break;
    case 12 * 8 + 3: LAUNCH(12, 16, true, true, false); break;
    case 12 * 8 + 4: LAUNCH(12, 16, false, false, true); break;
    case 12 * 8 + 6: LAUNCH(12, 16, true, false, true); break;
    case 12 * 8 + 5: LAUNCH(12, 16, false, true, true); break;
    case 12 * 8 + 7: LAUNCH(12, 16, true, true, true); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
#undef ARGS
  return (int)cudaGetLastError();
}

const char* mdqt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
