// Dependent-issue latency of the instruction classes on the tick kernel's
// chain, measured on the card by tools/tick_kernel_sass.py: one thread (a
// warp for the shuffle and vote chains) runs a chain of N instructions,
// each reading the one before, between two clock64() reads.  Built with
// nvcc -shared and loaded with ctypes.
//
// Classes (the SASS each PTX line becomes on sm_90a):
//   0 fma   fma.rn.f32                    FFMA (FADD, FMUL: the same pipe)
//   1 mnmx  min.f32                       FMNMX
//   2 sel   setp.gt.f32 + selp.f32        FSETP + FSEL, per instruction
//   3 mufu  rsqrt.approx.ftz.f32          MUFU.RSQ
//   4 imad  mad.lo.s32                    IMAD
//   5 shfl  and.b32 + shfl.sync.idx.b32   LOP3 + SHFL.IDX (a warp's 32
//                                         lanes, each its own value: the
//                                         assembler drops a shuffle of a
//                                         value it knows is the warp's;
//                                         the source lane is read from the
//                                         value; the caller takes the and off)
//   6 vote  8 x vote.sync.any.pred        VOTE.ANY P0, P0 (the assembler
//           between a setp.ne.s32 and a   drops the compare and the select
//           selp.s32                      between blocks: a step is 8 votes)
#include <cuda_runtime.h>
#include <stdint.h>

#define CHAIN 2048

template <int OP>
__global__ void latency_chain(float* xf, int* xi, long long* cycles, float a,
                              float b, int ia) {
  float x = xf[0];
  int k = xi[0] + (OP == 5 ? (int)threadIdx.x : 0);
  const long long t0 = clock64();
#pragma unroll 64
  for (int i = 0; i < CHAIN; ++i) {
    if (OP == 0)
      asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(x) : "f"(a), "f"(b));
    if (OP == 1) asm volatile("min.f32 %0, %0, %1;" : "+f"(x) : "f"(a));
    if (OP == 2)
      asm volatile(
          "{ .reg .pred p; setp.gt.f32 p, %0, %1; selp.f32 %0, %2, %0, p; }"
          : "+f"(x) : "f"(a), "f"(b));
    if (OP == 3) asm volatile("rsqrt.approx.ftz.f32 %0, %0;" : "+f"(x));
    if (OP == 4)
      asm volatile("mad.lo.s32 %0, %0, %1, %1;" : "+r"(k) : "r"(ia));
    if (OP == 5)
      asm volatile(
          "{ .reg .b32 t; and.b32 t, %0, 31;\n\t"
          "shfl.sync.idx.b32 %0, %0, t, 0x1f, 0xffffffff; }"
          : "+r"(k));
    if (OP == 6)
      asm volatile(
          "{ .reg .pred p; setp.ne.s32 p, %0, 0;\n\t"
          "vote.sync.any.pred p, p, 0xffffffff;\n\t"
          "vote.sync.any.pred p, p, 0xffffffff;\n\t"
          "vote.sync.any.pred p, p, 0xffffffff;\n\t"
          "vote.sync.any.pred p, p, 0xffffffff;\n\t"
          "vote.sync.any.pred p, p, 0xffffffff;\n\t"
          "vote.sync.any.pred p, p, 0xffffffff;\n\t"
          "vote.sync.any.pred p, p, 0xffffffff;\n\t"
          "vote.sync.any.pred p, p, 0xffffffff;\n\t"
          "selp.s32 %0, 1, 0, p; }"
          : "+r"(k));
  }
  const long long t1 = clock64();
  xf[0] = x;
  xi[0] = k;
  cycles[0] = t1 - t0;
}

extern "C" {

// cycles per instruction of class op (0-6); sel counts its two
// instructions; shfl and vote return the cycles of one step of their
// chain (the caller subtracts the and, or divides by the 8 votes).  The
// shfl and vote chains run on a whole warp.  Returns a cudaError_t.
int latency_probe(int op, double* per_instruction) {
  float* xf;
  int* xi;
  long long* cyc;
  cudaMalloc(&xf, sizeof(float));
  cudaMalloc(&xi, sizeof(int));
  cudaMalloc(&cyc, sizeof(long long));
  const float one = 1.0f;
  const int three = 3;
  cudaMemcpy(xf, &one, sizeof one, cudaMemcpyHostToDevice);
  cudaMemcpy(xi, &three, sizeof three, cudaMemcpyHostToDevice);
  long long best = -1;
  for (int rep = 0; rep < 5; ++rep) {
    switch (op) {
      case 0: latency_chain<0><<<1, 1>>>(xf, xi, cyc, 1.0f, 0.0f, 1); break;
      case 1: latency_chain<1><<<1, 1>>>(xf, xi, cyc, 2.0f, 0.0f, 1); break;
      case 2: latency_chain<2><<<1, 1>>>(xf, xi, cyc, 2.0f, 1.0f, 1); break;
      case 3: latency_chain<3><<<1, 1>>>(xf, xi, cyc, 0.0f, 0.0f, 1); break;
      case 5: latency_chain<5><<<1, 32>>>(xf, xi, cyc, 0.0f, 0.0f, 1); break;
      case 6: latency_chain<6><<<1, 32>>>(xf, xi, cyc, 0.0f, 0.0f, 1); break;
      default: latency_chain<4><<<1, 1>>>(xf, xi, cyc, 0.0f, 0.0f, 1); break;
    }
    long long c = 0;
    cudaMemcpy(&c, cyc, sizeof c, cudaMemcpyDeviceToHost);
    if (best < 0 || c < best) best = c;
  }
  const int err = (int)cudaGetLastError();
  cudaFree(xf);
  cudaFree(xi);
  cudaFree(cyc);
  *per_instruction =
      (double)best / (CHAIN * (op == 2 ? 2 : 1));
  return err;
}

}  // extern "C"
