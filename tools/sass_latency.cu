// Dependent-issue latency of the instruction classes on the tick kernel's
// chain, measured on the card by tools/tick_kernel_sass.py: one thread
// runs a chain of N instructions, each reading the one before, between two
// clock64() reads.  Built with nvcc -shared and loaded with ctypes.
//
// Classes (the SASS each PTX line becomes on sm_90a):
//   0 fma   fma.rn.f32                    FFMA (FADD, FMUL: the same pipe)
//   1 mnmx  min.f32                       FMNMX
//   2 sel   setp.gt.f32 + selp.f32        FSETP + FSEL, per instruction
//   3 mufu  rsqrt.approx.ftz.f32          MUFU.RSQ
//   4 imad  mad.lo.s32                    IMAD
#include <cuda_runtime.h>
#include <stdint.h>

#define CHAIN 2048

template <int OP>
__global__ void latency_chain(float* xf, int* xi, long long* cycles, float a,
                              float b, int ia) {
  float x = xf[0];
  int k = xi[0];
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
  }
  const long long t1 = clock64();
  xf[0] = x;
  xi[0] = k;
  cycles[0] = t1 - t0;
}

extern "C" {

// cycles per instruction of class op (0-4); sel counts its two
// instructions.  Returns a cudaError_t.
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
  *per_instruction = (double)best / (CHAIN * (op == 2 ? 2 : 1));
  return err;
}

}  // extern "C"
