// Issue-rate probe: dependent-free chains of one instruction class per
// thread, for tools/lane_rate_probe.py. Classes: 0 float32 add, 1 float32
// min/max, 2 32-bit integer xor/add, 3 population count, 4 32-bit integer
// min/max, 5 float32 min and integer max in turns (do they share a
// pipe?). Each thread runs kChains independent chains; every trip of the
// loop issues kOps instructions of the class on each chain. The
// instructions are volatile PTX, so the compiler's front end neither folds
// nor drops them; the assembler still may (it joins the two integer max of
// class 5 into one three-input VIMNMX3), which the tool's instruction
// histogram shows. Thread 0 of block 0 also reads the SM's cycle counter
// and the global nanosecond timer around its loop, which gives the SM
// clock during the run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;
constexpr int kOps = 16;   // instructions per chain and trip (kOps / 2 pairs)

template <int kClass>
__global__ void __launch_bounds__(256)
probe_kernel(int trips, float fa, float fb, uint32_t ia, uint32_t ib, float* sink,
             long long* clocks) {
  float x[kChains];
  uint32_t u[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    x[c] = fa * static_cast<float>(threadIdx.x + c);
    u[c] = ia * (threadIdx.x + c + 1u);
  }
  unsigned long long g0, g1;
  const long long t0 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  for (int i = 0; i < trips; ++i) {
#pragma unroll
    for (int k = 0; k < kOps / 2; ++k) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        if (kClass == 0) {
          asm volatile("add.f32 %0, %0, %1;\n\tadd.f32 %0, %0, %2;" : "+f"(x[c]) : "f"(fa), "f"(fb));
        } else if (kClass == 1) {
          asm volatile("min.f32 %0, %0, %1;\n\tmax.f32 %0, %0, %2;" : "+f"(x[c]) : "f"(fa), "f"(fb));
        } else if (kClass == 2) {
          asm volatile("xor.b32 %0, %0, %1;\n\tadd.u32 %0, %0, %2;" : "+r"(u[c]) : "r"(ia), "r"(ib));
        } else if (kClass == 3) {
          asm volatile("popc.b32 %0, %0;\n\tpopc.b32 %0, %0;" : "+r"(u[c]));
        } else if (kClass == 4) {
          asm volatile("min.s32 %0, %0, %1;\n\tmax.s32 %0, %0, %2;" : "+r"(u[c]) : "r"(ia), "r"(ib));
        } else {
          asm volatile("min.f32 %0, %0, %1;" : "+f"(x[c]) : "f"(fa));
          asm volatile("max.s32 %0, %0, %1;" : "+r"(u[c]) : "r"(ib));
        }
      }
    }
  }
  const long long t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += x[c] + static_cast<float>(u[c]);
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    clocks[0] = t1 - t0;
    clocks[1] = static_cast<long long>(g1 - g0);
  }
}

}  // namespace

// instructions of the class that one thread issues in `trips` trips
extern "C" int gmmloc_probe_ops_per_thread(int trips) { return trips * kOps * kChains; }

// sink: blocks * 256 floats; clocks: 2 int64 (SM cycles, nanoseconds)
extern "C" int gmmloc_lane_probe(int cls, int blocks, int trips, void* sink, void* clocks,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(sink);
  long long* clk = static_cast<long long*>(clocks);
  const float fa = 1.25f, fb = -1.25f;
  const uint32_t ia = 0x9E3779B9u, ib = 0x7F4A7C15u;
  switch (cls) {
    case 0: probe_kernel<0><<<blocks, 256, 0, s>>>(trips, fa, fb, ia, ib, out, clk); break;
    case 1: probe_kernel<1><<<blocks, 256, 0, s>>>(trips, fa, fb, ia, ib, out, clk); break;
    case 2: probe_kernel<2><<<blocks, 256, 0, s>>>(trips, fa, fb, ia, ib, out, clk); break;
    case 3: probe_kernel<3><<<blocks, 256, 0, s>>>(trips, fa, fb, ia, ib, out, clk); break;
    case 4: probe_kernel<4><<<blocks, 256, 0, s>>>(trips, fa, fb, ia, ib, out, clk); break;
    case 5: probe_kernel<5><<<blocks, 256, 0, s>>>(trips, fa, fb, ia, ib, out, clk); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
