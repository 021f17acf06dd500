// Host stand-in for the CUDA names the port's kernels use, so that a kernel
// source compiles with g++ and runs on the CPU: every block of the grid runs
// in turn, its threads as std::threads meeting at a std::barrier for
// __syncthreads and for each warp shuffle.  Enough to check a kernel's
// indexing, masking and reductions against its plain version; it says
// nothing about speed, and the kernel runs on the card only after nvcc.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(x)
#define __restrict__
typedef void* cudaStream_t;
struct uchar4 { unsigned char x, y, z, w; };
struct char4 { signed char x, y, z, w; };
struct int4 { int x, y, z, w; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim;
inline std::barrier<>* block_barrier = nullptr;
inline float shuffle_slots[1024];
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline void __threadfence() {}
// blocks run one at a time, so a plain add is atomic
inline int atomicAdd(int* p, int v) { int old = *p; *p += v; return old; }
inline unsigned atomicAdd(unsigned* p, unsigned v) { unsigned old = *p; *p += v; return old; }
inline int __clz(unsigned v) { return v ? __builtin_clz(v) : 32; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  shuffle_slots[threadIdx.x] = v;
  block_barrier->arrive_and_wait();
  const float other = shuffle_slots[threadIdx.x ^ lane_mask];
  block_barrier->arrive_and_wait();
  return other;
}
inline float fmaf(float a, float b, float c) { return a * b + c; }
// round-to-nearest add and multiply, never contracted into an FMA (the
// emulation compiles with -ffp-contract=off)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, sizeof f); return f; }
inline int cudaGetLastError() { return 0; }

// stands in for kernel<<<grid, threads, 0, stream>>>(args...)
template <class F> void host_launch(dim3 grid, int threads, F body) {
  gridDim = grid;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> bar(threads);
        block_barrier = &bar;
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([=] { threadIdx = dim3(t); blockIdx = dim3(x, y, z); body(); });
        for (auto& th : ts) th.join();
      }
}
