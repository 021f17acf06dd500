// Host stand-in for the CUDA names the port's kernels use, so that a kernel
// source compiles with g++ and runs on the CPU: every block of the grid runs
// in turn, its threads as std::threads meeting at a std::barrier for
// __syncthreads and for each warp shuffle.  Enough to check a kernel's
// indexing, masking and reductions against its plain version; it says
// nothing about speed, and the kernel runs on the card only after nvcc.
// A kernel's inline PTX sits behind __device__ helpers guarded by
// __CUDA_ARCH__; under CUDA_HOST_EMULATION they call the host_* stand-ins
// below instead (cp.async, mma.sync).
#pragma once
#define CUDA_HOST_EMULATION 1
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(x)
#define __restrict__
typedef void* cudaStream_t;
struct uchar4 { unsigned char x, y, z, w; };
struct char4 { signed char x, y, z, w; };
struct int4 { int x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim;
inline std::barrier<>* block_barrier = nullptr;
// one barrier per warp of the running block, for __syncwarp: the warps of a
// kernel may meet a different number of them
inline std::vector<std::barrier<>*> warp_barriers;
inline float shuffle_slots[1024];
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { warp_barriers[threadIdx.x / 32]->arrive_and_wait(); }
inline void __threadfence() {}
// the threads of a block run at once: shared-memory atomics must be atomic
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_RELAXED); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
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
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, sizeof u); return u; }
// byte i of the result is byte (s >> 4i) & 7 of the pair (x, y), x's bytes first
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t(y) << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= unsigned((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}

// bf16 as its 16 bits; widening to f32 is exact
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 h) { return __uint_as_float(unsigned(h.bits) << 16); }

// cp.async of 16 bytes, done at once (zero-filled when !valid); the
// commit/wait helpers have nothing to wait for
inline void host_cp_async16(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 16);
  else std::memset(dst, 0, 16);
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 as a warp collective:
// every lane posts its A and B fragments (the PTX ISA's layout: groupID =
// lane / 4, threadID_in_group = lane % 4, the lower-indexed element in the
// low 16 bits), the block meets (every warp of the kernel calls it alike),
// each lane computes its four outputs of D (products exact, summed in k
// order in f32), and the block meets again
inline uint32_t mma_a_slots[1024][4];
inline uint32_t mma_b_slots[1024][2];
inline void host_mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                                   const uint32_t (&b)[2]) {
  const unsigned t = threadIdx.x;
  for (int i = 0; i < 4; ++i) mma_a_slots[t][i] = a[i];
  for (int i = 0; i < 2; ++i) mma_b_slots[t][i] = b[i];
  block_barrier->arrive_and_wait();
  const unsigned base = t & ~31u, lane = t & 31u, gid = lane >> 2, tig = lane & 3;
  auto half = [](uint32_t reg, int k) { return __bfloat162float({uint16_t(reg >> (16 * (k & 1)))}); };
  auto A = [&](int r, int k) {
    return half(mma_a_slots[base + (r % 8) * 4 + (k % 8) / 2][(r >= 8) + 2 * (k >= 8)], k);
  };
  auto B = [&](int k, int n) { return half(mma_b_slots[base + n * 4 + (k % 8) / 2][k >= 8], k); };
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int r = gid + 8 * (e >> 1), n = 2 * tig + (e & 1);
    float s = 0.f;
    for (int k = 0; k < 16; ++k) s += A(r, k) * B(k, n);
    out[e] = d[e] + s;
  }
  block_barrier->arrive_and_wait();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}
// mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 as a warp collective,
// written from the PTX ISA's figures for .u8/.s8 m16n8k32 (groupID = lane / 4,
// threadID_in_group = lane % 4, the lower-indexed element in the low byte):
//   A (16 x 32, row), 4 registers of 4 bytes: a0 row groupID, a1 row
//     groupID + 8, a2 and a3 the same rows 16 columns on; the columns of a
//     register are threadID_in_group * 4 + 0..3;
//   B (32 x 8, col), 2 registers: b0 rows threadID_in_group * 4 + 0..3,
//     b1 the same rows + 16, column groupID;
//   C and D (16 x 8, s32): c0, c1 row groupID, c2, c3 row groupID + 8,
//     columns threadID_in_group * 2 + 0..1.
// Products of unsigned bytes summed exactly, then added to C, wrapping as
// the s32 accumulator does
inline void host_mma_m16n8k32_u8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2],
                                 const int (&c)[4]) {
  const unsigned t = threadIdx.x;
  int cin[4];
  for (int i = 0; i < 4; ++i) cin[i] = c[i];
  for (int i = 0; i < 4; ++i) mma_a_slots[t][i] = a[i];
  for (int i = 0; i < 2; ++i) mma_b_slots[t][i] = b[i];
  block_barrier->arrive_and_wait();
  const unsigned base = t & ~31u, lane = t & 31u, gid = lane >> 2, tig = lane & 3;
  auto byte = [](uint32_t reg, int k) { return (reg >> (8 * (k % 4))) & 0xFFu; };
  // element (r, k) of A lies with lane (r % 8) * 4 + (k % 16) / 4, register
  // (r >= 8) + 2 * (k >= 16); element (k, n) of B with lane n * 4 + (k % 16) / 4,
  // register (k >= 16)
  auto A = [&](int r, int k) {
    return byte(mma_a_slots[base + (r % 8) * 4 + (k % 16) / 4][(r >= 8) + 2 * (k >= 16)], k);
  };
  auto B = [&](int k, int n) { return byte(mma_b_slots[base + n * 4 + (k % 16) / 4][k >= 16], k); };
  int out[4];
  for (int e = 0; e < 4; ++e) {
    const int r = gid + 8 * (e >> 1), n = 2 * tig + (e & 1);
    uint32_t s = static_cast<uint32_t>(cin[e]);
    for (int k = 0; k < 32; ++k) s += A(r, k) * B(k, n);
    out[e] = static_cast<int>(s);
  }
  block_barrier->arrive_and_wait();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}
inline int cudaGetLastError() { return 0; }
// the device the emulation reports: two SMs
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 2; return 0; }
// one resident block per SM
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return 0;
}
constexpr int cudaErrorInvalidValue = 1;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
// a kernel's dynamic shared memory: blocks run one at a time, so one buffer
alignas(16) inline unsigned char host_dynamic_smem[256 * 1024];

// stands in for kernel<<<grid, threads, 0, stream>>>(args...)
template <class F> void host_launch(dim3 grid, int threads, F body) {
  gridDim = grid;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> bar(threads);
        block_barrier = &bar;
        std::vector<std::unique_ptr<std::barrier<>>> warps;
        warp_barriers.clear();
        for (int w = 0; w < (threads + 31) / 32; ++w) {
          warps.push_back(std::make_unique<std::barrier<>>(std::min(32, threads - 32 * w)));
          warp_barriers.push_back(warps.back().get());
        }
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([=] { threadIdx = dim3(t); blockIdx = dim3(x, y, z); body(); });
        for (auto& th : ts) th.join();
      }
}
