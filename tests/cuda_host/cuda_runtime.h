// Host stand-in for the CUDA names the port's kernels use, so that a kernel
// source compiles with g++ and runs on the CPU: every block of the grid runs
// in turn (the blocks of a thread-block cluster together), its threads as
// std::threads meeting at a std::barrier for __syncthreads and for each warp
// shuffle.  Enough to check a kernel's indexing, masking, pipelines and
// reductions against its plain version; it says nothing about speed, and the
// kernel runs on the card only after nvcc.  A kernel's inline PTX sits
// behind __device__ helpers guarded by __CUDA_ARCH__; under
// CUDA_HOST_EMULATION they call the host_* stand-ins below instead
// (cp.async, mma.sync, mbarrier, TMA, wgmma, clusters).
//
// The 128-byte swizzle: the TMA stand-in writes it and the wgmma stand-in
// and the kernel's own shared loads undo it by the same formula (16-byte
// chunk c of a 128-byte row r lands at chunk c ^ (r % 8)).  Both sides
// agree by construction, so only the card can show that the formula is the
// hardware's.
#pragma once
#define CUDA_HOST_EMULATION 1
#include <algorithm>
#include <barrier>
#include <cassert>
#include <condition_variable>
#include <functional>
#include <map>
#include <mutex>
#include <tuple>
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
#define __grid_constant__
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
// the running block's barrier for __syncthreads, and one barrier per warp,
// for __syncwarp (the warps of a kernel may meet a different number of
// them); thread-local, since the blocks of a cluster run at once
inline thread_local std::barrier<>* block_barrier = nullptr;
inline thread_local std::barrier<>** warp_barriers = nullptr;
// the running block's dynamic shared memory
inline thread_local unsigned char* host_dynamic_smem = nullptr;
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
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
typedef int cudaError_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }

// ---- thread groups: a barrier whose last arriver runs a function while the
// others wait (the wgmma stand-in computes a warpgroup's products there)
struct HostGroup {
  std::mutex mu;
  std::condition_variable cv;
  int count, arrived = 0;
  uint64_t generation = 0;
  explicit HostGroup(int n) : count(n) {}
  void sync(const std::function<void()>& last = {}) {
    std::unique_lock<std::mutex> lk(mu);
    const uint64_t g = generation;
    if (++arrived == count) {
      if (last) last();
      arrived = 0;
      ++generation;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return generation != g; });
    }
  }
};

// one issued wgmma of one thread, run when the warpgroup waits on it
struct HostWgmma {
  float* d;
  int n;              // the tile's columns (wgmma's N); d holds n / 2 floats
  uint32_t a[4];
  uint64_t desc;
};

// one running block: its barriers, its shared memory, its rank in its cluster
struct HostCluster;
struct HostBlock {
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<std::barrier<>*> warp_ptrs;
  std::vector<std::unique_ptr<HostGroup>> groups;   // one per warpgroup
  std::vector<std::vector<HostWgmma>> issued;       // per thread, since the last wait
  std::mutex named_mu;
  std::map<int, std::unique_ptr<HostGroup>> named;  // bar.sync's barriers 1..15
  std::vector<unsigned char> storage;
  unsigned char* smem;
  unsigned rank = 0;
  HostCluster* cluster = nullptr;
  HostBlock(int threads, size_t smem_bytes, unsigned char* shared = nullptr)
      : bar(threads), issued(threads) {
    for (int w = 0; w < (threads + 31) / 32; ++w) {
      warps.push_back(std::make_unique<std::barrier<>>(std::min(32, threads - 32 * w)));
      warp_ptrs.push_back(warps.back().get());
    }
    for (int g = 0; g < (threads + 127) / 128; ++g)
      groups.push_back(std::make_unique<HostGroup>(std::min(128, threads - 128 * g)));
    if (shared != nullptr) {
      smem = shared;
    } else {   // 1024-aligned, as the kernels' swizzled tiles want
      storage.resize(smem_bytes + 1024);
      smem = storage.data() + (1024 - reinterpret_cast<uintptr_t>(storage.data()) % 1024) % 1024;
    }
  }
};
struct HostCluster {
  std::vector<HostBlock*> blocks;
  std::unique_ptr<std::barrier<>> bar;   // every thread of every block
};
inline thread_local HostBlock* host_block = nullptr;

// a kernel's dynamic shared memory under <<<>>>: blocks run one at a time,
// so one buffer
alignas(1024) inline unsigned char host_smem_buffer[256 * 1024];

inline void host_enter(HostBlock* b, unsigned t, dim3 block) {
  host_block = b;
  block_barrier = &b->bar;
  warp_barriers = b->warp_ptrs.data();
  host_dynamic_smem = b->smem;
  threadIdx = dim3(t);
  blockIdx = block;
}

// stands in for kernel<<<grid, threads, 0, stream>>>(args...)
template <class F> void host_launch(dim3 grid, int threads, F body) {
  gridDim = grid;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        HostBlock b(threads, 0, host_smem_buffer);
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([=, &b] { host_enter(&b, t, dim3(x, y, z)); body(); });
        for (auto& th : ts) th.join();
      }
}

// ---- shared-space addresses: offsets into the running block's shared memory
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<size_t>(static_cast<const unsigned char*>(p) - host_dynamic_smem);
}

// ---- mbarrier: arrivals and transaction bytes; a phase completes when both
// reach zero, and then the barrier's phase bit flips
struct HostMbar { int expected = 0, pending = 0; long tx = 0; unsigned phase = 0; };
inline std::mutex mbar_mu;
inline std::condition_variable mbar_cv;
inline std::map<const void*, HostMbar> mbars;
inline void host_mbar_settle(HostMbar& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1u;
    b.pending = b.expected;
    mbar_cv.notify_all();
  }
}
inline void host_mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> lk(mbar_mu);
  mbars[bar] = HostMbar{count, count, 0, 0};
}
inline void host_mbar_arrive(uint64_t* bar, long tx_bytes = 0) {
  std::lock_guard<std::mutex> lk(mbar_mu);
  HostMbar& b = mbars.at(bar);
  b.tx += tx_bytes;
  assert(b.pending > 0);
  --b.pending;
  host_mbar_settle(b);
}
inline void host_mbar_complete_tx(uint64_t* bar, long bytes) {
  std::lock_guard<std::mutex> lk(mbar_mu);
  HostMbar& b = mbars.at(bar);
  b.tx -= bytes;
  host_mbar_settle(b);
}
// mbarrier.try_wait.parity in a loop: returns once the phase of parity
// ``parity`` has completed (the barrier's phase bit differs from it)
inline void host_mbar_wait(uint64_t* bar, unsigned parity) {
  std::unique_lock<std::mutex> lk(mbar_mu);
  mbar_cv.wait(lk, [&] { return mbars.at(bar).phase != (parity & 1u); });
}

// ---- tensor maps and TMA: the CUDA driver's cuTensorMapEncodeTiled keeps what a
// 2-D tile load needs; the load copies the box (zeros out of bounds) in the
// 128-byte swizzle and completes the barrier's bytes
typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;
typedef int CUresult;
constexpr int CUDA_SUCCESS = 0;
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_UINT8 = 0, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_128B = 3 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_NONE = 0,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B = 3 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
struct alignas(64) CUtensorMap { uint64_t opaque[16]; };
struct HostTensorMap {
  const unsigned char* base;
  uint64_t dim[2], stride;   // elements; the row stride in bytes
  uint32_t box[2], elem;     // elements; bytes per element
  int swizzle;
};
static_assert(sizeof(HostTensorMap) <= sizeof(CUtensorMap), "the map fits its opaque bytes");
inline CUresult cuTensorMapEncodeTiled(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
                                       void* base, const cuuint64_t* dim,
                                       const cuuint64_t* strides, const cuuint32_t* box,
                                       const cuuint32_t* elem_strides, CUtensorMapInterleave,
                                       CUtensorMapSwizzle swizzle, CUtensorMapL2promotion,
                                       CUtensorMapFloatOOBfill) {
  const uint32_t elem = type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : 1;
  // the CUDA driver's rules that the kernel's maps must keep
  if (rank != 2 || reinterpret_cast<uintptr_t>(base) % 16 || strides[0] % 16 ||
      box[0] == 0 || box[1] == 0 || box[0] > 256 || box[1] > 256 ||
      elem_strides[0] != 1 || elem_strides[1] != 1 ||
      (swizzle == CU_TENSOR_MAP_SWIZZLE_128B && box[0] * elem > 128))
    return 1;
  HostTensorMap h{static_cast<const unsigned char*>(base), {dim[0], dim[1]}, strides[0],
                  {box[0], box[1]}, elem, swizzle};
  std::memset(map, 0, sizeof *map);
  std::memcpy(map, &h, sizeof h);
  return CUDA_SUCCESS;
}
// the byte offset within a 1024-byte-aligned tile where 128-byte swizzling
// puts logical offset o: its 16-byte chunk XOR its row's index mod 8
inline uint32_t host_swizzle128(uint32_t o) { return o ^ (((o >> 7) & 7u) << 4); }
inline void host_tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                             uint64_t* bar) {
  HostTensorMap h;
  std::memcpy(&h, map, sizeof h);
  const uint32_t row_bytes = h.box[0] * h.elem;
  assert(h.swizzle != CU_TENSOR_MAP_SWIZZLE_128B || dst % 1024 == 0);
  for (uint32_t r = 0; r < h.box[1]; ++r)
    for (uint32_t b = 0; b < row_bytes; ++b) {
      const uint64_t i0 = uint64_t(c0) + b / h.elem, i1 = uint64_t(c1) + r;
      const uint32_t o = r * row_bytes + b;
      const uint32_t at = h.swizzle == CU_TENSOR_MAP_SWIZZLE_128B ? host_swizzle128(o) : o;
      host_dynamic_smem[dst + at] =
          i0 < h.dim[0] && i1 < h.dim[1] ? h.base[i1 * h.stride + i0 * h.elem + b % h.elem] : 0;
    }
  host_mbar_complete_tx(bar, long(row_bytes) * h.box[1]);
}

// the CUDA driver entry point the kernels take cuTensorMapEncodeTiled from
#define CUDART_VERSION 12080
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0 };
constexpr unsigned long long cudaEnableDefault = 0;
inline int cudaGetDriverEntryPointByVersion(const char* name, void** fn, unsigned,
                                            unsigned long long,
                                            cudaDriverEntryPointQueryResult* q) {
  *fn = std::strcmp(name, "cuTensorMapEncodeTiled") == 0
            ? reinterpret_cast<void*>(&cuTensorMapEncodeTiled) : nullptr;
  if (q) *q = cudaDriverEntryPointSuccess;
  return *fn ? 0 : 1;
}

// ---- wgmma.mma_async m64nNk16 f32 += bf16 x bf16, A from registers, B from
// shared memory by descriptor, as a warpgroup collective.  An issued wgmma
// only records its operands; wgmma.wait_group 0 meets the warpgroup, and the
// last thread to arrive runs every recorded one in issue order (so a read of
// the accumulators before the wait sees them unchanged, as the card makes
// no promise either way).  A is the PTX fragment layout of m16k16 per warp
// (warp w holds rows 16w..16w+15): register i of lane l holds row l/4 +
// 8 (i & 1), columns 2 (l % 4) + 8 (i >> 1) + {0, 1}, the lower column in
// the low 16 bits.  B is K-major with the 128-byte swizzle: column n of B
// (row n of the tile) at start + (n / 8) * SBO + (n % 8) * 128, element k
// 2k bytes on, the address then swizzled.  D: register q of lane l of warp
// w holds row 16w + l/4 + 8 ((q / 2) % 2), column 8 (q / 4) + 2 (l % 4) + q % 2.
inline void host_wgmma_issue(float* d, int n, const uint32_t (&a)[4], uint64_t desc) {
  host_block->issued[threadIdx.x].push_back(HostWgmma{d, n, {a[0], a[1], a[2], a[3]}, desc});
}
inline void host_wgmma_wait() {
  HostBlock* blk = host_block;
  const unsigned g = threadIdx.x / 128;
  blk->groups[g]->sync([blk, g] {
    const size_t ops = blk->issued[128 * g].size();
    for (unsigned t = 0; t < 128; ++t) assert(blk->issued[128 * g + t].size() == ops);
    for (size_t i = 0; i < ops; ++i) {
      const HostWgmma& op0 = blk->issued[128 * g][i];
      const int n = op0.n;
      assert(op0.desc >> 62 == 1);   // the 128-byte swizzle
      const uint32_t start = uint32_t(op0.desc & 0x3FFF) << 4;
      const uint32_t sbo = uint32_t((op0.desc >> 32) & 0x3FFF) << 4;
      float A[64][16], B[16][256];
      for (unsigned t = 0; t < 128; ++t) {
        const HostWgmma& op = blk->issued[128 * g + t][i];
        assert(op.desc == op0.desc && op.n == n);
        const unsigned w = t / 32, lane = t % 32;
        for (int r = 0; r < 4; ++r)
          for (int h = 0; h < 2; ++h)
            A[16 * w + lane / 4 + 8 * (r & 1)][2 * (lane % 4) + 8 * (r >> 1) + h] =
                __bfloat162float({uint16_t(op.a[r] >> (16 * h))});
      }
      for (int c = 0; c < n; ++c)
        for (int k = 0; k < 16; ++k) {
          const uint32_t addr = start + (c / 8) * sbo + (c % 8) * 128 + 2 * k;
          uint16_t v;
          std::memcpy(&v, blk->smem + (addr & ~1023u) + host_swizzle128(addr & 1023u), 2);
          B[k][c] = __bfloat162float({v});
        }
      for (unsigned t = 0; t < 128; ++t) {
        const HostWgmma& op = blk->issued[128 * g + t][i];
        const unsigned w = t / 32, lane = t % 32;
        for (int q = 0; q < n / 2; ++q) {
          const int row = 16 * w + lane / 4 + 8 * ((q / 2) % 2);
          const int col = 8 * (q / 4) + 2 * (lane % 4) + q % 2;
          float s = 0.f;
          for (int k = 0; k < 16; ++k) s += A[row][k] * B[k][col];
          op.d[q] += s;
        }
      }
    }
    for (unsigned t = 0; t < 128; ++t) blk->issued[128 * g + t].clear();
  });
}
// bar.sync id, count: the first ``count`` threads that name barrier ``id``
inline void host_named_barrier(int id, int count) {
  HostGroup* g;
  {
    std::lock_guard<std::mutex> lk(host_block->named_mu);
    auto& slot = host_block->named[id];
    if (!slot) slot = std::make_unique<HostGroup>(count);
    g = slot.get();
  }
  g->sync();
}

// ---- thread-block clusters: the blocks of one cluster run at once, each
// with its own shared memory; a cluster barrier meets all their threads, and
// a distributed shared address is (rank << 20) | offset
inline unsigned host_cluster_rank() { return host_block->rank; }
inline unsigned host_cluster_size() {
  return host_block->cluster ? unsigned(host_block->cluster->blocks.size()) : 1u;
}
inline void host_cluster_sync() {
  if (host_block->cluster) host_block->cluster->bar->arrive_and_wait();
}
inline uint32_t host_mapa(uint32_t addr, unsigned rank) { return (rank << 20) | addr; }
inline const unsigned char* host_cluster_ptr(uint32_t caddr) {
  return host_block->cluster->blocks.at(caddr >> 20)->smem + (caddr & 0xFFFFFu);
}

// cudaLaunchKernelEx with a cluster dimension: every cluster's blocks run
// together, clusters in turn
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
union cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
  char pad[64];
};
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... Exp, class... Act>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Exp...), Act&&... args) {
  dim3 cl(1, 1, 1);
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cl = dim3(cfg->attrs[i].val.clusterDim.x, cfg->attrs[i].val.clusterDim.y,
                cfg->attrs[i].val.clusterDim.z);
  const dim3 grid = cfg->gridDim;
  if (grid.x % cl.x || grid.y % cl.y || grid.z % cl.z) return cudaErrorInvalidValue;
  gridDim = grid;
  const int threads = int(cfg->blockDim.x);
  const std::tuple<std::decay_t<Exp>...> params(std::forward<Act>(args)...);
  for (unsigned z0 = 0; z0 < grid.z; z0 += cl.z)
    for (unsigned y0 = 0; y0 < grid.y; y0 += cl.y)
      for (unsigned x0 = 0; x0 < grid.x; x0 += cl.x) {
        HostCluster cluster;
        std::vector<std::unique_ptr<HostBlock>> blocks;
        std::vector<dim3> where;
        for (unsigned z = 0; z < cl.z; ++z)
          for (unsigned y = 0; y < cl.y; ++y)
            for (unsigned x = 0; x < cl.x; ++x) {
              blocks.push_back(std::make_unique<HostBlock>(threads, cfg->dynamicSmemBytes));
              blocks.back()->rank = unsigned(cluster.blocks.size());
              blocks.back()->cluster = &cluster;
              cluster.blocks.push_back(blocks.back().get());
              where.push_back(dim3(x0 + x, y0 + y, z0 + z));
            }
        cluster.bar = std::make_unique<std::barrier<>>(threads * int(blocks.size()));
        std::vector<std::thread> ts;
        for (size_t b = 0; b < blocks.size(); ++b)
          for (int t = 0; t < threads; ++t)
            ts.emplace_back([&, b, t] {
              host_enter(blocks[b].get(), unsigned(t), where[b]);
              auto p = params;   // each thread its own copy of the parameters
              std::apply(kernel, p);
            });
        for (auto& th : ts) th.join();
      }
  return cudaSuccess;
}
