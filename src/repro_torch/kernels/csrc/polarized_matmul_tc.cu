// Polarized-magnitude matmul on Hopper's tensor cores (sm_90a), bf16 x:
//
//   y[M, N] = (x[M, K] @ (repeat(signs[K/m, N], m, axis=0) * mags[K, N])) * scale[N]
//
// x bf16, mags uint8, signs int8 +-1, scale f32, y f32 (f32 accumulation).
//
// Replaces, for bf16 activations and uint8 codes at M >= TC_MIN_ROWS and
// N >= TC_MIN_COLS (the prefill of a bf16 served model), the Pallas TPU
// kernels src/repro/kernels/polarized_matmul.py:45 (_kernel, dense) and
// src/repro/kernels/polarized_matmul.py:68 (_kernel_skip, input
// zero-skipping).  polarized_matmul.cu keeps decode, narrow N, int32 codes
// (bits > 8) and f32 activations.
//
// Why the products are exact.  Every operand is exact in bf16: a bf16
// activation, a magnitude code 0..255 (8 significant bits, as bf16 has) and
// a sign of +-1.  A bf16 x bf16 product has at most 16 significant bits, so
// it is exact in the f32 accumulator: the tensor cores compute the same
// products as the f32 kernel on x widened to f32, and only the order (and
// the tensor core's alignment) of the summation differs -- the tolerance
// class of the f32 kernel's K split.
//
// What bounds it.  One qwen2-1.5b layer (7 projections) at M = 64 moves
// 46.8 MB of codes, 5.9 MB of signs, 2.3 MB of x and 5.9 MB of y: ~0.018 ms
// at 3.35 TB/s, against 6.0 GFLOP = 0.006 ms at the 989 TFLOP/s bf16 rate
// -- bytes.  The mma.sync design this file held before ran at ~10x that
// bound, and dropping its x or its code loads, more warps, wider tiles or
// more stages moved it little: what held it was the chain of dependent
// steps each block waits through (a 3-stage cp.async ring waited on stage by
// stage, the two K parities added through shared memory, a partial written
// to L2, a fence and an atomic ticket, then the last block re-reading up to
// 9 partials).  This design shortens that chain:
//   * the operands are swapped, so that the weights are the register operand
//     of wgmma: yT[N, M] = WT[N, K] . xT[K, M] with
//     wgmma.mma_async.m64nNk16.f32.bf16.bf16.  A is 64 weight columns by 16
//     K rows, made in registers: one 32-bit shared load gives a thread the
//     codes of one K row in 4 columns (columns 32w + 4g + j of warp w, group
//     g: byte j = 2t + h is row g + 8h of wgmma tile t), and each code widens
//     exactly to bf16 (its byte under the exponent of 2^23, minus 2^23, top
//     16 bits) with the fragment sign put in the sign bit -- wgmma's register
//     A has mma.sync's m16k16 layout per warp.  B is the x tile, read from
//     shared memory by a descriptor: K-major, 128-byte swizzled, 64 bf16 of
//     K per row.  The tokens are wgmma's N (8, 16, 32 or 64), so M = 4..64
//     pays for the next of those, not for 64 rows;
//   * one block per (128-column tile, token tile, K slice), 4 consumer warps
//     (one warpgroup: the widening and the wgmma) and one producer warp that
//     requests the block's whole K range at once: TMA tile loads
//     (cp.async.bulk.tensor.2d, 128-byte swizzle, zeros out of bounds) of x,
//     the codes and the stage's sign rows, into a ring of 64-row stages with
//     one mbarrier each.  Where the range fits in shared memory (227 KB) every
//     load is in flight before the first wgmma; else the ring refills as the
//     consumers release stages.  The swizzle makes the consumers' 32-bit code
//     loads conflict-free (a warp's 4 K rows fall in 4 disjoint bank groups);
//   * the K slices of one output tile are one thread-block cluster (at most
//     8, portable): after a cluster barrier, rank 0 adds the other ranks'
//     tiles, read through distributed shared memory in rank order, to its own,
//     multiplies by ``scale`` once and writes y.  No partial goes to L2, no
//     float atomics: two launches give equal bits, and the route allocates
//     nothing per call.
// ``mask`` holds one int per (64-row tile of x, 256-row K slice); a block
// skips its dead stages: no loads and no wgmma.  A block whose stages are
// all dead still joins its cluster's sum, with zeros.  The dense launch runs
// those stages' products on all-zero x, exact zeros, so the accumulators
// come out unchanged and skip equals dense bit for bit (checked on the card).
// ``gate`` (one int on the device), when it reads 0, returns every block of
// the launch before any barrier (fragment compaction launches two gated
// products into one output).  Rows past M and columns past N meet
// zero-filled x and codes and are never written.  Shapes that TMA cannot
// describe -- K % 8 or N % 16 nonzero, unaligned bases, or fragments that do
// not divide a 64-row stage (m = 3) -- fill the same ring by plain loads from
// the producer warp, for the same consumers (``Tma = false``).
// What bounds it now (PERF.md, H100): one layer at M = 64 takes ~0.126 ms,
// ~7x its byte bound and ~1.2x one bf16 torch.matmul on the pre-folded
// weight (0.182 ms before this design).  A block's stages arrive at ~0.4 us
// each (~40 GB/s per SM) whatever the ring's depth, and a consumer that
// skips the widening and the wgmma runs about as fast: the per-stage load
// path sets the time, so the K range is spread over as many SMs as one wave
// holds (tc_group), and the cluster's sum is a reduce-scatter so that no
// rank waits on all of it.  Not done: clusters of 16, TMA multicast of x
// across column tiles, token tiles of 128 or 256 rows (M = 256 runs three
// waves of 64-row tiles at ~2x the library call).
// Under the tests' host emulation the 128-byte swizzle is written and read
// by the same formula on both sides, so only the card shows that it is the
// hardware's.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#ifndef CUDA_HOST_EMULATION
#include <cuda.h>   // CUtensorMap and cuTensorMapEncodeTiled's type only: the
                    // function itself comes from cudaGetDriverEntryPoint, so
                    // nothing links against libcuda
#endif

namespace {

constexpr int BM = 64;            // rows of x per mask tile; a token tile holds at most this
constexpr int BN = 128;           // output columns per block: two m64 wgmma tiles
constexpr int KC = 256;           // K rows per mask tile (the zero-skip granule)
constexpr int KS = 64;            // K rows per stage: one 128-byte swizzle row of bf16 x
constexpr int KK = KS / 16;       // wgmma k16 steps per stage
constexpr int MAX_CLUSTER = 8;    // K slices per output tile: a portable cluster
constexpr int WG = 128;           // a warpgroup: it widens the codes and issues wgmma
constexpr int CONSUMERS = 2 * WG; // two of them, on alternate stages
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp loads
constexpr int ATOM = 1024;        // the 128-byte swizzle's period: 8 rows of 128 bytes
constexpr int MAX_RING = 64;      // stages in the ring, at most
constexpr int HEADER = 2 * ATOM;  // alignment slack, then the ring's 2 x MAX_RING barriers
constexpr int SMEM_MAX = 232448;  // 227 KB: the most dynamic shared memory a block gets
static_assert(2 * MAX_RING * 8 <= ATOM, "the barriers fit their atom");

__host__ __device__ constexpr int round_atom(int b) { return (b + ATOM - 1) / ATOM * ATOM; }
// sign rows a stage holds: 64/m when m divides the stage (the TMA path), else
// rows k0/m .. (k0 + KS - 1)/m at most
__host__ __device__ constexpr int sign_rows(int m, bool whole) {
  return whole ? KS / m : (KS - 1) / m + 2;
}
__host__ __device__ constexpr int x_tile_bytes(int nt) { return round_atom(nt * 2 * KS); }
// one stage: the x tile (nt rows of 64 bf16), the codes (64 rows of 128
// bytes) and the sign rows (of 128 bytes), each on its own atom
__host__ __device__ constexpr int stage_bytes(int nt, int srows) {
  return x_tile_bytes(nt) + KS * BN + round_atom(srows * BN);
}
// where the 128-byte swizzle puts logical byte o of a tile of 128-byte rows
__host__ __device__ constexpr uint32_t swz(uint32_t o) { return o ^ (((o >> 7) & 7u) << 4); }

// ---- the PTX helpers: the card runs the asm; the g++ host emulation of the
// tests supplies host_* stand-ins (tests/cuda_host/cuda_runtime.h)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
#elif defined(CUDA_HOST_EMULATION)
  host_mbar_init(bar, count);
#endif
}

__device__ __forceinline__ void mbar_init_fence() {
#ifdef __CUDA_ARCH__
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
#elif defined(CUDA_HOST_EMULATION)
  host_mbar_arrive(bar);
#endif
}

// one arrival that also expects ``bytes`` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
#elif defined(CUDA_HOST_EMULATION)
  host_mbar_arrive(bar, bytes);
#endif
}

// returns once the barrier's phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
#ifdef __CUDA_ARCH__
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
#elif defined(CUDA_HOST_EMULATION)
  host_mbar_wait(bar, parity);
#endif
}

// a 2-D TMA tile load into shared memory, completing ``bar``'s bytes
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
#elif defined(CUDA_HOST_EMULATION)
  host_tma_load_2d(smem_u32(dst), map, c0, c1, bar);
#endif
}

// the producer's plain stores, made visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
#ifdef __CUDA_ARCH__
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_fence() {
#ifdef __CUDA_ARCH__
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
}

// returns once every wgmma this warpgroup committed has completed
__device__ __forceinline__ void wgmma_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#elif defined(CUDA_HOST_EMULATION)
  host_wgmma_wait();
#endif
}

// keeps the compiler from moving accumulator traffic across the fence/wait
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
#endif
}

// the consumer warpgroups' own barrier (barrier 0 is __syncthreads')
__device__ __forceinline__ void consumers_sync() {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
#elif defined(CUDA_HOST_EMULATION)
  host_named_barrier(1, CONSUMERS);
#endif
}

// the first use of a tensor map need not wait for its descriptor
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
#endif
}

__device__ __forceinline__ unsigned cluster_rank() {
#ifdef __CUDA_ARCH__
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
#elif defined(CUDA_HOST_EMULATION)
  return host_cluster_rank();
#else
  return 0;
#endif
}

__device__ __forceinline__ unsigned cluster_size() {
#ifdef __CUDA_ARCH__
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
#elif defined(CUDA_HOST_EMULATION)
  return host_cluster_size();
#else
  return 1;
#endif
}

// every thread of every block of the cluster: release, then acquire
__device__ __forceinline__ void cluster_sync() {
#ifdef __CUDA_ARCH__
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
#elif defined(CUDA_HOST_EMULATION)
  host_cluster_sync();
#endif
}

// 16 bytes of rank ``rank``'s shared memory at this block's address ``addr``
__device__ __forceinline__ float4 ld_cluster(uint32_t addr, unsigned rank) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#ifdef __CUDA_ARCH__
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
#elif defined(CUDA_HOST_EMULATION)
  std::memcpy(&v, host_cluster_ptr(host_mapa(addr, rank)), sizeof v);
#endif
  return v;
}

// the wgmma descriptor of a K-major bf16 tile with the 128-byte swizzle:
// start address, leading byte offset 16 (unused), 1024 bytes between groups
// of 8 rows, swizzle mode 1.  A k16 step within the 64 K of a row is 32
// bytes on: 2 in the start address field
__device__ __forceinline__ uint64_t x_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(ATOM >> 4) << 32) | (1ull << 62);
}

// d (64 x nt, f32) += a (64 x 16 bf16, registers) * B (16 x nt, the descriptor's tile)
template <int NT>
struct Wgmma;
template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
#elif defined(CUDA_HOST_EMULATION)
    host_wgmma_issue(d, 8, a, desc);
#endif
  }
};
template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
#elif defined(CUDA_HOST_EMULATION)
    host_wgmma_issue(d, 16, a, desc);
#endif
  }
};
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
#elif defined(CUDA_HOST_EMULATION)
    host_wgmma_issue(d, 32, a, desc);
#endif
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
#elif defined(CUDA_HOST_EMULATION)
    host_wgmma_issue(d, 64, a, desc);
#endif
  }
};

// byte j of two code words (K rows r and r+1) and of their sign words ->
// the two signed codes as packed bf16 (row r in the low half).  A code v
// becomes the float 2^23 + v by placing its byte under the exponent of
// 2^23, and v exactly after subtracting 2^23; its top 16 bits are the bf16,
// and the fragment sign goes into the sign bit.
__device__ __forceinline__ uint32_t signed_pair(uint32_t c0, uint32_t c1, uint32_t s0,
                                                uint32_t s1, int j) {
  const uint32_t sel = 0x7540u | j;   // byte j, then the bytes of 0x4B000000 above it
  const float f0 = __uint_as_float(__byte_perm(c0, 0x4B000000u, sel)) - 8388608.0f;
  const float f1 = __uint_as_float(__byte_perm(c1, 0x4B000000u, sel)) - 8388608.0f;
  const uint32_t bf = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632u);
  // byte j of each sign word into bytes 1 and 3: its top bit is the bf16 sign
  const uint32_t sg = __byte_perm(s0, s1, 0x4000u | (j << 12) | (j << 4)) & 0x80008000u;
  return bf ^ sg;
}

// the producer's plain loads of one stage (shapes TMA cannot describe): the
// same swizzled layout a TMA load writes, zeros past the edges
template <int NT>
__device__ __forceinline__ void load_stage_plain(unsigned char* st, const uint16_t* __restrict__ x,
                                                 const uint8_t* __restrict__ mags,
                                                 const int8_t* __restrict__ signs, int row0,
                                                 int col0, int k0, int M, int N, int K, int m,
                                                 int lane) {
  for (int e = lane; e < NT * KS; e += 32) {
    const int r = e / KS, c = e % KS, gr = row0 + r, gk = k0 + c;
    const uint16_t v = gr < M && gk < K ? x[static_cast<size_t>(gr) * K + gk] : 0;
    *reinterpret_cast<uint16_t*>(st + swz(r * 2 * KS + 2 * c)) = v;
  }
  unsigned char* codes = st + x_tile_bytes(NT);
  for (int e = lane; e < KS * BN; e += 32) {
    const int r = e / BN, c = e % BN, gk = k0 + r, gc = col0 + c;
    codes[swz(r * BN + c)] = gk < K && gc < N ? mags[static_cast<size_t>(gk) * N + gc] : 0;
  }
  unsigned char* srow = codes + KS * BN;
  const int s0 = k0 / m, rows = (min(k0 + KS, K) - 1) / m - s0 + 1;
  for (int e = lane; e < rows * BN; e += 32) {
    const int r = e / BN, c = e % BN, gc = col0 + c;
    srow[swz(r * BN + c)] =
        gc < N ? static_cast<uint8_t>(signs[static_cast<size_t>(s0 + r) * N + gc]) : 0;
  }
}

template <int NT, bool Tma>
__global__ void __launch_bounds__(THREADS, 1)
polarized_matmul_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_mags,
                           const __grid_constant__ CUtensorMap map_signs,
                           const uint16_t* __restrict__ x, const uint8_t* __restrict__ mags,
                           const int8_t* __restrict__ signs, const float* __restrict__ scale,
                           const int* __restrict__ mask, const int* __restrict__ gate,
                           float* __restrict__ y, int M, int N, int K, int m, int ring, int vec) {
  // the launch's gate comes first, before any barrier: uniform over the launch
  if (gate != nullptr && *gate == 0) return;
#ifdef CUDA_HOST_EMULATION
  unsigned char* raw = host_dynamic_smem;
#else
  extern __shared__ __align__(16) unsigned char raw[];
#endif
  // the swizzle wants every tile on a 1024-byte boundary of the shared space
  unsigned char* base = raw + (ATOM - smem_u32(raw) % ATOM) % ATOM;
  uint64_t* full = reinterpret_cast<uint64_t*>(base);   // a stage has landed
  uint64_t* empty = full + MAX_RING;                    // a stage is free again
  unsigned char* stages = base + ATOM;
  const int srows = sign_rows(m, Tma);
  const int sbytes = stage_bytes(NT, srows);

  const int tid = threadIdx.x;
  const unsigned rank = cluster_rank(), ranks = cluster_size();
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * NT;
  // this block's K slice: rank r of the cluster sums stages [s_begin, s_end)
  const int S = (K + KS - 1) / KS;
  const int per = (S + static_cast<int>(ranks) - 1) / static_cast<int>(ranks);
  const int s_begin = min(S, static_cast<int>(rank) * per), s_end = min(S, s_begin + per);
  // a stage lies in one mask tile; NT < BM only when one token tile holds all M
  const int* mrow = mask == nullptr ? nullptr : mask + blockIdx.y * ((K + KC - 1) / KC);
  const auto live = [&](int s) { return mrow == nullptr || mrow[s * KS / KC] != 0; };

  if (tid == 0) {
    for (int i = 0; i < ring; ++i) {
      mbar_init(&full[i], Tma ? 1 : 32);
      mbar_init(&empty[i], WG);   // the warpgroup that read the stage
    }
    mbar_init_fence();
  }
  __syncthreads();

  // acc[t]: wgmma tile t (output columns 32w + 4g + 2t + h of the block for
  // row g + 8h of warp w's 16), all NT tokens
  float acc0[NT / 2], acc1[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc0[i] = acc1[i] = 0.f;

  if (tid >= CONSUMERS) {
    // the producer warp: every live stage of the block's K slice, in order
    const int lane = tid - CONSUMERS;
    if (Tma && lane == 0) {
      prefetch_map(&map_x);
      prefetch_map(&map_mags);
      prefetch_map(&map_signs);
    }
    int i = 0;
    for (int s = s_begin; s < s_end; ++s) {
      if (!live(s)) continue;
      const int slot = i % ring;
      if (i >= ring) mbar_wait(&empty[slot], (i / ring - 1) & 1);
      unsigned char* st = stages + slot * sbytes;
      const int k0 = s * KS;
      if constexpr (Tma) {
        if (lane == 0) {
          mbar_arrive_expect(&full[slot], (NT * KS * 2) + KS * BN + srows * BN);
          tma_load(st, &map_x, k0, row0, &full[slot]);
          tma_load(st + x_tile_bytes(NT), &map_mags, col0, k0, &full[slot]);
          tma_load(st + x_tile_bytes(NT) + KS * BN, &map_signs, col0, k0 / m, &full[slot]);
        }
      } else {
        load_stage_plain<NT>(st, x, mags, signs, row0, col0, k0, M, N, K, m, lane);
        fence_proxy_async();
        mbar_arrive(&full[slot]);
      }
      ++i;
    }
  } else {
    // the consumer warpgroups: warpgroup wg takes the slice's stages
    // s_begin + wg, s_begin + wg + 2, ... (by stage, not by live stage, so
    // that a dead stage leaves the other stages' warpgroup and order as the
    // dense launch has them)
    const int wg = tid / WG;
    const int warp = (tid % WG) >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
    const uint32_t word = 4 * (8 * warp + gid);   // this thread's 4 code columns
    // the K rows a thread reads are 2*tig + {0, 1} mod 8: their swizzled columns
    const uint32_t col_even = word ^ ((2 * tig) << 4), col_odd = word ^ ((2 * tig + 1) << 4);
    // sign rows relative to the stage: fixed where m divides the stage
    int srel[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int r = kk * 16 + 2 * tig;
      srel[kk][0] = r / m;
      srel[kk][1] = (r + 1) / m;
      srel[kk][2] = (r + 8) / m;
      srel[kk][3] = (r + 9) / m;
    }
    int i = -1;   // the live stage's place in the ring's order
    for (int s = s_begin; s < s_end; ++s) {
      if (!live(s)) continue;
      ++i;
      if ((s - s_begin) % 2 != wg) continue;
      const int slot = i % ring;
      mbar_wait(&full[slot], (i / ring) & 1);
      const unsigned char* st = stages + slot * sbytes;
      const unsigned char* codes = st + x_tile_bytes(NT);
      const unsigned char* srow = codes + KS * BN;
      const int k0 = s * KS;
      // without whole fragments a row may lie past the stage's last staged
      // sign row only where its codes are zero: any staged row will do
      const int last = (min(k0 + KS, K) - 1) / m - k0 / m;

      uint32_t a[KK][2][4];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const int r = kk * 16 + 2 * tig;
        const uint32_t cw[4] = {
            *reinterpret_cast<const uint32_t*>(codes + r * BN + col_even),
            *reinterpret_cast<const uint32_t*>(codes + (r + 1) * BN + col_odd),
            *reinterpret_cast<const uint32_t*>(codes + (r + 8) * BN + col_even),
            *reinterpret_cast<const uint32_t*>(codes + (r + 9) * BN + col_odd)};
        uint32_t sw[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int sr = srel[kk][q];
          if constexpr (!Tma) {
            const int kr = r + (q & 1) + 8 * (q >> 1);
            sr = min((k0 + kr) / m - k0 / m, last);
          }
          sw[q] = *reinterpret_cast<const uint32_t*>(srow + sr * BN + (word ^ ((sr & 7) << 4)));
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          a[kk][t][0] = signed_pair(cw[0], cw[1], sw[0], sw[1], 2 * t);       // row g, k 0-1
          a[kk][t][1] = signed_pair(cw[0], cw[1], sw[0], sw[1], 2 * t + 1);   // row g+8
          a[kk][t][2] = signed_pair(cw[2], cw[3], sw[2], sw[3], 2 * t);       // row g, k 8-9
          a[kk][t][3] = signed_pair(cw[2], cw[3], sw[2], sw[3], 2 * t + 1);   // row g+8
        }
      }
      fence_operands(acc0);
      fence_operands(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {   // k16 step kk: 32 bytes on within the rows
        Wgmma<NT>::mma(acc0, a[kk][0], x_desc(st) + 2 * kk);
        Wgmma<NT>::mma(acc1, a[kk][1], x_desc(st) + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait();
      fence_operands(acc0);
      fence_operands(acc1);
      mbar_arrive(&empty[slot]);   // this thread is done with the stage
    }
  }

  // the block's two warpgroups' sums, then the K slices' sum.  A thread's
  // sum holds, for token 8j + 2*tig + e, 4 neighbouring columns 32w + 4g +
  // {0, 1, 2, 3} (tile t, row half h at 2t + h): row u = 2j + e of y's
  // float4s.  Each sum parks over the consumed ring, thread t of a
  // warpgroup at float4 u * WG + t.  The second warpgroup parks, the first
  // adds it to its own and parks the block's sum; then rank r of the cluster
  // sums rows u = r, r + ranks, ... over every rank's parked sum, read
  // through distributed shared memory in rank order (the same bits for
  // every launch), multiplies by ``scale`` once and writes them to y
  float4* wg_sum = reinterpret_cast<float4*>(stages);   // the second warpgroup's
  float4* block_sum = wg_sum + NT / 4 * WG;              // the block's, for the cluster
  const int warp = (tid % WG) >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const auto row = [&](int u) {   // this thread's float4 of row u
    const int jj = u / 2, e = u % 2;
    return make_float4(acc0[4 * jj + e], acc0[4 * jj + 2 + e], acc1[4 * jj + e],
                       acc1[4 * jj + 2 + e]);
  };
  if (tid < CONSUMERS) {
    consumers_sync();   // both warpgroups are done with the ring
    if (tid >= WG) {
#pragma unroll
      for (int u = 0; u < NT / 4; ++u) wg_sum[u * WG + tid - WG] = row(u);
    }
    consumers_sync();
    if (tid < WG) {
#pragma unroll
      for (int u = 0; u < NT / 4; ++u) {
        const float4 a = row(u), b = wg_sum[u * WG + tid];
        block_sum[u * WG + tid] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
      }
    }
  }
  cluster_sync();   // every rank's sum is parked (a cluster of 1: this block's)
  if (tid < WG) {
    const int c = col0 + 32 * warp + 4 * gid;
    float sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = scale[min(c + j, N - 1)];
    for (int u = static_cast<int>(rank); u < NT / 4; u += static_cast<int>(ranks)) {
      const uint32_t at = smem_u32(block_sum + u * WG + tid);
      float4 sum = ld_cluster(at, 0);
      for (unsigned r = 1; r < ranks; ++r) {
        const float4 v = ld_cluster(at, r);
        sum = make_float4(sum.x + v.x, sum.y + v.y, sum.z + v.z, sum.w + v.w);
      }
      const int tok = row0 + 8 * (u / 2) + 2 * tig + u % 2;
      if (tok >= M || c >= N) continue;
      const float v[4] = {sum.x * sc[0], sum.y * sc[1], sum.z * sc[2], sum.w * sc[3]};
      float* p = y + static_cast<size_t>(tok) * N + c;
      if (vec && c + 3 < N) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int j = 0; j < 4 && c + j < N; ++j) p[j] = v[j];
      }
    }
  }
  cluster_sync();   // every rank's shared memory lives until the others have read it
}

// the tokens of one block: the least wgmma N that holds M (up to BM)
int token_tile(int M) { return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64; }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const int err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    const int err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == 0 && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D row-major map: ``cols`` x ``rows`` elements, tiles of box_cols x
// box_rows, 128-byte swizzle, zeros out of bounds
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, CUtensorMapDataType type,
            int elem, int cols, int rows, int box_cols, int box_rows) {
  const cuuint64_t dim[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dim, stride, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *x, *mags, *signs, *scale, *mask, *gate;
  void* y;
  int M, N, K, m, cluster;
};

template <int NT, bool Tma>
int launch(const Args& a, cudaStream_t stream) {
  CUtensorMap maps[3] = {};
  const int srows = sign_rows(a.m, Tma);
  if constexpr (Tma) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr ||
        !encode(fn, &maps[0], a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.K, a.M, KS, NT) ||
        !encode(fn, &maps[1], a.mags, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.N, a.K, BN, KS) ||
        !encode(fn, &maps[2], a.signs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.N, a.K / a.m, BN,
                srows))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int S = (a.K + KS - 1) / KS;
  const int per = (S + a.cluster - 1) / a.cluster;
  const int sbytes = stage_bytes(NT, srows);
  const int ring = std::max(1, std::min({per, MAX_RING, (SMEM_MAX - HEADER) / sbytes}));
  // the ring, or the two parked tiles over it, whichever is larger
  const int smem = HEADER + std::max(ring * sbytes, 2 * NT * WG * 4);
  const bool vec = a.N % 4 == 0 && reinterpret_cast<uintptr_t>(a.y) % 16 == 0;
  auto kernel = polarized_matmul_tc_kernel<NT, Tma>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(a.cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + BN - 1) / BN, (a.M + NT - 1) / NT, a.cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = cudaLaunchKernelEx(
      &cfg, kernel, maps[0], maps[1], maps[2], static_cast<const uint16_t*>(a.x),
      static_cast<const uint8_t*>(a.mags), static_cast<const int8_t*>(a.signs),
      static_cast<const float*>(a.scale), static_cast<const int*>(a.mask),
      static_cast<const int*>(a.gate), static_cast<float*>(a.y), a.M, a.N, a.K, a.m, ring,
      static_cast<int>(vec));
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

template <bool Tma>
int launch_tokens(const Args& a, cudaStream_t stream) {
  switch (token_tile(a.M)) {
    case 8: return launch<8, Tma>(a, stream);
    case 16: return launch<16, Tma>(a, stream);
    case 32: return launch<32, Tma>(a, stream);
    default: return launch<64, Tma>(a, stream);
  }
}

}  // namespace

extern "C" {

// Plain C entry points for ctypes.  Every pointer is a contiguous row-major
// device buffer: x (M, K) bf16, mags (K, N) uint8, signs (K/m, N) int8,
// scale (N,) f32, y (M, N) f32.  The grid is ceil(N / BN) column tiles x
// token tiles (the least of 8, 16, 32, 64 rows that holds M, else 64) x
// ``cluster`` K slices, one cluster per output tile (1 <= cluster <=
// MAX_CLUSTER; forms_polarized_matmul_tc_tile gives BM, BN, KC and
// MAX_CLUSTER).  ``fast`` may be 1 only when K % 8 == 0, N % 16 == 0 and x,
// mags and signs are 16-byte aligned: then, where m divides 64, TMA loads
// the operands.  ``mask`` holds ceil(M / BM) x ceil(K / KC) ints, row-major,
// or is null (every tile live); ``gate`` is one int, or null.  Returns the
// launch's error (cudaErrorInvalidValue for an m or cluster out of range, or
// a tensor map the CUDA driver refuses).
int forms_polarized_matmul_tc_tile(int which) {
  return which == 0 ? BM : which == 1 ? BN : which == 2 ? KC : MAX_CLUSTER;
}

int forms_polarized_matmul_tc(const void* x, const void* mags, const void* signs,
                              const void* scale, const void* mask, const void* gate, void* y,
                              int M, int N, int K, int m, int fast, int cluster, void* stream) {
  if (m <= 0 || cluster < 1 || cluster > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{x, mags, signs, scale, mask, gate, y, M, N, K, m, cluster};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast && KS % m == 0 ? launch_tokens<true>(a, s) : launch_tokens<false>(a, s);
}

}  // extern "C"
