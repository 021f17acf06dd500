// Polarized-magnitude matmul on Hopper's tensor cores (sm_90a), bf16 x:
//
//   y[M, N] = (x[M, K] @ (repeat(signs[K/m, N], m, axis=0) * mags[K, N])) * scale[N]
//
// x bf16, mags uint8, signs int8 +-1, scale f32, y f32 (f32 accumulation).
//
// Replaces, for bf16 activations and uint8 codes at M >= TC_MIN_ROWS (the
// prefill of a bf16 served model), the Pallas TPU kernels
// src/repro/kernels/polarized_matmul.py:45 (_kernel, dense) and
// src/repro/kernels/polarized_matmul.py:68 (_kernel_skip, input
// zero-skipping).  polarized_matmul.cu keeps decode, int32 codes (bits > 8)
// and f32 activations.
//
// Why the products are exact.  Every operand is exact in bf16: a bf16
// activation, a magnitude code 0..255 (8 significant bits, as bf16 has) and
// a sign of +-1.  A bf16 x bf16 product has at most 16 significant bits, so
// it is exact in the f32 accumulator: mma.sync computes the same products
// as the f32 kernel on x widened to f32, and only the order (and the
// tensor core's alignment) of the summation differs -- the tolerance class
// of the f32 kernel's K split.
//
// What bounds it on an H100 at M = 64: one qwen2-1.5b layer (7 projections)
// moves 46.8 MB of codes, 5.9 MB of signs, 2.3 MB of x and 5.9 MB of y:
// ~0.018 ms at 3.35 TB/s, against 6.0 GFLOP = 0.006 ms at the 989 TFLOP/s
// bf16 tensor-core rate -- bytes, near the ridge.  The design:
//   * one block per (64-column tile, 64-row tile, K slice).  K is cut into
//     mask tiles of KC = 256 rows, as the f32 kernel cuts it, and a block sums
//     ``group`` of them (the wrapper picks the group from the shape: as few K
//     splits as keep the SMs busy), so at M = 64 a 1536 x 1536 projection
//     launches 144 blocks, 1536 x 8960 280 and 8960 x 1536 216;
//   * x (bf16), the codes (uint8) and the stage's fragment signs stream
//     through dynamic shared memory in 4 stages of 64 K rows with 16-byte
//     cp.async, so three stages' loads are in flight behind this stage's
//     MMAs.  HBM only holds the uint8 codes and the 1/m-sized sign plane;
//   * B fragments are made in registers: one 32-bit shared load gives a
//     thread its codes of one K row in 4 columns -- one column for each of
//     its 4 n8 tiles -- and each code widens exactly to bf16 (its byte under
//     the exponent of 2^23, minus 2^23, top 16 bits) with the fragment sign
//     put in the sign bit.  This is the TPU kernel's "fold the signs in fast
//     memory, feed the matrix unit", placed in registers.  When m divides the
//     stage (``Whole``), each thread's sign rows are fixed offsets;
//   * 4 warps: two column halves of WN = 32 x two K parities (k16 steps 0-1
//     and 2-3 of each stage), each warp 4 m16 x 4 n8 tiles of
//     mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32; m16 tiles wholly past M
//     are skipped.  The parities are added in shared memory in a fixed order;
//   * the f32 kernel's deterministic split-K epilogue: each slice writes its
//     tile to ``work``, the last slice to take the tile's ticket sums the
//     slices in slice order and multiplies by ``scale`` once, and the
//     tickets return to zero.  No float atomics: two launches give equal bits.
//     The tile goes through shared memory first, so that every write and
//     read of ``work`` and ``y`` moves 16 bytes a thread, and the last slice
//     keeps two slices' loads in flight.
// ``mask`` holds one int per (64-row tile, 256-row K tile) -- this kernel's
// own tiling -- and a block skips the stages of its dead tiles: no code or
// sign loads and no MMAs.  The dense launch runs those stages' MMAs on an
// all-zero A, whose products are exact zeros, so the accumulators come out
// unchanged and skip equals dense bit for bit (checked on the card).
// ``gate`` (one int on the device), when it reads 0, returns the whole
// launch at once (fragment compaction launches two gated products into one
// output).  Rows past M and K past the range meet zero-filled x; columns
// past N meet zero-filled codes and are never written.  Shapes whose rows
// are not 16-byte aligned (K % 8 or N % 16 nonzero) take the same code with
// element-wise staging (the ``Fast = false`` instantiations).
// Measured on the card (PERF.md), the kernel streams the codes far below
// HBM's rate, and neither more warps per block, wider column tiles, more
// stages, nor dropping the x or the code loads moved that much: wgmma, TMA
// and a warp-specialised pipeline are left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;              // rows of x per block (four m16 tiles)
constexpr int BN = 64;              // output columns per block
constexpr int KC = 256;             // K rows per mask tile (the zero-skip granule)
constexpr int KS = 64;              // K rows per pipeline stage (four k16 steps)
constexpr int STAGES = 4;
constexpr int WN = 32;              // output columns per warp (four n8 tiles)
constexpr int WARPS_N = BN / WN;    // warps across the columns, times two K parities
constexpr int THREADS = 64 * WARPS_N;
constexpr int MAX_GROUP = 64;       // mask tiles per block, at most
constexpr int XS_LD = KS + 8;       // bf16 per staged x row (144 bytes: conflict-free A loads)
constexpr int MS_LD = BN + 16;      // bytes per staged code / sign row (conflict-free B loads)
constexpr int X_BYTES = STAGES * BM * XS_LD * 2;
constexpr int MAGS_BYTES = STAGES * KS * MS_LD;
static_assert(BM * BN * 4 <= X_BYTES, "the parity sums and the output tile alias the x stages");
static_assert(BM * BN / 4 % THREADS == 0, "the epilogue moves whole quads of 4 columns");

// a stage's fragment rows of signs: rows k0/m .. (k0 + KS - 1)/m
__host__ __device__ constexpr int sign_rows(int m) { return (KS - 1) / m + 2; }

// the dynamic shared memory of one block for fragment size m
__host__ __device__ constexpr int smem_bytes(int m) {
  return X_BYTES + MAGS_BYTES + STAGES * sign_rows(m) * MS_LD;
}

// the block's views of its dynamic shared memory
struct Smem {
  uint16_t* x;      // [STAGES][BM][XS_LD]
  uint8_t* mags;    // [STAGES][KS][MS_LD]
  uint8_t* signs;   // [STAGES][sign_rows(m)][MS_LD]
  float* red;       // [WARPS_N][BM][WN], over the x stages after the loop
  int srows;
  __device__ uint16_t* xrow(int buf, int r) { return x + (buf * BM + r) * XS_LD; }
  __device__ uint8_t* mrow(int buf, int r) { return mags + (buf * KS + r) * MS_LD; }
  __device__ uint8_t* srow(int buf, int r) { return signs + (buf * srows + r) * MS_LD; }
  __device__ float& redv(int h, int r, int c) { return red[(h * BM + r) * WN + c]; }
};

// ---- the PTX helpers: the card runs the asm; the g++ host emulation of the
// tests supplies host_* stand-ins (tests/cuda_host/cuda_runtime.h)

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
#elif defined(CUDA_HOST_EMULATION)
  host_cp_async16(dst, src, valid);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32, one warp
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#elif defined(CUDA_HOST_EMULATION)
  host_mma_m16n8k16_bf16(d, a, b);
#endif
}

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

// one stage into shared memory: x (BM x KS), codes (KS x BN) and the
// stage's fragment signs (rows k0/m .. (k0 + KS - 1)/m, clipped at kend)
template <bool Fast>
__device__ __forceinline__ void load_stage(Smem& sm, int buf, const uint16_t* __restrict__ x,
                                           const uint8_t* __restrict__ mags,
                                           const int8_t* __restrict__ signs, int row0,
                                           int col0, int k0, int kend, int M, int N, int K,
                                           int m, int tid) {
  const int s0 = k0 / m;
  const int srows = (min(k0 + KS, kend) - 1) / m - s0 + 1;
  if constexpr (Fast) {
    // x: BM rows x KS/8 chunks of 8 bf16; codes and signs: rows of BN/16
    // chunks of 16
    for (int i = tid; i < BM * (KS / 8); i += THREADS) {
      const int r = i / (KS / 8), c = (i % (KS / 8)) * 8;
      const int gr = row0 + r, gk = k0 + c;
      const bool ok = gr < M && gk < kend;
      cp_async16(sm.xrow(buf, r) + c, x + (ok ? static_cast<size_t>(gr) * K + gk : 0), ok);
    }
    for (int i = tid; i < KS * (BN / 16); i += THREADS) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      const int gk = k0 + r, gc = col0 + c;
      const bool ok = gk < kend && gc < N;
      cp_async16(sm.mrow(buf, r) + c, mags + (ok ? static_cast<size_t>(gk) * N + gc : 0), ok);
    }
    for (int i = tid; i < srows * (BN / 16); i += THREADS) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      const bool ok = col0 + c < N;
      cp_async16(sm.srow(buf, r) + c,
                 signs + (ok ? static_cast<size_t>(s0 + r) * N + col0 + c : 0), ok);
    }
  } else {
    for (int i = tid; i < BM * KS; i += THREADS) {
      const int r = i / KS, c = i % KS;
      const int gr = row0 + r, gk = k0 + c;
      sm.xrow(buf, r)[c] = (gr < M && gk < kend) ? x[static_cast<size_t>(gr) * K + gk] : 0;
    }
    for (int i = tid; i < KS * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gc = col0 + c;
      sm.mrow(buf, r)[c] = (gk < kend && gc < N) ? mags[static_cast<size_t>(gk) * N + gc] : 0;
    }
    for (int i = tid; i < srows * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      sm.srow(buf, r)[c] = col0 + c < N ? signs[static_cast<size_t>(s0 + r) * N + col0 + c] : 1;
    }
  }
}

template <bool Fast, bool Whole>
__global__ void __launch_bounds__(THREADS)
polarized_matmul_tc_kernel(const uint16_t* __restrict__ x, const uint8_t* __restrict__ mags,
                           const int8_t* __restrict__ signs, const float* __restrict__ scale,
                           const int* __restrict__ mask, const int* __restrict__ gate,
                           float* __restrict__ y, float* __restrict__ work,
                           int* __restrict__ tickets, int M, int N, int K, int m, int group) {
  // the launch's gate comes first: uniform over the launch
  if (gate != nullptr && *gate == 0) return;
#ifdef CUDA_HOST_EMULATION
  unsigned char* smem = host_dynamic_smem;
#else
  extern __shared__ __align__(16) unsigned char smem[];
#endif
  __shared__ int step_k0[MAX_GROUP * (KC / KS)];  // first K row of each live stage
  __shared__ int nsteps, last;
  Smem sm{reinterpret_cast<uint16_t*>(smem), smem + X_BYTES, smem + X_BYTES + MAGS_BYTES,
          reinterpret_cast<float*>(smem), sign_rows(m)};

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;          // the mma's groupID
  const int tig = lane & 3;           // and threadID_in_group
  const int half = warp % WARPS_N;    // this warp's WN columns of the tile
  const int par = warp / WARPS_N;     // and its two k16 steps of each stage
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tiles_k = (K + KC - 1) / KC;          // mask tiles along K
  const int t0 = blockIdx.z * group;              // this block's first one
  const int kend = min(K, (t0 + group) * KC);

  // the stages of the block's live mask tiles (all of them without a mask):
  // a dead tile (all of its x zero) issues no loads and no MMAs
  if (tid == 0) {
    int n = 0;
    for (int t = t0; t < min(tiles_k, t0 + group); ++t) {
      if (mask != nullptr && mask[blockIdx.y * tiles_k + t] == 0) continue;
      for (int k0 = t * KC; k0 < min(K, (t + 1) * KC); k0 += KS) step_k0[n++] = k0;
    }
    nsteps = n;
  }
  __syncthreads();
  const int steps = nsteps;

  // acc[t][j]: m16 tile t, n8 tile j.  Physical column half*WN + 4*n + j is
  // logical column n of n8 tile j, so one 32-bit code load serves all four.
  float acc[4][4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  // where every stage starts on a fragment boundary (Whole: m divides KS),
  // this thread's sign rows relative to the stage are fixed: no division
  // per step
  int srel[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kk = par * 32 + h * 16;
    const int kr[4] = {kk + 2 * tig, kk + 2 * tig + 1, kk + 2 * tig + 8, kk + 2 * tig + 9};
#pragma unroll
    for (int q = 0; q < 4; ++q) srel[h][q] = kr[q] / m;
  }

  if (steps > 0) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < steps)
        load_stage<Fast>(sm, s, x, mags, signs, row0, col0, step_k0[s], kend, M, N, K, m, tid);
      cp_async_commit();
    }

    for (int step = 0; step < steps; ++step) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // stage `step` has landed; stage step-1 is read by all
      const int next = step + STAGES - 1;
      if (next < steps)
        load_stage<Fast>(sm, next % STAGES, x, mags, signs, row0, col0, step_k0[next], kend,
                         M, N, K, m, tid);
      cp_async_commit();

      const int buf = step % STAGES;
      const int k0 = step_k0[step];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = par * 32 + h * 16;   // this warp's k16 steps of the stage
        // B: rows kk + 2*tig + {0, 1, 8, 9}, this thread's 4 columns
        uint32_t b[4][2];
        {
          const int kr[4] = {kk + 2 * tig, kk + 2 * tig + 1, kk + 2 * tig + 8,
                             kk + 2 * tig + 9};
          uint32_t cw[4], sw[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            cw[q] = *reinterpret_cast<const uint32_t*>(sm.mrow(buf, kr[q]) + half * WN + 4 * gid);
            // rows past kend meet zero codes and zero x; any staged row will do
            int r = srel[h][q];
            if constexpr (!Whole)
              r = min((k0 + kr[q]) / m - k0 / m, (min(k0 + KS, kend) - 1) / m - k0 / m);
            sw[q] = *reinterpret_cast<const uint32_t*>(sm.srow(buf, r) + half * WN + 4 * gid);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            b[j][0] = signed_pair(cw[0], cw[1], sw[0], sw[1], j);
            b[j][1] = signed_pair(cw[2], cw[3], sw[2], sw[3], j);
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (row0 + t * 16 >= M) break;     // uniform: the m16 tile is all padding
          const uint16_t* lo = sm.xrow(buf, t * 16 + gid) + kk + 2 * tig;
          const uint16_t* hi = sm.xrow(buf, t * 16 + gid + 8) + kk + 2 * tig;
          const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(lo),
                                 *reinterpret_cast<const uint32_t*>(hi),
                                 *reinterpret_cast<const uint32_t*>(lo + 8),
                                 *reinterpret_cast<const uint32_t*>(hi + 8)};
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[t][j], a, b[j]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the stages are free: red aliases them

    // the odd parity's sums join the even one's, in that order
    if (par == 1) {
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sm.redv(half, t * 16 + gid + (e >> 1) * 8, 4 * (2 * tig + (e & 1)) + j) = acc[t][j][e];
    }
    __syncthreads();
    if (par == 0) {
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[t][j][e] += sm.redv(half, t * 16 + gid + (e >> 1) * 8, 4 * (2 * tig + (e & 1)) + j);
    }
  }

  // the even-parity warps hold the block's tile: row t*16 + gid + 8*(e>>1),
  // column half*WN + 4*(2*tig + (e&1)) + j.  It goes through shared memory,
  // so that every thread then moves whole rows of 4 columns
  float* tile = sm.red;   // [BM][BN], over the x stages
  __syncthreads();
  if (par == 0) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tile[(t * 16 + gid + (e >> 1) * 8) * BN + half * WN + 4 * (2 * tig + (e & 1)) + j] =
              acc[t][j][e];
  }
  __syncthreads();

  // quad q of this thread: tile row qr(q), columns qc(q) .. qc(q) + 3
  constexpr int QUADS = BM * BN / 4 / THREADS;
  const auto qr = [&](int q) { return (tid + q * THREADS) / (BN / 4); };
  const auto qc = [&](int q) { return 4 * ((tid + q * THREADS) % (BN / 4)); };
  const bool vec = N % 4 == 0;   // rows of 4 columns are 16-byte aligned
  const auto store4 = [&](float* base, int q, float4 v) {
    const int gr = row0 + qr(q), gc = col0 + qc(q);
    if (gr >= M) return;
    float* p = base + static_cast<size_t>(gr) * N + gc;
    if (vec && gc + 3 < N) {
      *reinterpret_cast<float4*>(p) = v;
    } else {
      const float f[4] = {v.x, v.y, v.z, v.w};
      for (int i = 0; i < 4 && gc + i < N; ++i) p[i] = f[i];
    }
  };
  const auto load4 = [&](const float* base, int q) {
    const int gr = row0 + qr(q), gc = col0 + qc(q);
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (gr < M) {
      const float* p = base + static_cast<size_t>(gr) * N + gc;
      if (vec && gc + 3 < N) return __ldcg(reinterpret_cast<const float4*>(p));
      for (int i = 0; i < 4 && gc + i < N; ++i) f[i] = __ldcg(p + i);
    }
    return make_float4(f[0], f[1], f[2], f[3]);
  };
  const auto scaled = [&](int q, float4 v) {
    const int gc = col0 + qc(q);
    const float4 sc = make_float4(scale[min(gc, N - 1)], scale[min(gc + 1, N - 1)],
                                  scale[min(gc + 2, N - 1)], scale[min(gc + 3, N - 1)]);
    return make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
  };
  const auto tile4 = [&](int q) {
    return *reinterpret_cast<const float4*>(tile + qr(q) * BN + qc(q));
  };

  const int slices = gridDim.z;
  if (slices == 1) {
#pragma unroll
    for (int q = 0; q < QUADS; ++q) store4(y, q, scaled(q, tile4(q)));
    return;
  }

  // publish this slice's tile; the last slice of the tile to arrive sums
  // all slices in slice order, with two slices' loads in flight at a time
  float* wz = work + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int q = 0; q < QUADS; ++q) store4(wz, q, tile4(q));
  __threadfence();
  __syncthreads();
  const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(tickets + tile_id, 1) == slices - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float4 sum[QUADS];
#pragma unroll
  for (int q = 0; q < QUADS; ++q) sum[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  const auto add4 = [](float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  };
  for (int z = 0; z < slices; z += 2) {
    float4 a[QUADS], b[QUADS];
    const float* w0 = work + static_cast<size_t>(z) * M * N;
#pragma unroll
    for (int q = 0; q < QUADS; ++q) a[q] = load4(w0, q);
    if (z + 1 < slices) {
#pragma unroll
      for (int q = 0; q < QUADS; ++q) b[q] = load4(w0 + static_cast<size_t>(M) * N, q);
    }
#pragma unroll
    for (int q = 0; q < QUADS; ++q) {
      sum[q] = add4(sum[q], a[q]);
      if (z + 1 < slices) sum[q] = add4(sum[q], b[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < QUADS; ++q) store4(y, q, scaled(q, sum[q]));
  if (tid == 0) tickets[tile_id] = 0;  // ready for the next launch
}

struct Args {
  const void *x, *mags, *signs, *scale, *mask, *gate;
  void *y, *work, *tickets;
  int M, N, K, m, group;
};

template <bool Fast, bool Whole>
void launch_tile(const Args& a, cudaStream_t stream) {
  const int tiles_k = (a.K + KC - 1) / KC;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, (tiles_k + a.group - 1) / a.group);
  const int smem = smem_bytes(a.m);
  cudaFuncSetAttribute(polarized_matmul_tc_kernel<Fast, Whole>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  polarized_matmul_tc_kernel<Fast, Whole><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(a.x), static_cast<const uint8_t*>(a.mags),
      static_cast<const int8_t*>(a.signs), static_cast<const float*>(a.scale),
      static_cast<const int*>(a.mask), static_cast<const int*>(a.gate),
      static_cast<float*>(a.y), static_cast<float*>(a.work), static_cast<int*>(a.tickets),
      a.M, a.N, a.K, a.m, a.group);
}

}  // namespace

extern "C" {

// Plain C entry points for ctypes.  Every pointer is a contiguous row-major
// device buffer: x (M, K) bf16, mags (K, N) uint8, signs (K/m, N) int8,
// scale (N,) f32, y (M, N) f32.  K is cut into mask tiles of KC rows, and
// each block sums ``group`` of them (1 <= group <= MAX_GROUP):
// S = ceil(ceil(K / KC) / group) K slices (forms_polarized_matmul_tc_tile
// gives BM, BN, KC and MAX_GROUP).  With S > 1, ``work`` holds S * M * N
// floats of scratch and ``tickets`` at least ceil(N / BN) * ceil(M / BM)
// ints, all zero; the kernel leaves them zero again.  ``fast`` may be 1
// only when K % 8 == 0, N % 16 == 0 and x, mags and signs are 16-byte
// aligned.  ``mask`` holds ceil(M / BM) x ceil(K / KC) ints, row-major, or
// is null (every tile live); ``gate`` is one int, or null.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an m or group out of range.
int forms_polarized_matmul_tc_tile(int which) {
  return which == 0 ? BM : which == 1 ? BN : which == 2 ? KC : MAX_GROUP;
}

int forms_polarized_matmul_tc(const void* x, const void* mags, const void* signs,
                              const void* scale, const void* mask, const void* gate, void* y,
                              void* work, void* tickets, int M, int N, int K, int m, int fast,
                              int group, void* stream) {
  if (m <= 0 || group < 1 || group > MAX_GROUP) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{x, mags, signs, scale, mask, gate, y, work, tickets, M, N, K, m, group};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool whole = KS % m == 0;
  if (fast && whole) launch_tile<true, true>(a, s);
  else if (fast) launch_tile<true, false>(a, s);
  else if (whole) launch_tile<false, true>(a, s);
  else launch_tile<false, false>(a, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
