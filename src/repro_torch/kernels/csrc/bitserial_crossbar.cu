// Bit-serial FORMS crossbar simulator on Hopper's int8 tensor cores (sm_90a):
//
//   acc[r, n] = sum_b sum_c sum_f sign[f, n] * min(P[b, c, f, r, n], adc_max) << (c*cell_bits + b)
//   P[b, c, f, r, n] = sum_{k in fragment f} bit_b(x[r, k]) * cells[c, k, n]
//   eic[r, f] = last live bit plane of fragment f's m inputs of row r, + 1
//
// x int32 activation codes (bits below input_bits are streamed), cells uint8
// (C, K, N) planes, each cell read whole (0..255, whatever cell_bits is),
// signs int8 (K/m, N); acc int32, wrapping as two's complement does; eic
// int32.  Any m with K % m == 0, any C and cell_bits, 1 <= input_bits <= 32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitserial_crossbar.py::_kernel.
// The TPU kernel keeps all of K in VMEM per (row tile, column tile) and runs,
// for each input bit and cell plane, a batched thin (m-deep) f32 dot over the
// fragments, clips at the ADC ceiling, signs and shift-adds in int32.
//
// Here the per-fragment sums P are products of 0/1 bytes and cell bytes, so
// they come from mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 exactly
// (P <= m * 255 fits s32).  The design:
//   * fragments in the A rows.  Each fragment is padded to mp rows of a
//     padded K axis: for m <= 32 the next power of two (at least 2), so one
//     k32 chunk holds G = 32 / mp whole fragments ("slots"); for m > 32 a
//     multiple of 32, so a fragment spans mp / 32 chunks and its D
//     accumulates over them before the clip.  An m16 A tile's 16 rows are G
//     slots x R = 16 / G (row, bit) pairs: row i is slot i / R, pair i % R.
//     Row i's element at k is bit_b(x[r, k]) when k lies in slot i / R, else
//     0.  With rows 0-7 on the slots of columns 0-15 and rows 8-15 on those of
//     16-31, registers a1 and a2 are zero for G >= 2 and a0, a3 are one
//     32-bit shared load ANDed with a per-lane constant byte mask;
//   * the block stages its inputs' bit planes once per stage in shared
//     memory as 0/1 bytes, one row per (row, bit) pair, on the padded K axis,
//     from codes (and signs) each thread loads into registers one stage
//     ahead, while the stage before computes;
//   * B is one cell plane's (k32 x n8) tile, streamed with cp.async.  Cells
//     are (C, K, N), N contiguous, so a lane's four 32-bit loads of one k row
//     each are transposed bytewise (__byte_perm) into the .col fragment, one
//     physical column of each of the warp's four n8 tiles, as
//     polarized_matmul_tc.cu does for its uint8 codes;
//   * the (row, bit) expansion fills the M side of the MMA: at M = 4 and 16
//     input bits there are 64 pairs, 16 m16 tiles at m = 8, one block;
//   * the epilogue stays in registers: a lane's D rows gid and gid + 8 are a
//     fixed (slot, pair).  It clips (min with adc_max, only where the ADC can
//     clip: adc_max < m * 255) and adds D * (sign << c*cell_bits), the
//     multiplier staged per stage in shared memory, into uint32 accumulators
//     that wrap as the reference's int32 does.  At the end the pairs of one
//     row are shifted by their bit and added in shared memory, and one integer
//     atomicAdd per output covers the K split.  The sum is the same in any
//     order, so the result is exact and the same from run to run;
//   * the K split falls on fragment boundaries (whole chunks for m <= 32,
//     whole fragments for m > 32), since the clip is of a whole fragment's
//     sum.  Its size is the one whose waves of resident blocks (the card's
//     occupancy for this launch) end first.  Blocks take up to 4 cell planes
//     (one for m > 32, whose D holds a plane over several chunks); more
//     planes go to more blocks;
//   * EIC, from the OR of each fragment's masked codes, is written by the
//     blocks of column tile 0 and plane group 0, as the Pallas kernel writes
//     it at n-block 0.
// Every warp of a block issues the same MMAs (tiles of pairs past M*B are
// zero rows), so the block-wide emulation of the tests meets at every one.
// Bound: bytes.  At M = 4 the 16 x 4 bit-plane MACs take less time at the
// int8 tensor-core rate than reading the uint8 cell planes once, so the floor
// is the cells, x, signs, acc and eic moved once (chip_smoke.py's
// bitserial_bound).  At m = 8 the A tiles are 3/4 zeros (the MMA does 4x the
// useful MACs), and the clip-sign-accumulate of every D element runs on the
// CUDA cores: that epilogue, not the MMA, is the expected cost.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 32;              // output columns per block: four n8 tiles
constexpr int WARPS = 4;            // each warp AT m16 tiles of pairs, all BN columns
constexpr int THREADS = 32 * WARPS;
constexpr int AT = 4;               // m16 tiles per warp
constexpr int NT = BN / 8;          // n8 tiles per warp
constexpr int CH = 4;               // k32 chunks per pipeline stage
constexpr int SK = 32 * CH;         // padded K rows per stage
constexpr int STAGES = 2;
constexpr int CG_MAX = 4;           // cell planes per block (m <= 32)
constexpr int CS_LD = BN + 16;      // bytes per staged cell row
constexpr int XS_LD = SK + 16;      // bytes per staged bit-plane row
constexpr int XT = 2;               // x tasks per thread loaded a stage ahead
constexpr int ST = 4;               // sign tasks per thread loaded a stage ahead
constexpr int BLOCK_COST = 2;       // a block's fixed cost, in k32 chunks of work

struct Params {
  const int32_t* x;
  const uint8_t* cells;
  const int8_t* signs;
  unsigned* acc;
  int* eic;
  int M, N, K, C, m, B, cb;   // B: input bits, cb: cell bits
  unsigned adc_max;
  int mp;                     // padded fragment rows
  int G, R;                   // fragment slots per chunk, pairs per m16 tile
  int F;                      // fragments
  int cg, groups;             // cell planes per block, plane groups
  int units, upb, cpu;        // K split units (chunks, or fragments for m > 32),
                              // units per block, chunks per unit
  int wrows;                  // staged fragment rows of multipliers per stage
  int vec;                    // cell rows are 16-byte aligned (N % 16 == 0)
};

// pairs of (row, bit) per block
__host__ __device__ constexpr int block_pairs(int R) { return WARPS * AT * R; }

// the block's dynamic shared memory
__host__ __device__ inline int smem_bytes(const Params& p) {
  const int pb = block_pairs(p.R);
  const int stage = STAGES * p.cg * SK * CS_LD + pb * XS_LD + p.cg * p.wrows * BN * 4;
  const int red = (pb / p.B + 2) * BN * 4;
  return stage > red ? stage : red;
}

// ---- the PTX helpers: the card runs the asm; the g++ host emulation of the
// tests supplies host_* stand-ins (tests/cuda_host/cuda_runtime.h)

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

// d = a (16x32 u8, row) * b (32x8 u8, col) + c, s32, one warp
__device__ __forceinline__ void mma_u8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2], const int (&c)[4]) {
#ifdef __CUDA_ARCH__
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(c[0]),
        "r"(c[1]), "r"(c[2]), "r"(c[3]));
#elif defined(CUDA_HOST_EMULATION)
  host_mma_m16n8k32_u8(d, a, b, c);
#endif
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// byte q of four words, word j in byte j
__device__ __forceinline__ uint32_t byte_column(const uint32_t (&v)[4], int q) {
  const uint32_t sel = static_cast<uint32_t>(q | ((q + 4) << 4));
  return __byte_perm(__byte_perm(v[0], v[1], sel), __byte_perm(v[2], v[3], sel), 0x5410u);
}

template <bool Multi, bool Clip>
__global__ void __launch_bounds__(THREADS) bitserial_crossbar_kernel(Params p) {
#ifdef CUDA_HOST_EMULATION
  unsigned char* smem = host_dynamic_smem;
#else
  extern __shared__ __align__(16) unsigned char smem[];
#endif
  const int PB = block_pairs(p.R);
  uint8_t* cs = smem;                                         // [STAGES][cg][SK][CS_LD]
  uint8_t* xs = smem + STAGES * p.cg * SK * CS_LD;            // [PB][XS_LD]
  uint32_t* ws = reinterpret_cast<uint32_t*>(xs + PB * XS_LD);  // [cg][wrows][BN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;            // the mma's groupID
  const int tig = lane & 3;             // and threadID_in_group
  const int MB = p.M * p.B;             // (row, bit) pairs, row-major
  const int p0 = blockIdx.x * PB;       // the block's first pair
  const int col0 = blockIdx.y * BN;
  const int zs = blockIdx.z / p.groups; // K split
  const int c0 = (blockIdx.z % p.groups) * p.cg;
  const int ncg = min(p.cg, p.C - c0);
  const int u0 = zs * p.upb;
  const int kp0 = u0 * p.cpu * 32;                              // padded K rows
  const int kp1 = min(p.units, u0 + p.upb) * p.cpu * 32;
  const int r_lo = p0 / p.B;
  const int r_hi = min(p.M - 1, (p0 + PB - 1) / p.B);

  // EIC of the rows whose bit 0 is in this block, over its fragments
  if (blockIdx.y == 0 && c0 == 0) {
    const unsigned in_mask = p.B >= 32 ? 0xffffffffu : (1u << p.B) - 1u;
    const int f_lo = kp0 / p.mp, f_hi = min(p.F, kp1 / p.mp);
    const int ro = (p0 + p.B - 1) / p.B, re = min(p.M, (p0 + PB + p.B - 1) / p.B);
    const int nf = f_hi - f_lo;
    for (int i = tid; i < (re - ro) * nf; i += THREADS) {
      const int r = ro + i / nf, f = f_lo + i % nf;
      const int32_t* xr = p.x + static_cast<size_t>(r) * p.K + static_cast<size_t>(f) * p.m;
      unsigned any = 0u;
      for (int j = 0; j < p.m; ++j) any |= static_cast<unsigned>(__ldg(xr + j)) & in_mask;
      p.eic[static_cast<size_t>(r) * p.F + f] = any ? 32 - __clz(any) : 0;
    }
  }
  // pairs past M*B keep zero bit planes
  for (int i = tid; i < PB * XS_LD / 4; i += THREADS) reinterpret_cast<uint32_t*>(xs)[i] = 0u;

  // this lane's rows of every m16 tile: slot and pair of D rows gid, gid + 8
  const int g_lo = gid / p.R, g_hi = (gid + 8) / p.R;
  const int q_lo = gid % p.R, q_hi = (gid + 8) % p.R;
  const bool full = p.G == 1;           // one slot: all four A registers live
  uint32_t amask = 0u;                  // a0's and a3's bytes in this lane's slot
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if ((tig * 4 + j) / p.mp == g_lo) amask |= 0xFFu << (8 * j);

  // cell planes c0.. of padded rows [kps, kps + SK) into buffer `buf`
  const auto load_cells = [&](int s) {
    const int buf = s % STAGES;
    const int kps = kp0 + s * SK;
    uint8_t* dst = cs + buf * p.cg * SK * CS_LD;
    if (p.vec) {
      for (int i = tid; i < ncg * SK * 2; i += THREADS) {
        const int c = i / (SK * 2), rr = (i / 2) % SK, h = i % 2;
        const int pr = kps + rr, f = pr / p.mp, j = pr % p.mp;
        const int gc = col0 + 16 * h;
        const bool ok = pr < kp1 && j < p.m && f < p.F && gc < p.N;
        const uint8_t* src = p.cells + (ok ? (static_cast<size_t>(c0 + c) * p.K +
                                              static_cast<size_t>(f) * p.m + j) * p.N + gc : 0);
        cp_async16(dst + (c * SK + rr) * CS_LD + 16 * h, src, ok);
      }
    } else {
      for (int i = tid; i < ncg * SK * BN; i += THREADS) {
        const int c = i / (SK * BN), rr = (i / BN) % SK, col = i % BN;
        const int pr = kps + rr, f = pr / p.mp, j = pr % p.mp;
        const int gc = col0 + col;
        const bool ok = pr < kp1 && j < p.m && f < p.F && gc < p.N;
        dst[(c * SK + rr) * CS_LD + col] =
            ok ? p.cells[(static_cast<size_t>(c0 + c) * p.K + static_cast<size_t>(f) * p.m + j) *
                             p.N + gc]
               : 0;
      }
    }
  };

  // the stage's input codes and signs: x tasks (a row, 4 padded rows) and
  // sign tasks (a fragment, a column).  The first XT and ST of a thread are
  // loaded into registers one stage ahead, while the stage before computes
  const int nr = r_hi - r_lo + 1;
  const int nx = nr * (SK / 4);
  const auto x_code = [&](int kps, int i, int j) -> uint32_t {
    const int r = r_lo + i / (SK / 4), pr = kps + 4 * (i % (SK / 4)) + j;
    const int f = pr / p.mp, jj = pr % p.mp;
    return (pr < kp1 && jj < p.m && f < p.F)
               ? static_cast<uint32_t>(__ldg(p.x + static_cast<size_t>(r) * p.K +
                                             static_cast<size_t>(f) * p.m + jj)) : 0u;
  };
  const auto sign_rows = [&](int kps) {
    return min(p.F, (min(kps + SK, kp1) + p.mp - 1) / p.mp) - kps / p.mp;
  };
  const auto sign_of = [&](int kps, int i) -> int {
    const int gc = col0 + i % BN;
    return gc < p.N ? static_cast<int>(__ldg(p.signs + static_cast<size_t>(kps / p.mp + i / BN) *
                                                         p.N + gc)) : 0;
  };
  // the bit planes of task i's 4 codes into xs, for the block's bits of its row
  const auto put_x = [&](int i, const uint32_t (&v)[4]) {
    const int r = r_lo + i / (SK / 4), gq = i % (SK / 4);
    const int b0 = max(0, p0 - r * p.B), b1 = min(p.B, p0 + PB - r * p.B);
    uint32_t bytes = 0u;
    for (int b = b0; b < b1; ++b) {
      if (b == b0 || b % 8 == 0) bytes = byte_column(v, b / 8);
      *reinterpret_cast<uint32_t*>(xs + (r * p.B + b - p0) * XS_LD + 4 * gq) =
          (bytes >> (b % 8)) & 0x01010101u;
    }
  };
  // sign task i's multipliers sign << c*cell_bits into ws
  const auto put_w = [&](int i, int sg) {
    for (int c = 0; c < ncg; ++c) {
      const int sh = (c0 + c) * p.cb;
      ws[(c * p.wrows + i / BN) * BN + i % BN] = sh < 32 ? static_cast<uint32_t>(sg) << sh : 0u;
    }
  };
  uint32_t xv[XT][4];
  int sv[ST];
  const auto fetch = [&](int s) {
    const int kps = kp0 + s * SK;
#pragma unroll
    for (int q = 0; q < XT; ++q) {
      const int i = tid + q * THREADS;
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[q][j] = i < nx ? x_code(kps, i, j) : 0u;
    }
    const int ns = sign_rows(kps) * BN;
#pragma unroll
    for (int q = 0; q < ST; ++q) {
      const int i = tid + q * THREADS;
      sv[q] = i < ns ? sign_of(kps, i) : 0;
    }
  };
  const auto stage_inputs = [&](int s) {
    const int kps = kp0 + s * SK;
#pragma unroll
    for (int q = 0; q < XT; ++q)
      if (tid + q * THREADS < nx) put_x(tid + q * THREADS, xv[q]);
    for (int i = tid + XT * THREADS; i < nx; i += THREADS) {
      const uint32_t v[4] = {x_code(kps, i, 0), x_code(kps, i, 1), x_code(kps, i, 2),
                             x_code(kps, i, 3)};
      put_x(i, v);
    }
    const int ns = sign_rows(kps) * BN;
#pragma unroll
    for (int q = 0; q < ST; ++q)
      if (tid + q * THREADS < ns) put_w(tid + q * THREADS, sv[q]);
    for (int i = tid + ST * THREADS; i < ns; i += THREADS) put_w(i, sign_of(kps, i));
  };

  uint32_t acc[AT][NT][4];
  int dacc[AT][NT][4];                  // m > 32: a fragment's sums over its chunks
#pragma unroll
  for (int t = 0; t < AT; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[t][j][e] = 0u;
        dacc[t][j][e] = 0;
      }
  const int zero[4] = {0, 0, 0, 0};

  // acc += clip(d) * multiplier, for D rows gid (h = 0) and gid + 8 (h = 1)
  const auto epilogue = [&](uint32_t (&out)[4], const int (&d)[4], const uint32_t (&w)[2][8],
                            int j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t v = static_cast<uint32_t>(d[e]);
      if constexpr (Clip) v = min(v, p.adc_max);
      out[e] += v * w[e >> 1][4 * (e & 1) + j];
    }
  };

  const int nstages = (kp1 - kp0 + SK - 1) / SK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nstages) load_cells(s);
    cp_async_commit();
  }
  if (nstages > 0) fetch(0);
  __syncthreads();   // xs is zero

  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage s's cells have landed; stage s-1 is read by all
    stage_inputs(s);
    if (s + STAGES - 1 < nstages) load_cells(s + STAGES - 1);
    cp_async_commit();
    if (s + 1 < nstages) fetch(s + 1);
    __syncthreads();

    const int kps = kp0 + s * SK;
    const int nch = min(CH, (kp1 - kps) / 32);
    const uint8_t* cbuf = cs + (s % STAGES) * p.cg * SK * CS_LD;
    const int f_first = kps / p.mp;
    for (int ch = 0; ch < nch; ++ch) {
      const int kg = kps + ch * 32;                   // the chunk's first padded row
      // A: the lane's bytes of every tile's rows gid and gid + 8
      uint32_t a[AT][4];
#pragma unroll
      for (int t = 0; t < AT; ++t) {
        const uint8_t* base = xs + (warp * AT + t) * p.R * XS_LD + ch * 32 + tig * 4;
        a[t][0] = lds32(base + q_lo * XS_LD) & amask;
        a[t][3] = lds32(base + q_hi * XS_LD + 16) & amask;
        a[t][1] = full ? lds32(base + q_hi * XS_LD) : 0u;
        a[t][2] = full ? lds32(base + q_lo * XS_LD + 16) : 0u;
      }
      // the stage rows of ws of the lane's two fragments
      const int fl0 = kg / p.mp + g_lo - f_first, fl1 = kg / p.mp + g_hi - f_first;
      const bool last = !Multi || (kg + 32) % p.mp == 0;   // the fragment ends here
      for (int c = 0; c < ncg; ++c) {
        // B: k rows tig*4 + 0..3 (b0) and + 16 (b1), physical columns
        // 4*gid + j = logical column gid of n8 tile j
        uint32_t b[NT][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint8_t* rows = cbuf + (c * SK + ch * 32 + 16 * h + tig * 4) * CS_LD + 4 * gid;
          const uint32_t v[4] = {lds32(rows), lds32(rows + CS_LD), lds32(rows + 2 * CS_LD),
                                 lds32(rows + 3 * CS_LD)};
          const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140u);
          const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362u);
          const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140u);
          const uint32_t hi23 = __byte_perm(v[2], v[3], 0x7362u);
          b[0][h] = __byte_perm(lo01, lo23, 0x5410u);
          b[1][h] = __byte_perm(lo01, lo23, 0x7632u);
          b[2][h] = __byte_perm(hi01, hi23, 0x5410u);
          b[3][h] = __byte_perm(hi01, hi23, 0x7632u);
        }
        // multipliers of physical columns 8*tig .. 8*tig + 7, the lane's D columns
        uint32_t w[2][8];
        if (last) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint4* src = reinterpret_cast<const uint4*>(
                ws + (c * p.wrows + (h ? fl1 : fl0)) * BN + 8 * tig);
            const uint4 w0 = src[0], w1 = src[1];
            w[h][0] = w0.x; w[h][1] = w0.y; w[h][2] = w0.z; w[h][3] = w0.w;
            w[h][4] = w1.x; w[h][5] = w1.y; w[h][6] = w1.z; w[h][7] = w1.w;
          }
        }
#pragma unroll
        for (int t = 0; t < AT; ++t)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if constexpr (Multi) {
              mma_u8_16832(dacc[t][j], a[t], b[j], dacc[t][j]);
            } else {
              int d[4];
              mma_u8_16832(d, a[t], b[j], zero);
              epilogue(acc[t][j], d, w, j);
            }
          }
        if constexpr (Multi) {
          if (last) {
#pragma unroll
            for (int t = 0; t < AT; ++t)
#pragma unroll
              for (int j = 0; j < NT; ++j) {
                epilogue(acc[t][j], dacc[t][j], w, j);
#pragma unroll
                for (int e = 0; e < 4; ++e) dacc[t][j][e] = 0;
              }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the stages are free: red aliases them

  // the pairs of one row, each shifted by its bit, summed per output
  uint32_t* red = reinterpret_cast<uint32_t*>(smem);   // [r_hi - r_lo + 1][BN]
  const int nrr = r_hi - r_lo + 1;
  for (int i = tid; i < nrr * BN; i += THREADS) red[i] = 0u;
  __syncthreads();
#pragma unroll
  for (int t = 0; t < AT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gp = p0 + (warp * AT + t) * p.R + ((e >> 1) ? q_hi : q_lo);
      if (gp >= MB) continue;
      const int r = gp / p.B, b = gp % p.B;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        atomicAdd(red + (r - r_lo) * BN + 8 * tig + 4 * (e & 1) + j, acc[t][j][e] << b);
    }
  __syncthreads();
  for (int i = tid; i < nrr * BN; i += THREADS) {
    const int r = r_lo + i / BN, gc = col0 + i % BN;
    if (gc < p.N) atomicAdd(p.acc + static_cast<size_t>(r) * p.N + gc, red[i]);
  }
}

// a fragment's rows on the padded K axis: the next power of two (at least
// 2) up to 32, else the next multiple of 32
int padded_fragment(int m) {
  if (m > 32) return (m + 31) / 32 * 32;
  int mp = 2;
  while (mp < m) mp *= 2;
  return mp;
}

template <bool Multi, bool Clip>
int resident_blocks(int smem) {
  cudaFuncSetAttribute(bitserial_crossbar_kernel<Multi, Clip>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bitserial_crossbar_kernel<Multi, Clip>,
                                                THREADS, smem);
  return n > 0 ? n : 1;
}

// the launch geometry of a call: grid and Params (pointers aside)
struct Plan {
  dim3 grid;
  Params p;
  bool multi, clip;
};

Plan plan_of(int M, int N, int K, int C, int m, int input_bits, int cell_bits,
             unsigned adc_max) {
  Plan pl{};
  Params& p = pl.p;
  p.M = M; p.N = N; p.K = K; p.C = C; p.m = m; p.B = input_bits; p.cb = cell_bits;
  p.adc_max = adc_max;
  p.F = K / m;
  pl.multi = m > 32;
  p.mp = padded_fragment(m);
  p.G = pl.multi ? 1 : 32 / p.mp;
  p.R = 16 / p.G;
  p.cg = pl.multi ? 1 : min(C, CG_MAX);
  p.groups = (C + p.cg - 1) / p.cg;
  p.cpu = pl.multi ? p.mp / 32 : 1;
  p.units = pl.multi ? p.F : (p.F + p.G - 1) / p.G;
  p.wrows = (SK - 1) / p.mp + 2;
  p.vec = N % 16 == 0;
  // an ADC that cannot clip a fragment's sum (at most m * 255) is not applied
  pl.clip = static_cast<unsigned long long>(adc_max) < 255ull * static_cast<unsigned>(m);
  const int gx = (M * input_bits + block_pairs(p.R) - 1) / block_pairs(p.R);
  const int gy = (N + BN - 1) / BN;
  // the K split: the one whose waves of resident blocks finish first, a
  // block costing its chunks plus BLOCK_COST
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = smem_bytes(p);
  const int per_sm = pl.multi ? (pl.clip ? resident_blocks<true, true>(smem)
                                         : resident_blocks<true, false>(smem))
                              : (pl.clip ? resident_blocks<false, true>(smem)
                                         : resident_blocks<false, false>(smem));
  const long long slots = static_cast<long long>(sms > 0 ? sms : 1) * per_sm;
  const long long base = static_cast<long long>(gx) * gy * p.groups;
  long long best = -1;
  for (int split = 1; split <= p.units; ++split) {
    const int upb = (p.units + split - 1) / split;
    if ((p.units + upb - 1) / upb != split) continue;   // the same as a smaller split
    const long long waves = (base * split + slots - 1) / slots;
    const long long cost = waves * (static_cast<long long>(upb) * p.cpu + BLOCK_COST);
    if (best < 0 || cost < best) {
      best = cost;
      p.upb = upb;
    }
  }
  const int splits = (p.units + p.upb - 1) / p.upb;
  pl.grid = dim3(gx, gy, splits * p.groups);
  return pl;
}

template <bool Multi, bool Clip>
void launch(const Params& p, dim3 grid, cudaStream_t stream) {
  const int smem = smem_bytes(p);
  cudaFuncSetAttribute(bitserial_crossbar_kernel<Multi, Clip>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  bitserial_crossbar_kernel<Multi, Clip><<<grid, THREADS, smem, stream>>>(p);
}

bool valid_args(int M, int N, int K, int C, int m, int input_bits, int cell_bits) {
  return m >= 1 && K % m == 0 && C >= 1 && cell_bits >= 1 && input_bits >= 1 &&
         input_bits <= 32 && M >= 0 && N >= 0 && K >= 0 &&
         static_cast<long long>(M) * input_bits < (1ll << 31) &&
         static_cast<long long>(K / m + 32) * padded_fragment(m) < (1ll << 31);
}

}  // namespace

extern "C" {

// Plain C entry point for ctypes.  Every pointer is a contiguous row-major
// device buffer: x (M, K) int32, cells (C, K, N) uint8, signs (K/m, N) int8,
// acc (M, N) int32 set to zero by the caller, eic (M, K/m) int32.  Needs
// K % m == 0, 1 <= input_bits <= 32, M * input_bits < 2^31 and the padded
// K axis (fragments padded, see padded_fragment) below 2^31; adc_max =
// 2^adc_bits - 1, or 0xffffffff for an ideal ADC.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments out of range.
int forms_bitserial_crossbar(const void* x, const void* cells, const void* signs, void* acc,
                             void* eic, int M, int N, int K, int C, int m, int input_bits,
                             int cell_bits, unsigned adc_max, void* stream_ptr) {
  if (!valid_args(M, N, K, C, m, input_bits, cell_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0 || K == 0) return static_cast<int>(cudaGetLastError());
  Plan pl = plan_of(M, N, K, C, m, input_bits, cell_bits, adc_max);
  Params& p = pl.p;
  p.x = static_cast<const int32_t*>(x);
  p.cells = static_cast<const uint8_t*>(cells);
  p.signs = static_cast<const int8_t*>(signs);
  p.acc = static_cast<unsigned*>(acc);
  p.eic = static_cast<int*>(eic);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (pl.multi && pl.clip) launch<true, true>(p, pl.grid, stream);
  else if (pl.multi) launch<true, false>(p, pl.grid, stream);
  else if (pl.clip) launch<false, true>(p, pl.grid, stream);
  else launch<false, false>(p, pl.grid, stream);
  return static_cast<int>(cudaGetLastError());
}

// The launch the call above would make with the same arguments: out[0..2]
// its grid, out[3] the threads per block, out[4] its dynamic shared memory in
// bytes, out[5] the m16n8k32 MMAs it issues (every warp), out[6] its padded
// fragment rows, out[7] 1 where it clips at adc_max.  Returns 0, or
// cudaErrorInvalidValue for arguments out of range.
int forms_bitserial_plan(int M, int N, int K, int C, int m, int input_bits, int cell_bits,
                         unsigned adc_max, long long* out) {
  if (!valid_args(M, N, K, C, m, input_bits, cell_bits) || M == 0 || N == 0 || K == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_of(M, N, K, C, m, input_bits, cell_bits, adc_max);
  const long long chunks = static_cast<long long>(pl.p.units) * pl.p.cpu;
  out[0] = pl.grid.x;
  out[1] = pl.grid.y;
  out[2] = pl.grid.z;
  out[3] = THREADS;
  out[4] = smem_bytes(pl.p);
  out[5] = static_cast<long long>(pl.grid.x) * pl.grid.y * chunks * C * WARPS * AT * NT;
  out[6] = pl.p.mp;
  out[7] = pl.clip;
  return 0;
}

}  // extern "C"
