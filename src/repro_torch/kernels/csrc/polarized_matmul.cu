// Polarized-magnitude matmul for Hopper (sm_90a), f32 math on the CUDA cores:
//
//   y[M, N] = (x[M, K] @ (repeat(signs[K/m, N], m, axis=0) * mags[K, N])) * scale[N]
//
// x f32 or bf16 (widened in the kernel, exactly), mags uint8 (int32 when
// bits > 8), signs int8 +-1, scale f32, y f32.
//
// Replaces the Pallas TPU kernels src/repro/kernels/polarized_matmul.py:45
// (src/repro/kernels/polarized_matmul.py::_kernel, dense) and
// src/repro/kernels/polarized_matmul.py:68 (::_kernel_skip, input
// zero-skipping) below TC_MIN_ROWS rows of x -- decode, where M is the number
// of serving slots -- and for int32 codes and f32 x at any M;
// polarized_matmul_tc.cu takes bf16 x at prefill.  The TPU kernel walks a
// sequential (M/bm, N/bn, K/bk) grid, folds the fragment signs into a
// magnitude tile in VMEM and feeds the MXU, carrying the f32 sum in scratch
// across K steps.  Here blocks run in parallel in no order, so K is cut
// across blocks and their partial sums are combined at the end.
//
// What bounds it on an H100.  At M <= 8 the product does 2M flops per byte
// of codes, ~300x below the bf16 ridge: bytes bound it.  One qwen2-1.5b layer
// moves 46.8 MB of uint8 codes and 5.9 MB of signs, 15.7 us at 3.35 TB/s,
// and Little's law asks for ~25 KB in flight per SM, continuously.  The
// kernel this one replaced issued one burst of 8 KB of loads per block and
// then a serial chain (x staged behind a barrier, three barriers, a ticket),
// 1,680 blocks in four waves: its time followed its waves, not its bytes
// (13.8 MB in ~29 us, 14% of HBM's rate), and each code cost two
// int-to-float conversions.  This design (PERF.md):
//   * one wave of long-lived blocks.  A block owns a column tile of 128
//     columns -- whole 128-byte lines of codes -- and a K range of ``group``
//     slices of 256 rows; the wrapper's plan (polarized_matmul.decode_split)
//     picks the group whose busiest SM has least to stream, so 8960 x 1536
//     runs 108 blocks of 1,024 rows and 1536 x 8960 210 blocks of 512;
//   * each warp streams its own contiguous eighth of the block's rows, 8 rows
//     (1 KB of codes, with the rows' x and the fragment's sign row) at a
//     time, through its own ring of 16-byte cp.async copies in dynamic
//     shared memory, five stages in flight behind the one it sums: no block
//     barrier until the epilogue, ~40 KB in flight per block from the first
//     instruction;
//   * cheap conversion: a uint8 code and its fragment's sign become one f32
//     by a __byte_perm under the exponent of 2^23 (sign bit included) and one
//     FADD of -+2^23 (exact), no I2F; int32 codes convert with I2F and flip
//     the sign bit.  bf16 x is widened once per stage for the warp (its bits
//     under an f32 exponent, exact), so a bf16 launch computes on the very
//     values of the f32 launch on x.float().  f32 FMAs throughout: the
//     kernel's contract;
//   * fixed-order sums: each lane sums its rows in K order, the warps are
//     added in warp (K) order through shared memory, and the K splits in
//     split order by the last split to take its tile's ticket (prefetched to
//     L2 at the start; the tickets return to zero).  No float atomics: two
//     launches give equal bits.
// Measured on an H100 (PERF.md): 13.8 MB in ~14.5 us past the timing method's
// 4.9 us floor (0.8 TB/s with it) at M = 4, held in about equal parts by the
// streaming, the FMAs that overlap it only in part, and the split
// epilogue's chain of L2 round trips.  Neither wgmma nor TMA is used: the
// row tiles are 4 or 8 rows where wgmma takes 64, and 16-byte cp.async keeps
// the bytes in flight (and is emulated on the host for the CPU tests).  TMA
// bulk copies into an mbarrier ring, and a split-free (stream-K) balance of
// the SMs, are the next steps.
//
// ``mask`` (input zero-skipping) holds one int per (row tile of BM rows, K
// slice of 256 rows) -- BM = 4 at M <= 4, else 8 -- made by the wrapper from x
// before the launch.  Inside a block's K range a dead slice issues no copies
// and no FMAs: its stages drop out of the warps' rings.  The dense launch
// sums those stages on an all-zero x, and adding an exact 0 changes no sum,
// so skip equals dense bit for bit; a block whose whole range is dead still
// publishes its zero partial and takes its ticket.  ``gate`` (optional, one
// int on the device) turns a whole launch off when it reads 0: the wrapper's
// fragment compaction launches both the compacted and the full product with
// opposite gates, so exactly one of them writes y and the choice never
// visits the host.  Shapes whose rows are not 16-byte aligned (N % 16 or
// K % 8 nonzero) take the same code with element-wise staging (``fast`` = 0);
// m not a multiple of 8 reads each row's signs from global memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 256;              // K rows per mask slice (the zero-skip granule)
constexpr int BN = 128;              // output columns per block: 128-byte rows of codes
constexpr int VEC = 4;               // output columns per lane
constexpr int WR = 8;                // K rows per warp stage
constexpr int MAX_GROUP = 32;        // K slices per block, at most (one bit each)

// ring depth per warp: 6 stages of 1 KB of uint8 codes, 4 of 4 KB of int32 ones
template <typename MagT>
__host__ __device__ constexpr int stages() { return sizeof(MagT) == 1 ? 6 : 4; }

// one warp stage in shared memory: WR rows of BN codes, the rows' x (BM x
// WR, f32 or bf16 as given) and the fragment's sign row
template <int BM, typename MagT>
struct Stage {
  static constexpr int CODES = WR * BN * static_cast<int>(sizeof(MagT));
  static constexpr int X = BM * WR * 4;
  static constexpr int BYTES = CODES + X + BN;
};

// a warp's ring, and after it the bf16 x of its stage widened to f32
template <int BM, typename MagT>
__host__ __device__ constexpr int warp_bytes() {
  return stages<MagT>() * Stage<BM, MagT>::BYTES + BM * WR * 4;
}

// the block's dynamic shared memory: its warps' rings (the warps' sums of
// the epilogue alias them)
template <int BM, typename MagT>
__host__ __device__ constexpr int smem_bytes() { return WARPS * warp_bytes<BM, MagT>(); }

static_assert(WARPS * 8 * BN * 4 <= smem_bytes<8, uint8_t>(), "the warp sums alias the rings");

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

// the line of p into L2, ahead of its use
__device__ __forceinline__ void prefetch_l2(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
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

// the f32 sign bit of byte q of a word of int8 signs (+-1)
__device__ __forceinline__ uint32_t sign_bit(uint32_t sw, int q) {
  return (sw << (24 - 8 * q)) & 0x80000000u;
}

// one row's 4 codes with their fragment signs applied, as f32, exactly.
// ``set`` takes the word of the 4 columns' signs, ``get`` a row's codes.
template <typename MagT>
struct Signed;

// uint8: code v in the low byte under the exponent of 2^23, and the sign bit
// of a negative fragment above it, is the float s * (2^23 + v) (one
// __byte_perm); adding -s * 2^23 leaves s * v (one FADD)
template <>
struct Signed<uint8_t> {
  uint32_t hi[VEC];   // bytes 4-7 of the permute: 0, 0, 0, 0x4B | sign
  float off[VEC];     // -s * 2^23
  __device__ __forceinline__ void set(uint32_t sw) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const uint32_t b = sign_bit(sw, q);
      hi[q] = 0x4B000000u | b;
      off[q] = __uint_as_float(0xCB000000u ^ b);
    }
  }
  __device__ __forceinline__ void get(const uint8_t* p, float (&w)[VEC]) const {
    const uint32_t cw = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int q = 0; q < VEC; ++q)
      w[q] = __uint_as_float(__byte_perm(cw, hi[q], 0x7540u | q)) + off[q];
  }
};

// int32 (bits > 8): converted, then the sign bit flipped for a negative fragment
template <>
struct Signed<int32_t> {
  uint32_t sb[VEC];
  __device__ __forceinline__ void set(uint32_t sw) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) sb[q] = sign_bit(sw, q);
  }
  __device__ __forceinline__ void get(const int32_t* p, float (&w)[VEC]) const {
    const int4 v = *reinterpret_cast<const int4*>(p);
    const int c[VEC] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < VEC; ++q)
      w[q] = __uint_as_float(__float_as_uint(static_cast<float>(c[q])) ^ sb[q]);
  }
};

// bf16 (its 16 bits) as f32: under an f32 exponent, exactly
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// the launch's operands and this block's tile
template <typename MagT, typename XT>
struct Op {
  const XT* x;
  const MagT* mags;
  const int8_t* signs;
  int M, N, K, m, row0, col0, kend;
  bool fast;
};

// this lane's share of every warp stage's 16-byte copies (the fast path),
// worked out once: its code chunks, x chunk and sign chunk, with the stage's
// first K row left out
template <int BM, typename MagT, typename XT>
struct Feed {
  static constexpr int PER = 16 / sizeof(MagT);       // codes per chunk
  static constexpr int CH = BN / PER;                 // chunks per row of codes
  static constexpr int JN = WR * CH / 32;             // code chunks per lane
  static constexpr int JROWS = 32 / CH;               // rows between them
  static constexpr int XCH = WR * sizeof(XT) / 16;    // chunks per row of x
  const MagT* code;       // chunk 0 at K row 0
  const XT* x;            // x chunk at K row 0, when xlane
  const int8_t* sign;     // sign chunk of fragment row 0, when slane
  size_t step;            // JROWS rows of codes
  int crow, cdst, xdst;   // chunk 0's row in the stage; offsets in the slot
  bool cok, xlane, xok, slane, sok;
  __device__ __forceinline__ Feed(const Op<MagT, XT>& o, int lane) {
    const int col = (lane % CH) * PER, xr = lane / XCH, xc = (lane % XCH) * (16 / sizeof(XT));
    crow = lane / CH;
    cdst = crow * BN + col;
    cok = o.col0 + col < o.N;
    code = o.mags + (cok ? static_cast<size_t>(crow) * o.N + o.col0 + col : 0);
    step = static_cast<size_t>(JROWS) * o.N;
    xlane = lane < BM * XCH;
    xok = xlane && o.row0 + xr < o.M;
    xdst = xr * WR + xc;
    x = o.x + (xok ? static_cast<size_t>(o.row0 + xr) * o.K + xc : 0);
    slane = lane < BN / 16;
    sok = slane && o.col0 + lane * 16 < o.N;
    sign = o.signs + (sok ? o.col0 + lane * 16 : 0);
  }
};

// one warp stage into the warp's ring slot: rows k0 .. k0 + WR - 1 (k0 <
// kend) of the codes, of x (zero past M and kend) and the fragment's sign
// row (Frag).  Rows whose 16-byte chunks are aligned (``fast``) go by
// cp.async into the caller's open copy group; the rest are loaded here,
// element by element.
template <int BM, bool Frag, typename MagT, typename XT>
__device__ __forceinline__ void load_stage(const Op<MagT, XT>& o, const Feed<BM, MagT, XT>& f,
                                           unsigned char* slot, int k0, int lane) {
  using St = Stage<BM, MagT>;
  MagT* cs = reinterpret_cast<MagT*>(slot);
  XT* xs = reinterpret_cast<XT*>(slot + St::CODES);
  int8_t* ss = reinterpret_cast<int8_t*>(slot + St::CODES + St::X);
  // the fragment of the stage (m == 8, the served case, without a division)
  const int frow = o.m == WR ? k0 / WR : k0 / o.m;
  if (o.fast) {
    // N % 16 == 0 and K % 8 == 0: a 16-byte chunk is in or out as a whole
    const MagT* code = f.code + static_cast<size_t>(k0) * o.N;
#pragma unroll
    for (int j = 0; j < f.JN; ++j) {
      const bool ok = f.cok && k0 + f.crow + j * f.JROWS < o.kend;
      cp_async16(cs + f.cdst + j * f.JROWS * BN, ok ? code + j * f.step : o.mags, ok);
    }
    if (f.xlane) cp_async16(xs + f.xdst, f.xok ? f.x + k0 : o.x, f.xok);
    if (Frag && f.slane)
      cp_async16(ss + lane * 16, f.sok ? f.sign + static_cast<size_t>(frow) * o.N : o.signs,
                 f.sok);
  } else {
    for (int i = lane; i < WR * BN; i += 32) {
      const int gk = k0 + i / BN, gc = o.col0 + i % BN;
      cs[i] = (gk < o.kend && gc < o.N) ? o.mags[static_cast<size_t>(gk) * o.N + gc] : 0;
    }
    for (int i = lane; i < BM * WR; i += 32) {
      const int gr = o.row0 + i / WR, gk = k0 + i % WR;
      xs[i] = (gr < o.M && gk < o.kend) ? o.x[static_cast<size_t>(gr) * o.K + gk] : XT(0);
    }
    if (Frag) {
      for (int i = lane; i < BN; i += 32)
        ss[i] = o.col0 + i < o.N ? o.signs[static_cast<size_t>(frow) * o.N + o.col0 + i] : 1;
    }
  }
}

// the word of int8 signs of this lane's 4 columns in K row k, read from
// global memory (fragment signs not staged: any m), 0 past N
template <typename MagT, typename XT>
__device__ __forceinline__ uint32_t sign_word(const Op<MagT, XT>& o, int k, int cv) {
  const int8_t* p = o.signs + static_cast<size_t>(k / o.m) * o.N + o.col0 + cv;
  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < VEC; ++q)
    if (o.col0 + cv + q < o.N) w |= static_cast<uint32_t>(static_cast<uint8_t>(p[q])) << (8 * q);
  return w;
}

// one warp stage summed into acc in K order: the lane's 4 columns of rows
// k0 .. k0 + WR - 1.  With the fragment's signs staged (``Frag``: m a
// multiple of WR, so the stage lies in one fragment) one sign word serves
// the stage; otherwise each row reads its own.
template <int BM, bool Frag, typename MagT, typename XT>
__device__ __forceinline__ void sum_stage(float (&acc)[BM][VEC], const Op<MagT, XT>& o,
                                          const unsigned char* slot, const float* xf, int k0,
                                          int cv) {
  using St = Stage<BM, MagT>;
  const MagT* cs = reinterpret_cast<const MagT*>(slot);
  Signed<MagT> sg;
  if constexpr (Frag)
    sg.set(*reinterpret_cast<const uint32_t*>(slot + St::CODES + St::X + cv));
#pragma unroll
  for (int h = 0; h < WR; h += 4) {
    float4 xv[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) xv[r] = *reinterpret_cast<const float4*>(xf + r * WR + h);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // rows past kend meet zero codes and zero x; any sign row will do
      if constexpr (!Frag) sg.set(sign_word(o, min(k0 + h + j, o.kend - 1), cv));
      float w[VEC];
      sg.get(cs + (h + j) * BN + cv, w);
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float a = j == 0 ? xv[r].x : j == 1 ? xv[r].y : j == 2 ? xv[r].z : xv[r].w;
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[r][q] = fmaf(a, w[q], acc[r][q]);
      }
    }
  }
}

template <int BM, bool Frag, typename MagT, typename XT>
__global__ void __launch_bounds__(THREADS, 2)
polarized_matmul_kernel(const XT* __restrict__ x, const MagT* __restrict__ mags,
                        const int8_t* __restrict__ signs, const float* __restrict__ scale,
                        const int* __restrict__ mask, const int* __restrict__ gate,
                        float* __restrict__ y, float* __restrict__ work,
                        int* __restrict__ tickets, int M, int N, int K, int m, int fast,
                        int group) {
  // the launch's gate comes first: uniform over the launch
  if (gate != nullptr && *gate == 0) return;
#ifdef CUDA_HOST_EMULATION
  unsigned char* smem = host_dynamic_smem;
#else
  extern __shared__ __align__(16) unsigned char smem[];
#endif
  constexpr int WST = stages<MagT>();
  using St = Stage<BM, MagT>;
  __shared__ int last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cv = lane * VEC;                 // this lane's first column of the tile
  const int S = (K + KC - 1) / KC;           // K slices (the mask's columns)
  const int t0 = blockIdx.z * group;         // this block's first slice
  const int nt = min(group, S - t0);
  const int kbeg = t0 * KC;
  const Op<MagT, XT> o{x, mags, signs, M, N, K, m, static_cast<int>(blockIdx.y) * BM,
                       static_cast<int>(blockIdx.x) * BN, min(K, (t0 + nt) * KC), fast != 0};
  const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
  if (gridDim.z > 1 && tid == 0) prefetch_l2(tickets + tile_id);   // for the epilogue

  // the block's live slices (all of them without a mask): a dead slice (all
  // of its x zero) issues no copies and no FMAs
  unsigned live = 0;
  for (int t = 0; t < nt; ++t)
    if (mask == nullptr || mask[blockIdx.y * S + t0 + t] != 0) live |= 1u << t;

  // warp w streams its own contiguous share of the block's rows, WR at a
  // time, through its own ring: no block-wide barrier until the epilogue
  const int wrows = group * KC / WARPS;      // rows per warp (a multiple of WR)
  const int kw0 = kbeg + warp * wrows;
  const int nws = wrows / WR;                // the warp's stages
  const auto next_live = [&](int i) {        // the first live stage from i
    for (; i < nws; ++i) {
      const int k0 = kw0 + i * WR;
      if (k0 < o.kend && (live >> ((k0 - kbeg) / KC) & 1u)) break;
    }
    return i;
  };
  unsigned char* ring = smem + warp * warp_bytes<BM, MagT>();
  float* xw = reinterpret_cast<float*>(ring + WST * St::BYTES);   // widened bf16 x

  float acc[BM][VEC];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[r][q] = 0.f;

  const Feed<BM, MagT, XT> feed(o, lane);
  int ni = next_live(0);   // the next stage to issue
  int ci = ni;             // and to sum
  int issued = 0, put = 0, get = 0;   // stages issued; their ring slots
  const auto issue = [&] {
    load_stage<BM, Frag>(o, feed, ring + put * St::BYTES, kw0 + ni * WR, lane);
    ++issued;
    put = put + 1 == WST ? 0 : put + 1;
    ni = next_live(ni + 1);
  };
#pragma unroll
  for (int p = 0; p < WST - 1; ++p) {
    if (ni < nws) issue();
    cp_async_commit();
  }
  for (int done = 0; done < issued; ++done) {
    cp_async_wait<WST - 2>();
    __syncwarp();   // stage `done` has landed for the warp; stage done-1 is summed
    if (ni < nws) issue();
    cp_async_commit();
    const unsigned char* slot = ring + get * St::BYTES;
    get = get + 1 == WST ? 0 : get + 1;
    const float* xf = reinterpret_cast<const float*>(slot + St::CODES);
    if constexpr (sizeof(XT) == 2) {
      // bf16 x widened to f32 once per stage, for the whole warp
      for (int i = lane; i < BM * WR; i += 32)
        xw[i] = widen(reinterpret_cast<const uint16_t*>(slot + St::CODES)[i]);
      __syncwarp();
      xf = xw;
    }
    sum_stage<BM, Frag>(acc, o, slot, xf, kw0 + ci * WR, cv);
    ci = next_live(ci + 1);
  }
  cp_async_wait<0>();
  __syncthreads();   // the rings are free: red aliases them

  // the warps' sums, added in warp order (K order): red[WARPS][BM][BN]
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < BM; ++r)
    *reinterpret_cast<float4*>(red + (warp * BM + r) * BN + cv) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  constexpr int OUTS = BM * BN / THREADS;   // outputs per thread
  float tile[OUTS];
#pragma unroll
  for (int i = 0; i < OUTS; ++i) {
    tile[i] = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) tile[i] += red[w * BM * BN + tid + i * THREADS];
  }
  // output i of this thread: row e / BN, column e % BN of the tile
  const auto at = [&](int i, int& gr, int& gc) {
    const int e = tid + i * THREADS;
    gr = o.row0 + e / BN;
    gc = o.col0 + e % BN;
    return gr < M && gc < N;
  };

  const int splits = gridDim.z;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < OUTS; ++i) {
      int gr, gc;
      if (at(i, gr, gc)) y[static_cast<size_t>(gr) * N + gc] = tile[i] * scale[gc];
    }
    return;
  }

  // publish this split's tile; the last split of the tile to arrive sums
  // all splits in split order, eight loads in flight at a time
#pragma unroll
  for (int i = 0; i < OUTS; ++i) {
    int gr, gc;
    if (at(i, gr, gc)) work[(static_cast<size_t>(blockIdx.z) * M + gr) * N + gc] = tile[i];
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();   // the block's writes, seen through the barrier, before the ticket
    last = atomicAdd(tickets + tile_id, 1) == splits - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < OUTS; ++i) {
    int gr, gc;
    if (!at(i, gr, gc)) continue;
    const float* p = work + static_cast<size_t>(gr) * N + gc;
    const size_t plane = static_cast<size_t>(M) * N;
    float s = 0.f;
    for (int z = 0; z < splits; z += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = z + u < splits ? __ldcg(p + (z + u) * plane) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (z + u < splits) s += v[u];
    }
    y[static_cast<size_t>(gr) * N + gc] = s * scale[gc];
  }
  if (tid == 0) tickets[tile_id] = 0;  // ready for the next launch
}

struct Args {
  const void *x, *mags, *signs, *scale, *mask, *gate;
  void *y, *work, *tickets;
  int M, N, K, m, fast, group;
};

template <int BM, bool Frag, typename MagT, typename XT>
void launch_tile(const Args& a, cudaStream_t stream) {
  const int S = (a.K + KC - 1) / KC;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, (S + a.group - 1) / a.group);
  constexpr int smem = smem_bytes<BM, MagT>();
  // above 48 KB of dynamic shared memory: allowed once per device
  static bool allowed[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !allowed[dev]) {
    cudaFuncSetAttribute(polarized_matmul_kernel<BM, Frag, MagT, XT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (dev >= 0 && dev < 64) allowed[dev] = true;
  }
  polarized_matmul_kernel<BM, Frag, MagT, XT><<<grid, THREADS, smem, stream>>>(
      static_cast<const XT*>(a.x), static_cast<const MagT*>(a.mags),
      static_cast<const int8_t*>(a.signs), static_cast<const float*>(a.scale),
      static_cast<const int*>(a.mask), static_cast<const int*>(a.gate),
      static_cast<float*>(a.y), static_cast<float*>(a.work), static_cast<int*>(a.tickets),
      a.M, a.N, a.K, a.m, a.fast, a.group);
}

template <typename MagT, typename XT>
int launch(const Args& a, void* stream_ptr) {
  const int bm = a.M <= 4 ? 4 : 8;
  if (a.m <= 0 || a.group < 1 || a.group > MAX_GROUP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.M <= 0 || a.N <= 0 || a.K <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // a warp stage (WR rows from a multiple of WR) lies in one fragment when
  // m is a multiple of WR: its sign row is staged with it
  const bool frag = a.m % WR == 0;
  if (bm == 4 && frag) launch_tile<4, true, MagT, XT>(a, stream);
  else if (bm == 4) launch_tile<4, false, MagT, XT>(a, stream);
  else if (frag) launch_tile<8, true, MagT, XT>(a, stream);
  else launch_tile<8, false, MagT, XT>(a, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C entry points for ctypes, one per (x dtype, code dtype): x f32 or
// bf16 (its bits, uint16), mags uint8 or int32.  Every pointer is a
// contiguous row-major device buffer.  A block covers BM rows of x (4 for
// M <= 4, else 8), 128 columns and ``group`` (1..32) K slices of KC = 256
// rows (forms_polarized_matmul_kc): S = ceil(ceil(K / 256) / group) K
// splits.  With S > 1, ``work`` holds S * M * N floats of scratch and
// ``tickets`` at least ceil(N / 128) * ceil(M / BM) ints, all zero; the
// kernel leaves them zero again.  Launches that may overlap (other streams)
// need tickets of their own, and after a failed launch the caller gives the
// next one fresh zeros.  ``fast`` may be 1 only when N % 16 == 0, K % 8 == 0
// and x, mags and signs are 16-byte aligned.  ``mask`` holds ceil(M / BM) x
// ceil(K / 256) ints, row-major, or is null (every slice live: the dense
// kernel); ``gate`` is one int, or null (always run).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an m or group out of
// range.
int forms_polarized_matmul_kc(void) { return KC; }

int forms_polarized_matmul_u8(const void* x, const void* mags, const void* signs,
    const void* scale, const void* mask, const void* gate, void* y, void* work, void* tickets,
    int M, int N, int K, int m, int fast, int group, void* stream) {
  return launch<uint8_t, float>(
      {x, mags, signs, scale, mask, gate, y, work, tickets, M, N, K, m, fast, group}, stream);
}

int forms_polarized_matmul_i32(const void* x, const void* mags, const void* signs,
    const void* scale, const void* mask, const void* gate, void* y, void* work, void* tickets,
    int M, int N, int K, int m, int fast, int group, void* stream) {
  return launch<int32_t, float>(
      {x, mags, signs, scale, mask, gate, y, work, tickets, M, N, K, m, fast, group}, stream);
}

int forms_polarized_matmul_u8_bf16(const void* x, const void* mags, const void* signs,
    const void* scale, const void* mask, const void* gate, void* y, void* work, void* tickets,
    int M, int N, int K, int m, int fast, int group, void* stream) {
  return launch<uint8_t, uint16_t>(
      {x, mags, signs, scale, mask, gate, y, work, tickets, M, N, K, m, fast, group}, stream);
}

int forms_polarized_matmul_i32_bf16(const void* x, const void* mags, const void* signs,
    const void* scale, const void* mask, const void* gate, void* y, void* work, void* tickets,
    int M, int N, int K, int m, int fast, int group, void* stream) {
  return launch<int32_t, uint16_t>(
      {x, mags, signs, scale, mask, gate, y, work, tickets, M, N, K, m, fast, group}, stream);
}

}  // extern "C"
