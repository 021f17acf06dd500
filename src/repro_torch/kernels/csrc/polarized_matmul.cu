// Polarized-magnitude matmul for Hopper (sm_90a):
//
//   y[M, N] = (x[M, K] @ (repeat(signs[K/m, N], m, axis=0) * mags[K, N])) * scale[N]
//
// x f32, mags uint8 (int32 when bits > 8), signs int8 +-1, scale f32, y f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/polarized_matmul.py::_kernel.
// The TPU kernel walks a sequential (M/bm, N/bn, K/bk) grid, folds the fragment
// signs into a (bk, bn) magnitude tile in VMEM and feeds the MXU, carrying the
// f32 sum in scratch across K steps.  Here blocks run in parallel in no order
// and nothing carries between them, so the K axis is cut into slices of KC
// rows, one block per (column tile, row tile, K slice), and the slices' sums
// are combined at the end (below).
//
// What bounds it on an H100: at decode M is the number of serving slots
// (<= 8), so the work is ~2*M flops per weight byte -- far below the card's
// ridge point.  The kernel is bound by the bytes of mags (+ 1/m of that in
// signs) streamed from HBM, and on this card that means keeping enough loads
// in flight to cover HBM latency on all 132 SMs.  The design therefore:
//   * streams every weight byte once per tile of BM rows of x (BM = 4 at
//     decode, 8 above): M is never padded up to a big tile;
//   * splits K across blocks (KC = 256 rows each), so even a 1536 x 1536
//     matrix launches 288 blocks and an 8960-row one 1680: every SM has work,
//     three blocks to an SM;
//   * each thread issues all loads of its 8 rows (4 columns each: one 4-byte
//     load per row for uint8, 16 bytes for int32) at once, branch-free,
//     before it waits on anything; the block's slice of x is staged in
//     shared memory meanwhile;
//   * keeps the products in f32 on the CUDA cores (the contract is f32 math),
//     applies the fragment sign per row and the scale once per output;
//   * combines partial sums in a fixed order -- warp shuffles, then the warps
//     through shared memory, then the K slices: each slice writes its tile to
//     a workspace, and the last slice to finish (an atomic ticket per tile)
//     sums the slices in slice order.  The result is the same from run to
//     run, and the ticket counters return to zero for the next launch.
// Shapes that are not multiples of the vector widths take the same code with
// masked scalar loads (the ``Fast = false`` instantiation).
// wgmma and TMA are left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 32;             // output columns per block
constexpr int VEC = 4;             // columns per thread
constexpr int CG = BN / VEC;       // column groups per block (8)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KG = THREADS / CG;   // K groups per block (32)
constexpr int LANE_KG = 32 / CG;   // K groups within one warp (4)
constexpr int RPT = 8;             // K rows per thread
constexpr int KC = KG * RPT;       // K rows per block: one K slice (256)

template <typename MagT>
struct Raw;  // one row's VEC magnitude codes as loaded

template <>
struct Raw<uint8_t> {
  uchar4 v;
  __device__ __forceinline__ void load(const uint8_t* p) {
    v = __ldg(reinterpret_cast<const uchar4*>(p));
  }
  __device__ __forceinline__ float get(int q) const {
    return static_cast<float>(q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w);
  }
};

template <>
struct Raw<int32_t> {
  int4 v;
  __device__ __forceinline__ void load(const int32_t* p) {
    v = __ldg(reinterpret_cast<const int4*>(p));
  }
  __device__ __forceinline__ float get(int q) const {
    return static_cast<float>(q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w);
  }
};

__device__ __forceinline__ float sign_of(char4 s, int q) {
  return static_cast<float>(q == 0 ? s.x : q == 1 ? s.y : q == 2 ? s.z : s.w);
}

template <int BM, bool Fast, typename MagT>
// three blocks share an SM: at most 85 registers a thread
__global__ void __launch_bounds__(THREADS, 3)
polarized_matmul_kernel(const float* __restrict__ x, const MagT* __restrict__ mags,
                        const int8_t* __restrict__ signs, const float* __restrict__ scale,
                        float* __restrict__ y, float* __restrict__ work,
                        int* __restrict__ tickets, int M, int N, int K, int m) {
  __shared__ float xs[BM][KC];
  __shared__ __align__(16) float red[WARPS][BM][BN];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = lane % CG;
  const int kg = warp * LANE_KG + lane / CG;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int n0 = col0 + cg * VEC;
  const int kbeg = blockIdx.z * KC;
  const int kend = min(K, kbeg + KC);
  const int krow = kbeg + kg * RPT;     // this thread's first K row

  // 1. every load of this thread's rows, issued before anything waits
  Raw<MagT> mag[Fast ? RPT : 1];
  char4 sgn[Fast ? RPT : 1];
  float mag_s[Fast ? 1 : RPT][VEC];
  float sgn_s[Fast ? 1 : RPT][VEC];
  if constexpr (Fast) {
    // N % 4 == 0 and K % 8 == 0 here; rows past the slice and columns past N
    // are clamped to valid addresses and meet x == 0 or are never written
    const int nn = n0 < N ? n0 : 0;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int k = min(krow + j, K - 1);
      mag[j].load(mags + static_cast<size_t>(k) * N + nn);
      sgn[j] = __ldg(reinterpret_cast<const char4*>(signs + static_cast<size_t>(k / m) * N + nn));
    }
  } else {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int k = krow + j;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const bool in = k < kend && n0 + q < N;
        mag_s[j][q] = in ? static_cast<float>(__ldg(mags + static_cast<size_t>(k) * N + n0 + q)) : 0.f;
        sgn_s[j][q] = in ? static_cast<float>(__ldg(signs + static_cast<size_t>(k / m) * N + n0 + q)) : 0.f;
      }
    }
  }

  // 2. the block's slice of x into shared memory (zero past M and the slice)
  for (int i = tid; i < BM * KC; i += THREADS) {
    const int r = i / KC;
    const int kk = i % KC;
    const int gr = row0 + r;
    const int gk = kbeg + kk;
    xs[r][kk] = (gr < M && gk < kend) ? __ldg(x + static_cast<size_t>(gr) * K + gk) : 0.f;
  }
  __syncthreads();

  // 3. f32 products; rows past the slice meet x == 0 in xs and add nothing
  float acc[BM][VEC];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[r][q] = 0.f;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    float w[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      if constexpr (Fast) w[q] = mag[j].get(q) * sign_of(sgn[j], q);
      else w[q] = mag_s[j][q] * sgn_s[j][q];
    }
    const int kk = kg * RPT + j;
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const float xv = xs[r][kk];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[r][q] = fmaf(xv, w[q], acc[r][q]);
    }
  }

  // 4. sum the LANE_KG K groups of each warp, then the warps in warp order
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      float v = acc[r][q];
#pragma unroll
      for (int off = CG; off < 32; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][q] = v;
    }
  if (lane < CG) {
#pragma unroll
    for (int r = 0; r < BM; ++r)
      *reinterpret_cast<float4*>(&red[warp][r][cg * VEC]) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();

  const int slices = gridDim.z;
  const int r = tid / BN;
  const int c = tid % BN;
  const int gr = row0 + r;
  const int gc = col0 + c;
  const bool owner = tid < BM * BN && gr < M && gc < N;
  float tile = 0.f;  // this thread's output of the block's tile, one K slice
  if (tid < BM * BN) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) tile += red[w][r][c];
  }
  if (slices == 1) {
    if (owner) y[static_cast<size_t>(gr) * N + gc] = tile * scale[gc];
    return;
  }

  // 5. publish this slice's tile; the last slice of the tile to arrive sums
  // all slices in slice order
  if (owner) work[(static_cast<size_t>(blockIdx.z) * M + gr) * N + gc] = tile;
  __threadfence();
  __syncthreads();
  const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(tickets + tile_id, 1) == slices - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (owner) {
    float s = 0.f;
    for (int z = 0; z < slices; ++z)
      s += __ldcg(work + (static_cast<size_t>(z) * M + gr) * N + gc);
    y[static_cast<size_t>(gr) * N + gc] = s * scale[gc];
  }
  if (tid == 0) tickets[tile_id] = 0;  // ready for the next launch
}

static_assert(8 * BN <= THREADS, "the epilogue maps one output of a tile to each thread");

template <int BM, bool Fast, typename MagT>
void launch_tile(const void* x, const void* mags, const void* signs, const void* scale,
                 void* y, void* work, void* tickets, int M, int N, int K, int m,
                 cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, (K + KC - 1) / KC);
  polarized_matmul_kernel<BM, Fast, MagT><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const MagT*>(mags),
      static_cast<const int8_t*>(signs), static_cast<const float*>(scale),
      static_cast<float*>(y), static_cast<float*>(work), static_cast<int*>(tickets),
      M, N, K, m);
}

template <typename MagT>
int launch(const void* x, const void* mags, const void* signs, const void* scale, void* y,
           void* work, void* tickets, int M, int N, int K, int m, int fast,
           void* stream_ptr) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M <= 4) {
    if (fast) launch_tile<4, true, MagT>(x, mags, signs, scale, y, work, tickets, M, N, K, m, stream);
    else launch_tile<4, false, MagT>(x, mags, signs, scale, y, work, tickets, M, N, K, m, stream);
  } else {
    if (fast) launch_tile<8, true, MagT>(x, mags, signs, scale, y, work, tickets, M, N, K, m, stream);
    else launch_tile<8, false, MagT>(x, mags, signs, scale, y, work, tickets, M, N, K, m, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C entry points for ctypes.  Every pointer is a contiguous row-major
// device buffer.  With S = ceil(K / 256) K slices (forms_polarized_matmul_kc)
// and S > 1, ``work`` holds S * M * N floats of scratch and ``tickets`` at
// least ceil(N / 32) * ceil(M / BM) ints, all zero (BM = 4 for M <= 4, else
// 8); the kernel leaves them zero again.  Launches that may overlap (other
// streams) need tickets of their own, and after a failed launch the caller
// gives the next one fresh zeros.  ``fast`` may be 1 only when
// N % 4 == 0, K % 8 == 0, mags are aligned to 4 codes and signs to 4 bytes.
// Returns cudaGetLastError().
int forms_polarized_matmul_kc(void) { return KC; }

int forms_polarized_matmul_u8(const void* x, const void* mags, const void* signs,
                              const void* scale, void* y, void* work, void* tickets,
                              int M, int N, int K, int m, int fast, void* stream) {
  return launch<uint8_t>(x, mags, signs, scale, y, work, tickets, M, N, K, m, fast, stream);
}

int forms_polarized_matmul_i32(const void* x, const void* mags, const void* signs,
                               const void* scale, void* y, void* work, void* tickets,
                               int M, int N, int K, int m, int fast, void* stream) {
  return launch<int32_t>(x, mags, signs, scale, y, work, tickets, M, N, K, m, fast, stream);
}

}  // extern "C"
