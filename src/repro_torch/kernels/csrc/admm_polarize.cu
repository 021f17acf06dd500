// Fragment-polarization projection of the ADMM Z-update, for Hopper (sm_90a):
//
//   per (layer l, fragment f of m rows, column n):
//     s = +1 iff sum_i v[i] >= 0                          (rule "sum")
//     s = +1 iff sum_i max(v[i],0)^2 >= sum_i min(v[i],0)^2 (rule "energy")
//     out[i] = v[i] where v[i] * s >= 0, else 0;  signs[f, n] = s
//
// v, out (L, K, N) and signs (L, K/m, N) are float32 or bfloat16 (all three
// in one type, the signs as +-1.0), row-major, K a multiple of m.
//
// Replaces the Pallas TPU kernel src/repro/kernels/admm_polarize.py::_kernel.
// The TPU kernel takes (bk, bn) tiles of one 2-D matrix into VMEM, reduces
// each fragment's m rows, selects and writes the tile and its sign tile; the
// reference vmaps it over the layers of a stacked leaf.  Here:
//   * one thread per (layer, fragment, column): neighbouring threads take
//     neighbouring columns, so each of the m row reads of a warp is one
//     coalesced 128-byte (f32) line; the grid's y axis is the layer, so one
//     launch projects a whole stacked (L, K, N) leaf;
//   * the m values are added in row order with __fadd_rn / __fmul_rn: nvcc
//     would contract a*a + acc into an FMA, which rounds once where the
//     plain version rounds twice, and a fragment summing to about zero could
//     then elect the other sign.  The comparisons are the reference's as it
//     writes them: a NaN compares false (elects -1 and is zeroed), a sum of
//     0 or -0.0 elects +1, an entry of -0.0 is kept;
//   * for m = 4, 8 and 16 the fragment stays in registers between the
//     election and the write; other m read it again (from L1);
//   * bf16 travels as its 16 bits: widened exactly for the sums, and the
//     output is the input's own bits or 0, so nothing is rounded;
//   * offsets are 64-bit: one qwen2-1.5b MLP leaf holds 28 x 1536 x 8960 =
//     385 M elements.
// Bound: bytes.  Each element is read once and written once, plus one sign
// per m elements (at m = 8, f32: 8.5 bytes per element), for at most three
// additions and two multiplies per element: far below the card's rate of
// operations per byte.  Every load and store of the design is coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct F32 {
  typedef float T;
  static __device__ __forceinline__ float wide(T x) { return x; }
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T sign(bool up) { return up ? 1.0f : -1.0f; }
};

struct BF16 {                 // bfloat16 as its bits
  typedef uint16_t T;
  static __device__ __forceinline__ float wide(T x) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  }
  static __device__ __forceinline__ T zero() { return 0; }
  static __device__ __forceinline__ T sign(bool up) { return up ? 0x3F80 : 0xBF80; }
};

// rule: 0 = sum, 1 = energy; M > 0 fixes m at compile time, M == 0 reads m
template <class D, int RULE, int M>
__global__ void __launch_bounds__(THREADS)
admm_polarize_kernel(const typename D::T* __restrict__ v, typename D::T* __restrict__ out,
                     typename D::T* __restrict__ signs, int K, int N, int m, int col_blocks) {
  typedef typename D::T T;
  const int f = blockIdx.x / col_blocks;
  const int n = (blockIdx.x - f * col_blocks) * THREADS + threadIdx.x;
  if (n >= N) return;
  if (M > 0) m = M;
  const int64_t layer = blockIdx.y;
  const int64_t base = (layer * K + static_cast<int64_t>(f) * m) * N + n;

  T held[M > 0 ? M : 1];
  float acc = 0.0f, neg = 0.0f;
#pragma unroll
  for (int i = 0; i < (M > 0 ? M : m); ++i) {
    const T raw = __ldg(v + base + static_cast<int64_t>(i) * N);
    if (M > 0) held[i] = raw;
    const float x = D::wide(raw);
    if (RULE == 0) {
      acc = __fadd_rn(acc, x);
    } else {
      const float p = x < 0.0f ? 0.0f : x;     // max(x, 0): NaN stays NaN
      const float q = x > 0.0f ? 0.0f : x;     // min(x, 0)
      acc = __fadd_rn(acc, __fmul_rn(p, p));
      neg = __fadd_rn(neg, __fmul_rn(q, q));
    }
  }
  const bool up = RULE == 0 ? acc >= 0.0f : acc >= neg;
  const float s = up ? 1.0f : -1.0f;
#pragma unroll
  for (int i = 0; i < (M > 0 ? M : m); ++i) {
    const int64_t at = base + static_cast<int64_t>(i) * N;
    const T raw = M > 0 ? held[i] : __ldg(v + at);
    out[at] = __fmul_rn(D::wide(raw), s) >= 0.0f ? raw : D::zero();
  }
  const int64_t F = K / m;
  signs[(layer * F + f) * N + n] = D::sign(up);
}

template <class D>
using Kernel = void (*)(const typename D::T*, typename D::T*, typename D::T*, int, int, int, int);

template <class D, int RULE>
Kernel<D> pick_m(int m) {
  switch (m) {
    case 4: return admm_polarize_kernel<D, RULE, 4>;
    case 8: return admm_polarize_kernel<D, RULE, 8>;
    case 16: return admm_polarize_kernel<D, RULE, 16>;
    default: return admm_polarize_kernel<D, RULE, 0>;
  }
}

template <class D>
int launch(const void* v, void* out, void* signs, int L, int K, int N, int m, int rule,
           cudaStream_t stream) {
  typedef typename D::T T;
  const Kernel<D> kernel = rule == 0 ? pick_m<D, 0>(m) : pick_m<D, 1>(m);
  const int col_blocks = (N + THREADS - 1) / THREADS;
  dim3 grid(static_cast<unsigned>(col_blocks) * static_cast<unsigned>(K / m),
            static_cast<unsigned>(L));
  kernel<<<grid, THREADS, 0, stream>>>(static_cast<const T*>(v), static_cast<T*>(out), static_cast<T*>(signs), K, N, m, col_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// v, out (L, K, N); signs (L, K/m, N); dtype 0 = float32, 1 = bfloat16;
// rule 0 = sum, 1 = energy.  Returns the launch's CUDA error code (0 = ok).
// The wrapper checks K % m == 0, the sizes and the grid limits.
int forms_admm_polarize(const void* v, void* out, void* signs, int L, int K, int N, int m,
                        int rule, int dtype, cudaStream_t stream) {
  if (L == 0 || K == 0 || N == 0) return 0;
  return dtype == 0 ? launch<F32>(v, out, signs, L, K, N, m, rule, stream)
                    : launch<BF16>(v, out, signs, L, K, N, m, rule, stream);
}

int forms_admm_polarize_threads() { return THREADS; }

}  // extern "C"
