// Bit-serial FORMS crossbar simulator for Hopper (sm_90a):
//
//   acc[M, N] = sum_b sum_c sum_f sign[f, n] * min(P[b, c, f], adc_max) << (c*cell_bits + b)
//   P[b, c, f] = sum_{k in fragment f} bit_b(x[r, k]) * cells[c, k, n]
//   eic[M, K/m] = last live bit plane of each fragment's m inputs, + 1
//
// x int32 activation codes (bits below input_bits are streamed), cells uint8
// (C, K, N) planes of cell_bits-bit values, signs int8 (K/m, N); acc int32,
// wrapping as two's complement does; eic int32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitserial_crossbar.py::_kernel.
// The TPU kernel keeps all of K in VMEM per (row tile, column tile) and runs,
// for each input bit and cell plane, a batched thin (m-deep) f32 dot over the
// fragments, clips at the ADC ceiling, signs and shift-adds in int32.  Here:
//   * one block per (column tile of 32, row tile of 4, K range of 32
//     fragments); a lane owns one column, a warp every 8th fragment of the
//     range, and the block adds its sums into acc with integer atomics --
//     the sum is the same in any order, so the result is exact and the same
//     from run to run;
//   * the block first packs its inputs bit-serially: for each (row,
//     fragment) and input bit b, the m inputs' bit b as one m-bit mask in
//     shared memory (so m <= 32), and the fragment's EIC from the OR of its
//     masked codes (written by the column tile 0 blocks only, as the Pallas
//     kernel writes it at n-block 0);
//   * each lane packs its column's fragment the same way: weight bit q of
//     the m magnitude codes (cells re-assembled, cell c at bit c*cell_bits)
//     as one mask wm[q].  A fragment's analog column sum for input bit b and
//     cell c is then sum_t popc(X_b & wm[c*cell_bits + t]) << t: m MACs
//     in a few integer instructions, exact (at most m * (2^cell_bits - 1));
//   * the ADC clip is min(P, adc_max) on the unsigned sum, before the sign;
//   * the shift-add over 16 input bits and 4 cells overflows 32 bits at
//     full width (K = 8960 x (2^16 - 1) x 255 > 2^31).  XLA wraps; signed
//     overflow is undefined in C++, so everything is summed in uint32 and
//     the bits are read back as int32 by the caller: the reference's value;
//   * a fragment's input bit plane that is all zero is skipped (its sums
//     are 0): the zero-skip the EIC counts, here as work not done.
// Bound: bytes.  Even the M*K*N*input_bits*C bit-plane multiply-adds at the
// card's int8 tensor-core rate take less time than reading the C*K*N uint8
// cell planes once (at M = 4 about 0.004 ms against 0.017 ms for an
// 8960 x 1536 matrix), so the floor is the cells, x, signs and acc moved
// once.  This design does its multiply-adds on the CUDA cores (the popcount
// packing does m of them at once) and stays far above that floor; a
// tensor-core (mma.sync s8) design is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 32;          // output columns per block: one per lane
constexpr int FG = 8;           // fragment groups per block: one per warp
constexpr int THREADS = BN * FG;
constexpr int BM = 4;           // rows of x per block
constexpr int FPB = 32;         // fragments per block
constexpr int MAX_M = 32;       // a fragment's inputs fit one 32-bit mask
constexpr int MAX_WBITS = 16;   // weight bit planes: cells * cell_bits

static_assert(BM * FPB <= THREADS, "one thread packs each (row, fragment)");
static_assert(BM * BN <= THREADS, "one thread sums each output of the tile");

__global__ void __launch_bounds__(THREADS)
bitserial_crossbar_kernel(const int32_t* __restrict__ x, const uint8_t* __restrict__ cells,
                          const int8_t* __restrict__ signs, unsigned* __restrict__ acc,
                          int* __restrict__ eic, int M, int N, int K, int C, int m,
                          int input_bits, int cell_bits, unsigned adc_max) {
  __shared__ unsigned xm[BM][FPB][32];   // [row][fragment][input bit]: m-bit masks
  __shared__ unsigned red[FG][BM][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int F = K / m;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int f0 = blockIdx.z * FPB;
  const int nf = min(FPB, F - f0);
  const unsigned in_mask = input_bits >= 32 ? 0xffffffffu : (1u << input_bits) - 1u;

  // 1. the block's inputs, bit-serial: one m-bit mask per (row, fragment, bit)
  if (tid < BM * FPB) {
    const int r = tid / FPB;
    const int fl = tid % FPB;
    const int gr = row0 + r;
    const bool valid = gr < M && fl < nf;
    for (int b = 0; b < 32; ++b) xm[r][fl][b] = 0u;
    unsigned any = 0u;
    if (valid) {
      const int32_t* xr = x + static_cast<size_t>(gr) * K + static_cast<size_t>(f0 + fl) * m;
      for (int j = 0; j < m; ++j) {
        const unsigned v = static_cast<unsigned>(__ldg(xr + j)) & in_mask;
        any |= v;
        for (int b = 0; b < input_bits; ++b) xm[r][fl][b] |= ((v >> b) & 1u) << j;
      }
      if (blockIdx.x == 0)
        eic[static_cast<size_t>(gr) * F + f0 + fl] = any ? 32 - __clz(any) : 0;
    }
  }
  __syncthreads();

  // 2. this lane's column over the warp's fragments
  unsigned sum[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) sum[r] = 0u;
  const int n = col0 + lane;
  const int qb = C * cell_bits;
  if (n < N) {
    for (int fl = warp; fl < nf; fl += FG) {
      const int f = f0 + fl;
      const unsigned s = static_cast<unsigned>(static_cast<int>(__ldg(signs + static_cast<size_t>(f) * N + n)));
      unsigned wm[MAX_WBITS];
#pragma unroll
      for (int q = 0; q < MAX_WBITS; ++q) wm[q] = 0u;
      for (int j = 0; j < m; ++j) {
        const size_t k = static_cast<size_t>(f) * m + j;
        unsigned code = 0u;
        for (int c = 0; c < C; ++c)
          code |= static_cast<unsigned>(__ldg(cells + (static_cast<size_t>(c) * K + k) * N + n))
                  << (c * cell_bits);
#pragma unroll
        for (int q = 0; q < MAX_WBITS; ++q) wm[q] |= ((code >> q) & 1u) << j;
      }
#pragma unroll
      for (int r = 0; r < BM; ++r) {     // rows past M hold all-zero masks
        unsigned frag = 0u;
        for (int b = 0; b < input_bits; ++b) {
          const unsigned X = xm[r][fl][b];
          if (X == 0u) continue;         // a dead input bit plane of the fragment
          unsigned plane = 0u;
          unsigned part = 0u;
          int t = 0;
          int c = 0;
#pragma unroll
          for (int q = 0; q < MAX_WBITS; ++q) {
            if (q < qb) {
              part += static_cast<unsigned>(__popc(X & wm[q])) << t;
              if (++t == cell_bits) {    // cell c done: its ADC conversion
                plane += min(part, adc_max) << (c * cell_bits);
                part = 0u;
                t = 0;
                ++c;
              }
            }
          }
          frag += plane << b;
        }
        sum[r] += s * frag;              // the fragment's sign, mod 2^32
      }
    }
  }

  // 3. the warps' sums, then one atomic add per output of the tile
#pragma unroll
  for (int r = 0; r < BM; ++r) red[warp][r][lane] = sum[r];
  __syncthreads();
  if (tid < BM * BN) {
    const int r = tid / BN;
    const int c = tid % BN;
    const int gr = row0 + r;
    const int gc = col0 + c;
    if (gr < M && gc < N) {
      unsigned total = 0u;
#pragma unroll
      for (int w = 0; w < FG; ++w) total += red[w][r][c];
      atomicAdd(acc + static_cast<size_t>(gr) * N + gc, total);
    }
  }
}

}  // namespace

extern "C" {

// Plain C entry point for ctypes.  Every pointer is a contiguous row-major
// device buffer: x (M, K) int32, cells (C, K, N) uint8 holding cell_bits-bit
// values, signs (K/m, N) int8, acc (M, N) int32 set to zero by the caller,
// eic (M, K/m) int32.  Needs K % m == 0, 1 <= m <= 32, 1 <= input_bits <= 32,
// C * cell_bits <= 16 and N >= 1; adc_max = 2^adc_bits - 1, or 0xffffffff for
// an ideal ADC.  Returns cudaGetLastError().
int forms_bitserial_max_m(void) { return MAX_M; }

int forms_bitserial_crossbar(const void* x, const void* cells, const void* signs, void* acc,
                             void* eic, int M, int N, int K, int C, int m, int input_bits,
                             int cell_bits, unsigned adc_max, void* stream_ptr) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const int F = K / m;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, (F + FPB - 1) / FPB);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  bitserial_crossbar_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const int32_t*>(x), static_cast<const uint8_t*>(cells),
      static_cast<const int8_t*>(signs), static_cast<unsigned*>(acc), static_cast<int*>(eic),
      M, N, K, C, m, input_bits, cell_bits, adc_max);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
