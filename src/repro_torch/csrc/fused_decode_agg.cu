// Fused decode->aggregate epilogue for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _fused_decode_agg_kernel
// (fused_decode_agg) of src/repro/kernels/fused_decode_agg.py:
//   out (M, N) = sum_c w_c * (h_c @ W_last) + b_last      (sum_c w_c = 1)
// with h (C, M, K) the cohort's penultimate decoder activations. Because
// the last decoder layer is linear and shared, the weighted client reduce
// commutes with the product and happens first, latent-side: no per-client
// (M, N) tensor exists, in device memory or anywhere else, and the bias is
// added once.
//
// The TPU kernel carries the sum across a sequential client-block grid axis
// (pl.when(cb == 0) / (cb > 0)). Hopper has no sequential grid, so each
// block loops over all C clients itself: it reduces
//   hbar[bm, K] = sum_c w_c * h_c[rows]
// into shared memory (bm*K floats; bm = 8..64 rows, up to 227 KB), then
// expands hbar @ W_last + b for its output columns, one warp per bm/8 rows
// and one lane per column, W read coalesced through L1. That body is
// decode_agg_tile (decode_agg_tile.cuh), shared with the grouped kernel.
//
// Bound on the card: bytes. At the cohort scale of the fl_decode_agg table
// (C = 256, M = 4096 chunks, K = 32, N = 256) the kernel must read h once
// (128 MB) and write out once (4 MB), ~40 us at 3.35 TB/s, while its
// 2*C*M*K + 2*M*K*N = 0.1 GFLOP is ~2 us of float32 FMA. The wrapper picks
// bm so that the row bands alone give at least two blocks per SM, so h is
// read once. When M is too small for that, the grid also splits N and
// every column split repeats its band's client reduce (extra reads of h,
// L2-resident at those sizes); removing that repeat (a cluster sharing
// hbar through distributed shared memory, or a two-pass reduce) is later
// work.
#include <cuda_runtime.h>

#include "decode_agg_tile.cuh"

namespace {

template <int RM>   // rows per warp; bm = 8 * RM
__global__ void __launch_bounds__(256)
fused_decode_agg_kernel(const float* __restrict__ h,
                        const float* __restrict__ wts,
                        const float* __restrict__ W,
                        const float* __restrict__ b, float* __restrict__ out,
                        int C, int M, int K, int N, int cols_per_split) {
  constexpr int bm = 8 * RM;
  const long long m0 = (long long)blockIdx.x * bm;
  const int rows = (int)((M - m0) < bm ? (M - m0) : bm);
  const int n_begin = blockIdx.y * cols_per_split;
  const int n_end = min(N, n_begin + cols_per_split);
  decode_agg_tile<RM>(h + m0 * K, (long long)M * K, wts, C, rows, K, W, b,
                      N, n_begin, n_end, out + m0 * N);
}

template <int RM>
int launch(const float* h, const float* wts, const float* W, const float* b,
           float* out, int C, int M, int K, int N, int cols_per_split,
           cudaStream_t stream) {
  constexpr int bm = 8 * RM;
  const size_t smem = (size_t)bm * K * sizeof(float);
  if (int e = allow_smem(fused_decode_agg_kernel<RM>, smem)) return e;
  dim3 grid((unsigned)((M + bm - 1) / bm),
            (unsigned)((N + cols_per_split - 1) / cols_per_split));
  fused_decode_agg_kernel<RM><<<grid, 256, smem, stream>>>(
      h, wts, W, b, out, C, M, K, N, cols_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// bm in {8, 16, 32, 64}; cols_per_split a multiple of 32.
extern "C" int repro_fused_decode_agg(const float* h, const float* wts,
                                      const float* W, const float* b,
                                      float* out, int C, int M, int K, int N,
                                      int bm, int cols_per_split,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (bm) {
    case 8: return launch<1>(h, wts, W, b, out, C, M, K, N, cols_per_split, s);
    case 16: return launch<2>(h, wts, W, b, out, C, M, K, N, cols_per_split, s);
    case 32: return launch<4>(h, wts, W, b, out, C, M, K, N, cols_per_split, s);
    case 64: return launch<8>(h, wts, W, b, out, C, M, K, N, cols_per_split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
