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
// block loops over all C clients itself. Two routes, picked by the wrapper
// from (M, K) (kernels/fused_decode_agg.py::kernel_route); their bodies
// live in decode_agg_tile.cuh, shared with the grouped kernel:
//
// * few_rows (M <= 16, K <= 512): bound by the bytes of W. At the slice
//   shape (C = 3, M = 4, K = 512, N = 4096) the kernel must read W once
//   (8.4 MB, 2.5 us at 3.35 TB/s) against 24 KB of h. One block a column
//   tile of W (4 * tpr columns, all K rows), the whole tile copied into
//   shared memory with cp.async while the block reduces its own copy of
//   hbar from h (L2-resident);
//   tpr from kernels/fused_decode_agg.py::few_rows_plan (tiles narrowed to
//   about one block an SM: every block repeats the hbar reduce).
// * bands (every other M): bound by the bytes of h. At the cohort scale
//   of the fl_decode_agg table (C = 256, M = 4096 chunks, K = 32, N = 256)
//   the kernel must read h once (128 MB) and write out once (4 MB), ~40 us
//   at 3.35 TB/s, while its 2*C*M*K + 2*M*K*N = 0.13 GFLOP are ~2 us of
//   float32 FMA. One block a band of bm rows (and a column split where the
//   bands alone give too few blocks), the clients split into groups with 8
//   float4 loads of h in flight a thread.
#include <cuda_runtime.h>

#include "decode_agg_tile.cuh"

using namespace decode_agg;

namespace {

template <int MT>
__global__ void __launch_bounds__(kThreads, rows_min_blocks<MT>())
fused_decode_agg_rows_kernel(const float* __restrict__ h,
                             const float* __restrict__ wts,
                             const float* __restrict__ W,
                             const float* __restrict__ b,
                             float* __restrict__ out, int C, int M, int K,
                             int N, int tpr) {
  extern __shared__ float4 smem4[];
  decode_agg_rows<MT>(h, (long long)M * K, wts, C, M, K, W, b, N, tpr,
                      blockIdx.x, out, reinterpret_cast<float*>(smem4));
}

__global__ void __launch_bounds__(kThreads)
fused_decode_agg_band_kernel(const float* __restrict__ h,
                             const float* __restrict__ wts,
                             const float* __restrict__ W,
                             const float* __restrict__ b,
                             float* __restrict__ out, int C, int M, int K,
                             int N, int bm, int cols_per_split) {
  extern __shared__ float4 smem4[];
  const long long m0 = (long long)blockIdx.x * bm;
  const int rows = (int)((M - m0) < bm ? (M - m0) : bm);
  const int n_begin = blockIdx.y * cols_per_split;
  const int n_end = min(N, n_begin + cols_per_split);
  decode_agg_band(h + m0 * K, (long long)M * K, wts, C, rows, bm, K, W, b,
                  N, n_begin, n_end, out + m0 * N,
                  reinterpret_cast<float*>(smem4));
}

template <int MT>
int launch_rows(const float* h, const float* wts, const float* W,
                const float* b, float* out, int C, int M, int K, int N,
                int tpr, cudaStream_t stream) {
  const size_t smem = (size_t)rows_smem_floats(K, MT, tpr) * sizeof(float);
  if (int e = allow_smem(fused_decode_agg_rows_kernel<MT>, smem)) return e;
  const int tiles = ((N + 3) / 4 + tpr - 1) / tpr;
  fused_decode_agg_rows_kernel<MT><<<tiles, kThreads, smem, stream>>>(
      h, wts, W, b, out, C, M, K, N, tpr);
  return (int)cudaGetLastError();
}

}  // namespace

// few_rows route: 1 <= M <= 16, K <= 512; tpr (threads a 16-byte column
// vector of W) a power of two <= 16.
extern "C" int repro_fused_decode_agg_rows(const float* h, const float* wts,
                                           const float* W, const float* b,
                                           float* out, int C, int M, int K,
                                           int N, int tpr, void* stream) {
  if (M < 1 || M > 16 || K > kRowsMaxK || tpr < 1 || tpr > kRowsMaxTpr ||
      (tpr & (tpr - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 4) return launch_rows<4>(h, wts, W, b, out, C, M, K, N, tpr, s);
  if (M <= 8) return launch_rows<8>(h, wts, W, b, out, C, M, K, N, tpr, s);
  return launch_rows<16>(h, wts, W, b, out, C, M, K, N, tpr, s);
}

// bands route: bm in {8, 16, 32, 64}; cols_per_split > 0.
extern "C" int repro_fused_decode_agg(const float* h, const float* wts,
                                      const float* W, const float* b,
                                      float* out, int C, int M, int K, int N,
                                      int bm, int cols_per_split,
                                      void* stream) {
  if (bm < 8 || bm > 64 || bm % 8 || cols_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)band_smem_floats(bm, K) * sizeof(float);
  if (int e = allow_smem(fused_decode_agg_band_kernel, smem)) return e;
  dim3 grid((unsigned)((M + bm - 1) / bm),
            (unsigned)((N + cols_per_split - 1) / cols_per_split));
  fused_decode_agg_band_kernel<<<grid, kThreads, smem,
                                 (cudaStream_t)stream>>>(
      h, wts, W, b, out, C, M, K, N, bm, cols_per_split);
  return (int)cudaGetLastError();
}
