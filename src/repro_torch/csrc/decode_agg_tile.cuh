// The reduce-before-expand body shared by the fused decode->aggregate
// kernel (fused_decode_agg.cu) and its grouped ragged form
// (grouped_decode_agg.cu). For one band of `rows` output rows and the
// output columns [n_begin, n_end):
//
//   1) hbar[bm, K] = sum_c w_c * h_c[band]   in shared memory, clients in
//      ascending order, one fmaf chain per element (rows past `rows` are
//      zero);
//   2) out[band, n] = hbar @ W[:, n] + b[n], one warp per RM rows and one
//      lane per column, k ascending, W read coalesced through L1.
//
// Both kernels call this one function, so every element of a bucket's
// grouped result is computed by the same chain of fmaf as the per-bucket
// kernel computes it: the two are bit-equal, whatever band height and
// column split each launch picks.
#pragma once

#include <cuda_runtime.h>

template <int RM>   // rows per warp; bm = 8 * RM with 256 threads
__device__ __forceinline__ void decode_agg_tile(
    const float* __restrict__ hb,    // the band's first row, client 0
    long long client_stride,         // floats from one client to the next
    const float* __restrict__ wts, int C, int rows, int K,
    const float* __restrict__ W, const float* __restrict__ b, int N,
    int n_begin, int n_end,
    float* __restrict__ out) {       // the band's first output row
  extern __shared__ float hbar[];    // (bm, K), dynamic shared memory
  constexpr int bm = 8 * RM;
  const int band = rows * K;

  // 1) weighted client reduce, clients in ascending order
  for (int i = threadIdx.x; i < bm * K; i += blockDim.x) {
    float a = 0.f;
    if (i < band) {
#pragma unroll 8
      for (int c = 0; c < C; ++c)
        a = fmaf(__ldg(wts + c), __ldg(hb + (long long)c * client_stride + i),
                 a);
    }
    hbar[i] = a;
  }
  __syncthreads();

  // 2) expand: out[rows, cols] = hbar @ W[:, cols] + b[cols]
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const float* hw = hbar + warp * RM * K;
  for (int nb0 = n_begin; nb0 < n_end; nb0 += 32) {
    const int n = nb0 + lane;
    const bool ok = n < n_end;
    float acc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r] = 0.f;
    auto step = [&](int k) {
      const float wv = ok ? __ldg(W + (long long)k * N + n) : 0.f;
#pragma unroll
      for (int r = 0; r < RM; ++r) acc[r] = fmaf(hw[r * K + k], wv, acc[r]);
    };
    if constexpr (RM == 1) {
      // 16 loads of W in flight a lane, as nvcc chose when this loop sat in
      // kernel 4 itself; inlined from here it chose 4, 14 % slower at
      // K = 512. For RM > 1 its choice did not change.
#pragma unroll 16
      for (int k = 0; k < K; ++k) step(k);
    } else {
      for (int k = 0; k < K; ++k) step(k);
    }
    if (ok) {
      const float bv = b[n];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int m = warp * RM + r;
        if (m < rows) out[(long long)m * N + n] = acc[r] + bv;
      }
    }
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory when a band
// needs it; returns a cudaError_t as int.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
