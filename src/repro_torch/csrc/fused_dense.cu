// Fused dense layer act(x @ w + b) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _fused_dense_kernel (fused_dense) of
// src/repro/kernels/fused_dense.py: x (M, K), w (K, N), b (N,) -> (M, N) in
// x's type (float32 or bfloat16), float32 accumulation, act in
// {relu, tanh, sigmoid, linear} applied in the epilogue.
//
// Bound on the card: on the chunked-AE path the shapes are tall and narrow
// (M = clients x chunks, K <= 4096, N = 8..512), e.g. the decode's first
// layer (2^20, 8) @ (8, 32): 2*M*K*N = 0.5 GFLOP against 4*M*(K+N) = 168 MB,
// about 3 operations per byte, so bytes bind there; the encode's wide layer
// (n, 4096) @ (4096, 512) does ~250 operations per byte of x and would be
// bound by float32 FMA throughput. This first version is the classic
// shared-memory tiled SGEMM: 64x64 output tiles, 16-deep K slabs staged in
// shared memory (converted to float on load), 256 threads each holding a
// 4x4 register accumulator with float32 FMA, bias and activation fused in
// the epilogue so each output is written once. No tensor cores and no
// TF32, so float32 results agree with a float32 reference at 1e-5; the
// TMA/wgmma version and narrower tiles for N <= 32 are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;  // 16 x 16 threads

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);                   // round to nearest even
}

__device__ __forceinline__ float apply_act(float y, int act) {
  switch (act) {
    case 0: return fmaxf(y, 0.f);                // relu
    case 1: return tanhf(y);                     // tanh
    case 2: return 1.f / (1.f + expf(-y));       // sigmoid
    default: return y;                           // linear
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
fused_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ b, T* __restrict__ y, long long M,
                   int K, int N, int act) {
  __shared__ float As[BK][BM + 1];   // x tile, k-major; +1 avoids conflicts
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += 256) {
      const int r = i / BK, c = i % BK;
      const long long gm = m0 + r;
      const int gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f(x[gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += 256) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? to_f(w[(long long)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bb[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N)
        y[gm * N + gn] = from_f<T>(apply_act(acc[i][j] + to_f(b[gn]), act));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, long long M,
           int K, int N, int act, cudaStream_t stream) {
  const long long gx = (M + BM - 1) / BM;
  dim3 grid((unsigned)gx, (unsigned)((N + BN - 1) / BN));
  fused_dense_kernel<T><<<grid, 256, 0, stream>>>(
      (const T*)x, (const T*)w, (const T*)b, (T*)y, M, K, N, act);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: 0 relu, 1 tanh, 2 sigmoid, 3 linear.
extern "C" int repro_fused_dense(const void* x, const void* w, const void* b,
                                 void* y, long long M, int K, int N, int act,
                                 int dtype, void* stream) {
  if (dtype == 0)
    return launch<float>(x, w, b, y, M, K, N, act, (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, b, y, M, K, N, act,
                                 (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
