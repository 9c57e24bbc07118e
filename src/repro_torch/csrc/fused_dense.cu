// Fused dense layer act(x @ w + b) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _fused_dense_kernel (fused_dense) of
// src/repro/kernels/fused_dense.py: x (M, K), w (K, N), b (N,) -> (M, N) in
// x's type (float32 or bfloat16), float32 accumulation, act in
// {relu, tanh, sigmoid, linear} applied in the epilogue. The wrapper
// (kernels/fused_dense.py) picks one of two routes from M alone.
//
// Tiled route, M > 16. On the chunked-AE path at cohort scale the shapes
// are tall and narrow (M = clients x chunks, K <= 4096, N = 8..512), e.g.
// the decode's first layer (2^20, 8) @ (8, 32): 2*M*K*N = 0.5 GFLOP against
// 4*M*(K+N) = 168 MB, about 3 operations per byte, so bytes bind there; the
// encode's wide layer (n, 4096) @ (4096, 512) does ~250 operations per
// byte of x and would be bound by float32 FMA throughput. This route is
// the classic shared-memory tiled SGEMM: 64x64 output tiles, 16-deep K
// slabs staged in shared memory (converted to float on load), 256 threads
// each holding a 4x4 register accumulator with float32 FMA, bias and
// activation fused in the epilogue so each output is written once. No
// tensor cores and no TF32, so float32 results agree with a float32
// reference at 1e-5; the TMA/wgmma version and narrower tiles for N <= 32
// are later work.
//
// Split-K route, M <= 16: one client's encode and EF decode (M = its 4
// chunks), e.g. (4, 4096) @ (4096, 512), where the tiled route ran 8 blocks
// on 132 SMs, each walking K serially, with 60 of its 64 rows padding.
// There w is all the traffic (8.4 MB against 64 KB of x), so bytes bind:
// the work is a GEMV-like stream of w. A block owns a K slab of w and
// column tiles of it, holds the slab's M rows of x in shared memory as
// float, and streams w with 16-byte vector loads (float4 or 8 bf16), the
// loads of up to eight rows a thread issued before x is staged; every
// thread keeps its M x (4 or 8) partial sums in float32 registers. Lanes
// that share columns sum in a fixed shuffle tree, the 8 warps in warp
// order through shared memory.
// fused_dense.py::splitk_plan sizes the launch: a wide layer whose K fits
// one slab takes narrower tiles (to 64 bytes of a row) and no split;
// otherwise, where the tiles give fewer than 132 blocks, K is cut into
// slabs for about 2 blocks an SM of >= 16 KB of w each. Each slab writes
// float32 partials to a workspace (S, M, N); a second kernel sums them in
// slab order (8 lanes an output, each over a run of consecutive slabs,
// then the runs in order), adds the bias, applies the activation and
// casts, so the result is the same from run to run (no atomics). A single
// slab writes the output itself. N % VEC != 0, or w not 16-byte aligned,
// takes scalar loads in the same kernel (a template branch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

// ------------------------------------------------------------- split-K
constexpr int SK_THREADS = 256, SK_WARPS = SK_THREADS / 32, SK_UNROLL = 8;
constexpr int SK_MAX_ROWS = 512;   // rows of w (and x) a slab
constexpr int SK_GROUP = 8;        // finisher lanes an output

// VEC columns of one row of w, [n, n + VEC): load() issues one 16-byte
// load when ALIGNED, else one bounds-checked load a column (zeros past
// N); unpack() gives them as float.
template <typename T, bool ALIGNED> struct WRow;
template <> struct WRow<float, true> {
  static constexpr int VEC = 4;
  using Raw = float4;
  __device__ __forceinline__ static void load(const float* w, long long i,
                                              int, int, Raw& r) {
    r = __ldg(reinterpret_cast<const float4*>(w + i));
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float (&v)[4]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
};
template <> struct WRow<__nv_bfloat16, true> {
  static constexpr int VEC = 8;
  using Raw = uint4;
  __device__ __forceinline__ static void load(const __nv_bfloat16* w,
                                              long long i, int, int, Raw& r) {
    r = __ldg(reinterpret_cast<const uint4*>(w + i));
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
};
template <typename T> struct WRow<T, false> {
  static constexpr int VEC = 16 / sizeof(T);
  struct Raw { float v[VEC]; };
  __device__ __forceinline__ static void load(const T* w, long long i, int n,
                                              int N, Raw& r) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) r.v[j] = n + j < N ? to_f(w[i + j]) : 0.f;
  }
  __device__ __forceinline__ static void unpack(const Raw& r,
                                                float (&v)[VEC]) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = r.v[j];
  }
};

// Dynamic shared memory (floats) of a block: the x slab [rows][MT], later
// reused for the warps' sums [SK_WARPS][M][tpr * VEC].
template <typename T>
size_t splitk_smem_floats(int rows, int MT, int M, int tpr) {
  const size_t red = (size_t)SK_WARPS * M * tpr * (16 / sizeof(T));
  const size_t xs = (size_t)rows * MT;
  return red > xs ? red : xs;
}

// Block (split s, column tile t): rows [s * rows, min(K, (s + 1) * rows))
// of w, columns [t * tpr * VEC, (t + 1) * tpr * VEC). Lane = sub * tpr +
// tx: tx picks the column vector, sub one of 32 / tpr rows a warp reads at
// once; a thread has up to SK_UNROLL rows' loads in flight. Writes
// ws[s][m][n] (float32), or y itself when `final` (one slab).
template <typename T, int MT, bool ALIGNED>
__global__ void __launch_bounds__(SK_THREADS)
splitk_partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ ws, int M, int K, int N, int rows,
                      int tpr, int act, bool final) {
  using R = WRow<T, ALIGNED>;
  constexpr int VEC = R::VEC;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, wid = tid / 32, lane = tid % 32;
  const int tx = lane % tpr, sub = lane / tpr, rw = 32 / tpr;
  const int k0 = blockIdx.x * rows;
  const int nrows = max(0, min(K, k0 + rows) - k0);
  const int cols = tpr * VEC, n0 = blockIdx.y * cols, n = n0 + tx * VEC;

  // the first rows' loads of w go out before x is staged
  const int step = SK_WARPS * rw;
  int r0 = wid * rw + sub;
  typename R::Raw raw[SK_UNROLL];
  auto load_rows = [&](int r) {
#pragma unroll
    for (int u = 0; u < SK_UNROLL; ++u)
      if (n < N && r + u * step < nrows)
        R::load(w, (long long)(k0 + r + u * step) * N + n, n, N, raw[u]);
  };
  load_rows(r0);
  // this thread's output column in the block's sum (cols divides 256)
  const int t = tid % cols;
  const float bias = final && n0 + t < N ? to_f(b[n0 + t]) : 0.f;
#pragma unroll 4
  for (int e = tid; e < M * nrows; e += SK_THREADS) {
    const int m = e / nrows, r = e % nrows;      // x rows read along K
    sm[r * MT + m] = to_f(x[(long long)m * K + k0 + r]);
  }
  if (M < MT)                                    // rows of the MT padding
    for (int e = tid; e < (MT - M) * nrows; e += SK_THREADS)
      sm[(e % nrows) * MT + M + e / nrows] = 0.f;
  __syncthreads();

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[m][j] = 0.f;

  if (n < N) {
    while (r0 < nrows) {
#pragma unroll
      for (int u = 0; u < SK_UNROLL; ++u) {
        if (r0 + u * step >= nrows) break;
        float v[VEC];
        R::unpack(raw[u], v);
        const float* xr = sm + (r0 + u * step) * MT;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xm = xr[m];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[m][j] = fmaf(xm, v[j], acc[m][j]);
        }
      }
      r0 += SK_UNROLL * step;
      load_rows(r0);
    }
  }
  // lanes of one column vector: a fixed xor tree, the same sum on each
  for (int off = tpr; off < 32; off *= 2)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);

  // the 8 warps' sums, added in warp order
  __syncthreads();                               // the x slab is read
  if (sub == 0)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= M) break;
      float4* dst = reinterpret_cast<float4*>(sm + (wid * M + m) * cols +
                                              tx * VEC);
#pragma unroll
      for (int j = 0; j < VEC / 4; ++j)
        dst[j] = make_float4(acc[m][4 * j], acc[m][4 * j + 1],
                             acc[m][4 * j + 2], acc[m][4 * j + 3]);
    }
  __syncthreads();
  if (n0 + t < N)
#pragma unroll 4
    for (int m = tid / cols; m < M; m += SK_THREADS / cols) {
      float sum = sm[m * cols + t];
#pragma unroll
      for (int q = 1; q < SK_WARPS; ++q) sum += sm[(q * M + m) * cols + t];
      const long long o = (long long)m * N + n0 + t;
      if (final)
        y[o] = from_f<T>(apply_act(sum + bias, act));
      else
        ws[(long long)blockIdx.x * M * N + o] = sum;
    }
}

// y[m][n] = act(sum over slabs of ws[s][m][n] + b[n]). SK_GROUP lanes an
// output: lane g sums slabs [g * per, (g + 1) * per) in order, then the
// group's sums are added in lane order, so the order is fixed.
template <typename T>
__global__ void __launch_bounds__(256)
splitk_finish_kernel(const float* __restrict__ ws, const T* __restrict__ b,
                     T* __restrict__ y, int M, int N, int S, int act) {
  const long long MN = (long long)M * N;
  const long long t = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long i = t / SK_GROUP;
  const int g = (int)(t % SK_GROUP);
  const int per = (S + SK_GROUP - 1) / SK_GROUP;
  const float bias = g == 0 && i < MN ? to_f(b[i % N]) : 0.f;
  float part = 0.f;
  if (i < MN) {
    const int s1 = min(S, (g + 1) * per);
#pragma unroll 8
    for (int s = g * per; s < s1; ++s) part += ws[s * MN + i];
  }
  const int lead = threadIdx.x & ~(SK_GROUP - 1);
  float sum = 0.f;
#pragma unroll
  for (int q = 0; q < SK_GROUP; ++q)
    sum += __shfl_sync(0xffffffffu, part, lead + q);
  if (g == 0 && i < MN) y[i] = from_f<T>(apply_act(sum + bias, act));
}

template <typename T, int MT, bool ALIGNED>
int launch_partial(dim3 grid, size_t smem, cudaStream_t stream, const T* x,
                   const T* w, const T* b, T* y, float* ws, int M, int K,
                   int N, int rows, int tpr, int act, bool final) {
  static bool attr_set = false;      // above 48 KB needs the opt-in
  if (!attr_set) {
    const int most = (int)(splitk_smem_floats<T>(SK_MAX_ROWS, MT, MT, 32) *
                           sizeof(float));
    const cudaError_t err = cudaFuncSetAttribute(
        splitk_partial_kernel<T, MT, ALIGNED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  splitk_partial_kernel<T, MT, ALIGNED><<<grid, SK_THREADS, smem, stream>>>(
      x, w, b, y, ws, M, K, N, rows, tpr, act, final);
  return (int)cudaGetLastError();
}

template <typename T, int MT>
int launch_splitk_mt(const T* x, const T* w, const T* b, T* y, float* ws,
                     int M, int K, int N, int act, int rows, int tpr,
                     cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int S = K > 0 ? (K + rows - 1) / rows : 1;
  const int ncv = (N + VEC - 1) / VEC;
  dim3 grid((unsigned)S, (unsigned)((ncv + tpr - 1) / tpr));
  const size_t smem = splitk_smem_floats<T>(rows, MT, M, tpr) * sizeof(float);
  const bool final = S == 1;
  if (!final && ws == nullptr) return (int)cudaErrorInvalidValue;
  const bool aligned = N % VEC == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int err =
      aligned ? launch_partial<T, MT, true>(grid, smem, stream, x, w, b, y,
                                            ws, M, K, N, rows, tpr, act,
                                            final)
              : launch_partial<T, MT, false>(grid, smem, stream, x, w, b, y,
                                             ws, M, K, N, rows, tpr, act,
                                             final);
  if (err != 0 || final) return err;
  const long long threads = (long long)M * N * SK_GROUP;
  splitk_finish_kernel<T><<<(unsigned)((threads + 255) / 256), 256, 0,
                            stream>>>(ws, b, y, M, N, S, act);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_splitk(const void* x, const void* w, const void* b, void* y,
                  void* ws, int M, int K, int N, int act, int rows, int tpr,
                  cudaStream_t s) {
  // M rounded up to a compiled row count MT (the x slab's row stride)
  auto go = [&](auto mt) {
    return launch_splitk_mt<T, decltype(mt)::value>(
        (const T*)x, (const T*)w, (const T*)b, (T*)y, (float*)ws, M, K, N,
        act, rows, tpr, s);
  };
  if (M <= 1) return go(std::integral_constant<int, 1>());
  if (M <= 2) return go(std::integral_constant<int, 2>());
  if (M <= 4) return go(std::integral_constant<int, 4>());
  if (M <= 8) return go(std::integral_constant<int, 8>());
  if (M <= 12) return go(std::integral_constant<int, 12>());
  return go(std::integral_constant<int, 16>());
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

// Split-K route for 1 <= M <= 16. rows: K rows of w a slab (<= 512); tpr:
// threads a column vector row (a power of two <= 32); ws: float32
// (ceil(K / rows), M, N), unused (may be null) when one slab covers K.
extern "C" int repro_fused_dense_splitk(const void* x, const void* w,
                                        const void* b, void* y, void* ws,
                                        int M, int K, int N, int act,
                                        int dtype, int rows, int tpr,
                                        void* stream) {
  if (M < 1 || M > 16 || rows < 1 || rows > SK_MAX_ROWS || tpr < 1 ||
      tpr > 32 || (tpr & (tpr - 1)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_splitk<float>(x, w, b, y, ws, M, K, N, act, rows, tpr, s);
  if (dtype == 1)
    return launch_splitk<__nv_bfloat16>(x, w, b, y, ws, M, K, N, act, rows,
                                        tpr, s);
  return (int)cudaErrorInvalidValue;
}
