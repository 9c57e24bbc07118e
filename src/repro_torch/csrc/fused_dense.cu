// Fused dense layer act(x @ w + b) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _fused_dense_kernel (fused_dense) of
// src/repro/kernels/fused_dense.py: x (M, K), w (K, N), b (N,) -> (M, N) in
// x's type (float32 or bfloat16), float32 accumulation, act in
// {relu, tanh, sigmoid, linear} applied in float32 in the epilogue, one
// rounding to x's type. The wrapper (kernels/fused_dense.py::kernel_route)
// picks one of four routes from (M, K, N, dtype); every route adds in a
// fixed order (no atomics), so a call gives the same bits every time.
//
// On the chunked-AE path at cohort scale (chunk 256, hidden 32, latent 8,
// a 2^20-value update) the layers are tall and narrow: each client's
// encode (4096, 256) @ (256, 32) then (4096, 32) @ (32, 8), its EF decode
// (4096, 8) @ (8, 32) then (4096, 32) @ (32, 256), and the server's hidden
// layer over the cohort (C * 4096, 8) @ (8, 32). A row costs 2KN
// operations against 4 (K + N) bytes, so at K <= 32 bytes bind: (2^20, 8)
// @ (8, 32) moves 168 MB for 0.5 GFLOP.
//
// narrow, K <= 32 (bytes-bound; at M <= 16 as well, where it beat
// split-K on the card). Each block stages w's
// column tile (at most 32 x 256 floats, 32 KB) and its bias once, w by
// 16-byte copies all in flight at once, then walks row tiles (a
// persistent grid sized by the occupancy), so w is read from device
// memory about once a block, not once a tile. Row tiles of x come in by
// 16-byte cp.async, a ring of kNarrowStages tiles in flight. Each thread
// owns RM rows x VEC columns (VEC = one 16-byte store: 4 floats or 8
// bf16): a float4 of x a row feeds 4 k steps, each float4 of w from
// shared memory feeds RM rows' FMAs, and the outputs leave as coalesced
// 16-byte stores. RM (narrow_rows) is 4 on wide tiles, where the reads of
// w from shared memory would otherwise bind, and on narrow ones the most
// that still gives two row tiles an SM. One fmaf chain an output, k
// ascending from 0, then the bias.
//
// mma, M > 16, K > 32, bfloat16: tensor cores, mma.sync m16n8k16 (bf16 x
// bf16 -> f32) with A and B fragments from shared memory by ldmatrix (B
// transposed on the load, since w is k-major). A block owns BM rows (16,
// 32 or 64, from M) and 32 columns; K comes in 128-deep slabs by
// cp.async, kMmaStages slabs in flight (K = 256 is two, both in flight
// from the start). Each warp owns 16 rows and every fourth 16-deep k step
// of each slab: the four k warps' float32 tiles are added in k-warp order
// through shared memory before the bias and activation. bf16 products are
// exact in float32, so this is the reference's float32 sum in another
// order.
//
// sgemm, M > 16, K > 32, float32: a register-tiled SGEMM in IEEE FMA (no
// TF32: the float32 tolerance would not hold). Tiles of BM x BN (16 x 32,
// 32 x 32, 64 x 64, 128 x 64, 128 x 128) are chosen from (M, N), each
// thread holding TM x TN sums; K slabs come in by 16-byte cp.async, 3 or 4
// in flight; x is read from shared memory as float4 along k, w as float2
// or float4 along n. The narrow-N tiles split each slab's k among 4 groups
// of threads (512 a block), added in group order at the end.
//
// mma and sgemm take the widest tile that still gives half as many blocks
// as SMs (kernels/fused_dense.py::tile_plan): every block loads all of w's
// column tile, so a second, narrower wave costs more than it hides.
//
// A shape off 16-byte rows (K or N not a multiple of the vector, or an
// unaligned pointer) takes a template branch of the same route that stages
// one element a load and stores one element at a time (narrow: one row a
// thread).
//
// Split-K route, M <= 16 and K > 32: one client's encode and EF decode
// at the slice shapes (M = its 4 chunks), e.g. (4, 4096) @ (4096, 512),
// where a tiled kernel ran 8 blocks on 132 SMs, each walking K serially,
// with 60 of its 64 rows padding. There w is all the traffic (8.4 MB against 64 KB of x),
// so bytes bind: the work is a GEMV-like stream of w. A block owns a K slab
// of w and column tiles of it, holds the slab's M rows of x in shared
// memory as float, and streams w with 16-byte vector loads (float4 or 8
// bf16), the loads of up to eight rows a thread issued before x is staged;
// every thread keeps its M x (4 or 8) partial sums in float32 registers.
// Lanes that share columns sum in a fixed shuffle tree, the 8 warps in warp
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

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16 bytes from global to shared memory without registers (cp.async);
// bytes past src_bytes (0 or 16 here) are zero-filled and not read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive values of x from shared memory as float (16 bytes of
// float, 8 of bf16).
__device__ __forceinline__ void ld_x4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ld_x4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 c = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = c.x; v[3] = c.y;
}

// 16 bytes of output: 4 floats or 8 bf16 (one rounding each).
__device__ __forceinline__ void st16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(__nv_bfloat16* p, const float* v) {
  uint4 r;
  __nv_bfloat162 h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j],
                                                           v[2 * j + 1]);
  r.x = *reinterpret_cast<unsigned*>(&h[0]);
  r.y = *reinterpret_cast<unsigned*>(&h[1]);
  r.z = *reinterpret_cast<unsigned*>(&h[2]);
  r.w = *reinterpret_cast<unsigned*>(&h[3]);
  *reinterpret_cast<uint4*>(p) = r;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory, once per
// size it grows to (`done` is the launch site's own static).
template <typename F>
int smem_opt_in(F kernel, size_t bytes, size_t& done) {
  if (bytes <= 48 * 1024 || bytes <= done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  done = bytes;
  return 0;
}

// ------------------------------------------------------------- narrow
constexpr int kNarrowMaxK = 32, kNarrowThreads = 256, kNarrowCols = 256;
constexpr int kNarrowStages = 3;     // x tiles in flight a block

// Geometry of a narrow launch, from (K, N), the element size and the rows
// a thread (rm; 0: the rule below).
struct NarrowGeom {
  int vec;      // columns a thread: one 16-byte store
  int cg;       // column groups a tile (a power of two)
  int nt;       // columns a tile: vec * cg
  int threads;  // a block
  int rl;       // row lanes: threads / cg
  int rm;       // rows a thread
  int bm;       // rows a tile: rl * rm
  int kp;       // K padded to the staging vector
  int xs;       // row stride of the x tile in shared memory (elements)
};

// Rows a thread. A call of at most 16 rows takes 1 (no padded rows). A
// wide tile (16 column groups or more: N > 64 floats) takes 4, so that
// each float4 of w read from shared memory feeds 4 rows' FMAs (at 1 or 2
// the reads of w, not the FMAs or the bytes, bind). A narrow tile does
// few FMAs a byte: it takes the most rows (8, 4, 2; bf16 at most 4) that
// still give at least two row tiles an SM (32 row lanes), else 1, so
// that a short call keeps many blocks and stores in flight and a long
// one few, long-lived tiles.
inline int narrow_rows(int cg, int es, long long M, int sms) {
  if (M <= 16) return 1;
  if (cg >= 16) return 4;
  for (int rm = es == 4 ? 8 : 4; rm > 1; rm /= 2)
    if ((M + 32LL * rm - 1) / (32LL * rm) >= 2LL * sms) return rm;
  return 1;
}

// rm: rows a thread (0: narrow_rows); a shape off 16-byte rows takes 1.
inline NarrowGeom narrow_geom(long long M, int K, int N, int es, int rm,
                              bool aligned, int sms) {
  NarrowGeom g;
  g.vec = 16 / es;
  const int ncv = (N + g.vec - 1) / g.vec;
  const int most = kNarrowCols / g.vec;
  g.cg = 1;
  while (g.cg < ncv && g.cg < most) g.cg *= 2;
  g.nt = g.vec * g.cg;
  g.threads = g.cg * 32 < kNarrowThreads ? g.cg * 32 : kNarrowThreads;
  g.rl = g.threads / g.cg;
  g.rm = !aligned ? 1 : rm > 0 ? rm : narrow_rows(g.cg, es, M, sms);
  g.bm = g.rl * g.rm;
  const int kv = 16 / es;                        // elements a 16-byte copy
  g.kp = (K + kv - 1) / kv * kv;
  g.xs = g.kp + kv;                              // 16 bytes of padding
  return g;
}

inline size_t narrow_smem(const NarrowGeom& g, int es, int stages) {
  return (size_t)g.kp * g.nt * sizeof(float) +
         (size_t)stages * g.bm * g.xs * es;
}

// Row tiles t = blockIdx.x, + gridDim.x, ... of column tile blockIdx.y.
// Shared memory: w's tile [kp][nt] as float (zeros past K and N), then the
// x tiles [bm][xs] in T, a ring of kNarrowStages (one when not ALIGNED).
// ALIGNED: x rows are whole 16-byte copies (K a multiple of the copy),
// N a multiple of VEC, x and w 16-byte aligned; w's tile then comes in
// 16 bytes a copy too, in the first tile's cp.async group (float32) or
// 8 bf16 a load (converted), all in flight at once.
template <typename T, int RM, bool ALIGNED>
__global__ void __launch_bounds__(kNarrowThreads)
narrow_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const T* __restrict__ b, T* __restrict__ y, long long M, int K,
              int N, int act, int cg, int kp, int xs) {
  constexpr int VEC = 16 / sizeof(T), KV = 16 / sizeof(T);
  constexpr int S = ALIGNED ? kNarrowStages : 1;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  const int threads = blockDim.x, tid = threadIdx.x;
  const int nt = VEC * cg, rl_n = threads / cg, bm = rl_n * RM;
  T* xt0 = reinterpret_cast<T*>(ws + (size_t)kp * nt);
  const int c = tid % cg, rl = tid / cg;
  const int n_tile = blockIdx.y * nt, col = n_tile + c * VEC;
  const long long ntiles = (M + bm - 1) / bm, step = gridDim.x;
  const int cpr = kp / KV;                       // 16-byte copies a row

  auto stage = [&](long long t, int buf) {
    T* xt = xt0 + (size_t)buf * bm * xs;
    const long long r0 = t * bm;
    if constexpr (ALIGNED) {
      for (int e = tid; e < bm * cpr; e += threads) {
        const int r = e / cpr, q = e % cpr;
        const long long gm = r0 + r;
        const bool in = gm < M;
        cp_async16(xt + r * xs + q * KV, in ? x + gm * K + q * KV : x,
                   in ? 16 : 0);
      }
    } else {
#pragma unroll 1
      for (int e = tid; e < bm * kp; e += threads) {
        const int r = e / kp, k = e % kp;
        const long long gm = r0 + r;
        xt[r * xs + k] = (gm < M && k < K) ? x[gm * K + k] : from_f<T>(0.f);
      }
    }
  };

  // w's column tile and this thread's bias, once a block
  if constexpr (ALIGNED && std::is_same<T, float>::value) {
    const int cpn = nt / 4;                      // 16-byte copies a row
    for (int e = tid; e < kp * cpn; e += threads) {
      const int k = e / cpn, n = n_tile + 4 * (e % cpn);
      const bool in = k < K && n < N;
      cp_async16(ws + k * nt + n - n_tile,
                 in ? w + (long long)k * N + n : w, in ? 16 : 0);
    }
  } else if constexpr (ALIGNED) {
    const int cpn = nt / 8;                      // 8 bf16 a load
#pragma unroll 4
    for (int e = tid; e < kp * cpn; e += threads) {
      const int k = e / cpn, n = n_tile + 8 * (e % cpn);
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      if (k < K && n < N) {
        const uint4 r = __ldg(reinterpret_cast<const uint4*>(
            w + (long long)k * N + n));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          v[2 * j] = f.x;
          v[2 * j + 1] = f.y;
        }
      }
      float4* dst = reinterpret_cast<float4*>(ws + k * nt + n - n_tile);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < kp * nt; e += threads) {
      const int k = e / nt, n = n_tile + e % nt;
      ws[e] = (k < K && n < N) ? to_f(w[(long long)k * N + n]) : 0.f;
    }
  }
  long long t = blockIdx.x;
  if constexpr (ALIGNED) {
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (t + s * step < ntiles) stage(t + s * step, s);
      cp_async_commit();
    }
  }
  float bias[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    bias[j] = col + j < N ? to_f(b[col + j]) : 0.f;
  const bool vec_out = ALIGNED && col < N;

  for (int it = 0; t < ntiles; t += step, ++it) {
    if constexpr (ALIGNED) {
      cp_async_wait<S - 2>();                    // tile t has landed
      __syncthreads();                           // and tile t - 1 is read
      if (t + (S - 1) * step < ntiles)
        stage(t + (S - 1) * step, (it + S - 1) % S);
      cp_async_commit();
    } else {
      __syncthreads();                           // tile t - 1 is read
      stage(t, 0);
      __syncthreads();
    }
    const T* xt = xt0 + (size_t)(it % S) * bm * xs;
    float acc[RM][VEC];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < kp; k += 4) {
      float xv[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i) ld_x4(xt + (rl + i * rl_n) * xs + k, xv[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float wv[VEC];
        const float4* wr =
            reinterpret_cast<const float4*>(ws + (k + kk) * nt + c * VEC);
#pragma unroll
        for (int q = 0; q < VEC / 4; ++q) {
          const float4 f = wr[q];
          wv[4 * q] = f.x; wv[4 * q + 1] = f.y;
          wv[4 * q + 2] = f.z; wv[4 * q + 3] = f.w;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[i][j] = fmaf(xv[i][kk], wv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const long long gm = t * bm + rl + i * rl_n;
      if (gm >= M) continue;
      float v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = apply_act(acc[i][j] + bias[j], act);
      if (vec_out) {
        st16(y + gm * N + col, v);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (col + j < N) y[gm * N + col + j] = from_f<T>(v[j]);
      }
    }
  }
}

template <typename T, int RM, bool ALIGNED>
int launch_narrow_inst(const T* x, const T* w, const T* b, T* y, long long M,
                       int K, int N, int act, const NarrowGeom& g, int sms,
                       cudaStream_t stream) {
  static size_t opted = 0;
  static int occ_threads = -1, occ_blocks = 1;
  static size_t occ_smem = 0;
  auto kernel = narrow_kernel<T, RM, ALIGNED>;
  const size_t smem = narrow_smem(g, (int)sizeof(T),
                                  ALIGNED ? kNarrowStages : 1);
  if (int e = smem_opt_in(kernel, smem, opted)) return e;
  if (occ_threads != g.threads || occ_smem != smem) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, g.threads, smem);
    if (e != cudaSuccess) return (int)e;
    occ_threads = g.threads;
    occ_smem = smem;
    occ_blocks = n > 0 ? n : 1;
  }
  const int col_tiles = (N + g.nt - 1) / g.nt;
  const long long ntiles = (M + g.bm - 1) / g.bm;
  long long gx = (long long)occ_blocks * sms / col_tiles;
  if (gx < 1) gx = 1;
  if (gx > ntiles) gx = ntiles;
  kernel<<<dim3((unsigned)gx, (unsigned)col_tiles), g.threads, smem,
           stream>>>(x, w, b, y, M, K, N, act, g.cg, g.kp, g.xs);
  return (int)cudaGetLastError();
}

// rm: rows a thread, 1, 2, 4 or 8 (float32 only), 0 for narrow_rows; a
// shape off 16-byte rows takes the element-wise branch at 1.
template <typename T>
int launch_narrow(const void* x, const void* w, const void* b, void* y,
                  long long M, int K, int N, int act, int rm, int sms,
                  cudaStream_t s) {
  if (K > kNarrowMaxK) return (int)cudaErrorInvalidValue;
  constexpr int KV = 16 / sizeof(T);
  const bool aligned = K % KV == 0 && N % KV == 0 && aligned16(x) &&
                       aligned16(w) && aligned16(y);
  const NarrowGeom g = narrow_geom(M, K, N, (int)sizeof(T), rm, aligned,
                                   sms);
  const T *xp = (const T*)x, *wp = (const T*)w, *bp = (const T*)b;
  T* yp = (T*)y;
  if (!aligned)
    return launch_narrow_inst<T, 1, false>(xp, wp, bp, yp, M, K, N, act, g,
                                           sms, s);
  switch (g.rm) {
    case 1: return launch_narrow_inst<T, 1, true>(xp, wp, bp, yp, M, K, N,
                                                  act, g, sms, s);
    case 2: return launch_narrow_inst<T, 2, true>(xp, wp, bp, yp, M, K, N,
                                                  act, g, sms, s);
    case 4: return launch_narrow_inst<T, 4, true>(xp, wp, bp, yp, M, K, N,
                                                  act, g, sms, s);
    case 8:
      if constexpr (std::is_same<T, float>::value)
        return launch_narrow_inst<T, 8, true>(xp, wp, bp, yp, M, K, N, act,
                                              g, sms, s);
      [[fallthrough]];
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- mma
// bf16 tiles: BM rows x 32 columns a block, K slabs 128 deep (K = 256 is
// two slabs, both in flight at once); a warp owns 16 rows and every
// kMmaKWarps-th 16-deep k step of each slab.
constexpr int kMmaBN = 32, kMmaBK = 128, kMmaKWarps = 4, kMmaStages = 3;
constexpr int kMmaAS = kMmaBK + 8;      // A row stride (bf16): +16 bytes
constexpr int kMmaBS = kMmaBN + 8;      // B row stride (bf16): 80 bytes
constexpr int kMmaRS = kMmaBN + 4;      // partial sums' row stride (float)

__host__ __device__ constexpr int mma_threads(int BM) {
  return 32 * (BM / 16) * kMmaKWarps;
}
__host__ __device__ constexpr size_t mma_smem(int BM) {
  const size_t ring = (size_t)kMmaStages *
                      (BM * kMmaAS + kMmaBK * kMmaBS) * 2;
  const size_t red = (size_t)kMmaKWarps * BM * kMmaRS * 4;
  return ring > red ? ring : red;
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
// d = a (16 x 16, row) * b (16 x 8, col) + d, bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (row tile blockIdx.x, column tile blockIdx.y). ALIGNED: K and N
// multiples of 8 (whole 16-byte copies), x and w aligned.
template <int BM, bool ALIGNED>
__global__ void __launch_bounds__(32 * (BM / 16) * kMmaKWarps)
mma_kernel(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ w,
           const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ y,
           long long M, int K, int N, int act) {
  using bf16 = __nv_bfloat16;
  constexpr int THREADS = mma_threads(BM), WM = BM / 16;
  constexpr int STAGE = BM * kMmaAS + kMmaBK * kMmaBS;   // bf16 a slab
  extern __shared__ float4 smem4[];
  bf16* ring = reinterpret_cast<bf16*>(smem4);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % WM, wk = warp / WM;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * kMmaBN;
  const int nk = (K + kMmaBK - 1) / kMmaBK;

  auto load = [&](int kt, int slot) {
    bf16* As = ring + slot * STAGE;
    bf16* Bs = As + BM * kMmaAS;
    const int k0 = kt * kMmaBK;
    if constexpr (ALIGNED) {
      for (int e = tid; e < BM * (kMmaBK / 8); e += THREADS) {
        const int r = e / (kMmaBK / 8), q = e % (kMmaBK / 8);
        const long long gm = m0 + r;
        const int gk = k0 + 8 * q;
        const bool in = gm < M && gk < K;
        cp_async16(As + r * kMmaAS + 8 * q, in ? x + gm * K + gk : x,
                   in ? 16 : 0);
      }
      for (int e = tid; e < kMmaBK * (kMmaBN / 8); e += THREADS) {
        const int r = e / (kMmaBN / 8), q = e % (kMmaBN / 8);
        const int gk = k0 + r, gn = n0 + 8 * q;
        const bool in = gk < K && gn < N;
        cp_async16(Bs + r * kMmaBS + 8 * q,
                   in ? w + (long long)gk * N + gn : w, in ? 16 : 0);
      }
    } else {
      const bf16 zero = __float2bfloat16(0.f);
#pragma unroll 1
      for (int e = tid; e < BM * kMmaBK; e += THREADS) {
        const int r = e / kMmaBK, k = e % kMmaBK;
        const long long gm = m0 + r;
        const int gk = k0 + k;
        As[r * kMmaAS + k] = (gm < M && gk < K) ? x[gm * K + gk] : zero;
      }
#pragma unroll 1
      for (int e = tid; e < kMmaBK * kMmaBN; e += THREADS) {
        const int r = e / kMmaBN, n = e % kMmaBN;
        const int gk = k0 + r, gn = n0 + n;
        Bs[r * kMmaBS + n] =
            (gk < K && gn < N) ? w[(long long)gk * N + gn] : zero;
      }
    }
  };

  float acc[kMmaBN / 8][4];
#pragma unroll
  for (int j = 0; j < kMmaBN / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kMmaStages - 2>();             // slab kt has landed
    __syncthreads();                             // and slab kt - 1 is read
    if (kt + kMmaStages - 1 < nk)
      load(kt + kMmaStages - 1, (kt + kMmaStages - 1) % kMmaStages);
    cp_async_commit();
    const bf16* As = ring + (kt % kMmaStages) * STAGE;
    const bf16* Bs = As + BM * kMmaAS;
#pragma unroll
    for (int q = 0; q < kMmaBK / (16 * kMmaKWarps); ++q) {
      const int ks = (wk + q * kMmaKWarps) * 16;
      unsigned a[4];
      ldmatrix_x4(a, As + (wm * 16 + lane % 16) * kMmaAS + ks +
                         (lane / 16) * 8);
#pragma unroll
      for (int p = 0; p < kMmaBN / 16; ++p) {
        unsigned bb[4];
        ldmatrix_x4_trans(bb, Bs + (ks + lane % 16) * kMmaBS + p * 16 +
                                  (lane / 16) * 8);
        mma_bf16(acc[2 * p], a, bb[0], bb[1]);
        mma_bf16(acc[2 * p + 1], a, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                               // the ring is free

  // the k warps' tiles through shared memory, added in k-warp order
  float* red = reinterpret_cast<float*>(smem4);
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int j = 0; j < kMmaBN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* dst = red + ((size_t)wk * BM + wm * 16 + gid + 8 * h) * kMmaRS +
                   8 * j + 2 * tig;
      dst[0] = acc[j][2 * h];
      dst[1] = acc[j][2 * h + 1];
    }
  __syncthreads();
  for (int e = tid; e < BM * (kMmaBN / 8); e += THREADS) {
    const int r = e / (kMmaBN / 8), c = 8 * (e % (kMmaBN / 8));
    const long long gm = m0 + r;
    const int gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s = red[(size_t)r * kMmaRS + c + j];
#pragma unroll
      for (int q = 1; q < kMmaKWarps; ++q)
        s += red[((size_t)q * BM + r) * kMmaRS + c + j];
      v[j] = gn + j < N ? apply_act(s + to_f(b[gn + j]), act) : 0.f;
    }
    if (ALIGNED) {
      st16(y + gm * N + gn, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (gn + j < N) y[gm * N + gn + j] = __float2bfloat16(v[j]);
    }
  }
}

template <int BM, bool ALIGNED>
int launch_mma_inst(const void* x, const void* w, const void* b, void* y,
                    long long M, int K, int N, int act, cudaStream_t s) {
  static size_t opted = 0;
  auto kernel = mma_kernel<BM, ALIGNED>;
  constexpr size_t smem = mma_smem(BM);
  if (int e = smem_opt_in(kernel, smem, opted)) return e;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + kMmaBN - 1) /
                                                      kMmaBN));
  kernel<<<grid, mma_threads(BM), smem, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)b, (__nv_bfloat16*)y, M, K, N, act);
  return (int)cudaGetLastError();
}

template <bool ALIGNED>
int launch_mma_bm(const void* x, const void* w, const void* b, void* y,
                  long long M, int K, int N, int act, int bm,
                  cudaStream_t s) {
  if (bm == 16)
    return launch_mma_inst<16, ALIGNED>(x, w, b, y, M, K, N, act, s);
  if (bm == 32)
    return launch_mma_inst<32, ALIGNED>(x, w, b, y, M, K, N, act, s);
  if (bm == 64)
    return launch_mma_inst<64, ALIGNED>(x, w, b, y, M, K, N, act, s);
  return (int)cudaErrorInvalidValue;
}

int launch_mma(const void* x, const void* w, const void* b, void* y,
               long long M, int K, int N, int act, int bm, cudaStream_t s) {
  const bool aligned = K % 8 == 0 && N % 8 == 0 && aligned16(x) &&
                       aligned16(w) && aligned16(y);
  return aligned ? launch_mma_bm<true>(x, w, b, y, M, K, N, act, bm, s)
                 : launch_mma_bm<false>(x, w, b, y, M, K, N, act, bm, s);
}

// -------------------------------------------------------------- sgemm
// A tile: BM x BN outputs, TM x TN a thread, K slabs BK deep with STAGES
// of them in flight; x's slab rows are padded by 16 bytes (AS floats). KW
// k groups of (BM / TM) x (BN / TN) threads each take every KW-th run of
// BK / KW k values of a slab; their sums are added in group order through
// shared memory at the end (KW > 1 gives a narrow tile more warps).
template <int BM, int BN, int TM, int TN, int BK, int STAGES, int KW>
struct SgemmTile {
  static constexpr int kGroup = (BM / TM) * (BN / TN);
  static constexpr int kThreads = kGroup * KW;
  static constexpr int AS = BK + 4;
  static constexpr int RS = BN + 4;                              // sums
  static constexpr int kStage = BM * AS + BK * BN;               // floats
  static constexpr size_t kRing = (size_t)STAGES * kStage * 4;
  static constexpr size_t kRed = KW > 1 ? (size_t)KW * BM * RS * 4 : 0;
  static constexpr size_t kSmem = kRing > kRed ? kRing : kRed;
};

// Column j of a thread's TN: TN = 2 two adjacent columns; TN >= 4 groups
// of 4 adjacent columns BN / (TN / 4) apart, so that 8 threads read 128
// contiguous bytes of a w row.
template <int BN, int TN>
__device__ __forceinline__ int sgemm_col(int tx, int j) {
  if constexpr (TN == 2) return 2 * tx + j;
  else return (j / 4) * (BN / (TN / 4)) + 4 * tx + (j % 4);
}

// n0 + c .. n0 + c + nv - 1 of row gm: act(v + b), in 16-byte (or 8-byte)
// stores when ALIGNED, else one element at a time.
template <bool ALIGNED, int NV>
__device__ __forceinline__ void sgemm_store(float* y, const float* b,
                                            long long gm, int gn, int N,
                                            const float* v, int act) {
  float o[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j)
    o[j] = gn + j < N ? apply_act(v[j] + b[gn + j], act) : 0.f;
  if constexpr (ALIGNED && NV == 4) {
    if (gn < N) st16(y + gm * N + gn, o);
  } else if constexpr (ALIGNED && NV == 2) {
    if (gn < N)
      *reinterpret_cast<float2*>(y + gm * N + gn) = make_float2(o[0], o[1]);
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (gn + j < N) y[gm * N + gn + j] = o[j];
  }
}

template <int BM, int BN, int TM, int TN, int BK, int STAGES, int KW,
          bool ALIGNED>
__global__ void __launch_bounds__(
    SgemmTile<BM, BN, TM, TN, BK, STAGES, KW>::kThreads)
sgemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ b, float* __restrict__ y, long long M,
             int K, int N, int act) {
  using Tile = SgemmTile<BM, BN, TM, TN, BK, STAGES, KW>;
  constexpr int THREADS = Tile::kThreads, TX = BN / TN, TY = BM / TM;
  constexpr int AS = Tile::AS, KR = BK / KW;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, kw = tid / Tile::kGroup;
  const int tx = tid % Tile::kGroup % TX, ty = tid % Tile::kGroup / TX;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  auto load = [&](int kt, int slot) {
    float* As = ring + slot * Tile::kStage;
    float* Bs = As + BM * AS;
    const int k0 = kt * BK;
    if constexpr (ALIGNED) {
      for (int e = tid; e < BM * (BK / 4); e += THREADS) {
        const int r = e / (BK / 4), q = e % (BK / 4);
        const long long gm = m0 + r;
        const int gk = k0 + 4 * q;
        const bool in = gm < M && gk < K;
        cp_async16(As + r * AS + 4 * q, in ? x + gm * K + gk : x,
                   in ? 16 : 0);
      }
      for (int e = tid; e < BK * (BN / 4); e += THREADS) {
        const int r = e / (BN / 4), q = e % (BN / 4);
        const int gk = k0 + r, gn = n0 + 4 * q;
        const bool in = gk < K && gn < N;
        cp_async16(Bs + r * BN + 4 * q, in ? w + (long long)gk * N + gn : w,
                   in ? 16 : 0);
      }
    } else {
#pragma unroll 1
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, k = e % BK;
        const long long gm = m0 + r;
        const int gk = k0 + k;
        As[r * AS + k] = (gm < M && gk < K) ? x[gm * K + gk] : 0.f;
      }
#pragma unroll 1
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int r = e / BN, n = e % BN;
        const int gk = k0 + r, gn = n0 + n;
        Bs[r * BN + n] = (gk < K && gn < N) ? w[(long long)gk * N + gn] : 0.f;
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();                 // slab kt has landed
    __syncthreads();                             // and slab kt - 1 is read
    if (kt + STAGES - 1 < nk)
      load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* As = ring + (kt % STAGES) * Tile::kStage;
    const float* Bs = As + BM * AS;
#pragma unroll
    for (int k4 = 0; k4 < KR; k4 += 4) {
      const int k = kw * KR + k4;
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) ld_x4(As + (ty + i * TY) * AS + k, a[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[TN];
        const float* br = Bs + (k + kk) * BN;
        if constexpr (TN == 2) {
          const float2 f = *reinterpret_cast<const float2*>(br + 2 * tx);
          bv[0] = f.x; bv[1] = f.y;
        } else {
#pragma unroll
          for (int g = 0; g < TN / 4; ++g) {
            const float4 f = *reinterpret_cast<const float4*>(
                br + sgemm_col<BN, TN>(tx, 4 * g));
            bv[4 * g] = f.x; bv[4 * g + 1] = f.y;
            bv[4 * g + 2] = f.z; bv[4 * g + 3] = f.w;
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][kk], bv[j], acc[i][j]);
      }
    }
  }

  constexpr int NV = TN < 4 ? TN : 4;            // columns a store
  if constexpr (KW == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long gm = m0 + ty + i * TY;
      if (gm >= M) continue;
#pragma unroll
      for (int g = 0; g < TN / NV; ++g)
        sgemm_store<ALIGNED, NV>(y, b, gm, n0 + sgemm_col<BN, TN>(tx, NV * g),
                                 N, acc[i] + NV * g, act);
    }
  } else {
    // the k groups' sums through shared memory, added in group order
    cp_async_wait<0>();
    __syncthreads();                             // the ring is free
    float* red = ring;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        red[((size_t)kw * BM + ty + i * TY) * Tile::RS +
            sgemm_col<BN, TN>(tx, j)] = acc[i][j];
    __syncthreads();
    for (int e = tid; e < BM * (BN / 4); e += THREADS) {
      const int r = e / (BN / 4), c = 4 * (e % (BN / 4));
      const long long gm = m0 + r;
      if (gm >= M) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float sum = red[(size_t)r * Tile::RS + c + j];
#pragma unroll
        for (int q = 1; q < KW; ++q)
          sum += red[((size_t)q * BM + r) * Tile::RS + c + j];
        v[j] = sum;
      }
      sgemm_store<ALIGNED, 4>(y, b, gm, n0 + c, N, v, act);
    }
  }
}

template <int BM, int BN, int TM, int TN, int BK, int STAGES, int KW,
          bool ALIGNED>
int launch_sgemm_inst(const void* x, const void* w, const void* b, void* y,
                      long long M, int K, int N, int act, cudaStream_t s) {
  using Tile = SgemmTile<BM, BN, TM, TN, BK, STAGES, KW>;
  static size_t opted = 0;
  auto kernel = sgemm_kernel<BM, BN, TM, TN, BK, STAGES, KW, ALIGNED>;
  if (int e = smem_opt_in(kernel, Tile::kSmem, opted)) return e;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  kernel<<<grid, Tile::kThreads, Tile::kSmem, s>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)y, M, K, N,
      act);
  return (int)cudaGetLastError();
}

// tile (kernels/fused_dense.py::SGEMM_TILES): 0 = 32 x 32 and 4 = 16 x 32
// (narrow N: 32-deep slabs, 4 in flight, 4 k groups, 512 threads, since
// each thread of a narrow tile has little work a slab), 1 = 64 x 64, 2 =
// 128 x 64, 3 = 128 x 128 (256 threads; 16-deep slabs, 3 in flight).
template <bool ALIGNED>
int launch_sgemm_tile(const void* x, const void* w, const void* b, void* y,
                      long long M, int K, int N, int act, int tile,
                      cudaStream_t s) {
  switch (tile) {
    case 0: return launch_sgemm_inst<32, 32, 4, 2, 32, 4, 4, ALIGNED>(
        x, w, b, y, M, K, N, act, s);
    case 1: return launch_sgemm_inst<64, 64, 4, 4, 16, 3, 1, ALIGNED>(
        x, w, b, y, M, K, N, act, s);
    case 2: return launch_sgemm_inst<128, 64, 8, 4, 16, 3, 1, ALIGNED>(
        x, w, b, y, M, K, N, act, s);
    case 3: return launch_sgemm_inst<128, 128, 8, 8, 16, 3, 1, ALIGNED>(
        x, w, b, y, M, K, N, act, s);
    case 4: return launch_sgemm_inst<16, 32, 2, 2, 32, 4, 4, ALIGNED>(
        x, w, b, y, M, K, N, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_sgemm(const void* x, const void* w, const void* b, void* y,
                 long long M, int K, int N, int act, int tile,
                 cudaStream_t s) {
  const bool aligned = K % 4 == 0 && N % 4 == 0 && aligned16(x) &&
                       aligned16(w) && aligned16(y);
  return aligned ? launch_sgemm_tile<true>(x, w, b, y, M, K, N, act, tile, s)
                 : launch_sgemm_tile<false>(x, w, b, y, M, K, N, act, tile,
                                            s);
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

// The routes other than split-K (kernels/fused_dense.py::kernel_route): any
// M at K <= 32, M > 16 above it. dtype: 0
// float32, 1 bfloat16; act: 0 relu, 1 tanh, 2 sigmoid, 3 linear; route: 0
// narrow (K <= 32, either dtype; cfg = rows a thread, 0 for the rule of
// narrow_rows), 1 mma (bfloat16; cfg = BM,
// 16, 32 or 64), 2 sgemm (float32; cfg = tile 0..4); sms: the card's SMs
// (the narrow route's persistent grid).
extern "C" int repro_fused_dense(const void* x, const void* w, const void* b,
                                 void* y, long long M, int K, int N, int act,
                                 int dtype, int route, int cfg, int sms,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (M < 1 || K < 0 || N < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  if (route == 0 && dtype == 0)
    return launch_narrow<float>(x, w, b, y, M, K, N, act, cfg, sms, s);
  if (route == 0 && dtype == 1)
    return launch_narrow<__nv_bfloat16>(x, w, b, y, M, K, N, act, cfg, sms,
                                        s);
  if (route == 1 && dtype == 1)
    return launch_mma(x, w, b, y, M, K, N, act, cfg, s);
  if (route == 2 && dtype == 0)
    return launch_sgemm(x, w, b, y, M, K, N, act, cfg, s);
  return (int)cudaErrorInvalidValue;
}

// Split-K route for 1 <= M <= 16 (the wrapper takes it at K > 32). rows: K
// rows of w a slab (<= 512); tpr: threads a column vector row (a power of
// two <= 32); ws: float32 (ceil(K / rows), M, N), unused (may be null)
// when one slab covers K.
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
