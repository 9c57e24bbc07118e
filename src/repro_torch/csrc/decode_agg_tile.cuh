// The reduce-before-expand bodies shared by the fused decode->aggregate
// kernel (fused_decode_agg.cu) and its grouped ragged form
// (grouped_decode_agg.cu). Both compute, for one bucket of C clients,
//
//   out[m, n] = sum_c w_c * (h_c[m] @ W[:, n]) + b[n]
//             = (hbar @ W)[m, n] + b[n],   hbar = sum_c w_c * h_c
//
// reducing the clients first, latent-side, so that no per-client (M, N)
// value exists anywhere. There are two bodies, and the wrappers pick one
// per bucket from the bucket's own (M, K) (kernels/fused_decode_agg.py::
// kernel_route):
//
// * decode_agg_rows, M <= 16 and K <= 512 (the "few_rows" route: one
//   client's or a rung's few chunks, e.g. M = 4, K = 512, N = 4096). W is
//   all the traffic there (8 MB against 24 KB of h), so the body is a
//   stream of W, as kernel 3's split-K route (fused_dense.cu) is: a block
//   owns a column tile of W (tpr 16-byte vectors wide) and all K of its
//   rows. It first puts its whole tile of W in flight into shared memory
//   (cp.async, 16 bytes a copy, no registers held), then reduces hbar
//   (M, K) from h (L2-resident, float4 loads, clients in ascending order)
//   into shared memory while W arrives, then each thread keeps M x 4
//   float32 partial sums in registers over rows k = p, p + G, p + 2G, ...
//   (G = 256 / tpr threads along K, p its place). Each block's fixed cost
//   is its own hbar reduce, so the plan gives a bucket about one block an
//   SM. Lanes of one column vector are summed
//   in a fixed xor tree, the 8 warps in warp order through shared memory,
//   then the bias is added. The order of additions depends on tpr alone,
//   which the plan takes from (N, SMs): every launch over a bucket, alone
//   or grouped, adds in the same order.
// * decode_agg_band, every other bucket (the "bands" route: cohort scale,
//   e.g. C = 256, M = 4096, K = 32, N = 256). h is all the traffic there
//   (128 MB), so the body streams h: a block owns a band of up to bm rows,
//   and the threads split the clients into Q = f(K) interleaved groups
//   (client c in group c mod Q), each thread holding 8 float4 loads of h in
//   flight; the groups' sums are added in group order through shared
//   memory into hbar. Then each thread expands one column at a time for 8
//   rows: k ascending, one fmaf chain an output, W read coalesced, then
//   the bias. Band height and column split change nothing in that order.
//
// So each bucket's grouped result is bit-equal to the per-bucket kernel on
// that bucket alone, whatever tiles either launch cuts.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace decode_agg {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kUnroll = 8;           // bands: loads of h in flight a thread
constexpr int kRowsBatch = 4;        // few_rows: loads of h a batch
constexpr int kRowsMaxK = 512;       // few_rows: K rows of hbar in shared
constexpr int kStageFloats = 4 * kThreads;   // bands: the groups' partials
enum Route { kBands = 0, kRows = 1 };

// Four floats from p, valid of them in range (zeros past it): one 16-byte
// load when vec and all four are in range, else one load a float.
__device__ __forceinline__ float4 ld4(const float* p, int valid, bool vec) {
  if (vec && valid >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 r;
  r.x = valid > 0 ? __ldg(p) : 0.f;
  r.y = valid > 1 ? __ldg(p + 1) : 0.f;
  r.z = valid > 2 ? __ldg(p + 2) : 0.f;
  r.w = valid > 3 ? __ldg(p + 3) : 0.f;
  return r;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Client groups of the bands route's reduce, from K alone: about 8 rows of
// a band a group's threads at once (Q = 128 / K, a power of two in
// [1, 8]).
__host__ __device__ inline int band_groups(int K) {
  int q = 1;
  while (q < 8 && 2 * q * K <= 128) q *= 2;
  return q;
}

// ---------------------------------------------------------- few_rows
constexpr int kRowsMaxTpr = 16;      // the W tile [512][64] in shared

// Blocks an SM the kernels ask of the compiler at row template MT: 64
// registers a thread at MT = 4, so that the grouped kernel's bands tiles
// are not held to the few_rows body's register count.
template <int MT>
constexpr int rows_min_blocks() { return MT == 4 ? 4 : MT == 8 ? 3 : 2; }

// Shared memory (floats): the W tile [K][4 * tpr], then hbar [K][MT],
// later the warps' sums [kWarps][M][4 * tpr].
__host__ __device__ inline int rows_smem_floats(int K, int MT, int tpr) {
  const int red = kWarps * MT * 4 * tpr, xs = K * MT;
  return K * 4 * tpr + (red > xs ? red : xs);
}

// 16 bytes from global to shared memory, asynchronously (cp.async; the
// thread waits at cp.async.wait_group).
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Column tile `tile` (columns [tile * 4 tpr, (tile + 1) * 4 tpr)) of out
// (M, N) for one bucket: hb is client 0's (M, K), clients client_stride
// floats apart. MT >= M is the compiled row count (rows M..MT-1 are zero).
template <int MT>
__device__ __forceinline__ void decode_agg_rows(
    const float* __restrict__ hb, long long client_stride,
    const float* __restrict__ wts, int C, int M, int K,
    const float* __restrict__ W, const float* __restrict__ b, int N,
    int tpr, int tile, float* __restrict__ out, float* sm) {
  const int tid = threadIdx.x, wid = tid / 32, lane = tid % 32;
  const int tx = lane % tpr, sub = lane / tpr, rw = 32 / tpr;
  const int cols = 4 * tpr, n0 = tile * cols, n = n0 + 4 * tx;
  const int step = kWarps * rw;                  // G: threads along K
  const bool wvec = N % 4 == 0 && aligned16(W);
  float* wsm = sm;                               // [K][cols]
  float* xs = sm + K * cols;                     // hbar [K][MT], then sums

  // 1) the block's whole tile of W into shared memory, all of it in flight
  for (int i = tid; i < K * tpr; i += kThreads) {
    const int k = i / tpr, v = i % tpr, nn = n0 + 4 * v;
    float* dst = wsm + k * cols + 4 * v;
    const float* src = W + (long long)k * N + nn;
    if (wvec && nn + 4 <= N) {
      cp_async16(dst, src);
    } else {
      const float4 r = ld4(src, N - nn, wvec);
      dst[0] = r.x; dst[1] = r.y; dst[2] = r.z; dst[3] = r.w;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const int t = tid % cols;                      // column in the block sum
  const float bias = n0 + t < N ? __ldg(b + n0 + t) : 0.f;

  // 2) hbar[k][m] = sum_c w_c * h_c[m][k], clients ascending
  const int band = M * K;
  const bool hvec = client_stride % 4 == 0 && aligned16(hb);
  for (int e = 4 * tid; e < band; e += 4 * kThreads) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < C; c0 += kRowsBatch) {
      float4 v[kRowsBatch];
      float wv[kRowsBatch];
#pragma unroll
      for (int u = 0; u < kRowsBatch; ++u)
        if (c0 + u < C) {
          wv[u] = __ldg(wts + c0 + u);
          v[u] = ld4(hb + (long long)(c0 + u) * client_stride + e, band - e,
                     hvec);
        }
#pragma unroll
      for (int u = 0; u < kRowsBatch; ++u)
        if (c0 + u < C) {
          a.x = fmaf(wv[u], v[u].x, a.x);
          a.y = fmaf(wv[u], v[u].y, a.y);
          a.z = fmaf(wv[u], v[u].z, a.z);
          a.w = fmaf(wv[u], v[u].w, a.w);
        }
    }
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e + j < band) xs[((e + j) % K) * MT + (e + j) / K] = av[j];
  }
  for (int e = tid; e < (MT - M) * K; e += kThreads)
    xs[(e % K) * MT + M + e / K] = 0.f;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 3) M x 4 partial sums over rows p, p + G, ...
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  if (n < N)
#pragma unroll 4
    for (int k = wid * rw + sub; k < K; k += step) {
      const float4 w4 = *reinterpret_cast<const float4*>(wsm + k * cols +
                                                         4 * tx);
      const float v[4] = {w4.x, w4.y, w4.z, w4.w};
      const float* xr = xs + k * MT;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xm = xr[m];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xm, v[j], acc[m][j]);
      }
    }
  // 4) lanes of one column vector: a fixed xor tree
  for (int off = tpr; off < 32; off *= 2)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
  // 5) the 8 warps' sums in warp order, then the bias
  __syncthreads();                               // hbar is read
  if (sub == 0)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= M) break;
      *reinterpret_cast<float4*>(xs + (wid * M + m) * cols + 4 * tx) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  __syncthreads();
  if (n0 + t < N)
    for (int m = tid / cols; m < M; m += kThreads / cols) {
      float sum = xs[m * cols + t];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) sum += xs[(q * M + m) * cols + t];
      out[(long long)m * N + n0 + t] = sum + bias;
    }
}

// ------------------------------------------------------------- bands
// Shared memory (floats): hbar [K][bm] and the groups' partials.
__host__ __device__ inline int band_smem_floats(int bm, int K) {
  return bm * K + kStageFloats;
}

// Rows [0, rows) of a band (rows <= bm, bm a multiple of 8) and columns
// [n_begin, n_end) of out: hb is client 0's first band row, clients
// client_stride floats apart; out is the band's first output row.
__device__ __forceinline__ void decode_agg_band(
    const float* __restrict__ hb, long long client_stride,
    const float* __restrict__ wts, int C, int rows, int bm, int K,
    const float* __restrict__ W, const float* __restrict__ b, int N,
    int n_begin, int n_end, float* __restrict__ out, float* sm) {
  float* hbar = sm;                              // [K][bm]
  float4* stage = reinterpret_cast<float4*>(sm + bm * K);
  const int Q = band_groups(K), TG = kThreads / Q;
  const int q = threadIdx.x / TG, slot = threadIdx.x % TG;
  const int band = rows * K;
  const bool hvec = client_stride % 4 == 0 && aligned16(hb);

  // 1) hbar = sum over groups in group order of each group's fmaf chain
  //    over its clients q, q + Q, q + 2Q, ... ascending
  for (int base = 0; base < band; base += 4 * TG) {
    const int e = base + 4 * slot;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < band)
      for (int c0 = q; c0 < C; c0 += kUnroll * Q) {
        float4 v[kUnroll];
        float wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = c0 + u * Q;
          if (c < C) {
            wv[u] = __ldg(wts + c);
            v[u] = ld4(hb + (long long)c * client_stride + e, band - e, hvec);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (c0 + u * Q < C) {
            a.x = fmaf(wv[u], v[u].x, a.x);
            a.y = fmaf(wv[u], v[u].y, a.y);
            a.z = fmaf(wv[u], v[u].z, a.z);
            a.w = fmaf(wv[u], v[u].w, a.w);
          }
      }
    if (Q > 1) {
      stage[threadIdx.x] = a;
      __syncthreads();
      if (q == 0)
        for (int p = 1; p < Q; ++p) {
          const float4 s = stage[p * TG + slot];
          a.x += s.x;
          a.y += s.y;
          a.z += s.z;
          a.w += s.w;
        }
    }
    if (q == 0 && e < band) {
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e + j < band) hbar[((e + j) % K) * bm + (e + j) / K] = av[j];
    }
    if (Q > 1) __syncthreads();                  // the stage is reused
  }
  for (int e = threadIdx.x; e < (bm - rows) * K; e += kThreads)
    hbar[(e % K) * bm + rows + e / K] = 0.f;
  __syncthreads();

  // 2) expand: a thread a column, 8 rows at a time, k ascending
  for (int n = n_begin + threadIdx.x; n < n_end; n += kThreads) {
    const float bv = __ldg(b + n);
    for (int g = 0; g < rows; g += 8) {
      float acc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float wv = __ldg(W + (long long)k * N + n);
        const float4 h0 = *reinterpret_cast<const float4*>(hbar + k * bm + g);
        const float4 h1 =
            *reinterpret_cast<const float4*>(hbar + k * bm + g + 4);
        acc[0] = fmaf(h0.x, wv, acc[0]);
        acc[1] = fmaf(h0.y, wv, acc[1]);
        acc[2] = fmaf(h0.z, wv, acc[2]);
        acc[3] = fmaf(h0.w, wv, acc[3]);
        acc[4] = fmaf(h1.x, wv, acc[4]);
        acc[5] = fmaf(h1.y, wv, acc[5]);
        acc[6] = fmaf(h1.z, wv, acc[6]);
        acc[7] = fmaf(h1.w, wv, acc[7]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (g + r < rows) out[(long long)(g + r) * N + n] = acc[r] + bv;
    }
  }
}

}  // namespace decode_agg

// Opt a kernel into more than 48 KB of dynamic shared memory when a launch
// needs it; returns a cudaError_t as int.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
