// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_kernel (flash_attention_pallas) of
// src/repro/kernels/flash_attention.py: q (B, Sq, H, D), k and v
// (B, Skv, KV, D), float32 or bfloat16; head h reads kv head h / G with
// G = H / KV, so K and V are never replicated. Scores are float32,
// scaled by D^-0.5 and masked to -1e30 (kv padding k < Skv; causal k <= q;
// window k > q - window); the online softmax (m, l, acc) runs over kv
// tiles in float32 and the output, acc / max(l, 1e-30), is written in q's
// type. Like the reference, the (q tile x kv tile) score and probability
// tiles never reach device memory.
//
// The TPU kernel walks kv blocks as a sequential grid axis and carries
// m, l and acc in VMEM scratch. Here one block owns one (b, h, 64-row q
// tile) and loops over 64-row kv tiles itself, carrying m, l and acc in
// registers: 256 threads as 16 x 16, thread (ty, tx) holds rows
// ty + 16 i (i < 4) of the tile, the scores of columns tx + 16 j (j < 4)
// and the output columns tx + 16 c (c < D / 16). A row's max and sum are
// shuffles within a half-warp, and the rescale by exp(m_old - m_new)
// touches only the thread's own registers. The q, k and v tiles are
// converted to float32 once, on their way into shared memory; P goes
// through shared memory between S = Q K^T and acc += P V.
//
// A kv tile that the mask empties for every row of the q tile is skipped
// (in causal mode the tiles past the tile's last row, in window mode also
// those before its first row's window). That is exact: a row that has
// seen only masked scores holds m = -1e30, and its first unmasked score
// multiplies the garbage in l and acc by exp(-1e30 - m_new) = 0. Partly
// masked tiles always run. The wrapper guarantees every row sees a key.
//
// Bound on the card: at the serving shape (4, 1024, 56, 128) causal in
// bfloat16, 60.2 GFLOP against 134 MB, so operations bind (0.061 ms at the
// bf16 tensor-core peak). This first version does its products with
// float32 FMA, no tensor cores, and reads its operands from shared memory
// one float at a time (8 loads per 16 FMA in Q K^T), so shared-memory
// bandwidth, not the FMA pipe, limits it; wgmma on bf16 tiles fed by TMA
// is later work. IEEE expf and division: no --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BKV = 64, NT = 256;
constexpr float kNegInf = -1e30f;

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

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1);
}

// mode: 0 causal, 1 window, 2 full
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int KV, int mode, int window, float scale) {
  constexpr int QS = D + 1;          // padded row stride of the q, k tiles
  constexpr int PS = BKV + 1;        // padded row stride of the P tile
  constexpr int DC = D / 16;         // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][QS]
  float* Ks = Qs + BQ * QS;          // [BKV][QS]
  float* Vs = Ks + BKV * QS;         // [BKV][D]
  float* Ps = Vs + BKV * D;          // [BQ][PS]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_stride = (long long)H * D;     // between positions
  const long long kv_stride = (long long)KV * D;
  const T* qb = q + ((long long)b * Sq * H + h) * D;
  const T* kb = k + ((long long)b * Skv * KV + kvh) * D;
  const T* vb = v + ((long long)b * Skv * KV + kvh) * D;
  T* ob = o + ((long long)b * Sq * H + h) * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D, s = q0 + r;
    Qs[r * QS + c] = s < Sq ? to_f(qb[s * q_stride + c]) : 0.f;
  }

  const int n_kv = (Skv + BKV - 1) / BKV;
  int kt_begin = 0, kt_end = n_kv;
  if (mode != 2) {                   // no key after the tile's last row
    const int q_last = min(q0 + BQ, Sq) - 1;
    kt_end = min(n_kv, q_last / BKV + 1);
  }
  if (mode == 1) {                   // no key at or before q0 - window
    const int first = q0 - window + 1;
    kt_begin = first > 0 ? first / BKV : 0;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();                 // the q tile is stored; P V is done
    for (int e = tid; e < BKV * D; e += NT) {
      const int r = e / D, c = e % D, s = k0 + r;
      const bool in = s < Skv;
      Ks[r * QS + c] = in ? to_f(kb[s * kv_stride + c]) : 0.f;
      Vs[r * D + c] = in ? to_f(vb[s * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool ok = kj < Skv;
        if (mode != 2) ok = ok && kj <= qi;
        if (mode == 1) ok = ok && kj > qi - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)   // the row's 16 threads
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[qi * q_stride + tx + 16 * c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int mode, int window, float scale,
           cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  static bool attr_set = false;      // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_fwd_kernel<T, D><<<grid, NT, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, H, KV, mode,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int H, int KV, int D, int mode, int window,
             float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, KV, mode,
                                  window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KV, mode,
                                  window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KV, mode,
                                  window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KV, mode,
                                    window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mode: 0 causal, 1 window, 2 full.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Skv, int H, int KV, int D, int mode,
                                     int window, float scale, int dtype,
                                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, Sq, Skv, H, KV, D, mode, window,
                           scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, D, mode,
                                   window, scale, s);
  return (int)cudaErrorInvalidValue;
}
