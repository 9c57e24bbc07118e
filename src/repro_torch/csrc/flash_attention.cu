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
// tiles never reach device memory. The TPU kernel walks kv blocks as a
// sequential grid axis and carries m, l and acc in VMEM scratch; here a
// block owns a q tile of one (b, h) and loops over kv tiles itself,
// carrying m, l and acc in registers. The dtype picks one of two kernels.
//
// Tile skipping (both kernels): a kv tile that the mask empties for every
// row of a q tile is skipped (in causal mode the tiles past the tile's last
// row, in window mode also those before its first row's window). That is
// exact: a row that has seen only masked scores holds m = -1e30, and its
// first unmasked score multiplies the garbage in l and acc by
// exp(-1e30 - m_new) = 0. Partly masked tiles always run. The wrapper
// guarantees every row sees a key.
//
// Bound on the card: at the serving shape (4, 1024, 56, 128) causal in
// bfloat16, 60.2 GFLOP against 134 MB, so operations bind (0.061 ms at the
// bf16 tensor-core peak).
//
// bfloat16: wgmma fed by TMA (flash_wgmma_kernel). A block of 288
// threads owns 128 q rows: two consumer warpgroups of 64 rows each and one
// producer warp. The producer issues TMA loads, Q once and K, V tiles of
// 64 keys into a 2-stage ring, each stage with a "full" mbarrier (bytes
// arrived) and an "empty" one (8 consumer warps done). Tensor maps,
// encoded on the host per call, address the strided (B, S, heads, D)
// layouts directly, zero-fill rows past Sq and Skv, and swizzle to the
// wgmma layout: 128 B at D >= 64 (D = 128 as two 64-column panels), 64 B
// at D = 32, 32 B at D = 16. S = Q K^T is wgmma m64n64k16 with both
// operands K-major in shared memory; bf16 products are exact in float32,
// so S matches the reference up to summation order. Mask, row max (over
// the 4 lanes of a quad), exp2 of the scores prescaled by D^-0.5 log2(e),
// and the rescale run on the accumulator fragment in registers; l sums the
// float32 P. P V runs as two register-A wgmmas against V (MN-major):
// P_hi = bf16(P) and P_lo = bf16(P - P_hi), accumulated in float32. A
// single bf16 P rounds P by up to 2^-9 relative, which at run (f)'s shape
// puts some outputs past two bf16 ulps of the float32-P reference; the
// split leaves P's error near 2^-17. So P V costs twice S's tensor work,
// and the kernel does 1.5 times the reference's operations. Registers
// (the fragments: 32 floats of S, D / 2 of O, 32 bf16 pairs of P), not
// shared memory (99 KB at D = 128), hold it to one block an SM. Rows past
// Sq are not stored; a q tile's later consumer warpgroup skips kv tiles
// that are masked for all of its rows, the earlier one those masked for
// its rows, and both wait on and release every stage. Later q tiles,
// which see more keys in causal mode, are launched first.
//
// float32: the first version, kept for float32 inputs (wgmma would round
// them to TF32): one block per (b, h, 64-row q tile), 256 threads as
// 16 x 16, thread (ty, tx) holds rows ty + 16 i (i < 4) of the tile, the
// scores of columns tx + 16 j (j < 4) and the output columns tx + 16 c
// (c < D / 16). A row's max and sum are shuffles within a half-warp, and
// the rescale by exp(m_old - m_new) touches only the thread's own
// registers. The q, k and v tiles are converted to float32 once, on their
// way into shared memory; P goes through shared memory between S = Q K^T
// and acc += P V. Float32 FMA from shared memory, one float at a time (8
// loads per 16 FMA in Q K^T), so shared-memory bandwidth limits it. IEEE
// expf and division: no --use_fast_math.
#include <cuda.h>            // CUtensorMap; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "repro_errors.h"

namespace {

constexpr int BQ = 64, BKV = 64, NT = 256;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
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

// ------------------------------------------------------ bfloat16: wgmma
namespace wg {

constexpr int BQ = 128, WQ = 64, BKV = 64, NSTAGE = 2;
constexpr int NCONSUMER = 256, NTHREADS = NCONSUMER + 32;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: Q (BQ rows), then NSTAGE x (K, V) tiles (BKV rows each),
// then the mbarriers. A tile is D / EPR panels of rows x EPR bf16, one
// ROWB-byte swizzled row per key or query; every panel starts on 1 KB.
template <int D> struct Geo {
  static constexpr int EPR = D < 64 ? D : 64;
  static constexpr int ROWB = EPR * 2;                 // 32, 64 or 128 B
  static constexpr int NPANEL = D / EPR;
  static constexpr int LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int K_OFF = Q_BYTES;                // stage s: K, then V
  static constexpr int BAR_OFF = Q_BYTES + NSTAGE * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * NSTAGE) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// Returns once the barrier's phase of parity `parity` has completed. A
// wait that never ends (a lost load or arrival) traps after 2^24 polls, so
// a fault fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (polls == (1u << 24)) __trap();
  }
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3), "r"(bar) : "memory");
}
// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout (1: 128 B, 2: 64 B,
// 3: 32 B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving reads of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64 float32) (+)= A (64 x 16, smem) * B (16 x 64, smem),
// both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 16 float32) += A (64 x 16 bf16, registers) * B (16 x 16,
// smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32 float32) += A (64 x 16 bf16, registers) * B (16 x 32,
// smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 float32) += A (64 x 16 bf16, registers) * B (16 x 64,
// smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 float32) += A (64 x 16 bf16, registers) * B (16 x 128,
// smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 16) wgmma_rs_n16(acc, a, db);
  else if constexpr (D == 32) wgmma_rs_n32(acc, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(acc, a, db);
  else wgmma_rs_n128(acc, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// kv tiles [*tb, *te) that rows [lo, hi) of a q tile need (empty if none).
__device__ __forceinline__ void tile_range(int lo, int hi, int n_kv, int mode,
                                           int window, int* tb, int* te) {
  *tb = 0;
  *te = hi > lo ? n_kv : 0;
  if (hi <= lo) return;
  if (mode != 2) *te = min(n_kv, (hi - 1) / BKV + 1);
  if (mode == 1) {
    const int first = lo - window + 1;
    *tb = first > 0 ? first / BKV : 0;
  }
}

// mode: 0 causal, 1 window, 2 full
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                   int KV, int mode, int window, float scale) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + G::BAR_OFF;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 8 + 8 * NSTAGE;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // long tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int n_kv = (Skv + BKV - 1) / BKV;
  int tb0, te0, tb1, te1;
  tile_range(q0, min(q0 + WQ, Sq), n_kv, mode, window, &tb0, &te0);
  tile_range(q0 + WQ, min(q0 + BQ, Sq), n_kv, mode, window, &tb1, &te1);
  const int kt_begin = tb0, kt_end = max(te0, te1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONSUMER / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONSUMER) {                           // producer warp
    if (tid == NCONSUMER) {
      mbar_expect_tx(bar_q, G::Q_BYTES);
      for (int p = 0; p < G::NPANEL; ++p)
        tma_load(base + p * BQ * G::ROWB, &tm_q, p * G::EPR, h, q0, b,
                 bar_q);
      for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int s = it % NSTAGE;
        if (it >= NSTAGE) mbar_wait(bar_empty + 8 * s, (it / NSTAGE - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * G::KV_BYTES);
        const uint32_t kd = base + G::K_OFF + s * 2 * G::KV_BYTES;
        for (int p = 0; p < G::NPANEL; ++p) {
          tma_load(kd + p * BKV * G::ROWB, &tm_k, p * G::EPR, kvh, kt * BKV,
                   b, bar_full + 8 * s);
          tma_load(kd + G::KV_BYTES + p * BKV * G::ROWB, &tm_v, p * G::EPR,
                   kvh, kt * BKV, b, bar_full + 8 * s);
        }
      }
    }
    return;
  }

  // consumer warpgroup c: q rows [lo, lo + 64); this thread's rows r0, r1
  const int c = tid / 128, wq = (tid % 128) / 32, lane = tid % 32;
  const int lo = q0 + WQ * c;
  const int r0 = lo + 16 * wq + lane / 4, r1 = r0 + 8;
  const int my_b = c ? tb1 : tb0, my_e = c ? te1 : te0;
  const float sl2 = scale * kLog2e;                 // scores in log2 units
  const uint32_t qa = base + WQ * c * G::ROWB;
  constexpr uint32_t SBO = 8 * G::ROWB;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
  mbar_wait(bar_q, 0);

  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    const int s = it % NSTAGE;
    mbar_wait(bar_full + 8 * s, (it / NSTAGE) & 1);
    if (kt >= my_b && kt < my_e) {
      const uint32_t ka = base + G::K_OFF + s * 2 * G::KV_BYTES;
      const uint32_t va = ka + G::KV_BYTES;
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk * 16 / G::EPR, off = (kk * 16 % G::EPR) * 2;
        wgmma_ss_n64(sc, desc(qa + p * BQ * G::ROWB + off, 16, SBO, G::LAYOUT),
                     desc(ka + p * BKV * G::ROWB + off, 16, SBO, G::LAYOUT),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);

      // scale (log2 units) and mask; fragment: sc[4 j + e] is row e < 2 ?
      // r0 : r1, key k0 + 8 j + 2 (lane % 4) + e % 2
      const int k0 = kt * BKV;
      const bool need_mask = k0 + BKV > Skv ||
                             (mode != 2 && k0 + BKV - 1 > lo) ||
                             (mode == 1 && k0 <= lo + WQ - 1 - window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = sc[4 * j + e] * sl2;
          if (need_mask) {
            const int col = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
            const int row = e < 2 ? r0 : r1;
            bool ok = col < Skv;
            if (mode != 2) ok = ok && col <= row;
            if (mode == 1) ok = ok && col > row - window;
            v = ok ? v : -1e30f;
          }
          sc[4 * j + e] = v;
        }
      float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {        // the row's quad
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float s0 = 0.f, s1 = 0.f;
      uint32_t ph[16], pl[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {                // i: pair (2i, 2i + 1)
        const float mn = (i & 1) ? mn1 : mn0;
        const float pa = exp2f(sc[2 * i] - mn), pb = exp2f(sc[2 * i + 1] - mn);
        if (i & 1) s1 += pa + pb; else s0 += pa + pb;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(pa, pb);
        const float2 hf = __bfloat1622float2(hi);
        ph[i] = bf16x2_bits(hi);
        pl[i] = bf16x2_bits(__floats2bfloat162_rn(pa - hf.x, pb - hf.y));
      }
      l0 = l0 * c0 + s0;                            // quad-partial sums
      l1 = l1 * c1 + s1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= c0;
        acc[4 * j + 1] *= c0;
        acc[4 * j + 2] *= c1;
        acc[4 * j + 3] *= c1;
      }
      // the S fragment of keys 16 kk .. 16 kk + 15 is the A fragment of
      // P V's k-step kk: registers 4 kk .. 4 kk + 3 of ph / pl
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t db = desc(va + kk * 16 * G::ROWB, BKV * G::ROWB, SBO,
                                 G::LAYOUT);
        const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                                ph[4 * kk + 3]};
        const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                                pl[4 * kk + 3]};
        wgmma_pv<D>(acc, ah, db);
        wgmma_pv<D>(acc, al, db);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const long long qs = (long long)H * D;
  __nv_bfloat16* ob = o + ((long long)b * Sq * H + h) * D + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * qs + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * qs + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, seq, heads, D) bf16 tensor, boxes of rows x EPR of one (b, head).
template <int D>
int encode(CUtensorMap* map, const void* ptr, int B, int seq, int heads,
           int rows) {
  using G = Geo<D>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)seq * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::EPR, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = G::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : G::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int mode, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = encode<D>(&tq, q, B, Sq, H, BQ);
  if (rc == 0) rc = encode<D>(&tk, k, B, Skv, KV, BKV);
  if (rc == 0) rc = encode<D>(&tv, v, B, Skv, KV, BKV);
  if (rc != 0) return rc;
  constexpr int bytes = Geo<D>::SMEM;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_wgmma_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, Sq, Skv, H, KV, mode, window, scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int H, int KV, int D, int mode, int window,
             float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, Sq, Skv, H, KV, mode, window,
                               scale, s);
    case 32: return launch<32>(q, k, v, o, B, Sq, Skv, H, KV, mode, window,
                               scale, s);
    case 64: return launch<64>(q, k, v, o, B, Sq, Skv, H, KV, mode, window,
                               scale, s);
    case 128: return launch<128>(q, k, v, o, B, Sq, Skv, H, KV, mode, window,
                                 scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wg
}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel). mode: 0
// causal, 1 window, 2 full. Non-zero return: a cudaError_t, or
// kNoEncoder / kEncodeFailed for the bf16 tensor maps.
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
    return wg::dispatch(q, k, v, o, B, Sq, Skv, H, KV, D, mode, window,
                        scale, s);
  return (int)cudaErrorInvalidValue;
}
