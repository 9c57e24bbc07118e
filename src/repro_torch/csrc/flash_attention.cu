// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_kernel (flash_attention_pallas) of
// src/repro/kernels/flash_attention.py: q (B, Sq, H, D), k (B, Skv, KV, D)
// and v (B, Skv, KV, Dv), float32 or bfloat16; the output is (B, Sq, H,
// Dv), as the TPU kernel's (it takes Dv = v.shape[-1] apart from D). Head h
// reads kv head h / G with G = H / KV, so K and V are never replicated.
// The (D, Dv) pairs instantiated are D = Dv in {16, 32, 64, 128, 256},
// (96, 64) (minicpm3-4b's MLA heads: q/k 64 + 32, v 64) and (96, 96)
// (phi-3's heads). Scores are float32,
// scaled (by D^-0.5 unless the caller gives a scale), capped to
// tanh(s / softcap) * softcap when softcap > 0, and masked to -1e30 (kv
// padding k < Skv; causal k <= q; window k > q - window, with query row i
// at position q = i + q_offset among the keys), in the reference's order
// (models/attention.py:100-111); the online softmax (m, l, acc) runs over kv
// tiles in float32 and the output, acc / max(l, 1e-30), is written in q's
// type. Like the reference, the (q tile x kv tile) score and probability
// tiles never reach device memory. The TPU kernel walks kv blocks as a
// sequential grid axis and carries m, l and acc in VMEM scratch; here a
// block owns a q tile of one (b, h) and loops over kv tiles itself,
// carrying m, l and acc in registers. The dtype picks one of two kernels.
//
// Tile skipping (both kernels): a kv tile that the mask empties for every
// row of a q tile is skipped (in causal mode the tiles past the tile's last
// row, in window mode also those before its first row's window; both
// bounds are taken at the rows' positions, row + q_offset, so a chunk of
// queries at the end of a longer cache keeps every live tile). That is
// exact: a row that has seen only masked scores holds m = -1e30, and its
// first unmasked score multiplies the garbage in l and acc by
// exp(-1e30 - m_new) = 0. Partly masked tiles always run. The wrapper
// guarantees every row sees a key.
//
// Bound on the card: at the serving shape (4, 1024, 56, 128) causal in
// bfloat16, 60.2 GFLOP against 134 MB, so operations bind (0.061 ms at the
// bf16 tensor-core peak); at MLA's (4, 1024, 40, 96 / 64), 26.9 GFLOP
// against 105 MB, so bytes bind (0.031 ms).
//
// bfloat16: wgmma fed by TMA (flash_wgmma_kernel). Persistent: at most
// one block an SM, each walking work items (a q tile of 128 rows of one
// (b, h); later q tiles, which see more keys in causal mode, first) in a
// stride of the grid, so that the producer loads the next item's Q (two
// Q buffers) and kv tiles while the consumers finish the last one. A block
// of 288 threads: two consumer warpgroups of 64 rows each and one producer
// warp. The producer issues TMA loads, Q once an item and K, V tiles of
// BKV keys into a ring of NSTAGE stages (4; 3 at D = 256), each stage
// with a "full" mbarrier (bytes arrived) and an "empty" one (8 consumer
// warps done), the ring's position running on over items. Tensor maps,
// encoded on the host per call and per operand, address the strided (B,
// S, heads, width) layouts directly, zero-fill rows past Sq and Skv, and
// swizzle to the wgmma layout: Q and K follow D, V and O follow Dv. A
// width that is a multiple of 64 is 64-column panels at 128 B; 96 (no
// whole 64-column panels) is three 32-column panels at 64 B; 32 one panel
// at 64 B, 16 one at 32 B. S = Q K^T is wgmma m64nBKVk16 with both
// operands K-major in shared memory (D / 16 k-steps: 6 at D 96); bf16
// products are exact in float32, so S matches the reference up to
// summation order. Mask, row max (over the 4 lanes of a quad), exp2 of the
// scores prescaled by scale * log2(e) (with a cap, tanh(s * scale /
// softcap) * softcap * log2(e); the capped and uncapped bodies are
// separate instantiations, so an uncapped call runs no tanh), and the
// rescale run on the accumulator fragment in registers; l sums the
// float32 P. P V runs as two register-A wgmmas against V (MN-major, N =
// Dv: m64n64k16 at Dv 64, m64n96k16 at Dv 96): P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), accumulated in float32. A single bf16 P rounds P
// by up to 2^-9 relative, which puts outputs past two bf16 ulps of the
// float32-P reference (2.76 times FLASH_BF16_TOL at run (r)'s shape on the
// card); the split leaves P's error near 2^-17. So P V costs twice its
// tensor work: 2 D + 4 Dv operations a score against 2 D + 2 Dv.
//
// The consumer loop is software-pipelined so that exp2 and the rest of
// the softmax run under tensor work. At kv tile j a warpgroup issues S_j =
// Q K_j^T and then P_{j-1} V_{j-1} (the previous tile's product, whose P
// it already holds in registers), waits for S_j alone and runs tile j's
// softmax while P_{j-1} V_{j-1} is still on the tensor cores; then it
// waits for that, releases tile j-1's stage, rescales O and splits P_j.
// O sees the same sequence of rescales and sums as without the pipeline
// (acc *= f_j follows P_{j-1} V_{j-1} and precedes P_j V_j). Each phase of
// the loop (an item's first tile, the steady state, the last P V) is
// straight-line code around its wgmmas, and the warpgroup's index comes
// from a warp shuffle: ptxas serializes the wgmmas otherwise (C7514,
// C7520). The two consumer warpgroups take turns to issue their products
// (two "turn" mbarriers, warpgroup 0 first, whose waits trap rather than
// hang): one warpgroup's products run while the other runs its softmax.
// Registers bound the tile: a consumer thread holds S (BKV / 2 floats),
// P_hi and P_lo (BKV / 4 words each) and O (Dv / 2 floats) at once, and
// 9 warps on the SM's four 16,384-register quarters leave it 168, so
// BKV is 96 at Dv <= 64 and 64 above. Rows past Sq are
// not stored; a q tile's later consumer warpgroup skips kv tiles that are
// masked for all of its rows, the earlier one those masked for its rows,
// and both wait on and release every stage and take every turn. At D =
// 256 (the local attention of recurrentgemma-9b) a 64-row O would take 128
// registers a thread, so a block owns 64 q rows and its two consumer
// warpgroups split O's columns (128 each), each computing the whole S:
// QK^T's tensor work doubles, and shared memory holds one Q (32 KB) and
// three stages of K and V (192 KB).
//
// What bounds it (tools/kernel_ab.py flash, the H100 at run (r)'s shape):
// neither the tensor cores nor memory. The softmax's instructions (about 7
// a score beside one exp2, the split included) on 2 warps a scheduler
// take about a third of the time; the split's second product about a
// tenth; a wider kv tile, a deeper ring or no turns change nothing.
//
// float32: the first version, kept for float32 inputs (wgmma would round
// them to TF32): one block per (b, h, 64-row q tile), 256 threads as
// 16 x 16, thread (ty, tx) holds rows ty + 16 i (i < 4) of the tile, the
// scores of columns tx + 16 j (j < 4) and the output columns tx + 16 c
// (c < Dv / 16). A row's max and sum are shuffles within a half-warp, and
// the rescale by exp(m_old - m_new) touches only the thread's own
// registers. The q, k and v tiles are converted to float32 once, on their
// way into shared memory; P goes through shared memory between S = Q K^T
// and acc += P V. Float32 FMA from shared memory, one float at a time (8
// loads per 16 FMA in Q K^T), so shared-memory bandwidth limits it. IEEE
// expf and division: no --use_fast_math. At D = 256 its tiles take 213,760
// B of shared memory (the opt-in allows 232,448).
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

template <int D, int DV>
constexpr int smem_floats() {
  return BQ * (D + 1) + BKV * (D + 1) + BKV * DV + BQ * (BKV + 1);
}

// mode: 0 causal, 1 window, 2 full; CAP: softcap > 0 (a template flag, as
// in the bf16 kernel, so an uncapped instantiation carries no tanh)
template <typename T, int D, int DV, bool CAP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int KV, int mode, int window, int q_offset,
                 float scale, float softcap) {
  constexpr int QS = D + 1;          // padded row stride of the q, k tiles
  constexpr int PS = BKV + 1;        // padded row stride of the P tile
  constexpr int DC = DV / 16;        // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][QS]
  float* Ks = Qs + BQ * QS;          // [BKV][QS]
  float* Vs = Ks + BKV * QS;         // [BKV][DV]
  float* Ps = Vs + BKV * DV;         // [BQ][PS]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_stride = (long long)H * D;     // between positions
  const long long k_stride = (long long)KV * D;
  const long long v_stride = (long long)KV * DV;
  const long long o_stride = (long long)H * DV;
  const T* qb = q + ((long long)b * Sq * H + h) * D;
  const T* kb = k + ((long long)b * Skv * KV + kvh) * D;
  const T* vb = v + ((long long)b * Skv * KV + kvh) * DV;
  T* ob = o + ((long long)b * Sq * H + h) * DV;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D, s = q0 + r;
    Qs[r * QS + c] = s < Sq ? to_f(qb[s * q_stride + c]) : 0.f;
  }

  const int n_kv = (Skv + BKV - 1) / BKV;
  int kt_begin = 0, kt_end = n_kv;
  if (mode != 2) {                   // no key after the tile's last row
    const int q_last = min(q0 + BQ, Sq) - 1 + q_offset;
    kt_end = min(n_kv, q_last / BKV + 1);
  }
  if (mode == 1) {                   // no key at or before q0 - window
    const int first = q0 + q_offset - window + 1;
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
      Ks[r * QS + c] = s < Skv ? to_f(kb[s * k_stride + c]) : 0.f;
    }
    for (int e = tid; e < BKV * DV; e += NT) {
      const int r = e / DV, c = e % DV, s = k0 + r;
      Vs[r * DV + c] = s < Skv ? to_f(vb[s * v_stride + c]) : 0.f;
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
      const int qi = q0 + ty + 16 * i + q_offset;    // the row's position
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool ok = kj < Skv;
        if (mode != 2) ok = ok && kj <= qi;
        if (mode == 1) ok = ok && kj > qi - window;
        float x = s[i][j] * scale;
        if constexpr (CAP) x = tanhf(x / softcap) * softcap;
        s[i][j] = ok ? x : kNegInf;
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
      for (int c = 0; c < DC; ++c) vv[c] = Vs[j * DV + tx + 16 * c];
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
      ob[qi * o_stride + tx + 16 * c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int D, int DV, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int mode, int window, int q_offset,
           float scale, float softcap, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D, DV>() * (int)sizeof(float);
  static bool attr_set = false;      // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, DV, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_fwd_kernel<T, D, DV, CAP><<<grid, NT, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, H, KV, mode,
      window, q_offset, scale, softcap);
  return (int)cudaGetLastError();
}

#define REPRO_FLASH_ARGS \
  q, k, v, o, B, Sq, Skv, H, KV, mode, window, q_offset, scale, softcap, s

// the (D, Dv) pairs both kernels instantiate, as one switch key
constexpr int pair_key(int d, int dv) { return d * 1024 + dv; }

template <typename T, bool CAP>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int H, int KV, int D, int Dv, int mode,
             int window, int q_offset, float scale, float softcap,
             cudaStream_t s) {
  switch (pair_key(D, Dv)) {
    case pair_key(16, 16): return launch<T, 16, 16, CAP>(REPRO_FLASH_ARGS);
    case pair_key(32, 32): return launch<T, 32, 32, CAP>(REPRO_FLASH_ARGS);
    case pair_key(64, 64): return launch<T, 64, 64, CAP>(REPRO_FLASH_ARGS);
    case pair_key(96, 64): return launch<T, 96, 64, CAP>(REPRO_FLASH_ARGS);
    case pair_key(96, 96): return launch<T, 96, 96, CAP>(REPRO_FLASH_ARGS);
    case pair_key(128, 128):
      return launch<T, 128, 128, CAP>(REPRO_FLASH_ARGS);
    case pair_key(256, 256):
      return launch<T, 256, 256, CAP>(REPRO_FLASH_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------ bfloat16: wgmma
namespace wg {

constexpr int BQ = 128, WQ = 64;
constexpr int NCONSUMER = 256, NTHREADS = NCONSUMER + 32;
constexpr float kLog2e = 1.4426950408889634f;

// An operand W bf16 columns wide in shared memory: W / EPR panels of
// rows x EPR, one ROWB-byte swizzled row per key or query; every panel
// starts on 1 KB. 64-column panels at 128 B where W is a multiple of 64;
// 96 as three 32-column panels at 64 B; 32 and 16 one panel each.
template <int W> struct Panels {
  static constexpr int EPR = W % 64 == 0 ? 64 : W < 64 ? W : 32;
  static constexpr int ROWB = EPR * 2;                 // 32, 64 or 128 B
  static constexpr int NPANEL = W / EPR;
  static constexpr int LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr uint32_t SBO = 8 * ROWB;            // 8-row groups
  static_assert(NPANEL * EPR == W, "a width of whole panels");
};

// Shared memory: NQ Q buffers (BQT rows x D), then NSTAGE x (K (BKV x D),
// V (BKV x Dv)), then the mbarriers. A kv tile is BKV keys, as many as
// the registers allow: a consumer thread holds S (BKV / 2 floats), P_hi
// and P_lo (BKV / 4 words each) and O (DO / 2 floats) at once, and 9 warps
// on the SM's four 16,384-register quarters leave it 168 (3 warps share a
// quarter). So BKV is 96 at Dv <= 64 (128 registers of fragments), else
// 64 (Dv 96: 112; D 128, and D 256 whose consumers hold 128 columns each:
// 128); 80 keys at Dv 96 fit too but ran slower than 64 at run (y).
// SPLIT (D = Dv = 256): a 64 x 256 float32 O is
// 128 registers a thread, which with S and P would not fit beside the
// producer warp, so both consumer warpgroups take the same 64 q rows (BQT
// = 64), each computes the whole S (identical instructions on identical
// tiles, so identical m and l) and accumulates its own DO = 128 output
// columns, as at D = 128.
template <int D, int DV> struct Geo {
  using QK = Panels<D>;
  using V = Panels<DV>;
  static constexpr bool SPLIT = DV > 128;
  static constexpr int BQT = SPLIT ? WQ : BQ;          // q rows a block
  static constexpr int DO = SPLIT ? DV / 2 : DV;       // O columns a consumer
  static constexpr int BKV = DV <= 64 ? 96 : 64;      // keys a kv tile
  static constexpr int NSTAGE = SPLIT ? 3 : 4;
  static constexpr int NQ = SPLIT ? 1 : 2;             // Q buffers
  static constexpr int Q_BYTES = BQT * D * 2;
  static constexpr int K_BYTES = BKV * D * 2;
  static constexpr int V_BYTES = BKV * DV * 2;
  static constexpr int STAGE = K_BYTES + V_BYTES;      // stage s: K, then V
  static constexpr int K_OFF = NQ * Q_BYTES;
  static constexpr int BAR_OFF = K_OFF + NSTAGE * STAGE;
  // NQ Q full and empty, NSTAGE full and empty, two turns; 1 KB to align
  // the base
  static constexpr int SMEM = BAR_OFF + 8 * (2 * NQ + 2 * NSTAGE + 2) + 1024;
  static_assert(SMEM <= 232448, "the opt-in shared memory of an SM");
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
// Returns once at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
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

// d (64 x 96 float32) (+)= A (64 x 16, smem) * B (16 x 96, smem),
// both K-major.
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
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

// d (64 x 96 float32) += A (64 x 16 bf16, registers) * B (16 x 96,
// smem, MN-major: three 32-column panels LBO apart).
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
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

// acc (64 x N) += P (registers) * V's N columns at db; N = Geo::DO
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&acc)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(acc, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(acc, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(acc, a, db);
  else if constexpr (N == 96) wgmma_rs_n96(acc, a, db);
  else wgmma_rs_n128(acc, a, db);
}

// Issues S = Q K^T for one kv tile: D / 16 k-steps over Q's rows at qa
// and the tile's BKV keys at ka (K-major, Q and K panels of G::QK).
template <class G, int D>
__device__ __forceinline__ void issue_qk(float (&sc)[G::BKV / 2], uint32_t qa,
                                         uint32_t ka) {
  using P = typename G::QK;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk * 16 / P::EPR, off = (kk * 16 % P::EPR) * 2;
    const uint64_t da = desc(qa + p * G::BQT * P::ROWB + off, 16, P::SBO,
                             P::LAYOUT);
    const uint64_t db = desc(ka + p * G::BKV * P::ROWB + off, 16, P::SBO,
                             P::LAYOUT);
    if constexpr (G::BKV == 96) wgmma_ss_n96(sc, da, db, kk > 0);
    else wgmma_ss_n64(sc, da, db, kk > 0);
  }
}

// Issues acc += P_hi V + P_lo V for one kv tile whose V columns for this
// warpgroup start at va (MN-major, panels of G::V, LBO a panel apart).
// The S fragment of keys 16 kk .. 16 kk + 15 is the A fragment of P V's
// k-step kk: registers 4 kk .. 4 kk + 3 of ph / pl.
template <class G>
__device__ __forceinline__ void issue_pv(float (&acc)[G::DO / 2],
                                         const uint32_t (&ph)[G::BKV / 4],
                                         const uint32_t (&pl)[G::BKV / 4],
                                         uint32_t va) {
  using P = typename G::V;
#pragma unroll
  for (int kk = 0; kk < G::BKV / 16; ++kk) {
    const uint64_t db = desc(va + kk * 16 * P::ROWB, G::BKV * P::ROWB,
                             P::SBO, P::LAYOUT);
    const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                            ph[4 * kk + 3]};
    const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                            pl[4 * kk + 3]};
    wgmma_pv<G::DO>(acc, ah, db);
    wgmma_pv<G::DO>(acc, al, db);
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// kv tiles of bkv keys [*tb, *te) that rows [lo, hi) of a q tile need
// (empty if none); row i sits at position i + qo among the keys.
__device__ __forceinline__ void tile_range(int lo, int hi, int qo, int n_kv,
                                           int mode, int window, int bkv,
                                           int* tb, int* te) {
  *tb = 0;
  *te = hi > lo ? n_kv : 0;
  if (hi <= lo) return;
  if (mode != 2) *te = min(n_kv, (hi - 1 + qo) / bkv + 1);
  if (mode == 1) {
    const int first = lo + qo - window + 1;
    *tb = first > 0 ? first / bkv : 0;
  }
}

// mode: 0 causal, 1 window, 2 full. CAP: softcap > 0, a template flag so
// that the instantiations without the cap carry no tanh (D 256 is near
// the register limit).
template <int D, int DV, bool CAP>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, int B, int Sq, int Skv,
                   int H, int KV, int mode, int window, int qo, float scale,
                   float softcap) {
  using G = Geo<D, DV>;
  using PQ = typename G::QK;
  using PV = typename G::V;
  constexpr int NS = G::NSTAGE, NQ = G::NQ, BKV = G::BKV;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_qfull = base + G::BAR_OFF, bar_qempty = bar_qfull + 8 * NQ;
  const uint32_t bar_full = bar_qempty + 8 * NQ, bar_empty = bar_full + 8 * NS;
  const uint32_t bar_turn = bar_empty + 8 * NS;     // one a warpgroup

  const int tid = threadIdx.x;
  const int n_kv = (Skv + BKV - 1) / BKV;
  const int n_qt = (Sq + G::BQT - 1) / G::BQT, n_items = n_qt * H * B;
  // work item w: q tile n_qt - 1 - w / (H B) (later tiles, which see more
  // keys in causal mode, first), head w % H, batch w / H % B; this block
  // takes items blockIdx.x, blockIdx.x + gridDim.x, ...; each warpgroup's
  // kv tiles [tb, te), the item's their union
  auto item = [&](int w, int* q0, int* h, int* b, int* tb0, int* te0,
                  int* tb1, int* te1) {
    *q0 = (n_qt - 1 - w / (H * B)) * G::BQT;
    *h = w % H;
    *b = w / H % B;
    tile_range(*q0, min(*q0 + WQ, Sq), qo, n_kv, mode, window, BKV, tb0,
               te0);
    if (G::SPLIT) {                                 // the same rows
      *tb1 = *tb0;
      *te1 = *te0;
    } else {
      tile_range(*q0 + WQ, min(*q0 + BQ, Sq), qo, n_kv, mode, window, BKV,
                 tb1, te1);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < NQ; ++i) {
      mbar_init(bar_qfull + 8 * i, 1);
      mbar_init(bar_qempty + 8 * i, NCONSUMER / 32);
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONSUMER / 32);
    }
    mbar_init(bar_turn, 4);                         // a warpgroup's warps
    mbar_init(bar_turn + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warp's index, broadcast from lane 0 so that ptxas sees it (and
  // every branch on it) warp-uniform; a wgmma it cannot prove uniform it
  // serializes (C7520)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  if (warp >= NCONSUMER / 32) {                     // producer warp
    if (tid == NCONSUMER) {
      // g: the ring position, over every kv tile of every item in turn
      for (int w = blockIdx.x, n = 0, g = 0; w < n_items;
           w += gridDim.x, ++n) {
        int q0, h, b, tb0, te0, tb1, te1;
        item(w, &q0, &h, &b, &tb0, &te0, &tb1, &te1);
        const int kvh = h / (H / KV), qb = n % NQ;
        if (n >= NQ) mbar_wait(bar_qempty + 8 * qb, (n / NQ - 1) & 1);
        mbar_expect_tx(bar_qfull + 8 * qb, G::Q_BYTES);
        for (int p = 0; p < PQ::NPANEL; ++p)
          tma_load(base + qb * G::Q_BYTES + p * G::BQT * PQ::ROWB, &tm_q,
                   p * PQ::EPR, h, q0, b, bar_qfull + 8 * qb);
        for (int kt = tb0; kt < max(te0, te1); ++kt, ++g) {
          const int s = g % NS;
          if (g >= NS) mbar_wait(bar_empty + 8 * s, (g / NS - 1) & 1);
          mbar_expect_tx(bar_full + 8 * s, G::STAGE);
          const uint32_t kd = base + G::K_OFF + s * G::STAGE;
          for (int p = 0; p < PQ::NPANEL; ++p)
            tma_load(kd + p * BKV * PQ::ROWB, &tm_k, p * PQ::EPR, kvh,
                     kt * BKV, b, bar_full + 8 * s);
          for (int p = 0; p < PV::NPANEL; ++p)
            tma_load(kd + G::K_BYTES + p * BKV * PV::ROWB, &tm_v,
                     p * PV::EPR, kvh, kt * BKV, b, bar_full + 8 * s);
        }
      }
    }
    return;
  }

  // consumer warpgroup c: q rows [lo, lo + 64) of each item's q tile and O
  // columns [c0, c0 + DO); this thread's rows r0, r1
  const int c = warp / 4, wq = warp % 4, lane = tid % 32;
  const int c0 = G::SPLIT ? G::DO * c : 0;
  const float sl2 = scale * kLog2e;                 // scores in log2 units
  const float cl2 = softcap * kLog2e;               // the cap, in log2 units
  const uint32_t v_col = G::K_BYTES + (c0 / PV::EPR) * BKV * PV::ROWB;
  const uint32_t my_turn = bar_turn + 8 * c, next_turn = bar_turn + 8 * !c;
  int lo, r0, r1;                                   // of the current item

  float acc[G::DO / 2];
  float m0, m1, l0, l1;
  float sc[BKV / 2];
  uint32_t ph[BKV / 4], pl[BKV / 4];

  // ring position g (the block's g-th kv tile over its items) sits in
  // stage g % NS; every turn and stage is taken in order, the tiles this
  // warpgroup skips too
  auto take_turn = [&](int g) {
    mbar_wait(bar_full + 8 * (g % NS), (g / NS) & 1);
    mbar_wait(my_turn, g & 1);
  };
  auto pass_turn = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(next_turn);
  };
  auto release = [&](int g) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (g % NS));
  };
  auto k_tile = [&](int g) { return base + G::K_OFF + (g % NS) * G::STAGE; };
  // S (in sc, retired) -> P in place, with the row maxima's rescale
  // factors f0, f1 and l updated; sc[4 j + e] is row e < 2 ? r0 : r1, key
  // k0 + 8 j + 2 (lane % 4) + e % 2; rows sit at positions row + qo
  auto softmax = [&](int kt, float& f0, float& f1) {
    reg_fence(sc);
    const int k0 = kt * BKV;
    const bool need_mask = k0 + BKV > Skv ||
                           (mode != 2 && k0 + BKV - 1 > lo + qo) ||
                           (mode == 1 && k0 <= lo + qo + WQ - 1 - window);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v;                                    // scaled, log2 units
        if constexpr (CAP)
          v = tanhf(sc[4 * j + e] * scale / softcap) * cl2;
        else
          v = sc[4 * j + e] * sl2;
        if (need_mask) {
          const int col = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
          const int row = (e < 2 ? r0 : r1) + qo;
          bool ok = col < Skv;
          if (mode != 2) ok = ok && col <= row;
          if (mode == 1) ok = ok && col > row - window;
          v = ok ? v : -1e30f;
        }
        sc[4 * j + e] = v;
      }
    float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {          // the row's quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    f0 = exp2f(m0 - mn0);
    f1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) {             // i: pair (2i, 2i + 1)
      const float mn = (i & 1) ? mn1 : mn0;
      const float pa = exp2f(sc[2 * i] - mn), pb = exp2f(sc[2 * i + 1] - mn);
      if (i & 1) s1 += pa + pb; else s0 += pa + pb;
      sc[2 * i] = pa;
      sc[2 * i + 1] = pb;
    }
    l0 = l0 * f0 + s0;                              // quad-partial sums
    l1 = l1 * f1 + s1;
  };
  // O *= f (P V retired), then P_hi, P_lo of the tile just softmaxed
  auto rescale_split = [&](float f0, float f1) {
#pragma unroll
    for (int j = 0; j < G::DO / 8; ++j) {
      acc[4 * j] *= f0;
      acc[4 * j + 1] *= f0;
      acc[4 * j + 2] *= f1;
      acc[4 * j + 3] *= f1;
    }
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[2 * i],
                                                      sc[2 * i + 1]);
      const float2 hf = __bfloat1622float2(hi);
      ph[i] = bf16x2_bits(hi);
      pl[i] = bf16x2_bits(__floats2bfloat162_rn(sc[2 * i] - hf.x,
                                                sc[2 * i + 1] - hf.y));
    }
  };

  if (c == 1) {                   // warpgroup 0 takes the first turn
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_turn);
  }
  for (int w = blockIdx.x, n = 0, g = 0; w < n_items; w += gridDim.x, ++n) {
    int q0, h, b, tb0, te0, tb1, te1;
    item(w, &q0, &h, &b, &tb0, &te0, &tb1, &te1);
    const int kt_begin = tb0, kt_end = max(te0, te1), qb = n % NQ;
    const int my_b = c ? tb1 : tb0, my_e = c ? te1 : te0;
    lo = q0 + (G::SPLIT ? 0 : WQ * c);
    r0 = lo + 16 * wq + lane / 4;
    r1 = r0 + 8;
    const uint32_t qa = base + qb * G::Q_BYTES + (lo - q0) * PQ::ROWB;
#pragma unroll
    for (int i = 0; i < G::DO / 2; ++i) acc[i] = 0.f;
    m0 = m1 = -1e30f;
    l0 = l1 = 0.f;
    mbar_wait(bar_qfull + 8 * qb, (n / NQ) & 1);
    // this warpgroup's tiles are g + it for it in [a, e) of [0, n_t); each
    // phase below is straight-line code, so that ptxas can match each
    // wgmma.wait_group to its group and leave the products asynchronous
    const int n_t = kt_end - kt_begin;
    const int a = max(my_b, kt_begin) - kt_begin;
    const int e = max(min(my_e, kt_end) - kt_begin, a);
    int it = 0;
    for (; it < a; ++it) {                          // skipped before
      take_turn(g + it);
      pass_turn();
      release(g + it);
    }
    if (a < e) {
      float f0, f1;
      take_turn(g + it);                            // the first tile: S
      wgmma_fence();
      issue_qk<G, D>(sc, qa, k_tile(g + it));
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      softmax(kt_begin + it, f0, f1);
      rescale_split(f0, f1);
      for (++it; it < e; ++it) {                    // S_it, then P V_it-1
        take_turn(g + it);
        wgmma_fence();
        issue_qk<G, D>(sc, qa, k_tile(g + it));
        wgmma_commit();
        issue_pv<G>(acc, ph, pl, k_tile(g + it - 1) + v_col);
        wgmma_commit();
        pass_turn();
        wgmma_wait<1>();                            // S_it, not P V
        softmax(kt_begin + it, f0, f1);
        wgmma_wait<0>();
        reg_fence(acc);
        release(g + it - 1);
        rescale_split(f0, f1);
      }
      // the last tile's P V, in the next tile's turn if there is one
      const bool more = it < n_t;
      if (more) take_turn(g + it);
      wgmma_fence();
      issue_pv<G>(acc, ph, pl, k_tile(g + it - 1) + v_col);
      wgmma_commit();
      if (more) pass_turn();
      wgmma_wait<0>();
      reg_fence(acc);
      release(g + it - 1);
      if (more) release(g + it++);
    }
    for (; it < n_t; ++it) {                        // skipped after
      take_turn(g + it);
      pass_turn();
      release(g + it);
    }
    g += n_t;
    __syncwarp();                                   // this item's Q is free
    if (lane == 0) mbar_arrive(bar_qempty + 8 * qb);

    float s0 = l0, s1 = l1;
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    const float d0 = fmaxf(s0, 1e-30f), d1 = fmaxf(s1, 1e-30f);
    const long long qs = (long long)H * DV;
    __nv_bfloat16* ob =
        o + ((long long)b * Sq * H + h) * DV + c0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < G::DO / 8; ++j) {
      if (r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * qs + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
      if (r1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * qs + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
    }
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

// A (B, seq, heads, W) bf16 tensor, boxes of rows x EPR of one (b, head)
// in Panels<W>'s swizzle.
template <int W>
int encode(CUtensorMap* map, const void* ptr, int B, int seq, int heads,
           int rows) {
  using P = Panels<W>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 2,
                                 (cuuint64_t)heads * W * 2,
                                 (cuuint64_t)seq * heads * W * 2};
  const cuuint32_t box[4] = {(cuuint32_t)P::EPR, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = P::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : P::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

template <int D, int DV, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int mode, int window, int q_offset,
           float scale, float softcap, cudaStream_t stream) {
  using G = Geo<D, DV>;
  CUtensorMap tq, tk, tv;
  int rc = encode<D>(&tq, q, B, Sq, H, G::BQT);
  if (rc == 0) rc = encode<D>(&tk, k, B, Skv, KV, G::BKV);
  if (rc == 0) rc = encode<DV>(&tv, v, B, Skv, KV, G::BKV);
  if (rc != 0) return rc;
  constexpr int bytes = G::SMEM;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<D, DV, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  // persistent: at most one block an SM, each walking its work items
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)((Sq + G::BQT - 1) / G::BQT) * H * B;
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  flash_wgmma_kernel<D, DV, CAP><<<grid, NTHREADS, bytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, B, Sq, Skv, H, KV, mode, window,
      q_offset, scale, softcap);
  return (int)cudaGetLastError();
}

template <bool CAP>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int H, int KV, int D, int Dv, int mode,
             int window, int q_offset, float scale, float softcap,
             cudaStream_t s) {
  switch (pair_key(D, Dv)) {
    case pair_key(16, 16): return launch<16, 16, CAP>(REPRO_FLASH_ARGS);
    case pair_key(32, 32): return launch<32, 32, CAP>(REPRO_FLASH_ARGS);
    case pair_key(64, 64): return launch<64, 64, CAP>(REPRO_FLASH_ARGS);
    case pair_key(96, 64): return launch<96, 64, CAP>(REPRO_FLASH_ARGS);
    case pair_key(96, 96): return launch<96, 96, CAP>(REPRO_FLASH_ARGS);
    case pair_key(128, 128): return launch<128, 128, CAP>(REPRO_FLASH_ARGS);
    case pair_key(256, 256): return launch<256, 256, CAP>(REPRO_FLASH_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wg
}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel). q and k
// are D wide, v and o Dv wide ((D, Dv) one of the pairs dispatch takes).
// mode: 0 causal, 1 window, 2 full; query row i sits at key position i +
// q_offset; softcap > 0 caps the scaled scores. Non-zero return: a
// cudaError_t, or kNoEncoder / kEncodeFailed for the bf16 tensor maps.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Skv, int H, int KV, int D, int Dv,
                                     int mode, int window, int q_offset,
                                     float scale, float softcap, int dtype,
                                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && softcap > 0.f)
    return dispatch<float, true>(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, mode,
                                 window, q_offset, scale, softcap, s);
  if (dtype == 0)
    return dispatch<float, false>(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, mode,
                                  window, q_offset, scale, softcap, s);
  if (dtype == 1 && softcap > 0.f)
    return wg::dispatch<true>(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, mode,
                              window, q_offset, scale, softcap, s);
  if (dtype == 1)
    return wg::dispatch<false>(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, mode,
                               window, q_offset, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
