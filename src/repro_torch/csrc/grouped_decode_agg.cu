// Grouped ragged decode->aggregate for Hopper (sm_90a): every kernel-path
// chunked-AE bucket of a server round in one launch.
//
// Replaces the Pallas TPU kernel _grouped_decode_agg_kernel
// (grouped_fused_decode_agg) of src/repro/kernels/fused_decode_agg.py.
// For each bucket b, with h_b (C_b, M_b, K), weights w_b (C_b,) summing to
// 1 and its final decoder layer (W_b, bias_b):
//   out_b (M_b, N) = sum_c w_b[c] * (h_b[c] @ W_b) + bias_b
// C_b and M_b are ragged across buckets; K and N are shared.
//
// What changed from the TPU kernel, and why:
//
// * Nothing carries across blocks. The TPU kernel pads every bucket's
//   clients to one cohort-wide count and carries the sum across a
//   sequential client-block grid axis. Here each block loops over its own
//   bucket's C_b clients, so a small bucket reads no padding and no
//   zero-weight client exists.
// * Scalar prefetch becomes a tile table that each block reads itself.
//   The TPU's (3, T) descriptor (bucket, packed row block, decoder) becomes
//   one row of 8 int64 per block, built by the wrapper and copied to the
//   card once per launch plan:
//     [0] address of the tile's first row of h_b, client 0
//     [1] address of w_b
//     [2] address of the tile's first output row
//     [3] address of W_b (K, N)     [4] address of bias_b (N,)
//     [5] client stride of h_b in floats (M_b * K)
//     [6] C_b | rows in the tile << 32
//     [7] route | column tile << 8
//   The table carries device addresses rather than offsets into packed
//   arrays, so the buckets' h tensors are read where the hidden decoder
//   layers wrote them (packing them would copy all of h once more) and
//   each decoder where the caller holds it (stacking them would copy 8 MB
//   a slot at K = 512, N = 4096 every round). Empty buckets get no tile.
// * Each tile carries its bucket's route (decode_agg_tile.cuh): a few_rows
//   bucket (M_b <= 16, K <= 512) takes one block a column tile of W, all
//   of its rows; a bands bucket one block a band of bm rows and a column
//   split. A round that mixes routes is one launch.
// * The bodies are the functions the per-bucket kernel (fused_decode_agg.cu)
//   runs, with the same order of additions for a bucket whatever the
//   launch's band height or row template, so each bucket's grouped result is
//   bit-equal to that kernel launched on the bucket alone.
//
// Bound on the card: bytes. The launch must read every bucket's h once,
// every distinct decoder once, and write each out_b once. At run (d)'s
// round (two rungs of 2 clients, 4 chunks, K = 512, N = 4096, two decoders)
// that is 16.8 MB of W, 5.1 us at 3.35 TB/s; at the partitioned-AE cohort
// point of the fl_partition table (two rungs of 32 clients, 3,840 chunks of
// 256, K = 32) 31.5 MB of h and 7.9 MB of output, ~12 us.
#include <cuda_runtime.h>

#include "decode_agg_tile.cuh"

using namespace decode_agg;

namespace {

constexpr int kTileWords = 8;

// MT: the few_rows template (>= every few_rows tile's rows); bm, cols: the
// bands tiles' height and column split; tpr: the few_rows column tiles.
template <int MT>
__global__ void __launch_bounds__(kThreads, rows_min_blocks<MT>())
grouped_decode_agg_kernel(const long long* __restrict__ table, int K, int N,
                          int bm, int cols_per_split, int tpr) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const long long* t = table + (long long)blockIdx.x * kTileWords;
  const float* hb = reinterpret_cast<const float*>(t[0]);
  const float* wts = reinterpret_cast<const float*>(t[1]);
  float* out = reinterpret_cast<float*>(t[2]);
  const float* W = reinterpret_cast<const float*>(t[3]);
  const float* b = reinterpret_cast<const float*>(t[4]);
  const long long client_stride = t[5];
  const int C = (int)(t[6] & 0xffffffffll), rows = (int)(t[6] >> 32);
  const int route = (int)(t[7] & 0xff), col = (int)(t[7] >> 8);
  if (route == kRows) {
    decode_agg_rows<MT>(hb, client_stride, wts, C, rows, K, W, b, N, tpr,
                        col, out, sm);
  } else {
    const int n_begin = col * cols_per_split;
    decode_agg_band(hb, client_stride, wts, C, rows, bm, K, W, b, N, n_begin,
                    min(N, n_begin + cols_per_split), out, sm);
  }
}

template <int MT>
int launch(const long long* table, int T, int K, int N, int bm, int cols,
           int tpr, cudaStream_t stream) {
  const int rows_f = tpr ? rows_smem_floats(K, MT, tpr) : 0;
  const int band_f = bm ? band_smem_floats(bm, K) : 0;
  const size_t smem = (size_t)(rows_f > band_f ? rows_f : band_f) *
                      sizeof(float);
  if (int e = allow_smem(grouped_decode_agg_kernel<MT>, smem)) return e;
  grouped_decode_agg_kernel<MT><<<T, kThreads, smem, stream>>>(
      table, K, N, bm, cols, tpr);
  return (int)cudaGetLastError();
}

}  // namespace

// table: (T, 8) int64 on the device, one row a block. bm in {8, ..., 64}
// (a multiple of 8; 0 without bands tiles); cols_per_split > 0 with bands
// tiles; tpr a power of two <= 16 (0 without few_rows tiles); mt in
// {4, 8, 16}, at least every few_rows tile's rows.
extern "C" int repro_grouped_decode_agg(const long long* table, int T, int K,
                                        int N, int bm, int cols_per_split,
                                        int tpr, int mt, void* stream) {
  if (bm < 0 || bm > 64 || bm % 8 || (bm && cols_per_split < 1) ||
      tpr < 0 || tpr > kRowsMaxTpr || (tpr & (tpr - 1)) ||
      (tpr && K > kRowsMaxK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mt) {
    case 4: return launch<4>(table, T, K, N, bm, cols_per_split, tpr, s);
    case 8: return launch<8>(table, T, K, N, bm, cols_per_split, tpr, s);
    case 16: return launch<16>(table, T, K, N, bm, cols_per_split, tpr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
