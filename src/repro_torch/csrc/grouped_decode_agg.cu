// Grouped ragged decode->aggregate for Hopper (sm_90a): every kernel-path
// chunked-AE bucket of a server round in one launch.
//
// Replaces the Pallas TPU kernel _grouped_decode_agg_kernel
// (grouped_fused_decode_agg) of src/repro/kernels/fused_decode_agg.py.
// For each bucket b, with h_b (C_b, M_b, K), weights w_b (C_b,) summing to
// 1 and decoder slot d_b:
//   out_b (M_b, N) = sum_c w_b[c] * (h_b[c] @ W[d_b]) + bias[d_b]
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
//   one row of 8 int64 per row tile, built by the wrapper and copied to the
//   card once per launch plan:
//     [0] address of the tile's first row of h_b, client 0
//     [1] client stride of h_b in floats (M_b * K)
//     [2] address of w_b
//     [3] address of the tile's first output row
//     [4] C_b   [5] rows in the tile   [6] decoder slot   [7] unused
//   The table carries device addresses rather than offsets into one packed
//   h, so the buckets' h tensors are read where the hidden decoder layers
//   wrote them: packing them first would copy all of h (the bulk of the
//   bytes) once more. Empty buckets get no tile.
// * The body is decode_agg_tile (decode_agg_tile.cuh), the same function
//   the per-bucket kernel (fused_decode_agg.cu) runs, so each bucket's
//   grouped result is bit-equal to that kernel launched on the bucket
//   alone.
//
// Bound on the card: bytes. The launch must read every bucket's h once,
// every distinct decoder (K x N + N floats a slot) once, and write each
// out_b once. At the partitioned-AE cohort point of the fl_partition table
// (two rungs of 32 clients, 3,840 chunks of 256, K = 32) that is 31.5 MB of
// h and 7.9 MB of output, ~12 us at 3.35 TB/s, against 2*sum(C_b*M_b*K +
// M_b*K*N) = 0.2 GFLOP, ~3 us of float32 FMA. The wrapper picks the band
// height so that the tiles alone give two blocks per SM where the round
// has enough rows; otherwise it splits the columns as the per-bucket
// kernel does, each split repeating its band's client reduce.
#include <cuda_runtime.h>

#include "decode_agg_tile.cuh"

namespace {

constexpr int kTileWords = 8;

template <int RM>
__global__ void __launch_bounds__(256)
grouped_decode_agg_kernel(const long long* __restrict__ table,
                          const float* __restrict__ W_stack,
                          const float* __restrict__ b_stack, int K, int N,
                          int cols_per_split) {
  const long long* t = table + (long long)blockIdx.x * kTileWords;
  const float* hb = reinterpret_cast<const float*>(t[0]);
  const long long client_stride = t[1];
  const float* wts = reinterpret_cast<const float*>(t[2]);
  float* out = reinterpret_cast<float*>(t[3]);
  const int C = (int)t[4], rows = (int)t[5], slot = (int)t[6];
  const int n_begin = blockIdx.y * cols_per_split;
  const int n_end = min(N, n_begin + cols_per_split);
  decode_agg_tile<RM>(hb, client_stride, wts, C, rows, K,
                      W_stack + (long long)slot * K * N,
                      b_stack + (long long)slot * N, N, n_begin, n_end, out);
}

template <int RM>
int launch(const long long* table, const float* W, const float* b, int T,
           int K, int N, int cols_per_split, cudaStream_t stream) {
  constexpr int bm = 8 * RM;
  const size_t smem = (size_t)bm * K * sizeof(float);
  if (int e = allow_smem(grouped_decode_agg_kernel<RM>, smem)) return e;
  dim3 grid((unsigned)T,
            (unsigned)((N + cols_per_split - 1) / cols_per_split));
  grouped_decode_agg_kernel<RM><<<grid, 256, smem, stream>>>(
      table, W, b, K, N, cols_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// table: (T, 8) int64 on the device; bm in {8, 16, 32, 64} and no tile
// taller than bm; cols_per_split a multiple of 32.
extern "C" int repro_grouped_decode_agg(const long long* table,
                                        const float* W_stack,
                                        const float* b_stack, int T, int K,
                                        int N, int bm, int cols_per_split,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (bm) {
    case 8: return launch<1>(table, W_stack, b_stack, T, K, N, cols_per_split, s);
    case 16: return launch<2>(table, W_stack, b_stack, T, K, N, cols_per_split, s);
    case 32: return launch<4>(table, W_stack, b_stack, T, K, N, cols_per_split, s);
    case 64: return launch<8>(table, W_stack, b_stack, T, K, N, cols_per_split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
