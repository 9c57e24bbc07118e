// Blockwise absmax quantization and its inverse, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quantize.py:
//   _quant_kernel   (quantize_blocks_2d)   -> repro_quantize_blocks
//   _dequant_kernel (dequantize_blocks_2d) -> repro_dequantize_blocks
//
// Quantize, per row of `block` floats:
//   scale = max(max|x| / qmax, 1e-12);  q = clip(rint(x / scale), -qmax, qmax)
// with qmax = 127 (8 bits) or 7 (4 bits). The reference rounds with
// jnp.round (half to even) after a true division, so this file divides with
// IEEE `/` and rounds with rintf: no reciprocal multiply, no roundf, and the
// build must not use --use_fast_math, or codes flip at .5 ties.
//
// Bound on the card: bytes. Quantize reads 4 bytes and writes 1 per value
// (plus 4 per row); dequantize reads 1 and writes 4. Neither does more than
// a few operations per byte, far below the H100's ~20 float32 operations
// per byte of HBM bandwidth. The design therefore only keeps the accesses
// coalesced: one warp per row, lanes striding the row 32 values apart, so
// every warp-wide load is one contiguous 128-byte segment; the row's
// absmax is a warp-shuffle reduction, no shared memory and no second
// kernel. The second pass over the row (to quantize) hits L1/L2, not HBM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "repro_errors.h"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
quantize_rows(const float* __restrict__ x, int8_t* __restrict__ q,
              float* __restrict__ s, long long nb, int block, float qmax) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= nb) return;                  // warp-uniform: whole warp leaves
  const float* xr = x + row * block;
  float m = 0.f;
  for (int i = lane; i < block; i += 32) m = fmaxf(m, fabsf(xr[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float scale = fmaxf(m / qmax, 1e-12f);   // IEEE division
  int8_t* qr = q + row * block;
  for (int i = lane; i < block; i += 32) {
    float v = rintf(xr[i] / scale);               // half to even
    v = fminf(fmaxf(v, -qmax), qmax);
    qr[i] = (int8_t)v;
  }
  if (lane == 0) s[row] = scale;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dequantize_rows(const int8_t* __restrict__ q, const float* __restrict__ s,
                float* __restrict__ x, long long nb, int block) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= nb) return;
  const float scale = s[row];
  const int8_t* qr = q + row * block;
  float* xr = x + row * block;
  for (int i = lane; i < block; i += 32) xr[i] = (float)qr[i] * scale;
}

}  // namespace

extern "C" int repro_quantize_blocks(const float* x, int8_t* q, float* s,
                                     long long nb, int block, float qmax,
                                     void* stream) {
  const long long grid = (nb + kWarpsPerBlock - 1) / kWarpsPerBlock;
  quantize_rows<<<(unsigned)grid, kWarpsPerBlock * 32, 0,
                  (cudaStream_t)stream>>>(x, q, s, nb, block, qmax);
  return (int)cudaGetLastError();
}

extern "C" int repro_dequantize_blocks(const int8_t* q, const float* s,
                                       float* x, long long nb, int block,
                                       void* stream) {
  const long long grid = (nb + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dequantize_rows<<<(unsigned)grid, kWarpsPerBlock * 32, 0,
                    (cudaStream_t)stream>>>(q, s, x, nb, block);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  if (code == kNoEncoder)
    return "libcuda has no cuTensorMapEncodeTiled (TMA descriptors)";
  if (code == kEncodeFailed)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}
