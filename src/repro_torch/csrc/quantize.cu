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
// __fdiv_rn (IEEE, whatever the flags) and rounds with rintf: no reciprocal
// multiply, no roundf, or codes flip at .5 ties. Dequantize is one
// (float)q * scale a value.
//
// Bound on the card: bytes, at 3.35 TB/s. Quantize reads 4 bytes and
// writes 1 a value (plus 4 a row); dequantize reads 1 and writes 4. Neither
// does more than a few operations a byte, far below the H100's ~20 float32
// operations a byte of HBM bandwidth. So each route is about bytes in
// flight and bytes an instruction; kernels/quantize.py::kernel_route picks
// one from the block and the pointers' alignment, and the block size and
// grid:
//
//   vector, 16-byte accesses. Quantize ("rows") is templated on block in
//     {64, 128, 256, 512, 1024}: a warp (a half warp at 64) takes a row,
//     each lane loads block/128 float4s of it, all in flight at once. The
//     absmax is a shuffle reduce over the registers, so the row comes from
//     HBM once; codes leave 4 to a 32-bit store. Dequantize ("stream")
//     walks the flat codes a 4-code word a lane (block % 4 == 0, so a word
//     lies in one row): 2 words and their scales a lane loaded first, then
//     2 float4 stores, each 512 contiguous bytes a warp.
//   generic: any block, any alignment (a view such as buf[k:], rows of
//     int8 codes that are not 4-byte aligned): a warp a row, lanes 4 bytes
//     (quantize) or 1 byte (dequantize) apart: the first port's bodies.
//
// Every launch gives each warp one unit of work (a row, two half rows, or
// 64 words) and the launchers refuse a grid that does not cover the work:
// a grid capped at one wave, each warp walking several units, timed slower
// on the H100 (its last blocks ran alone), and so did bulk (TMA) copies into
// a shared-memory ring (PERF.md §6; tools/kernel_ab.py quant). Offsets are
// 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "repro_errors.h"

namespace {

constexpr int kGeneric = 0, kVector = 1;              // kernels/quantize.py
constexpr int kMaxThreads = 256;                      // a block, at most
constexpr int kWords = 2;                             // stream: words a lane

// Lanes, float4s and rows of the templated quantize bodies.
template <int BLOCK>
struct Rows {
  static constexpr int LPR = BLOCK == 64 ? 16 : 32;    // lanes a row
  static constexpr int V = BLOCK / (4 * LPR);          // float4s a lane a row
  static constexpr int RW = 32 / LPR;                  // rows a warp
};

__device__ __forceinline__ long long warp_id() {
  return (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
}

__device__ __forceinline__ float amax4(float m, float4 v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))),
               fmaxf(fabsf(v.z), fabsf(v.w)));
}
__device__ __forceinline__ uint32_t code(float x, float scale, float qmax) {
  float v = rintf(__fdiv_rn(x, scale));               // half to even
  v = fminf(fmaxf(v, -qmax), qmax);
  return (uint32_t)__float2int_rz(v) & 0xffu;
}
__device__ __forceinline__ uint32_t codes4(float4 v, float scale,
                                           float qmax) {
  return code(v.x, scale, qmax) | code(v.y, scale, qmax) << 8 |
         code(v.z, scale, qmax) << 16 | code(v.w, scale, qmax) << 24;
}
__device__ __forceinline__ float4 dequant4(uint32_t p, float scale) {
  return make_float4((float)(int8_t)(p & 0xffu) * scale,
                     (float)(int8_t)((p >> 8) & 0xffu) * scale,
                     (float)(int8_t)((p >> 16) & 0xffu) * scale,
                     (float)(int8_t)(p >> 24) * scale);
}
// the row of flat code `e`: a shift where block is a power of two
__device__ __forceinline__ long long row_of(long long e, int block,
                                            int shift) {
  return shift >= 0 ? e >> shift : e / block;
}

// One row (or two half-warp rows at block 64) already in registers: the
// absmax over the row's lanes, the scale, packed codes out.
template <int BLOCK>
__device__ __forceinline__ void quantize_row(const float4 (&v)[Rows<BLOCK>::V],
                                             long long row, long long nb,
                                             int sub, int8_t* q, float* s,
                                             float qmax) {
  using S = Rows<BLOCK>;
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < S::V; ++j) m = amax4(m, v[j]);
#pragma unroll
  for (int o = S::LPR / 2; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float scale = fmaxf(__fdiv_rn(m, qmax), 1e-12f);
  if (row < nb) {
    uint32_t* qr = reinterpret_cast<uint32_t*>(q + row * BLOCK);
#pragma unroll
    for (int j = 0; j < S::V; ++j)
      qr[j * S::LPR + sub] = codes4(v[j], scale, qmax);
    if (sub == 0) s[row] = scale;
  }
}

// ------------------------------------------------------------ vector route
template <int BLOCK>
__global__ void __launch_bounds__(kMaxThreads)
quantize_vector(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ s, long long nb, float qmax) {
  using S = Rows<BLOCK>;
  const long long row0 = warp_id() * S::RW;
  if (row0 >= nb) return;                          // warp-uniform
  const int lane = threadIdx.x & 31, sub = lane % S::LPR;
  const long long row = row0 + lane / S::LPR;
  const float4* xr = reinterpret_cast<const float4*>(x + row * BLOCK);
  float4 v[S::V];
#pragma unroll
  for (int j = 0; j < S::V; ++j)                  // the whole row in flight
    v[j] = row < nb ? xr[j * S::LPR + sub] : make_float4(0, 0, 0, 0);
  quantize_row<BLOCK>(v, row, nb, sub, q, s, qmax);
}

__global__ void __launch_bounds__(kMaxThreads)
dequantize_stream(const int8_t* __restrict__ q, const float* __restrict__ s,
                  float* __restrict__ x, long long n, int block, int shift) {
  const long long words = n / 4;                  // 4 codes, one row each
  const long long k0 = warp_id() * 32 * kWords + (threadIdx.x & 31);
  const uint32_t* q4 = reinterpret_cast<const uint32_t*>(q);
  float4* x4 = reinterpret_cast<float4*>(x);
  uint32_t p[kWords];
  float sc[kWords];
#pragma unroll
  for (int u = 0; u < kWords; ++u) {              // every load first
    const long long k = k0 + 32 * u;
    p[u] = k < words ? q4[k] : 0u;
    sc[u] = k < words ? s[row_of(4 * k, block, shift)] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kWords; ++u) {              // 512 bytes a store
    const long long k = k0 + 32 * u;
    if (k < words) x4[k] = dequant4(p[u], sc[u]);
  }
}

// ----------------------------------------------------------- generic route
__global__ void __launch_bounds__(kMaxThreads)
quantize_generic(const float* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ s, long long nb, int block, float qmax) {
  const long long row = warp_id();
  if (row >= nb) return;                           // warp-uniform
  const int lane = threadIdx.x & 31;
  const float* xr = x + row * block;
  float m = 0.f;
  for (int i = lane; i < block; i += 32) m = fmaxf(m, fabsf(xr[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float scale = fmaxf(__fdiv_rn(m, qmax), 1e-12f);
  int8_t* qr = q + row * block;
  for (int i = lane; i < block; i += 32)
    qr[i] = (int8_t)code(xr[i], scale, qmax);
  if (lane == 0) s[row] = scale;
}

__global__ void __launch_bounds__(kMaxThreads)
dequantize_generic(const int8_t* __restrict__ q, const float* __restrict__ s,
                   float* __restrict__ x, long long nb, int block) {
  const long long row = warp_id();
  if (row >= nb) return;
  const int lane = threadIdx.x & 31;
  const float scale = s[row];
  const int8_t* qr = q + row * block;
  float* xr = x + row * block;
  for (int i = lane; i < block; i += 32) xr[i] = (float)qr[i] * scale;
}

// --------------------------------------------------------------- launchers
bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// `grid` blocks of `threads` (a multiple of 32, at most 256) hold at least
// `warps` warps
bool covers(int grid, int threads, long long warps) {
  return grid >= 1 && threads >= 32 && threads <= kMaxThreads &&
         threads % 32 == 0 && (long long)grid * (threads / 32) >= warps;
}

template <int BLOCK>
int launch_rows(const float* x, int8_t* q, float* s, long long nb,
                float qmax, int grid, int threads, cudaStream_t stream) {
  constexpr int RW = Rows<BLOCK>::RW;
  if (!covers(grid, threads, (nb + RW - 1) / RW))
    return (int)cudaErrorInvalidValue;
  quantize_vector<BLOCK><<<grid, threads, 0, stream>>>(x, q, s, nb, qmax);
  return (int)cudaGetLastError();
}

int log2_or_minus1(int block) {
  return (block & (block - 1)) ? -1 : __builtin_ctz(block);
}

}  // namespace

// route 0 generic, 1 vector ("rows"); `grid` blocks of `threads` must give
// every row (or pair of half rows) a warp. A plan or route the inputs do
// not admit (block, alignment) returns cudaErrorInvalidValue, no launch.
extern "C" int repro_quantize_blocks(const float* x, int8_t* q, float* s,
                                     long long nb, int block, float qmax,
                                     int route, int grid, int threads,
                                     void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == kGeneric) {
    if (!covers(grid, threads, nb)) return (int)cudaErrorInvalidValue;
    quantize_generic<<<grid, threads, 0, st>>>(x, q, s, nb, block, qmax);
    return (int)cudaGetLastError();
  }
  if (route != kVector || !aligned(x, 16) || !aligned(q, 4))
    return (int)cudaErrorInvalidValue;
  switch (block) {
    case 64: return launch_rows<64>(x, q, s, nb, qmax, grid, threads, st);
    case 128: return launch_rows<128>(x, q, s, nb, qmax, grid, threads, st);
    case 256: return launch_rows<256>(x, q, s, nb, qmax, grid, threads, st);
    case 512: return launch_rows<512>(x, q, s, nb, qmax, grid, threads, st);
    case 1024: return launch_rows<1024>(x, q, s, nb, qmax, grid, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// route 0 generic, 1 vector ("stream": `grid` blocks of `threads` must give
// every 64 words a warp); as above
extern "C" int repro_dequantize_blocks(const int8_t* q, const float* s,
                                       float* x, long long nb, int block,
                                       int route, int grid, int threads,
                                       void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == kGeneric) {
    if (!covers(grid, threads, nb)) return (int)cudaErrorInvalidValue;
    dequantize_generic<<<grid, threads, 0, st>>>(q, s, x, nb, block);
    return (int)cudaGetLastError();
  }
  const long long n = nb * block;
  if (route != kVector || block % 4 || !aligned(q, 4) || !aligned(x, 16) ||
      !covers(grid, threads, (n / 4 + 32 * kWords - 1) / (32 * kWords)))
    return (int)cudaErrorInvalidValue;
  dequantize_stream<<<grid, threads, 0, st>>>(q, s, x, n, block,
                                              log2_or_minus1(block));
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  if (code == kNoEncoder)
    return "libcuda has no cuTensorMapEncodeTiled (TMA descriptors)";
  if (code == kEncodeFailed)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}
