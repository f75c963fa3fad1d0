// The codec's wire transform: block-scaled int8/int4 quantize and
// dequantize, and the int4 nibble pack and unpack.
//
// Replaces the four Pallas TPU kernels of src/repro/kernels/qpack/kernel.py:
//   qpack_quant_kernel   <- `_quant_kernel`   (quant_flat)
//   qpack_dequant_kernel <- `_dequant_kernel` (dequant_flat)
//   qpack_pack4_kernel   <- `_pack4_kernel`   (pack4_flat)
//   qpack_unpack4_kernel <- `_unpack4_kernel` (unpack4_flat)
// They run on the composed coded sync (IntQuant.encode / decode / roundtrip
// on every leaf the fused sync does not take: TopK + IntQuant chains,
// fused_sync=False, non-f32 leaves).  Every array is row-major and
// contiguous: x and codes (R, N) with N a multiple of the even `block`,
// scales (R, N / block) f16, packed nibbles (R, N / 2) uint8.  Because a
// row holds a whole number of blocks, quantizer tile t starts at element
// t * block of the flat stream, and pack / unpack work on the flat stream.
//
// Bound: bytes, all four.  A handful of operations per element against
// 5 bytes moved (quant: f32 in, int8 out; dequant the reverse) or 1.5
// bytes (pack / unpack).  quant and dequant at the image experiment's
// largest leaf, (5, 2,097,152), move 52.6 MB: 15.7 us at 3.35 TB/s.
//
// Design, simple first: quant gives each (row, block) tile to one warp;
// the lanes stride through the tile with coalesced loads, take the
// max-abs with shuffles, and lane 0 writes the tile's scale.  The tile is
// read a second time for the codes; that read hits the cache.  dequant
// runs one thread per element, pack4 one thread per output byte, unpack4
// one thread per input byte; all grid-stride.  The arithmetic is in
// blockquant.cuh, shared with csrc/qsync.cu, so the composed and the fused
// sync agree bit for bit on the card.
#include <cuda_runtime.h>
#include <cstdint>

#include "blockquant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;  // grid-stride covers the rest

unsigned grid_for(long long work, int per_block) {
  long long blocks = (work + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

__global__ void qpack_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                                   __half* __restrict__ s, long long tiles, int block,
                                   float qmax) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long step = (long long)gridDim.x * warps;
  // t is the same for every lane of a warp, so the shuffles see all 32
  for (long long t = (long long)blockIdx.x * warps + (threadIdx.x >> 5); t < tiles;
       t += step) {
    const float* xt = x + t * block;
    float amax = 0.f;
    for (int i = lane; i < block; i += 32) amax = fmaxf(amax, fabsf(xt[i]));
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const __half sw = wire_scale(amax, qmax);
    const float sd = decode_scale(sw);
    int8_t* qt = q + t * block;
    for (int i = lane; i < block; i += 32) qt[i] = (int8_t)quantize(xt[i], sd, qmax);
    if (lane == 0) s[t] = sw;
  }
}

__global__ void qpack_dequant_kernel(const int8_t* __restrict__ q, const __half* __restrict__ s,
                                     float* __restrict__ out, long long n, int block) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    out[i] = dequantize(q[i], decode_scale(s[i / block]));
  }
}

// Two codes in [-7, 7] per byte, the first in the low nibble.
__global__ void qpack_pack4_kernel(const int8_t* __restrict__ q, uint8_t* __restrict__ p,
                                   long long n_bytes) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n_bytes; j += step) {
    const unsigned lo = (uint8_t)q[2 * j] & 0xFu, hi = (uint8_t)q[2 * j + 1] & 0xFu;
    p[j] = (uint8_t)(lo | (hi << 4));
  }
}

// Each nibble back to a sign-extended int8 code.
__global__ void qpack_unpack4_kernel(const uint8_t* __restrict__ p, int8_t* __restrict__ q,
                                     long long n_bytes) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n_bytes; j += step) {
    const int v = p[j], lo = v & 0xF, hi = v >> 4;
    q[2 * j] = (int8_t)(lo > 7 ? lo - 16 : lo);
    q[2 * j + 1] = (int8_t)(hi > 7 ? hi - 16 : hi);
  }
}

}  // namespace

// x (rows, n) f32 -> codes (rows, n) int8, scales (rows, n / block) f16.
// The caller guarantees n % block == 0 and an even block >= 2.
extern "C" int qpack_quant(const void* x, void* q, void* s, long long rows, long long n,
                           int block, int qmax, void* stream) {
  const long long tiles = rows * (n / block);
  if (tiles > 0) {
    qpack_quant_kernel<<<grid_for(tiles, kThreads / 32), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (int8_t*)q, (__half*)s, tiles, block, (float)qmax);
  }
  return (int)cudaGetLastError();
}

// codes (rows, n) int8 + scales (rows, n / block) f16 -> (rows, n) f32.
extern "C" int qpack_dequant(const void* q, const void* s, void* out, long long rows,
                             long long n, int block, void* stream) {
  const long long total = rows * n;
  if (total > 0) {
    qpack_dequant_kernel<<<grid_for(total, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)q, (const __half*)s, (float*)out, total, block);
  }
  return (int)cudaGetLastError();
}

// codes (2 * n_bytes,) int8 -> packed (n_bytes,) uint8.
extern "C" int qpack_pack4(const void* q, void* p, long long n_bytes, void* stream) {
  if (n_bytes > 0) {
    qpack_pack4_kernel<<<grid_for(n_bytes, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)q, (uint8_t*)p, n_bytes);
  }
  return (int)cudaGetLastError();
}

// packed (n_bytes,) uint8 -> codes (2 * n_bytes,) int8.
extern "C" int qpack_unpack4(const void* p, void* q, long long n_bytes, void* stream) {
  if (n_bytes > 0) {
    qpack_unpack4_kernel<<<grid_for(n_bytes, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)p, (int8_t*)q, n_bytes);
  }
  return (int)cudaGetLastError();
}
