// The codec's wire transform: block-scaled int8/int4 quantize and
// dequantize, and the int4 nibble pack and unpack.
//
// Replaces the four Pallas TPU kernels of src/repro/kernels/qpack/kernel.py:
//   qpack_quant_kernel   <- `_quant_kernel`   (quant_flat)
//   qpack_dequant_vec, qpack_dequant_general
//                        <- `_dequant_kernel` (dequant_flat)
//   qpack_pack4_kernel   <- `_pack4_kernel`   (pack4_flat)
//   qpack_unpack4_kernel <- `_unpack4_kernel` (unpack4_flat)
// (pack4 and unpack4 each a template of two routes, vector and general).
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
// Design: quant gives each (row, block) tile to one warp; the lanes stride
// through the tile with coalesced loads, take the max-abs with shuffles,
// and lane 0 writes the tile's scale.  The tile is read a second time for
// the codes; that read hits the cache.  dequant, pack4 and unpack4 take a
// vector route, one word a thread and the lanes of a warp on consecutive
// words, so that every load and store is contiguous across the warp:
// dequant decodes a 4-byte word of codes into one float4 store; pack4
// packs a 16-byte word of codes into one 8-byte store, masking four codes
// at a time and gathering their nibble pairs with __byte_perm; unpack4 an
// 8-byte word of nibbles into one 16-byte store, sign-extending four
// nibbles at a time with __vsub4 and interleaving them with __byte_perm.
// (16 codes a thread into four float4 stores 64 bytes apart ran dequant
// 1.5x slower at the largest leaf; four words a lane, coalesced, as fast
// there but 1.5x slower on the composed round's small leaves, with 16x
// fewer threads: PERF.md §6.)  A block that 4 does not divide, or a
// misaligned pointer, takes the general route: dequant 16 consecutive
// codes a thread with scalar loads and stores, the tile index stepped at
// each tile boundary; pack4 and unpack4 one byte a thread.  The C entry
// picks the route from the block and the pointers; either is one launch.
// The arithmetic is in blockquant.cuh, shared with csrc/qsync.cu, so the
// composed and the fused sync agree bit for bit on the card.
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

// Codes a thread of dequant's general route decodes.
constexpr int kGroup = 16;

bool aligned(const void* p, uintptr_t bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

// Vector route: block % 4 == 0, q 4-byte and out 16-byte aligned, so the
// stream holds whole words of 4 codes and a word lies in one tile.  One
// word a thread: a warp-wide load reads 128 contiguous bytes, a float4
// store writes 512, and where 128 divides the block the warp's 32 scale
// reads are one address.
__global__ void __launch_bounds__(kThreads)
qpack_dequant_vec(const int* __restrict__ q, const __half* __restrict__ s,
                  float4* __restrict__ out, long long words, int words_per_tile) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x; w < words; w += step) {
    const int c = q[w];
    const float sd = decode_scale(s[w / words_per_tile]);
    out[w] = make_float4(dequantize((signed char)c, sd), dequantize((signed char)(c >> 8), sd),
                         dequantize((signed char)(c >> 16), sd), dequantize(c >> 24, sd));
  }
}

// General route: any even block, any alignment.  16 consecutive codes a
// thread, one division a thread; the tile index steps where the stream
// crosses a tile boundary.
__global__ void __launch_bounds__(kThreads)
qpack_dequant_general(const int8_t* __restrict__ q, const __half* __restrict__ s,
                      float* __restrict__ out, long long n, int block) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kGroup; i0 < n;
       i0 += step * kGroup) {
    long long t = i0 / block, next = (t + 1) * block;
    float sd = decode_scale(s[t]);
    const long long end = i0 + kGroup < n ? i0 + kGroup : n;
    for (long long i = i0; i < end; ++i) {
      if (i == next) {
        sd = decode_scale(s[++t]);
        next += block;
      }
      out[i] = dequantize(q[i], sd);
    }
  }
}

// Two codes a byte, the first in the low nibble, four codes a word: each
// code keeps its low 4 bits (x = w & 0x0F0F0F0F), y = x | (x >> 4) puts
// c0 | c1 << 4 in byte 0 and c2 | c3 << 4 in byte 2, and __byte_perm
// gathers bytes 0 and 2 of two such words into one word of 4 packed bytes.
__device__ __forceinline__ unsigned pair_nibbles(unsigned w) {
  const unsigned x = w & 0x0F0F0F0Fu;
  return x | (x >> 4);
}

__device__ __forceinline__ unsigned pack_words(unsigned a, unsigned b) {
  return __byte_perm(pair_nibbles(a), pair_nibbles(b), 0x6420);
}

// One packed byte, through the same word arithmetic.
__device__ __forceinline__ void pack1(const int8_t* q, uint8_t* p, long long j) {
  const unsigned w = (unsigned)(uint8_t)q[2 * j] | ((unsigned)(uint8_t)q[2 * j + 1] << 8);
  p[j] = (uint8_t)(pack_words(w, 0u) & 0xFFu);
}

// ALIGNED (q 16-byte, p 8-byte aligned): 16 codes a thread from one 16-byte
// load into one 8-byte store of their 8 packed bytes, contiguous across the
// warp (a warp loads 512 bytes and stores 256); the bytes past the last
// whole 8 (all of them when not ALIGNED) go one a thread.
template <bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
qpack_pack4_kernel(const int8_t* __restrict__ q, uint8_t* __restrict__ p, long long n_bytes) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  const long long units = ALIGNED ? n_bytes / 8 : 0;
  for (long long u = tid; u < units; u += threads) {
    const uint4 w = reinterpret_cast<const uint4*>(q)[u];
    reinterpret_cast<uint2*>(p)[u] = make_uint2(pack_words(w.x, w.y), pack_words(w.z, w.w));
  }
  for (long long j = units * 8 + tid; j < n_bytes; j += threads) pack1(q, p, j);
}

// Each nibble back to a sign-extended int8 code, four bytes a word: the
// low and high nibbles of packed word w become the code words
// lo0 hi0 lo1 hi1 and lo2 hi2 lo3 hi3, low nibble first.  A nibble x in a
// byte sign-extends as (x ^ 8) - 8, per byte with no borrow across bytes.
__device__ __forceinline__ unsigned sext_nibbles(unsigned x) {
  return __vsub4(x ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ uint2 unpack_word(unsigned w) {
  const unsigned lo = sext_nibbles(w & 0x0F0F0F0Fu), hi = sext_nibbles((w >> 4) & 0x0F0F0F0Fu);
  return make_uint2(__byte_perm(lo, hi, 0x5140), __byte_perm(lo, hi, 0x7362));
}

// One packed byte, through the same word arithmetic.
__device__ __forceinline__ void unpack1(const uint8_t* p, int8_t* q, long long j) {
  const unsigned v = unpack_word(p[j]).x;
  q[2 * j] = (int8_t)(v & 0xFFu);
  q[2 * j + 1] = (int8_t)((v >> 8) & 0xFFu);
}

// ALIGNED (p 8-byte, q 16-byte aligned): 8 packed bytes a thread from one
// 8-byte load into one 16-byte store of their 16 codes, contiguous across
// the warp; the bytes past the last whole 8 (all of them when not ALIGNED)
// go one a thread.
template <bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
qpack_unpack4_kernel(const uint8_t* __restrict__ p, int8_t* __restrict__ q, long long n_bytes) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  const long long units = ALIGNED ? n_bytes / 8 : 0;
  for (long long u = tid; u < units; u += threads) {
    const uint2 w = reinterpret_cast<const uint2*>(p)[u];
    const uint2 a = unpack_word(w.x), b = unpack_word(w.y);
    reinterpret_cast<uint4*>(q)[u] = make_uint4(a.x, a.y, b.x, b.y);
  }
  for (long long j = units * 8 + tid; j < n_bytes; j += threads) unpack1(p, q, j);
}

template <typename K>
int attrs_of(K kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return 0;
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
// The vector route where 4 divides the block, q is 4-byte and out 16-byte
// aligned, else the general route.
extern "C" int qpack_dequant(const void* q, const void* s, void* out, long long rows,
                             long long n, int block, void* stream) {
  const long long total = rows * n;
  if (total <= 0) return (int)cudaGetLastError();
  if (block % 4 == 0 && aligned(q, 4) && aligned(out, 16)) {
    qpack_dequant_vec<<<grid_for(total / 4, kThreads), kThreads, 0,
                        (cudaStream_t)stream>>>((const int*)q, (const __half*)s, (float4*)out,
                                                total / 4, block / 4);
  } else {
    qpack_dequant_general<<<grid_for(total, kThreads * kGroup), kThreads, 0,
                            (cudaStream_t)stream>>>((const int8_t*)q, (const __half*)s,
                                                    (float*)out, total, block);
  }
  return (int)cudaGetLastError();
}

// codes (2 * n_bytes,) int8 -> packed (n_bytes,) uint8.  The vector route
// where q is 16-byte and p 8-byte aligned, else one byte a thread.
extern "C" int qpack_pack4(const void* q, void* p, long long n_bytes, void* stream) {
  if (n_bytes <= 0) return (int)cudaGetLastError();
  if (aligned(q, 16) && aligned(p, 8)) {
    qpack_pack4_kernel<true><<<grid_for(n_bytes / 8 + 1, kThreads), kThreads, 0,
                               (cudaStream_t)stream>>>((const int8_t*)q, (uint8_t*)p,
                                                       n_bytes);
  } else {
    qpack_pack4_kernel<false><<<grid_for(n_bytes, kThreads), kThreads, 0,
                                (cudaStream_t)stream>>>((const int8_t*)q, (uint8_t*)p,
                                                        n_bytes);
  }
  return (int)cudaGetLastError();
}

// packed (n_bytes,) uint8 -> codes (2 * n_bytes,) int8.  The vector route
// where p is 8-byte and q 16-byte aligned, else one byte a thread.
extern "C" int qpack_unpack4(const void* p, void* q, long long n_bytes, void* stream) {
  if (n_bytes <= 0) return (int)cudaGetLastError();
  if (aligned(p, 8) && aligned(q, 16)) {
    qpack_unpack4_kernel<true><<<grid_for(n_bytes / 8 + 1, kThreads), kThreads, 0,
                                 (cudaStream_t)stream>>>((const uint8_t*)p, (int8_t*)q,
                                                         n_bytes);
  } else {
    qpack_unpack4_kernel<false><<<grid_for(n_bytes, kThreads), kThreads, 0,
                                  (cudaStream_t)stream>>>((const uint8_t*)p, (int8_t*)q,
                                                          n_bytes);
  }
  return (int)cudaGetLastError();
}

// Registers and local (spill) bytes a thread of kernel `which`: 0 quant,
// 1 dequant (vector), 2 dequant (general), 3 pack4 (vector), 4 pack4
// (general), 5 unpack4 (vector), 6 unpack4 (general).
extern "C" int qpack_attrs(int which, int* out) {
  switch (which) {
    case 0: return attrs_of(qpack_quant_kernel, out);
    case 1: return attrs_of(qpack_dequant_vec, out);
    case 2: return attrs_of(qpack_dequant_general, out);
    case 3: return attrs_of(qpack_pack4_kernel<true>, out);
    case 4: return attrs_of(qpack_pack4_kernel<false>, out);
    case 5: return attrs_of(qpack_unpack4_kernel<true>, out);
    case 6: return attrs_of(qpack_unpack4_kernel<false>, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
