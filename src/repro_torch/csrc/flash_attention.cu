// Flash attention forward: GQA, causal and sliding-window masks, online
// softmax over KV tiles, no backward.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (src/repro/kernels/
// flash_attention/kernel.py), the full-sequence forward and prefill of the
// attention backbones.  q is (B, nh, T, hd), k and v (B, nkv, S, hd), in
// float32 or bfloat16; query head h reads KV head h / (nh / nkv), nothing
// is replicated.  The output is (B, nh, T, hd) in q's type.
//
// Arithmetic, as the reference kernel: scores q.k * (1/sqrt(hd)) and p.v in
// float32; masked scores take NEG_INF = -2^30 (finite, so a row whose
// first tile is all masked gets p = 1 there and alpha = exp(-2^30 - m) = 0
// wipes it at the first valid key); the running max, denominator and
// accumulator are carried over the KV tiles; out = acc / (l == 0 ? 1 : l).
// Masks: kpos < S, causal qpos >= kpos, window qpos - kpos < window when
// window > 0.  KV tiles wholly masked for every row of the query tile are
// skipped, which is exact (they would add 0) and what makes the local
// layers cheaper.
//
// Bound: operations.  At gemma3-4b width (hd = 256, T = 2,000) each score
// and each p.v term is a 256-long dot, about 250 flops per byte of q, k
// and v read, so the tensor-core rate would bound a product on the tensor
// cores.  This first version computes in float32 on the CUDA cores (the
// reference's f32 arithmetic, with exact products of bf16 inputs), so its
// own ceiling is the 67 TFLOP/s float32 rate, and in practice the
// shared-memory loads that feed the FMAs.
//
// Design: one block of 256 threads per (64-query tile, head, batch row).
// The Q tile, one 64-key K tile and V tile are staged in shared memory in
// the input type (bf16 keeps a 64 x 256 tile at 32 KB; float32 at hd 256
// uses 214 KB of the 227 KB a block may take); the Q and K rows are padded
// so that 16 threads reading 16 rows at one column hit 16 banks.  A 16 x 16
// thread grid computes the 64 x 64 score tile, 4 x 4 scores a thread, and
// writes it masked and scaled to shared memory; each warp then runs the
// online softmax of 8 rows with shuffles; the same grid accumulates p.v,
// 4 rows x hd/16 columns a thread in registers.  T and S need not be
// multiples of the tile: rows and keys past the end are zero-filled, masked
// and never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1073741824.0f;  // -2^30, as the reference
constexpr int BQ = 64;                     // query rows of a block
constexpr int BK = 64;                     // keys of a KV tile
constexpr int THREADS = 256;               // a 16 x 16 grid
constexpr int LDS = BK + 1;                // row stride of the score tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Row padding of the Q and K tiles, in elements: an odd stride in 32-bit
// words, so the 16 rows one warp reads at one column sit in 16 banks.
template <typename T> struct Pad { static constexpr int value = 1; };
template <> struct Pad<__nv_bfloat16> { static constexpr int value = 2; };

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return (size_t)(2 * BQ * (HD + Pad<T>::value) + BK * HD) * sizeof(T) +
         (size_t)(BQ * LDS + 3 * BQ) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int nh, int nkv, int T_, int S, float scale, int causal,
          int window) {
  constexpr int LD = HD + Pad<T>::value;
  constexpr int NJ = HD / 16;  // output columns of a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);             // BQ x LD
  T* Ks = Qs + BQ * LD;                                // BK x LD
  T* Vs = Ks + BK * LD;                                // BK x HD
  float* Ss = reinterpret_cast<float*>(Vs + BK * HD);  // BQ x LDS, scores then p
  float* m_s = Ss + BQ * LDS;                          // running max of each row
  float* l_s = m_s + BQ;                               // running denominator
  float* a_s = l_s + BQ;                               // this tile's rescale

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q_start = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (nh / nkv);
  const T* qb = q + ((long long)(b * nh + h) * T_) * HD;
  const T* kb = k + ((long long)(b * nkv + kvh) * S) * HD;
  const T* vb = v + ((long long)(b * nkv + kvh) * S) * HD;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    Qs[r * LD + d] = (q_start + r < T_) ? qb[(long long)(q_start + r) * HD + d] : from_f32<T>(0.f);
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // KV tiles that hold a key some row of this tile may see
  const int q_last = min(q_start + BQ, T_) - 1;
  const int n_tiles = (S + BK - 1) / BK;
  const int kt_hi = causal ? min(n_tiles, q_last / BK + 1) : n_tiles;
  const int kt_lo = window > 0 ? max(0, q_start - window + 1) / BK : 0;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and p are consumed
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < S;
      const long long off = (long long)(k0 + r) * HD + d;
      Ks[r * LD + d] = in ? kb[off] : from_f32<T>(0.f);
      Vs[r * HD + d] = in ? vb[off] : from_f32<T>(0.f);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f32(Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = to_f32(Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q_start + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        bool ok = kpos < S;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        Ss[r * LDS + c] = ok ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w + 7, a lane two columns
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float x0 = Ss[r * LDS + lane], x1 = Ss[r * LDS + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ss[r * LDS + lane] = p0;
      Ss[r * LDS + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], w[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) w[j] = to_f32(Vs[kk * HD + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }
  __syncthreads();  // l_s of the last tile is written

  T* ob = o + ((long long)(b * nh + h) * T_) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q_start + r;
    if (qpos >= T_) continue;
    const float l = l_s[r];
    const float den = l == 0.f ? 1.f : l;
#pragma unroll
    for (int j = 0; j < NJ; ++j) ob[(long long)qpos * HD + tx + 16 * j] = from_f32<T>(acc[i][j] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int nh, int nkv,
           int T_, int S, float scale, int causal, int window, void* stream) {
  constexpr size_t smem = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_ + BQ - 1) / BQ, nh, B);
  flash_fwd<T, HD><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, nh, nkv, T_, S, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int nh, int nkv,
             int T_, int S, int hd, float scale, int causal, int window, void* stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, nh, nkv, T_, S, scale, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, nh, nkv, T_, S, scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, nh, nkv, T_, S, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, nh, nkv, T_, S, scale, causal, window, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, nh, nkv, T_, S, scale, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                                   int nh, int nkv, int T, int S, int hd, float scale,
                                   int causal, int window, void* stream) {
  return dispatch<float>(q, k, v, o, B, nh, nkv, T, S, hd, scale, causal, window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                    int nh, int nkv, int T, int S, int hd, float scale,
                                    int causal, int window, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, nh, nkv, T, S, hd, scale, causal, window,
                                 stream);
}
