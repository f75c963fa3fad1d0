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
// and v read: q.k plus p.v over the unmasked pairs at the 989 TFLOP/s
// bfloat16 tensor-core rate bounds the call.
//
// Two kernels, one per input type.
//
// bfloat16, `flash_fwd_tc` (the backbones' route): q.k and p.v on the
// tensor cores, `mma.sync.m16n8k16` with bf16 operands and float32
// accumulators.  The products of bf16 values are exact and the sums are
// float32, so q.k is what the reference computes.  p is not bf16: the
// reference multiplies v by float32 p.  Rounding p to bf16, as the usual
// flash design does, fails the card test's bound (1e-5 of max |o| plus
// 2^-6 of the element) by 16 to 30x: over about a thousand random keys
// |o| is near |v| / sqrt(S) while the rounding error of p.v grows with
// sum |p v|.  So p is split in two bf16 halves, p_hi = bf16(p) and p_lo =
// bf16(p - p_hi), which keep about 16 of p's bits, and p.v = p_hi.v +
// p_lo.v is two tensor-core products into the same float32 accumulator.
// A CPU emulation of this arithmetic (tests/test_torch_flash.py) puts the
// largest error at 0.47-0.49 of that bound at the card test's shapes, as
// float32 p does, and p in bf16 alone at 16-30 of it; at gemma3-4b's (T =
// 2,000, hd 256) 0.487 and 0.485 at windows 1024 and 0, against 25.1 and
// 30.2 with p in bf16.  The split costs work: the kernel does 1.5x the
// products of the bound (q.k once, p.v twice).
//
// Design: one block of 4 warps per (64-query tile, head, batch row), the
// tiles launched in reverse so the longest causal rows start first.  A warp
// owns 16 query rows.  Q is copied to shared memory once; K and V tiles of
// BK keys (64, or 32 at hd 256 so that two blocks fit on an SM) are
// double-buffered with cp.async, rows past T or S zero-filled.  Shared rows
// are padded by 16 bytes, so the 8 rows an ldmatrix reads sit in 8
// distinct bank groups.  Q and K reach the tensor cores through ldmatrix, V
// through ldmatrix.trans.  The scores stay in registers: the accumulator
// fragment of two 16 x 8 score tiles has the layout of the A fragment of a
// 16 x 16 slice, so p_hi and p_lo go from registers straight into the p.v
// products.  The online softmax runs on the fragments: each thread holds
// two rows' running max (reduced over its quad with shuffles) and its own
// columns' share of the denominator, summed over the quad at the end; p =
// expf(s - m), as the reference's exp.  A warp skips a tile that masks all
// of its rows.  At hd 256 the output accumulator is 128 float32 registers
// a thread; `flash_attention_bf16_attrs` reports the registers, local
// (spill) bytes and blocks per SM of each instantiation.
//
// Next, on the record (ROADMAP): wgmma with p from registers as its A
// operand, TMA loads fed by a producer warp, and reading the model's (B, T,
// nh, hd) layout in place.
//
// float32, `flash_fwd`: float32 FMAs on the CUDA cores (the float32 gate
// allows no bf16 or TF32 rounding), so its ceiling is the 67 TFLOP/s
// float32 rate, and in practice the shared-memory loads that feed the FMAs.
// One block of 256 threads per (64-query tile, head, batch row).  The Q
// tile, one 64-key K tile and V tile are staged in shared memory (214 KB of
// the 227 KB a block may take at hd 256); the Q and K rows are padded so
// that 16 threads reading 16 rows at one column hit 16 banks.  A 16 x 16
// thread grid computes the 64 x 64 score tile, 4 x 4 scores a thread, and
// writes it masked and scaled to shared memory; each warp then runs the
// online softmax of 8 rows with shuffles; the same grid accumulates p.v,
// 4 rows x hd/16 columns a thread in registers.  T and S need not be
// multiples of the tile: rows and keys past the end are zero-filled, masked
// and never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr float NEG_INF = -1073741824.0f;  // -2^30, as the reference
constexpr int BQ = 64;                     // query rows of a block
constexpr int BK = 64;                     // keys of a KV tile
constexpr int THREADS = 256;               // a 16 x 16 grid
constexpr int LDS = BK + 1;                // row stride of the score tile

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// Row padding of the Q and K tiles, in elements: an odd stride in 32-bit
// words, so the 16 rows one warp reads at one column sit in 16 banks.
template <typename T> struct Pad { static constexpr int value = 1; };

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

// ---- bfloat16: flash_fwd_tc, the tensor-core kernel ------------------------
// (fragment layouts: mma_bf16.cuh)

template <int HD>
struct Tc {
  static constexpr int BQ = 64;                   // query rows of a block, 16 a warp
  static constexpr int THREADS = 128;             // 4 warps
  static constexpr int BK = HD >= 256 ? 32 : 64;  // keys of a KV tile
  static constexpr int LD = HD + 8;               // shared row stride: 16 bytes of padding
  static constexpr size_t SMEM = (size_t)(BQ + 4 * BK) * LD * sizeof(__nv_bfloat16);
};

// p -> p_hi = bf16(p), p_lo = bf16(p - p_hi) (the difference is exact in
// float32), for the two adjacent columns one A-fragment register holds
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

// Two blocks an SM leave a thread up to 255 registers: hd 256 takes them all.
template <int HD>
__global__ void __launch_bounds__(Tc<HD>::THREADS, 2)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int nh,
             int nkv, int T_, int S, float scale, int causal, int window) {
  using C = Tc<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, THR = C::THREADS;
  constexpr int NS = BK / 8;   // 8-key score tiles of a warp
  constexpr int NO = HD / 8;   // 8-column output tiles of a warp
  constexpr int CH = HD / 8;   // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x LD
  __nv_bfloat16* Ks = Qs + BQ * LD;                                 // 2 x BK x LD
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;                             // 2 x BK x LD

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (nh / nkv);
  const __nv_bfloat16* qb = q + ((long long)(b * nh + h) * T_) * HD;
  const __nv_bfloat16* kb = k + ((long long)(b * nkv + kvh) * S) * HD;
  const __nv_bfloat16* vb = v + ((long long)(b * nkv + kvh) * S) * HD;

  // The block copies a tile's ROWS x CH 16-byte chunks, chunk i = (row i /
  // CH, column (i % CH) * 8), thread tid taking i = tid, tid + THR, ...: each
  // chunk exactly once.  (ROWS * CH is a multiple of THR at every head dim:
  // CH = HD / 8 is even and ROWS is 32 or 64.)  When CH divides THR a
  // thread's column is fixed and its rows step by THR / CH.
  auto copy_rows = [&](auto ROWS_, auto&& chunk) {
    constexpr int ROWS = decltype(ROWS_)::value;
    static_assert(ROWS * CH % THR == 0, "a tile's chunks must fill whole passes");
    if constexpr (THR % CH == 0) {
      const int lc = (tid % CH) * 8;
#pragma unroll
      for (int r = tid / CH; r < ROWS; r += THR / CH) chunk(r, lc);
    } else {
#pragma unroll
      for (int i = tid; i < ROWS * CH; i += THR) chunk(i / CH, (i % CH) * 8);
    }
  };
  copy_rows(std::integral_constant<int, BQ>{}, [&](int r, int lc) {
    const bool in = q_start + r < T_;
    cp_async16(smem_u32(Qs + r * LD + lc), qb + (in ? (long long)(q_start + r) * HD + lc : 0),
               in);
  });
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    copy_rows(std::integral_constant<int, BK>{}, [&](int r, int lc) {
      const bool in = k0 + r < S;
      const int off = in ? (k0 + r) * HD + lc : 0;  // 32-bit: 64-bit offsets spill at hd 256
      cp_async16(smem_u32(Ks + (buf * BK + r) * LD + lc), kb + off, in);
      cp_async16(smem_u32(Vs + (buf * BK + r) * LD + lc), vb + off, in);
    });
  };

  // KV tiles that hold a key some row of this tile may see
  const int q_last = min(q_start + BQ, T_) - 1;
  const int n_tiles = (S + BK - 1) / BK;
  const int kt_hi = causal ? min(n_tiles, q_last / BK + 1) : n_tiles;
  const int kt_lo = window > 0 ? max(0, q_start - window + 1) / BK : 0;
  if (kt_lo < kt_hi) load_kv(kt_lo, 0);
  cp_async_commit();

  const int w_first = q_start + warp * 16, w_last = w_first + 15;
  const int row0 = w_first + g;  // this thread's rows: row0 and row0 + 8
  // the keys row r may see, lo[r] <= kpos <= hi[r]: kpos < S, causal
  // qpos >= kpos, window qpos - kpos < window
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    hi[r] = causal ? min(qpos, S - 1) : S - 1;
    lo[r] = window > 0 ? qpos - window + 1 : 0;
  }
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and this tile have landed
    __syncthreads();
    const int k0 = kt * BK;
    // a tile that masks every row of this warp adds nothing (exact to skip)
    const bool live =
        !(causal && k0 > w_last) && !(window > 0 && w_first - (k0 + BK - 1) >= window);
    if (live) {
      const __nv_bfloat16* Kt = Ks + buf * BK * LD;
      const __nv_bfloat16* Vt = Vs + buf * BK * LD;
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(smem_u32(Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8), a);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bk[4];  // b0, b1 of score tiles 2np and 2np + 1
          ldmatrix_x4(smem_u32(Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                               ((lane >> 3) & 1) * 8),
                      bk);
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // mask and scale, then the online softmax of rows row0 (e < 2) and row0 + 8
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          const bool ok = lo[e >> 1] <= kpos && kpos <= hi[e >> 1];
          s[j][e] = ok ? s[j][e] * scale : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = expf(m_run[r] - m_new);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m_run[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + sum[r];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }

      // acc += p_hi.v + p_lo.v, 16 keys at a time: score tiles 2kk, 2kk + 1
      // are the A fragment of the 16 x 16 slice
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bv[4];  // b0, b1 of output tiles 2dp and 2dp + 1
          ldmatrix_x4_trans(smem_u32(Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                     dp * 16 + (lane >> 4) * 8),
                            bv);
          mma_bf16(acc[2 * dp], hi, bv[0], bv[1]);
          mma_bf16(acc[2 * dp], lo, bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], hi, bv[2], bv[3]);
          mma_bf16(acc[2 * dp + 1], lo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this buffer is consumed before the next tile's load overwrites it
  }
  cp_async_wait<0>();

  __nv_bfloat16* ob = o + ((long long)(b * nh + h) * T_) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qpos = row0 + 8 * r;
    if (qpos >= T_) continue;
    const float den = l == 0.f ? 1.f : l;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const __nv_bfloat162 pair = __halves2bfloat162(__float2bfloat16_rn(acc[j][2 * r] / den),
                                                     __float2bfloat16_rn(acc[j][2 * r + 1] / den));
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qpos * HD + j * 8 + 2 * t) = pair;
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int nh, int nkv,
              int T_, int S, float scale, int causal, int window, void* stream) {
  using C = Tc<HD>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_ + C::BQ - 1) / C::BQ, nh, B);
  flash_fwd_tc<HD><<<grid, C::THREADS, C::SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, nh, nkv, T_, S, scale, causal, window);
  return (int)cudaGetLastError();
}

// out[0..3]: registers a thread, local (spill) bytes a thread, dynamic
// shared bytes a block, resident blocks an SM
template <int HD>
int attrs_tc(int* out) {
  using C = Tc<HD>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, flash_fwd_tc<HD>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_fwd_tc<HD>, C::THREADS,
                                                        C::SMEM);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)C::SMEM;
  out[3] = blocks;
  return 0;
}

// f(std::integral_constant<int, hd>) for the head dims the kernels take
template <typename F>
int by_head_dim(int hd, F&& f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 112: return f(std::integral_constant<int, 112>{});  // zamba2-7b's shared attention
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                                   int nh, int nkv, int T, int S, int hd, float scale,
                                   int causal, int window, void* stream) {
  return by_head_dim(hd, [&](auto HD) {
    return launch<float, decltype(HD)::value>(q, k, v, o, B, nh, nkv, T, S, scale, causal,
                                              window, stream);
  });
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                    int nh, int nkv, int T, int S, int hd, float scale,
                                    int causal, int window, void* stream) {
  return by_head_dim(hd, [&](auto HD) {
    return launch_tc<decltype(HD)::value>(q, k, v, o, B, nh, nkv, T, S, scale, causal, window,
                                          stream);
  });
}

extern "C" int flash_attention_bf16_attrs(int hd, int* out) {
  return by_head_dim(hd, [&](auto HD) { return attrs_tc<decltype(HD)::value>(out); });
}
