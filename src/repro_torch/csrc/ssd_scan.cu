// Mamba2 SSD chunked scan, forward (no backward).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` (src/repro/kernels/ssd_scan/
// kernel.py), the full-sequence forward of the SSM backbone.  x is
// (Bsz, T, nh, hd) in float32 or bfloat16, dt (Bsz, T, nh) float32 after the
// softplus, A (nh,) float32 and negative, B and C (Bsz, T, ds) in x's type
// (one group shared by all heads).  T is a multiple of the chunk Q.  The
// output y is (Bsz, T, nh, hd) in x's type.
//
// Per chunk c, head h, with u = dt * x and L the inclusive cumsum of dt * A
// within the chunk (each product rounded, summed in order from the chunk's
// first step, as the plain version on the card):
//   S_loc[c]  = sum_p exp(L_last - L_p) u_p B_p^T                  (hd x ds)
//   S_in[c+1] = exp(L_last[c]) S_in[c] + S_loc[c],  S_in[0] = 0
//   y         = exp(L) (C . S_in[c]^T) + tril(exp(min(L_q - L_p, 0)) (C . B^T)) . u
// all in float32, y rounded once to x's type.  The clamp min(., 0) keeps
// the masked (p > q) entries from overflowing exp.
//
// With a final-state output (the decode cache of a prefill) the scan also
// returns S_in[NC], the state after the last step, as the plain version's
// `return_final_state` does: (Bsz, nh, hd, ds) float32.
//
// A scan is three launches on the caller's stream (one when T is a single
// chunk and no final state is asked for: phases 1 and 2 then have no state
// to make), each parallel.  NS, the states the workspace holds, is NC - 1,
// or NC with a final state:
//
// 1. `ssd_chunk_states`: one block per (chunk c < NS, block of HB = 4
//    heads, batch row).  The chunk's B is staged once for the block, and L
//    of every head of the block (one lane a head); per head, w_p =
//    exp(L_last - L_p) and w u, then S_loc^T = B^T (w u), a (ds x hd)
//    float32 product, written to the workspace with L_last.
// 2. `ssd_state_pass`: one thread per (batch, head, state entry) walks the
//    chunks and overwrites slot c in place with S_in[c+1], in the plain
//    version's order (decay times state, rounded, plus S_loc, rounded),
//    reading the L_last that phase 1 wrote.  With a final state, the last
//    slot's S_in[NC] is also written to the output in the plain version's
//    (hd, ds) layout.
// 3. `ssd_chunk_outputs`: one block per (chunk, QR = 64 query rows, block of
//    HB heads, batch row).  C . B^T of the block's rows against the keys up
//    to its last row (causal: the first half of a 128-row chunk needs half
//    the keys) is computed once and kept in shared memory for every head of
//    the block; 80 heads share one B and C.  L again with phase 1's code
//    (bit for bit); per head y = exp(L) (C . S_in^T) + M . u, M the
//    decayed, masked C . B^T, built 64 keys at a time.
//
// L is summed in order, not by a parallel scan: at |L| near 1,000 (A =
// -11.6 over a chunk of 128 steps) a lane-parallel scan rounds neighbouring
// L's independently, and exp(L_q - L_p) of close steps then carries their
// rounding, 3x the plain version's error against a float64 scan on the
// card (8.1e-6 against 2.5e-6 of max |y| at T = 4,096).
//
// The workspace is float32: (Bsz, NS, nh, ds, hd) states, each stored
// transposed so that phase 3 reads it with 16-byte loads along hd, then
// (Bsz, NS, nh) L_last.  At mamba2-2.7b width (2 x 2048 tokens, 80
// heads of 64, state 128, chunk 128) that is 78.6 MB; phases 1, 2 and 3
// write it, read and write it, and read it: about 315 MB of traffic.
//
// Bound, as chip_smoke.py reckons it: bytes.  The products (C . B^T once
// per chunk; per head the intra-chunk, inter-chunk and state products) at
// the 989 TFLOP/s bfloat16 tensor-core rate take less time than reading x,
// dt, B, C and writing y once at 3.35 TB/s (0.0261 ms at mamba2-2.7b
// width).  This kernel is far from that bound: it runs its products in
// float32 on the CUDA cores (the float32 gate allows no bf16 rounding of a
// float32 operand; tensor cores with split-bf16 operands are the next
// step), so its own ceiling is the 67 TFLOP/s float32 rate: about 8 G
// multiply-adds at mamba2-2.7b width, 0.24 ms.
//
// Products: 256 threads, a 16 x 16 grid; each product gives a thread a
// register tile of 4 or 8 rows by 4 or 8 columns (rows 4 ty + 64 i' + i,
// columns 4 tx + 64 j' + j), fed from shared memory by 16-byte loads with
// the reduced index k outermost: the operands are staged k-major (C and B
// transposed), so a warp's loads of the row operand hit two addresses and
// its loads of the column operand 256 contiguous bytes.  Every operand is
// float32 in shared memory.  At the main path's (Q, hd, ds) = (128, 64,
// 128), which has its own instantiation with the sizes as constants and
// 16-byte global loads, phases 1 and 3 take 102,400 bytes of shared
// memory each: two blocks (16 warps) an SM.  The generic instantiation
// pads Q, hd and ds to 128 in shared memory, zero-filled, reads with
// guarded scalar loads, and runs one block an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXD = 128;  // largest Q, hd and ds
constexpr int QR = 64;     // query rows of a phase-3 block
constexpr int PT = 64;     // keys of a phase-3 tile
constexpr int HB = 4;      // heads of a phase-1 or phase-3 block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// The sizes in shared memory and the byte layout of each phase.  CQ, CHD,
// CDS: the chunk, head_dim and state as compile-time constants (the main
// path's shape), or all 0 for the generic instantiation, which pads each
// to MAXD.
template <int CQ, int CHD, int CDS>
struct Dims {
  static constexpr bool EX = CQ > 0;
  static constexpr int Q = EX ? CQ : MAXD, HD = EX ? CHD : MAXD, DS = EX ? CDS : MAXD;
  // phase 1: B (Q x DS), w u (Q x HD), then dt and L (HB x Q each)
  static constexpr size_t P1_U = (size_t)Q * DS * 4;
  static constexpr size_t P1_VEC = P1_U + (size_t)Q * HD * 4;
  static constexpr size_t P1_BYTES = P1_VEC + 2 * (size_t)HB * Q * 4;
  // phase 3: C^T (DS x QR), (C B^T)^T (Q x QR), a region that holds in
  // turn a B^T tile (DS x PT), the state S_in^T (DS x HD), and an M^T tile
  // (PT x QR) with its u (PT x HD); then dt and L (HB x Q each)
  static constexpr size_t P3_CB = (size_t)DS * QR * 4;
  static constexpr size_t P3_R = P3_CB + (size_t)Q * QR * 4;
  static constexpr size_t P3_U = (size_t)PT * QR * 4;  // u's offset within the region
  static constexpr size_t R_BYTES =
      cmax(cmax((size_t)DS * PT, (size_t)DS * HD), (size_t)PT * (QR + HD)) * 4;
  static constexpr size_t P3_VEC = P3_R + R_BYTES;
  static constexpr size_t P3_BYTES = P3_VEC + 2 * (size_t)HB * Q * 4;
  static constexpr size_t SMEM = cmax(P1_BYTES, P3_BYTES);
};

// acc[i][j] += sum_{k < K} a[k lda + m_i] b[k ldb + n_j], with m_i = 4 ty +
// 64 (i / 4) + i % 4 and n_j = 4 tx + 64 (j / 4) + j % 4: the rows of a
// 16 x 16 thread grid, four at a time.  a, b and both strides are 16-byte
// aligned.
template <int TM, int TN>
__device__ __forceinline__ void mm(float (&acc)[TM][TN], int K, const float* __restrict__ a,
                                   int lda, const float* __restrict__ b, int ldb, int ty,
                                   int tx) {
  a += 4 * ty;
  b += 4 * tx;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM / 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(a + k * lda + 64 * i);
      av[4 * i] = t.x, av[4 * i + 1] = t.y, av[4 * i + 2] = t.z, av[4 * i + 3] = t.w;
    }
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const float4 t = *reinterpret_cast<const float4*>(b + k * ldb + 64 * j);
      bv[4 * j] = t.x, bv[4 * j + 1] = t.y, bv[4 * j + 2] = t.z, bv[4 * j + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ int tile_row(int t, int i) { return 4 * t + 64 * (i / 4) + i % 4; }

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// VEC elements of type T from 16 bytes of global memory, as float32.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* v) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = to_f32(e[k]);
}

// dst[s][r] = src[r][s] as float32, for r < NR rows of a (rows x ds) global
// block and s < DS, zero past the real rows and ds.  Lanes run along r, so
// the shared stores hit consecutive words.
template <typename T, bool EX, int NR, int DS>
__device__ __forceinline__ void stage_transposed(float* dst, const T* __restrict__ src, int rows,
                                                 int ds, int tid) {
  if constexpr (EX) {
    constexpr int VEC = 16 / sizeof(T);
    for (int i = tid; i < NR * (DS / VEC); i += THREADS) {
      const int r = i % NR, s0 = i / NR * VEC;
      float v[VEC];
      if (r < rows) {
        load16(src + (size_t)r * DS + s0, v);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) dst[(s0 + k) * NR + r] = v[k];
    }
  } else {
    for (int i = tid; i < NR * DS; i += THREADS) {
      const int r = i % NR, s = i / NR;
      dst[s * NR + r] = r < rows && s < ds ? to_f32(src[(size_t)r * ds + s]) : 0.f;
    }
  }
}

// dts[hh][p] = dt of step p, head h0 + hh, for every head of the block (0
// past the chunk and the heads); then L[hh][p] = the inclusive cumsum of
// dt A over the chunk, one lane of warp 0 per head, in order from p = 0:
// the plain version's order (torch.cumsum along a dimension that is not
// the innermost runs sequentially on the card), so L is the plain
// version's bit for bit, and phases 1 and 3 get the same L.  Ends with the
// block synchronised.
template <int NQ>
__device__ __forceinline__ void chunk_cumsums(float* dts, float* Ls, const float* __restrict__ dt,
                                              const float* __restrict__ A, size_t row0, int Q,
                                              int nh, int h0, int nhb, int tid) {
  for (int i = tid; i < HB * NQ; i += THREADS) {
    const int hh = i / NQ, p = i % NQ;
    dts[i] = hh < nhb && p < Q ? dt[(row0 + p) * nh + h0 + hh] : 0.f;
  }
  __syncthreads();
  if (tid < nhb) {
    const float Ah = A[h0 + tid];
    const float* d = dts + tid * NQ;
    float* L = Ls + tid * NQ;
    float run = 0.f;
    for (int p = 0; p < Q; ++p) {
      run = __fadd_rn(run, __fmul_rn(d[p], Ah));  // dt A rounded, as the reference
      L[p] = run;
    }
  }
  __syncthreads();
}

// Phase 1: the chunk's local end state S_loc^T (ds x hd) of every head of
// the block, and its L_last.
template <typename T, int CQ, int CHD, int CDS>
__global__ void __launch_bounds__(THREADS, CQ > 0 ? 2 : 1)
ssd_chunk_states(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm, float* __restrict__ ws,
                 int T_, int NS, int nh, int hd_rt, int ds_rt, int Q_rt) {
  using D = Dims<CQ, CHD, CDS>;
  constexpr bool EX = D::EX;
  const int Q = EX ? CQ : Q_rt, hd = EX ? CHD : hd_rt, ds = EX ? CDS : ds_rt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Bs = reinterpret_cast<float*>(smem_raw);              // Q x DS, B[p][s]
  float* uw = reinterpret_cast<float*>(smem_raw + D::P1_U);    // Q x HD, w_p u[p][d]
  float* dts = reinterpret_cast<float*>(smem_raw + D::P1_VEC);  // HB x Q
  float* Ls = dts + HB * D::Q;                                     // HB x Q

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c = blockIdx.x, h0 = blockIdx.y * HB, b = blockIdx.z;
  const int Bsz = gridDim.z;
  const size_t row0 = (size_t)b * T_ + (size_t)c * Q;  // (b, t) row of the chunk's first step
  const size_t E = (size_t)hd * ds;

  if constexpr (EX) {
    constexpr int VEC = 16 / sizeof(T);
    for (int i = tid; i < D::Q * D::DS / VEC; i += THREADS) {
      float v[VEC];
      load16(Bm + row0 * D::DS + (size_t)i * VEC, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) Bs[i * VEC + k] = v[k];
    }
  } else {
    for (int i = tid; i < D::Q * D::DS; i += THREADS) {
      const int p = i / D::DS, s = i % D::DS;
      Bs[i] = p < Q && s < ds ? to_f32(Bm[(row0 + p) * ds + s]) : 0.f;
    }
  }

  const int nhb = min(HB, nh - h0);
  chunk_cumsums<D::Q>(dts, Ls, dt, A, row0, Q, nh, h0, nhb, tid);
  for (int hh = 0; hh < nhb; ++hh) {
    const int h = h0 + hh;
    const float* dh = dts + hh * D::Q;
    const float* L = Ls + hh * D::Q;
    const float Llast = L[Q - 1];
    if (hh) __syncthreads();  // the previous head's product is done with uw
    const T* xh = x + row0 * nh * hd + (size_t)h * hd;
    if constexpr (EX) {
      constexpr int VEC = 16 / sizeof(T), DV = D::HD / VEC;
      for (int i = tid; i < D::Q * DV; i += THREADS) {
        const int p = i / DV, d0 = i % DV * VEC;
        float v[VEC];
        load16(xh + (size_t)p * nh * D::HD + d0, v);
        const float dp = dh[p], wp = expf(Llast - L[p]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) uw[p * D::HD + d0 + k] = v[k] * dp * wp;
      }
    } else {
      for (int i = tid; i < D::Q * D::HD; i += THREADS) {
        const int p = i / D::HD, d = i % D::HD;
        uw[i] = p < Q && d < hd
                    ? to_f32(xh[(size_t)p * nh * hd + d]) * dh[p] * expf(Llast - L[p])
                    : 0.f;
      }
    }
    __syncthreads();

    // S_loc^T[s][d] = sum_p B[p][s] (w u)[p][d]
    float acc[D::DS / 16][D::HD / 16];
    zero(acc);
    mm(acc, Q, Bs, D::DS, uw, D::HD, ty, tx);
    const size_t slot = ((size_t)b * NS + c) * nh + h;
    float* out = ws + slot * E;
#pragma unroll
    for (int i = 0; i < D::DS / 16; ++i) {
      const int s = tile_row(ty, i);
      if constexpr (EX) {
#pragma unroll
        for (int j = 0; j < D::HD / 16; j += 4)
          *reinterpret_cast<float4*>(out + s * D::HD + tile_row(tx, j)) =
              make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < D::HD / 16; ++j) {
          const int d = tile_row(tx, j);
          if (s < ds && d < hd) out[(size_t)s * hd + d] = acc[i][j];
        }
      }
    }
    if (tid == 0) ws[(size_t)Bsz * NS * nh * E + slot] = Llast;
  }
}

// Phase 2: slot c of (b, h) holds S_loc[c] and becomes S_in[c + 1]; with
// `state`, the last slot's S_in[NS] also goes there, (hd, ds) per (b, h).
template <int V>
__global__ void __launch_bounds__(THREADS)
ssd_state_pass(float* ws, float* __restrict__ state, int Bsz, int NS, int nh, int hd, int E) {
  const int e = (blockIdx.x * THREADS + threadIdx.x) * V;
  if (e >= E) return;
  const int b = blockIdx.y / nh, h = blockIdx.y % nh;
  const float* Llast = ws + (size_t)Bsz * NS * nh * E;
  float run[V];
#pragma unroll
  for (int k = 0; k < V; ++k) run[k] = 0.f;
#pragma unroll 4
  for (int c = 0; c < NS; ++c) {
    const size_t slot = ((size_t)b * NS + c) * nh + h;
    const float decay = expf(Llast[slot]);
    float* s = ws + slot * E + e;
    float v[V];
    if constexpr (V == 4) {
      const float4 t = *reinterpret_cast<const float4*>(s);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else {
      v[0] = *s;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) run[k] = __fadd_rn(__fmul_rn(decay, run[k]), v[k]);
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(s) = make_float4(run[0], run[1], run[2], run[3]);
    } else {
      *s = run[0];
    }
  }
  if (state) {  // entry e + k is (s, d) of the transposed state: out[d][s]
    const int ds = E / hd;
    float* out = state + ((size_t)b * nh + h) * E;
#pragma unroll
    for (int k = 0; k < V; ++k) out[(size_t)((e + k) % hd) * ds + (e + k) / hd] = run[k];
  }
}

// Phase 3: y of QR query rows of a chunk, for every head of the block.
template <typename T, int CQ, int CHD, int CDS>
__global__ void __launch_bounds__(THREADS, CQ > 0 ? 2 : 1)
ssd_chunk_outputs(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ ws, T* __restrict__ y,
                  int T_, int NS, int nh, int hd_rt, int ds_rt, int Q_rt) {
  using D = Dims<CQ, CHD, CDS>;
  constexpr bool EX = D::EX;
  constexpr int TH = D::HD / 16;  // register columns over head_dim
  const int Q = EX ? CQ : Q_rt, hd = EX ? CHD : hd_rt, ds = EX ? CDS : ds_rt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ct = reinterpret_cast<float*>(smem_raw);             // DS x QR, C[q][s] at [s][q]
  float* CBt = reinterpret_cast<float*>(smem_raw + D::P3_CB);  // Q x QR, (C B^T)[q][p] at [p][q]
  float* R = reinterpret_cast<float*>(smem_raw + D::P3_R);
  float* Mt = R;                                                // PT x QR, M[q][p] at [p][q]
  float* us = reinterpret_cast<float*>(smem_raw + D::P3_R + D::P3_U);  // PT x HD
  float* dts = reinterpret_cast<float*>(smem_raw + D::P3_VEC);  // HB x Q
  float* Ls = dts + HB * D::Q;                                     // HB x Q

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int NR = (Q + QR - 1) / QR;
  const int c = blockIdx.x / NR, q0 = blockIdx.x % NR * QR;
  const int h0 = blockIdx.y * HB, b = blockIdx.z;
  const int nq = min(QR, Q - q0);  // real query rows of the block
  const int P = min(Q, q0 + QR);   // keys they attend to
  const size_t row0 = (size_t)b * T_ + (size_t)c * Q;
  const size_t E = (size_t)hd * ds;

  // C . B^T of the block's rows against keys [0, P), 64 keys at a time
  const int nhb = min(HB, nh - h0);
  stage_transposed<T, EX, QR, D::DS>(Ct, Cm + (row0 + q0) * ds, nq, ds, tid);
  chunk_cumsums<D::Q>(dts, Ls, dt, A, row0, Q, nh, h0, nhb, tid);
  for (int p0 = 0; p0 < P; p0 += PT) {
    if (p0) __syncthreads();  // the previous B^T tile is read
    stage_transposed<T, EX, PT, D::DS>(R, Bm + (row0 + p0) * ds, min(PT, P - p0), ds, tid);
    __syncthreads();
    float acc[QR / 16][PT / 16];
    zero(acc);
    mm(acc, ds, Ct, QR, R, PT, ty, tx);
#pragma unroll
    for (int j = 0; j < PT / 16; ++j)
#pragma unroll
      for (int i = 0; i < QR / 16; ++i) CBt[(p0 + tile_row(tx, j)) * QR + tile_row(ty, i)] = acc[i][j];
  }

  for (int hh = 0; hh < nhb; ++hh) {
    const int h = h0 + hh;
    const float* dh = dts + hh * D::Q;
    const float* L = Ls + hh * D::Q;
    __syncthreads();  // C B^T is written; the previous head is done with R
    if (c > 0) {  // S_in^T of this chunk: slot c - 1, written by phase 2
      const float* St = ws + (((size_t)b * NS + c - 1) * nh + h) * E;
      if constexpr (EX) {
        for (int i = tid; i < D::DS * D::HD / 4; i += THREADS)
          reinterpret_cast<float4*>(R)[i] = reinterpret_cast<const float4*>(St)[i];
      } else {
        for (int i = tid; i < D::DS * D::HD; i += THREADS) {
          const int s = i / D::HD, d = i % D::HD;
          R[i] = s < ds && d < hd ? St[(size_t)s * hd + d] : 0.f;
        }
      }
      __syncthreads();
    }

    // inter-chunk: y[q][d] = exp(L_q) sum_s C[q][s] S_in[d][s]
    float acc[QR / 16][TH];
    zero(acc);
    if (c > 0) {
      mm(acc, ds, Ct, QR, R, D::HD, ty, tx);
#pragma unroll
      for (int i = 0; i < QR / 16; ++i) {
        const int q = q0 + tile_row(ty, i);
        const float e = q < Q ? expf(L[q]) : 0.f;
#pragma unroll
        for (int j = 0; j < TH; ++j) acc[i][j] *= e;
      }
    }

    // intra-chunk, 64 keys at a time:
    // M[q][p] = (q >= p) exp(min(L_q - L_p, 0)) (C B^T)[q][p]; y += M u
    for (int p0 = 0; p0 < P; p0 += PT) {
      if (c > 0 || p0) __syncthreads();  // R is free: the state or the previous tile is read
      for (int i = tid; i < PT * QR; i += THREADS) {
        const int p = i / QR, q = i % QR, qq = q0 + q, pp = p0 + p;
        Mt[i] = qq >= pp && qq < Q ? CBt[pp * QR + q] * expf(fminf(L[qq] - L[pp], 0.f)) : 0.f;
      }
      const T* xh = x + (row0 + p0) * nh * hd + (size_t)h * hd;
      if constexpr (EX) {
        constexpr int VEC = 16 / sizeof(T), DV = D::HD / VEC;
        for (int i = tid; i < PT * DV; i += THREADS) {
          const int p = i / DV, d0 = i % DV * VEC;
          float v[VEC];
          load16(xh + (size_t)p * nh * D::HD + d0, v);
          const float dp = dh[p0 + p];
#pragma unroll
          for (int k = 0; k < VEC; ++k) us[p * D::HD + d0 + k] = v[k] * dp;
        }
      } else {
        for (int i = tid; i < PT * D::HD; i += THREADS) {
          const int p = i / D::HD, d = i % D::HD;
          us[i] = p0 + p < Q && d < hd ? to_f32(xh[(size_t)p * nh * hd + d]) * dh[p0 + p] : 0.f;
        }
      }
      __syncthreads();
      mm(acc, PT, Mt, QR, us, D::HD, ty, tx);
    }

    T* yh = y + (row0 + q0) * nh * hd + (size_t)h * hd;
#pragma unroll
    for (int i = 0; i < QR / 16; ++i) {
      const int q = tile_row(ty, i);
#pragma unroll
      for (int j = 0; j < TH; ++j) {
        const int d = tile_row(tx, j);
        if (EX || (q < nq && d < hd)) yh[(size_t)q * nh * hd + d] = from_f32<T>(acc[i][j]);
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// Launch the phases in `mask` (bit 0: chunk states, 1: state pass, 2: chunk
// outputs).  Phases 1 and 2 run only when there is a state to make: more
// than one chunk, or a final state (`state` not null).
template <typename T, int CQ, int CHD, int CDS>
int launch(int mask, const void* x, const void* dt, const void* A, const void* B, const void* C,
           void* y, void* ws, void* state, int Bsz, int T_, int nh, int hd, int ds, int Q,
           void* stream) {
  using D = Dims<CQ, CHD, CDS>;
  const cudaStream_t s = (cudaStream_t)stream;
  const int NC = T_ / Q, NHB = (nh + HB - 1) / HB, NR = (Q + QR - 1) / QR, E = hd * ds;
  const int NS = NC - 1 + (state != nullptr);
  cudaError_t err = cudaSuccess;
  if ((mask & 1) && NS > 0) {
    if ((err = allow_smem(ssd_chunk_states<T, CQ, CHD, CDS>, D::P1_BYTES)) != cudaSuccess)
      return (int)err;
    ssd_chunk_states<T, CQ, CHD, CDS><<<dim3(NS, NHB, Bsz), THREADS, D::P1_BYTES, s>>>(
        (const T*)x, (const float*)dt, (const float*)A, (const T*)B, (float*)ws, T_, NS, nh, hd,
        ds, Q);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if ((mask & 2) && NS > 0) {
    const int V = E % 4 ? 1 : 4, per = THREADS * V;
    const dim3 grid((E + per - 1) / per, Bsz * nh);
    if (V == 4)
      ssd_state_pass<4><<<grid, THREADS, 0, s>>>((float*)ws, (float*)state, Bsz, NS, nh, hd, E);
    else
      ssd_state_pass<1><<<grid, THREADS, 0, s>>>((float*)ws, (float*)state, Bsz, NS, nh, hd, E);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (mask & 4) {
    if ((err = allow_smem(ssd_chunk_outputs<T, CQ, CHD, CDS>, D::P3_BYTES)) != cudaSuccess)
      return (int)err;
    ssd_chunk_outputs<T, CQ, CHD, CDS><<<dim3(NC * NR, NHB, Bsz), THREADS, D::P3_BYTES, s>>>(
        (const T*)x, (const float*)dt, (const float*)A, (const T*)B, (const T*)C,
        (const float*)ws, (T*)y, T_, NS, nh, hd, ds, Q);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

bool main_shape(int Q, int hd, int ds) { return Q == 128 && hd == 64 && ds == 128; }

template <typename T>
int dispatch(int mask, const void* x, const void* dt, const void* A, const void* B,
             const void* C, void* y, void* ws, void* state, int Bsz, int T_, int nh, int hd,
             int ds, int Q, void* stream) {
  if (Q < 1 || hd < 1 || ds < 1 || Q > MAXD || hd > MAXD || ds > MAXD || T_ % Q)
    return (int)cudaErrorInvalidValue;
  if (main_shape(Q, hd, ds))  // mamba2's chunk, head_dim and state
    return launch<T, 128, 64, 128>(mask, x, dt, A, B, C, y, ws, state, Bsz, T_, nh, hd, ds, Q,
                                   stream);
  return launch<T, 0, 0, 0>(mask, x, dt, A, B, C, y, ws, state, Bsz, T_, nh, hd, ds, Q, stream);
}

template <typename K>
int attrs_of(K kernel, size_t smem, int* out) {
  cudaError_t err = smem ? allow_smem(kernel, smem) : cudaSuccess;
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return 0;
}

template <typename T>
int attrs(int phase, int* out) {
  using D = Dims<128, 64, 128>;
  switch (phase) {
    case 1: return attrs_of(ssd_chunk_states<T, 128, 64, 128>, D::P1_BYTES, out);
    case 2: return attrs_of(ssd_state_pass<4>, 0, out);
    case 3: return attrs_of(ssd_chunk_outputs<T, 128, 64, 128>, D::P3_BYTES, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// `state`: null, or the (Bsz, nh, hd, ds) float32 final state to write
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, void* y, void* ws, void* state, int Bsz, int T,
                            int nh, int hd, int ds, int Q, void* stream) {
  return dispatch<float>(7, x, dt, A, B, C, y, ws, state, Bsz, T, nh, hd, ds, Q, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* B,
                             const void* C, void* y, void* ws, void* state, int Bsz, int T,
                             int nh, int hd, int ds, int Q, void* stream) {
  return dispatch<__nv_bfloat16>(7, x, dt, A, B, C, y, ws, state, Bsz, T, nh, hd, ds, Q,
                                 stream);
}

// One phase (1, 2 or 3) alone, for timing each: the phases before it must
// have run on the same workspace and `state` (null or not).
extern "C" int ssd_scan_phase(int phase, int bf16, const void* x, const void* dt, const void* A,
                              const void* B, const void* C, void* y, void* ws, void* state,
                              int Bsz, int T, int nh, int hd, int ds, int Q, void* stream) {
  if (phase < 1 || phase > 3) return (int)cudaErrorInvalidValue;
  const int mask = 1 << (phase - 1);
  return bf16 ? dispatch<__nv_bfloat16>(mask, x, dt, A, B, C, y, ws, state, Bsz, T, nh, hd, ds,
                                        Q, stream)
              : dispatch<float>(mask, x, dt, A, B, C, y, ws, state, Bsz, T, nh, hd, ds, Q,
                                stream);
}

// The dynamic shared memory of the largest phase, for the wrapper's check.
extern "C" long long ssd_scan_smem_bytes(int Q, int hd, int ds, int bf16) {
  (void)bf16;  // every operand is float32 in shared memory
  return (long long)(main_shape(Q, hd, ds) ? Dims<128, 64, 128>::SMEM : Dims<0, 0, 0>::SMEM);
}

// Registers, local (spill) bytes a thread, dynamic shared bytes and blocks
// an SM of phase 1, 2 or 3 at the main path's instantiation.
extern "C" int ssd_scan_attrs(int phase, int bf16, int* out) {
  return bf16 ? attrs<__nv_bfloat16>(phase, out) : attrs<float>(phase, out);
}
