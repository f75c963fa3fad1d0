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
// 1. `ssd_chunk_states` (bf16: `ssd_chunk_states_tc`): one block per
//    (chunk c < NS, block of HB = 4 heads, batch row).  The chunk's B is staged once for the block, and L
//    of every head of the block (one lane a head); per head, w_p =
//    exp(L_last - L_p) and w u, then S_loc^T = B^T (w u), a (ds x hd)
//    float32 product, written to the workspace with L_last.
// 2. `ssd_state_pass`: one thread per (batch, head, state entry) walks the
//    chunks and overwrites slot c in place with S_in[c+1], in the plain
//    version's order (decay times state, rounded, plus S_loc, rounded),
//    reading the L_last that phase 1 wrote.  With a final state, the last
//    slot's S_in[NC] is also written to the output in the plain version's
//    (hd, ds) layout.
// 3. `ssd_chunk_outputs` (bf16: `ssd_chunk_outputs_tc`): one block per
//    (chunk, QR = 64 query rows, block of HB heads, batch row).  C . B^T
//    of the block's rows against the keys up to its last row (causal: the
//    first half of a 128-row chunk needs half the keys) is computed once
//    and kept (in shared memory; bf16: in the warps' registers) for every
//    head of the block; 80 heads share one B and C.  L again with phase
//    1's code (bit for bit); per head y = exp(L) (C . S_in^T) + M . u, M
//    the decayed, masked C . B^T (float32: built 64 keys at a time).
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
// Two routes, by x's type, the same three phases and the same workspace.
//
// bfloat16 (the backbones' route): the products of phases 1 and 3 on the
// tensor cores, `mma.sync.m16n8k16` with bf16 operands and float32
// accumulators, fed by ldmatrix from shared memory where every operand is
// staged as bf16 (mma_bf16.cuh).  The gates allow no rounding of a float32
// operand to bf16, so every product has one operand that is bf16 already
// and exact, and its other, float32 operand v is split in three bf16
// terms, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), each
// difference exact: 8 significant bits a term, so three hold all 24 of a
// float32 (two, as flash's p takes, hold 16), except where lo falls
// subnormal, below 2^-133 of v's scale.  A product is then three MMAs of
// exact bf16 products, summed into the same float32 accumulator, each
// 16-deep k-step adding hi, mid, lo in turn: the float32 arithmetic of the
// CUDA-core route in another order of summation.  Which operand is exact:
//   phase 1, S_loc^T = B^T (w dt x): B exact; (w_p dt_p) x_p split;
//   phase 3, C . B^T (once for the block's heads): both exact, one MMA;
//   phase 3, inter-chunk C . S_in^T: C exact; phase 2's state S_in split
//     as it is staged;
//   phase 3, intra-chunk: dt folded into M, M'[q][p] = mask exp(min(L_q -
//     L_p, 0)) (C . B^T)[q][p] dt_p, split, against x, exact.
// L is summed in order as in the float32 route, bit for bit, the exp clamp
// and phase 2 are the same, and the three phases run alone give the scan
// bit for bit.  tests/test_torch_ssd.py emulates this arithmetic on the
// CPU (`_three_phases(tc=True)`) within 2e-7 of max |y| of the plain
// version, and M' in one bf16 term about 800 times the 3e-6 bound.
//
// Bound, as chip_smoke.py reckons it: bytes.  The products (C . B^T once
// per chunk; per head the intra-chunk, inter-chunk and state products) at
// the 989 TFLOP/s bfloat16 tensor-core rate take less time than reading x,
// dt, B, C and writing y once at 3.35 TB/s (0.0261 ms at mamba2-2.7b
// width).  The split triples the split products, about 39 GFLOP at
// mamba2-2.7b width (0.040 ms at that rate; `mma.sync` reaches a part of
// it), and the workspace's 315 MB are about 0.094 ms at 3.35 TB/s: the
// design's own floor, three times the bound.
//
// Products on the tensor cores: 256 threads, 8 warps, each owning a tile
// of the product's output in MMA accumulators.  Phase 1: a warp takes
// DS / 2 state rows by HD / 4 columns (2 x 4 warps).  Phase 3: C . B^T a
// 32 x 32 tile of the block's 64 rows by 128 keys, kept in registers for
// every head of the block (a warp whose keys lie past the causal end
// skips); M' is built from that fragment by the warp that holds it, split,
// and written to shared memory; y a 16-row by HD / 2 tile, whose intra-
// chunk k-steps stop at the warp's last row (the keys past it are masked).
// Shared rows are padded by 16 bytes, so the 8 rows an ldmatrix reads sit
// in 8 distinct bank groups.  B, C and x reach shared memory by cp.async,
// phase 1's x a head ahead, in flight during the product of the head
// before; phase 3's S_in, split on the way, comes through registers, four
// 16-byte loads a thread in flight together.
//
// float32: the products on the CUDA cores (the float32 gate,
// test_ssd_kernel_as_accurate_as_plain, is held by float32 FMAs; tensor
// cores would need both operands split), so its ceiling is the 67 TFLOP/s
// float32 rate: about 8 G multiply-adds at mamba2-2.7b width, 0.24 ms.
// 256 threads, a 16 x 16 grid; each product gives a thread a register
// tile of 4 or 8 rows by 4 or 8 columns (rows 4 ty + 64 i' + i, columns
// 4 tx + 64 j' + j), fed from shared memory by 16-byte loads with the
// reduced index k outermost: the operands are staged k-major (C and B
// transposed), so a warp's loads of the row operand hit two addresses and
// its loads of the column operand 256 contiguous bytes.  Every operand is
// float32 in shared memory.
//
// Instantiations: (Q, hd, ds) = (128, 64, 128), mamba2's, and (128, 64,
// 64), zamba2-7b's, each with the sizes as constants and 16-byte global
// loads; phases 1 and 3 fit two blocks (16 warps) an SM in both routes.
// Every other shape takes the generic instantiation, which pads Q, hd and
// ds to 128 in shared memory, zero-filled, reads with guarded scalar
// loads, and runs one block an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAXD = 128;  // largest Q, hd and ds
constexpr int QR = 64;     // query rows of a phase-3 block
constexpr int PT = 64;     // keys of a phase-3 tile
constexpr int HB = 4;      // heads of a phase-1 or phase-3 block

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// The sizes in shared memory and the byte layout of each phase of the
// float32 route.  CQ, CHD, CDS: the chunk, head_dim and state as
// compile-time constants (mamba2's or zamba2-7b's shape), or all 0 for the
// generic instantiation, which pads each to MAXD.
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

// 4 float32 from 16 bytes of global memory
__device__ __forceinline__ void load16(const float* src, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

// The 8 bf16 of a 16-byte word as float32
__device__ __forceinline__ void unpack8(const uint4& raw, float* v) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(e[k]);
}

// dst[s][r] = src[r][s] as float32, for r < NR rows of a (rows x ds) global
// block and s < DS, zero past the real rows and ds.  Lanes run along r, so
// the shared stores hit consecutive words.
template <bool EX, int NR, int DS>
__device__ __forceinline__ void stage_transposed(float* dst, const float* __restrict__ src,
                                                 int rows, int ds, int tid) {
  if constexpr (EX) {
    constexpr int VEC = 4;
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
      dst[s * NR + r] = r < rows && s < ds ? src[(size_t)r * ds + s] : 0.f;
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
template <int CQ, int CHD, int CDS>
__global__ void __launch_bounds__(THREADS, CQ > 0 ? 2 : 1)
ssd_chunk_states(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 float* __restrict__ ws, int T_, int NS, int nh, int hd_rt, int ds_rt, int Q_rt) {
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
    constexpr int VEC = 4;
    for (int i = tid; i < D::Q * D::DS / VEC; i += THREADS) {
      float v[VEC];
      load16(Bm + row0 * D::DS + (size_t)i * VEC, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) Bs[i * VEC + k] = v[k];
    }
  } else {
    for (int i = tid; i < D::Q * D::DS; i += THREADS) {
      const int p = i / D::DS, s = i % D::DS;
      Bs[i] = p < Q && s < ds ? Bm[(row0 + p) * ds + s] : 0.f;
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
    const float* xh = x + row0 * nh * hd + (size_t)h * hd;
    if constexpr (EX) {
      constexpr int VEC = 4, DV = D::HD / VEC;
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
                    ? xh[(size_t)p * nh * hd + d] * dh[p] * expf(Llast - L[p])
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
template <int CQ, int CHD, int CDS>
__global__ void __launch_bounds__(THREADS, CQ > 0 ? 2 : 1)
ssd_chunk_outputs(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ ws,
                  float* __restrict__ y,
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
  stage_transposed<EX, QR, D::DS>(Ct, Cm + (row0 + q0) * ds, nq, ds, tid);
  chunk_cumsums<D::Q>(dts, Ls, dt, A, row0, Q, nh, h0, nhb, tid);
  for (int p0 = 0; p0 < P; p0 += PT) {
    if (p0) __syncthreads();  // the previous B^T tile is read
    stage_transposed<EX, PT, D::DS>(R, Bm + (row0 + p0) * ds, min(PT, P - p0), ds, tid);
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
      const float* xh = x + (row0 + p0) * nh * hd + (size_t)h * hd;
      if constexpr (EX) {
        constexpr int VEC = 4, DV = D::HD / VEC;
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
          us[i] = p0 + p < Q && d < hd ? xh[(size_t)p * nh * hd + d] * dh[p0 + p] : 0.f;
        }
      }
      __syncthreads();
      mm(acc, PT, Mt, QR, us, D::HD, ty, tx);
    }

    float* yh = y + (row0 + q0) * nh * hd + (size_t)h * hd;
#pragma unroll
    for (int i = 0; i < QR / 16; ++i) {
      const int q = tile_row(ty, i);
#pragma unroll
      for (int j = 0; j < TH; ++j) {
        const int d = tile_row(tx, j);
        if (EX || (q < nq && d < hd)) yh[(size_t)q * nh * hd + d] = acc[i][j];
      }
    }
  }
}

// ---- bfloat16: the tensor-core route ---------------------------------------

using bf16 = __nv_bfloat16;

// The sizes in shared memory and the byte layout of each phase of the
// tensor-core route, every operand bf16 in rows padded by 8 elements (16
// bytes).  CQ, CHD, CDS as in Dims.
template <int CQ, int CHD, int CDS>
struct TcDims {
  static constexpr bool EX = CQ > 0;
  static constexpr int Q = EX ? CQ : MAXD, HD = EX ? CHD : MAXD, DS = EX ? CDS : MAXD;
  static constexpr int LB = DS + 8;  // row stride of B and C, [p][s] and [q][s]
  static constexpr int LU = HD + 8;  // of x, w dt x and S_in^T, [p][d] and [s][d]
  static constexpr int LM = Q + 8;   // of M', [q][p]
  static_assert(DS % 32 == 0 && HD % 64 == 0, "the warps' tiles must divide ds and hd");
  // phase 1: B (Q x LB), the three terms of w dt x (3 x Q x LU), x of a
  // head (Q x LU), dt and L
  static constexpr size_t P1_U = (size_t)Q * LB * 2;
  static constexpr size_t P1_X = P1_U + 3 * (size_t)Q * LU * 2;
  static constexpr size_t P1_VEC = P1_X + (size_t)Q * LU * 2;
  static constexpr size_t P1_BYTES = P1_VEC + 2 * (size_t)HB * Q * 4;
  // phase 3: C (QR x LB), then a region that holds in turn the keys' B (Q
  // x LB), the three terms of S_in^T (3 x DS x LU) and the three terms of
  // M' (3 x QR x LM); x (Q x LU), then dt and L
  static constexpr size_t P3_R = (size_t)QR * LB * 2;
  static constexpr size_t R_BYTES =
      cmax(cmax((size_t)Q * LB * 2, 3 * (size_t)DS * LU * 2), 3 * (size_t)QR * LM * 2);
  static constexpr size_t P3_X = P3_R + R_BYTES;
  static constexpr size_t P3_VEC = P3_X + (size_t)Q * LU * 2;
  static constexpr size_t P3_BYTES = P3_VEC + 2 * (size_t)HB * Q * 4;
  static constexpr size_t SMEM = cmax(P1_BYTES, P3_BYTES);
};

// v = hi + mid + lo, three bf16 terms, each difference exact in float32
__device__ __forceinline__ void split3(float v, bf16& hi, bf16& mid, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

// The three terms of N (4 or 8) float32 values, to dst, dst + step and
// dst + 2 step (bf16 elements), N * 2 bytes each
template <int N>
__device__ __forceinline__ void split_store(bf16* dst, size_t step, const float* v) {
  uint32_t w[3][N / 2];
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    bf16 h0, m0, l0, h1, m1, l1;
    split3(v[2 * k], h0, m0, l0);
    split3(v[2 * k + 1], h1, m1, l1);
    w[0][k] = pack_bf16(h0, h1), w[1][k] = pack_bf16(m0, m1), w[2][k] = pack_bf16(l0, l1);
  }
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if constexpr (N == 8)
      *reinterpret_cast<uint4*>(dst + t * step) = make_uint4(w[t][0], w[t][1], w[t][2], w[t][3]);
    else
      *reinterpret_cast<uint2*>(dst + t * step) = make_uint2(w[t][0], w[t][1]);
  }
}

// Fragments of m16n8k16 from a bf16 tile in shared memory of row stride ld.
// The A fragment of rows m0.. and k0.. from a [m][k] tile:
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0,
                                       int lane) {
  ldmatrix_x4(smem_u32(s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8), a);
}
// ... from a [k][m] tile:
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0,
                                         int lane) {
  ldmatrix_x4_trans(smem_u32(s + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 +
                             ((lane >> 3) & 1) * 8),
                    a);
}
// b0, b1 of the 8-column tiles n0.. and n0 + 8.. (16 deep from k0) from a
// [n][k] tile:
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* s, int ld, int n0, int k0,
                                       int lane) {
  ldmatrix_x4(smem_u32(s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                       ((lane >> 3) & 1) * 8),
              b);
}
// ... from a [k][n] tile:
__device__ __forceinline__ void frag_b_t(uint32_t (&b)[4], const bf16* s, int ld, int n0, int k0,
                                         int lane) {
  ldmatrix_x4_trans(smem_u32(s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                             (lane >> 4) * 8),
                    b);
}

// acc += A B over k in [0, K), K a multiple of 16, for a warp's tile of WM
// 16-row tiles from m0 by 2 WN 8-column tiles from n0.  A is NA bf16 terms
// and B NB (one of the two is 1), term t at a + t a_step (b + t b_step);
// AT and BT: A stored [k][m], B stored [k][n] (else [m][k] and [n][k]).  In
// each 16-deep k-step the terms' products are added in order, the split
// operand's fragments loaded a term at a time.
template <int WM, int WN, int NA, int NB, bool AT, bool BT>
__device__ __forceinline__ void mma_tile(float (&acc)[WM][2 * WN][4], int K, const bf16* a,
                                         int lda, size_t a_step, const bf16* b, int ldb,
                                         size_t b_step, int m0, int n0, int lane) {
  static_assert(NA == 1 || NB == 1, "one operand is exact");
  auto load_a = [&](uint32_t(&fa)[WM][4], int t, int k0) {
#pragma unroll
    for (int i = 0; i < WM; ++i) {
      if constexpr (AT)
        frag_a_t(fa[i], a + t * a_step, lda, m0 + 16 * i, k0, lane);
      else
        frag_a(fa[i], a + t * a_step, lda, m0 + 16 * i, k0, lane);
    }
  };
  auto load_b = [&](uint32_t(&fb)[WN][4], int t, int k0) {
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      if constexpr (BT)
        frag_b_t(fb[j], b + t * b_step, ldb, n0 + 16 * j, k0, lane);
      else
        frag_b(fb[j], b + t * b_step, ldb, n0 + 16 * j, k0, lane);
    }
  };
  auto mma_all = [&](const uint32_t(&fa)[WM][4], const uint32_t(&fb)[WN][4]) {
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        mma_bf16(acc[i][2 * j], fa[i], fb[j][0], fb[j][1]);
        mma_bf16(acc[i][2 * j + 1], fa[i], fb[j][2], fb[j][3]);
      }
  };
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t fa[WM][4], fb[WN][4];
    if constexpr (NA == 1) {
      load_a(fa, 0, k0);
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        load_b(fb, t, k0);
        mma_all(fa, fb);
      }
    } else {
      load_b(fb, 0, k0);
#pragma unroll
      for (int t = 0; t < NA; ++t) {
        load_a(fa, t, k0);
        mma_all(fa, fb);
      }
    }
  }
}

// dst[r][j] = src[r stride + j] (bf16, dst rows of LD elements) for r <
// nrows and j < NC, zero at r >= rows or j >= cols: asynchronous 16-byte
// copies (cp.async, the caller commits and waits) in a compile-time
// instantiation (whole rows, 16-byte aligned), guarded scalar stores in
// the generic.
template <bool EX, int NC, int LD>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* __restrict__ src, size_t stride,
                                           int nrows, int rows, int cols, int tid) {
  if constexpr (EX) {
    constexpr int CH = NC / 8;
    for (int i = tid; i < nrows * CH; i += THREADS) {
      const int r = i / CH, j = i % CH * 8;
      cp_async16(smem_u32(dst + r * LD + j), src + (r < rows ? r * stride + j : 0), r < rows);
    }
  } else {
    for (int i = tid; i < nrows * NC; i += THREADS) {
      const int r = i / NC, j = i % NC;
      dst[r * LD + j] = r < rows && j < cols ? src[r * stride + j] : __float2bfloat16_rn(0.f);
    }
  }
}

// Phase 1 on the tensor cores: S_loc^T = B^T (w dt x), B exact, (w_p dt_p)
// x_p split in three.
template <int CQ, int CHD, int CDS>
__global__ void __launch_bounds__(THREADS, CQ > 0 ? 2 : 1)
ssd_chunk_states_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    float* __restrict__ ws, int T_, int NS, int nh, int hd_rt, int ds_rt,
                    int Q_rt) {
  using D = TcDims<CQ, CHD, CDS>;
  constexpr bool EX = D::EX;
  constexpr int LB = D::LB, LU = D::LU;
  constexpr int WM = D::DS / 32, WN = D::HD / 64;  // a warp's 16-row and 16-column tiles
  const int Q = EX ? CQ : Q_rt, hd = EX ? CHD : hd_rt, ds = EX ? CDS : ds_rt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);                  // Q x LB, B[p][s]
  bf16* U = reinterpret_cast<bf16*>(smem_raw + D::P1_U);          // 3 x Q x LU, w dt x
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw + D::P1_X);         // Q x LU, x[p][d]
  float* dts = reinterpret_cast<float*>(smem_raw + D::P1_VEC);   // HB x Q
  float* Ls = dts + HB * D::Q;                                    // HB x Q

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int c = blockIdx.x, h0 = blockIdx.y * HB, b = blockIdx.z;
  const int Bsz = gridDim.z;
  const size_t row0 = (size_t)b * T_ + (size_t)c * Q;
  const size_t E = (size_t)hd * ds;
  const int K = EX ? D::Q : (Q + 15) / 16 * 16;
  const int m0 = warp / 4 * (D::DS / 2), n0 = warp % 4 * (D::HD / 4);

  // B and the first head's x in flight while L is summed; each later head's
  // x in flight during the product of the one before
  const int nhb = min(HB, nh - h0);
  const bf16* x0 = x + row0 * nh * hd;
  stage_bf16<EX, D::DS, LB>(Bs, Bm + row0 * ds, ds, D::Q, Q, ds, tid);
  stage_bf16<EX, D::HD, LU>(Xs, x0 + (size_t)h0 * hd, (size_t)nh * hd, D::Q, Q, hd, tid);
  cp_async_commit();
  chunk_cumsums<D::Q>(dts, Ls, dt, A, row0, Q, nh, h0, nhb, tid);
#pragma unroll 1
  for (int hh = 0; hh < nhb; ++hh) {
    const int h = h0 + hh;
    const float* dh = dts + hh * D::Q;
    const float* L = Ls + hh * D::Q;
    const float Llast = L[Q - 1];
    cp_async_wait<0>();  // this head's x (and B) have landed
    __syncthreads();     // ... for every thread; the previous head's product is done with U
    // the three terms of (w_p dt_p) x_p, w_p = exp(L_last - L_p); zero past
    // the chunk
    constexpr int CH = D::HD / 8;
    for (int i = tid; i < D::Q * CH; i += THREADS) {
      const int p = i / CH, d0 = i % CH * 8;
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(Xs + p * LU + d0), v);
      const float wd = p < Q ? expf(Llast - L[p]) * dh[p] : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= wd;
      split_store<8>(U + p * LU + d0, (size_t)D::Q * LU, v);
    }
    __syncthreads();  // U is written; Xs is free
    if (hh + 1 < nhb)
      stage_bf16<EX, D::HD, LU>(Xs, x0 + (size_t)(h + 1) * hd, (size_t)nh * hd, D::Q, Q, hd, tid);
    cp_async_commit();

    // S_loc^T[s][d] = sum_p B[p][s] (w dt x)[p][d]
    float acc[WM][2 * WN][4] = {};
    mma_tile<WM, WN, 1, 3, true, true>(acc, K, Bs, LB, 0, U, LU, (size_t)D::Q * LU, m0, n0,
                                       lane);
    const size_t slot = ((size_t)b * NS + c) * nh + h;
    float* out = ws + slot * E;
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < 2 * WN; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int s = m0 + 16 * i + g + 8 * r, d = n0 + 8 * j + 2 * t;
          if constexpr (EX) {
            *reinterpret_cast<float2*>(out + s * D::HD + d) =
                make_float2(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
          } else {
            if (s < ds && d < hd) out[(size_t)s * hd + d] = acc[i][j][2 * r];
            if (s < ds && d + 1 < hd) out[(size_t)s * hd + d + 1] = acc[i][j][2 * r + 1];
          }
        }
    if (tid == 0) ws[(size_t)Bsz * NS * nh * E + slot] = Llast;
  }
}

// Phase 3 on the tensor cores: y of QR query rows of a chunk, for every
// head of the block.
template <int CQ, int CHD, int CDS>
__global__ void __launch_bounds__(THREADS, CQ > 0 ? 2 : 1)
ssd_chunk_outputs_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm, const float* __restrict__ ws,
                     bf16* __restrict__ y, int T_, int NS, int nh, int hd_rt, int ds_rt,
                     int Q_rt) {
  using D = TcDims<CQ, CHD, CDS>;
  constexpr bool EX = D::EX;
  constexpr int LB = D::LB, LU = D::LU, LM = D::LM;
  constexpr int YN = D::HD / 32;  // a warp's 16-column tiles of y: 16 rows by HD / 2
  const int Q = EX ? CQ : Q_rt, hd = EX ? CHD : hd_rt, ds = EX ? CDS : ds_rt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);                  // QR x LB, C[q][s]
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + D::P3_R);        // Q x LB, B[p][s]
  bf16* St = Ks;                                                  // 3 x DS x LU, S_in^T[s][d]
  bf16* Mt = Ks;                                                  // 3 x QR x LM, M'[q][p]
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw + D::P3_X);        // Q x LU, x[p][d]
  float* dts = reinterpret_cast<float*>(smem_raw + D::P3_VEC);   // HB x Q
  float* Ls = dts + HB * D::Q;                                    // HB x Q

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int NR = (Q + QR - 1) / QR;
  const int c = blockIdx.x / NR, q0 = blockIdx.x % NR * QR;
  const int h0 = blockIdx.y * HB, b = blockIdx.z;
  const int nq = min(QR, Q - q0);  // real query rows of the block
  const int P = min(Q, q0 + QR);   // keys they attend to
  const int P16 = (P + 15) / 16 * 16, K_ds = EX ? D::DS : (ds + 15) / 16 * 16;
  const size_t row0 = (size_t)b * T_ + (size_t)c * Q;
  const size_t E = (size_t)hd * ds;

  // C . B^T of the block's rows against keys [0, P): a warp's 32 x 32 tile
  const int nhb = min(HB, nh - h0);
  stage_bf16<EX, D::DS, LB>(Cs, Cm + (row0 + q0) * ds, ds, QR, nq, ds, tid);
  // (whole 32-key tiles of the warps that compute: rows past P zero)
  stage_bf16<EX, D::DS, LB>(Ks, Bm + row0 * ds, ds, (P + 31) / 32 * 32, P, ds, tid);
  cp_async_commit();
  chunk_cumsums<D::Q>(dts, Ls, dt, A, row0, Q, nh, h0, nhb, tid);
  cp_async_wait<0>();
  __syncthreads();
  const int cm0 = 32 * (warp % 2), cn0 = 32 * (warp / 2);
  const bool cb_live = cn0 < P16;
  float cb[2][4][4] = {};
  if (cb_live) mma_tile<2, 2, 1, 1, false, false>(cb, K_ds, Cs, LB, 0, Ks, LB, 0, cm0, cn0, lane);

  const int ym0 = 16 * (warp % 4), yn0 = D::HD / 2 * (warp / 4);
  const int K_intra = min(P16, q0 + ym0 + 16);  // the keys the warp's rows see
#pragma unroll 1
  for (int hh = 0; hh < nhb; ++hh) {
    const int h = h0 + hh;
    const float* dh = dts + hh * D::Q;
    const float* L = Ls + hh * D::Q;
    __syncthreads();  // C . B^T is done with Ks; the previous head is done with the region and x
    stage_bf16<EX, D::HD, LU>(Xs, x + row0 * nh * hd + (size_t)h * hd, (size_t)nh * hd, P16, P,
                              hd, tid);
    cp_async_commit();
    float acc[1][2 * YN][4] = {};
    if (c > 0) {  // inter-chunk: y[q][d] = exp(L_q) sum_s C[q][s] S_in[d][s]
      const float* Sg = ws + (((size_t)b * NS + c - 1) * nh + h) * E;  // slot c - 1
      if constexpr (EX) {
        // the split of S_in^T, the loads of a batch of 4 float4s a thread in
        // flight together
        constexpr int SN = D::DS * D::HD / 4 / THREADS, SB = SN < 4 ? SN : 4;
#pragma unroll 1
        for (int k0 = 0; k0 < SN; k0 += SB) {
          float4 sv[SB];
#pragma unroll
          for (int k = 0; k < SB; ++k)
            sv[k] = reinterpret_cast<const float4*>(Sg)[tid + (k0 + k) * THREADS];
#pragma unroll
          for (int k = 0; k < SB; ++k) {
            const int i = tid + (k0 + k) * THREADS, s = i / (D::HD / 4), d0 = i % (D::HD / 4) * 4;
            const float v[4] = {sv[k].x, sv[k].y, sv[k].z, sv[k].w};
            split_store<4>(St + s * LU + d0, (size_t)D::DS * LU, v);
          }
        }
      } else {
        for (int i = tid; i < D::DS * D::HD; i += THREADS) {
          const int s = i / D::HD, d = i % D::HD;
          bf16* st = St + s * LU + d;
          split3(s < ds && d < hd ? Sg[(size_t)s * hd + d] : 0.f, st[0], st[D::DS * LU],
                 st[2 * D::DS * LU]);
        }
      }
      __syncthreads();
      mma_tile<1, YN, 1, 3, false, true>(acc, K_ds, Cs, LB, 0, St, LU, (size_t)D::DS * LU, ym0,
                                         yn0, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + ym0 + g + 8 * r;
        const float e = q < Q ? expf(L[q]) : 0.f;
#pragma unroll
        for (int j = 0; j < 2 * YN; ++j) acc[0][j][2 * r] *= e, acc[0][j][2 * r + 1] *= e;
      }
      __syncthreads();  // every warp is done with S_in^T before M' takes the region
    }

    // intra-chunk: M'[q][p] = (q >= p) exp(min(L_q - L_p, 0)) (C B^T)[q][p]
    // dt_p, from the C . B^T fragment, split; y += M' x.  The L of the
    // thread's 4 rows, and of each pair of its columns with their dt, are
    // read once (indices clamped into the chunk) and the mask selects,
    // without branches.
    if (cb_live) {
      float Lq[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) Lq[i][r] = L[min(q0 + cm0 + 16 * i + g + 8 * r, Q - 1)];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = cn0 + 8 * j + 2 * t;
        const float Lp[2] = {L[min(p, Q - 1)], L[min(p + 1, Q - 1)]}, dp[2] = {dh[p], dh[p + 1]};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int ql = cm0 + 16 * i + g + 8 * r, qq = q0 + ql;
            float m[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = cb[i][j][2 * r + e] * expf(fminf(Lq[i][r] - Lp[e], 0.f)) * dp[e];
              m[e] = qq >= p + e && qq < Q ? v : 0.f;
            }
            bf16 h0_, m0_, l0_, h1_, m1_, l1_;
            split3(m[0], h0_, m0_, l0_);
            split3(m[1], h1_, m1_, l1_);
            uint32_t* dst = reinterpret_cast<uint32_t*>(Mt + ql * LM + p);
            constexpr int TS = QR * LM / 2;  // a term's 32-bit words
            dst[0] = pack_bf16(h0_, h1_);
            dst[TS] = pack_bf16(m0_, m1_);
            dst[2 * TS] = pack_bf16(l0_, l1_);
          }
      }
    }
    cp_async_wait<0>();  // x has landed
    __syncthreads();
    mma_tile<1, YN, 3, 1, false, true>(acc, K_intra, Mt, LM, (size_t)QR * LM, Xs, LU, 0, ym0,
                                       yn0, lane);

    bf16* yh = y + (row0 + q0) * nh * hd + (size_t)h * hd;
#pragma unroll
    for (int j = 0; j < 2 * YN; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = ym0 + g + 8 * r, d = yn0 + 8 * j + 2 * t;
        if constexpr (EX) {
          *reinterpret_cast<__nv_bfloat162*>(yh + (size_t)q * nh * D::HD + d) =
              __floats2bfloat162_rn(acc[0][j][2 * r], acc[0][j][2 * r + 1]);
        } else {
          if (q < nq && d < hd) yh[(size_t)q * nh * hd + d] = __float2bfloat16_rn(acc[0][j][2 * r]);
          if (q < nq && d + 1 < hd)
            yh[(size_t)q * nh * hd + d + 1] = __float2bfloat16_rn(acc[0][j][2 * r + 1]);
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

// The phase-1 and phase-3 kernels of x's type and their byte layout:
// float32 on the CUDA cores, bfloat16 on the tensor cores.
template <typename T, int CQ, int CHD, int CDS>
struct Route {
  using D = Dims<CQ, CHD, CDS>;
  static constexpr auto states = ssd_chunk_states<CQ, CHD, CDS>;
  static constexpr auto outputs = ssd_chunk_outputs<CQ, CHD, CDS>;
};
template <int CQ, int CHD, int CDS>
struct Route<bf16, CQ, CHD, CDS> {
  using D = TcDims<CQ, CHD, CDS>;
  static constexpr auto states = ssd_chunk_states_tc<CQ, CHD, CDS>;
  static constexpr auto outputs = ssd_chunk_outputs_tc<CQ, CHD, CDS>;
};

// Launch the phases in `mask` (bit 0: chunk states, 1: state pass, 2: chunk
// outputs).  Phases 1 and 2 run only when there is a state to make: more
// than one chunk, or a final state (`state` not null).
template <typename T, int CQ, int CHD, int CDS>
int launch(int mask, const void* x, const void* dt, const void* A, const void* B, const void* C,
           void* y, void* ws, void* state, int Bsz, int T_, int nh, int hd, int ds, int Q,
           void* stream) {
  using R = Route<T, CQ, CHD, CDS>;
  using D = typename R::D;
  const cudaStream_t s = (cudaStream_t)stream;
  const int NC = T_ / Q, NHB = (nh + HB - 1) / HB, NR = (Q + QR - 1) / QR, E = hd * ds;
  const int NS = NC - 1 + (state != nullptr);
  cudaError_t err = cudaSuccess;
  if ((mask & 1) && NS > 0) {
    const auto states = R::states;
    if ((err = allow_smem(states, D::P1_BYTES)) != cudaSuccess) return (int)err;
    states<<<dim3(NS, NHB, Bsz), THREADS, D::P1_BYTES, s>>>(
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
    const auto outputs = R::outputs;
    if ((err = allow_smem(outputs, D::P3_BYTES)) != cudaSuccess) return (int)err;
    outputs<<<dim3(NC * NR, NHB, Bsz), THREADS, D::P3_BYTES, s>>>(
        (const T*)x, (const float*)dt, (const float*)A, (const T*)B, (const T*)C,
        (const float*)ws, (T*)y, T_, NS, nh, hd, ds, Q);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int CQ, int CHD, int CDS>
struct Shape {
  static constexpr int q = CQ, hd = CHD, ds = CDS;
};

// f(Shape) of the instantiation that (Q, hd, ds) takes
template <typename F>
auto by_shape(int Q, int hd, int ds, F&& f) {
  if (Q == 128 && hd == 64 && ds == 128) return f(Shape<128, 64, 128>{});  // mamba2's
  if (Q == 128 && hd == 64 && ds == 64) return f(Shape<128, 64, 64>{});    // zamba2-7b's
  return f(Shape<0, 0, 0>{});
}

template <typename T>
int dispatch(int mask, const void* x, const void* dt, const void* A, const void* B,
             const void* C, void* y, void* ws, void* state, int Bsz, int T_, int nh, int hd,
             int ds, int Q, void* stream) {
  if (Q < 1 || hd < 1 || ds < 1 || Q > MAXD || hd > MAXD || ds > MAXD || T_ % Q)
    return (int)cudaErrorInvalidValue;
  return by_shape(Q, hd, ds, [&](auto S) {
    using Sh = decltype(S);
    return launch<T, Sh::q, Sh::hd, Sh::ds>(mask, x, dt, A, B, C, y, ws, state, Bsz, T_, nh, hd,
                                            ds, Q, stream);
  });
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
int attrs(int phase, int Q, int hd, int ds, int* out) {
  return by_shape(Q, hd, ds, [&](auto S) {
    using Sh = decltype(S);
    using R = Route<T, Sh::q, Sh::hd, Sh::ds>;
    out[4] = Sh::q, out[5] = Sh::hd, out[6] = Sh::ds;
    switch (phase) {
      case 1: return attrs_of(R::states, R::D::P1_BYTES, out);
      case 2: return attrs_of(ssd_state_pass<4>, 0, out);
      case 3: return attrs_of(R::outputs, R::D::P3_BYTES, out);
      default: return (int)cudaErrorInvalidValue;
    }
  });
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
  return dispatch<bf16>(7, x, dt, A, B, C, y, ws, state, Bsz, T, nh, hd, ds, Q, stream);
}

// One phase (1, 2 or 3) alone, for timing each: the phases before it must
// have run on the same workspace and `state` (null or not).
extern "C" int ssd_scan_phase(int phase, int is_bf16, const void* x, const void* dt, const void* A,
                              const void* B, const void* C, void* y, void* ws, void* state,
                              int Bsz, int T, int nh, int hd, int ds, int Q, void* stream) {
  if (phase < 1 || phase > 3) return (int)cudaErrorInvalidValue;
  const int mask = 1 << (phase - 1);
  return is_bf16 ? dispatch<bf16>(mask, x, dt, A, B, C, y, ws, state, Bsz, T, nh, hd, ds, Q,
                                  stream)
                    : dispatch<float>(mask, x, dt, A, B, C, y, ws, state, Bsz, T, nh, hd, ds, Q,
                                   stream);
}

// The dynamic shared memory of the largest phase of the instantiation
// (Q, hd, ds) takes in x's type, for the wrapper's check.
extern "C" long long ssd_scan_smem_bytes(int Q, int hd, int ds, int is_bf16) {
  return by_shape(Q, hd, ds, [&](auto S) {
    using Sh = decltype(S);
    return (long long)(is_bf16 ? TcDims<Sh::q, Sh::hd, Sh::ds>::SMEM
                               : Dims<Sh::q, Sh::hd, Sh::ds>::SMEM);
  });
}

// out[0..3]: registers, local (spill) bytes a thread, dynamic shared bytes
// and blocks an SM of phase 1, 2 or 3 at the instantiation that (Q, hd,
// ds) takes; out[4..6]: that instantiation's (Q, hd, ds), all 0 for the
// generic one.
extern "C" int ssd_scan_attrs(int phase, int is_bf16, int Q, int hd, int ds, int* out) {
  return is_bf16 ? attrs<bf16>(phase, Q, hd, ds, out) : attrs<float>(phase, Q, hd, ds, out);
}
