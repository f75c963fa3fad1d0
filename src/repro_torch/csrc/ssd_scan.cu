// Mamba2 SSD chunked scan, forward (no backward).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` (src/repro/kernels/ssd_scan/
// kernel.py), the full-sequence forward of the SSM backbone.  x is
// (Bsz, T, nh, hd) in float32 or bfloat16, dt (Bsz, T, nh) float32 after the
// softplus, A (nh,) float32 and negative, B and C (Bsz, T, ds) in x's type
// (one group shared by all heads).  T is a multiple of the chunk Q.  The
// output y is (Bsz, T, nh, hd) in x's type.
//
// Per (batch, head) the chunks are walked in order and the float32 state
// S (hd, ds) is carried in shared memory across them.  Per chunk, with
// u = dt * x and L the inclusive cumsum of dt * A:
//   y = exp(L) (C . S_prev^T) + tril(exp(min(L_q - L_p, 0)) (C . B^T)) . u
//   S = exp(L_last) S_prev + sum_p (exp(L_last - L_p) u_p) B_p^T
// all in float32.  The clamp min(., 0) keeps the masked (p > q) entries
// from overflowing exp.
//
// Bound: operations.  At mamba2-2.7b width (hd 64, ds 128, Q 128) a chunk
// of one head does about 5 M multiply-adds on 40 KB of inputs (bf16): C.B^T
// 2 M, the intra-chunk product, the inter-chunk product and the state
// update 1 M each.  This first version runs them on the CUDA cores in
// float32, so its ceiling is the 67 TFLOP/s float32 rate and in practice the
// shared-memory loads that feed the FMAs.  It recomputes C.B^T for every
// head, where the reference computes it once per block of heads: 80 heads
// share one B and C, so 40% of its operations repeat work.
//
// Design: one block of 256 threads per (head, batch row), a 16 x 16 thread
// grid.  Each matrix product gives a thread a register tile of up to 8 x 8
// outputs (rows ty + 16 i, columns tx + 16 j), fed from shared memory:
// the chunk's B and C in x's type, u in float32, the state in float32, and
// a Q x 32 tile of the decayed, masked scores at a time.  Rows read 16 at a
// time at one column are padded to an odd word stride.  Q, hd and ds are at
// most 128 each.  The main path's (Q, hd, ds) = (128, 64, 128) has its own
// instantiation with the sizes as constants: register tiles of exactly its
// size and no run-time guards.  The generic instantiation guards every
// element of its 8 x 8 tiles at run time and is much slower.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PT = 32;     // key columns of a score tile
constexpr int MAXD = 128;  // largest Q, hd and ds: 8 register rows of 16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> struct Pad { static constexpr int value = 1; };
template <> struct Pad<__nv_bfloat16> { static constexpr int value = 2; };

struct Layout {
  int ldS, ldB;  // row strides of the state and of B, in elements
  size_t off_B, off_C, off_u, off_M, off_vec, bytes;
};

template <typename T>
__host__ __device__ Layout layout(int Q, int hd, int ds) {
  Layout l;
  l.ldS = ds + 1;
  l.ldB = ds + Pad<T>::value;
  size_t off = (size_t)hd * l.ldS * sizeof(float);        // state, float32
  l.off_B = off;
  off += ((size_t)Q * l.ldB * sizeof(T) + 15) / 16 * 16;  // B, x's type
  l.off_C = off;
  off += ((size_t)Q * ds * sizeof(T) + 15) / 16 * 16;     // C, x's type
  l.off_u = off;
  off += (size_t)Q * hd * sizeof(float);                  // u = dt x
  l.off_M = off;
  off += (size_t)Q * PT * sizeof(float);                  // score tile
  l.off_vec = off;
  off += (size_t)4 * Q * sizeof(float);                   // dt, L, exp(L), w
  l.bytes = off;
  return l;
}

// acc[i][j] += sum_k a(ty + 16 i, k) * b(tx + 16 j, k) over the thread's
// register tile.  EX: M and N are multiples of 16 known at compile time,
// so every guard folds away; otherwise rows >= M and columns >= N are
// guarded at run time.
template <bool EX, int MI, int NJ, class FA, class FB>
__device__ __forceinline__ void mma_acc(float (&acc)[MI][NJ], int M, int N, int K, int ty,
                                        int tx, FA a, FB b) {
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float av[MI], bv[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      av[i] = (EX ? 16 * i < M : ty + 16 * i < M) ? a(ty + 16 * i, kk) : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      bv[j] = (EX ? 16 * j < N : tx + 16 * j < N) ? b(tx + 16 * j, kk) : 0.f;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (EX || (16 * i < M && 16 * j < N)) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MI][NJ]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

// CQ, CHD, CDS: the chunk, head_dim and state as compile-time constants
// (multiples of 16, the main path's shape), or all 0 for the generic
// version that takes them at run time, each up to 128.
template <typename T, int CQ, int CHD, int CDS>
__global__ void __launch_bounds__(THREADS)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
        const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y, int T_, int nh,
        int hd_rt, int ds_rt, int Q_rt) {
  constexpr bool EX = CQ > 0;
  constexpr int QI = EX ? CQ / 16 : MAXD / 16;   // register rows over the chunk
  constexpr int HI = EX ? CHD / 16 : MAXD / 16;  // ... over head_dim
  constexpr int SI = EX ? CDS / 16 : MAXD / 16;  // ... over the state
  const int Q = EX ? CQ : Q_rt, hd = EX ? CHD : hd_rt, ds = EX ? CDS : ds_rt;
  const Layout lay = layout<T>(Q, hd, ds);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* St = reinterpret_cast<float*>(smem_raw);              // hd x ldS
  T* Bs = reinterpret_cast<T*>(smem_raw + lay.off_B);          // Q x ldB
  T* Cs = reinterpret_cast<T*>(smem_raw + lay.off_C);          // Q x ds
  float* us = reinterpret_cast<float*>(smem_raw + lay.off_u);  // Q x hd
  float* Ms = reinterpret_cast<float*>(smem_raw + lay.off_M);  // Q x PT
  float* dts = reinterpret_cast<float*>(smem_raw + lay.off_vec);
  float* Ls = dts + Q;
  float* eL = Ls + Q;    // exp(L)
  float* wl = eL + Q;    // exp(L_last - L)
  const int ldS = lay.ldS, ldB = lay.ldB;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const float Ah = A[h];

  for (int i = tid; i < hd * ldS; i += THREADS) St[i] = 0.f;

  for (int c0 = 0; c0 < T_; c0 += Q) {
    const long long row0 = (long long)b * T_ + c0;  // (b, t) row of the chunk's first step
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = tid; i < Q; i += THREADS) dts[i] = dt[(row0 + i) * nh + h];
#pragma unroll 4
    for (int i = tid; i < Q * ds; i += THREADS) {
      const int p = i / ds, s = i % ds;
      Bs[p * ldB + s] = Bm[(row0 + p) * ds + s];
      Cs[i] = Cm[(row0 + p) * ds + s];
    }
#pragma unroll 4
    for (int i = tid; i < Q * hd; i += THREADS) {
      const int p = i / hd, d = i % hd;
      us[i] = to_f32(x[((row0 + p) * nh + h) * hd + d]);
    }
    __syncthreads();

    // L = inclusive cumsum of dt A: each lane of warp 0 sums a run of
    // steps, a shuffle scan adds the runs of the lanes before it
    if (tid < 32) {
      const int per = (Q + 31) / 32, lo = min(tid * per, Q), hi = min(lo + per, Q);
      float run = 0.f;
      for (int p = lo; p < hi; ++p) {
        run = __fadd_rn(run, __fmul_rn(dts[p], Ah));  // dt A rounded, as the reference
        Ls[p] = run;
      }
      float scan = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, scan, off);
        if (tid >= off) scan += o;
      }
      float before = __shfl_up_sync(0xffffffffu, scan, 1);
      if (tid == 0) before = 0.f;
      for (int p = lo; p < hi; ++p) Ls[p] += before;
    }
    for (int i = tid; i < Q * hd; i += THREADS) us[i] *= dts[i / hd];
    __syncthreads();
    const float Llast = Ls[Q - 1];
    for (int p = tid; p < Q; p += THREADS) {
      eL[p] = expf(Ls[p]);
      wl[p] = expf(Llast - Ls[p]);
    }
    __syncthreads();

    // inter-chunk: y[q][d] = exp(L_q) sum_s C[q][s] S_prev[d][s]
    float acc[QI][HI];
    zero(acc);
    mma_acc<EX>(acc, Q, hd, ds, ty, tx,
                [&](int q, int s) { return to_f32(Cs[q * ds + s]); },
                [&](int d, int s) { return St[d * ldS + s]; });
#pragma unroll
    for (int i = 0; i < QI; ++i) {
      const float e = ty + 16 * i < Q ? eL[ty + 16 * i] : 0.f;
#pragma unroll
      for (int j = 0; j < HI; ++j) acc[i][j] *= e;
    }

    // intra-chunk, one Q x PT tile of keys at a time:
    // M[q][p] = (q >= p) exp(min(L_q - L_p, 0)) sum_s C[q][s] B[p][s]; y += M u
    for (int p0 = 0; p0 < Q; p0 += PT) {
      const int np = EX ? PT : min(PT, Q - p0);
      float sc[QI][PT / 16];
      zero(sc);
      mma_acc<EX>(sc, Q, np, ds, ty, tx,
                  [&](int q, int s) { return to_f32(Cs[q * ds + s]); },
                  [&](int p, int s) { return to_f32(Bs[(p0 + p) * ldB + s]); });
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        const int q = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < PT / 16; ++j) {
          const int p = tx + 16 * j, pp = p0 + p;
          if (q < Q && p < np) {
            const float decay = expf(fminf(Ls[q] - Ls[pp], 0.f));
            Ms[q * PT + p] = q >= pp ? sc[i][j] * decay : 0.f;
          }
        }
      }
      __syncthreads();
      mma_acc<EX>(acc, Q, hd, np, ty, tx,
                  [&](int q, int p) { return Ms[q * PT + p]; },
                  [&](int d, int p) { return us[(p0 + p) * hd + d]; });
      __syncthreads();  // Ms is rewritten by the next tile
    }

#pragma unroll
    for (int i = 0; i < QI; ++i) {
      const int q = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < HI; ++j) {
        const int d = tx + 16 * j;
        if (q < Q && d < hd) y[((row0 + q) * nh + h) * hd + d] = from_f32<T>(acc[i][j]);
      }
    }

    // state: S[d][s] = exp(L_last) S_prev[d][s] + sum_p (w_p u[p][d]) B[p][s];
    // a thread owns its (d, s) entries, read and written by it alone
    float st[HI][SI];
    zero(st);
    mma_acc<EX>(st, hd, ds, Q, ty, tx,
                [&](int d, int p) { return us[p * hd + d] * wl[p]; },
                [&](int s, int p) { return to_f32(Bs[p * ldB + s]); });
    const float eLast = expf(Llast);
#pragma unroll
    for (int i = 0; i < HI; ++i) {
      const int d = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < SI; ++j) {
        const int s = tx + 16 * j;
        if (d < hd && s < ds) St[d * ldS + s] = eLast * St[d * ldS + s] + st[i][j];
      }
    }
  }
}

template <typename T, int CQ, int CHD, int CDS>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
           int Bsz, int T_, int nh, int hd, int ds, int Q, void* stream) {
  const size_t smem = layout<T>(Q, hd, ds).bytes;
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd<T, CQ, CHD, CDS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nh, Bsz);
  ssd_fwd<T, CQ, CHD, CDS><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B, (const T*)C, (T*)y, T_, nh,
      hd, ds, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
             int Bsz, int T_, int nh, int hd, int ds, int Q, void* stream) {
  if (Q < 1 || hd < 1 || ds < 1 || Q > MAXD || hd > MAXD || ds > MAXD || T_ % Q)
    return (int)cudaErrorInvalidValue;
  if (Q == 128 && hd == 64 && ds == 128)  // mamba2's chunk, head_dim and state
    return launch<T, 128, 64, 128>(x, dt, A, B, C, y, Bsz, T_, nh, hd, ds, Q, stream);
  return launch<T, 0, 0, 0>(x, dt, A, B, C, y, Bsz, T_, nh, hd, ds, Q, stream);
}

}  // namespace

extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, void* y, int Bsz, int T, int nh, int hd, int ds,
                            int Q, void* stream) {
  return dispatch<float>(x, dt, A, B, C, y, Bsz, T, nh, hd, ds, Q, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* B,
                             const void* C, void* y, int Bsz, int T, int nh, int hd, int ds,
                             int Q, void* stream) {
  return dispatch<__nv_bfloat16>(x, dt, A, B, C, y, Bsz, T, nh, hd, ds, Q, stream);
}

// The dynamic shared memory a launch needs, for the wrapper's check.
extern "C" long long ssd_scan_smem_bytes(int Q, int hd, int ds, int bf16) {
  return (long long)(bf16 ? layout<__nv_bfloat16>(Q, hd, ds).bytes
                          : layout<float>(Q, hd, ds).bytes);
}
