// Weighted average over the agent axis: out[n] = sum_b w[b] * x[b, n].
//
// Replaces the Pallas TPU kernel `_fedavg_kernel` (src/repro/kernels/fedavg/
// kernel.py), the intermediary's eq. (2) reduce of an uncompressed FedAvg
// sync.  x is the (B, N) agent-stacked bucket of one parameter subtree, in
// float32 or bfloat16; w is (B,) float32; out is (N,) in x's type.
//
// Bound: bytes.  Each x element is read once and used for one multiply and
// one add, about 0.5 flop per byte in f32, far below the H100's ridge.  At
// the FedGAN ACGAN generator bucket (B = 5, N = 2,314,435, f32) the kernel
// must move 6 * N * 4 bytes = 55.5 MB, 16.6 us at 3.35 TB/s.
//
// Design: one thread per column n, grid-stride.  Neighbouring threads read
// neighbouring addresses of each agent row, so every load is coalesced and
// x is streamed exactly once; nothing is staged in shared memory because
// nothing is reused.  The sum runs in agent order in float32 with explicit
// round-to-nearest multiply and add (__fmul_rn / __fadd_rn) so the compiler
// cannot contract them into an FMA: the products are rounded before the
// sum, as in the plain PyTorch version and the JAX reference.
//
// Three more routes port XLA reduces of the reference's collectives, not a
// Pallas kernel; each is bit-identical to the reference on its own CPU:
//
// * The wire route (fedavg_wire_bf16, fedavg_wire_f16) replaces
//   repro.dist.collectives.weighted_mean on a bfloat16 or float16 leaf (the
//   leaves of a sync_dtype cast), which computes in the leaf's type: w is
//   rounded to T, each product w_T[b] * x[b, n] is rounded to T, the
//   products are summed in float32 in agent order from +0 and the sum is
//   rounded to T.  The product of two T values is exact in float32, so
//   __fmul_rn followed by the rounding to T is the correctly rounded
//   product.  Bound: bytes, 2 * (B + 1) * N in and out; at the generator
//   bucket (B = 5) 12 N bytes, 8.3 us at 3.35 TB/s.
// * The pod route (fedavg_pod_f32) replaces collectives.average_intra_pod,
//   the tier-1 reduce of hierarchical sync: per pod p, w_intra[p, a] =
//   w[p, a] / s_p (s_p the row summed in order from w[p, 0]; __fdiv_rn),
//   then out[p, n] = a chain of fused multiply-adds over a in agent order
//   from +0 (__fmaf_rn), which is what the reference's einsum computes on
//   XLA's CPU backend.  Bound: bytes, 4 * (P * A + P) * N; at the generator
//   bucket on a (2, 4) grid 27.6 us.
// * The low-precision pod route (fedavg_pod_bf16, fedavg_pod_f16) replaces
//   the same einsum on a bfloat16 or float16 leaf (a model built with
//   param_dtype bfloat16 or float16), which XLA computes in the leaf's type
//   T: w_intra as above, rounded to T once a block; both operands widened
//   to float32; the same fused multiply-add chain from +0 in agent order;
//   the sum rounded to T once.  A product of two T values is exact in
//   float32 (8 + 8 or 11 + 11 significant bits of 24, unless a bfloat16
//   product falls below float32's normal range), so the fused chain and a
//   multiply-then-add chain give the same bits.  Bound: bytes, P * A * N *
//   2 read plus P * N * 2 written; at the generator bucket on a (2, 4)
//   grid 20 N bytes, 13.8 us.
//
// The routes share one kernel, rows_kernel<Op, NB>, built for the memory
// system.  A thread reading one 2- or 4-byte element of each row moves 64
// or 128 bytes a warp request, and a runtime agent count leaves each load
// behind the running sum; the kernel instead:
//
// 1. Gives each lane 16 bytes of output columns (8 bf16/f16 or 4 f32
//    values) and loads each agent row with one aligned 16-byte load a lane,
//    the 32 lanes of a warp on 512 contiguous bytes.  Columns line up
//    across rows, so row r's misalignment s_r = (address of its first
//    column in the span) mod 16 is the same for every lane of the warp.  At
//    the production bucket N = 2,314,435 is odd: the bf16 rows start at
//    byte offsets 0, 6, 12, 2, 8 (mod 16), rows 1 and 3 not even 4-byte
//    aligned, and the f32 rows of a (2, 4) grid at 0, 12, 8, 4, 0, 12, 8, 4.
//    So a lane cannot load its own 16 bytes directly: it loads the aligned
//    word holding its first byte, takes the next aligned word from lane + 1
//    (__shfl_down_sync), and picks its 16 bytes out of the 32 with two
//    word selects and a funnel shift (realign).  s_r is warp-uniform, so
//    nothing diverges.  Lanes 0..30 each sum a chunk; lane 31 only loads
//    the word lane 30 needs (a warp's span is 31 chunks, 496 bytes of a
//    row).  The first version, in which lane 31 summed a chunk too and
//    loaded its neighbour word itself, held 4 x G more registers a thread,
//    fit 2 blocks an SM and ran 2-9% slower at the generator bucket
//    (PERF.md).  A word that would reach outside the tensor's own bytes
//    [x, x + size) (only the first row's head and the last row's tail
//    can) is assembled from the 2-byte halves inside it, zeros
//    elsewhere; no load reads outside.  Chunks follow the output row's
//    alignment, so every store is one aligned 16-byte store; the output
//    row's head and tail (fewer than 16 bytes each) take one thread a
//    column.
// 2. Issues every agent's load of a span before the first add: the agent
//    loop is unrolled at compile time for NB = 1..8 rows (a switch in the
//    launcher picks the instantiation); beyond 8 the rows are taken in
//    unrolled groups of 8 (NB = 0), so B = 16 or 33 and pods of 9 agents
//    take the same route.  The adds keep agent order.  With NB rows the
//    first span's loads are issued before the block's weights are
//    computed, so the two latencies overlap.
// 3. Sizes the grid to fill the card once (SMs x resident blocks, from
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor, capped by the work;
//    the launch bounds hold every instantiation to 3 blocks of 256 threads
//    an SM), a pod's spans grid-strided over the blocks given to it; P pods
//    are folded into that grid (no grid y dimension).  x is read
//    evict-first (__ldcs) and out written streaming (__stcs): each byte is
//    touched once.
// 4. Computes the weights once a block into shared memory: the wire route
//    w[b] rounded to T, the pod routes s_p and w_intra[p, a] with the same
//    __fadd_rn chain and __fdiv_rn as before (the low-precision pod routes
//    round them to T there), so each element costs one multiply-add chain
//    step per agent and the bits are unchanged.  The element type's loads
//    and stores (Half2 for 2-byte types, Pod for float32) are separate from
//    the arithmetic (WireMath, PodMath), so the bf16/f16 pod routes share
//    the wire route's loads and the float32 pod route's weights.
//
// fedavg_attrs reports each instantiation's registers, local bytes and
// blocks an SM.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// v rounded to T and back: exact in float32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T>
__global__ void fedavg_kernel(const float* __restrict__ w, const T* __restrict__ x,
                              T* __restrict__ out, int B, long long N) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N; n += stride) {
    float acc = 0.f;
    for (int b = 0; b < B; ++b) {
      acc = __fadd_rn(acc, __fmul_rn(w[b], to_f32(x[(long long)b * N + n])));
    }
    out[n] = from_f32<T>(acc);
  }
}


// ---- The wire and pod routes ---------------------------------------------

constexpr int kWarps = 8;               // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 8;               // agent rows whose loads are in flight at once
constexpr int kRoutes = kGroup + 1;     // instantiations a route: 1..8 rows, groups of 8
constexpr int kSpan = 31;               // chunks a warp sums at a time

template <typename T> __device__ __forceinline__ T from_bits(unsigned short u);
template <> __device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(unsigned short u) {
  return __ushort_as_bfloat16(u);
}
template <> __device__ __forceinline__ __half from_bits<__half>(unsigned short u) {
  return __ushort_as_half(u);
}
__device__ __forceinline__ unsigned to_bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ unsigned to_bits(__half v) { return __half_as_ushort(v); }

// The wire route's arithmetic in T = bfloat16 or float16: w[b] rounded to
// T, each product rounded to T, the sum in float32.
template <typename T>
struct WireMath {
  __device__ static void weights(const float* w, int, int rows, float* sw) {
    for (int a = threadIdx.x; a < rows; a += blockDim.x) sw[a] = round_to<T>(w[a]);
  }
  __device__ static float step(float acc, float wa, float x) {
    return __fadd_rn(acc, round_to<T>(__fmul_rn(wa, x)));
  }
};

// The pod route's arithmetic for leaves of type T: w[p, a] / s_p (s_p
// summed in order from w[p, 0] by one thread into sw[rows]) rounded to T
// (for float32 that rounds nothing), then a fused multiply-add chain.
template <typename T>
struct PodMath {
  __device__ static void weights(const float* w, int p, int rows, float* sw) {
    const float* wp = w + (long long)p * rows;
    if (threadIdx.x == 0) {
      float s = wp[0];
      for (int a = 1; a < rows; ++a) s = __fadd_rn(s, wp[a]);
      sw[rows] = s;
    }
    __syncthreads();
    for (int a = threadIdx.x; a < rows; a += blockDim.x) {
      sw[a] = round_to<T>(__fdiv_rn(wp[a], sw[rows]));
    }
  }
  __device__ static float step(float acc, float wa, float x) { return __fmaf_rn(wa, x, acc); }
};

// Elements of a 2-byte type T (bfloat16 or float16) under the arithmetic M.
template <typename T, typename M>
struct Half2 {
  static constexpr int kSize = 2;
  __device__ static void weights(const float* w, int p, int rows, float* sw) {
    M::weights(w, p, rows, sw);
  }
  __device__ static float scalar(const char* row, long long n) {
    return to_f32(from_bits<T>(__ldcs(reinterpret_cast<const unsigned short*>(row) + n)));
  }
  __device__ static float step(float acc, float wa, float x) { return M::step(acc, wa, x); }
  __device__ static void accumulate(float* acc, float wa, uint4 v) {
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[2 * k] = step(acc[2 * k], wa, to_f32(from_bits<T>((unsigned short)(u[k] & 0xffffu))));
      acc[2 * k + 1] = step(acc[2 * k + 1], wa, to_f32(from_bits<T>((unsigned short)(u[k] >> 16))));
    }
  }
  __device__ static void store(char* dst, const float* acc) {
    unsigned u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      u[k] = to_bits(from_f32<T>(acc[2 * k])) | (to_bits(from_f32<T>(acc[2 * k + 1])) << 16);
    }
    __stcs(reinterpret_cast<uint4*>(dst), make_uint4(u[0], u[1], u[2], u[3]));
  }
  __device__ static void store1(char* row, long long n, float acc) {
    reinterpret_cast<T*>(row)[n] = from_f32<T>(acc);
  }
};

template <typename T> using Wire = Half2<T, WireMath<T>>;
template <typename T> using PodLow = Half2<T, PodMath<T>>;

// The pod route on float32 elements.
struct Pod {
  static constexpr int kSize = 4;
  __device__ static void weights(const float* w, int p, int rows, float* sw) {
    PodMath<float>::weights(w, p, rows, sw);
  }
  __device__ static float step(float acc, float wa, float x) {
    return PodMath<float>::step(acc, wa, x);
  }
  __device__ static float scalar(const char* row, long long n) {
    return __ldcs(reinterpret_cast<const float*>(row) + n);
  }
  __device__ static void accumulate(float* acc, float wa, uint4 v) {
    acc[0] = step(acc[0], wa, __uint_as_float(v.x));
    acc[1] = step(acc[1], wa, __uint_as_float(v.y));
    acc[2] = step(acc[2], wa, __uint_as_float(v.z));
    acc[3] = step(acc[3], wa, __uint_as_float(v.w));
  }
  __device__ static void store(char* dst, const float* acc) {
    __stcs(reinterpret_cast<float4*>(dst), make_float4(acc[0], acc[1], acc[2], acc[3]));
  }
  __device__ static void store1(char* row, long long n, float acc) {
    reinterpret_cast<float*>(row)[n] = acc;
  }
};

// The aligned 16-byte word at address p, read evict-first.  A word that
// reaches outside [lo, hi), the tensor's own bytes (which begin and end on
// element boundaries), is assembled from its 2-byte halves inside, zeros
// elsewhere.
__device__ __forceinline__ uint4 load_word(unsigned long long p, unsigned long long lo,
                                           unsigned long long hi) {
  if (p >= lo && p + 16 <= hi) return __ldcs(reinterpret_cast<const uint4*>(p));
  unsigned u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned long long q = p + 2 * k;
    if (q >= lo && q + 2 <= hi) {
      u[k >> 1] |= (unsigned)__ldcs(reinterpret_cast<const unsigned short*>(q)) << (16 * (k & 1));
    }
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// Bytes [s, s + 16) of the 32 bytes a:b, s a multiple of 2: whole words
// by two selects (8 and 4 bytes), the last 2 bytes by a funnel shift.
__device__ __forceinline__ uint4 realign(uint4 a, uint4 b, unsigned s) {
  const unsigned c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned d[6], e[5];
#pragma unroll
  for (int k = 0; k < 6; ++k) d[k] = (s & 8) ? c[k + 2] : c[k];
#pragma unroll
  for (int k = 0; k < 5; ++k) e[k] = (s & 4) ? d[k + 1] : d[k];
  const unsigned bits = (s & 3) * 8;
  return make_uint4(__funnelshift_r(e[0], e[1], bits), __funnelshift_r(e[1], e[2], bits),
                    __funnelshift_r(e[2], e[3], bits), __funnelshift_r(e[3], e[4], bits));
}

__device__ __forceinline__ uint4 shfl_down1(uint4 v) {
  return make_uint4(__shfl_down_sync(0xffffffffu, v.x, 1), __shfl_down_sync(0xffffffffu, v.y, 1),
                    __shfl_down_sync(0xffffffffu, v.z, 1), __shfl_down_sync(0xffffffffu, v.w, 1));
}

// The aligned words of rows [g0, g0 + cnt) that hold the first byte of
// the chunk starting at column n0 of xp's rows, and each row's byte offset
// in its word (warp-uniform).
template <int G, int kSize>
__device__ __forceinline__ void load_rows(uint4 (&own)[G], unsigned (&sh)[G], const char* xp,
                                          long long N, long long n0, int g0, int cnt,
                                          unsigned long long lo, unsigned long long hi) {
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if (i < cnt) {
      const unsigned long long at = reinterpret_cast<unsigned long long>(xp) +
                                    (unsigned long long)(kSize * ((long long)(g0 + i) * N + n0));
      sh[i] = (unsigned)(at & 15);
      own[i] = load_word(at & ~15ull, lo, hi);
    }
  }
}

// x (P, rows, N) of Op's element type at any element-aligned address, out
// (P, N) from the wrapper's allocation; w as Op::weights reads it.  NB > 0:
// exactly NB rows a pod, unrolled; NB = 0: any count, in groups of kGroup.
// Blocks [p * per_pod, (p + 1) * per_pod) start on pod p and stride over
// the pods by gridDim.x / per_pod.  A warp's span is kSpan chunks: lanes
// 0..30 each sum one, lane 31 loads the word after lane 30's for it.
template <typename Op, int NB>
__global__ void __launch_bounds__(kThreads, 3)
rows_kernel(const float* __restrict__ w, const char* __restrict__ x, char* __restrict__ out,
            int P, int A, long long N, int per_pod) {
  extern __shared__ float sw[];
  constexpr int kSize = Op::kSize, V = 16 / kSize, G = NB ? NB : kGroup;
  const int rows = NB ? NB : A;
  const unsigned long long lo = reinterpret_cast<unsigned long long>(x);
  const unsigned long long hi = lo + (unsigned long long)kSize * P * rows * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int local = blockIdx.x % per_pod;
  for (int p = blockIdx.x / per_pod; p < P; p += gridDim.x / per_pod) {
    const char* xp = x + (long long)kSize * p * rows * N;
    char* op = out + (long long)kSize * p * N;
    // columns [head, tail) in whole 16-byte output chunks
    const unsigned long long op_off = reinterpret_cast<unsigned long long>(op) & 15;
    long long head = (long long)((16 - op_off) & 15) / kSize;
    head = head < N ? head : N;
    const long long chunks = (N - head) / V;
    const long long tail = head + chunks * V;
    const long long spans = (chunks + kSpan - 1) / kSpan;
    uint4 own[G];
    unsigned sh[G];
    long long sp = (long long)local * kWarps + warp;
    // with NB rows, the first span's loads are in flight while the block
    // computes the weights (with groups that costs more than it hides)
    bool loaded = NB > 0 && sp < spans;
    if (loaded) load_rows<G, kSize>(own, sh, xp, N, head + (sp * kSpan + lane) * V, 0,
                                    rows < G ? rows : G, lo, hi);
    __syncthreads();  // the block is done with the previous pod's weights
    Op::weights(w, p, rows, sw);
    __syncthreads();
    if (local == 0) {
      const long long scalars = head + (N - tail);
      for (long long t = threadIdx.x; t < scalars; t += blockDim.x) {
        const long long n = t < head ? t : tail + (t - head);
        float acc = 0.f;
        for (int a = 0; a < rows; ++a) {
          acc = Op::step(acc, sw[a], Op::scalar(xp, (long long)a * N + n));
        }
        Op::store1(op, n, acc);
      }
    }
    for (; sp < spans; sp += (long long)per_pod * kWarps) {
      const long long c = sp * kSpan + lane;  // this lane's chunk; lanes past the end
      const long long n0 = head + c * V;      // still load (bounded) for the shuffles
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.f;
      for (int g0 = 0; g0 < rows; g0 += G) {
        const int cnt = rows - g0 < G ? rows - g0 : G;  // warp-uniform
        if (!loaded) load_rows<G, kSize>(own, sh, xp, N, n0, g0, cnt, lo, hi);
        loaded = false;
#pragma unroll
        for (int i = 0; i < G; ++i) {
          if (i < cnt) {
            Op::accumulate(acc, sw[g0 + i], realign(own[i], shfl_down1(own[i]), sh[i]));
          }
        }
      }
      if (lane < kSpan && c < chunks) Op::store(op + kSize * n0, acc);
    }
  }
}

using RowsKernel = void (*)(const float*, const char*, char*, int, int, long long, int);

// Instantiation k of a route: k + 1 rows for k < kGroup, else groups of kGroup.
template <typename Op>
RowsKernel rows_route(int k) {
  switch (k) {
    case 0: return rows_kernel<Op, 1>;
    case 1: return rows_kernel<Op, 2>;
    case 2: return rows_kernel<Op, 3>;
    case 3: return rows_kernel<Op, 4>;
    case 4: return rows_kernel<Op, 5>;
    case 5: return rows_kernel<Op, 6>;
    case 6: return rows_kernel<Op, 7>;
    case 7: return rows_kernel<Op, 8>;
    default: return rows_kernel<Op, 0>;
  }
}

// The grid that fills the current card once: its SMs times the blocks of
// `kernel` resident on one with `smem` bytes of shared memory.
cudaError_t card_blocks(const void* kernel, size_t smem, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
          cudaSuccess) {
    return err;
  }
  *blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <typename Op>
int launch_rows(const void* w, const void* x, void* out, int P, int A, long long N,
                void* stream) {
  if (P < 1 || A < 1) return (int)cudaErrorInvalidValue;
  if (N < 1) return (int)cudaGetLastError();
  const RowsKernel kernel = rows_route<Op>(A <= kGroup ? A - 1 : kGroup);
  const size_t smem = (size_t)(A + 1) * sizeof(float);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess) {
    return (int)err;
  }
  long long blocks = 0;
  if ((err = card_blocks((const void*)kernel, smem, &blocks)) != cudaSuccess) return (int)err;
  // the spans of a pod's output row, 8 a block at most
  const long long spans = (N / (16 / Op::kSize) + kSpan - 1) / kSpan;
  const long long need = spans > kWarps ? (spans + kWarps - 1) / kWarps : 1;
  long long per_pod = 1;
  if (blocks >= P) {
    per_pod = blocks / P < need ? blocks / P : need;
    blocks = per_pod * P;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)w, (const char*)x, (char*)out, P, A, N, (int)per_pod);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* w, const void* x, void* out, int B, long long N, void* stream) {
  const int threads = 256;
  long long blocks = (N + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride covers the rest
  if (blocks < 1) blocks = 1;
  fedavg_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const T*)x, (T*)out, B, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fedavg_f32(const void* w, const void* x, void* out, int B, long long N,
                          void* stream) {
  return launch<float>(w, x, out, B, N, stream);
}

extern "C" int fedavg_bf16(const void* w, const void* x, void* out, int B, long long N,
                           void* stream) {
  return launch<__nv_bfloat16>(w, x, out, B, N, stream);
}


extern "C" int fedavg_wire_bf16(const void* w, const void* x, void* out, int B, long long N,
                                void* stream) {
  return launch_rows<Wire<__nv_bfloat16>>(w, x, out, 1, B, N, stream);
}

extern "C" int fedavg_wire_f16(const void* w, const void* x, void* out, int B, long long N,
                               void* stream) {
  return launch_rows<Wire<__half>>(w, x, out, 1, B, N, stream);
}

// w (P, A) float32 as given (not normalised per pod), x (P, A, N), out (P, N).
extern "C" int fedavg_pod_f32(const void* w, const void* x, void* out, int P, int A,
                              long long N, void* stream) {
  return launch_rows<Pod>(w, x, out, P, A, N, stream);
}

// The pod route on bfloat16 and float16 leaves: the weights rounded to the
// leaf's type, x and out in it.
extern "C" int fedavg_pod_bf16(const void* w, const void* x, void* out, int P, int A,
                               long long N, void* stream) {
  return launch_rows<PodLow<__nv_bfloat16>>(w, x, out, P, A, N, stream);
}

extern "C" int fedavg_pod_f16(const void* w, const void* x, void* out, int P, int A,
                              long long N, void* stream) {
  return launch_rows<PodLow<__half>>(w, x, out, P, A, N, stream);
}

// The instantiations of route r = which / 9 (0 wire bf16, 1 wire f16, 2 pod
// f32, 3 pod bf16, 4 pod f16).
static const void* route_kernel(int r, int k) {
  switch (r) {
    case 0: return (const void*)rows_route<Wire<__nv_bfloat16>>(k);
    case 1: return (const void*)rows_route<Wire<__half>>(k);
    case 2: return (const void*)rows_route<Pod>(k);
    case 3: return (const void*)rows_route<PodLow<__nv_bfloat16>>(k);
    default: return (const void*)rows_route<PodLow<__half>>(k);
  }
}

// Of the wire and pod routes' instantiation `which` (route which / 9, as
// route_kernel numbers them; k = which % 9: k + 1 rows for k < 8, groups of
// 8 for k = 8): out[0] registers a thread, out[1] local (spill) bytes a
// thread, out[2] blocks resident an SM with the shared memory of k + 2 rows.
extern "C" int fedavg_attrs(int which, int* out) {
  if (which < 0 || which >= 5 * kRoutes) return (int)cudaErrorInvalidValue;
  const int k = which % kRoutes;
  const void* kernel = route_kernel(which / kRoutes, k);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      (size_t)(k + 2) * sizeof(float));
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = per_sm;
  return 0;
}
