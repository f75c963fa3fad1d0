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
// Two more routes port XLA reduces of the reference's collectives, not a
// Pallas kernel; both are bit-identical to the reference on its own CPU:
//
// * The wire route (fedavg_wire_bf16, fedavg_wire_f16) is
//   repro.dist.collectives.weighted_mean on a bfloat16 or float16 leaf (the
//   leaves of a sync_dtype cast), which computes in the leaf's type: w is
//   rounded to T, each product w_T[b] * x[b, n] is rounded to T, the
//   products are summed in float32 in agent order and the sum is rounded
//   to T.  The product of two T values is exact in float32, so __fmul_rn
//   followed by the rounding to T is the correctly rounded product.  Bound:
//   bytes, 2 * (B + 1) * N in and out; at the generator bucket (B = 5) 12 N
//   bytes, 8.3 us at 3.35 TB/s.
// * The pod route (fedavg_pod_f32) is collectives.average_intra_pod, the
//   tier-1 reduce of hierarchical sync: per pod p, w_intra[p, a] = w[p, a] /
//   sum_a w[p, a] (the row summed in order), then out[p, n] = a chain of
//   fused multiply-adds over a in agent order, starting from +0.  That is
//   what the reference's einsum computes on XLA's CPU backend (not the
//   rounded-product sum of weighted_mean), so it uses __fmaf_rn.  One block
//   row per pod.  Bound: bytes, 4 * (P * A + P) * N.
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

template <typename T>
__global__ void fedavg_wire_kernel(const float* __restrict__ w, const T* __restrict__ x,
                                   T* __restrict__ out, int B, long long N) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N; n += stride) {
    float acc = 0.f;
    for (int b = 0; b < B; ++b) {
      const float p = round_to<T>(__fmul_rn(round_to<T>(w[b]),
                                            to_f32(x[(long long)b * N + n])));
      acc = __fadd_rn(acc, p);
    }
    out[n] = from_f32<T>(acc);
  }
}

__global__ void fedavg_pod_kernel(const float* __restrict__ w, const float* __restrict__ x,
                                  float* __restrict__ out, int A, long long N) {
  const int p = blockIdx.y;
  const float* wp = w + (long long)p * A;
  float s = wp[0];
  for (int a = 1; a < A; ++a) s = __fadd_rn(s, wp[a]);
  const float* xp = x + (long long)p * A * N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N; n += stride) {
    float acc = 0.f;
    for (int a = 0; a < A; ++a) {
      acc = __fmaf_rn(__fdiv_rn(wp[a], s), xp[(long long)a * N + n], acc);
    }
    out[(long long)p * N + n] = acc;
  }
}

long long grid_x(long long N, int threads, long long cap) {
  long long blocks = (N + threads - 1) / threads;
  if (blocks > cap) blocks = cap;  // grid-stride covers the rest
  return blocks < 1 ? 1 : blocks;
}

template <typename T>
int launch_wire(const void* w, const void* x, void* out, int B, long long N, void* stream) {
  const int threads = 256;
  fedavg_wire_kernel<T><<<(unsigned)grid_x(N, threads, 1048576), threads, 0,
                          (cudaStream_t)stream>>>((const float*)w, (const T*)x, (T*)out, B, N);
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
  return launch_wire<__nv_bfloat16>(w, x, out, B, N, stream);
}

extern "C" int fedavg_wire_f16(const void* w, const void* x, void* out, int B, long long N,
                               void* stream) {
  return launch_wire<__half>(w, x, out, B, N, stream);
}

// w (P, A) float32 as given (not normalised per pod), x (P, A, N), out (P, N).
extern "C" int fedavg_pod_f32(const void* w, const void* x, void* out, int P, int A,
                              long long N, void* stream) {
  const int threads = 256;
  if (P < 1 || P > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)grid_x(N, threads, 1048576 / P + 1), (unsigned)P);
  fedavg_pod_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)x, (float*)out, A, N);
  return (int)cudaGetLastError();
}
