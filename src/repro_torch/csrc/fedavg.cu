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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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
