// Fused coded sync of one agent-stacked stream, block by block:
//   y = x + ef                        (uplink error-feedback residual, optional)
//   per agent: amax -> f16 wire scale -> codes clip(rint(y / s), +-qmax) -> dq
//   m = sum_b w[b] * dq[b]            (eq. (2), agent order)
//   yd = m + ef_down                  (downlink residual, optional)
//   synced = requantize(yd); new_ef = y - dq; new_ef_down = yd - synced
//
// Replaces the Pallas TPU kernel `_qsync_kernel` (src/repro/kernels/qsync/
// kernel.py), the one-pass compressed sync of FedAvgSync(codec=IntQuant(8|4),
// error_feedback=True).  x, ef and new_ef are (B, N) float32, ef_down,
// synced and new_ef_down (N,) float32, w (B,) float32; N is a multiple of
// the quantizer block.
//
// Bound: bytes.  A few flops per element against 12 bytes per agent element
// (x and ef read, new_ef written).  At the FedGAN ACGAN generator bucket
// (B = 5, about 2.32 M columns after per-leaf padding) the kernel must move
// about 167 MB, 50 us at 3.35 TB/s.
//
// Design: one thread block per quantizer block (blockDim = block, a
// multiple of 32), one thread per column.  For each agent in turn the block
// loads its row segment, takes the max-abs with warp shuffles and one shared
// memory exchange, quantizes and dequantizes in registers, writes the
// agent's new residual and adds the weighted product into a per-thread
// float32 sum.  The per-agent decoded image never reaches device memory,
// which is what the fusion is for: the composed pipeline writes and re-reads
// it.  The downlink re-quantize runs in the same block on the summed value.
//
// Numerics follow the reference exactly where it is elementwise: the
// quantizer's arithmetic is the one of csrc/qpack.cu, shared through
// blockquant.cuh (f16 wire scale of amax / qmax, a zero scale divides by 1,
// codes round half to even, IEEE division), and every multiply and add is
// explicitly rounded (__fmul_rn, __fadd_rn, __fsub_rn) so nothing is
// contracted into an FMA.  The plain version sums the products in the same
// agent order, so every output is bit-identical to it, and so is the
// composed coded sync on the card (qpack quantize / dequantize around the
// fedavg reduce, which sums in the same order).
#include <cuda_runtime.h>

#include "blockquant.cuh"

namespace {

// Max over the thread block; every thread returns the block's value.
// `smem` holds one float per warp.  The leading barrier keeps a previous
// call's readers ahead of this call's writers.
__device__ __forceinline__ float block_max(float v, float* smem) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float r = smem[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) r = fmaxf(r, smem[i]);
  return r;
}

__device__ __forceinline__ float roundtrip(float y, float s, float qmax) {
  return dequantize(quantize(y, s, qmax), s);
}

__global__ void qsync_kernel(const float* __restrict__ w, const float* __restrict__ x,
                             const float* __restrict__ ef, const float* __restrict__ ef_down,
                             float* __restrict__ synced, float* __restrict__ new_ef,
                             float* __restrict__ new_ef_down, int B, long long N, float qmax) {
  __shared__ float smem[32];
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) {
    const long long i = (long long)b * N + col;
    float y = x[i];
    if (ef != nullptr) y = __fadd_rn(y, ef[i]);
    const float s = decode_scale(wire_scale(block_max(fabsf(y), smem), qmax));
    const float dq = roundtrip(y, s, qmax);
    if (new_ef != nullptr) new_ef[i] = __fsub_rn(y, dq);
    acc = __fadd_rn(acc, __fmul_rn(w[b], dq));
  }
  float yd = acc;
  if (ef_down != nullptr) yd = __fadd_rn(yd, ef_down[col]);
  const float sd = decode_scale(wire_scale(block_max(fabsf(yd), smem), qmax));
  const float dqd = roundtrip(yd, sd, qmax);
  synced[col] = dqd;
  if (new_ef_down != nullptr) new_ef_down[col] = __fsub_rn(yd, dqd);
}

}  // namespace

// ef / ef_down / new_ef / new_ef_down may be null (no error feedback).
// The caller guarantees block % 32 == 0, 32 <= block <= 1024, N % block == 0.
extern "C" int qsync_f32(const void* w, const void* x, const void* ef, const void* ef_down,
                         void* synced, void* new_ef, void* new_ef_down, int B, long long N,
                         int block, int qmax, void* stream) {
  const long long blocks = N / block;
  if (blocks > 0) {
    qsync_kernel<<<(unsigned)blocks, block, 0, (cudaStream_t)stream>>>(
        (const float*)w, (const float*)x, (const float*)ef, (const float*)ef_down,
        (float*)synced, (float*)new_ef, (float*)new_ef_down, B, N, (float)qmax);
  }
  return (int)cudaGetLastError();
}
