// Two fused kernels of the FedGAN sync, each one pass over device memory.
//
// qsync_f32: fused coded sync of one agent-stacked stream, block by block:
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
//
// adam_sync_f32: the K-th local Adam step of every agent fused with the
// uplink quantize of its new parameters:
//   mu' = b1 mu + (1 - b1) g;  nu' = b2 nu + (1 - b2) g^2
//   p'  = p - (lr (mu' / bc1)) / (sqrt(nu' / bc2) + eps)
//   per agent and block: amax(|p'|) -> f16 wire scale -> int8 codes of p'
//
// Replaces the Pallas TPU kernel `_adam_sync_kernel` (src/repro/kernels/
// qsync/kernel.py), reached through `adam_sync_flat` / `adam_sync_tree`.
// p, g, mu, nu and their updates are (B, N) float32, codes (B, N) int8,
// scales (B, N / block) float16; hyper is the (1, 3) float32 row
// [lr, bc1, bc2] in device memory, read by the kernel.
//
// Bound: bytes.  Per element it reads 16 bytes (p, g, mu, nu) and writes
// 13 (p', mu', nu', the code), plus 2 bytes of scale per block, for about
// 15 flops.  At the ACGAN generator bucket (B = 5, 2,314,752 columns after
// per-leaf padding) that is about 336 MB, 0.100 ms at 3.35 TB/s.
//
// Design: one thread block per (agent row, quantizer block), one thread
// per element.  The new parameter stays in a register from the update to
// its code: it is written once and never read back from device memory
// before it is quantized, which is what the fusion is for.  The block's
// max-abs is taken with block_max, and the scale and code with the
// quantizer of blockquant.cuh, so the codes are those of qpack's quantize
// of the same values.
//
// Numerics: bit for bit with the plain version (kernels/qsync/ref.py) and
// with optim.Adam.update followed by quantize_blocks on the card, which
// PyTorch runs one operation at a time.  So (1) every multiply, add,
// divide and square root is explicitly rounded (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn), in Adam.update's order, and nothing
// is contracted into an FMA (the JAX reference, jitted on XLA:CPU, does
// contract the moment updates, and so agrees only to a few ulps);
// (2) 1 - b1 and 1 - b2 arrive as the float32 roundings of the host's
// double differences, which is what PyTorch's scalar multiply uses
// (1.0f - 0.999f computed in float32 is another number); (3) bc1 and bc2
// are computed once on the card by the same torch ops as Adam.update's
// and read from `hyper`, never recomputed here (the card's powf may differ
// from the host's in the last ulp); (4) the divisions by bc1 and bc2 are
// IEEE divisions, as PyTorch's division by a 0-d device tensor (a
// division by a host scalar would be a multiply by its reciprocal).
// Zero-padded lanes (p = g = mu = nu = 0) take the step 0 / (0 + eps) = 0,
// stay 0 and move no block's max-abs.  Zero-scale blocks, f16 overflow and
// the sign of a zero code are handled by blockquant.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void adam_sync_kernel(const float* __restrict__ hyper, const float* __restrict__ p,
                                 const float* __restrict__ g, const float* __restrict__ mu,
                                 const float* __restrict__ nu, float* __restrict__ p_out,
                                 float* __restrict__ mu_out, float* __restrict__ nu_out,
                                 int8_t* __restrict__ codes, __half* __restrict__ scales,
                                 long long N, float qmax, float b1, float one_minus_b1,
                                 float b2, float one_minus_b2, float eps) {
  __shared__ float smem[32];
  const long long blocks_per_row = N / blockDim.x;
  const long long row = blockIdx.y;
  const long long i = row * N + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float lr = hyper[0], bc1 = hyper[1], bc2 = hyper[2];
  const float gi = g[i];
  const float m = __fadd_rn(__fmul_rn(b1, mu[i]), __fmul_rn(one_minus_b1, gi));
  const float v = __fadd_rn(__fmul_rn(b2, nu[i]), __fmul_rn(one_minus_b2, __fmul_rn(gi, gi)));
  const float q1 = __fdiv_rn(m, bc1);
  const float q2 = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps);
  const float pn = __fsub_rn(p[i], __fdiv_rn(__fmul_rn(lr, q1), q2));
  p_out[i] = pn;
  mu_out[i] = m;
  nu_out[i] = v;
  const __half sw = wire_scale(block_max(fabsf(pn), smem), qmax);
  codes[i] = (int8_t)quantize(pn, decode_scale(sw), qmax);
  if (threadIdx.x == 0) scales[row * blocks_per_row + blockIdx.x] = sw;
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

// The caller guarantees block % 32 == 0, 32 <= block <= 1024, N % block == 0,
// B <= 65535.  one_minus_b1 / one_minus_b2 are float32(1 - b) of the host's
// doubles.
extern "C" int adam_sync_f32(const void* hyper, const void* p, const void* g, const void* mu,
                             const void* nu, void* p_out, void* mu_out, void* nu_out,
                             void* codes, void* scales, int B, long long N, int block,
                             int qmax, float b1, float one_minus_b1, float b2,
                             float one_minus_b2, float eps, void* stream) {
  const long long blocks = N / block;
  if (blocks > 0 && B > 0) {
    adam_sync_kernel<<<dim3((unsigned)blocks, (unsigned)B), block, 0, (cudaStream_t)stream>>>(
        (const float*)hyper, (const float*)p, (const float*)g, (const float*)mu,
        (const float*)nu, (float*)p_out, (float*)mu_out, (float*)nu_out, (int8_t*)codes,
        (__half*)scales, N, (float)qmax, b1, one_minus_b1, b2, one_minus_b2, eps);
  }
  return (int)cudaGetLastError();
}
