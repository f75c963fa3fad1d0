// The block quantizer's arithmetic, shared by csrc/qpack.cu (the codec's
// standalone quantize / dequantize) and csrc/qsync.cu (the fused sync), so
// that the composed and the fused coded sync round every value alike.
//
// Numerics follow the JAX reference (src/repro/kernels/qpack/kernel.py,
// `_wire_scale`, `_quant_kernel`, `_dequant_kernel`): the wire scale is
// __float2half_rn(fminf(amax / qmax, 65504)) with an IEEE division, a zero
// scale decodes with divisor 1, codes are rintf (round half to even, as
// jnp.round) of the IEEE quotient clipped to +-qmax, and the decoded value
// is one explicitly rounded multiply of the integer code.  Build without
// --use_fast_math.
#pragma once

#include <cuda_fp16.h>

// The f16 scale that ships for a block whose max-abs is `amax`.  Clamped
// to f16's finite range: an overflowing block clips hard instead of
// shipping inf and decoding 0 * inf = NaN.
__device__ __forceinline__ __half wire_scale(float amax, float qmax) {
  return __float2half_rn(fminf(__fdiv_rn(amax, qmax), 65504.f));
}

// The value both wire ends divide and multiply by: the f16 scale, or 1
// for a block whose scale is zero.
__device__ __forceinline__ float decode_scale(__half s) {
  const float v = __half2float(s);
  return v > 0.f ? v : 1.f;
}

// The integer code of `y` in a block with decode scale `s`.
__device__ __forceinline__ int quantize(float y, float s, float qmax) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(y, s)), -qmax), qmax);
}

// The decoded value of an integer code.  Going through the integer is what
// the wire does: a code of 0 decodes to +0, whatever the sign of the
// rounded quotient was, so the fused sync and the composed one (whose
// codes pass through int8) agree in every bit.
__device__ __forceinline__ float dequantize(int code, float s) {
  return __fmul_rn((float)code, s);
}
