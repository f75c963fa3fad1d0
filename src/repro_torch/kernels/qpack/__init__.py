"""The codec's block quantize / dequantize and int4 pack / unpack (CUDA
``csrc/qpack.cu``)."""
