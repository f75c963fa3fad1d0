"""The fused coded sync (CUDA ``csrc/qsync.cu``)."""
