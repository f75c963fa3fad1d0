"""The eq. (2) weighted reduce over agents (CUDA ``csrc/fedavg.cu``)."""
