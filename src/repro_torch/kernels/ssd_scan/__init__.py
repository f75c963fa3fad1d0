"""The Mamba2 SSD chunked scan, forward (CUDA ``csrc/ssd_scan.cu``)."""
