"""Flash attention forward, GQA with causal and sliding-window masks (CUDA
``csrc/flash_attention.cu``)."""
