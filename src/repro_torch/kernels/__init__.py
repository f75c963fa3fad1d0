"""Hand-written CUDA kernels of the port, one subpackage per TPU kernel it
replaces, each with its plain PyTorch version in ``ref.py``."""
