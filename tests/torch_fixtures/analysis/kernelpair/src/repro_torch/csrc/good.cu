// fixture CUDA source of kernels/good
