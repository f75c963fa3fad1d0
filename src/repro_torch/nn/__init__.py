from repro_torch.nn.module import (BatchNorm, Conv1D, Conv2D, ConvTranspose2D, Dense,
                                   Embedding, LayerNorm, Module, RMSNorm,
                                   Sequential, fan_in_init, glorot_uniform,
                                   leaky_relu, normal_init, param_count,
                                   truncated_normal_init)

__all__ = ["Module", "Dense", "Embedding", "LayerNorm", "RMSNorm", "BatchNorm",
           "Conv1D", "Conv2D", "ConvTranspose2D", "Sequential", "leaky_relu",
           "glorot_uniform", "normal_init", "truncated_normal_init",
           "fan_in_init", "param_count"]
