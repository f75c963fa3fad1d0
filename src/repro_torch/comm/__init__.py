from repro_torch.comm.codecs import Codec, IntQuant, Like

__all__ = ["Codec", "IntQuant", "Like"]
