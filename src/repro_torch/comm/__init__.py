from repro_torch.comm.codecs import (CODECS, Codec, IntQuant, Like, Sequential,
                                     TopK, codec_from_flags, get_codec)

__all__ = ["Codec", "IntQuant", "TopK", "Sequential", "Like", "CODECS",
           "get_codec", "codec_from_flags"]
