"""Public flash-attention entry point in model layout (B, T, nh, hd) (a
port of ``repro.kernels.flash_attention.ops``)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, T, nh, hd); k/v: (B, S, nkv, hd) -> (B, T, nh, hd).  The head
    axis moves ahead of the sequence (one copy each way) because the kernel
    takes contiguous (B, heads, seq, hd) tensors."""
    out = flash_attention_bhsd(q.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous(),
                               causal=causal, window=window)
    return out.transpose(1, 2)
