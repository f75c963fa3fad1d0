"""Architecture configuration (a port of ``repro.models.config``).

One ``ArchConfig`` describes any backbone of the zoo (dense, MoE, SSM,
hybrid, enc-dec audio, early-fusion VLM).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free SSM)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention pattern ---
    sliding_window: int = 0          # >0 -> local layers use this window
    local_global_ratio: int = 0      # e.g. 5 -> 5 local : 1 global (gemma3)
    global_uses_window: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_group_size: int = 1024
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_heads: int = 0               # 0 -> d_inner // 64
    ssm_chunk: int = 128
    conv_kernel: int = 4

    # --- hybrid (zamba2) ---
    hybrid_period: int = 0

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0
    cross_attention: bool = False

    # --- modality stub (audio/vlm) ---
    frontend_stub: bool = False

    # --- norms / misc ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 256
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True               # recompute the layer bodies in the backward

    # --- adversarial (FedGAN) head: discriminator encoder dims ---
    disc_layers: int = 4
    disc_d_model: int = 512
    disc_heads: int = 8

    # provenance
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return max(self.d_inner // 64, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """True iff a 500k-token decode is sub-quadratic *and* cache-bounded:
        SSM (O(1) state), hybrid (O(1) state + the shared attention's
        windowed variant), and dense/MoE with sliding windows (a
        window-bounded cache on the local layers)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def is_global_layer(self, i: int) -> bool:
        if self.local_global_ratio <= 0:
            return self.sliding_window == 0
        return (i + 1) % (self.local_global_ratio + 1) == 0

    def scaled(self, **overrides) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family variant for CPU smoke tests."""
        kv = min(self.num_kv_heads, 2) if self.num_kv_heads else 0
        heads = min(self.num_heads, 4) if self.num_heads else 0
        if heads and kv and heads % kv:
            kv = 1
        over = dict(
            num_layers=3 if self.hybrid_period else 2,
            local_global_ratio=1 if self.local_global_ratio else 0,
            d_model=128,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=32 if heads else 0,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=2 if self.family in ("ssm", "hybrid") else 0,
            ssm_chunk=8,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            hybrid_period=3 if self.hybrid_period else 0,
            disc_layers=2,
            disc_d_model=64,
            disc_heads=2,
            dtype=torch.float32,
            remat=False,
        )
        if self.num_experts:
            over.update(num_experts=4, experts_per_token=min(self.experts_per_token, 2),
                        moe_group_size=16, d_ff=64)
        return self.scaled(**over)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
