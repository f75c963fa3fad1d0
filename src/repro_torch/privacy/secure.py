"""Secure-aggregation-style masked summing: the strategy-facing config (a
port of ``repro.privacy.secure``).

The mechanism lives in ``repro_torch.dist.collectives.masked_sync``: every
agent one-time-pads the uint32 bit pattern of its weighted uplink payload
with net pairwise masks, and the masks cancel exactly (mod 2^32) at the
reduce, so the intermediary learns the weighted average and nothing else,
and the round is bit-identical to the plain ``average_agents`` sync.

:class:`SecureAgg` is the knob ``FedAvgSync(secure_agg=...)`` takes: a
static fleet seed, from which the round's mask key is folded with the
(checkpointed) step counter.  The fold runs on the step counter's device
(``repro_torch.prng.fold_in_t``), so a secure round reads nothing on the
host and can be captured in a CUDA graph (``repro_torch.run.graph``); a
restored run draws the same masks, and no round reuses a pad.

What it refuses to stack with (``FedAvgSync.validate``): ``codec=`` and
``sync_dtype=`` (a per-agent re-encoding must be decoded per agent at the
server, which reveals what the masks hide), ``SubsampledFedAvg`` (masks
cancel only when both halves of every pair reach the wire) and the
Byzantine-robust reduces (order statistics need the per-agent values).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SecureAgg:
    """Pairwise-mask secure summing config (see the module docstring)."""

    seed: int = 0

    def validate(self):
        pass

    def round_key(self, step: torch.Tensor) -> torch.Tensor:
        """The round's mask key, (2,) int64 key data on ``step``'s device:
        ``fold_in(key(seed), step)``, from the step counter at sync time
        without reading it on the host."""
        from repro_torch import prng
        from repro_torch.dist import collectives
        return collectives.mask_pair_key(prng.key_t(prng.key(self.seed), step.device), step)
