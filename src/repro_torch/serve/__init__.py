"""repro_torch.serve — continuous-batching generator serving (a port of
``repro.serve``).

The FedGAN end product is the synced generator, and this package serves
it: a :class:`ServeEngine` whose decode tick is one captured CUDA graph on
the card, a continuous :class:`Batcher`, the KV/SSM-cache layouts
(:mod:`repro_torch.serve.cache`) and hot reload of training checkpoints
(:mod:`repro_torch.serve.reload`).
"""
from repro_torch.serve.batcher import Batcher, Request
from repro_torch.serve.cache import (CacheLayout, insert_slot, make_buckets,
                                     plan_layout, prefill_bucket, ring_index_map)
from repro_torch.serve.engine import EngineStats, ServeEngine
from repro_torch.serve.reload import CheckpointWatcher, generator_from_state

__all__ = [
    "Batcher", "CacheLayout", "CheckpointWatcher", "EngineStats", "Request",
    "ServeEngine", "generator_from_state", "insert_slot", "make_buckets",
    "plan_layout", "prefill_bucket", "ring_index_map",
]
