from repro_torch.data import synthetic
from repro_torch.data.federated import (
    DeviceFederatedData,
    FederatedData,
    FederatedRounds,
    FleetRounds,
    StreamingFederatedData,
    dirichlet_partition,
    label_shard_partition,
    partition_sizes,
    round_key_schedule,
    stream_key_schedule,
)

__all__ = [
    "DeviceFederatedData", "FederatedData", "FederatedRounds", "FleetRounds",
    "StreamingFederatedData", "dirichlet_partition", "label_shard_partition",
    "partition_sizes", "round_key_schedule", "stream_key_schedule", "synthetic",
]
