from repro_torch.dist.collectives import (average_agents, average_intra_pod,
                                         coded_sync, sync_bytes, tree_bytes,
                                         weighted_mean)

__all__ = ["weighted_mean", "average_agents", "average_intra_pod", "coded_sync",
           "tree_bytes", "sync_bytes"]
