from repro_torch.dist.collectives import (average_agents, average_intra_pod,
                                         coded_sync, sync_bytes, tree_bytes,
                                         weighted_mean)
from repro_torch.dist.sharding import (DEFAULT_BATCH_AXES, batch_axes, batch_spec,
                                       current_batch_axes, current_mesh, dp_param_specs,
                                       filter_spec, named_shardings, param_specs, place,
                                       shape_of, shard, shard_attn_qkv, use_mesh)

__all__ = ["weighted_mean", "average_agents", "average_intra_pod", "coded_sync",
           "tree_bytes", "sync_bytes",
           "DEFAULT_BATCH_AXES", "batch_axes", "batch_spec", "current_batch_axes",
           "current_mesh", "dp_param_specs", "filter_spec", "named_shardings",
           "param_specs", "place", "shape_of", "shard", "shard_attn_qkv", "use_mesh"]
