"""The multi-device layer of the PyTorch port: sharding rules on a
``DeviceMesh`` and the multihost barrier."""

from .sharding import (Sharding, ShardingRules, addressable_shard_spans,
                       batch_spec, cache_shardings, current_rules,
                       elastic_rules, placements, shard_act, tree_shardings,
                       use_sharding_rules)

__all__ = ["Sharding", "ShardingRules", "addressable_shard_spans",
           "batch_spec", "cache_shardings", "current_rules", "elastic_rules",
           "placements", "shard_act", "tree_shardings", "use_sharding_rules"]
