from repro_torch.distributed.sharding import (
    ShardingRules,
    DEFAULT_RULES,
    MULTIPOD_RULES,
    logical_to_pspec,
    shard_activation,
    tree_pspecs,
)
