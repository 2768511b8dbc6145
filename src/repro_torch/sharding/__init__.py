from repro_torch.sharding.policy import (  # noqa: F401
    ShardingPolicy, LOGICAL_RULES, current_policy, use_policy, shard,
)
