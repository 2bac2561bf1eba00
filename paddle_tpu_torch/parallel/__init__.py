"""Parallelism (``paddle_tpu/parallel``) on ``torch.distributed``:
sharding plans as data, each rank's slice of a parameter, and explicit
collectives over a mesh axis's process group. The serving engine's
tensor parallelism (``ServingEngine(mesh=..., tp=...)``) stands on
these. Ring attention, the sharded train step, pipelines and the sharded
embedding are later slices of the port."""

from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel.plan import (P, Rule, ShardingPlan, fsdp_plan,
                                            local_shard, megatron_plan,
                                            paged_pool_specs, replicated_plan,
                                            serving_prefill_tp_plan,
                                            serving_tp_plan)

__all__ = [
    "collective", "P", "Rule", "ShardingPlan", "fsdp_plan", "local_shard",
    "megatron_plan", "paged_pool_specs", "replicated_plan",
    "serving_prefill_tp_plan", "serving_tp_plan",
]
