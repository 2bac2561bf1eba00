"""Parallelism (``paddle_tpu/parallel``) on ``torch.distributed``:
sharding plans as data, each rank's slice of a parameter, explicit
collectives over a mesh axis's process group and their autograd
transposes, ring attention over "sp" (the ``ring_attention`` module; its
entry point is ``ring_attention.ring_attention``), and the sharded train
and eval
steps (data parallel, FSDP, Megatron from the layers' hints). The serving
engine's tensor parallelism (``ServingEngine(mesh=..., tp=...)``) stands
on these too. Pipelines and the sharded embedding are later slices of
the port (ROADMAP Queue 1 item 4.4)."""

from paddle_tpu_torch.parallel import collective, functional
from paddle_tpu_torch.parallel.api import (batch_specs, gathered_params,
                                           shard_eval_step, shard_train_step,
                                           with_sharding_constraint)
from paddle_tpu_torch.parallel.plan import (P, Rule, ShardingPlan, fsdp_plan,
                                            local_shard, megatron_plan,
                                            paged_pool_specs, replicated_plan,
                                            serving_prefill_tp_plan,
                                            serving_tp_plan)
from paddle_tpu_torch.parallel import ring_attention

__all__ = [
    "collective", "functional", "P", "Rule", "ShardingPlan", "batch_specs",
    "fsdp_plan", "gathered_params", "local_shard", "megatron_plan",
    "paged_pool_specs", "replicated_plan", "ring_attention",
    "serving_prefill_tp_plan", "serving_tp_plan", "shard_eval_step",
    "shard_train_step", "with_sharding_constraint",
]
