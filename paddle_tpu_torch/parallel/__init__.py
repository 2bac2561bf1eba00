"""Parallelism (``paddle_tpu/parallel``) on ``torch.distributed``:
sharding plans as data, each rank's slice of a parameter, explicit
collectives over a mesh axis's process group and their autograd
transposes, ring attention over "sp" (the ``ring_attention`` module; its
entry point is ``ring_attention.ring_attention``), and the sharded train
and eval
steps (data parallel, FSDP, Megatron from the layers' hints, pipelines
over "pp"), and the pipeline schedules themselves (GPipe and the circular
schedule, the stacked-layer layouts). The serving engine's tensor
parallelism (``ServingEngine(mesh=..., tp=...)``) stands on these too.
The sparse world: the vocab-parallel embedding over "tp"
(``embedding``), the host KV store and its training loop (``host_kv``),
its pserver and remote client (``kv_server``), and the async, GeoSGD and
federated communicators (``communicator``)."""

from paddle_tpu_torch.parallel import collective, functional
from paddle_tpu_torch.parallel.embedding import (ShardedEmbedding,
                                                 vocab_parallel_lookup)
from paddle_tpu_torch.parallel.api import (batch_specs, gathered_params,
                                           shard_eval_step, shard_train_step,
                                           with_sharding_constraint)
from paddle_tpu_torch.parallel.plan import (P, Rule, ShardingPlan, fsdp_plan,
                                            local_shard, megatron_plan,
                                            paged_pool_specs, replicated_plan,
                                            serving_prefill_tp_plan,
                                            serving_tp_plan)
from paddle_tpu_torch.parallel import ring_attention
from paddle_tpu_torch.parallel.pipeline import (circular_pipeline, gpipe,
                                                gpipe_layer_stack,
                                                interleave_stack, microbatch,
                                                microbatch_extras,
                                                pipeline_bubble_fraction,
                                                stack_layer_params,
                                                stack_params_at,
                                                uninterleave_stack,
                                                unmicrobatch,
                                                unstack_params_at)

__all__ = [
    "collective", "functional", "P", "Rule", "ShardedEmbedding",
    "ShardingPlan", "batch_specs",
    "circular_pipeline", "fsdp_plan", "gathered_params", "gpipe",
    "gpipe_layer_stack", "interleave_stack", "local_shard", "megatron_plan",
    "microbatch", "microbatch_extras", "paged_pool_specs",
    "pipeline_bubble_fraction", "replicated_plan", "ring_attention",
    "serving_prefill_tp_plan", "serving_tp_plan", "shard_eval_step",
    "shard_train_step", "stack_layer_params", "stack_params_at",
    "uninterleave_stack", "unmicrobatch", "unstack_params_at",
    "vocab_parallel_lookup", "with_sharding_constraint",
]
