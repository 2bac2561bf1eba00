"""Static and runtime analysis (``paddle_tpu/analysis``): graph lint for
the port's step functions, the reporting spine, and the host-thread
tier.

The analysis runs in tiers, one per program representation:

- :mod:`~paddle_tpu_torch.analysis.ast_lint` -- reads step-function
  *source* for host-sync idioms (``.item()``, ``.cpu()``, ``np.asarray``,
  ``torch.cuda.synchronize()``, ``time.time()``, stdlib ``random``) and
  Python branches on tensor values.
- :mod:`~paddle_tpu_torch.analysis.fx_lint` -- walks the aten *graph* a
  trace on fake tensors records (:mod:`~paddle_tpu_torch.analysis.api`:
  ``make_fx``; subgraphs of higher-order ops included) for host reads,
  debug asserts, float64, state not updated in place and re-seeded or
  unregistered generators; the plan check for replicated state.
- :mod:`~paddle_tpu_torch.analysis.cost_model` +
  :mod:`~paddle_tpu_torch.analysis.hlo_lint` -- the same graph costed:
  per-op flops and bytes (the registered kernels from their registry
  entry's work), a liveness peak-memory estimate, every collective, and
  the cost-tier rules -- unexpected collectives, resharding round trips,
  peak-memory and flops budgets, and the bucket-coverage proof that
  serving ``warmup()`` captures every reachable pow2 signature.
- :mod:`~paddle_tpu_torch.analysis.concurrency` and
  :mod:`~paddle_tpu_torch.analysis.conformance` -- the host threads
  around the steps: lock discipline, the lock-order graph and sanitizer,
  interface and reject-vocabulary conformance.
- :mod:`~paddle_tpu_torch.analysis.findings` -- the reporting spine.

Entry points: :func:`lint_fn` / :func:`lint_train_step` (``cost=True``
or any budget option for the cost tier), ``Trainer.fit(lint='warn'|
'error'|'off', lint_cost=...)``, ``Executor(lint=..., lint_cost=...)``,
and ``python -m paddle_tpu_torch.analysis.graph_lint`` over the model
zoo (``--cost`` / ``--cost-diff`` gate the committed
``analysis/cost_budgets.json``).

The reference's rules and their counterparts here:

- ``host-callback`` (pure_callback/io_callback) -> nodes that return to
  the host: ``_local_scalar_dense``, device-to-CPU copies,
  data-dependent shapes (``nonzero``, boolean-mask indexing).
- ``debug-callback`` (jax.debug.*) -> ``_assert_async``,
  ``_assert_scalar``, ``_print`` (warning).
- ``f64-promotion`` -> a float64/complex128 value in the graph.
- ``undonated-buffer`` (no ``donate_argnums``) -> a state input not
  written in place while a new same-shape, same-dtype tensor is
  returned (the port updates state in place instead of donating).
- ``prng-key-reuse`` (one key, two draws; a key closed over ``scan``)
  -> a random op drawing from a generator the step creates or re-seeds
  inside its body, or in a captured step a CUDA generator the graph does
  not register.
- ``replicated-large`` -> the ``ShardingPlan`` half only; the in-graph
  ``sharding_constraint`` half has no counterpart (the port's sharded
  steps place each block explicitly; nothing in a torch graph pins a
  layout).
- ``ast-host-sync`` / ``ast-tracer-branch`` -> the same idioms plus
  ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize()``;
  a branch on a tensor is also frozen into a CUDA graph at capture.
- ``unexpected-collective`` -> ``ptt.collective`` nodes (the port's
  collectives record themselves on fake tensors) outside the allowlist.
- ``resharding-churn`` (disagreeing ``@Sharding`` annotations) -> an
  all-gathered value that reaches a reduce-scatter or all-to-all through
  data movement alone.
- ``peak-hbm-budget``, ``cost-regression`` -> as the reference, over the
  traced graph's static peak and flops.
- ``bucket-coverage`` -> ``warmup_plan()`` vs ``reachable_signatures()``
  (the captured-graph buckets) and the embedding cache's widths.

Names load from their submodule on first use, so ``python -m
paddle_tpu_torch.analysis.concurrency`` runs the module once."""

import importlib

_EXPORTS = {
    "Finding": "findings", "Report": "findings", "Suppressions": "findings",
    "RULES": "findings", "SEVERITIES": "findings",
    "SUPPRESSIONS_PATH": "findings",
    "LINT_MODES": "api", "LintError": "api", "abstractify": "api",
    "enforce": "api", "lint_fn": "api", "lint_train_step": "api",
    "lint_callable": "ast_lint", "lint_source": "ast_lint",
    "analyze_graph": "fx_lint",
    "CostReport": "cost_model", "analyze_module": "cost_model",
    "estimate_cost": "cost_model", "estimate_lowered": "cost_model",
    "check_bucket_coverage": "hlo_lint",
    "embedding_bucket_coverage": "hlo_lint",
    "lint_cost_report": "hlo_lint", "serving_bucket_coverage": "hlo_lint",
    "DoubleAcquireError": "concurrency", "LockGraph": "concurrency",
    "LockMonitor": "concurrency", "extract_lock_graph": "concurrency",
    "guarded_by": "concurrency", "lint_concurrency": "concurrency",
    "lint_locks": "concurrency", "load_lock_order": "concurrency",
    "lock_order_diff": "concurrency", "lock_order_manifest": "concurrency",
    "sanitize": "concurrency", "LOCK_ORDER_PATH": "concurrency",
    "lint_interfaces": "conformance", "lint_reject_vocab": "conformance",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
