"""The port's public surface held to the reference's, name by name.

Every module of ``paddle_tpu`` (``pkgutil.walk_packages``) is imported
with its counterpart in ``paddle_tpu_torch`` (:data:`MODULE_RENAMES`
where the port names it otherwise), and each public function, class and
method the reference module defines is
- (a) present under the same name in the port's module,
- (b) in :data:`RENAMES`, naming the port's object that does its work, or
- (c) in :data:`JAX_ONLY`, with the reason it has no counterpart: it
  names a JAX or XLA object, or the functional idiom that ``nn.Module``
  and ``torch.optim`` replace.

Each keyword parameter of a pair is then held the same way: present in
the port's signature, exempt by name as an idiom parameter
(:func:`_idiom`: parameter trees, PRNG keys, ``training=``, donation,
sharding, Pallas and platform switches), renamed
(:data:`PARAM_RENAMES`), forwarded through ``**kw`` to a port function
that takes it (:data:`FORWARDED`), or listed with its reason
(:data:`PARAM_REASONS`).

To add a name to a table: only with a reason a reader can check, and
only where the port has, or needs, no counterpart. A name the port gains
later must leave its table: :func:`test_tables_name_only_what_is_missing`
fails on an entry that is no longer needed."""

import importlib
import inspect
import pkgutil

import pytest

import paddle_tpu

#: reference module -> the port's module (relative to the packages)
MODULE_RENAMES = {
    "serving.decode_attention": "serving.paged_attention",
    "analysis.jaxpr_lint": "analysis.fx_lint",
    "native.pjrt": "native.runner",
}

#: reference modules with no counterpart
JAX_ONLY_MODULES = {
    "core.compat": "shims over JAX versions (shard_map, tree utilities); "
                   "the port runs no JAX",
}

#: reference name -> the port's object doing its work (dotted from the
#: port's package)
RENAMES = {
    "kernels.registry.KernelSpec": "kernels.registry.KernelEntry",
    "kernels.registry.KernelContract.default_blocks":
        "kernels.autotune.static_prior",
    "kernels.autotune.candidate_grid": "kernels.registry.KernelContract.grid",
    "observability.recompile.compile_count":
        "observability.recompile.capture_count",
}

_FUNCTIONAL_OPT = ("the functional optimizer API (state passed in and "
                   "returned); the port's optimizers are torch.optim."
                   "Optimizer (step(), state in self.state)")
_FUNCTIONAL_INIT = ("functional init of a parameter tree; an nn.Module "
                    "holds its parameters from construction")

#: reference name -> why the port has no counterpart
JAX_ONLY = {
    "analysis.jaxpr_lint.analyze_jaxpr":
        "lints a jax.core.Jaxpr; the port lints torch.fx graphs "
        "(fx_lint.analyze_graph)",
    "core.mesh.batch_sharding": "a jax.sharding.NamedSharding; the port "
                                "cuts a batch with parallel.api.local_batch",
    "core.mesh.replicated": "a jax.sharding.NamedSharding",
    "kernels.harness.on_tpu": "whether JAX's backend is a TPU",
    "kernels.registry.all_pallas_sites":
        "the registry's pl.pallas_call sites; the port binds ctypes entry "
        "points (KernelContract.symbols, lint.bypass_findings)",
    "native.pjrt.default_plugin_path": "the PJRT plugin of JAX's TPU runtime",
    "nn.module.Layer": "the functional layer base (parameters passed in); "
                       "the port's layers are torch.nn.Module",
    "nn.module.ParamSpec": "a functional layer's parameter declaration; an "
                           "nn.Module holds its nn.Parameter",
    "nn.module.apply_state_updates":
        "folds the state tape into a functional parameter tree; the port's "
        "tape writes the buffers in place (StateCapture.apply)",
    "nn.module.StackedLayers.init": _FUNCTIONAL_INIT,
    "nn.module.StackedLayers.param_specs": _FUNCTIONAL_INIT,
    "observability.recompile.install_compile_listener":
        "a jax.monitoring listener on XLA compiles; the port counts CUDA "
        "graph captures (recompile.note_capture)",
    "optimizer.Optimizer.init": _FUNCTIONAL_OPT,
    "optimizer.Optimizer.update": _FUNCTIONAL_OPT,
    "optimizer.Optimizer.minimize": _FUNCTIONAL_OPT,
    "optimizer.Adagrad.init": _FUNCTIONAL_OPT,
    "optimizer.AdagradOptimizer.init": _FUNCTIONAL_OPT,
    "optimizer.AdamW.update": _FUNCTIONAL_OPT,
    "optimizer.Dpsgd.init": _FUNCTIONAL_OPT,
    "optimizer.Dpsgd.update": _FUNCTIONAL_OPT,
    "optimizer.LookaheadOptimizer.init": _FUNCTIONAL_OPT,
    "optimizer.LookaheadOptimizer.update": _FUNCTIONAL_OPT,
    "optimizer.ExponentialMovingAverage.init": _FUNCTIONAL_OPT,
    "optimizer.ModelAverage.init": _FUNCTIONAL_OPT,
    "parallel.collective.shard_map":
        "jax.experimental.shard_map; each port rank runs its own shard",
    "parallel.plan.named_shardings": "a tree of jax.sharding.NamedSharding",
    "profiler.start_server": "jax.profiler's server protocol; the port "
                             "writes torch.profiler traces (profiler.profiler)",
    "slim.int8_resident": "guards int8 constants against XLA's constant "
                          "folding, which the port does not run",
}

#: "module.qualname(param)" -> the port's name of that parameter
PARAM_RENAMES = {
    "analysis.cost_model.analyze_module(module)": "gm",
    "inference.save_inference_model(fn)": "model_or_fn",
    "kernels.autotune.tune_key(spec)": "entry",
    "kernels.autotune.static_prior(spec)": "entry",
    "kernels.autotune.KernelTuner.get(spec)": "entry",
    "kernels.autotune.KernelTuner.measure(spec)": "entry",
    "kernels.autotune.seed_entry(spec)": "entry",
    "kernels.lint.contract_findings(spec)": "entry",
    "kernels.lint.bypass_findings(roots)": "root",
    "kernels.lint.bypass_findings(allowlist_path)": "allowlist",
    "kernels.lint.lint_registry(allowlist_path)": "allowlist",
    "kernels.registry.register(spec)": "entry",
    "kernels.registry.KernelContract(block_candidates)": "candidates",
    "kernels.registry.KernelSpec(pallas_fn)": "cuda_fn",
    "kernels.registry.KernelSpec(lax_fn)": "plain_fn",
    "kernels.registry.KernelSpec(vmem_estimate)": "smem",
    "models.bert.BertPretrainingHeads.forward(word_table)": "word",
    "nn.module.StackedLayers(template)": "make_layer",
    "nn.module.report_state(layer)": "module",
    "nn.transformer.MultiHeadAttention.forward(query)": "x",
    "ops.sequence.dynamic_lstm(cell)": "rnn",
    "ops.sequence.dynamic_gru(cell)": "rnn",
    "nn.module.LayerList(layers)": "modules",
    "nn.module.LayerList.append(layer)": "module",
    "parallel.communicator.AsyncCommunicator(optimizer)": "make_optimizer",
    "parallel.communicator.geo_sgd_sync(stacked_params)": "local_params",
    "parallel.pipeline.gpipe_layer_stack(params_list)": "params",
    "serving.paged_cache.quantize_kv(psum_axis)": "group",
}

#: reference function -> the port function its ``**kw`` reaches
FORWARDED = {
    "models.ssd.SSD.detect": "models.ssd.SSD.detect_from",
    "models.yolov3.YOLOv3.detect": "models.yolov3.YOLOv3.detect_from",
    "models.faster_rcnn.FasterRCNN.detect":
        "models.faster_rcnn.FasterRCNN.final_detections",
    "models.faster_rcnn.MaskRCNN.segment":
        "models.faster_rcnn.FasterRCNN.final_detections",
}

_POSITIONAL_REST = ("passed positionally through *rest in the inner "
                    "kernel's argument order")
_LAYER_KEYS = ("per-layer PRNG keys; the port's layers draw from the "
               "step's generator")

#: "module.qualname(param)" -> why the port's signature lacks it
PARAM_REASONS = {
    "analysis.cost_model.estimate_lowered(lowered)":
        "a jax.stages.Lowered; the port's takes a trace of analysis.api",
    "kernels.autotune.candidate_grid(contract)":
        "the contract is the method's own object (KernelContract.grid)",
    "kernels.autotune.static_prior(kwargs)":
        "the port's prior reads the arguments' shapes alone",
    "kernels.autotune.static_prior(budget_bytes)":
        "the reference's largest-that-fits-VMEM prior; the port's prior is "
        "the configuration its kernel source fixes",
    "kernels.registry.KernelContract(donatable)":
        "XLA input/output aliasing; the port's wrappers allocate outputs",
    "kernels.registry.KernelContract(grid)":
        "the Pallas grid; a port wrapper sizes its CUDA grid from the "
        "shapes (KernelContract.grid is the candidates' product)",
    "kernels.registry.KernelContract(collectives)":
        "the collectives of a shard_map'd kernel; the port's mesh kernels "
        "are CompositeEntry",
    "kernels.registry.KernelContract(atol)":
        "tolerances are per dtype on the entry (KernelEntry.tolerance)",
    "kernels.registry.KernelContract(rtol)":
        "tolerances are per dtype on the entry (KernelEntry.tolerance)",
    "kernels.registry.KernelSpec(pallas_sites)":
        "the kernel's pl.pallas_call sites; a port entry names its CUDA "
        "source and the TPU kernel it replaces (source, replaces)",
    "kernels.registry.KernelSpec(requires_mesh)":
        "the port's mesh kernels are CompositeEntry, refused without a mesh",
    "kernels.registry.KernelSpec(donation_probe)":
        "probes XLA buffer donation, which a CUDA wrapper does not do",
    "kernels.registry.KernelSpec(tune_sample_variants)":
        "the tp twins' tuning samples; the port's tp entries run the inner "
        "kernel's own buckets (CompositeEntry)",
    "kernels.registry.KernelSpec(parity_fn)":
        "a Pallas-against-lax parity callback; the port's battery is "
        "kernels.harness over cuda_fn, plain_fn and reference_fn",
    "nn.initializer.zeros(shape)": "the port's initializers fill a given "
                                   "tensor, which carries shape and dtype",
    "nn.initializer.zeros(dtype)": "the port's initializers fill a given "
                                   "tensor, which carries shape and dtype",
    "nn.initializer.ones(shape)": "the port's initializers fill a given "
                                  "tensor, which carries shape and dtype",
    "nn.initializer.ones(dtype)": "the port's initializers fill a given "
                                  "tensor, which carries shape and dtype",
    "nn.module.StackedLayers.forward(layer_keys)": _LAYER_KEYS,
    "parallel.pipeline.gpipe_layer_stack(layer_keys)": _LAYER_KEYS,
    "serving.engine.ServingEngine(draft_params)":
        "the draft model holds its own weights (draft_model=)",
    "train.make_train_state(sample_extra)":
        "example feeds to trace a functional init; the module is built",
    **{f"serving.decode_attention.{fn}({p})": _POSITIONAL_REST
       for fn, ps in (
           ("ragged_paged_decode_tp_attention", ("block_tables", "lengths")),
           ("ragged_paged_prefill_tp_attention",
            ("block_tables", "chunk_starts", "n_valid")),
           ("ragged_paged_decode_int8_tp_attention",
            ("k_scales", "v_scales", "block_tables", "lengths")),
           ("ragged_paged_prefill_int8_tp_attention",
            ("k_scales", "v_scales", "block_tables", "chunk_starts",
             "n_valid")))
       for p in ps},
}

#: names once missing from the port and ported since: none may sit in a
#: table
PORTED = (
    "observability.render_prometheus", "observability.snapshot",
    "observability.tracing.Tracer.export_jsonl",
    "observability.tracing.validate_trace_record",
    "observability.tracing.validate_trace_log",
    "observability.tracing.chrome_trace_from_jsonl",
    "observability.anatomy.StepAnatomy.export_jsonl",
    "observability.anatomy.validate_anatomy_log",
    "observability.flight.read_bundle",
    "observability.flight.validate_postmortem_file",
    "observability.registry.Histogram.percentiles",
    "observability.registry.Histogram.count_over",
    "observability.registry.Histogram.count_le",
    "observability.registry.Gauge.inc",
    "observability.registry.MetricsRegistry.unregister",
    "observability.registry.counter", "observability.registry.gauge",
    "observability.registry.histogram",
    "observability.exposition.ExpositionServer.add_json",
    "nn.layers.FC", "nn.module.LayerList", "nn.module.Sequential",
    "slim.quantization_error", "core.dtypes.is_floating",
    "core.dtypes.Policy.cast_to_param", "core.dtypes.Policy.cast_to_output",
    "core.mesh.single_device_mesh", "core.mesh.local_device_count",
    "core.mesh.device_count", "serving.paged_cache.PagedKVCache.device_tables",
    "kernels.autotune.seed_entry", "kernels.autotune.seed_default_buckets",
    "kernels.lint.load_allowlist",
)
PORTED_PARAMS = (
    "nn.layers.Linear(bias_init)", "nn.layers.LayerNorm(scale)",
    "nn.layers.LayerNorm(shift)", "nn.layers.Embedding(padding_idx)",
    "nn.layers.Embedding(weight_init)", "trainer.Trainer.evaluate(metrics)",
    "parallel.collective.all_gather(tiled)", "optimizer.recompute(policy)",
)

_IDIOM = {"params", "state", "key", "rng", "rng_key", "seed", "training",
          "sharding", "interpret", "impl", "platforms", "devices"}


def _idiom(p: str) -> bool:
    return (p in _IDIOM or p.endswith("_key") or p.startswith("donate")
            or p.startswith("plugin_"))


def _ref_modules():
    return sorted(m.name[len("paddle_tpu."):] for m in pkgutil.walk_packages(
        paddle_tpu.__path__, "paddle_tpu."))


REF_MODULES = _ref_modules()


def _port_module(rel: str):
    return importlib.import_module(
        "paddle_tpu_torch." + MODULE_RENAMES.get(rel, rel))


def _resolve(dotted: str):
    """A dotted path under ``paddle_tpu_torch`` to its object."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(
                "paddle_tpu_torch." + ".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(dotted)


def _kw_params(fn):
    """(names of the keyword-capable parameters, takes **kwargs)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None, False
    names = [q.name for q in sig.parameters.values()
             if q.kind in (q.POSITIONAL_OR_KEYWORD, q.KEYWORD_ONLY)
             and q.name not in ("self", "cls")]
    varkw = any(q.kind == q.VAR_KEYWORD for q in sig.parameters.values())
    return names, varkw


def _surface(rel: str):
    """``(label, ref object, port object or None)`` for each public
    function, class and method the reference module defines."""
    ref = importlib.import_module("paddle_tpu." + rel)
    port = _port_module(rel)
    out = []
    for attr, obj in sorted(vars(ref).items()):
        if attr.startswith("_") or not (inspect.isfunction(obj)
                                        or inspect.isclass(obj)):
            continue
        if getattr(obj, "__module__", None) != ref.__name__:
            continue
        label = f"{rel}.{attr}"
        pobj = getattr(port, attr, None)
        if pobj is None and label in RENAMES:
            pobj = _resolve(RENAMES[label])
        out.append((label, obj, pobj))
        if not inspect.isclass(obj) or label in JAX_ONLY:
            continue
        for m, mo in sorted(vars(obj).items()):
            if m.startswith("_") and m != "__init__":
                continue
            f = mo.__func__ if isinstance(mo, (staticmethod, classmethod)) \
                else mo
            if not (inspect.isfunction(f) or isinstance(mo, property)):
                continue
            pm = getattr(pobj, m, None) if pobj is not None else None
            if pm is None and f"{label}.{m}" in RENAMES:
                pm = _resolve(RENAMES[f"{label}.{m}"])
            if m == "__init__":
                if pobj is not None and inspect.isfunction(f):
                    # a class's keywords are its constructor's
                    out.append((f"{rel}.{attr}", f, pobj))
                continue
            out.append((f"{rel}.{attr}.{m}", f, pm))
    return out


def _problems(rel: str):
    if rel in JAX_ONLY_MODULES:
        return []
    probs = []
    for label, obj, pobj in _surface(rel):
        if inspect.isclass(obj):
            if pobj is None and label not in RENAMES and label not in \
                    JAX_ONLY:
                probs.append(f"missing: {label}")
            continue
        if pobj is None:
            if label not in JAX_ONLY:
                probs.append(f"missing: {label}")
            continue
        if not inspect.isfunction(obj):
            continue
        ref_names, _ = _kw_params(obj)
        port_names, varkw = _kw_params(pobj)
        if ref_names is None or port_names is None:
            continue
        if varkw and label in FORWARDED:
            fwd, _ = _kw_params(_resolve(FORWARDED[label]))
            port_names = port_names + fwd
        for p in ref_names:
            key = f"{label}({p})"
            if p in port_names or _idiom(p) or key in PARAM_REASONS:
                continue
            if key in PARAM_RENAMES:
                if PARAM_RENAMES[key] not in port_names:
                    probs.append(f"renamed parameter not in the port: "
                                 f"{key} -> {PARAM_RENAMES[key]}")
                continue
            probs.append(f"missing parameter: {key}")
    return probs


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_and_keyword_has_its_counterpart(rel):
    if rel in JAX_ONLY_MODULES:
        with pytest.raises(ImportError):
            _port_module(rel)
        return
    assert _problems(rel) == []


def test_tables_name_only_what_is_missing():
    """Every table entry names a reference object or parameter that
    exists, and that the port still lacks under its own name: an entry
    that is no longer needed is stale."""
    seen = {}
    for rel in REF_MODULES:
        if rel in JAX_ONLY_MODULES:
            continue
        for label, obj, pobj in _surface(rel):
            seen[label] = (obj, pobj)
    for table in (RENAMES, JAX_ONLY):
        for label in table:
            assert label in seen, f"no reference object {label}"
            owner, name = label.rsplit(".", 1)
            if owner in REF_MODULES:
                owner = _port_module(owner)
            else:
                mod, cls = owner.rsplit(".", 1)
                owner = getattr(_port_module(mod), cls, None)
            assert getattr(owner, name, None) is None, \
                f"{label} is in the port now"
            assert table[label], label
    for label, target in RENAMES.items():
        assert _resolve(target) is not None, target
    for table in (PARAM_RENAMES, PARAM_REASONS):
        for key, why in table.items():
            label, p = key[:-1].split("(")
            obj, pobj = seen[label]
            assert p in _kw_params(obj)[0], f"{key}: no such parameter"
            port_names, _ = _kw_params(pobj)
            assert p not in port_names, f"{key} is in the port now"
            assert why, key
    for label, target in FORWARDED.items():
        assert _kw_params(seen[label][1])[1], f"{label} takes no **kw"
        assert _resolve(target) is not None


def test_ported_names_sit_in_no_table():
    """These names are in the port itself, not in a table."""
    tables = set(RENAMES) | set(JAX_ONLY)
    for label in PORTED:
        assert label not in tables, label
        assert _resolve(label) is not None, label
    param_tables = set(PARAM_RENAMES) | set(PARAM_REASONS)
    for key in PORTED_PARAMS:
        assert key not in param_tables, key
        label, p = key[:-1].split("(")
        fn = _resolve(label)
        names, _ = _kw_params(fn if not inspect.isclass(fn)
                              else fn.__init__)
        assert p in names, key
