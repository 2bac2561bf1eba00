"""Inference facade (``paddle_tpu/inference.py``): one GPT serving engine,
a fleet of them behind a router, or a router over replica server
processes; the recommender front end, an embedding serving engine over a
host or remote KV store; and the export half,
:func:`save_inference_model`, :func:`load_inference_model`,
:class:`Predictor` and :func:`fold_batch_norms`.

Export, redesigned over ``torch.export`` (the reference serializes a
jitted forward as StableHLO with ``jax.export``): a directory holds

- ``__model__.pt2``: the ``ExportedProgram`` (``torch.export.save``), its
  graph and its weights on the device it was exported on. The flash
  attention forward stays in the graph as the registered op
  ``ptt::flash_fwd`` (K5 on the card; :mod:`paddle_tpu_torch.ops.
  attention`), so the loaded program launches the same kernel;
- ``meta.json``: the reference's keys (``input_names``, ``inputs`` and
  ``outputs`` with shapes and dtypes, ``weight_quantize``) and
  ``device``.

A :class:`Predictor` runs the program with no model class: it imports
this package's attention ops (to register ``ptt::``) and nothing of the
model. It runs on the device the program was exported for and raises
elsewhere (a card's program is not moved to the CPU).

``freeze_native=True`` adds the frozen package of the reference's C++
runner (``native/pjrt_runner.cc``): ``__model__frozen__.pt2``, the program
compiled ahead of time by AOTInductor for its one device, weights
inside. :class:`paddle_tpu_torch.native.runner.NativePredictor` serves it
from a C++ process with no Python in it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Sequence


def make_serving_engine(model, **kwargs):
    """Continuous-batching serving front end for a
    :class:`~paddle_tpu_torch.models.gpt.GPT`: builds a
    :class:`~paddle_tpu_torch.serving.ServingEngine` over a paged KV
    cache. ``submit()`` requests and drive ``step()`` (or
    ``generate_many``); the engine keeps its fixed decode slots full and
    reports tokens, TTFT, slot occupancy and page utilization through
    its metrics registry. ``device`` defaults to CUDA;
    ``cache_dtype=torch.int8`` serves over the int8 page pool, and
    ``draft_model`` / ``spec_k`` / ``draft_cache_dtype`` turn on exact
    speculative decoding; ``tier`` ("prefill" or "decode") makes one half
    of a disaggregated pair, ``host_spill_pages`` adds the host spill
    tier and ``snapshot_every_blocks`` keeps micro-snapshots for
    ``restore_slot`` (see
    :class:`~paddle_tpu_torch.serving.ServingEngine`)."""
    from paddle_tpu_torch.serving.engine import ServingEngine
    return ServingEngine(model, **kwargs)


def make_serving_fleet(model, *, num_replicas: int = 2,
                       policy: str = "affinity", registry=None,
                       tracer=None, warmup: bool = True, autoscaler=None,
                       seed: int = 0, faults=None, postmortem_dir=None,
                       shed_spike_threshold: int = 4, **engine_kwargs):
    """``num_replicas`` serving engines over one
    :class:`~paddle_tpu_torch.models.gpt.GPT` (the weights are shared and
    read-only) behind a
    :class:`~paddle_tpu_torch.serving.fleet.FleetRouter`: prefix-affinity
    routing with power-of-two-choices fallback, router-minted trace ids,
    fault tolerance (``faults=``, a ``FaultPolicy``) and, with
    ``autoscaler=``, burn-rate scaling with live migration on drain. Each
    engine gets its own metrics registry and the shared ``tracer``;
    ``engine_kwargs`` go to every
    :class:`~paddle_tpu_torch.serving.ServingEngine`. Returns the router,
    its replicas warmed (every signature captured on the card) unless
    ``warmup=False``."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import fleet
    from paddle_tpu_torch.serving.engine import ServingEngine
    registry = registry or obs.default()
    tracer = tracer or obs.tracing.default()
    reps = []
    for i in range(num_replicas):
        eng = ServingEngine(model, registry=obs.MetricsRegistry(),
                            tracer=tracer, **engine_kwargs)
        rep = fleet.LocalReplica(eng, name=f"replica{i}")
        if warmup:
            rep.warmup()
        reps.append(rep)
    return fleet.FleetRouter(reps, policy=policy, registry=registry,
                             tracer=tracer, seed=seed,
                             autoscaler=autoscaler, faults=faults,
                             postmortem_dir=postmortem_dir,
                             shed_spike_threshold=shed_spike_threshold)


def make_net_serving_fleet(addresses, *, policy: str = "affinity",
                           registry=None, tracer=None, seed: int = 0,
                           faults=None, postmortem_dir=None,
                           call_timeout_s: float = 60.0,
                           shed_spike_threshold: int = 4):
    """Process-isolated serving front end, the network sibling of
    :func:`make_serving_fleet`. Each address in ``addresses`` points at
    a replica server process (spawn them with
    ``python -m paddle_tpu_torch.serving.fleet.net.replica_server`` or
    :func:`paddle_tpu_torch.serving.fleet.net.spawn_replica_server`);
    this connects a :class:`~paddle_tpu_torch.serving.fleet.net.NetReplica`
    to each and fronts them with the same
    :class:`~paddle_tpu_torch.serving.fleet.FleetRouter` the in-process
    fleet uses: the same routing, breakers, exactly-once redrive and
    migration, since the router sees only the ``ReplicaHandle`` contract.
    A dead process shows up as transport errors that trip its breaker and
    eject it; wrap the router in a
    :class:`~paddle_tpu_torch.serving.fleet.net.FrontDoor` to stream
    tokens to clients. Returns the router."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import fleet
    from paddle_tpu_torch.serving.fleet import net
    registry = registry or obs.default()
    tracer = tracer or obs.tracing.default()
    reps = [net.NetReplica(addr, call_timeout_s=call_timeout_s,
                           registry=registry)
            for addr in addresses]
    return fleet.FleetRouter(reps, policy=policy, registry=registry,
                             tracer=tracer, seed=seed, faults=faults,
                             postmortem_dir=postmortem_dir,
                             shed_spike_threshold=shed_spike_threshold)


def make_embedding_serving_engine(store, model=None, **kwargs):
    """Online embedding-lookup serving front end, the sparse/recsys
    sibling of :func:`make_serving_engine`. Builds a
    :class:`~paddle_tpu_torch.embedding_serving.EmbeddingServingEngine`
    over a host (:class:`~paddle_tpu_torch.parallel.host_kv.HostKVStore`)
    or remote (:class:`~paddle_tpu_torch.parallel.kv_server.
    RemoteKVStore`) KV backing store: ``submit()`` batches of sparse ids
    and drive ``step()`` (or call ``serve()``); hot rows come from a
    fixed-shape device cache (misses pulled async and installed with
    LRU/LFU eviction) while trainer pushes stream in through a
    :class:`~paddle_tpu_torch.embedding_serving.StreamingUpdateChannel`
    under an enforced staleness bound. ``model`` (a
    :class:`~paddle_tpu_torch.models.deepfm.DeepFMHostKV`) turns rows into
    click probabilities; ``device`` defaults to CUDA; ``warmup((B, F))``
    captures every graph a batch of that shape can use."""
    from paddle_tpu_torch.embedding_serving import EmbeddingServingEngine
    return EmbeddingServingEngine(store, model, **kwargs)


# ---------------------------------------------------------------------------
# export: save_inference_model, Predictor, fold_batch_norms
# ---------------------------------------------------------------------------

_MODEL_FILE = "__model__.pt2"
#: the AOTInductor package of ``freeze_native=True`` (the native runner's)
FROZEN_FILE = "__model__frozen__.pt2"
_META_FILE = "meta.json"


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _function_module(fn):
    """A module whose forward is ``fn(*inputs)`` (``torch.export`` takes
    modules; a closed-over model's tensors become the program's)."""
    import torch

    class _Fn(torch.nn.Module):
        def forward(self, *inputs):
            return fn(*inputs)

    return _Fn()


def _int8_program(model):
    """``model`` with every weight :func:`paddle_tpu_torch.slim.
    quantize_int8` selects held as int8 and float32 scale buffers and
    dequantized in the graph, to the weight's dtype, at each use (a copy:
    ``model`` keeps its weights)."""
    import copy

    import torch

    from paddle_tpu_torch import slim

    class _Int8(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = copy.deepcopy(model)
            self.quantized = []
            for i, (name, p) in enumerate(list(
                    self.model.named_parameters())):
                parent, _, leaf = name.rpartition(".")
                if not slim.quantizable((leaf,), p):
                    continue
                q = slim.quantize_int8(p.detach())
                self.register_buffer(f"q{i}", q["q"])
                self.register_buffer(f"scale{i}", q["scale"])
                del self.model.get_submodule(parent)._parameters[leaf]
                self.quantized.append((name, f"q{i}", f"scale{i}", p.dtype))

        def forward(self, *inputs):
            weights = {name: slim.dequantize_int8(
                {"q": getattr(self, q), "scale": getattr(self, sc)}, dtype)
                for name, q, sc, dtype in self.quantized}
            return torch.func.functional_call(self.model, weights, inputs,
                                              strict=False)

    return _Int8()


def _program_device(module, example_inputs) -> str:
    import torch
    for t in list(module.parameters()) + list(module.buffers()) + [
            x for x in example_inputs if isinstance(x, torch.Tensor)]:
        return str(t.device)
    return "cpu"


def _specs(values) -> list:
    import torch
    return [{"shape": list(v.shape), "dtype": _dtype_name(v.dtype)}
            for v in values if isinstance(v, torch.Tensor)]


def save_inference_model(path: str, model_or_fn, example_inputs:
                         Sequence[Any], input_names:
                         Optional[Sequence[str]] = None, *,
                         weight_quantize: Optional[str] = None,
                         freeze_native: bool = False):
    """Export ``model_or_fn(*example_inputs)`` for serving (module
    docstring for the directory's files). ``model_or_fn`` is a module
    (its ``forward``) or a function of the inputs; it is traced in eval
    mode under ``torch.no_grad()``, on the device its tensors and the
    inputs lie on. Returns the ``ExportedProgram``.

    ``weight_quantize="int8"``: the program holds every weight matrix
    (2-D and up leaves named ``weight``) as per-channel symmetric int8
    plus float32 scales (:mod:`paddle_tpu_torch.slim`, the reference's
    values) and dequantizes them in the graph at each use, so the
    artifact's weights are about 4x smaller than float32 (2x than bf16).

    ``freeze_native=True`` also compiles the program with AOTInductor
    (``torch._inductor.aoti_compile_and_package``) into
    ``__model__frozen__.pt2`` for the native runner
    (:class:`~paddle_tpu_torch.native.runner.NativePredictor`), on the
    program's one device; the flash attention stays the op
    ``ptt::flash_fwd``, which the runner registers in C++. int8 weights
    stay int8 constants in the package (nothing folds ``q * scale``: the
    weights are the program's constants, not frozen into the graph). The
    default stays ``False``, unlike the reference's: an AOTInductor
    compile costs tens of seconds even for a tiny model (g++ or Triton
    compiles every generated kernel). An export without it deletes an
    earlier frozen package in ``path``, so the runner never serves stale
    weights."""
    import torch
    if weight_quantize not in (None, "int8"):
        raise ValueError(f"weight_quantize must be None or 'int8', "
                         f"got {weight_quantize!r}")
    example_inputs = tuple(example_inputs)
    module = (model_or_fn if isinstance(model_or_fn, torch.nn.Module)
              else _function_module(model_or_fn))
    was_training = module.training
    module.eval()
    try:
        if weight_quantize == "int8":
            module = _int8_program(module)
        with torch.no_grad():
            program = torch.export.export(module, example_inputs)
    finally:
        if was_training and isinstance(model_or_fn, torch.nn.Module):
            model_or_fn.train()
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, _MODEL_FILE))
    out_node = next(n for n in program.graph.nodes if n.op == "output")
    outputs = [n.meta["val"] for n in out_node.args[0]]
    names = list(input_names or
                 [f"x{i}" for i in range(len(example_inputs))])
    if len(names) != len(example_inputs):
        raise ValueError(f"{len(names)} input names for "
                         f"{len(example_inputs)} inputs")
    meta = {"input_names": names, "inputs": _specs(example_inputs),
            "outputs": _specs(outputs), "weight_quantize": weight_quantize,
            "device": _program_device(module, example_inputs)}
    frozen = os.path.join(path, FROZEN_FILE)
    if freeze_native:
        # Inductor compiles and links the package with the g++ on PATH, as
        # every native build of the port does (its default is $CXX, which
        # a host may point at a compiler without OpenMP), and rounds fused
        # low-precision intermediates where eager PyTorch rounds them, so
        # the frozen program computes what the module computes. A card's
        # program has no CPU kernel worth vectorizing, so it skips the CPU
        # ISA probes (a fresh Python process each, which imports torch
        # where Inductor's probe does so)
        cfg = {"cpp.cxx": (None, "g++"), "emulate_precision_casts": True}
        if meta["device"].startswith("cuda"):
            cfg["cpp.vec_isa_ok"] = False
        with torch._inductor.config.patch(cfg):
            torch._inductor.aoti_compile_and_package(program,
                                                     package_path=frozen)
    elif os.path.exists(frozen):
        os.remove(frozen)
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return program


def load_inference_model(path: str) -> "Predictor":
    return Predictor(path)


class Predictor:
    """Serving wrapper over an exported program (the reference's
    ``Predictor``, the AnalysisPredictor analog): ``run(*inputs)`` or
    ``run(feed={name: array})``, the Executor's feed protocol. Inputs may
    be numpy arrays or tensors; host ones are copied to the program's
    device, a tensor on another device than the program's raises.
    Outputs are tensors on the program's device. Keeps
    ``inference_predictors_total``, ``inference_requests_total`` and
    ``inference_latency_seconds`` (the call's dispatch latency: on the
    card the kernels may still run when it returns) in the package's
    default metrics registry."""

    def __init__(self, path: str):
        import torch

        # registers the ptt:: ops an exported program calls
        import paddle_tpu_torch.ops.attention  # noqa: F401
        from paddle_tpu_torch import observability as obs
        with open(os.path.join(path, _META_FILE)) as f:
            self.meta = json.load(f)
        self.device = torch.device(self.meta.get("device", "cpu"))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{path} was exported for {self.device}, and no CUDA device "
                "is available here: a Predictor runs on the device its "
                "program was exported for (export it again on the CPU to "
                "serve it there)")
        self.program = torch.export.load(os.path.join(path, _MODEL_FILE))
        self._fn = self.program.module()
        self.input_names = self.meta["input_names"]
        self._reg = obs.default()
        self._reg.counter("inference_predictors_total",
                          "Predictor instances loaded").inc()

    def _input(self, x, name):
        import numpy as np
        import torch
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.device.type != "cpu" and x.device != self.device:
            raise ValueError(f"input {name!r} is on {x.device}; this "
                             f"program runs on {self.device}")
        return x.to(self.device)

    def run(self, *inputs, feed: Optional[Dict[str, Any]] = None):
        import torch
        if feed is not None:
            inputs = tuple(feed[name] for name in self.input_names)
        if len(inputs) != len(self.input_names):
            raise ValueError(f"expected {len(self.input_names)} inputs "
                             f"{self.input_names}, got {len(inputs)}")
        args = [self._input(x, n) for x, n in zip(inputs, self.input_names)]
        t0 = time.perf_counter()
        with torch.no_grad():
            out = self._fn(*args)
        self._reg.counter("inference_requests_total").inc()
        self._reg.histogram("inference_latency_seconds",
                            "Predictor.run dispatch latency").observe(
                                time.perf_counter() - t0)
        return out


def _is_bn(node) -> bool:
    return (isinstance(node, dict)
            and {"scale", "bias", "mean", "variance"} <= set(node))


def _fold_pair(conv, bn, eps):
    """Fold an eval-mode BatchNorm into the preceding conv's parameters:
    the per-channel scale s = gamma / sqrt(var + eps) moves into the conv
    weight along its output-channel axis (axis 0 of torch's OIHW; the
    reference scales HWIO's last axis), and the BN becomes a pure bias
    add (scale 1, mean 0, variance 1 - eps, so sqrt(var + eps) == 1)."""
    import torch
    s = bn["scale"] / torch.sqrt(bn["variance"] + eps)
    conv = dict(conv)
    w = conv["weight"]
    conv["weight"] = w * s.reshape((-1,) + (1,) * (w.ndim - 1))
    if "bias" in conv:
        new_bias = bn["bias"] + s * (conv["bias"] - bn["mean"])
        conv["bias"] = torch.zeros_like(conv["bias"])
    else:
        new_bias = bn["bias"] - s * bn["mean"]
    bn = dict(bn)
    bn["scale"] = torch.ones_like(bn["scale"])
    bn["bias"] = new_bias
    bn["mean"] = torch.zeros_like(bn["mean"])
    bn["variance"] = torch.ones_like(bn["variance"]) * (1.0 - eps)
    return conv, bn


def fold_batch_norms(params, eps: float = 1e-5):
    """Inference-time conv+BN folding over a parameter tree (nested dicts
    of tensors; the reference's ``conv_bn_fuse_pass`` as a tree
    transform). Folds the two layouts of the model zoo: a ``{"conv",
    "bn"}`` sibling pair and index-aligned ``{"convs": {i}, "bns": {i}}``
    lists; lists whose keys differ (an offset mapping, DCGAN's
    discriminator) are left alone. Eval graphs only. The folded tree
    computes the same function in the same model."""
    if not isinstance(params, dict):
        return params
    out = {k: fold_batch_norms(v, eps) for k, v in params.items()}
    if ("conv" in out and "bn" in out and _is_bn(out["bn"])
            and isinstance(out["conv"], dict) and "weight" in out["conv"]):
        out["conv"], out["bn"] = _fold_pair(out["conv"], out["bn"], eps)
    if (isinstance(out.get("convs"), dict)
            and isinstance(out.get("bns"), dict)
            and set(out["convs"]) == set(out["bns"])):
        for i in out["bns"]:
            if (_is_bn(out["bns"][i])
                    and isinstance(out["convs"][i], dict)
                    and "weight" in out["convs"][i]):
                out["convs"] = dict(out["convs"])
                out["bns"] = dict(out["bns"])
                out["convs"][i], out["bns"][i] = _fold_pair(
                    out["convs"][i], out["bns"][i], eps)
    return out
