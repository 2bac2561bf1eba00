"""Shared set-up of the port's fleet parity tests: the reference fleet
tests' tiny GPT (vocab 64, hidden 16, 2 layers, 2 heads, ffn 32,
max_position 64) in both packages, the port's weights carried from the
JAX ``PRNGKey`` with ``GPT.from_jax``, and engine factories for each.

A JAX engine jit-compiles its steps per instance, and its warmup takes
seconds on the CPU. The step bodies read only the engine's static
configuration, so the JAX engines made here share one engine's jitted
steps per configuration: each shape compiles once per test module."""

import jax
import numpy as np
import torch

from paddle_tpu import observability as jax_obs
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.serving import fleet as jax_fleet
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference import make_serving_engine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.serving import fleet

torch.set_num_threads(2)

VOCAB = 64
DIMS = dict(vocab_size=VOCAB, hidden_size=16, num_layers=2, num_heads=2,
            ffn_size=32, max_position=64)
GEOM = dict(num_slots=4, page_size=4, max_tokens_per_slot=32,
            prefill_chunk=4)
#: engine arguments the jitted step bodies never read
_HOST_ONLY = {"tier", "snapshot_every_blocks", "host_spill_pages",
              "max_queue_depth", "ttft_budget_s", "num_slots"}
_STEPS = ("decode_step", "prefill_step", "copy_page_step",
          "read_page_step", "write_page_step")

#: (jax module, port module) pairs the tests index by package
PACKAGES = {"jax": (jax_obs, jax_fleet), "port": (obs, fleet)}


class Pair:
    """The same weights in both packages, and engines over them."""

    def __init__(self, seed: int = 0):
        self.jmodel = JaxGPT(JaxGPTConfig.tiny(dropout=0.0, attn_impl="xla",
                                               **DIMS))
        self.params = self.jmodel.init(jax.random.PRNGKey(seed))
        self.model = GPT.from_jax(GPTConfig(**DIMS),
                                  jax.device_get(self.params), device="cpu")
        self._templates = {}

    def jax_engine(self, tracer=None, **kw):
        kw = {**GEOM, **kw}
        eng = jax_serving.ServingEngine(
            self.jmodel, self.params, attn_impl="lax", tracer=tracer,
            registry=jax_obs.MetricsRegistry(), **kw)
        key = tuple(sorted((k, str(v)) for k, v in kw.items()
                           if k not in _HOST_ONLY))
        first = self._templates.setdefault(key, eng)
        for name in _STEPS:
            setattr(eng, name, getattr(first, name))
        return eng

    def port_engine(self, tracer=None, **kw):
        return make_serving_engine(self.model, device="cpu", tracer=tracer,
                                   registry=obs.MetricsRegistry(),
                                   **{**GEOM, **kw})

    def engine(self, pkg: str, tracer=None, **kw):
        return (self.jax_engine if pkg == "jax" else self.port_engine)(
            tracer=tracer, **kw)

    def replicas(self, pkg: str, n: int, tracer=None, warm=True,
                 cost_gauges=False, names="r", **kw):
        """``n`` LocalReplicas of package ``pkg``, warmed; the bucket
        costs only where asked (the JAX cost model lowers every bucket)."""
        reps = []
        for i in range(n):
            eng = self.engine(pkg, tracer=tracer, **kw)
            if warm:
                eng.warmup(cost_gauges=cost_gauges)
            reps.append(PACKAGES[pkg][1].LocalReplica(eng,
                                                      name=f"{names}{i}"))
        return reps

    def router(self, pkg: str, n: int, *, tracer=None, seed=0,
               policy="affinity", faults=None, autoscaler=None, clock=None,
               wrap=None, prefix_fetch=True, **kw):
        """A FleetRouter of package ``pkg`` over ``n`` fresh replicas;
        ``wrap`` maps a replica index to ``ChaosReplica`` arguments."""
        pobs, pfleet = PACKAGES[pkg]
        tracer = tracer or pobs.Tracer(enabled=False)
        reps = self.replicas(pkg, n, tracer=tracer, **kw)
        for i, spec in (wrap or {}).items():
            reps[i] = pfleet.ChaosReplica(reps[i], **spec)
        extra = {"clock": clock} if clock is not None else {}
        router = pfleet.FleetRouter(
            reps, policy=policy, registry=pobs.MetricsRegistry(),
            tracer=tracer, seed=seed, faults=faults, autoscaler=autoscaler,
            prefix_fetch=prefix_fetch, **extra)
        return router, reps


def prompts(n, seed=0, lo=3, hi=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def drain(router, frids, max_steps=5000):
    """Step to idle; every request ends with a result or a structured
    reject. Returns ({frid: tokens}, {frid: reject reason})."""
    steps = 0
    while not router.idle():
        router.step()
        steps += 1
        assert steps < max_steps, "fleet did not converge"
    outs, rejects = {}, {}
    for f in frids:
        r = router.result(f)
        if r is not None:
            outs[f] = np.asarray(r)
        else:
            rej = router.reject_reason(f)
            assert rej is not None, f"request {f} silently lost"
            rejects[f] = rej.reason
    return outs, rejects


def where(router, frid):
    """Name of the replica holding ``frid``."""
    return router._where[frid][0].name
