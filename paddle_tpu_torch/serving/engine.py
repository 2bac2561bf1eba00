"""ServingEngine: continuous-batching GPT inference over a paged KV cache
(``paddle_tpu/serving/engine.py``, the single-device subset).

The serving loop is two fixed-shape device steps:

- a **batched chunked-prefill step**: one call advances every admitted
  request's next prompt chunk at once — tokens (S, C), ragged per-slot
  valid counts, causal paged attention through
  :func:`~paddle_tpu_torch.serving.paged_attention.ragged_paged_prefill_attention`;
- a **decode step**: every slot advances a block of ``decode_block``
  tokens per call (one device-to-host copy per block), attending over
  its own pages through
  :func:`~paddle_tpu_torch.serving.paged_attention.ragged_paged_decode_attention`.

Block-table widths are pow2-bucketed over the live high-water mark, so
attention work follows live tokens. Pages are written in place
(``index_put_``), which stands in for the reference's buffer donation.
``cache_dtype=torch.int8`` stores int8 pages with fp32 per-token-row
scales (``paged_cache.quantize_kv``) and attends through the
dequant-attend entry points.
Prefill and decode interleave under a per-step prompt-token budget
(``prefill_budget``); prefix sharing maps published prompt pages into a
new slot and performs the one copy-on-write copy a borrowed tail page
needs. Scheduling is SLO-aware by default (priority lanes, TTFT
deadlines, bounded skipping, structured load shedding).

Speculative decoding: pass ``draft_model`` (+ ``spec_k``) and each decode
round becomes draft-then-verify. The draft proposes ``spec_k`` greedy
tokens per slot on its own paged cache (the decode loop with
``n_steps=spec_k``), the target verifies the chunk ``[pending, d_1 ..
d_{k-1}]`` in one batched-prefill call that returns its greedy token
after every position, and each slot keeps the longest agreeing draft
prefix plus the target's own next token, so the output is exactly
non-speculative greedy decoding; rollback is a host-side cursor rewind
on both caches. Speculation turns prefix sharing off (the draft must
prefill every prompt token).

Every device call is one bucket signature (``("decode", w)``,
``("prefill", w, lanes)``, ``("draft", w)``, ``("verify", w)``,
``("draft_prefill", w, lanes)``, ``("copy_page",)``, ``("page_read",)``,
``("page_write",)``), and on the card
each signature is one captured CUDA graph (:mod:`.graphs`), the
counterpart of the reference's one compiled XLA program per bucket:
:meth:`ServingEngine.warmup` captures every signature of
:meth:`~ServingEngine.warmup_plan`, which covers
:meth:`~ServingEngine.reachable_signatures`, so steady-state serving
captures nothing (``health()["recompiles"]`` counts any capture after
warmup). ``cuda_graphs=False`` dispatches eagerly instead; the CPU
always does, counting its builds the same way.

Observability, all host-side and outside every graph: ``tracer=`` for
one root span per request with scheduler events and child spans per
prefill chunk and decode block, ``ttft_budget_s=`` for an SLO burn-rate
monitor over the TTFT histogram, ``request_stats(rid)``, ``health()``
with the resource headroom, step anatomy (``anatomy``), the flight
recorder (``flight``) and ``start_exposition()``.

KV mobility, all through the two page-IO signatures (one page id a
device scalar, the page laid out ``(2, L, page_size, H, Dh)`` plus the
scale rows ``(2, L, page_size)`` of an int8 pool):

- slot migration: :meth:`ServingEngine.snapshot_slot` carries an
  in-flight request with one sha256-digested shard per live page (the
  reference's transfer format, :data:`MIGRATION_FORMAT`; a bf16 page
  travels as the uint16 view of its bits, numpy having no bf16), and
  :meth:`~ServingEngine.restore_slot` verifies every shard before any
  page lands; ``snapshot_every_blocks`` keeps micro-snapshots;
- disaggregated tiers: ``tier="prefill"`` parks prefill-done slots for
  :meth:`~ServingEngine.poll_handoffs`, ``tier="decode"`` takes only
  restored slots;
- the host spill tier (``host_spill_pages``): evicted published pages
  park in host memory and come back on a prefix hit;
- prefix-page exchange: :meth:`~ServingEngine.export_prefix_pages` and
  :meth:`~ServingEngine.import_prefix_pages` (:data:`PREFIX_BUNDLE_FORMAT`,
  the whole chain proven from the root).

Tensor parallelism (the reference's ``mesh=`` / ``tp=`` path): the
engine runs on every rank of a mesh's "tp" axis (a ``torch.distributed``
group the caller started, :func:`~paddle_tpu_torch.core.mesh.make_mesh`).
Each rank holds ``H/tp`` heads of every page pool and of the attention
projections (:func:`~paddle_tpu_torch.parallel.plan.serving_tp_plan`),
runs K1-K4 on its local heads (the tp=1 kernels: heads are
independent), and one all-reduce per layer closes the row-split output
projection (a prefill tier adds a second for the Megatron MLP; int8
pools complete each token's K and V abs-max with one MAX all-reduce, so
the rows quantize as at tp=1). Rank 0 leads: its engine is the one callers
``submit``, ``step``, snapshot and read ``health()`` on, and before each
device call it broadcasts the call over a CPU group (:mod:`.tp`); ranks 1
to tp-1 build the same engine and call :meth:`ServingEngine.follow`,
which returns when rank 0's :meth:`~ServingEngine.close` stops it. The
hidden state after every layer and the LM head are replicated, so every
rank computes the same tokens. Slot snapshots and prefix bundles carry
one sha256 shard per (page, tp shard), as the reference's do.
``tp_probe=True`` runs one shard's local work on one device with the
collectives elided (the per-chip compute of a tp deployment), and a tp
engine's rank 0 re-runs the decode shapes through such a twin every
``anatomy_probe_every`` rounds to measure the exposed collective time.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import threading
import time
import traceback
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.core import mesh as mesh_lib
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.serving import paged_attention as PA
from paddle_tpu_torch.serving import tp as tp_lib
from paddle_tpu_torch.serving.graphs import StepGraphs
from paddle_tpu_torch.serving.paged_cache import (_ROOT_KEY, _chain,
                                                  PagedCacheConfig,
                                                  PagedKVCache,
                                                  payload_digest,
                                                  quantize_kv)
from paddle_tpu_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                                LoadShedError, Reject,
                                                Request, SLOScheduler,
                                                SlotState)

# TTFT/queue-wait histograms need sub-second resolution around
# interactive SLO budgets (the reference's buckets)
_LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.2, 0.35,
                    0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 4.0, 5.0, 7.5, 10.0,
                    15.0, 30.0, 60.0)

#: the reference's transfer formats, so snapshots and bundles cross
#: between the two packages
MIGRATION_FORMAT = "paddle_tpu.serving.slot-migration-v1"
PREFIX_BUNDLE_FORMAT = "paddle_tpu.serving.prefix-pages-v1"

#: the numpy dtype a page's K/V travels as, by pool dtype: numpy has no
#: bf16, so bf16 pages travel as the uint16 view of their bits (the same
#: bytes, hence the reference's digests); never converted as values
_HOST_DTYPES = {torch.float32: np.dtype(np.float32),
                torch.float16: np.dtype(np.float16),
                torch.bfloat16: np.dtype(np.uint16),
                torch.int8: np.dtype(np.int8)}


def _dtype_name(dtype: torch.dtype) -> str:
    """The geometry's dtype string, as the reference writes
    ``str(jnp.dtype(...))``: "float32", "bfloat16", "int8"."""
    return str(dtype).rsplit(".", 1)[-1]


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A page tensor as the dtype it travels in: bf16 as its int16 bits."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _host_array(h: torch.Tensor) -> np.ndarray:
    """A host tensor of :func:`_bits` as numpy (int16 bits as uint16)."""
    a = h.numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a


def _host_tensor(a) -> torch.Tensor:
    """A copy of the host array ``a`` as a tensor (uint16 bits as int16):
    the inverse of :func:`_host_array`."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)


@dataclasses.dataclass(frozen=True)
class BucketCost:
    """Analytic price of one bucket signature (:func:`bucket_cost`)."""

    total_flops: float
    peak_hbm_bytes: int


def bucket_cost(sig: tuple, cfg, draft_cfg, *, num_slots: int,
                page_size: int, chunk: int, spec_k: int,
                hbm_bytes: int) -> BucketCost:
    """Flops of one call of ``sig`` counted from the model configs and
    the signature's shape, with 2 flops per multiply-add:

    - each token through a model's layers: ``L * 2 * (4 H^2 + 2 H F)``
      (q, k, v and the output projection; the two FFN matmuls);
    - attention of ``q`` queries over the gathered width's ``w *
      page_size`` tokens: ``L * 4 * H * q * w * page_size`` (``Q K^T``
      and ``P V``);
    - each row through the tied LM head: ``2 * H * V``.

    ``("decode", w)`` and ``("draft", w)`` are priced per step of their
    block (``num_slots`` tokens, one head row each), as the reference's
    cost model prices a loop body once; ``("prefill", w, lanes)`` and
    ``("draft_prefill", w, lanes)`` run ``lanes * chunk`` tokens with one
    head row per lane; ``("verify", w)`` runs ``num_slots * spec_k``
    tokens with a head row each. Page IO and the page copy do no
    arithmetic: 0 flops. ``peak_hbm_bytes`` is ``hbm_bytes``, the page
    pools' bytes plus the weights' bytes, for every signature."""
    phase = sig[0]
    model = draft_cfg if phase in ("draft", "draft_prefill") else cfg
    if phase in ("decode", "draft", "decode_probe"):
        tokens, rows = num_slots, num_slots
    elif phase in ("prefill", "draft_prefill"):
        tokens, rows = sig[2] * chunk, sig[2]
    elif phase == "verify":
        tokens = rows = num_slots * spec_k
    else:
        return BucketCost(0.0, int(hbm_bytes))
    h, f, n = model.hidden_size, model.ffn_size, model.num_layers
    ctx = sig[1] * page_size
    flops = (tokens * n * 2 * (4 * h * h + 2 * h * f)
             + n * 4 * h * tokens * ctx
             + rows * 2 * h * model.vocab_size)
    return BucketCost(float(flops), int(hbm_bytes))


def check_tp_graphs(tp: int, tp_probe: bool, graphed: bool):
    """A tp engine's collectives run over gloo on one card or over NCCL
    across cards, and neither is captured in the step graphs yet
    (ROADMAP, "NCCL across cards": tp across cards with captured
    collectives): a graphed tp engine is refused. A probe engine has no
    collectives and graphs as a tp=1 engine does."""
    if tp > 1 and not tp_probe and graphed:
        raise ValueError(
            "cuda_graphs=True with tp > 1: collectives are not captured "
            "in the step graphs (ROADMAP, \"NCCL across cards\": tp "
            "across cards with captured collectives); pass "
            "cuda_graphs=False")


class SlotMigrationError(RuntimeError):
    """A slot snapshot (or prefix bundle) cannot be restored: corrupt
    shard (sha256 mismatch), incompatible cache geometry, inconsistent
    state, or no free slot or pages on this engine."""


class ServingEngine:
    """Continuous-batching front end over a
    :class:`~paddle_tpu_torch.models.gpt.GPT` (which holds the weights).

    ``submit()`` enqueues a request, ``step()`` advances the engine one
    iteration (admit + budgeted batched prefill + one decode block +
    evict), and ``generate_many()`` drives the loop to completion.
    Decoding is greedy. ``device`` defaults to CUDA and must be where
    the model lives. ``attn_impl="kernel"`` (the default) dispatches
    attention on the tensors' device — the Hopper kernels on CUDA, the
    plain versions on the CPU; ``"plain"`` runs the plain PyTorch
    versions on any device, the reference run the kernels are held
    against on the card. ``cache_dtype=torch.int8`` selects the int8
    page pool and its dequant-attend entry points. ``draft_model`` (a
    ``GPT`` on the same device with the target's vocabulary) turns on
    speculative decoding with ``spec_k`` proposals per round over a draft
    cache of ``draft_cache_dtype`` (default ``cache_dtype``, else the
    draft's weight dtype). ``cuda_graphs`` (default on) replays one
    captured CUDA graph per bucket signature on the card; ``False``
    dispatches every call eagerly (the graphs' parity leg). ``tracer``,
    ``ttft_budget_s`` and ``slo_windows`` are the reference's
    observability arguments. ``tier`` ("colocated", "prefill" or
    "decode"), ``snapshot_every_blocks`` and ``host_spill_pages`` are the
    reference's disaggregation, micro-snapshot and host spill
    arguments. ``mesh`` (a ``DeviceMesh`` with a "tp" axis) or ``tp``
    (with an initialized process group of ``tp`` ranks, or the ambient
    ``mesh_context``) shards the engine over tensor-parallel ranks (the
    module docstring), ``tp_probe`` makes the one-shard probe engine and
    ``anatomy_probe_every`` sets the collective probe's rounds (default
    64 on a tp engine, else off). A tp engine on the card dispatches
    eagerly: ``cuda_graphs=True`` with ``tp > 1`` raises."""

    def __init__(self, model, *, num_slots: int = 8, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_tokens_per_slot: Optional[int] = None,
                 prefill_chunk: int = 32, decode_block: int = 8,
                 prefill_budget: Optional[int] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 prefix_sharing: bool = True,
                 scheduler_policy: str = "slo",
                 lanes: Sequence[str] = ("interactive", "default", "batch"),
                 max_queue_depth: Optional[int] = None,
                 starvation_skips: int = 64,
                 registry: Optional[obs.MetricsRegistry] = None,
                 tracer: Optional[obs.Tracer] = None,
                 ttft_budget_s: Optional[float] = None,
                 slo_windows=(60.0, 300.0),
                 attn_impl: str = "kernel", device="cuda",
                 draft_model=None, spec_k: int = 4,
                 draft_cache_dtype: Optional[torch.dtype] = None,
                 cuda_graphs: bool = True,
                 snapshot_every_blocks: Optional[int] = None,
                 tier: str = "colocated", host_spill_pages: int = 0,
                 mesh=None, tp: Optional[int] = None,
                 tp_probe: bool = False,
                 anatomy_probe_every: Optional[int] = None):
        if getattr(model.cfg, "pipeline", False) or getattr(
                model.cfg, "stacked_layers", False):
            raise ValueError(
                "ServingEngine needs the LayerList GPT layout; convert "
                "stacked/pipeline checkpoints for serving first")
        self.device = resolve_device(device)
        # disaggregation: a "prefill" engine runs only the batched
        # prefill and parks prefill-done slots for poll_handoffs; a
        # "decode" engine takes only restored slots and runs only decode
        if tier not in ("colocated", "prefill", "decode"):
            raise ValueError(
                f"tier must be 'colocated', 'prefill' or 'decode', "
                f"got {tier!r}")
        if tier != "colocated" and draft_model is not None:
            raise ValueError(
                "speculative decoding does not compose with a "
                "disaggregated tier (draft caches do not migrate)")
        self.tier = tier
        # handoff-fallback slots a prefill-tier engine decodes itself
        self._decode_in_place: set = set()
        for what, m in (("model", model), ("draft_model", draft_model)):
            if m is not None and m.device != self.device:
                raise ValueError(f"{what} lives on {m.device}, engine "
                                 f"device is {self.device}")
        cfg = model.cfg
        # -- tensor parallelism: heads split H/tp over the mesh's "tp"
        # axis, one all-reduce per layer at the attention output
        mesh_tp = (mesh_lib.axis_size(mesh, mesh_lib.TP)
                   if mesh is not None else None)
        if mesh is not None and tp is not None and int(tp) != mesh_tp:
            raise ValueError(f"tp={tp} disagrees with the mesh's tp "
                             f"axis ({mesh_tp})")
        tp = int(mesh_tp if mesh is not None else (tp or 1))
        if tp > 1:
            if cfg.num_heads % tp:
                raise ValueError(
                    f"tp={tp} must divide num_heads={cfg.num_heads}")
            if draft_model is not None:
                raise ValueError(
                    "speculative decoding does not compose with tensor "
                    "parallelism (the draft cache is single-device)")
        check_tp_graphs(tp, tp_probe,
                        cuda_graphs and self.device.type == "cuda")
        if tp_probe:
            if tp < 2:
                raise ValueError("tp_probe needs tp >= 2")
            mesh = None            # one shard's work, one device
        elif tp > 1 and mesh is None:
            mesh = mesh_lib.current_mesh()
            if mesh is None or mesh_lib.axis_size(mesh, mesh_lib.TP) != tp:
                if not dist.is_initialized() or \
                        dist.get_world_size() != tp:
                    raise ValueError(
                        f"tp={tp} needs a mesh (mesh=, or mesh_context) "
                        f"or an initialized process group of {tp} ranks")
                mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(tp=tp),
                                          device_type=self.device.type)
        self.mesh = mesh if tp > 1 else None
        self.tp = tp
        self.tp_probe = bool(tp_probe)
        self.tp_spmd = self.mesh is not None
        self._tp_heads = cfg.num_heads // tp
        # prefill tier under tp: the Megatron MLP split too (prefill is
        # flops-bound: worth a second all-reduce per layer)
        self._mlp_sharded = tier == "prefill" and self.tp_spmd
        self._link = tp_lib.TpLink(self.mesh) if self.tp_spmd else None
        #: all-reduces this rank's steps issued, by site ("attn_out" per
        #: layer, "mlp" per layer of a prefill tier, "kv_amax" one per
        #: layer of an int8 pool): host-side counts of eager calls
        self.tp_all_reduces: "collections.Counter[str]" = \
            collections.Counter()
        self._lead = self._link is None or self._link.lead
        # step-side weights of this rank: head-major local slices of the
        # attention projections (shard 0's on a probe engine)
        self._tp_layers = (tp_lib.rank_layers(
            model, tp, self._link.rank if self.tp_spmd else 0,
            self._mlp_sharded) if tp > 1 else None)
        # (decode, prefill) attention by pool kind: False = fp, True = int8;
        # a tp rank runs them on its pool's H/tp heads
        if attn_impl not in ("kernel", "plain"):
            raise ValueError(f"attn_impl must be 'kernel' or 'plain', "
                             f"got {attn_impl!r}")
        if attn_impl == "kernel":
            self._attn = {
                False: (PA.ragged_paged_decode_attention,
                        PA.ragged_paged_prefill_attention),
                True: (PA.ragged_paged_decode_int8_attention,
                       PA.ragged_paged_prefill_int8_attention)}
        else:
            self._attn = {
                False: (PA.paged_decode_plain, PA.paged_prefill_plain),
                True: (PA.paged_decode_int8_plain,
                       PA.paged_prefill_int8_plain)}
        self.model = model
        self.draft_model = draft_model
        self.speculative = draft_model is not None
        self.spec_k = int(spec_k)
        if self.speculative:
            if draft_model.cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    "draft and target models must share a vocabulary "
                    f"({draft_model.cfg.vocab_size} != {cfg.vocab_size})")
            if self.spec_k < 2:
                raise ValueError("spec_k must be >= 2 (spec_k=1 is plain "
                                 "decoding: drop the draft)")
            # the draft cache must hold every prompt token (the draft
            # prefills alongside the target), so target-side prefix
            # sharing, which skips shared tokens, would desynchronize the
            # two caches
            prefix_sharing = False
        self.prefill_chunk = int(prefill_chunk)
        self.decode_block = max(int(decode_block), 1)
        # prompt tokens per step() (default = one full batched call)
        self.prefill_budget = int(prefill_budget or
                                  num_slots * self.prefill_chunk)
        if max_tokens_per_slot is None:
            max_tokens_per_slot = cfg.max_position
        max_pages_per_slot = -(-max_tokens_per_slot // page_size)
        if num_pages is None:
            # every slot full, +1 null page — callers can size DOWN to
            # bet on early EOS (that is the paging win)
            num_pages = num_slots * max_pages_per_slot + 1
        # a probe engine's pool holds one shard's heads; a tp engine's
        # pool is shaped for all heads and holds this rank's H/tp
        cache_cfg = PagedCacheConfig(
            num_layers=cfg.num_layers,
            num_heads=self._tp_heads if self.tp_probe else cfg.num_heads,
            head_dim=cfg.hidden_size // cfg.num_heads,
            num_slots=num_slots, page_size=page_size, num_pages=num_pages,
            max_pages_per_slot=max_pages_per_slot,
            dtype=cache_dtype or model.wte.weight.dtype,
            share_prefix=prefix_sharing)
        self.cache = PagedKVCache(cache_cfg, device=self.device,
                                  host_spill_pages=host_spill_pages,
                                  mesh=self.mesh)
        self.quantized = self.cache.config.quantized
        self.draft_cache = None
        if self.speculative:
            dcfg = draft_model.cfg
            # the target's slot and page geometry: reservations run in
            # lockstep, so target admission implies draft admission
            self.draft_cache = PagedKVCache(PagedCacheConfig(
                num_layers=dcfg.num_layers, num_heads=dcfg.num_heads,
                head_dim=dcfg.hidden_size // dcfg.num_heads,
                num_slots=num_slots, page_size=page_size, num_pages=num_pages,
                max_pages_per_slot=max_pages_per_slot,
                dtype=(draft_cache_dtype or cache_dtype
                       or draft_model.wte.weight.dtype),
                share_prefix=False), device=self.device)
        if scheduler_policy == "slo":
            self.scheduler = SLOScheduler(
                num_slots, can_admit=self._can_admit, lanes=lanes,
                max_queue_depth=max_queue_depth,
                starvation_skips=starvation_skips)
        elif scheduler_policy == "fifo":
            self.scheduler = ContinuousBatchingScheduler(
                num_slots, can_admit=self._can_admit)
        else:
            raise ValueError(
                f"scheduler_policy must be 'slo' or 'fifo', "
                f"got {scheduler_policy!r}")
        self._reg = registry or obs.default()
        self.recompile_detector = obs.RecompileDetector(
            "serving_decode", warmup=1, registry=self._reg)
        # request-lifecycle tracing: one root span per request, children
        # per prefill chunk / decode block, scheduler verdicts as events;
        # host-side only, so tracing cannot change what a graph runs
        self.tracer = tracer or obs.tracing.default()
        self._req_spans: Dict[int, object] = {}
        self._phase_acc: Dict[int, Dict[str, float]] = {}
        self.scheduler.event_cb = self._sched_event
        self.ttft_budget_s = ttft_budget_s
        self.slo_monitor = None
        if ttft_budget_s is not None:
            self.slo_monitor = obs.BurnRateMonitor(
                "serving_ttft_seconds", ttft_budget_s,
                windows=slo_windows, registry=self._reg,
                tracer=self.tracer)
        self.anatomy = obs.StepAnatomy(registry=self._reg,
                                       tracer=self.tracer)
        self.flight = obs.FlightRecorder(
            "engine", anatomy=self.anatomy, registry=self._reg,
            tracer=self.tracer)
        self._anat_steps = 0
        if anatomy_probe_every is not None and anatomy_probe_every < 0:
            raise ValueError("anatomy_probe_every must be >= 0")
        # collective-exposed sampling: every N decode rounds rank 0 of a
        # tp engine re-runs the same decode shapes through a twin with
        # the collectives elided (one shard's work on a zero pool); the
        # wall delta is the exposed collective time
        self.anatomy_probe_every = (
            (64 if anatomy_probe_every is None else anatomy_probe_every)
            if self.tp_spmd else 0)
        self._decode_rounds = 0
        self._probe_cache = None
        if self.anatomy_probe_every and self._lead:
            self._probe_cache = PagedKVCache(cache_cfg, device=self.device,
                                             mesh=self.mesh)
        # finished-request store for result(); pop-on-read + bounded
        self._results: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._rejects: "OrderedDict[int, Reject]" = OrderedDict()
        self._stats: "OrderedDict[int, Dict[str, float]]" = OrderedDict()
        self._results_cap = max(64, 16 * num_slots)
        # one captured graph per bucket signature on the card (eager
        # calls on the CPU or with cuda_graphs=False), built by warmup()
        # or on a signature's first use
        self.graphs = StepGraphs(self.device, self._bucket_spec,
                                 enabled=cuda_graphs)
        self.warmed_signatures: set = set()
        # pinned staging buffers of the page IO, by (turn, shapes)
        self._ring: Dict[tuple, tuple] = {}
        # the spill tier reads an evicted page through the warmed
        # ("page_read",) signature: spill traffic builds nothing
        self.cache.attach_spill_io(self._spill_read)
        # micro-snapshots: every K decode blocks an in-flight slot's
        # snapshot lands in an outbox (poll_micro_snapshots)
        if snapshot_every_blocks is not None:
            if self.speculative:
                raise ValueError(
                    "micro-snapshots need slot migration, which "
                    "speculative engines do not support")
            if snapshot_every_blocks < 1:
                raise ValueError("snapshot_every_blocks must be >= 1")
        self.snapshot_every_blocks = snapshot_every_blocks
        self._micro_snaps: Dict[int, Dict] = {}
        self._last_snap_blocks: Dict[int, int] = {}
        # trace ids adopted from restored snapshots, kept for
        # request_stats even with tracing off
        self._ext_trace: Dict[int, int] = {}
        self.migrated_in_total = 0
        self.migrated_out_total = 0
        # flops headroom: priced buckets retired per busy second against
        # the best per-call rate seen (warmup prices the buckets)
        self.bucket_costs: Dict[tuple, BucketCost] = {}
        self._busy_s = 0.0
        self._flops_done = 0.0
        self._flops_rate_peak = 0.0
        # health(): a monitor may poll from its own thread while step()
        # mutates the books, so step() publishes a snapshot at safe
        # points and health() reads only that, under a lock
        self._health_lock = threading.Lock()
        self._health_snap: Dict[str, object] = {}
        self._refresh_health()

    # -- request surface --------------------------------------------------

    def _can_admit(self, req) -> bool:
        return self.cache.can_reserve(req.total_tokens, prompt=req.prompt)

    def submit(self, prompt, max_new_tokens: int = 32,
               eos_id: Optional[int] = None, *, lane: str = "default",
               ttft_deadline_s: Optional[float] = None,
               trace_id: Optional[int] = None) -> int:
        """Enqueue a request; returns its rid. ``lane`` and
        ``ttft_deadline_s`` feed the SLO scheduler. ``trace_id`` adopts
        an externally minted trace id (the fleet router's) for the
        request's root span instead of starting a fresh trace, and is
        carried through ``request_stats`` and ``snapshot_slot`` even with
        tracing off. Raises
        :class:`~paddle_tpu_torch.serving.scheduler.LoadShedError` (with
        a structured ``Reject``) when the scheduler sheds the request,
        and ``ValueError`` on a decode-tier engine, which takes only
        restored slots."""
        if self.tier == "decode":
            raise ValueError(
                "decode-tier engines accept only restored slots "
                "(restore_slot), not fresh prompts")
        total = len(np.asarray(prompt).reshape(-1)) + max_new_tokens
        limit = min(self.cache.config.max_tokens_per_slot,
                    self.model.cfg.max_position)
        if total > limit:
            raise ValueError(f"request needs {total} tokens > per-slot "
                             f"limit {limit}")
        if self.cache.config.pages_for(total) > self.cache.config.num_pages - 1:
            raise ValueError("request exceeds the whole page pool")
        try:
            rid = self.scheduler.submit(prompt, max_new_tokens, eos_id,
                                        lane=lane,
                                        ttft_deadline_s=ttft_deadline_s)
        except LoadShedError as e:
            self._reg.counter("serving_rejected_total",
                              "requests load-shed instead of queued").inc(
                                  reason=e.reject.reason)
            if self.tracer.enabled:
                # shed at submit: a zero-length request span whose
                # attributes carry the structured verdict
                self.tracer.record_span(
                    "serving.request", duration_s=0.0, status="shed",
                    lane=lane, shed_reason=e.reject.reason,
                    queue_depth=e.reject.queue_depth,
                    est_ttft_s=round(e.reject.est_ttft_s, 6))
            raise
        self._reg.counter("serving_requests_total",
                          "requests submitted to the engine").inc()
        self._reg.counter("serving_prompt_tokens_total",
                          "prompt tokens submitted").inc(total -
                                                         max_new_tokens)
        self._phase_acc[rid] = {"prefill_s": 0.0, "decode_s": 0.0,
                                "prefill_chunks": 0.0,
                                "decode_blocks": 0.0,
                                "shared_tokens": 0.0,
                                "spec_proposed": 0.0,
                                "spec_accepted": 0.0}
        if trace_id is not None:
            self._ext_trace[rid] = int(trace_id)
        if self.tracer.enabled:
            root = self.tracer.start_span(
                "serving.request", trace_id=trace_id, rid=rid, lane=lane,
                prompt_tokens=total - max_new_tokens,
                max_new_tokens=max_new_tokens)
            root.add_event("submitted",
                           queue_depth=self.scheduler.queue_depth())
            self._req_spans[rid] = root
        self._refresh_health()
        return rid

    def _sched_event(self, rid: int, name: str, **attrs):
        """Scheduler decision -> event on the request's trace span."""
        root = self._req_spans.get(rid)
        if root is not None:
            root.add_event(name, **attrs)

    def result(self, rid: int) -> Optional[np.ndarray]:
        """Generated tokens for a finished request (None while running
        or already consumed); pop-on-read, bounded."""
        return self._results.pop(rid, None)

    def reject_reason(self, rid: int) -> Optional[Reject]:
        """Structured reject for a request shed AFTER queueing (its TTFT
        deadline expired before admission); pop-on-read."""
        return self._rejects.pop(rid, None)

    def request_stats(self, rid: int) -> Optional[Dict[str, float]]:
        """Per-request latency record of a finished request: the wall
        split (``ttft_s``, ``queue_wait_s``, ``prefill_s``), the time
        inside the device calls (``prefill_compute_s``, ``decode_s``),
        ``prefill_chunks`` / ``decode_blocks``, ``shared_tokens``,
        ``spec_proposed`` / ``spec_accepted``, ``tokens``, the handoff
        stamps ``prefill_done_s`` / ``handoff_s`` / ``decode_start_s``
        (monotonic; 0.0 on a request that crossed no tier) and
        ``trace_id`` (0 with tracing off and none adopted); pop-on-read,
        bounded."""
        return self._stats.pop(rid, None)

    # -- tensor parallelism: rank 0 leads --------------------------------

    def _feeds_flat(self, sig, feeds) -> np.ndarray:
        """A call's int32 host inputs in its bucket's layout order (the
        payload a follower splits back)."""
        layout, _ = self._bucket_spec(sig)
        parts = []
        for ent in layout:
            if len(ent) != 2:
                continue
            name, shape = ent
            a = feeds.get(name)
            parts.append(np.zeros(int(np.prod(shape)), np.int32) if a is None
                         else np.asarray(a, np.int32).reshape(-1))
        return np.concatenate(parts) if parts else np.zeros(0, np.int32)

    def _feeds_of(self, sig, flat: np.ndarray) -> Dict[str, np.ndarray]:
        layout, _ = self._bucket_spec(sig)
        out, at = {}, 0
        for ent in layout:
            if len(ent) != 2:
                continue
            name, shape = ent
            k = int(np.prod(shape))
            out[name] = flat[at:at + k].reshape(shape)
            at += k
        return out

    def _tp_guard(self, fn, *args):
        """Run a device call of a tp engine's rank 0: when it fails and a
        follower left its traceback in the store, re-raise that as a
        :class:`~paddle_tpu_torch.serving.tp.TpFollowerError`. A follower
        makes no call of its own: rank 0's come to it in :meth:`follow`."""
        if not self._lead:
            raise RuntimeError("a follower rank of a tp engine makes the "
                               "calls rank 0 broadcasts (follow()); serve "
                               "through rank 0's engine")
        try:
            return fn(*args)
        except Exception as e:
            text = self._link.follower_error()
            if text is not None:
                raise tp_lib.TpFollowerError(
                    f"a follower rank failed:\n{text}") from e
            raise

    def _call(self, sig, feeds, device_feeds=None):
        """One device call of ``sig`` (:meth:`StepGraphs.run`); rank 0 of
        a tp engine first broadcasts it to the followers."""
        if self._link is None:
            return self.graphs.run(sig, feeds, device_feeds)

        def run():
            self._link.send_run(sig, self._feeds_flat(sig, feeds))
            return self.graphs.run(sig, feeds, device_feeds)
        return self._tp_guard(run)

    def _build(self, sig):
        if self._link is None or sig[0] == "decode_probe":
            return self.graphs.build(sig)

        def build():
            self._link.send_build(sig)
            return self.graphs.build(sig)
        return self._tp_guard(build)

    def follow(self):
        """Serve as a follower rank (1 to tp-1) of a tp engine: make every
        device call rank 0 broadcasts, on this rank's heads, until rank
        0's :meth:`close`. A failure here leaves the traceback for rank 0
        (whose pending collective fails when this process exits, or at the
        group's timeout, and re-raises it) and re-raises."""
        if self._link is None or self._lead:
            raise RuntimeError("follow() runs on ranks 1..tp-1 of a "
                               "tensor-parallel engine")
        link = self._link
        try:
            while True:
                op, sig, payload = link.recv()
                if op == tp_lib.OP_STOP:
                    return
                if op == tp_lib.OP_BUILD:
                    self.graphs.build(sig)
                elif op == tp_lib.OP_RUN:
                    self.graphs.run(sig, self._feeds_of(sig, payload))
                elif op == tp_lib.OP_READ:
                    link.give_pages(self._read_pages_local(payload))
                elif op == tp_lib.OP_WRITE:
                    like = [self._page_like()] * len(payload)
                    self._write_pages_local(zip(
                        payload.tolist(), link.take_pages(like)))
                else:
                    raise RuntimeError(f"unknown tp operation {op}")
        except BaseException:
            link.report(traceback.format_exc())
            raise

    def close(self):
        """Rank 0 of a tp engine: stop the followers' :meth:`follow`
        loops (once). A no-op on other engines."""
        if self._link is not None and self._lead:
            self._link.send_stop()

    def _page_like(self) -> tuple:
        """Empty host arrays shaped as this rank's slice of one page (K/V
        bits, and the scale rows of an int8 pool)."""
        c = self.cache.config
        shape = (2, c.num_layers, c.page_size, self.cache.local_heads,
                 c.head_dim)
        kv = np.empty(shape, _HOST_DTYPES[c.dtype])
        return (kv, np.empty(shape[:3], np.float32)) if self.quantized \
            else (kv,)

    def _refresh_health(self):
        """Recompute the health snapshot from the live scheduler and
        cache books; called from the engine's own thread at consistent
        points (construction, submit, end of step)."""
        h: Dict[str, object] = {
            "slot_occupancy": self.scheduler.occupancy(),
            "queue_depth": self.scheduler.queue_depth(),
            "page_utilization": self.cache.utilization(),
            "free_slots": len(self.scheduler.free_slots()),
            "recompiles": self.recompile_detector.recompiles,
            "requests_in_flight": len(self.scheduler.active_slots()),
            "steps": int(self._reg.counter(
                "serving_steps_total").value()),
            # the mesh shape: a tp replica counts tp chips
            "tp": self.tp,
            "mesh_devices": self.tp if self.tp_spmd else 1,
            "tp_probe": self.tp_probe,
            "tier": self.tier,
            "prefix_gen": int(self.cache.prefix_gen),
        }
        if self.slo_monitor is not None:
            h["slo"] = self.slo_monitor.status()
        h["headroom"] = self._headroom()
        with self._health_lock:
            self._health_snap = h

    def _headroom(self) -> Dict[str, float]:
        """Spare capacity per resource in [0, 1], published as
        ``serving_headroom`` gauges. Flops utilization is the priced
        flops retired per busy second against the best per-call rate
        seen (0.0 until ``warmup(cost_gauges=True)`` priced the buckets
        and a step ran); spill is 1.0 without a host spill tier, else
        the host pool's spare share."""
        util = self.cache.utilization()
        flops_util = 0.0
        if self._busy_s > 0 and self._flops_rate_peak > 0:
            flops_util = min((self._flops_done / self._busy_s)
                             / self._flops_rate_peak, 1.0)
        free = len(self.scheduler.free_slots())
        cap_b = self.cache.capacity_bytes()
        live_b = self.cache.live_bytes()
        tokens = self._reg.counter("serving_tokens_total").value()
        saved = self._reg.counter(
            "serving_prefix_shared_tokens_total").value()
        head = {
            "flops_utilization": round(flops_util, 6),
            "flops": round(1.0 - flops_util, 6),
            "pages": round(max(1.0 - util, 0.0), 6),
            "slots": round(free / self.scheduler.num_slots, 6),
            "hbm": round(max(1.0 - (live_b / cap_b if cap_b else 0.0),
                             0.0), 6),
            "hbm_live_bytes": int(live_b),
            "hbm_capacity_bytes": int(cap_b),
            "flops_per_busy_s": (self._flops_done / self._busy_s
                                 if self._busy_s > 0 else 0.0),
            "prefix_saved_per_token": round(
                saved / tokens if tokens else 0.0, 6),
        }
        pool = self.cache.spill_pool
        if pool is None:
            head.update(spill=1.0, spill_pages=0, spill_bytes=0)
        else:
            head.update(spill=round(max(1.0 - len(pool) / pool.capacity,
                                        0.0), 6),
                        spill_pages=len(pool),
                        spill_bytes=int(pool.spilled_bytes()))
        g = self._reg.gauge(
            "serving_headroom",
            "spare capacity per resource (1 = idle, 0 = saturated)")
        for res in ("flops", "pages", "slots", "hbm", "spill"):
            g.set(head[res], resource=res)
        self._reg.gauge(
            "serving_spill_pages",
            "published KV pages resident in the host spill pool"
        ).set(head["spill_pages"])
        self._reg.gauge(
            "serving_spill_bytes",
            "bytes of KV (incl. int8 scale rows) in the host spill pool"
        ).set(head["spill_bytes"])
        self._reg.gauge(
            "serving_flops_utilization",
            "retired priced flops per busy second / best observed rate"
        ).set(flops_util)
        self._reg.gauge(
            "serving_prefix_saved_per_token",
            "prefill tokens skipped via prefix sharing per served token"
        ).set(head["prefix_saved_per_token"])
        return head

    def _note_busy(self, sigs, dur: float):
        """Headroom accounting for one device call: busy seconds plus
        the priced flops of the bucket(s) it retired."""
        self._busy_s += dur
        flops = sum(self.bucket_costs[sig].total_flops for sig in sigs
                    if sig in self.bucket_costs)
        if flops > 0:
            self._flops_done += flops
            if dur > 0:
                self._flops_rate_peak = max(self._flops_rate_peak,
                                            flops / dur)

    def health(self) -> Dict[str, object]:
        """Structured live health (the ``/healthz`` payload): slot
        occupancy, queue depth, page utilization, free slots, recompile
        count (graph captures after warmup), headroom, and the SLO
        monitor's state when one is configured. Safe to call from any
        thread while ``step()`` runs: it returns the last published
        snapshot."""
        with self._health_lock:
            return dict(self._health_snap)

    def start_exposition(self, port: int = 0, host: str = "127.0.0.1"):
        """Start a background
        :class:`~paddle_tpu_torch.observability.ExpositionServer` over
        the engine's registry and tracer, with the engine as the
        ``serving`` health provider and its flight recorder's bundles
        under ``/debug/postmortem``. Port 0 binds an ephemeral port
        (``server.port``); the caller stops it."""
        srv = obs.ExpositionServer(registry=self._reg, tracer=self.tracer,
                                   port=port, host=host)
        srv.add_health("serving", self.health)
        srv.add_postmortem("serving", self.flight.bundles)
        return srv.start()

    # -- engine loop ------------------------------------------------------

    def step(self) -> Dict[int, np.ndarray]:
        """One engine iteration: shed expired-deadline queue entries,
        admit into free slots, advance every admitted request's prefill
        under the interleaving budget, advance every decoding slot one
        block, evict finished sequences. Returns ``{rid: generated
        tokens}`` for requests that finished now."""
        finished: Dict[int, np.ndarray] = {}
        self._anat_steps += 1
        self.anatomy.begin_step(self._anat_steps)
        step_tokens = 0
        if isinstance(self.scheduler, SLOScheduler):
            for req in self.scheduler.shed_expired():
                rej = Reject("deadline_expired", req.lane,
                             self.scheduler.queue_depth(),
                             self.scheduler.est_ttft_s(), 0.001)
                self._rejects[req.rid] = rej
                while len(self._rejects) > self._results_cap:
                    self._rejects.popitem(last=False)
                self._reg.counter("serving_rejected_total",
                                  "requests load-shed instead of queued"
                                  ).inc(reason=rej.reason)
                self._phase_acc.pop(req.rid, None)
                self._ext_trace.pop(req.rid, None)
                root = self._req_spans.pop(req.rid, None)
                if root is not None:
                    root.add_event("shed", reason=rej.reason,
                                   deadline_s=req.ttft_deadline_s)
                    root.finish(status="shed")
        budget = self.prefill_budget
        prefilled_any = False
        while True:  # admissions can cascade as early-EOS slots free up
            # pages are reserved inside the admit callback, so each
            # can_admit check sees the pool net of earlier admissions
            admitted = self.scheduler.admit(on_admit=self._on_admit)
            done = self._prefill_round(budget,
                                       allow_liveness=not prefilled_any)
            prefilled_any = prefilled_any or done > 0
            budget -= done
            finished.update(self._evict())
            if (not admitted and done == 0) or budget <= 0:
                break

        dslots = self.scheduler.decode_slots()
        if self.tier == "prefill":
            # prefill-done slots park for poll_handoffs; only handoff-
            # fallback slots flagged decode-in-place decode here
            dslots = [i for i in dslots if i in self._decode_in_place]
        if dslots:
            self._reg.gauge("serving_slot_occupancy",
                            "fraction of decode slots live").set(
                                len(dslots) / self.scheduler.num_slots)
            self._reg.gauge("serving_page_utilization",
                            "live tokens / page-pool capacity").set(
                                self.cache.utilization())
            if self.speculative:
                kept = self._speculative_round(dslots)
            else:
                kept = self._decode_round(dslots)
            step_tokens += kept
            self._reg.counter("serving_tokens_total",
                              "decode tokens produced").inc(kept)
            self._reg.counter("serving_steps_total").inc()
            self.recompile_detector.check()
            finished.update(self._evict())
            if self.snapshot_every_blocks is not None:
                self._take_micro_snapshots()

        if self.slo_monitor is not None:
            self.slo_monitor.check()
        if prefilled_any or dslots:
            self.anatomy.end_step(tokens=step_tokens)
        else:
            # an idle tick is not a serving step: recording it would
            # count queue-empty waiting as host gap
            self.anatomy.cancel_step()
        self._refresh_health()
        with self._health_lock:
            snap = self._health_snap
        self.flight.note(snap)
        return finished

    def _decode_round(self, dslots) -> int:
        """Advance every decoding slot one block of ``decode_block``
        tokens through the decode step; returns tokens kept."""
        n = self.decode_block
        s_tot = self.scheduler.num_slots
        tokens = np.zeros((s_tot,), np.int32)
        active = np.zeros((s_tot,), np.int32)
        for i in dslots:
            tokens[i] = self.scheduler.slots[i].generated[-1]
            active[i] = 1
        w = self._pow2_width(max(
            self.cache.config.pages_for(
                int(self.cache.lengths[i]) + n) for i in dslots))
        feeds = dict(block_tables=self.cache.block_tables[:, :w],
                     lengths=self.cache.lengths, tokens=tokens,
                     active=active)
        t0 = time.monotonic()
        out = self._call(("decode", w), feeds)
        out = out.cpu().numpy()                   # (S, decode_block)
        t1 = time.monotonic()
        self._reg.histogram(
            "serving_decode_step_seconds",
            "wall time per decode block (sync included)").observe(t1 - t0)
        self.anatomy.add_phase("decode", t0, t1)
        self._note_busy((("decode", w),), t1 - t0)
        self._decode_rounds += 1
        if self._probe_cache is not None and \
                self._decode_rounds % self.anatomy_probe_every == 0:
            # collective-exposed sample: the same decode shapes through
            # the collectives-elided twin (a warmed ("decode_probe", w)
            # bucket: sampling builds nothing after warmup)
            p0 = time.monotonic()
            self.graphs.run(("decode_probe", w), feeds).cpu()
            p1 = time.monotonic()
            self.anatomy.set_collective(t1 - t0, p1 - p0)
        tr_on = self.tracer.enabled
        kept = 0
        for i in dslots:
            st = self.scheduler.slots[i]
            req = st.request
            budget_i = req.max_new_tokens - len(st.generated)
            kept_i = 0
            for j in range(min(n, budget_i)):
                tok = int(out[i, j])
                st.generated.append(tok)
                kept_i += 1
                if req.eos_id is not None and tok == req.eos_id:
                    break
            kept += kept_i
            if not st.finished():
                # the device advanced this slot the full block
                self.cache.lengths[i] += n
            acc = self._phase_acc.get(req.rid)
            if acc is not None:
                acc["decode_s"] += t1 - t0
                acc["decode_blocks"] += 1
            if tr_on:
                # lanes run in the same batched call, so the spans share
                # the interval: a parallel track per request
                self.tracer.record_span(
                    "serving.decode_block", start=t0, end=t1,
                    parent=self._req_spans.get(req.rid),
                    slot=i, tokens=kept_i)
        return kept

    def _speculative_round(self, dslots) -> int:
        """One speculative round: the draft proposes ``spec_k`` greedy
        tokens per slot on its own cache, the target verifies the chunk
        ``[pending, d_1 .. d_{k-1}]`` in one batched-prefill call (greedy
        token after every position), and each slot accepts the longest
        draft prefix the target reproduced plus the target's own next
        token, so every kept token is what non-speculative greedy
        decoding gives, 1..spec_k per round. The chunk is assembled on
        the device from the draft's output: no host copy between draft
        and verify. Rollback is a cursor rewind: both caches advance by
        the accepted inputs only; rejected K/V stay behind the slot
        length (masked, overwritten next round) inside the slot's
        reservation. Returns tokens kept."""
        n = self.spec_k
        s_tot = self.scheduler.num_slots
        tokens = np.zeros((s_tot,), np.int32)
        active = np.zeros((s_tot,), np.int32)
        nv = np.zeros((s_tot,), np.int32)
        for i in dslots:
            st = self.scheduler.slots[i]
            tokens[i] = st.generated[-1]
            active[i] = 1
            # never write past the slot's reservation: the chunk is
            # capped at the remaining generation budget
            nv[i] = min(n, st.request.max_new_tokens - len(st.generated))
        w = self._pow2_width(max(
            self.cache.config.pages_for(
                int(self.cache.lengths[i]) + n) for i in dslots))
        t0 = time.monotonic()
        props_dev = self.graphs.run(("draft", w), dict(
            block_tables=self.draft_cache.block_tables[:, :w],
            lengths=self.draft_cache.lengths, tokens=tokens,
            active=active, n_valid=nv))                     # (S, spec_k)
        ver = self.graphs.run(("verify", w), dict(
            block_tables=self.cache.block_tables[:, :w],
            lengths=self.cache.lengths, tokens=tokens, n_valid=nv),
            {"props": props_dev})                          # (S, spec_k)
        props = props_dev.cpu().numpy()
        # the proposals arrive when the draft call has finished: the
        # clock read between the two copies splits the round
        t_mid = time.monotonic()
        ver = ver.cpu().numpy()
        t1 = time.monotonic()
        self._reg.histogram(
            "serving_decode_step_seconds",
            "wall time per decode block (sync included)").observe(t1 - t0)
        self.anatomy.add_phase("draft", t0, t_mid)
        self.anatomy.add_phase("verify", t_mid, t1)
        self._note_busy((("draft", w), ("verify", w)), t1 - t0)
        tr_on = self.tracer.enabled
        kept = 0
        for i in dslots:
            st = self.scheduler.slots[i]
            req = st.request
            c = int(nv[i])
            # accept t_1, plus t_{j+1} for every draft token d_j the
            # target reproduced: the greedy accept-prefix
            a = 1
            while a < c and props[i, a - 1] == ver[i, a - 1]:
                a += 1
            kept_i = 0
            for j in range(a):
                tok = int(ver[i, j])
                st.generated.append(tok)
                kept_i += 1
                if req.eos_id is not None and tok == req.eos_id:
                    break
            kept += kept_i
            if not st.finished():
                # commit exactly the accepted inputs on both caches
                self.cache.lengths[i] += a
                self.draft_cache.lengths[i] += a
            proposed, accepted = max(c - 1, 0), a - 1
            self._reg.counter(
                "serving_spec_proposed_total",
                "draft tokens proposed for verification").inc(proposed)
            self._reg.counter(
                "serving_spec_accepted_total",
                "draft tokens the target verified and kept").inc(accepted)
            if proposed:
                self._reg.histogram(
                    "serving_spec_accept_rate",
                    "accepted/proposed draft tokens per verify round",
                    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                             0.875, 1.0)).observe(accepted / proposed)
            acc = self._phase_acc.get(req.rid)
            if acc is not None:
                acc["decode_s"] += t1 - t0
                acc["decode_blocks"] += 1
                acc["spec_proposed"] += proposed
                acc["spec_accepted"] += accepted
            if tr_on:
                self.tracer.record_span(
                    "serving.verify_block", start=t0, end=t1,
                    parent=self._req_spans.get(req.rid), slot=i,
                    tokens=kept_i, proposed=proposed, accepted=accepted)
        return kept

    def generate_many(self, prompts: Sequence, max_new_tokens: int = 32,
                      eos_id: Optional[int] = None,
                      max_steps: Optional[int] = None) -> List[np.ndarray]:
        """Submit ``prompts`` and run the loop until all finish; returns
        each request's generated tokens in submission order."""
        rids = [self.submit(p, max_new_tokens, eos_id) for p in prompts]
        collected: Dict[int, np.ndarray] = {}
        steps = 0
        while not self.scheduler.idle():
            collected.update(self.step())
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(f"no convergence in {max_steps} steps")
        for r in rids:          # consumed here; drop from the store
            self._results.pop(r, None)
        return [collected[r] for r in rids]

    def _evict(self) -> Dict[int, np.ndarray]:
        out = {}
        for slot, st in self.scheduler.evict_finished().items():
            self.cache.free_slot(slot)
            self._decode_in_place.discard(slot)
            if self.speculative:
                self.draft_cache.free_slot(slot)
            toks = np.asarray(st.generated, np.int32)
            req = st.request
            self._results[req.rid] = toks
            acc = self._phase_acc.pop(req.rid, None) or {}
            root = self._req_spans.pop(req.rid, None)
            # the wall split from the lifecycle stamps, and the compute
            # split whose numbers are the request's trace spans
            self._stats[req.rid] = {
                "ttft_s": st.first_token_at - req.submitted_at,
                "queue_wait_s": st.admitted_at - req.submitted_at,
                "prefill_s": st.first_token_at - st.admitted_at,
                "prefill_compute_s": acc.get("prefill_s", 0.0),
                "decode_s": acc.get("decode_s", 0.0),
                "prefill_chunks": acc.get("prefill_chunks", 0.0),
                "decode_blocks": acc.get("decode_blocks", 0.0),
                "shared_tokens": acc.get("shared_tokens", 0.0),
                "spec_proposed": acc.get("spec_proposed", 0.0),
                "spec_accepted": acc.get("spec_accepted", 0.0),
                "tokens": float(len(st.generated)),
                "prefill_done_s": acc.get("prefill_done_s", 0.0),
                "handoff_s": acc.get("handoff_s", 0.0),
                "decode_start_s": acc.get("decode_start_s", 0.0),
                "trace_id": float(root.trace_id) if root is not None
                else float(self._ext_trace.get(req.rid, 0)),
            }
            self._ext_trace.pop(req.rid, None)
            self._micro_snaps.pop(req.rid, None)
            self._last_snap_blocks.pop(req.rid, None)
            if root is not None:
                root.add_event("finished", tokens=len(st.generated))
                root.set_attrs(
                    tokens=len(st.generated),
                    shared_tokens=int(acc.get("shared_tokens", 0)))
                root.finish()
            out[req.rid] = toks
        while len(self._results) > self._results_cap:
            self._results.popitem(last=False)   # oldest unconsumed
        while len(self._stats) > self._results_cap:
            self._stats.popitem(last=False)
        return out

    # -- prefill ----------------------------------------------------------

    def _on_admit(self, slot: int, req):
        """Admission callback: restore host-spilled pages of the prompt's
        chain, reserve pages (mapping any published shared prefix), seed
        the slot's prefill cursor past the shared tokens, and record the
        queue-wait half of the TTFT split."""
        self._restore_spilled(req.prompt, req.rid)
        shared = self.cache.reserve(slot, req.total_tokens,
                                    prompt=req.prompt)
        if self.speculative:
            # lockstep: same geometry and alloc/free history as the
            # target cache (sharing off), so this cannot overflow when the
            # target reserve succeeded
            self.draft_cache.reserve(slot, req.total_tokens)
        st = self.scheduler.slots[slot]
        st.prefilled = shared
        if shared:
            self._reg.counter(
                "serving_prefix_shared_tokens_total",
                "prompt tokens skipped via shared prefix pages").inc(shared)
        self._reg.histogram(
            "serving_queue_wait_seconds", "submit -> slot admission wait",
            buckets=_LATENCY_BUCKETS).observe(
                max(st.admitted_at - req.submitted_at, 0.0))
        acc = self._phase_acc.get(req.rid)
        if acc is not None:
            acc["shared_tokens"] = float(shared)
        root = self._req_spans.get(req.rid)
        if root is not None:
            root.add_event("admitted", slot=slot, queue_wait_s=round(
                max(st.admitted_at - req.submitted_at, 0.0), 6))
            if shared:
                root.add_event("prefix_shared", tokens=shared)

    def _prefill_round(self, budget: int,
                       allow_liveness: bool = True) -> int:
        """Advance in-prefill slots' next prompt chunks through the
        batched prefill step, spending at most ``budget`` prompt tokens.
        Returns tokens computed. Slots whose prompt completes get their
        first generated token from the same call. Each call computes up
        to ``lanes x prefill_chunk`` tokens, so the lane count is capped
        by the budget left; the ``allow_liveness`` single lane (once per
        ``step()``) keeps an admitted slot progressing even with
        ``prefill_budget < prefill_chunk``."""
        consumed = 0
        c = self.prefill_chunk
        cfgc = self.cache.config
        while budget - consumed > 0:
            pslots = [i for i in self.scheduler.active_slots()
                      if not self.scheduler.slots[i].prefill_done]
            if not pslots:
                break
            lane_cap = (budget - consumed) // c
            if lane_cap == 0:
                if consumed > 0 or not allow_liveness:
                    break
                lane_cap = 1    # the once-per-step liveness lane
            # when lanes must wait, run the slots closest to their first
            # token: that closes TTFTs soonest
            if len(pslots) > lane_cap:
                pslots.sort(key=lambda i: int(
                    self.scheduler.slots[i].request.prompt.shape[0])
                    - self.scheduler.slots[i].prefilled)
                pslots = pslots[:lane_cap]
            # compact batch, pow2-bucketed over the slots actually
            # prefilling; padding lanes are inert (n_valid 0, null page)
            sb = self._pow2_count(len(pslots))
            tokens = np.zeros((sb, c), np.int32)
            starts = np.zeros((sb,), np.int32)
            nv = np.zeros((sb,), np.int32)
            bt_rows = np.zeros((sb, cfgc.max_pages_per_slot), np.int32)
            dbt_rows = np.zeros_like(bt_rows)
            for j, i in enumerate(pslots):
                st = self.scheduler.slots[i]
                pc = self.cache.pending_copy(i)
                if pc is not None:
                    # copy-on-write of a borrowed tail page, owed before
                    # this slot's first write lands in it
                    self._call(("copy_page",),
                               {"src": pc[0], "dst": pc[1]})
                    self.cache.copy_done(i)
                    self._reg.counter(
                        "serving_prefix_cow_total",
                        "copy-on-write page copies for shared tails").inc()
                    root = self._req_spans.get(st.request.rid)
                    if root is not None:
                        root.add_event("cow_copy", src_page=int(pc[0]),
                                       dst_page=int(pc[1]))
                prompt = st.request.prompt
                lo = st.prefilled
                # borrower write isolation: the page this chunk starts
                # writing into must be slot-owned
                assert self.cache.writable(i, lo // cfgc.page_size), \
                    f"slot {i} would write a borrowed page"
                n = min(c, int(prompt.shape[0]) - lo)
                tokens[j, :n] = prompt[lo:lo + n]
                starts[j] = lo
                nv[j] = n
                bt_rows[j] = self.cache.block_tables[i]
                if self.speculative:
                    dbt_rows[j] = self.draft_cache.block_tables[i]
            w = self._pow2_width(max(
                cfgc.pages_for(int(starts[j]) + int(nv[j]))
                for j in range(len(pslots))))
            t0 = time.monotonic()
            nxt = self._call(("prefill", w, sb), dict(
                block_tables=bt_rows[:, :w], starts=starts, tokens=tokens,
                n_valid=nv))
            if self.speculative:
                # the draft ingests the same chunks so its cache mirrors
                # the target's committed prefix (its output is unused)
                self.graphs.run(("draft_prefill", w, sb), dict(
                    block_tables=dbt_rows[:, :w], starts=starts,
                    tokens=tokens, n_valid=nv))
            nxt = nxt.cpu().numpy()
            now = time.monotonic()
            self._reg.histogram(
                "serving_prefill_step_seconds",
                "wall time per batched prefill call (sync included)"
            ).observe(now - t0)
            self.anatomy.add_phase("prefill", t0, now)
            self._note_busy((("prefill", w, sb),)
                            + ((("draft_prefill", w, sb),)
                               if self.speculative else ()), now - t0)
            call_tokens = 0
            tr_on = self.tracer.enabled
            for j, i in enumerate(pslots):
                st = self.scheduler.slots[i]
                rid = st.request.rid
                n = int(nv[j])
                st.prefilled += n
                self.cache.lengths[i] += n
                if self.speculative:
                    self.draft_cache.lengths[i] += n
                call_tokens += n
                self.cache.publish_prefix(i, st.request.prompt,
                                          st.prefilled)
                acc = self._phase_acc.get(rid)
                if acc is not None:
                    acc["prefill_s"] += now - t0
                    acc["prefill_chunks"] += 1
                if tr_on:
                    self.tracer.record_span(
                        "serving.prefill_chunk", start=t0, end=now,
                        parent=self._req_spans.get(rid), slot=i,
                        tokens=n, start_pos=st.prefilled - n)
                if st.prefill_done:
                    st.generated.append(int(nxt[j]))
                    st.first_token_at = now
                    if acc is not None:
                        acc["prefill_done_s"] = now
                    ttft = now - st.request.submitted_at
                    self._reg.histogram(
                        "serving_ttft_seconds",
                        "submit -> first token latency",
                        buckets=_LATENCY_BUCKETS).observe(ttft)
                    self._reg.histogram(
                        "serving_admit_to_first_token_seconds",
                        "admit -> first token (prefill cost, net of "
                        "queue wait)",
                        buckets=_LATENCY_BUCKETS).observe(
                            now - st.admitted_at)
                    self._reg.counter("serving_tokens_total").inc()
                    self.scheduler.note_ttft(ttft)
                    root = self._req_spans.get(rid)
                    if root is not None:
                        root.add_event("first_token",
                                       ttft_s=round(ttft, 6))
            consumed += call_tokens
            self._reg.counter(
                "serving_prefill_tokens_total",
                "prompt tokens actually computed by prefill (shared "
                "prefix tokens are skipped)").inc(call_tokens)
        return consumed

    def _pow2_width(self, need: int) -> int:
        """Pow2 page count covering ``need`` pages, capped at the slot
        capacity: attention work follows the LIVE high-water mark."""
        w = 1
        while w < need:
            w *= 2
        return min(w, self.cache.config.max_pages_per_slot)

    def _pow2_count(self, need: int) -> int:
        """Pow2 lane count for the compact prefill batch."""
        s = 1
        while s < need:
            s *= 2
        return min(s, self.scheduler.num_slots)

    def warmup_plan(self):
        """The signatures :meth:`warmup` builds, in build order:
        ``("decode", width)``, ``("prefill", width, lanes)`` and
        ``("copy_page",)``, then the page IO ``("page_read",)`` and
        ``("page_write",)`` (a page id is a device scalar: one signature
        each covers every page); a speculative engine swaps the decode
        buckets for ``("draft", width)`` and ``("verify", width)`` and
        adds the draft's ``("draft_prefill", width, lanes)`` twins; a tp
        engine that samples its collectives adds ``("decode_probe",
        width)`` after each decode bucket (built on rank 0 only).
        Derived from the warmup-side doubling loops and filtered by tier
        (:meth:`_tier_sig`); it covers :meth:`reachable_signatures`,
        which makes zero captures after warmup a property of the plan."""
        c = self.cache.config
        s_tot = self.scheduler.num_slots
        widths, w = [], 1
        while w < c.max_pages_per_slot:
            widths.append(w)
            w *= 2
        widths.append(c.max_pages_per_slot)
        widths = sorted(set(widths))
        counts, s = [], 1
        while s < s_tot:
            counts.append(s)
            s *= 2
        counts.append(s_tot)
        counts = sorted(set(counts))
        plan = []
        for w in widths:
            if self.speculative:
                plan.append(("draft", w))
                plan.append(("verify", w))
            else:
                plan.append(("decode", w))
                if self.anatomy_probe_every:
                    # the collective probe's twin samples the same width
                    # buckets: warmed, sampling builds nothing later
                    plan.append(("decode_probe", w))
            for sb in counts:
                plan.append(("prefill", w, sb))
                if self.speculative:
                    plan.append(("draft_prefill", w, sb))
        plan.append(("copy_page",))
        plan.append(("page_read",))
        plan.append(("page_write",))
        return [sig for sig in plan if self._tier_sig(sig)]

    def _tier_sig(self, sig) -> bool:
        """Tier filter over signatures: a prefill engine builds no decode
        bucket, a decode engine no prefill bucket. Page IO and the CoW
        copy stay on both: a handoff reads pages on the prefill side and
        writes them on the decode side."""
        if self.tier == "prefill" and sig[0] in ("decode", "decode_probe"):
            return False
        if self.tier == "decode" and sig[0] == "prefill":
            return False
        return True

    def reachable_signatures(self):
        """Every signature the steady-state ``step()`` loop can request,
        enumerated from the step-side bucketing functions
        (``_pow2_width`` over every possible live page count,
        ``_pow2_count`` over every in-prefill slot count): the other
        half of the coverage proof. A speculative engine's decode phase
        requests draft and verify buckets instead of decode buckets,
        plus the draft-prefill twins."""
        c = self.cache.config
        widths = {self._pow2_width(n)
                  for n in range(1, c.max_pages_per_slot + 1)}
        counts = {self._pow2_count(n)
                  for n in range(1, self.scheduler.num_slots + 1)}
        if self.speculative:
            sigs = {("draft", w) for w in widths}
            sigs |= {("verify", w) for w in widths}
            sigs |= {("draft_prefill", w, sb)
                     for w in widths for sb in counts}
        else:
            sigs = {("decode", w) for w in widths}
            if self.anatomy_probe_every:
                sigs |= {("decode_probe", w) for w in widths}
        sigs |= {("prefill", w, sb) for w in widths for sb in counts}
        sigs |= {("copy_page",), ("page_read",), ("page_write",)}
        return {sig for sig in sigs if self._tier_sig(sig)}

    def warmup(self, cost_gauges: bool = True):
        """Build every signature of :meth:`warmup_plan` up front, each
        against the null page (no live state is touched): on the card
        one eager call and one CUDA graph capture per signature, so the
        kernel build, every capture and every first launch happen at
        start-up and steady-state serving captures nothing. Records the
        built set in :attr:`warmed_signatures`.

        ``cost_gauges`` also prices every signature (:func:`bucket_cost`)
        into :attr:`bucket_costs`, which the flops headroom reads, and
        publishes ``serving_bucket_cost_flops`` /
        ``serving_bucket_cost_peak_hbm_bytes`` gauges (labels: phase,
        width, lanes). On a tp engine rank 0 warms up (each build is
        broadcast to the followers); a follower refuses."""
        if not self._lead:
            raise RuntimeError("a follower rank builds what rank 0's "
                               "warmup() broadcasts (follow())")
        self.warmed_signatures = set()
        self.bucket_costs = {}
        for sig in self.warmup_plan():
            if cost_gauges:
                self._bucket_cost_gauges(sig)
            self._build(sig)
            self.warmed_signatures.add(sig)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _bucket_cost_gauges(self, sig):
        """Price one warmup signature into :attr:`bucket_costs` and its
        two gauges."""
        c = self.cache.config
        hbm = self.cache.capacity_bytes() + sum(
            t.numel() * t.element_size() for t in self.model.parameters())
        if self.speculative:
            hbm += self.draft_cache.capacity_bytes() + sum(
                t.numel() * t.element_size()
                for t in self.draft_model.parameters())
        cost = bucket_cost(
            sig, self.model.cfg,
            self.draft_model.cfg if self.speculative else None,
            num_slots=self.scheduler.num_slots, page_size=c.page_size,
            chunk=self.prefill_chunk, spec_k=self.spec_k, hbm_bytes=hbm)
        self.bucket_costs[sig] = cost
        labels = dict(phase=sig[0],
                      width=str(sig[1] if len(sig) > 1 else 0),
                      lanes=str(sig[2] if len(sig) > 2
                                else self.scheduler.num_slots))
        self._reg.gauge(
            "serving_bucket_cost_flops",
            "analytic flops per bucket signature").set(
                cost.total_flops, **labels)
        self._reg.gauge(
            "serving_bucket_cost_peak_hbm_bytes",
            "page pools' plus weights' bytes per bucket signature").set(
                cost.peak_hbm_bytes, **labels)

    # -- KV mobility: page IO, migration, handoff, spill, exchange --------

    def _staging(self, k: int, specs) -> tuple:
        """Pinned host buffers of ``specs`` (``(shape, dtype)`` of a
        page's K/V bits and scale rows), two sets per layout used in turn
        by ``k``, with the event of the copy that last used the set,
        waited on here before the set is reused."""
        key = (k % 2,) + tuple(specs)
        ent = self._ring.get(key)
        if ent is None:
            ent = self._ring[key] = (
                tuple(torch.empty(shape, dtype=dt, pin_memory=True)
                      for shape, dt in specs), torch.cuda.Event())
        ent[1].synchronize()
        return ent

    def _read_pages(self, pids) -> List[tuple]:
        """Host copies of pages ``pids`` (:meth:`_read_pages_local`); on a
        tp engine's rank 0, every rank's head slice gathered and joined
        into whole pages."""
        if self._link is None:
            return self._read_pages_local(pids)
        return self._tp_guard(self._link.read_pages, [int(p) for p in pids],
                              self._read_pages_local)

    def _write_pages(self, items):
        """Write ``(pid, payload)`` host pages (:meth:`_write_pages_local`);
        on a tp engine's rank 0, each rank gets its head slice of every
        page."""
        if self._link is None:
            return self._write_pages_local(items)
        items = list(items)
        pids = [int(pid) for pid, _ in items]

        def write():
            mine = self._link.write_pages(pids, [a for _, a in items],
                                          self.cache.local_heads)
            self._write_pages_local(zip(pids, mine))
        return self._tp_guard(write)

    def _read_pages_local(self, pids) -> List[tuple]:
        """Host copies of this rank's pages ``pids``: one
        ``("page_read",)`` call per page, its static output copied at
        once into a pinned staging buffer (stream order keeps the copy
        ahead of the next call's overwrite); while the card copies one
        page the host copies the previous one out of its buffer, after
        that copy's event. Returns per page ``(kv,)`` or ``(kv,
        scales)`` numpy arrays of their own."""
        out, prev = [], None
        for k, pid in enumerate(pids):
            res = self.graphs.run(("page_read",), {"src": int(pid)})
            dev = tuple(_bits(t) for t in
                        (res if isinstance(res, tuple) else (res,)))
            if self.device.type != "cuda":
                out.append(tuple(_host_array(t.clone()) for t in dev))
                continue
            bufs, ev = self._staging(
                k, tuple((tuple(t.shape), t.dtype) for t in dev))
            for b, t in zip(bufs, dev):
                b.copy_(t, non_blocking=True)
            ev.record()
            if prev is not None:
                prev[1].synchronize()
                out.append(tuple(_host_array(b).copy() for b in prev[0]))
            prev = (bufs, ev)
        if prev is not None:
            prev[1].synchronize()
            out.append(tuple(_host_array(b).copy() for b in prev[0]))
        return out

    def _write_pages_local(self, items):
        """Write ``(pid, payload)`` host pages of this rank (``(kv,)`` or
        ``(kv, scales)``, as :meth:`_read_pages_local` returns them)
        through one ``("page_write",)`` call each. On the card the host copies a page
        into a pinned staging buffer (after that buffer's last copy),
        from which it goes to the call's static input asynchronously, so
        the host prepares one page while the card writes the previous
        one. Bits move as they are: nothing converts values."""
        c = self.cache.config
        shape = (2, c.num_layers, c.page_size, self.cache.local_heads,
                 c.head_dim)
        bits = torch.int16 if c.dtype == torch.bfloat16 else c.dtype
        for k, (pid, arrays) in enumerate(items):
            if self.device.type == "cuda":
                specs = ((shape, bits), (shape[:3], torch.float32))
                bufs, ev = self._staging(k, specs[:len(arrays)])
                for b, a in zip(bufs, arrays):
                    _host_array(b)[...] = a
            else:
                bufs = tuple(_host_tensor(a) for a in arrays)
            feeds = dict(zip(("kv", "sc"), bufs))
            feeds["kv"] = feeds["kv"].view(c.dtype)
            self.graphs.run(("page_write",), {"dst": int(pid)}, feeds)
            if self.device.type == "cuda":
                ev.record()

    def _geometry(self) -> Dict[str, object]:
        c = self.cache.config
        return {"num_layers": c.num_layers, "num_heads": c.num_heads,
                "head_dim": c.head_dim, "page_size": c.page_size,
                "dtype": _dtype_name(c.dtype), "tp": self._tp_shards}

    @property
    def _tp_shards(self) -> int:
        """Transfer shards per page: one per tp rank of a tp engine."""
        return self.tp if self.tp_spmd else 1

    def _shards(self, payload) -> list:
        """A whole page's host arrays as its transfer shards, one per tp
        shard in mesh order: the K/V head slice, or ``(kv, scales)`` on
        an int8 pool (the scale rows whole in each)."""
        hl = self.cache.config.num_heads // self._tp_shards
        kv = payload[0]
        out = []
        for t in range(self._tp_shards):
            kv_t = kv[..., t * hl:(t + 1) * hl, :] if self._tp_shards > 1 \
                else kv
            out.append((kv_t, payload[1]) if self.quantized else kv_t)
        return out

    def _payload(self, shards) -> tuple:
        """The inverse of :meth:`_shards`: the page's K/V joined on the
        head axis in shard order (and the first shard's scale rows)."""
        parts = [tuple(sh) if self.quantized else (sh,) for sh in shards]
        kv = (np.concatenate([np.asarray(p[0]) for p in parts], axis=3)
              if len(parts) > 1 else parts[0][0])
        return (kv,) + parts[0][1:]

    def _shard_record(self, index: int, t: int, shard) -> Dict[str, object]:
        return {"index": index, "tp_shard": t,
                "sha256": self._shard_digest(shard),
                "bytes": self._shard_bytes(shard)}

    def _shard_digest(self, shard) -> str:
        """sha256 of one shard's raw bytes; an int8 shard hashes its K/V
        and its scale rows as one digest."""
        h = hashlib.sha256()
        for a in (shard if self.quantized else (shard,)):
            h.update(np.ascontiguousarray(a))     # the raw bytes, no copy
        return h.hexdigest()

    def _shard_bytes(self, shard) -> int:
        if self.quantized:
            return int(shard[0].nbytes + shard[1].nbytes)
        return int(shard.nbytes)

    def _check_shard(self, shard, what: str):
        """A shard's arrays must have this pool's page layout and host
        dtype (bf16 pages as uint16 bits): nothing converts values."""
        c = self.cache.config
        kv, sc = ((tuple(shard) if self.quantized else (shard,))
                  + (None,))[:2]
        want = (2, c.num_layers, c.page_size,
                c.num_heads // self._tp_shards, c.head_dim)
        kv = np.asarray(kv)
        if kv.shape != want or kv.dtype != _HOST_DTYPES[c.dtype]:
            raise SlotMigrationError(
                f"{what}: K/V {kv.dtype}{list(kv.shape)} != "
                f"{_HOST_DTYPES[c.dtype]}{list(want)}")
        if sc is not None:
            sc = np.asarray(sc)
            if sc.shape != want[:3] or sc.dtype != np.float32:
                raise SlotMigrationError(
                    f"{what}: scale rows {sc.dtype}{list(sc.shape)} != "
                    f"float32{list(want[:3])}")

    def _spill_read(self, pid: int):
        """The cache's spill reader: one page to host through the warmed
        ``("page_read",)`` signature (scale rows travel with an int8
        page)."""
        return self._read_pages([pid])[0]

    def _restore_spilled(self, prompt, rid: int) -> int:
        """Before reserving pages for ``prompt``, bring host-spilled pages
        of its published chain back to the card so ``reserve`` maps them
        as ordinary shared-prefix hits: each payload's sha256 is checked
        (a mismatch drops the page and stops the chain walk: a re-prefill,
        never a corrupt hit), every host-to-device copy starts, then each
        page is adopted and written through ``("page_write",)``. Returns
        pages restored."""
        pool = self.cache.spill_pool
        if pool is None:
            return 0
        entries = []
        for ent in self.cache.spill_restore_plan(prompt):
            if payload_digest(ent.payload) != ent.sha256:
                pool.pop(ent.key)
                self._reg.counter(
                    "serving_spill_corrupt_total",
                    "host-spilled pages refused on restore "
                    "(sha256 mismatch)").inc()
                break
            entries.append(ent)
        if not entries:
            return 0
        self._write_pages([(self.cache.adopt_published_page(e.key, e.tokens),
                            e.payload) for e in entries])
        nbytes = sum(e.nbytes for e in entries)
        pool.note_restored(len(entries), nbytes)
        self._reg.counter(
            "serving_spill_restored_pages_total",
            "host-spilled pages restored to the card on a prefix hit"
        ).inc(len(entries))
        self._reg.counter(
            "serving_spill_restored_bytes_total",
            "bytes restored from the host spill pool").inc(nbytes)
        root = self._req_spans.get(rid)
        if root is not None:
            root.add_event("spill_restored", pages=len(entries),
                           bytes=nbytes)
        return len(entries)

    def snapshot_slot(self, slot: int) -> Dict[str, object]:
        """Portable snapshot of one in-flight request: its request and
        slot bookkeeping plus its live KV pages, one sha256-digested shard
        per (page, tp shard) (an int8 shard carries the page's scale rows
        under the same hash). Mutates nothing: pair with :meth:`release_slot` to
        drain the slot. A pending copy-on-write tail reads through to its
        source page, so the snapshot carries the logical content."""
        if self.speculative:
            raise SlotMigrationError(
                "speculative engines do not migrate slots (the draft "
                "cache state is not carried in a snapshot)")
        st = self.scheduler.slots[slot]
        if st is None:
            raise SlotMigrationError(f"slot {slot} is empty")
        req = st.request
        cfgc = self.cache.config
        length = int(self.cache.lengths[slot])
        n_live = cfgc.pages_for(length) if length else 0
        pids = [int(p) for p in self.cache.block_tables[slot, :n_live]]
        pc = self.cache.pending_copy(slot)
        if pc is not None:
            src, dst = pc
            pids = [src if p == dst else p for p in pids]
        shards, manifest = [], []
        for k, payload in enumerate(self._read_pages(pids)):
            # one sha256 shard per (page, tp shard), in mesh-shard order
            for t, shard in enumerate(self._shards(payload)):
                shards.append(shard)
                manifest.append(self._shard_record(k, t, shard))
        root = self._req_spans.get(req.rid)
        trace_id = (root.trace_id if root is not None
                    else self._ext_trace.get(req.rid, 0))
        acc = self._phase_acc.get(req.rid) or {}
        return {
            "format": MIGRATION_FORMAT,
            "geometry": self._geometry(),
            "request": {"prompt": np.asarray(req.prompt, np.int32),
                        "max_new_tokens": req.max_new_tokens,
                        "eos_id": req.eos_id, "lane": req.lane,
                        "ttft_deadline_s": req.ttft_deadline_s,
                        "submitted_at": req.submitted_at},
            "state": {"generated": list(st.generated),
                      "prefilled": int(st.prefilled),
                      "length": length,
                      "admitted_at": st.admitted_at,
                      "first_token_at": st.first_token_at,
                      "phase_acc": dict(acc)},
            "trace_id": int(trace_id),
            "shards": shards,
            "manifest": manifest,
        }

    def _take_micro_snapshots(self):
        """Refresh the micro-snapshot outbox: a decoding slot that crossed
        another ``snapshot_every_blocks`` decode blocks gets a fresh
        snapshot keyed by rid (newest wins)."""
        k = self.snapshot_every_blocks
        for i in self.scheduler.decode_slots():
            rid = self.scheduler.slots[i].request.rid
            acc = self._phase_acc.get(rid)
            blocks = int(acc["decode_blocks"]) if acc else 0
            if blocks and blocks % k == 0 \
                    and self._last_snap_blocks.get(rid) != blocks:
                self._micro_snaps[rid] = self.snapshot_slot(i)
                self._last_snap_blocks[rid] = blocks

    def poll_micro_snapshots(self) -> Dict[int, Dict]:
        """Drain the micro-snapshot outbox (``{rid: snapshot}``, newest
        per request)."""
        out, self._micro_snaps = self._micro_snaps, {}
        return out

    def poll_handoffs(self) -> List:
        """Drain the prefill tier's handoff outbox: every parked
        prefill-done slot (first token emitted, not finished, not
        decoding in place) is snapshotted, stamped ``handoff_s`` and
        released, freeing its slot. Returns ``[(rid, snapshot), ...]``
        for a decode-tier engine's :meth:`restore_slot`; empty on other
        tiers."""
        if self.tier != "prefill":
            return []
        out = []
        now = time.monotonic()
        for slot in list(self.scheduler.active_slots()):
            st = self.scheduler.slots[slot]
            if not st.prefill_done or st.finished() \
                    or slot in self._decode_in_place:
                continue
            rid = st.request.rid
            snap = self.snapshot_slot(slot)
            snap["state"]["phase_acc"]["handoff_s"] = now
            self.release_slot(slot)
            out.append((rid, snap))
        self._refresh_health()
        return out

    def cancel_queued(self) -> List[Request]:
        """Pop every queued (not yet admitted) request and close its
        bookkeeping: the open root span finishes ``requeued``. Returns the
        requests in queue order."""
        out: List[Request] = []
        sched = self.scheduler
        while sched.queue:
            r = sched.queue.popleft()
            self._phase_acc.pop(r.rid, None)
            self._ext_trace.pop(r.rid, None)
            root = self._req_spans.pop(r.rid, None)
            if root is not None:
                root.add_event("requeued")
                root.finish(status="requeued")
            out.append(r)
        self._refresh_health()
        return out

    def release_slot(self, slot: int):
        """Drop a migrated-out slot without recording a result: free its
        pages, close its span ``migrated``; returns the popped
        :class:`~paddle_tpu_torch.serving.scheduler.SlotState`."""
        st = self.scheduler.slots[slot]
        if st is None:
            raise SlotMigrationError(f"slot {slot} is empty")
        self.scheduler.slots[slot] = None
        self.cache.free_slot(slot)
        self._decode_in_place.discard(slot)
        if self.speculative:
            self.draft_cache.free_slot(slot)
        rid = st.request.rid
        self._phase_acc.pop(rid, None)
        self._ext_trace.pop(rid, None)
        self._micro_snaps.pop(rid, None)
        self._last_snap_blocks.pop(rid, None)
        root = self._req_spans.pop(rid, None)
        if root is not None:
            root.add_event("migrated_out", slot=slot,
                           tokens=len(st.generated))
            root.finish(status="migrated")
        self.migrated_out_total += 1
        self._reg.counter("serving_migrated_out_total",
                          "in-flight requests migrated away").inc()
        self._refresh_health()
        return st

    def restore_slot(self, snap: Dict[str, object], *,
                     parent_span=None) -> int:
        """Restore a :meth:`snapshot_slot` snapshot (the port's or the
        reference's) into a free slot and resume it where it left off.
        Before any page lands: the geometry, then every shard's sha256
        (and layout), then the shard count against the carried length.
        Pages are reserved all-or-nothing with no shared mapping (the
        slot writes every page), so greedy outputs equal an unmigrated
        run. Returns the request's new local rid; its span adopts the
        snapshot's ``trace_id`` (under ``parent_span`` when given)."""
        if self.speculative:
            raise SlotMigrationError(
                "speculative engines do not migrate slots (the draft "
                "cache state is not carried in a snapshot)")
        if snap.get("format") != MIGRATION_FORMAT:
            raise SlotMigrationError(
                f"unknown snapshot format {snap.get('format')!r}")
        cfgc = self.cache.config
        geo, mine = snap["geometry"], self._geometry()
        if geo != mine:
            raise SlotMigrationError(
                f"cache geometry mismatch: snapshot {geo} != engine {mine}")
        shards, manifest = snap["shards"], snap["manifest"]
        if len(shards) != len(manifest):
            raise SlotMigrationError(
                f"{len(shards)} shards != {len(manifest)} manifest entries")
        for shard, rec in zip(shards, manifest):
            digest = self._shard_digest(shard)
            if digest != rec["sha256"]:
                raise SlotMigrationError(
                    f"shard {rec['index']} sha256 mismatch "
                    f"({digest[:12]}... != {rec['sha256'][:12]}...): "
                    "refusing to restore a corrupt page")
            self._check_shard(shard, f"shard {rec['index']}")
        free = self.scheduler.free_slots()
        if not free:
            raise SlotMigrationError("no free slot to restore into")
        rq, stt = snap["request"], snap["state"]
        prompt = np.asarray(rq["prompt"], np.int32).reshape(-1)
        total = int(prompt.shape[0]) + int(rq["max_new_tokens"])
        # an excess shard would index past the reserved block-table
        # entries (0) and overwrite the null page every slot gathers from
        length = int(stt["length"])
        n_live = cfgc.pages_for(length) if length > 0 else 0
        per = self._tp_shards
        if length < 0 or length > total or len(shards) != n_live * per:
            raise SlotMigrationError(
                f"{len(shards)} shards for {length} live tokens ({per} "
                f"per page) of a {total}-token reservation: snapshot "
                "state inconsistent, refusing to restore")
        if self.tier == "decode" and \
                int(stt["prefilled"]) < int(prompt.shape[0]):
            raise SlotMigrationError(
                "decode-tier engines restore only prefill-complete "
                f"slots ({int(stt['prefilled'])} of "
                f"{int(prompt.shape[0])} prompt tokens prefilled)")
        if not self.cache.can_reserve(total):
            raise SlotMigrationError(
                f"no page capacity for {total} tokens")
        slot = free[0]
        # no prompt: never map shared pages, the restore writes them all
        self.cache.reserve(slot, total)
        self._write_pages(zip(
            self.cache.block_tables[slot, :n_live],
            (self._payload(shards[k * per:(k + 1) * per])
             for k in range(n_live))))
        self.cache.lengths[slot] = length
        rid = next(self.scheduler._ids)     # a fresh local rid
        req = Request(rid, prompt, int(rq["max_new_tokens"]),
                      rq["eos_id"], submitted_at=rq["submitted_at"],
                      lane=rq["lane"],
                      ttft_deadline_s=rq["ttft_deadline_s"])
        st = SlotState(req, generated=list(stt["generated"]),
                       prefilled=int(stt["prefilled"]),
                       admitted_at=stt["admitted_at"],
                       first_token_at=stt["first_token_at"])
        self.scheduler.slots[slot] = st
        if snap.get("decode_in_place") and self.tier == "prefill":
            # handoff fallback: no decode-tier capacity, so this prefill
            # engine decodes the slot itself (its decode buckets are not
            # warmed: the one exception to the tier's build-free steady
            # state)
            self._decode_in_place.add(slot)
        acc = {"prefill_s": 0.0, "decode_s": 0.0, "prefill_chunks": 0.0,
               "decode_blocks": 0.0, "shared_tokens": 0.0}
        acc.update(stt.get("phase_acc") or {})
        if acc.get("handoff_s") and not acc.get("decode_start_s"):
            acc["decode_start_s"] = time.monotonic()
        self._phase_acc[rid] = acc
        trace_id = int(snap.get("trace_id") or 0)
        if trace_id:
            self._ext_trace[rid] = trace_id
        if self.tracer.enabled:
            root = self.tracer.start_span(
                "serving.request", parent=parent_span,
                trace_id=trace_id or None, rid=rid, lane=req.lane,
                migrated=True, prompt_tokens=int(prompt.shape[0]),
                max_new_tokens=req.max_new_tokens)
            root.add_event("migrated_in", slot=slot,
                           tokens=len(st.generated), kv_tokens=length)
            self._req_spans[rid] = root
        self.migrated_in_total += 1
        self._reg.counter("serving_migrated_in_total",
                          "in-flight requests migrated in").inc()
        self._refresh_health()
        return rid

    def export_prefix_pages(self, digests) -> Optional[Dict[str, object]]:
        """Package the leading run of ``digests`` this engine holds (on
        the card or host-spilled) as a bundle a peer can
        :meth:`import_prefix_pages`: per page its chain key, tokens and
        one sha256 shard (the migration layout). Stops at the first
        digest no longer held; a rotted spilled copy is dropped there and
        never leaves. Returns None when nothing is exportable."""
        if not self.cache.config.share_prefix:
            return None
        hits = []
        for key in digests:
            key = int(key)
            hit = self.cache.lookup_prefix_page(key)
            if hit is None:
                break
            if hit[0] == "host" and \
                    payload_digest(hit[1].payload) != hit[1].sha256:
                self.cache.spill_pool.pop(hit[1].key)
                self._reg.counter(
                    "serving_spill_corrupt_total",
                    "host-spilled pages refused on restore "
                    "(sha256 mismatch)").inc()
                break
            hits.append((key, hit))
        if not hits:
            return None
        read = iter(self._read_pages([h[1] for _, h in hits
                                      if h[0] == "device"]))
        pages, total_bytes = [], 0
        for key, hit in hits:
            if hit[0] == "device":
                tokens, payload = hit[2], next(read)
            else:
                tokens, payload = hit[1].tokens, hit[1].payload
            shards = self._shards(payload)
            recs = [self._shard_record(len(pages), t, shard)
                    for t, shard in enumerate(shards)]
            total_bytes += sum(r["bytes"] for r in recs)
            pages.append({"key": key,
                          "tokens": np.asarray(tokens, np.int32),
                          "shards": shards, "manifest": recs})
        self._reg.counter(
            "serving_prefix_exported_pages_total",
            "published prefix pages exported to peers").inc(len(pages))
        return {"format": PREFIX_BUNDLE_FORMAT, "geometry": self._geometry(),
                "pages": pages, "bytes": int(total_bytes)}

    def import_prefix_pages(self, bundle) -> int:
        """Install a peer's :meth:`export_prefix_pages` bundle into the
        published-prefix index, so the next admission maps the pages as
        shared-prefix hits. Verified before any page lands: format,
        geometry, the whole publication chain from the root (each key
        must equal ``chain(parent, tokens)``) and every shard's sha256.
        Pages land all-or-nothing into idle free pages, never by
        eviction, through ``("page_write",)``. Returns pages installed (0
        when all were already held)."""
        if bundle is None or not self.cache.config.share_prefix:
            return 0
        if bundle.get("format") != PREFIX_BUNDLE_FORMAT:
            raise SlotMigrationError(
                f"unknown prefix bundle format {bundle.get('format')!r}")
        cfgc = self.cache.config
        mine = self._geometry()
        if bundle.get("geometry") != mine:
            raise SlotMigrationError(
                f"cache geometry mismatch: bundle "
                f"{bundle.get('geometry')} != engine {mine}")
        pages = bundle.get("pages") or []
        prev = _ROOT_KEY
        for page in pages:
            tokens = np.asarray(page["tokens"], np.int32).reshape(-1)
            if tokens.shape[0] != cfgc.page_size:
                raise SlotMigrationError(
                    f"prefix page carries {tokens.shape[0]} tokens "
                    f"(page_size {cfgc.page_size}): refusing")
            key = int(page["key"])
            if _chain(prev, tokens) != key:
                raise SlotMigrationError(
                    "prefix bundle breaks the publication hash chain: "
                    "refusing to install unprovable pages")
            prev = key
            shards, manifest = page["shards"], page["manifest"]
            per = self._tp_shards
            if len(shards) != per or len(manifest) != per:
                raise SlotMigrationError(
                    f"{len(shards)} shards for a {per}-shard page: "
                    "refusing")
            for shard, rec in zip(shards, manifest):
                digest = self._shard_digest(shard)
                if digest != rec["sha256"]:
                    raise SlotMigrationError(
                        f"prefix shard sha256 mismatch ({digest[:12]}... "
                        f"!= {rec['sha256'][:12]}...): refusing to "
                        "install a corrupt page")
                self._check_shard(shard, f"prefix page {key}")
        held = self.cache.advertised_digests()
        install = [p for p in pages if int(p["key"]) not in held]
        if not install:
            return 0
        if len(install) > self.cache.idle_free_pages:
            raise SlotMigrationError(
                f"no idle page capacity for {len(install)} fetched "
                "prefix pages")
        self._write_pages([(self.cache.adopt_published_page(
            int(p["key"]), p["tokens"]), self._payload(p["shards"]))
            for p in install])
        nbytes = sum(int(r["bytes"]) for p in install
                     for r in p["manifest"])
        self._reg.counter(
            "serving_prefix_fetched_pages_total",
            "prefix pages installed from peers").inc(len(install))
        self._reg.counter(
            "serving_prefix_fetched_bytes_total",
            "bytes of prefix pages installed from peers").inc(nbytes)
        self._refresh_health()
        return len(install)

    # -- device steps -----------------------------------------------------

    def _bucket_spec(self, sig):
        """(int32 input layout, step function) of one signature: the
        function reads only those inputs, the weights and the pages."""
        kind = sig[0]
        s_tot = self.scheduler.num_slots
        if kind in ("prefill", "draft_prefill"):
            w, sb = sig[1], sig[2]
            layout = (("block_tables", (sb, w)), ("starts", (sb,)),
                      ("tokens", (sb, self.prefill_chunk)),
                      ("n_valid", (sb,)))
            model, cache = ((self.model, self.cache) if kind == "prefill"
                            else (self.draft_model, self.draft_cache))
            return layout, functools.partial(self._prefill_loop, model,
                                             cache)
        if kind == "copy_page":
            return (("src", (1,)), ("dst", (1,))), self._copy_page
        if kind == "page_read":
            return (("src", (1,)),), self._read_page
        if kind == "page_write":
            c = self.cache.config
            layout = (("dst", (1,)),
                      ("kv", (2, c.num_layers, c.page_size,
                              self.cache.local_heads, c.head_dim), c.dtype))
            if self.quantized:
                layout += (("sc", (2, c.num_layers, c.page_size),
                            torch.float32),)
            return layout, self._write_page
        w = sig[1]
        layout = (("block_tables", (s_tot, w)), ("lengths", (s_tot,)),
                  ("tokens", (s_tot,)))
        if kind == "decode":
            return layout + (("active", (s_tot,)),), functools.partial(
                self._decode_loop, self.model, self.cache,
                n_steps=self.decode_block)
        if kind == "decode_probe":
            # the decode step's twin: one shard's local work on a zero
            # pool with the collectives elided
            return layout + (("active", (s_tot,)),), functools.partial(
                self._decode_loop, self.model, self._probe_cache,
                n_steps=self.decode_block, collectives=False)
        if kind == "draft":
            return layout + (("active", (s_tot,)), ("n_valid", (s_tot,))), \
                functools.partial(self._decode_loop, self.draft_model,
                                  self.draft_cache, n_steps=self.spec_k)
        if kind == "verify":
            return layout + (("props", (s_tot, self.spec_k)),
                             ("n_valid", (s_tot,))), self._verify
        raise ValueError(f"unknown bucket signature {sig!r}")

    def _write_kv(self, layer, quantized, page_idx, off, k, v, axes,
                  group=None):
        """Land token K/V ``(..., H, Dh)`` in one layer's pages at
        ``[page_idx, off]`` in place; an int8 pool stores
        :func:`quantize_kv` rows (per token over ``axes``, the abs-max
        completed over the tp ``group``) and their scales. Duplicate
        targets only ever hit the null page."""
        if quantized:
            kp, vp, ksc, vsc = layer
            # K and V stacked: one MAX all-reduce of their abs-max rows
            kvq, kv_s = quantize_kv(torch.stack((k, v)),
                                    tuple(a + 1 for a in axes), group)
            if group is not None:
                self.tp_all_reduces["kv_amax"] += 1
            kp[page_idx, off] = kvq[0]
            vp[page_idx, off] = kvq[1]
            ksc[page_idx, off] = kv_s[0]
            vsc[page_idx, off] = kv_s[1]
        else:
            kp, vp = layer
            kp[page_idx, off] = k.to(kp.dtype)
            vp[page_idx, off] = v.to(vp.dtype)

    # -- the per-layer pieces, tp=1 or this rank's shard ------------------

    def _group(self, model, collectives: bool):
        """The device group a step's all-reduces run on: the tp group of
        the target model, None for tp=1, the probe twin and the draft."""
        if model is self.model and self.tp_spmd and collectives:
            return self._link.dev_group
        return None

    def _qkv(self, model, i: int, h):
        """q, k, v heads ``(S, H', C, Dh)`` of layer ``i`` from ``h``
        ``(S, C, D)``: all heads at tp=1, this rank's ``H/tp`` under tp
        (the column-split half of the Megatron split)."""
        if model is not self.model or self._tp_layers is None:
            return model.blocks[i].attn.qkv_heads(h)
        lay = self._tp_layers[i]
        y = h @ lay["qkv_w"]
        if "qkv_b" in lay:
            y = y + lay["qkv_b"]
        s, c = y.shape[:2]
        y = y.reshape(s, c, 3, self._tp_heads, -1).permute(2, 0, 3, 1, 4)
        return y[0], y[1], y[2]

    def _proj(self, model, i: int, att, group):
        """The output projection of layer ``i`` from heads ``(S, H', C,
        Dh)`` to ``(S, C, D)``; under tp this rank's row-split partial
        product, summed over the tp ``group`` (the one attention-output
        all-reduce) before the bias is added once."""
        if model is not self.model or self._tp_layers is None:
            return model.blocks[i].attn.proj_out(att)
        lay = self._tp_layers[i]
        s, h, c, dh = att.shape
        part = att.transpose(1, 2).reshape(s, c, h * dh) @ lay["out_w"]
        if group is not None:
            part = self._all_reduce(part, group, "attn_out")
        return part + lay["out_b"] if "out_b" in lay else part

    def _all_reduce(self, part, group, site: str):
        """The sum of every rank's ``part`` over the tp ``group``, in
        fp32 (bf16 partial products are summed in fp32 and rounded
        once)."""
        buf = part if part.dtype == torch.float32 else part.float()
        collective.group_all_reduce(buf, group)
        self.tp_all_reduces[site] += 1
        return buf if buf is part else buf.to(part.dtype)

    def _mlp(self, model, i: int, x, group):
        """The MLP of layer ``i`` on ``x`` (its ln2 included): replicated,
        or on a prefill tier under tp the Megatron split (fc1 by columns,
        fc2 by rows, closed by the layer's second all-reduce, the fc2 bias
        added once after it)."""
        block = model.blocks[i]
        if model is not self.model or not self._mlp_sharded:
            return block.mlp(block.ln2(x))
        lay = self._tp_layers[i]
        h = block.mlp.act(block.ln2(x) @ lay["fc1_w"] + lay["fc1_b"])
        part = h @ lay["fc2_w"]
        if group is not None:
            part = self._all_reduce(part, group, "mlp")
        return part + lay["fc2_b"]

    @torch.no_grad()
    def _decode_loop(self, model, cache, block_tables, lengths, tokens,
                     active, n_steps: int, n_valid=None,
                     collectives: bool = True):
        """The greedy token loop behind the decode block and the draft's
        proposals: ``n_steps`` iterations, each entering every slot's
        current token at position ``lengths[s]``, writing its K/V into
        the slot's current page of ``cache`` (int8 pools store quantized
        rows and scales), and attending ragged-paged over live pages
        only. Non-decoding lanes (``active`` 0: free slots and slots
        still mid-prefill, which own live pages the block must not
        corrupt) write to the null page, and so do iterations ``j >=
        n_valid[s]`` when ``n_valid`` is given (a draft chunk capped below
        ``n_steps`` must not write past the slot's reservation);
        post-EOS/post-cap lanes produce discarded tokens (the host keeps
        only in-budget, pre-EOS ones). Under tp the body is this rank's:
        its heads' qkv, K/V into its pool slice, attention over its
        heads, and the row-split output projection closed by one
        all-reduce per layer (``collectives=False``, the probe twin,
        elides it). Inputs are int32. Returns (S, n_steps) int32 tokens
        on the device."""
        cfg = model.cfg
        group = self._group(model, collectives)
        tokens = tokens.long()
        active = active != 0
        ps = cache.config.page_size
        quantized = cache.config.quantized
        decode_attn = self._attn[quantized][0]
        s_tot = tokens.shape[0]
        w = block_tables.shape[1]
        bt = block_tables.long()
        slot_ids = torch.arange(s_tot, device=self.device)
        out = torch.empty((s_tot, n_steps), dtype=torch.int32,
                          device=self.device)
        for j in range(n_steps):
            pos = lengths.clamp(max=cfg.max_position - 1).long()
            x = model.wte(tokens[:, None]) + model.wpe(pos[:, None])  # (S,1,D)
            writable = active if n_valid is None else active & (j < n_valid)
            # masked lanes write the null page; the column clamps to w - 1
            page_idx = torch.where(
                writable,
                bt[slot_ids, (lengths // ps).clamp(max=w - 1).long()], 0)
            off = (lengths % ps).long()
            attend_len = lengths + 1
            for i, block in enumerate(model.blocks):
                q, k, v = self._qkv(model, i, block.ln1(x))   # (S,H,1,Dh)
                # in-place page writes stand in for the reference's
                # donated page buffers
                layer = cache.pages[i]
                self._write_kv(layer, quantized, page_idx, off,
                               k[:, :, 0, :], v[:, :, 0, :], (1, 2), group)
                att = decode_attn(q[:, :, 0, :].contiguous(), *layer,
                                  block_tables, attend_len)   # (S,H,Dh)
                x = x + self._proj(model, i, att[:, :, None, :], group)
                x = x + self._mlp(model, i, x, group)
            x = model.ln_f(x)
            nxt = (x[:, 0] @ model.wte.weight.T).argmax(-1)
            out[:, j] = nxt.to(torch.int32)
            lengths = lengths + 1
            tokens = nxt
        return out

    @torch.no_grad()
    def _prefill_loop(self, model, cache, block_tables, starts, tokens,
                      n_valid, all_positions: bool = False):
        """Batched chunk forward behind the prefill step, the draft's
        prefill twin and the speculative verify: ``tokens`` (S, C) enter
        at absolute positions ``starts[s] .. starts[s] + C - 1`` (the
        first ``n_valid[s]`` real, the rest padding written to the null
        page), their K/V land in each slot's pages of ``cache`` (int8
        pools: quantized rows and scales), and every live lane attends
        causally over everything cached. Returns the greedy next token
        after each slot's last valid position, (S,) int32 on device, or
        with ``all_positions`` the greedy token after every chunk
        position, (S, C) (the verifier's per-candidate target tokens).
        Inputs are int32."""
        cfg = model.cfg
        group = self._group(model, True)
        tokens = tokens.long()
        ps = cache.config.page_size
        quantized = cache.config.quantized
        prefill_attn = self._attn[quantized][1]
        s_tot, c = tokens.shape
        w = block_tables.shape[1]
        bt = block_tables.long()
        lane = torch.arange(c, device=self.device)
        positions = starts.long()[:, None] + lane                # (S, C)
        x = (model.wte(tokens)
             + model.wpe(positions.clamp(max=cfg.max_position - 1)))
        valid = lane[None, :] < n_valid.long()[:, None]
        slot_ids = torch.arange(s_tot, device=self.device)[:, None]
        page_idx = torch.where(
            valid, bt[slot_ids, (positions // ps).clamp(max=w - 1)], 0)
        off = positions % ps
        for i, block in enumerate(model.blocks):
            q, k, v = self._qkv(model, i, block.ln1(x))      # (S,H,C,Dh)
            layer = cache.pages[i]
            self._write_kv(layer, quantized, page_idx, off,
                           k.transpose(1, 2), v.transpose(1, 2), (2, 3),
                           group)
            att = prefill_attn(q.transpose(1, 2).contiguous(), *layer,
                               block_tables, starts, n_valid)  # (S,C,H,Dh)
            x = x + self._proj(model, i, att.transpose(1, 2), group)
            x = x + self._mlp(model, i, x, group)
        x = model.ln_f(x)
        if all_positions:
            return (x @ model.wte.weight.T).argmax(-1).to(torch.int32)
        last = x[torch.arange(s_tot, device=self.device),
                 (n_valid.long() - 1).clamp(min=0)]             # (S, D)
        return (last @ model.wte.weight.T).argmax(-1).to(torch.int32)

    def _verify(self, block_tables, lengths, tokens, props, n_valid):
        """The speculative verify call: the chunk ``[pending, d_1 ..
        d_{k-1}]`` assembled on the device from the draft's proposals
        ``props`` (S, spec_k), through the target's batched prefill at
        every position. Returns (S, spec_k) int32 target tokens."""
        chunk = torch.cat([tokens[:, None], props[:, :self.spec_k - 1]],
                          dim=1)
        return self._prefill_loop(self.model, self.cache, block_tables,
                                  lengths, chunk, n_valid,
                                  all_positions=True)

    @torch.no_grad()
    def _copy_page(self, src, dst):
        """Device-side page copy (CoW of a borrowed shared tail page):
        every layer's K and V page ``src`` duplicated into ``dst``, with
        the scale rows of an int8 pool, which travel with their page.
        The bucket passes the page ids as (1,) device tensors, so one
        captured copy serves every pair."""
        for layer in self.cache.pages:
            for t in layer:
                t[dst] = t[src]

    @torch.no_grad()
    def _read_page(self, src):
        """One page of every layer, stacked ``(2, L, page_size, H, Dh)``
        (K then V): the migration shard's unit; an int8 pool also returns
        the page's scale rows ``(2, L, page_size)``. ``src`` is a (1,)
        device tensor: one captured read serves every page."""
        idx = src.long()
        pages = self.cache.pages

        def stack(j0):
            return torch.stack([torch.cat([layer[j].index_select(0, idx)
                                           for layer in pages])
                                for j in (j0, j0 + 1)])

        return (stack(0), stack(2)) if self.quantized else stack(0)

    @torch.no_grad()
    def _write_page(self, dst, kv, sc=None):
        """Install one page in the :meth:`_read_page` layout into page
        ``dst`` (a (1,) device tensor) of every layer, with its scale
        rows on an int8 pool."""
        idx = dst.long()
        for i, layer in enumerate(self.cache.pages):
            layer[0].index_copy_(0, idx, kv[0, i:i + 1])
            layer[1].index_copy_(0, idx, kv[1, i:i + 1])
            if sc is not None:
                layer[2].index_copy_(0, idx, sc[0, i:i + 1])
                layer[3].index_copy_(0, idx, sc[1, i:i + 1])
