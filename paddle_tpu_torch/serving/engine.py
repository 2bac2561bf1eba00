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
``("draft_prefill", w, lanes)``, ``("copy_page",)``), and on the card
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

Tensor parallelism, slot migration (and its page read/write
signatures), the disaggregated tiers and the host spill tier are later
slices of the port.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.serving import paged_attention as PA
from paddle_tpu_torch.serving.graphs import StepGraphs
from paddle_tpu_torch.serving.paged_cache import (PagedCacheConfig,
                                                  PagedKVCache, quantize_kv)
from paddle_tpu_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                                LoadShedError, Reject,
                                                SLOScheduler)

# TTFT/queue-wait histograms need sub-second resolution around
# interactive SLO budgets (the reference's buckets)
_LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.2, 0.35,
                    0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 4.0, 5.0, 7.5, 10.0,
                    15.0, 30.0, 60.0)


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
    observability arguments."""

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
                 cuda_graphs: bool = True):
        self.device = resolve_device(device)
        for what, m in (("model", model), ("draft_model", draft_model)):
            if m is not None and m.device != self.device:
                raise ValueError(f"{what} lives on {m.device}, engine "
                                 f"device is {self.device}")
        # (decode, prefill) attention by pool kind: False = fp, True = int8
        if attn_impl == "kernel":
            self._attn = {
                False: (PA.ragged_paged_decode_attention,
                        PA.ragged_paged_prefill_attention),
                True: (PA.ragged_paged_decode_int8_attention,
                       PA.ragged_paged_prefill_int8_attention)}
        elif attn_impl == "plain":
            self._attn = {
                False: (PA.paged_decode_plain, PA.paged_prefill_plain),
                True: (PA.paged_decode_int8_plain,
                       PA.paged_prefill_int8_plain)}
        else:
            raise ValueError(f"attn_impl must be 'kernel' or 'plain', "
                             f"got {attn_impl!r}")
        cfg = model.cfg
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
        self.cache = PagedKVCache(PagedCacheConfig(
            num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            head_dim=cfg.hidden_size // cfg.num_heads,
            num_slots=num_slots, page_size=page_size, num_pages=num_pages,
            max_pages_per_slot=max_pages_per_slot,
            dtype=cache_dtype or model.wte.weight.dtype,
            share_prefix=prefix_sharing), device=self.device)
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
               ttft_deadline_s: Optional[float] = None) -> int:
        """Enqueue a request; returns its rid. ``lane`` and
        ``ttft_deadline_s`` feed the SLO scheduler. Raises
        :class:`~paddle_tpu_torch.serving.scheduler.LoadShedError` (with
        a structured ``Reject``) when the scheduler sheds the request."""
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
        if self.tracer.enabled:
            root = self.tracer.start_span(
                "serving.request", rid=rid, lane=lane,
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
        ``spec_proposed`` / ``spec_accepted``, ``tokens`` and
        ``trace_id`` (0 with tracing off); pop-on-read, bounded."""
        return self._stats.pop(rid, None)

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
            # one card, no tensor parallelism, the colocated tier
            "tp": 1,
            "mesh_devices": 1,
            "tp_probe": False,
            "tier": "colocated",
            "prefix_gen": int(self.cache.prefix_gen),
        }
        if self.slo_monitor is not None:
            h["slo"] = self.slo_monitor.status()
        h["headroom"] = self._headroom()
        with self._health_lock:
            self._health_snap = h

    def _headroom(self) -> Dict[str, float]:
        """Spare capacity per resource in [0, 1], published as
        ``serving_headroom`` gauges. Flops stay unpriced (utilization
        0.0, the reference's value without its cost gauges) and spill
        stays 1.0 (no host spill tier)."""
        util = self.cache.utilization()
        free = len(self.scheduler.free_slots())
        cap_b = self.cache.capacity_bytes()
        live_b = self.cache.live_bytes()
        tokens = self._reg.counter("serving_tokens_total").value()
        saved = self._reg.counter(
            "serving_prefix_shared_tokens_total").value()
        head = {
            "flops_utilization": 0.0,
            "flops": 1.0,
            "pages": round(max(1.0 - util, 0.0), 6),
            "slots": round(free / self.scheduler.num_slots, 6),
            "hbm": round(max(1.0 - (live_b / cap_b if cap_b else 0.0),
                             0.0), 6),
            "hbm_live_bytes": int(live_b),
            "hbm_capacity_bytes": int(cap_b),
            "flops_per_busy_s": 0.0,
            "prefix_saved_per_token": round(
                saved / tokens if tokens else 0.0, 6),
            "spill": 1.0,
            "spill_pages": 0,
            "spill_bytes": 0,
        }
        g = self._reg.gauge(
            "serving_headroom",
            "spare capacity per resource (1 = idle, 0 = saturated)")
        for res in ("flops", "pages", "slots", "hbm", "spill"):
            g.set(head[res], resource=res)
        self._reg.gauge(
            "serving_prefix_saved_per_token",
            "prefill tokens skipped via prefix sharing per served token"
        ).set(head["prefix_saved_per_token"])
        return head

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
        t0 = time.monotonic()
        out = self.graphs.run(("decode", w), dict(
            block_tables=self.cache.block_tables[:, :w],
            lengths=self.cache.lengths, tokens=tokens, active=active))
        out = out.cpu().numpy()                   # (S, decode_block)
        t1 = time.monotonic()
        self._reg.histogram(
            "serving_decode_step_seconds",
            "wall time per decode block (sync included)").observe(t1 - t0)
        self.anatomy.add_phase("decode", t0, t1)
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
                "trace_id": float(root.trace_id) if root is not None
                else 0.0,
            }
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
        """Admission callback: reserve pages (mapping any published
        shared prefix), seed the slot's prefill cursor past the shared
        tokens, and record the queue-wait half of the TTFT split."""
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
                    self.graphs.run(("copy_page",),
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
            nxt = self.graphs.run(("prefill", w, sb), dict(
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
        ``("copy_page",)``; a speculative engine swaps the decode
        buckets for ``("draft", width)`` and ``("verify", width)`` and
        adds the draft's ``("draft_prefill", width, lanes)`` twins.
        Derived from the warmup-side doubling loops; it covers
        :meth:`reachable_signatures`, which makes zero captures after
        warmup a property of the plan. The reference's migration page
        IO signatures (``("page_read",)``, ``("page_write",)``) come
        with slot migration, which the port does not have yet."""
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
            for sb in counts:
                plan.append(("prefill", w, sb))
                if self.speculative:
                    plan.append(("draft_prefill", w, sb))
        plan.append(("copy_page",))
        return plan

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
        sigs |= {("prefill", w, sb) for w in widths for sb in counts}
        sigs.add(("copy_page",))
        return sigs

    def warmup(self):
        """Build every signature of :meth:`warmup_plan` up front, each
        against the null page (no live state is touched): on the card
        one eager call and one CUDA graph capture per signature, so the
        kernel build, every capture and every first launch happen at
        start-up and steady-state serving captures nothing. Records the
        built set in :attr:`warmed_signatures`."""
        self.warmed_signatures = set()
        for sig in self.warmup_plan():
            self.graphs.build(sig)
            self.warmed_signatures.add(sig)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        w = sig[1]
        layout = (("block_tables", (s_tot, w)), ("lengths", (s_tot,)),
                  ("tokens", (s_tot,)))
        if kind == "decode":
            return layout + (("active", (s_tot,)),), functools.partial(
                self._decode_loop, self.model, self.cache,
                n_steps=self.decode_block)
        if kind == "draft":
            return layout + (("active", (s_tot,)), ("n_valid", (s_tot,))), \
                functools.partial(self._decode_loop, self.draft_model,
                                  self.draft_cache, n_steps=self.spec_k)
        if kind == "verify":
            return layout + (("props", (s_tot, self.spec_k)),
                             ("n_valid", (s_tot,))), self._verify
        raise ValueError(f"unknown bucket signature {sig!r}")

    @staticmethod
    def _write_kv(layer, quantized, page_idx, off, k, v, axes):
        """Land token K/V ``(..., H, Dh)`` in one layer's pages at
        ``[page_idx, off]`` in place; an int8 pool stores
        :func:`quantize_kv` rows (per token over ``axes``) and their
        scales. Duplicate targets only ever hit the null page."""
        if quantized:
            kp, vp, ksc, vsc = layer
            kq, k_s = quantize_kv(k, axes)
            vq, v_s = quantize_kv(v, axes)
            kp[page_idx, off] = kq
            vp[page_idx, off] = vq
            ksc[page_idx, off] = k_s
            vsc[page_idx, off] = v_s
        else:
            kp, vp = layer
            kp[page_idx, off] = k.to(kp.dtype)
            vp[page_idx, off] = v.to(vp.dtype)

    @torch.no_grad()
    def _decode_loop(self, model, cache, block_tables, lengths, tokens,
                     active, n_steps: int, n_valid=None):
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
        only in-budget, pre-EOS ones). Inputs are int32. Returns
        (S, n_steps) int32 tokens on the device."""
        cfg = model.cfg
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
                q, k, v = block.attn.qkv_heads(block.ln1(x))  # (S,H,1,Dh)
                # in-place page writes stand in for the reference's
                # donated page buffers
                layer = cache.pages[i]
                self._write_kv(layer, quantized, page_idx, off,
                               k[:, :, 0, :], v[:, :, 0, :], (1, 2))
                att = decode_attn(q[:, :, 0, :].contiguous(), *layer,
                                  block_tables, attend_len)   # (S,H,Dh)
                x = x + block.attn.proj_out(att[:, :, None, :])
                x = x + block.mlp(block.ln2(x))
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
            q, k, v = block.attn.qkv_heads(block.ln1(x))      # (S,H,C,Dh)
            layer = cache.pages[i]
            self._write_kv(layer, quantized, page_idx, off,
                           k.transpose(1, 2), v.transpose(1, 2), (2, 3))
            att = prefill_attn(q.transpose(1, 2).contiguous(), *layer,
                               block_tables, starts, n_valid)  # (S,C,H,Dh)
            x = x + block.attn.proj_out(att.transpose(1, 2))
            x = x + block.mlp(block.ln2(x))
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
