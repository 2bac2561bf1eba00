"""ServingEngine: continuous-batching GPT inference over a paged KV cache
(``paddle_tpu/serving/engine.py``, the single-device subset).

The serving loop is two fixed-shape device steps:

- a **batched chunked-prefill step**: one call advances every admitted
  request's next prompt chunk at once — tokens (S, C), ragged per-slot
  valid counts, causal paged attention through
  :func:`~paddle_tpu_torch.serving.paged_attention.ragged_paged_prefill_attention`;
- a **decode step**: every slot advances a block of ``decode_block``
  tokens per call (a Python loop on the device with one device-to-host
  copy per block), attending over its own pages through
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

Tensor parallelism, slot migration, the disaggregated tiers, the host
spill tier, tracing, step anatomy and the flight recorder are later
slices of the port.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.observability import registry as obs
from paddle_tpu_torch.serving import paged_attention as PA
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
    draft's weight dtype)."""

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
                 attn_impl: str = "kernel", device="cuda",
                 draft_model=None, spec_k: int = 4,
                 draft_cache_dtype: Optional[torch.dtype] = None):
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
        # finished-request store for result(); pop-on-read + bounded
        self._results: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._rejects: "OrderedDict[int, Reject]" = OrderedDict()
        self._results_cap = max(64, 16 * num_slots)
        self.warmed_signatures: set = set()

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
            raise
        self._reg.counter("serving_requests_total",
                          "requests submitted to the engine").inc()
        self._reg.counter("serving_prompt_tokens_total",
                          "prompt tokens submitted").inc(total -
                                                         max_new_tokens)
        return rid

    def result(self, rid: int) -> Optional[np.ndarray]:
        """Generated tokens for a finished request (None while running
        or already consumed); pop-on-read, bounded."""
        return self._results.pop(rid, None)

    def reject_reason(self, rid: int) -> Optional[Reject]:
        """Structured reject for a request shed AFTER queueing (its TTFT
        deadline expired before admission); pop-on-read."""
        return self._rejects.pop(rid, None)

    # -- engine loop ------------------------------------------------------

    def step(self) -> Dict[int, np.ndarray]:
        """One engine iteration: shed expired-deadline queue entries,
        admit into free slots, advance every admitted request's prefill
        under the interleaving budget, advance every decoding slot one
        block, evict finished sequences. Returns ``{rid: generated
        tokens}`` for requests that finished now."""
        finished: Dict[int, np.ndarray] = {}
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
            self._reg.counter("serving_tokens_total",
                              "decode tokens produced").inc(kept)
            self._reg.counter("serving_steps_total").inc()
            finished.update(self._evict())
        return finished

    def _decode_round(self, dslots) -> int:
        """Advance every decoding slot one block of ``decode_block``
        tokens through the decode step; returns tokens kept."""
        n = self.decode_block
        s_tot = self.scheduler.num_slots
        tokens = np.zeros((s_tot,), np.int64)
        active = np.zeros((s_tot,), np.bool_)
        for i in dslots:
            tokens[i] = self.scheduler.slots[i].generated[-1]
            active[i] = True
        w = self._pow2_width(max(
            self.cache.config.pages_for(
                int(self.cache.lengths[i]) + n) for i in dslots))
        t0 = time.monotonic()
        out = self._decode_loop(self.model, self.cache,
                                self._dev(self.cache.block_tables[:, :w]),
                                self._dev(self.cache.lengths),
                                self._dev(tokens), self._dev(active), n)
        out = out.cpu().numpy()                   # (S, decode_block)
        t1 = time.monotonic()
        self._reg.histogram(
            "serving_decode_step_seconds",
            "wall time per decode block (sync included)").observe(t1 - t0)
        kept = 0
        for i in dslots:
            st = self.scheduler.slots[i]
            req = st.request
            budget_i = req.max_new_tokens - len(st.generated)
            for j in range(min(n, budget_i)):
                tok = int(out[i, j])
                st.generated.append(tok)
                kept += 1
                if req.eos_id is not None and tok == req.eos_id:
                    break
            if not st.finished():
                # the device advanced this slot the full block
                self.cache.lengths[i] += n
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
        tokens = np.zeros((s_tot,), np.int64)
        active = np.zeros((s_tot,), np.bool_)
        nv = np.zeros((s_tot,), np.int32)
        for i in dslots:
            st = self.scheduler.slots[i]
            tokens[i] = st.generated[-1]
            active[i] = True
            # never write past the slot's reservation: the chunk is
            # capped at the remaining generation budget
            nv[i] = min(n, st.request.max_new_tokens - len(st.generated))
        w = self._pow2_width(max(
            self.cache.config.pages_for(
                int(self.cache.lengths[i]) + n) for i in dslots))
        t0 = time.monotonic()
        tokens_dev, nv_dev = self._dev(tokens), self._dev(nv)
        props_dev = self._decode_loop(
            self.draft_model, self.draft_cache,
            self._dev(self.draft_cache.block_tables[:, :w]),
            self._dev(self.draft_cache.lengths), tokens_dev,
            self._dev(active), n, n_valid=nv_dev)           # (S, spec_k)
        chunk = torch.cat([tokens_dev[:, None],
                           props_dev[:, :n - 1].long()], dim=1)
        ver = self._prefill_loop(self.model, self.cache,
                                 self._dev(self.cache.block_tables[:, :w]),
                                 self._dev(self.cache.lengths), chunk,
                                 nv_dev, all_positions=True)  # (S, spec_k)
        props = props_dev.cpu().numpy()
        ver = ver.cpu().numpy()
        t1 = time.monotonic()
        self._reg.histogram(
            "serving_decode_step_seconds",
            "wall time per decode block (sync included)").observe(t1 - t0)
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
            for j in range(a):
                tok = int(ver[i, j])
                st.generated.append(tok)
                kept += 1
                if req.eos_id is not None and tok == req.eos_id:
                    break
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
            self._results[st.request.rid] = toks
            out[st.request.rid] = toks
        while len(self._results) > self._results_cap:
            self._results.popitem(last=False)   # oldest unconsumed
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
            tokens = np.zeros((sb, c), np.int64)
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
                    self._copy_page(*pc)
                    self.cache.copy_done(i)
                    self._reg.counter(
                        "serving_prefix_cow_total",
                        "copy-on-write page copies for shared tails").inc()
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
            starts_dev, tokens_dev, nv_dev = (self._dev(a) for a in
                                              (starts, tokens, nv))
            nxt = self._prefill_loop(self.model, self.cache,
                                     self._dev(bt_rows[:, :w]), starts_dev,
                                     tokens_dev, nv_dev)
            if self.speculative:
                # the draft ingests the same chunks so its cache mirrors
                # the target's committed prefix (its output is unused)
                self._prefill_loop(self.draft_model, self.draft_cache,
                                   self._dev(dbt_rows[:, :w]), starts_dev,
                                   tokens_dev, nv_dev)
            nxt = nxt.cpu().numpy()
            now = time.monotonic()
            self._reg.histogram(
                "serving_prefill_step_seconds",
                "wall time per batched prefill call (sync included)"
            ).observe(now - t0)
            call_tokens = 0
            for j, i in enumerate(pslots):
                st = self.scheduler.slots[i]
                n = int(nv[j])
                st.prefilled += n
                self.cache.lengths[i] += n
                if self.speculative:
                    self.draft_cache.lengths[i] += n
                call_tokens += n
                self.cache.publish_prefix(i, st.request.prompt,
                                          st.prefilled)
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
        """The buckets :meth:`warmup` runs, in order: ``("decode",
        width)``, ``("prefill", width, lanes)`` and ``("copy_page",)``; a
        speculative engine swaps the decode buckets for ``("draft",
        width)`` and ``("verify", width)`` and adds the draft's
        ``("draft_prefill", width, lanes)`` twins."""
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

    def warmup(self):
        """Run every decode and prefill bucket once against the null
        page (no live state is touched), so the kernel build and every
        bucket's first launch happen at start-up, not on a request."""
        s_tot = self.scheduler.num_slots
        zeros = self._dev(np.zeros((s_tot,), np.int32))
        tok0 = self._dev(np.zeros((s_tot,), np.int64))
        off = self._dev(np.zeros((s_tot,), np.bool_))
        self.warmed_signatures = set()
        for sig in self.warmup_plan():
            kind = sig[0]
            if kind in ("decode", "draft", "verify"):
                bt = self._dev(np.zeros((s_tot, sig[1]), np.int32))
            if kind == "decode":
                self._decode_loop(self.model, self.cache, bt, zeros, tok0,
                                  off, self.decode_block)
            elif kind == "draft":
                self._decode_loop(self.draft_model, self.draft_cache, bt,
                                  zeros, tok0, off, self.spec_k,
                                  n_valid=zeros)
            elif kind == "verify":
                self._prefill_loop(
                    self.model, self.cache, bt, zeros,
                    self._dev(np.zeros((s_tot, self.spec_k), np.int64)),
                    zeros, all_positions=True)
            elif kind in ("prefill", "draft_prefill"):
                w, sb = sig[1], sig[2]
                zb = self._dev(np.zeros((sb,), np.int32))
                model, cache = ((self.model, self.cache) if kind == "prefill"
                                else (self.draft_model, self.draft_cache))
                self._prefill_loop(
                    model, cache, self._dev(np.zeros((sb, w), np.int32)), zb,
                    self._dev(np.zeros((sb, self.prefill_chunk), np.int64)),
                    zb)
            else:
                self._copy_page(0, 0)
            self.warmed_signatures.add(sig)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- device steps -----------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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
        only. Non-decoding lanes (``active`` false: free slots and slots
        still mid-prefill, which own live pages the block must not
        corrupt) write to the null page, and so do iterations ``j >=
        n_valid[s]`` when ``n_valid`` is given (a draft chunk capped below
        ``n_steps`` must not write past the slot's reservation);
        post-EOS/post-cap lanes produce discarded tokens (the host keeps
        only in-budget, pre-EOS ones). Returns (S, n_steps) int32 tokens
        on the device."""
        cfg = model.cfg
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
        position, (S, C) (the verifier's per-candidate target tokens)."""
        cfg = model.cfg
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

    @torch.no_grad()
    def _copy_page(self, src: int, dst: int):
        """Device-side page copy (CoW of a borrowed shared tail page):
        every layer's K and V page ``src`` duplicated into ``dst``, with
        the scale rows of an int8 pool, which travel with their page."""
        for layer in self.cache.pages:
            for t in layer:
                t[dst] = t[src]
