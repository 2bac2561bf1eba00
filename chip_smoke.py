#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile every ``paddle_tpu_torch/csrc/*.cu`` with nvcc
   (sm_90a), one process per source, all started together, and beside
   them the native runner of phase 12 with g++; print the
   ptxas line (registers, spills) of each of the 34 tensor-core
   instances, the 18 bf16 instances of K5, K6a and K6b and the 16 paged
   prefill instances (bf16 q over bf16 pages, K3, and over int8 pages,
   K4, each for Dh up to 128) and, with ``cuobjdump``, its count of
   HGMMA (wgmma, K5/K6) or HMMA (mma.sync, K3/K4) instructions (each
   must be found with a spill count and, where counted, a count > 0; the
   Dh = 64 instances must not spill).
3. kernels — every registered kernel against its plain PyTorch version
   (and the dense reference) on the card, fp32 and bf16, timed with CUDA
   events (median, L2 flushed before each launch; ``ms`` as the host
   issues the call, ``device_ms`` with the card spinning ~1 ms first so
   the host's work stays out, and ``host_ms``, the host's time in the
   call) beside the roofline bound and, where one PyTorch call computes
   the same function, that call's time in both windows:
   (a) ragged paged decode / prefill at the serving shapes (S=16, H=16,
       Dh=64, page 16, width 32, chunk 64), with ragged lengths (0 and
       non-multiples of the page), inactive prefill slots, and NaN in
       every page no block table references; their int8 twins on the same
       pages quantized by ``quantize_kv``, where the unreferenced pages
       hold bytes 127 under NaN scale rows and each dead tail bytes 127
       under a finite scale of 1e4; both prefills (K3 over bf16 or fp32
       pages, K4 over int8 pages) also at the speculative verify shape
       (chunk = spec_k = 4: the ``verify`` case of their entries in the
       ``kernels`` line, with its own bound); decode also at a
       long, few-slot shape (2 slots of 4096 tokens, lengths at the edges
       of the partition of a slot's pages over the 8 warps of its block);
       K1-K4 also on the head slice a rank of 4m's tp=2 (8 heads) and
       tp=4 (4 heads) legs holds (cases ``tp2_heads8`` and
       ``tp4_heads4``; int8 pages quantized over all 16 heads), where
       the registered ``ragged_paged_*_tp`` entry point must equal the
       kernel bit for bit. Every kernel launched twice on the same inputs must give the same
       bits, and a decode slot of length 0 exact zeros; each timed row
       runs the launch configuration the committed tuning cache
       (``paddle_tpu_torch/kernels/tune.json``) chooses, and every
       configuration K1-K4's contracts declare (one each: the warps a
       block the kernels fix) is held to the plain version on the same
       poisoned inputs, fp32 and bf16, bitwise on a repeat and zeros for
       length 0;
   (b) flash attention forward, dk/dv and dq at the training shape
       (48, 12, 512, 64) with a key-padding bias from ragged valid
       lengths (one of them 0: a fully masked batch row), causal at
       (4, 16, 512, 64), a ragged S=320 with a key bias, and phase 11's
       packed shape (16, 16, 256, 64) with a full (16, 1, 256, 256)
       segment bias (SDPA timed with the same float mask); each row
       with its achieved TFLOP/s and share of its bound, repeat launches
       bit-identical, and the K6a + K6b pair beside SDPA's whole
       backward.
3c. kernel layer — the parity battery (``kernels.harness``) of every
   registered entry on the card under every configuration its contract
   declares, fp32 and bf16; the autotuner's measurement at the cells'
   shapes (``kernels.autotune.CELLS``) into a temporary cache, each key's
   choice beside the prior's device time (the configuration the kernels
   run today; each declares one candidate per tunable); the committed
   cache's entries for this card as fresh or stale (stale fails); the
   registry lint (an error fails).
4. serve   — GPT (vocab 32768, hidden 1024, 12 layers, 16 heads, ffn
   4096, max_position 512, random weights from a seed) behind
   ``make_serving_engine(num_slots=16, page_size=16, prefill_chunk=64,
   max_tokens_per_slot=352)``; ``warmup()`` captures one CUDA graph per
   bucket signature (37; 73 with speculation) and each run prints the
   count, its warmup seconds, the graph pool's bytes and the captures
   after warmup, which must be 0:
   (a) bf16 weights and pages, 48 requests (prompts of 16..256 tokens,
       96 new tokens each), timed; every request must finish and both
       paged kernels must have launched during the run;
   (c) the same with ``cache_dtype=torch.int8``: every request finishes,
       the int8 kernels launch; capacity bytes per token and token
       agreement with (a) are reported (int8 is another result, not
       gated);
   (d) the same over int8 pools with self-draft speculation, spec_k=4:
       the draft proposes through the int8 decode kernel, the target
       verifies through the int8 prefill kernel (its launches counted by
       chunk from the graphs' replays: 4 for verify, 64 for prefill and
       the draft's prefill twin); proposed, accepted and
       tokens per round are reported (self-draft doubles the work per
       token by design: this shows the path runs, not a speed-up);
   (b) fp32, 8 requests x 32 new tokens, through the kernels in captured
       graphs, through the kernels dispatched eagerly
       (``cuda_graphs=False``) and through the plain versions: greedy
       tokens must be identical, the two kernel runs must launch K1 and
       K3 equally often, and the first tokens must match the dense
       ``GPT.forward`` recompute;
   (e) fp32 again: int8 pools through the kernels and through the plain
       versions give identical tokens, and self-draft speculation over
       int8 pools gives the non-speculative int8 tokens, each request up
       to a near-tie of the int8 dense recompute (``NEAR_TIE``); a weak
       draft (2 layers at full width, another seed) over fp pools gives
       (b)'s tokens exactly, with accepted < proposed;
   (f) ``GPT.generate(use_cache=True)`` (eager) and ``generate_bucketed``
       (one captured decode graph per bucket) on (a)'s GPT, bf16, 16
       prompts of 128 tokens, 128 new tokens: tokens/s, prefill ms, ms
       per decode step, K5 launches (12 per prefill), the bucket's builds
       and the captures of a second prompt length in it (must be 0);
   (g) slot migration, bf16 and int8 pools: 16 of (a)'s requests on
       engine A, after 2 decode blocks every live slot snapshotted,
       released and restored on a warmed engine B, which finishes them:
       restored pages re-read to their manifest digests, tokens agree
       with an unmigrated run up to a near-tie, no capture after warmup;
       snapshot and restore ms per slot and the page IO split by stage
       (device read, device to host, sha256, host to device, device
       write) with its GB/s;
   (h) disaggregated: a prefill-tier and a decode-tier engine serve (a)'s
       48 requests through ``poll_handoffs``/``restore_slot``: decode
       tokens/s, TTFT and handoff latency p50/p99, bytes handed over,
       each tier's signatures; tokens agree with (a) up to a near-tie, no
       capture after warmup;
   (i) host spill and prefix exchange: (a)'s engine with 160 pages and a
       512-page host pool over waves sharing a 128-token prefix: pages and
       bytes spilled and restored, restore GB/s, the prefix's 8 pages
       exported to and imported by a fresh engine;
   (j) fp32, 2 layers at full width, exact tokens: ``generate`` cached ==
       uncached == bucketed == the serving engine; migrated ==
       unmigrated; disaggregated == colocated; spill on == off; imported
       prefix == fresh prefill; a fleet-routed run == one engine; drained
       == undrained; redriven after a crash == failure-free; a request
       through ``NetReplica`` == one through ``LocalReplica``;
   (k) fleet: four ``LocalReplica``s of (a)'s GPT, bf16, each engine as
       the reference's router bench configures a replica on its chip
       (8 slots, page 16, chunk 64, 256 tokens a slot), 48 requests of
       16..192 prompt tokens, 64 new: 1/2/4 replicas (tokens/s, TTFT),
       affinity against round robin over a 66-token system prompt, a
       mid-decode drain (ms per migrated slot), a crash and a flaky
       transport (ejects, redrives, sheds by reason), four fresh replicas
       on their own threads while the autoscaler warms a fifth on the
       main thread, all built and run under the lock sanitizer (no
       double-acquire, every observed edge in the committed
       ``lock_order.json``; its edges and counts printed), and two
       int8-pool replicas; every request finishes or is
       shed with a registered reason, no replica captures after warmup,
       disturbed tokens agree with undisturbed ones up to a near-tie, K1
       and K3 (K2 and K4 in the int8 leg) launch, flops headroom < 1;
   (l) network: replica servers as subprocesses on the card beside an
       in-process replica, same weights (sha256): 16 requests through
       the local replica, a server (its router from
       ``inference.make_net_serving_fleet``), and a ``FrontDoor``
       streaming to 16 clients; ``kill -9`` of a second server mid-decode (ejected,
       redriven) and SIGTERM to the first (exit 84 after its work);
       tokens agree up to a near-tie, each stream >= 2 partials, the
       netlog validates; codec, RPCs, transport ms per token, stream
       TTFT;
   (m) tensor parallelism: (i) a tp=2 group of two processes on the
       card over gloo (rank 0 leads, rank 1 follows; K1-K4 built by
       phase 2, loaded by both), eager, (a)'s GPT bf16 and int8 and the
       fp32 2-layer model, 16 requests of 16..256 prompt tokens, 64 new
       each: tokens held against a tp=1 engine on the same weights
       (near-tie rules as (k); fp32 up to a near-tie, counted), K1/K3
       (K2/K4 for int8) launched on both ranks at 8 heads, as many times
       on each (rank 0's collective probe twin's launches apart), one
       attention-output all-reduce per layer per forward (and one K/V
       abs-max all-reduce on an int8 pool), tokens/s (gloo on one card:
       not a tp speed) and rank 0's collective probe every 8 decode
       rounds (exposed seconds and share); either rank failing fails
       the run; (ii) ``tp_probe=True`` at tp=2 and tp=4 in this process,
       graphs on, (a)'s traffic: decode and prefill tokens/s and the
       paged kernels' device ms per 4 decode blocks at 8 and 4 heads
       beside (a)'s: one chip's share of a tp deployment.
5. train   — BERT-base pretraining (vocab 30522, hidden 768, 12 layers,
   12 heads, ffn 3072, max_position 512, post-LN, dropout 0), batch
   48 x 512 with valid lengths 128..512, the multi-tensor AdamW(1e-4),
   bf16 compute over fp32 master weights, through ``build_train_step``
   (one captured CUDA graph: step 1 eager, step 2 captured, then replays)
   and ``Trainer.fit(checkpoint_dir=..., run_log=...)`` with telemetry:
   3 warm-up steps (a forced save at the end), then 20 timed steps on a
   fixed seeded batch; the loss must be finite and fall, each flash
   kernel must launch exactly 12 times per step (counted per replay), no
   capture may follow the first graphed step, and the run log must pass
   its validator. Then 80 steps with a save issued at their 2nd step
   (the host copy on the loop, the write behind it; whether the write
   ended inside the window is reported), and
   ``Trainer.restore()`` of the newest snapshot, which must give the
   state back bit for bit. Prints tokens/s, ms/step, MFU, peak memory,
   snapshot save/restore seconds, the window's ms/step, and the device
   busy share (within the profiled window), top kernels and every flash kernel's device time over 3
   profiled steps; the AdamW alone (multi-tensor and the plain
   per-parameter rule) on copies of the parameters: kernels and device ms
   per step beside its bound (28 bytes a parameter); then two legs from
   fresh weights: ``remat=True`` against the step without it (losses
   equal, peak memory of each), and ``amp.scaled_train_step`` (bf16)
   whose 4th step is forced to overflow by an infinite scale and must be
   skipped on the device (parameters, slots and steps unchanged, the
   scale backed off).
6. parity  — fp32 BERT at full width with 2 layers, batch 8 x 512, TF32
   off: 3 AdamW steps through the kernels and through the plain versions
   (losses and final parameters within 1e-4); the captured step against
   eager dispatch after 3 steps, bit for bit; the multi-tensor AdamW
   against the plain rule within 1e-6; a run checkpointed at step 2,
   restored into a fresh model and continued to step 4 against an
   unbroken run, bit for bit.
8. parallel train (runs before 7) — training across ranks, every group
   a gloo group of processes on the card whose mesh turns on the explicit
   ``stage_cuda_through_host`` switch (``ppermute``, ``all_gather`` and
   ``reduce_scatter`` of CUDA tensors through pinned host buffers, their
   bytes counted; every kernel on the card), each rank loading the K5/K6
   phase 2 built, TF32 off:
   (a) the ring alone in an sp=4 and an sp=2 group at (8, 12, 2048, 64)
       with a key-padding bias (one batch row fully masked): bf16, bf16
       causal and fp32; forward and dq/dk/dv against the dense K5/K6 path
       on the whole sequence within the flash entries' tolerances; per
       rank K5/K6a/K6b launches equal to the blocks run, a causal rank r
       running the diagonal and r earlier blocks and launching nothing
       for the later ones; staged bytes per hop; at sp=2 the bf16 ring's
       forward and backward timed beside the plain blocks', SDPA's on
       the whole sequence and the bound;
   (b) BERT-base with ``attn_impl="ring"`` at sp=2 (each rank 8 x 256 of
       an 8 x 512 batch, valid lengths 128..512), 3 eager AdamW steps in
       bf16 over fp32 masters (the phase's main path: counts set to 0
       just before, read just after; K5, K6a and K6b must launch on each
       rank), losses equal on the ranks and within one bf16 ulp (2^-7
       relative) of sp=1 with ``attn_impl="auto"`` in this process; the
       fp32 2-layer model within 1e-4;
   (c) ``shard_train_step`` at 2 x (24 x 512), fp32, BERT-base width at 4
       layers (``PAR_LAYERS``, cut in depth for the script's time): the
       ``replicated`` plan (dp=2) and the ``fsdp`` plan (fsdp=2) against
       one process at 48 x 512, losses within 2e-5 and the parameters
       gathered within 1e-4 (the key third of each qkv bias held to its
       drift bound, as phase 6), each rank's peak memory;
   (d) Megatron from the layers' hints, tp=2, (c)'s model fp32 at 4 x
       512: losses within 2e-4 of tp=1;
   (e) LocalSGD(k=2) in the dp=2 group, fp32 2-layer model: after each
       sync step every rank holds the same parameters, bit for bit the
       mean of the ranks' before it;
   (f) the fsdp ranks of (c) save their blocks into one snapshot; a
       fresh fsdp=2 group restores with ``shardings=``, and this process
       without, both bit for bit.
   Each leg's seconds; tokens/s labelled "gloo on one card: not a
   parallel speed"; either rank failing fails the run.
9. pipelines (runs after 8) — a pp=2 gloo group of two processes on the
   card (the staging switch on; every kernel on the card, TF32 off): its
   legs ride phase 8's two-rank group after (e), one start-up for both:
   (a) ``gpipe`` and ``circular_pipeline`` (v=2) over a 4-layer toy stack
       (tanh(h @ w + b), width 1024, 4 microbatches of 16 rows), fp32 and
       bf16, forward and gradients against the sequential stack (fp32
       within 1e-5 of its largest value, bf16 2e-2);
   (b) BERT-base ``pipeline=True`` (stacked encoder split over "pp" by
       its hints), GPipe, M=4, 16 x 512 (valid lengths 128..512), 3 eager
       AdamW steps in bf16 over fp32 masters through ``shard_train_step``
       (the phase's main path: counts set to 0 just before, read just
       after), then the fp32 2-layer model: K5/K6a/K6b launches per rank
       equal to the reckoning (each stage layer once per microbatch, K5
       again in the recompute), staged bytes equal to its hops, losses
       equal on the ranks and within 2^-9 relative (fp32: 1e-5) of pp=1
       in this process, and the fp32 pp=1 losses within 1e-5 of the same
       weights' stacked layers without the pipeline (``StackedLayers``'
       plain loop over the whole batch); step seconds and peak memory per
       rank;
   (c) (b)'s model under the circular schedule (v=2, pre-interleaved), 1
       step, its loss against (b)'s first;
   (d) GPT-2 small (vocab 50304, 12 x 768, 12 heads, 1024 positions)
       ``pipeline=True``, M=4, 8 x 512, 2 bf16 steps (causal K5) against
       pp=1;
   (e) (b)'s state saved as each stage's rows (``Shard`` leaves), restored
       in the group with ``shardings=`` naming "pp" and here without
       them, bit for bit.
10. embedding serving (runs after 9; every leg on the card, TF32 off)
   at the reference's configuration for a chip: a host KV store of 2M
   ids x 26 fields x (1 + 16) floats (adagrad, seed 0), DeepFM's towers
   (400, 400), a device cache of 65,536 rows (LRU, gather widths from
   8,192) whose gather, install and forward widths are captured CUDA
   graphs, batches of 2048 x 26 ids (80% on a hot head of 8,192, 20% on
   the tail) with 64 rows pushed every 4th batch:
   (a) an engine without a model over 48 batches, every push applied
       before the next: every served row equals ``store.pull`` bit for
       bit, the cache's index holds after every step, 0 captures after
       warmup, the table keeps its storage;
   (b) DeepFM's probabilities against the plain forward on the CPU from
       the same pulled rows within 1e-5, the forward graph's replay equal
       to the eager forward on the card bit for bit;
   (c) the main path, timed: ``warmup((2048, 26))`` (captures equal to
       ``warmup_plan``), 48 batches pipelined two deep with a streaming
       channel (staleness bound 5 s): examples/s, lookup p50/p99,
       miss-pull p99, hit rate (0.79-0.82), evictions, rows applied,
       staleness, 0 captures after warmup, no registered kernel
       launched, the device's busy share and the wall time by stage;
       then the reference's cold yardstick (the whole table pulled and
       copied to the card per batch, 4 batches) and ``speedup_vs_cold``;
   (d) the engine over a ``RemoteKVStore`` to an in-process ``KVServer``
       against a local store of the same seed, 8 batches: probabilities
       bit for bit;
   (e) (c)'s engine snapshot restored into a fresh store: rows, version
       counters and the next batch's probabilities bit for bit;
   (f) host-KV training, DeepFM at 4096 x 26 (Adam 1e-3 on the towers,
       adagrad 0.05 on the rows), 4 steps of ``run_kv_epoch`` with
       prefetch; the first step's loss and row gradients within 1e-5
       (relative) of the same step on the CPU; steps/s.
11. data, packed Transformer-big training and export (runs after 10;
   TF32 off for (c)) at the reference's chip configuration
   (``bench.py:368-393``): Transformer-big (vocab 32768, d_model 1024, 16
   heads, ffn 4096, 6 + 6 pre-LN layers, label smoothing 0.1, seeded
   weights), 16 x 256 packed rows, Adam(1e-4), bf16 over fp32 masters:
   (a) 1,500 WMT-like pairs (lognormal(3.0, 0.6) lengths clipped to
       [4, 255], a copy task) written into 4 MultiSlot files, loaded by
       the native feed on 4 threads, ``global_shuffle(0)``, framed with
       BOS/EOS and packed (``packing.packed_batches``); a second run of
       the same files must give the same batches bit for bit, and the
       batches ``DeviceLoader`` stages must equal them; pairs loaded,
       packed batches, packing efficiency, the loader's host and wait ms
       per batch and its pinned allocations (none after the first
       capture);
   (b) the main path: ``build_train_step`` through one captured graph
       fed by the loader, 3 warm-up and 10 timed steps: ms per step,
       real target tokens/s, MFU of the hand reckoning
       (``tf_flops_per_step``) over 989 TFLOP/s, peak memory, busy share,
       captures after the first graphed step (0), K5/K6a/K6b launches
       per step (18 each: 6 encoder, 6 causal decoder and 6 cross
       attentions, each with a full segment bias); then the padded
       layout (one pair a row) on the same graph: ``packed_vs_padded``;
   (c) fp32, full width, 2 + 2 layers: the packed token sum against the
       padded per-pair losses (rel 2e-5), the first batch's gradients
       (atol/rtol 1e-4) and 3 Adam steps' losses (rel 1e-5) through the
       kernels against the plain versions, and cross-attention over
       source rows without padding at (16, 16, 256, 64): the target's
       padding queries see no key, so their rows and dq are 0 and their
       cotangent moves dk/dv by nothing;
   (d) the trained model in bf16 exported by ``save_inference_model``
       and run by a ``Predictor`` in a fresh ``python3 -c`` process that
       imports no model module: logits bit for bit the eager model's, 18
       K5 launches a call (passed back on stdout); the artifact's bytes;
       with ``weight_quantize="int8"`` its bytes and the logits' max error
       against bf16 (within ``TF_INT8_TOL`` of their std).
12. native serving and beam search (runs after 11, on its trained
   model; TF32 off; the C++ runner is built by g++ against libtorch
   beside phase 2's nvcc builds):
   (a) the bf16 model's teacher-forced forward on (d)'s 16 x 256 batch
       frozen with ``save_inference_model(freeze_native=True)``
       (AOTInductor), then with ``weight_quantize="int8"``: compile
       seconds, package bytes beside ``__model__.pt2``'s, the int8
       package at most ``NATIVE_INT8_BYTES`` of the bf16 one;
   (b) each package served by ``NativePredictor`` from a runner process
       with no Python in it: logits against the eager bf16 model within
       ``NATIVE_TOL`` of their std (int8 ``TF_INT8_TOL``), 18 K5
       launches a call from the C++ counter, 10 repeated calls bit for
       bit, the median of 20 calls (and the runner's own device and
       copy-out ms) beside the Python ``Predictor``'s on the same
       program and inputs; the fp32 2 + 2 model of 11 (c) frozen and
       served within ``NATIVE_FP32_TOL`` of its eager logits;
   (c) K5 through the runner's C++ registration of ``ptt::flash_fwd``
       against K5 through the Python op, bit for bit, at 3b's packed
       case (16, 16, 256, 64) with its segment bias and the training
       case (48, 12, 512, 64) with a key bias, and within the entry's
       tolerance of the plain version; its time back to back in the
       runner beside the plain version's, SDPA's and the bound;
   (d) ``beam_search_decode(beam_size=4)`` on 16 source rows to 64
       tokens: bf16 tokens/s and K5 launches (6 a call, the encoder);
       the fp32 2 + 2 model through the kernels and the plain versions
       (identical ids, scores within 1e-5); beam 1 equal to greedy;
   (e) every op of the dense op library (``ops/samples.py``) on the
       card in fp32 against its numpy reference (or the op on the CPU
       where the reference has none), the random ops by their
       distributions: 0 failures.
7. output  — one ``{"kernels": [...]}`` line (each kernel with its
   tunables' candidates and the configuration the committed cache chose
   at each shape, ``blocks``; the ring's entry over K5/K6 with its calls
   on (b)'s main path; K5/K6a/K6b with their launches on each stage
   rank of 9 (b), ``launches_pipeline_ranks``, over 11 (b)'s timed
   steps, ``launches_transformer``, and K5's in 12 (d),
   ``launches_beam_search``; K5's C++ binding with its launches over 12
   (b)'s timed bf16 calls), the nvidia-smi line, and the final
   ``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import collections
import concurrent.futures
import copy
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): HBM bytes/s and FLOP/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

S, H, DH, PS, W, C = 16, 16, 64, 16, 32, 64     # serving shapes
SPEC_K = 4                                       # the verify chunk (4d)
UNREFERENCED_PAGES = 64                          # NaN-poisoned, never read


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels vs plain versions --------------------------------------

def _pages(rng, n_slots=S, width=W):
    live = 1 + n_slots * width
    n_pages = live + UNREFERENCED_PAGES
    kp = rng.standard_normal((n_pages, PS, H, DH)).astype(np.float32)
    vp = rng.standard_normal((n_pages, PS, H, DH)).astype(np.float32)
    kp[live:] = np.nan                      # pages no block table holds
    vp[live:] = np.nan
    bt = (1 + rng.permutation(n_slots * width)).reshape(
        n_slots, width).astype(np.int32)
    return kp, vp, bt


def _poison_dead_tail(kp, vp, bt, horizon):
    """Finite poison past each slot's horizon inside its last live page:
    masked tokens must contribute exact zeros."""
    for s, n in enumerate(horizon):
        n = int(n)
        if 0 < n < bt.shape[1] * PS and n % PS:
            page = bt[s, n // PS]
            kp[page, n % PS:] = 1e4
            vp[page, n % PS:] = 1e4


def _int8_pages(kp, vp, bt, horizon):
    """(k_pages, v_pages, k_scales, v_scales): the live fp pages quantized
    by ``quantize_kv``; every page no block table references holds bytes
    127 under a NaN scale row (int8 cannot hold NaN), and each slot's
    dead tail inside its last live page bytes 127 under a finite scale of
    1e4: masked tokens must contribute exact zeros."""
    from paddle_tpu_torch.serving.paged_cache import quantize_kv
    live = 1 + S * W
    out = []
    for pages in (kp, vp):
        q8, sc = (t.numpy() for t in quantize_kv(
            torch.from_numpy(pages[:live]), (2, 3)))
        dead = len(pages) - live
        q8 = np.concatenate([q8, np.full((dead,) + q8.shape[1:], 127,
                                         np.int8)])
        sc = np.concatenate([sc, np.full((dead, PS), np.nan, np.float32)])
        for s, n in enumerate(horizon):
            n = int(n)
            if 0 < n < W * PS and n % PS:
                q8[bt[s, n // PS], n % PS:] = 127
                sc[bt[s, n // PS], n % PS:] = 1e4
        out.append((q8, sc))
    (kq, ks), (vq, vs) = out
    return kq, vq, ks, vs


def decode_inputs(seed, device, quantized=False):
    rng = np.random.default_rng(seed)
    kp, vp, bt = _pages(rng)
    lengths = rng.integers(1, W * PS + 1, S).astype(np.int32)
    lengths[:4] = (0, 1, W * PS, 17)         # inactive, one token, full, ragged
    if quantized:
        pages = _int8_pages(kp, vp, bt, lengths)
    else:
        _poison_dead_tail(kp, vp, bt, lengths)
        pages = (kp, vp)
    q = rng.standard_normal((S, H, DH)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (q, *pages, bt, lengths))


def prefill_inputs(seed, device, quantized=False, c=C):
    """A chunk of ``c`` rows per slot (``C``: prefill; ``SPEC_K``: the
    speculative verify call)."""
    rng = np.random.default_rng(seed)
    kp, vp, bt = _pages(rng)
    starts = rng.integers(0, W * PS - c + 1, S).astype(np.int32)
    n_valid = rng.integers(1, c + 1, S).astype(np.int32)
    n_valid[:3] = (0, c, 1)                  # inactive slot, full, one row
    starts[1] = W * PS - c                   # chunk ending at the last page
    horizon = np.where(n_valid > 0, starts + n_valid, 0)
    if quantized:
        pages = _int8_pages(kp, vp, bt, horizon)
    else:
        _poison_dead_tail(kp, vp, bt, horizon)
        pages = (kp, vp)
    q = rng.standard_normal((S, c, H, DH)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (q, *pages, bt, starts, n_valid))


#: a long, few-slot decode: S_LONG slots of W_LONG pages (4096 tokens
#: each), where each of the 8 warps of the fp decode kernel's (K1) block
#: for a (slot, head) folds 32 of the slot's pages
S_LONG, W_LONG = 2, 256
#: lengths of the two slots, at the edges of that partition (warp w takes
#: pages w, w + 8, ...): every page, half, one token past a page edge,
#: fewer pages than warps, one page per warp and one token more, an
#: inactive slot and a single token. The first pair is the timed one.
LONG_LENGTHS = ((W_LONG * PS, W_LONG * PS // 2), (97 * PS + 1, 17),
                (8 * PS, 8 * PS + 1), (0, 1))


def long_decode_inputs(seed, device, lengths):
    rng = np.random.default_rng(seed)
    kp, vp, bt = _pages(rng, S_LONG, W_LONG)
    lengths = np.asarray(lengths, np.int32)
    _poison_dead_tail(kp, vp, bt, lengths)
    q = rng.standard_normal((S_LONG, H, DH)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (q, kp, vp, bt, lengths))


def _cast(args, dtype):
    """q and fp pages (float tensors of 3 or more dims) to ``dtype``; int8
    pages, their fp32 scale rows (P, ps) and int tensors as they are."""
    return tuple(a.to(dtype) if a.is_floating_point() and a.ndim >= 3 else a
                 for a in args)


class L2Flush:
    """Overwrite a buffer larger than the 50 MB L2 before a timed launch,
    so the kernel finds its inputs in HBM as the serving loop does (12
    layers of weights and K/V pass between two calls of one layer)."""

    def __init__(self, device):
        self.buf = torch.empty(96 << 20, dtype=torch.uint8, device=device)

    def __call__(self):
        self.buf.fill_(1)


#: device clock cycles (~1 ms) the card spins before a launch in the
#: device-only window of :func:`time_ms`
SPIN_CYCLES = 2_000_000


def time_ms(fn, flush, reps):
    """Medians over ``reps`` calls of ``fn()``, each after an L2 flush, of
    two windows taken in turns and of the host's time in the call:

    - ``ms``: CUDA events around the call as the host issues it, so host
      work in the call (checks, tensor maps, the ctypes call, a library's
      own host work) beyond the flush's device time shows up as idle
      device time inside the window. The kernel table's times.
    - ``device_ms``: the same with the card spinning ~1 ms
      (``SPIN_CYCLES``) before the call, so that the host's work hides
      under the spin: device time only.
    - ``host_ms``: the host's time inside ``fn()`` in the second window,
      where the card is still spinning and nothing waits on it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = {"ms": [], "device_ms": [], "host_ms": []}
    for _ in range(reps):
        for spin in (False, True):
            flush()
            if spin:
                torch.cuda._sleep(SPIN_CYCLES)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            fn()
            host = time.perf_counter() - t0
            e1.record()
            e1.synchronize()
            runs["device_ms" if spin else "ms"].append(e0.elapsed_time(e1))
            if spin:
                runs["host_ms"].append(host * 1e3)
    return {k: float(np.median(v)) for k, v in runs.items()}


def _timed(fn, flush, reps, prefix=""):
    """:func:`time_ms` with its keys prefixed (``plain_ms``,
    ``plain_device_ms``, ...); the kernel's own keys unprefixed."""
    return {prefix + k: v for k, v in time_ms(fn, flush, reps).items()}


def _ms_text(r, prefix=""):
    """'a ms (device b, host c)' of one timed call in a row."""
    ms, dev, host = (r[prefix + k] for k in ("ms", "device_ms", "host_ms"))
    return f"{ms:.4f} ms (device {dev:.4f}, host {host:.4f})"


def _bound(nbytes, flops, dtype):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _repeat_and_zeros(entry, args, out, what, blocks=None):
    """A second launch on the same inputs (and launch configuration)
    gives the same bits; a decode kernel's slots of length 0 give exact
    zeros."""
    again = entry.cuda_fn(*args, blocks=blocks)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{what}: two launches on the same inputs "
                             "differ")
    if args[0].ndim == 3:                   # decode: (S, H, Dh), lengths last
        dead = args[-1] == 0
        if not torch.all(out[dead] == 0):
            raise AssertionError(f"{what}: a slot of length 0 is not exact "
                                 "zeros")


def check_candidates(entry, args, ref, what):
    """Every configuration ``entry``'s contract declares on ``args``
    (the phase's inputs: lengths 0, dead tails, NaN-poisoned pages): each
    held to the plain version's ``ref`` at the entry's tolerance, finite,
    bitwise on a repeat launch, exact zeros for a decode slot of length
    0. Returns {configuration: max_abs_err}."""
    from paddle_tpu_torch.kernels.registry import blocks_text
    tol = entry.tolerance[args[0].dtype]
    errs = {}
    for blocks in entry.contract.grid(args):
        text = blocks_text(blocks)
        out = entry.cuda_fn(*args, blocks=blocks)
        torch.cuda.synchronize()
        _repeat_and_zeros(entry, args, out, f"{what}[{text}]", blocks)
        errs[text] = _err(out, ref, tol, f"{what}[{text}] vs plain")
    return errs


def check_kernel(entry, make_inputs, device, flush):
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = _cast(make_inputs(11, device), dtype)
        out = entry.cuda_fn(*args)
        torch.cuda.synchronize()
        _repeat_and_zeros(entry, args, out, f"{entry.name}[{dtype}]")
        # the yardstick: the plain version in fp32 on the same inputs
        ref = entry.plain_fn(*_cast(args, torch.float32))
        atol, rtol = entry.tolerance[dtype]
        got = out.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{entry.name}[{dtype}]: non-finite output "
                                 "(a poisoned page was read)")
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, atol=atol, rtol=rtol):
            raise AssertionError(f"{entry.name}[{dtype}]: max |kernel - plain|"
                                 f" = {err:.3e} > atol {atol} / rtol {rtol}")
        if dtype == torch.float32:
            dense = entry.reference_fn(*args)
            derr = float((got - dense).abs().max())
            if not torch.allclose(got, dense, atol=atol, rtol=rtol):
                raise AssertionError(f"{entry.name}: max |kernel - dense "
                                     f"reference| = {derr:.3e}")
        cands = check_candidates(entry, args, ref,
                                 f"{entry.name}[{dtype}]")
        bound_ms, bound_by = _bound(*entry.work(*args), dtype)
        r = rows[dtype] = {
            "max_abs_err": err,
            **_timed(lambda: entry.cuda_fn(*args), flush, 50),
            **_timed(lambda: entry.plain_fn(*args), flush, 10, "plain_"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "blocks": entry.blocks_for(args),
            "candidates_max_abs_err": max(cands.values()),
        }
        log(f"  {entry.name} [{str(dtype)[6:]}] max_abs_err={err:.3e} "
            f"kernel={_ms_text(r)} plain={_ms_text(r, 'plain_')} "
            f"bound={bound_ms:.4f} ms ({bound_by}); blocks "
            f"{json.dumps(r['blocks'], sort_keys=True)}; {len(cands)} "
            f"configurations within tolerance (max {max(cands.values()):.3e})")
    return rows


def check_long_decode(device, flush):
    """K1 at the long, few-slot shape: every pair of ``LONG_LENGTHS``
    against the plain version (fp32 run) and, in fp32, the dense
    reference, with a repeat launch and exact zeros for length 0; the
    first pair timed. Returns {dtype: row} of the timed pair."""
    from paddle_tpu_torch.serving import paged_attention as PA
    entry = PA.DECODE
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = entry.tolerance[dtype]
        errs = []
        for i, lengths in enumerate(LONG_LENGTHS):
            args = _cast(long_decode_inputs(13 + i, device, lengths), dtype)
            what = f"{entry.name}[long {lengths}][{dtype}]"
            out = entry.cuda_fn(*args)
            torch.cuda.synchronize()
            _repeat_and_zeros(entry, args, out, what)
            got = out.float()
            want = entry.plain_fn(*_cast(args, torch.float32))
            errs.append(_err(got, want, (atol, rtol), what + " vs plain"))
            errs += check_candidates(entry, args, want, what).values()
            if dtype == torch.float32:
                _err(got, entry.reference_fn(*args), (atol, rtol),
                     what + " vs dense")
            if i == 0:
                timed = args
        bound_ms, bound_by = _bound(*entry.work(*timed), dtype)
        r = rows[dtype] = {
            "max_abs_err": max(errs),
            **_timed(lambda: entry.cuda_fn(*timed), flush, 50),
            **_timed(lambda: entry.plain_fn(*timed), flush, 10, "plain_"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "blocks": entry.blocks_for(timed),
        }
        log(f"  {entry.name}[long S={S_LONG} x {W_LONG * PS} tokens] "
            f"[{str(dtype)[6:]}] max_abs_err="
            f"{r['max_abs_err']:.3e} kernel={_ms_text(r)} plain="
            f"{_ms_text(r, 'plain_')} bound={bound_ms:.4f} ms ({bound_by})")
    return rows


#: tensor-parallel ranks whose head slice phase 3 checks: the heads a
#: rank of 4m's tp=2 group and of its tp=4 probe holds
TP_SLICES = (2, 4)
#: the ``ragged_paged_*_tp`` entry points take a mesh only to refuse a
#: call made outside one: this stands for the rank's mesh
TP_ENTRY_MESH = object()


def _head_slice(args, tp):
    """The last of ``tp`` ranks' share of a paged kernel's inputs: its
    ``H/tp`` heads of q and of the K/V pages (contiguous, as its local
    pool is); int8 scale rows, block tables and lengths or chunk
    geometry whole."""
    lo = H - H // tp
    q, kp, vp, *rest = args
    return (q[..., lo:, :].contiguous(), kp[:, :, lo:].contiguous(),
            vp[:, :, lo:].contiguous(), *rest)


def check_head_slices(entry, make_inputs, device, flush):
    """``entry`` on a tp rank's head slice of phase 3's inputs (``H/tp``
    heads for each of ``TP_SLICES``; int8 pages quantized over all ``H``
    heads, as the tp path's MAX all-reduce makes them): the rows of
    :func:`check_kernel`, and the registered ``*_tp`` entry point on the
    slice bitwise equal to the kernel, fp32 and bf16. Returns
    {case: {dtype: row}}."""
    from paddle_tpu_torch.kernels import registry
    tp_entry, = [e for e in registry.composite_entries()
                 if e.inner == (entry.name,)]
    cases = {}
    for tp in TP_SLICES:
        def sliced(seed, dev, tp=tp):
            return _head_slice(make_inputs(seed, dev), tp)
        log(f"  {entry.name} on a tp={tp} rank's {H // tp} heads:")
        cases[f"tp{tp}_heads{H // tp}"] = check_kernel(entry, sliced,
                                                      device, flush)
        for dtype in (torch.float32, torch.bfloat16):
            args = _cast(sliced(11, device), dtype)
            got = tp_entry.fn(*args, mesh=TP_ENTRY_MESH)
            if not torch.equal(got, entry.cuda_fn(*args)):
                raise AssertionError(f"{tp_entry.name}[tp={tp}][{dtype}]: "
                                     "differs from the kernel on the slice")
    return cases


# -- phase 3b: flash attention vs plain versions -------------------------------

#: (name, (B, H, S, Dh), causal, bias: "ragged" key padding, "segments"
#: a packed batch's full segment bias, None no bias)
FLASH_CASES = (
    ("train", (48, 12, 512, 64), False, "ragged"),
    ("causal", (4, 16, 512, 64), True, None),
    ("s320", (8, 12, 320, 64), False, "ragged"),
    ("packed", (16, 16, 256, 64), False, "segments"),
)


def packed_segments(rng, b, s):
    """(B, S) segment ids of packed rows: runs of lognormal(3.0, 0.6)
    lengths (phase 11's pairs) numbered from 1, the rest of a row 0
    (padding)."""
    seg = np.zeros((b, s), np.int32)
    for r in range(b):
        pos, n = 0, 0
        while True:
            ln = int(np.clip(rng.lognormal(3.0, 0.6), 4, s - 1))
            if pos + ln > s - int(rng.integers(0, 24)):
                break
            n += 1
            seg[r, pos:pos + ln] = n
            pos += ln
    return seg


def flash_inputs(shape, lengths, device, seed=5):
    """q, k, v, do (fp32) and a bias: for "ragged" a key-padding bias
    with valid lengths drawn from [S/4, S] and the first set to 0 (a
    fully masked batch row); for "segments" the (B, 1, S, S) segment
    bias of packed rows (:func:`packed_segments`)."""
    b, h, s, d = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen, device=device)
                   for _ in range(4))
    bias = None
    if lengths == "segments":
        from paddle_tpu_torch.ops.sequence import make_segment_attention_bias
        seg = packed_segments(np.random.default_rng(seed), b, s)
        bias = make_segment_attention_bias(torch.from_numpy(seg).to(device))
    elif lengths == "ragged":
        from paddle_tpu_torch.ops.attention import make_padding_bias
        rng = np.random.default_rng(seed)
        n = rng.integers(s // 4, s + 1, b)
        n[0] = 0
        valid = np.arange(s)[None, :] < n[:, None]
        bias = make_padding_bias(torch.from_numpy(valid).to(device))
    return q, k, v, bias, do


def _err(got, want, tol, what):
    atol, rtol = tol
    got = got.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = float((got - want.float()).abs().max())
    if not torch.allclose(got, want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"{what}: max |kernel - reference| = {err:.3e}"
                             f" > atol {atol} / rtol {rtol}")
    return err


def _sdpa_mask(bias, q):
    """SDPA's mask for ``bias``: a key-padding bias as a bool mask; a full
    (.., Sq, Sk) bias as the same float mask in q's dtype."""
    if bias is None:
        return None
    if bias.shape[-2] != 1:
        return bias.to(q.dtype)
    return bias > -1e29


def _library_fwd(q, k, v, bias, causal):
    """One PyTorch call for the same function (timing yardstick only)."""
    import torch.nn.functional as F
    mask = _sdpa_mask(bias, q)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  is_causal=causal)


def _library_bwd(q, k, v, bias, do, causal):
    """SDPA's whole backward (dq, dk, dv) for the same inputs: one
    library time for the K6a + K6b pair."""
    import torch.nn.functional as F
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    mask = _sdpa_mask(bias, q)
    out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                         is_causal=causal)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def check_flash(case, device, flush):
    """K5, K6a and K6b on one case, fp32 and bf16: kernel vs the plain
    version on the same inputs (run in fp32), the fp32 run also vs the
    dense reference (composed attention and its autograd). Returns
    {entry name: {dtype: row}}."""
    from paddle_tpu_torch.ops import attention as FA
    name, shape, causal, lengths = case
    q0, k0, v0, bias, do0 = flash_inputs(shape, lengths, device)
    kw = dict(causal=causal)
    rows = {e.name: {} for e in (FA.FWD, FA.BWD_DKV, FA.BWD_DQ)}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (t.to(dtype) for t in (q0, k0, v0, do0))
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        out, lse = FA.FWD.cuda_fn(q, k, v, bias, **kw)
        torch.cuda.synchronize()
        p_out, p_lse = FA.FWD.plain_fn(q32, k32, v32, bias, **kw)
        alive = p_lse > FA.NEG_INF / 2
        if not torch.all(lse[~alive] <= FA.NEG_INF / 2) or \
                not torch.all(out[~alive] == 0):
            raise AssertionError(f"flash fwd [{name}]: a fully masked row "
                                 "is not 0 with lse ~ NEG_INF")
        errs = {FA.FWD.name: max(
            _err(out, p_out, FA.FWD.tolerance[dtype], f"fwd[{name}] out"),
            _err(lse[alive], p_lse[alive], FA.FWD.tolerance[torch.float32],
                 f"fwd[{name}] lse"))}
        delta = FA.flash_delta(do32, p_out)
        args = (q, k, v, bias, do, p_lse, delta)
        args32 = (q32, k32, v32, bias, do32, p_lse, delta)
        dk, dv = FA.BWD_DKV.cuda_fn(*args, **kw)
        dq = FA.BWD_DQ.cuda_fn(*args, **kw)
        dk2, dv2 = FA.BWD_DKV.cuda_fn(*args, **kw)
        dq2 = FA.BWD_DQ.cuda_fn(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                and torch.equal(dv, dv2)):
            raise AssertionError(f"flash bwd [{name}] [{dtype}]: two launches "
                                 "on the same inputs differ")
        del dk2, dv2, dq2
        p_dk, p_dv = FA.BWD_DKV.plain_fn(*args32, **kw)
        p_dq = FA.BWD_DQ.plain_fn(*args32, **kw)
        tol = FA.BWD_DQ.tolerance[dtype]
        errs[FA.BWD_DKV.name] = max(_err(dk, p_dk, tol, f"dk[{name}]"),
                                    _err(dv, p_dv, tol, f"dv[{name}]"))
        errs[FA.BWD_DQ.name] = _err(dq, p_dq, tol, f"dq[{name}]")
        if dtype == torch.float32:
            r_out, _ = FA.FWD.reference_fn(q, k, v, bias, **kw)
            _err(out, r_out, FA.FWD.tolerance[dtype], f"fwd[{name}] vs dense")
            r_dk, r_dv = FA.BWD_DKV.reference_fn(*args, **kw)
            r_dq = FA.BWD_DQ.reference_fn(*args, **kw)
            for got, want, what in ((dk, r_dk, "dk"), (dv, r_dv, "dv"),
                                    (dq, r_dq, "dq")):
                _err(got, want, tol, f"{what}[{name}] vs dense")
        del out, lse, dk, dv, dq, p_out, p_dk, p_dv, p_dq
        lib_fwd = _timed(_library_fwd(q, k, v, bias, causal), flush, 20,
                         "library_")
        lib_bwd = _timed(_library_bwd(q, k, v, bias, do, causal), flush, 20,
                         "library_")
        for entry, a, a32, lib in (
                (FA.FWD, (q, k, v, bias), (q32, k32, v32, bias), lib_fwd),
                (FA.BWD_DKV, args, args32, lib_bwd),
                (FA.BWD_DQ, args, args32, lib_bwd)):
            nbytes, flops = entry.work(*a, **kw)
            ms_bound, by = _bound(nbytes, flops, dtype)
            r = rows[entry.name][dtype] = {
                "max_abs_err": errs[entry.name],
                **_timed(lambda: entry.cuda_fn(*a, **kw), flush, 20),
                **_timed(lambda: entry.plain_fn(*a32, **kw), flush, 5,
                         "plain_"),
                "bound_ms": ms_bound, "bound_by": by, **lib,
                "blocks": entry.blocks_for(a),
            }
            r["tflops"] = flops / r["ms"] / 1e9
            r["share_of_bound"] = ms_bound / r["ms"]
            log(f"  {entry.name}[{name}] [{str(dtype)[6:]}] max_abs_err="
                f"{r['max_abs_err']:.3e} kernel={_ms_text(r)} plain="
                f"{_ms_text(r, 'plain_')} library={_ms_text(r, 'library_')}"
                f" bound={ms_bound:.4f} ms ({by}) achieved="
                f"{r['tflops']:.1f} TFLOP/s share_of_bound="
                f"{r['share_of_bound']:.3f}")
        pair = [rows[e.name][dtype] for e in (FA.BWD_DKV, FA.BWD_DQ)]
        log(f"  backward pair[{name}] [{str(dtype)[6:]}]: K6a + K6b "
            + " / ".join(f"{sum(r[k] for r in pair):.4f}"
                         for k in ("ms", "device_ms", "host_ms"))
            + " ms (ms / device / host) against SDPA's whole backward "
            + _ms_text(pair[0], "library_"))
        torch.cuda.empty_cache()
    return rows


#: the bf16 tensor-core instances of K5, K6a and K6b
#: (csrc/flash_attention.cu), by mangled name: head dim, and whether the
#: element loop checks a full bias and the causal mask
TC_KERNELS = re.compile(r"(flash_fwd_tc_kernel|flash_bwd_dkv_tc_kernel|"
                        r"flash_bwd_dq_tc_kernel)ILi(\d+)ELb([01])EE")
TC_EXPECTED = tuple(f"{k}<{d}, {c}>"
                    for k in ("flash_bwd_dkv_tc_kernel",
                              "flash_bwd_dq_tc_kernel", "flash_fwd_tc_kernel")
                    for d in (32, 64, 128) for c in ("false", "true"))
#: the tensor-core instances of the paged prefill
#: (csrc/paged_attention.cu): K3 over bf16 pages and K4 over int8 pages
#: (kQuant), NK = ceil(Dh / 16) k-steps of 16 (Dh = 64 is NK = 4), and
#: the warps per block (8 for K3, 4 for K4)
PAGED_TC_KERNELS = re.compile(r"(paged_prefill_tc_kernel)I(a|\w*?bfloat16)"
                              r"Lb[01]ELi(\d+)ELi\d+EE")
PAGED_TC_EXPECTED = tuple(f"paged_prefill_tc_kernel<{kv}, {nk}>"
                          for kv in ("bf16", "int8") for nk in range(1, 9))


def _tc_name(m):
    checks = "true" if m.group(3) == "1" else "false"
    return f"{m.group(1)}<{m.group(2)}, {checks}>"


def _paged_tc_name(m):
    kv = "int8" if m.group(2) == "a" else "bf16"
    return f"{m.group(1)}<{kv}, {m.group(3)}>"


#: per library: its instances' pattern and name, the names expected, the
#: main path's (Dh = 64) instances, and the tensor-core instruction counted
TC_LIBRARIES = (
    ("flash_attention", TC_KERNELS, _tc_name, TC_EXPECTED,
     lambda key: key.split("<")[1].startswith("64,"), "HGMMA"),
    ("paged_attention", PAGED_TC_KERNELS, _paged_tc_name, PAGED_TC_EXPECTED,
     lambda key: key.endswith(", 4>"), "HMMA"),
)


def tensor_core_report(build):
    """The ptxas line (registers, spills) of each tensor-core instance
    (``TC_LIBRARIES``: bf16 K5, K6a, K6b, K3 and K4) from the build logs,
    and, where ``cuobjdump`` is present, the count of its tensor-core
    instructions (HGMMA for wgmma, HMMA for mma.sync) in its SASS. Fails
    unless every expected instance has a ptxas line with a spill count,
    the Dh = 64 instances (the main path) spill nothing, and, with
    ``cuobjdump``, each instance has a count > 0: that shows the tensor
    cores are in use."""
    exe = shutil.which("cuobjdump") or str(
        pathlib.Path(build.nvcc()).parent / "cuobjdump")
    counted = pathlib.Path(exe).is_file()
    reports = {}
    for stem, pattern, name, expected, main_path, instr in TC_LIBRARIES:
        report = {key: {} for key in expected}
        lines = build.build_logs.get(stem, "").splitlines()
        for i, line in enumerate(lines):
            m = pattern.search(line)
            if m is None or "Compiling entry function" not in line:
                continue
            props = [re.sub(r"^ptxas info\s*:\s*", "", x.strip())
                     for x in lines[i + 1:i + 5] if "spill" in x or "Used" in x]
            spills = re.search(r"(\d+) bytes spill stores", " ".join(props))
            report.setdefault(name(m), {}).update(
                ptxas=" | ".join(props),
                spill_store_bytes=int(spills.group(1)) if spills else None)
        if counted:
            sass = subprocess.run(
                [exe, "-sass", str(build.library_path(stem))],
                capture_output=True, text=True, timeout=300, check=True).stdout
            func = None
            for line in sass.splitlines():
                if "Function :" in line:
                    m = pattern.search(line)
                    func = name(m) if m else None
                    if func:
                        report.setdefault(func, {})[instr] = 0
                elif func and any(w.split(".")[0] == instr
                                  for w in line.split()):
                    report[func][instr] += 1
        for key, r in sorted(report.items()):
            log(f"  {key}: {r.get('ptxas', 'no ptxas line')} | {instr} "
                f"{r.get(instr, 'not counted (no cuobjdump)')}")
        if set(report) != set(expected):
            raise AssertionError(f"tensor-core instances {sorted(report)}, "
                                 f"expected {sorted(expected)}")
        for key, r in report.items():
            if r.get("spill_store_bytes") is None:
                raise AssertionError(f"{key}: no ptxas spill count in the "
                                     "build log")
            if main_path(key) and r["spill_store_bytes"]:
                raise AssertionError(f"{key}: spills on the main path: "
                                     f"{r['ptxas']}")
            if counted and not r.get(instr):
                raise AssertionError(f"{key}: no {instr} instruction in its "
                                     "SASS")
        reports[stem] = report
    if not counted:
        log(f"  no cuobjdump at {exe}: tensor-core instructions not counted")
    return reports


# -- phase 3c: the kernel layer -------------------------------------------------

def kernel_layer(device):
    """3c: the parity battery (``kernels.harness.parity_check``) of every
    registered entry on the card under every configuration its contract
    declares, fp32 and bf16; ``KernelTuner.measure`` at the cells' shapes
    (``autotune.CELLS``: phase 3's serving shapes, the verify chunk, the
    2 x 4096 decode, phase 5's flash shape) into a cache in a temporary
    directory, never the committed one, each key's choice printed beside
    the prior's (the configuration the kernels run today) device time; the committed cache's entries for this
    device kind as fresh or stale (a stale one fails); and the registry
    lint, which must give no error."""
    import tempfile
    from paddle_tpu_torch.kernels import autotune, harness, lint, registry
    t0 = time.monotonic()
    parity = {}
    for name in registry.names():
        errs = harness.parity_check(name, 0, device=device)
        legs = [k for k in errs if k.startswith("cuda")]
        parity[name] = {"kernel_legs": len(legs),
                        "max_abs_err": max(errs[k] for k in legs),
                        "plain": errs["plain"]}
    log("  parity: " + json.dumps(parity))
    tuner = autotune.KernelTuner(None)
    tuned = autotune.measure_cells(tuner, device, log=log)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tune.json")
        tuner.save(path)
        if autotune.KernelTuner(path).entries != tuner.entries:
            raise AssertionError("3c: the measured cache does not round-trip")
    kind = autotune.device_kind(device)
    committed = autotune.KernelTuner(autotune.DEFAULT_CACHE_PATH)
    state = committed.report(kind)
    log(f"  committed tune.json for {kind}: {len(state['fresh'])} fresh, "
        f"{len(state['stale'])} stale")
    if state["stale"]:
        raise AssertionError(f"3c: stale committed entries {state['stale']}")
    agree = {r["key"]: committed.entries.get(r["key"], {}).get("blocks")
             == r["blocks"] for r in tuned}
    report = lint.lint_registry(registry_metrics=False)
    log("  " + report.render_text().replace("\n", "\n  "))
    if not report.ok():
        raise AssertionError("3c: the kernel-registry lint has errors")
    seconds = time.monotonic() - t0
    log(f"  phase 3c took {seconds:.1f} s")
    return {"parity": parity, "seconds": seconds,
            "committed": {"fresh": len(state["fresh"]),
                          "stale": len(state["stale"]),
                          "agrees_with_this_run": agree},
            "tuned": {r["key"]: {"blocks": r["blocks"],
                                 "best_ms": r["best_ms"],
                                 "prior": r["prior"],
                                 "prior_ms": r["prior_ms"]}
                      for r in tuned}}


# -- phase 4: the main path ----------------------------------------------------

def model_config():
    from paddle_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(vocab_size=32768, hidden_size=1024, num_layers=12,
                     num_heads=16, ffn_size=4096, max_position=512)


ENGINE_KW = dict(num_slots=16, page_size=16, prefill_chunk=64,
                 max_tokens_per_slot=352)
PROMPT_LENS = (16, 32, 48, 64, 96, 128, 192, 256)


def make_prompts(n, vocab, seed=1234):
    rng = np.random.default_rng(seed)
    lens = rng.choice(PROMPT_LENS, n)
    return [rng.integers(0, vocab, int(k)).astype(np.int32) for k in lens]


def launches_by_chunk(eng, since, entry):
    """``entry``'s launches since the tally ``since`` by the chunk of its
    calls, from the engine's launches per bucket signature (replays and
    eager calls alike): ``spec_k`` for the speculative verify, the
    prefill chunk for prefill and the draft's prefill twin."""
    chunks = collections.Counter()
    for sig, counts in eng.graphs.launches.items():
        n = counts[entry.name] - since.get(sig, {}).get(entry.name, 0)
        if n:
            chunks[eng.spec_k if sig[0] == "verify"
                   else eng.prefill_chunk] += n
    return chunks


def serve(device, kernels, label, profile=False, self_draft=False,
          **engine_kw):
    """One timed serving run of the main path at full width, bf16 weights:
    48 requests x 96 new tokens through ``make_serving_engine``, after
    ``warmup()`` has captured one CUDA graph per bucket signature. Every
    request must finish, every kernel in ``kernels`` must launch in the
    run and the run must capture no graph; ``self_draft`` makes the model
    its own draft; ``profile`` adds the decode profile
    (:func:`profile_decode`) to the stats as ``decode_profile``. The int8
    prefill kernel's calls (K4) are tallied by chunk
    (``int8_prefill_calls_by_chunk``: 64 for prefill, spec_k for the
    speculative verify) from the engine's launches per signature. Returns
    (stats, generated token streams)."""
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import paged_attention as PA
    cfg = model_config()
    model = GPT(cfg, device=device, dtype=torch.bfloat16, seed=0)
    if self_draft:
        engine_kw["draft_model"] = model
    reg = MetricsRegistry()
    eng = make_serving_engine(model, registry=reg, device=device,
                              **ENGINE_KW, **engine_kw)
    t0 = time.monotonic()
    eng.warmup()
    warm_s = time.monotonic() - t0
    graphs = eng.graphs.builds
    prompts = make_prompts(48, cfg.vocab_size)
    registry.reset_launches()               # count only the served run
    since = {sig: dict(c) for sig, c in eng.graphs.launches.items()}
    t0 = time.monotonic()
    rids = [eng.submit(p, 96) for p in prompts]
    done = {}
    while not eng.scheduler.idle():
        done.update(eng.step())
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {e.name: e.launches for e in kernels}
    chunks = launches_by_chunk(eng, since, PA.PREFILL_INT8)
    if sum(chunks.values()) != PA.PREFILL_INT8.launches:
        raise AssertionError(f"int8 prefill calls {dict(chunks)} against "
                             f"{PA.PREFILL_INT8.launches} launches")
    captured = eng.graphs.builds - graphs
    if captured or eng.health()["recompiles"]:
        raise AssertionError(f"{label}: {captured} graphs captured after "
                             "warmup")
    for r in rids:
        toks = done.get(r)
        if toks is None or toks.shape != (96,):
            raise AssertionError(f"request {r} did not finish with 96 tokens")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r} produced an out-of-vocab token")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path ({label})")
    gen = 96 * len(prompts)
    dec_s = reg.histogram("serving_decode_step_seconds").summary()["sum"]
    pre_s = reg.histogram("serving_prefill_step_seconds").summary()["sum"]
    ttft = reg.histogram("serving_ttft_seconds")
    c = eng.cache.config
    stats = {
        "requests": len(prompts), "prompt_tokens": int(sum(map(len, prompts))),
        "generated_tokens": gen, "wall_s": wall, "warmup_s": warm_s,
        "graphs": graphs, "captures_after_warmup": captured,
        "graph_pool_bytes": eng.graphs.pool_bytes(),
        "decode_tokens_per_s": (gen - len(prompts)) / dec_s,
        "prefill_tokens_per_s":
            reg.counter("serving_prefill_tokens_total").value() / pre_s,
        "end_to_end_tokens_per_s": gen / wall,
        "ttft_p50_s": ttft.quantile(0.5), "ttft_p99_s": ttft.quantile(0.99),
        "decode_steps": int(reg.counter("serving_steps_total").value()),
        "cache_dtype": str(c.dtype)[6:],
        "capacity_bytes_per_token":
            eng.cache.capacity_bytes() / ((c.num_pages - 1) * c.page_size),
        "launches": launches,
    }
    if chunks:
        stats["int8_prefill_calls_by_chunk"] = {
            str(c): n for c, n in sorted(chunks.items())}
    if eng.speculative:
        prop = reg.counter("serving_spec_proposed_total").value()
        acc = reg.counter("serving_spec_accepted_total").value()
        stats.update(spec_k=eng.spec_k, proposed=prop, accepted=acc,
                     tokens_per_round=(gen - len(prompts))
                     / stats["decode_steps"])
    log(f"  {label}: " + json.dumps(stats))
    if profile:
        stats["decode_profile"] = profile_decode(eng, cfg.vocab_size,
                                                 keep=("paged_",))
        log(f"  {label} decode profile: "
            + json.dumps(stats["decode_profile"]))
    outs = [done[r] for r in rids]
    del eng, model
    release()
    return stats, outs


def release():
    """Free what deleted engines held: an engine and its graphs refer to
    each other, so only the cycle collector frees them."""
    _FP32_TWINS.clear()
    gc.collect()
    torch.cuda.empty_cache()


def agreement(got, want):
    """How far two sets of token streams agree: identical requests, and
    the mean share of each stream before its first difference."""
    prefix = []
    for a, b in zip(got, want):
        diff = np.nonzero(a != b)[0]
        prefix.append((diff[0] if len(diff) else len(a)) / len(a))
    return {"identical_requests": int(sum(p == 1.0 for p in prefix)),
            "of": len(prefix), "mean_agreeing_prefix": float(np.mean(prefix))}


#: CUDA API calls that launch work (the runtime's ``cuda*`` and the
#: low-level ``cu*`` entry points): one per eagerly dispatched kernel,
#: one per CUDA graph replay
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


def _union_s(intervals) -> float:
    """Seconds covered by the union of ``(start_us, end_us)``
    intervals."""
    total, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total / 1e6


def profile_window(step, reps, keep=()):
    """Where the time of ``reps`` calls of ``step()`` goes: ``reps``
    calls run unprofiled (host clock, synchronised), then ``reps`` more
    under ``torch.profiler``. The device's busy share is read within the
    profiled window alone: the union of its device intervals (kernels
    and copies; overlapping ones count once) over the window's span, from
    its first host or device event to its last, so it is at most 1. The
    profiler's overhead on the host lengthens that span where the host
    holds the device back, so the share is a lower bound there. Returns
    that share, the summed device time by kernel (CUPTI): the top ten,
    and every kernel whose name contains one of ``keep``, and the host's
    launch calls by API (``LAUNCH_APIS``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    kernels = []
    launch_calls = collections.Counter()
    for ev in prof.key_averages():
        if ev.key in LAUNCH_APIS:
            launch_calls[ev.key] += ev.count
        # user annotations (e.g. "Optimizer.step#AdamW.step") are ranges
        # on the device timeline, not kernels: counting them counts the
        # kernels inside them twice
        if not str(ev.device_type).endswith("CUDA") or getattr(
                ev, "is_user_annotation", False):
            continue
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0:
            kernels.append((us, ev.key[:90], ev.count))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels) / 1e6
    spans, device = [], []
    for ev in prof.events():
        spans.append((ev.time_range.start, ev.time_range.end))
        if str(ev.device_type).endswith("CUDA") and not getattr(
                ev, "is_user_annotation", False):
            device.append(spans[-1])
    span = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e6
    union = _union_s(device)
    out = {"unprofiled_wall_s": wall, "device_busy_s": busy,
           "profiled_span_s": span, "device_union_s": union,
           "device_busy_share": union / span,
           "kernel_launches": int(sum(k[2] for k in kernels)),
           "launch_api_calls": dict(launch_calls),
           "top_kernels": [{"name": n, "ms": us / 1e3, "count": c}
                           for us, n, c in kernels[:10]]}
    if keep:
        out["kept_kernels"] = [{"name": n, "ms": us / 1e3, "count": c}
                               for us, n, c in kernels
                               if any(x in n for x in keep)]
    return out


def profile_decode(eng, vocab, blocks=4, keep=()):
    """Where a decode block's time goes, after the measured run: 16 new
    requests are prefilled, then :func:`profile_window` over ``blocks``
    decode blocks of 16 live slots (the two windows differ only by 8
    tokens per block of slot length); ``keep`` as there."""
    for p in make_prompts(16, vocab, seed=7):
        eng.submit(p, 96)         # outlives both windows
    while eng.scheduler.queue or any(
            not eng.scheduler.slots[i].prefill_done
            for i in eng.scheduler.active_slots()):
        eng.step()
    return {"blocks": blocks, "tokens": blocks * eng.decode_block * 16,
            **profile_window(eng.step, blocks, keep=keep)}


def dense_greedy(model, prompt, n):
    ids = torch.from_numpy(prompt.astype(np.int64))[None].to(model.device)
    out = []
    with torch.no_grad():
        for _ in range(n):
            nxt = model(ids)[0, -1].argmax()
            out.append(int(nxt))
            ids = torch.cat([ids, nxt.view(1, 1)], dim=1)
    return np.asarray(out, np.int32)


#: an int8 greedy decision is a near-tie when the top-2 logit gap of its
#: int8 dense recompute is below this share of the logits' standard
#: deviation. Two int8 runs whose fp32 sums differ only in order can round
#: a K/V element to neighbouring int8 values (one quantum, ~1/127 of the
#: token's abs-max), which moves later logits by far more than fp32 noise
#: does; such a flip may change a greedy token only where the decision was
#: this close. The first such divergence on the card had a gap of 4.3e-4.
NEAR_TIE = 1e-2


def _bf16_quantum(x: float) -> float:
    """The spacing of bf16 values around ``x`` (8 significant bits): two
    logits of a bf16 model that close are adjacent bf16 values, ordered
    by the rounding of their last operation."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def _dequantized(t):
    """(1, H, T, Dh) K or V through quantize_kv and back, per token."""
    from paddle_tpu_torch.serving.paged_cache import quantize_kv
    q8, sc = quantize_kv(t.transpose(1, 2), (2, 3))
    return (q8.float() * sc[..., None, None]).transpose(1, 2)


@torch.no_grad()
def dense_logits(model, ids, quantized):
    """Last-position logits of a dense causal recompute of ``ids`` (1, T);
    with ``quantized`` each layer's K and V are stored as an int8 pool
    stores them (the plain int8 path's arithmetic up to summation
    order)."""
    t = ids.shape[1]
    x = model.wte(ids) + model.wpe(torch.arange(t, device=ids.device)[None])
    causal = torch.ones(t, t, dtype=torch.bool, device=ids.device).tril()
    for block in model.blocks:
        q, k, v = block.attn.qkv_heads(block.ln1(x))       # (1, H, T, Dh)
        if quantized:
            k, v = _dequantized(k).to(q.dtype), _dequantized(v).to(q.dtype)
        s = (q @ k.transpose(-1, -2)) / float(q.shape[-1]) ** 0.5
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        x = x + block.attn.proj_out(p @ v)
        x = x + block.mlp(block.ln2(x))
    return model.ln_f(x)[0, -1] @ model.wte.weight.T


_FP32_TWINS = {}
#: the ``bf16_noise`` tie bound in sigmas of a top-2 gap's difference
#: between two bf16 runs (first met on the card: 2.9 sigma, PR 10)
BF16_TIE_SIGMAS = 4


def _bf16_noise(model, ids):
    """RMS over the vocabulary of a bf16 model's last-position logits
    minus those of its fp32 copy on the same context (``ids`` (1, T)):
    how far bf16 rounding moves a logit there."""
    twin = _FP32_TWINS.get(id(model))
    if twin is None:
        twin = _FP32_TWINS[id(model)] = (copy.deepcopy(model).float(),
                                         model)
    d = dense_logits(model, ids, False).float() - dense_logits(
        twin[0], ids, False)
    return float(d.pow(2).mean().sqrt())


def _hold_tokens(model, prompts, got, want, what, quantized=False,
                 allow_ties=False, bf16_noise=False):
    """Tokens identical; with ``allow_ties`` a request may first differ
    only at a near-tie (after which its contexts differ and the rest is
    not compared): a top-2 gap of the dense recompute under ``NEAR_TIE``
    of the logits' standard deviation or, for a bf16 model, of at most
    one bf16 step at the top logit (``_bf16_quantum``: the two are
    adjacent bf16 values). With ``bf16_noise`` (bf16 runs whose requests
    were prefilled in other batches: another GEMM shape rounds the K/V
    otherwise, which moves later logits by more than one step), it is
    also a tie where the two runs' tokens are the recompute's top two and
    their gap is at most 4 sigma of how two bf16 evaluations' top-2 gaps
    differ: ``BF16_TIE_SIGMAS`` x 2 x the rms bf16 rounding noise of a
    logit there (:func:`_bf16_noise`; a logit's noise sigma, twice over
    for two runs and two logits). A failure names the first differing
    position and the top-2 logit gap of the dense recompute on ``want``'s
    context there. Returns the near-ties met."""
    ties = []
    for i, (a, b) in enumerate(zip(got, want)):
        if np.array_equal(a, b):
            continue
        j = int(np.nonzero(a != b)[0][0]) if len(a) == len(b) else \
            min(len(a), len(b))
        ids = np.concatenate([prompts[i], b[:j]]).astype(np.int64)
        logits = dense_logits(model, torch.from_numpy(ids)[None].to(
            model.device), quantized).float()
        top, top_ids = logits.topk(2)
        tie = {"request": i, "position": j,
               "top2_gap": float(top[0] - top[1]),
               "logit_std": float(logits.std())}
        step = 0.0
        if model.wte.weight.dtype == torch.bfloat16:
            step = tie["bf16_step"] = _bf16_quantum(float(top[0]))
            pair = {int(a[j]), int(b[j])} if j < min(len(a), len(b)) \
                else set()
            if bf16_noise and allow_ties and pair == set(top_ids.tolist()):
                tie["bf16_noise_rms"] = _bf16_noise(
                    model, torch.from_numpy(ids)[None].to(model.device))
                step = max(step, BF16_TIE_SIGMAS * 2 * tie["bf16_noise_rms"])
        if not allow_ties or (tie["top2_gap"] >= NEAR_TIE * tie["logit_std"]
                              and tie["top2_gap"] > step):
            raise AssertionError(
                f"{what}: request {i} first differs at generated position "
                f"{j} ({a[j:j + 4]} vs {b[j:j + 4]}); top-2 logit gap there "
                f"{tie['top2_gap']:.3e}, logit std {tie['logit_std']:.3e}"
                + (f", bf16 noise rms {tie['bf16_noise_rms']:.3e}"
                   if "bf16_noise_rms" in tie else ""))
        ties.append(tie)
    return ties


def serve_fp32_parity(device):
    """Phases 4b and 4e: fp32 greedy parity, kernels against plain
    versions, captured graphs against eager dispatch, int8 pools, and
    speculation against plain decoding. Every engine is warmed up first
    and must capture nothing while it serves."""
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import paged_attention as PA
    # fp32 parity leg: TF32 off for matmuls AND cuDNN, stated explicitly
    # (PyTorch's matmul default is already off; cuDNN's is on)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_config()
    model = GPT(cfg, device=device, dtype=torch.float32, seed=0)
    prompts = make_prompts(8, cfg.vocab_size, seed=99)
    fp, q8 = (PA.DECODE, PA.PREFILL), (PA.DECODE_INT8, PA.PREFILL_INT8)

    def run(impl="kernel", launched=(), **kw):
        reg = MetricsRegistry()
        eng = make_serving_engine(model, device=device, attn_impl=impl,
                                  registry=reg, **ENGINE_KW, **kw)
        eng.warmup()
        registry.reset_launches()
        outs = eng.generate_many(prompts, max_new_tokens=32)
        counts = {e.name: e.launches for e in fp + q8}
        want = {e.name for e in launched}
        if any((n > 0) != (name in want) for name, n in counts.items()):
            raise AssertionError(f"fp32 run {impl} {sorted(kw)} launched "
                                 f"{counts}, expected only {sorted(want)}")
        if eng.graphs.builds != len(eng.warmup_plan()):
            raise AssertionError(f"fp32 run {impl} {sorted(kw)} captured "
                                 "graphs after warmup")
        del eng
        release()
        return outs, counts, (
            reg.counter("serving_spec_proposed_total").value(),
            reg.counter("serving_spec_accepted_total").value())

    kern, graphed, _ = run(launched=fp)
    eager, eager_counts, _ = run(launched=fp, cuda_graphs=False)
    _hold_tokens(model, prompts, kern, eager, "4b fp32 graphs vs eager")
    if graphed != eager_counts:
        raise AssertionError(f"4b launches through graphs {graphed} != "
                             f"eager dispatch {eager_counts}")
    log("  4b fp32 graphs vs eager dispatch: identical tokens, launches "
        + json.dumps(graphed))
    plain, _, _ = run("plain")
    _hold_tokens(model, prompts, kern, plain, "4b fp32 kernel vs plain")
    for i in range(2):
        ref = dense_greedy(model, prompts[i], 4)
        if not np.array_equal(kern[i][:4], ref):
            raise AssertionError(f"fp32 request {i}: engine {kern[i][:4]}"
                                 f" != dense GPT.forward {ref}")
    log("  4b fp32 parity: 8 requests x 32 tokens identical through kernels "
        "and plain versions; first 4 tokens of 2 requests match dense "
        "forward")
    k8, _, _ = run(launched=q8, cache_dtype=torch.int8)
    p8, _, _ = run("plain", cache_dtype=torch.int8)
    ties = {"int8_kernel_vs_plain": _hold_tokens(
        model, prompts, k8, p8, "4e int8 kernel vs plain", quantized=True,
        allow_ties=True)}
    s8, _, (prop8, acc8) = run(launched=q8, draft_model=model,
                               cache_dtype=torch.int8)
    ties["int8_self_draft_vs_int8"] = _hold_tokens(
        model, prompts, s8, k8, "4e int8 self-draft vs int8", quantized=True,
        allow_ties=True)
    weak = GPT(dataclasses.replace(cfg, num_layers=2), device=device,
               dtype=torch.float32, seed=1)
    sw, _, (propw, accw) = run(launched=fp, draft_model=weak)
    _hold_tokens(model, prompts, sw, kern, "4e weak draft vs 4b kernel")
    if not accw < propw:
        raise AssertionError(f"weak draft accepted {accw} of {propw}: the "
                             "rollback path did not run")
    stats = {"int8_vs_fp32_kernel": agreement(k8, kern),
             "int8_near_ties": ties,
             "int8_kernel_vs_plain": agreement(k8, p8),
             "int8_self_draft_vs_int8": agreement(s8, k8),
             "self_draft_int8": {"proposed": prop8, "accepted": acc8},
             "weak_draft_fp32": {"proposed": propw, "accepted": accw}}
    log("  4e fp32 parity: int8 kernels == int8 plain versions and int8 "
        "self-draft == int8 decoding up to near-ties, weak-draft "
        "speculation == 4b: " + json.dumps(stats))
    del model, weak
    release()
    return stats


# -- phases 4f-4i: cached dense decoding and KV mobility ----------------------

GEN_BATCH, GEN_PROMPT, GEN_NEW = 16, 128, 128
MIGRATE_REQUESTS, MIGRATE_NEW = 16, 64
#: the spill cell: 4a's engine with the page pool cut to 160 pages, so a
#: wave of 16 requests over 256-token prompts evicts the published pages
#: of an earlier wave sharing a 128-token prefix; the host pool holds 512
#: pages, more than the filler wave spills after them
SPILL_PAGES, HOST_SPILL_PAGES, SPILL_PREFIX = 161, 512, 128


def _events_ms(fn):
    """Device time of ``fn()`` between two CUDA events, synchronised."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


def generate_run(device):
    """4f: ``GPT.generate(use_cache=True)`` dispatched eagerly and
    ``GPT.generate_bucketed`` through its captured decode graph, on 4a's
    GPT in bf16: 16 prompts of 128 tokens, 128 new tokens each. The
    prefill of both attends through K5 (12 launches per prefill); the
    decode steps attend over the whole static cache (composed). Reports
    tokens/s, the prefill's ms (events, median of 3), ms per decode step
    (the rest of the call over its 127 steps), the buckets' builds and
    the captures of a second prompt length in the same bucket (must be
    0); tokens must be in the vocabulary, and the two paths' agreement is
    reported (bf16; the fp32 leg gates equality)."""
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.observability import capture_count
    from paddle_tpu_torch.ops import attention as FA
    cfg = model_config()
    model = GPT(cfg, device=device, dtype=torch.bfloat16, seed=0)
    rng = np.random.default_rng(4321)
    host = rng.integers(0, cfg.vocab_size,
                        (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    prompt = torch.from_numpy(host).to(device)
    model.generate(prompt[:, :16], 2, use_cache=True)   # first launches
    cache = model.init_cache(GEN_BATCH, GEN_PROMPT + GEN_NEW)
    prefill_ms = float(np.median([_events_ms(
        lambda: model.prefill(prompt, cache)) for _ in range(3)]))
    del cache
    registry.reset_launches()
    t0 = time.monotonic()
    cached = model.generate(prompt, GEN_NEW, use_cache=True)
    torch.cuda.synchronize()
    cached_s = time.monotonic() - t0
    k5_cached = FA.FWD.launches
    caps = capture_count()
    t0 = time.monotonic()
    model.generate_bucketed(host, GEN_NEW)
    torch.cuda.synchronize()
    first_s = time.monotonic() - t0
    builds = capture_count() - caps
    t0 = time.monotonic()
    bucketed = model.generate_bucketed(host, GEN_NEW)
    torch.cuda.synchronize()
    bucketed_s = time.monotonic() - t0
    caps = capture_count()
    model.generate_bucketed(host[:, :100], GEN_NEW)     # same (128, 128)
    second = capture_count() - caps
    k5 = FA.FWD.launches
    if k5_cached != cfg.num_layers or k5 != 4 * cfg.num_layers:
        raise AssertionError(f"4f: K5 launched {k5_cached} times in one "
                             f"cached generate and {k5} in all, expected "
                             f"{cfg.num_layers} per prefill")
    if builds != 1 or second != 0:
        raise AssertionError(f"4f: {builds} builds for the first bucketed "
                             f"call, {second} for a second prompt length "
                             "in the same bucket")
    for name, ids in (("cached", cached), ("bucketed", bucketed)):
        ids = ids.cpu().numpy()
        if ids.shape != (GEN_BATCH, GEN_PROMPT + GEN_NEW) or not (
                (ids >= 0) & (ids < cfg.vocab_size)).all():
            raise AssertionError(f"4f: {name} ids {ids.shape} out of range")
        if not np.array_equal(ids[:, :GEN_PROMPT], host):
            raise AssertionError(f"4f: {name} lost the prompt")
    gen = GEN_BATCH * GEN_NEW
    stats = {
        "batch": GEN_BATCH, "prompt": GEN_PROMPT, "new": GEN_NEW,
        "cached_tokens_per_s": gen / cached_s,
        "bucketed_tokens_per_s": gen / bucketed_s,
        "prefill_ms": prefill_ms,
        "cached_ms_per_decode_step":
            (cached_s * 1e3 - prefill_ms) / (GEN_NEW - 1),
        "bucketed_ms_per_decode_step":
            (bucketed_s * 1e3 - prefill_ms) / (GEN_NEW - 1),
        "bucketed_first_call_s": first_s, "bucket_builds": builds,
        "captures_second_length": second, "k5_launches": k5,
        "k5_launches_per_prefill": k5_cached,
        "cached_vs_bucketed": agreement(
            list(bucketed.cpu().numpy()[:, GEN_PROMPT:]),
            list(cached.cpu().numpy()[:, GEN_PROMPT:])),
    }
    log("  4f generate: " + json.dumps(stats))
    del model
    release()
    return stats


def _engine(model, device, **kw):
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.observability import MetricsRegistry
    eng = make_serving_engine(model, registry=MetricsRegistry(),
                              device=device, **{**ENGINE_KW, **kw})
    eng.warmup()
    return eng


def _no_captures(label, *engines):
    for eng in engines:
        if eng.graphs.builds != len(eng.warmup_plan()) or \
                eng.health()["recompiles"]:
            raise AssertionError(
                f"{label}: {eng.tier} engine captured "
                f"{eng.graphs.builds - len(eng.warmup_plan())} graphs "
                "after warmup")


def _slot_of(eng, rid):
    return next(i for i in eng.scheduler.active_slots()
                if eng.scheduler.slots[i].request.rid == rid)


def _to_mid_decode(eng, prompts, new, blocks=2):
    """Submit ``prompts`` and step until every request has decoded
    ``blocks`` blocks (none finished). Returns the rids."""
    rids = [eng.submit(p, new) for p in prompts]
    while True:
        eng.step()
        sts = [eng.scheduler.slots[i] for i in eng.scheduler.active_slots()]
        if len(sts) == len(rids) and all(
                s.prefill_done and eng._phase_acc[s.request.rid][
                    "decode_blocks"] >= blocks for s in sts):
            break
    if any(s.finished() for s in sts):
        raise AssertionError("a request finished before the migration")
    return rids


def _check_restored(eng, restored, label):
    """Every restored page, read back through ``("page_read",)``, hashes
    to its manifest entry."""
    pages = 0
    for rid, snap in restored:
        slot = _slot_of(eng, rid)
        n = len(snap["shards"]) // eng._tp_shards
        got = [eng._shard_digest(sh) for p in
               eng._read_pages(eng.cache.block_tables[slot, :n])
               for sh in eng._shards(p)]
        if got != [r["sha256"] for r in snap["manifest"]]:
            raise AssertionError(f"{label}: a restored page of request "
                                 f"{rid} does not hash to its manifest")
        pages += n
    return pages


def page_io_profile(eng, pids):
    """The page IO of pages ``pids`` split by stage, each timed on its
    own: device read (``("page_read",)`` replays, events), device to host
    (copies of the static output into pinned memory, events), sha256 (host
    clock), host to device (pinned copies of each page's own bytes,
    events) and device write (``("page_write",)`` replays of those bytes
    into the same pages, events). Returns ms per page and GB/s per
    stage."""
    from paddle_tpu_torch.serving.engine import _bits, _host_array
    n = len(pids)
    out = None

    def reads():
        nonlocal out
        for pid in pids:
            out = eng.graphs.run(("page_read",), {"src": int(pid)})

    read_ms = _events_ms(reads)
    outs = tuple(_bits(t) for t in (out if isinstance(out, tuple)
                                    else (out,)))
    nbytes = sum(t.numel() * t.element_size() for t in outs)
    hosts = [tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                   for t in outs) for _ in pids]
    d2h_ms = _events_ms(lambda: [h.copy_(t, non_blocking=True)
                                 for hs in hosts for h, t in zip(hs, outs)])
    payloads = eng._read_pages(pids)
    t0 = time.perf_counter()
    for p in payloads:
        eng._shard_digest(eng._shards(p)[0])
    hash_ms = (time.perf_counter() - t0) * 1e3
    for hs, p in zip(hosts, payloads):
        for h, a in zip(hs, p):
            _host_array(h)[...] = a
    devs = [tuple(torch.empty_like(t) for t in outs) for _ in pids]
    h2d_ms = _events_ms(lambda: [d.copy_(h, non_blocking=True)
                                 for ds, hs in zip(devs, hosts)
                                 for d, h in zip(ds, hs)])
    dtype = eng.cache.config.dtype

    def writes():
        for pid, ds in zip(pids, devs):
            feeds = dict(zip(("kv", "sc"), ds))
            feeds["kv"] = feeds["kv"].view(dtype)
            eng.graphs.run(("page_write",), {"dst": int(pid)}, feeds)

    write_ms = _events_ms(writes)
    stages = (("read", read_ms), ("d2h", d2h_ms), ("hash", hash_ms),
              ("h2d", h2d_ms), ("write", write_ms))
    return {"pages": n, "page_bytes": nbytes,
            "ms_per_page": {k: ms / n for k, ms in stages},
            "gb_per_s": {k: nbytes * n / (ms * 1e6) for k, ms in stages}}


def migration_run(device, label, **engine_kw):
    """4g: 16 requests of 4a's prompt mix (64 new tokens) on engine A;
    after every request has decoded 2 blocks, every live slot is
    snapshotted and released on A and restored on a warmed engine B,
    which finishes them. Gates: each restored page re-read through
    ``("page_read",)`` hashes to its manifest entry; tokens agree with an
    unmigrated run (on B, before) by 4e's ``NEAR_TIE`` rule; A and B
    capture nothing after warmup. Reports snapshot and restore ms per slot
    and the page-IO split of the longest slot's pages
    (:func:`page_io_profile`)."""
    from paddle_tpu_torch.models.gpt import GPT
    cfg = model_config()
    model = GPT(cfg, device=device, dtype=torch.bfloat16, seed=0)
    prompts = make_prompts(MIGRATE_REQUESTS, cfg.vocab_size)
    a = _engine(model, device, **engine_kw)
    b = _engine(model, device, **engine_kw)
    want = b.generate_many(prompts, MIGRATE_NEW)
    rids = _to_mid_decode(a, prompts, MIGRATE_NEW)
    snap_s, restore_s, restored, moved = [], [], [], {}
    for rid in rids:
        slot = _slot_of(a, rid)
        t0 = time.monotonic()
        snap = a.snapshot_slot(slot)
        snap_s.append(time.monotonic() - t0)
        a.release_slot(slot)
        t0 = time.monotonic()
        new = b.restore_slot(snap)
        restore_s.append(time.monotonic() - t0)
        restored.append((new, snap))
        moved[rid] = new
    pages = _check_restored(b, restored, label)
    longest = max(restored, key=lambda r: len(r[1]["shards"]))
    io = page_io_profile(b, b.cache.block_tables[
        _slot_of(b, longest[0]), :len(longest[1]["shards"])])
    done = {}
    while not b.scheduler.idle():
        done.update(b.step())
    got = [done[moved[r]] for r in rids]
    quantized = b.quantized
    ties = _hold_tokens(model, prompts, got, want, label,
                        quantized=quantized, allow_ties=True)
    _no_captures(label, a, b)
    shard_bytes = sum(r["bytes"] for _, s in restored for r in s["manifest"])
    stats = {"requests": len(rids), "pages": pages,
             "bytes": shard_bytes,
             "snapshot_ms_per_slot": float(np.mean(snap_s)) * 1e3,
             "restore_ms_per_slot": float(np.mean(restore_s)) * 1e3,
             "snapshot_gb_per_s": shard_bytes / sum(snap_s) / 1e9,
             "restore_gb_per_s": shard_bytes / sum(restore_s) / 1e9,
             "page_io": io, "near_ties": ties,
             "agreement": agreement(got, want),
             "captures_after_warmup": 0}
    log(f"  {label}: " + json.dumps(stats))
    del a, b, model
    release()
    return stats


def _disagg_drive(pre, dec, prompts, new):
    """The two-tier serving loop: step the prefill engine when no handoff
    waits, restore waiting handoffs on the decode engine while it has a
    free slot and the pages (a refused restore decodes in place on the
    prefill engine), step the decode engine. Returns (tokens per prompt,
    decode-side request stats, bytes handed over, fallbacks)."""
    from collections import deque

    from paddle_tpu_torch.serving import SlotMigrationError
    owner = {("p", pre.submit(p, new)): i for i, p in enumerate(prompts)}
    pending, out, stats = deque(), {}, []
    nbytes = fallbacks = 0
    while owner:
        if not pending:
            for rid, toks in pre.step().items():
                out[owner.pop(("p", rid))] = toks
            pending.extend(pre.poll_handoffs())
        while pending and dec.scheduler.free_slots():
            rid, snap = pending.popleft()
            i = owner.pop(("p", rid))
            nbytes += sum(r["bytes"] for r in snap["manifest"])
            try:
                owner[("d", dec.restore_slot(snap))] = i
            except SlotMigrationError:
                snap["decode_in_place"] = True
                owner[("p", pre.restore_slot(snap))] = i
                fallbacks += 1
        for rid, toks in dec.step().items():
            out[owner.pop(("d", rid))] = toks
            stats.append(dec.request_stats(rid))
    return [out[i] for i in range(len(prompts))], stats, nbytes, fallbacks


def disagg_run(device, colocated_outs):
    """4h: a prefill-tier and a decode-tier engine at 4a's configuration on
    one card serve 4a's 48 requests (96 new tokens) through
    :func:`_disagg_drive`. Reports decode tokens/s (the decode engine's
    decode tokens over its decode-block seconds), TTFT p50/p99 (first
    tokens come from the prefill engine), handoff latency p50/p99
    (``decode_start_s - handoff_s``, the wait for a decode slot
    included), bytes handed over and each tier's signature count. Gates:
    tokens agree with 4a's colocated run by the ``NEAR_TIE`` rule, and
    neither engine captures after warmup."""
    from paddle_tpu_torch.models.gpt import GPT
    cfg = model_config()
    model = GPT(cfg, device=device, dtype=torch.bfloat16, seed=0)
    prompts = make_prompts(48, cfg.vocab_size)
    pre = _engine(model, device, tier="prefill")
    dec = _engine(model, device, tier="decode")
    t0 = time.monotonic()
    outs, rstats, nbytes, fallbacks = _disagg_drive(pre, dec, prompts, 96)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    ties = _hold_tokens(model, prompts, outs, colocated_outs,
                        "4h disaggregated vs 4a colocated", allow_ties=True)
    _no_captures("4h", pre, dec)
    reg_d, reg_p = dec._reg, pre._reg
    handoff = np.asarray([s["decode_start_s"] - s["handoff_s"]
                          for s in rstats])
    ttft = reg_p.histogram("serving_ttft_seconds")
    stats = {
        "requests": len(prompts), "wall_s": wall, "fallbacks": fallbacks,
        "decode_tokens_per_s":
            reg_d.counter("serving_tokens_total").value()
            / reg_d.histogram("serving_decode_step_seconds").summary()["sum"],
        "ttft_p50_s": ttft.quantile(0.5), "ttft_p99_s": ttft.quantile(0.99),
        "handoff_p50_s": float(np.quantile(handoff, 0.5)),
        "handoff_p99_s": float(np.quantile(handoff, 0.99)),
        "handoff_bytes": nbytes,
        "signatures": {"prefill": len(pre.warmup_plan()),
                       "decode": len(dec.warmup_plan())},
        "captures_after_warmup": 0, "near_ties": ties,
        "agreement": agreement(outs, colocated_outs)}
    log("  4h disaggregated: " + json.dumps(stats))
    del pre, dec, model
    release()
    return stats


def prefix_waves(vocab, seed=5, n=16, prefix_len=SPILL_PREFIX, unique=32,
                 filler_len=256):
    """Two waves of ``n`` prompts sharing one ``prefix_len``-token prefix
    (each with ``unique`` tokens of its own) and, between them, a wave of
    ``n`` unrelated ``filler_len``-token prompts."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len).astype(np.int32)

    def wave():
        return [np.concatenate([prefix, rng.integers(0, vocab, unique)
                                .astype(np.int32)]) for _ in range(n)]

    first = wave()
    filler = [rng.integers(0, vocab, filler_len).astype(np.int32)
              for _ in range(n)]
    return first, filler, wave()


def spill_exchange_run(device):
    """4i: 4a's engine with the page pool cut to 160 pages and a host pool
    of 512 pages serves a wave sharing a 128-token prefix, a filler wave
    that evicts the published pages (they spill), and a second wave on the
    prefix (they are restored); then the first engine exports the
    prefix's 8 pages and a fresh engine imports them and serves the
    second wave's first 4 prompts on them. Reports pages and bytes
    spilled and restored, restore GB/s (the admission restores, host
    clock), exported and imported pages with their ms; gates: pages
    spilled and restored, the import installs all 8 and the importer's
    prefill skips them, no capture after warmup."""
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.serving import prompt_prefix_digests
    cfg = model_config()
    model = GPT(cfg, device=device, dtype=torch.bfloat16, seed=0)
    first, filler, second = prefix_waves(cfg.vocab_size)
    eng = _engine(model, device, num_pages=SPILL_PAGES,
                  host_spill_pages=HOST_SPILL_PAGES)
    restores = []
    restore = eng._restore_spilled

    def timed_restore(prompt, rid):
        t0 = time.monotonic()
        n = restore(prompt, rid)
        if n:
            restores.append(time.monotonic() - t0)
        return n

    eng._restore_spilled = timed_restore
    eng.generate_many(first, 32)
    eng.generate_many(filler, 32)
    outs = eng.generate_many(second, 32)
    pool = eng.cache.spill_pool
    if not (pool.spilled_total and pool.restored_total):
        raise AssertionError(f"4i: spilled {pool.spilled_total}, restored "
                             f"{pool.restored_total} pages")
    digests = prompt_prefix_digests(second[0], eng.cache.config.page_size)[
        :SPILL_PREFIX // eng.cache.config.page_size]
    t0 = time.monotonic()
    bundle = eng.export_prefix_pages(digests)
    export_s = time.monotonic() - t0
    other = _engine(model, device)
    t0 = time.monotonic()
    imported = other.import_prefix_pages(bundle)
    import_s = time.monotonic() - t0
    got = other.generate_many(second[:4], 32)
    shared = other._reg.counter("serving_prefix_shared_tokens_total").value()
    if imported != len(digests) or shared < 4 * SPILL_PREFIX:
        raise AssertionError(f"4i: imported {imported} of {len(digests)} "
                             f"pages, {shared} prompt tokens shared")
    _no_captures("4i", eng, other)
    stats = {"spilled_pages": pool.spilled_total,
             "spilled_bytes": pool.spilled_bytes_total,
             "restored_pages": pool.restored_total,
             "restored_bytes": pool.restored_bytes_total,
             "restore_gb_per_s": pool.restored_bytes_total
             / sum(restores) / 1e9,
             "exported_pages": len(bundle["pages"]),
             "exported_bytes": bundle["bytes"],
             "export_ms": export_s * 1e3, "imported_pages": imported,
             "import_ms": import_s * 1e3, "shared_tokens": shared,
             "imported_vs_local": agreement(got, outs[:4]),
             "captures_after_warmup": 0}
    log("  4i spill and exchange: " + json.dumps(stats))
    del eng, other, model
    release()
    return stats


def mobility_fp32_parity(device):
    """4j: fp32 (TF32 off), full width, 2 layers, 8 of 4b's requests x 32
    new tokens; every gate is exact token equality. ``generate`` cached ==
    uncached == ``generate_bucketed`` == the serving engine's greedy
    tokens; migrated mid-decode == unmigrated (restored pages hash to
    their manifest); disaggregated == colocated; spill on == spill off
    over prefix waves; a prompt served on imported prefix pages == the
    same prompt prefilled fresh. No engine captures after warmup."""
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.serving import prompt_prefix_digests
    cfg = dataclasses.replace(model_config(), num_layers=2)
    model = GPT(cfg, device=device, dtype=torch.float32, seed=0)
    prompts = make_prompts(8, cfg.vocab_size, seed=99)
    eng = _engine(model, device)
    base = eng.generate_many(prompts, 32)
    del eng
    gen = {}
    for name, fn in (
            ("cached", lambda p: model.generate(
                torch.from_numpy(p[None]).to(device), 32, use_cache=True)),
            ("uncached", lambda p: model.generate(
                torch.from_numpy(p[None]).to(device), 32)),
            ("bucketed", lambda p: model.generate_bucketed(p[None], 32))):
        gen[name] = [fn(p)[0, len(p):].cpu().numpy() for p in prompts]
        _hold_tokens(model, prompts, gen[name], base,
                     f"4j fp32 generate {name} vs the serving engine")
    a, b = _engine(model, device), _engine(model, device)
    rids = _to_mid_decode(a, prompts, 32)
    restored = []
    for rid in rids:
        slot = _slot_of(a, rid)
        snap = a.snapshot_slot(slot)
        a.release_slot(slot)
        restored.append((b.restore_slot(snap), snap))
    _check_restored(b, restored, "4j fp32 migration")
    done = {}
    while not b.scheduler.idle():
        done.update(b.step())
    _hold_tokens(model, prompts, [done[r] for r, _ in restored], base,
                 "4j fp32 migrated vs unmigrated")
    _no_captures("4j migration", a, b)
    pre = _engine(model, device, tier="prefill")
    dec = _engine(model, device, tier="decode")
    outs, _, _, _ = _disagg_drive(pre, dec, prompts, 32)
    _hold_tokens(model, prompts, outs, base,
                 "4j fp32 disaggregated vs colocated")
    _no_captures("4j disaggregated", pre, dec)
    del a, b, pre, dec
    release()
    waves = prefix_waves(cfg.vocab_size, seed=6)
    runs = {}
    for spill in (0, HOST_SPILL_PAGES):
        eng = _engine(model, device, num_pages=SPILL_PAGES,
                      host_spill_pages=spill)
        runs[spill] = [eng.generate_many(w, 16) for w in waves]
        _no_captures("4j spill", eng)
    pool = eng.cache.spill_pool
    if not (pool.spilled_total and pool.restored_total):
        raise AssertionError("4j: the spill schedule spilled "
                             f"{pool.spilled_total}, restored "
                             f"{pool.restored_total} pages")
    for w, on, off in zip(waves, runs[HOST_SPILL_PAGES], runs[0]):
        _hold_tokens(model, w, on, off, "4j fp32 spill on vs off")
    first, _, second = waves
    src = _engine(model, device)
    src.generate_many(first[:1], 16)
    bundle = src.export_prefix_pages(prompt_prefix_digests(
        first[0], src.cache.config.page_size)[:SPILL_PREFIX // 16])
    dst, fresh = _engine(model, device), _engine(model, device)
    if dst.import_prefix_pages(bundle) != SPILL_PREFIX // 16:
        raise AssertionError("4j: the import installed too few pages")
    imported = dst.generate_many(second[:4], 16)
    _hold_tokens(model, second[:4], imported,
                 fresh.generate_many(second[:4], 16),
                 "4j fp32 imported prefix vs fresh prefill")
    _no_captures("4j exchange", src, dst, fresh)
    log("  4j fp32 parity: generate cached == uncached == bucketed == the "
        "serving engine; migrated == unmigrated; disaggregated == "
        "colocated; spill on (spilled "
        f"{pool.spilled_total}, restored {pool.restored_total} pages) == "
        "off; imported prefix == fresh prefill (exact tokens)")
    del src, dst, fresh, eng, model
    release()


# -- phases 4k-4l: the serving fleet ------------------------------------------

#: a replica as the reference's router bench configures one on its chip
#: (bench.py:868-876): 8 slots, pages of 16, chunk 64, 64 new tokens
#: after prompts of up to 192
FLEET_KW = dict(num_slots=8, page_size=16, prefill_chunk=64,
                max_tokens_per_slot=256, decode_block=8)
FLEET_REQUESTS, FLEET_NEW = 48, 64
FLEET_LENS = (16, 32, 64, 128, 192)
FLEET_SYSTEM = 4 * 16 + 2                       # 4 pages and 2 tokens
NET_REQUESTS = 16


def fleet_prompts(rng, vocab, n=FLEET_REQUESTS):
    """``n`` fresh prompts with the bench's length mix."""
    return [rng.integers(1, vocab, int(k)).astype(np.int32)
            for k in rng.choice(FLEET_LENS, n)]


def _fleet_replica(model, device, name, warm=True, **kw):
    """A ``LocalReplica`` over a fresh engine of ``model``, warmed
    unless ``warm`` is false."""
    from paddle_tpu_torch.observability import MetricsRegistry, Tracer
    from paddle_tpu_torch.serving import fleet
    from paddle_tpu_torch.serving.engine import ServingEngine
    eng = ServingEngine(model, device=device, registry=MetricsRegistry(),
                        tracer=Tracer(enabled=False), ttft_budget_s=1.0,
                        **{**FLEET_KW, **kw})
    rep = fleet.LocalReplica(eng, name=name)
    return rep.warmup() if warm else rep


def _fleet_no_captures(label, reps):
    """Each replica's engine built exactly its warmup plan. (Its
    ``health()["recompiles"]`` is the process-wide build count, as the
    reference's detector counts the process's compiles: another
    replica's warmup shows there.)"""
    for rep in reps:
        eng = rep.engine
        extra = eng.graphs.builds - len(eng.warmup_plan())
        if extra:
            raise AssertionError(f"{label}: {rep.name} captured {extra} "
                                 "graphs after warmup")


def _reset_replica(rep):
    """Drop what an ejected replica's engine still holds (its requests
    were redriven elsewhere), so the engine serves again."""
    eng = rep.engine
    eng.cancel_queued()
    for slot in list(eng.scheduler.active_slots()):
        eng.release_slot(slot)
    eng._results.clear()
    eng._stats.clear()
    rep.draining = False


def _burst(router, prompts, new=FLEET_NEW):
    """Submit everything, step to idle; returns (tokens per prompt,
    wall seconds, TTFTs)."""
    for rep in router.replicas:
        rep.busy_s = 0.0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    frids = [router.submit(p, new) for p in prompts]
    done = router.run_until_idle(max_steps=1_000_000)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    outs = [done.get(f) for f in frids]
    if any(o is None or len(o) != new for o in outs):
        raise AssertionError("a fleet burst lost a request")
    ttft = [router.request_stats(f)["ttft_s"] for f in frids]
    return outs, wall, ttft


def _redrive_points(tracer):
    """Fleet rid -> tokens observed at its last cold redrive, from the
    router's spans."""
    spans = sorted(tracer.spans(), key=lambda s: s.start)
    tid = {s.attrs["fleet_rid"]: s.trace_id for s in spans
           if s.name == "router.route"}
    last = {s.trace_id: int(s.attrs["tokens_observed"]) for s in spans
            if s.name == "router.redrive" and s.attrs.get("mode") == "cold"}
    return {f: last[t] for f, t in tid.items() if t in last}


def _hold_redriven(model, eng, prompts, got, want, points, label):
    """``_hold_tokens`` for a fleet run with cold redrives (``points``:
    request index -> tokens observed when it was resubmitted). A cold
    redrive resubmits ``prompt + observed``, whose K/V the peer's prefill
    recomputes: in bf16 their bits differ from the decode's, so past the
    redrive a greedy decision can part from the undisturbed run's where
    the two runs' logits are a few bf16 steps apart. So a redriven
    request's first ``k`` tokens are held to the undisturbed run, and
    the rest to ``eng``'s failure-free greedy continuation of the same
    resubmitted prompt (what the redrive runs), each by the near-tie
    rule; the others to the undisturbed run. Returns the near-ties."""
    plain = [i for i in range(len(got)) if i not in points]
    ties = _hold_tokens(model, [prompts[i] for i in plain],
                        [got[i] for i in plain], [want[i] for i in plain],
                        label, allow_ties=True, bf16_noise=True)
    for i, k in sorted(points.items()):
        ties += _hold_tokens(model, [prompts[i]], [got[i][:k]],
                             [want[i][:k]], f"{label} (observed prefix)",
                             allow_ties=True, bf16_noise=True)
        ctx = np.concatenate([prompts[i], got[i][:k]]).astype(np.int32)
        cont = eng.generate_many([ctx], len(got[i]) - k)[0]
        ties += _hold_tokens(model, [ctx], [got[i][k:]], [cont],
                             f"{label} (continuation of a cold redrive)",
                             allow_ties=True, bf16_noise=True)
    return ties


def _q(xs, q):
    return float(np.quantile(np.asarray(xs), q))


def _harvest(router, frids, timeout_s=300.0):
    """Results of threaded replicas: each request's tokens from its
    replica's result store (the replicas step on their own threads)."""
    out, deadline = {}, time.monotonic() + timeout_s
    while len(out) < len(frids):
        for f in frids:
            if f not in out:
                rep, lrid = router._where[f]
                toks = rep.result(lrid)
                if toks is not None:
                    out[f] = (toks, rep.request_stats(lrid), rep.name)
        for rep in router.replicas:
            if rep.failed:
                raise AssertionError(f"4k threaded: {rep.name} failed: "
                                     f"{rep.last_error}")
        if time.monotonic() > deadline:
            raise AssertionError(f"4k threaded: {len(out)} of {len(frids)}"
                                 " requests finished in time")
        time.sleep(0.002)
    return [out[f] for f in frids]


def fleet_run(device):
    """4k: four ``LocalReplica``s over one bf16 GPT at full width on one
    card, all warmed before any leg, behind a ``FleetRouter`` driven on
    the host's thread (the reference router bench's legs,
    ``bench.py:855-1190``, at its chip settings): (i) 1, 2 and 4
    replicas under affinity routing on fresh prompts; (ii) 48 requests
    sharing a 66-token system prompt under affinity and round robin;
    (iii) ``drain_replica`` of a replica holding mid-decode slots; (iv)
    a crash (``crash_on_step=6``) and a flaky transport
    (``submit_failures=2``) under a ``FaultPolicy``; (v) four fresh
    replicas, built and warmed under the lock sanitizer
    (``analysis.concurrency.sanitize``), on their own threads
    (``start()``) while the autoscaler spawns a fifth and warms it on this
    thread: no double-acquire, and every acquisition edge the sanitizer
    observed lies in the committed ``lock_order.json``; (vi) two int8-pool
    replicas. Gates:
    every request finishes or is shed with a registered reason; no
    replica captures after warmup; drained, redriven and threaded tokens
    equal the undisturbed runs' up to a bf16 near-tie; K1 and K3 launch
    in (i)-(v), K2 and K4 in (vi); a replica that served has flops
    headroom below 1. Returns the stats (``launches`` by kernel)."""
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.observability import MetricsRegistry, Tracer
    from paddle_tpu_torch.serving import REJECT_REASONS
    from paddle_tpu_torch.serving import fleet
    from paddle_tpu_torch.serving import paged_attention as PA
    cfg = model_config()
    model = GPT(cfg, device=device, dtype=torch.bfloat16, seed=0)
    rng = np.random.default_rng(0)
    lens = rng.choice(FLEET_LENS, FLEET_REQUESTS)

    def fresh():
        return [rng.integers(1, cfg.vocab_size, int(k)).astype(np.int32)
                for k in lens]

    t0 = time.monotonic()
    reps = [_fleet_replica(model, device, f"replica{i}") for i in range(4)]
    warm_s = time.monotonic() - t0
    stats = {"replicas": 4, "warmup_s_4_replicas": warm_s,
             "signatures": len(reps[0].engine.warmup_plan())}
    registry.reset_launches()

    # (i) scaling
    scaling, runs = {}, {}
    for n in (1, 2, 4):
        prompts = fresh()
        router = fleet.FleetRouter(reps[:n], registry=MetricsRegistry(),
                                   seed=n)
        outs, wall, ttft = _burst(router, prompts)
        runs[n] = (prompts, outs)
        tokens = FLEET_REQUESTS * FLEET_NEW
        scaling[str(n)] = {
            "tokens_per_s": tokens / wall,
            "critical_path_tokens_per_s":
                tokens / max(r.busy_s for r in reps[:n]),
            "ttft_p50_s": _q(ttft, 0.5), "ttft_p99_s": _q(ttft, 0.99)}
    stats["scaling"] = scaling
    stats["aggregate_tokens_per_s"] = scaling["4"]["tokens_per_s"]
    log("  4k (i) scaling: " + json.dumps(scaling))

    # (ii) affinity against round robin over a shared system prompt
    affinity = {}
    for policy in ("affinity", "round_robin"):
        sysp = rng.integers(1, cfg.vocab_size, FLEET_SYSTEM).astype(np.int32)

        def shared():
            return np.concatenate([sysp, rng.integers(
                1, cfg.vocab_size, FLEET_LENS[0]).astype(np.int32)])

        def saved():
            return sum(r.engine._reg.counter(
                "serving_prefix_shared_tokens_total").value()
                for r in reps[:2])

        before = saved()
        router = fleet.FleetRouter(reps[:2], policy=policy,
                                   registry=MetricsRegistry(), seed=9)
        router.submit(shared(), 8)
        router.run_until_idle(max_steps=1_000_000)
        for _ in range(FLEET_REQUESTS):
            router.submit(shared(), 8)
        router.run_until_idle(max_steps=1_000_000)
        affinity[policy] = {
            "routed_affinity_total": router.routed_affinity_total,
            "routed_balance_total": router.routed_balance_total,
            "prefix_tokens_shared": int(saved() - before)}
    if affinity["affinity"]["routed_affinity_total"] < FLEET_REQUESTS:
        raise AssertionError(f"4k affinity: {affinity}")
    stats["affinity"] = affinity
    log("  4k (ii) affinity vs round robin: " + json.dumps(affinity))

    # (iii) drain: live migration of a replica's mid-decode slots
    prompts = fresh()[:FLEET_KW["num_slots"]]
    ref, _, _ = _burst(fleet.FleetRouter(reps[:2],
                                         registry=MetricsRegistry(),
                                         seed=13), prompts)
    router = fleet.FleetRouter(reps[:2], registry=MetricsRegistry(),
                               seed=13)
    frids = [router.submit(p, FLEET_NEW) for p in prompts]
    eng1, done = reps[1].engine, {}
    for _ in range(1000):
        done.update(router.step())
        if any(0 < len(eng1.scheduler.slots[i].generated) < FLEET_NEW
               for i in eng1.scheduler.decode_slots()):
            break
    else:
        raise AssertionError("4k drain: no mid-decode window")
    t0 = time.monotonic()
    migrated = router.drain_replica(reps[1], remove=False)
    drain_s = time.monotonic() - t0
    done.update(router.run_until_idle(max_steps=1_000_000))
    reps[1].draining = False
    if not migrated:
        raise AssertionError("4k drain migrated no slot")
    ties = _hold_tokens(model, prompts, [done[f] for f in frids], ref,
                        "4k drained vs undrained", allow_ties=True)
    stats["drain"] = {"migrations": migrated,
                      "ms_per_migrated_slot": drain_s / migrated * 1e3,
                      "near_ties": ties}
    log("  4k (iii) drain: " + json.dumps(stats["drain"]))

    # (iv) chaos: a crash and a flaky transport
    prompts = fresh()
    ref, _, _ = _burst(fleet.FleetRouter(reps, registry=MetricsRegistry(),
                                         seed=17), prompts)
    crash = fleet.ChaosReplica(reps[1], crash_on_step=6)
    flaky = fleet.ChaosReplica(reps[2], submit_failures=2)
    policy = fleet.FaultPolicy(max_consecutive_failures=6,
                               probe_timeout_s=120.0, breaker_threshold=2,
                               breaker_cooldown_s=0.2, max_redrives=4)
    reg, tracer = MetricsRegistry(), Tracer()
    router = fleet.FleetRouter([reps[0], crash, flaky, reps[3]],
                               registry=reg, tracer=tracer, seed=17,
                               faults=policy)
    tiny = [rng.integers(1, cfg.vocab_size, FLEET_LENS[0]).astype(np.int32)
            for _ in range(64)]
    pre = []
    for p in tiny:
        pre.append(router.submit(p, 4))
        if (flaky.name, "closed", "open") in router.breaker_transitions:
            break
    frids = [router.submit(p, FLEET_NEW) for p in prompts]
    done = router.run_until_idle(max_steps=1_000_000)
    time.sleep(policy.breaker_cooldown_s + 0.05)
    probes = [router.submit(p, 4) for p in tiny[:2]]
    done.update(router.run_until_idle(max_steps=1_000_000))
    sheds = collections.Counter()
    for f in pre + frids + probes:
        if f in done:
            continue
        rej = router.reject_reason(f)
        if rej is None or rej.reason not in REJECT_REASONS:
            raise AssertionError(f"4k chaos: request {f} lost ({rej})")
        sheds[rej.reason] += 1
    kept = [i for i, f in enumerate(frids) if f in done]
    at = _redrive_points(tracer)
    points = {j: at[frids[i]] for j, i in enumerate(kept)
              if frids[i] in at}
    ties = _hold_redriven(model, reps[0].engine,
                          [prompts[i] for i in kept],
                          [done[frids[i]] for i in kept],
                          [ref[i] for i in kept], points,
                          "4k redriven vs clean")
    if router.ejected_total != 1 or not router.redrives_total:
        raise AssertionError(f"4k chaos: {router.ejected_total} ejected, "
                             f"{router.redrives_total} redriven")
    stats["chaos"] = {
        "ejected": router.ejected_total, "redrives": router.redrives_total,
        "redrives_by_mode": {m: reg.counter("fleet_redrive_total").value(
            mode=m) for m in ("cold", "warm", "observed")},
        "sheds_by_reason": dict(sheds), "finished": len(kept),
        "cold_redriven_requests": len(points),
        "agreement_with_clean": agreement(
            [done[frids[i]] for i in kept], [ref[i] for i in kept]),
        "breaker_transitions": [f"{n}:{a}->{b}" for n, a, b
                                in router.breaker_transitions],
        "near_ties": ties}
    log("  4k (iv) chaos: " + json.dumps(stats["chaos"]))
    _reset_replica(reps[1])
    _fleet_no_captures("4k (i)-(iv)", reps)

    # (v) threaded replicas while the autoscaler warms a fifth, every lock
    # of the leg made under the sanitizer
    from paddle_tpu_torch.analysis import concurrency
    names = [r.name for r in reps]
    del reps
    release()
    spawned = []

    def spawn(i):
        spawned.append(_fleet_replica(model, device, f"auto{i}",
                                      warm=False))
        return spawned[-1]
    # the first wave is 4k (i)'s 4-replica prompts and 16 of its
    # 2-replica ones, the second 16 more of those: tokens are known
    (p4, want4), (p2, want2) = runs[4], runs[2]
    prompts, want = p4 + p2[:32], want4 + want2[:32]
    with concurrency.sanitize(register_metrics=False) as mon:
        reps = [_fleet_replica(model, device, n) for n in names]
        scaler = fleet.FleetAutoscaler(spawn, min_replicas=5,
                                       max_replicas=5,
                                       registry=MetricsRegistry())
        router = fleet.FleetRouter(reps, policy="p2c", seed=21,
                                   registry=MetricsRegistry(),
                                   autoscaler=scaler)
        for rep in reps:
            rep.start()
        try:
            frids = [router.submit(p, FLEET_NEW) for p in prompts[:64]]
            steps = sum(r.steps for r in reps)
            t0 = time.monotonic()
            action = scaler.tick()        # spawn + warmup on this thread
            spawn_s = time.monotonic() - t0
            steps = sum(r.steps for r in reps) - steps
            if action != "replace" or len(router.replicas) != 5:
                raise AssertionError(f"4k threaded: autoscaler {action}, "
                                     f"{len(router.replicas)} replicas")
            if not steps:
                raise AssertionError("4k threaded: no replica stepped "
                                     "while the fifth captured its graphs")
            spawned[0].start()
            frids += [router.submit(p, FLEET_NEW) for p in prompts[64:]]
            got = _harvest(router, frids)
        finally:
            for rep in reps + spawned:
                rep.stop()
    violations = mon.check(concurrency.load_lock_order(
        concurrency.LOCK_ORDER_PATH))
    sanitized = {"locks_created": mon.locks_created,
                 "acquisitions": mon.acquisitions,
                 "edges": {f"{a} -> {b}": n
                           for (a, b), n in sorted(mon.edges.items())},
                 "hold_while_blocking": len(mon.blocked),
                 "double_acquires": len(mon.double_acquires),
                 "violations": [f.message for f in violations]}
    log("  4k (v) sanitizer: " + json.dumps(sanitized))
    if violations or mon.double_acquires:
        raise AssertionError(f"4k threaded: sanitizer {sanitized}")
    ties = _hold_tokens(model, prompts, [g[0] for g in got], want,
                        "4k threaded vs synchronous", allow_ties=True,
                        bf16_noise=True)
    served = collections.Counter(g[2] for g in got)
    if not served[spawned[0].name]:
        raise AssertionError("4k threaded: the spawned replica served "
                             "nothing")
    _fleet_no_captures("4k threaded", reps + spawned)
    stats["threaded"] = {
        "requests": len(got), "spawn_warmup_s": spawn_s,
        "replica_steps_during_spawn": steps,
        "served_by": dict(served),
        "ttft_p99_s": _q([g[1]["ttft_s"] for g in got], 0.99),
        "near_ties": ties, "sanitizer": sanitized}
    log("  4k (v) threaded + autoscaled: " + json.dumps(stats["threaded"]))
    launches = {e.name: e.launches for e in (PA.DECODE, PA.PREFILL)}
    if min(launches.values()) <= 0:
        raise AssertionError(f"4k: fp kernels launched {launches}")
    heads = [r.health()["headroom"]["flops"] for r in reps + spawned]
    if not max(heads) < 1.0:
        raise AssertionError(f"4k: flops headroom {heads}")
    stats["flops_headroom"] = heads
    del reps, spawned, router, scaler
    release()

    # (vi) int8 pools
    registry.reset_launches()
    q8 = [_fleet_replica(model, device, f"int8_{i}", cache_dtype=torch.int8)
          for i in range(2)]
    outs, wall, ttft = _burst(fleet.FleetRouter(
        q8, registry=MetricsRegistry(), seed=23), fresh())
    _fleet_no_captures("4k int8", q8)
    for name, n in ((e.name, e.launches) for e in (PA.DECODE_INT8,
                                                   PA.PREFILL_INT8)):
        if n <= 0:
            raise AssertionError(f"4k int8: {name} never launched")
        launches[name] = n
    stats["int8"] = {"tokens_per_s": FLEET_REQUESTS * FLEET_NEW / wall,
                     "ttft_p99_s": _q(ttft, 0.99)}
    stats["launches"] = launches
    log("  4k (vi) int8: " + json.dumps(stats["int8"]))
    log("  4k launches: " + json.dumps(launches))
    del q8, model
    release()
    return stats


def _net_config():
    """4a's GPT as ``--config`` JSON for ``GPTConfig.tiny``."""
    cfg = model_config()
    return dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                ffn_size=cfg.ffn_size, max_position=cfg.max_position,
                dtype="bfloat16")


def _spawn_servers(names, device):
    """Spawn one replica server per name on ``device``, all at once
    (each process builds its model and warms its engine there)."""
    import threading

    from paddle_tpu_torch.serving.fleet import net
    out, errors = {}, []

    def one(name):
        try:
            out[name] = net.spawn_replica_server(
                config=_net_config(), engine=FLEET_KW, seed=0, name=name,
                device=str(device), startup_timeout_s=300.0)
        except Exception as e:          # re-raised below, on this thread
            errors.append(e)
    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    return threads, out, errors


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def net_run(device):
    """4l: replica servers as real processes on the card
    (``spawn_replica_server``, 4k's replica configuration and seed)
    beside one in-process ``LocalReplica``. The same 16 requests (64 new
    tokens) through the local replica alone, through one server alone,
    and streamed by a ``FrontDoor`` over the two to 16
    ``FrontDoorClient``s; then a second server ``kill -9``'d mid-decode
    and redriven, and SIGTERM to the first with work in flight. Gates:
    the servers hold the in-process model's weights (sha256); every run's
    tokens equal the local run's up to a bf16 near-tie; each stream
    delivers at least 2 partials; the netlog validates; the killed
    server is ejected and its requests redriven; the drained server
    exits with ``EXIT_DRAINED``. The server-alone router is
    ``inference.make_net_serving_fleet`` over the first server's address.
    Reports the codec, RPC counts, the transport's overhead in ms per
    token and the streams' TTFT."""
    import signal
    import threading

    from paddle_tpu_torch.inference import make_net_serving_fleet
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.observability import MetricsRegistry, Tracer
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.resilience.preempt import EXIT_DRAINED
    from paddle_tpu_torch.resilience.retry import RetryPolicy
    from paddle_tpu_torch.serving import fleet
    from paddle_tpu_torch.serving.fleet import net
    from paddle_tpu_torch.serving.fleet.net.replica_server import \
        weights_digest
    t_spawn = time.monotonic()
    threads, servers, errors = _spawn_servers(("net_a", "net_b"), device)
    cfg = model_config()
    model = GPT(cfg, device=device, dtype=torch.bfloat16, seed=0)
    local = _fleet_replica(model, device, "local")
    digest = weights_digest(model)
    registry.reset_launches()
    for t in threads:
        t.join()
    procs = [servers[n][0] for n in servers]
    try:
        if errors:
            raise errors[0]
        spawn_s = time.monotonic() - t_spawn
        net_router = make_net_serving_fleet([servers["net_a"][1]],
                                            registry=MetricsRegistry(),
                                            call_timeout_s=300.0)
        net_a, = net_router.replicas
        # the killed server's redials give up fast
        net_b = net.NetReplica(servers["net_b"][1], name="net_b",
                               call_timeout_s=300.0, retry=RetryPolicy(
                                   max_attempts=2, base_delay_s=0.02,
                                   max_delay_s=0.1, deadline_s=2.0))
        if {net_a.remote_weights, net_b.remote_weights} != {digest}:
            raise AssertionError("4l: a server's weights differ from the "
                                 "in-process model's")
        prompts = fleet_prompts(np.random.default_rng(3), cfg.vocab_size,
                                NET_REQUESTS)
        tokens = NET_REQUESTS * FLEET_NEW
        want, local_s, _ = _burst(fleet.FleetRouter(
            [local], registry=MetricsRegistry()), prompts)
        calls0 = net_a.calls_total
        got, net_s, _ = _burst(net_router, prompts)
        ties = _hold_tokens(model, prompts, got, want, "4l server vs local",
                            allow_ties=True, bf16_noise=True)
        rpcs = net_a.calls_total - calls0
        # streamed through the front door over the server and the local
        netlog = pathlib.Path("build") / "chip_smoke_4l.netlog.jsonl"
        netlog.parent.mkdir(exist_ok=True)
        netlog.unlink(missing_ok=True)
        door = net.FrontDoor(fleet.FleetRouter(
            [net_a, local], registry=MetricsRegistry(), seed=5),
            netlog_path=str(netlog)).start()
        streams = [None] * NET_REQUESTS

        def client(i):
            cli = net.FrontDoorClient(door.address)
            try:
                streams[i] = cli.generate(prompts[i], FLEET_NEW,
                                          tag=f"s{i}", timeout_s=300.0)
            finally:
                cli.close()
        t0 = time.monotonic()
        workers = [threading.Thread(target=client, args=(i,))
                   for i in range(NET_REQUESTS)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        stream_s = time.monotonic() - t0
        door.close()
        if any(s is None or s["reject"] is not None for s in streams):
            raise AssertionError("4l: a stream was lost or rejected")
        if min(s["partials"] for s in streams) < 2:
            raise AssertionError("4l: a stream arrived in one piece")
        ties += _hold_tokens(model, prompts,
                             [np.asarray(s["tokens"], np.int32)
                              for s in streams], want,
                             "4l streamed vs local", allow_ties=True,
                             bf16_noise=True)
        summary = net.validate_netlog_file(str(netlog),
                                           require_requests=NET_REQUESTS)
        # kill -9 of the second server mid-decode
        policy = fleet.FaultPolicy(max_consecutive_failures=3,
                                   probe_timeout_s=120.0,
                                   breaker_threshold=2,
                                   breaker_cooldown_s=0.2, max_redrives=3)
        tracer = Tracer()
        router = fleet.FleetRouter([net_b, local], seed=11, faults=policy,
                                   registry=MetricsRegistry(),
                                   tracer=tracer)
        sub = prompts[:8]
        frids = [router.submit(p, FLEET_NEW) for p in sub]
        victims = [f for f in frids if router._where[f][0] is net_b]
        if not victims:
            raise AssertionError("4l: nothing routed to the second server")
        done = {}
        for _ in range(1000):
            done.update(router.step())
            if any(router.progress(f) for f in victims if f not in done):
                break
        proc_b = servers["net_b"][0]
        os.kill(proc_b.pid, signal.SIGKILL)
        proc_b.wait(timeout=60)
        done.update(router.run_until_idle(max_steps=1_000_000))
        if any(f not in done for f in frids) or not router.ejected_total:
            raise AssertionError("4l kill -9: requests lost or no eject")
        at = _redrive_points(tracer)
        ties += _hold_redriven(model, local.engine, sub,
                               [done[f] for f in frids], want[:8],
                               {i: at[f] for i, f in enumerate(frids)
                                if f in at}, "4l redriven vs local")
        # SIGTERM with work in flight: drain, then exit EXIT_DRAINED
        proc_a = servers["net_a"][0]
        rids = [net_a.submit(p, FLEET_NEW) for p in prompts[:2]]
        proc_a.send_signal(signal.SIGTERM)
        deadline, drained = time.monotonic() + 120, {}
        while not net_a.draining and time.monotonic() < deadline:
            net_a.health()
        while len(drained) < len(rids) and time.monotonic() < deadline:
            drained.update(net_a.step())
        net_a.close()
        net_b.close()
        rc = proc_a.wait(timeout=120)
        if rc != EXIT_DRAINED or len(drained) != len(rids):
            raise AssertionError(f"4l SIGTERM: exit {rc}, "
                                 f"{len(drained)} of {len(rids)} finished")
        _fleet_no_captures("4l", [local])
        launches = registry.launch_counts()
    finally:
        _stop(procs)
    ttft = [s["ttft_s"] for s in streams]
    stats = {
        "servers_spawn_s": spawn_s, "codec": net_a.codec,
        "rpc_calls_total": rpcs, "local_tokens_per_s": tokens / local_s,
        "net_tokens_per_s": tokens / net_s,
        "transport_overhead_ms_per_token": (net_s - local_s) / tokens * 1e3,
        "stream_tokens_per_s": tokens / stream_s,
        "stream_ttft_p50_s": _q(ttft, 0.5),
        "stream_ttft_p99_s": _q(ttft, 0.99),
        "partials_min": min(s["partials"] for s in streams),
        "netlog": summary, "ejected": router.ejected_total,
        "redrives": router.redrives_total, "sigterm_exit": rc,
        "local_launches": {k: v for k, v in launches.items() if v},
        "near_ties": ties}
    log("  4l network: " + json.dumps(stats))
    del local, model
    release()
    return stats


def _to_mid_decode_fleet(router, rep, new=32):
    """Step the fleet until ``rep`` holds a request mid-decode; returns
    what finished meanwhile."""
    eng, done = rep.engine, {}
    for _ in range(1000):
        done.update(router.step())
        if any(0 < len(eng.scheduler.slots[i].generated) < new
               for i in eng.scheduler.decode_slots()):
            return done
    raise AssertionError(f"{rep.name} never held a request mid-decode")


def fleet_fp32_parity(device):
    """4j's fleet legs (fp32, TF32 off, 2 layers at full width, exact
    tokens): a 2-replica fleet under affinity routing == one engine;
    ``drain_replica`` mid-decode == undrained; a crashed replica's
    requests redriven == failure-free; a request through ``NetReplica``
    (an in-thread ``ReplicaServer``) == one through ``LocalReplica``."""
    import threading

    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import fleet
    from paddle_tpu_torch.serving.fleet import net
    cfg = dataclasses.replace(model_config(), num_layers=2)
    model = GPT(cfg, device=device, dtype=torch.float32, seed=0)
    prompts = make_prompts(8, cfg.vocab_size, seed=99)
    base = _engine(model, device).generate_many(prompts, 32)
    release()

    def pair():
        return [fleet.LocalReplica(_engine(model, device), name=f"r{i}")
                for i in range(2)]

    reps = pair()
    router = fleet.FleetRouter(reps, registry=MetricsRegistry(), seed=3)
    frids = [router.submit(p, 32) for p in prompts]
    done = router.run_until_idle(max_steps=100_000)
    _hold_tokens(model, prompts, [done[f] for f in frids], base,
                 "4j fp32 fleet vs one engine")
    frids = [router.submit(p, 32) for p in prompts]
    done = _to_mid_decode_fleet(router, reps[1])
    if not router.drain_replica(reps[1]):
        raise AssertionError("4j: the drain migrated nothing")
    done.update(router.run_until_idle(max_steps=100_000))
    _hold_tokens(model, prompts, [done[f] for f in frids], base,
                 "4j fp32 drained vs undrained")
    _fleet_no_captures("4j fleet", reps)
    del reps, router
    release()
    reps = pair()
    chaos = fleet.ChaosReplica(reps[1])
    router = fleet.FleetRouter([reps[0], chaos], registry=MetricsRegistry(),
                               seed=3, faults=fleet.FaultPolicy(
                                   max_consecutive_failures=1,
                                   probe_timeout_s=120.0))
    frids = [router.submit(p, 32) for p in prompts]
    done = _to_mid_decode_fleet(router, reps[1])
    chaos.dead = True
    done.update(router.run_until_idle(max_steps=100_000))
    if router.ejected_total != 1 or not router.redrives_total:
        raise AssertionError("4j: the crash was not ejected and redriven")
    _hold_tokens(model, prompts, [done[f] for f in frids], base,
                 "4j fp32 redriven vs failure-free")
    srv = net.ReplicaServer(reps[0].engine, name="inthread")
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            srv.serve_step(0.01)
    loop = threading.Thread(target=serve)
    loop.start()
    try:
        rep = net.NetReplica(srv.address, name="inthread")
        rids = [rep.submit(p, 32) for p in prompts]
        out = {}
        while len(out) < len(rids):
            out.update(rep.step())
        rep.close()
    finally:
        stop.set()
        loop.join()
        srv.close()
    _hold_tokens(model, prompts, [out[r] for r in rids], base,
                 "4j fp32 NetReplica vs LocalReplica")
    log("  4j fp32 fleet: routed == one engine; drained == undrained; "
        "redriven == failure-free; NetReplica == LocalReplica (exact "
        "tokens)")
    del reps, router, srv, model
    release()


# -- phase 4m: tensor parallelism ---------------------------------------------

#: 4m (i): requests and new tokens of each leg of the tp=2 group
TP_REQUESTS, TP_NEW = 16, 64
#: a rank group's process-group timeout and the parent's wait for it (s)
GROUP_TIMEOUT_S, GROUP_WAIT_S = 300, 900


def _tp_legs(rank, n, device, dims):
    """4m (i) on one rank of the tp=2 group: the bf16 and int8 legs at 4a's
    width and the fp32 2-layer leg, each an engine over the group's mesh
    (eager: collectives are not captured) with the collective probe
    every 8 decode rounds. Rank 0 serves ``TP_REQUESTS`` requests and
    closes the engine; rank 1 follows it. Every rank returns its K1-K4
    launches, its all-reduces by site and its forwards through the
    layers (calls of each decode or prefill signature, its eager build
    included, times the decode block for decode)."""
    from paddle_tpu_torch.core import mesh as mesh_lib
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import paged_attention as PA
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(tp=n),
                              device_type=device.type)
    cfg = GPTConfig(**dims)
    legs = (("bf16", cfg, torch.bfloat16, None),
            ("int8", cfg, torch.bfloat16, torch.int8),
            ("fp32_2layer", dataclasses.replace(cfg, num_layers=2),
             torch.float32, None))
    out = {}
    for name, c, dtype, cache_dtype in legs:
        model = GPT(c, device=device, dtype=dtype, seed=0)
        reg = MetricsRegistry()
        eng = make_serving_engine(model, device=device, registry=reg,
                                  mesh=mesh, cuda_graphs=False,
                                  cache_dtype=cache_dtype,
                                  anatomy_probe_every=8, **ENGINE_KW)
        registry.reset_launches()
        leg = {}
        if rank == 0:
            prompts = make_prompts(TP_REQUESTS, c.vocab_size, seed=21)
            t0 = time.monotonic()
            outs = eng.generate_many(prompts, TP_NEW)
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.monotonic() - t0
            eng.close()
            gen = TP_NEW * len(prompts)
            summary = eng.anatomy.summary()
            leg.update(
                tokens=[o.tolist() for o in outs], wall_s=wall,
                tokens_per_s_gloo_one_card_not_a_tp_speed=gen / wall,
                decode_steps=int(reg.counter("serving_steps_total").value()),
                health={k: eng.health()[k]
                        for k in ("tp", "mesh_devices", "tp_probe")},
                collective_probe_samples=summary["probe_samples"],
                collective_exposed_s=summary.get("collective_exposed_s"),
                collective_exposed_frac=summary.get(
                    "collective_exposed_frac"))
        else:
            eng.follow()
        built = eng.graphs.signatures()
        leg["forwards"] = sum(
            (n + (sig in built)) * (eng.decode_block if sig[0] == "decode"
                                     else 1)
            for sig, n in collections.Counter(
                {**{b: 0 for b in built}, **eng.graphs.calls}).items()
            if sig[0] in ("decode", "prefill"))
        leg["layers"] = c.num_layers
        leg["all_reduces"] = dict(eng.tp_all_reduces)
        # K1-K4 launches by signature: the tp path's, and rank 0's
        # collective probe twin's (("decode_probe", w)) apart; together
        # every launch the counters saw
        paged = (PA.DECODE, PA.PREFILL, PA.DECODE_INT8, PA.PREFILL_INT8)
        by_sig = eng.graphs.launches
        leg["launches"] = {e.name: sum(n[e.name] for sig, n in by_sig.items()
                                       if sig[0] != "decode_probe")
                           for e in paged}
        leg["launches_probe"] = {
            e.name: sum(n[e.name] for sig, n in by_sig.items()
                        if sig[0] == "decode_probe") for e in paged}
        leg["launches_counted"] = {e.name: e.launches for e in paged}
        out[name] = leg
        del eng, model
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _group_rank(rank, n, port, results, device, legs, leg_kw):
    """Process entry of one rank of a group (4m, phase 8): join the gloo
    group over ``tcp://127.0.0.1:port`` with a timeout, TF32 off, run
    ``legs`` (names in :data:`GROUP_LEGS`, each with its keywords from
    ``leg_kw``) in order and put ``(rank, "ok", {leg: result})`` (each
    with its seconds) or ``(rank, "err", traceback)`` on ``results``; a
    failure also exits non-zero."""
    import datetime
    import traceback

    import torch.distributed as dist
    try:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        from paddle_tpu_torch.kernels import registry
        registry.load_all()
        out = {}
        for leg in legs:
            t0 = time.monotonic()
            out[leg] = GROUP_LEGS[leg](rank, n, device,
                                       **leg_kw.get(leg, {}))
            out[leg]["seconds"] = time.monotonic() - t0
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "err", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def group_run(n, legs, device, label, **leg_kw):
    """``legs`` on a gloo group of ``n`` processes on ``device``
    (:func:`_group_rank`), each loading the kernels phase 2 built. Either
    rank failing or exiting non-zero fails the run. Returns the ranks'
    ``{leg: result}`` in rank order."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_group_rank,
                         args=(r, n, port, results, str(device), legs,
                               leg_kw))
             for r in range(n)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in procs:
            rank, status, val = results.get(timeout=GROUP_WAIT_S)
            (got.__setitem__(rank, val) if status == "ok"
             else errors.append(f"rank {rank}:\n{val}"))
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if errors or codes != [0] * n:
        raise AssertionError(f"{label} failed (exit codes {codes}):\n"
                             + "\n".join(errors))
    return [got[r] for r in range(n)]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tp_group_run(device, dims=None):
    """4m (i): the tp=2 group, two processes on ``device`` over gloo
    (:func:`group_run`), each building K1-K4 from the cache phase 2 left.
    Either rank failing or exiting non-zero fails the run. Then the tp=1
    references in this process on the same weights and prompts: bf16 and
    int8 tokens held with ``_hold_tokens`` (bf16 noise and near-tie
    rules, as 4k), the fp32 2-layer tokens exact up to a near-tie
    (counted). Both ranks must launch K1 and K3 (bf16, fp32) and K2 and
    K4 (int8), as many times on each rank outside rank 0's collective
    probe twin (whose launches are counted apart, and with the tp path's
    make up each rank's counters), and issue one attention-output
    all-reduce per layer per forward (one per layer more for an int8
    pool's K and V abs-max). Returns the legs' stats."""
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import paged_attention as PA
    dims = dims or dataclasses.asdict(model_config())
    got = [r["tp_serve"] for r in group_run(
        2, ("tp_serve",), device, "4m tp group", tp_serve={"dims": dims})]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**dims)
    wanted = {"bf16": (PA.DECODE, PA.PREFILL),
              "int8": (PA.DECODE_INT8, PA.PREFILL_INT8),
              "fp32_2layer": (PA.DECODE, PA.PREFILL)}
    stats = {}
    for name, (c, dtype, cache_dtype) in {
            "bf16": (cfg, torch.bfloat16, None),
            "int8": (cfg, torch.bfloat16, torch.int8),
            "fp32_2layer": (dataclasses.replace(cfg, num_layers=2),
                            torch.float32, None)}.items():
        leg0, leg1 = got[0][name], got[1][name]
        if leg0["launches"] != leg1["launches"] or leg1["launches_probe"] \
                != dict.fromkeys(leg1["launches_probe"], 0):
            raise AssertionError(
                f"4m {name}: the ranks' tp-path launches differ (rank 0 "
                f"{leg0['launches']}, rank 1 {leg1['launches']}, rank 1's "
                f"probe {leg1['launches_probe']})")
        for rank, leg in ((0, leg0), (1, leg1)):
            whole = {k: leg["launches"][k] + leg["launches_probe"][k]
                     for k in leg["launches"]}
            if whole != leg["launches_counted"]:
                raise AssertionError(
                    f"4m {name}: rank {rank}'s launches by signature "
                    f"{whole} are not its counters' "
                    f"{leg['launches_counted']}")
            for e in wanted[name]:
                if leg["launches"][e.name] <= 0:
                    raise AssertionError(f"4m {name}: rank {rank} never "
                                         f"launched {e.name}")
            per = leg["all_reduces"].get("attn_out", 0) / (
                leg["layers"] * leg["forwards"])
            amax = leg["all_reduces"].get("kv_amax", 0) / (
                leg["layers"] * leg["forwards"])
            if per != 1 or amax != (1 if cache_dtype else 0):
                raise AssertionError(
                    f"4m {name}: rank {rank} all-reduces {leg['all_reduces']}"
                    f" over {leg['forwards']} forwards of {leg['layers']} "
                    "layers")
        model = GPT(c, device=device, dtype=dtype, seed=0)
        prompts = make_prompts(TP_REQUESTS, c.vocab_size, seed=21)
        eng = make_serving_engine(model, device=device,
                                  cache_dtype=cache_dtype,
                                  registry=MetricsRegistry(), **ENGINE_KW)
        want = eng.generate_many(prompts, TP_NEW)
        got_toks = [np.asarray(t, np.int32) for t in leg0["tokens"]]
        bf16 = dtype == torch.bfloat16
        ties = _hold_tokens(model, prompts, got_toks, want,
                            f"4m {name} tp=2 vs tp=1",
                            quantized=cache_dtype is not None,
                            allow_ties=True, bf16_noise=bf16)
        stats[name] = {k: v for k, v in leg0.items()
                       if k not in ("tokens", "launches", "launches_probe",
                                    "launches_counted")}
        stats[name].update(
            launches_rank0=leg0["launches"], launches_rank1=leg1["launches"],
            launches_probe_rank0=leg0["launches_probe"],
            all_reduces_per_layer_forward=1, near_ties=len(ties),
            ties=ties, agreement=agreement(got_toks, want))
        log(f"  4m (i) {name} tp=2 group (gloo on one card, not a tp "
            "speed): " + json.dumps(stats[name]))
        del eng, model
        release()
    return stats

# -- phases 5 and 6: BERT-base pretraining ------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 48, 512
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 3, 20, 3


def bert_batch(cfg, b, s, device, seed=0):
    """Feeds as bench.py makes them, from numpy with a seed, except that
    each sequence gets a valid length drawn from [s/4, s], so the
    key-padding bias does real work."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(s // 4, s + 1, b)
    feeds = dict(
        input_ids=rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        token_type_ids=np.zeros((b, s), np.int32),
        attention_mask=np.arange(s)[None, :] < lengths[:, None],
        mlm_labels=rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        mlm_mask=(rng.random((b, s)) < 0.15).astype(np.float32),
        nsp_labels=rng.integers(0, 2, b).astype(np.int32),
    )
    return {k: torch.from_numpy(v).to(device) for k, v in feeds.items()}


def flash_entries():
    from paddle_tpu_torch.ops import attention as FA
    return (FA.FWD, FA.BWD_DKV, FA.BWD_DQ)


TRAIN_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
#: phase 5's steps with a background save in them: long enough to hold
#: the save's whole write (4.2-4.9 s to commit on one H100 80GB HBM3,
#: 700 W, at ~88 ms a step)
SAVE_WINDOW = 80


def _train_dir():
    """A fresh directory for phase 5's checkpoints and run log."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    return TRAIN_DIR


def _bert_base(device, seed=0):
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    cfg = BertConfig.base(dropout=0.0, attn_dropout=0.0)
    model = BertForPretraining(cfg, device=device, seed=seed)
    return cfg, model, AdamW(model.parameters(), learning_rate=1e-4)


def _bert_loss(m, **b):
    return m.loss(**b)


def _hist_sum(name):
    """(count, sum) of a histogram of the process's default registry,
    where the snapshot engine records."""
    from paddle_tpu_torch import observability
    s = observability.default().histogram(name).summary()
    return s["count"], s["sum"]


def adamw_profile(params, reps=3):
    """The optimizer alone, eagerly, on copies of the parameters and their
    gradients: the multi-tensor AdamW and the plain per-parameter rule,
    each's kernels per step and device ms (``profile_window``) beside the
    bound: p, g, m and v read and p, m and v written once, 28 bytes per
    parameter, over the card's memory rate."""
    from paddle_tpu_torch.optimizer import AdamW
    copies = [p.detach().clone().requires_grad_() for p in params]
    for c, p in zip(copies, params):
        c.grad = p.grad.detach().clone()
    n = sum(p.numel() for p in params)
    out = {"params": n, "bound_ms": 28 * n / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes"}
    for name, foreach in (("multi_tensor", True), ("plain", False)):
        opt = AdamW(copies, learning_rate=1e-4, foreach=foreach)
        opt.step()                               # slots and lr warm
        prof = profile_window(opt.step, reps)
        out[name] = {"kernels_per_step": prof["kernel_launches"] / reps,
                     "device_ms": prof["device_busy_s"] * 1e3 / reps,
                     "wall_ms": prof["unprofiled_wall_s"] * 1e3 / reps}
        del opt
    del copies
    torch.cuda.empty_cache()
    return out


def train_bf16(device):
    """The training main path through the user's entry points:
    ``build_train_step`` (the multi-tensor AdamW, one captured graph) ->
    ``Trainer.fit(checkpoint_dir=..., run_log=...)`` with telemetry ->
    ``Trainer.restore()``."""
    from paddle_tpu_torch.core.dtypes import get_policy
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.observability import (MetricsRegistry, recompile,
                                                runlog)
    from paddle_tpu_torch.train import build_train_step, make_train_state
    from paddle_tpu_torch.trainer import Trainer, state_tree
    out_dir = _train_dir()
    cfg, model, opt = _bert_base(device)
    state = make_train_state(model, opt)
    step = build_train_step(_bert_loss, opt, policy=get_policy("bf16"))
    batch = bert_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, device)
    losses, marks = [], {}

    def hook(t, n, m):
        losses.append(m["loss"])
        if n == marks.get("sync_at"):
            torch.cuda.synchronize()
            marks["t_end"] = time.monotonic()
            if "save_at" in marks:           # the window's save, done
                marks["committed_in_window"] = _hist_sum(
                    "resilience_snapshot_seconds")[0] > marks["saved"][0]
                t.manager.wait()
                marks["saved_after"] = _hist_sum(
                    "resilience_snapshot_seconds")
        if n == marks.get("save_at"):
            marks["saved"] = _hist_sum("resilience_snapshot_seconds")
            t.manager.save(t.step_count, state_tree(t.state), force=True)

    reg = MetricsRegistry()
    run_log = str(out_dir / "train.jsonl")
    ckpt = str(out_dir / "ckpt")
    trainer = Trainer(step, state, checkpoint_dir=ckpt,
                      checkpoint_every=1000, keep_checkpoints=2,
                      run_log=run_log, log_every=10, log_fn=log,
                      registry=reg, hooks=[hook])
    # step 1 eager, step 2 captured, step 3 replayed; a forced save at 3.
    # The run's peak memory includes the capture (the graph pool).
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    trainer.fit(itertools.repeat(batch), steps_per_epoch=WARMUP_STEPS)
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    captures = recompile.capture_count()
    registry.reset_launches()               # count only the timed run
    marks["sync_at"] = TIMED_STEPS
    reg = trainer.registry = MetricsRegistry()
    t0 = time.monotonic()
    trainer.fit(itertools.repeat(batch), steps_per_epoch=TIMED_STEPS)
    wall = marks["t_end"] - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {e.name: e.launches for e in flash_entries()}
    saves, save_sum = _hist_sum("resilience_snapshot_seconds")
    blocks, block_sum = _hist_sum("resilience_snapshot_blocking_seconds")
    # a window with a save issued at its 2nd step through the Trainer's
    # manager: the host copy blocks the loop, the write runs behind it
    marks.update(sync_at=SAVE_WINDOW, save_at=2)
    window_reg = MetricsRegistry()
    trainer.registry = window_reg
    t0 = time.monotonic()
    trainer.fit(itertools.repeat(batch), steps_per_epoch=SAVE_WINDOW)
    window_wall = marks["t_end"] - t0
    n_after, sum_after = marks["saved_after"]
    n_before, sum_before = marks["saved"]
    if n_after != n_before + 1:
        raise AssertionError(f"expected the window's save, got "
                             f"{n_after - n_before} saves")
    if recompile.capture_count() != captures:
        raise AssertionError("the train step captured after its first "
                             "graphed step")
    tree_bytes = sum(t.numel() * t.element_size() for t in _leaves(
        state_tree(state)))
    before = [t.detach().clone() for t in _leaves(state_tree(state))]
    restorer = Trainer(step, state, checkpoint_dir=ckpt, log_fn=log,
                       telemetry=False)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    restored_step = restorer.restore()
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    if restored_step != WARMUP_STEPS + TIMED_STEPS + SAVE_WINDOW or not all(
            torch.equal(a, b) for a, b in zip(
                before, _leaves(state_tree(state)))):
        raise AssertionError(f"restore of step {restored_step} did not "
                             "give back the saved state bit for bit")
    del before
    records = runlog.validate_run_log(run_log, require_steps=WARMUP_STEPS
                                      + TIMED_STEPS + SAVE_WINDOW)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < min(losses[0], losses[WARMUP_STEPS]):
        raise AssertionError(f"training loss did not fall: {losses}")
    want = cfg.num_layers * TIMED_STEPS
    if any(n != want for n in launches.values()):
        raise AssertionError(f"flash kernels launched {launches} times, "
                             f"expected {want} each (12 layers x steps)")
    n_params = sum(p.numel() for p in model.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops_per_token = 6 * n_params + 12 * cfg.num_layers * TRAIN_SEQ * \
        cfg.hidden_size
    tps = tokens * TIMED_STEPS / wall
    window_steps = window_reg.histogram("train_step_seconds").summary()
    stats = {
        "steps": TIMED_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "params": n_params, "wall_s": wall, "warmup_s": warm_s,
        "ms_per_step": wall / TIMED_STEPS * 1e3, "tokens_per_s": tps,
        "mfu_vs_989tflops": tps * flops_per_token / PEAK_FLOPS[torch.bfloat16],
        "peak_memory_gib": peak / 2**30,
        "loss_first": losses[0], "loss_last": losses[-1],
        "host_step_s_mean":
            reg.histogram("train_step_seconds").summary()["mean"],
        "captures_after_first_graphed_step":
            recompile.capture_count() - captures,
        "graph_builds": step.builds,
        "launches": launches,
        "checkpoint_bytes": tree_bytes,
        "snapshot_save_s_mean": save_sum / max(saves, 1),
        "snapshot_blocking_s_mean": block_sum / max(blocks, 1),
        "snapshot_background_save_s": sum_after - sum_before,
        "save_window_ms_per_step": window_wall / SAVE_WINDOW * 1e3,
        # the background write ended before the window's clock stopped
        "save_committed_in_window": marks["committed_in_window"],
        "save_window_host_step_s_max": window_steps["max"],
        "restore_s": restore_s,
        "run_log_step_records": records,
    }
    log("  bf16 train: " + json.dumps(stats))
    it = itertools.repeat(batch)
    # the flash kernels, and the deterministic embedding backward's sort,
    # gather and segment reduction
    prof = profile_window(lambda: step(state, **next(it)), PROFILED_STEPS,
                          keep=("flash_", "segment_reduce", "radixSort",
                                "index_select", "searchsorted"))
    log("  train profile: " + json.dumps({"steps": PROFILED_STEPS, **prof}))
    stats["busy_share"] = prof["device_busy_share"]
    stats["kernels_per_step"] = prof["kernel_launches"] / PROFILED_STEPS
    stats["optimizer"] = adamw_profile(list(model.parameters()))
    stats["adamw_kernels_per_step"] = \
        stats["optimizer"]["multi_tensor"]["kernels_per_step"]
    stats["adamw_device_ms"] = stats["optimizer"]["multi_tensor"][
        "device_ms"]
    log("  AdamW alone: " + json.dumps(stats["optimizer"]))
    trainer.manager.close()
    del trainer, restorer, state, step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    stats["remat"] = remat_leg(device, batch)
    stats["amp"] = amp_leg(device, batch)
    del batch
    torch.cuda.empty_cache()
    return stats


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def remat_leg(device, batch, steps=3):
    """Phase 5's step with and without ``remat=True`` (each graphed, from
    the same weights): losses equal, peak memory of each."""
    from paddle_tpu_torch.core.dtypes import get_policy
    from paddle_tpu_torch.train import build_train_step, make_train_state
    out = {}
    for remat in (False, True):
        _, model, opt = _bert_base(device)
        state = make_train_state(model, opt)
        step = build_train_step(_bert_loss, opt, policy=get_policy("bf16"),
                                remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(step(state, **batch)[1]["loss"])
                  for _ in range(steps)]
        out["remat" if remat else "plain"] = {
            "losses": losses,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
        del state, step, opt, model
        gc.collect()
        torch.cuda.empty_cache()
    if out["remat"]["losses"] != out["plain"]["losses"]:
        raise AssertionError(f"remat changed the losses: {out}")
    log("  remat leg: " + json.dumps(out))
    return out


def amp_leg(device, batch):
    """``scaled_train_step`` on the default bf16 policy, graphed: 3 steps,
    then one with the scale set to infinity in place, which overflows and
    must be skipped on the device (parameters, slots and both step counts
    unchanged, the scale backed off and clipped to ``max_scale``), then
    one more that trains. (A scale of 2**127 does not overflow: the loss
    is scaled, but the gradients of BERT-base's bf16 step stay below
    float32's range at that scale on the card.) The flash kernels run 12
    times per step, counted per replay."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.kernels import registry
    cfg, model, opt = _bert_base(device)
    state = amp.make_amp_state(model, opt)
    step = amp.scaled_train_step(_bert_loss, opt)
    registry.reset_launches()
    first = [step(state, **batch)[1] for _ in range(3)]
    state["loss_scale"]["scale"].fill_(float("inf"))
    tensors = opt.params() + opt.state_tensors()
    before = [t.clone() for t in tensors]
    _, skipped = step(state, **batch)
    unchanged = all(torch.equal(a, b) for a, b in zip(tensors, before))
    del before
    _, after = step(state, **batch)
    launches = [e.launches for e in flash_entries()]
    out = {"finite": [bool(m["grads_finite"]) for m in first]
           + [bool(skipped["grads_finite"]), bool(after["grads_finite"])],
           "loss_scale_after_overflow": float(skipped["loss_scale"]),
           "unchanged_by_the_skipped_step": unchanged,
           "step": int(state["step"]), "opt_step": opt.num_steps,
           "launches": launches, "builds": step.builds,
           "losses": [float(m["loss"]) for m in first + [after]]}
    log("  amp leg: " + json.dumps(out))
    if out["finite"] != [True, True, True, False, True] or not unchanged \
            or out["step"] != 4 or out["opt_step"] != 4 \
            or out["loss_scale_after_overflow"] != 2.0 ** 24 \
            or launches != [cfg.num_layers * 5] * 3 \
            or step.builds != (device.type == "cuda"):
        raise AssertionError(f"amp leg: {out}")
    del state, step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _held_params(name, got, want, steps, lr):
    """Parameters within 1e-4, except the key third of each
    ``qkv_proj.bias``: its gradient is zero in exact arithmetic (a
    constant added to a row's scores cancels in the softmax), so Adam
    normalises rounding noise into steps of about ``lr`` either way;
    there only the drift is held, to at most 2 x steps x lr."""
    if name.endswith("attn.qkv_proj.bias"):
        d = got.shape[0] // 3
        drift = float((got[d:2 * d] - want[d:2 * d]).abs().max())
        if drift > 2 * steps * lr:
            raise AssertionError(f"{name}: key-bias drift {drift:.3e}")
        got, want = got.clone(), want.clone()
        got[d:2 * d] = want[d:2 * d]
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"fp32 parity: {name} differs by {err:.3e}")
    return err


def train_fp32_parity(device):
    """BERT at full width, 2 layers, fp32: 3 AdamW steps through the
    kernels and through the plain versions, TF32 off for matmuls and
    cuDNN (stated explicitly)."""
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.train import build_train_step, make_train_state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps, lr = 3, 1e-4
    runs = {}
    for impl in ("auto", "plain"):
        cfg = BertConfig.base(num_layers=2, dropout=0.0, attn_dropout=0.0,
                              attn_impl=impl)
        model = BertForPretraining(cfg, device=device, seed=1)
        state = make_train_state(model, AdamW(model.parameters(),
                                              learning_rate=lr))
        step = build_train_step(lambda m, **b: m.loss(**b), state["opt"])
        batch = bert_batch(cfg, 8, TRAIN_SEQ, device, seed=3)
        registry.reset_launches()
        losses = [float(step(state, **batch)[1]["loss"])
                  for _ in range(steps)]
        launched = [e.launches for e in flash_entries()]
        if launched != ([2 * steps] * 3 if impl == "auto" else [0] * 3):
            raise AssertionError(f"fp32 {impl} run launched {launched}")
        runs[impl] = (losses, {n: p.detach() for n, p in
                               model.named_parameters()})
    (k_losses, k_params), (p_losses, p_params) = runs["auto"], runs["plain"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
    if rel > 1e-4:
        raise AssertionError(f"fp32 parity: losses {k_losses} vs {p_losses}")
    err = max(_held_params(n, k_params[n], p_params[n], steps, lr)
              for n in k_params)
    log(f"  fp32 train parity: losses kernel {k_losses} plain {p_losses} "
        f"(max rel {rel:.2e}); max |param diff| {err:.2e} over "
        f"{len(k_params)} tensors")
    del runs
    torch.cuda.empty_cache()
    return {"losses_kernel": k_losses, "losses_plain": p_losses,
            "loss_rel_err": rel, "param_max_abs_err": err}


def train_fp32_exact(device, steps=3):
    """fp32 BERT at full width, 2 layers, TF32 off (set by
    :func:`train_fp32_parity`): the captured step against eager dispatch
    after ``steps`` steps, bit for bit; the multi-tensor AdamW against the
    plain per-parameter rule, within 1e-6; and a run checkpointed at step
    2 through ``Trainer``, restored into a fresh model (another seed) and
    continued to step 4, against an unbroken run of 4 steps, bit for
    bit."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.train import build_train_step, make_train_state
    from paddle_tpu_torch.trainer import Trainer
    cfg = BertConfig.base(num_layers=2, dropout=0.0, attn_dropout=0.0)
    batch = bert_batch(cfg, 8, TRAIN_SEQ, device, seed=3)

    def parts(seed=1, graphs=True, foreach=True):
        model = BertForPretraining(cfg, device=device, seed=seed)
        opt = AdamW(model.parameters(), learning_rate=1e-4, foreach=foreach)
        state = make_train_state(model, opt)
        return state, build_train_step(_bert_loss, opt, cuda_graphs=graphs)

    def run(**kw):
        state, step = parts(**kw)
        for _ in range(steps):
            step(state, **batch)
        return {n: p.detach().clone()
                for n, p in state["model"].named_parameters()}

    graphed, eager = run(graphs=True), run(graphs=False)
    plain = run(graphs=False, foreach=False)
    if not all(torch.equal(graphed[n], eager[n]) for n in eager):
        bad = max(float((graphed[n] - eager[n]).abs().max()) for n in eager)
        raise AssertionError(f"graphed != eager, max |diff| {bad:.3e}")
    rule_err = max(float((eager[n] - plain[n]).abs().max()) for n in eager)
    if rule_err > 1e-6:
        raise AssertionError(f"multi-tensor AdamW vs the plain rule: "
                             f"{rule_err:.3e}")
    quiet = dict(telemetry=False, log_fn=lambda m: None, checkpoint_every=2)
    root = _train_dir()
    unbroken, step = parts()
    Trainer(step, unbroken, checkpoint_dir=str(root / "a"), **quiet).fit(
        itertools.repeat(batch), steps_per_epoch=4)
    first, step = parts()
    Trainer(step, first, checkpoint_dir=str(root / "b"), **quiet).fit(
        itertools.repeat(batch), steps_per_epoch=2)
    resumed, step = parts(seed=7)
    tr = Trainer(step, resumed, checkpoint_dir=str(root / "b"), **quiet)
    if tr.restore() != 2:
        raise AssertionError("resume did not find step 2")
    tr.fit(itertools.repeat(batch), steps_per_epoch=2)
    a = dict(unbroken["model"].named_parameters())
    b = dict(resumed["model"].named_parameters())
    if int(resumed["step"]) != 4 or not all(torch.equal(a[n], b[n])
                                            for n in a):
        raise AssertionError("resumed run != unbroken run")
    out = {"graphed_equals_eager": True, "adamw_rule_max_abs_err": rule_err,
           "resume_equals_unbroken": True, "tensors": len(a)}
    log("  fp32 exact: " + json.dumps(out))
    del unbroken, first, resumed, tr, step, graphed, eager, plain
    torch.cuda.empty_cache()
    return out


# -- phase 8: training across ranks -------------------------------------------

#: leg (a): the ring alone at (B, H, S, Dh) and its cases (name, dtype,
#: causal), every case with a key-padding bias (one batch row fully
#: masked)
RING_SHAPE = (8, 12, 2048, 64)
RING_CASES = (("bf16", torch.bfloat16, False),
              ("bf16_causal", torch.bfloat16, True),
              ("fp32", torch.float32, False))
#: legs (b)-(e): global batch rows (sequence 512) and steps
SP_BATCH, SP_STEPS = 8, 3            # (b): each sp rank 8 x 256
DP_BATCH, DP_STEPS = 24, 2           # (c): each dp rank 24 x 512
TP_BATCH, TP_STEPS = 4, 2            # (d)
#: (c), (d) and so (f): BERT-base width cut to 4 layers in depth, to keep
#: the script's time with phase 9 in it
PAR_LAYERS = 4
LOCAL_SGD_BATCH, LOCAL_SGD_STEPS, LOCAL_SGD_K = 8, 4, 2   # (e), per rank
#: (b): the bf16 ring run's losses against the sp=1 run's, relative: one
#: bf16 unit in the last place (PERF.md says why)
RING_BF16_RTOL = 2.0 ** -7
PAR_DIR = TRAIN_DIR.parent / "chip_smoke_parallel"


def _par_mesh(device, **sizes):
    """A mesh of the group's ranks; on the card with the explicit switch
    that stages the ops gloo cannot run on CUDA tensors through the host
    (transport only: every kernel runs on the card)."""
    from paddle_tpu_torch.core import mesh as mesh_lib
    return mesh_lib.make_mesh(mesh_lib.MeshConfig(**sizes),
                              device_type=device.type,
                              stage_cuda_through_host=device.type == "cuda")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _ring_work(q, bias, causal):
    """(bytes, flops) of the ring's forward and backward on the whole
    sequence: q, k, v and do read once, out, dq, dk and dv written once,
    the key bias read once; 18 flops per live (query, key, d): K5's 4,
    K6a's 8, K6b's 6."""
    from paddle_tpu_torch.ops import attention as FA
    b, h, s, d = q.shape
    nbytes = 8 * q.numel() * q.element_size() + (
        4 * bias.numel() if bias is not None else 0)
    return nbytes, 18 * b * h * d * FA._live_pairs(s, s, causal)


def ring_leg(rank, n, device, timed=False):
    """(a) on one rank of an sp=n group: each case's blocks through
    ``ring_attention`` (impl "auto": K5 per visiting block, K6a/K6b per
    block in the backward), forward and dq/dk/dv held to the dense K5/K6
    path on the whole sequence within the flash entries' tolerances; the
    rank's K5/K6a/K6b launches, blocks by case and staged bytes. With
    ``timed``, the bf16 case's ring (kernels and plain block functions)
    and, on rank 0 alone, SDPA's forward and backward on the whole
    sequence."""
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.ops import attention as FA
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel import ring_attention as R
    mesh = _par_mesh(device, sp=n)
    out = {}
    for name, dtype, causal in RING_CASES:
        q0, k0, v0, bias, do0 = flash_inputs(RING_SHAPE, "ragged", device,
                                             seed=8)
        q, k, v, do = (t.to(dtype) for t in (q0, k0, v0, do0))
        del q0, k0, v0, do0

        def blk(t, dim=2):
            return R.block_of(t, mesh, "sp", dim)

        def ring(impl):
            leaves = [blk(t).requires_grad_() for t in (q, k, v)]
            o = R.ring_attention(*leaves, bias=blk(bias, 3), causal=causal,
                                 mesh=mesh, impl=impl)
            o.backward(blk(do))
            return o.detach(), [t.grad for t in leaves]

        registry.reset_launches()
        R.reset_ring_stats()
        C.reset_staged_stats()
        o, grads = ring("auto")
        _sync(device)
        launches = {e.name: e.launches for e in flash_entries()}
        cases, staged = R.ring_stats(), C.staged_stats()
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        dense = FA.flash_attention(*leaves, bias, causal)
        dense.backward(do)
        tol = FA.FWD.tolerance[dtype]
        gtol = FA.BWD_DQ.tolerance[dtype]
        errs = {"out": _err(o, blk(dense.detach()), tol,
                            f"8a ring[{name}] sp={n} out")}
        for what, g, leaf in zip(("dq", "dk", "dv"), grads, leaves):
            errs[what] = _err(g, blk(leaf.grad), gtol,
                              f"8a ring[{name}] sp={n} {what}")
        if not torch.all(o[0] == 0):
            raise AssertionError(f"8a ring[{name}]: the fully masked batch "
                                 "row is not 0")
        row = {"max_abs_err": errs, "launches": launches, "cases": cases,
               "staged": staged,
               "hops": staged["calls"].get("ppermute", 0),
               "staged_bytes_per_hop": (
                   staged["bytes"].get("ppermute", 0)
                   / max(1, staged["calls"].get("ppermute", 0)))}
        del dense, leaves, grads, o
        if timed and name == "bf16":
            flush = L2Flush(device)
            row.update(_timed(lambda: ring("auto"), flush, 3))
            row.update(_timed(lambda: ring("plain"), flush, 1, "plain_"))
            C.barrier("sp", mesh=mesh)
            if rank == 0:
                lib_f = _library_fwd(q, k, v, bias, causal)
                lib_b = _library_bwd(q, k, v, bias, do, causal)
                row.update(_timed(lambda: (lib_f(), lib_b()), flush, 5,
                                  "library_"))
            C.barrier("sp", mesh=mesh)
            nbytes, flops = _ring_work(q, bias, causal)
            row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, dtype)
            del flush
        out[name] = row
        del q, k, v, do, bias
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _bert_sharded(device, mesh, cfg, batch, *, plan=None, layer_hints=False,
                  seq_dim=None, policy=None, seed=0):
    """A BERT of ``cfg`` from ``seed`` with AdamW(1e-4), its eager step
    put on ``mesh`` by ``shard_train_step`` (with ``layer_hints``, the
    layers' own sharding hints). Returns (run, state, model)."""
    from paddle_tpu_torch.core.dtypes import get_policy
    from paddle_tpu_torch.models.bert import BertForPretraining
    from paddle_tpu_torch.nn.module import sharding_specs
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import api
    from paddle_tpu_torch.train import build_train_step, make_train_state
    model = BertForPretraining(cfg, device=device, seed=seed)
    hints = sharding_specs(model) if layer_hints else None
    opt = AdamW(model.parameters(), learning_rate=1e-4)
    step = build_train_step(_bert_loss, opt,
                            policy=get_policy(policy) if policy else None)
    spec = api.batch_specs(batch, seq_dim=seq_dim) if seq_dim \
        else api.BATCH_SPEC
    run, state = api.shard_train_step(step, mesh,
                                      make_train_state(model, opt),
                                      plan=plan, hints=hints,
                                      batch_spec=spec)
    return run, state, model


def _free(device):
    """Free what the caller has deleted (a model and its optimizer refer
    to each other through the train state)."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def bert_ring_leg(rank, n, device):
    """(b): BERT-base with ``attn_impl="ring"`` on an sp=n mesh, each rank
    its 8 x 512/n block of the 8 x 512 batch: 3 eager AdamW steps in bf16
    over fp32 masters (the phase's main path: the counts are set to 0
    just before and read just after), then the fp32 2-layer model at
    full width. Returns each run's losses, K5/K6a/K6b launches, ring
    calls, blocks by case, staged bytes and tokens/s."""
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel import ring_attention as R
    mesh = _par_mesh(device, sp=n)
    out = {}
    for label, policy, layers in (("bf16", "bf16", 12),
                                  ("fp32_2layer", None, 2)):
        cfg = BertConfig.base(num_layers=layers, dropout=0.0,
                              attn_dropout=0.0, attn_impl="ring")
        batch = bert_batch(cfg, SP_BATCH, TRAIN_SEQ, device, seed=3)
        run, state, model = _bert_sharded(device, mesh, cfg, batch,
                                          seq_dim=1, policy=policy)
        _sync(device)
        registry.reset_launches()
        R.reset_ring_stats()
        C.reset_staged_stats()
        t0 = time.monotonic()
        losses = [float(run(state, **batch)[1]["loss"])
                  for _ in range(SP_STEPS)]
        _sync(device)
        wall = time.monotonic() - t0
        out[label] = {
            "losses": losses,
            "launches": {e.name: e.launches for e in flash_entries()},
            "ring_calls": R.RING.calls, "cases": R.ring_stats(),
            "staged": C.staged_stats(), "wall_s": wall,
            "tokens_per_s_gloo_on_one_card_not_a_parallel_speed":
                SP_BATCH * TRAIN_SEQ * SP_STEPS / wall}
        del run, state, model
        _free(device)
    return out


def _snapshot_tree(state, specs, mesh):
    """The train state's reference tree with every parameter and
    optimizer slot as this rank's :class:`Shard` under its parameter's
    spec, and ``{flat key: spec or None}`` of its leaves."""
    from paddle_tpu_torch.resilience.snapshot import flatten_tree, shard_leaf
    from paddle_tpu_torch.trainer import state_tree
    flat = flatten_tree(state_tree(state))
    keyed = {}
    for key in flat:
        parts = key.split("/")
        name = None
        if parts[0] == "params":
            name = ".".join(parts[1:])
        elif parts[:2] == ["opt", "slots"]:
            name = ".".join(parts[3:])
        keyed[key] = specs.get(name) if name in specs else None
    out = {}
    for key, v in flat.items():
        spec = keyed[key]
        out[key] = v if spec is None or not isinstance(v, torch.Tensor) \
            else shard_leaf(v.detach(), spec, mesh)
    return _nested(out), keyed


def _nested(flat):
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        if leaf != "\x00empty":
            node[leaf] = v
    return out


def dp_leg(rank, n, device):
    """(c) and the save of (f): BERT-base fp32 (TF32 off) at n x (24 x
    512), 2 eager AdamW steps under the ``replicated`` plan (mesh dp=n)
    and the ``fsdp`` plan (mesh fsdp=n), each from the same seed on the
    same global batch: losses, peak memory, and the parameters gathered
    whole (saved by rank 0 for the parent). The fsdp state is then saved
    by every rank as its blocks (``Shard`` leaves) into one snapshot,
    beside each rank's blocks and rank 0's whole state for the checks."""
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.parallel import api, plan as plan_lib
    from paddle_tpu_torch.resilience.snapshot import (SnapshotEngine,
                                                      flatten_tree)
    from paddle_tpu_torch.trainer import state_tree
    out = {}
    cfg = BertConfig.base(num_layers=PAR_LAYERS, dropout=0.0,
                          attn_dropout=0.0)
    for name, axis, plan in (("replicated", "dp", plan_lib.replicated_plan()),
                             ("fsdp", "fsdp", plan_lib.fsdp_plan())):
        mesh = _par_mesh(device, **{axis: n})
        batch = bert_batch(cfg, n * DP_BATCH, TRAIN_SEQ, device, seed=5)
        _free(device)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        run, state, model = _bert_sharded(device, mesh, cfg, batch,
                                          plan=plan)
        state_bytes = torch.cuda.memory_allocated() - before if cuda \
            else None
        t0 = time.monotonic()
        losses = [float(run(state, **batch)[1]["loss"])
                  for _ in range(DP_STEPS)]
        _sync(device)
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated() - before if cuda else None
        whole = api.gathered_params(model, run.specs, mesh)
        if rank == 0:
            torch.save({k: v.cpu() for k, v in whole.items()},
                       PAR_DIR / f"{name}_params.pt")
        out[name] = {
            "losses": losses, "peak_bytes": peak, "wall_s": wall,
            "state_bytes_after_placement": state_bytes,
            "sharded_params": sum(1 for s in run.specs.values()
                                  if "fsdp" in str(s)),
            "local_param_bytes": sum(p.numel() * p.element_size()
                                     for p in model.parameters()),
            "tokens_per_s_gloo_on_one_card_not_a_parallel_speed":
                n * DP_BATCH * TRAIN_SEQ * DP_STEPS / wall}
        if name == "fsdp":
            t0 = time.monotonic()
            tree, keyed = _snapshot_tree(state, run.specs, mesh)
            eng = SnapshotEngine(str(PAR_DIR / "snap"), process_index=rank,
                                 process_count=n)
            eng.save(1, tree, wait=True)
            eng.close()
            blocks = {k: v.detach().cpu() for k, v in
                      flatten_tree(state_tree(state)).items()
                      if isinstance(v, torch.Tensor)}
            torch.save(blocks, PAR_DIR / f"blocks_{rank}.pt")
            full = {k: (api.gather_block(v.detach(), keyed[k], mesh)
                        if keyed[k] is not None else v).cpu()
                    for k, v in flatten_tree(state_tree(state)).items()
                    if isinstance(v, torch.Tensor)}
            if rank == 0:
                torch.save(full, PAR_DIR / "whole.pt")
                torch.save(keyed, PAR_DIR / "specs.pt")
            out["save_s"] = time.monotonic() - t0
            del tree, blocks, full
        del run, state, model, whole
        _free(device)
    return out


def tp_leg(rank, n, device):
    """(d): Megatron from the layers' hints on a tp=n mesh, BERT-base fp32
    (TF32 off), 4 x 512, 2 eager AdamW steps: the losses."""
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel import plan as plan_lib
    mesh = _par_mesh(device, tp=n)
    cfg = BertConfig.base(num_layers=PAR_LAYERS, dropout=0.0,
                          attn_dropout=0.0)
    batch = bert_batch(cfg, TP_BATCH, TRAIN_SEQ, device, seed=7)
    run, state, model = _bert_sharded(device, mesh, cfg, batch,
                                      plan=plan_lib.megatron_plan(),
                                      layer_hints=True)
    C.reset_staged_stats()
    t0 = time.monotonic()
    losses = [float(run(state, **batch)[1]["loss"])
              for _ in range(TP_STEPS)]
    _sync(device)
    out = {"losses": losses, "wall_s": time.monotonic() - t0,
           "split_params": sum(1 for s in run.specs.values()
                               if "tp" in str(s)),
           "local_param_bytes": sum(p.numel() * p.element_size()
                                    for p in model.parameters()),
           "staged": C.staged_stats()}
    del run, state, model
    _free(device)
    return out


def local_sgd_leg(rank, n, device):
    """(e): LocalSGD(k=2) in a dp=n group: the fp32 2-layer BERT at full
    width from one seed, each rank stepping on its own 8 x 512 block of
    the batch; at each sync step the parameters are averaged over "dp",
    and after it every rank holds the same parameters, equal bit for bit
    to the mean of the ranks' parameters before it (gathered here)."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.compression import LocalSGD
    from paddle_tpu_torch.parallel import api
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.train import build_train_step, make_train_state
    mesh = _par_mesh(device, dp=n)
    cfg = BertConfig.base(num_layers=2, dropout=0.0, attn_dropout=0.0)
    model = BertForPretraining(cfg, device=device, seed=0)
    opt = AdamW(model.parameters(), learning_rate=1e-4)
    step = build_train_step(_bert_loss, opt, cuda_graphs=False)
    state = make_train_state(model, opt)
    local = api.local_batch(bert_batch(cfg, n * LOCAL_SGD_BATCH, TRAIN_SEQ,
                                       device, seed=9), mesh)
    avg = LocalSGD(k_steps=LOCAL_SGD_K, axis="dp")
    params = list(model.parameters())
    syncs, losses = [], []
    for i in range(LOCAL_SGD_STEPS):
        before = [C.all_gather(p.detach()[None], "dp", mesh=mesh)
                  for p in params] if i % LOCAL_SGD_K == 0 else None
        if avg.maybe_average(params, i, mesh=mesh):
            mean = [g.sum(0) / n for g in before]
            after = [C.all_gather(p.detach()[None], "dp", mesh=mesh)
                     for p in params]
            syncs.append({
                "step": i,
                "equal_to_mean": all(torch.equal(p, m)
                                     for p, m in zip(params, mean)),
                "equal_across_ranks": all(torch.equal(a[0], a[r])
                                          for a in after
                                          for r in range(1, n)),
                "ranks_differed_before": any(
                    not torch.equal(b[0], b[1]) for b in before)})
            del before, after, mean
        state, m = step(state, **local)
        losses.append(float(m["loss"]))
    out = {"syncs": syncs, "losses": losses}
    del state, model, opt, params, step
    _free(device)
    return out


def restore_leg(rank, n, device):
    """(f) in a fresh fsdp=n group: restore the snapshot the fsdp ranks of
    (c) saved with ``shardings=`` (each rank reads every shard file whole,
    ``files_read_bytes``, and keeps its blocks, ``block_bytes``), each
    block equal bit for bit to what that rank held."""
    from paddle_tpu_torch.resilience.snapshot import (Shard, SnapshotEngine,
                                                      flatten_tree)
    mesh = _par_mesh(device, fsdp=n)
    keyed = torch.load(PAR_DIR / "specs.pt")
    shardings = _nested({k: None if s is None else (s, mesh)
                         for k, s in keyed.items()})
    t0 = time.monotonic()
    eng = SnapshotEngine(str(PAR_DIR / "snap"))
    back = flatten_tree(eng.restore(1, shardings=shardings))
    eng.close()
    seconds = time.monotonic() - t0
    want = torch.load(PAR_DIR / f"blocks_{rank}.pt")
    blocks = {k: v for k, v in back.items() if isinstance(v, Shard)}
    bad = [k for k, v in blocks.items() if not torch.equal(v.data, want[k])]
    bad += [k for k, v in back.items() if k not in blocks
            and isinstance(v, torch.Tensor) and not torch.equal(v, want[k])]
    if bad or not blocks:
        raise AssertionError(f"8f restore rank {rank}: {len(bad)} leaves "
                             f"differ ({bad[:3]}), {len(blocks)} blocks")
    return {"blocks": len(blocks),
            "split": sum(1 for v in blocks.values()
                         if tuple(v.data.shape) != tuple(v.shape)),
            "block_bytes": sum(v.data.numel() * v.data.element_size()
                               for v in blocks.values()),
            "files_read_bytes": sum(
                p.stat().st_size
                for p in (PAR_DIR / "snap").glob("step_*/shards_p*.pkl")),
            "restore_s": seconds}


# -- phase 9: pipelines ------------------------------------------------------

#: (a): the toy stack's layers and width, microbatches and their rows
PIPE_TOY = (4, 1024, 4, 16)
#: (b)-(d): microbatches; BERT-base rows and steps; GPT-2 small rows, steps
PIPE_M = 4
PIPE_BATCH, PIPE_STEPS = 16, 3
PIPE_GPT_BATCH, PIPE_GPT_STEPS = 8, 2
#: bf16 pipelined losses against pp=1, relative: a quarter of a bf16 unit
#: in the last place (PERF.md says why: each stage runs pp=1's
#: arithmetic); the fp32 2-layer runs within 1e-5; (a)'s bf16 stack within
#: 2e-2 of its largest value, fp32 within 1e-5
PIPE_BF16_RTOL, PIPE_FP32_RTOL = 2.0 ** -9, 1e-5
PIPE_TOY_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
PIPE_DIR = TRAIN_DIR.parent / "chip_smoke_pipeline"


def pipe_reckoning(layers, n, steps, m=PIPE_M):
    """K5/K6a/K6b launches a stage rank makes in ``steps`` steps: each of
    its ``layers / n`` layers once per microbatch in the forward and once
    in the recompute (K5), once in the backward (K6a, K6b), whatever the
    schedule (the circular one runs the same layers in chunks)."""
    per = layers // n * m * steps
    return {"K5": 2 * per, "K6a": per, "K6b": per}


def pipe_hop_ends(n, m, steps, v=1):
    """Hop ends (a send or a receive, each staged through the host once)
    of each stage rank in ``steps`` steps: forward, each of the ``v*m``
    items crosses ``n - 1`` stage boundaries plus ``v - 1`` returns to
    stage 0, and its gradient crosses them back; each hop has two ends,
    spread evenly over the ranks at n=2."""
    hops = v * m * (n - 1) + (v - 1) * m
    return 2 * hops * 2 // n * steps


def _toy_stack(device, dtype, seed=21):
    L, D, M, mb = PIPE_TOY
    rng = np.random.default_rng(seed)
    stack = {"w": rng.standard_normal((L, D, D)) * D ** -0.5,
             "b": rng.standard_normal((L, D)) * 0.1}
    x = rng.standard_normal((M, mb, D))
    g = rng.standard_normal((M, mb, D))
    put = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)
    return {k: put(v) for k, v in stack.items()}, put(x), put(g)


def _toy_block(lp, h, extra, mb_idx):
    return torch.tanh(h @ lp["w"] + lp["b"])


def _toy_value_grads(fn, stack, x, g):
    stack = {k: v.clone().requires_grad_() for k, v in stack.items()}
    x = x.clone().requires_grad_()
    out = fn(stack, x)
    (out.float() * g.float()).sum().backward()
    return {"out": out.detach(), "x": x.grad,
            **{k: v.grad for k, v in stack.items()}}


def pipe_toy_leg(rank, n, device):
    """(a): ``gpipe`` and ``circular_pipeline`` (v=2) of a 4-layer toy
    stack (tanh(h @ w + b), width 1024, 4 microbatches of 16 rows) at
    pp=n, every rank holding the stack whole, fp32 and bf16: output and
    gradients against the sequential stack run in this process without a
    mesh; each error relative to the reference's largest value."""
    from paddle_tpu_torch.parallel import pipeline as PL
    mesh = _par_mesh(device, pp=n)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        stack, x, g = _toy_stack(device, dtype)

        def seq(st, xx):
            h = xx.reshape(-1, xx.shape[-1])
            for i in range(PIPE_TOY[0]):
                h = torch.tanh(h @ st["w"][i] + st["b"][i])
            return h.reshape(xx.shape)

        want = _toy_value_grads(seq, stack, x, g)
        for name, v in (("gpipe", 1), ("circular_v2", 2)):
            fn = (functools.partial(PL.gpipe, _toy_block, mesh=mesh)
                  if v == 1 else functools.partial(
                      PL.circular_pipeline, _toy_block, num_circuits=v,
                      mesh=mesh))
            got = _toy_value_grads(lambda st, xx: fn(st, xx), stack, x, g)
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            out[f"{name}_{tag}"] = {
                k: float((got[k].float() - w.float()).abs().max()
                         / w.float().abs().max().clamp(min=1e-30))
                for k, w in want.items()}
    return out


def _pipe_bert(device, mesh, cfg, batch, policy, interleave=None):
    """A pipelined BERT of ``cfg`` from seed 0, AdamW(1e-4), its eager
    step put on ``mesh`` with the layers' hints (the stacked encoder
    split over "pp"); with ``interleave=(n, v)`` the encoder is first
    rearranged into the circular schedule's interleaved order."""
    from paddle_tpu_torch.core.dtypes import get_policy
    from paddle_tpu_torch.models.bert import BertForPretraining
    from paddle_tpu_torch.nn.module import sharding_specs
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import api
    from paddle_tpu_torch.parallel import pipeline as PL
    from paddle_tpu_torch.train import build_train_step, make_train_state
    model = BertForPretraining(cfg, device=device, seed=0)
    if interleave is not None:
        enc = model.bert.encoder.stacked_params()
        with torch.no_grad():
            for k, t in PL.interleave_stack(enc, *interleave).items():
                enc[k].copy_(t)
    opt = AdamW(model.parameters(), learning_rate=1e-4)
    step = build_train_step(_bert_loss, opt,
                            policy=get_policy(policy) if policy else None)
    run, state = api.shard_train_step(step, mesh,
                                      make_train_state(model, opt),
                                      hints=sharding_specs(model))
    return run, state, model


def _pipe_steps(device, run, state, batch, steps):
    """``steps`` steps from counts at 0: losses, each step's seconds,
    the flash launches, staged transport and peak memory."""
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.parallel import collective as C
    _sync(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    C.reset_staged_stats()
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.monotonic()
        losses.append(float(run(state, **batch)[1]["loss"]))
        secs.append(time.monotonic() - t0)
    _sync(device)
    staged = C.staged_stats()
    return {"losses": losses, "step_s": secs,
            "launches": {e.name: e.launches for e in flash_entries()},
            "staged_calls": staged["calls"].get("ppermute", 0),
            "staged_bytes": staged["bytes"].get("ppermute", 0),
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda
            else None}


def pipe_bert_leg(rank, n, device):
    """(b), (c) and (e) on one stage rank of a pp=n group: BERT-base
    (``pipeline=True``, stacked, GPipe, M=4) at 16 x 512, 3 eager AdamW
    steps in bf16 over fp32 masters (the phase's main path: the counts
    are set to 0 just before and read just after), then the fp32 2-layer
    model; (c) the circular schedule (v=2, pre-interleaved) for 1 step;
    (e) (b)'s state saved as each stage's rows, restored here with
    ``shardings=`` naming "pp" and compared bit for bit, and gathered
    whole for the parent's restore without them."""
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.resilience.snapshot import (Shard, SnapshotEngine,
                                                      flatten_tree)
    from paddle_tpu_torch.parallel import api
    from paddle_tpu_torch.trainer import state_tree
    import torch.distributed as dist
    mesh = _par_mesh(device, pp=n)
    out = {}
    for label, policy, layers, extra in (
            ("bf16", "bf16", 12, {}),
            ("fp32_2layer", None, 2, {}),
            ("circular_bf16", "bf16", 12,
             dict(pp_schedule="circular", pp_circuits=2,
                  pp_pre_interleaved=True))):
        cfg = BertConfig.base(num_layers=layers, dropout=0.0,
                              attn_dropout=0.0, pipeline=True,
                              pp_microbatches=PIPE_M, **extra)
        batch = bert_batch(cfg, PIPE_BATCH, TRAIN_SEQ, device, seed=9)
        run, state, model = _pipe_bert(
            device, mesh, cfg, batch, policy,
            interleave=(n, 2) if extra else None)
        steps = 1 if extra else PIPE_STEPS
        out[label] = _pipe_steps(device, run, state, batch, steps)
        out[label]["encoder_rows"] = tuple(
            model.bert.encoder.stacked_params()["ffn.fc1.weight"].shape)
        if label == "bf16":
            t0 = time.monotonic()
            snap = PIPE_DIR / "snap"
            tree, keyed = _snapshot_tree(state, run.specs, mesh)
            eng = SnapshotEngine(str(snap), process_index=rank,
                                 process_count=n)
            eng.save(1, tree, wait=True)
            eng.close()
            dist.barrier()       # process 0 commits once every file is in
            mine = {k: v.detach() for k, v in
                    flatten_tree(state_tree(state)).items()
                    if isinstance(v, torch.Tensor)}
            eng = SnapshotEngine(str(snap))
            back = flatten_tree(eng.restore(1, shardings=_nested({
                k: None if sp is None else (sp, mesh)
                for k, sp in keyed.items()})))
            eng.close()
            blocks = {k: v for k, v in back.items() if isinstance(v, Shard)}
            bad = [k for k, v in mine.items()
                   if not torch.equal((blocks[k].data if k in blocks
                                       else back[k]).to(v.device), v)]
            split = [k for k, sp in keyed.items()
                     if sp and "pp" in str(sp)]
            if bad or not split:
                raise AssertionError(f"9e restore rank {rank}: {len(bad)} "
                                     f"leaves differ ({bad[:3]}), "
                                     f"{len(split)} split over pp")
            whole = {k: (api.gather_block(v, keyed[k], mesh)
                         if keyed[k] is not None else v).cpu()
                     for k, v in mine.items()}
            if rank == 0:
                torch.save(whole, PIPE_DIR / "whole.pt")
            out["snapshot"] = {
                "leaves": len(mine), "split_over_pp": len(split),
                "block_bytes": sum(b.data.numel() * b.data.element_size()
                                   for b in blocks.values()),
                "save_and_restore_s": time.monotonic() - t0}
            del tree, mine, back, blocks, whole
        del run, state, model
        _free(device)
    return out


def _gpt_small(pipeline=True):
    from paddle_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                     num_heads=12, ffn_size=3072, max_position=1024,
                     pipeline=pipeline, pp_microbatches=PIPE_M)


def _gpt_ids(cfg, device, seed=13):
    rng = np.random.default_rng(seed)
    return {"ids": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PIPE_GPT_BATCH, TRAIN_SEQ + 1)).astype(
            np.int32)).to(device)}


def _gpt_step(device, mesh=None):
    """GPT-2 small (pipelined, stacked) from seed 0 with AdamW(1e-4) in
    bf16 over fp32 masters: the eager step, on ``mesh`` with the layers'
    hints where one is given."""
    from paddle_tpu_torch.core.dtypes import get_policy
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.nn.module import sharding_specs
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import api
    from paddle_tpu_torch.train import build_train_step, make_train_state
    model = GPT(_gpt_small(), device=device, seed=0)
    opt = AdamW(model.parameters(), learning_rate=1e-4)
    step = build_train_step(lambda m, ids: m.loss(ids), opt,
                            policy=get_policy("bf16"), cuda_graphs=False)
    state = make_train_state(model, opt)
    if mesh is None:
        return step, state, model
    run, state = api.shard_train_step(step, mesh, state,
                                      hints=sharding_specs(model))
    return run, state, model


def pipe_gpt_leg(rank, n, device):
    """(d): GPT-2 small (vocab 50304, 12 x 768, 1024 positions) with
    ``pipeline=True`` at pp=n, 8 x 512, 2 bf16 AdamW steps (causal K5)."""
    mesh = _par_mesh(device, pp=n)
    run, state, model = _gpt_step(device, mesh)
    ids = _gpt_ids(model.cfg, device)
    out = _pipe_steps(device, run, state, ids, PIPE_GPT_STEPS)
    del run, state, model
    _free(device)
    return out


def _hop_bytes(rows, width, policy, seq=None):
    """Bytes of one microbatch's activation: ``rows / M`` sequences of
    ``seq`` (``TRAIN_SEQ``) tokens of ``width``, bf16 under the bf16
    policy, else fp32."""
    seq = TRAIN_SEQ if seq is None else seq
    return rows // PIPE_M * seq * width * (2 if policy == "bf16" else 4)


def _check_pipe_staging(label, rows, device, want_bytes):
    """Each stage rank staged the reckoned bytes through the host (on the
    card; the CPU stages nothing)."""
    if device.type != "cuda":
        return
    for rank, r in enumerate(rows):
        if r["staged_bytes"] != want_bytes:
            raise AssertionError(f"9 {label} rank {rank}: staged "
                                 f"{r['staged_bytes']} bytes, reckoned "
                                 f"{want_bytes}")


def _check_pipe_launches(label, rows, want):
    fwd, dkv, dq = (e.name for e in flash_entries())
    for rank, r in enumerate(rows):
        got = {"K5": r["launches"][fwd], "K6a": r["launches"][dkv],
               "K6b": r["launches"][dq]}
        if got != want:
            raise AssertionError(f"9 {label} rank {rank}: launches {got}, "
                                 f"reckoned {want}")


def _pipe_dir():
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    PIPE_DIR.mkdir(parents=True)


def pipeline_train(device, two):
    """Phase 9: pipelines over "pp" on a gloo group of 2 processes on
    ``device`` (the staging switch on) against one process at pp=1
    (module docstring). ``two``: the ranks' results of :data:`PIPE_LEGS`,
    which phase 8's group ran; this makes the checks and the pp=1
    references."""
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.resilience.snapshot import (SnapshotEngine,
                                                      flatten_tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.monotonic()
    n = 2
    legs_s = sum(two[0][leg]["seconds"] for leg in PIPE_LEGS)
    stats = {"seconds": {leg: two[0][leg]["seconds"] for leg in PIPE_LEGS}}

    # (a) each rank against the sequential stack
    for rank, r in enumerate(two):
        for case, errs in r["pipe_toy"].items():
            if case == "seconds":
                continue
            tol = PIPE_TOY_TOL[torch.bfloat16 if "bf16" in case
                               else torch.float32]
            if max(errs.values()) > tol:
                raise AssertionError(f"9a {case} rank {rank}: {errs} "
                                     f"(tolerance {tol})")
    stats["toy"] = {k: v for k, v in two[0]["pipe_toy"].items()
                    if k != "seconds"}
    log("  9a gpipe / circular (v=2) toy stack vs sequential, max error "
        "over its largest value, rank 0: " + json.dumps(stats["toy"]))

    # (b) against pp=1 in this process
    for label, policy, layers, rtol in (
            ("bf16", "bf16", 12, PIPE_BF16_RTOL),
            ("fp32_2layer", None, 2, PIPE_FP32_RTOL)):
        cfg = BertConfig.base(num_layers=layers, dropout=0.0,
                              attn_dropout=0.0, pipeline=True,
                              pp_microbatches=PIPE_M)
        rows = [r["pipe_bert"][label] for r in two]
        _check_pipe_launches(f"b {label}", rows,
                             pipe_reckoning(layers, n, PIPE_STEPS))
        for r in rows:
            if r["losses"] != rows[0]["losses"]:
                raise AssertionError(f"9b {label}: the ranks' losses differ")
        _check_pipe_staging(f"b {label}", rows, device, pipe_hop_ends(
            n, PIPE_M, PIPE_STEPS) * _hop_bytes(PIPE_BATCH,
                                                cfg.hidden_size, policy))
        batch = bert_batch(cfg, PIPE_BATCH, TRAIN_SEQ, device, seed=9)
        from paddle_tpu_torch.kernels import registry
        registry.reset_launches()
        want, _ = _one_process_bert(device, cfg, batch, PIPE_STEPS,
                                    policy=policy)
        pp1 = {e.name: e.launches for e in flash_entries()}
        rel = _close(rows[0]["losses"], want, rtol, 0.0,
                     f"9b {label} pp=2 vs pp=1")
        loop = {}
        if policy is None:
            # the timetable itself, against the stacked layers' plain
            # loop over the whole batch on the same weights
            loop["losses_loop"], _ = _one_process_bert(
                device, dataclasses.replace(cfg, pipeline=False,
                                            stacked_layers=True),
                batch, PIPE_STEPS)
            loop["max_rel_err_pp1_vs_loop"] = _close(
                want, loop["losses_loop"], rtol, 0.0,
                f"9b {label} pp=1 vs the stacked loop")
        stats[f"bert_{label}"] = {
            "losses_pp1": want, "max_rel_err": rel, **loop,
            "launches_pp1": pp1,
            "reckoned_per_rank": pipe_reckoning(layers, n, PIPE_STEPS),
            "per_rank": [{k: r[k] for k in (
                "losses", "launches", "staged_calls", "staged_bytes",
                "step_s", "peak_bytes", "encoder_rows")} for r in rows]}
        log(f"  9b BERT-base {label} pp=2 (GPipe, M={PIPE_M}, "
            f"{PIPE_BATCH} x {TRAIN_SEQ}) vs pp=1: "
            + json.dumps(stats[f"bert_{label}"]))

    # (c) the circular schedule's first step against (b)'s
    rows = [r["pipe_bert"]["circular_bf16"] for r in two]
    _check_pipe_launches("c circular", rows, pipe_reckoning(12, n, 1))
    _check_pipe_staging("c circular", rows, device, pipe_hop_ends(
        n, PIPE_M, 1, v=2) * _hop_bytes(PIPE_BATCH,
                                        BertConfig.base().hidden_size,
                                        "bf16"))
    first = two[0]["pipe_bert"]["bf16"]["losses"][0]
    rel = _close([r["losses"][0] for r in rows], [first] * n,
                 PIPE_BF16_RTOL, 0.0, "9c circular vs gpipe")
    stats["bert_circular"] = {
        "max_rel_err_vs_gpipe_first_step": rel,
        "per_rank": [{k: r[k] for k in (
            "losses", "launches", "staged_calls", "staged_bytes",
            "step_s", "peak_bytes", "encoder_rows")} for r in rows]}
    log("  9c circular (v=2, pre-interleaved) vs (b)'s first step: "
        + json.dumps(stats["bert_circular"]))

    # (d) GPT-2 small against pp=1
    rows = [r["pipe_gpt"] for r in two]
    _check_pipe_launches("d gpt", rows, pipe_reckoning(12, n,
                                                        PIPE_GPT_STEPS))
    _check_pipe_staging("d gpt", rows, device, pipe_hop_ends(
        n, PIPE_M, PIPE_GPT_STEPS) * _hop_bytes(
            PIPE_GPT_BATCH, _gpt_small().hidden_size, "bf16"))
    step, state, model = _gpt_step(device)
    ids = _gpt_ids(model.cfg, device)
    want = [float(step(state, **ids)[1]["loss"])
            for _ in range(PIPE_GPT_STEPS)]
    del step, state, model
    _free(device)
    rel = _close(rows[0]["losses"], want, PIPE_BF16_RTOL, 0.0,
                 "9d GPT pp=2 vs pp=1")
    stats["gpt"] = {"losses_pp1": want, "max_rel_err": rel, "per_rank": [
        {k: r[k] for k in ("losses", "launches", "staged_calls",
                           "staged_bytes", "step_s", "peak_bytes")}
        for r in rows]}
    log("  9d GPT-2 small pp=2 vs pp=1: " + json.dumps(stats["gpt"]))

    # (e) the pp=2 snapshot restored whole here
    t0 = time.monotonic()
    eng = SnapshotEngine(str(PIPE_DIR / "snap"))
    back = flatten_tree(eng.restore(1))
    eng.close()
    whole = torch.load(PIPE_DIR / "whole.pt")
    bad = [k for k, v in whole.items()
           if not torch.equal(torch.as_tensor(back[k]).cpu(), v)]
    if bad:
        raise AssertionError(f"9e one-process restore: {len(bad)} leaves "
                             f"differ ({bad[:3]})")
    stats["snapshot"] = {"ranks": [r["pipe_bert"]["snapshot"] for r in two],
                         "whole_restore_s": time.monotonic() - t0,
                         "leaves": len(whole)}
    log("  9e pp=2 snapshot restored at pp=2 and whole: "
        + json.dumps(stats["snapshot"]))
    del back, whole
    stats["main_path_launches"] = [r["pipe_bert"]["bf16"]["launches"]
                                   for r in two]
    stats["seconds"]["checks_and_pp1"] = time.monotonic() - t_phase
    stats["seconds"]["phase"] = legs_s + stats["seconds"]["checks_and_pp1"]
    log(f"  phase 9 took {stats['seconds']['phase']:.1f} s (its legs on "
        "the ranks, then the checks and pp=1 here): "
        + json.dumps(stats["seconds"]))
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    return stats


#: phase 9's legs, run by phase 8's two-rank group
PIPE_LEGS = ("pipe_toy", "pipe_bert", "pipe_gpt")

#: the legs a group's ranks run (:func:`_group_rank`), by name
GROUP_LEGS = {"tp_serve": _tp_legs, "ring": ring_leg,
              "ring_timed": functools.partial(ring_leg, timed=True),
              "bert_ring": bert_ring_leg, "dp": dp_leg, "tp": tp_leg,
              "local_sgd": local_sgd_leg, "restore": restore_leg,
              "pipe_toy": pipe_toy_leg, "pipe_bert": pipe_bert_leg,
              "pipe_gpt": pipe_gpt_leg}


def _check_ring_counts(label, n, rows):
    """Every rank launched K5, K6a and K6b; a causal rank r ran the
    diagonal block and r earlier ones and skipped the n - 1 - r later
    ones without a launch; K5 launches = forward blocks run, K6a = K6b =
    backward blocks run."""
    fwd, dkv, dq = (e.name for e in flash_entries())
    for rank, ranks_rows in enumerate(rows):
        for name, _, causal in RING_CASES:
            r = ranks_rows[name]
            want = ({"diagonal": 1, "visible": rank, "skipped": n - 1 - rank}
                    if causal else {"diagonal": 0, "visible": n,
                                    "skipped": 0})
            run = want["diagonal"] + want["visible"]
            if r["cases"]["fwd"] != want or r["cases"]["bwd"] != want:
                raise AssertionError(f"8a {label} {name} rank {rank}: "
                                     f"blocks {r['cases']}, want {want}")
            if (r["launches"][fwd], r["launches"][dkv],
                    r["launches"][dq]) != (run, run, run):
                raise AssertionError(f"8a {label} {name} rank {rank}: "
                                     f"launches {r['launches']} for {run} "
                                     "blocks run")


def _one_process_bert(device, cfg, batch, steps, *, policy=None, seed=0):
    """The unsharded reference: the same BERT and AdamW(1e-4) in this
    process, eager. Returns (losses, {name: parameter})."""
    from paddle_tpu_torch.core.dtypes import get_policy
    from paddle_tpu_torch.models.bert import BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.train import build_train_step, make_train_state
    model = BertForPretraining(cfg, device=device, seed=seed)
    opt = AdamW(model.parameters(), learning_rate=1e-4)
    step = build_train_step(_bert_loss, opt, cuda_graphs=False,
                            policy=get_policy(policy) if policy else None)
    state = make_train_state(model, opt)
    losses = [float(step(state, **batch)[1]["loss"]) for _ in range(steps)]
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    del state, model, opt, step
    _free(device)
    return losses, params


def _close(got, want, rtol, atol, what):
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: {got} against {want} (rtol {rtol}, "
                             f"atol {atol})")
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want))


def parallel_train(device):
    """Phase 8: training across ranks; every group a gloo group of
    processes on ``device`` whose mesh has the staging switch on (module
    docstring)."""
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.resilience.snapshot import (SnapshotEngine,
                                                      flatten_tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    PAR_DIR.mkdir(parents=True)
    stats = {}
    t_phase = time.monotonic()

    # (a) at sp=4; then the sp=2 group: (a) timed, (b), (c), (d), (e)
    t0 = time.monotonic()
    four = group_run(4, ("ring",), device, "8a sp=4 group")
    _check_ring_counts("sp=4", 4, [r["ring"] for r in four])
    # phase 9's pp=2 legs ride this group: one start-up for both phases
    _pipe_dir()
    two = group_run(2, ("ring_timed", "bert_ring", "dp", "tp", "local_sgd")
                    + PIPE_LEGS, device, "8a-8e sp/dp/tp=2 and 9 pp=2 group")
    _check_ring_counts("sp=2", 2, [r["ring_timed"] for r in two])
    group_s = time.monotonic() - t0
    for label, rows in (("sp=2", [r["ring_timed"] for r in two]),
                        ("sp=4", [r["ring"] for r in four])):
        log(f"  8a ring {label}: " + json.dumps({
            name: {"max_abs_err": rows[0][name]["max_abs_err"],
                   "per_rank": [{k: r[name][k] for k in (
                       "launches", "cases", "hops", "staged_bytes_per_hop")}
                       for r in rows]}
            for name, _, _ in RING_CASES}))
    timing = two[0]["ring_timed"]["bf16"]
    log("  8a ring sp=2 bf16 fwd+bwd (gloo on one card: not a parallel "
        f"speed; the ring's windows wait on the host's staging, so they "
        f"are wall time): kernels {timing['ms']:.4f} ms (host "
        f"{timing['host_ms']:.4f}), plain blocks {timing['plain_ms']:.4f} "
        f"ms, SDPA fwd+bwd on the whole sequence "
        f"{_ms_text(timing, 'library_')}, bound {timing['bound_ms']:.4f} ms"
        f" ({timing['bound_by']})")
    stats["ring"] = timing

    # (b) against sp=1 with attn_impl="auto"
    fwd, dkv, dq = (e.name for e in flash_entries())
    for label, policy, layers, rtol in (
            ("bf16", "bf16", 12, RING_BF16_RTOL),
            ("fp32_2layer", None, 2, 1e-4)):
        legs = [r["bert_ring"][label] for r in two]
        for rank, leg in enumerate(legs):
            if min(leg["launches"][k] for k in (fwd, dkv, dq)) <= 0:
                raise AssertionError(f"8b {label} rank {rank}: launches "
                                     f"{leg['launches']}")
            if leg["losses"] != legs[0]["losses"]:
                raise AssertionError(f"8b {label}: the ranks' losses differ")
        cfg = BertConfig.base(num_layers=layers, dropout=0.0,
                              attn_dropout=0.0)
        want, _ = _one_process_bert(
            device, cfg, bert_batch(cfg, SP_BATCH, TRAIN_SEQ, device,
                                    seed=3), SP_STEPS, policy=policy)
        rel = _close(legs[0]["losses"], want, rtol, 0.0,
                     f"8b {label} sp=2 ring vs sp=1")
        stats[f"bert_ring_{label}"] = {**legs[0], "losses_sp1": want,
                                       "max_rel_err": rel}
        log(f"  8b BERT {label} sp=2 ring vs sp=1 auto: "
            + json.dumps(stats[f"bert_ring_{label}"]))
    log(f"  8b took {two[0]['bert_ring']['seconds']:.1f} s on the ranks")

    # (c) against one process at 2 x 24 x 512
    cfg = BertConfig.base(num_layers=PAR_LAYERS, dropout=0.0,
                          attn_dropout=0.0)
    want, ref = _one_process_bert(
        device, cfg, bert_batch(cfg, 2 * DP_BATCH, TRAIN_SEQ, device,
                                seed=5), DP_STEPS)
    for name in ("replicated", "fsdp"):
        legs = [r["dp"][name] for r in two]
        rel = _close(legs[0]["losses"], want, 2e-5, 2e-6,
                     f"8c {name} dp=2 vs one process")
        whole = torch.load(PAR_DIR / f"{name}_params.pt")
        err = max(_held_params(k, whole[k].to(device), ref[k], DP_STEPS,
                               1e-4) for k in ref)
        stats[f"dp_{name}"] = {**legs[0], "losses_one_process": want,
                               "max_rel_err": rel, "param_max_abs_err": err,
                               "peak_bytes_ranks": [leg["peak_bytes"]
                                                    for leg in legs]}
        log(f"  8c {name} dp=2 vs one process at 48 x 512: "
            + json.dumps(stats[f"dp_{name}"]))
        del whole
    log("  8c peak memory per rank, fsdp vs replicated: " + json.dumps({
        n: stats[f"dp_{n}"]["peak_bytes_ranks"]
        for n in ("fsdp", "replicated")}) + "; the leg took "
        f"{two[0]['dp']['seconds']:.1f} s on the ranks")
    del ref

    # (d) against tp=1
    want, _ = _one_process_bert(
        device, cfg, bert_batch(cfg, TP_BATCH, TRAIN_SEQ, device, seed=7),
        TP_STEPS)
    rel = _close(two[0]["tp"]["losses"], want, 2e-4, 1e-5,
                 "8d tp=2 vs tp=1")
    stats["tp"] = {**two[0]["tp"], "losses_tp1": want, "max_rel_err": rel}
    log("  8d Megatron tp=2 vs tp=1: " + json.dumps(stats["tp"]))

    # (e)
    syncs = [r["local_sgd"]["syncs"] for r in two]
    if [s["step"] for s in syncs[0]] != list(range(0, LOCAL_SGD_STEPS,
                                                   LOCAL_SGD_K)) or not all(
            s["equal_to_mean"] and s["equal_across_ranks"]
            for ss in syncs for s in ss) or not any(
            s["ranks_differed_before"] for s in syncs[0]):
        raise AssertionError(f"8e LocalSGD: {syncs}")
    stats["local_sgd"] = two[0]["local_sgd"]
    log("  8e LocalSGD k=2 dp=2: " + json.dumps(stats["local_sgd"]))

    # (f) a fresh fsdp=2 group restores with shardings=, this process
    # without
    t0 = time.monotonic()
    fresh = group_run(2, ("restore",), device, "8f fresh fsdp=2 group")
    eng = SnapshotEngine(str(PAR_DIR / "snap"))
    back = flatten_tree(eng.restore(1))
    eng.close()
    whole = torch.load(PAR_DIR / "whole.pt")
    bad = [k for k, v in whole.items() if not torch.equal(back[k], v)]
    if bad:
        raise AssertionError(f"8f one-process restore: {len(bad)} leaves "
                             f"differ ({bad[:3]})")
    stats["snapshot"] = {"save_s": two[0]["dp"]["save_s"],
                         "restore_ranks": [r["restore"] for r in fresh],
                         "fresh_group_and_whole_restore_s":
                             time.monotonic() - t0,
                         "leaves": len(whole)}
    log("  8f sharded snapshot: " + json.dumps(stats["snapshot"]))
    del back, whole
    stats["pipe_ranks"] = [{leg: r[leg] for leg in PIPE_LEGS} for r in two]
    pipe_s = sum(two[0][leg]["seconds"] for leg in PIPE_LEGS)
    stats["ring_calls_main_path"] = two[0]["bert_ring"]["bf16"]["ring_calls"]
    stats["main_path_launches"] = two[0]["bert_ring"]["bf16"]["launches"]
    stats["seconds"] = {
        "groups_a_to_e": group_s - pipe_s,
        "phase": time.monotonic() - t_phase - pipe_s,
        "sp4_ring": four[0]["ring"]["seconds"],
        **{leg: two[0][leg]["seconds"] for leg in (
            "ring_timed", "bert_ring", "dp", "tp", "local_sgd")}}
    log(f"  phase 8 took {stats['seconds']['phase']:.1f} s: "
        + json.dumps(stats["seconds"]))
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    return stats


# -- phase 10: embedding serving ------------------------------------------------

#: the reference's embedding-serving configuration for a chip
#: (``bench.py`` ``run_bench_embedding_serving``)
EMBED_VOCAB, EMBED_FIELDS, EMBED_DIM, EMBED_BATCH = 2_000_000, 26, 16, 2048
EMBED_HEAD, EMBED_CAPACITY, EMBED_MIN_BUCKET = 8192, 1 << 16, 8192
EMBED_HIDDEN, EMBED_BATCHES, EMBED_PUSH_ROWS = (400, 400), 48, 64
#: (f): the reference's host-KV training configuration for a chip
#: (``bench.py`` ``run_bench_deepfm``)
KV_TRAIN_BATCH, KV_TRAIN_STEPS = 4096, 4
EMBED_DIR = TRAIN_DIR.parent / "chip_smoke_embedding"
#: the seed every leg's traffic derives from
SEED_EMBED = 0
#: (c)'s occurrence-weighted hit rate must fall here: 80% of lookups on
#: a head that stays resident, plus the tail's few resident rows
EMBED_HIT_RANGE = (0.79, 0.82)


def _embed_batches(rng, n):
    """80% of lookups uniform on the hot head, 20% on the tail."""
    out = []
    shape = (EMBED_BATCH, EMBED_FIELDS)
    for _ in range(n):
        hot = rng.integers(0, EMBED_HEAD, size=shape)
        tail = rng.integers(EMBED_HEAD, EMBED_VOCAB, size=shape)
        pick = rng.random(shape) < 0.8
        out.append(np.where(pick, hot, tail).astype(np.int64))
    return out


def _embed_push(rng, channel):
    ids = rng.integers(0, EMBED_HEAD, size=(EMBED_PUSH_ROWS,)).astype(
        np.int64)
    rows = rng.normal(0, 0.01, size=(EMBED_PUSH_ROWS, 1 + EMBED_DIM))
    channel.push_rows(ids, rows.astype(np.float32))


def _embed_store(store_cls=None, seed=0, **kw):
    from paddle_tpu_torch.parallel.host_kv import HostKVStore
    return (store_cls or HostKVStore)(1 + EMBED_DIM, optimizer="adagrad",
                                      init_scale=0.01, seed=seed, **kw)


def _embed_engine(store, model, device, **kw):
    from paddle_tpu_torch import embedding_serving as es
    from paddle_tpu_torch import observability as obs
    reg = obs.MetricsRegistry()
    ch = es.StreamingUpdateChannel(store, registry=reg)
    kw.setdefault("max_staleness_s", 5.0)
    eng = es.EmbeddingServingEngine(
        store, model, capacity=EMBED_CAPACITY, policy="lru",
        min_bucket=EMBED_MIN_BUCKET, max_pending=4, channel=ch,
        registry=reg, device=device, **kw)
    return eng, ch, reg


def _deepfm(device, seed=0):
    from paddle_tpu_torch.models.deepfm import DeepFMHostKV
    return DeepFMHostKV(EMBED_FIELDS, EMBED_DIM, EMBED_HIDDEN,
                        device=device, seed=seed)


def _pipelined(eng, batches, rng, channel, submit_s=None):
    """Submit/step two deep, ``EMBED_PUSH_ROWS`` pushed every 4th batch
    (the reference's bench loop); the outputs by batch index."""
    out, rid_of = {}, {}

    def drain(done):
        for rid, o in done.items():
            out[rid_of[rid]] = o

    for i, b in enumerate(batches):
        if i % 4 == 3:
            _embed_push(rng, channel)
        t0 = time.perf_counter()
        rid_of[eng.submit(b)] = i
        if submit_s is not None:
            submit_s.append(time.perf_counter() - t0)
        while eng.pending() >= 2:
            drain(eng.step())
    while eng.pending():
        drain(eng.step())
    return [out[i] for i in range(len(batches))]


def embed_rows_leg(device):
    """(a) an engine without a model, every push applied before the next
    batch: every served row equals ``store.pull`` bit for bit, and the
    cache's index holds after every step."""
    from paddle_tpu_torch.observability import recompile
    store = _embed_store()
    eng, ch, reg = _embed_engine(store, None, device, max_lag_updates=0)
    eng.warmup((EMBED_BATCH, EMBED_FIELDS))
    captures = recompile.capture_count()
    ptr = eng.cache.table.data_ptr()
    rng = np.random.default_rng(SEED_EMBED)
    t0 = time.monotonic()
    for i, b in enumerate(_embed_batches(rng, EMBED_BATCHES)):
        if i % 4 == 3:
            _embed_push(rng, ch)
        rows = eng.serve(b)
        uniq = np.unique(b)
        want = store.pull(uniq)
        if not np.array_equal(rows[:uniq.size], want):
            bad = int((rows[:uniq.size] != want).any(1).sum())
            raise AssertionError(f"10a batch {i}: {bad} of {uniq.size} "
                                 "served rows differ from the store's")
        eng.cache.check_invariants()
    seconds = time.monotonic() - t0
    if recompile.capture_count() != captures:
        raise AssertionError("10a captured after warmup")
    if eng.cache.table.data_ptr() != ptr:
        raise AssertionError("10a: the cache's table moved")
    applied = int(reg.counter("embedding_stream_rows_applied_total").value())
    ch.stop()
    out = {"batches": EMBED_BATCHES, "rows_equal_store": True,
           "invariants_held": True, "rows_applied": applied,
           "evictions": int(reg.counter(
               "embedding_cache_evictions_total").value()),
           "seconds": seconds}
    log("  10a rows (no model, max_lag_updates=0): " + json.dumps(out))


def embed_deepfm_leg(device):
    """(b) the engine's probabilities on the card against the plain
    forward on the CPU from the same pulled rows (fp32, TF32 off), and
    the forward graph's replay against the eager forward on the card."""
    model = _deepfm(device)
    cpu = _deepfm("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    store = _embed_store()
    eng, ch, _ = _embed_engine(store, model, device, max_lag_updates=0)
    eng.warmup((EMBED_BATCH, EMBED_FIELDS))
    rng = np.random.default_rng(SEED_EMBED + 1)
    worst, replay_equal = 0.0, True
    for i, b in enumerate(_embed_batches(rng, 4)):
        probs = eng.serve(b)
        uniq, inv = np.unique(b, return_inverse=True)
        inv = inv.reshape(b.shape)
        w = _gather_width(eng, uniq.size)
        rows = np.zeros((w, 1 + EMBED_DIM), np.float32)
        rows[:uniq.size] = store.pull(uniq)
        with torch.no_grad():
            want = cpu.predict_proba(torch.from_numpy(rows),
                                     torch.from_numpy(inv)).numpy()
            slots = torch.from_numpy(eng.cache.lookup_slots(
                uniq, pad_to=w)).to(device)
            eager = model.predict_proba(
                eng.cache.table.index_select(0, slots).float(),
                torch.from_numpy(inv).to(device)).cpu().numpy()
        worst = max(worst, float(np.abs(probs - want).max()))
        replay_equal &= bool(np.array_equal(probs, eager))
    ch.stop()
    out = {"max_abs_err_vs_cpu": worst, "tol": 1e-5,
           "replay_equals_eager": replay_equal}
    log("  10b DeepFM (fp32, TF32 off): " + json.dumps(out))
    if worst > 1e-5 or not replay_equal:
        raise AssertionError(f"10b failed: {out}")


def _gather_width(eng, n):
    from paddle_tpu_torch.embedding_serving.device_cache import _pow2_bucket
    return _pow2_bucket(n, eng.cache.min_gather_bucket,
                        max(eng.cache.capacity, n))


def _span_s(tracer, name):
    return float(sum(s.duration_s for s in tracer.spans(name)))


def embed_main_leg(device, model):
    """(c) the main path, timed: the reference's configuration after
    ``warmup((2048, 26))``, pipelined two deep with pushes streaming in."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.observability import recompile
    store = _embed_store()
    tracer = obs.tracing.Tracer(capacity=1 << 16)
    eng, ch, reg = _embed_engine(store, model, device, tracer=tracer)
    plan = eng.warmup_plan((EMBED_BATCH, EMBED_FIELDS))
    c0 = recompile.capture_count()
    t0 = time.monotonic()
    eng.warmup((EMBED_BATCH, EMBED_FIELDS))
    warmup_s = time.monotonic() - t0
    warm_captures = recompile.capture_count() - c0
    rng = np.random.default_rng(SEED_EMBED + 2)
    for b in _embed_batches(rng, 2):        # the hot head goes resident
        eng.serve(b)
    batches = _embed_batches(rng, EMBED_BATCHES)
    hits0 = (eng._served_hits, eng._served_rows)
    tracer.clear()
    launches0 = registry.launch_counts()
    c1 = recompile.capture_count()
    submit_s = []
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    outs = _pipelined(eng, batches, rng, ch, submit_s)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    after = recompile.capture_count() - c1
    hit_rate = (eng._served_hits - hits0[0]) / (eng._served_rows - hits0[1])
    # exact percentiles from the window's spans (submit -> served, and a
    # miss pull's issue -> rows ready)
    lookups = [s.duration_s for s in tracer.spans("embed.request")]
    pulls = [s.attrs["pull_age_s"] for s in tracer.spans("embed.pull_wait")]
    stats = {
        "examples_per_s": EMBED_BATCH * EMBED_BATCHES / wall,
        "wall_s": wall, "batches": EMBED_BATCHES,
        "lookup_p50_s": float(np.percentile(lookups, 50)),
        "lookup_p99_s": float(np.percentile(lookups, 99)),
        "miss_pull_p99_s": float(np.percentile(pulls, 99)),
        "hit_rate": hit_rate,
        "hit_rate_cumulative": reg.gauge("embedding_serving_hit_rate")
        .value(),
        "evictions": int(reg.counter(
            "embedding_cache_evictions_total").value()),
        "streaming_rows_applied": int(reg.counter(
            "embedding_stream_rows_applied_total").value()),
        "staleness_s": reg.gauge("embedding_serving_staleness_seconds")
        .value(),
        "warmup_captures": warm_captures, "warmup_plan": len(plan),
        "warmup_s": warmup_s, "captures_after_warmup": after,
        "wall_split_s": {
            "submit (dedup, gate, split, pull issue)": float(sum(submit_s)),
            "pull_wait": _span_s(tracer, "embed.pull_wait"),
            "install": _span_s(tracer, "embed.install"),
            "gather_forward": _span_s(tracer, "embed.gather_forward")},
        "registered_kernel_launches": registry.count_delta(
            registry.launch_counts(), launches0),
    }
    more = iter(enumerate(_embed_batches(rng, 16)))

    def one():                       # the same loop, one batch a call
        i, b = next(more)
        if i % 4 == 3:
            _embed_push(rng, ch)
        eng.submit(b)
        while eng.pending() >= 2:
            eng.step()

    prof = profile_window(one, 8)
    while eng.pending():
        eng.step()
    stats["device_busy_share"] = prof["device_busy_share"]
    stats["profiled_top_kernels"] = prof["top_kernels"][:5]
    log(f"  10c main path (DeepFM, {EMBED_BATCHES} x {EMBED_BATCH} x "
        f"{EMBED_FIELDS}, pipelined two deep): " + json.dumps(stats))
    if warm_captures != len(plan) or after != 0:
        raise AssertionError(f"10c captures: warmup {warm_captures} of "
                             f"{len(plan)}, after warmup {after}")
    if not EMBED_HIT_RANGE[0] <= hit_rate <= EMBED_HIT_RANGE[1]:
        raise AssertionError(f"10c hit rate {hit_rate} outside "
                             f"{EMBED_HIT_RANGE}")
    if stats["registered_kernel_launches"]:
        raise AssertionError("10c launched a registered kernel: "
                             f"{stats['registered_kernel_launches']}")
    if not all(np.isfinite(o).all() and o.shape == (EMBED_BATCH,)
               for o in outs):
        raise AssertionError("10c: probabilities not finite or misshapen")
    return eng, ch, store, stats


def embed_remote_leg(device, model):
    """(d) the engine over a ``RemoteKVStore`` to an in-process
    ``KVServer`` of the same seed against the local store, the same
    traffic on 8 batches (every push applied before the next batch, so
    both serve the same rows): probabilities bit for bit."""
    from paddle_tpu_torch.parallel.kv_server import KVServer, RemoteKVStore
    srv = KVServer(1 + EMBED_DIM, optimizer="adagrad", init_scale=0.01,
                   seed=0)
    remote = RemoteKVStore("localhost", srv.port)
    outs = []
    try:
        for store in (remote, _embed_store()):
            eng, ch, _ = _embed_engine(store, model, device,
                                       max_lag_updates=0)
            eng.warmup((EMBED_BATCH, EMBED_FIELDS))
            rng = np.random.default_rng(SEED_EMBED + 3)
            t0 = time.monotonic()
            outs.append(_pipelined(eng, _embed_batches(rng, 8), rng, ch))
            outs.append(time.monotonic() - t0)
            ch.stop()
    finally:
        remote.close()
        srv.stop()
    equal = all(np.array_equal(a, b) for a, b in zip(outs[0], outs[2]))
    out = {"batches": 8, "probabilities_equal_local": equal,
           "remote_s": outs[1], "local_s": outs[3]}
    log("  10d remote store (in-process KVServer): " + json.dumps(out))
    if not equal:
        raise AssertionError("10d: remote and local probabilities differ")


def embed_snapshot_leg(device, model, eng, ch, store):
    """(e) ``engine.snapshot`` -> a fresh store of the same configuration
    (a restarted server) -> ``restore``: the rows (the hot head, which the
    pushes rewrote) and version counters bit for bit, and the next
    batch's probabilities."""
    shutil.rmtree(EMBED_DIR, ignore_errors=True)
    t0 = time.monotonic()
    eng.snapshot(str(EMBED_DIR), step=1)
    save_s = time.monotonic() - t0
    store2 = _embed_store()
    eng2, ch2, _ = _embed_engine(store2, model, device)
    head = np.arange(EMBED_HEAD, dtype=np.int64)
    differed = not np.array_equal(store2.pull(head), store.pull(head))
    t0 = time.monotonic()
    versions = eng2.restore(str(EMBED_DIR))
    restore_s = time.monotonic() - t0
    rng = np.random.default_rng(SEED_EMBED + 4)
    b = _embed_batches(rng, 1)[0]
    rows_equal = bool(np.array_equal(store2.pull(head), store.pull(head)))
    with ch._vlock:
        want_versions = dict(ch._versions)
    probs_equal = bool(np.array_equal(eng.serve(b), eng2.serve(b)))
    out = {"rows": len(store), "restored_rows": len(store2),
           "head_differed_before_restore": differed,
           "rows_equal": rows_equal, "versions": len(versions),
           "versions_equal": versions == want_versions,
           "next_batch_equal": probs_equal, "save_s": save_s,
           "restore_s": restore_s}
    ch2.stop()
    shutil.rmtree(EMBED_DIR, ignore_errors=True)
    log("  10e snapshot -> fresh store -> restore: " + json.dumps(out))
    if not (differed and rows_equal and out["versions_equal"]
            and probs_equal and versions):
        raise AssertionError(f"10e failed: {out}")


def embed_cold_leg(device, model, store, qps_cached):
    """The reference's cold yardstick: per batch, pull the whole table
    from the host store, copy it to the card, and run the forward with
    the batch's ids indexing it (4 batches)."""
    every = np.arange(EMBED_VOCAB, dtype=np.int64)
    rng = np.random.default_rng(SEED_EMBED + 5)
    batches = _embed_batches(rng, 5)
    times = []
    with torch.no_grad():
        for i, b in enumerate(batches):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            table = torch.from_numpy(store.pull(every)).to(device)
            out = model.predict_proba(table, torch.from_numpy(b).to(device))
            out.cpu()
            if i:                  # the first call warms up
                times.append(time.perf_counter() - t0)
    qps_cold = EMBED_BATCH * len(times) / sum(times)
    out = {"batches": len(times), "examples_per_s": qps_cold,
           "batch_p99_s": float(np.percentile(times, 99)),
           "speedup_vs_cold": qps_cached / qps_cold}
    log("  10c cold yardstick (whole table pulled and copied per batch): "
        + json.dumps(out))
    return out


def embed_train_leg(device):
    """(f) ``DeepFMHostKV`` at the reference's training configuration for
    a chip, 4 steps through ``run_kv_epoch`` with prefetch; the first
    step's loss and row gradients against the same step on the CPU."""
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.parallel import host_kv as kv
    from paddle_tpu_torch.train import make_train_state
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(KV_TRAIN_STEPS):
        hot = rng.integers(0, 1000, size=(KV_TRAIN_BATCH, EMBED_FIELDS // 2))
        tail = rng.integers(1000, EMBED_VOCAB, size=(
            KV_TRAIN_BATCH, EMBED_FIELDS - EMBED_FIELDS // 2))
        ids = np.concatenate([hot, tail], 1).astype(np.int64)
        label = (rng.random(KV_TRAIN_BATCH) < 0.2).astype(np.float32)
        batches.append(dict(feat_ids=ids, label=label))

    card_model = _deepfm(device)

    def run(dev, steps):
        # the CPU step starts from the card's weights (the generators of
        # the two devices draw apart)
        model = _deepfm(dev)
        model.load_state_dict({k: v.to(dev) for k, v in
                               card_model.state_dict().items()})
        popt = opt.Adam(model.parameters(), learning_rate=1e-3)
        step = kv.build_kv_train_step(
            lambda m, rows, inv, label: m.loss(rows, inv, label), popt)
        first = {}

        def recorded(state, rows, **batch):
            state, grad_rows, metrics = step(state, rows, **batch)
            if not first:
                first.update(loss=float(metrics["loss"]),
                             grad_rows=grad_rows.cpu().numpy())
            return state, grad_rows, metrics

        emb = kv.HostKVEmbedding(_embed_store(), lr=0.05,
                                 min_bucket=1 << 12)
        state = make_train_state(model, popt)
        t0 = time.perf_counter()
        state, hist = kv.run_kv_epoch(recorded, state, emb, batches[:steps],
                                      prefetch=True)
        losses = [float(m["loss"]) for m in hist]    # waits for the card
        return first, losses, time.perf_counter() - t0

    card, losses, seconds = run(device, KV_TRAIN_STEPS)
    cpu, _, _ = run("cpu", 1)
    g, w = card["grad_rows"], cpu["grad_rows"]
    rel_loss = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    rel_grad = float(np.abs(g - w).max() / np.abs(w).max())
    out = {"steps": KV_TRAIN_STEPS, "steps_per_s": KV_TRAIN_STEPS / seconds,
           "examples_per_s": KV_TRAIN_STEPS * KV_TRAIN_BATCH / seconds,
           "losses": losses, "first_loss_rel_err": rel_loss,
           "first_row_grad_rel_err": rel_grad, "tol": 1e-5,
           "row_bucket": int(g.shape[0])}
    log(f"  10f host-KV training (DeepFM {EMBED_FIELDS} x {EMBED_DIM}, "
        f"batch {KV_TRAIN_BATCH}, Adam + adagrad rows): " + json.dumps(out))
    if rel_loss > 1e-5 or rel_grad > 1e-5 or not np.isfinite(losses).all():
        raise AssertionError(f"10f failed: {out}")


def embedding_serving(device):
    """Phase 10 (module docstring): (a)-(f), TF32 off throughout."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t = time.monotonic()
        embed_rows_leg(device)
        embed_deepfm_leg(device)
        model = _deepfm(device)
        eng, ch, store, stats = embed_main_leg(device, model)
        embed_remote_leg(device, model)
        embed_snapshot_leg(device, model, eng, ch, store)
        ch.stop()
        cold = embed_cold_leg(device, model, store, stats["examples_per_s"])
        embed_train_leg(device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    log(f"  phase 10 took {time.monotonic() - t:.1f} s")
    return {**stats, "cold": cold}


# -- phase 11: data, packed Transformer-big training and export ---------------

#: Transformer-big's packed WMT cell (``bench.py:368-393``): rows a batch,
#: the src and tgt buckets, pairs, their MultiSlot files and loader
#: threads; 3 warm-up and 10 timed steps
TF_ROWS, TF_LEN, TF_PAIRS, TF_FILES = 16, 256, 1500, 4
TF_WARM, TF_TIMED = 3, 10
TF_DIR = TRAIN_DIR.parent / "chip_smoke_transformer"
#: feeds of ``Transformer.loss_packed``, in its order
TF_KEYS = ("src", "src_seg", "src_pos", "tgt", "tgt_out", "tgt_seg",
           "tgt_pos")
#: int8 weights against bf16: max |logit difference| over the logits' std
TF_INT8_TOL = 0.25


def _tf_config(**kw):
    from paddle_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig.big(dropout=0.0, attn_dropout=0.0,
                                 vocab_size=32768, max_len=TF_LEN, **kw)


def _tf_loss(m, **b):
    return m.loss_packed(*(b[k] for k in TF_KEYS))


def tf_pairs(vocab, seed=0):
    """The reference bench's WMT-like pairs: lognormal(3.0, 0.6) lengths
    clipped to [4, 255], ids from [3, vocab); the target is the source
    (a copy task)."""
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.lognormal(3.0, 0.6, TF_PAIRS).astype(np.int64), 4,
                   TF_LEN - 1)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in lens]


def write_multislot(dirpath, seqs):
    """``seqs`` as MultiSlot lines (slots ``src`` and ``tgt``) over
    ``TF_FILES`` files; returns their paths."""
    dirpath.mkdir(parents=True, exist_ok=True)
    paths = [dirpath / f"part-{i:02d}.txt" for i in range(TF_FILES)]
    for i, path in enumerate(paths):
        with open(path, "w") as f:
            for s in seqs[i::TF_FILES]:
                text = " ".join(map(str, s))
                f.write(f"{len(s)} {text} {len(s)} {text}\n")
    return paths


def tf_epoch(paths, cfg):
    """file -> the MultiSlot feed (4 threads, ``global_shuffle(0)``) ->
    BOS/EOS framing -> the packer: (pairs loaded, the epoch's packed
    (rows, 256) batches as numpy, the pairs in feed order)."""
    from paddle_tpu_torch.data import packing
    from paddle_tpu_torch.data.native_feed import MultiSlotDataset
    ds = MultiSlotDataset([("src", "int64"), ("tgt", "int64")])
    ds.set_filelist([str(p) for p in paths])
    n = ds.load_into_memory(num_threads=4)
    ds.global_shuffle(0)
    srcs, tins, touts = [], [], []
    for b in ds.batches(64, drop_last=False, with_lengths=True):
        for i in range(b["src"].shape[0]):
            s = b["src"][i, :b["src_len"][i]].astype(np.int32)
            t = b["tgt"][i, :b["tgt_len"][i]].astype(np.int32)
            srcs.append(s)
            tins.append(np.concatenate([[cfg.bos_id], t]).astype(np.int32))
            touts.append(np.concatenate([t, [cfg.eos_id]]).astype(np.int32))
    batches = list(packing.packed_batches(
        srcs, tins, rows_per_batch=TF_ROWS, src_len=TF_LEN, tgt_len=TF_LEN,
        tgt_extras={"tgt_out": touts}))
    return n, batches, (srcs, tins, touts)


def padded_batches(pairs, n_batches):
    """The padded layout on the same shapes: one pair a row (the
    reference bench's ``padded()``)."""
    srcs, tins, touts = pairs
    out = []
    for lo in range(0, len(srcs), TF_ROWS):
        chunk = list(range(lo, min(lo + TF_ROWS, len(srcs))))
        b = {k: np.zeros((TF_ROWS, TF_LEN), np.int32) for k in TF_KEYS}
        for r, i in enumerate(chunk):
            for key, seq in (("src", srcs[i]), ("tgt", tins[i]),
                             ("tgt_out", touts[i])):
                b[key][r, :len(seq)] = seq
            for side, seq in (("src", srcs[i]), ("tgt", tins[i])):
                b[f"{side}_seg"][r, :len(seq)] = 1
                b[f"{side}_pos"][r, :len(seq)] = np.arange(len(seq))
        out.append(b)
        if len(out) == n_batches:
            break
    return out


def tf_flops_per_step(cfg, rows=TF_ROWS, s=TF_LEN):
    """Model FLOPs of one packed step over the whole (rows, 256) slabs,
    padding included (the reckoning of PERF.md §5): 6 per parameter per
    token slot for every matrix (encoder layer 4D^2 + 2DF, decoder layer
    8D^2 + 2DF, the tied output projection DV), and 12 per (query, key,
    head dim) for each attention (3x its 4 forward), the decoder's
    self-attention over its causal half."""
    d, f, v = cfg.d_model, cfg.ffn_size, cfg.vocab_size
    tokens = rows * s
    matmul = (cfg.num_encoder_layers * (4 * d * d + 2 * d * f)
              + cfg.num_decoder_layers * (8 * d * d + 2 * d * f) + d * v)
    pairs = ((cfg.num_encoder_layers + cfg.num_decoder_layers) * s * s
             + cfg.num_decoder_layers * s * (s + 1) // 2)
    return 6 * matmul * tokens + 12 * rows * d * pairs


def _tf_host(batch):
    return {k: v.detach().cpu().numpy() for k, v in batch.items()}


def tf_feed_and_train(device, paths):
    """(a) and (b): the main path. The epoch from the files, staged by
    ``DeviceLoader``, trains Transformer-big in bf16 through one captured
    graph; the padded layout on the same graph after it."""
    from paddle_tpu_torch.core.dtypes import get_policy
    from paddle_tpu_torch.data import packing
    from paddle_tpu_torch.data.native_feed import DeviceLoader
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.models.transformer import Transformer
    from paddle_tpu_torch.observability import recompile
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.train import build_train_step, make_train_state
    cfg = _tf_config()
    t0 = time.monotonic()
    n_pairs, epoch, pairs = tf_epoch(paths, cfg)
    feed_s = time.monotonic() - t0
    if n_pairs != TF_PAIRS:
        raise AssertionError(f"loaded {n_pairs} pairs, wrote {TF_PAIRS}")
    # the same files through the same feed, shuffle and packer again: the
    # CPU run the staged batches must equal bit for bit
    _, again, _ = tf_epoch(paths, cfg)
    steps = TF_WARM + TF_TIMED
    stream = [epoch[i % len(epoch)] for i in range(steps)]
    model = Transformer(cfg, device=device, seed=0)
    opt = Adam(model.parameters(), learning_rate=1e-4)
    state = make_train_state(model, opt)
    step = build_train_step(_tf_loss, opt, policy=get_policy("bf16"))
    captures0 = recompile.capture_count()
    loader = DeviceLoader(iter(stream), buffer_size=2, device=device)
    staged, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    it = iter(loader)
    t0 = time.monotonic()
    for _ in range(TF_WARM):
        batch = next(it)
        staged.append(_tf_host(batch))
        state, m = step(state, **batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    captures = recompile.capture_count()
    builds = step.builds
    registry.reset_launches()
    t0 = time.monotonic()
    for _ in range(TF_TIMED):
        batch = next(it)
        state, m = step(state, **batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {e.name: e.launches for e in flash_entries()}
    peak = torch.cuda.max_memory_allocated()
    feed_stats = loader.stats()
    loader.close()
    late = [a for a in feed_stats["pinned_allocations"]
            if a["captures_before"] > captures0]
    if len(again) != len(epoch) or not all(
            np.array_equal(a[k], b[k]) for a, b in zip(epoch, again)
            for k in TF_KEYS):
        raise AssertionError("two runs of the feed, shuffle and packer "
                             "over the same files differ")
    for i, b in enumerate(staged):       # read back in the warm-up
        if not all(np.array_equal(b[k], stream[i][k]) for k in TF_KEYS):
            raise AssertionError(f"staged batch {i} != the CPU run's")
    if device.type == "cuda" and builds != 1:
        raise AssertionError(f"{builds} captures in the warm-up")
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    per_step = {n: c / TF_TIMED for n, c in launches.items()}
    want_per_step = cfg.num_encoder_layers + 2 * cfg.num_decoder_layers
    if any(v != want_per_step for v in per_step.values()):
        raise AssertionError(f"flash launches per step {per_step}, "
                             f"expected {want_per_step} each")
    if recompile.capture_count() != captures:
        raise AssertionError("the train step captured after its first "
                             "graphed step")
    if late:
        raise AssertionError(f"pinned allocations after a capture: {late}")
    real = sum(int((b["tgt_seg"] > 0).sum())
               for b in stream[TF_WARM:steps])
    flops = tf_flops_per_step(cfg)
    ms = wall / TF_TIMED * 1e3
    all_seg = np.concatenate([b["tgt_seg"] for b in epoch])
    stats = {
        "pairs_loaded": n_pairs, "packed_batches": len(epoch),
        "packing_efficiency_tgt": packing.packing_efficiency(all_seg),
        "packing_efficiency_src": packing.packing_efficiency(
            np.concatenate([b["src_seg"] for b in epoch])),
        "feed_and_pack_s": feed_s,
        "loader_host_ms_per_batch": feed_stats["host_ms_per_batch"],
        "loader_wait_ms_per_batch": feed_stats["wait_ms_per_batch"],
        "pinned_allocations": len(feed_stats["pinned_allocations"]),
        "pinned_bytes": sum(a["bytes"]
                            for a in feed_stats["pinned_allocations"]),
        "pinned_allocations_after_first_capture": len(late),
        "steps": TF_TIMED, "ms_per_step": ms,
        "real_tgt_tokens_per_s": real / wall,
        "model_flops_per_step": flops,
        "mfu_vs_989tflops": flops / (wall / TF_TIMED)
        / PEAK_FLOPS[torch.bfloat16],
        "peak_memory_gib": peak / 2**30, "warmup_s": warm_s,
        "captures_after_first_graphed_step":
            recompile.capture_count() - captures,
        "graph_builds": step.builds,
        "launches_per_step": per_step, "launches": launches,
        "loss_first": losses[0], "loss_last": losses[-1],
    }
    prof_batch = {k: torch.from_numpy(v).to(device)
                  for k, v in epoch[0].items()}
    prof = profile_window(lambda: step(state, **prof_batch), PROFILED_STEPS,
                          keep=("flash_",))
    stats["busy_share"] = prof["device_busy_share"]
    stats["kernels_per_step"] = prof["kernel_launches"] / PROFILED_STEPS
    log("  11 train profile: " + json.dumps({"steps": PROFILED_STEPS,
                                             **prof}))
    # the padded layout (one pair a row) on the same captured graph
    padded = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
              for b in padded_batches(pairs, TF_TIMED)]
    step(state, **padded[0])
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for b in padded:
        step(state, **b)
    torch.cuda.synchronize()
    p_wall = time.monotonic() - t0
    p_real = sum(int((b["tgt_seg"] > 0).sum()) for b in padded)
    stats.update(
        padded_ms_per_step=p_wall / len(padded) * 1e3,
        padded_real_tgt_tokens_per_s=p_real / p_wall,
        packed_vs_padded=(real / wall) / (p_real / p_wall),
        captures_after_padded=recompile.capture_count() - captures)
    if stats["captures_after_padded"]:
        raise AssertionError("the padded layout captured another graph")
    log("  11 (a)+(b) feed and packed training: " + json.dumps(stats))
    return stats, model, epoch


def _tf_fp32(device, impl, seed=1):
    from paddle_tpu_torch.models.transformer import Transformer
    return Transformer(_tf_config(num_encoder_layers=2, num_decoder_layers=2,
                                  attn_impl=impl), device=device, seed=seed)


def _padded_token_sum(model, pairs, rows):
    """Sum over pairs of each pair's padded loss times its token count:
    ``Transformer.loss``'s per-token terms over one pair a row (pad_id
    2, which no id in [3, vocab) takes)."""
    srcs, tins, touts = pairs
    cfg = model.cfg
    total, count = 0.0, 0
    for lo in range(0, len(rows), TF_ROWS):
        idx = rows[lo:lo + TF_ROWS]
        arrs = []
        for seqs in (srcs, tins, touts):
            a = np.full((len(idx), TF_LEN), cfg.pad_id, np.int32)
            for r, i in enumerate(idx):
                a[r, :len(seqs[i])] = seqs[i]
            arrs.append(torch.from_numpy(a).to(model.device))
        logits = model(arrs[0], arrs[1]).float()
        nll = model._nll(logits, arrs[2])
        mask = (arrs[2] != cfg.pad_id).float()
        total += float((nll * mask).sum(dtype=torch.float64))
        count += int(mask.sum())
    return total, count


def tf_fp32_parity(device, epoch, pairs_of_first):
    """(c): fp32, full width, 2 + 2 layers, TF32 off: the packed token sum
    against the padded per-pair losses; the first batch's gradients and
    3 Adam steps' losses through the kernels and through the plain
    versions; fully masked cross-attention rows."""
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.train import build_train_step, make_train_state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in epoch[:3]]
    model = _tf_fp32(device, "auto")
    with torch.no_grad():
        _, aux = model.loss_packed(*(batches[0][k] for k in TF_KEYS))
        want, count = _padded_token_sum(model, *pairs_of_first)
    got = float(aux["token_sum"])
    rel_sum = abs(got - want) / abs(want)
    if int(aux["token_count"]) != count or rel_sum > 2e-5:
        raise AssertionError(f"packed token sum {got} (count "
                             f"{int(aux['token_count'])}) vs padded {want} "
                             f"({count})")
    steps, lr = 3, 1e-4
    runs = {}
    for impl in ("auto", "plain"):
        m = model if impl == "auto" else _tf_fp32(device, impl)
        # the gradients of the first batch at the seeded weights
        m.zero_grad(set_to_none=True)
        _tf_loss(m, **batches[0])[0].backward()
        grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        st = make_train_state(m, Adam(m.parameters(), learning_rate=lr))
        step = build_train_step(_tf_loss, st["opt"])
        registry.reset_launches()
        losses = [float(step(st, **b)[1]["loss"]) for b in batches]
        launched = [e.launches for e in flash_entries()]
        want_l = [6 * steps] * 3 if impl == "auto" else [0] * 3
        if launched != want_l:
            raise AssertionError(f"fp32 {impl} run launched {launched}")
        runs[impl] = (losses, grads)
    (k_losses, k_grads), (p_losses, p_grads) = runs["auto"], runs["plain"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
    if rel > 1e-5:
        raise AssertionError(f"fp32 parity: losses {k_losses} vs {p_losses}")
    # gradients held as phase 6 holds BERT's parameters: atol and rtol
    # 1e-4 (after Adam steps the tied embedding's near-zero gradients
    # turn rounding noise into lr-sized steps of either sign, so the
    # parameters are not compared)
    err = 0.0
    for n, g in k_grads.items():
        err = max(err, float((g - p_grads[n]).abs().max()))
        if not torch.allclose(g, p_grads[n], atol=1e-4, rtol=1e-4):
            raise AssertionError(f"fp32 parity: d{n} differs by "
                                 f"{float((g - p_grads[n]).abs().max()):.3e}")
    del runs, model
    torch.cuda.empty_cache()
    dead = tf_dead_rows(device)
    out = {"packed_token_sum": got, "padded_token_sum": want,
           "token_sum_rel_err": rel_sum, "losses_kernel": k_losses,
           "losses_plain": p_losses, "loss_rel_err": rel,
           "grad_max_abs_err": err, **dead}
    log("  11 (c) fp32 parity: " + json.dumps(out))
    return out


def tf_dead_rows(device, seed=9):
    """Cross-attention of packed rows whose source rows hold no padding:
    the target's padding queries (segment 0) see no key. Through the
    kernels at the slice's shape, fp32: those rows are 0 and their dq 0,
    their cotangent adds nothing to dk/dv, and the rest equals the plain
    versions."""
    from paddle_tpu_torch.ops import attention as FA
    from paddle_tpu_torch.ops.sequence import make_segment_attention_bias
    rng = np.random.default_rng(seed)
    b, h, s, d = TF_ROWS, 16, TF_LEN, 64
    src_seg = np.zeros((b, s), np.int32)
    for r in range(b):                 # every source slot in a segment
        cuts = np.sort(rng.choice(np.arange(8, s - 8), 5, replace=False))
        src_seg[r] = np.searchsorted(cuts, np.arange(s), side="right") + 1
    tgt_seg = np.where(np.arange(s)[None, :] < rng.integers(
        s // 4, s - 16, b)[:, None], np.minimum(
        np.arange(s)[None, :] // 40 + 1, 6), 0).astype(np.int32)
    bias = make_segment_attention_bias(
        torch.from_numpy(tgt_seg).to(device),
        torch.from_numpy(src_seg).to(device))
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)).to(device) for _ in range(4))
    dead = torch.from_numpy(tgt_seg == 0).to(device)[:, None, :, None]
    dead = dead.expand(b, h, s, d)

    def run(impl, g):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = FA.dot_product_attention(*leaves, bias=bias, impl=impl)
        return (out.detach(), *torch.autograd.grad(out, leaves, g))

    out, dq, dk, dv = run("flash", do)
    if not (torch.all(out[dead] == 0) and torch.all(dq[dead] == 0)):
        raise AssertionError("a fully masked cross-attention row is not 0")
    _, _, dk0, dv0 = run("flash", torch.where(dead, 0.0, do))
    inflation = max(float((dk - dk0).abs().max()),
                    float((dv - dv0).abs().max()))
    if inflation > 1e-6:
        raise AssertionError(f"dead rows moved dk/dv by {inflation:.3e}")
    p_out, p_dq, p_dk, p_dv = run("plain", do)
    tol = FA.BWD_DQ.tolerance[torch.float32]
    errs = {"out": _err(out, p_out, FA.FWD.tolerance[torch.float32],
                        "dead rows out"),
            "dq": _err(dq, p_dq, tol, "dead rows dq"),
            "dk": _err(dk, p_dk, tol, "dead rows dk"),
            "dv": _err(dv, p_dv, tol, "dead rows dv")}
    return {"dead_rows": int((tgt_seg == 0).sum()),
            "dead_rows_dkdv_shift": inflation,
            "dead_rows_vs_plain_max_abs_err": errs}


#: run in a fresh interpreter: loads the artifact with no model module,
#: runs it on the saved inputs, saves the logits and prints the K5
#: launches of the call as one JSON line
PREDICTOR_CODE = """
import json, sys, torch
from paddle_tpu_torch.inference import load_inference_model
from paddle_tpu_torch.ops import attention as FA
path, inputs, out = sys.argv[1:4]
pred = load_inference_model(path)
args = torch.load(inputs)
sync = torch.cuda.synchronize if pred.device.type == "cuda" else lambda: None
pred.run(*args)
sync()
before = FA.FWD.launches
logits = pred.run(*args)
sync()
torch.save(logits.cpu(), out)
bad = sorted(m for m in sys.modules if m.startswith(
    ("paddle_tpu_torch.models", "paddle_tpu_torch.nn", "jax", "paddle_tpu.")))
print(json.dumps({"k5_launches_per_call": FA.FWD.launches - before,
                  "model_modules": bad, "device": str(pred.device)}))
"""


def tf_export_batch(cfg, epoch):
    """(src, tgt) int32 (TF_ROWS, TF_LEN): a teacher-forced batch with key
    padding, the first pair of each packed row of the first batch."""
    first = epoch[0]
    src = np.full((TF_ROWS, TF_LEN), cfg.pad_id, np.int32)
    tgt = np.full((TF_ROWS, TF_LEN), cfg.pad_id, np.int32)
    for r in range(TF_ROWS):
        for arr, key in ((src, "src"), (tgt, "tgt")):
            row = first[key][r][first[f"{key}_seg"][r] == 1]
            arr[r, :len(row)] = row
    return src, tgt


def tf_export(device, model, epoch):
    """(d): the trained model's teacher-forced forward in bf16 exported
    with ``save_inference_model``, run by a ``Predictor`` in a fresh
    process that imports no model module: logits bit for bit the eager
    model's, 18 K5 launches a call; then int8 weights."""
    import copy

    from paddle_tpu_torch.inference import save_inference_model
    from paddle_tpu_torch.ops import attention as FA
    d = TF_DIR / "export"
    shutil.rmtree(d, ignore_errors=True)
    b16 = copy.deepcopy(model).to(torch.bfloat16).eval()
    cfg = b16.cfg
    inputs = tuple(torch.from_numpy(a).to(device)
                   for a in tf_export_batch(cfg, epoch))
    t0 = time.monotonic()
    save_inference_model(str(d / "bf16"), b16, inputs,
                         input_names=["src_ids", "tgt_ids"])
    export_s = time.monotonic() - t0
    torch.save(tuple(t.cpu() for t in inputs), d / "inputs.pt")
    before = FA.FWD.launches
    with torch.no_grad():
        eager = b16(*inputs)
    torch.cuda.synchronize()
    eager_k5 = FA.FWD.launches - before
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-c", PREDICTOR_CODE,
                          str(d / "bf16"), str(d / "inputs.pt"),
                          str(d / "logits.pt")],
                         capture_output=True, text=True, timeout=300,
                         cwd=pathlib.Path(__file__).resolve().parent)
    sub_s = time.monotonic() - t0
    if res.returncode != 0:
        raise AssertionError(f"the Predictor process failed:\n{res.stderr}")
    sub = json.loads(res.stdout.strip().splitlines()[-1])
    got = torch.load(d / "logits.pt")
    want_k5 = cfg.num_encoder_layers + 2 * cfg.num_decoder_layers
    if sub["model_modules"]:
        raise AssertionError(f"the Predictor imported {sub['model_modules']}")
    if not torch.equal(got, eager.cpu()):
        raise AssertionError("exported logits != eager logits, max |diff| "
                             f"{float((got.float() - eager.cpu().float()).abs().max()):.3e}")
    if sub["k5_launches_per_call"] != want_k5 or eager_k5 != want_k5:
        raise AssertionError(f"K5 launches per call: predictor "
                             f"{sub['k5_launches_per_call']}, eager "
                             f"{eager_k5}, expected {want_k5}")
    save_inference_model(str(d / "int8"), b16, inputs,
                         input_names=["src_ids", "tgt_ids"],
                         weight_quantize="int8")
    from paddle_tpu_torch.inference import load_inference_model
    q8 = load_inference_model(str(d / "int8")).run(*inputs)
    q8_err = float((q8.float() - eager.float()).abs().max())
    std = float(eager.float().std())
    sizes = {k: (d / k / "__model__.pt2").stat().st_size
             for k in ("bf16", "int8")}
    fp32_weights = 4 * sum(p.numel() for p in b16.parameters())
    out = {"artifact_bytes_bf16": sizes["bf16"],
           "artifact_bytes_int8": sizes["int8"],
           "int8_vs_bf16_bytes": sizes["int8"] / sizes["bf16"],
           # the same weights in float32 (reckoned, not exported)
           "fp32_weight_bytes": fp32_weights,
           "int8_vs_fp32_weight_bytes": sizes["int8"] / fp32_weights,
           "export_s": export_s, "predictor_process_s": sub_s,
           "predictor_device": sub["device"],
           "logits_bitwise_equal": True,
           "k5_launches_per_call": sub["k5_launches_per_call"],
           "int8_max_abs_err_vs_bf16": q8_err, "logits_std": std,
           "int8_err_over_std": q8_err / std,
           "int8_tolerance_over_std": TF_INT8_TOL}
    if not torch.isfinite(q8).all() or q8_err > TF_INT8_TOL * std:
        raise AssertionError(f"int8 logits off by {q8_err:.3e} (std "
                             f"{std:.3e})")
    log("  11 (d) export: " + json.dumps(out))
    del b16
    torch.cuda.empty_cache()
    return out


def transformer_slice(device):
    """Phase 11: (a) feed, (b) packed training, (c) fp32 parity, (d)
    export. Returns (stats, the trained model, the epoch's batches) for
    phase 12."""
    t_phase = time.monotonic()
    shutil.rmtree(TF_DIR, ignore_errors=True)
    cfg = _tf_config()
    paths = write_multislot(TF_DIR / "wmt", tf_pairs(cfg.vocab_size))
    stats, model, epoch = tf_feed_and_train(device, paths)
    export = tf_export(device, model, epoch)
    gc.collect()
    torch.cuda.empty_cache()
    # the first packed batch's pairs, for the padded baseline of (c)
    _, _, pairs = tf_epoch(paths, cfg)
    srcs = pairs[0]
    first = epoch[0]
    in_first = []
    lookup = {s.tobytes(): i for i, s in enumerate(srcs)}
    for r in range(TF_ROWS):
        for seg in range(1, int(first["src_seg"][r].max()) + 1):
            row = first["src"][r][first["src_seg"][r] == seg]
            in_first.append(lookup[row.tobytes()])
    parity = tf_fp32_parity(device, epoch, (pairs, in_first))
    stats.update(export=export, parity=parity,
                 phase_s=time.monotonic() - t_phase)
    return stats, model, epoch


# -- phase 12: native serving, beam search, the op library --------------------

#: frozen bf16 logits against the eager model: max |diff| over their std
NATIVE_TOL = 0.05
#: the fp32 2 + 2 model's frozen logits: max |diff| over max |logit|
NATIVE_FP32_TOL = 1e-4
#: the int8 package's bytes over the bf16 package's, at most
NATIVE_INT8_BYTES = 0.55
#: timed calls (medians), then repeated calls that must match bit for bit
NATIVE_CALLS, NATIVE_REPEATS = 20, 10
#: beam search: beams, source rows, max_len
BEAM_K, BEAM_ROWS, BEAM_LEN = 4, 16, 64
#: (c): K5 through the C++ registration at phase 11's packed shape with
#: its segment bias and at the training shape with a key bias
NATIVE_K5_CASES = ("packed", "train")
#: launches timed back to back in the runner for (c)'s ms
NATIVE_K5_REPS = 50


def _native_serve(path, src, tgt, calls, repeats):
    """``calls`` timed calls of a NativePredictor on ``path`` (after two
    warm-up calls), then one more and ``repeats`` after it that must equal
    it bit for bit. Returns (its logits, stats): K5 launches a call from the
    runner's counter (each call's), per-call ms (median), the runner's
    own device and copy-out ms (medians), start-up s."""
    from paddle_tpu_torch.native.runner import NativePredictor
    t0 = time.monotonic()
    pred = NativePredictor(str(path))
    start_s = time.monotonic() - t0
    try:
        pred.run(src, tgt)
        pred.run(src, tgt)
        before = pred.last_call["k5_launches_total"]
        lat, dev_ms, copy_ms, per_call = [], [], [], []
        for _ in range(calls):
            t1 = time.perf_counter()
            pred.run(src, tgt)
            lat.append((time.perf_counter() - t1) * 1e3)
            now = pred.last_call["k5_launches_total"]
            per_call.append(now - before)
            before = now
            dev_ms.append(pred.last_call["device_us"] / 1e3)
            copy_ms.append(pred.last_call["copy_us"] / 1e3)
        first = pred.run(src, tgt)[0]
        bitwise = all(np.array_equal(pred.run(src, tgt)[0], first)
                      for _ in range(repeats))
    finally:
        pred.close()
    return first, {"start_s": start_s, "ms": float(np.median(lat)),
                   "device_ms": float(np.median(dev_ms)),
                   "copy_ms": float(np.median(copy_ms)),
                   "k5_per_call": sorted(set(per_call)),
                   "k5_launches": sum(per_call),
                   "repeats_bitwise": bitwise}


def _freeze(path, model, inputs, **kw):
    """save_inference_model(freeze_native=True): (seconds, package bytes,
    __model__.pt2 bytes)."""
    from paddle_tpu_torch.inference import save_inference_model
    from paddle_tpu_torch.native.runner import FROZEN_FILE
    t0 = time.monotonic()
    save_inference_model(str(path), model, inputs,
                         input_names=["src_ids", "tgt_ids"],
                         freeze_native=True, **kw)
    return (time.monotonic() - t0, (path / FROZEN_FILE).stat().st_size,
            (path / "__model__.pt2").stat().st_size)


def native_freeze_and_serve(device, model, epoch):
    """(a) the trained Transformer-big frozen in bf16 and with int8
    weights; (b) both served by the C++ runner against the eager model,
    K5 counted in C++, repeats bitwise, latency beside the Python
    Predictor's; the fp32 2 + 2 model frozen and served within
    ``NATIVE_FP32_TOL``."""
    from paddle_tpu_torch.inference import Predictor
    d = TF_DIR / "native"
    shutil.rmtree(d, ignore_errors=True)
    b16 = copy.deepcopy(model).to(torch.bfloat16).eval()
    cfg = b16.cfg
    src, tgt = tf_export_batch(cfg, epoch)
    inputs = (torch.from_numpy(src).to(device), torch.from_numpy(tgt).to(device))
    with torch.no_grad():
        eager = b16(*inputs).float().cpu().numpy()
    std = float(eager.std())
    want_k5 = cfg.num_encoder_layers + 2 * cfg.num_decoder_layers
    out = {}
    for name, kw in (("bf16", {}), ("int8", {"weight_quantize": "int8"})):
        secs, nbytes, pt2 = _freeze(d / name, b16, inputs, **kw)
        logits, st = _native_serve(d / name, src, tgt, NATIVE_CALLS,
                                   NATIVE_REPEATS)
        err = float(np.abs(logits - eager).max())
        out[name] = {"freeze_s": secs, "package_bytes": nbytes,
                     "pt2_bytes": pt2, **st, "max_abs_err": err,
                     "err_over_std": err / std}
        log(f"  12 (a)/(b) {name}: " + json.dumps(out[name]))
        if st["k5_per_call"] != [want_k5] or not st["repeats_bitwise"]:
            raise AssertionError(f"native {name}: K5 a call "
                                 f"{st['k5_per_call']} (expected {want_k5}),"
                                 f" repeats bitwise {st['repeats_bitwise']}")
        tol = NATIVE_TOL if name == "bf16" else TF_INT8_TOL
        if not np.isfinite(logits).all() or err > tol * std:
            raise AssertionError(f"native {name} logits off by {err:.3e} "
                                 f"({err / std:.4f} of the std {std:.3e}; "
                                 f"tolerance {tol})")
    ratio = out["int8"]["package_bytes"] / out["bf16"]["package_bytes"]
    if ratio > NATIVE_INT8_BYTES:
        raise AssertionError(f"int8 package {ratio:.3f} of the bf16 one")
    # the Python Predictor on the same program and inputs
    pred = Predictor(str(d / "bf16"))
    lat, lat_host = [], []
    for i in range(NATIVE_CALLS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pred.run(*inputs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res.float().cpu().numpy()
        t2 = time.perf_counter()
        if i >= 2:
            lat.append((t1 - t0) * 1e3)
            lat_host.append((t2 - t0) * 1e3)
    del pred, res
    py = {"ms": float(np.median(lat)), "host_ms": float(np.median(lat_host))}
    # the fp32 2 + 2 model of phase 11 (c), TF32 off
    m32 = _tf_fp32(device, "auto").eval()
    with torch.no_grad():
        e32 = m32(*inputs).cpu().numpy()
    secs, nbytes, _ = _freeze(d / "fp32", m32, inputs)
    l32, st32 = _native_serve(d / "fp32", src, tgt, 2, 2)
    rel = float(np.abs(l32 - e32).max() / np.abs(e32).max())
    fp32 = {"freeze_s": secs, "package_bytes": nbytes, "rel_err": rel,
            "k5_per_call": st32["k5_per_call"],
            "repeats_bitwise": st32["repeats_bitwise"]}
    log("  12 (b) fp32 2 + 2: " + json.dumps(fp32))
    if rel > NATIVE_FP32_TOL or st32["k5_per_call"] != [6]:
        raise AssertionError(f"native fp32: rel {rel:.3e}, K5 a call "
                             f"{st32['k5_per_call']}")
    del b16, m32
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    summary = {"int8_vs_bf16_bytes": ratio, "python_predictor": py,
               "native_vs_python_ms": out["bf16"]["ms"] / py["host_ms"],
               "native_device_vs_python_ms": out["bf16"]["device_ms"]
               / py["ms"]}
    log("  12 (b) latency: " + json.dumps(summary))
    return {"bf16": out["bf16"], "int8": out["int8"], "fp32": fp32,
            **summary}


def native_k5(device, flush):
    """(c) K5 through the runner's C++ registration against K5 through the
    Python op, bit for bit, on the same inputs at phase 11's packed shape
    (segment bias) and the training shape (key bias), and against the
    plain version within the entry's tolerance. The packed case's row for
    the ``kernels`` line: the C++ binding's ms (back to back in the
    runner), the plain version's, SDPA's, the bound."""
    from paddle_tpu_torch.native.runner import flash_fwd_files
    from paddle_tpu_torch.ops import attention as FA
    rows = {}
    for case in FLASH_CASES:
        name, shape, causal, lengths = case
        if name not in NATIVE_K5_CASES:
            continue
        q, k, v, bias, _ = flash_inputs(shape, lengths, device)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        out, lse = FA.flash_fwd_cuda(q, k, v, bias, causal=causal)
        got = flash_fwd_files(q, k, v, bias, causal=causal,
                              device=str(device), workdir=str(TF_DIR),
                              reps=NATIVE_K5_REPS)
        if not (torch.equal(got["out"], out.cpu())
                and torch.equal(got["lse"], lse.cpu())):
            raise AssertionError(f"K5 in C++ [{name}] differs from K5 in "
                                 "Python")
        q32, k32, v32 = (t.float() for t in (q, k, v))
        p_out, p_lse = FA.flash_fwd_plain(q32, k32, v32, bias, causal=causal)
        alive = p_lse > FA.NEG_INF / 2
        err = max(_err(got["out"].to(device), p_out,
                       FA.FWD.tolerance[torch.bfloat16], f"C++ K5[{name}]"),
                  _err(got["lse"].to(device)[alive], p_lse[alive],
                       FA.FWD.tolerance[torch.float32],
                       f"C++ K5[{name}] lse"))
        nbytes, flops = FA.FWD.work(q, k, v, bias, causal=causal)
        bound, by = _bound(nbytes, flops, torch.bfloat16)
        rows[name] = {"bitwise_vs_python": True, "max_abs_err": err,
                      "ms": got["ms"],
                      **_timed(lambda: FA.flash_fwd_plain(
                          q32, k32, v32, bias, causal=causal), flush, 5,
                          "plain_"),
                      **_timed(_library_fwd(q, k, v, bias, causal), flush, 20,
                               "library_"),
                      "bound_ms": bound, "bound_by": by,
                      "runner_launches": got["launches"]}
        log(f"  12 (c) K5 C++ vs Python [{name}] {tuple(shape)}: "
            + json.dumps(rows[name]))
    return rows


def native_beam_search(device, model, epoch):
    """(d) ``beam_search_decode(beam_size=4)`` on 16 source rows, max_len
    64: the trained model in bf16 (tokens/s, K5 launches: 6 a call, the
    encoder); the fp32 2 + 2 model through the kernels and through the
    plain versions (identical ids, scores within 1e-5); beam 1 against
    greedy decoding."""
    from paddle_tpu_torch.ops import attention as FA
    b16 = copy.deepcopy(model).to(torch.bfloat16).eval()
    src, _ = tf_export_batch(b16.cfg, epoch)
    src = torch.from_numpy(src[:BEAM_ROWS]).to(device)
    b16.beam_search_decode(src, beam_size=BEAM_K, max_len=BEAM_LEN)
    torch.cuda.synchronize()
    before = FA.FWD.launches
    t0 = time.perf_counter()
    ids, scores = b16.beam_search_decode(src, beam_size=BEAM_K,
                                         max_len=BEAM_LEN)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k5 = FA.FWD.launches - before
    steps = BEAM_LEN - 1
    out = {"s": secs, "k5_launches": k5,
           "tokens_per_s": BEAM_ROWS * steps / secs,
           "beam_tokens_per_s": BEAM_ROWS * BEAM_K * steps / secs,
           "ms_per_step": secs / steps * 1e3}
    if k5 != b16.cfg.num_encoder_layers or not torch.isfinite(scores).all() \
            or tuple(ids.shape) != (BEAM_ROWS, BEAM_LEN):
        raise AssertionError(f"bf16 beam search: K5 {k5}, ids "
                             f"{tuple(ids.shape)}, scores finite "
                             f"{bool(torch.isfinite(scores).all())}")
    del b16
    m_k = _tf_fp32(device, "auto").eval()
    m_p = _tf_fp32(device, "plain").eval()
    ik, sk = m_k.beam_search_decode(src, beam_size=BEAM_K, max_len=BEAM_LEN)
    ip, sp = m_p.beam_search_decode(src, beam_size=BEAM_K, max_len=BEAM_LEN)
    one, _ = m_k.beam_search_decode(src, beam_size=1, max_len=BEAM_LEN)
    greedy = m_k.greedy_decode(src, max_len=BEAM_LEN)
    out.update(fp32_ids_equal=bool(torch.equal(ik, ip)),
               fp32_scores_max_abs_err=float((sk - sp).abs().max()),
               beam1_equals_greedy=bool(torch.equal(one, greedy)))
    log("  12 (d) beam search: " + json.dumps(out))
    if not (out["fp32_ids_equal"] and out["beam1_equals_greedy"]) or \
            out["fp32_scores_max_abs_err"] > 1e-5:
        raise AssertionError(f"fp32 beam search: {out}")
    del m_k, m_p
    torch.cuda.empty_cache()
    return out


def op_battery(device):
    """(e) every op of the dense op library on the card in fp32 against
    its numpy reference (or the op on the CPU where the reference has
    none), the random ops by their distributions; 0 failures."""
    from paddle_tpu_torch.ops import samples
    res = samples.run_battery(device)
    log("  12 (e) op battery: " + json.dumps(res))
    if res["failures"]:
        raise AssertionError(f"op battery failures: {res['failures']}")
    return res


def native_slice(device, model, epoch):
    """Phase 12: (a)/(b) freeze and serve from C++, (c) K5's C++
    registration, (d) beam search, (e) the op battery. TF32 off."""
    t_phase = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = model.eval()
    stats = {"serve": native_freeze_and_serve(device, model, epoch)}
    flush = L2Flush(device)
    stats["k5"] = native_k5(device, flush)
    del flush
    stats["beam"] = native_beam_search(device, model, epoch)
    stats["battery"] = op_battery(device)
    stats["phase_s"] = time.monotonic() - t_phase
    return stats


def native_k5_line(stats):
    """The ``kernels`` line's entry of K5 through the runner's C++
    registration: the same compiled kernel as K5's entry, launched from
    ``ptt_ops.cc``. ``launches`` is the runner's C++ count over (b)'s
    timed bf16 calls (18 a call); the times are (c)'s packed case in
    bf16: ``ms`` back to back in the runner (host clock, L2 warm), the
    plain version's and SDPA's with CUDA events."""
    from paddle_tpu_torch.ops import attention as FA
    r = stats["k5"]["packed"]
    keys = ("max_abs_err", "ms", "plain_ms", "plain_device_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms")
    return {"name": FA.FWD.name + "_native", "route": "cuda",
            "source": FA.FWD.source,
            "binding": "paddle_tpu_torch/native/ptt_ops.cc",
            "replaces": FA.FWD.replaces,
            "launches": stats["serve"]["bf16"]["k5_launches"],
            **{k: r.get(k) for k in keys}, "dtype": "bfloat16",
            "shape": [16, 16, 256, 64],
            "bitwise_vs_python": {c: v["bitwise_vs_python"]
                                  for c, v in stats["k5"].items()},
            "note": "K5's compiled kernel launched by the C++ op "
                    "ptt::flash_fwd in the native runner; ms is the mean "
                    "of 50 launches back to back in the runner"}


def ring_line(stats):
    """The ``kernels`` line's entry of the ring, which has no kernel of its
    own: ``launches`` is the K5/K6a/K6b launches its calls made on rank 0
    of (b)'s main path (``inner_launches`` by kernel; K5/K6's lines count
    them too), ``calls`` its calls there. The times are (a)'s bf16
    forward and backward at sp=2: ``ms`` is CUDA events around the call,
    which stages k/v through the host over gloo, so it is wall time of
    the staged ring and no device time is given (the card waits on the
    host inside the call)."""
    from paddle_tpu_torch.parallel import ring_attention as R
    t = stats["ring"]
    keys = ("ms", "host_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms", "bound_by")
    inner = stats["main_path_launches"]
    return {"name": R.RING.name, "route": "cuda", "source": R.RING.source,
            "replaces": R.RING.replaces, "entry_over": list(R.RING.inner),
            "launches": sum(inner.values()), "inner_launches": inner,
            "calls": stats["ring_calls_main_path"],
            "max_abs_err": t["max_abs_err"]["out"],
            **{k: t.get(k) for k in keys}, "dtype": "bfloat16",
            "shape": list(RING_SHAPE), "sp": 2,
            "note": "no kernel of its own; ms is the wall time of forward "
                    "and backward over a gloo group of 2 processes on one "
                    "card, k/v staged through the host: not device time, "
                    "not a parallel speed"}


def tunable_args(entry):
    """Meta tensors of ``entry``'s first cell shape in bf16 (what its
    candidates read: dtypes and head dim)."""
    from paddle_tpu_torch.kernels import autotune
    kind, geom = next((k, g) for n, _, k, g in autotune.CELLS
                      if n == entry.name)
    return autotune.cell_inputs(kind, geom, "meta")[0]


def kernel_line(entry, rows, launches, case_rows=None):
    """One entry of the ``kernels`` line: the bf16 row at the main
    path's shape, with its fp32 row (and other cases) beside it, the
    tunables' candidates, and the launch configuration (``blocks``) the
    committed tuning cache chose at each shape."""
    b16, f32 = rows[torch.bfloat16], rows[torch.float32]
    keys = ("max_abs_err", "ms", "device_ms", "host_ms", "plain_ms",
            "plain_device_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "blocks")
    line = {"name": entry.name, "route": entry.route,
            "source": entry.source, "replaces": entry.replaces,
            "launches": launches, **{k: b16.get(k) for k in keys},
            "dtype": "bfloat16", "fp32": {k: f32.get(k) for k in keys},
            "tunables": {k: list(v) for k, v in
                         entry.contract.candidates(tunable_args(entry))
                         .items()}}
    if case_rows:
        line["cases"] = {c: {str(dt)[6:]: {k: r.get(k) for k in keys}
                             for dt, r in by_dtype.items()}
                         for c, by_dtype in case_rows.items()}
    return line


def _timed_runner_build() -> float:
    from paddle_tpu_torch.native.runner import build_runner
    t0 = time.monotonic()
    build_runner()
    return time.monotonic() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import build, registry
    t_start = time.monotonic()
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"[1/7] device: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.monotonic()
    # the native runner (g++ against libtorch, phase 12) builds beside nvcc
    runner_build = concurrent.futures.ThreadPoolExecutor(1).submit(
        _timed_runner_build)
    secs = build.build_all()
    log(f"[2/7] build: {json.dumps(secs)} in {time.monotonic() - t0:.1f} s;"
        f" the native runner {runner_build.result():.1f} s")
    for stem, text in build.build_logs.items():
        print(f"--- nvcc {stem}.cu ---\n{text}", file=sys.stderr)
    tensor_core_report(build)

    registry.load_all()
    from paddle_tpu_torch.serving import paged_attention as PA
    fp_paged = [PA.DECODE, PA.PREFILL]
    int8_paged = [PA.DECODE_INT8, PA.PREFILL_INT8]
    paged = fp_paged + int8_paged
    flash = list(flash_entries())
    if sorted(e.name for e in paged + flash) != list(registry.names()):
        raise AssertionError(f"unexpected registry: {registry.names()}")
    makers = {PA.DECODE.name: decode_inputs, PA.PREFILL.name: prefill_inputs,
              PA.DECODE_INT8.name: functools.partial(decode_inputs,
                                                     quantized=True),
              PA.PREFILL_INT8.name: functools.partial(prefill_inputs,
                                                      quantized=True)}
    log("[3/7] kernels vs plain versions")
    flush = L2Flush(device)
    rows = {e.name: check_kernel(e, makers[e.name], device, flush)
            for e in paged}
    verify_rows = {}
    for e in (PA.PREFILL, PA.PREFILL_INT8):
        log(f"  {e.name} at the verify chunk (C = {SPEC_K}):")
        verify_rows[e.name] = check_kernel(
            e, functools.partial(makers[e.name], c=SPEC_K), device, flush)
    long_rows = check_long_decode(device, flush)
    slice_rows = {e.name: check_head_slices(e, makers[e.name], device, flush)
                  for e in paged}
    flash_rows = {e.name: {} for e in flash}
    for case in FLASH_CASES:
        for name, by_dtype in check_flash(case, device, flush).items():
            flash_rows[name][case[0]] = by_dtype
    del flush
    log(f"  phase 3 done at {time.monotonic() - t_start:.1f} s")
    log("[3c/7] kernel layer: parity battery, tuner, committed cache, lint")
    layer = kernel_layer(device)

    log("[4/7] serve: GPT continuous batching")
    stats, bf16_outs = serve(device, fp_paged, "4a bf16 serve", profile=True)
    q8_stats, q8_outs = serve(device, int8_paged, "4c int8 serve",
                              profile=True, cache_dtype=torch.int8)
    log("  4c int8 vs 4a bf16: " + json.dumps({
        "capacity_bytes_per_token": [q8_stats["capacity_bytes_per_token"],
                                     stats["capacity_bytes_per_token"]],
        "token_agreement": agreement(q8_outs, bf16_outs)}))
    spec_stats, spec_outs = serve(device, int8_paged,
                                  "4d int8 self-draft speculative serve",
                                  cache_dtype=torch.int8, self_draft=True,
                                  spec_k=SPEC_K)
    log("  4d vs 4c token agreement (bf16, not gated): "
        + json.dumps(agreement(spec_outs, q8_outs)))
    serve_fp32_parity(device)
    log(f"  phases 4a-4e done at {time.monotonic() - t_start:.1f} s")
    t_mobility = time.monotonic()
    gen_stats = generate_run(device)
    migration_run(device, "4g bf16 migration")
    migration_run(device, "4g int8 migration", cache_dtype=torch.int8)
    disagg_run(device, bf16_outs)
    spill_exchange_run(device)
    mobility_fp32_parity(device)
    fleet_fp32_parity(device)
    log(f"  phases 4f-4j took {time.monotonic() - t_mobility:.1f} s")
    t0 = time.monotonic()
    fleet_stats = fleet_run(device)
    log(f"  phase 4k took {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    net_run(device)
    log(f"  phase 4l took {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    tp_stats = tp_group_run(device)
    probe = {}
    for tp in (2, 4):
        st, _ = serve(device, fp_paged, f"4m (ii) tp={tp} probe serve",
                      profile=True, tp=tp, tp_probe=True)
        probe[tp] = st
    log("  4m (ii) one chip's share of a tp deployment (tp_probe, graphs, "
        "bf16) beside 4a: " + json.dumps({
            f"tp={tp}" if tp > 1 else "4a (tp=1)": {
                "heads_per_chip": model_config().num_heads // tp,
                "decode_tokens_per_s": st["decode_tokens_per_s"],
                "prefill_tokens_per_s": st["prefill_tokens_per_s"],
                "paged_kernels_per_4_decode_blocks":
                    st["decode_profile"].get("kept_kernels")}
            for tp, st in ((1, stats), (2, probe[2]), (4, probe[4]))}))
    log(f"  phase 4m took {time.monotonic() - t0:.1f} s")

    log("[5/7] train: BERT-base pretraining, bf16")
    train = train_bf16(device)
    log("[6/7] train parity: fp32, kernels vs plain versions, graphs vs "
        "eager, resume")
    train_fp32_parity(device)
    train_fp32_exact(device)

    log("[8/8] parallel train: ring attention, sharded steps, LocalSGD, the "
        "sharded snapshot (gloo groups on one card)")
    par_stats = parallel_train(device)

    log("[9/9] pipelines: GPipe and the circular schedule over pp=2, "
        "BERT-base and GPT-2 small, the pp-split snapshot (legs run by "
        "phase 8's two-rank group on one card)")
    pipe_stats = pipeline_train(device, par_stats.pop("pipe_ranks"))

    log("[10/10] embedding serving: the host KV store, the device hot-row "
        "cache's graphs, DeepFM, streaming updates, the remote store, KV "
        "snapshots and host-KV training (the slice launches no registered "
        "kernel)")
    embedding_serving(device)

    log("[11/11] data, packed Transformer-big training and export: the "
        "MultiSlot feed, the packer and DeviceLoader, K5/K6a/K6b under "
        "segment biases in one captured graph, fp32 parity, "
        "save_inference_model and a Predictor in a fresh process")
    tf_stats, tf_model, tf_epoch = transformer_slice(device)
    log(f"  phase 11 took {tf_stats['phase_s']:.1f} s")

    log("[12/12] native serving and beam search: Transformer-big frozen "
        "by AOTInductor and served from the C++ runner (K5 registered in "
        "C++), beam search, the dense op library on the card")
    native = native_slice(device, tf_model, tf_epoch)
    del tf_model, tf_epoch
    log(f"  phase 12 took {native['phase_s']:.1f} s")

    lines = [kernel_line(e, rows[e.name], stats["launches"][e.name],
                         {**({"long": long_rows} if e is PA.DECODE
                             else {"verify": verify_rows[e.name]}),
                          **slice_rows[e.name]})
             for e in fp_paged]
    # K2/K4: launches of the int8 serving run (4c), with the speculative
    # run's (4d) beside them; K4's verify calls (chunk spec_k) of 4d and
    # its verify-shape row on their own
    verify_calls = spec_stats["int8_prefill_calls_by_chunk"].get(str(SPEC_K),
                                                                 0)
    lines += [dict(kernel_line(e, rows[e.name], q8_stats["launches"][e.name],
                               {**({"verify": verify_rows[e.name]}
                                   if e is PA.PREFILL_INT8 else {}),
                                **slice_rows[e.name]}),
                   launches_speculative=spec_stats["launches"][e.name],
                   **({"launches_verify": verify_calls}
                      if e is PA.PREFILL_INT8 else {}))
              for e in int8_paged]
    lines += [kernel_line(e, flash_rows[e.name][FLASH_CASES[0][0]],
                          train["launches"][e.name],
                          {c: r for c, r in flash_rows[e.name].items()
                           if c != FLASH_CASES[0][0]})
              for e in flash]
    # K1-K4 also run in 4k's fleet (K2/K4 in its int8 leg), and at 8
    # heads on each rank of 4m's tp=2 group (K1/K3 in its bf16 leg, K2/K4
    # in its int8 leg), where rank 0's collective probe twin launches
    # K1 (K2) besides
    for ln in lines:
        if ln["name"] in fleet_stats["launches"]:
            ln["launches_fleet"] = fleet_stats["launches"][ln["name"]]
        leg = tp_stats["int8" if "int8" in ln["name"] else "bf16"]
        if ln["name"] in leg["launches_rank0"]:
            ln["launches_tp2_ranks"] = [leg["launches_rank0"][ln["name"]],
                                        leg["launches_rank1"][ln["name"]]]
            ln["launches_tp2_probe_rank0"] = \
                leg["launches_probe_rank0"][ln["name"]]
    # K5 also runs in 4f's prefills (GPT.generate, generate_bucketed)
    k5_line, = [ln for ln in lines if ln["name"] == flash[0].name]
    k5_line["launches_generate"] = gen_stats["k5_launches"]
    # K5/K6a/K6b per stage rank of phase 9 (b)'s main path
    for ln in lines:
        if ln["name"] in pipe_stats["main_path_launches"][0]:
            ln["launches_pipeline_ranks"] = [
                r[ln["name"]] for r in pipe_stats["main_path_launches"]]
    # K5/K6a/K6b over phase 11 (b)'s 10 timed packed Transformer-big
    # steps (18 attentions a step, segment biases)
    for ln in lines:
        if ln["name"] in tf_stats["launches"]:
            ln["launches_transformer"] = tf_stats["launches"][ln["name"]]
    lines.append(ring_line(par_stats))
    lines.append(native_k5_line(native))
    # K5 also runs in 12 (d)'s beam search (the encoder, 6 a call)
    k5_line["launches_beam_search"] = native["beam"]["k5_launches"]
    log(f"[7/7] done in {time.monotonic() - t_start:.1f} s; library_ms of "
        "the two backward rows is one call for the pair: SDPA's whole "
        "backward (dq, dk, dv)")
    log("  kernel layer: " + json.dumps(layer))
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
