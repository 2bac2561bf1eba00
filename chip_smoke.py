#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile every ``paddle_tpu_torch/csrc/*.cu`` with nvcc
   (sm_90a), one process per source, all started together; print the
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
       of the partition of a slot's pages over the 8 warps of its block).
       Every kernel launched twice on the same inputs must give the same
       bits, and a decode slot of length 0 exact zeros;
   (b) flash attention forward, dk/dv and dq at the training shape
       (48, 12, 512, 64) with a key-padding bias from ragged valid
       lengths (one of them 0: a fully masked batch row), causal at
       (4, 16, 512, 64), and a ragged S=320 with a key bias; each row
       with its achieved TFLOP/s and share of its bound, repeat launches
       bit-identical, and the K6a + K6b pair beside SDPA's whole
       backward.
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
       prefix == fresh prefill.
5. train   — BERT-base pretraining (vocab 30522, hidden 768, 12 layers,
   12 heads, ffn 3072, max_position 512, post-LN, dropout 0), batch
   48 x 512 with valid lengths 128..512, AdamW(1e-4), bf16 compute over
   fp32 master weights, through ``Trainer.fit``: 3 warm-up steps, then 20
   timed steps on a fixed seeded batch; the loss must be finite and fall,
   and each flash kernel must launch exactly 12 times per step. Prints
   tokens/s, ms/step, MFU, peak memory, and the device busy share, top
   kernels and every flash kernel's device time over 3 profiled steps.
6. parity  — fp32 BERT at full width with 2 layers, batch 8 x 512, 3
   AdamW steps through the kernels and through the plain versions (TF32
   off): losses and final parameters within 1e-4.
7. output  — one ``{"kernels": [...]}`` line, the nvidia-smi line, and
   the final ``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import itertools
import json
import math
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


def _repeat_and_zeros(entry, args, out, what):
    """A second launch on the same inputs gives the same bits; a decode
    kernel's slots of length 0 give exact zeros."""
    again = entry.cuda_fn(*args)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{what}: two launches on the same inputs "
                             "differ")
    if args[0].ndim == 3:                   # decode: (S, H, Dh), lengths last
        dead = args[-1] == 0
        if not torch.all(out[dead] == 0):
            raise AssertionError(f"{what}: a slot of length 0 is not exact "
                                 "zeros")


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
        bound_ms, bound_by = _bound(*entry.work(*args), dtype)
        r = rows[dtype] = {
            "max_abs_err": err,
            **_timed(lambda: entry.cuda_fn(*args), flush, 50),
            **_timed(lambda: entry.plain_fn(*args), flush, 10, "plain_"),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log(f"  {entry.name} [{str(dtype)[6:]}] max_abs_err={err:.3e} "
            f"kernel={_ms_text(r)} plain={_ms_text(r, 'plain_')} "
            f"bound={bound_ms:.4f} ms ({bound_by})")
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
        }
        log(f"  {entry.name}[long S={S_LONG} x {W_LONG * PS} tokens] "
            f"[{str(dtype)[6:]}] max_abs_err="
            f"{r['max_abs_err']:.3e} kernel={_ms_text(r)} plain="
            f"{_ms_text(r, 'plain_')} bound={bound_ms:.4f} ms ({bound_by})")
    return rows


# -- phase 3b: flash attention vs plain versions -------------------------------

#: (name, (B, H, S, Dh), causal, key-padding lengths (None: no bias))
FLASH_CASES = (
    ("train", (48, 12, 512, 64), False, "ragged"),
    ("causal", (4, 16, 512, 64), True, None),
    ("s320", (8, 12, 320, 64), False, "ragged"),
)


def flash_inputs(shape, lengths, device, seed=5):
    """q, k, v, do (fp32) and a key-padding bias: valid lengths drawn
    from [S/4, S] with the first set to 0 (a fully masked batch row)."""
    b, h, s, d = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen, device=device)
                   for _ in range(4))
    bias = None
    if lengths == "ragged":
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


def _library_fwd(q, k, v, bias, causal):
    """One PyTorch call for the same function (timing yardstick only)."""
    import torch.nn.functional as F
    mask = None if bias is None else (bias > -1e29)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  is_causal=causal)


def _library_bwd(q, k, v, bias, do, causal):
    """SDPA's whole backward (dq, dk, dv) for the same inputs: one
    library time for the K6a + K6b pair."""
    import torch.nn.functional as F
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    mask = None if bias is None else (bias > -1e29)
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
        stats["decode_profile"] = profile_decode(eng, cfg.vocab_size)
        log(f"  {label} decode profile: "
            + json.dumps(stats["decode_profile"]))
    outs = [done[r] for r in rids]
    del eng, model
    release()
    return stats, outs


def release():
    """Free what deleted engines held: an engine and its graphs refer to
    each other, so only the cycle collector frees them."""
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


def profile_window(step, reps, keep=()):
    """Where the time of ``reps`` calls of ``step()`` goes: ``reps``
    calls run unprofiled (host clock, synchronised), then ``reps`` more
    under ``torch.profiler``. The profiler's own overhead inflates its
    window's wall time, so the device's busy share is the profiled
    window's device time over the unprofiled window's wall time. Returns
    that share, device time by kernel (CUPTI): the top ten, and every
    kernel whose name contains one of ``keep``, and the host's launch
    calls by API (``LAUNCH_APIS``)."""
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
    out = {"unprofiled_wall_s": wall, "device_busy_s": busy,
           "device_busy_share": busy / wall,
           "kernel_launches": int(sum(k[2] for k in kernels)),
           "launch_api_calls": dict(launch_calls),
           "top_kernels": [{"name": n, "ms": us / 1e3, "count": c}
                           for us, n, c in kernels[:10]]}
    if keep:
        out["kept_kernels"] = [{"name": n, "ms": us / 1e3, "count": c}
                               for us, n, c in kernels
                               if any(x in n for x in keep)]
    return out


def profile_decode(eng, vocab, blocks=4):
    """Where a decode block's time goes, after the measured run: 16 new
    requests are prefilled, then :func:`profile_window` over ``blocks``
    decode blocks of 16 live slots (the two windows differ only by 8
    tokens per block of slot length)."""
    for p in make_prompts(16, vocab, seed=7):
        eng.submit(p, 96)         # outlives both windows
    while eng.scheduler.queue or any(
            not eng.scheduler.slots[i].prefill_done
            for i in eng.scheduler.active_slots()):
        eng.step()
    return {"blocks": blocks, "tokens": blocks * eng.decode_block * 16,
            **profile_window(eng.step, blocks)}


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
            k, v = _dequantized(k), _dequantized(v)
        s = (q @ k.transpose(-1, -2)) / float(q.shape[-1]) ** 0.5
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        x = x + block.attn.proj_out(p @ v)
        x = x + block.mlp(block.ln2(x))
    return model.ln_f(x)[0, -1] @ model.wte.weight.T


def _hold_tokens(model, prompts, got, want, what, quantized=False,
                 allow_ties=False):
    """Tokens identical; with ``allow_ties`` a request may first differ
    only at a near-tie (after which its contexts differ and the rest is
    not compared): a top-2 gap of the dense recompute under ``NEAR_TIE``
    of the logits' standard deviation or, for a bf16 model, of at most
    one bf16 step at the top logit (``_bf16_quantum``: the two are
    adjacent bf16 values). A failure names the first differing position
    and the top-2 logit gap of the dense recompute on ``want``'s context
    there. Returns the near-ties met."""
    ties = []
    for i, (a, b) in enumerate(zip(got, want)):
        if np.array_equal(a, b):
            continue
        j = int(np.nonzero(a != b)[0][0]) if len(a) == len(b) else \
            min(len(a), len(b))
        ids = np.concatenate([prompts[i], b[:j]]).astype(np.int64)
        logits = dense_logits(model, torch.from_numpy(ids)[None].to(
            model.device), quantized).float()
        top = logits.topk(2).values
        tie = {"request": i, "position": j,
               "top2_gap": float(top[0] - top[1]),
               "logit_std": float(logits.std())}
        step = 0.0
        if model.wte.weight.dtype == torch.bfloat16:
            step = tie["bf16_step"] = _bf16_quantum(float(top[0]))
        if not allow_ties or (tie["top2_gap"] >= NEAR_TIE * tie["logit_std"]
                              and tie["top2_gap"] > step):
            raise AssertionError(
                f"{what}: request {i} first differs at generated position "
                f"{j} ({a[j:j + 4]} vs {b[j:j + 4]}); top-2 logit gap there "
                f"{tie['top2_gap']:.3e}, logit std {tie['logit_std']:.3e}")
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
        n = len(snap["shards"])
        got = [eng._shard_digest(eng._shard(p)) for p in
               eng._read_pages(eng.cache.block_tables[slot, :n])]
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
        eng._shard_digest(eng._shard(p))
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


def train_bf16(device):
    """The training main path through the user's entry points."""
    from paddle_tpu_torch.core.dtypes import get_policy
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.train import build_train_step, make_train_state
    from paddle_tpu_torch.trainer import Trainer
    cfg = BertConfig.base(dropout=0.0, attn_dropout=0.0)
    model = BertForPretraining(cfg, device=device, seed=0)
    opt = AdamW(model.parameters(), learning_rate=1e-4)
    state = make_train_state(model, opt)
    step = build_train_step(lambda m, **b: m.loss(**b), opt,
                            policy=get_policy("bf16"))
    batch = bert_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, device)
    losses = []
    reg = MetricsRegistry()
    trainer = Trainer(step, state, log_every=10, log_fn=log, registry=reg,
                      hooks=[lambda t, n, m: losses.append(m["loss"])])
    t0 = time.monotonic()
    trainer.fit(itertools.repeat(batch), steps_per_epoch=WARMUP_STEPS)
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()               # count only the timed run
    t0 = time.monotonic()
    trainer.fit(itertools.repeat(batch), steps_per_epoch=TIMED_STEPS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {e.name: e.launches for e in flash_entries()}
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
    stats = {
        "steps": TIMED_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "params": n_params, "wall_s": wall, "warmup_s": warm_s,
        "ms_per_step": wall / TIMED_STEPS * 1e3, "tokens_per_s": tps,
        "mfu_vs_989tflops": tps * flops_per_token / PEAK_FLOPS[torch.bfloat16],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "loss_first": losses[0], "loss_last": losses[-1],
        "host_step_s_mean":
            reg.histogram("train_step_seconds").summary()["mean"],
        "launches": launches,
    }
    log("  bf16 train: " + json.dumps(stats))
    it = itertools.repeat(batch)
    prof = profile_window(lambda: step(state, **next(it)), PROFILED_STEPS,
                          keep=("flash_",))
    log("  train profile: " + json.dumps({"steps": PROFILED_STEPS, **prof}))
    del trainer, state, step, opt, model, batch
    torch.cuda.empty_cache()
    return stats


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


def kernel_line(entry, rows, launches, case_rows=None):
    """One entry of the ``kernels`` line: the bf16 row at the main
    path's shape, with its fp32 row (and other cases) beside it."""
    b16, f32 = rows[torch.bfloat16], rows[torch.float32]
    keys = ("max_abs_err", "ms", "device_ms", "host_ms", "plain_ms",
            "plain_device_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms")
    line = {"name": entry.name, "route": entry.route,
            "source": entry.source, "replaces": entry.replaces,
            "launches": launches, **{k: b16.get(k) for k in keys},
            "dtype": "bfloat16", "fp32": {k: f32.get(k) for k in keys}}
    if case_rows:
        line["cases"] = {c: {str(dt)[6:]: {k: r.get(k) for k in keys}
                             for dt, r in by_dtype.items()}
                         for c, by_dtype in case_rows.items()}
    return line


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
    secs = build.build_all()
    log(f"[2/7] build: {json.dumps(secs)} in {time.monotonic() - t0:.1f} s")
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
    flash_rows = {e.name: {} for e in flash}
    for case in FLASH_CASES:
        for name, by_dtype in check_flash(case, device, flush).items():
            flash_rows[name][case[0]] = by_dtype
    del flush
    log(f"  phase 3 done at {time.monotonic() - t_start:.1f} s")

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
    log(f"  phases 4f-4j took {time.monotonic() - t_mobility:.1f} s")

    log("[5/7] train: BERT-base pretraining, bf16")
    train = train_bf16(device)
    log("[6/7] train parity: fp32, kernels vs plain versions")
    train_fp32_parity(device)

    lines = [kernel_line(e, rows[e.name], stats["launches"][e.name],
                         {"long": long_rows} if e is PA.DECODE
                         else {"verify": verify_rows[e.name]})
             for e in fp_paged]
    # K2/K4: launches of the int8 serving run (4c), with the speculative
    # run's (4d) beside them; K4's verify calls (chunk spec_k) of 4d and
    # its verify-shape row on their own
    verify_calls = spec_stats["int8_prefill_calls_by_chunk"].get(str(SPEC_K),
                                                                 0)
    lines += [dict(kernel_line(e, rows[e.name], q8_stats["launches"][e.name],
                               {"verify": verify_rows[e.name]}
                               if e is PA.PREFILL_INT8 else None),
                   launches_speculative=spec_stats["launches"][e.name],
                   **({"launches_verify": verify_calls}
                      if e is PA.PREFILL_INT8 else {}))
              for e in int8_paged]
    lines += [kernel_line(e, flash_rows[e.name][FLASH_CASES[0][0]],
                          train["launches"][e.name],
                          {c: r for c, r in flash_rows[e.name].items()
                           if c != FLASH_CASES[0][0]})
              for e in flash]
    # K5 also runs in 4f's prefills (GPT.generate, generate_bucketed)
    k5_line, = [ln for ln in lines if ln["name"] == flash[0].name]
    k5_line["launches_generate"] = gen_stats["k5_launches"]
    log(f"[7/7] done in {time.monotonic() - t_start:.1f} s; library_ms of "
        "the two backward rows is one call for the pair: SDPA's whole "
        "backward (dq, dk, dv)")
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
