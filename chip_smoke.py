#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile ``paddle_tpu_torch/csrc/*.cu`` with nvcc (sm_90a).
3. kernels — every registered kernel against its plain PyTorch version
   (and the dense reference) on the card, at the serving shapes (S=16,
   H=16, Dh=64, page 16, width 32, chunk 64), fp32 and bf16, with ragged
   lengths (0 and non-multiples of the page), inactive prefill slots, and
   NaN in every page no block table references. Timed with CUDA events
   (median, L2 flushed before each launch), beside the roofline bound.
4. serve   — the main path at full width: GPT (vocab 32768, hidden 1024,
   12 layers, 16 heads, ffn 4096, max_position 512, random weights from a
   seed) behind ``make_serving_engine(num_slots=16, page_size=16,
   prefill_chunk=64, max_tokens_per_slot=352)``:
   (a) bf16 weights and pages, 48 requests (prompts of 16..256 tokens,
       96 new tokens each), timed; every request must finish and every
       kernel must have launched during the run;
   (b) fp32, 8 requests x 32 new tokens, through the kernels and through
       the plain versions: greedy tokens must be identical, and the first
       tokens must match the dense ``GPT.forward`` recompute.
5. output  — one ``{"kernels": [...]}`` line, the nvidia-smi line, and
   the final ``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): HBM bytes/s and FLOP/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

S, H, DH, PS, W, C = 16, 16, 64, 16, 32, 64     # serving shapes
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

def _pages(rng, n_pages):
    kp = rng.standard_normal((n_pages, PS, H, DH)).astype(np.float32)
    vp = rng.standard_normal((n_pages, PS, H, DH)).astype(np.float32)
    live = 1 + S * W
    kp[live:] = np.nan                      # pages no block table holds
    vp[live:] = np.nan
    bt = (1 + rng.permutation(S * W)).reshape(S, W).astype(np.int32)
    return kp, vp, bt


def _poison_dead_tail(kp, vp, bt, horizon):
    """Finite poison past each slot's horizon inside its last live page:
    masked tokens must contribute exact zeros."""
    for s, n in enumerate(horizon):
        n = int(n)
        if 0 < n < W * PS and n % PS:
            page = bt[s, n // PS]
            kp[page, n % PS:] = 1e4
            vp[page, n % PS:] = 1e4


def decode_inputs(seed, device):
    rng = np.random.default_rng(seed)
    kp, vp, bt = _pages(rng, 1 + S * W + UNREFERENCED_PAGES)
    lengths = rng.integers(1, W * PS + 1, S).astype(np.int32)
    lengths[:4] = (0, 1, W * PS, 17)         # inactive, one token, full, ragged
    _poison_dead_tail(kp, vp, bt, lengths)
    q = rng.standard_normal((S, H, DH)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (q, kp, vp, bt, lengths))


def prefill_inputs(seed, device):
    rng = np.random.default_rng(seed)
    kp, vp, bt = _pages(rng, 1 + S * W + UNREFERENCED_PAGES)
    starts = rng.integers(0, W * PS - C + 1, S).astype(np.int32)
    n_valid = rng.integers(1, C + 1, S).astype(np.int32)
    n_valid[:3] = (0, C, 1)                  # inactive slot, full, one row
    starts[1] = W * PS - C                   # chunk ending at the last page
    _poison_dead_tail(kp, vp, bt, np.where(n_valid > 0, starts + n_valid, 0))
    q = rng.standard_normal((S, C, H, DH)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (q, kp, vp, bt, starts, n_valid))


def _cast(args, dtype):
    """Float tensors to ``dtype``; int tensors (tables, lengths) as they are."""
    return tuple(a.to(dtype) if a.is_floating_point() else a for a in args)


class L2Flush:
    """Overwrite a buffer larger than the 50 MB L2 before a timed launch,
    so the kernel finds its inputs in HBM as the serving loop does (12
    layers of weights and K/V pass between two calls of one layer)."""

    def __init__(self, device):
        self.buf = torch.empty(96 << 20, dtype=torch.uint8, device=device)

    def __call__(self):
        self.buf.fill_(1)


def time_ms(fn, flush, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def check_kernel(entry, make_inputs, device, flush):
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = _cast(make_inputs(11, device), dtype)
        out = entry.cuda_fn(*args)
        torch.cuda.synchronize()
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
        nbytes, flops = entry.work(*args)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        rows[dtype] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: entry.cuda_fn(*args), flush, 50),
            "plain_ms": time_ms(lambda: entry.plain_fn(*args), flush, 10),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        }
        log(f"  {entry.name} [{str(dtype)[6:]}] max_abs_err={err:.3e} "
            f"kernel={rows[dtype]['ms']:.4f} ms plain="
            f"{rows[dtype]['plain_ms']:.4f} ms bound="
            f"{rows[dtype]['bound_ms']:.4f} ms ({rows[dtype]['bound_by']})")
    return rows


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


def serve_bf16(device, kernels):
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.observability import MetricsRegistry
    cfg = model_config()
    model = GPT(cfg, device=device, dtype=torch.bfloat16, seed=0)
    reg = MetricsRegistry()
    eng = make_serving_engine(model, registry=reg, device=device, **ENGINE_KW)
    t0 = time.monotonic()
    eng.warmup()
    warm_s = time.monotonic() - t0
    prompts = make_prompts(48, cfg.vocab_size)
    registry.reset_launches()               # count only the served run
    t0 = time.monotonic()
    rids = [eng.submit(p, 96) for p in prompts]
    done = {}
    while not eng.scheduler.idle():
        done.update(eng.step())
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {e.name: e.launches for e in kernels}
    for r in rids:
        toks = done.get(r)
        if toks is None or toks.shape != (96,):
            raise AssertionError(f"request {r} did not finish with 96 tokens")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r} produced an out-of-vocab token")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    gen = 96 * len(prompts)
    dec_s = reg.histogram("serving_decode_step_seconds").summary()["sum"]
    pre_s = reg.histogram("serving_prefill_step_seconds").summary()["sum"]
    ttft = reg.histogram("serving_ttft_seconds")
    stats = {
        "requests": len(prompts), "prompt_tokens": int(sum(map(len, prompts))),
        "generated_tokens": gen, "wall_s": wall, "warmup_s": warm_s,
        "decode_tokens_per_s": (gen - len(prompts)) / dec_s,
        "prefill_tokens_per_s":
            reg.counter("serving_prefill_tokens_total").value() / pre_s,
        "end_to_end_tokens_per_s": gen / wall,
        "ttft_p50_s": ttft.quantile(0.5), "ttft_p99_s": ttft.quantile(0.99),
        "decode_steps": int(reg.counter("serving_steps_total").value()),
        "launches": launches,
    }
    log("  bf16 serve: " + json.dumps(stats))
    log("  decode profile: " + json.dumps(profile_decode(eng, cfg.vocab_size)))
    del eng, model
    torch.cuda.empty_cache()
    return stats


def profile_decode(eng, vocab, blocks=4):
    """Where a decode block's time goes, after the measured run: 16 new
    requests are prefilled, then ``blocks`` decode blocks of 16 live
    slots run unprofiled (host clock, synchronised) and ``blocks`` more
    under ``torch.profiler``. The profiler's own overhead inflates its
    window's wall time, so the device's busy share is the profiled
    window's device time over the unprofiled window's wall time (the
    two windows differ only by 8 tokens per block of slot length).
    Returns that share and device time by kernel (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    for p in make_prompts(16, vocab, seed=7):
        eng.submit(p, 96)         # outlives both windows
    while eng.scheduler.queue or any(
            not eng.scheduler.slots[i].prefill_done
            for i in eng.scheduler.active_slots()):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(blocks):
        eng.step()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(blocks):
            eng.step()
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0:
            kernels.append((us, ev.key[:90], ev.count))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels) / 1e6
    return {"blocks": blocks, "tokens": blocks * eng.decode_block * 16,
            "unprofiled_wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall,
            "kernel_launches": int(sum(k[2] for k in kernels)),
            "top_kernels": [{"name": n, "ms": us / 1e3, "count": c}
                            for us, n, c in kernels[:10]]}


def dense_greedy(model, prompt, n):
    ids = torch.from_numpy(prompt.astype(np.int64))[None].to(model.device)
    out = []
    with torch.no_grad():
        for _ in range(n):
            nxt = model(ids)[0, -1].argmax()
            out.append(int(nxt))
            ids = torch.cat([ids, nxt.view(1, 1)], dim=1)
    return np.asarray(out, np.int32)


def serve_fp32_parity(device, kernels):
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.models.gpt import GPT
    # fp32 parity leg: TF32 off for matmuls AND cuDNN, stated explicitly
    # (PyTorch's matmul default is already off; cuDNN's is on)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_config()
    model = GPT(cfg, device=device, dtype=torch.float32, seed=0)
    prompts = make_prompts(8, cfg.vocab_size, seed=99)
    outs = {}
    for impl in ("kernel", "plain"):
        registry.reset_launches()
        eng = make_serving_engine(model, device=device, attn_impl=impl,
                                  **ENGINE_KW)
        outs[impl] = eng.generate_many(prompts, max_new_tokens=32)
        launched = {e.name: e.launches for e in kernels}
        if impl == "kernel" and min(launched.values()) <= 0:
            raise AssertionError(f"fp32 kernel run missed a kernel: {launched}")
        if impl == "plain" and max(launched.values()) != 0:
            raise AssertionError(f"plain run launched kernels: {launched}")
        del eng
    for i, (a, b) in enumerate(zip(outs["kernel"], outs["plain"])):
        if not np.array_equal(a, b):
            raise AssertionError(f"fp32 request {i}: kernel tokens {a} != "
                                 f"plain tokens {b}")
    for i in range(2):
        ref = dense_greedy(model, prompts[i], 4)
        if not np.array_equal(outs["kernel"][i][:4], ref):
            raise AssertionError(f"fp32 request {i}: engine {outs['kernel'][i][:4]}"
                                 f" != dense GPT.forward {ref}")
    log("  fp32 parity: 8 requests x 32 tokens identical through kernels "
        "and plain versions; first 4 tokens of 2 requests match dense forward")
    del model
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import build, registry
    t_start = time.monotonic()
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"[1/5] device: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.monotonic()
    secs = build.build_all()
    log(f"[2/5] build: {json.dumps(secs)} in {time.monotonic() - t0:.1f} s")
    for stem, text in build.build_logs.items():
        print(f"--- nvcc {stem}.cu ---\n{text}", file=sys.stderr)

    registry.load_all()
    kernels = [registry.get(n) for n in registry.names()]
    from paddle_tpu_torch.serving import paged_attention as PA
    makers = {PA.DECODE.name: decode_inputs, PA.PREFILL.name: prefill_inputs}
    log("[3/5] kernels vs plain versions")
    flush = L2Flush(device)
    rows = {e.name: check_kernel(e, makers[e.name], device, flush)
            for e in kernels}
    del flush

    log("[4/5] main path")
    stats = serve_bf16(device, kernels)
    serve_fp32_parity(device, kernels)

    lines = []
    for e in kernels:
        b16, f32 = rows[e.name][torch.bfloat16], rows[e.name][torch.float32]
        lines.append({
            "name": e.name, "route": e.route, "source": e.source,
            "replaces": e.replaces, "launches": stats["launches"][e.name],
            "max_abs_err": b16["max_abs_err"],
            "ms": b16["ms"], "plain_ms": b16["plain_ms"],
            "bound_ms": b16["bound_ms"], "bound_by": b16["bound_by"],
            "library_ms": None, "dtype": "bfloat16",
            "fp32": {k: f32[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by")},
        })
    log(f"[5/5] done in {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
