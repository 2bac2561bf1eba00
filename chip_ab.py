#!/usr/bin/env python3
"""Compare two checkouts of the repo on one NVIDIA GPU, in turns.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [--phases train,serve]

Runs phases of each checkout's own ``chip_smoke.py`` in the order parent,
change, change, parent, one process per turn started inside that
checkout, so that each builds and imports its own ``paddle_tpu_torch``:

- ``train``: phase 5, BERT-base pretraining (``train_bf16``): ms per
  step, tokens/s, MFU, and (a tree without them reads None) the busy
  share, peak memory, the AdamW's kernels and device ms per step, the
  captures after the first graphed step, the snapshot's blocking host
  copy, ms per step of the window with a save in it, and restore s;
- ``serve``: phases 4a, 4c and 4d, bf16, int8 and speculative int8
  serving (``serve``), and 4a's and 4c's decode profiles (the
  ``decode_profile`` of ``serve``'s stats): the device's busy share, its
  device time and the paged decode kernel's (K1, K2) share of it over 4
  decode blocks, with its kernels and the host's launch calls (one per
  eager kernel, one per graph replay); and 4a's prefill window
  (``prefill_window``): 16 requests with 4a's prompt lengths and one new
  token each, so that the window holds only batched prefill calls, run
  4 times unprofiled and 4 times under the profiler: prompt tokens/s,
  the device's busy share, its device time, the fp prefill kernel's
  (K3) part of it, its kernels and the host's launch calls; then 4g's
  bf16 slot migration (snapshot and restore ms per slot and GB/s) and
  4h's disaggregated tiers (decode tokens/s, TTFT, handoff latency and
  bytes), 4k's fleet (the 4-replica aggregate tokens/s) and 4l's network
  tier (transport overhead in ms per token, streamed TTFT p99). A key
  one tree does not report (the graphs' counts in a tree without graphs,
  the migration, tier and fleet numbers in a tree without them) reads
  None and gets no ratio;
- ``kernels``: the bf16 rows of K1 at the serving shape and at the long,
  few-slot shape, of K2, K3 and K4 at the serving shape, of K3 and K4 at
  the speculative verify chunk, and of K6b at the training shape, from
  phase 3 (``check_kernel``, ``check_long_decode``, ``check_flash``):
  each call's ``ms``, ``device_ms`` and ``host_ms``.

Host-bound phases move with the machine a run lands on, so two versions
are compared only inside one such run. Prints one ``AB <label> {...}``
line per turn, one line per metric with both checkouts' runs and the
ratio of their means, and the card's nvidia-smi line. Exits non-zero
without a card or when a turn fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

TRAIN_KEYS = ("ms_per_step", "tokens_per_s", "mfu_vs_989tflops",
              "busy_share", "peak_memory_gib", "adamw_kernels_per_step",
              "adamw_device_ms", "captures_after_first_graphed_step",
              "snapshot_blocking_s_mean", "save_window_ms_per_step",
              "restore_s")
SERVE_KEYS = ("decode_tokens_per_s", "prefill_tokens_per_s",
              "end_to_end_tokens_per_s", "ttft_p50_s", "ttft_p99_s",
              "warmup_s", "graphs", "captures_after_warmup",
              "graph_pool_bytes")
KERNEL_KEYS = ("ms", "device_ms", "host_ms")
MIGRATION_KEYS = ("snapshot_ms_per_slot", "restore_ms_per_slot",
                  "snapshot_gb_per_s", "restore_gb_per_s")
DISAGG_KEYS = ("decode_tokens_per_s", "ttft_p50_s", "ttft_p99_s",
               "handoff_p50_s", "handoff_p99_s", "handoff_bytes")
FLEET_KEYS = ("aggregate_tokens_per_s",)
NET_KEYS = ("transport_overhead_ms_per_token", "stream_ttft_p99_s")

#: one turn, run with ``python3 -c`` inside a checkout
CHILD = f"""
import functools, json, sys, torch
import chip_smoke as cs
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.serving import paged_attention as PA
build.build_all()
dev = torch.device("cuda", 0)
phases, out = sys.argv[1].split(","), {{}}


# K3 and K4 at the verify chunk (4 rows), made from the serving-shape
# prefill inputs that both trees' chip_smoke.py build alike
def verify_inputs(seed, device, quantized):
    q, *pages, starts, n_valid = cs.prefill_inputs(seed, device,
                                                   quantized=quantized)
    return (q[:, :4].contiguous(), *pages, starts, n_valid.clamp(max=4))


def prefill_window(device, reps=4):
    import itertools
    import numpy as np
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.models.gpt import GPT
    cfg = cs.model_config()
    model = GPT(cfg, device=device, dtype=torch.bfloat16, seed=0)
    eng = make_serving_engine(model, device=device, **cs.ENGINE_KW)
    eng.warmup()
    lens = [len(p) for p in cs.make_prompts(16, cfg.vocab_size, seed=7)]
    calls = itertools.count()

    def batch():        # new tokens every call: no prefix is shared
        rng = np.random.default_rng(1000 + next(calls))
        for n in lens:
            eng.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 1)
        while not eng.scheduler.idle():
            eng.step()

    prof = cs.profile_window(batch, reps, keep=("paged_prefill",))
    k3_ms = sum(k["ms"] for k in prof["kept_kernels"])
    calls = prof.get("launch_api_calls")
    wall_ms = prof["unprofiled_wall_s"] * 1e3
    del eng, model
    torch.cuda.empty_cache()
    return {{"prefill_window_tokens_per_s": sum(lens) * reps / wall_ms * 1e3,
            "prefill_window_busy_share": prof["device_busy_share"],
            "prefill_window_device_ms": prof["device_busy_s"] * 1e3,
            "prefill_window_k3_ms": k3_ms,
            "prefill_window_k3_share_of_device": k3_ms / (
                prof["device_busy_s"] * 1e3),
            "prefill_window_k3_share_of_wall": k3_ms / wall_ms,
            "prefill_window_kernels": prof["kernel_launches"],
            "prefill_window_launch_calls":
                None if calls is None else sum(calls.values())}}


if "kernels" in phases:
    from paddle_tpu_torch.ops import attention as FA
    flush = cs.L2Flush(dev)
    rows = cs.check_kernel(PA.DECODE, cs.decode_inputs, dev, flush)
    out["K1"] = {{k: rows[torch.bfloat16][k] for k in {KERNEL_KEYS!r}}}
    rows = cs.check_long_decode(dev, flush)
    out["K1_long"] = {{k: rows[torch.bfloat16][k] for k in {KERNEL_KEYS!r}}}
    for key, entry, make in (
            ("K2", PA.DECODE_INT8,
             functools.partial(cs.decode_inputs, quantized=True)),
            ("K3", PA.PREFILL, cs.prefill_inputs),
            ("K3_verify", PA.PREFILL,
             functools.partial(verify_inputs, quantized=False)),
            ("K4", PA.PREFILL_INT8,
             functools.partial(cs.prefill_inputs, quantized=True)),
            ("K4_verify", PA.PREFILL_INT8,
             functools.partial(verify_inputs, quantized=True))):
        rows = cs.check_kernel(entry, make, dev, flush)
        out[key] = {{k: rows[torch.bfloat16][k] for k in {KERNEL_KEYS!r}}}
    rows = cs.check_flash(cs.FLASH_CASES[0], dev, flush)[FA.BWD_DQ.name]
    out["K6b"] = {{k: rows[torch.bfloat16][k] for k in {KERNEL_KEYS!r}}}
    del flush
if "serve" in phases:
    for key, kernels, kw in (
            ("4a", [PA.DECODE, PA.PREFILL], {{}}),
            ("4c", [PA.DECODE_INT8, PA.PREFILL_INT8],
             {{"cache_dtype": torch.int8}}),
            ("4d", [PA.DECODE_INT8, PA.PREFILL_INT8],
             {{"cache_dtype": torch.int8, "self_draft": True, "spec_k": 4}})):
        stats, outs = cs.serve(dev, kernels, key, profile=key != "4d",
                               **kw)
        # keys a tree's chip_smoke.py does not report read None
        out[key] = {{k: stats.get(k) for k in {SERVE_KEYS!r}}}
        if key == "4a":
            out[key].update(prefill_window(dev))
            colocated = outs
        prof = stats.get("decode_profile")
        if prof is None:
            continue
        calls = prof.get("launch_api_calls")
        out[key].update(
            decode_busy_share=prof["device_busy_share"],
            decode_device_ms=prof["device_busy_s"] * 1e3,
            decode_paged_kernel_ms=sum(k["ms"] for k in prof["top_kernels"]
                                       if "paged_decode" in k["name"]),
            decode_kernels=prof["kernel_launches"],
            decode_launch_calls=None if calls is None
            else sum(calls.values()))
    mig, dis = (getattr(cs, f, None) for f in ("migration_run", "disagg_run"))
    stats = {{}} if mig is None else mig(dev, "4g bf16 migration")
    out["4g"] = {{k: stats.get(k) for k in {MIGRATION_KEYS!r}}}
    stats = {{}} if dis is None else dis(dev, colocated)
    out["4h"] = {{k: stats.get(k) for k in {DISAGG_KEYS!r}}}
    fl, nt = (getattr(cs, f, None) for f in ("fleet_run", "net_run"))
    stats = {{}} if fl is None else fl(dev)
    out["4k"] = {{k: stats.get(k) for k in {FLEET_KEYS!r}}}
    stats = {{}} if nt is None else nt(dev)
    out["4l"] = {{k: stats.get(k) for k in {NET_KEYS!r}}}
if "train" in phases:
    stats = cs.train_bf16(dev)
    out["5"] = {{k: stats.get(k) for k in {TRAIN_KEYS!r}}}
print("AB_RESULT " + json.dumps(out), flush=True)
"""


def run_turn(tree, phases, timeout):
    """One turn in ``tree``: its output goes to stderr, its result back."""
    proc = subprocess.run([sys.executable, "-c", CHILD, phases], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    sys.stderr.write(proc.stdout + proc.stderr)
    found = [line for line in proc.stdout.splitlines()
             if line.startswith("AB_RESULT ")]
    if proc.returncode != 0 or not found:
        raise RuntimeError(f"turn in {tree} failed (exit {proc.returncode})")
    return json.loads(found[-1][len("AB_RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--phases", default="train,serve")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds one turn may take")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 2
    turns = [("parent", args.parent), ("change", args.change),
             ("change", args.change), ("parent", args.parent)]
    results = []
    for label, tree in turns:
        res = run_turn(tree, args.phases, args.timeout)
        print(f"AB {label} {json.dumps(res)}", flush=True)
        results.append((label, res))
    for phase in results[0][1]:
        for key in results[0][1][phase]:
            got = {lab: [r[phase][key] for lb, r in results if lb == lab]
                   for lab in ("parent", "change")}
            line = (f"  {phase} {key}: parent {got['parent']} change "
                    f"{got['change']}")
            vals = got["parent"] + got["change"]
            if None not in vals and np.mean(got["parent"]):
                ratio = np.mean(got["change"]) / np.mean(got["parent"])
                line += f" change/parent {ratio:.4f}"
            print(line, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
