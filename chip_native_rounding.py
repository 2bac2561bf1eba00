#!/usr/bin/env python3
"""Where a frozen bf16 program's logits part from eager PyTorch's, on one
NVIDIA GPU.

    python3 chip_native_rounding.py [--out PATH]

The model and inputs are those of ``tests/test_torch_cuda.py``'s
``test_native_runner_serves_a_frozen_model_on_the_card``: the tiny bf16
Transformer (width 128, 2 heads, ffn 256, vocab 96, seed 4) on 3 x 40
source and target rows, source row 0 padded from position 30. Each
reading is the largest absolute difference over the logits against the
eager bf16 logits, in bf16 units in the last place of the largest eager
logit (``ulps``) and over the eager logits' standard deviation
(``over_std``), with the share of logits that differ at all:

- ``frozen``: the package ``save_inference_model(freeze_native=True)``
  writes, served by ``NativePredictor`` (AOTInductor with
  ``emulate_precision_casts`` on);
- ``frozen_no_emulate``: the same program frozen with
  ``emulate_precision_casts`` off;
- ``program``: the ``ExportedProgram`` run by PyTorch, no Inductor;
- ``float32``: the same weights in float32, eager (the model's own bf16
  rounding);
- ``frozen_vs_float32``: the frozen logits against that float32 run;
- ``no_padding_bias``: eager with the key-padding bias dropped, a wrong
  attention that a bound on ``frozen`` must still catch.

Then, per kind of module that the forward calls, its first instance
compiled with ``torch.compile`` (Inductor) against its eager output on
the input it gets in the forward, with ``emulate_precision_casts`` on
and off (``modules``); and the same for the forward's stages, each
compiled whole (``stages``, each on its eager inputs: the embedding,
the encoder's layers, its final LayerNorm, the encoder, the decoder,
the final LayerNorm with the tied projection, the whole forward).
Prints one JSON object and the card's nvidia-smi
line; ``--out`` also writes the object there. Exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import functools
import json
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch


def _tiny_transformer(dev):
    from paddle_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig)
    cfg = TransformerConfig.tiny(dropout=0.0, attn_dropout=0.0, d_model=128,
                                 num_heads=2, ffn_size=256, vocab_size=96,
                                 max_len=64)
    return Transformer(cfg, device=dev, dtype=torch.bfloat16, seed=4).eval()


def _inputs():
    rng = np.random.default_rng(2)
    src = rng.integers(3, 96, (3, 40)).astype(np.int32)
    src[0, 30:] = 2
    tgt = rng.integers(3, 96, (3, 40)).astype(np.int32)
    return src, tgt


def _reading(got, want):
    """``got`` against ``want`` (float arrays): max |diff| in bf16 ulps of
    ``want``'s largest magnitude, over ``want``'s std, and the share of
    elements that differ at all."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    top = float(np.abs(want).max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    err = float(np.abs(got - want).max())
    return {"max_abs_err": err, "ulps": err / ulp,
            "over_std": err / float(want.std()),
            "differ_share": float((got != want).mean())}


def _freeze(program, meta_dir, out_dir, emulate):
    """``program`` AOT-compiled as ``save_inference_model`` does, with
    ``emulate_precision_casts`` set to ``emulate``, into ``out_dir``
    beside a copy of ``meta_dir``'s meta.json."""
    from paddle_tpu_torch.inference import FROZEN_FILE
    out_dir.mkdir(parents=True)
    shutil.copy(meta_dir / "meta.json", out_dir / "meta.json")
    with torch._inductor.config.patch({"cpp.cxx": (None, "g++"),
                                       "cpp.vec_isa_ok": False,
                                       "emulate_precision_casts": emulate}):
        torch._inductor.aoti_compile_and_package(
            program, package_path=str(out_dir / FROZEN_FILE))


def _serve(model_dir, src, tgt):
    from paddle_tpu_torch.native.runner import NativePredictor
    pred = NativePredictor(str(model_dir))
    try:
        return pred.run(src, tgt)[0]
    finally:
        pred.close()


def _first_tensor(out):
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def _module_calls(model, ex):
    """The first call of each kind of module in ``model(*ex)``: kind ->
    (qualified name, module, args, kwargs)."""
    calls, hooks = {}, []
    for name, mod in model.named_modules():
        if not name or isinstance(mod, torch.nn.ModuleList):
            continue

        def pre(m, args, kwargs, name=name):
            calls.setdefault(type(m).__name__, (name, m, args, kwargs))
        hooks.append(mod.register_forward_pre_hook(pre, with_kwargs=True))
    with torch.no_grad():
        model(*ex)
    for h in hooks:
        h.remove()
    return calls


def _compiled_readings(fns):
    """``{name: fn}`` (``fn()`` a float tensor, or a tuple led by one)
    compiled by Inductor (``torch.compile``) against eager, with
    ``emulate_precision_casts`` on and off."""
    rows = {}
    for name, fn in fns.items():
        with torch.no_grad():
            want = _first_tensor(fn()).float().cpu().numpy()
        row = {}
        for emulate in (True, False):
            torch._dynamo.reset()
            with torch._inductor.config.patch(
                    {"emulate_precision_casts": emulate}), torch.no_grad():
                got = _first_tensor(torch.compile(fn)())
            row["emulate_on" if emulate else "emulate_off"] = _reading(
                got.float().cpu().numpy(), want)
        rows[name] = row
    torch._dynamo.reset()
    return rows


def _module_readings(model, ex):
    fns, names = {}, {}
    for kind, (name, mod, args, kwargs) in sorted(
            _module_calls(model, ex).items()):
        with torch.no_grad():
            out = _first_tensor(mod(*args, **kwargs))
        if isinstance(out, torch.Tensor) and out.is_floating_point():
            fns[kind] = functools.partial(mod, *args, **kwargs)
            names[kind] = name
    rows = _compiled_readings(fns)
    return {kind: {"module": names[kind], **row}
            for kind, row in rows.items()}


def _stage_readings(model, ex):
    """The forward's stages, each compiled whole: the embedding, the
    encoder's layers on the eager embedding, its final LayerNorm on their
    eager output, the encoder, the decoder on the eager memory, the final
    LayerNorm with the tied projection, and the whole forward."""
    src, tgt = ex
    seen = {}
    hooks = [ln.register_forward_pre_hook(
        lambda m, args, key=key: seen.setdefault(key, args[0]))
        for key, ln in (("enc", model.enc_ln), ("dec", model.dec_ln))]
    with torch.no_grad():
        x = model._embed(src)
        memory, bias = model.encode(src)
        model.decode(tgt, memory, bias)
    for h in hooks:
        h.remove()

    def encoder_layers():
        y = x
        for layer in model.encoder:
            y = layer(y, bias=bias)
        return y

    return _compiled_readings({
        "embed": lambda: model._embed(src),
        "encoder_layers": encoder_layers,
        "enc_ln": lambda: model.enc_ln(seen["enc"]),
        "encode": lambda: model.encode(src)[0],
        "decode": lambda: model.decode(tgt, memory, bias),
        "logits": lambda: model._logits(seen["dec"]),
        "forward": lambda: model(*ex)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_native_rounding: no CUDA device is available",
              file=sys.stderr)
        return 2
    from paddle_tpu_torch.inference import save_inference_model
    from paddle_tpu_torch.kernels import build, registry
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.native.runner import build_runner
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        runner = pool.submit(build_runner)
        build.build_all(["flash_attention"])
        runner.result()
    registry.load_all()
    dev = torch.device("cuda", 0)
    model = _tiny_transformer(dev)
    src, tgt = _inputs()
    ex = (torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev))
    with torch.no_grad():
        eager = model(*ex).float().cpu().numpy()
        wide = copy.deepcopy(model).float()(*ex).cpu().numpy()
        real_bias = T.make_padding_bias
        T.make_padding_bias = lambda valid, dtype=torch.float32: torch.zeros(
            (valid.shape[0], 1, 1, valid.shape[1]), dtype=dtype,
            device=valid.device)
        try:
            no_bias = model(*ex).float().cpu().numpy()
        finally:
            T.make_padding_bias = real_bias
    res = {"float32": _reading(wide, eager),
           "no_padding_bias": _reading(no_bias, eager)}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        program = save_inference_model(str(d / "on"), model, ex,
                                       freeze_native=True)
        with torch.no_grad():
            ran = _first_tensor(program.module()(*ex)).float().cpu().numpy()
        res["program"] = _reading(ran, eager)
        frozen = _serve(d / "on", src, tgt)
        res["frozen"] = _reading(frozen, eager)
        res["frozen_vs_float32"] = _reading(frozen, wide)
        _freeze(program, d / "on", d / "off", emulate=False)
        res["frozen_no_emulate"] = _reading(_serve(d / "off", src, tgt),
                                            eager)
    res["modules"] = _module_readings(model, ex)
    res["stages"] = _stage_readings(model, ex)
    text = json.dumps(res)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
