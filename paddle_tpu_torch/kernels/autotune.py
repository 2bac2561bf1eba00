"""Launch-tunable autotuner: measure and cache per (kernel, shape bucket).

The port's counterpart of ``paddle_tpu/kernels/autotune.py``. Every
registered kernel's launch tunables (its contract's candidates) resolve
through one :class:`KernelTuner`. Today each kernel declares one
candidate per tunable: the paged kernels' warps a block and the flash
kernels' tiles are fixed at compile time, so a measurement times that
one configuration and the wrappers never look the tuner up; a tunable
with several candidates is resolved as below.

- **Key**: ``kernel|v<contract version>|<pow2 shape bucket>|<dtypes>|
  <device kind>``, the reference's form. The shape bucket comes from the
  entry's ``tune_signature`` with each dim rounded up to a power of two,
  so it equals the reference's bucket for the same shapes; the device
  kind is ``torch.cuda.get_device_name()`` of the call's card (spaces as
  underscores, as the reference writes TPU kinds), or ``cpu``.
- **Prior**: on a miss, the configuration the kernel runs today (the
  contract's ``prior``). This departs from the reference, whose prior is
  the largest candidate whose VMEM working set fits: there, large blocks
  are the TPU's fast default; here the warp counts were chosen by
  measurement at the serving shapes, so with an empty cache the
  main path runs exactly the kernels it ran before the tuner existed,
  and only a measured entry could change a launch.
- **Measurement**: :meth:`KernelTuner.measure` times every candidate on
  the card with CUDA events (the L2 flushed and the card spinning ~1 ms
  before each launch, after a warm-up, as ``chip_smoke.py`` times its
  kernels' ``device_ms``), each after it passed the parity battery's
  kernel leg (:func:`~paddle_tpu_torch.kernels.harness.kernel_leg`), and
  keeps the fastest.
- **Resolution**: :meth:`KernelTuner.get` is a dictionary lookup on the
  host and never measures (:func:`~paddle_tpu_torch.kernels.harness.
  dispatch` with a ``tuner``, ``KernelEntry.blocks_for`` with no
  ``blocks``). Under a CUDA graph capture a wrapper runs once, at capture,
  so a choice would be baked into the graph (the counterpart of the
  reference's trace-time resolution) and no replay resolves again.
- **Persistence**: ``paddle_tpu_torch/kernels/tune.json`` (the port's
  own; ``tools/kernel_tune.json`` stays the reference's). Refresh it on
  the card with ``python -m paddle_tpu_torch.kernels.autotune --measure``
  and commit what it writes. Entries whose contract version moved, or
  whose blocks the contract no longer admits, are stale: detected,
  counted and ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.kernels import registry as _registry

DEFAULT_CACHE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tune.json")

_SCHEMA_VERSION = 1

#: device clock cycles (~1 ms on an H100) the card spins before a timed
#: launch, so the host's work in the call hides under the spin
SPIN_CYCLES = 2_000_000


def next_pow2(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


_KINDS: Dict[int, str] = {}


def device_kind(device=None) -> str:
    """``torch.cuda.get_device_name`` of a CUDA device with spaces as
    underscores, or ``"cpu"``."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return "cpu"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    kind = _KINDS.get(idx)
    if kind is None:
        kind = _KINDS[idx] = torch.cuda.get_device_name(idx).replace(" ", "_")
    return kind


def _tensors(args):
    return [a for a in args if isinstance(a, torch.Tensor)]


_DTYPE_NAMES: Dict[torch.dtype, str] = {}


def _dtype_name(dtype) -> str:
    name = _DTYPE_NAMES.get(dtype)
    if name is None:
        name = _DTYPE_NAMES[dtype] = str(dtype).replace("torch.", "")
    return name


def tune_key(entry, args, kwargs=None) -> str:
    """Deterministic cache key of one call signature."""
    bucket = "x".join(f"{label}{next_pow2(d)}"
                      for label, d in entry.tune_signature(args))
    tensors = _tensors(args)
    dtypes = "-".join(sorted({_dtype_name(t.dtype) for t in tensors}))
    kind = device_kind(tensors[0].device if tensors else None)
    return (f"{entry.name}|v{entry.contract.version}|{bucket}|{dtypes}|"
            f"{kind}")


def static_prior(entry, args) -> Dict[str, int]:
    """The configuration an empty cache resolves to: the one the
    kernel's source fixes (see the module docstring for why this is not
    the reference's largest-that-fits prior)."""
    return dict(entry.contract.prior(args))


def _valid(entry, args, ent) -> bool:
    return (int(ent.get("contract_version", -1)) == entry.contract.version
            and entry.contract.admits(args, ent.get("blocks", {})))


class KernelTuner:
    """Measure-and-cache launch configurations, persisted as JSON.

    ``path=None`` is a pure in-memory tuner (tests, a measurement into a
    temporary file); :func:`default_tuner` reads the committed
    ``tune.json``."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: Dict[str, dict] = {}
        self.comment: List[str] = []
        self.hits = 0
        self.misses = 0
        self.stale = 0
        # replicas on their own threads resolve launches concurrently
        self._count_lock = threading.Lock()
        if path and os.path.exists(path):
            self.load(path)

    # -- persistence --------------------------------------------------------
    def load(self, path: str):
        with open(path) as f:
            data = json.load(f)
        if int(data.get("schema_version", 0)) != _SCHEMA_VERSION:
            return  # incompatible manifest: a cold cache
        self.comment = list(data.get("_comment", []))
        self.entries.update(data.get("entries", {}))

    def save(self, path: Optional[str] = None, comment: Sequence[str] = ()):
        path = path or self.path
        manifest = {
            "_comment": list(comment) or self.comment or [
                "Launch configurations of the port's Hopper kernels "
                "(paddle_tpu_torch/kernels/autotune.py).",
                "Refresh on the card: python -m "
                "paddle_tpu_torch.kernels.autotune --measure",
                "Keys are kernel|v<contract>|<pow2 bucket>|<dtypes>|"
                "<device kind>; entries with a stale contract_version "
                "are ignored and should be deleted."],
            "schema_version": _SCHEMA_VERSION,
            "entries": {k: self.entries[k] for k in sorted(self.entries)},
        }
        with open(path, "w") as f:
            json.dump(manifest, f, indent=1)
            f.write("\n")

    # -- resolution ----------------------------------------------------------
    def get(self, entry, args, kwargs=None) -> Dict[str, int]:
        """The launch configuration of one call: the cached entry of its
        key if it is valid, else the prior. Host code on shapes only; it
        never measures, and a stale entry is counted and ignored."""
        key = tune_key(entry, args, kwargs)
        ent = self.entries.get(key)
        valid = ent is not None and _valid(entry, args, ent)
        with self._count_lock:
            if valid:
                self.hits += 1
            else:
                self.stale += ent is not None
                self.misses += 1
        return dict(ent["blocks"]) if valid else static_prior(entry, args)

    # -- measurement (on the card only) -------------------------------------
    def measure(self, entry, args, kwargs=None, *, reps: int = 20,
                flush=None, candidates=None) -> dict:
        """Time every candidate of one call on the card and cache the
        fastest. Each candidate first passes the kernel leg of the parity
        battery on these inputs; one outside its tolerance raises (a
        kernel fault, not a slower choice). Returns ``{"key", "blocks", "device_ms" (by configuration),
        "max_abs_err" (by configuration), "prior", "prior_ms",
        "best_ms"}``. Raises for CPU tensors: a time comes only from the
        card."""
        from paddle_tpu_torch.kernels import harness
        kwargs = dict(kwargs or {})
        tensors = _tensors(args)
        if not tensors or tensors[0].device.type != "cuda":
            raise ValueError(f"{entry.name}: measure needs CUDA tensors")
        key = tune_key(entry, args, kwargs)
        prior = static_prior(entry, args)
        flush = flush or L2Flush(tensors[0].device)
        times: Dict[str, float] = {}
        errs: Dict[str, float] = {}
        best, best_ms = None, float("inf")
        for cand in (candidates or entry.contract.grid(args)):
            text = _registry.blocks_text(cand)
            errs[text] = harness.kernel_leg(entry, args, kwargs, cand)
            ms = device_ms(lambda: entry.cuda_fn(*args, blocks=cand,
                                                 **kwargs), flush, reps)
            times[text] = ms
            if ms < best_ms:
                best, best_ms = dict(cand), ms
        self.entries[key] = {
            "blocks": best,
            "source": "measured",
            "contract_version": entry.contract.version,
            "device_ms": times,
            "max_abs_err": errs,
        }
        return {"key": key, "blocks": best, "device_ms": times,
                "max_abs_err": errs, "prior": prior,
                "prior_ms": times[_registry.blocks_text(prior)],
                "best_ms": best_ms}

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "stale": self.stale, "entries": len(self.entries)}

    def stale_entries(self) -> List[str]:
        """Keys that are dead: a kernel the registry does not know, a
        recorded contract version behind the registered one, or blocks
        that are not a configuration of the contract's candidates (the
        candidates are read at the key's head dim and dtypes). The rule
        :meth:`purge_stale`, :meth:`report` and the registry lint read;
        :meth:`get` applies it to the call's own arguments."""
        _registry.load_all()
        dead = []
        for key, ent in self.entries.items():
            name = key.split("|", 1)[0]
            try:
                entry = _registry.get(name)
            except KeyError:
                dead.append(key)
                continue
            blocks = ent.get("blocks", {})
            grids = _key_grids(entry, key)
            if int(ent.get("contract_version", -1)) != \
                    entry.contract.version or blocks not in grids:
                dead.append(key)
        return dead

    def purge_stale(self) -> int:
        """Drop every stale entry; returns how many were dropped."""
        dead = self.stale_entries()
        for key in dead:
            del self.entries[key]
        return len(dead)

    def report(self, kind: str) -> Dict[str, List[str]]:
        """The entries of one device kind, as ``{"fresh": [...],
        "stale": [...]}`` keys."""
        dead = set(self.stale_entries())
        mine = [k for k in sorted(self.entries) if k.rsplit("|", 1)[-1] == kind]
        return {"fresh": [k for k in mine if k not in dead],
                "stale": [k for k in mine if k in dead]}


def _key_grids(entry, key: str) -> Tuple[Dict[str, int], ...]:
    """The configurations the contract admits at a key's bucket: its
    candidates on meta tensors of the key's head dim and dtypes (the only
    parts of a call the candidates read)."""
    parts = key.split("|")
    dims = dict(_split_dim(d) for d in parts[2].split("x")) if \
        len(parts) > 2 else {}
    dtypes = parts[3].split("-") if len(parts) > 3 else ["float32"]
    float_dt = next((getattr(torch, d) for d in dtypes
                     if d in ("bfloat16", "float32")), torch.float32)
    d = dims.get("d", 64)
    q = torch.empty((1, 1, d), dtype=float_dt, device="meta")
    args = (q,) + tuple(
        torch.empty((1, 1, 1, d), dtype=torch.int8 if "int8" in dtypes
                    else float_dt, device="meta") for _ in range(2))
    return entry.contract.grid(args)


def _split_dim(text: str) -> Tuple[str, int]:
    i = len(text.rstrip("0123456789"))
    return text[:i], int(text[i:] or 0)


# ---------------------------------------------------------------------------
# timing on the card
# ---------------------------------------------------------------------------

class L2Flush:
    """Overwrite a buffer larger than the 50 MB L2 before a timed launch,
    so the kernel finds its inputs in device memory, as the serving loop
    does (12 layers of weights and K/V pass between two calls of one
    layer)."""

    def __init__(self, device):
        self.buf = torch.empty(96 << 20, dtype=torch.uint8, device=device)

    def __call__(self):
        self.buf.fill_(1)


def device_ms(fn, flush, reps: int) -> float:
    """Median device time (ms) of ``fn()`` over ``reps`` launches, each
    after an L2 flush and ~1 ms of spinning (``SPIN_CYCLES``), measured
    with CUDA events after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(max(reps, 1)):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


_DEFAULT: Optional[KernelTuner] = None


def default_tuner() -> KernelTuner:
    """The process-wide tuner over the committed cache."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = KernelTuner(DEFAULT_CACHE_PATH)
    return _DEFAULT


def set_default_tuner(tuner: Optional[KernelTuner]) -> Optional[KernelTuner]:
    """Swap the process-wide tuner (tests, a measurement run); returns
    the previous one."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, tuner
    return prev


# ---------------------------------------------------------------------------
# the cells' shapes
# ---------------------------------------------------------------------------

#: the serving cell's paged shapes (``chip_smoke.py`` phase 3): slots,
#: heads, head dim, page size, block-table width, prefill chunk, and the
#: verify chunk of speculative decoding
S, H, DH, PS, W, C, SPEC_K = 16, 16, 64, 16, 32, 64, 4
#: a long, few-slot decode: 2 slots of 4096 tokens
S_LONG, W_LONG = 2, 256
#: phase 5's flash shape: BERT-base at batch 48 x 512
FLASH_SHAPE = (48, 12, 512, 64)

#: (kernel, label, kind of inputs, geometry)
CELLS = (
    ("ragged_paged_decode", "serve", "decode", (S, W)),
    ("ragged_paged_decode", "long", "decode", (S_LONG, W_LONG)),
    ("ragged_paged_decode_int8", "serve", "decode_int8", (S, W)),
    ("ragged_paged_prefill", "serve", "prefill", (S, W, C)),
    ("ragged_paged_prefill", "verify", "prefill", (S, W, SPEC_K)),
    ("ragged_paged_prefill_int8", "serve", "prefill_int8", (S, W, C)),
    ("ragged_paged_prefill_int8", "verify", "prefill_int8", (S, W, SPEC_K)),
    ("flash_attention_fwd", "train", "flash_fwd", FLASH_SHAPE),
    ("flash_attention_bwd_dkv", "train", "flash_bwd", FLASH_SHAPE),
    ("flash_attention_bwd_dq", "train", "flash_bwd", FLASH_SHAPE),
)


def cell_inputs(kind: str, geom, device, dtype=torch.bfloat16, seed=0):
    """``(args, kwargs)`` of one cell shape: seeded random pages, ragged
    live lengths, ragged chunks (a ``device="meta"`` call gives empty
    tensors of the same shapes and dtypes, which is all a key reads)."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    meta = dev.type == "meta"

    def t(shape, dt, draw):
        if meta:
            return torch.empty(shape, dtype=dt, device=dev)
        return torch.from_numpy(draw()).to(device=dev, dtype=dt)

    if kind.startswith("flash"):
        b, h, s, d = geom
        q, k, v = (t((b, h, s, d), dtype,
                     lambda: rng.standard_normal((b, h, s, d)).astype(
                         np.float32)) for _ in range(3))
        valid = rng.integers(s // 4, s + 1, b)
        bias = t((b, 1, 1, s), torch.float32, lambda: np.where(
            np.arange(s)[None, :] < valid[:, None], 0.0, -1e30).astype(
                np.float32)[:, None, None, :])
        if kind == "flash_fwd":
            return (q, k, v, bias), {}
        do = t((b, h, s, d), dtype, lambda: rng.standard_normal(
            (b, h, s, d)).astype(np.float32))
        if meta:
            lse = torch.empty((b, h, s), device=dev)
            return (q, k, v, bias, do, lse, lse), {}
        # the backward's lse and delta from the plain forward on these
        # inputs, as the training step hands them over
        from paddle_tpu_torch.ops.attention import (flash_delta,
                                                    flash_fwd_plain)
        out, lse = flash_fwd_plain(q, k, v, bias)
        return (q, k, v, bias, do, lse, flash_delta(do, out)), {}
    s_slots, w = geom[0], geom[1]
    n_pages = 1 + s_slots * w
    quant = kind.endswith("int8")
    page_dt = torch.int8 if quant else dtype
    shape = (n_pages, PS, H, DH)
    if quant:
        pages = [t(shape, torch.int8, lambda: rng.integers(
            -127, 128, shape).astype(np.int8)) for _ in range(2)]
        scales = [t(shape[:2], torch.float32, lambda: rng.uniform(
            1e-3, 2e-2, shape[:2]).astype(np.float32)) for _ in range(2)]
    else:
        pages = [t(shape, page_dt, lambda: rng.standard_normal(shape).astype(
            np.float32)) for _ in range(2)]
        scales = []
    bt = t((s_slots, w), torch.int32, lambda: (1 + rng.permutation(
        s_slots * w)).reshape(s_slots, w).astype(np.int32))
    if kind.startswith("decode"):
        q = t((s_slots, H, DH), dtype, lambda: rng.standard_normal(
            (s_slots, H, DH)).astype(np.float32))
        lengths = t((s_slots,), torch.int32, lambda: rng.integers(
            w * PS // 2, w * PS + 1, s_slots).astype(np.int32))
        return (q, *pages, *scales, bt, lengths), {}
    c = geom[2]
    q = t((s_slots, c, H, DH), dtype, lambda: rng.standard_normal(
        (s_slots, c, H, DH)).astype(np.float32))
    starts = t((s_slots,), torch.int32, lambda: rng.integers(
        0, w * PS - c + 1, s_slots).astype(np.int32))
    n_valid = t((s_slots,), torch.int32, lambda: rng.integers(
        1, c + 1, s_slots).astype(np.int32))
    return (q, *pages, *scales, bt, starts, n_valid), {}


def cells(device, dtype=torch.bfloat16, seed=0):
    """``[(entry, label, args, kwargs)]`` over :data:`CELLS`."""
    _registry.load_all()
    return [(_registry.get(name), label,
             *cell_inputs(kind, geom, device, dtype, seed))
            for name, label, kind, geom in CELLS]


def measure_cells(tuner: KernelTuner, device, reps: int = 20,
                  log=print) -> List[dict]:
    """:meth:`KernelTuner.measure` at every cell shape (bf16, the
    timed cells' dtype), one line logged per key."""
    flush = L2Flush(device)
    out = []
    for entry, label, args, kwargs in cells(device):
        r = tuner.measure(entry, args, kwargs, reps=reps, flush=flush)
        r.update(name=entry.name, label=label)
        out.append(r)
        log(f"  tune {entry.name}[{label}] {r['key']}: chose "
            f"{_registry.blocks_text(r['blocks'])} {r['best_ms']:.4f} ms; "
            f"prior {_registry.blocks_text(r['prior'])} "
            f"{r['prior_ms']:.4f} ms")
        del args
    return out


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Measure the port's kernel launch configurations at "
                    "the cells' shapes on the card")
    ap.add_argument("--measure", action="store_true",
                    help="time every candidate at the cells' shapes")
    ap.add_argument("--out", default=DEFAULT_CACHE_PATH)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not args.measure:
        ap.error("nothing to do (pass --measure)")
    if not torch.cuda.is_available():
        print("autotune: no CUDA device: a measurement needs the card",
              file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import build
    build.build_all()
    device = torch.device("cuda", 0)
    tuner = KernelTuner(args.out if os.path.exists(args.out) else None)
    purged = tuner.purge_stale()
    smi = nvidia_smi_line()
    t0 = time.monotonic()
    results = measure_cells(tuner, device, reps=args.reps)
    tuner.save(args.out, comment=[
        "Launch configurations of the port's Hopper kernels "
        "(paddle_tpu_torch/kernels/autotune.py), measured at the cells' "
        "shapes by python -m paddle_tpu_torch.kernels.autotune --measure",
        f"on {smi} (nvidia-smi name, power.limit), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; device_ms is "
        "the median device time of each configuration.",
        "Keys are kernel|v<contract>|<pow2 bucket>|<dtypes>|<device "
        "kind>; entries with a stale contract_version are ignored and "
        "should be deleted."])
    print(json.dumps({"measured": len(results), "purged": purged,
                      "seconds": round(time.monotonic() - t0, 1),
                      "out": args.out, "device": smi}))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
