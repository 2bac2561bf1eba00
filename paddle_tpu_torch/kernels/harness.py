"""Shared dispatch and parity battery of the registered kernels.

The port's counterpart of ``paddle_tpu/kernels/harness.py``. One entry
point runs any registered kernel::

    out = dispatch("ragged_paged_decode", q, k_pages, v_pages,
                   block_tables, lengths, impl="auto")

``impl`` is one of:

- ``"auto"``: the Hopper kernel for CUDA tensors, the plain PyTorch
  version for CPU tensors (never one for the other);
- ``"cuda"``: the kernel; CPU tensors raise;
- ``"plain"``: the plain PyTorch version on any device.

The kernel's launch tunables resolve through the autotuner
(:func:`~paddle_tpu_torch.kernels.autotune.default_tuner`, or ``tuner``),
unless ``block_sizes`` names them.

:func:`parity_check` is the battery every registered kernel must pass,
on its own sample inputs within its declared tolerance: the kernel on the
card under every configuration of its tunables, fp32 and bf16; the plain
version; and the dense reference, which both are held to. The
reference's fourth leg, its lax fallback, is JAX: the port does not
import it, and the tests run that leg through numpy
(``tests/test_torch_kernels.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from paddle_tpu_torch.kernels import registry as _registry

IMPLS = ("auto", "cuda", "plain")


def _device(args) -> torch.device:
    return next(a.device for a in args if isinstance(a, torch.Tensor))


def resolve_impl(impl: str, args) -> str:
    """Canonical impl name -> ``"cuda"`` or ``"plain"`` for these
    arguments."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected "
                         f"{'|'.join(IMPLS)})")
    dev = _device(args)
    if impl == "auto":
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}")
        return "cuda" if dev.type == "cuda" else "plain"
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {dev}")
    return impl


def dispatch(name: str, *args, impl: str = "auto",
             block_sizes: Optional[Mapping[str, int]] = None,
             tuner=None, **kwargs):
    """Run kernel ``name`` (see the module docstring). ``block_sizes``
    overrides the tuner; ``tuner`` overrides the process-wide cache."""
    entry = _registry.get(name)
    if resolve_impl(impl, args) == "plain":
        return entry.plain_fn(*args, **kwargs)
    if block_sizes is None and tuner is not None:
        block_sizes = tuner.get(entry, args, kwargs)
    return entry.cuda_fn(*args, blocks=block_sizes, **kwargs)


def _flat(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def max_error(got, want, tol, what: str) -> float:
    """Max |got - want| over the outputs (float32), raising
    ``AssertionError`` outside ``tol`` = (atol, rtol) or on non-finite
    values."""
    atol, rtol = tol
    err = 0.0
    for g, w in zip(_flat(got), _flat(want), strict=True):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        if g.shape != w.shape:
            raise AssertionError(f"{what}: shape {tuple(g.shape)} against "
                                 f"{tuple(w.shape)}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite output")
        if g.numel():
            err = max(err, float((g - w).abs().max()))
        if not torch.allclose(g, w, atol=atol, rtol=rtol):
            raise AssertionError(f"{what}: max |diff| = {err:.3e} > atol "
                                 f"{atol} / rtol {rtol}")
    return err


def cast_inputs(entry, args, dtype):
    """The float arguments whose declared layout names no dtype of its
    own (q, k, v, fp pages, do) in ``dtype``; int8 pages, fp32 scale
    rows, lse, delta, the bias and integers as they are."""
    out = []
    for (name, layout), a in zip(entry.contract.arg_layouts.items(), args,
                                 strict=True):
        own_dtype = layout.rsplit(")", 1)[-1].strip()
        if (isinstance(a, torch.Tensor) and a.is_floating_point()
                and name != "bias" and not own_dtype):
            a = a.to(dtype)
        out.append(a)
    return tuple(out)


def kernel_leg(entry, args, kwargs, blocks: Mapping[str, int]) -> float:
    """The kernel under one configuration on CUDA ``args``, held to the
    plain version run in float32 on the same inputs within the entry's
    tolerance for ``args``' dtype; returns the max abs error."""
    out = entry.cuda_fn(*args, blocks=dict(blocks), **kwargs)
    torch.cuda.synchronize()
    want = entry.plain_fn(*cast_inputs(entry, args, torch.float32),
                          **kwargs)
    dtype = args[0].dtype
    return max_error(out, want, entry.tolerance[dtype],
                     f"{entry.name}[{_registry.blocks_text(blocks)}]"
                     f"[{dtype}]")


def parity_check(name: str, seed: int = 0, *,
                 device: Optional[torch.device] = None) -> Dict[str, float]:
    """Run one kernel's parity battery on its sample inputs. Returns
    ``{leg: max_abs_err}``: ``"plain"`` and ``"reference"`` (the dense
    reference's leg: its output layout against the plain version's, 0.0
    by construction) always; with a CUDA ``device``, ``"cuda[<blocks>]
    [<dtype>]"`` for every configuration of the tunables in float32 and
    bfloat16 (bf16 against the plain version in float32 on the same bf16
    inputs), each also held to the dense reference in float32. Raises
    ``AssertionError`` outside the entry's tolerance."""
    entry = _registry.get(name)
    args, kwargs = entry.sample_inputs(seed)
    tol = entry.tolerance[torch.float32]
    ref = entry.reference_fn(*args, **kwargs)
    plain = entry.plain_fn(*args, **kwargs)
    errs = {"plain": max_error(plain, ref, tol, f"{name}[plain]")}
    for p, r in zip(_flat(plain), _flat(ref), strict=True):
        if p.shape != r.shape or p.dtype != r.dtype:
            raise AssertionError(f"{name}[reference]: {tuple(r.shape)} "
                                 f"{r.dtype} against the plain version's "
                                 f"{tuple(p.shape)} {p.dtype}")
    errs["reference"] = 0.0
    if device is None or torch.device(device).type != "cuda":
        return errs
    on_card = tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                    for a in args)
    for dtype in (torch.float32, torch.bfloat16):
        cargs = cast_inputs(entry, on_card, dtype)
        for blocks in entry.contract.grid(cargs):
            text = _registry.blocks_text(blocks)
            errs[f"cuda[{text}][{str(dtype)[6:]}]"] = kernel_leg(
                entry, cargs, kwargs, blocks)
            if dtype == torch.float32:
                max_error(entry.cuda_fn(*cargs, blocks=blocks, **kwargs),
                          ref, tol, f"{name}[cuda {text}] vs reference")
    return errs
