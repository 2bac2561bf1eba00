"""Fault F1: ``dot_product_attention(impl="auto")`` takes every shape and
dtype, as the reference's "auto" does.

The flash kernels take head dims 32, 64 and 128 in fp32 and bf16. Under
"auto" a head dim up to 128 outside those is zero-padded to the next one
(``padded_flash_attention``), which is exact: the padded q and k columns
add nothing to q.k, and the padded output columns get a zero cotangent.
A larger head dim or another dtype takes the composed path. On the CPU
the flash path runs the kernels' plain versions, so padding is held
here against the unpadded plain versions, forward and backward, within
1e-6 (the same fp32 sums over another number of zero terms).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import attention as attn

torch.set_num_threads(2)

TOL = dict(atol=1e-6, rtol=1e-6)


def _inputs(seed, b, h, sq, sk, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((b, h, sq, d)).astype(
        np.float32)).to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, h, sk, d)).astype(
        np.float32)).to(dtype) for _ in range(2))
    return q, k, v, do


def _out_and_grads(fn, q, k, v, do):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    out.backward(do)
    return [out.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("d,padded", [(16, 32), (48, 64), (80, 128),
                                      (96, 128)])
@pytest.mark.parametrize("causal,bias", [(False, None), (True, None),
                                         (False, "key")],
                         ids=["full", "causal", "key-bias"])
def test_padding_to_the_kernels_head_dim_is_exact(d, padded, causal, bias):
    assert attn.kernel_head_dim(d) == padded
    q, k, v, do = _inputs(d, 2, 3, 17, 23, d)
    if bias == "key":
        valid = torch.arange(23)[None, :] < torch.tensor([23, 9])[:, None]
        bias = attn.make_padding_bias(valid)
    got = _out_and_grads(lambda *a: attn.padded_flash_attention(
        *a, bias, causal), q, k, v, do)
    want = _out_and_grads(lambda *a: attn.flash_attention(
        *a, bias, causal), q, k, v, do)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, **TOL, msg=name)


def _spy(monkeypatch):
    """Record which path each call of ``dot_product_attention`` takes."""
    calls = []
    flash, composed = attn.flash_attention, attn.scaled_dot_product_attention

    def flash_spy(q, *a, **kw):
        calls.append(("flash", q.shape[-1]))
        return flash(q, *a, **kw)

    def composed_spy(q, *a, **kw):
        calls.append(("composed", q.shape[-1]))
        return composed(q, *a, **kw)

    monkeypatch.setattr(attn, "flash_attention", flash_spy)
    monkeypatch.setattr(attn, "scaled_dot_product_attention", composed_spy)
    return calls


@pytest.mark.parametrize("d,dtype,route", [
    (16, torch.float32, ("flash", 32)),
    (64, torch.bfloat16, ("flash", 64)),
    (96, torch.float32, ("flash", 128)),
    (160, torch.float32, ("composed", 160)),
    (64, torch.float16, ("composed", 64)),
    (200, torch.bfloat16, ("composed", 200))])
def test_auto_routes_from_shape_and_dtype_without_raising(monkeypatch, d,
                                                          dtype, route):
    calls = _spy(monkeypatch)
    q, k, v, _ = _inputs(d, 1, 2, 9, 9, d, dtype)
    out = attn.dot_product_attention(q, k, v, causal=True)
    assert calls == [route]
    assert out.shape == q.shape and out.dtype == dtype
    want = attn._fwd_reference(q, k, v, causal=True)[0]
    torch.testing.assert_close(out.float(), want, atol=1e-2, rtol=1e-2)


def test_explicit_flash_keeps_the_kernels_head_dims(monkeypatch):
    """Only "auto" pads: impl="flash" hands the head dim on as it is
    (the CUDA wrappers refuse it, tests/test_torch_cuda.py)."""
    calls = _spy(monkeypatch)
    q, k, v, _ = _inputs(0, 1, 2, 9, 9, 48)
    attn.dot_product_attention(q, k, v, impl="flash")
    attn.dot_product_attention(q, k, v, impl="plain")
    assert calls == [("flash", 48), ("flash", 48)]
