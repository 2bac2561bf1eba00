"""The port's flash attention against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(``flash_attention(..., block_q=32, block_k=32, interpret=True)``) and
its ``custom_vjp`` through ``jax.vjp``; the port runs its plain versions
(CPU tensors) forward and through its ``torch.autograd.Function``.
Inputs are made with numpy from seeds. Tolerance, fp32: forward 2e-5
(the reference kernel contract, ``ops/attention.py:761``), gradients
5e-5 (sums over up to Sq or Sk fp32 products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jattn
from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.ops import attention as attn

torch.set_num_threads(2)

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)


def _inputs(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    shapes = [(b, h, sq, d), (b, h, sk, d), (b, h, sk, d), (b, h, sq, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _key_bias(lengths, sk):
    valid = np.arange(sk)[None, :] < np.asarray(lengths)[:, None]
    return np.where(valid, 0.0, jattn.NEG_INF).astype(
        np.float32)[:, None, None, :]


def _jax_flash(q, k, v, bias, causal, do):
    def f(q, k, v, *b):
        return jattn.flash_attention(q, k, v, b[0] if b else None, causal,
                                     None, 32, 32, True)
    args = [jnp.asarray(x) for x in (q, k, v)]
    if bias is not None:
        args.append(jnp.asarray(bias))
    out, vjp = jax.vjp(f, *args)
    _, lse = jattn._flash_fwd(*[jnp.asarray(x) for x in (q, k, v)],
                              None if bias is None else jnp.asarray(bias),
                              scale=1.0 / np.sqrt(q.shape[-1]),
                              causal=causal, block_q=32, block_k=32,
                              interpret=True, return_lse=True)
    return np.asarray(out), np.asarray(lse), [np.asarray(g)
                                              for g in vjp(jnp.asarray(do))]


def _port_flash(q, k, v, bias, causal, do, bias_grad=False):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tb = None
    if bias is not None:
        tb = torch.tensor(bias, requires_grad=bias_grad)
    out = attn.flash_attention(tq, tk, tv, tb, causal)
    out.backward(torch.tensor(do))
    _, lse = attn.flash_fwd_plain(*(torch.tensor(x) for x in (q, k, v)),
                                  None if bias is None else torch.tensor(bias),
                                  causal=causal)
    grads = [tq.grad, tk.grad, tv.grad] + ([tb.grad] if bias_grad else [])
    return out.detach().numpy(), lse.numpy(), [g.numpy() for g in grads]


CASES = {
    # causal, S = 80 over 32-wide JAX blocks: ragged last tiles
    "causal_ragged": dict(shape=(1, 2, 80, 80, 32), causal=True, bias=None),
    # causal with Sq < Sk: the bottom-right aligned diagonal
    "causal_sq_lt_sk": dict(shape=(1, 2, 48, 80, 32), causal=True,
                            bias=None),
    # key-padding bias, the second sequence fully masked
    "key_bias_dead_row": dict(shape=(2, 2, 40, 40, 32), causal=False,
                              bias="key"),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_flash_forward_and_grads_match_reference(case):
    spec = CASES[case]
    b, h, sq, sk, d = spec["shape"]
    q, k, v, do = _inputs(sum(spec["shape"]), b, h, sq, sk, d)
    bias = _key_bias([29, 0], sk) if spec["bias"] == "key" else None
    j_out, j_lse, j_grads = _jax_flash(q, k, v, bias, spec["causal"], do)
    out, lse, grads = _port_flash(q, k, v, bias, spec["causal"], do)
    np.testing.assert_allclose(out, j_out, **FWD_TOL)
    alive = j_lse > jattn.NEG_INF / 2
    np.testing.assert_allclose(lse[alive], j_lse[alive], **FWD_TOL)
    assert np.all(lse[~alive] <= jattn.NEG_INF / 2)
    for got, want, name in zip(grads, j_grads, "qkv"):
        np.testing.assert_allclose(got, want, err_msg=f"d{name}", **GRAD_TOL)
    if spec["bias"] == "key":
        # the fully-masked sequence: output 0, lse ~ NEG_INF, grads 0
        assert np.all(out[1] == 0.0)
        assert np.all(lse[1] <= jattn.NEG_INF / 2)
        for g in grads:
            assert np.all(g[1] == 0.0)


def test_full_bias_gradient_takes_the_recompute_path():
    b, h, s, d = 1, 2, 24, 32
    q, k, v, do = _inputs(5, b, h, s, s, d)
    bias = np.random.default_rng(6).standard_normal(
        (1, h, s, s)).astype(np.float32)
    j_out, _, j_grads = _jax_flash(q, k, v, bias, False, do)
    out, _, grads = _port_flash(q, k, v, bias, False, do, bias_grad=True)
    np.testing.assert_allclose(out, j_out, **FWD_TOL)
    assert grads[3].shape == bias.shape
    assert np.abs(grads[3]).max() > 0
    for got, want, name in zip(grads, j_grads, ["dq", "dk", "dv", "dbias"]):
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)


def test_key_bias_cotangent_is_zero_and_composed_path_agrees():
    q, k, v, do = _inputs(9, 2, 2, 33, 33, 32)
    bias = torch.tensor(_key_bias([33, 7], 33), requires_grad=True)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = attn.flash_attention(tq, tk, tv, bias, False)
    out.backward(torch.tensor(do))
    assert torch.all(bias.grad == 0)
    ref = attn.scaled_dot_product_attention(
        *(torch.tensor(x) for x in (q, k, v)), bias=bias.detach())
    torch.testing.assert_close(out.detach(), ref, **FWD_TOL)


def test_plain_bwd_matches_dense_autograd_with_delta():
    q, k, v, do = (torch.tensor(x) for x in _inputs(3, 1, 3, 17, 40, 32))
    out, lse = attn.flash_fwd_plain(q, k, v, causal=True)
    dq, dk, dv = attn.flash_bwd_plain(q, k, v, None, out, lse, do,
                                      causal=True)
    ref = attn._bwd_reference(q, k, v, None, do, causal=True, scale=None)
    for got, want in zip((dq, dk, dv), ref):
        torch.testing.assert_close(got, want, **GRAD_TOL)


def test_dot_product_attention_dispatch():
    q, k, v, _ = (torch.tensor(x) for x in _inputs(4, 1, 2, 16, 16, 32))
    flash = attn.dot_product_attention(q, k, v, causal=True)
    plain = attn.dot_product_attention(q, k, v, causal=True, impl="plain")
    xla = attn.dot_product_attention(q, k, v, causal=True, impl="xla")
    torch.testing.assert_close(flash, plain, atol=0, rtol=0)
    torch.testing.assert_close(flash, xla, **FWD_TOL)
    gen = torch.Generator().manual_seed(0)
    dropped = attn.dot_product_attention(q, k, v, dropout_rate=0.5,
                                         generator=gen)
    assert not torch.allclose(dropped, xla)
    with pytest.raises(ValueError, match="impl"):
        attn.dot_product_attention(q, k, v, impl="pallas")


def test_make_padding_bias_matches_reference():
    mask = np.array([[1, 1, 0, 0], [1, 1, 1, 1]], bool)
    ref = np.asarray(jattn.make_padding_bias(jnp.asarray(mask)))
    got = attn.make_padding_bias(torch.from_numpy(mask))
    assert got.shape == (2, 1, 1, 4) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_registry_entries_and_work():
    names = registry.load_all()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert name in names
        entry = registry.get(name)
        assert entry.route == "cuda"
        assert entry.source == "paddle_tpu_torch/csrc/flash_attention.cu"
    q = torch.zeros((48, 12, 512, 64), dtype=torch.bfloat16, device="meta")
    lse = torch.zeros((48, 12, 512), device="meta")
    nbytes, flops = attn.fwd_work(q, q, q)
    assert flops == 4 * 48 * 12 * 512 * 512 * 64
    assert nbytes == 4 * q.numel() * 2 + 4 * lse.numel()
    _, cflops = attn.fwd_work(q, q, q, causal=True)
    assert cflops == 4 * 48 * 12 * 64 * (512 * 513 // 2)
    kbias = torch.zeros((48, 1, 1, 512), device="meta")
    nb, fl = attn.dkv_work(q, q, q, kbias, q, lse, lse)
    assert fl == 2 * flops
    assert nb == 6 * q.numel() * 2 + 2 * 4 * lse.numel() + 4 * 48 * 512
    _, fl = attn.dq_work(q, q, q, None, q, lse, lse)
    assert fl == 6 * 48 * 12 * 512 * 512 * 64


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 1, 8, 32))
    with pytest.raises(ValueError, match="CUDA"):
        attn.flash_fwd_cuda(q, q, q)
    lse = torch.zeros((1, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        attn.flash_bwd_dkv_cuda(q, q, q, None, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        attn.flash_bwd_dq_cuda(q, q, q, None, q, lse, lse)
