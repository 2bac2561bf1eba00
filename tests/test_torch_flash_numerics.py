"""The numerical contract of the bf16 tensor-core flash kernels, on the CPU.

The bf16 instances of K5 (forward), K6a (dk/dv) and K6b (dq) in
``paddle_tpu_torch/csrc/flash_attention.cu`` keep every product's
accumulation in fp32 but feed the second products bf16 operands: ``P``
before ``P V``, ``P^T`` before ``dV = P^T dO``, ``dS^T`` before
``dK = dS^T Q`` and ``dS`` before ``dQ = dS K``. The forward also runs
its online softmax over key tiles of 128 with ``exp2``. The CUDA kernels
cannot run here, so this file emulates that rounding in fp32 torch and
holds it against the JAX reference (``_lax_flash_fwd``,
``_lax_flash_block_bwd``, fp32 on the same bf16-representable inputs)
within the tolerances the card check uses: ``FWD.tolerance[bf16]`` for
``out``, ``BWD_DKV.tolerance[bf16]`` for ``dk``/``dv``,
``BWD_DQ.tolerance[bf16]`` for ``dq`` and the fp32 tolerance for ``lse``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jattn
from paddle_tpu_torch.ops import attention as FA

torch.set_num_threads(2)

KEY_TILE = 128          # the forward's key tile for head dims up to 64
LOG2E = 1.4426950408889634


def _bf16(x):
    """Round fp32 values to bf16, kept in fp32."""
    return x.to(torch.bfloat16).float()


def _scores(q, k, bias, scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    return s if bias is None else s + bias


def emulate_fwd(q, k, v, bias, scale):
    """K5's arithmetic: an online softmax over key tiles, P rounded to
    bf16 for P V, fp32 accumulation; out rounded to bf16, lse fp32."""
    b, h, sq, d = q.shape
    m = torch.full((b, h, sq), FA.NEG_INF)
    l = torch.zeros((b, h, sq))
    o = torch.zeros((b, h, sq, d))
    for k0 in range(0, k.shape[2], KEY_TILE):
        tile = slice(k0, k0 + KEY_TILE)
        x = _scores(q, k[:, :, tile], None if bias is None
                    else bias[..., tile], scale)
        m_next = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp2((m - m_next) * LOG2E)
        p = torch.exp2((x - m_next[..., None]) * LOG2E)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", _bf16(p), v[:, :, tile])
        m = m_next
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    alive = m > FA.NEG_INF / 2
    out = torch.where(alive[..., None], o / denom[..., None],
                      torch.zeros_like(o))
    return _bf16(out), m + torch.log(denom)


def emulate_dkv(q, k, v, bias, out, lse, do, scale):
    """K6a's arithmetic: P^T and dS^T rounded to bf16 as the A operands
    of dV and dK, fp32 accumulation; dk and dv rounded to bf16."""
    s = _scores(q, k, bias, scale)
    p = torch.exp2((s - lse[..., None]) * LOG2E)
    p = torch.where(lse[..., None] <= FA.NEG_INF / 2, torch.zeros_like(p), p)
    delta = (do * out).sum(dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", _bf16(ds), q)
    dv = torch.einsum("bhqk,bhqd->bhkd", _bf16(p), do)
    return _bf16(dk), _bf16(dv)


def emulate_dq(q, k, v, bias, out, lse, do, scale):
    """K6b's arithmetic: dS rounded to bf16 as the A operand of dQ = dS K,
    fp32 accumulation over all key tiles; dq rounded to bf16."""
    s = _scores(q, k, bias, scale)
    p = torch.exp2((s - lse[..., None]) * LOG2E)
    p = torch.where(lse[..., None] <= FA.NEG_INF / 2, torch.zeros_like(p), p)
    delta = (do * out).sum(dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    return _bf16(torch.einsum("bhqk,bhkd->bhqd", _bf16(ds), k))


def _reference(q, k, v, bias, do, scale):
    """The JAX reference's out, lse and (dq, dk, dv), as torch tensors."""
    jnp_bias = None if bias is None else jnp.asarray(bias.numpy())
    ref_out, ref_lse = jattn._lax_flash_fwd(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), jnp_bias,
        scale=scale, return_lse=True)
    grads = jattn._lax_flash_block_bwd(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), jnp_bias, ref_out,
        ref_lse, jnp.asarray(do.numpy()), scale=scale, causal=False)
    return tuple(torch.from_numpy(np.array(t))
                 for t in (ref_out, ref_lse, *grads))


def _inputs(seed, s, d, bias_mode):
    """(1, 2, s, d) q, k, v, do with bf16-representable values, and a key
    bias: None, ragged valid length, or length 0 (a fully masked row)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(torch.from_numpy(
        rng.standard_normal((1, 2, s, d)).astype(np.float32)))
        for _ in range(4))
    bias = None
    if bias_mode is not None:
        n = 0 if bias_mode == "masked" else int(rng.integers(s // 4, s))
        valid = np.arange(s)[None, :] < n
        bias = np.where(valid, 0.0, FA.NEG_INF).astype(
            np.float32)[:, None, None, :]
        bias = torch.from_numpy(bias)
    return q, k, v, bias, do


@pytest.mark.parametrize("bias_mode", [None, "key", "masked"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [64, 200, 512])
def test_bf16_operand_rounding_stays_within_the_card_tolerances(s, d,
                                                                bias_mode):
    q, k, v, bias, do = _inputs(s * 7 + d, s, d, bias_mode)
    scale = 1.0 / math.sqrt(d)
    jnp_bias = None if bias is None else jnp.asarray(bias.numpy())
    ref_out, ref_lse = jattn._lax_flash_fwd(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), jnp_bias,
        scale=scale, return_lse=True)
    ref_out = torch.from_numpy(np.array(ref_out))
    ref_lse = torch.from_numpy(np.array(ref_lse))

    out, lse = emulate_fwd(q, k, v, bias, scale)
    atol, rtol = FA.FWD.tolerance[torch.bfloat16]
    torch.testing.assert_close(out, ref_out, atol=atol, rtol=rtol)
    alive = ref_lse > FA.NEG_INF / 2
    atol, rtol = FA.FWD.tolerance[torch.float32]
    torch.testing.assert_close(lse[alive], ref_lse[alive], atol=atol,
                               rtol=rtol)
    assert torch.all(lse[~alive] <= FA.NEG_INF / 2)
    assert torch.all(out[~alive] == 0)
    if bias_mode == "masked":
        assert not alive.any()

    _, ref_dk, ref_dv = jattn._lax_flash_block_bwd(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), jnp_bias,
        jnp.asarray(ref_out.numpy()), jnp.asarray(ref_lse.numpy()),
        jnp.asarray(do.numpy()), scale=scale, causal=False)
    dk, dv = emulate_dkv(q, k, v, bias, ref_out, ref_lse, do, scale)
    atol, rtol = FA.BWD_DKV.tolerance[torch.bfloat16]
    torch.testing.assert_close(dk, torch.from_numpy(np.array(ref_dk)),
                               atol=atol, rtol=rtol)
    torch.testing.assert_close(dv, torch.from_numpy(np.array(ref_dv)),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("bias_mode", [None, "key", "masked"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [64, 200, 512])
def test_dq_bf16_operand_rounding_stays_within_the_card_tolerance(s, d,
                                                                  bias_mode):
    q, k, v, bias, do = _inputs(s * 7 + d, s, d, bias_mode)
    scale = 1.0 / math.sqrt(d)
    ref_out, ref_lse, ref_dq, _, _ = _reference(q, k, v, bias, do, scale)
    dq = emulate_dq(q, k, v, bias, ref_out, ref_lse, do, scale)
    atol, rtol = FA.BWD_DQ.tolerance[torch.bfloat16]
    torch.testing.assert_close(dq, ref_dq, atol=atol, rtol=rtol)
    if bias_mode == "masked":                  # every row fully masked
        assert torch.all(dq == 0)
