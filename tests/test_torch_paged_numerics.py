"""The fold order of the fp ragged paged decode kernel (K1), on the CPU.

``paged_decode_fp_kernel`` in ``paddle_tpu_torch/csrc/paged_attention.cu``
runs one block of 8 warps per (slot, head) and splits the slot's live
pages over those warps: warp w takes the units w, w + 8, ... (a unit is
a run of tokens of one page), updates its online softmax once per unit,
and the block merges the warps' states in warp order. The CUDA kernel
cannot run here, so this file emulates that order in fp32 torch and
holds it against the JAX reference's lax fallback
(``ragged_paged_decode_attention(impl="lax")``) at the kernel contract's
2e-5, on ragged lengths: 0, one token, exactly one page, exactly at a
partition edge (a page per warp), one token past it, and the full width.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import decode_attention as DA
from paddle_tpu_torch.ops.attention import NEG_INF

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
#: warps per block of the kernel (kDecWarps)
WARPS = 8


def _merge(states):
    """Merge (m, l, acc) states in the given order; a state that folded
    nothing (m = NEG_INF, l = 0) weighs exactly 0."""
    m = max(st[0] for st in states)
    l, acc = torch.tensor(0.0), torch.zeros_like(states[0][2])
    for sm, sl, sa in states:
        wt = torch.exp(sm - m)
        l = l + sl * wt
        acc = acc + sa * wt
    return m, l, acc


def emulate_decode(q, kp, vp, bt, lengths, scale, unit, warps=WARPS):
    """The kernel's partition and fold order for one (slot, head) at a
    time; ``unit`` is its tokens per unit (16 for bf16 rows of 64, 8 for
    fp32 rows of 64)."""
    n_slots, n_heads, dh = q.shape
    ps, w, n_pages = kp.shape[1], bt.shape[1], kp.shape[0]
    out = torch.zeros_like(q)
    cpp = -(-ps // unit)                            # units per page
    for s in range(n_slots):
        n_tok = min(max(int(lengths[s]), 0), w * ps)
        if n_tok == 0:
            continue                                # exact zeros
        n_cols = -(-n_tok // ps)                    # live pages
        for h in range(n_heads):
            states = []
            for wp in range(warps):
                m = torch.tensor(NEG_INF)
                l, acc = torch.tensor(0.0), torch.zeros(dh)
                for u in range(wp, n_cols * cpp, warps):
                    col, t0 = u // cpp, (u % cpp) * unit
                    live = min(unit, min(ps, n_tok - col * ps) - t0)
                    if live <= 0:
                        continue                    # a unit past the tail
                    page = min(max(int(bt[s, col]), 0), n_pages - 1)
                    k = kp[page, t0:t0 + live, h]
                    v = vp[page, t0:t0 + live, h]
                    sc = (k @ q[s, h]) * scale
                    m_next = torch.maximum(m, sc.max())
                    alpha = torch.exp(m - m_next)
                    p = torch.exp(sc - m_next)
                    l = l * alpha + p.sum()
                    acc = acc * alpha + p @ v
                    m = m_next
                states.append((m, l, acc))
            _, l, acc = _merge(states)
            out[s, h] = acc / l
    return out


def _sample(seed, n_slots, h, dh, ps, w, lengths):
    rng = np.random.default_rng(seed)
    n_pages = 1 + n_slots * w
    q = rng.standard_normal((n_slots, h, dh)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, h, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, h, dh)).astype(np.float32)
    bt = (1 + rng.permutation(n_slots * w)).reshape(n_slots, w).astype(
        np.int32)
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("ps,unit,dh,w", [
    *(pytest.param(ps, unit, 16, 24, id=f"{ps}-{unit}")
      for ps, unit in ((16, 16), (16, 8), (4, 4), (8, 32))),
    # the serving cell's page, head size and block-table width (unit 16
    # for bf16 rows of 64, 8 for fp32)
    (16, 16, 64, 32), (16, 8, 64, 32)])
def test_split_fold_order_matches_the_reference_lax_fallback(ps, unit, dh, w):
    edge = WARPS * ps                               # one page per warp
    lengths = (0, 1, ps, edge - 1, edge, edge + 1, 2 * edge - 1, w * ps)
    args = _sample(ps + unit + dh, len(lengths), 2, dh, ps, w, lengths)
    ref = np.asarray(DA.ragged_paged_decode_attention(
        *map(jnp.asarray, args), impl="lax"))
    got = emulate_decode(*map(torch.from_numpy, args), scale=dh ** -0.5,
                         unit=unit)
    assert torch.all(got[0] == 0)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
