"""The fold orders of the ragged paged kernels, on the CPU.

``paged_decode_vec_kernel`` in ``paddle_tpu_torch/csrc/paged_attention.cu``
(K1 over fp pages, K2 over int8 pages) runs one block of 8 warps per
(slot, head) and splits the slot's live pages over those warps: warp w
takes the units w, w + 8, ... (a unit is a run of tokens of one page),
updates its online softmax once per unit, and the block merges the
warps' states in warp order. Over int8 pages each token's k_scale
multiplies its score after the scale, and its v_scale multiplies p after
l has taken it.

``paged_prefill_tc_kernel`` (bf16 q; K3 over bf16 pages, K4 over int8
pages) runs one block per (slot, head, tile of 64 query rows); a warp
owns 16 rows, and when the live rows fill fewer 16-row tiles than the
block has warps (8 over bf16 pages, 4 over int8 pages), the warps of a
row tile split each 64-token key tile between them (up to 4 warps of 16
tokens) and merge in warp order. Its
products take bf16 operands: q rounded to bf16, bf16 K and V as they
are, int8 K and V converted exactly, p rounded to bf16 (after v_scale
over int8 pages).

The CUDA kernels cannot run here, so this file emulates those orders in
fp32 torch and holds them against the JAX reference's lax fallbacks
(``ragged_paged_{decode,decode_int8,prefill,prefill_int8}_attention(
impl="lax")``): the decode folds at their kernel contracts (2e-5 fp,
5e-5 int8) on ragged lengths (0, one token, exactly one page, at a
partition edge, one token past it, the full width), the bf16 prefills
at the bf16 tolerance 1e-2 with rows past n_valid, an inactive slot, a
single row, a chunk ending at the last page and chunk starts that are
not page multiples.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import decode_attention as DA
from paddle_tpu_torch.ops.attention import NEG_INF

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
INT8_TOL = dict(atol=5e-5, rtol=5e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
#: warps per block of the decode kernel (kDecWarps)
WARPS = 8
#: the prefill kernel's warps per block over int8 (kInt8PreWarps) and bf16
#: (kFpPreWarps) pages, rows per warp, rows and tokens per tile
INT8_PRE_WARPS, FP_PRE_WARPS, WARP_ROWS, ROW_TILE, KEY_TILE = 4, 8, 16, 64, 64


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


def emulate_decode(q, kp, vp, bt, lengths, scale, unit, warps=WARPS,
                   scales=None):
    """The kernel's partition and fold order for one (slot, head) at a
    time; ``unit`` is its tokens per unit (16 for bf16 rows of 64 and
    int8 rows of 64, 8 for fp32 rows of 64). ``scales``: the int8 pool's
    ``(k_scales, v_scales)``."""
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
                    k = kp[page, t0:t0 + live, h].float()
                    v = vp[page, t0:t0 + live, h].float()
                    sc = (k @ q[s, h]) * scale
                    if scales is not None:          # (q.k * scale) * k_scale
                        sc = sc * scales[0][page, t0:t0 + live]
                    m_next = torch.maximum(m, sc.max())
                    alpha = torch.exp(m - m_next)
                    p = torch.exp(sc - m_next)
                    l = l * alpha + p.sum()
                    if scales is not None:          # after l: l never sees it
                        p = p * scales[1][page, t0:t0 + live]
                    acc = acc * alpha + p @ v
                    m = m_next
                states.append((m, l, acc))
            _, l, acc = _merge(states)
            out[s, h] = acc / l
    return out


def emulate_decode_int8(q, kq, vq, ks, vs, bt, lengths, scale, unit):
    """K2: K1's partition, fold and merge over int8 pages, with the
    scales fused into each unit's fold."""
    return emulate_decode(q, kq, vq, bt, lengths, scale, unit,
                          scales=(ks, vs))


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split(nrt, warps):
    """Warps per 16-row tile when ``nrt`` row tiles are live: as many as
    the block has per row tile, a power of two up to 4."""
    spl = 1
    while spl < 4 and 2 * spl * nrt <= warps:
        spl *= 2
    return spl


def _emulate_prefill_bf16(q, kp, vp, bt, starts, n_valid, scale, warps,
                          scales=None):
    """The tensor-core prefill's tiles, split and bf16 operands, in fp32
    elsewhere, over pages whose values bf16 holds exactly (bf16 pages, or
    int8 pages with ``scales`` = their ``(k_scales, v_scales)``); returns
    (S, C, H, Dh) fp32 (the kernel rounds it to bf16)."""
    n_slots, c, n_heads, dh = q.shape
    n_pages, ps = kp.shape[:2]
    cap = bt.shape[1] * ps
    qb = _bf16(q)
    out = torch.zeros_like(q)
    for s in range(n_slots):
        pages = bt[s].long().clamp(0, n_pages - 1)  # ids clamp
        kt = kp[pages].reshape(cap, n_heads, dh).float()
        vt = vp[pages].reshape(cap, n_heads, dh).float()
        if scales is None:
            kst = vst = torch.ones(cap)
        else:
            kst, vst = (x[pages].reshape(cap) for x in scales)
        for r0 in range(0, c, ROW_TILE):
            nl = min(max(int(n_valid[s]) - r0, 0), ROW_TILE, c - r0)
            lims = [min(int(starts[s]) + r0 + r + 1, cap) for r in range(nl)]
            if nl == 0 or lims[-1] <= 0:
                continue                            # exact zeros
            n_hi = lims[-1]
            nrt = -(-nl // WARP_ROWS)
            spl = _split(nrt, warps)                # warps per row tile
            part = KEY_TILE // spl                  # tokens a warp takes
            for rt in range(nrt):
                rows = range(rt * WARP_ROWS, min(rt * WARP_ROWS + WARP_ROWS,
                                                 nl))
                lim = torch.tensor([lims[r] for r in rows])
                for h in range(n_heads):
                    states = []
                    for ph in range(spl):
                        m = torch.full((len(rows),), NEG_INF)
                        l = torch.zeros(len(rows))
                        acc = torch.zeros(len(rows), dh)
                        for t0 in range(ph * part, n_hi, KEY_TILE):
                            t1 = min(t0 + part, n_hi)   # zero-filled past
                            tok = torch.arange(t0, t1)
                            sc = (qb[s, r0 + rows.start:r0 + rows.stop, h]
                                  @ kt[t0:t1, h].T) * scale
                            if scales is not None:  # (q.k * scale) * k_scale
                                sc = sc * kst[t0:t1]
                            ok = tok[None, :] < lim[:, None]
                            sc = torch.where(ok, sc, torch.tensor(NEG_INF))
                            m_next = torch.maximum(m, sc.max(dim=1).values)
                            alpha = torch.exp(m - m_next)
                            p = torch.where(ok, torch.exp(sc - m_next[:, None]),
                                            torch.tensor(0.0))
                            l = l * alpha + p.sum(dim=1)
                            if scales is not None:  # after l: l never sees it
                                p = p * vst[t0:t1]
                            acc = acc * alpha[:, None] + _bf16(p) @ vt[t0:t1, h]
                            m = m_next
                        states.append((m, l, acc))
                    m = torch.stack([st[0] for st in states]).amax(dim=0)
                    l, a = torch.zeros(len(rows)), torch.zeros(len(rows), dh)
                    for sm, sl, sa in states:       # in warp order
                        wt = torch.exp(sm - m)
                        l = l + sl * wt
                        a = a + sa * wt[:, None]
                    out[s, r0 + rows.start:r0 + rows.stop, h] = a / l[:, None]
    return out


def emulate_prefill_int8_bf16(q, kq, vq, ks, vs, bt, starts, n_valid,
                              scale):
    """K4: bf16 q over int8 pages (converted to bf16 exactly), the scales
    fused as in K2."""
    return _emulate_prefill_bf16(q, kq, vq, bt, starts, n_valid, scale,
                                 INT8_PRE_WARPS, scales=(ks, vs))


def emulate_prefill_bf16(q, kp, vp, bt, starts, n_valid, scale):
    """K3: bf16 q over bf16 pages, no scales."""
    return _emulate_prefill_bf16(q, _bf16(kp), _bf16(vp), bt, starts,
                                 n_valid, scale, FP_PRE_WARPS)


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


def _int8_pages(rng, n_pages, ps, h, dh):
    """int8 pages and positive fp32 scale rows, as quantize_kv lays them
    out."""
    kq, vq = (rng.integers(-127, 128, (n_pages, ps, h, dh)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.002, 0.03, (n_pages, ps)).astype(np.float32)
              for _ in range(2))
    return kq, vq, ks, vs


@pytest.mark.parametrize("ps,unit,dh,w", [
    pytest.param(16, 16, 64, 32, id="serving"),      # int8 rows of 64
    pytest.param(16, 32, 16, 24, id="16-32"),        # a unit past the page
    pytest.param(8, 16, 64, 24, id="8-16"),
    pytest.param(16, 8, 33, 24, id="33-8")])         # one-element rows
def test_int8_decode_fold_order_matches_the_reference_lax_fallback(ps, unit,
                                                                  dh, w):
    edge = WARPS * ps
    lengths = (0, 1, ps, edge - 1, edge, edge + 1, 2 * edge - 1, w * ps)
    q, _, _, bt, lens = _sample(ps + dh, len(lengths), 2, dh, ps, w,
                                lengths)
    rng = np.random.default_rng(dh)
    pages = _int8_pages(rng, 1 + len(lengths) * w, ps, 2, dh)
    args = (q, *pages, bt, lens)
    ref = np.asarray(DA.ragged_paged_decode_int8_attention(
        *map(jnp.asarray, args), impl="lax"))
    got = emulate_decode_int8(*map(torch.from_numpy, args), scale=dh ** -0.5,
                              unit=unit)
    assert torch.all(got[0] == 0)
    np.testing.assert_allclose(got.numpy(), ref, **INT8_TOL)


@pytest.mark.parametrize("c,dh", [(4, 64), (64, 64), (80, 48)],
                         ids=["verify", "prefill", "two-row-blocks"])
def test_int8_bf16_prefill_tiles_match_the_reference_lax_fallback(c, dh):
    n_slots, h, ps, w = 5, 2, 16, 12
    rng = np.random.default_rng(c + dh)
    q = rng.standard_normal((n_slots, c, h, dh)).astype(np.float32)
    q = _bf16(torch.from_numpy(q)).numpy()          # the kernel's bf16 q
    kq, vq, ks, vs = _int8_pages(rng, 1 + n_slots * w, ps, h, dh)
    bt = (1 + rng.permutation(n_slots * w)).reshape(n_slots, w).astype(
        np.int32)
    # starts that are not page multiples; a chunk ending at the last page
    starts = np.array([5, 3, w * ps - c, 17, 0], np.int32)
    # an inactive slot, rows past n_valid, a full chunk, one row
    n_valid = np.array([0, c - 3, c, 1, min(c, 20)], np.int32)
    args = (q, kq, vq, ks, vs, bt, starts, n_valid)
    ref = np.asarray(DA.ragged_paged_prefill_int8_attention(
        *map(jnp.asarray, args), impl="lax"))
    got = emulate_prefill_int8_bf16(*map(torch.from_numpy, args),
                                    scale=dh ** -0.5)
    assert torch.all(got[0] == 0)                    # inactive slot
    assert torch.all(got[1, c - 3:] == 0)            # rows past n_valid
    np.testing.assert_allclose(_bf16(got).numpy(), ref, **BF16_TOL)


@pytest.mark.parametrize("c,dh", [(4, 64), (64, 64), (80, 48)],
                         ids=["verify", "prefill", "two-row-blocks"])
def test_bf16_prefill_tiles_match_the_reference_lax_fallback(c, dh):
    n_slots, h, ps, w = 5, 2, 16, 12
    rng = np.random.default_rng(100 + c + dh)
    # q and pages as the kernel sees them: bf16 values
    q, kp, vp = (_bf16(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32))).numpy() for shape in ((n_slots, c, h, dh),
                                            (1 + n_slots * w, ps, h, dh),
                                            (1 + n_slots * w, ps, h, dh)))
    bt = (1 + rng.permutation(n_slots * w)).reshape(n_slots, w).astype(
        np.int32)
    # starts that are not page multiples; a chunk ending at the last page
    starts = np.array([5, 3, w * ps - c, 17, 0], np.int32)
    # an inactive slot, rows past n_valid, a full chunk, one row
    n_valid = np.array([0, c - 3, c, 1, min(c, 20)], np.int32)
    args = (q, kp, vp, bt, starts, n_valid)
    ref = np.asarray(DA.ragged_paged_prefill_attention(
        *map(jnp.asarray, args), impl="lax"))
    got = emulate_prefill_bf16(*map(torch.from_numpy, args),
                               scale=dh ** -0.5)
    assert torch.all(got[0] == 0)                    # inactive slot
    assert torch.all(got[1, c - 3:] == 0)            # rows past n_valid
    assert torch.all(got[3, 1:] == 0)                # one live row
    np.testing.assert_allclose(_bf16(got).numpy(), ref, **BF16_TOL)
