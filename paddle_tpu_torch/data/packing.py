"""Sequence packing: variable-length training with a bounded shape set
(``paddle_tpu/data/packing.py``, this package's own copy).

Reference mapping: fluid's LoD tensors make every batch a ragged
concatenation with per-row offsets (``framework/lod_tensor.h:104``), and
the sequence_ops family computes directly on that layout. A captured CUDA
graph (and the reference's jit) wants STATIC shapes, so the ragged story
is: pack many short sequences into fixed (rows, seq_len) slabs with
SEGMENT IDS (0 = padding, 1..k = packed sequences), attend within segments
only (:func:`paddle_tpu_torch.ops.sequence.make_segment_attention_bias`),
and embed with per-segment POSITIONS. Shapes come from a small bucket
ladder, so the train step captures O(#buckets) graphs no matter how
ragged the data (Transformer-big's variable-length WMT training).

Host-side (numpy): this runs in the input pipeline, composing with the
native MultiSlot feed's ragged slots (:mod:`.native_feed`). The same
inputs give the reference's arrays element for element.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024)


def bucket_len(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (the shape ladder)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"sequence length {n} exceeds largest bucket "
                     f"{buckets[-1]}")


class _Row:
    """One output row being filled (first-fit bin)."""

    __slots__ = ("used_a", "used_b", "items")

    def __init__(self):
        self.used_a = 0
        self.used_b = 0
        self.items: List[int] = []


def _first_fit(lens_a, lens_b, cap_a, cap_b, max_segments):
    """First-fit-decreasing over (a, b) capacity pairs; returns rows of
    example indices."""
    order = sorted(range(len(lens_a)),
                   key=lambda i: -(lens_a[i] + lens_b[i]))
    rows: List[_Row] = []
    for i in order:
        la, lb = lens_a[i], lens_b[i]
        placed = False
        for r in rows:
            if (r.used_a + la <= cap_a and r.used_b + lb <= cap_b
                    and len(r.items) < max_segments):
                r.items.append(i)
                r.used_a += la
                r.used_b += lb
                placed = True
                break
        if not placed:
            r = _Row()
            r.items.append(i)
            r.used_a, r.used_b = la, lb
            rows.append(r)
    return rows


def pack_examples(seqs: Sequence[np.ndarray], seq_len: int, *,
                  max_segments: int = 0, pad_value: int = 0
                  ) -> Dict[str, np.ndarray]:
    """Pack 1-D token sequences into (rows, seq_len) with segment ids and
    per-segment positions. Single-stream (LM / encoder-only) variant.

    Returns {"tokens", "segment_ids", "positions"}; segment id 0 marks
    padding, positions restart at 0 per segment.
    """
    seqs = [np.asarray(s) for s in seqs]
    lens = [len(s) for s in seqs]
    if any(n > seq_len for n in lens):
        raise ValueError("a sequence exceeds seq_len; bucket first")
    max_segments = max_segments or seq_len
    rows = _first_fit(lens, [0] * len(seqs), seq_len, 0, max_segments)

    out_tok = np.full((len(rows), seq_len), pad_value,
                      dtype=seqs[0].dtype)
    out_seg = np.zeros((len(rows), seq_len), np.int32)
    out_pos = np.zeros((len(rows), seq_len), np.int32)
    for ri, r in enumerate(rows):
        off = 0
        for si, idx in enumerate(r.items):
            s = seqs[idx]
            out_tok[ri, off:off + len(s)] = s
            out_seg[ri, off:off + len(s)] = si + 1
            out_pos[ri, off:off + len(s)] = np.arange(len(s))
            off += len(s)
    return {"tokens": out_tok, "segment_ids": out_seg,
            "positions": out_pos}


def pack_pairs(src: Sequence[np.ndarray], tgt: Sequence[np.ndarray],
               src_len: int, tgt_len: int, *, max_segments: int = 0,
               pad_value: int = 0,
               tgt_extras: Optional[Dict[str, Sequence[np.ndarray]]] = None
               ) -> Dict[str, np.ndarray]:
    """Pack aligned (src, tgt) pairs for seq2seq training.

    A pair occupies the SAME segment number in its source row and target
    row, so the decoder's cross-attention segment test (tgt_seg[q] ==
    src_seg[k]) pairs each target with exactly its own source. Returns
    {"src", "src_seg", "src_pos", "tgt", "tgt_seg", "tgt_pos"}.

    ``tgt_extras``: additional target-aligned streams (e.g. shifted
    labels ``tgt_out`` alongside decoder inputs) — each sequence must
    have the same length as its tgt and is packed into the identical row
    placement, appearing under its own key.
    """
    src = [np.asarray(s) for s in src]
    tgt = [np.asarray(t) for t in tgt]
    if len(src) != len(tgt):
        raise ValueError("src/tgt count mismatch")
    tgt_extras = tgt_extras or {}
    ls = [len(s) for s in src]
    lt = [len(t) for t in tgt]
    for name, seqs in tgt_extras.items():
        if [len(np.asarray(e)) for e in seqs] != lt:
            raise ValueError(f"tgt_extras[{name!r}] lengths differ from tgt")
    if any(n > src_len for n in ls) or any(n > tgt_len for n in lt):
        raise ValueError("a sequence exceeds its capacity; bucket first")
    max_segments = max_segments or (src_len + tgt_len)
    rows = _first_fit(ls, lt, src_len, tgt_len, max_segments)

    n = len(rows)
    out = {
        "src": np.full((n, src_len), pad_value, src[0].dtype),
        "src_seg": np.zeros((n, src_len), np.int32),
        "src_pos": np.zeros((n, src_len), np.int32),
        "tgt": np.full((n, tgt_len), pad_value, tgt[0].dtype),
        "tgt_seg": np.zeros((n, tgt_len), np.int32),
        "tgt_pos": np.zeros((n, tgt_len), np.int32),
    }
    for name in tgt_extras:
        out[name] = np.full((n, tgt_len), pad_value,
                            np.asarray(tgt_extras[name][0]).dtype)
    for ri, r in enumerate(rows):
        so = to = 0
        for si, idx in enumerate(r.items):
            s, t = src[idx], tgt[idx]
            out["src"][ri, so:so + len(s)] = s
            out["src_seg"][ri, so:so + len(s)] = si + 1
            out["src_pos"][ri, so:so + len(s)] = np.arange(len(s))
            so += len(s)
            out["tgt"][ri, to:to + len(t)] = t
            out["tgt_seg"][ri, to:to + len(t)] = si + 1
            out["tgt_pos"][ri, to:to + len(t)] = np.arange(len(t))
            for name, seqs in tgt_extras.items():
                e = np.asarray(seqs[idx])
                out[name][ri, to:to + len(e)] = e
            to += len(t)
    return out


def packed_batches(src: Sequence[np.ndarray], tgt: Sequence[np.ndarray],
                   *, rows_per_batch: int, src_len: int, tgt_len: int,
                   pad_rows: bool = True, max_segments: int = 0,
                   tgt_extras: Optional[Dict[str, Sequence[np.ndarray]]]
                   = None) -> Iterator[Dict[str, np.ndarray]]:
    """Pack a whole epoch and yield fixed-shape (rows_per_batch, *) batches
    — the ONE static shape for this bucket config. The final partial
    batch is padded with empty rows (segment 0 everywhere) when
    ``pad_rows``; dropped otherwise."""
    packed = pack_pairs(src, tgt, src_len, tgt_len,
                        max_segments=max_segments, tgt_extras=tgt_extras)
    n = packed["src"].shape[0]
    for lo in range(0, n, rows_per_batch):
        hi = min(n, lo + rows_per_batch)
        batch = {k: v[lo:hi] for k, v in packed.items()}
        if hi - lo < rows_per_batch:
            if not pad_rows:
                return
            pad = rows_per_batch - (hi - lo)
            batch = {k: np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                for k, v in batch.items()}
        yield batch


def packing_efficiency(seg: np.ndarray) -> float:
    """Fraction of slots holding real tokens (padding waste diagnostic)."""
    return float((seg > 0).mean())
