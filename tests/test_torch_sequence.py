"""The port's ``ops/sequence.py`` against the reference's on the CPU: every
op on the same numpy-seeded inputs, within 1e-6 (integer outputs
exactly), ragged lengths including 0 and the full width."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import sequence as J
from paddle_tpu_torch.ops import sequence as P

TOL = dict(rtol=1e-6, atol=1e-6)
B, T, D = 4, 7, 3


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((B, T, D)).astype(np.float32),
        x2=rng.standard_normal((B, T)).astype(np.float32),
        ids=rng.integers(0, 6, (B, T)).astype(np.int32),
        lengths=np.array([0, 3, T, 5], np.int32),
    )


def _same(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, **TOL)
    else:
        np.testing.assert_array_equal(g, w)


def _both(fn_name, *args, **kw):
    """Call the op of both packages on the same numpy arguments."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    pargs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
             for a in args]
    return getattr(P, fn_name)(*pargs, **kw), getattr(J, fn_name)(*jargs,
                                                                   **kw)


CASES = [
    ("sequence_mask", lambda d: (d["lengths"],), dict(maxlen=T)),
    ("sequence_mask", lambda d: (d["lengths"],), {}),
    *[("sequence_pool", lambda d: (d["x"], d["lengths"]),
       dict(pool_type=p))
      for p in ("sum", "average", "sqrt", "max", "last", "first")],
    ("sequence_softmax", lambda d: (d["x2"], d["lengths"]), {}),
    ("sequence_reverse", lambda d: (d["x"], d["lengths"]), {}),
    ("sequence_reverse", lambda d: (d["ids"], d["lengths"]), {}),
    ("sequence_expand", lambda d: (d["x"], 3), {}),
    ("sequence_conv", lambda d: (d["x"], d["lengths"], np.random.default_rng(
        9).standard_normal((3 * D, 5)).astype(np.float32)), {}),
    ("sequence_conv", lambda d: (d["x"], d["lengths"], np.random.default_rng(
        9).standard_normal((2 * D, 4)).astype(np.float32)),
     dict(context_start=0, padding_value=0.5)),
    ("sequence_slice", lambda d: (d["x"], d["lengths"],
                                  np.array([0, 1, 2, 4], np.int32),
                                  np.array([2, 5, 3, 1], np.int32)), {}),
    ("sequence_slice", lambda d: (d["ids"], d["lengths"],
                                  np.array([1, 0, 6, 2], np.int32),
                                  np.array([3, 3, 3, 9], np.int32)), {}),
    ("sequence_erase", lambda d: (d["ids"], d["lengths"], [1, 4]), {}),
    ("sequence_enumerate", lambda d: (d["ids"], d["lengths"], 3),
     dict(pad_value=-1)),
    ("sequence_concat", lambda d: (d["ids"], d["lengths"], d["ids"][:, :5],
                                   np.array([5, 0, 2, 4], np.int32)), {}),
    ("sequence_concat", lambda d: (d["x"], d["lengths"], d["x"][:, :4],
                                   np.array([1, 4, 0, 2], np.int32)),
     dict(pad_value=-2)),
    ("sequence_first_step", lambda d: (d["x"], d["lengths"]), {}),
    ("sequence_last_step", lambda d: (d["x"], d["lengths"]), {}),
    ("sequence_last_step", lambda d: (d["ids"], d["lengths"]), {}),
    ("sequence_expand_as", lambda d: (d["x"][:, 0], d["lengths"], 5), {}),
    ("sequence_reshape", lambda d: (d["x"][:, :6], np.array(
        [0, 2, 6, 4], np.int32), 2), {}),
    ("sequence_reshape", lambda d: (d["x"][:, :6], d["lengths"].clip(
        0, 6), 9), {}),
    ("sequence_scatter", lambda d: (d["x2"], np.array(
        [[0, 2], [1, 1], [6, 3], [5, 0]], np.int32), np.ones(
        (B, 2), np.float32) * 2, np.array([1, 2, 2, 0], np.int32)), {}),
    ("segment_sum", lambda d: (d["x2"], np.array([0, 2, 2, 1], np.int32),
                               4), {}),
    ("segment_max", lambda d: (d["x2"], np.array([0, 2, 2, 1], np.int32),
                               4), {}),
]


@pytest.mark.parametrize("name,make,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_op_matches_the_reference(name, make, kw):
    got, want = _both(name, *make(_inputs()), **kw)
    _same(got, want)


def test_pad_and_unpad_match_the_reference():
    rng = np.random.default_rng(1)
    rows = [rng.standard_normal((n, D)).astype(np.float32) for n in (2, 0, 5)]
    got, want = P.sequence_pad(rows, 4, -1.0), J.sequence_pad(rows, 4, -1.0)
    _same(got, want)
    back_p = P.sequence_unpad(*got)
    back_j = J.sequence_unpad(*want)
    _same(back_p, back_j)


@pytest.mark.parametrize("kv", [False, True])
def test_segment_attention_bias_matches_the_reference(kv):
    rng = np.random.default_rng(2)
    q = rng.integers(0, 4, (3, 9)).astype(np.int32)
    k = rng.integers(0, 4, (3, 5)).astype(np.int32) if kv else None
    got = P.make_segment_attention_bias(
        torch.from_numpy(q), None if k is None else torch.from_numpy(k))
    want = J.make_segment_attention_bias(
        jnp.asarray(q), None if k is None else jnp.asarray(k))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (3, 1, 9, 9 if k is None else 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rnn_surfaces_are_left_to_their_roadmap_item():
    for name in ("dynamic_lstm", "dynamic_gru", "lstm_unit", "gru_unit"):
        assert hasattr(J, name) and not hasattr(P, name)
    assert "ROADMAP Queue 1 item" in P.__doc__
