"""Linear-chain CRF and CTC (``paddle_tpu/ops/crf.py``): the structured
prediction tail of the op library.

- ``linear_chain_crf`` (``linear_chain_crf_op``): the forward algorithm's
  negative log-likelihood; autograd differentiates the log-partition
  loop (the reference differentiates its scan the same way).
- ``crf_decoding`` (``crf_decoding_op``): Viterbi.
- ``warpctc`` (:func:`ctc_loss`): optax's ``ctc_loss``, the reference's
  implementation, step for step (not ``F.ctc_loss``: that takes
  ``(T, B, C)`` log-probabilities and treats infeasible alignments its
  own way).
- ``ctc_greedy_decoder`` and ``edit_distance``.

Batches are padded ``(B, T, N)`` rows with ``(B,)`` lengths (the LoD
analog); every loop runs over time on the whole batch, masked past each
row's length. Index outputs are int64 (the reference's int32 without
x64); the values are the same.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op

__all__ = ["linear_chain_crf", "crf_decoding", "ctc_loss",
           "ctc_greedy_decoder", "edit_distance"]


def _boundaries(emission, length, start, stop):
    """``start`` added at step 0, ``stop`` at each row's step
    ``max(length - 1, 0)`` (the reference packs both as the extra rows of
    its (N+2, N) transition)."""
    if start is not None:
        emission = torch.cat([emission[:, :1] + start, emission[:, 1:]], 1)
    if stop is not None:
        last = torch.clamp(length - 1, min=0)
        at = torch.arange(emission.shape[1], device=emission.device)[
            None, :] == last[:, None]
        emission = emission + at[..., None].to(emission.dtype) * stop
    return emission


@register_op("linear_chain_crf")
def linear_chain_crf(emission, label, length, transition, *, start=None,
                     stop=None):
    """Per-sequence negative log-likelihood. ``emission`` (B, T, N),
    ``label`` (B, T) gold tags, ``length`` (B,), ``transition`` (N, N)
    [from, to], optional ``start``/``stop`` (N,). A row of length 0
    scores ``logsumexp(emission[0])`` against a gold score of 0, as the
    reference's."""
    emission = _boundaries(emission, length, start, stop)
    t_len = emission.shape[1]
    alpha = emission[:, 0]
    for t in range(1, t_len):
        nxt = torch.logsumexp(alpha[:, :, None] + transition, dim=1) \
            + emission[:, t]
        alpha = torch.where((length > t)[:, None], nxt, alpha)
    log_z = torch.logsumexp(alpha, dim=-1)
    idx = torch.arange(t_len, device=emission.device)[None, :]
    lab = label.long()
    emit = torch.gather(emission, 2, lab[..., None])[..., 0]
    emit = torch.where(idx < length[:, None], emit,
                       torch.zeros_like(emit)).sum(1)
    trans = transition[lab[:, :-1], lab[:, 1:]]
    trans = torch.where(idx[:, 1:] < length[:, None], trans,
                        torch.zeros_like(trans)).sum(1)
    return log_z - (emit + trans)


@register_op("crf_decoding")
def crf_decoding(emission, transition, length, *, start=None, stop=None,
                 label=None):
    """Viterbi paths (B, T), 0 past each row's length; ties go to the
    lowest tag, as ``jnp.argmax``. Past the length the back pointers are
    the identity, so the best tag at a row's last step carries back. With
    ``label``, a (B, T) 0/1 mask instead: 1 where the path equals the
    label within the length (``crf_decoding_op.h:70,99``)."""
    emission = _boundaries(emission, length, start, stop)
    b, t_len, n = emission.shape
    ident = torch.arange(n, device=emission.device).expand(b, n)
    score = emission[:, 0]
    ptrs = []
    for t in range(1, t_len):
        cand = score[:, :, None] + transition              # (B, from, to)
        best, best_prev = cand.max(dim=1)
        keep = (length > t)[:, None]
        score = torch.where(keep, best + emission[:, t], score)
        ptrs.append(torch.where(keep, best_prev, ident))
    tag = torch.argmax(score, dim=-1)
    path = [None] * t_len
    path[t_len - 1] = tag
    for t in range(t_len - 2, -1, -1):
        tag = torch.gather(ptrs[t], 1, tag[:, None])[:, 0]
        path[t] = tag
    paths = torch.stack(path, dim=1)
    valid = torch.arange(t_len, device=emission.device)[None, :] \
        < length[:, None]
    paths = torch.where(valid, paths, torch.zeros_like(paths))
    if label is not None:
        return ((paths == label) & valid).to(torch.int32)
    return paths


@register_op("warpctc")
def ctc_loss(logits, logit_lengths, labels, label_lengths, *, blank=0):
    """Per-sequence CTC loss (B,) over unnormalised ``logits`` (B, T, V)
    and ``labels`` (B, L) padded on the right: optax's ``ctc_loss``
    (log-epsilon -1e5 for log 0), to which the reference hands off. A
    label that does not fit its frames gets optax's finite
    ~1e5-per-missing-step loss, not ``inf``."""
    log_eps = -1e5
    b, t_len, v = logits.shape
    n = labels.shape[1]
    dev = logits.device
    logprobs = torch.log_softmax(logits, dim=-1)
    logit_pad = (torch.arange(t_len, device=dev)[None, :]
                 >= logit_lengths[:, None]).to(logits.dtype)
    labellens = torch.clamp(label_lengths, max=n).long()
    lab = labels.long()
    repeat = (lab[:, :-1] == lab[:, 1:]).to(logits.dtype)
    repeat = torch.cat([repeat, repeat.new_zeros((b, 1))], 1)
    logprobs_phi = logprobs[:, :, blank:blank + 1]          # (B, T, 1)
    # one_hot(labels) contracted with logprobs: a gather that reads 0 for
    # an id outside [0, V)
    inside = (lab >= 0) & (lab < v)
    emit = torch.gather(logprobs, 2, torch.where(inside, lab, 0)[:, None, :]
                        .expand(b, t_len, n))
    emit = torch.where(inside[:, None, :], emit, torch.zeros_like(emit))
    phi = torch.full((b, n + 1), log_eps, dtype=logits.dtype, device=dev)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], 1)
    emit_a = torch.full((b, n), log_eps, dtype=logits.dtype, device=dev)

    def update(phi_, added):
        return torch.cat([phi_[:, :1],
                          torch.logaddexp(phi_[:, 1:], added)], -1)

    for t in range(t_len):
        prev_phi_orig = phi
        prev_phi = update(phi, emit_a + log_eps * repeat)
        lp_emit, lp_phi = emit[:, t], logprobs_phi[:, t]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit,
                                    emit_a + lp_emit)
        next_phi = prev_phi + lp_phi
        next_phi = update(next_phi, emit_a + lp_phi
                          + log_eps * (1.0 - repeat))
        pad = logit_pad[:, t:t + 1]
        emit_a = pad * emit_a + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    phi_last = update(phi, emit_a)
    return -torch.gather(phi_last, 1, labellens[:, None])[:, 0]


@register_op("ctc_greedy_decoder", has_grad=False)
def ctc_greedy_decoder(probs, lengths, *, blank=0):
    """Per-frame argmax, repeats merged, blanks dropped
    (``ctc_align_op``): ``(tokens (B, T) left-compacted in order and
    padded with ``blank``, out_lengths (B,))``."""
    b, t, _ = probs.shape
    ids = torch.argmax(probs, dim=-1)
    pos = torch.arange(t, device=probs.device)[None, :]
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], 1)
    keep = (ids != blank) & (ids != prev) & (pos < lengths[:, None])
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    kept = torch.gather(keep, 1, order)
    tokens = torch.where(kept, torch.gather(ids, 1, order),
                         torch.full_like(ids, blank))
    return tokens, keep.sum(-1)


@register_op("edit_distance", has_grad=False)
def edit_distance(hyp, hyp_lengths, ref, ref_lengths, *, normalized=True):
    """Levenshtein distance (B,) between padded int rows ``hyp`` (B, L1)
    and ``ref`` (B, L2) with lengths: the reference's DP over hypothesis
    tokens carrying one (L2 + 1) row, padding neutralised by clamping to
    the row lengths; divided by ``max(ref_length, 1)`` when
    ``normalized``."""
    b, l1 = hyp.shape
    l2 = ref.shape[1]
    dev = hyp.device
    r_len = ref_lengths.to(torch.float32)
    prev = torch.minimum(torch.arange(l2 + 1, dtype=torch.float32,
                                      device=dev)[None, :], r_len[:, None])
    for i in range(l1):
        tok = hyp[:, i]
        first = prev[:, 0] + 1.0
        diag, left = prev[:, 0], first
        cols = [first]
        for j in range(l2):
            up = prev[:, j + 1]
            sub = diag + (tok != ref[:, j]).to(torch.float32)
            best = torch.minimum(torch.minimum(up + 1, left + 1), sub)
            best = torch.where(ref_lengths > j, best, left)
            diag, left = up, best
            cols.append(best)
        cur = torch.stack(cols, dim=1)
        prev = torch.where((hyp_lengths > i)[:, None], cur, prev)
    d = torch.gather(prev, 1, torch.clamp(ref_lengths, max=l2).long()[:, None]
                     )[:, 0]
    if normalized:
        d = d / torch.clamp(ref_lengths, min=1)
    return d
