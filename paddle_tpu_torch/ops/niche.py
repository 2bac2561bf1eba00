"""The reference's eight niche ops (``paddle_tpu/ops/niche.py``):
``modified_huber_loss``, ``unpool``, ``spp``, ``conv_shift``,
``tree_conv``, ``var_conv_2d``, ``sample_logits`` and
``sequence_topk_avg_pooling``, static-shape (padded and masked where the
reference uses LoD). ``tree_conv`` builds its patch weights on the host
(a data-dependent walk of the tree, :func:`_tree_patch_weights`, a copy
of the reference's); its contraction runs on the tensors' device and is
differentiable. ``sample_logits`` draws from a ``torch.Generator`` where
the reference takes a key.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op

__all__ = ["modified_huber_loss", "unpool", "spp", "conv_shift",
           "tree_conv", "var_conv_2d", "sample_logits",
           "sequence_topk_avg_pooling"]


@register_op("modified_huber_loss",
             reference=lambda x, y: np.where(
                 x * (2 * y - 1) < -1, -4 * x * (2 * y - 1),
                 np.where(x * (2 * y - 1) < 1,
                          (1 - x * (2 * y - 1)) ** 2, 0.0)))
def modified_huber_loss(x, y):
    """With ``a = x * (2y - 1)``: ``-4a`` if ``a < -1``, ``(1 - a)^2`` if
    ``a < 1``, else 0 (``modified_huber_loss_op.h:41``)."""
    a = x * (2.0 * y - 1.0)
    return torch.where(a < -1.0, -4.0 * a,
                       torch.where(a < 1.0, (1.0 - a) ** 2,
                                   torch.zeros_like(a)))


@register_op("unpool")
def unpool(x, indices, output_size):
    """Max-unpooling: each value of ``x`` (N, C, h, w) goes to its flat
    position ``indices`` in the (H, W) = ``output_size`` plane; the rest
    stay 0. Positions within a plane are distinct, as max-pooling's
    argmaxes are (a duplicate's winner is unspecified here as in the
    reference's scatter)."""
    n, c, h, w = x.shape
    oh, ow = output_size
    out = torch.zeros((n, c, oh * ow), dtype=x.dtype, device=x.device)
    out = out.scatter(2, indices.reshape(n, c, h * w).long(),
                      x.reshape(n, c, h * w))
    return out.reshape(n, c, oh, ow)


def _pool_level(x, ksize, stride, pad, pooling_type):
    """One pyramid level over NCHW: max, or the average over the cells of
    the window inside the image."""
    kh, kw = ksize
    ph, pw = pad
    if pooling_type == "max":
        xp = F.pad(x, (pw, pw, ph, ph), value=-math.inf)
        return F.max_pool2d(xp, (kh, kw), stride)
    s = F.avg_pool2d(F.pad(x, (pw, pw, ph, ph)), (kh, kw), stride) * (kh * kw)
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                            device=x.device), (pw, pw, ph, ph))
    cnt = F.avg_pool2d(ones, (kh, kw), stride) * (kh * kw)
    return s / cnt


@register_op("spp")
def spp(x, pyramid_height, pooling_type="max"):
    """Spatial pyramid pooling (``spp_op.h:28``): level p pools NCHW into
    2^p x 2^p bins, kernel ceil(dim / bins), padding (kernel * bins - dim
    + 1) // 2, stride the kernel; levels flattened and concatenated ->
    (N, C * sum_p 4^p)."""
    n, c, h, w = x.shape
    outs = []
    for p in range(pyramid_height):
        bins = 2 ** p
        kh, kw = math.ceil(h / bins), math.ceil(w / bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        lvl = _pool_level(x, (kh, kw), (kh, kw), (ph, pw), pooling_type)
        outs.append(lvl.reshape(n, c * bins * bins))
    return torch.cat(outs, dim=1)


def _conv_shift_ref(x, y):
    b, m = x.shape
    _, n = y.shape
    half = (n - 1) // 2
    out = np.zeros_like(x)
    for i in range(m):
        for j in range(-half, half + 1):
            out[:, i] += x[:, (i + j) % m] * y[:, j + half]
    return out


@register_op("conv_shift", reference=_conv_shift_ref)
def conv_shift(x, y):
    """Circular correlation (NTM attention shift): ``out[i] = sum_j
    x[(i + j) mod M] * y[j + (N - 1) / 2]``; x (B, M), y (B, N), N odd and
    at most M."""
    m, n = x.shape[1], y.shape[1]
    if n % 2 != 1:
        raise ValueError(f"conv_shift filter width must be odd, got {n}")
    if n > m:
        raise ValueError(f"conv_shift filter width {n} exceeds data "
                         f"width {m}")
    half = (n - 1) // 2
    idx = (torch.arange(m, device=x.device)[None, :]
           + torch.arange(n, device=x.device)[:, None] - half) % m
    return torch.einsum("bnm,bn->bm", x[:, idx], y)


def _tree_patch_weights(edges, num_nodes, max_depth):
    """Host-side tree2col (``math/tree2col.cc:82``): a DFS patch per root
    with the continuous-binary-tree weights eta_l, eta_r, eta_t. Returns
    (N, N, 3) float32; row p holds the weights of root p + 1 (nodes are
    1-based, (0, 0) edge rows are padding)."""
    tr = [[] for _ in range(num_nodes + 1)]
    for a, b in np.asarray(edges).reshape(-1, 2):
        a, b = int(a), int(b)
        if a == 0 or b == 0:
            continue
        tr[a].append(b)

    weights = np.zeros((num_nodes, num_nodes, 3), np.float32)

    def eta(index, pclen, depth):
        eta_t = (max_depth - depth) / max_depth
        tmp = 0.5 if pclen == 1 else (index - 1.0) / (pclen - 1.0)
        eta_l = (1.0 - eta_t) * tmp
        eta_r = (1.0 - eta_t) * (1.0 - eta_l)
        return eta_l, eta_r, eta_t

    for root in range(1, num_nodes + 1):
        visited = {root}
        stack = [(root, 1, 1, 0)]
        patch = [(root, 1, 1, 0)]
        while stack:
            node, _, _, depth = stack[-1]
            advanced = False
            children = tr[node]
            for i, v in enumerate(children):
                if v not in visited and depth + 1 < max_depth:
                    visited.add(v)
                    stack.append((v, i, len(children), depth + 1))
                    patch.append((v, i + 1, len(children), depth + 1))
                    advanced = True
            if not advanced:
                stack.pop()
        for node, index, pclen, depth in patch:
            el, er, et = eta(index, pclen, depth)
            weights[root - 1, node - 1, 0] += el
            weights[root - 1, node - 1, 1] += er
            weights[root - 1, node - 1, 2] += et
    return weights


@register_op("tree_conv")
def tree_conv(nodes_vector, edge_set, filter, max_depth=2):
    """Tree-based convolution (``tree_conv_op.h:27``): ``nodes_vector``
    (B, N, F), ``edge_set`` (B, E, 2) 1-based, ``filter`` (F, 3, out,
    num_filters) -> (B, N, out, num_filters)."""
    b, n, _ = nodes_vector.shape
    edges = edge_set.detach().cpu().numpy() if isinstance(
        edge_set, torch.Tensor) else np.asarray(edge_set)
    ws = torch.from_numpy(np.stack([
        _tree_patch_weights(edges[i], n, max_depth) for i in range(b)])).to(
        nodes_vector.device, nodes_vector.dtype)
    patch = torch.einsum("bpvc,bvf->bpfc", ws, nodes_vector)
    return torch.einsum("bpfc,fcom->bpom", patch, filter)


@register_op("var_conv_2d")
def var_conv_2d(x, row_lens, col_lens, w, *, input_channel, output_channel,
                kernel_h=3, kernel_w=3, stride_h=1, stride_w=1):
    """Variable-size conv (``var_conv_2d_op.cc:121``) over a padded canvas
    ``x`` (B, C, Hmax, Wmax) with true sizes ``row_lens``/``col_lens``:
    kernel centres on a stride grid with half-kernel zero borders, out
    (B, OC, ceil(Hmax / sh), ceil(Wmax / sw)) masked to each sample's
    ceil(h / sh) x ceil(w / sw). ``w`` is (OC, C * kh * kw)."""
    _, c, hm, wm = x.shape
    if c != input_channel:
        raise ValueError(f"x has {c} channels, expected {input_channel}")
    half_h, half_w = kernel_h // 2, kernel_w // 2
    out_h = (hm - 1) // stride_h + 1
    out_w = (wm - 1) // stride_w + 1
    dev = x.device
    rmask = torch.arange(hm, device=dev)[None, :] < row_lens[:, None]
    cmask = torch.arange(wm, device=dev)[None, :] < col_lens[:, None]
    x = x * (rmask[:, None, :, None] & cmask[:, None, None, :]).to(x.dtype)
    pad_h_hi = max(0, (out_h - 1) * stride_h - half_h + kernel_h - hm)
    pad_w_hi = max(0, (out_w - 1) * stride_w - half_w + kernel_w - wm)
    kernel = w.reshape(output_channel, input_channel, kernel_h, kernel_w)
    out = F.conv2d(F.pad(x, (half_w, pad_w_hi, half_h, pad_h_hi)), kernel,
                   stride=(stride_h, stride_w))
    zero = torch.zeros_like(row_lens)
    to_h = torch.where(row_lens > 0, (row_lens - 1) // stride_h + 1, zero)
    to_w = torch.where(col_lens > 0, (col_lens - 1) // stride_w + 1, zero)
    omask = ((torch.arange(out_h, device=dev)[None, :] < to_h[:, None])
             [:, None, :, None]
             & (torch.arange(out_w, device=dev)[None, :] < to_w[:, None])
             [:, None, None, :])
    return out * omask.to(out.dtype)


def _tolerable(v):
    """The reference's TolerableValue: NaN -> 0, clamp to +-1e20."""
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    return torch.clamp(v, -1e20, 1e20)


@register_op("sample_logits", has_grad=False)
def sample_logits(logits, labels, num_samples, generator=None, *,
                  remove_accidental_hits=True, customized_samples=None,
                  customized_probabilities=None):
    """Sampled-softmax preparation (``sample_logits_op.h:148``):
    ``(samples (B, T+S), probabilities (B, T+S), sampled_logits (B, T+S),
    sampled_labels (B, T))``. Negatives follow the log-uniform Q(c) =
    log((c+2)/(c+1)) / log(range+1), drawn with replacement from
    ``generator`` and shared across the batch; Q is scaled by
    ``num_samples``. ``customized_samples``/``customized_probabilities``
    take the draw instead (then nothing is drawn). Accidental hits are
    pushed down by 1e20."""
    b, num_classes = logits.shape
    num_true = labels.shape[1]
    log_range = torch.log(torch.tensor(num_classes + 1.0,
                                       dtype=logits.dtype,
                                       device=logits.device))

    def q(v):
        v = v.to(logits.dtype)
        return torch.log((v + 2.0) / (v + 1.0)) / log_range

    if customized_samples is not None:
        if customized_probabilities is None:
            raise ValueError("customized_samples requires "
                             "customized_probabilities (the reference's "
                             "use_customized_samples path takes both)")
        samples = customized_samples.long()
        probabilities = customized_probabilities
    else:
        if generator is None:
            raise ValueError("sample_logits needs a generator when not "
                             "given customized_samples")
        u = torch.rand((num_samples,), generator=generator,
                       device=generator.device, dtype=logits.dtype).to(
            logits.device)
        neg = (torch.exp(u * log_range) - 1.0).to(torch.int32).long() \
            % num_classes
        samples = torch.cat([labels.long(), neg[None, :].expand(
            b, num_samples)], 1)
        probabilities = q(samples) * num_samples
    sampled = torch.gather(logits, 1, samples)
    if remove_accidental_hits:
        negs = samples[:, num_true:]
        hit = (negs[:, :, None] == labels[:, None, :].long()).any(-1)
        sampled = torch.cat([sampled[:, :num_true],
                             sampled[:, num_true:] - 1e20 * hit], 1)
    sampled = _tolerable(sampled - _tolerable(torch.log(probabilities)))
    sampled_labels = torch.arange(num_true, device=logits.device)[
        None, :].expand(b, num_true)
    return samples, probabilities, sampled, sampled_labels


@register_op("sequence_topk_avg_pooling")
def sequence_topk_avg_pooling(x, row_lens, col_lens, *, topks):
    """Per (sample, row, channel), the mean of the top-k values over the
    row's valid columns for each k in ``topks``, dividing by k even when
    fewer columns are valid (``sequence_topk_avg_pooling_op.h:64``). x
    (B, C, Rmax, Cmax) -> (B, Rmax, C, len(topks)), rows past
    ``row_lens`` zero."""
    _, _, rm, cm = x.shape
    topks = tuple(int(k) for k in topks)
    max_k = max(topks)
    if max_k > cm:
        raise ValueError(f"topks={topks} exceed column capacity {cm}")
    dev = x.device
    colmask = torch.arange(cm, device=dev)[None, :] < col_lens[:, None]
    masked = torch.where(colmask[:, None, None, :], x,
                         torch.full_like(x, -math.inf))
    top = torch.topk(masked, max_k, dim=-1).values
    contrib = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    csum = torch.cumsum(contrib, dim=-1)
    ks = torch.tensor(topks, device=dev)
    avg = csum[..., ks - 1] / ks.to(x.dtype)
    rowmask = torch.arange(rm, device=dev)[None, :] < row_lens[:, None]
    avg = avg * rowmask[:, None, :, None].to(avg.dtype)
    return avg.permute(0, 2, 1, 3)
