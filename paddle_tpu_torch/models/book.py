"""The book chapters' models (``paddle_tpu/models/book.py``, fluid's
``tests/book``): fit-a-line, word2vec (n-gram and skip-gram with negative
sampling), sentiment (stacked LSTM and text CNN), the LSTM language
model, the recommender, machine translation with beam search, and
semantic role labelling (BiLSTM + CRF).

The modules keep the reference's parameter names and ``Linear``'s ``(in,
out)`` layout, so each ``from_jax(params, ...)`` loads a reference tree
(numpy arrays) with ``models.convert.load_jax``; a model built from
``seed`` draws the reference's schemes from a ``torch.Generator``, not
JAX's bits. Models live on ``device``, the card unless the caller asks
for the CPU. ``loss(...)`` returns ``(loss, aux)`` as the reference's.
"""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.nn.layers import Embedding, Linear
from paddle_tpu_torch.nn.nets import SequenceConvPool
from paddle_tpu_torch.nn.rnn import LSTM, RNN, LSTMCell
from paddle_tpu_torch.ops import beam_search as bs
from paddle_tpu_torch.ops import crf as crf_ops
from paddle_tpu_torch.ops import nn as ops_nn
from paddle_tpu_torch.ops import sequence as seq_ops
from paddle_tpu_torch.ops.activation import softplus

__all__ = ["LinearRegression", "Word2Vec", "SkipGramNS", "SentimentLSTM",
           "SentimentCNN", "RNNLanguageModel", "RecommenderSystem",
           "MachineTranslation", "LabelSemanticRoles"]


class _BookModel(nn.Module):
    """Device resolution, seeded initialisation and ``from_jax``."""

    def _setup(self, device):
        return dict(device=resolve_device(device))

    def _init(self, seed: int):
        """Every submodule's ``reset_parameters`` from one generator of
        ``seed``, in module order."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(gen)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @classmethod
    def from_jax(cls, params, *args, device="cuda", **kwargs):
        """The model of a reference parameter tree (numpy arrays): built
        with the reference constructor's ``args``/``kwargs`` on
        ``device``, then loaded (``models.convert.load_jax``)."""
        from paddle_tpu_torch.models.convert import load_jax
        return load_jax(cls(*args, device=device, **kwargs), params)


def _nll(logits, label):
    return ops_nn.softmax_with_cross_entropy(logits, label[:, None]).mean()


class LinearRegression(_BookModel):
    """fit_a_line: ``y = x W + b`` with the mean squared error."""

    def __init__(self, in_features: int = 13, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.fc = Linear(in_features, 1, sharding=None, **self._setup(device))
        self._init(seed)

    def forward(self, x):
        return self.fc(x)[:, 0]

    def loss(self, x, y):
        return ((self.forward(x) - y) ** 2).mean(), {}


class Word2Vec(_BookModel):
    """The n-gram neural language model of the word2vec chapter: embed the
    context words, concatenate, a sigmoid hidden layer, softmax over the
    vocabulary."""

    def __init__(self, vocab_size: int, embed_dim: int = 32,
                 context: int = 4, hidden: int = 256, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        kw = self._setup(device)
        self.context = context
        self.embed = Embedding(vocab_size, embed_dim, **kw)
        self.fc1 = Linear(context * embed_dim, hidden, sharding=None, **kw)
        self.fc2 = Linear(hidden, vocab_size, **kw)
        self._init(seed)

    def forward(self, context_ids):
        e = self.embed(context_ids.long())
        h = torch.sigmoid(self.fc1(e.reshape(e.shape[0], -1)))
        return self.fc2(h)

    def loss(self, context_ids, target_ids):
        return _nll(self.forward(context_ids), target_ids), {}


class SkipGramNS(_BookModel):
    """Skip-gram with negative sampling; the output table starts at
    zero."""

    def __init__(self, vocab_size: int, embed_dim: int = 64, *,
                 device="cuda", seed: int = 0):
        super().__init__()
        kw = self._setup(device)
        self.in_embed = Embedding(vocab_size, embed_dim, **kw)
        self.out_embed = Embedding(vocab_size, embed_dim, init_std=0.0, **kw)
        self._init(seed)

    def loss(self, center, positive, negatives):
        """center (B,), positive (B,), negatives (B, K)."""
        c = self.in_embed(center.long())
        pos = self.out_embed(positive.long())
        neg = self.out_embed(negatives.long())
        pos_logit = (c * pos).sum(-1)
        neg_logit = torch.einsum("bd,bkd->bk", c, neg)
        loss = (softplus(-pos_logit).mean()
                + softplus(neg_logit).sum(-1).mean())
        return loss, {}


def _accuracy(logits, label):
    return (logits.argmax(-1) == label).to(torch.float32).mean()


class SentimentLSTM(_BookModel):
    """understand_sentiment: embedding, stacked LSTM, max pool over each
    row's length, softmax."""

    def __init__(self, vocab_size: int, num_classes: int = 2,
                 embed_dim: int = 64, hidden: int = 128, num_layers: int = 2,
                 *, device="cuda", seed: int = 0):
        super().__init__()
        kw = self._setup(device)
        self.embed = Embedding(vocab_size, embed_dim, **kw)
        self.lstm = LSTM(embed_dim, hidden, num_layers=num_layers, **kw)
        self.fc = Linear(self.lstm.output_size, num_classes, sharding=None,
                         **kw)
        self._init(seed)

    def forward(self, ids, lengths):
        h, _ = self.lstm(self.embed(ids.long()), lengths)
        return self.fc(seq_ops.sequence_pool(h, lengths, "max"))

    def loss(self, ids, lengths, label):
        logits = self.forward(ids, lengths)
        return _nll(logits, label), {"acc": _accuracy(logits, label)}


class SentimentCNN(_BookModel):
    """understand_sentiment, conv variant (``convolution_net``): two
    ``SequenceConvPool`` branches of filter sizes 3 and 4 (tanh,
    sqrt-pool), concatenated, softmax."""

    def __init__(self, vocab_size: int, num_classes: int = 2,
                 embed_dim: int = 128, hidden: int = 512, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        kw = self._setup(device)
        self.embed = Embedding(vocab_size, embed_dim, **kw)
        self.conv3 = SequenceConvPool(embed_dim, hidden, 3, act="tanh",
                                      pool_type="sqrt", **kw)
        self.conv4 = SequenceConvPool(embed_dim, hidden, 4, act="tanh",
                                      pool_type="sqrt", **kw)
        self.fc = Linear(2 * hidden, num_classes, sharding=None, **kw)
        self._init(seed)

    def forward(self, ids, lengths):
        x = self.embed(ids.long())
        return self.fc(torch.cat([self.conv3(x, lengths),
                                  self.conv4(x, lengths)], -1))

    def loss(self, ids, lengths, label):
        logits = self.forward(ids, lengths)
        return _nll(logits, label), {"acc": _accuracy(logits, label)}


class RNNLanguageModel(_BookModel):
    """The LSTM language model: embedding, stacked LSTM, a projection to
    the vocabulary (or the tied embedding when ``tie_embeddings`` and the
    widths agree); next-token cross entropy, masked by ``lengths``."""

    def __init__(self, vocab_size: int, embed_dim: int = 128,
                 hidden: int = 128, num_layers: int = 2,
                 tie_embeddings: bool = True, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        kw = self._setup(device)
        self.embed = Embedding(vocab_size, embed_dim, init_std=0.05, **kw)
        self.lstm = LSTM(embed_dim, hidden, num_layers=num_layers, **kw)
        self.tie = tie_embeddings and hidden == embed_dim
        if not self.tie:
            self.proj = Linear(hidden, vocab_size, **kw)
        self._init(seed)

    def forward(self, ids, lengths=None):
        h, _ = self.lstm(self.embed(ids.long()), lengths)
        return self.embed.attend(h) if self.tie else self.proj(h)

    def loss(self, ids, targets, lengths=None):
        logp = torch.log_softmax(self.forward(ids, lengths).float(), -1)
        nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
        if lengths is not None:
            mask = seq_ops.sequence_mask(lengths, ids.shape[1],
                                         torch.float32)
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        else:
            loss = nll.mean()
        return loss, {"ppl": torch.exp(loss)}


class RecommenderSystem(_BookModel):
    """recommender_system: a user tower (id, gender, age, occupation
    embeddings) and a movie tower (id embedding, category multi-hot)
    fused by cosine similarity scaled to the rating range; MSE."""

    def __init__(self, n_users: int = 6041, n_movies: int = 3953,
                 n_cat: int = 18, dim: int = 32, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        kw = self._setup(device)
        half = dim // 2
        self.user_emb = Embedding(n_users, dim, **kw)
        self.gender_emb = Embedding(2, half, **kw)
        self.age_emb = Embedding(7, half, **kw)
        self.occ_emb = Embedding(21, half, **kw)
        self.user_fc = Linear(dim + 3 * half, dim, sharding=None, **kw)
        self.movie_emb = Embedding(n_movies, dim, **kw)
        self.cat_fc = Linear(n_cat, half, sharding=None, **kw)
        self.movie_fc = Linear(dim + half, dim, sharding=None, **kw)
        self._init(seed)

    def forward(self, user_id, gender, age, occupation, movie_id,
                categories):
        u = torch.cat([self.user_emb(user_id.long()),
                       self.gender_emb(gender.long()),
                       self.age_emb(age.long()),
                       self.occ_emb(occupation.long())], -1)
        u = torch.tanh(self.user_fc(u))
        m = torch.cat([self.movie_emb(movie_id.long()),
                       torch.tanh(self.cat_fc(categories))], -1)
        m = torch.tanh(self.movie_fc(m))
        cos = (u * m).sum(-1) / (torch.linalg.vector_norm(u, dim=-1)
                                 * torch.linalg.vector_norm(m, dim=-1)
                                 + 1e-8)
        return 5.0 * cos

    def loss(self, user_id, gender, age, occupation, movie_id, categories,
             rating):
        pred = self.forward(user_id, gender, age, occupation, movie_id,
                            categories)
        return ((pred - rating) ** 2).mean(), {
            "mae": (pred - rating).abs().mean()}


class MachineTranslation(_BookModel):
    """machine_translation: embedding, tanh fc, an LSTM encoder whose final
    hidden state seeds a plain-RNN decoder (``state = tanh(fc([word,
    state]))``, vocab softmax); decoded by :meth:`beam_search_translate`
    over ``ops.beam_search``."""

    def __init__(self, src_vocab: int, trg_vocab: int, embed_dim: int = 32,
                 hidden: int = 32, bos_id: int = 1, eos_id: int = 2,
                 pad_id: int = 0, *, device="cuda", seed: int = 0):
        super().__init__()
        kw = self._setup(device)
        self.src_embed = Embedding(src_vocab, embed_dim, **kw)
        self.trg_embed = Embedding(trg_vocab, embed_dim, **kw)
        self.enc_fc = Linear(embed_dim, hidden, sharding=None, **kw)
        self.encoder = RNN(LSTMCell(hidden, hidden, **kw))
        self.dec_fc = Linear(embed_dim + hidden, hidden, sharding=None, **kw)
        self.out = Linear(hidden, trg_vocab, sharding=None, **kw)
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self._init(seed)

    def encode(self, src_ids, src_lengths):
        x = torch.tanh(self.enc_fc(self.src_embed(src_ids.long())))
        _, (h, _) = self.encoder(x, src_lengths)
        return h

    def _dec_step(self, state, emb):
        state = torch.tanh(self.dec_fc(torch.cat([emb, state], -1)))
        return state, self.out(state)

    def forward(self, src_ids, src_lengths, trg_ids):
        """Teacher-forced logits (B, T, V)."""
        state = self.encode(src_ids, src_lengths)
        emb = self.trg_embed(trg_ids.long())
        logits = []
        for t in range(emb.shape[1]):
            state, lg = self._dec_step(state, emb[:, t])
            logits.append(lg)
        return torch.stack(logits, dim=1)

    def loss(self, src_ids, src_lengths, trg_in, trg_out, trg_lengths):
        logits = self.forward(src_ids, src_lengths, trg_in)
        nll = ops_nn.softmax_with_cross_entropy(logits,
                                                trg_out.long()[..., None])
        mask = seq_ops.sequence_mask(trg_lengths, trg_in.shape[1],
                                     logits.dtype)
        return (nll[..., 0] * mask).sum() / torch.clamp(mask.sum(),
                                                        min=1.0), {}

    def beam_search_translate(self, src_ids, src_lengths, *,
                              beam_size: int = 4, max_len: int = 16,
                              length_penalty: float = 0.0):
        """``(seqs (B, K, max_len + 1) from BOS, scores (B, K))``,
        best-first (``beam_search_step``, ``gather_beams``,
        ``beam_search_decode``)."""
        b, k = src_ids.shape[0], beam_size
        ctx = self.encode(src_ids, src_lengths)
        state = ctx[:, None, :].expand(b, k, ctx.shape[-1])
        scores, done = bs.beam_init(b, k, device=ctx.device)
        tok = torch.full((b, k), self.bos_id, dtype=torch.int32,
                         device=ctx.device)
        toks, parents = [], []
        for _ in range(max_len):
            emb = self.trg_embed(tok.long())
            h, logits = self._dec_step(state.reshape(b * k, -1),
                                       emb.reshape(b * k, -1))
            logp = torch.log_softmax(logits.float(), -1)
            tok, scores, done, parent = bs.beam_search_step(
                logp.reshape(b, k, -1), scores, done, eos_id=self.eos_id,
                pad_id=self.pad_id)
            state = bs.gather_beams(h.reshape(b, k, -1), parent)
            toks.append(tok)
            parents.append(parent)
        return bs.beam_search_decode(
            torch.stack(toks, 1), torch.stack(parents, 1), scores,
            eos_id=self.eos_id, pad_id=self.pad_id, bos_id=self.bos_id,
            length_penalty=length_penalty)


class LabelSemanticRoles(_BookModel):
    """label_semantic_roles: word, predicate and mark embeddings, a deep
    BiLSTM, per-token tag emissions, the linear-chain CRF loss and
    Viterbi :meth:`decode` (``ops.crf``). ``transition``/``start``/``stop``
    start at zero."""

    def __init__(self, vocab_size: int, num_tags: int, *, dim: int = 32,
                 hidden: int = 32, depth: int = 2, device="cuda",
                 seed: int = 0):
        super().__init__()
        kw = self._setup(device)
        self.word_emb = Embedding(vocab_size, dim, **kw)
        self.pred_emb = Embedding(vocab_size, dim, **kw)
        self.mark_emb = Embedding(2, dim // 2, **kw)
        self.lstm = LSTM(2 * dim + dim // 2, hidden, num_layers=depth,
                         bidirectional=True, **kw)
        self.fc = Linear(self.lstm.output_size, num_tags, sharding=None,
                         **kw)
        self.transition = nn.Parameter(torch.zeros(num_tags, num_tags, **kw))
        self.start = nn.Parameter(torch.zeros(num_tags, **kw))
        self.stop = nn.Parameter(torch.zeros(num_tags, **kw))
        self._init(seed)

    def emissions(self, words, predicate, mark, lengths):
        words = words.long()
        x = torch.cat([self.word_emb(words),
                       self.pred_emb(predicate.long()[:, None].expand_as(
                           words)),
                       self.mark_emb(mark.long())], -1)
        h, _ = self.lstm(x, lengths)
        return self.fc(h)

    def loss(self, words, predicate, mark, labels, lengths):
        em = self.emissions(words, predicate, mark, lengths)
        nll = crf_ops.linear_chain_crf(em, labels, lengths, self.transition,
                                       start=self.start, stop=self.stop)
        return nll.mean(), {}

    def decode(self, words, predicate, mark, lengths):
        """Viterbi tag paths (B, T), 0 past each row's length."""
        em = self.emissions(words, predicate, mark, lengths)
        return crf_ops.crf_decoding(em, self.transition, lengths,
                                    start=self.start, stop=self.stop)
