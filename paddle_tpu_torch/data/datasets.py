"""Stock datasets (``paddle_tpu/data/datasets.py``, this package's own
copy; parity: ``python/paddle/dataset/`` — mnist, cifar, imdb, wmt14/16…).

Two tiers:
- REAL-FORMAT loaders (:func:`mnist`, :func:`cifar10`, :func:`imdb`,
  :func:`wmt_parallel`, :func:`uci_housing`, :func:`movielens`) parse the
  standard on-disk formats (idx-ubyte, cifar-10-batches-py pickles,
  pos/neg text trees, line-aligned parallel text) from a local
  ``data_dir``: the reference loaders' parse paths without their download
  step (nothing is downloaded; point ``data_dir`` at a pre-fetched copy).
- *synthetic but learnable* generators with the same sample schemas, for
  tests; each draws from ``np.random.RandomState`` as the reference does,
  so the same seed yields the same numpy samples.

All loaders are reader-creators (``paddle.dataset`` convention): calling
them returns a ``reader()`` generator factory composable with
:mod:`paddle_tpu_torch.data.reader` combinators.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np


# ---------------------------------------------------------------------------
# real-format loaders (python/paddle/dataset/{mnist,cifar,imdb}.py parse
# paths, minus the downloader)
# ---------------------------------------------------------------------------

def _open_maybe_gz(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _open_text(path):
    import io
    return io.TextIOWrapper(_open_maybe_gz(path), errors="ignore")


def _find(data_dir, names):
    for n in names:
        for cand in (n, n + ".gz"):
            p = os.path.join(data_dir, cand)
            if os.path.exists(p):
                return p
    raise FileNotFoundError(
        f"none of {names} (optionally .gz) under {data_dir!r} — nothing "
        "is downloaded; place the files there or use the synthetic_* "
        "loaders")


def mnist(data_dir, split="train"):
    """idx-ubyte MNIST reader (paddle.dataset.mnist.train/test parity):
    yields (image (784,) float32 in [-1, 1], label int64)."""
    prefix = "train" if split == "train" else "t10k"
    img_path = _find(data_dir, [f"{prefix}-images-idx3-ubyte",
                                f"{prefix}-images.idx3-ubyte"])
    lbl_path = _find(data_dir, [f"{prefix}-labels-idx1-ubyte",
                                f"{prefix}-labels.idx1-ubyte"])

    def reader():
        with _open_maybe_gz(img_path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(f"bad idx3 magic {magic} in {img_path}")
            images = np.frombuffer(f.read(n * rows * cols),
                                   np.uint8).reshape(n, rows * cols)
        with _open_maybe_gz(lbl_path) as f:
            magic, n2 = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise ValueError(f"bad idx1 magic {magic} in {lbl_path}")
            labels = np.frombuffer(f.read(n2), np.uint8)
        if n != n2:
            raise ValueError(f"image/label count mismatch {n} vs {n2}")
        for img, lbl in zip(images, labels):
            # reference normalization: [0,255] -> [-1, 1]
            yield (img.astype(np.float32) / 255.0 * 2.0 - 1.0,
                   np.int64(lbl))

    return reader


def cifar10(data_dir, split="train"):
    """cifar-10-batches-py reader (paddle.dataset.cifar.train10 parity):
    yields (image (3072,) float32 in [0, 1], label int64)."""
    base = data_dir
    inner = os.path.join(data_dir, "cifar-10-batches-py")
    if os.path.isdir(inner):
        base = inner
    names = ([f"data_batch_{i}" for i in range(1, 6)]
             if split == "train" else ["test_batch"])

    def reader():
        for name in names:
            p = os.path.join(base, name)
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"{p} missing — zero-egress environment; stage the "
                    "extracted cifar-10-batches-py directory locally")
            with open(p, "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            data = batch[b"data"]
            labels = batch.get(b"labels", batch.get(b"fine_labels"))
            for row, lbl in zip(data, labels):
                yield (np.asarray(row, np.float32) / 255.0,
                       np.int64(lbl))

    return reader


def _build_dict(token_iter, cutoff=0, unk="<unk>"):
    """Frequency-sorted vocab (shared by the imdb/wmt builders): most
    frequent word gets id 0, ``unk`` always gets the LAST id — literal
    occurrences of the unk token in the corpus are excluded so its id is
    never shadowed (an id hole would overflow an embedding table sized
    len(dict))."""
    freq = {}
    for w in token_iter:
        freq[w] = freq.get(w, 0) + 1
    words = sorted((w for w, c in freq.items()
                    if c > cutoff and w != unk),
                   key=lambda w: (-freq[w], w))
    d = {w: i for i, w in enumerate(words)}
    d[unk] = len(words)
    return d


def imdb_build_dict(data_dir, cutoff=1):
    """Frequency-sorted word dict over train pos/neg text files
    (paddle.dataset.imdb.word_dict parity; <unk> gets the last id)."""
    def tokens():
        for sub in ("train/pos", "train/neg"):
            d = os.path.join(data_dir, sub)
            if not os.path.isdir(d):
                raise FileNotFoundError(
                    f"{d} missing — stage an extracted aclImdb tree")
            for name in sorted(os.listdir(d)):
                with open(os.path.join(d, name), errors="ignore") as f:
                    yield from f.read().lower().split()

    return _build_dict(tokens(), cutoff=cutoff)


def wmt_parallel(data_dir, src_lang="en", tgt_lang="de", split="train", *,
                 src_dict=None, tgt_dict=None, unk="<unk>"):
    """Parallel-corpus reader (paddle.dataset.wmt14/wmt16 parity): reads
    ``{split}.{src_lang}`` / ``{split}.{tgt_lang}`` line-aligned text plus
    vocab dicts, yielding (src_ids, tgt_ids) int64 arrays. Build dicts
    with :func:`wmt_build_dict` or pass pre-built {word: id} maps."""
    src_path = os.path.join(data_dir, f"{split}.{src_lang}")
    tgt_path = os.path.join(data_dir, f"{split}.{tgt_lang}")
    for p in (src_path, tgt_path):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} missing — stage line-aligned parallel text locally "
                "(zero-egress environment)")
    if src_dict is None:
        src_dict = wmt_build_dict([src_path], unk=unk)
    if tgt_dict is None:
        tgt_dict = wmt_build_dict([tgt_path], unk=unk)
    for name, d in (("src_dict", src_dict), ("tgt_dict", tgt_dict)):
        if unk not in d:
            raise ValueError(
                f"{name} has no {unk!r} entry — pre-built vocabs must "
                "include the unk token (or pass unk= matching theirs)")

    def to_ids(line, d):
        u = d[unk]
        return np.asarray([d.get(w, u) for w in line.split()], np.int64)

    def reader():
        with open(src_path, errors="ignore") as fs, \
                open(tgt_path, errors="ignore") as ft:
            # strict: a line-count mismatch is corpus MISALIGNMENT, not
            # something to silently truncate away
            for ls, lt in zip(fs, ft, strict=True):
                yield to_ids(ls.strip(), src_dict), \
                    to_ids(lt.strip(), tgt_dict)

    return reader


def wmt_build_dict(paths, cutoff=0, unk="<unk>"):
    """Frequency-sorted vocab over text files (wmt16 build_dict parity)."""
    def tokens():
        for p in paths:
            with open(p, errors="ignore") as f:
                for line in f:
                    yield from line.split()

    return _build_dict(tokens(), cutoff=cutoff, unk=unk)


def imdb(data_dir, word_idx, split="train"):
    """IMDB sentiment reader (paddle.dataset.imdb.train parity): yields
    (word ids (L,) int64, label int64) with pos=1/neg=0."""
    unk = word_idx["<unk>"]

    def reader():
        for label, sub in ((1, f"{split}/pos"), (0, f"{split}/neg")):
            d = os.path.join(data_dir, sub)
            for name in sorted(os.listdir(d)):
                with open(os.path.join(d, name), errors="ignore") as f:
                    ids = [word_idx.get(w, unk)
                           for w in f.read().lower().split()]
                yield np.asarray(ids, np.int64), np.int64(label)

    return reader


def synthetic_mnist(n=1024, seed=0, template_seed=0):
    """(image[28,28,1] float32, label int64) — mnist schema.

    Learnable structure: each class has a fixed random template (from
    ``template_seed`` — keep it constant across train/eval splits); samples
    are template + noise (from ``seed``), so a LeNet converges quickly.
    """
    rng = np.random.RandomState(template_seed)
    templates = rng.randn(10, 28, 28, 1).astype(np.float32)

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(n):
            label = r.randint(0, 10)
            img = templates[label] + 0.3 * r.randn(28, 28, 1).astype(np.float32)
            yield img.astype(np.float32), np.int64(label)

    return reader


def synthetic_imagenet(n=256, image_size=224, num_classes=1000, seed=0):
    """(image[H,W,3] float32, label int64) — flowers/imagenet schema."""
    rng = np.random.RandomState(seed)
    means = rng.randn(num_classes, 1, 1, 3).astype(np.float32)

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(n):
            label = r.randint(0, num_classes)
            img = means[label] + r.randn(image_size, image_size, 3).astype(np.float32)
            yield img.astype(np.float32), np.int64(label)

    return reader


def synthetic_lm(n=512, seq_len=128, vocab=1024, seed=0):
    """(token_ids[L] int32,) — language-model schema (wmt/imdb analog).
    Markov-chain structure so next-token prediction is learnable."""
    rng = np.random.RandomState(seed)
    # sparse transition preference: each token has 4 likely successors
    succ = rng.randint(0, vocab, (vocab, 4))

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(n):
            ids = np.empty(seq_len, np.int32)
            ids[0] = r.randint(0, vocab)
            for t in range(1, seq_len):
                if r.rand() < 0.8:
                    ids[t] = succ[ids[t - 1], r.randint(0, 4)]
                else:
                    ids[t] = r.randint(0, vocab)
            yield (ids,)

    return reader


def synthetic_ctr(n=2048, num_sparse_fields=26, num_dense=13,
                  vocab_per_field=1000, seed=0):
    """(dense[13] float32, sparse_ids[26] int64, label int64) — criteo/DeepFM
    schema (reference ctr_reader / dist_ctr.py)."""
    rng = np.random.RandomState(seed)
    field_w = rng.randn(num_sparse_fields).astype(np.float32)
    dense_w = rng.randn(num_dense).astype(np.float32)

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(n):
            dense = r.randn(num_dense).astype(np.float32)
            ids = r.randint(0, vocab_per_field, num_sparse_fields).astype(np.int64)
            logit = dense @ dense_w / 4 + ((ids % 7 == 0) * field_w).sum()
            label = np.int64(1 / (1 + np.exp(-logit)) > r.rand())
            yield dense, ids, label

    return reader


def uci_housing(data_dir=None, split="train", *, test_fraction=0.2):
    """UCI housing (python/paddle/dataset/uci_housing.py): 13 features +
    target, whitespace-separated ``housing.data``. Features are
    feature-normalized like the reference; deterministic train/test split.
    With ``data_dir=None`` falls back to a synthetic linear dataset with
    the same schema (sandbox default)."""
    if data_dir is not None:
        path = _find(data_dir, ["housing.data", "housing.data.gz"])
        with _open_maybe_gz(path) as f:
            rows = np.array([[float(v) for v in line.split()]
                             for line in f if line.strip()],
                            dtype=np.float32)
    else:
        rng = np.random.RandomState(0)
        x = rng.randn(506, 13).astype(np.float32)
        w = rng.randn(13).astype(np.float32)
        y = x @ w + 0.1 * rng.randn(506).astype(np.float32)
        rows = np.concatenate([x, y[:, None]], axis=1)
    feats = rows[:, :13]
    mean, std = feats.mean(0), feats.std(0) + 1e-8
    feats = (feats - mean) / std
    n_test = int(len(rows) * test_fraction)
    if split == "test":
        sel = slice(len(rows) - n_test, None)
    else:
        sel = slice(0, len(rows) - n_test)
    feats, target = feats[sel], rows[sel, 13]

    def reader():
        for i in range(len(feats)):
            yield feats[i], np.float32(target[i])

    return reader


def movielens(data_dir=None, split="train", *, test_fraction=0.1, n=4096):
    """MovieLens-1M (python/paddle/dataset/movielens.py): yields the
    recommender-system book schema (user_id, gender, age_bucket,
    occupation, movie_id, category_multihot[18], rating). Reads the
    ml-1m ``::``-separated .dat files; ``data_dir=None`` -> synthetic
    preference structure with the same schema."""
    n_cat = 18
    if data_dir is not None:
        upath = _find(data_dir, ["users.dat"])
        mpath = _find(data_dir, ["movies.dat"])
        rpath = _find(data_dir, ["ratings.dat"])
        users = {}
        with _open_text(upath) as f:
            for line in f:
                uid, gender, age, occ, _ = line.strip().split("::")
                ages = [1, 18, 25, 35, 45, 50, 56]
                users[int(uid)] = (int(gender == "F"),
                                  ages.index(int(age)), int(occ))
        cats = {}
        movies = {}
        with _open_text(mpath) as f:
            for line in f:
                mid, _, genres = line.strip().split("::")
                hot = np.zeros(n_cat, np.float32)
                for g in genres.split("|"):
                    hot[cats.setdefault(g, len(cats)) % n_cat] = 1.0
                movies[int(mid)] = hot
        ratings = []
        with _open_text(rpath) as f:
            for line in f:
                uid, mid, rating, _ = line.strip().split("::")
                ratings.append((int(uid), int(mid), float(rating)))
    else:
        rng = np.random.RandomState(0)
        users = {u: (int(rng.rand() < 0.5), rng.randint(0, 7),
                     rng.randint(0, 21)) for u in range(1, 101)}
        movies = {m: (rng.rand(n_cat) < 0.15).astype(np.float32)
                  for m in range(1, 201)}
        taste = {u: rng.randn(n_cat) for u in users}
        ratings = []
        for _ in range(n):
            u = rng.randint(1, 101)
            m = rng.randint(1, 201)
            score = 3.0 + taste[u] @ movies[m] + 0.3 * rng.randn()
            ratings.append((u, m, float(np.clip(np.round(score), 1, 5))))
    n_test = max(1, int(len(ratings) * test_fraction))
    sel = ratings[-n_test:] if split == "test" else ratings[:-n_test]

    def reader():
        for uid, mid, rating in sel:
            g, a, o = users.get(uid, (0, 0, 0))
            cat = movies.get(mid, np.zeros(n_cat, np.float32))
            yield (np.int64(uid), np.int64(g), np.int64(a), np.int64(o),
                   np.int64(mid), cat.astype(np.float32),
                   np.float32(rating))

    return reader


def synthetic_conll05(n=512, seq_len=24, vocab=200, num_tags=9, seed=0):
    """(words[T] int64, predicate int64, mark[T] int64, labels[T] int64,
    length int64) — conll05 SRL schema (python/paddle/dataset/conll05.py).
    Tags correlate with distance to the predicate so a tagger can learn."""

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(n):
            ln = r.randint(seq_len // 2, seq_len + 1)
            words = r.randint(1, vocab, seq_len).astype(np.int64)
            words[ln:] = 0
            pred_pos = r.randint(0, ln)
            mark = np.zeros(seq_len, np.int64)
            mark[pred_pos] = 1
            dist = np.abs(np.arange(seq_len) - pred_pos)
            labels = ((dist + words % 3) % num_tags).astype(np.int64)
            labels[ln:] = 0
            yield (words, np.int64(words[pred_pos]), mark, labels,
                   np.int64(ln))

    return reader
