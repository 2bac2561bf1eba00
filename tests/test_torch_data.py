"""The port's data path (``paddle_tpu_torch.data``) against the reference's
on the CPU, exactly: reader combinators (the same seed gives the same
order), the datasets' real-format parsers over files written here and
their synthetic generators, the packer's arrays element for element, the
native MultiSlot feed (the port's own ``data_feed.cc``, loaded
``RTLD_LOCAL`` beside the reference's library) with its batches, shuffle
and parse errors, ``DataFeeder`` and ``device_iterator`` (a 2-rank gloo
mesh keeps each rank's dp rows, as the reference's ``batch_sharding``
places them), and ``DeviceLoader`` on the CPU: the same batches, early
close, an exception carried to the consumer. End to end, file -> native
feed -> packer -> train step: a tiny Transformer learns a copy task
(``tests/test_packing.py:166``)."""

import gzip
import os
import pickle
import struct
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.data import datasets as jds
from paddle_tpu.data import feeder as jfeeder
from paddle_tpu.data import packing as jpack
from paddle_tpu.data import reader as jreader
from paddle_tpu.data.native_feed import MultiSlotDataset as JaxMultiSlot
from paddle_tpu_torch.data import datasets as pds
from paddle_tpu_torch.data import feeder as pfeeder
from paddle_tpu_torch.data import packing as ppack
from paddle_tpu_torch.data import reader as preader
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.data.native_feed import DeviceLoader, MultiSlotDataset
from paddle_tpu_torch.models.transformer import Transformer, TransformerConfig
from paddle_tpu_torch.train import build_train_step, make_train_state

from torch_tp_pool import TpPool

torch.set_num_threads(2)


def _same(a, b):
    """Nested samples equal, arrays by value and dtype."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _src(n=23):
    return lambda: iter(range(n))


# -- reader combinators -------------------------------------------------------

READERS = {
    "cache": lambda R: R.cache(_src()),
    "map_readers": lambda R: R.map_readers(lambda a, b: a * 10 + b, _src(),
                                           _src(7)),
    "shuffle": lambda R: R.shuffle(_src(50), 8, seed=3),
    "shuffle_one_buffer": lambda R: R.shuffle(_src(50), 100, seed=11),
    "chain": lambda R: R.chain(_src(3), _src(4)),
    "compose": lambda R: R.compose(lambda: iter([(1, 2), (3, 4)]),
                                   lambda: iter([5, 6])),
    "firstn": lambda R: R.firstn(_src(), 5),
    "buffered": lambda R: R.buffered(_src(40), 4),
    "xmap_ordered": lambda R: R.xmap_readers(lambda x: x * x, _src(40), 3,
                                             4, order=True),
    "batch": lambda R: R.batch(_src(), 5),
    "batch_keep_last": lambda R: R.batch(_src(), 5, drop_last=False),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_equals_the_reference(name):
    got = list(READERS[name](preader)())
    want = list(READERS[name](jreader)())
    assert got == want
    if name == "cache":
        assert list(READERS[name](preader)()) == want


def test_unordered_xmap_gives_the_same_samples():
    got = list(preader.xmap_readers(lambda x: -x, _src(60), 4, 2)())
    assert sorted(got) == sorted(-x for x in range(60))


# -- datasets -------------------------------------------------------------------

SYNTHETIC = {
    "synthetic_mnist": dict(n=6, seed=1, template_seed=2),
    "synthetic_imagenet": dict(n=3, image_size=8, num_classes=5, seed=2),
    "synthetic_lm": dict(n=4, seq_len=9, vocab=50, seed=3),
    "synthetic_ctr": dict(n=5, seed=4),
    "synthetic_conll05": dict(n=4, seq_len=10, seed=5),
    "uci_housing": dict(split="test"),
    "movielens": dict(split="train", n=64),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_generator_equals_the_reference(name):
    _same(list(getattr(pds, name)(**SYNTHETIC[name])()),
          list(getattr(jds, name)(**SYNTHETIC[name])()))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Small files in each real format the parsers read."""
    d = tmp_path_factory.mktemp("datasets")
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (5, 28 * 28), dtype=np.uint8)
    with gzip.open(d / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with open(d / "train-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + bytes([3, 1, 4, 1, 5]))
    cif = d / "cifar-10-batches-py"
    cif.mkdir()
    with open(cif / "test_batch", "wb") as f:
        pickle.dump({b"data": rng.integers(0, 256, (4, 3072),
                                           dtype=np.uint8),
                     b"labels": [0, 9, 2, 7]}, f)
    words = "the cat sat on a mat and the dog ran off".split()
    for split in ("train",):
        for sub in ("pos", "neg"):
            p = d / "aclImdb" / split / sub
            p.mkdir(parents=True)
            for i in range(3):
                (p / f"{i}_7.txt").write_text(" ".join(
                    rng.choice(words, 9)).title())
    for lang in ("en", "de"):
        (d / f"train.{lang}").write_text("\n".join(
            " ".join(rng.choice(words, int(rng.integers(2, 7))))
            for _ in range(6)) + "\n")
    rows = rng.standard_normal((20, 14))
    (d / "housing.data").write_text("\n".join(
        " ".join(f"{v:.5f}" for v in r) for r in rows) + "\n")
    (d / "users.dat").write_text("1::F::25::3::00000\n2::M::56::7::11111\n")
    (d / "movies.dat").write_text(
        "10::A (1995)::Comedy|Drama\n20::B (1996)::Action\n")
    (d / "ratings.dat").write_text("\n".join(
        f"{u}::{m}::{r}::0" for u, m, r in
        ((1, 10, 5), (2, 20, 3), (1, 20, 4), (2, 10, 1), (1, 30, 2))) + "\n")
    return d


REAL = {
    "mnist": lambda M, d: M.mnist(str(d)),
    "cifar10": lambda M, d: M.cifar10(str(d), split="test"),
    "imdb": lambda M, d: M.imdb(
        str(d / "aclImdb"), M.imdb_build_dict(str(d / "aclImdb"), cutoff=0)),
    "wmt_parallel": lambda M, d: M.wmt_parallel(str(d)),
    "uci_housing": lambda M, d: M.uci_housing(str(d), split="train"),
    "movielens": lambda M, d: M.movielens(str(d), split="test",
                                          test_fraction=0.4),
}


@pytest.mark.parametrize("name", sorted(REAL))
def test_real_format_parser_equals_the_reference(name, data_dir):
    _same(list(REAL[name](pds, data_dir)()),
          list(REAL[name](jds, data_dir)()))


def test_dicts_and_missing_files_equal_the_reference(data_dir, tmp_path):
    paths = [str(data_dir / "train.en"), str(data_dir / "train.de")]
    assert pds.wmt_build_dict(paths, cutoff=1) == \
        jds.wmt_build_dict(paths, cutoff=1)
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        pds.mnist(str(tmp_path))
    with pytest.raises(ValueError, match="no '<unk>' entry"):
        pds.wmt_parallel(str(data_dir), src_dict={"the": 0})


# -- packing ---------------------------------------------------------------------

def _ragged(rng, n, lo, hi):
    return [rng.integers(3, 64, size=int(rng.integers(lo, hi))).astype(
        np.int32) for _ in range(n)]


def test_packing_equals_the_reference():
    rng = np.random.default_rng(1)
    seqs = _ragged(rng, 37, 1, 17)
    for kw in ({}, {"max_segments": 3}, {"pad_value": 2}):
        _same(ppack.pack_examples(seqs, 32, **kw),
              jpack.pack_examples(seqs, 32, **kw))
    src, tgt = _ragged(rng, 41, 2, 15), _ragged(rng, 41, 2, 13)
    extras = {"tgt_out": [t + 1 for t in tgt]}
    _same(ppack.pack_pairs(src, tgt, 16, 16, tgt_extras=extras),
          jpack.pack_pairs(src, tgt, 16, 16, tgt_extras=extras))
    for pad_rows in (True, False):
        got = list(ppack.packed_batches(src, tgt, rows_per_batch=4,
                                        src_len=16, tgt_len=16,
                                        pad_rows=pad_rows, max_segments=4,
                                        tgt_extras=extras))
        _same(got, list(jpack.packed_batches(
            src, tgt, rows_per_batch=4, src_len=16, tgt_len=16,
            pad_rows=pad_rows, max_segments=4, tgt_extras=extras)))
        assert ppack.packing_efficiency(got[0]["tgt_seg"]) == \
            jpack.packing_efficiency(got[0]["tgt_seg"])
    for n in (1, 32, 33, 1024):
        assert ppack.bucket_len(n) == jpack.bucket_len(n)
    for mod in (ppack, jpack):
        with pytest.raises(ValueError, match="exceeds"):
            mod.pack_examples([np.arange(40)], 32)
        with pytest.raises(ValueError, match="lengths differ"):
            mod.pack_pairs([np.arange(3)], [np.arange(3)], 8, 8,
                           tgt_extras={"bad": [np.arange(2)]})


# -- the native MultiSlot feed ---------------------------------------------------

def _write_multislot(dirpath, files=3, lines=40, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(files):
        p = os.path.join(dirpath, f"part-{i}.txt")
        with open(p, "w") as f:
            for _ in range(lines):
                a = rng.integers(0, 1000, int(rng.integers(1, 9)))
                w = rng.standard_normal(int(rng.integers(0, 4)))
                f.write(f"{len(a)} {' '.join(map(str, a))} {len(w)} "
                        + " ".join(f"{v:.6g}" for v in w) + " 1 "
                        + str(int(rng.integers(0, 2))) + "\n")
        paths.append(p)
    return paths


SLOTS = [("ids", "int64"), ("w", "float32"), ("label", "int64")]


def _batches(cls, paths, shuffle=None, **kw):
    ds = cls(SLOTS)
    ds.set_filelist(paths)
    n = ds.load_into_memory(num_threads=3)
    if shuffle is not None:
        ds.global_shuffle(shuffle)
    return n, len(ds), list(ds.batches(16, **kw))


@pytest.mark.parametrize("shuffle,kw", [
    (None, {}), (0, {"with_lengths": True}),
    (7, {"pad_value": -1, "drop_last": False, "with_lengths": True})])
def test_multislot_batches_equal_the_reference(tmp_path, shuffle, kw):
    paths = _write_multislot(str(tmp_path))
    got = _batches(MultiSlotDataset, paths, shuffle, **kw)
    want = _batches(JaxMultiSlot, paths, shuffle, **kw)
    assert got[:2] == want[:2] == (120, 120)
    _same(got[2], want[2])


def test_multislot_errors_equal_the_reference(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("2 1 2 1 0.5 1 0\n3 1 2 1 0.5 1 0\n")
    msgs = []
    for cls in (MultiSlotDataset, JaxMultiSlot):
        for paths in ([str(bad)], [str(tmp_path / "missing.txt")]):
            ds = cls(SLOTS)
            ds.set_filelist(paths)
            with pytest.raises(RuntimeError) as err:
                ds.load_into_memory(2)
            msgs.append(str(err.value))
    assert msgs[:2] == msgs[2:]
    assert msgs[0].startswith("parse error in ")
    assert msgs[1].startswith("cannot open ")


# -- feeding ------------------------------------------------------------------------

def _samples(n=12, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(3).astype(np.float32),
             np.int64(rng.integers(0, 9)),
             rng.integers(0, 5, 4).astype(np.int32)) for _ in range(n)]


def test_data_feeder_and_device_iterator_equal_the_reference():
    names = ["x", "y", "ids"]
    samples = _samples()
    _same(pfeeder.DataFeeder(names).feed(samples),
          jfeeder.DataFeeder(names).feed(samples))
    with pytest.raises(ValueError, match="arity"):
        pfeeder.DataFeeder(["x"]).feed(samples)
    br = lambda: iter([samples[i:i + 4] for i in range(0, 12, 4)])
    got = [{k: v.numpy() for k, v in b.items()}
           for b in pfeeder.device_iterator(br, names, device="cpu")]
    want = [{k: np.asarray(v) for k, v in b.items()}
            for b in jfeeder.device_iterator(br, names)]
    # the same values; the port keeps the host dtypes (JAX without x64
    # narrows int64 to int32 on its device)
    for g, w, host in zip(got, want, br()):
        _same(g, pfeeder.DataFeeder(names).feed(host))
        for k in names:
            np.testing.assert_array_equal(g[k], w[k])


def test_device_iterator_keeps_each_ranks_dp_rows():
    """A 2-rank gloo mesh (dp=2): each rank holds the rows the
    reference's ``batch_sharding`` places on its dp index, and the
    ``replicated`` feed whole."""
    from paddle_tpu.core import mesh as jmesh
    names, samples = ["x", "y", "ids"], _samples(16)
    br = jreader.batch(lambda: iter(samples), 8)
    mesh = jmesh.make_mesh(jmesh.MeshConfig(dp=2, tp=4))
    want = []
    for b in jfeeder.device_iterator(br, names, mesh=mesh,
                                     replicated=("y",)):
        blocks = {}
        for k, arr in b.items():
            parts = {}
            for sh in arr.addressable_shards:
                rows = sh.index[0]
                parts[(rows.start or 0)] = np.asarray(sh.data)
            blocks[k] = [parts[s] for s in sorted(parts)]
        want.append(blocks)
    pool = TpPool(2)
    try:
        got = pool.run("feed_rows", timeout_s=60, samples=samples,
                       names=names, replicated=("y",), sizes={"dp": 2},
                       batch_size=8)
    finally:
        pool.close()
    for rank in range(2):
        for b_got, b_want in zip(got[rank], want):
            for k in names:
                blocks = b_want[k]
                block = blocks[0] if k == "y" else blocks[rank]
                np.testing.assert_array_equal(b_got[k], block)
        assert len(got[rank]) == len(want) == 2


def test_device_loader_on_the_cpu():
    batches = [{"a": np.full((2, 3), i, np.int32),
                "b": np.arange(4, dtype=np.float32) + i} for i in range(7)]
    loader = DeviceLoader(iter(batches), buffer_size=2, device="cpu")
    got = [{k: v.numpy() for k, v in b.items()} for b in loader]
    _same(got, batches)
    assert loader.stats()["batches"] == 7
    assert loader.stats()["pinned_allocations"] == []

    # early break: the thread stops
    started = threading.active_count()
    loader = DeviceLoader(iter(batches * 100), buffer_size=2, device="cpu")
    for i, _ in enumerate(loader):
        if i == 2:
            break
    loader._thread.join(5)
    assert not loader._thread.is_alive()
    assert threading.active_count() <= started

    def failing():
        yield batches[0]
        raise KeyError("bad record")

    with pytest.raises(KeyError, match="bad record"):
        list(DeviceLoader(failing(), device="cpu"))

    def failing_first():
        raise OSError("no such file")
        yield

    with pytest.raises(OSError, match="no such file"):
        list(DeviceLoader(failing_first(), device="cpu"))


def test_device_loader_under_thread_switching_keeps_every_batch():
    """Stress: 400 batches through a loader of buffer 1 with the
    interpreter switching threads every microsecond; every batch arrives
    once, in order, and the loader thread ends."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = DeviceLoader(({"i": np.full((3,), i, np.int64)}
                               for i in range(400)), buffer_size=1,
                              device="cpu")
        got = [int(b["i"][0]) for b in loader]
        loader._thread.join(10)
    finally:
        sys.setswitchinterval(old)
    assert got == list(range(400))
    assert not loader._thread.is_alive()
    assert loader.stats()["batches"] == 400


def test_device_loader_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceLoader(iter([]))


PACKED_KEYS = ("src", "src_seg", "src_pos", "tgt", "tgt_out", "tgt_seg",
               "tgt_pos")


def test_native_feed_to_packed_training_converges(tmp_path):
    """file -> the port's MultiSlot feed (ragged src/tgt) -> packer ->
    train step; a copy task converges (the reference's
    ``test_native_feed_to_packed_training``)."""
    rng = np.random.default_rng(4)
    path = tmp_path / "mt.txt"
    with open(path, "w") as f:
        for _ in range(256):
            n = int(rng.integers(3, 12))
            s = " ".join(map(str, rng.integers(3, 32, size=n)))
            f.write(f"{n} {s} {n} {s}\n")
    ds = MultiSlotDataset([("src", "int64"), ("tgt", "int64")])
    ds.set_filelist([str(path)])
    assert ds.load_into_memory(4) == 256
    cfg = TransformerConfig.tiny(dropout=0.0, attn_dropout=0.0, max_len=16,
                                 vocab_size=32, label_smoothing=0.0)
    model = Transformer(cfg, device="cpu", seed=0)
    state = make_train_state(model, opt.Adam(model.parameters(),
                                             learning_rate=1e-2))
    step = build_train_step(
        lambda m, **b: m.loss_packed(*(b[k] for k in PACKED_KEYS)),
        state["opt"])
    srcs, tins, touts = [], [], []
    for b in ds.batches(64, with_lengths=True):
        for i in range(b["src"].shape[0]):
            s = b["src"][i, :b["src_len"][i]].astype(np.int32)
            t = b["tgt"][i, :b["tgt_len"][i]].astype(np.int32)
            srcs.append(s)
            tins.append(np.concatenate([[cfg.bos_id], t]).astype(np.int32))
            touts.append(np.concatenate([t, [cfg.eos_id]]).astype(np.int32))
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in ppack.packed_batches(
                   srcs, tins, rows_per_batch=8, src_len=16, tgt_len=16,
                   tgt_extras={"tgt_out": touts})]
    losses = []
    for _ in range(10):
        losses.append(np.mean([float(step(state, **b)[1]["loss"])
                               for b in batches]))
    assert losses[-1] < losses[0] * 0.7, losses
