"""Reader combinators (``paddle_tpu/data/reader.py``, this package's own
copy: parity with ``python/paddle/reader/decorator.py`` — shuffle:83,
buffered:229, xmap_readers:300, plus map_readers/chain/compose/firstn/
cache/batch).

A *reader creator* is a zero-arg callable returning an iterator of samples,
the reference's contract. ``shuffle`` draws from ``random.Random(seed)``,
so the same seed gives the reference's order. ``buffered``/``xmap`` use
daemon threads + queues like the reference's implementations.
"""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading
from typing import List


def cache(reader):
    all_data: List = []
    loaded = threading.Event()

    def creator():
        if not loaded.is_set():
            all_data.extend(reader())
            loaded.set()
        return iter(list(all_data))

    return creator


def map_readers(func, *readers):
    def creator():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return creator


def shuffle(reader, buf_size, seed=None):
    """Buffered shuffle (decorator.py:83)."""

    def creator():
        rng = _random.Random(seed)
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rng.shuffle(buf)
            yield from buf

    return creator


def chain(*readers):
    def creator():
        return itertools.chain(*[r() for r in readers])

    return creator


def compose(*readers):
    """Zip readers into tuple samples (decorator.py compose)."""

    def creator():
        for items in zip(*[r() for r in readers]):
            out = []
            for it in items:
                if isinstance(it, tuple):
                    out.extend(it)
                else:
                    out.append(it)
            yield tuple(out)

    return creator


def firstn(reader, n):
    def creator():
        return itertools.islice(reader(), n)

    return creator


def buffered(reader, size):
    """Background-thread prefetch queue (decorator.py:229)."""

    _end = object()

    def creator():
        q: queue.Queue = queue.Queue(maxsize=size)

        def fill():
            try:
                for sample in reader():
                    q.put(sample)
            finally:
                q.put(_end)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            sample = q.get()
            if sample is _end:
                break
            yield sample

    return creator


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over samples with worker threads (decorator.py:300)."""

    _end = object()

    def creator():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)

        def feed():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(_end)

        def work():
            while True:
                item = in_q.get()
                if item is _end:
                    out_q.put(_end)
                    return
                i, sample = item
                out_q.put((i, mapper(sample)))

        threads = [threading.Thread(target=feed, daemon=True)]
        threads += [threading.Thread(target=work, daemon=True)
                    for _ in range(process_num)]
        for t in threads:
            t.start()

        finished = 0
        if order:
            pending = {}
            next_idx = 0
            while finished < process_num:
                item = out_q.get()
                if item is _end:
                    finished += 1
                    continue
                i, mapped = item
                pending[i] = mapped
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
            for i in sorted(pending):
                yield pending[i]
        else:
            while finished < process_num:
                item = out_q.get()
                if item is _end:
                    finished += 1
                    continue
                yield item[1]

    return creator


def batch(reader, batch_size, drop_last=True):
    """Group samples into lists (paddle.batch parity)."""

    def creator():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return creator
