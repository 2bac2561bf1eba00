"""Captured CUDA graphs of the serving engine's step signatures: the
port's counterpart of the JAX engine's jit cache, where every decode and
prefill bucket is one compiled XLA program
(``paddle_tpu/serving/engine.py`` ``warmup``).

One ``torch.cuda.CUDAGraph`` per bucket signature (``("decode", w)``,
``("prefill", w, lanes)``, ``("draft", w)``, ``("verify", w)``,
``("draft_prefill", w, lanes)``, ``("copy_page",)``, ``("page_read",)``,
``("page_write",)``). A bucket owns:

- its static inputs: one int32 device buffer holding every int32 input
  its step reads (block-table slice, lengths, tokens, active / n_valid,
  starts, page ids), as views. Before each call the host fills a pinned
  twin and copies it in with one asynchronous copy; an input that lives
  on the device (the draft's proposals feeding the verify call, a page
  written by ``("page_write",)``) is copied in on the device. An input
  of another dtype (a page's K/V) is a static device tensor of its own,
  fed only that way;
- its static output (one tensor or a tuple), allocated outside the graph
  pool, which the captured step's last operations write. Every graph
  shares one pool,
  so the pool costs the largest graph, not the sum: one graph's
  intermediates may reuse another's, and whatever one call hands to
  the next lives outside the pool;
- the kernel launches one replay makes, by registry entry. The kernel
  wrappers count launches in Python, which a replay never runs, so the
  counts the capture itself made are taken back and every replay adds
  the graph's counts: registry counts are the kernels the card ran.

Building a bucket (its signature's first use, or warmup) runs its step
once eagerly with the bucket's zero inputs, which write only the null
page, on a side stream as PyTorch documents for the warm-up before a
capture, then captures the same call. A failed capture raises, and so
does every later build of the same object (PyTorch's allocator may still
hold the failed capture's pool): nothing falls back to eager dispatch.
Each build counts as one capture,
process-wide (:func:`paddle_tpu_torch.observability.recompile.note_capture`),
the counterpart of one XLA compile. On the CPU, and on the card with
``enabled=False`` (eager dispatch), a build is the eager warm-up alone,
counted the same way, and every call runs the step eagerly on the
bucket's inputs.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.device import graph_capture
from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.observability import recompile

#: one step input: (name, shape), int32 in the bucket's shared buffer,
#: or (name, shape, dtype), a static device tensor fed from the device
Layout = Sequence[tuple]
#: signature -> (input layout, step function of those inputs by name)
Spec = Callable[[tuple], Tuple[Layout, Callable]]


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {n: c - before.get(n, 0) for n, c in after.items()
            if c != before.get(n, 0)}


class _Bucket:
    """One signature's static inputs, output and graph."""

    def __init__(self, layout: Layout, fn: Callable, device):
        self.fn = fn
        typed = [e for e in layout if len(e) == 3]
        layout = [e for e in layout if len(e) == 2]
        n = sum(int(np.prod(shape)) for _, shape in layout)
        if device.type == "cuda":
            self.host_t = torch.zeros(n, dtype=torch.int32, pin_memory=True)
            self.buf = torch.zeros(n, dtype=torch.int32, device=device)
        else:
            # the step reads the host buffer itself: nothing to copy
            self.host_t = self.buf = torch.zeros(n, dtype=torch.int32)
        self.host = self.host_t.numpy()
        self.views: Dict[str, torch.Tensor] = {}
        self.host_views: Dict[str, np.ndarray] = {}
        at = 0
        for name, shape in layout:
            k = int(np.prod(shape))
            self.views[name] = self.buf[at:at + k].view(shape)
            self.host_views[name] = self.host[at:at + k].reshape(shape)
            at += k
        for name, shape, dtype in typed:
            self.views[name] = torch.zeros(shape, dtype=dtype, device=device)
        self.out = None
        self.graph = None
        self.launches: Dict[str, int] = {}   # kernel launches per replay
        self.copied = None                   # event after the input copy


class StepGraphs:
    """The engine's step signatures, built once each and then replayed.

    ``spec(sig)`` gives a signature's input layout and its step function,
    which reads only those inputs (by name), the weights and the pages,
    and returns one tensor, a tuple of tensors, or None. ``enabled`` (with a CUDA ``device``)
    captures graphs; otherwise every call dispatches eagerly."""

    def __init__(self, device: torch.device, spec: Spec,
                 enabled: bool = True):
        self.device = device
        self._spec = spec
        self.graphed = bool(enabled) and device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.graphed else None
        self._side = None
        self._failed: Optional[BaseException] = None
        self._buckets: Dict[tuple, _Bucket] = {}
        #: builds (graph captures) over this object's life
        self.builds = 0
        #: calls per signature, and kernel launches per signature by
        #: registry entry (eager warm-ups included): what ran where
        self.calls: "collections.Counter[tuple]" = collections.Counter()
        self.launches: Dict[tuple, "collections.Counter[str]"] = \
            collections.defaultdict(collections.Counter)

    def signatures(self):
        """The signatures built so far."""
        return set(self._buckets)

    # -- build --------------------------------------------------------------

    def build(self, sig: tuple) -> _Bucket:
        """Build ``sig``'s bucket (once): zero inputs, the eager warm-up
        and, on the card, the capture. Raises if the capture fails."""
        b = self._buckets.get(sig)
        if b is not None:
            return b
        if self._failed is not None:
            raise RuntimeError(f"cannot build {sig}: an earlier graph "
                               "capture failed") from self._failed
        layout, fn = self._spec(sig)
        b = _Bucket(layout, fn, self.device)
        recompile.note_capture()
        self.builds += 1
        if not self.graphed:
            self._eager(sig, b)
        else:
            self._capture(sig, b)
        self._buckets[sig] = b
        return b

    def _eager(self, sig, b: _Bucket):
        before = registry.thread_launch_counts()
        out = b.fn(**b.views)
        self.launches[sig].update(
            _delta(registry.thread_launch_counts(), before))
        return out

    def _capture(self, sig, b: _Bucket):
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            y = self._eager(sig, b)          # real launches: counted
        cur.wait_stream(self._side)
        if isinstance(y, tuple):
            b.out = tuple(torch.empty_like(t) for t in y)
        elif y is not None:
            b.out = torch.empty_like(y)      # outside the graph pool
        del y
        graph = torch.cuda.CUDAGraph()
        before = registry.thread_launch_counts()
        try:
            with graph_capture(graph, pool=self.pool):
                y = b.fn(**b.views)
                if isinstance(b.out, tuple):
                    for o, t in zip(b.out, y):
                        o.copy_(t)
                elif b.out is not None:
                    b.out.copy_(y)
                del y
        except Exception as e:
            self._failed = e
            raise
        finally:
            # a capture launches nothing: take its counts back (this
            # thread's: other threads may launch meanwhile)
            b.launches = _delta(registry.thread_launch_counts(), before)
            for name, n in b.launches.items():
                registry.get(name).note_launch(-n)
        b.graph = graph

    # -- call ---------------------------------------------------------------

    def run(self, sig: tuple, feeds: Dict[str, np.ndarray],
            device_feeds: Optional[Dict[str, torch.Tensor]] = None):
        """One call of ``sig`` (built on first use) on ``feeds`` (host
        arrays by input name; inputs left out are 0) and
        ``device_feeds`` (device tensors, or pinned host tensors the
        caller keeps until the call's copies are done, by input name). Returns the
        step's output: on the card with graphs, the bucket's static
        output tensor (or tuple), overwritten by its next call."""
        b = self._buckets.get(sig)
        if b is None:
            b = self.build(sig)
        if b.copied is not None:
            # the last call's copy must have read the pinned buffer
            b.copied.synchronize()
        b.host[:] = 0
        for name, a in feeds.items():
            b.host_views[name][...] = a
        if self.device.type == "cuda":
            b.buf.copy_(b.host_t, non_blocking=True)
            if b.copied is None:
                b.copied = torch.cuda.Event()
            b.copied.record()
        for name, t in (device_feeds or {}).items():
            # a pinned host feed copies asynchronously, in stream order
            b.views[name].copy_(t, non_blocking=True)
        self.calls[sig] += 1
        if b.graph is None:
            return self._eager(sig, b)
        b.graph.replay()
        for name, n in b.launches.items():
            registry.get(name).note_launch(n)
        self.launches[sig].update(b.launches)
        return b.out

    def pool_bytes(self) -> int:
        """Bytes the card holds in the graphs' shared memory pool (0
        without graphs)."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
