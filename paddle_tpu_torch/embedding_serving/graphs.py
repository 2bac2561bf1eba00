"""Captured CUDA graphs of the embedding service's device calls: the
port's counterpart of the reference's jit cache, where each gather,
install and forward width is one compiled program.

A :class:`CallGraphs` holds one graph per signature. A signature's static
inputs are device tensors of fixed shape and dtype; a call copies the
host's arrays into them (plain copies from pageable memory, so the
service makes no pinned buffer at all) and replays. Its output, where
the body returns one, is a static tensor outside the shared graph pool,
overwritten by the signature's next call.

Building a signature (its first use, or warmup) runs the body once
eagerly on zero inputs (which the bodies make harmless: zero slots read
and write the null row of the cache) on a side stream, then captures it;
each build counts as one capture, process-wide
(:func:`paddle_tpu_torch.observability.recompile.note_capture`), the
counterpart of one XLA compile. A failed capture raises, and so does
every later build. On the CPU a build is the eager run alone, counted
the same way, and every call runs the body eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.device import counted_capture
from paddle_tpu_torch.observability import recompile

#: input name -> (shape, dtype)
Inputs = Dict[str, Tuple[tuple, torch.dtype]]


class _Call:
    def __init__(self, inputs: Inputs, fn: Callable, device):
        self.fn = fn
        self.views = {name: torch.zeros(shape, dtype=dtype, device=device)
                      for name, (shape, dtype) in inputs.items()}
        self.out: Optional[torch.Tensor] = None
        self.graph = None


class CallGraphs:
    """Signatures built once each, then replayed (module docstring)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graphed = device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.graphed else None
        self._side = None
        self._failed: Optional[BaseException] = None
        self._calls: Dict[tuple, _Call] = {}
        #: builds (captures) over this object's life
        self.builds = 0

    def signatures(self):
        return set(self._calls)

    def build(self, sig: tuple, inputs: Inputs, fn: Callable) -> _Call:
        """Build ``sig`` once: ``fn(**inputs)`` reads only its static
        inputs (and tensors that keep their storage, such as the cache's
        table and the model's weights)."""
        c = self._calls.get(sig)
        if c is not None:
            return c
        if self._failed is not None:
            raise RuntimeError(f"cannot build {sig}: an earlier graph "
                               "capture failed") from self._failed
        c = _Call(inputs, fn, self.device)
        recompile.note_capture()
        self.builds += 1
        if self.graphed:
            self._capture(c)
        else:
            c.fn(**c.views)
        self._calls[sig] = c
        return c

    def _capture(self, c: _Call):
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            y = c.fn(**c.views)
        cur.wait_stream(self._side)
        if y is not None:
            c.out = torch.empty_like(y)      # outside the graph pool
        del y

        def body():
            y = c.fn(**c.views)
            if c.out is not None:
                c.out.copy_(y)

        graph = torch.cuda.CUDAGraph()
        try:
            counted_capture(graph, body, pool=self.pool)
        except Exception as e:
            self._failed = e
            raise
        c.graph = graph

    def run(self, sig: tuple, feeds: Dict[str, np.ndarray],
            inputs: Inputs, fn: Callable):
        """One call of ``sig`` (built on first use from ``inputs`` and
        ``fn``) on ``feeds``, host arrays by input name; an input left
        out keeps its last value. Returns the output: on the card, the
        signature's static output tensor."""
        c = self._calls.get(sig) or self.build(sig, inputs, fn)
        for name, a in feeds.items():
            c.views[name].copy_(torch.from_numpy(a))
        if c.graph is None:
            return c.fn(**c.views)
        c.graph.replay()
        return c.out
