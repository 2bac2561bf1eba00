"""The state tape (``nn.module.capture_state``) of concurrent train steps.

Two threads each run ``build_train_step`` on a BatchNorm model of their
own, at once, under a short switch interval: each model's running
statistics and parameters equal those of the same steps run one thread
after the other, bit for bit, with and without remat (whose recompute
in the backward must report to its own step's tape). The reference keeps
its tape per thread (``paddle_tpu/nn/module.py`` ``_StateTape``)."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch import nn

from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.nn.layers import BatchNorm, Linear
from paddle_tpu_torch.nn.module import capture_state, report_state
from paddle_tpu_torch.train import build_train_step, make_train_state

torch.set_num_threads(1)

STEPS = 25


class _Net(nn.Module):
    """Three Linear + BatchNorm blocks on (B, 8) rows."""

    def __init__(self, seed):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.lins = nn.ModuleList([Linear(8, 8, device="cpu")
                                   for _ in range(3)])
        self.bns = nn.ModuleList([BatchNorm(8, device="cpu")
                                  for _ in range(3)])
        for lin in self.lins:
            lin.reset_parameters(gen)

    def loss(self, x):
        for lin, bn in zip(self.lins, self.bns):
            x = torch.relu(bn(lin(x)))
        return (x ** 2).mean()


def _run(seed, remat, barrier=None):
    model = _Net(seed)
    opt = popt.SGD(model.parameters(), learning_rate=0.1)
    step = build_train_step(lambda m, x: m.loss(x), opt, remat=remat)
    state = make_train_state(model, opt)
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.standard_normal((16, 8), np.float32))
          for _ in range(STEPS)]
    if barrier is not None:
        barrier.wait(timeout=30)
    for x in xs:
        step(state, x=x)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("remat", [False, True])
def test_two_threads_step_as_one_after_the_other(remat):
    want = [_run(seed, remat) for seed in (1, 2)]
    got, errors = [None, None], []
    barrier = threading.Barrier(2)

    def work(i, seed):
        try:
            got[i] = _run(seed, remat, barrier)
        except BaseException as e:       # reported below, with the name
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i, seed))
                   for i, seed in enumerate((1, 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for i in range(2):
        for k, v in want[i].items():
            assert torch.equal(got[i][k], v), (i, k)


def test_a_capture_in_one_thread_is_not_seen_in_another():
    """A forward in another thread while this thread's capture is open
    writes its own buffers in place and leaves this tape empty."""
    bn = BatchNorm(4, device="cpu")
    seen = {}

    def other():
        seen["reported"] = report_state(bn, {"mean": torch.ones(4)})

    with capture_state() as tape:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen["reported"] is False
    assert tape.updates == {}
