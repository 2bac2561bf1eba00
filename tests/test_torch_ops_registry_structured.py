"""Every registered op of ``ops/{nn,crf,sequence,control_flow,quant,
metrics_ops,niche}.py`` and ``nn/nets.py``'s ``glu`` against the JAX op
on the same numpy inputs (``ops.samples``), on the CPU: floats within
1e-6 abs / 1e-5 rel, integers, bools and indices exactly. The dense op
library's ops are held in ``test_torch_ops_registry.py``, the detection
ops in ``test_torch_detection_ops.py``; the files run on separate
workers."""

import pytest
import torch

import paddle_tpu.nn.nets  # noqa: F401  (registers the reference's glu)
import paddle_tpu.ops  # noqa: F401  (registers the reference's ops)
from paddle_tpu.ops import (control_flow, crf, metrics_ops,  # noqa: F401
                            niche, quant, sequence)
from paddle_tpu_torch.ops import samples
from torch_parity import (DENSE_OPS, DETECTION_OPS, op_equals_the_reference,
                          op_module)

torch.set_num_threads(2)


@pytest.mark.parametrize("name", sorted(
    n for n in samples.SAMPLES
    if op_module(n) not in DENSE_OPS + DETECTION_OPS))
def test_op_equals_the_references(name):
    op_equals_the_reference(name)
