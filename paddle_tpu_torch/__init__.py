"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu`` for one
NVIDIA H100.

The serving main path (GPT continuous batching over a paged KV cache)
runs on the card through hand-written Hopper kernels built from
``csrc/`` at first use. Entry points run on CUDA unless the caller asks
for ``device="cpu"``; on the CPU every kernel wrapper takes its plain
PyTorch version.
"""

__version__ = "0.1.0"
