"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu`` for one
NVIDIA H100.

Two paths run on the card through hand-written Hopper kernels built from
``csrc/`` at first use: GPT continuous-batching serving over a paged KV
cache (ragged paged decode and prefill attention) and BERT pretraining
(flash attention, forward and backward) through ``train`` and
``trainer``. Entry points run on CUDA unless the caller asks for
``device="cpu"``; on the CPU every kernel wrapper takes its plain
PyTorch version.
"""

__version__ = "0.2.0"
