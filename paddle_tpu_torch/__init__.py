"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu`` for one
NVIDIA H100.

Two paths run on the card through hand-written Hopper kernels built from
``csrc/`` at first use: GPT continuous-batching serving over a paged KV
cache (ragged paged decode and prefill attention) and BERT pretraining
(flash attention, forward and backward) through ``train`` and
``trainer``. The recommender front end,
``inference.make_embedding_serving_engine``, serves DeepFM over a host or
remote KV store (``parallel.host_kv``, ``parallel.kv_server``, built from
``native/`` with g++) through a device hot-row cache of captured CUDA
graphs (``embedding_serving``). ``data`` feeds files through the native
MultiSlot feed, the packer and a device loader to the Transformer's
packed training, and ``inference.save_inference_model`` exports a model
with ``torch.export`` for a ``Predictor`` that needs no model class.
The front end around them: ``executor`` (``Program``, ``Executor``),
``config``, ``fleet`` and ``launch`` over ``torch.distributed``,
``metrics``, ``slim``, ``profiler``, ``debug`` and ``testing``.
Entry points run on CUDA unless the
caller asks for ``device="cpu"``; on the CPU every kernel wrapper takes
its plain PyTorch version.
"""

from paddle_tpu_torch.version import __version__
