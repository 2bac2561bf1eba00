"""Kernel layer: the registry of hand-written Hopper kernels and their
contracts, the ``nvcc`` build that produces them, the parity battery
(``harness``), the launch-tunable autotuner (``autotune``) and the
registry lint (``lint``)."""

from paddle_tpu_torch.kernels.registry import (KernelContract, KernelEntry,
                                               get, load_all, names,
                                               register, reset_launches)

__all__ = ["KernelContract", "KernelEntry", "get", "load_all", "names",
           "register", "reset_launches"]
