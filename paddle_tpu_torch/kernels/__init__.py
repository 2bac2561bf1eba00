"""Kernel layer: the registry of hand-written Hopper kernels and the
``nvcc`` build that produces them."""

from paddle_tpu_torch.kernels.registry import (KernelEntry, get, load_all,
                                               names, register,
                                               reset_launches)

__all__ = ["KernelEntry", "get", "load_all", "names", "register",
           "reset_launches"]
