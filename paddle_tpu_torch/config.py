"""One typed configuration tree (``paddle_tpu/config.py``): the
reference's gflags, env-var bootstrap and strategy structs as dataclasses
over the port's :class:`~paddle_tpu_torch.core.mesh.MeshConfig`,
overridable from ``PADDLE_TPU_<FLAG>`` environment variables (the same
names as the reference's, so one environment configures either package).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from paddle_tpu_torch.core.mesh import MeshConfig


@dataclasses.dataclass
class ExecutionConfig:
    """Per-step execution knobs (ExecutionStrategy)."""

    # update the train state in place (the reference's buffer donation;
    # the port's train steps always write in place)
    donate_params: bool = True
    # check every output for NaN/Inf (FLAGS_check_nan_inf)
    check_nan_inf: bool = False
    # deterministic algorithms (FLAGS_cudnn_deterministic)
    deterministic: bool = False


@dataclasses.dataclass
class BuildConfig:
    """Build-time knobs (BuildStrategy): the AMP policy, remat and
    gradient accumulation."""

    amp_policy: str = "full"  # "full" | "bf16" | "bf16_full"
    remat: bool = False
    grad_accum_steps: int = 1


@dataclasses.dataclass
class DistributedConfig:
    """The mesh and the process group's bootstrap (DistributedStrategy):
    ``coordinator_address`` is ``host:port`` of rank 0's TCP store."""

    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0


@dataclasses.dataclass
class Config:
    execution: ExecutionConfig = dataclasses.field(
        default_factory=ExecutionConfig)
    build: BuildConfig = dataclasses.field(default_factory=BuildConfig)
    distributed: DistributedConfig = dataclasses.field(
        default_factory=DistributedConfig)
    seed: int = 0


_GLOBAL = Config()


def global_config() -> Config:
    return _GLOBAL


def set_flags(**kwargs):
    """Flat flag setter (fluid's ``FLAGS_*`` surface), e.g.
    ``set_flags(check_nan_inf=True, amp_policy="bf16")``: each name is
    looked up in the execution, build and distributed sections, then on
    the config itself; an unknown name raises ValueError."""
    for k, v in kwargs.items():
        for section in (_GLOBAL.execution, _GLOBAL.build,
                        _GLOBAL.distributed):
            if hasattr(section, k):
                setattr(section, k, v)
                break
        else:
            if hasattr(_GLOBAL, k):
                setattr(_GLOBAL, k, v)
            else:
                raise ValueError(f"unknown flag {k!r}")


def _parse(val: str):
    if val.lower() in ("true", "false"):
        return val.lower() == "true"
    for kind in (int, float):
        try:
            return kind(val)
        except ValueError:
            pass
    return val


def _bootstrap_from_env(environ=None):
    """``PADDLE_TPU_<FLAG>=value`` overrides (fluid's ``__bootstrap__``):
    booleans, ints and floats parsed, anything else a string; a variable
    that names no flag is ignored."""
    prefix = "PADDLE_TPU_"
    for key, val in (os.environ if environ is None else environ).items():
        if not key.startswith(prefix):
            continue
        try:
            set_flags(**{key[len(prefix):].lower(): _parse(val)})
        except ValueError:
            pass  # another variable sharing the prefix


_bootstrap_from_env()
