from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.dtypes import Policy, get_policy

__all__ = ["Policy", "get_policy", "resolve_device"]
