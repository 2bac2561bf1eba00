from paddle_tpu_torch.ops.activation import gelu
from paddle_tpu_torch.ops.attention import NEG_INF, scaled_dot_product_attention

__all__ = ["gelu", "NEG_INF", "scaled_dot_product_attention"]
