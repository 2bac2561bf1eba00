from paddle_tpu_torch.ops.activation import gelu
from paddle_tpu_torch.ops.attention import (NEG_INF, dot_product_attention,
                                            flash_attention, make_padding_bias,
                                            scaled_dot_product_attention)
from paddle_tpu_torch.ops.nn import sigmoid_cross_entropy_with_logits

__all__ = ["gelu", "NEG_INF", "dot_product_attention", "flash_attention",
           "make_padding_bias", "scaled_dot_product_attention",
           "sigmoid_cross_entropy_with_logits"]
