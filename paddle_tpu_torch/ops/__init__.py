from paddle_tpu_torch.ops.activation import gelu
from paddle_tpu_torch.ops.attention import (NEG_INF, dot_product_attention,
                                            flash_attention, make_padding_bias,
                                            scaled_dot_product_attention)

__all__ = ["gelu", "NEG_INF", "dot_product_attention", "flash_attention",
           "make_padding_bias", "scaled_dot_product_attention"]
