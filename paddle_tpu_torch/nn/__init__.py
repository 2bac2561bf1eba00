from paddle_tpu_torch.nn import initializer
from paddle_tpu_torch.nn.layers import (Dropout, Embedding, LayerNorm, Linear,
                                        dropout)
from paddle_tpu_torch.nn.transformer import (FeedForward, MultiHeadAttention,
                                             TransformerEncoderLayer)

__all__ = ["Dropout", "Embedding", "FeedForward", "LayerNorm", "Linear",
           "MultiHeadAttention", "TransformerEncoderLayer", "dropout",
           "initializer"]
