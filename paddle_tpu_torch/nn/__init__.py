from paddle_tpu_torch.nn import initializer
from paddle_tpu_torch.nn.layers import (FC, Dropout, Embedding, LayerNorm,
                                        Linear, dropout)
from paddle_tpu_torch.nn.module import (LayerList, Sequential, capture_state,
                                        report_state)
from paddle_tpu_torch.nn.transformer import (FeedForward, MultiHeadAttention,
                                             TransformerDecoderLayer,
                                             TransformerEncoderLayer)

__all__ = ["FC", "Dropout", "Embedding", "FeedForward", "LayerList",
           "LayerNorm", "Linear", "MultiHeadAttention", "Sequential",
           "TransformerDecoderLayer", "TransformerEncoderLayer",
           "capture_state", "dropout", "initializer", "report_state"]
