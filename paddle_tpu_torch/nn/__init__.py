from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear
from paddle_tpu_torch.nn.transformer import FeedForward, MultiHeadAttention

__all__ = ["Dropout", "Embedding", "FeedForward", "LayerNorm", "Linear",
           "MultiHeadAttention"]
