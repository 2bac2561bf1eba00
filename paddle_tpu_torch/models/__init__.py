from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                          BertModel)
from paddle_tpu_torch.models.convert import gpt_state_from_jax, state_from_jax
from paddle_tpu_torch.models.gpt import GPT, GPTBlock, GPTConfig
from paddle_tpu_torch.models.transformer import Transformer, TransformerConfig

__all__ = ["BertConfig", "BertForPretraining", "BertModel", "GPT", "GPTBlock",
           "GPTConfig", "Transformer", "TransformerConfig",
           "gpt_state_from_jax", "state_from_jax"]
