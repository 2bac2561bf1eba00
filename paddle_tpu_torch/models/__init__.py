from paddle_tpu_torch.models.convert import gpt_state_from_jax
from paddle_tpu_torch.models.gpt import GPT, GPTBlock, GPTConfig

__all__ = ["GPT", "GPTBlock", "GPTConfig", "gpt_state_from_jax"]
