"""Model layer of the port: the Llama, Gemma-2 and Mixtral-style MoE
families' building blocks (`llama`, `gemma`, `moe`), the serving steps
(`serving`) and the continuous-batching engine (`engine`)."""

from metal_flash_attention_tpu_torch.models import moe

__all__ = ["moe"]
