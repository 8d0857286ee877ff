from bigdl_tpu_torch.models.transformer.generate import GenerationConfig
from bigdl_tpu_torch.models.transformer.model import (TransformerBlock,
                                                      TransformerLM)

__all__ = ["TransformerBlock", "TransformerLM", "GenerationConfig"]
