"""Model zoo of the port (counterpart of ``bigdl_tpu/models``)."""
from bigdl_tpu_torch.models.transformer.model import (TransformerBlock,
                                                      TransformerLM)

__all__ = ["TransformerLM", "TransformerBlock"]
