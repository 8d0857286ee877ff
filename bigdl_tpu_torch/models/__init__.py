"""Model zoo of the port (counterpart of ``bigdl_tpu/models``)."""
from bigdl_tpu_torch.models.inception.model import (
    Inception_Layer_v1, Inception_v1_NoAuxClassifier)
from bigdl_tpu_torch.models.transformer.model import (TransformerBlock,
                                                      TransformerLM)

__all__ = ["TransformerLM", "TransformerBlock", "Inception_Layer_v1",
           "Inception_v1_NoAuxClassifier"]
