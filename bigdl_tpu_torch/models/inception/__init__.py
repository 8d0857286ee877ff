"""Inception model family of the port (counterpart of
``bigdl_tpu/models/inception``): Inception-v1 without auxiliary heads."""
from bigdl_tpu_torch.models.inception.model import (
    Inception_Layer_v1, Inception_v1_NoAuxClassifier)

__all__ = ["Inception_Layer_v1", "Inception_v1_NoAuxClassifier"]
