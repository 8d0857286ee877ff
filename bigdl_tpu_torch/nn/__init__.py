"""Module library of the port (counterpart of ``bigdl_tpu/nn``): the
modules and criteria the transformer LM and Inception-v1 serve and train
with."""
from bigdl_tpu_torch.nn.activations import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.attention import MultiHeadAttention, apply_rope
from bigdl_tpu_torch.nn.containers import Concat, Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          CrossEntropyCriterion)
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Container, Criterion, Module
from bigdl_tpu_torch.nn.normalization import (LayerNorm, ReLUCrossMapLRN,
                                              SpatialCrossMapLRN)
from bigdl_tpu_torch.nn.pooling import (SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.structural import View

__all__ = ["Module", "Container", "Criterion", "Sequential", "Concat",
           "Linear", "SpatialConvolution", "SpatialMaxPooling",
           "SpatialAveragePooling", "LayerNorm", "SpatialCrossMapLRN",
           "ReLUCrossMapLRN", "ReLU", "LogSoftMax", "Dropout", "View",
           "MultiHeadAttention", "apply_rope", "ClassNLLCriterion",
           "CrossEntropyCriterion"]
