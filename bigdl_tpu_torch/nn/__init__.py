"""Module library of the port (counterpart of ``bigdl_tpu/nn``): the
modules and the criterion the transformer LM serves and trains with."""
from bigdl_tpu_torch.nn.activations import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.attention import MultiHeadAttention, apply_rope
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Container, Criterion, Module
from bigdl_tpu_torch.nn.normalization import LayerNorm

__all__ = ["Module", "Container", "Criterion", "Sequential", "Linear",
           "LayerNorm", "ReLU", "LogSoftMax", "MultiHeadAttention",
           "apply_rope", "CrossEntropyCriterion"]
