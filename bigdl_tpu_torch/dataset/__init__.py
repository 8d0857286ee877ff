"""Data pipeline of the port (counterpart of ``bigdl_tpu/dataset``): the
in-memory path the text LM trains from."""
from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet,
                                             LocalArrayDataSet,
                                             TransformedDataSet)
from bigdl_tpu_torch.dataset.sample import (LabeledSentence, MiniBatch,
                                            Sample)
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 SampleToBatch, Transformer)

__all__ = ["Sample", "MiniBatch", "LabeledSentence", "Transformer",
           "ChainedTransformer", "SampleToBatch", "AbstractDataSet",
           "TransformedDataSet", "LocalArrayDataSet"]
