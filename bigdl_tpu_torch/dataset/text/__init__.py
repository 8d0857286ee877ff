"""Text data pipeline of the port (counterpart of
``bigdl_tpu/dataset/text``)."""
from bigdl_tpu_torch.dataset.text.transforms import (
    Dictionary, LabeledSentenceToSample, SentenceBiPadding, SentenceSplitter,
    SentenceToken, SentenceTokenizer, TextToLabeledSentence)

__all__ = ["Dictionary", "SentenceToken", "SentenceSplitter",
           "SentenceTokenizer", "SentenceBiPadding", "TextToLabeledSentence",
           "LabeledSentenceToSample"]
