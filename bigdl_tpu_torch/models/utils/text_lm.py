"""Shared text-LM data pipeline (counterpart of
``bigdl_tpu/models/utils/text_lm.py``): read -> sentence split ->
tokenize -> pad markers -> Dictionary -> fixed-length samples ->
batches."""
from __future__ import annotations

import os

__all__ = ["build_text_lm_datasets"]


def build_text_lm_datasets(folder: str, vocab_size: int, seq_length: int,
                           batch: int, *, one_hot: bool,
                           dictionary_dir: str | None = None):
    """Returns (train_set, val_set, vocab, dictionary): the first 80 % of
    the samples train, the rest validate. ``one_hot=True`` feeds (T,
    vocab) dense rows; ``one_hot=False`` feeds 1-based token ids."""
    from bigdl_tpu_torch.dataset.dataset import LocalArrayDataSet
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.dataset.text import (Dictionary,
                                              LabeledSentenceToSample,
                                              SentenceBiPadding,
                                              SentenceSplitter,
                                              SentenceTokenizer,
                                              TextToLabeledSentence)
    from bigdl_tpu_torch.dataset.transformer import (SampleToBatch,
                                                     Transformer)

    with open(os.path.join(folder, "input.txt")) as f:
        text = f.read()
    sentences = list(SentenceSplitter()(iter([text])))
    tokens = list(SentenceTokenizer()(iter(sentences)))
    tokens = list(SentenceBiPadding()(iter(tokens)))
    dictionary = Dictionary(tokens, vocab_size)
    dictionary.save(dictionary_dir or folder)
    vocab = dictionary.get_vocab_size() + 1   # + OOV bucket

    class ToTokenIds(Transformer):
        """0-based dictionary indices -> 1-based embedding ids."""

        def __call__(self, it):
            for s in it:
                yield Sample(s.feature.astype("int32") + 1, s.label)

    to_sample = (TextToLabeledSentence(dictionary)
                 >> LabeledSentenceToSample(
                     vocab, fixed_data_length=seq_length,
                     fixed_label_length=seq_length, one_hot=one_hot))
    if not one_hot:
        to_sample = to_sample >> ToTokenIds()
    samples = list(to_sample(iter(tokens)))
    split = max(1, int(len(samples) * 0.8))
    train_set = LocalArrayDataSet(samples[:split]) >> SampleToBatch(
        batch, drop_remainder=True)
    val_set = LocalArrayDataSet(samples[split:] or samples[:1]) \
        >> SampleToBatch(batch)
    return train_set, val_set, vocab, dictionary
