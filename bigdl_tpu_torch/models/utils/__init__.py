"""Shared pieces of the model mains (counterpart of
``bigdl_tpu/models/utils``)."""
