"""Parallelism of the port (counterpart of ``bigdl_tpu/parallel``): so far
the local attention core only."""
