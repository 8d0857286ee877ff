"""Deterministic RNG for host-side code: data shuffling (counterpart of
``bigdl_tpu/utils/random.py``).

The same seeded numpy MT19937 streams as the JAX package, so a port run
and a JAX run seeded alike visit the data in the same order. Weights are
drawn from ``torch.Generator``s instead (``nn/init.py``).
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["RandomGenerator"]


class RandomGenerator:
    """Thread-local seeded MT19937."""

    _local = threading.local()
    _default_seed = 1

    def __init__(self, seed: int | None = None):
        self._rng = np.random.Generator(np.random.MT19937(
            seed if seed is not None else self._default_seed))

    @classmethod
    def RNG(cls) -> "RandomGenerator":
        """This thread's generator, made from the default seed on first
        use."""
        inst = getattr(cls._local, "inst", None)
        if inst is None:
            inst = cls(cls._default_seed)
            cls._local.inst = inst
        return inst

    @classmethod
    def set_seed(cls, seed: int) -> "RandomGenerator":
        cls._default_seed = seed
        return cls.seed_thread(seed)

    @classmethod
    def seed_thread(cls, seed: int) -> "RandomGenerator":
        """Seed only the calling thread's generator (the class default
        stays untouched)."""
        cls._local.inst = cls(seed)
        return cls._local.inst

    def shuffle(self, seq):
        """In-place Fisher-Yates."""
        self._rng.shuffle(seq)
        return seq
