"""Shared CLI plumbing for the model train mains (counterpart of
``bigdl_tpu/models/utils/cli.py``): the common flags -f/--folder,
-b/--batchSize, --model/--state snapshots, --checkpoint, --overWrite,
--maxEpoch, --learningRate, --chips. The mesh builder ``init_engine`` is
not ported: multi-card training is ROADMAP.md queue A, Multi-card."""
from __future__ import annotations

import argparse
import logging

__all__ = ["base_train_parser", "setup_logging"]


def setup_logging():
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s - %(message)s")


def base_train_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-f", "--folder", default="./",
                   help="where the training data lives")
    p.add_argument("-b", "--batchSize", type=int, default=None,
                   help="global batch size")
    p.add_argument("--model", default=None,
                   help="model snapshot to resume from")
    p.add_argument("--state", default=None,
                   help="state snapshot to resume from")
    p.add_argument("--checkpoint", default=None,
                   help="where to cache the model/state each epoch")
    p.add_argument("--overWrite", action="store_true",
                   help="overwrite existing checkpoint files")
    p.add_argument("-e", "--maxEpoch", type=int, default=None)
    p.add_argument("-r", "--learningRate", type=float, default=None)
    p.add_argument("--chips", type=int, default=None,
                   help="devices to train on (only 1 is ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    return p
