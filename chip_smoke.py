#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one NVIDIA
card: build every kernel from the checkout's sources (one nvcc per
source, all at once), count the tensor-core instructions in the SASS
of the tensor-core kernels (none fails the run), and hold each kernel
against its plain PyTorch version at the shapes its path gives it, then
drive the main paths end to end at
the full width of the flagship LM with weights made from a seed:

- ``[serve]``: 16 requests through ``ContinuousBatcher`` (d_model 1024,
  12 layers, 8 heads, 2 kv heads, RoPE, vocab 32768) — paged attention:
  the split-KV decode kernel and the tensor-core prefill kernel; five
  tails serve 4 requests each against the dense plain path: through
  pages of 256 slots and of 300 (prefill on the tensor cores, which pad
  such a page to 304 slots), at Qwen2.5-7B's attention width (G 7:
  prefill on the tensor cores, decode on the split-KV kernel), at
  Falcon-7B's (G 71, folded flat: prefill and decode, 71 rows a step,
  on the tensor cores) and at Phi-3-mini's (head dim 96, run at 128
  inside the kernels: prefill on the tensor cores, decode on the
  split-KV kernel);
- ``[train]``: the port's train main (``models/transformer/train.py``)
  on a generated text, at the ``bench.py:1040-1063`` training geometry
  (learned positions, full MHA, batch 4 x 2048, bf16 policy) for two
  epochs — flash attention forward, dq and dkdv — then one epoch at head
  dim 256 (``--numHeads 4``) and one at head dim 16 (``--dModel 128
  --numHeads 8``, which the flash entry pads to 32);
- ``[perf]``: the throughput harness (``models/utils/perf.py -m
  transformer``) at the same geometry with the fused LM head + CE — the
  fused-CE forward, dh and dW/db kernels (and flash attention) — then
  its ``-m attention`` mode at head dims 128, 256, 96 (Phi-3-mini's,
  padded to 128) and 512 (the sliced tensor-core flash forward, dq and
  dk/dv), and at 512 in f32 (the 3xTF32 forward, dq and dk/dv); then
  ``-m transformer --dataType f32`` at the same geometry (the f32
  fused-CE forward, dh and dW/db and flash's forward, dq and dk/dv in
  3xTF32 on the tensor cores);
- ``[inception]``: the harness's ``-m inception_v1`` at the
  ``bench.py:109-202`` geometry (batch 256, 224x224, 1000 classes, bf16
  policy, SGD with momentum) — the LRN forward and backward kernels
  (windows of 5: every backward on the "staged" route's register rings;
  the tiled forward past window 9, the backward past window 9 and the
  "any" backward must launch 0 times there, counted apart). The LRN
  kernels are also held at AlexNet's odd planes, windows 9 and 10,
  misaligned tensors and past the staged route's cap, at windows wider
  than C and in the "any" backward's two-launch form (``_LRN_CASES``).
  The opt-in 3x3 / stride-1 max-pool backward kernel is held against its
  plain version at the in-block pools' shapes, on -inf planes, on a
  plane past its whole-plane cap and on an odd plane, timed at the nine
  in-block pools' shapes, and must launch 0 times there.

    python3 chip_smoke.py [--seed N]

Run it from the root of a checkout. It prints one line per phase, the
run's wall time, a ``{"kernels": [...]}`` line, the card's name and
power limit, and last
``{"ok": true, "device": {...}}``. Any failure raises before that line
and exits non-zero; without CUDA it exits non-zero and prints no result.
It imports nothing of JAX or of ``bigdl_tpu``.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# the card's published peaks (H100 SXM data sheet), for the bounds
_HBM_BYTES_PER_S = 3.35e12
_BF16_FLOPS = 989e12
_F32_FLOPS = 67e12          # CUDA-core f32 (the f32 kernels do f32 math)
_TF32_FLOPS = 495e12        # tensor-core TF32 (3xTF32: 3 products a multiply)
_FLUSH_BYTES = 256 << 20    # > 50 MB L2, and long enough to hide launches
_DEV = "cuda"

# flagship LM geometry (bench.py's transformer row, docs/PERF.md)
_LM = dict(vocab_size=32768, d_model=1024, num_heads=8, num_layers=12,
           max_len=2048, with_log_softmax=False, pos_encoding="rope",
           num_kv_heads=2)
_H, _KV, _D, _S = 8, 2, 128, 16
#: paged kernel vs plain, element by element: |kernel - plain| <=
#: rtol·|plain| + atol·rms(plain's row), the rms over the query row's
#: heads and dims (a decode row at L keys has |o| about sqrt(e/L), 0.05
#: at L = 1100 against 0.4 at L = 16, so one rms over all rows would
#: hold the long rows only as loosely as the old flat 1e-2 did). Both
#: sides are f32 outputs of bf16 operands and round the softmax weights
#: to bf16 before P·V — the kernel unnormalised running weights, the
#: plain version normalised ones — so each weight may differ by one
#: bf16 rounding (2^-8 relative); summed over the row's keys with
#: random signs that moves an element by about 2^-8·rms(row) at most
#: a few times over: 0.05·rms is about ten times that, and an element
#: whose f32 sums differ only in order is within 2^-7·|plain|. f32
#: pools round nothing: sum order alone. (rtol, atol) by pool dtype.
_PAGED_TOL = {torch.bfloat16: (2 ** -7, 0.05),
              torch.float32: (1e-5, 1e-4)}
#: the tensor-core prefill kernel vs ``paged_attention_tile_ref`` at its
#: 64-key tiles, element by element as ``_PAGED_TOL``. Both round p to
#: bf16 at the same running max of the same tiles, so they differ only
#: where the tensor cores' f32 sums of a score (in another order than the
#: plain version's) move p across a bf16 rounding boundary, which few
#: weights lie close enough to. A flip moves its term by at most 2^-7 of
#: it, an element by at most 2^-7·w·|v| for a weight w <= sqrt(sum w^2)
#: of the row, so by some 0.035·rms(row) at the worst (|v| at 4.5 sigma),
#: 2^-5; the f32 sums alone differ by far less than 2^-8·|plain|. Against
#: ``_PAGED_TOL``'s (2^-7, 0.05), which also covers rounding at another
#: point: (rtol, atol). The row-tile kernel against
#: ``paged_attention_row_ref`` (its 8-key groups a page) is held the
#: same way: the same roundings at the same running max, its dot products
#: summed in another order (a warp's shuffle tree).
_PAGED_TILE_TOL = (2 ** -8, 2 ** -5)
#: keys of a row's gathered view up to which the row-tile kernel is also
#: held against ``paged_attention_row_ref`` (a loop over 8-key groups)
_ROW_REF_MAX_KEYS = 4096
#: prompt buckets of the batcher the prefill sweep runs
_PREFILL_BUCKETS = (32, 128, 512, 1024)
#: kernel vs dense serving prefill logits: both run the bf16 policy, the
#: attention outputs are rounded to bf16 before the residual add, so a
#: few elements round to the neighbouring bf16 value and the difference
#: travels through 12 blocks; bounded relative to the logits' scale
_LOGIT_REL_TOL = 0.1

# the training geometry (bench.py:1040-1063, learned positions, full MHA)
_TRAIN = dict(vocab=32768, d_model=1024, heads=8, layers=12, seq=2048,
              batch=4, epochs=2)
# the same at head dim 256 (4 heads, as Gemma's heads are wide): one
# epoch of 4 steps
_TRAIN_WIDE = dict(_TRAIN, heads=4, epochs=1)
# the train main's default width (--dModel 128) at --numHeads 8: head
# dim 16, which the flash kernels run zero-padded to 32; one epoch
_TRAIN_NARROW = dict(_TRAIN, d_model=128, heads=8, epochs=1)
# flash at head dims the kernels run zero-padded (``padded_head_dim``),
# timed: the [train] narrow run's shape (D 16 -> 32), Phi-3-mini's
# attention (32 heads of 96 -> 128) and Phi-2's (32 of 80 -> 128), at
# batch 2 and length 2048
_FLASH_PADDED = (dict(batch=4, seq=2048, heads=8, head_dim=16),
                 dict(batch=2, seq=2048, heads=32, head_dim=96),
                 dict(batch=2, seq=2048, heads=32, head_dim=80))
# the flash kernels past D 128 timed at the training batch and length,
# and the D-sliced kernels at D 512 (2 heads, batch 2)
_FLASH_WIDE = dict(batch=4, seq=2048, heads=4, head_dim=256)
_FLASH_SLICED = dict(batch=2, seq=2048, heads=2, head_dim=512)
# bf16 flash held in full at the width where one flipped rounding read
# past the old gradient limit (B4 S2048 H16 D64, ``_FLASH_TOL``)
_FLASH_NARROW = dict(batch=4, seq=2048, heads=16, head_dim=64)
# the serving tails, 4 requests of 16 new tokens each: (label, the LM
# (None: [serve]'s own model, else the widths of another one, built from
# the seed at ``_LM``'s vocab, max_len, RoPE and ffn_mult 4), page size,
# prompt lengths (None: 4 drawn from the seed in 300..1000)). Pages of
# 256 slots and of 300 (S % 8 != 0: padded to 304 in the tensor-core
# kernel's walk), whose prompts span two to four pages; Qwen2.5-7B's
# attention (d_model 3584, 28 heads over 4 kv heads: G 7, padded to 8;
# 4 of its 28 layers, the LM's own FFN) through pages of 16, prefill on
# the tensor cores and decode (T·G 7) on the split-KV kernel; and
# Falcon-7B's (d_model 4544, 71 heads over one kv head, D 64; 2 of its
# 32 layers), whose G past 64 the tensor-core kernel folds flat: every
# call, decode too (T·G 71), on the tensor cores; and Phi-3-mini's
# (d_model 3072, 32 heads over 32 kv heads, D 96; 2 of its 32 layers),
# whose head dim the kernels run at 128 with zero columns past 96:
# prefill on the tensor cores, decode (T·G 1) on the split-KV kernel;
# and a synthetic head dim of 512 (d_model 1024, 2 heads over one kv
# head: G 2; no public model runs a head dim past 256), there to put the
# sliced tensor-core prefill on the batcher's path: every call, decode
# (T·G 2) too, "tc_sliced"
_SERVE_TAILS = (
    ("pages of 256", None, 256, (300, 520, 777, 1000)),
    ("pages of 300", None, 300, (300, 520, 777, 1000)),
    ("Qwen2.5-7B attention", dict(d_model=3584, num_heads=28,
                                  num_kv_heads=4, num_layers=4), 16, None),
    ("Falcon-7B attention", dict(d_model=4544, num_heads=71,
                                 num_kv_heads=1, num_layers=2), 16, None),
    ("Phi-3-mini attention", dict(d_model=3072, num_heads=32,
                                  num_kv_heads=32, num_layers=2), 16, None),
    ("head dim 512", dict(d_model=1024, num_heads=2, num_kv_heads=1,
                          num_layers=2), 16, None),
)
_TAIL_REQUESTS, _TAIL_NEW_TOKENS = 4, 16
#: flash kernel vs plain, element by element: |kernel - plain| <=
#: rtol·|plain| + atol·rms(plain), the rms over the whole output, as
#: (rtol, atol) by dtype and output. bf16: where the f32 sums differ in
#: order an element rounds at most one bf16 step (2^-7·|plain|) away. o
#: also differs before rounding: the forward rounds P to bf16 at each
#: tile's running max, the plain version at the row's final max (2^-8
#: relative per weight, so about 0.3 % of a row's typical |o|); 0.05·rms
#: is some ten times the largest such difference expected at the train
#: shapes, where a typical late row's |o| is itself about 0.4·rms. The
#: bf16 backward rounds P and dS from scores that its tensor cores sum in
#: another order than the plain version's f32 products (last-bit
#: differences), so the few P or dS lying that close to a bf16 rounding
#: boundary round to the neighbouring value: its
#: term of dq/dk/dv moves by one bf16 step of the term (up to 2^-8 of
#: P·|dO| for a P near 1, up to 2^-7 of a large dS·|k|). Where one such
#: term dominates an element this adds a step to the element's own
#: rounding step: rtol two steps, 2^-6. Elsewhere a few flipped terms of
#: a sum of up to 2048 land on elements of any size, small ones too: at
#: B4 S2048 H8 D128 they read 0.75-1.37 x the old limit (2^-7, 2^-7),
#: which rested on bit-equal P and dS as the CUDA-core kernels' FMA
#: chains gave (scripts/flash_fault_check.py, seeds 0-5), and 3.06 x it
#: on this script's own draw: atol 2^-4 (0.0625·rms) puts them at 0.2-0.6
#: of the limit, while a wrong dO tile in dk/dv reads 25-70 x it (the
#: same script). f32 rounds nothing: sum order alone. lse is f32 on both
#: sides and held absolutely.
#:
#: bf16 gradients at head dims of 64 and below: atol 2^-3. A flipped P of
#: an early query row (P 0.25-1, one bf16 step 2^-9-2^-8 of it) moves its
#: dv element by up to 2^-8·|dO|, some 0.011 at |dO| 2.8: past
#: 2^-4·rms (0.0058, rms 0.092) where that element is small. Whether a
#: draw holds such a flip is a lottery over the B·H early rows, and the
#: port's widths fix H·D (d_model 1024: H 16 at D 64, 32 at D 32, 8 at D
#: 128), so at D 64 a run holds twice the tickets of D 128 and at D 32
#: four times. Measured (scripts/flash_fault_check.py, B4 S2048 causal,
#: NVIDIA H100 80GB HBM3 at 700 W): the sound dv read 0.28-0.42 of the 2^-4 limit over seeds
#: 0-29 at H16 D64 and seeds 0-5 at H8 D64, H32 D32, H8 and H16 D128;
#: flash_ab.py's own draw at H16 D64 read 1.476, its worst element
#: (key 1, plain -0.119) off by 0.01123 where the terms whose P lies
#: within 2^-16 of a bf16 rounding midpoint could move it by 0.01092
#: plus one output step (0.00049): one flipped P, no fault. 2^-3 puts that
#: draw at 0.84 and the sound gradients of seeds 0-5 at H8 and H16 D64 at
#: 0.13-0.36, while the planted do_prev_tile fault reads 11.6-47 x it
#: there (at D 32, where no element's limit more than doubles, it read
#: 38.7-87 x the 2^-4 limit). D 128 and past keep 2^-4 (the planted
#: fault 24.6-84 x it).
_FLASH_TOL = {(torch.bfloat16, "o"): (2 ** -7, 0.05),
              (torch.bfloat16, "grad"): (2 ** -6, 2 ** -4),
              (torch.float32, "o"): (1e-5, 1e-4),
              (torch.float32, "grad"): (1e-5, 1e-4)}
_FLASH_NARROW_GRAD_TOL = (2 ** -6, 2 ** -3)
_LSE_TOL = 1e-4
#: kernel vs flash=False on one training batch under the bf16 policy:
#: both round attention outputs to bf16; the kernel rounds P and dS to
#: bf16 before their products where the plain path keeps f32, so the
#: loss (about 10.4) moves in its 5th digit or later, and a gradient
#: element by a few bf16 steps of the gradients through 12 blocks,
#: bounded relative to the largest element
_TRAIN_LOSS_TOL = 1e-3
_TRAIN_GRAD_REL_TOL = 5e-2

# the fused-CE kernels at the harness's head: B4 x S2048 rows of the
# d1024 LM against its 32768-word vocab; the tails case has GPT-2's
# vocab and a row count that no tile divides; two small cases take the
# kernels' other widths: D 72 (bf16 forward: two 64-column boxes, most
# of the second zero fill; bf16 backward: three of a cluster's four
# feature slices empty; f32 backward: one 64-column chunk a CTA, score
# steps past D read as zeros) and D 1032 (bf16 forward: 17 boxes; past
# the bf16 backward cluster path's 1024: the chunked passes, one chunk,
# pass 2's last column tile 8 columns wide; the f32 backward: two
# clusters a row block, each forming the logits over all of D); the
# ragged case takes the bf16 chunked passes past D 2048 with GPT-2's
# vocab (no multiple of 8: dl's padded pitch, the masks past V and N)
# and dh in three chunks of token rows, the last 440 rows, no multiple of
# 128
_FCE_CASES = (("main", 8192, 32768, 1024), ("tails", 1000, 50257, 1024),
              ("narrow", 300, 1000, 72), ("wide", 300, 1000, 1032),
              ("ragged", 3000, 50257, 2056))
# a feature width no multiple of 8, which ``linear_cross_entropy`` pads
# with zero columns to 1032 for the kernels: (label, N, V, D)
_FCE_PADDED = ("padded", 300, 1000, 1028)
#: fused-CE kernel vs plain, element by element as the flash outputs:
#: (rtol, atol) for |kernel - plain| <= rtol·|plain| + atol·rms(plain).
#: Both sides take f32 sums of the same products (exact in f32) and round
#: dlogits to the operand dtype at the same points; the sums differ in
#: order (tensor-core or CUDA-core tiles against cuBLAS), so a bf16 dh
#: or dW element rounds at most one bf16 step (<= 2^-7·|plain|) away,
#: and f32 outputs and the f32 db differ by a few f32 steps of the sum.
#: nll and lse (about 10.4, f32 on both sides, from logits whose sums
#: differ in order by ~1e-6) are held absolutely at 1e-4, about 100
#: f32 steps.
_FCE_TOL = {torch.bfloat16: (2 ** -7, 2 ** -7), torch.float32: (1e-5, 1e-4)}
_FCE_DB_TOL = (1e-5, 1e-4)
_FCE_ABS_TOL = 1e-4
#: the fused head + CE against the unfused one (``--fusedHeadLoss off``)
#: on one harness batch under the bf16 policy: the unfused LM head adds
#: the bias in bf16 and rounds its logits to bf16 (2^-9 relative, logits
#: of order 1) before the f32 CE, where the fused kernels keep them f32;
#: the loss (about 10.4) averages those roundings over 8192 rows, a
#: gradient element moves by a few bf16 steps through 12 blocks, bounded
#: relative to the largest element
_PERF_LOSS_TOL = 2e-3
_PERF_GRAD_REL_TOL = 5e-2
# the harness run: bench.py:1040-1063's geometry, 2 warm-up steps and 8
# timed ones
_PERF = dict(batch=4, seq=2048, vocab=32768, d_model=1024, layers=12,
             warm_up=2, iterations=8)


# the harness's attention mode at the long-context shape it defaults to
# (B4 S4096 H8 D128), at head dim 256 (4 heads), at Phi-3-mini's
# attention (32 heads of 96, run zero-padded to 128; B2 S2048, the shape
# [kernels] times it at) and at 512 (2 heads: the D-sliced kernels; the
# last, as ``_flash_main_shape`` reads it)
_PERF_ATTENTION = (dict(batch=4, seq=4096, heads=8, head_dim=128),
                   dict(batch=4, seq=4096, heads=4, head_dim=256),
                   dict(batch=2, seq=2048, heads=32, head_dim=96),
                   dict(batch=4, seq=4096, heads=2, head_dim=512))
# and its f32 run at D 512 (``--dataType f32``: the 3xTF32 forward, dq
# and dk/dv), the width the train mains' default f32 policy takes past
# head dim 256
_PERF_ATTENTION_F32 = _PERF_ATTENTION[-1]

# the LRN kernels: norm1 and norm2 of Inception-v1 at batch 256 (the
# path's rows, bf16, fused ReLU, size 5, alpha 1e-4, beta 0.75, k 1), the
# same in f32, and a ragged case (odd N, C not a multiple of 8, H·W not
# a multiple of the 4-wide vectors, an even window, no ReLU, a larger
# alpha so the normalisation is far from the identity); each case runs
# in bf16 and f32, and every backward on the route ops.lrn.bwd_route
# names
_LRN_ARGS = dict(size=5, alpha=1e-4, beta=0.75, k=1.0, relu=True)
_ALEXNET_LRN = dict(size=5, alpha=1e-4, beta=0.75, k=1.0, relu=False)
_LRN_CASES = (("norm1", (256, 64, 56, 56), _LRN_ARGS),
              ("norm2", (256, 192, 56, 56), _LRN_ARGS),
              ("ragged", (3, 13, 5, 7),
               dict(size=4, alpha=0.5, beta=0.75, k=1.0, relu=False)),
              # windows past 9 (the tiled forward; the staged backward's
              # runtime-window form): 11 at norm2's
              # channels and 16 (even: the JAX window's asymmetry) without
              # ReLU, at batch 32, and 16 at a ragged shape narrower than
              # the window
              ("size11", (32, 192, 56, 56), dict(_LRN_ARGS, size=11)),
              ("size16", (32, 64, 56, 56),
               dict(size=16, alpha=1e-2, beta=0.75, k=2.0, relu=False)),
              ("ragged16", (3, 13, 5, 7),
               dict(size=16, alpha=0.5, beta=0.75, k=1.0, relu=True)),
              # AlexNet's norm1 and norm2 (bigdl_tpu/models/alexnet/
              # model.py:56,61 at a 227x227 input, batch 128): odd planes,
              # so the staged backward copies each row's ends element by
              # element
              ("alexnet_norm1", (128, 96, 55, 55), _ALEXNET_LRN),
              ("alexnet_norm2", (128, 256, 27, 27), _ALEXNET_LRN),
              # one on each side of the register ring (9 in registers, 10
              # in shared-memory slots), at a ragged shape
              ("size9", (3, 13, 5, 7),
               dict(size=9, alpha=0.5, beta=0.5, k=1.0, relu=True)),
              ("size10", (3, 13, 5, 7),
               dict(size=10, alpha=0.5, beta=1.0, k=2.0, relu=False)),
              # x and g one element past 16-byte alignment: every row's
              # ends copied element by element
              ("shifted", (4, 24, 28, 28), _LRN_ARGS),
              # past the staged route's cap (min(size, C) > 256 slots):
              # the "any" route, one launch of the tiled walk's backward
              ("past_cap", (8, 320, 28, 28),
               dict(size=288, alpha=1e-2, beta=0.6, k=1.0, relu=True)),
              # past it, untimed: an even window on odd planes, C past one
              # tile (its halos), a window wider than C, and a span past
              # the forward's ring cap whose backward no tile fits (the
              # two-launch form and its f32 scratch)
              ("past_cap_ragged", (3, 300, 5, 7),
               dict(size=290, alpha=1.0, beta=0.75, k=1.0, relu=True)),
              ("wide_c", (2, 1100, 7, 9),
               dict(size=300, alpha=1.0, beta=0.75, k=1.0, relu=False)),
              ("window_past_c", (4, 264, 14, 14),
               dict(size=1001, alpha=1.0, beta=0.5, k=2.0, relu=True)),
              ("two_launch", (1, 2048, 3, 5),
               dict(size=1500, alpha=1.0, beta=1.0, k=1.0, relu=True)))
#: the LRN cases held but not timed
_LRN_UNTIMED = ("ragged", "ragged16", "size9", "size10", "shifted",
                "past_cap_ragged", "wide_c", "window_past_c", "two_launch")
#: LRN kernel vs plain, element by element: |kernel - plain| <=
#: rtol·|plain| + atol·rms(plain). Both compute in f32 from the same
#: inputs and differ in rsqrt/sqrt routines and the order of a few sums
#: (a few f32 steps); bf16 outputs are rounded once from those f32
#: values, so an element may land one bf16 step away (rtol 2^-7), and
#: atol covers dx elements that are a small difference of two large
#: terms.
_LRN_TOL = {torch.bfloat16: (2 ** -7, 2 ** -7), torch.float32: (1e-5, 1e-5)}
# the max-pool backward at the in-block pools' planes (28x28 of
# inception_3a/3b, 14x14 of 4a-4e, 7x7 of 5a/5b) at batch 256: small
# integers (ties in every window) with integer cotangents ("ties"), and
# random normals ("normal"); then planes of -inf ("neginf": 60 % -inf,
# each sample's first plane all -inf, which the fill value of
# out-of-image x must not outrank), a 224x224 plane (100 KB a tensor in
# bf16: past the whole-plane cap, on the band route), an odd 57x33
# plane, rows of 1500 f32 (past the band route: blocks staged element by
# element) and x and dy one element past 16-byte alignment ("shifted":
# the spans' unaligned ends); all must be bit-exact (the kernel and the
# plain version add the same f32 terms in the same order and round once)
_MAXPOOL_CASES = (((256, 256, 28, 28), torch.bfloat16, "normal"),
                  ((256, 192, 28, 28), torch.bfloat16, "ties"),
                  ((256, 512, 14, 14), torch.bfloat16, "ties"),
                  ((256, 832, 7, 7), torch.bfloat16, "normal"),
                  ((256, 192, 28, 28), torch.float32, "normal"),
                  ((256, 480, 14, 14), torch.float32, "ties"),
                  ((256, 832, 7, 7), torch.float32, "ties"),
                  ((32, 64, 28, 28), torch.bfloat16, "neginf"),
                  ((4, 16, 224, 224), torch.bfloat16, "ties"),
                  ((8, 24, 57, 33), torch.float32, "normal"),
                  ((2, 3, 20, 1500), torch.float32, "ties"),
                  ((8, 24, 57, 33), torch.bfloat16, "shifted"))
#: Inception-v1's nine in-block pools (3x3, stride 1, SAME) at batch 256:
#: (name, input channels, plane side, pools of that shape)
_MAXPOOL_BATCH = 256
_MAXPOOL_POOLS = (("3a", 192, 28, 1), ("3b", 256, 28, 1), ("4a", 480, 14, 1),
                  ("4b-4d", 512, 14, 3), ("4e", 528, 14, 1),
                  ("5a-5b", 832, 7, 2))
# the Inception-v1 harness run: bench.py:109-202's geometry, 2 warm-up
# steps and 8 timed ones
_INCEPTION = dict(batch=256, warm_up=2, iterations=8, classes=1000)
#: first loss: 1000 classes, log-probabilities near uniform at the
#: Xavier init (6.9028 on the CPU at batch 4 from the same seed)
_INCEPTION_LOSS_BAND = 0.05
#: kernel vs plain LRN on one harness batch under the bf16 policy,
#: dropout off: the kernels and their plain versions round the same f32
#: values to bf16, so LRN outputs and input gradients differ by one bf16
#: step in a few elements; a step can flip the maximum of a pooling
#: window downstream, which moves a cotangent to a neighbouring pixel,
#: so gradients are bounded relative to their largest element and the
#: loss (about 6.9) absolutely
_INCEPTION_LOSS_TOL = 1e-3
_INCEPTION_GRAD_REL_TOL = 5e-2


def _perf_args(**over):
    p = dict(_PERF, **over)
    return ["-m", "transformer", "-b", str(p["batch"]), "--seqLen",
            str(p["seq"]), "--classNum", str(p["vocab"]), "--dModel",
            str(p["d_model"]), "--numLayers", str(p["layers"]), "--warmUp",
            str(p["warm_up"]), "-i", str(p["iterations"]), "--device", _DEV]


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def _print_ptxas(report: str) -> None:
    """Registers and spills of each kernel instantiation, from the
    compiler's ``-Xptxas=-v`` report (kernel, type, head dim and, for
    paged attention, rows per warp of the row-tile kernel and query rows
    of the split-KV decode kernel; of the LRN kernels' 84
    instantiations, the forward's at the path's window of 5 with 4-wide
    vectors, and the staged backward's at 5 and past 9, rows of whole
    16-byte chunks or not), then
    the most registers and the spilling instantiations of the file."""
    name = None
    kernels, regs, spilled = 0, 0, 0
    for line in report.splitlines():
        if "entry function" in line:
            kernels += 1
        r = re.search(r"Used (\d+) registers", line)
        if r:
            regs = max(regs, int(r.group(1)))
        if re.search(r"[1-9]\d* bytes spill stores", line):
            spilled += 1
        m = re.search(r"entry function '\S*?(paged_attention)_kernelI(\w+?)"
                      r"Li(\d+)E"
                      r"(?:Li(\d+)ELb([01])E(?:Lb([01])E)?)?", line)
        t = re.search(r"entry function '\S*?(flash_fwd|flash_dq|flash_dkdv|"
                      r"flash_dkdv_split)_tc_kernelILi(\d+)E", line)
        st = re.search(r"entry function '\S*?(flash_fwd|flash_dq|flash_dkdv)"
                       r"_sliced_tc_kernelILi(\d+)E", line)
        tf = re.search(r"entry function '\S*?(flash_fwd|flash_dq|flash_dkdv)"
                       r"_(sliced|rows)_tf32_kernelILi(\d+)E", line)
        f = re.search(r"entry function '\S*?(fce_\w+?)_kernel(\w*)'", line)
        ft = re.search(r"entry function '\S*?fce_bwd_tf32_kernelILb([01])E",
                       line)
        fc = re.search(r"entry function '\S*?fce_(dl_tc_kernelILb([01])E|"
                       r"gemm_tc_kernel|db_merge_kernel)", line)
        fw = re.search(r"entry function '\S*?fce_fwd_tf32_kernel", line)
        lr = re.search(r"entry function '\S*?(lrn_fwd|lrn_bwd)_kernelI(\w+?)"
                       r"Li(\d+)ELi(\d+)E", line)
        la = re.search(r"entry function '\S*?lrn_(bwd_)?tiled_kernelI(\w+?)"
                       r"(?:Li([012])E)?Lb([01])E", line)
        ls = re.search(r"entry function '\S*?lrn_bwd_staged_kernelI(\w+?)"
                       r"Li(\d+)ELb([01])E", line)
        mp = re.search(r"entry function '\S*?(maxpool3x3s1_bwd)_kernelI(\w+?)"
                       r"E", line)
        ps = re.search(r"entry function '\S*?paged_decode_split_kernelI"
                       r"(\w+?)Li(\d+)ELi(\d+)E(?:Lb([01])E)?", line)
        pt = re.search(r"entry function '\S*?paged_prefill_tc_kernelILi(\d+)E",
                       line)
        pw = re.search(r"entry function '\S*?paged_attention_(wide|sliced)_"
                       r"kernelI(\w+?)E", line)
        # the row-tile and split-KV kernels' PAD instantiations (a head
        # dim below the built one) are marked "padded"
        if pw and pw.group(1) == "sliced":
            name = (f"paged_attention_sliced "
                    f"{'bf16' if 'bfloat16' in pw.group(2) else 'f32'} "
                    f"(D past the wide form's cap, a runtime value)"
                    + (" padded" if "Lb1" in pw.group(2) else ""))
        elif pw:
            name = (f"paged_attention_wide "
                    f"{'bf16' if 'bfloat16' in pw.group(2) else 'f32'} "
                    f"(D past 256, a runtime value)"
                    + (" padded" if "Lb1" in pw.group(2) else ""))
        elif pt:
            name = f"paged_prefill_tc bf16 (tensor cores) D={pt.group(1)}"
        elif ps:
            dt, d, rows, pad = ps.groups()
            name = (f"paged_decode_split "
                    f"{'bf16' if 'bfloat16' in dt else 'f32'} D={d} "
                    f"rows<={rows}" + (" padded" if pad == "1" else ""))
        elif st:
            name = (f"{st.group(1)}_sliced_tc bf16 (tensor cores, D past "
                    f"256) OWN={st.group(2)}")
        elif tf:
            name = (f"{tf.group(1)}_{tf.group(2)}_tf32 f32 (3xTF32 on the "
                    f"tensor cores) OWN={tf.group(3)}")
        elif "tf32_split_kernel" in line:
            name = "tf32_split f32 (the 3xTF32 kernels' pass before)"
        elif t:
            name = f"{t.group(1)} bf16 (tensor cores) D={t.group(2)}"
        elif ls:
            # the path's window of 5, and the runtime window (SIZE 0)
            name = (f"lrn_bwd_staged "
                    f"{'bf16' if 'bfloat16' in ls.group(1) else 'f32'} "
                    + (f"size={ls.group(2)}" if ls.group(2) != "0" else
                       "(window past 9, a runtime value)")
                    + (" aligned" if ls.group(3) == "1" else " unaligned")
                    if ls.group(2) in ("5", "0") else None)
        elif la:
            # the tiled walk past window 9: the forward and the two-launch
            # "any" backward's passes (kind 0 / 1 / 2), the one-launch
            # "any" backward
            name = ("lrn_" + (
                "bwd_tiled (one launch)" if la.group(1) else
                ("fwd_tiled", "bwd_tiled pass t", "bwd_tiled pass dx")[
                    int(la.group(3))])
                + f" {'bf16' if 'bfloat16' in la.group(2) else 'f32'}"
                + (" aligned" if la.group(4) == "1" else " unaligned"))
        elif lr:
            # the path's instantiations: window 5, 4-wide vectors
            name = (f"{lr.group(1)} "
                    f"{'bf16' if 'bfloat16' in lr.group(2) else 'f32'} "
                    f"size={lr.group(3)} vec={lr.group(4)}"
                    if lr.group(3) == "5" and lr.group(4) == "4" else None)
        elif mp:
            name = (f"{mp.group(1)} "
                    f"{'bf16' if 'bfloat16' in mp.group(2) else 'f32'}")
        elif m:
            name = (f"{m.group(1)} "
                    f"{'bf16' if 'bfloat16' in m.group(2) else 'f32'} "
                    f"D={m.group(3)}"
                    + (f" rows/warp={m.group(4)}" if m.group(4) else "")
                    + (" chunks" if m.group(5) == "1" else "")
                    + (" padded" if m.group(6) == "1" else ""))
        elif ft:
            name = (f"fce_{'dw' if ft.group(1) == '1' else 'dh'}_tf32 f32 "
                    f"(3xTF32 on the tensor cores)")
        elif fc:
            name = (f"fce_dl_{'dw' if fc.group(2) == '1' else 'dh'} bf16 "
                    f"(chunked pass 1, tensor cores)" if fc.group(2) else
                    "fce_gemm bf16 (chunked pass 2 of dh and dW, tensor "
                    "cores)" if fc.group(1) == "gemm_tc_kernel" else
                    "fce_db_merge (chunked dW's db)")
        elif fw:
            name = "fce_fwd_tf32 f32 (3xTF32 on the tensor cores)"
        elif f:
            # fce_bwd's template flag: Lb0 dh, Lb1 dW/db
            kind, rest = f.groups()
            name = kind.replace("fce_bwd", "fce_dw" if "Lb1E" in rest
                                else "fce_dh")
            if name.endswith("_tc"):
                name = name[:-3] + " bf16 (tensor cores)"
            elif not kind.endswith("merge"):
                name += " bf16" if "bfloat16" in rest else " f32"
        elif "entry function" in line:
            name = None
        elif name and ("registers" in line or "spill" in line):
            print(f"[build] {name}: {line.split(':', 1)[-1].strip()}")
        if "wgmma" in line and "warning" in line.lower():
            # C7518 and its kin: ptxas serialised a kernel's wgmma
            print(f"[build] ptxas: {line.strip()}")
    print(f"[build] {kernels} instantiations: at most {regs} registers a "
          f"thread, {spilled} spilling")


def _check_tensor_cores(flash_lib: str, fce_lib: str, paged_lib: str) -> dict:
    """Tensor-core instructions in the SASS of each bf16 flash kernel, of
    the bf16 fused-CE forward, dh and dW/db kernels and of the bf16
    paged prefill kernels (``HGMMA``: wgmma; ``HMMA``: mma.sync), from
    ``cuobjdump --dump-sass`` of the built libraries; fails unless each
    of the nine flash kernels (fwd, dq, dkdv x D 32, 64, 128) has some,
    and the six past D 128 (D 192, 256; dk/dv from
    ``flash_dkdv_split_tc_kernel``), the bf16 forward past D 256 (both
    instantiations of ``flash_fwd_sliced_tc_kernel``: slices of 3 and of
    4 chunks), the bf16 dq and dk/dv past D 256 (both instantiations of
    ``flash_dq_sliced_tc_kernel`` and ``flash_dkdv_sliced_tc_kernel``),
    the f32 (3xTF32) forward past D 256 and dq and dk/dv at every head
    dim (every instantiation of ``flash_fwd_sliced_tf32_kernel`` and
    ``flash_dq_sliced_tf32_kernel``: warpgroup chunks 2, 3, 4, of
    ``flash_dkdv_sliced_tf32_kernel``: 1, 2, 3, 4, the 1- and 2-chunk
    ones for the head dims up to 128, and of
    ``flash_fwd_rows_tf32_kernel`` and ``flash_dq_rows_tf32_kernel``: 1,
    2, the forward and dq up to D 128), all three
    bf16 fused-CE
    kernels, the f32 (3xTF32) fused-CE forward (``fce_fwd_tf32_kernel``)
    and dh and dW/db (``fce_bwd_tf32_kernel``), the bf16 dh and dW/db
    past D 1024 (both instantiations of pass 1, ``fce_dl_tc_kernel``,
    and pass 2, ``fce_gemm_tc_kernel``, which both run), the five
    paged prefill kernels (D 32, 64, 128, 192, 256) and its sliced form
    past D 256 (``paged_prefill_sliced_tc_kernel``: slices of 3 and of
    4 chunks) have ``HGMMA``."""
    from bigdl_tpu_torch.ops import _build
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    counts, name = {}, None
    for lib in (flash_lib, fce_lib, paged_lib):
        sass = subprocess.run([str(tool), "--dump-sass", lib], check=True,
                              capture_output=True, text=True,
                              timeout=300).stdout
        for line in sass.splitlines():
            if "Function :" in line:
                f = re.search(r"(flash_fwd|flash_dq|flash_dkdv)(?:_split)?"
                              r"_tc_kernelILi(\d+)E", line)
                c = re.search(r"fce_bwd_tc_kernelILb([01])E", line)
                ct = re.search(r"fce_bwd_tf32_kernelILb([01])E", line)
                cd = re.search(r"fce_dl_tc_kernelILb([01])E", line)
                sl = re.search(r"(flash_fwd|flash_dq|flash_dkdv)_sliced_tc"
                               r"_kernelILi(\d+)E", line)
                tf = re.search(r"(flash_fwd|flash_dq|flash_dkdv)_(sliced|rows)"
                               r"_tf32_kernelILi(\d+)E", line)
                p = re.search(r"paged_prefill_tc_kernelILi(\d+)E", line)
                ps = re.search(r"paged_prefill_sliced_tc_kernelILi(\d+)E",
                               line)
                name = (f"{f.group(1)} bf16 D={f.group(2)}" if f else
                        f"{sl.group(1)}_sliced_tc bf16 OWN={sl.group(2)}"
                        if sl else
                        f"{tf.group(1)}_{tf.group(2)}_tf32 f32 "
                        f"OWN={tf.group(3)}" if tf
                        else
                        f"paged_prefill_tc bf16 D={p.group(1)}" if p else
                        f"paged_prefill_sliced_tc bf16 OWN={ps.group(1)}"
                        if ps else
                        f"fused_ce_{'dw' if c.group(1) == '1' else 'dh'} bf16"
                        if c else
                        f"fused_ce_{'dw' if ct.group(1) == '1' else 'dh'}"
                        f" f32 tf32" if ct else
                        f"fused_ce_dl_{'dw' if cd.group(1) == '1' else 'dh'}"
                        f" bf16 chunked" if cd else
                        "fused_ce_gemm bf16 chunked"
                        if "fce_gemm_tc_kernel" in line else
                        "fused_ce_fwd bf16"
                        if "fce_fwd_tc_kernel" in line else
                        "fused_ce_fwd f32 tf32"
                        if "fce_fwd_tf32_kernel" in line else None)
                if name:
                    counts[name] = {"HGMMA": 0, "HMMA": 0}
            elif name:
                for op in counts[name]:
                    counts[name][op] += bool(re.search(rf"\b{op}\.", line))
    print("[build] tensor-core instructions in the SASS of the bf16 flash, "
          "f32 3xTF32 flash, fused-CE and paged prefill kernels: "
          + json.dumps(counts), flush=True)
    bare = sorted(f"{k} bf16 D={d}" for k in ("flash_fwd", "flash_dq",
                                              "flash_dkdv")
                  for d in (32, 64, 128)
                  if not sum(counts.get(f"{k} bf16 D={d}", {}).values()))
    bare += [k for k in ("fused_ce_fwd bf16", "fused_ce_dh bf16",
                         "fused_ce_dw bf16", "fused_ce_fwd f32 tf32",
                         "fused_ce_dh f32 tf32",
                         "fused_ce_dw f32 tf32", "fused_ce_dl_dh bf16 chunked",
                         "fused_ce_dl_dw bf16 chunked",
                         "fused_ce_gemm bf16 chunked") + tuple(
                             f"{k} bf16 D={d}" for k in ("flash_fwd",
                                                         "flash_dq",
                                                         "flash_dkdv")
                             for d in (192, 256)) + tuple(
                             f"{k}_sliced_tc bf16 OWN={n}"
                             for k in ("flash_fwd", "flash_dq", "flash_dkdv")
                             for n in (3, 4)) + tuple(
                             f"{k}_sliced_tf32 f32 OWN={n}"
                             for k, owns in (("flash_fwd", (2, 3, 4)),
                                             ("flash_dq", (2, 3, 4)),
                                             ("flash_dkdv", (1, 2, 3, 4)))
                             for n in owns) + tuple(
                             f"{k}_rows_tf32 f32 OWN={n}"
                             for k in ("flash_fwd", "flash_dq")
                             for n in (1, 2)) + tuple(
                             f"paged_prefill_tc bf16 D={d}"
                             for d in (32, 64, 128, 192, 256)) + tuple(
                             f"paged_prefill_sliced_tc bf16 OWN={n}"
                             for n in (3, 4))
             if not counts.get(k, {}).get("HGMMA")]
    if bare:
        raise AssertionError(f"no (wgmma) tensor-core instructions in {bare}")
    return counts


def _time_ms(fn, iters=20):
    """Median device time of ``fn`` over ``iters`` runs, after three to
    warm, each after an L2 flush (the serving path reaches every K/V
    page cold), from CUDA events around the call alone. A spin of about
    0.2 ms on the card follows each flush, so the host has enqueued the
    call before its start event is reached: a call of a few µs of device
    time would otherwise read the host's time to enqueue it."""
    flush = torch.empty(_FLUSH_BYTES, dtype=torch.uint8, device=_DEV)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(400_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def _paged_case(b, t, q_start, n_alloc, p, dtype, gen, h=_H, kv=_KV, d=_D,
                s=_S):
    """Random pools and a block table like the batcher's: row i owns
    ``n_alloc[i]`` distinct pages in random order, the rest of its ``p``
    table entries point at a scratch page (the pool's last); the serving
    heads unless ``h``, ``kv``, ``d`` and the page size ``s`` say
    otherwise."""
    n_pages = int(sum(n_alloc)) + 1
    perm = torch.randperm(n_pages - 1, generator=gen).tolist()
    table = torch.full((b, p), n_pages - 1, dtype=torch.int32)
    at = 0
    for i, n in enumerate(n_alloc):
        table[i, :n] = torch.tensor(perm[at:at + n], dtype=torch.int32)
        at += n
    shape = (n_pages, s, kv, d)
    kp = torch.randn(shape, generator=gen).to(dtype)
    vp = torch.randn(shape, generator=gen).to(dtype)
    q = torch.randn((b, t, h, d), generator=gen).to(dtype)
    return (q.to(_DEV), kp.to(_DEV), vp.to(_DEV), table.to(_DEV),
            torch.tensor(q_start, dtype=torch.int32, device=_DEV))


def _bound(q, table, q_start, s, kv, elt):
    """Least time for this call: bytes it must move (q, the K/V rows
    each row's queries reach, ``min(last + 1, P·S)`` keys and not whole
    pages, table, q_start, the f32 output) over the memory rate vs flops
    over the bf16 peak."""
    b, t, h, d = q.shape
    last = q_start.long().cpu() + t - 1
    keys_read = torch.clamp(last + 1, max=table.shape[1] * s)
    bytes_ = (q.numel() * q.element_size() + int(keys_read.sum()) * kv * d
              * elt * 2 + table.numel() * 4 + q_start.numel() * 4
              + q.numel() * 4)
    keys = sum(int(q_start[i]) * t + t * (t + 1) // 2 for i in range(b))
    flops = 4 * d * h * keys
    tb, tf = bytes_ / _HBM_BYTES_PER_S * 1e3, flops / _BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _library_ms(q, kp, vp, table, q_start, pa):
    """One PyTorch call computing the same function: SDPA on the gathered
    dense view with the causal row mask (timed here only; the port never
    calls it)."""
    import torch.nn.functional as F
    b, t, h, d = q.shape
    g = h // kp.shape[2]
    ck = pa._paged_view(kp, table).repeat_interleave(g, dim=2)
    cv = pa._paged_view(vp, table).repeat_interleave(g, dim=2)
    qq, kk, vv = (x.transpose(1, 2).contiguous() for x in (q, ck, cv))
    kpos = torch.arange(ck.shape[1], device=q.device)
    upto = q_start.long()[:, None] + torch.arange(t, device=q.device)
    mask = (kpos[None, None, :] <= upto[:, :, None])[:, None]
    return _time_ms(lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask))


def _library_gather_ms(q, kp, vp, table, q_start, pa):
    """The same function in library calls, the block-table gather
    included: ``_paged_view`` + ``repeat_interleave`` + SDPA, all inside
    the timed call (timed here only; the port never calls it)."""
    import torch.nn.functional as F
    b, t, h, d = q.shape
    g = h // kp.shape[2]
    qq = q.transpose(1, 2).contiguous()
    kpos = torch.arange(table.shape[1] * kp.shape[1], device=q.device)
    upto = q_start.long()[:, None] + torch.arange(t, device=q.device)
    mask = (kpos[None, None, :] <= upto[:, :, None])[:, None]

    def call():
        ck = pa._paged_view(kp, table).repeat_interleave(g, dim=2)
        cv = pa._paged_view(vp, table).repeat_interleave(g, dim=2)
        return F.scaled_dot_product_attention(
            qq, ck.transpose(1, 2), cv.transpose(1, 2), attn_mask=mask)
    return _time_ms(call)


def _split_breakdown(pa, args, card):
    """Device µs a call of the split-KV decode kernel alone under
    ``torch.profiler`` over 20 calls, L2 flushed before each (``ms``
    adds the launch between CUDA events); and the call's time with
    splits of other widths (CUDA events, as ``ms``),
    ``decode_split_pages`` swapped inside this function."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(_FLUSH_BYTES, dtype=torch.uint8, device=_DEV)
    pa.paged_attention(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            flush.zero_()
            pa.paged_attention(*args)
        torch.cuda.synchronize()
    kinds, _ = _device_ms(prof, 20, lambda n: (
        "split" if "decode_split" in n else "other"))
    widths = {}
    chosen = pa.decode_split_pages
    try:
        for pps in (2, 4, 8, 16, 32):
            pa.decode_split_pages = lambda *_, n=pps: n
            widths[pps] = _time_ms(lambda: pa.paged_attention(*args))
    finally:
        pa.decode_split_pages = chosen
    row = dict(kernel_us=kinds.get("split", 0.0) * 1e3,
               ms_by_pages_per_split=widths)
    print(f"[kernels] paged_attention[decode] split-KV breakdown, card="
          f"'{card}': " + json.dumps(row), flush=True)
    return row


#: small geometries that reach every other instantiation of the split-KV
#: decode kernel, held against both plain versions (no timing): (label,
#: B, T, H, KV, D, page size, table entries, pool dtype, last key of each
#: row); T·G <= 16 in each, so each takes the split-KV kernel
_DECODE_GEOMETRIES = (
    ("mha-d32", 4, 1, 8, 8, 32, 16, 20, torch.bfloat16, [0, 15, 16, 319]),
    ("mqa-g8-d64", 3, 1, 8, 1, 64, 32, 9, torch.float32, [5, 100, 287]),
    ("d256", 3, 1, 4, 2, 256, 16, 12, torch.bfloat16, [0, 64, 191]),
    ("t2-g8-d256-f32", 2, 2, 16, 2, 256, 16, 10, torch.float32, [3, 158]),
    ("t2-g4-d128", 4, 2, 8, 2, 128, 16, 30, torch.bfloat16,
     [1, 127, 128, 478]),
    ("page7-d64", 5, 1, 8, 2, 64, 7, 30, torch.bfloat16,
     [0, 6, 7, 100, 209]),
    # 64 rows x 8 kv heads fill the card without splitting: one split of
    # 40 pages (640 keys) a row, staged in chunks (two stages)
    ("one-split-chunks-f32", 64, 1, 8, 8, 128, 16, 40, torch.float32,
     [int(x) for x in np.linspace(0, 639, 64)]),
    ("one-split-chunks", 64, 1, 8, 8, 128, 16, 40, torch.bfloat16,
     [int(x) for x in np.linspace(639, 0, 64)]),
    # head dim 192: 24 (bf16) or 48 (f32) vectors a row, which do not
    # divide the 128 threads; both row counts
    ("d192", 3, 1, 4, 2, 192, 16, 12, torch.bfloat16, [0, 64, 191]),
    ("t4-g4-d192", 2, 4, 8, 2, 192, 16, 10, torch.bfloat16, [3, 158]),
    ("t2-g8-d192-f32", 2, 2, 16, 2, 192, 16, 10, torch.float32, [3, 158]),
    # pages of 256 slots, past the row-tile kernel's limit
    ("s256", 4, 1, 8, 2, 128, 256, 9, torch.bfloat16, [0, 255, 256, 2100]),
)


#: geometry rows that are also timed (beside their bound, plain version
#: and library calls): head dim 192, pages of 256 slots, Qwen2.5-7B's G 7
#: and 14B's G 5 at the T 512 bucket, Falcon-7B's G 71 prefill and decode
#: (the flat fold), and f32 pools at G 7 (the row-tile kernel)
_TIMED_GEOMETRIES = ("d192", "s256", "qwen7b-g7", "qwen14b-g5",
                     "falcon7b-g71", "falcon7b-g71-decode", "g7-f32")


def _geometry_times(pa, args, s, kv):
    """ms, plain ms, bound and library ms of one paged call."""
    bound, by = _bound(args[0], args[3], args[4], s, kv,
                       args[1].element_size())
    return dict(ms=_time_ms(lambda: pa.paged_attention(*args)),
                plain_ms=_time_ms(lambda: pa.paged_attention_ref(*args)),
                bound_ms=bound, bound_by=by,
                library_ms=_library_ms(*args, pa),
                library_gather_ms=_library_gather_ms(*args, pa))


def _decode_geometries(pa, gen):
    """Every row of ``_DECODE_GEOMETRIES``: the split-KV kernel against
    ``paged_attention_split_ref`` and ``paged_attention_ref``, the split
    plain version against the other, each within ``_PAGED_TOL`` (the
    ``_TIMED_GEOMETRIES`` rows timed too); returns the kernel's largest
    error against ``paged_attention_ref`` and the worst error / limit."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err_all, worst_all, rows = 0.0, 0.0, {}
    for label, b, t, h, kv, d, s, p, dtype, last in _DECODE_GEOMETRIES:
        starts = [x - t + 1 if x >= t - 1 else 0 for x in last]
        q, kp, vp, table, qs = _paged_case(
            b, t, starts, [min(p, (x + t) // s + 1) for x in starts], p,
            dtype, gen, h=h, kv=kv, d=d, s=s)
        splits = pa.split_launches
        got = pa.paged_attention(q, kp, vp, table, qs)
        torch.cuda.synchronize()
        if pa.split_launches - splits != 1:
            raise AssertionError(f"decode geometry {label} did not take the "
                                 f"split-KV kernel")
        pps = pa.decode_split_pages(b, kv, p, sms)
        want = pa.paged_attention_ref(q, kp, vp, table, qs)
        want_split = pa.paged_attention_split_ref(q, kp, vp, table, qs,
                                                  pages_per_split=pps)
        tol = _PAGED_TOL[dtype]
        err, worst = _paged_check(f"decode geometry {label}", got, want, tol)
        worst = max(worst,
                    _paged_check(f"decode geometry {label} vs split plain",
                                 got, want_split, tol)[1],
                    _paged_check(f"decode geometry {label}: split plain vs "
                                 f"plain", want_split, want, tol)[1])
        rows[label] = dict(pages_per_split=pps, max_abs_err=err,
                           worst_err_over_limit=worst)
        if label in _TIMED_GEOMETRIES:
            rows[label].update(_geometry_times(
                pa, (q, kp, vp, table, qs), s, kv))
        err_all, worst_all = max(err_all, err), max(worst_all, worst)
    print("[kernels] split-KV decode at other geometries (kernel vs both "
          "plain versions, split plain vs plain): " + json.dumps(rows),
          flush=True)
    return err_all, worst_all


def _paged_call(pa, label, route, q, kp, vp, table, qs):
    """One ``paged_attention`` call, synchronised; raises unless it ran
    ``route``'s kernel ("split", "tc", "tc_sliced", "row" or
    "row_sliced"), as ``kernel_route`` names it and the counters show."""
    counts = (pa.launches, pa.split_launches, pa.tc_launches,
              pa.tc_sliced_launches)
    got = pa.paged_attention(q, kp, vp, table, qs)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip((pa.launches, pa.split_launches,
                                    pa.tc_launches, pa.tc_sliced_launches),
                                   counts)]
    want = [1, int(route == "split"), int(route == "tc"),
            int(route == "tc_sliced")]
    took = pa.kernel_route(q.shape[1], q.shape[2], kp.shape[2], q.shape[3],
                           kp.shape[1], table.shape[1], kp.dtype)
    if moved != want or took != route:
        raise AssertionError(f"{label} took route {took} (counters moved "
                             f"{moved}), not the {route} kernel")
    return got


def _tile_check(pa, label, got, q, kp, vp, table, qs):
    """A tensor-core prefill output against ``paged_attention_tile_ref``
    at the kernel's 64-key tiles, within ``_PAGED_TILE_TOL``."""
    tile = pa.paged_attention_tile_ref(q, kp, vp, table, qs, key_tile=64)
    err, worst = _worst(got, tile, *_PAGED_TILE_TOL, rms_dims=(2, 3))
    if not worst <= 1:
        raise AssertionError(f"{label} vs tile plain: max abs err {err}, "
                             f"{worst} x its limit")
    return dict(max_abs_err=err, worst_err_over_limit=worst,
                tol=_PAGED_TILE_TOL)


def _row_check(pa, label, got, q, kp, vp, table, qs):
    """A row-tile output against ``paged_attention_row_ref`` within
    ``_PAGED_TILE_TOL``, where the row's view holds at most
    ``_ROW_REF_MAX_KEYS`` keys (else None)."""
    if table.shape[1] * kp.shape[1] > _ROW_REF_MAX_KEYS:
        return None
    ref = pa.paged_attention_row_ref(q, kp, vp, table, qs)
    err, worst = _worst(got, ref, *_PAGED_TILE_TOL, rms_dims=(2, 3))
    if not worst <= 1:
        raise AssertionError(f"{label} vs row plain: max abs err {err}, "
                             f"{worst} x its limit")
    return dict(max_abs_err=err, worst_err_over_limit=worst)


def _prefill_buckets(pa, gen, p_slot):
    """The tensor-core prefill at the batcher's buckets (B 1, q_start 0,
    the pages the batcher allocates, its 129-entry table), each held
    against both plain versions and timed beside its bound and the
    library calls."""
    rows = {}
    for t in _PREFILL_BUCKETS:
        args = _paged_case(1, t, [0], [-(-(t + 72) // _S)], p_slot,
                           torch.bfloat16, gen)
        label = f"prefill bucket T={t}"
        got = _paged_call(pa, label, "tc", *args)
        err, worst = _paged_check(label, got, pa.paged_attention_ref(*args),
                                  _PAGED_TOL[torch.bfloat16])
        bound, by = _bound(args[0], args[3], args[4], _S, _KV, 2)
        rows[t] = dict(max_abs_err=err, worst_err_over_limit=worst,
                       vs_tile_ref=_tile_check(pa, label, got, *args),
                       ms=_time_ms(lambda: pa.paged_attention(*args)),
                       bound_ms=bound, bound_by=by,
                       library_ms=_library_ms(*args, pa),
                       library_gather_ms=_library_gather_ms(*args, pa))
    print(f"[kernels] paged_attention prefill buckets (B 1, q_start 0, "
          f"{p_slot}-entry table), card='{_card()}': " + json.dumps(rows),
          flush=True)
    return rows


#: prefill geometries besides the serving one, each held against both
#: plain versions (the row-tile ones against paged_attention_ref): (label,
#: B, T, H, KV, D, page size, table entries, pool dtype, q_start of each
#: row, the route kernel_route names)
_PREFILL_GEOMETRIES = (
    ("d64", 2, 96, 8, 2, 64, 16, 20, torch.bfloat16, [0, 30], "tc"),
    ("d32", 2, 96, 8, 2, 32, 16, 20, torch.bfloat16, [0, 30], "tc"),
    ("d256", 2, 96, 4, 2, 256, 16, 20, torch.bfloat16, [0, 30], "tc"),
    ("mha-g1", 2, 100, 8, 8, 128, 16, 20, torch.bfloat16, [0, 7], "tc"),
    ("g8", 2, 100, 8, 1, 128, 16, 20, torch.bfloat16, [0, 7], "tc"),
    ("t17-g1", 1, 17, 2, 2, 128, 16, 4, torch.bfloat16, [0], "tc"),
    ("s8", 2, 100, 8, 2, 128, 8, 20, torch.bfloat16, [0, 7], "tc"),
    ("s32", 2, 100, 8, 2, 128, 32, 20, torch.bfloat16, [0, 7], "tc"),
    ("s128", 2, 300, 8, 2, 128, 128, 8, torch.bfloat16, [0, 7], "tc"),
    ("s24", 2, 100, 8, 2, 128, 24, 20, torch.bfloat16, [0, 7], "tc"),
    # chunked prefill: rows that start deep in their tables
    ("chunked", 2, 64, 8, 2, 128, 16, 129, torch.bfloat16, [100, 517],
     "tc"),
    ("f32-pools", 1, 128, 8, 2, 128, 16, 20, torch.float32, [0], "row"),
    # pages padded to a multiple of 8 slots (a box of 8 rows past a
    # 7-slot page's own 7)
    ("s7", 1, 128, 8, 2, 64, 7, 30, torch.bfloat16, [0], "tc"),
    # head dim 192 on each prefill route, and pages of 256 slots
    ("d192", 2, 96, 4, 2, 192, 16, 20, torch.bfloat16, [0, 30], "tc"),
    ("d192-f32", 1, 128, 8, 2, 192, 16, 20, torch.float32, [0], "row"),
    ("d192-s12", 1, 64, 8, 2, 192, 12, 30, torch.bfloat16, [0], "tc"),
    ("s256", 2, 300, 8, 2, 128, 256, 9, torch.bfloat16, [0, 700], "tc"),
    ("s256-chunked", 1, 64, 8, 2, 128, 256, 9, torch.bfloat16, [1500],
     "tc"),
    # groups padded to a power of two: Qwen2.5-7B's attention (28 heads
    # over 4 kv heads, G 7) and 14B's (40 over 8, G 5) at the T 512
    # bucket, 1.5B's G 6 (12 over 2), chunked rows deep in their tables,
    # G 7 over one kv head (the box of 8 heads past H 7) and G 64
    ("qwen7b-g7", 1, 512, 28, 4, 128, 16, 40, torch.bfloat16, [0], "tc"),
    ("qwen14b-g5", 1, 512, 40, 8, 128, 16, 40, torch.bfloat16, [0], "tc"),
    ("g6", 2, 200, 12, 2, 128, 16, 30, torch.bfloat16, [0, 150], "tc"),
    ("g7-chunked", 2, 64, 28, 4, 128, 16, 129, torch.bfloat16, [100, 517],
     "tc"),
    ("g5-chunked", 1, 64, 40, 8, 128, 16, 129, torch.bfloat16, [1000],
     "tc"),
    ("g7-kv1", 2, 100, 7, 1, 64, 16, 12, torch.bfloat16, [0, 60], "tc"),
    ("g64", 1, 17, 64, 1, 64, 16, 4, torch.bfloat16, [20], "tc"),
    # pages of 300 slots at G 7 and of 125 (the dense view of a
    # 1000-slot cache: dense_cache_page_size(1000))
    ("s300-g7", 2, 300, 28, 4, 128, 300, 6, torch.bfloat16, [0, 700],
     "tc"),
    ("s125", 2, 200, 8, 2, 128, 125, 16, torch.bfloat16, [0, 900], "tc"),
    ("g6-s12-chunked", 1, 48, 12, 2, 64, 12, 60, torch.bfloat16, [500],
     "tc"),
    # the row-tile kernel's f32 pools at G 7
    ("g7-f32", 1, 128, 28, 4, 128, 16, 20, torch.float32, [0], "row"),
    # G past 64, folded flat (F = G): Falcon-7B's attention (71 heads
    # over one kv head, D 64) at the T 512 bucket and a decode step of
    # [serve]'s Falcon-7B tail (4 rows, keys 308-1013 of 66-entry
    # tables: 71 rows, two CTAs a row); G 65 over one kv head (a tile
    # straddles two query columns by one row; D 32, zeros past D); G 96
    # over 2 kv heads (two runs of heads a tile) deep in chunked tables;
    # G 71 through 300-slot pages; a G 128 decode at D 256
    ("falcon7b-g71", 1, 512, 71, 1, 64, 16, 40, torch.bfloat16, [0],
     "tc"),
    ("falcon7b-g71-decode", 4, 1, 71, 1, 64, 16, 66, torch.bfloat16,
     [307, 548, 790, 1012], "tc"),
    ("g65-kv1", 2, 40, 65, 1, 32, 16, 8, torch.bfloat16, [0, 50], "tc"),
    ("g96-kv2-chunked", 2, 64, 192, 2, 128, 16, 129, torch.bfloat16,
     [100, 517], "tc"),
    ("g71-s300", 2, 100, 71, 1, 64, 300, 6, torch.bfloat16, [0, 700],
     "tc"),
    ("g128-decode", 3, 1, 128, 1, 256, 16, 40, torch.bfloat16,
     [0, 200, 600], "tc"),
)


def _prefill_geometries(pa, gen):
    """Every row of ``_PREFILL_GEOMETRIES``: the route it took, and the
    kernel against the plain version (and the tile version where the
    tensor-core kernel ran, the row version where the row-tile kernel
    did), each within its limit; the
    ``_TIMED_GEOMETRIES`` rows timed too."""
    rows = {}
    for label, b, t, h, kv, d, s, p, dtype, starts, route in \
            _PREFILL_GEOMETRIES:
        args = _paged_case(b, t, starts,
                           [min(p, (x + t) // s + 1) for x in starts], p,
                           dtype, gen, h=h, kv=kv, d=d, s=s)
        got = _paged_call(pa, f"prefill geometry {label}", route, *args)
        err, worst = _paged_check(f"prefill geometry {label}", got,
                                  pa.paged_attention_ref(*args),
                                  _PAGED_TOL[dtype])
        rows[label] = dict(route=route, max_abs_err=err,
                           worst_err_over_limit=worst)
        if route == "tc":
            rows[label]["vs_tile_ref"] = _tile_check(
                pa, f"prefill geometry {label}", got, *args)
        else:
            rows[label]["vs_row_ref"] = _row_check(
                pa, f"prefill geometry {label}", got, *args)
        if label in _TIMED_GEOMETRIES:
            rows[label].update(_geometry_times(pa, args, s, kv))
    print("[kernels] paged_attention prefill at other geometries (route, "
          "kernel vs plain, vs tile plain): " + json.dumps(rows), flush=True)
    return rows


def _prefill_nan_pool(pa, gen):
    """The tensor-core prefill over pools whose pages past each row's
    last query hold NaN (pages no kernel may read, as the TPU kernel
    reads none): the output must equal, bit for bit, the kernel's on the
    same pools without the NaN, and be within ``_PAGED_TOL`` of the
    plain version on those. Pages of 16 slots (a random table), then of
    300 (S % 8 != 0), whose table puts a NaN page right after each page
    read in memory: a page's last 8-row box reaches 4 slots past its
    300, which must read as zeros, not as the next page's first slots."""
    cases = {16: _paged_case(2, 64, [0, 40], [6, 8], 12, torch.bfloat16,
                             gen)}
    q, kp, vp, _, qs = _paged_case(2, 64, [0, 400], [4, 4], 4,
                                   torch.bfloat16, gen, s=300)
    # row 0 reads page 0, row 1 pages 2 and 4; every odd page is unread
    table = torch.tensor([[0, 3, 5, 7], [2, 4, 1, 6]], dtype=torch.int32,
                         device=_DEV)
    cases[300] = (q, kp[:8].contiguous(), vp[:8].contiguous(), table, qs)
    rows = {}
    for s, (q, kp, vp, table, qs) in cases.items():
        kn, vn = kp.clone(), vp.clone()
        for i in range(2):
            past = table[i, (int(qs[i]) + 63) // s + 1:].long()
            kn[past] = float("nan")
            vn[past] = float("nan")
        clean = _paged_call(pa, f"prefill NaN pool S={s} (clean)", "tc", q,
                            kp, vp, table, qs)
        got = _paged_call(pa, f"prefill NaN pool S={s}", "tc", q, kn, vn,
                          table, qs)
        if not torch.equal(got, clean):
            raise AssertionError(f"prefill over a pool of {s}-slot pages "
                                 f"with NaN past each row's last query "
                                 f"differs from the clean pool's")
        err, worst = _paged_check(
            f"prefill NaN pool S={s}", got,
            pa.paged_attention_ref(q, kp, vp, table, qs),
            _PAGED_TOL[torch.bfloat16])
        rows[s] = dict(equal_to_clean_pool=True, max_abs_err=err,
                       worst_err_over_limit=worst)
    print("[kernels] paged_attention prefill, NaN in the pages past each "
          "row's last query (by page size): " + json.dumps(rows),
          flush=True)
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                by_page_size=rows)


#: pools the kernels took only from their own PR on, each held against
#: the plain version with its route checked (same columns as
#: ``_PREFILL_GEOMETRIES``): pages past the row-tile kernel's whole-page
#: staging (f32 pages of 256 slots, a 4097-entry table of 256-slot
#: pages), streamed in chunks of ``row_chunk_slots`` slots; bf16 pages of
#: 300 and G 3 at 256, which the tensor-core kernel takes; and head dims
#: 320, 512, 576 and 1024 and the caps (bf16 1792, f32 1152), whose bf16
#: calls, decode too, run the sliced tensor-core kernel (D a runtime
#: value, 3 or 4 64-column output chunks a CTA; G <= 64 and tables of
#: up to 4096 entries, the last rows holding the bf16 calls past either
#: on the row-tile kernels) and whose f32 calls run the row-tile
#: kernel's wide form, D a runtime value (an f32 D 512 pool of 64-slot
#: pages takes chunks of 24, 24 and 16, an f32 D 1024 pool chunks of 8);
#: past the caps the sliced tensor-core kernel (bf16) or the row-tile
#: kernel's column-sliced form
_POOL_GEOMETRIES = (
    ("s256-f32", 2, 300, 8, 2, 128, 256, 9, torch.float32, [0, 700],
     "row"),
    ("s256-f32-decode", 4, 1, 8, 2, 128, 256, 9, torch.float32,
     [0, 255, 256, 2099], "split"),
    ("s300", 2, 300, 8, 2, 128, 300, 8, torch.bfloat16, [0, 700], "tc"),
    ("s256-g3", 2, 100, 6, 2, 128, 256, 9, torch.bfloat16, [0, 300],
     "tc"),
    ("s256-4097-pages", 1, 64, 8, 2, 128, 256, 4097, torch.bfloat16,
     [600], "row"),
    ("d320", 2, 96, 4, 2, 320, 16, 20, torch.bfloat16, [0, 30],
     "tc_sliced"),
    ("d320-decode", 3, 1, 4, 2, 320, 16, 12, torch.bfloat16, [0, 64, 191],
     "tc_sliced"),
    ("d512", 2, 96, 4, 2, 512, 16, 20, torch.bfloat16, [0, 30],
     "tc_sliced"),
    ("d512-decode", 3, 1, 4, 2, 512, 16, 12, torch.bfloat16,
     [0, 64, 191], "tc_sliced"),
    ("d512-f32-s64", 1, 64, 4, 2, 512, 64, 6, torch.float32, [100], "row"),
    ("d576", 2, 96, 4, 2, 576, 16, 20, torch.bfloat16, [0, 30],
     "tc_sliced"),
    ("d576-f32", 2, 96, 4, 2, 576, 16, 20, torch.float32, [0, 30], "row"),
    ("d576-decode", 3, 1, 4, 2, 576, 16, 12, torch.bfloat16, [0, 64, 191],
     "tc_sliced"),
    ("d576-f32-decode", 3, 1, 4, 2, 576, 16, 12, torch.float32,
     [0, 64, 191], "row"),
    ("d1024", 2, 96, 4, 2, 1024, 16, 20, torch.bfloat16, [0, 30],
     "tc_sliced"),
    ("d1024-f32", 2, 96, 4, 2, 1024, 16, 20, torch.float32, [0, 30],
     "row"),
    ("d1024-decode", 3, 1, 4, 2, 1024, 16, 12, torch.bfloat16,
     [0, 64, 191], "tc_sliced"),
    ("d1024-f32-decode", 3, 1, 4, 2, 1024, 16, 12, torch.float32,
     [0, 64, 191], "row"),
    ("d1024-s300", 1, 64, 2, 1, 1024, 300, 4, torch.bfloat16, [500],
     "tc_sliced"),
    # at the wide form's cap (1792 bf16, 1152 f32: one 8-slot chunk)
    ("d1792", 2, 96, 4, 2, 1792, 16, 20, torch.bfloat16, [0, 30],
     "tc_sliced"),
    ("d1152-f32", 2, 96, 4, 2, 1152, 16, 20, torch.float32, [0, 30],
     "row"),
    # past the wide form's cap (1792 bf16, 1152 f32): its column-sliced
    # form (4, 4 and 3 slices of 512 columns), prefill and decode
    ("d1856", 2, 96, 4, 2, 1856, 16, 20, torch.bfloat16, [0, 30],
     "tc_sliced"),
    ("d1856-decode", 3, 1, 4, 2, 1856, 16, 12, torch.bfloat16,
     [0, 64, 191], "tc_sliced"),
    ("d2048", 2, 96, 4, 2, 2048, 16, 20, torch.bfloat16, [0, 30],
     "tc_sliced"),
    ("d2048-s300", 1, 64, 2, 1, 2048, 300, 4, torch.bfloat16, [500],
     "tc_sliced"),
    ("d1216-f32", 2, 96, 4, 2, 1216, 16, 20, torch.float32, [0, 30],
     "row_sliced"),
    # past D 256 the bf16 rows above, decode too, run the sliced
    # tensor-core kernel; beside them G 7 through pages of 12, G 64 over
    # one kv head, a short prefill (T 9: 18 rows a kv head, q_start past
    # 0) and the padded head dims 304 (at 320) and 1864 (at 1920)
    ("d512-g7-s12", 2, 40, 14, 2, 512, 12, 30, torch.bfloat16, [0, 50],
     "tc_sliced"),
    ("d320-g64", 1, 17, 64, 1, 320, 16, 4, torch.bfloat16, [20],
     "tc_sliced"),
    ("d512-t9", 2, 9, 4, 2, 512, 16, 12, torch.bfloat16, [40, 100],
     "tc_sliced"),
    ("d304", 2, 96, 4, 2, 304, 16, 20, torch.bfloat16, [0, 30],
     "tc_sliced"),
    ("d1864", 2, 96, 4, 2, 1864, 16, 20, torch.bfloat16, [0, 30],
     "tc_sliced"),
    # a 512-token prefill at D 512: 16 row tiles a kv head, up to 8 key
    # tiles a CTA
    ("d512-t512", 1, 512, 8, 2, 512, 16, 40, torch.bfloat16, [0],
     "tc_sliced"),
    ("d1216-f32-decode", 3, 1, 4, 2, 1216, 16, 12, torch.float32,
     [0, 64, 191], "row_sliced"),
    # head dims the kernels run at the next built one (padded_head_dim),
    # zeros past D in every staged row, D columns stored: the train
    # main's 16 (-> 32), Phi-2's 80 and Phi-3-mini's 96 (-> 128) on the
    # split-KV and tensor-core kernels (TMA maps of extent D), f32 96 on
    # the split-KV and row-tile kernels; rows of no 16-byte multiple on
    # the row-tile kernels' element-wise staging, decode and prefill
    # alike: bf16 20 (40 bytes, -> 32), 300 (the wide form at 320) and
    # 1860 (the sliced form at 1920), f32 1190 (sliced at 1216); and 288
    # (at 320 on the sliced tensor-core kernel, 576-byte rows as TMA rows)
    ("d16", 2, 96, 8, 2, 16, 16, 20, torch.bfloat16, [0, 30], "tc"),
    ("d16-decode", 3, 1, 8, 8, 16, 16, 12, torch.bfloat16, [0, 64, 191],
     "split"),
    ("d80", 2, 96, 8, 2, 80, 16, 20, torch.bfloat16, [0, 30], "tc"),
    ("d80-decode", 3, 1, 8, 2, 80, 16, 12, torch.bfloat16, [0, 64, 191],
     "split"),
    ("d96", 2, 96, 8, 8, 96, 16, 20, torch.bfloat16, [0, 30], "tc"),
    ("d96-g4", 2, 100, 8, 2, 96, 12, 20, torch.bfloat16, [0, 30], "tc"),
    ("d96-decode", 3, 1, 32, 32, 96, 16, 12, torch.bfloat16, [0, 64, 191],
     "split"),
    ("d96-f32", 2, 96, 8, 2, 96, 16, 20, torch.float32, [0, 30], "row"),
    ("d96-f32-decode", 3, 1, 8, 2, 96, 16, 12, torch.float32,
     [0, 64, 191], "split"),
    ("d20", 2, 96, 6, 2, 20, 16, 20, torch.bfloat16, [0, 30], "row"),
    ("d20-decode", 3, 1, 6, 2, 20, 16, 12, torch.bfloat16, [0, 64, 191],
     "row"),
    ("d20-f32-decode", 3, 1, 6, 2, 20, 16, 12, torch.float32,
     [0, 64, 191], "split"),
    ("d288", 2, 96, 4, 2, 288, 16, 20, torch.bfloat16, [0, 30],
     "tc_sliced"),
    ("d288-decode", 3, 1, 4, 2, 288, 16, 12, torch.bfloat16, [0, 64, 191],
     "tc_sliced"),
    ("d300", 2, 96, 4, 2, 300, 16, 20, torch.bfloat16, [0, 30], "row"),
    ("d1860", 2, 96, 4, 2, 1860, 16, 20, torch.bfloat16, [0, 30],
     "row_sliced"),
    ("d1190-f32", 2, 96, 4, 2, 1190, 16, 20, torch.float32, [0, 30],
     "row_sliced"),
    # Phi-3-mini's attention at the T 512 bucket and a decode step of
    # [serve]'s tail (8 rows, the batcher's 129-entry table), Phi-2's
    # prefill (32 heads of 80)
    ("phi3-d96", 1, 512, 32, 32, 96, 16, 40, torch.bfloat16, [0], "tc"),
    ("phi3-d96-decode", 8, 1, 32, 32, 96, 16, 129, torch.bfloat16,
     [15, 46, 127, 299, 510, 766, 1023, 1099], "split"),
    ("phi2-d80", 1, 512, 32, 32, 80, 16, 40, torch.bfloat16, [0], "tc"),
    # bf16 calls past D 256 whose rows are 16-byte multiples but which
    # the sliced tensor-core kernel refuses, so the row-tile kernels'
    # 16-byte copies stage them, prefill and decode: G 71 over one kv
    # head at D 512 (the wide form; at D 1024 through 300-slot pages, in
    # chunks of row_chunk_slots), G 65 at D 2048 (the column-sliced
    # form) and a 4097-entry table at D 512 (the wide form)
    ("d512-g71", 1, 9, 71, 1, 512, 16, 12, torch.bfloat16, [40], "row"),
    ("d512-g71-decode", 2, 1, 71, 1, 512, 16, 12, torch.bfloat16,
     [64, 191], "row"),
    ("d1024-g71-s300", 1, 9, 71, 1, 1024, 300, 4, torch.bfloat16, [500],
     "row"),
    ("d2048-g65", 1, 9, 65, 1, 2048, 16, 12, torch.bfloat16, [40],
     "row_sliced"),
    ("d2048-g65-decode", 2, 1, 65, 1, 2048, 16, 12, torch.bfloat16,
     [64, 191], "row_sliced"),
    ("d512-4097-pages", 1, 64, 4, 2, 512, 16, 4097, torch.bfloat16, [600],
     "row"),
    ("d512-4097-pages-decode", 2, 1, 4, 2, 512, 16, 4097, torch.bfloat16,
     [600, 3000], "row"),
)
#: the rows of ``_POOL_GEOMETRIES`` timed beside their bound, plain
#: version and library calls: the ``[serve]`` tail's 300-slot pages,
#: the bf16 prefill rows of the sliced tensor-core kernel at head dims
#: 512, 576, 1024, 1792, 1856 and 2048 and its decode rows at D 512, 576,
#: 1024 and 1856, the row-tile kernel's f32 prefill rows at D 576 and
#: 1024 (the wide form) and 1216 (its sliced form), and the padded head
#: dims: Phi-3-mini's prefill and decode, Phi-2's prefill, bf16 D 20 (the
#: element-wise staging) and D 288 (at 320)
_POOL_TIMED = ("s300", "d512", "d576", "d1024", "d1792", "d1856", "d2048",
               "d512-decode", "d576-decode", "d1024-decode", "d1856-decode",
               "d576-f32", "d1024-f32", "d1216-f32", "phi3-d96",
               "phi3-d96-decode", "phi2-d80", "d20", "d288",
               # the bf16 row-tile kernels past D 256 (G > 64, a 4097-entry
               # table, rows of no 16-byte multiple), prefill and decode
               "d512-g71", "d512-g71-decode", "d2048-g65", "d2048-g65-decode",
               "d512-4097-pages", "d512-4097-pages-decode", "d300", "d1860")


def _pool_geometries(pa, gen):
    """Every row of ``_POOL_GEOMETRIES``: the route it took and the
    kernel against ``paged_attention_ref`` within ``_PAGED_TOL`` (the
    row-tile kernel, its sliced form too, also against
    ``paged_attention_row_ref``, with its chunk ``row_chunk_slots``; the
    tensor-core kernel, its sliced form too, against
    ``paged_attention_tile_ref``); ``_POOL_TIMED`` timed too. Returns the
    rows by label."""
    rows = {}
    for label, b, t, h, kv, d, s, p, dtype, starts, route in \
            _POOL_GEOMETRIES:
        args = _paged_case(b, t, starts,
                           [min(p, (x + t) // s + 1) for x in starts], p,
                           dtype, gen, h=h, kv=kv, d=d, s=s)
        got = _paged_call(pa, f"pool geometry {label}", route, *args)
        err, worst = _paged_check(f"pool geometry {label}", got,
                                  pa.paged_attention_ref(*args),
                                  _PAGED_TOL[dtype])
        rows[label] = dict(route=route, max_abs_err=err,
                           worst_err_over_limit=worst)
        if route in ("row", "row_sliced"):
            rows[label].update(
                chunk_slots=pa.row_chunk_slots(d, s, dtype),
                vs_row_ref=_row_check(pa, f"pool geometry {label}", got,
                                      *args))
        elif route in ("tc", "tc_sliced"):
            rows[label]["vs_tile_ref"] = _tile_check(
                pa, f"pool geometry {label}", got, *args)
        if label in _POOL_TIMED:
            rows[label].update(_geometry_times(pa, args, s, kv))
        del args, got
    torch.cuda.empty_cache()
    print(f"[kernels] paged_attention at pools past the row-tile kernel's "
          f"whole pages and head dims past 256 (route, kernel vs plain), "
          f"card='{_card()}': " + json.dumps(rows), flush=True)
    return rows


def _warm_card(seconds=0.5):
    """Keep the card busy for ``seconds`` before the first timing, so
    the clocks have left the idle state the builds leave it in."""
    x = torch.randn((4096, 4096), device=_DEV).to(torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            x = (x @ x).clamp_(-1, 1)
        torch.cuda.synchronize()


def phase_kernels(pa, gen):
    """Kernel vs plain on the card at the serving path's shapes. Decode
    calls (T·G <= 16) run the split-KV kernel: each is held against
    both plain versions, and the split plain version against the
    other. Prefill runs the tensor-core kernel: held against
    ``paged_attention_ref`` and against its own arithmetic
    (``paged_attention_tile_ref``), then swept over the batcher's
    buckets and held at other geometries and on a pool with NaN past
    each row's last query; last the pools past the row-tile kernel's
    whole pages and the head dims past 256 (``_POOL_GEOMETRIES``)."""
    decode_len = [16, 47, 128, 300, 511, 767, 1024, 1100]
    p_slot = -(-(2048 - 64 + 64 + 8) // _S)        # the batcher's table
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pps = pa.decode_split_pages(8, _KV, p_slot, sms)
    width = pps * _S
    # rows whose lengths sit one below, on and one above split boundaries
    edge_len = [width - 1, width, width + 1, 4 * width - 1, 4 * width,
                4 * width + 1, 8 * width, 8 * width + 1]
    # the longest rows the batcher admits (max_len 2048)
    long_len = np.linspace(1985, 2048, 8).round().astype(int).tolist()
    cases = {
        # T=1 decode: query at position L-1 attends L keys; rows end on
        # a page boundary (16, 128, 1024) or mid-page
        "decode": _paged_case(8, 1, [n - 1 for n in decode_len],
                              [-(-n // _S) for n in decode_len], p_slot,
                              torch.bfloat16, gen),
        # prefill of a 300-token prompt in its 512-column bucket: the
        # kernel sees the whole bucket (q_start 0, T=512) and the row's
        # ceil((512 + 64 + 8) / 16) pages, as the batcher allocates them
        "prefill": _paged_case(1, 512, [0], [-(-(512 + 72) // _S)],
                               p_slot, torch.bfloat16, gen),
        "decode_f32": _paged_case(8, 1, [n - 1 for n in decode_len],
                                  [-(-n // _S) for n in decode_len],
                                  p_slot, torch.float32, gen),
        "decode_edges": _paged_case(8, 1, [n - 1 for n in edge_len],
                                    [-(-n // _S) for n in edge_len],
                                    p_slot, torch.bfloat16, gen),
        "decode_long": _paged_case(8, 1, [n - 1 for n in long_len],
                                   [-(-n // _S) for n in long_len],
                                   p_slot, torch.bfloat16, gen),
    }
    results = {}
    _warm_card()
    for name, (q, kp, vp, table, qs) in cases.items():
        route = "split" if name.startswith("decode") else "tc"
        got = _paged_call(pa, f"paged_attention[{name}]", route, q, kp, vp,
                          table, qs)
        split = route == "split"
        want = pa.paged_attention_ref(q, kp, vp, table, qs)
        tol = _PAGED_TOL[kp.dtype]
        err, worst = _paged_check(f"paged_attention[{name}]", got, want, tol)
        row = dict(max_abs_err=err, worst_err_over_limit=worst, tol=tol)
        if route == "tc":
            row["vs_tile_ref"] = _tile_check(pa, f"paged_attention[{name}]",
                                             got, q, kp, vp, table, qs)
        if split:
            want_split = pa.paged_attention_split_ref(
                q, kp, vp, table, qs, pages_per_split=pps)
            err_s, worst_s = _paged_check(
                f"paged_attention[{name}] vs split plain", got, want_split,
                tol)
            _, worst_r = _paged_check(
                f"paged_attention_split_ref[{name}] vs plain", want_split,
                want, tol)
            row.update(max_abs_err=max(err, err_s),
                       worst_err_over_limit=max(worst, worst_s, worst_r),
                       vs_split_plain=dict(max_abs_err=err_s,
                                           worst_err_over_limit=worst_s),
                       split_plain_vs_plain_worst=worst_r,
                       pages_per_split=pps, n_split=-(-p_slot // pps),
                       live_ctas=_KV * int((qs.long().cpu() // width + 1)
                                           .clamp(max=-(-p_slot // pps))
                                           .sum()))
        bound, by = _bound(q, table, qs, _S, _KV, kp.element_size())
        row.update(ms=_time_ms(lambda: pa.paged_attention(
                       q, kp, vp, table, qs)),
                   plain_ms=_time_ms(lambda: pa.paged_attention_ref(
                       q, kp, vp, table, qs)),
                   bound_ms=bound, bound_by=by,
                   library_ms=_library_ms(q, kp, vp, table, qs, pa),
                   library_gather_ms=_library_gather_ms(q, kp, vp, table,
                                                        qs, pa))
        # after 24 more calls (the split kernel's counters must be back
        # at 0 after each) the same output, bit for bit: the merge adds
        # the splits in one order whichever CTA runs it
        if not torch.equal(pa.paged_attention(q, kp, vp, table, qs), got):
            raise AssertionError(f"paged_attention[{name}] changed between "
                                 f"calls on the same inputs")
        results[name] = row
        print(f"[kernels] paged_attention[{name}] B={q.shape[0]} "
              f"T={q.shape[1]} H={_H} KV={_KV} D={_D} S={_S} "
              f"pool={str(kp.dtype)[6:]} " + json.dumps(row), flush=True)
    results["decode"].update(_split_breakdown(pa, cases["decode"], _card()))
    err, worst = _decode_geometries(pa, gen)
    results["decode_geometries"] = dict(max_abs_err=err,
                                        worst_err_over_limit=worst)
    results["prefill_buckets"] = _prefill_buckets(pa, gen, p_slot)
    results["prefill_geometries"] = _prefill_geometries(pa, gen)
    results["prefill_nan_pool"] = _prefill_nan_pool(pa, gen)
    results["pool_geometries"] = _pool_geometries(pa, gen)

    # dense-cache view: a (B, M, KV, D) cache as identity-table pages of
    # dense_cache_page_size(M) = 128 slots (64 KB of K/V per page in
    # shared memory, past the 48 KB default)
    m = _LM["max_len"]
    ck = torch.randn((8, m, _KV, _D), generator=gen).to(torch.bfloat16)
    cv = torch.randn((8, m, _KV, _D), generator=gen).to(torch.bfloat16)
    q = torch.randn((8, 1, _H, _D), generator=gen).to(torch.bfloat16)
    ck, cv, q = ck.to(_DEV), cv.to(_DEV), q.to(_DEV)
    qs = torch.tensor([n - 1 for n in decode_len], dtype=torch.int32,
                      device=_DEV)
    got = pa.dense_cache_attention(q, ck, cv, qs)
    torch.cuda.synchronize()
    want = pa._attend_grouped(q, ck, cv, qs.long()[:, None], _H, _D ** -0.5)
    tol = _PAGED_TOL[torch.bfloat16]
    err, worst = _paged_check("dense_cache_attention", got, want, tol)
    results["dense_cache"] = dict(max_abs_err=err, worst_err_over_limit=worst)
    print(f"[kernels] dense_cache_attention B=8 M={m} page="
          f"{pa.dense_cache_page_size(m)} max_abs_err={err} worst error / "
          f"limit {worst} (limit rtol·|plain| + atol·rms(plain's row), "
          f"(rtol, atol) = {tol})", flush=True)
    return results


def _paged_check(label, got, want, tol):
    """Max abs error and worst error / limit of a paged-attention output
    (B, T, H, D) against its plain version, the rms taken per query row;
    raises where an element is not finite or past its limit."""
    err, worst = _worst(got, want, *tol, rms_dims=(2, 3))
    if not (torch.isfinite(got).all() and worst <= 1):
        raise AssertionError(f"{label} max abs err {err}, {worst} x its "
                             f"limit")
    return err, worst


def phase_serve(pa, seed):
    """ContinuousBatcher end to end at the flagship width: 16 requests,
    prompt lengths 32..1024 from the seed, 64 new tokens each, in two
    submission waves (the second queues behind the first and is admitted
    into recycled slots and pages)."""
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.models.transformer.serving import (
        ContinuousBatcher, PagedKVCache, _meta_statics, _paged_prefill_impl)
    from bigdl_tpu_torch.tensor import DTypePolicy, set_policy

    # f32 params, bf16 compute, bf16 activations and KV pool (bench.py)
    set_policy(DTypePolicy(param_dtype=torch.float32,
                           compute_dtype=torch.bfloat16,
                           activation_dtype=torch.bfloat16))
    t0 = time.perf_counter()
    model = TransformerLM(**_LM, device=_DEV,
                          generator=torch.Generator().manual_seed(seed))
    model.evaluate()
    print(f"[serve] model built in {time.perf_counter() - t0:.3f} s: "
          f"{sum(p.numel() for p in model.parameters())} params", flush=True)
    rs = np.random.default_rng(seed)
    lens = rs.integers(32, 1025, size=16)
    prompts = [rs.integers(1, _LM["vocab_size"] + 1, size=int(n)).tolist()
               for n in lens]
    new_tokens, max_batch, page = 64, 8, _S
    kw = dict(max_batch=max_batch, page_size=page,
              max_new_tokens=new_tokens, max_burst=8)
    # pages of the longest request (its bucket + budget + burst slack)
    need = -(-(ContinuousBatcher._bucket(int(lens.max())) + new_tokens
               + 8) // page)
    num_pages = max_batch * need + 1                 # + the scratch page

    # warm-up: one short request (cuBLAS handles, the kernel's library)
    warm = ContinuousBatcher(model, num_pages=num_pages, **kw)
    warm.submit("warm", prompts[0][:32])
    warm.run_to_completion()
    del warm
    torch.cuda.synchronize()

    batcher = ContinuousBatcher(model, num_pages=num_pages, **kw)
    torch.cuda.reset_peak_memory_stats()
    pa.launches = pa.split_launches = pa.tc_launches = 0
    pa.tc_sliced_launches = 0
    t0 = time.perf_counter()
    for i in range(8):
        batcher.submit(i, prompts[i])
    bursts = 0
    bursts += batcher.step() > 0
    bursts += batcher.step() > 0
    for i in range(8, 16):
        batcher.submit(i, prompts[i])
    while not batcher.idle:
        bursts += batcher.step() > 0
    results = dict(batcher.finished())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, splits, tcs = pa.launches, pa.split_launches, pa.tc_launches
    peak = torch.cuda.max_memory_allocated()

    expect = _LM["num_layers"] * (16 + 8 * bursts)
    if launches != expect:
        raise AssertionError(f"paged_attention launched {launches} times, "
                             f"expected 12 x (16 prefills + 8 x {bursts} "
                             f"decode steps) = {expect}")
    if splits != _LM["num_layers"] * 8 * bursts:
        raise AssertionError(f"the split-KV kernel ran in {splits} calls, "
                             f"expected every decode call: 12 x 8 x "
                             f"{bursts} = {_LM['num_layers'] * 8 * bursts}")
    if tcs != _LM["num_layers"] * 16:
        raise AssertionError(f"the tensor-core prefill kernel ran in {tcs} "
                             f"calls, expected every prefill call: 12 x 16 "
                             f"= {_LM['num_layers'] * 16}")
    if sorted(results) != list(range(16)) or any(
            len(t) != new_tokens or not all(
                1 <= x <= _LM["vocab_size"] for x in t)
            for t in results.values()):
        raise AssertionError("not every request returned 64 in-vocab "
                             "tokens")
    ttft = np.asarray([batcher.ttft_s[i] for i in range(16)])
    card = _card()
    print(f"[serve] card='{card}' requests=16 prompt_lens={lens.tolist()} "
          f"new_tokens={new_tokens} decode_bursts={bursts} "
          f"kernel_launches={launches} (=12x(16+8x{bursts})) "
          f"of them split-KV decode={splits} (=12x8x{bursts}), "
          f"tensor-core prefill={tcs} (=12x16)", flush=True)
    print(f"[serve] card='{card}' wall_s={wall} "
          f"generated_tok_per_s={16 * new_tokens / wall} "
          f"ttft_p50_s={np.percentile(ttft, 50)} "
          f"ttft_p99_s={np.percentile(ttft, 99)} "
          f"peak_mem_bytes={peak}", flush=True)

    # the first wave once more through the dense plain version: the
    # kernel and dense prefill logits at each prompt's last position
    wave = prompts[:8]
    width = max(batcher._bucket(len(p)) for p in wave)
    n_tab = -(-width // page)
    batch = np.ones((8, width), np.int32)
    for i, p in enumerate(wave):
        batch[i, :len(p)] = p
    lengths = np.asarray([len(p) for p in wave], np.int32)
    table = np.arange(8 * n_tab, dtype=np.int32).reshape(8, n_tab)
    logits = {}
    for mode in ("kernel", "dense"):
        cache = PagedKVCache(_LM["num_layers"], 8 * n_tab, page, _KV, _D,
                             device=_DEV)
        logits[mode] = _paged_prefill_impl(
            model.params, cache, table, batch, lengths,
            **_meta_statics(model, mode, cache)).float()
        del cache
    diff = float((logits["kernel"] - logits["dense"]).abs().max())
    scale = float(logits["dense"].abs().max())
    if not (torch.isfinite(logits["kernel"]).all()
            and diff <= _LOGIT_REL_TOL * scale):
        raise AssertionError(f"kernel vs dense prefill logits differ by "
                             f"{diff} > {_LOGIT_REL_TOL} x {scale}")
    first_k = logits["kernel"].argmax(-1)
    first_d = logits["dense"].argmax(-1)
    served = torch.tensor([results[i][0] - 1 for i in range(8)],
                          device=first_d.device)
    print(f"[serve] kernel vs dense prefill logits (8 prompts, bf16): "
          f"max_abs_diff={diff} max_abs_logit={scale} tol="
          f"{_LOGIT_REL_TOL}x; equal first tokens kernel/dense="
          f"{float((first_k == first_d).float().mean())} "
          f"served/dense={float((served == first_d).float().mean())}",
          flush=True)
    _profile_decode(batcher, prompts[:8], card)
    del batcher
    torch.cuda.empty_cache()
    tails = {}
    for label, widths, page, lens in _SERVE_TAILS:
        lm = model if widths is None else _tail_model(widths, seed)
        tails[label] = _serve_tail(pa, lm, seed, label, page, lens)
        del lm
        torch.cuda.empty_cache()
    return launches, tcs, tails


def _tail_model(widths, seed):
    """A ``TransformerLM`` of ``widths`` at ``_LM``'s vocab, max_len and
    RoPE, weights from the seed (the bf16 policy [serve] set)."""
    from bigdl_tpu_torch.models import TransformerLM
    cfg = dict(_LM, **widths)
    t0 = time.perf_counter()
    model = TransformerLM(**cfg, device=_DEV,
                          generator=torch.Generator().manual_seed(seed))
    model.evaluate()
    print(f"[serve] tail model {widths} built in "
          f"{time.perf_counter() - t0:.3f} s: "
          f"{sum(p.numel() for p in model.parameters())} params",
          flush=True)
    return model


def _serve_tail(pa, model, seed, label, page, prompt_lens):
    """One of ``[serve]``'s tails (``_SERVE_TAILS``): 4 requests through a
    ``ContinuousBatcher`` with pages of ``page`` slots and bf16 pools,
    the counters set to 0 just before and read just after: every prefill
    call on the kernel ``kernel_route`` names for the model's heads (T·G
    past 16), every decode call on the one it names at T 1; then the
    same requests with ``paged_kernel="dense"`` (no launch), their tokens
    compared. Held within ``_LOGIT_REL_TOL`` as ``[serve]`` holds its
    prefill: the prefill logits of both paths, and the logits of one
    decode step over the kernel-prefilled pools, kernel against dense
    (tokens are printed, not held: a near-tie that flips one greedy
    token changes every later one). Returns the run's launches by route
    (split, tc, tc_sliced, row) and its row-tile launches on rows staged
    element by element (unaligned)."""
    from bigdl_tpu_torch.models.transformer.serving import (
        ContinuousBatcher, PagedKVCache, _meta_statics, _paged_prefill_impl)
    meta = model.lm_meta
    layers, h = meta["num_layers"], meta["num_heads"]
    kv = meta["num_kv_heads"] or h
    d = meta["d_model"] // h
    new, n = _TAIL_NEW_TOKENS, _TAIL_REQUESTS
    rs = np.random.default_rng(seed + 1)
    lens = (list(prompt_lens) if prompt_lens is not None
            else rs.integers(300, 1001, size=n).tolist())
    prompts = [rs.integers(1, _LM["vocab_size"] + 1, size=m).tolist()
               for m in lens]
    kw = dict(max_batch=n, page_size=page, max_new_tokens=new, max_burst=8)
    need = -(-(ContinuousBatcher._bucket(max(lens)) + new + 8) // page)
    # every prefill call has more than 16 query rows per kv head
    prefill = pa.kernel_route(pa._SPLIT_ROWS + 1, h, kv, d, page, need,
                              torch.bfloat16)
    decode = pa.kernel_route(1, h, kv, d, page, need, torch.bfloat16)
    tokens, counts = {}, {}
    for mode in ("auto", "dense"):
        batcher = ContinuousBatcher(model, num_pages=n * need + 1,
                                    paged_kernel=mode, **kw)
        pa.launches = pa.split_launches = pa.tc_launches = 0
        pa.tc_sliced_launches = pa.unaligned_launches = 0
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            batcher.submit(i, p)
        bursts = 0
        while not batcher.idle:
            bursts += batcher.step() > 0
        tokens[mode] = dict(batcher.finished())
        torch.cuda.synchronize()
        counts[mode] = dict(wall_s=time.perf_counter() - t0,
                            launches=pa.launches, split=pa.split_launches,
                            tc=pa.tc_launches,
                            tc_sliced=pa.tc_sliced_launches,
                            row=pa.launches - pa.split_launches
                            - pa.tc_launches - pa.tc_sliced_launches,
                            unaligned=pa.unaligned_launches, bursts=bursts)
        del batcher
    k = counts["auto"]
    want = {"split": 0, "tc": 0, "tc_sliced": 0, "row": 0}
    want[prefill] += layers * n
    want[decode] += layers * 8 * k["bursts"]
    if {r: k[r] for r in want} != want:
        raise AssertionError(f"{label}: launches {k}, expected {want}: "
                             f"{layers} x {n} {prefill} prefill calls and "
                             f"{layers} x 8 x bursts {decode} decode calls")
    if counts["dense"]["launches"]:
        raise AssertionError(f"{label}: the dense run launched "
                             f"{counts['dense']['launches']} kernels")
    if sorted(tokens["auto"]) != list(range(n)) or any(
            len(t) != new for t in tokens["auto"].values()):
        raise AssertionError(f"{label}: not every request returned {new} "
                             f"tokens")
    equal = float(np.mean([a == b for i in range(n) for a, b in
                           zip(tokens["auto"][i], tokens["dense"][i])]))
    # the prefill logits at each prompt's last position, both paths
    width = max(ContinuousBatcher._bucket(len(p)) for p in prompts)
    batch = np.ones((n, width), np.int32)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    lengths = np.asarray([len(p) for p in prompts], np.int32)
    # one slot past the longest prompt for the decode step below
    n_tab = -(-(width + 1) // page)
    table = np.arange(n * n_tab, dtype=np.int32).reshape(n, n_tab)
    logits, caches = {}, {}
    for mode in ("kernel", "dense"):
        caches[mode] = PagedKVCache(layers, n * n_tab, page, kv, d,
                                    device=_DEV)
        logits[mode] = _paged_prefill_impl(
            model.params, caches[mode], table, batch, lengths,
            **_meta_statics(model, mode, caches[mode])).float()
    diff = float((logits["kernel"] - logits["dense"]).abs().max())
    scale = float(logits["dense"].abs().max())
    if not (torch.isfinite(logits["kernel"]).all()
            and diff <= _LOGIT_REL_TOL * scale):
        raise AssertionError(f"{label}: kernel vs dense prefill logits "
                             f"differ by {diff} > {_LOGIT_REL_TOL} x "
                             f"{scale}")
    del caches["dense"]
    # the next token at each prompt's end, decoded over the same pools
    table_t = torch.as_tensor(table, device=_DEV)
    lens_t = torch.as_tensor(lengths, dtype=torch.int64, device=_DEV)
    tok0 = logits["kernel"].argmax(-1) + 1
    step = {}
    for mode in ("kernel", "dense"):
        before = (pa.launches, pa.split_launches, pa.tc_launches,
                  pa.tc_sliced_launches)
        step[mode] = _decode_step_logits(model, caches["kernel"], table_t,
                                         lens_t, tok0, mode)
        moved = [a - b for a, b in zip((pa.launches, pa.split_launches,
                                        pa.tc_launches,
                                        pa.tc_sliced_launches), before)]
        by = dict(split=moved[1], tc=moved[2], tc_sliced=moved[3],
                  row=moved[0] - moved[1] - moved[2] - moved[3])
        if by[decode] != (layers if mode == "kernel" else 0) \
                or moved[0] != by[decode]:
            raise AssertionError(f"{label}: the {mode} decode step made "
                                 f"{by} kernel calls, expected "
                                 f"{layers} {decode} calls or none")
    del caches
    step_diff = float((step["kernel"] - step["dense"]).abs().max())
    step_scale = float(step["dense"].abs().max())
    if not (torch.isfinite(step["kernel"]).all()
            and step_diff <= _LOGIT_REL_TOL * step_scale):
        raise AssertionError(f"{label}: kernel vs dense decode-step "
                             f"logits differ by {step_diff} > "
                             f"{_LOGIT_REL_TOL} x {step_scale}")
    print(f"[serve] card='{_card()}' tail {label}: {layers} layers, {h} "
          f"heads over {kv} kv heads, D {d}, pages of {page} slots (bf16 "
          f"pools; prefill on the {prefill} kernel, decode on the "
          f"{decode} kernel): requests={n} prompt_lens={lens} "
          f"new_tokens={new} kernel run " + json.dumps(counts["auto"])
          + " dense run " + json.dumps(counts["dense"])
          + f" equal tokens kernel/dense={equal}; prefill logits "
          f"max_abs_diff={diff} max_abs_logit={scale}; decode-step logits "
          f"({decode} vs dense) max_abs_diff={step_diff} max_abs_logit="
          f"{step_scale} tol={_LOGIT_REL_TOL}x", flush=True)
    return {r: k[r] for r in ("split", "tc", "tc_sliced", "row",
                              "unaligned")}


def _decode_step_logits(model, cache, table, lengths, tok, mode):
    """The logits of one greedy decode step of ``_paged_decode_impl`` over
    ``cache`` (``table``, ``lengths`` and ``tok`` tensors on the card),
    read where the step hands them to its sampler: the step returns
    tokens only. The step writes its own K/V slot before it attends, so
    both modes may run over one cache."""
    from bigdl_tpu_torch.models.transformer import serving as sv
    seen, real = [], sv._row_logits

    def keep(*a):
        seen.append(real(*a))
        return seen[-1]

    sv._row_logits = keep
    try:
        sv._paged_decode_impl(
            model.params, cache, table, lengths, tok, n_new=1,
            temperature=0.0, top_k=None,
            **sv._meta_statics(model, mode, cache))
    finally:
        sv._row_logits = real
    return seen[0].float()


def _profile_decode(batcher, prompts, card):
    """Where a decode step's device time goes: 8 requests admitted (one
    step: prefills and a burst), then ``_profile_steps`` over two more
    8-step decode bursts of all 8 rows (after one to warm), kernels by
    kind; prints paged attention's device ms a decode step, the rest of
    the step's device ms and the device's idle share."""
    for i, p in enumerate(prompts):
        batcher.submit(("profile", i), p)
    batcher.step()
    burst = batcher._resolve_burst(None)
    kinds, wall_ms = _profile_steps(
        lambda state, *_: (state, batcher.step()), None, None, None,
        "serve", card, kind=lambda n: ("paged_attention" if "paged_" in
                                       n.lower() else _lm_kind(n)),
        shape=f"{len(prompts)} rows, bursts of {burst} decode steps")
    busy = sum(kinds.values())
    paged = kinds.get("paged_attention", 0.0)
    print(f"[serve] card='{card}' decode step (profiled bursts / {burst}): "
          f"paged_attention_device_ms={paged / burst} "
          f"rest_device_ms={(busy - paged) / burst} "
          f"wall_ms={wall_ms / burst} device_idle_share="
          f"{1 - busy / wall_ms if busy else 'not measured'}", flush=True)
    batcher.run_to_completion()


#: the flash kernel of each count of half-products
_FLASH_KERNELS = {2: "fwd", 3: "dq", 4: "dkdv"}


def _flash_flops(b, s, h, d, half_products):
    """Operations of one flash kernel at (b, s, h, d), causal: 2·d per
    (q, k) pair of the causal half and per half-product."""
    return 2 * d * half_products * (b * h * s * (s + 1) // 2)


def _flash_bytes_ms(b, s, h, d, dtype, half_products):
    """Least time for one flash kernel's bytes at (b, s, h, d): each input
    read once and each output written once over the memory rate."""
    elt = torch.finfo(dtype).bits // 8
    rows = b * s * h
    # fwd: q, k, v in, o and lse out; dq: q, k, v, dO, lse, delta in, dq
    # out; dkdv: the same in, dk and dv out
    tensors, row_arrays = {2: (4, 1), 3: (5, 2), 4: (6, 2)}[half_products]
    bytes_ = tensors * rows * d * elt + row_arrays * rows * 4
    return bytes_ / _HBM_BYTES_PER_S * 1e3


def _flash_bound(b, s, h, d, dtype, half_products):
    """Least time for one flash kernel at (b, s, h, d), causal: its bytes
    (``_flash_bytes_ms``) vs the operations the causal half needs over
    the peak for the dtype's arithmetic."""
    flops = _flash_flops(b, s, h, d, half_products)
    peak = _BF16_FLOPS if dtype == torch.bfloat16 else _F32_FLOPS
    tb = _flash_bytes_ms(b, s, h, d, dtype, half_products)
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _tf32_bound(b, s, h, d, half_products):
    """The 3xTF32 kernels' own bound (f32 past D 256): three
    tensor-core TF32 products for each multiply of the f32 function, the
    causal half's operations x 3 over the TF32 peak (or the bytes, where
    they take longer)."""
    tf = 3 * _flash_flops(b, s, h, d, half_products) / _TF32_FLOPS * 1e3
    tb = _flash_bytes_ms(b, s, h, d, torch.float32, half_products)
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _flash_kernel_bound(fa, b, s, h, d, dtype, half_products):
    """(bound ms, bound_by, other fields) of the flash kernel of
    ``half_products`` (2 forward, 3 dq, 4 dk/dv) on its route
    (``flash_route(dtype, d, kernel)``): ``_flash_bound`` (bf16), or for
    the 3xTF32 kernels (``fa.TF32_ROUTES``: every f32 one, on the tensor
    cores) ``_tf32_bound``, with the f32 CUDA-core bound beside it as
    ``bound_f32_cuda_cores_ms``."""
    route = fa.flash_route(dtype, d, _FLASH_KERNELS[half_products])
    bound, by = _flash_bound(b, s, h, d, dtype, half_products)
    if route not in fa.TF32_ROUTES:
        return bound, by, {}
    return (*_tf32_bound(b, s, h, d, half_products),
            {"bound_f32_cuda_cores_ms": bound})


def _peak_mib(call):
    """MiB the card's allocator holds at most during ``call`` beyond what
    it held before (its outputs and any workspace)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def _worst(got, want, rtol, atol, rms_dims=None):
    """Max abs error of ``got`` against ``want``, and the worst ratio of
    an element's error to its limit rtol·|want| + atol·rms(want) (pass:
    <= 1); the rms over all of ``want``, or over ``rms_dims`` (kept per
    slice of the other dims). atol alone (rtol None) is an absolute
    limit."""
    diff = (got.float() - want.float()).abs()
    w = want.float()
    if rtol is None:
        limit = atol
    else:
        rms = (w.square().mean(dim=rms_dims, keepdim=True) if rms_dims
               else w.square().mean()).sqrt()
        limit = rtol * w.abs() + atol * rms
    return float(diff.max()), float((diff / limit).max())


def _flash_tol(dtype, what, d):
    """(rtol, atol) of flash output ``what`` ("o" or a gradient) in
    ``dtype`` at head dim ``d`` (``_FLASH_TOL``'s comment)."""
    if what != "o" and dtype == torch.bfloat16 and d <= 64:
        return _FLASH_NARROW_GRAD_TOL
    return _FLASH_TOL[(dtype, "o" if what == "o" else "grad")]


def _flash_err(what, got, want):
    """Max abs error of one flash output against its plain version, and
    the worst ratio of an element's error to its limit (pass: <= 1)."""
    if what == "lse":
        return _worst(got, want, None, _LSE_TOL)
    return _worst(got, want, *_flash_tol(want.dtype, what, want.shape[-1]))


def _flash_entry_outputs(fa, q, k, v, do, causal):
    """o, lse, dq, dk, dv of ``flash_attention_with_lse``, the backward
    through autograd from the cotangent dO of o. It is given no scale, so
    it takes it from the true head dim; at a head dim the kernels are not
    built for it pads q, k and v, runs the kernels at the padded width
    and slices o back: its own logic, which the plain versions at the
    true head dim hold."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
    return (o.detach(), lse.detach(),
            *torch.autograd.grad(o, (q, k, v), do))


def _flash_fwd_refs(fa, q, k, v, scale, causal):
    """o and lse of the plain forward, the f32 one evaluated in float64 on
    the same inputs (``flash_fwd_ref`` keeps float64 inputs in float64)
    and rounded to f32, as ``_flash_bwd_refs`` holds the backward; bf16
    as it is, its rounding points kept."""
    if q.dtype != torch.float32:
        return fa.flash_fwd_ref(q, k, v, scale, causal)
    o, lse = fa.flash_fwd_ref(q.double(), k.double(), v.double(), scale,
                              causal)
    return o.float(), lse.float()


def _flash_bwd_refs(fa, q, k, v, do, lse, delta, scale, causal):
    """dq, dk, dv of the plain versions, the f32 ones evaluated in float64
    on the same inputs (lse and delta as given) and rounded to f32: in f32
    their own sums (cuBLAS's FMA chain over D) stray from the exact
    function past the f32 limits where dS = P∘(dP - delta) cancels
    (PERF.md, Findings). bf16 keeps its rounding points, in f32."""
    if q.dtype == torch.float32:
        q, k, v, do, lse, delta = (x.double()
                                   for x in (q, k, v, do, lse, delta))
    got = (fa.flash_dq_ref(q, k, v, do, lse, delta, scale, causal),
           *fa.flash_dkdv_ref(q, k, v, do, lse, delta, scale, causal))
    return tuple(g.float() if g.dtype == torch.float64 else g for g in got)


def _flash_outputs(fa, q, k, v, do, scale, causal, kernel):
    """o, lse, dq, dk, dv of the kernels (``kernel``) or their plain
    versions at the true head dim (by ``_flash_fwd_refs`` and
    ``_flash_bwd_refs``: the f32 ones in float64), the backward from the
    plain forward's lse and delta. At a head dim the kernels are not
    built for (``padded_head_dim``) the kernels' outputs are those of the
    entry (``_flash_entry_outputs``: padded by the entry, the backward
    from its own lse and o; ``scale`` must be the true D's)."""
    ro, rlse = _flash_fwd_refs(fa, q, k, v, scale, causal)
    delta = (do.float() * ro.float()).sum(-1)
    if not kernel:
        return (ro, rlse, *_flash_bwd_refs(fa, q, k, v, do, rlse, delta,
                                           scale, causal))
    if fa.padded_head_dim(q.shape[-1]) != q.shape[-1]:
        return _flash_entry_outputs(fa, q, k, v, do, causal)
    o, lse = fa.flash_fwd(q, k, v, scale, causal)
    return (o, lse, fa.flash_dq(q, k, v, do, rlse, delta, scale, causal),
            *fa.flash_dkdv(q, k, v, do, rlse, delta, scale, causal))


def _flash_compare(got, want, label):
    """Max abs error of each output; raises where one is not finite or
    past its limit."""
    errs, worst = {}, {}
    for what, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        errs[what], worst[what] = _flash_err(what, g, w)
        if not (torch.isfinite(g).all() and worst[what] <= 1):
            raise AssertionError(
                f"flash {what} {label}: max abs err {errs[what]}, "
                f"{worst[what]} x its limit")
    return errs, worst


def _flash_tails(fa, gen):
    """Ragged tile tails on the card: sequence lengths that 64 does not
    divide, Sq != Skv (non-causal), every head dim and dtype; in bf16
    also a 128-row tile with a ragged tail (S 200, Skv 136) and each
    head dim both causal and not. Head dim 32 is the train main's
    default width (d_model 128, 4 heads); 192 and 256 run the tiles past
    D 128 (64-key forward tiles, one-warpgroup dq, the split dk/dv
    kernel; f32 tiles of 32 rows), both causal and not in each dtype;
    320, 384 and 512 the D-sliced kernels (5, 6 and 8 slices of 64
    columns), both causal and not in each dtype, and in bf16 also 448,
    576, 640 and 1024: the bf16 forward, dq and dk/dv past 256 on the
    sliced tensor-core kernels (slices of 3 + 2, 3 + 3, 4 + 3, 4 + 4, 3 x
    3, 4 + 4 + 2 and 4 x 4 chunks; the forward's Q resident up to 576
    and streamed past it, dq's Q resident up to 384; the forward's and
    dq's query tiles paired where the causal grid fits one wave, and
    unpaired at B4 S1000 H8 D512; at S 300, 5 tiles, the middle one
    alone; their SASS is held to HGMMA by ``_check_tensor_cores``); f32
    at 576 and 1024 too: the 3xTF32 forward, dq and dk/dv, also at S 300
    (five tiles, causal), at Sq 300 / Skv 136 (D 320 and 512, not
    causal), on the 512-CTA causal grid, where the forward's and dq's
    slice is 8 chunks wide, at B2 S2048 H2 D1024 causal, where dS
    cancels in the first row of each (b, h), and at D 512 with a ramp
    along the keys' positions (``ramp``), causal and not, so the
    forward's running max rises at every key tile and each tile rescales
    o by α = exp(m_old - m_new) far from 1. The f32 forward, dq and
    dk/dv at head dims 32, 64, 128, 192 and 256 (the 3xTF32 kernels: the
    forward and dq up to 128 in CTAs of 128 rows, the others one slice of
    all of D) also at S 300, causal and not, and at Sq 300 / Skv 136,
    and the forward's ramp at D 32 and 128 (its 128-row kernel, whose
    warpgroups each run the softmax of their own rows) and 256. Head
    dims 16, 80, 96 and 288, both causal and not in each dtype, go
    through ``flash_attention_with_lse`` and autograd, which run the
    kernels zero-padded to 32, 128, 128 and 320 (``padded_head_dim``),
    held against the plain versions at the true head dim. The f32
    outputs are held to the plain versions evaluated in float64
    (``_flash_outputs``)."""
    def tail(b, sq, skv, h, d, causal, dtype, ramp=0.0):
        q, do = (torch.randn((b, sq, h, d), generator=gen).to(dtype)
                 .to(_DEV) for _ in range(2))
        k, v = (torch.randn((b, skv, h, d), generator=gen).to(dtype)
                .to(_DEV) for _ in range(2))
        if ramp:
            # q leans toward the all-ones direction (its elements' mean
            # 1/4), and key s gains ramp·s/skv in every element: the
            # scores rise by about ramp·D^0.5/4 from the first key to the
            # last
            q += 0.25
            k += ramp * (torch.arange(skv, device=_DEV, dtype=dtype)
                         / skv)[None, :, None, None]
        got = _flash_outputs(fa, q, k, v, do, d ** -0.5, causal, True)
        torch.cuda.synchronize()
        want = _flash_outputs(fa, q, k, v, do, d ** -0.5, causal, False)
        label = (f"tails B={b} Sq={sq} Skv={skv} H={h} D={d} "
                 f"causal={causal} {str(dtype)[6:]}"
                 + (f" ramp={ramp}" if ramp else ""))
        errs, worst = _flash_compare(got, want, label)
        print(f"[kernels] flash {label} max abs errs " + json.dumps(errs)
              + " worst error / limit " + json.dumps(worst), flush=True)

    for b, sq, skv, h, d, causal, dtype in (
            (2, 100, 100, 3, 32, True, torch.float32),
            (1, 130, 200, 2, 32, False, torch.float32),
            (2, 100, 100, 3, 32, True, torch.bfloat16),
            (1, 200, 136, 2, 32, False, torch.bfloat16),
            (4, 128, 128, 4, 32, True, torch.bfloat16),
            (2, 100, 100, 3, 64, True, torch.float32),
            (2, 100, 77, 3, 64, False, torch.bfloat16),
            (1, 130, 200, 2, 128, False, torch.float32),
            (1, 130, 130, 2, 128, True, torch.bfloat16),
            (2, 100, 100, 3, 64, True, torch.bfloat16),
            (1, 130, 200, 2, 128, False, torch.bfloat16),
            (1, 200, 136, 2, 128, False, torch.bfloat16),
            (1, 200, 200, 2, 128, True, torch.bfloat16),
            (2, 100, 100, 3, 192, True, torch.float32),
            (1, 130, 77, 2, 192, False, torch.float32),
            (2, 100, 100, 3, 192, True, torch.bfloat16),
            (1, 200, 136, 2, 192, False, torch.bfloat16),
            (2, 100, 100, 3, 256, True, torch.float32),
            (1, 130, 200, 2, 256, False, torch.float32),
            (1, 200, 200, 2, 256, True, torch.bfloat16),
            (1, 130, 77, 2, 256, False, torch.bfloat16),
            *((b_, sq_, skv_, 2, d_, c_, t_)
              for d_ in (320, 384, 512, 576, 1024)
              for b_, sq_, skv_, c_, t_ in (
                  (2, 200, 200, True, torch.float32),
                  (1, 130, 200, False, torch.float32),
                  (2, 200, 200, True, torch.bfloat16),
                  (1, 200, 136, False, torch.bfloat16))),
            *((b_, sq_, skv_, 2, d_, c_, torch.bfloat16)
              for d_ in (448, 640)
              for b_, sq_, skv_, c_ in ((2, 200, 200, True),
                                        (1, 130, 77, False))),
            # a causal grid past one wave of the card (512 CTAs): the
            # sliced bf16 forward's and dq's query tiles unpaired,
            # heaviest first; the f32 dq's slices of up to 8 chunks
            # (one at D 512: 4 a warpgroup)
            *((4, 1000, 1000, 8, 512, True, t_)
              for t_ in (torch.bfloat16, torch.float32)),
            # five 64-row tiles, paired: the middle tile alone (a
            # forward or dq warpgroup with no rows); in f32 ragged
            # tiles of 3xTF32 dq and dk/dv, causal
            *((2, 300, 300, 2, d_, True, t_)
              for d_ in (384, 512, 1024)
              for t_ in (torch.bfloat16, torch.float32)),
            # f32, ragged and Sq != Skv, not causal
            *((1, 300, 136, 2, d_, False, torch.float32)
              for d_ in (320, 512)),
            # the f32 3xTF32 dq and dk/dv at the head dims up to 256 (dq
            # up to 128 in 128-row CTAs: three, the last ragged; the
            # others one slice of all of D, at D 32 half a chunk): S 300,
            # causal and not, and Sq 300 / Skv 136, not causal
            *((b_, 300, skv_, 2, d_, c_, torch.float32)
              for d_ in (32, 64, 128, 192, 256)
              for b_, skv_, c_ in ((2, 300, True), (2, 300, False),
                                   (1, 136, False))),
            # f32 3xTF32 dq and dk/dv at the widest head dim, causal,
            # over 2048 rows: row 0 of each (b, h) sees key 0 alone, so
            # dS = P∘(dP - delta) cancels there and dP's own error shows
            # whole in dq's row 0 and dk's row 0
            (2, 2048, 2048, 2, 1024, True, torch.float32),
            *((b_, sq_, skv_, 2, d_, c_, t_)
              for d_ in (16, 80, 96, 288)
              for b_, sq_, skv_, c_, t_ in (
                  (2, 200, 200, True, torch.float32),
                  (1, 130, 200, False, torch.float32),
                  (2, 200, 200, True, torch.bfloat16),
                  (1, 200, 136, False, torch.bfloat16)))):
        tail(b, sq, skv, h, d, causal, dtype)
    # the forward's running max rising at every key tile (some 11 over
    # the keys at D 512: about 2 a 64-key tile), at D 512 and on the
    # kernels up to D 256
    for b, sq, skv, causal in ((2, 300, 300, True), (1, 200, 500, False)):
        for d in (32, 128, 256, 512):
            tail(b, sq, skv, 2, d, causal, torch.float32, ramp=2.0)


def _sdpa_ms(qt, kt, vt, dot):
    """SDPA's forward ms and its backward ms (autograd's forward +
    backward minus the forward: one call that gives dq, dk and dv
    together), causal, on (B, H, S, D) copies; (None, None, why) where
    SDPA refuses the shape."""
    import torch.nn.functional as F
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        out.backward(dot)
    try:
        lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        return lib_fwd, _time_ms(sdpa_fwd_bwd) - lib_fwd, None
    except RuntimeError as e:
        return None, None, f"SDPA refused: {str(e)[:200]}"


def _flash_timed(fa, gen, b, s, h, d):
    """The three flash kernels vs their plain versions at (b, s, h, d),
    causal, bf16 (tensor cores) and f32 (3xTF32 on the tensor cores),
    each timed beside its bound (``_flash_kernel_bound``: in f32 the
    3xTF32 one with the CUDA-core one beside it), its
    plain version and SDPA, with the memory it allocates (``_peak_mib``:
    outputs, and the 3xTF32 kernels' workspace), each row naming its
    route (``kernel``); rows by (kernel, dtype). At a
    head dim the kernels run zero-padded, the errors are those of
    ``flash_attention_with_lse`` and autograd against the plain versions
    at the true head dim (``_flash_outputs``), and the kernels are
    timed on operands padded as the entry pads them (``padded_to``; the
    padding, done outside the timed call, is ``pad_ms``: q, k and v, once
    a forward), the bound, the plain versions and SDPA at the true head
    dim."""
    import torch.nn.functional as F
    scale = d ** -0.5
    width = fa.padded_head_dim(d)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen).to(dtype)
                       .to(_DEV) for _ in range(4))
        got = _flash_outputs(fa, q, k, v, do, scale, True, True)
        torch.cuda.synchronize()
        want = _flash_outputs(fa, q, k, v, do, scale, True, False)
        errs, worst = _flash_compare(got, want, f"[{name}] D={d}")
        rlse = want[1]
        delta = (do.float() * want[0].float()).sum(-1)
        del got, want
        # the library's layout is (B, H, S, D): transposed copies, made
        # outside the timed calls
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        lib_fwd, lib_bwd, refused = _sdpa_ms(qt, kt, vt, dot)
        qp, kp, vp, dop = (F.pad(x, (0, width - d)) if width != d else x
                           for x in (q, k, v, do))
        kernels = {
            "flash_fwd": (lambda: fa.flash_fwd(qp, kp, vp, scale, True),
                          lambda: fa.flash_fwd_ref(q, k, v, scale, True),
                          2, lib_fwd, max(errs["o"], errs["lse"])),
            "flash_dq": (lambda: fa.flash_dq(qp, kp, vp, dop, rlse, delta,
                                             scale, True),
                         lambda: fa.flash_dq_ref(q, k, v, do, rlse, delta,
                                                 scale, True),
                         3, lib_bwd, errs["dq"]),
            "flash_dkdv": (lambda: fa.flash_dkdv(qp, kp, vp, dop, rlse,
                                                 delta, scale, True),
                           lambda: fa.flash_dkdv_ref(q, k, v, do, rlse,
                                                     delta, scale, True),
                           4, lib_bwd, max(errs["dk"], errs["dv"])),
        }
        pad_ms = (_time_ms(lambda: [F.pad(x, (0, width - d))
                                    for x in (q, k, v)])
                  if width != d else None)
        for kname, (kern, plain, halves, lib, err) in kernels.items():
            bound, by, more = _flash_kernel_bound(fa, b, s, h, d, dtype,
                                                  halves)
            ms = _time_ms(kern)
            row = dict(kernel=fa.flash_route(dtype, d, kname[6:]),
                       max_abs_err=err, ms=ms, plain_ms=_time_ms(plain),
                       bound_ms=bound, bound_by=by, library_ms=lib,
                       tflops=_flash_flops(b, s, h, d, halves) / ms / 1e9,
                       share_of_bound=bound / ms, peak_mib=_peak_mib(kern),
                       **more)
            if refused:
                row["library"] = refused
            if width != d:
                row.update(padded_to=width, pad_ms=pad_ms)
            rows[(kname, dtype)] = row
            print(f"[kernels] {kname}[{name}] B={b} S={s} H={h} D={d} "
                  f"causal " + json.dumps(row), flush=True)
        o_tol, g_tol = (_flash_tol(dtype, w, d) for w in ("o", "dq"))
        print(f"[kernels] flash [{name}] D={d} max abs errs vs plain "
              + json.dumps(errs) + " worst error / limit "
              + json.dumps(worst) + f" (limit rtol·|plain| + atol·"
              f"rms(plain): o {o_tol}, dq/dk/dv {g_tol}; lse {_LSE_TOL})",
              flush=True)
        del q, k, v, do, qt, kt, vt, dot, qp, kp, vp, dop
        torch.cuda.empty_cache()
    return rows


def _flash_main_shape(fa, gen):
    """The kernels past D 256 at ``[perf]``'s ``-m attention`` D 512 shape
    (``_PERF_ATTENTION``'s last: B4 S4096 H2, causal; past one wave of
    the card, so query tiles unpaired, as the main path runs them), in
    bf16 (the sliced tensor-core kernels) and f32 (the 3xTF32 forward, dq
    and dk/dv): o and lse held against ``flash_fwd_ref``,
    dq against ``flash_dq_ref`` and dk, dv against ``flash_dkdv_ref``
    (from the plain forward's lse and delta) within ``_FLASH_TOL``, then
    each timed beside its bound (``_flash_kernel_bound``), its plain
    version and SDPA's forward or whole backward, with the memory it
    allocates (``_peak_mib``: outputs, and the 3xTF32 kernels'
    workspace). The ``{"kernels"}`` line's D 512 rows, by (kernel name,
    dtype)."""
    a = _PERF_ATTENTION[-1]
    b, s, h, d = a["batch"], a["seq"], a["heads"], a["head_dim"]
    scale = d ** -0.5
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen)
                       .to(dtype).to(_DEV) for _ in range(4))
        got = _flash_outputs(fa, q, k, v, do, scale, True, True)
        torch.cuda.synchronize()
        want = _flash_outputs(fa, q, k, v, do, scale, True, False)
        label = f"B={b} S={s} H={h} D={d} causal {name}"
        errs, worst = _flash_compare(got, want, f"{label} (main shape)")
        rlse = want[1]
        delta = (do.float() * want[0].float()).sum(-1)
        del got, want
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        lib_fwd, lib_bwd, refused = _sdpa_ms(qt, kt, vt, dot)
        del qt, kt, vt, dot
        kernels = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale, True),
                          lambda: fa.flash_fwd_ref(q, k, v, scale, True),
                          2, lib_fwd, max(errs["o"], errs["lse"])),
            "flash_dq": (lambda: fa.flash_dq(q, k, v, do, rlse, delta,
                                             scale, True),
                         lambda: fa.flash_dq_ref(q, k, v, do, rlse, delta,
                                                 scale, True),
                         3, lib_bwd, errs["dq"]),
            "flash_dkdv": (lambda: fa.flash_dkdv(q, k, v, do, rlse, delta,
                                                 scale, True),
                           lambda: fa.flash_dkdv_ref(q, k, v, do, rlse,
                                                     delta, scale, True),
                           4, lib_bwd, max(errs["dk"], errs["dv"])),
        }
        for kname, (kern, plain, halves, lib, err) in kernels.items():
            bound, by, more = _flash_kernel_bound(fa, b, s, h, d, dtype,
                                                  halves)
            ms = _time_ms(kern)
            row = dict(
                kernel=fa.flash_route(dtype, d, kname[6:]),
                max_abs_err=err, ms=ms, plain_ms=_time_ms(plain),
                bound_ms=bound, bound_by=by, library_ms=lib,
                tflops=_flash_flops(b, s, h, d, halves) / ms / 1e9,
                share_of_bound=bound / ms, peak_mib=_peak_mib(kern),
                **more)
            if refused:
                row["library"] = refused
            rows[(kname, dtype)] = row
            print(f"[kernels] {kname}[{name}] {label} (the main path's "
                  f"shape) " + json.dumps(row), flush=True)
        print(f"[kernels] flash {label} (the main path's shape) max abs "
              f"errs " + json.dumps(errs) + " worst error / limit "
              + json.dumps(worst), flush=True)
        del q, k, v, do
        torch.cuda.empty_cache()
    return rows


def _flash_narrow(fa, gen):
    """bf16 fwd, dq and dk/dv in full at ``_FLASH_NARROW`` (B4 S2048 H16
    D64, causal) against their plain versions, within ``_FLASH_TOL``'s
    limits at D 64."""
    c = _FLASH_NARROW
    b, s, h, d = c["batch"], c["seq"], c["heads"], c["head_dim"]
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen)
                   .to(torch.bfloat16).to(_DEV) for _ in range(4))
    got = _flash_outputs(fa, q, k, v, do, d ** -0.5, True, True)
    torch.cuda.synchronize()
    want = _flash_outputs(fa, q, k, v, do, d ** -0.5, True, False)
    label = f"B={b} S={s} H={h} D={d} causal bfloat16"
    errs, worst = _flash_compare(got, want, label)
    print(f"[kernels] flash {label} max abs errs " + json.dumps(errs)
          + " worst error / limit " + json.dumps(worst) + " (limit "
          f"rtol·|plain| + atol·rms(plain): o "
          f"{_flash_tol(torch.bfloat16, 'o', d)}, dq/dk/dv "
          f"{_flash_tol(torch.bfloat16, 'dq', d)})", flush=True)
    del got, want, q, k, v, do
    torch.cuda.empty_cache()


def phase_flash(fa, gen):
    """The three flash kernels vs their plain versions on ragged tails
    and in bf16 at ``_FLASH_NARROW``, then timed at the training shapes
    (B4 S2048 H8 D128, causal), at head dim 256 (B4 S2048 H4 D256) and at
    512 (B2 S2048 H2, the D-sliced kernels), bf16 (tensor cores) and f32
    (``_flash_timed``'s routes); SDPA as the library yardstick. Each row
    also gives the kernel's rate over the causal half's operations and
    its share of the bound (bound_ms / ms). Rows by (kernel, dtype, head
    dim), each naming its route (in f32 all three in 3xTF32 at every
    head dim); under
    "main_shape" the kernels past D 256, both dtypes, held and timed at
    ``-m attention``'s B4 S4096 H2 D512 as well (at B2 S2048 the
    forward's and dq's causal grids fit one wave of SMs and pair their
    query tiles; at B4 S4096 they do not). Then at the padded head dims of
    ``_FLASH_PADDED``: the kernels on zero-padded operands, the rest at
    the true head dim."""
    _flash_tails(fa, gen)
    _flash_narrow(fa, gen)
    rows = {}
    for b, s, h, d in ((_TRAIN["batch"], _TRAIN["seq"], _TRAIN["heads"],
                        _TRAIN["d_model"] // _TRAIN["heads"]),
                       *((w["batch"], w["seq"], w["heads"], w["head_dim"])
                         for w in (_FLASH_WIDE, _FLASH_SLICED)
                         + _FLASH_PADDED)):
        for (kname, dtype), row in _flash_timed(fa, gen, b, s, h, d).items():
            rows[(kname, dtype, d)] = row
    rows["main_shape"] = _flash_main_shape(fa, gen)
    return rows


def _write_text(folder: Path, seed: int, vocab_words: int) -> None:
    """About 20 sentences of about 2100 words, every word w0..w{n-1} at
    least once, order and fill drawn from the seed."""
    rs = np.random.default_rng(seed)
    n_sent, per = 20, 2100
    words = np.concatenate([rs.permutation(vocab_words),
                            rs.integers(0, vocab_words,
                                        size=n_sent * per - vocab_words)])
    rs.shuffle(words)
    lines = [" ".join(f"w{i}" for i in chunk) + "."
             for chunk in np.split(words, n_sent)]
    (folder / "input.txt").write_text(" ".join(lines))


def _train_main_run(fa, seed, geo, tag):
    """The port's train main at geometry ``geo`` (a ``_TRAIN``-like dict)
    on a text generated from the seed, the flash counters set to 0 just
    before and read just after: exact launch counts (12 fwd a step and
    validation batch, 12 dq and dkdv a step), finite losses, the first
    within 0.5 of ln(vocab). Prints the run's numbers; returns the
    optimizer and the launch counts."""
    from bigdl_tpu_torch.models.transformer import train
    from bigdl_tpu_torch.utils.random import RandomGenerator

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        folder = Path(tmp)
        _write_text(folder, seed, geo["vocab"] - 1)
        torch.manual_seed(seed)
        RandomGenerator.set_seed(seed)
        torch.cuda.reset_peak_memory_stats()
        fa.fwd_launches = fa.dq_launches = fa.dkdv_launches = 0
        t0 = time.perf_counter()
        opt = train.main(["-f", str(folder), "--vocabSize",
                          str(geo["vocab"] - 1), "--dModel",
                          str(geo["d_model"]), "--numHeads",
                          str(geo["heads"]), "--numLayers",
                          str(geo["layers"]), "--seqLength",
                          str(geo["seq"]), "-b", str(geo["batch"]),
                          "-e", str(geo["epochs"]), "--device", _DEV])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
                    "dkdv": fa.dkdv_launches}
        peak = torch.cuda.max_memory_allocated()
    hist = opt.history
    losses = [h["loss"] for h in hist]
    steps = len(hist)
    val_batches = sum(1 for _ in opt.validation_dataset.data(train=False))
    passes = len(opt.validation_results)
    layers = geo["layers"]
    expect = {"fwd": layers * (steps + passes * val_batches),
              "dq": layers * steps, "dkdv": layers * steps}
    if launches != expect:
        raise AssertionError(f"{tag} flash launches {launches}, expected "
                             f"{expect} ({steps} steps, {passes} x "
                             f"{val_batches} validation batches)")
    if not all(math.isfinite(x) for x in losses) or steps == 0:
        raise AssertionError(f"{tag} non-finite training loss: {losses}")
    if abs(losses[0] - math.log(geo["vocab"])) > 0.5:
        raise AssertionError(f"{tag} first loss {losses[0]} not within 0.5 "
                             f"of ln {geo['vocab']}")
    timed = sum(h["step_time"] for h in hist[1:])
    card = _card()
    val = [round(r["Loss"].result()[0], 6) for _, r in
           opt.validation_results]
    head_dim = geo["d_model"] // geo["heads"]
    print(f"[{tag}] card='{card}' head_dim={head_dim} steps={steps} "
          f"first_loss={losses[0]} losses={losses} validation_losses={val} "
          f"flash_launches={launches} (={layers}x{steps} bwd, "
          f"{layers}x({steps}+{passes}x{val_batches}) fwd)", flush=True)
    print(f"[{tag}] card='{card}' head_dim={head_dim} wall_s={wall} "
          f"steps_per_s={(steps - 1) / timed} tokens_per_s="
          f"{(steps - 1) * geo['batch'] * geo['seq'] / timed} "
          f"(over steps 2..{steps}, host step times with the loss "
          f"readback shared across each window) peak_mem_bytes={peak}",
          flush=True)
    return opt, launches


def phase_train(fa, seed):
    """The port's train main at the flagship training geometry: two
    epochs of SGD on a generated text, then one batch once more with the
    plain attention (``flash=False``) to hold loss and gradients."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.tensor import DTypePolicy, set_policy

    set_policy(DTypePolicy(param_dtype=torch.float32,
                           compute_dtype=torch.bfloat16,
                           activation_dtype=torch.bfloat16))
    opt, launches = _train_main_run(fa, seed, _TRAIN, "train")
    model, layers, card = opt.model, _TRAIN["layers"], _card()

    # one batch through the kernels and through the plain attention
    batch = next(iter(opt.validation_dataset.data(train=False)))
    data = torch.as_tensor(batch.data).to(_DEV)
    labels = torch.as_tensor(batch.labels).to(_DEV)
    crit = nn.CrossEntropyCriterion()
    watch = {"lm_head.weight": model[layers + 2].weight,
             "block_0.q_weight": model[1][0][1].q_weight}
    out = {}
    model.train()
    for mode in ("auto", False):
        loss = crit(model(data, flash=mode), labels)
        grads = torch.autograd.grad(loss, list(watch.values()))
        out[mode] = (float(loss.detach()), grads)
        del loss
        torch.cuda.empty_cache()
    model.evaluate()
    dloss = abs(out["auto"][0] - out[False][0])
    report = {"loss_kernel": out["auto"][0], "loss_plain": out[False][0],
              "loss_diff": dloss}
    if not dloss <= _TRAIN_LOSS_TOL:
        raise AssertionError(f"kernel vs plain loss differ by {dloss}")
    for name, gk, gp in zip(watch, out["auto"][1], out[False][1]):
        diff = float((gk - gp).abs().max())
        scale = float(gp.abs().max())
        report[name] = {"max_abs_diff": diff, "max_abs_grad": scale}
        if not (torch.isfinite(gk).all()
                and diff <= _TRAIN_GRAD_REL_TOL * scale):
            raise AssertionError(f"kernel vs plain grad of {name} differs "
                                 f"by {diff} > {_TRAIN_GRAD_REL_TOL} x "
                                 f"{scale}")
    print(f"[train] kernel vs flash=False on one batch (bf16 policy): "
          + json.dumps(report) + f" tol loss {_TRAIN_LOSS_TOL}, grads "
          f"{_TRAIN_GRAD_REL_TOL} x max|grad|", flush=True)
    # two more steps of the train main's step function (SGD as train.py
    # sets it) under the profiler
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.accumulation import make_train_step
    params = dict(model.named_parameters())
    sgd = SGD(learning_rate=0.02, learning_rate_decay=0.001)
    step = make_train_step(fwd=model, criterion=nn.CrossEntropyCriterion(),
                           params=params, update_fn=sgd.update)
    model.train()
    _profile_steps(step, sgd.init_state(params), data, labels, "train", card)
    model.evaluate()
    return launches


def phase_train_wide(fa, seed):
    """The train main at head dim 256: the ``[train]`` geometry with 4
    heads of 256 (``--dModel 1024 --numHeads 4``), one epoch of 4 steps:
    flash forward, dq and dk/dv at D 256 through
    ``dot_product_attention(flash="auto")``."""
    from bigdl_tpu_torch.tensor import DTypePolicy, set_policy
    set_policy(DTypePolicy(param_dtype=torch.float32,
                           compute_dtype=torch.bfloat16,
                           activation_dtype=torch.bfloat16))
    opt, launches = _train_main_run(fa, seed, _TRAIN_WIDE, "train d256")
    del opt
    torch.cuda.empty_cache()
    return launches


def phase_train_narrow(fa, seed):
    """The train main at head dim 16: ``--dModel 128 --numHeads 8``, one
    epoch, through ``dot_product_attention(flash="auto")``, which runs
    the flash kernels on q, k and v zero-padded to 32 (their launches
    counted as ``[train]``'s)."""
    from bigdl_tpu_torch.tensor import DTypePolicy, set_policy
    set_policy(DTypePolicy(param_dtype=torch.float32,
                           compute_dtype=torch.bfloat16,
                           activation_dtype=torch.bfloat16))
    opt, launches = _train_main_run(fa, seed, _TRAIN_NARROW, "train d16")
    del opt
    torch.cuda.empty_cache()
    return launches


def _lm_kind(name: str) -> str:
    """Kernel kind of a device kernel of the LM steps, by its name."""
    low = name.lower()
    # the split pass of the LM steps is the f32 fused CE's (the flash
    # kernels that take one run past head dim 256, which no LM step has)
    return ("fused_ce" if "fce_" in low or "tf32_split" in low else
            "flash" if "flash_" in low else
            "gemm" if any(w in low for w in ("gemm", "cutlass", "xmma",
                                             "nvjet", "cublas", "sm90_"))
            else "other")


def _profile_steps(step, state, data, labels, tag, card, steps=2,
                   kind=_lm_kind, shape=None):
    """Where a training step's device time goes: ``steps`` more calls of
    ``step`` (a ``make_train_step`` step, from optimizer state ``state``)
    under ``torch.profiler``, kernel time summed by ``kind`` (a function
    of the kernel's name), and the device's busy share of the window's
    wall clock. Runs after every check, so the launches it makes are in
    no count. Returns the device ms a step by kind and the wall ms a
    step."""
    from torch.profiler import ProfilerActivity, profile
    state, _ = step(state, data, labels, 1)          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = step(state, data, labels, 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds, top = _device_ms(prof, steps, kind)
    busy = sum(kinds.values())
    shape = shape or f"B{data.shape[0]} S{data.shape[1]}"
    print(f"[{tag}] card='{card}' profile of {steps} steps at {shape}: "
          f"wall_ms_per_step={wall_ms / steps} device_ms_per_step={busy} "
          f"by kind " + json.dumps(kinds) + " device_idle_share="
          f"{1 - busy / (wall_ms / steps) if busy else 'not measured'}",
          flush=True)
    for ms, n, name in top[:8]:
        print(f"[{tag}]   {ms:.4f} ms/step in {n} launches/step: {name}",
              flush=True)
    return kinds, wall_ms / steps


def _device_ms(prof, steps, kind):
    """Device ms per step summed by ``kind`` of kernel name, and the
    kernels by time ((ms, launches, name) per step, largest first)."""
    kinds, top = {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        k = kind(e.key)
        kinds[k] = kinds.get(k, 0.0) + us / 1e3 / steps
        top.append((us / 1e3 / steps, e.count // steps, e.key[:60]))
    top.sort(reverse=True)
    return kinds, top


def _fce_inputs(n, v, d, dtype, gen, zero_target):
    """Head inputs like the harness's: unit-variance hidden rows (the
    final LayerNorm's output), W rows of N(0, 1/D) so the logits are about
    N(0, 1), a small f32 bias, uniform 1-based targets (one of them the
    out-of-contract 0 under ``zero_target``), and g = 1/N, the mean
    reduction's cotangent."""
    h = torch.randn((n, d), generator=gen).to(dtype).to(_DEV)
    w = (torch.randn((v, d), generator=gen) / d ** 0.5).to(dtype).to(_DEV)
    b = (0.1 * torch.randn(v, generator=gen)).to(_DEV)
    t = torch.randint(1, v + 1, (n,), generator=gen, dtype=torch.int32)
    if zero_target:
        t[n // 2] = 0
    return h, w, b, t.to(_DEV), torch.full((n,), 1.0 / n, device=_DEV)


def _fce_bytes_ms(n, v, d, dtype, kernel):
    """Least time for one fused-CE kernel's bytes: each input read once
    and each output written once over the memory rate."""
    elt = torch.finfo(dtype).bits // 8
    ins = (n + v) * d * elt + v * 4 + n * 4          # h, W, b, t
    bytes_ = {"fwd": ins + 2 * n * 4,                 # nll, lse out
              "dh": ins + 2 * n * 4 + n * d * elt,    # lse, g in; dh out
              "dw": ins + 2 * n * 4 + v * d * elt + v * 4}[kernel]
    return bytes_ / _HBM_BYTES_PER_S * 1e3


def _fce_flops(n, v, d, kernel):
    """2·N·V·D operations (forward) or 4·N·V·D (each backward kernel:
    the logits once more and one product)."""
    return (2 if kernel == "fwd" else 4) * n * v * d


def _fce_bound(n, v, d, dtype, kernel):
    """Least time for one fused-CE kernel: its bytes (``_fce_bytes_ms``)
    vs its operations over the peak for the dtype's arithmetic."""
    peak = _BF16_FLOPS if dtype == torch.bfloat16 else _F32_FLOPS
    tb = _fce_bytes_ms(n, v, d, dtype, kernel)
    tf = _fce_flops(n, v, d, kernel) / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _fce_kernel_bound(fce, n, v, d, dtype, kernel):
    """(bound ms, bound_by, other fields) of fused-CE ``kernel`` on its
    route: ``_fce_bound``, or for the 3xTF32 dh and dW/db (route "tf32",
    on the tensor cores) three TF32 products for each multiply over the
    TF32 peak (or the bytes, where they take longer), with the f32
    CUDA-core bound beside it as ``bound_f32_cuda_cores_ms``."""
    bound, by = _fce_bound(n, v, d, dtype, kernel)
    if fce.kernel_route(dtype, d, kernel) != "tf32":
        return bound, by, {}
    tf = 3 * _fce_flops(n, v, d, kernel) / _TF32_FLOPS * 1e3
    tb = _fce_bytes_ms(n, v, d, dtype, kernel)
    return (*((tb, "bytes") if tb >= tf else (tf, "operations")),
            {"bound_f32_cuda_cores_ms": bound})


def _fce_library_ms(h, w, b, t):
    """A two-call PyTorch composition computing the same function, timed
    here only: ``F.cross_entropy`` over ``F.linear``'s logits (forward),
    and autograd's forward + backward minus the forward (dh, dW and db
    in one)."""
    import torch.nn.functional as F
    t0, bias = t.long() - 1, b.to(h.dtype)
    fwd = _time_ms(lambda: F.cross_entropy(F.linear(h, w, bias).float(), t0))
    hg, wg, bg = (x.detach().clone().requires_grad_() for x in (h, w, bias))

    def fwd_bwd():
        hg.grad = wg.grad = bg.grad = None
        F.cross_entropy(F.linear(hg, wg, bg).float(), t0).backward()
    return fwd, _time_ms(fwd_bwd) - fwd


def _fce_fwd_f64(h, w, b, t):
    """nll and lse of the function evaluated in float64 on the same
    inputs, rounded to f32 (the f32 plain version's own sums, cuBLAS's
    FMA chain over D, stray from it a few f32 steps)."""
    s = h.double() @ w.double().T + b.double()
    lse = torch.logsumexp(s, dim=1)
    t0 = t.long() - 1
    ok = (t0 >= 0) & (t0 < w.shape[0])
    tl = torch.where(ok, s.gather(1, t0.clamp(0, w.shape[0] - 1)[:, None])
                     [:, 0], 0.0)
    return (lse - tl).float(), lse.float()


def _fce_check(fce, h, w, b, t, g, label):
    """Each fused-CE kernel's outputs against its plain version's (the
    backward kernels from the plain forward's lse), and the f32 forward's
    nll and lse also against the function in float64 (``_fce_fwd_f64``,
    as ``nll_f64`` and ``lse_f64``), at the same limits; raises where one
    is not finite or past its limit. Returns the max abs errors, the
    worst error / limit ratios and the plain lse."""
    tol = _FCE_TOL[h.dtype]
    errs, worst = {}, {}

    def hold(what, got, want, limit):
        errs[what], worst[what] = _worst(got, want, *limit)
        if not (torch.isfinite(got).all() and worst[what] <= 1):
            raise AssertionError(f"fused_ce {what} {label}: max abs err "
                                 f"{errs[what]}, {worst[what]} x its limit")

    nll, lse = fce.fused_ce_fwd(h, w, b, t)
    torch.cuda.synchronize()
    rnll, rlse = fce.fused_ce_fwd_ref(h, w, b, t)
    hold("nll", nll, rnll, (None, _FCE_ABS_TOL))
    hold("lse", lse, rlse, (None, _FCE_ABS_TOL))
    if h.dtype == torch.float32:
        enll, else_ = _fce_fwd_f64(h, w, b, t)
        hold("nll_f64", nll, enll, (None, _FCE_ABS_TOL))
        hold("lse_f64", lse, else_, (None, _FCE_ABS_TOL))
        del enll, else_
    dh = fce.fused_ce_dh(h, w, b, t, rlse, g)
    torch.cuda.synchronize()
    hold("dh", dh, fce.fused_ce_dh_ref(h, w, b, t, rlse, g), tol)
    dw, db = fce.fused_ce_dw(h, w, b, t, rlse, g)
    torch.cuda.synchronize()
    rdw, rdb = fce.fused_ce_dw_ref(h, w, b, t, rlse, g)
    hold("dw", dw, rdw, tol)
    hold("db", db, rdb, _FCE_DB_TOL)
    torch.cuda.empty_cache()
    return errs, worst, rlse


def phase_fused_ce(fce, gen):
    """The three fused-CE kernels vs their plain versions at the harness
    head's shapes (N 8192, V 32768, D 1024) in bf16 and f32, at a tails
    case (N 1000, V 50257, one target 0) and at D 72 and 1032; at the
    main shapes each is timed against its bound, its plain version and
    the library composition. Each row names its route
    (``fce.kernel_route``). The forward's rows also give its rate over
    2·N·V·D, its share of the bound (bound_ms / ms) and, as the
    product's yardstick, the time of a bare ``F.linear(h, w)`` at the
    same shape and dtype (``gemm_ms``: the logits alone, not the same
    function). The f32 rows (route "tf32": the forward, dh and dW/db)
    give the 3xTF32 bound as ``bound_ms`` with the f32 CUDA-core one
    beside it, the share of the 3xTF32 bound, the workspace
    (``workspace_mib``) and the most the call holds beyond its inputs
    (``peak_mib``); the f32 forward's nll and lse are held to the
    function in float64 as well (``nll_f64``, ``lse_f64``: worst error /
    limit). Last, the bf16 dh and dW/db past D 1024 at N 8192, V 32768,
    D 2048 (``_fce_wide_bwd``)."""
    import torch.nn.functional as F
    sms = torch.cuda.get_device_properties(_DEV).multi_processor_count
    rows = {}
    for case, n, v, d in _FCE_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype)[6:]
            h, w, b, t, g = _fce_inputs(n, v, d, dtype, gen, case != "main")
            errs, worst, rlse = _fce_check(fce, h, w, b, t, g,
                                           f"[{case} {name}]")
            code = fce._DTYPE_CODES[dtype]
            fwd_splits = fce._kernel_fns()["fwd_splits"](code, n, v, d, sms)
            splits = fce._kernel_fns()["dh_splits"](code, n, v, d)
            routes = {k: fce.kernel_route(dtype, d, k)
                      for k in ("fwd", "dh", "dw")}
            print(f"[kernels] fused_ce[{case} {name}] N={n} V={v} D={d} "
                  f"routes={routes} "
                  f"fwd_splits={fwd_splits} dh_splits={splits} "
                  f"max abs errs " + json.dumps(errs) + " worst error / "
                  "limit " + json.dumps(worst) + f" (limit rtol·|plain| + "
                  f"atol·rms(plain): dh/dw {_FCE_TOL[dtype]}, db "
                  f"{_FCE_DB_TOL}; nll/lse {_FCE_ABS_TOL})", flush=True)
            if case == "main":
                lib_fwd, lib_bwd = _fce_library_ms(h, w, b, t)
                kernels = {
                    "fwd": (lambda: fce.fused_ce_fwd(h, w, b, t),
                            lambda: fce.fused_ce_fwd_ref(h, w, b, t),
                            lib_fwd, max(errs["nll"], errs["lse"])),
                    "dh": (lambda: fce.fused_ce_dh(h, w, b, t, rlse, g),
                           lambda: fce.fused_ce_dh_ref(h, w, b, t, rlse, g),
                           lib_bwd, errs["dh"]),
                    "dw": (lambda: fce.fused_ce_dw(h, w, b, t, rlse, g),
                           lambda: fce.fused_ce_dw_ref(h, w, b, t, rlse, g),
                           lib_bwd, max(errs["dw"], errs["db"])),
                }
                for kname, (kern, plain, lib, err) in kernels.items():
                    bound, by, extra = _fce_kernel_bound(fce, n, v, d,
                                                         dtype, kname)
                    ms = _time_ms(kern)
                    row = dict(route=routes[kname], max_abs_err=err, ms=ms,
                               plain_ms=_time_ms(plain), bound_ms=bound,
                               bound_by=by, library_ms=lib, **extra)
                    if routes[kname] == "tf32":
                        row.update(
                            share_of_bound=bound / ms,
                            workspace_mib=fce.workspace_floats(
                                kname, n, v, d, dtype) * 4 / 2 ** 20,
                            peak_mib=_peak_mib(kern))
                    if kname == "fwd":
                        row.update(tflops=2 * n * v * d / ms / 1e9,
                                   share_of_bound=bound / ms,
                                   gemm_ms=_time_ms(lambda: F.linear(h, w)))
                        if "nll_f64" in worst:
                            row.update(nll_f64=worst["nll_f64"],
                                       lse_f64=worst["lse_f64"])
                    rows[(f"fused_ce_{kname}", dtype)] = row
                    print(f"[kernels] fused_ce_{kname}[{name}] N={n} V={v} "
                          f"D={d} " + json.dumps(row), flush=True)
                del kernels
            del h, w, b, t, g, rlse
            torch.cuda.empty_cache()
    rows["padded"] = _fce_padded(fce, gen)
    rows.update(_fce_wide_bwd(fce, gen))
    return rows


#: the bf16 fused-CE backward past the cluster kernels' D 1024, timed at
#: the harness head's rows and vocabulary: (label, N, V, D)
_FCE_WIDE_BWD = ("wide_bwd", 8192, 32768, 2048)
#: ms of the CUDA-core dh and dW/db (``fce_bwd_kernel<bf16>``) that the
#: chunked passes replaced, at ``_FCE_WIDE_BWD`` on an NVIDIA H100 80GB
#: HBM3 at 700 W (PERF.md): printed beside the new times, as text only
_FCE_WIDE_CUDA_CORES_MS = {"dh": 197.80, "dw": 200.67}


def _fce_wide_bwd(fce, gen):
    """The bf16 dh and dW/db past D 1024 (route "tc_chunked":
    ``fce_dl_tc_kernel`` then ``fce_gemm_tc_kernel``, a chunk of resident
    rows at a time) at ``_FCE_WIDE_BWD``: each held against its plain
    version (from the plain forward's lse) within ``_FCE_TOL`` and timed
    beside its bound, its plain version and the library composition's
    whole backward (``_fce_library_ms``), with its workspace
    (``workspace_mib``) and the most the call holds beyond its inputs
    (``peak_mib``: the workspace and its outputs). Returns the rows by
    (kernel name, "d2048")."""
    case, n, v, d = _FCE_WIDE_BWD
    dtype = torch.bfloat16
    h, w, b, t, g = _fce_inputs(n, v, d, dtype, gen, False)
    _, rlse = fce.fused_ce_fwd_ref(h, w, b, t)
    _, lib_bwd = _fce_library_ms(h, w, b, t)
    tol = _FCE_TOL[dtype]
    kernels = {
        "dh": (lambda: fce.fused_ce_dh(h, w, b, t, rlse, g),
               lambda: fce.fused_ce_dh_ref(h, w, b, t, rlse, g)),
        "dw": (lambda: fce.fused_ce_dw(h, w, b, t, rlse, g),
               lambda: fce.fused_ce_dw_ref(h, w, b, t, rlse, g)),
    }
    rows = {}
    for kname, (kern, plain) in kernels.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got, want = ((got,), (want,)) if kname == "dh" else (got, want)
        errs = [_worst(x, y, *(tol if i == 0 else _FCE_DB_TOL))
                for i, (x, y) in enumerate(zip(got, want))]
        if not all(torch.isfinite(x).all() and e[1] <= 1
                   for x, e in zip(got, errs)):
            raise AssertionError(f"fused_ce_{kname}[{case} bf16] N={n} V={v} "
                                 f"D={d}: max abs err / limit {errs}")
        del got, want
        bound, by, extra = _fce_kernel_bound(fce, n, v, d, dtype, kname)
        row = dict(route=fce.kernel_route(dtype, d, kname),
                   max_abs_err=max(e[0] for e in errs),
                   worst_err_over_limit=max(e[1] for e in errs),
                   ms=_time_ms(kern), plain_ms=_time_ms(plain),
                   bound_ms=bound, bound_by=by, library_ms=lib_bwd, **extra)
        row.update(share_of_bound=bound / row["ms"],
                   workspace_mib=fce.workspace_floats(
                       kname, n, v, d, dtype) * 4 / 2 ** 20,
                   peak_mib=_peak_mib(kern))
        rows[(f"fused_ce_{kname}", "d2048")] = row
        print(f"[kernels] fused_ce_{kname}[{case} bf16] N={n} V={v} D={d} "
              f"(library_ms: the whole backward; the CUDA-core kernel it "
              f"replaced took [{_FCE_WIDE_CUDA_CORES_MS[kname]}] ms, "
              f"PERF.md) " + json.dumps(row), flush=True)
    del h, w, b, t, g, rlse, kernels
    torch.cuda.empty_cache()
    return rows


def _fce_padded(fce, gen):
    """``linear_cross_entropy`` at ``_FCE_PADDED``'s D 1028, which it
    pads with zero columns to 1032 for the kernels, in bf16 and f32: the
    loss and dh, dW and db of one forward and backward on the card (each
    kernel launched once, counted) against the same call on CPU copies,
    where the wrappers take their plain versions behind the same padding
    (``_FCE_ABS_TOL`` on the loss, ``_FCE_TOL`` / ``_FCE_DB_TOL`` on the
    gradients). Returns the rows by dtype."""
    case, n, v, d = _FCE_PADDED
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        h, w, b, t, _ = _fce_inputs(n, v, d, dtype, gen, True)
        out = {}
        before = fce.fwd_launches, fce.dh_launches, fce.dw_launches
        for where in ("cuda", "cpu"):
            hg, wg, bg = (x.detach().to(where).clone().requires_grad_()
                          for x in (h, w, b))
            loss = fce.linear_cross_entropy(hg, wg, bg, t.to(where),
                                            use_kernel=True)
            loss.backward()
            out[where] = (loss.detach(), hg.grad, wg.grad, bg.grad)
            if where == "cuda":
                torch.cuda.synchronize()
                moved = [a - b_ for a, b_ in zip(
                    (fce.fwd_launches, fce.dh_launches, fce.dw_launches),
                    before)]
                if moved != [1, 1, 1]:
                    raise AssertionError(f"fused_ce[{case} {name}] launched "
                                         f"{moved} kernels, not one each")
        errs, worst = {}, {}
        for what, got, want, lim in zip(
                ("loss", "dh", "dw", "db"), out["cuda"], out["cpu"],
                ((None, _FCE_ABS_TOL), _FCE_TOL[dtype], _FCE_TOL[dtype],
                 _FCE_DB_TOL)):
            if got.shape != want.shape:
                raise AssertionError(f"fused_ce[{case} {name}] {what} "
                                     f"shape {tuple(got.shape)}")
            errs[what], worst[what] = _worst(got, want.to(_DEV), *lim)
            if not (torch.isfinite(got).all() and worst[what] <= 1):
                raise AssertionError(
                    f"fused_ce[{case} {name}] {what}: max abs err "
                    f"{errs[what]}, {worst[what]} x its limit")
        rows[dtype] = dict(max_abs_err=errs, worst_err_over_limit=worst)
        print(f"[kernels] fused_ce[{case} {name}] N={n} V={v} D={d} (padded "
              f"to {d + -d % 8}) through linear_cross_entropy, card vs CPU "
              f"plain versions: max abs errs " + json.dumps(errs)
              + " worst error / limit " + json.dumps(worst), flush=True)
        del h, w, b, t, out
        torch.cuda.empty_cache()
    return rows


def _perf_fused(fce, card):
    """The harness at the flagship geometry with the fused head + CE:
    exact launch counts, the losses, then one batch against the unfused
    head and a profile of the fused step. Returns the launch counts and
    the run's numbers."""
    from bigdl_tpu_torch.models.utils import perf
    from bigdl_tpu_torch.optim import SGD
    fce.fwd_launches = fce.dh_launches = fce.dw_launches = 0
    fce.dh_tf32_launches = fce.dw_tf32_launches = 0
    out = perf.main(_perf_args())
    launches = {"fwd": fce.fwd_launches, "dh": fce.dh_launches,
                "dw": fce.dw_launches}
    steps = _PERF["warm_up"] + _PERF["iterations"]
    if (not out["fused"] or launches != dict.fromkeys(launches, steps)
            or fce.dh_tf32_launches or fce.dw_tf32_launches):
        raise AssertionError(f"fused-CE launches {launches} (f32 route: "
                             f"{fce.dh_tf32_launches}, "
                             f"{fce.dw_tf32_launches}), expected {steps} "
                             f"of each, none f32 (fused={out['fused']})")
    first, final = out["first_loss"], out["final_loss"]
    if not (math.isfinite(first) and math.isfinite(final)):
        raise AssertionError(f"non-finite harness loss: {first}, {final}")
    if abs(first - math.log(_PERF["vocab"])) > 0.5:
        raise AssertionError(f"first loss {first} not within 0.5 of "
                             f"ln {_PERF['vocab']}")
    numbers = {k: out[k] for k in ("tokens_per_s", "ms_per_step", "tflops",
                                   "tflops_causal", "peak_bytes",
                                   "first_loss", "final_loss")}
    print(f"[perf] card='{card}' transformer " + json.dumps(_PERF)
          + " bf16, fused head+CE: " + json.dumps(numbers)
          + f" fused_ce_launches={launches} (=1 per step x {steps} steps; "
          f"TFLOP/s from bench.py's analytic step count, host clock over "
          f"the timed steps ending in the loss readback)", flush=True)
    _fused_vs_unfused(out, _PERF["layers"], True)
    sgd = SGD(learning_rate=0.01)
    model = out["model"]
    _profile_steps(perf.make_step(model, sgd, True),
                   sgd.init_state(dict(model.named_parameters())),
                   out["data"], out["labels"], "perf", card)
    return launches, numbers


def _fused_vs_unfused(out, layers, watch_q):
    """One batch of a harness run (``out``'s model, data and labels)
    through the fused and the unfused head: the losses within
    ``_PERF_LOSS_TOL`` and the gradients of the LM head's weight (and,
    with ``watch_q``, block 0's q weight) within ``_PERF_GRAD_REL_TOL``
    of their largest element. Prints and returns the report."""
    from bigdl_tpu_torch.models.utils import perf
    model, data, labels = out["model"], out["data"], out["labels"]
    watch = {"lm_head.weight": model[layers + 2].weight}
    if watch_q:
        watch["block_0.q_weight"] = model[1][0][1].q_weight
    res = {}
    for fused in (True, False):
        fwd, crit = perf.body_and_loss(model, fused)
        loss = crit(fwd(data), labels)
        res[fused] = (float(loss.detach()),
                      torch.autograd.grad(loss, list(watch.values())))
        del loss
        torch.cuda.empty_cache()
    dloss = abs(res[True][0] - res[False][0])
    report = {"loss_fused": res[True][0], "loss_unfused": res[False][0],
              "loss_diff": dloss}
    if not dloss <= _PERF_LOSS_TOL:
        raise AssertionError(f"fused vs unfused loss differ by {dloss}")
    for name, gf, gu in zip(watch, res[True][1], res[False][1]):
        diff = float((gf - gu).abs().max())
        scale = float(gu.abs().max())
        report[name] = {"max_abs_diff": diff, "max_abs_grad": scale}
        if not (torch.isfinite(gf).all()
                and diff <= _PERF_GRAD_REL_TOL * scale):
            raise AssertionError(f"fused vs unfused grad of {name} differs "
                                 f"by {diff} > {_PERF_GRAD_REL_TOL} x "
                                 f"{scale}")
    print(f"[perf] fused vs unfused head on one batch (bf16 policy, "
          f"{layers} layers, d_model {watch['lm_head.weight'].shape[1]}): "
          + json.dumps(report) + f" tol loss {_PERF_LOSS_TOL}, grads "
          f"{_PERF_GRAD_REL_TOL} x max|grad|", flush=True)
    return report


def _unfused_peak(perf, fused_peak, over, card):
    """The harness step with the unfused head (``--fusedHeadLoss off``, 1
    warm-up and 2 timed steps) at ``_PERF`` with ``over``: its peak must
    be at least the bf16 (B·S, V) logits above the fused step's
    ``fused_peak``. Prints its numbers."""
    geo = dict(_PERF, **over)
    off = perf.main(_perf_args(**dict(over, warm_up=1, iterations=2))
                    + ["--fusedHeadLoss", "off"])
    saved = off["peak_bytes"] - fused_peak
    logits = geo["batch"] * geo["seq"] * geo["vocab"] * 2
    if off["fused"] or saved < logits:
        raise AssertionError(f"fused step peak {fused_peak} at d_model "
                             f"{geo['d_model']} is not {logits} below the "
                             f"unfused {off['peak_bytes']}")
    print(f"[perf] card='{card}' unfused head (--fusedHeadLoss off) at "
          f"d_model {geo['d_model']}, {geo['layers']} layers: "
          f"tokens_per_s={off['tokens_per_s']} ms_per_step="
          f"{off['ms_per_step']} peak_bytes={off['peak_bytes']}; the fused "
          f"step's peak is {saved} bytes lower ({saved / logits} x the "
          f"bf16 logits' {logits})", flush=True)
    del off
    torch.cuda.empty_cache()


#: the harness past the bf16 cluster kernels' D 1024: d_model 2048 (the
#: LM head of Llama-3.2-1B and Qwen2.5-3B; 16 heads of 128), 2 layers,
#: 1 warm-up and 3 timed steps: the fused head's dh and dW/db on the
#: route "tc_chunked"
_PERF_WIDE = dict(d_model=2048, layers=2, warm_up=1, iterations=3)


def _perf_wide(fce, card):
    """The harness at ``_PERF_WIDE`` under the bf16 policy, the fused-CE
    counters set to 0 just before and read just after: 4 launches of
    each kernel, dh's and dW's all on the route "tc_chunked"; finite
    losses, the first within 0.5 of ln V; one batch through the fused and
    the unfused head (``_fused_vs_unfused``, the LM head's gradient); the
    unfused step's peak at least the bf16 logits above the fused one's
    (``_unfused_peak``). Returns the launches of dh and dW/db."""
    from bigdl_tpu_torch.models.utils import perf
    fce.fwd_launches = fce.dh_launches = fce.dw_launches = 0
    fce.dh_chunked_launches = fce.dw_chunked_launches = 0
    out = perf.main(_perf_args(**_PERF_WIDE))
    launches = {"fwd": fce.fwd_launches, "dh": fce.dh_launches,
                "dw": fce.dw_launches}
    chunked = {"dh": fce.dh_chunked_launches, "dw": fce.dw_chunked_launches}
    steps = _PERF_WIDE["warm_up"] + _PERF_WIDE["iterations"]
    routes = {k: fce.kernel_route(torch.bfloat16, _PERF_WIDE["d_model"], k)
              for k in chunked}
    if (not out["fused"] or launches != dict.fromkeys(launches, steps)
            or chunked != dict.fromkeys(chunked, steps)
            or set(routes.values()) != {"tc_chunked"}):
        raise AssertionError(f"d_model {_PERF_WIDE['d_model']} fused-CE "
                             f"launches {launches} (on the route "
                             f"'tc_chunked': {chunked}; routes {routes}), "
                             f"expected {steps} of each, dh and dW all "
                             f"chunked (fused={out['fused']})")
    first, final = out["first_loss"], out["final_loss"]
    if not (math.isfinite(first) and math.isfinite(final)
            and abs(first - math.log(_PERF["vocab"])) <= 0.5):
        raise AssertionError(f"d_model {_PERF_WIDE['d_model']} harness "
                             f"losses {first}, {final}: the first not "
                             f"within 0.5 of ln {_PERF['vocab']}")
    numbers = {k: out[k] for k in ("ms_per_step", "tokens_per_s",
                                   "peak_bytes", "first_loss",
                                   "final_loss")}
    print(f"[perf] card='{card}' transformer "
          + json.dumps(dict(_PERF, **_PERF_WIDE)) + f" bf16, "
          f"{_PERF_WIDE['d_model'] // 128} heads of 128, fused head+CE "
          f"(dh and dW/db on the route 'tc_chunked'): "
          + json.dumps(numbers) + f" fused_ce_launches={launches} "
          f"chunked_launches={chunked}", flush=True)
    _fused_vs_unfused(out, _PERF_WIDE["layers"], False)
    del out
    torch.cuda.empty_cache()
    _unfused_peak(perf, numbers["peak_bytes"], _PERF_WIDE, card)
    return chunked


def _perf_f32(fce, fa, card):
    """The transformer step in f32 (``--dataType f32``) at ``_PERF``'s
    geometry, 1 warm-up and 3 timed steps: the 3xTF32 fused-CE forward,
    dh and dW/db and the f32 flash kernels at head dim 128 (all three in
    3xTF32), the counters set to 0 just before and read just after (4
    launches of each fused-CE kernel, all on the route "tf32"; 12 layers
    x 4 steps = 48 of each flash kernel, all on 3xTF32 routes: the
    forward's and dq's "rows_tf32", dk/dv's "sliced_tf32", printed
    beside them), the first loss within 0.5 of ln V; then a profile
    of the f32 step by kernel kind (``_profile_steps``). Returns the
    fused-CE and the flash launches."""
    from bigdl_tpu_torch.models.utils import perf
    from bigdl_tpu_torch.optim import SGD
    fce.fwd_launches = fce.dh_launches = fce.dw_launches = 0
    fce.fwd_tf32_launches = fce.dh_tf32_launches = fce.dw_tf32_launches = 0
    fa.fwd_launches = fa.dq_launches = fa.dkdv_launches = 0
    fa.fwd_tf32_launches = fa.dq_tf32_launches = fa.dkdv_tf32_launches = 0
    out = perf.main(_perf_args(warm_up=1, iterations=3)
                    + ["--dataType", "f32"])
    launches = {"fwd": fce.fwd_tf32_launches, "dh": fce.dh_tf32_launches,
                "dw": fce.dw_tf32_launches}
    flash = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
             "dkdv": fa.dkdv_launches}
    flash_tf32 = {"fwd": fa.fwd_tf32_launches, "dq": fa.dq_tf32_launches,
                  "dkdv": fa.dkdv_tf32_launches}
    flash_routes = {k: fa.flash_route(torch.float32, 128, k) for k in flash}
    if (not out["fused"] or launches != dict.fromkeys(launches, 4)
            or (fce.fwd_launches, fce.dh_launches, fce.dw_launches)
            != (4, 4, 4)):
        raise AssertionError(f"f32 fused-CE launches {launches} (all fwd, "
                             f"dh, dW: {fce.fwd_launches}, "
                             f"{fce.dh_launches}, {fce.dw_launches}), "
                             f"expected 4 of each on the f32 route "
                             f"(fused={out['fused']})")
    n = _PERF["layers"] * 4
    if (flash != dict.fromkeys(flash, n)
            or flash_tf32 != dict.fromkeys(flash, n)
            or any(r not in fa.TF32_ROUTES for r in flash_routes.values())):
        raise AssertionError(f"f32 step flash launches {flash} (on 3xTF32 "
                             f"routes: {flash_tf32}; routes "
                             f"{flash_routes}), expected {n} of each, all "
                             f"on those routes")
    first, final = out["first_loss"], out["final_loss"]
    if not (math.isfinite(first) and math.isfinite(final)
            and abs(first - math.log(_PERF["vocab"])) <= 0.5):
        raise AssertionError(f"f32 harness losses {first}, {final}: the "
                             f"first not within 0.5 of ln {_PERF['vocab']}")
    numbers = {k: out[k] for k in ("ms_per_step", "tokens_per_s",
                                   "peak_bytes", "first_loss",
                                   "final_loss")}
    print(f"[perf] card='{card}' transformer "
          + json.dumps(dict(_PERF, warm_up=1, iterations=3))
          + " f32, fused head+CE (on the route "
          + f"{fce.kernel_route(torch.float32, _PERF['d_model'], 'fwd')!r}): "
          + json.dumps(numbers) + f" fused_ce_launches={launches} "
          f"flash_launches={flash} (on 3xTF32 routes: {flash_tf32}; "
          f"head dim 128, the harness's d_model / 128 heads: routes "
          f"{json.dumps(flash_routes)})", flush=True)
    sgd = SGD(learning_rate=0.01)
    model = out["model"]
    _profile_steps(perf.make_step(model, sgd, True),
                   sgd.init_state(dict(model.named_parameters())),
                   out["data"], out["labels"], "perf f32", card)
    return launches, flash


def phase_perf(fce, fa):
    """The throughput harness: the fused transformer step (``_perf_fused``),
    the unfused step's peak memory against the fused one's, the
    attention mode at each of ``_PERF_ATTENTION``'s head dims in bf16 and
    at ``_PERF_ATTENTION_F32`` in f32, the flash counters set to 0 just
    before each run and read just after (1 warm-up and 3 timed fwd+bwd: 4
    launches of each kernel), and the f32 transformer step
    (``_perf_f32``). Returns the fused-CE launches of the bf16 and of the
    f32 step and the flash launches by (head dim, "bf16" or "f32"), the
    f32 step's under (128, "f32 step"), and the chunked dh and dW/db
    launches of the step at d_model 2048 (``_perf_wide``)."""
    from bigdl_tpu_torch.models.utils import perf
    card = _card()
    launches, fused = _perf_fused(fce, card)
    torch.cuda.empty_cache()
    _unfused_peak(perf, fused["peak_bytes"], {}, card)
    wide = _perf_wide(fce, card)
    torch.cuda.empty_cache()
    flash = {}
    for a, dt in (*((a, "bf16") for a in _PERF_ATTENTION),
                  (_PERF_ATTENTION_F32, "f32")):
        fa.fwd_launches = fa.dq_launches = fa.dkdv_launches = 0
        att = perf.main(["-m", "attention", "-b", str(a["batch"]),
                         "--seqLen", str(a["seq"]), "--heads",
                         str(a["heads"]), "--headDim", str(a["head_dim"]),
                         "--dataType", dt, "--warmUp", "1", "-i", "3",
                         "--device", _DEV])
        counts = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
                  "dkdv": fa.dkdv_launches}
        if att["flash"] is None or counts != dict.fromkeys(counts, 4):
            raise AssertionError(f"perf -m attention {dt} at head dim "
                                 f"{a['head_dim']}: the flash path failed "
                                 f"or launched {counts}, not 4 of each")
        flash[(a["head_dim"], dt)] = counts
        print(f"[perf] card='{card}' attention " + json.dumps(a) + f" {dt} "
              f"causal, fwd+bwd ms per iteration: " + json.dumps(att)
              + f" flash_launches={counts}", flush=True)
        torch.cuda.empty_cache()
    f32_launches, flash[(128, "f32 step")] = _perf_f32(fce, fa, card)
    torch.cuda.empty_cache()
    return launches, f32_launches, flash, wide


def _lrn_bound(shape, dtype, size, backward):
    """Least time for one LRN kernel: x (and g) read once and the output
    written once over the memory rate, vs its f32 operations (2·size for
    the window's squares and sum, about 6 more a channel forward; the
    adjoint window's sum and about 10 more backward) over the CUDA
    cores' f32 peak."""
    n = math.prod(shape)
    elt = torch.finfo(dtype).bits // 8
    bytes_ = (3 if backward else 2) * n * elt
    flops = n * (3 * size + 10 if backward else 2 * size + 6)
    tb, tf = bytes_ / _HBM_BYTES_PER_S * 1e3, flops / _F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _lrn_library_ms(x, g, a):
    """``F.local_response_norm`` after ``F.relu`` (odd window: the same
    function; at an even one its window lies one channel the other way,
    the same work), timed here only: the forward, and autograd's forward
    + backward minus the forward."""
    import torch.nn.functional as F

    def fwd(v):
        return F.local_response_norm(F.relu(v) if a["relu"] else v,
                                     a["size"], a["alpha"], a["beta"],
                                     a["k"])
    xg = x.detach().clone().requires_grad_()

    def fwd_bwd():
        xg.grad = None
        fwd(xg).backward(g)
    f = _time_ms(lambda: fwd(x))
    return f, _time_ms(fwd_bwd) - f


def _lrn_inputs(case, shape, dtype, gen):
    """x and g of an LRN case on the card ("shifted": each one element
    into a fresh buffer, so every row is off 16-byte alignment)."""
    scale = 1.5 if case in _LRN_UNTIMED else 4.0
    x = (scale * torch.randn(shape, generator=gen)).to(dtype).to(_DEV)
    g = torch.randn(shape, generator=gen).to(dtype).to(_DEV)
    if case == "shifted":
        x, g = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(shape)
                for t in (x, g))
    return x, g


def phase_lrn(lrn, gen):
    """The LRN kernels vs their plain versions at norm1 and norm2 of the
    Inception-v1 step (batch 256) and AlexNet's norm1 and norm2 in bf16
    and f32, at ragged and misaligned cases, and past window 9 (the
    tiled forward; the staged backward's slots, and past its cap the
    "any" backward, the tiled walk's); each row but ``_LRN_UNTIMED`` timed
    against its
    bound, its plain version and the library call. Each backward must
    take the route ``ops.lrn.bwd_route`` names."""
    rows = {}
    for case, shape, a in _LRN_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype)[6:]
            x, g = _lrn_inputs(case, shape, dtype, gen)
            args = (a["size"], a["alpha"], a["beta"], a["k"], a["relu"])
            route = lrn.bwd_route(dtype, shape, a["size"])
            tol = _LRN_TOL[dtype]
            errs, worst = {}, {}
            y = lrn.lrn_fwd(x, *args)
            torch.cuda.synchronize()
            errs["fwd"], worst["fwd"] = _worst(y, lrn.lrn_ref(x, *args), *tol)
            before = (lrn.bwd_staged_launches, lrn.bwd_any_launches)
            dx = lrn.lrn_bwd(g, x, *args)
            torch.cuda.synchronize()
            took = (lrn.bwd_staged_launches - before[0],
                    lrn.bwd_any_launches - before[1])
            if took != ((1, 0) if route == "staged" else (0, 1)):
                raise AssertionError(f"lrn_bwd[{case} {name}]: {took} "
                                     f"launches (staged, any), route {route}")
            errs["bwd"], worst["bwd"] = _worst(dx, lrn.lrn_bwd_ref(g, x, *args),
                                               *tol)
            del y, dx
            for what in ("fwd", "bwd"):
                if not worst[what] <= 1:
                    raise AssertionError(
                        f"lrn_{what}[{case} {name}] max abs err "
                        f"{errs[what]}, {worst[what]} x its limit")
            print(f"[kernels] lrn[{case} {name}] shape={list(shape)} "
                  f"args={json.dumps(a)} bwd route {route} max abs errs "
                  + json.dumps(errs)
                  + " worst error / limit " + json.dumps(worst)
                  + f" (limit rtol·|plain| + atol·rms(plain), {tol})",
                  flush=True)
            if case not in _LRN_UNTIMED:
                lib_fwd, lib_bwd = _lrn_library_ms(x, g, a)
                for what, kern, plain, lib in (
                        ("fwd", lambda: lrn.lrn_fwd(x, *args),
                         lambda: lrn.lrn_ref(x, *args), lib_fwd),
                        ("bwd", lambda: lrn.lrn_bwd(g, x, *args),
                         lambda: lrn.lrn_bwd_ref(g, x, *args), lib_bwd)):
                    bound, by = _lrn_bound(shape, dtype, a["size"],
                                           what == "bwd")
                    row = dict(max_abs_err=errs[what], ms=_time_ms(kern),
                               plain_ms=_time_ms(plain), bound_ms=bound,
                               bound_by=by, library_ms=lib)
                    if what == "bwd":
                        row["kernel_route"] = route
                    rows[(f"lrn_{what}", case, dtype)] = row
                    print(f"[kernels] lrn_{what}[{case} {name}] "
                          + json.dumps(row), flush=True)
            del x, g
            torch.cuda.empty_cache()
    return rows


def _maxpool_inputs(shape, dtype, kind, gen):
    if kind == "normal":
        x = torch.randn(shape, generator=gen)
        dy = torch.randn(shape, generator=gen)
    else:
        x = torch.randint(0, 4, shape, generator=gen).float()
        dy = torch.randint(-8, 9, shape, generator=gen)
        if kind == "neginf":
            x[torch.rand(shape, generator=gen) < 0.6] = float("-inf")
            x[:, 0] = float("-inf")
    x, dy = x.to(dtype).to(_DEV), dy.to(dtype).to(_DEV)
    if kind == "shifted":   # contiguous, one element into a fresh buffer
        x, dy = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(shape)
                 for t in (x, dy))
    return x, dy


def _maxpool_library_ms(x, dy):
    """The library's max-pool backward: its forward + backward less its
    forward, through autograd on the same inputs."""
    import torch.nn.functional as F
    xg = x.detach().clone().requires_grad_()

    def lib_fwd_bwd():
        xg.grad = None
        F.max_pool2d(xg, 3, 1, 1).backward(dy)
    return _time_ms(lib_fwd_bwd) - _time_ms(lambda: F.max_pool2d(x, 3, 1, 1))


def _maxpool_pools(mp, seed):
    """The kernel, its bound and the library's backward at the nine
    in-block pools' shapes (bf16, batch 256, random normals made on the
    card), and their sums over the nine pools."""
    import torch.nn.functional as F
    gen = torch.Generator(device=_DEV).manual_seed(seed)
    pools, total = {}, dict(ms=0.0, bound_ms=0.0, library_ms=0.0)
    for name, c, side, count in _MAXPOOL_POOLS:
        shape = (_MAXPOOL_BATCH, c, side, side)
        x = torch.randn(shape, generator=gen, device=_DEV,
                        dtype=torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device=_DEV,
                         dtype=torch.bfloat16)
        y = F.max_pool2d(x, 3, 1, 1)
        row = dict(shape=list(shape), pools=count,
                   ms=_time_ms(lambda: mp.maxpool3x3s1_bwd(x, y, dy)),
                   bound_ms=4 * x.numel() * x.element_size()
                   / _HBM_BYTES_PER_S * 1e3,
                   library_ms=_maxpool_library_ms(x, dy))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        pools[name] = row
        for k in total:
            total[k] += count * row[k]
        del x, dy, y
    torch.cuda.empty_cache()
    return dict(pools=pools, nine_pools=total)


def phase_maxpool(mp, gen, seed=0):
    """The opt-in max-pool backward kernel vs its plain version, bit for
    bit, at the in-block pools' shapes (batch 256, bf16 and f32, tied and
    random inputs), on -inf planes, past the whole-plane cap and at an
    odd plane; the first bf16 case is timed against its bound, its plain
    version and the library's backward, then the kernel at the nine
    in-block pools' shapes against theirs."""
    import torch.nn.functional as F
    row = None
    for shape, dtype, kind in _MAXPOOL_CASES:
        name = str(dtype)[6:]
        x, dy = _maxpool_inputs(shape, dtype, kind, gen)
        y = F.max_pool2d(x, 3, 1, 1)
        got = mp.maxpool3x3s1_bwd(x, y, dy)
        torch.cuda.synchronize()
        want = mp.maxpool3x3s1_bwd_ref(x, y, dy)
        err = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"maxpool3x3s1_bwd {shape} {name} {kind}: "
                                 f"not bit-exact (max abs err {err})")
        print(f"[kernels] maxpool3x3s1_bwd shape={list(shape)} {name} "
              f"{kind}: bit-exact", flush=True)
        if row is None:
            bytes_ = 4 * x.numel() * x.element_size()   # x, y, dy, dx
            row = dict(max_abs_err=err,
                       ms=_time_ms(lambda: mp.maxpool3x3s1_bwd(x, y, dy)),
                       plain_ms=_time_ms(
                           lambda: mp.maxpool3x3s1_bwd_ref(x, y, dy)),
                       bound_ms=bytes_ / _HBM_BYTES_PER_S * 1e3,
                       bound_by="bytes",
                       library_ms=_maxpool_library_ms(x, dy))
            print(f"[kernels] maxpool3x3s1_bwd[{name}] shape={list(shape)} "
                  + json.dumps(row), flush=True)
        del x, dy, y, got, want
        torch.cuda.empty_cache()
    print("[kernels] maxpool3x3s1_bwd[shapes] "
          + json.dumps(_maxpool_pools(mp, seed)), flush=True)
    return row


def _conv_kind(name: str) -> str:
    """Kernel kind of a device kernel of the Inception step, by name."""
    low = name.lower()
    if "lrn_" in low:
        return "lrn"
    if "pool" in low:
        return "pooling"
    if any(w in low for w in ("conv", "cudnn", "xmma", "implicit", "gemm",
                              "sm90", "cutlass", "winograd", "fft", "nhwc",
                              "nchw", "wgrad", "dgrad", "fprop")):
        return "cudnn_conv"
    return "elementwise"


def _plain_lrn(x, size=5, alpha=1.0, beta=0.75, k=1.0, relu=False):
    """``ops.lrn.lrn`` on the plain versions: the same autograd function
    shape (saves x, analytic backward), no kernel."""
    from bigdl_tpu_torch.ops import lrn

    class _Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v):
            ctx.save_for_backward(v)
            return lrn.lrn_ref(v, size, alpha, beta, k, relu)

        @staticmethod
        def backward(ctx, g):
            (v,) = ctx.saved_tensors
            return lrn.lrn_bwd_ref(g.contiguous(), v, size, alpha, beta, k,
                                   relu)
    return _Plain.apply(x)


def phase_inception(lrn, mp):
    """The harness's ``-m inception_v1`` at bench.py:109-202's geometry:
    exact LRN launch counts (2 forward and 2 backward a step, the
    backward on the "staged" route, no max-pool kernel), the first loss,
    one batch through the kernels and the plain LRN, and a profile of two
    more steps."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.utils import perf
    from bigdl_tpu_torch.ops import lrn as lrn_mod
    card = _card()
    c = _INCEPTION
    lrn.fwd_launches = lrn.bwd_launches = mp.bwd_launches = 0
    lrn.fwd_any_launches = lrn.bwd_any_launches = 0
    lrn.bwd_staged_launches = lrn.bwd_wide_launches = 0
    out = perf.main(["-m", "inception_v1", "-b", str(c["batch"]),
                     "--warmUp", str(c["warm_up"]), "-i",
                     str(c["iterations"]), "--classNum", str(c["classes"]),
                     "--device", _DEV])
    launches = {"lrn_fwd": lrn.fwd_launches, "lrn_bwd": lrn.bwd_launches,
                "lrn_bwd_staged": lrn.bwd_staged_launches,
                "lrn_fwd_any": lrn.fwd_any_launches,
                "lrn_bwd_wide": lrn.bwd_wide_launches,
                "lrn_bwd_any": lrn.bwd_any_launches,
                "maxpool3x3s1_bwd": mp.bwd_launches}
    steps = c["warm_up"] + c["iterations"]
    # Inception-v1's windows are 5: every backward on the staged route's
    # register rings, none past window 9 or on the "any" route
    expect = {"lrn_fwd": 2 * steps, "lrn_bwd": 2 * steps,
              "lrn_bwd_staged": 2 * steps, "lrn_fwd_any": 0,
              "lrn_bwd_wide": 0, "lrn_bwd_any": 0, "maxpool3x3s1_bwd": 0}
    if launches != expect:
        raise AssertionError(f"[inception] launches {launches}, expected "
                             f"{expect} ({steps} steps)")
    first, final = out["first_loss"], out["final_loss"]
    if not (math.isfinite(first) and math.isfinite(final)):
        raise AssertionError(f"non-finite harness loss: {first}, {final}")
    if abs(first - math.log(c["classes"])) > _INCEPTION_LOSS_BAND:
        raise AssertionError(f"first loss {first} not within "
                             f"{_INCEPTION_LOSS_BAND} of ln {c['classes']}")
    numbers = {k: out[k] for k in ("records_per_s", "ms_per_step", "tflops",
                                   "step_flops", "peak_bytes", "first_loss",
                                   "final_loss")}
    print(f"[inception] card='{card}' inception_v1 " + json.dumps(c)
          + " 224x224 bf16 policy, SGD(0.01, momentum 0.9): "
          + json.dumps(numbers) + f" launches={launches} (=2 per step x "
          f"{steps} steps; TFLOP/s from the analytic step count, host clock "
          f"over the timed steps ending in the loss readback)", flush=True)

    # one batch through the kernels and through the plain LRN, dropout off
    model, data, labels = out["model"], out["data"], out["labels"]
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.set_p(0.0)
    watch = {"conv1/7x7_s2": model[0].weight,
             "inception_3a/3x3": model[8][1][2].weight,
             "loss3/classifier": model[22].weight}
    crit = nn.ClassNLLCriterion()
    kernel_lrn = lrn_mod.lrn
    res = {}
    try:
        for mode, fn in (("kernel", kernel_lrn), ("plain", _plain_lrn)):
            lrn_mod.lrn = fn
            loss = crit(model(data), labels)
            res[mode] = (float(loss.detach()),
                         torch.autograd.grad(loss, list(watch.values())))
            del loss
            torch.cuda.empty_cache()
    finally:
        lrn_mod.lrn = kernel_lrn
    dloss = abs(res["kernel"][0] - res["plain"][0])
    report = {"loss_kernel": res["kernel"][0], "loss_plain": res["plain"][0],
              "loss_diff": dloss}
    if not dloss <= _INCEPTION_LOSS_TOL:
        raise AssertionError(f"kernel vs plain LRN loss differ by {dloss}")
    for name, gk, gp in zip(watch, res["kernel"][1], res["plain"][1]):
        diff = float((gk - gp).abs().max())
        scale = float(gp.abs().max())
        report[name] = {"max_abs_diff": diff, "max_abs_grad": scale}
        if not (torch.isfinite(gk).all()
                and diff <= _INCEPTION_GRAD_REL_TOL * scale):
            raise AssertionError(f"kernel vs plain LRN grad of {name} "
                                 f"differs by {diff} > "
                                 f"{_INCEPTION_GRAD_REL_TOL} x {scale}")
    print(f"[inception] kernel vs plain LRN on one batch (bf16 policy, "
          f"dropout off): " + json.dumps(report) + f" tol loss "
          f"{_INCEPTION_LOSS_TOL}, grads {_INCEPTION_GRAD_REL_TOL} x "
          f"max|grad|", flush=True)
    del res
    torch.cuda.empty_cache()

    # two more steps under the profiler, and the SGD update alone
    from torch.profiler import ProfilerActivity, profile
    sgd, state = out["sgd"], out["opt_state"]
    shape = f"B{data.shape[0]} {data.shape[2]}x{data.shape[3]}"
    kinds, wall = _profile_steps(perf.make_conv_step(model, sgd), state,
                                 data, labels, "inception", card,
                                 kind=_conv_kind, shape=shape)
    params = dict(model.named_parameters())
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    sgd_state = dict(sgd.init_state(params), neval=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            sgd_state = sgd.update(grads, params, sgd_state)
        torch.cuda.synchronize()
    sgd_kinds, _ = _device_ms(prof, 2, lambda name: "sgd")
    sgd_ms = sgd_kinds.get("sgd", 0.0)
    busy = sum(kinds.values())
    split = {"cudnn_conv": kinds.get("cudnn_conv", 0.0),
             "lrn": kinds.get("lrn", 0.0),
             "pooling": kinds.get("pooling", 0.0),
             "elementwise": kinds.get("elementwise", 0.0) - sgd_ms,
             "sgd": sgd_ms}
    print(f"[inception] card='{card}' device ms a step by kind (the SGD "
          f"update profiled alone, its time taken out of the elementwise "
          f"kernels): " + json.dumps(split) + f" device_ms_per_step={busy} "
          f"wall_ms_per_step={wall} device_idle_share={1 - busy / wall}",
          flush=True)
    return launches, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the "
              "card", file=sys.stderr)
        return 2
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops import fused_ce as fce
    from bigdl_tpu_torch.ops import lrn
    from bigdl_tpu_torch.ops import maxpool as mp
    from bigdl_tpu_torch.ops import paged_attention as pa

    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | TF32 off for matmul and cuDNN",
          flush=True)

    t0 = time.perf_counter()
    sources = ("paged_attention.cu", "flash_attention.cu", "fused_ce.cu",
               "lrn.cu", "maxpool.cu")
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(_build.load_library, sources))
    print(f"[build] {' + '.join(sources)} (one nvcc each, in parallel) "
          f"in {time.perf_counter() - t0:.3f} s", flush=True)
    for lib in libs:
        _print_ptxas(Path(lib._name).with_suffix(".ptxas.txt").read_text())
    _check_tensor_cores(libs[sources.index("flash_attention.cu")]._name,
                        libs[sources.index("fused_ce.cu")]._name,
                        libs[sources.index("paged_attention.cu")]._name)

    gen = torch.Generator().manual_seed(args.seed)
    rows = phase_kernels(pa, gen)
    flash_rows = phase_flash(fa, gen)
    fce_rows = phase_fused_ce(fce, gen)
    lrn_rows = phase_lrn(lrn, gen)
    mp_row = phase_maxpool(mp, gen, args.seed)
    launches, tc_launches, tails = phase_serve(pa, args.seed)
    flash_launches = phase_train(fa, args.seed)
    torch.cuda.empty_cache()
    wide_launches = phase_train_wide(fa, args.seed)
    narrow_launches = phase_train_narrow(fa, args.seed)
    fce_launches, fce_f32_launches, perf_flash, fce_wide_launches = (
        phase_perf(fce, fa))
    torch.cuda.empty_cache()
    conv_launches, _ = phase_inception(lrn, mp)

    # errors: the paged_attention entry takes the split-KV calls,
    # paged_prefill_tc the tensor-core ones, paged_row_tile the row-tile
    # ones
    dec = rows["decode"]
    geo = [*rows["prefill_geometries"].values(),
           *rows["pool_geometries"].values()]
    err = max([r["max_abs_err"] for k, r in rows.items()
               if k.startswith("decode") or k == "dense_cache"]
              + [r["max_abs_err"] for r in geo if r["route"] == "split"])
    row_err = max(r["max_abs_err"] for r in geo
                  if r["route"] in ("row", "row_sliced"))
    pre_err = max([rows["prefill"]["max_abs_err"],
                   rows["prefill_nan_pool"]["max_abs_err"]]
                  + [r["max_abs_err"]
                     for r in rows["prefill_buckets"].values()]
                  + [r["max_abs_err"] for r in geo if r["route"] == "tc"])
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "bigdl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "bigdl_tpu/ops/pallas/paged_attention.py:225",
        "launches": launches, "max_abs_err": err, "ms": dec["ms"],
        "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
        "library_gather_ms": dec["library_gather_ms"]}]
    # B1's prefill calls: the tensor-core kernel at the [kernels] prefill
    # case, its launches those of [serve]'s 16 prefills and its tails'
    # (pages of 256 and 300 slots, Qwen2.5-7B's G 7 prefills, all 40 of
    # Falcon-7B's G 71 calls, decode too, Phi-3-mini's prefills), each
    # run with the counters set to 0 before it and read after it
    pre = rows["prefill"]
    kernels.append({
        "name": "paged_prefill_tc", "route": "cuda",
        "source": "bigdl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "bigdl_tpu/ops/pallas/paged_attention.py:225",
        "launches": tc_launches + sum(t["tc"] for t in tails.values()),
        "max_abs_err": pre_err,
        **{k: pre[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "library_gather_ms")}})
    # the sliced tensor-core prefill past D 256: timed at q (2,96,4,512)
    # bf16 (d512), its launches those of [serve]'s head dim 512 tail,
    # prefill and decode (the counters set to 0 before it and read after
    # it), its errors those of every "tc_sliced" geometry of [kernels]
    sl = rows["pool_geometries"]["d512"]
    kernels.append({
        "name": "paged_prefill_sliced_tc", "route": "cuda",
        "source": "bigdl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "bigdl_tpu/ops/pallas/paged_attention.py:225",
        "launches": sum(t["tc_sliced"] for t in tails.values()),
        "max_abs_err": max(r["max_abs_err"] for r in geo
                           if r["route"] == "tc_sliced"),
        **{k: sl[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "library_gather_ms")}})
    # the row-tile kernel (its wide form past D 256 and its sliced form
    # past the wide form's cap among its errors): timed at f32 pools at
    # G 7 (g7-f32); its launches those of [serve]'s tails, now 0, since
    # the tensor-core kernels take every bf16 call of the tails (past D
    # 256 the sliced one, decode too): it keeps f32 pools, tables past
    # 4096 entries, unaligned rows and, past D 256, G past 64, which no
    # main path runs, and is held at every "row" and "row_sliced"
    # geometry of [kernels]
    row = rows["prefill_geometries"]["g7-f32"]
    kernels.append({
        "name": "paged_row_tile", "route": "cuda",
        "source": "bigdl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "bigdl_tpu/ops/pallas/paged_attention.py:225",
        "launches": sum(t["row"] for t in tails.values()),
        "max_abs_err": row_err,
        **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "library_gather_ms")}})
    # the padded head dims on those kernels: Phi-3-mini's 96 (at 128) on
    # the split-KV and tensor-core kernels, timed at its decode step and
    # T 512 prefill, their launches those of [serve]'s Phi-3-mini tail;
    # bf16 D 20 on the row-tile kernel's element-wise staging, timed at
    # its prefill row, its launches those of [serve]'s tails on rows
    # staged element by element (none: every tail's rows are 16-byte
    # multiples; [serve]'s own run launches split and tc alone)
    phi3 = tails["Phi-3-mini attention"]
    for name, label, launched in (
            ("paged_attention_d96", "phi3-d96-decode", phi3["split"]),
            ("paged_prefill_tc_d96", "phi3-d96", phi3["tc"]),
            ("paged_row_tile_d20", "d20",
             sum(t["unaligned"] for t in tails.values()))):
        row = rows["pool_geometries"][label]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/paged_attention.cu",
            "replaces": "bigdl_tpu/ops/pallas/paged_attention.py:225",
            "launches": launched,
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "library_gather_ms")}})
    # the main paths train in bf16: their rows are the bf16 measurements
    # (the line keeps its keys; tflops, share_of_bound and the forward's
    # gemm_ms are in [kernels])
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # and the D 256 rows: the kernels past D 128, timed at B4 S2048 H4
    # D256, their launches those of the D 256 [train] run; and the D 512
    # rows, their launches those of [perf]'s -m attention at D 512: the
    # sliced tensor-core forward, dq and dk/dv timed at that run's shape
    # (B4 S4096 H2, query tiles unpaired); the D 16 rows, the kernels at
    # D 32 on zero-padded operands, timed at the D 16 [train] run's B4
    # S2048 H8, its launches; the D 96 rows (Phi-3-mini's heads, padded
    # to 128), timed at B2 S2048 H32, their launches those of [perf]'s
    # -m attention at that shape
    for d, counts, suffix in ((128, flash_launches, ""),
                              (256, wide_launches, "_d256"),
                              (512, perf_flash[(512, "bf16")], "_d512"),
                              (16, narrow_launches, "_d16"),
                              (96, perf_flash[(96, "bf16")], "_d96")):
        for name, line, count in (("flash_fwd", 190, "fwd"),
                                  ("flash_dq", 306, "dq"),
                                  ("flash_dkdv", 322, "dkdv")):
            row = (flash_rows["main_shape"][(name, torch.bfloat16)]
                   if d == 512 else flash_rows[(name, torch.bfloat16, d)])
            # past D 256 the bf16 kernels are the sliced tensor-core ones
            kname = (name + "_sliced_tc" if fa.flash_route(
                torch.bfloat16, d) == "sliced_tc" else name)
            kernels.append({
                "name": kname + suffix, "route": "cuda",
                "kernel_route": row["kernel"],
                "source": "bigdl_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"bigdl_tpu/ops/pallas/flash_attention.py:"
                            f"{line}",
                "launches": counts[count],
                **{k: row[k] for k in keys}})
    # the f32 rows at D 512, timed at B4 S4096 H2 (``_flash_main_shape``),
    # their launches those of [perf]'s -m attention --dataType f32 there:
    # the 3xTF32 forward, dq and dk/dv (bound_ms theirs on the tensor
    # cores, the f32 CUDA-core one beside it)
    counts = perf_flash[(512, "f32")]
    for name, line, count in (("flash_fwd", 190, "fwd"),
                              ("flash_dq", 306, "dq"),
                              ("flash_dkdv", 322, "dkdv")):
        row = flash_rows["main_shape"][(name, torch.float32)]
        kernels.append({
            "name": f"{name}_{row['kernel']}_d512", "route": "cuda",
            "kernel_route": row["kernel"],
            "source": "bigdl_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"bigdl_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": counts[count], **{k: row[k] for k in keys},
            "bound_f32_cuda_cores_ms": row["bound_f32_cuda_cores_ms"]})
    # the f32 rows at head dim 128, timed at B4 S2048 H8, their launches
    # those of [perf]'s f32 transformer step: the 3xTF32 forward, dq and
    # dk/dv, each named by its route (bound_ms theirs on the tensor cores,
    # the f32 CUDA-core one beside it), with the memory each call
    # allocates
    counts = perf_flash[(128, "f32 step")]
    for name, line, count in (("flash_fwd", 190, "fwd"),
                              ("flash_dq", 306, "dq"),
                              ("flash_dkdv", 322, "dkdv")):
        row = flash_rows[(name, torch.float32, 128)]
        kernels.append({
            "name": f"{name}_{row['kernel']}",
            "route": "cuda", "kernel_route": row["kernel"],
            "source": "bigdl_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"bigdl_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": counts[count], **{k: row[k] for k in keys},
            **{k: row[k] for k in ("bound_f32_cuda_cores_ms",
                                   "peak_mib")}})
    for name, line, count in (("fused_ce_fwd", 184, "fwd"),
                              ("fused_ce_dh", 214, "dh"),
                              ("fused_ce_dw", 230, "dw")):
        row = fce_rows[(name, torch.bfloat16)]
        kernels.append({
            "name": name, "route": "cuda", "kernel_route": row["route"],
            "source": "bigdl_tpu_torch/csrc/fused_ce.cu",
            "replaces": f"bigdl_tpu/ops/pallas/fused_ce.py:{line}",
            "launches": fce_launches[count],
            **{k: row[k] for k in keys}})
    # the bf16 dh and dW/db past D 1024 (the chunked passes), timed at
    # N 8192 V 32768 D 2048, their launches those of [perf]'s step at
    # d_model 2048
    for name, line, count in (("fused_ce_dh", 214, "dh"),
                              ("fused_ce_dw", 230, "dw")):
        row = fce_rows[(name, "d2048")]
        kernels.append({
            "name": f"{name}_d2048", "route": "cuda",
            "kernel_route": row["route"],
            "source": "bigdl_tpu_torch/csrc/fused_ce.cu",
            "replaces": f"bigdl_tpu/ops/pallas/fused_ce.py:{line}",
            "launches": fce_wide_launches[count],
            **{k: row[k] for k in keys}})
    # the f32 rows at the harness head (N 8192, V 32768, D 1024), their
    # launches those of [perf]'s f32 transformer step: the forward, dh and
    # dW/db in 3xTF32 (bound_ms theirs on the tensor cores, the f32
    # CUDA-core one beside it)
    for name, line, count in (("fused_ce_fwd", 184, "fwd"),
                              ("fused_ce_dh", 214, "dh"),
                              ("fused_ce_dw", 230, "dw")):
        row = fce_rows[(name, torch.float32)]
        kernels.append({
            "name": f"{name}_{row['route']}",
            "route": "cuda", "kernel_route": row["route"],
            "source": "bigdl_tpu_torch/csrc/fused_ce.cu",
            "replaces": f"bigdl_tpu/ops/pallas/fused_ce.py:{line}",
            "launches": fce_f32_launches[count],
            **{k: row[k] for k in keys},
            **({"bound_f32_cuda_cores_ms": row["bound_f32_cuda_cores_ms"]}
               if "bound_f32_cuda_cores_ms" in row else {})})
    # the path's LRN rows: norm2, the larger of the two, in bf16 (the
    # backward on the staged route's register rings); past window 9 at
    # size 11, bf16, the tiled forward and the staged backward's slots,
    # their launches those of [inception] past window 9 (counted apart:
    # none, as its windows are 5); the tiled forward at window 288 too,
    # and the "any" backward past the staged route's cap (no path reaches
    # either)
    lrn_src = dict(route="cuda", source="bigdl_tpu_torch/csrc/lrn.cu")
    for name, case, count, line in (
            ("lrn_fwd", "norm2", "lrn_fwd", 121),
            ("lrn_bwd_staged", "norm2", "lrn_bwd_staged", 129),
            ("lrn_fwd_any", "size11", "lrn_fwd_any", 121),
            ("lrn_fwd_any_past_cap", "past_cap", "lrn_fwd_any", 121),
            ("lrn_bwd_staged_slots", "size11", "lrn_bwd_wide", 129),
            ("lrn_bwd_any", "past_cap", "lrn_bwd_any", 129)):
        what = name[:7]
        kernels.append({
            "name": name, **lrn_src,
            "replaces": f"bigdl_tpu/ops/pallas/lrn.py:{line}",
            "launches": conv_launches[count],
            **lrn_rows[(what, case, torch.bfloat16)]})
    kernels.append({
        "name": "maxpool3x3s1_bwd", "route": "cuda",
        "source": "bigdl_tpu_torch/csrc/maxpool.cu",
        "replaces": "bigdl_tpu/ops/pallas/maxpool.py:186",
        "launches": conv_launches["maxpool3x3s1_bwd"], **mp_row})
    print(f"[smoke] card='{card}' wall_s={time.perf_counter() - t_run} "
          f"(from the start of main, builds included)", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
