"""Smoke run of the PyTorch / H100 port on one card.

    python3 chip_smoke.py [--seed N]

1. Prints the card's name and power limit; exits non-zero without a GPU.
2. Builds the CUDA kernels (nvcc, one process per source) and the rANS
   coder (g++) from the sources in this checkout.
3. Kernel phase: each kernel against its plain PyTorch version at the
   shapes the decode and encode paths (bf16) and the training steps (f32;
   the stage-I yaml phase's larger shapes held untimed) give it, with the
   tolerance stated below: K1 (flash attention forward),
   K1-bwd (its backward), K2 (GN-affine + SiLU + conv3x3) and K3 (conv3x3,
   K2's input gradient), and K2's autograd backward against autograd of its
   plain version; CUDA event times of the kernel (through its wrapper), the
   plain version and one PyTorch library call for the same function (for
   the f32 kernels also that call in bf16 on the bf16-rounded operands,
   the arithmetic they do: cuDNN for K2 f32 and K3, SDPA and its backward
   for K1 f32 and K1-bwd); the card's bound for the same work; K1-bwd
   launched twice on the same inputs must give the same bits. A ragged
   sub-phase runs the card-only cases of
   ``tests/test_torch_attention_conv.py::test_kernels_on_card`` (ragged
   sequences and images, head dims 8 to 160, Cout 64 to 192) and K1-bwd in
   bf16.
4. Decode path: the full-width OneDC (lambda family: codec 512/128, FSQ
   [4]*7, SD1.5 UNet, SD2.1 VAE) on weights drawn from a seeded
   generator, in bf16. Writes two 768x768 streams and one 512x768 stream
   with the port's own programs (``write_synthetic_stream``), decodes each
   with ``OneDCRuntime.decode`` and all three with ``decode_batch``, and
   checks symbols, y_hat, images and kernel launch counts, and that a row
   of a batch decodes the same whatever stream shares its batch.
5. Encode path, on the same runtime: seeded synthetic images (two 768x768,
   one 512x768, one 500x700) through ``encode``, ``encode_batch`` (the
   768x768 pair) and ``encode_many`` (all four); every stream decodes to
   its writer's write plan (indexes, symbols, y_hat) bit for bit, launches
   per encode as ENCODE_PER_CALL, no symbol reaches the coder's clamp;
   encode wall ms and its device / host split.
6. z-only path: ``OneDC(z_only=True)`` with the lambda model's weights in
   bf16 encodes (no y stream) and decodes the 768x768 and 512x768 images,
   with the decode's launch counts, and ``decode_batch`` of both.
6b. Spatial phase (``spatial_path``), on the same runtime: a 768x768
   stream written by its programs, decoded whole and by two processes in a
   gloo group on the one card (``mp.spawn``; NCCL refuses two ranks on one
   device), each a band of rows over the mesh's ``tensor`` axis
   (``parallel/spatial.py``: halo rows for the convs and K2, GroupNorm's
   sums all-reduced, K1 on a band's queries against every key), the
   all-gathered image within the BATCH_* limits of the whole decode, each
   band's K1 / K2 launches as the "spatial768" tables; then the same two
   processes as a ``data`` axis: ``encode_batch`` and ``decode_batch`` of
   three 768x768 images with ``mesh=``, every stream decoding to its
   writer's plan, launches per rank as ``data_mesh_launches``. The
   bundles' exports (BUNDLE_EXPORTS) start before this phase, each in a
   process of its own, and run beside it and the serving phase.
7. Serving phase, on the same runtime: ``pick_stream_scale`` on a
   768x768 probe calibrates the weights (``utils/calibrate.py``) into the
   released 0.02-0.15 bpp band; the Kodak-sized set (SERVING_SIZES) and
   SERVE_SQUARE 768x768 images go through ``encode_many`` and the
   pipelined ``decode_batch`` (``serving/pipeline.py``): every row's y_hat
   is its writer's plan's bit for bit, every update takes int8 symbols,
   launches as ``batch_launches``, images within the BATCH_* limits of
   single decodes; decodes/s at the defaults, at depth 1 and per stream,
   and peak memory. The BUNDLE_BUCKET serving bundle (``utils/aot.py``,
   the BUNDLE_PROGRAMS its process runs, export seconds and bytes)
   serves the 768x768 streams in a fresh process (``--serve-bundle``),
   which loads it while the pipelined checks run and decodes after them:
   ``ServingDecoder`` and ``ServingEncoder`` with no model module loaded,
   their launches, rows and containers checked against the writers'
   plans, and the bundle's decodes/s.
8. w8a8 phase (``w8a8_path``): ``OneDCRuntime(quant="w8a8")`` on the
   serving phase's calibrated model at the default gate 512 decodes the
   SERVE_SQUARE 768x768 streams pipelined and two of them alone: the
   writers' y_hat bit for bit, K1/K2 launches as the exact decode's, the
   quantized ops and int8 products per decode as W8A8_OPS gives them,
   every image within the PSNR and correlation floors of
   ``tests/test_quant.py`` against the exact bf16 image; per op family at
   its largest decode shape the card's int32 accumulators against the
   exact integer products of the same int8 operands, and a batch row
   against its B=1 output bit for bit; the costs (per op and family w8a8
   against bf16, the gate the per-op sums favour, one decode's wall and
   device busy, pipelined decodes/s; per op in build/w8a8_costs.json);
   a BUNDLE_BUCKET w8a8 bundle (its x0 and VAE exported, the serving
   bundle's prior programs) served by a fresh process, which loads it
   while the checks run, bit-identical to the runtime's pipelined images.
9. Tiled phase (``tiled_path``), on the same runtime: a seeded 3840x2160
   image through ``TiledCodec(rt, 768, 64)`` (``parallel/tiled.py``): the
   ODTC header and 18 tiles, every tile stream decodes to its writer's
   plan bit for bit, the stitched image equals ``decode_batch``'s tiles
   bit for bit wherever one tile alone covers a pixel at weight 1, a
   768x768 image passes through to the runtime's container, launches as
   ``tiled_launches``; encode and decode walls, tiles/s, peak memory.
10. TF32 probe (printed, not a check): on a full-width f32 runtime, how many
   CDF indexes and symbols of a 512x768 write plan move when TF32 is on.
11. cli path: a full-width release directory (``tests/twins.py``, F16,
   written once for this phase and the next) loaded by
   ``eval.inference.main`` with ``checkpoint_path=``, bf16: the
   loaded weights against the twins, ``evaluate`` of the encode path's
   images as PNGs, ``--serving`` on them and on a Kodak-sized set (24
   images, after a warm pass), ``--decoder_only`` in a fresh Evaluator,
   and a TinyVAE runtime beside the large VAE's on one model (see
   ``cli_path``).
12. Quality path (``quality_path``): ``eval.rd_sweep.main`` on
   ``configs/rd_sweep.yaml`` with two points on the same release, the
   lambda model and the z-only exlow one, over 12 Kodak-sized PNGs,
   with seeded random LPIPS, DISTS and InceptionV3 files written by the
   port's converters: ``rd_curve.csv`` sorted by bpp with every metric
   finite, the sweep's launches, and on two source/recon pairs the card's
   PSNR / MS-SSIM against numpy f64 and its LPIPS, DISTS and Inception
   features and logits against the same modules on the CPU (the QUALITY_*
   limits); the metric nets' rates, the host ``sqrtm`` seconds, walls and
   peak memory.
13. Training path: ``Trainer`` on ``configs/train_stage1.yaml`` with the
   overrides in ``TRAIN_OVERRIDES`` (AdamW, no Codeformer, no remat) and a
   seeded random LPIPS file
   (``train_overrides``), full width, f32, random seeded weights, seeded
   synthetic 1024x1024 images: two steps at 512x512 (batch 2) and one at
   768x768 (batch 1). Checks finite metrics, the LPIPS term finite and
   > 0, the frozen VAE and the loss's VGG bit-identical, the trainable
   parameters unchanged by the first step (lr 0) and changed by the next,
   every kernel's launches per step (the VGG's convs are stock: no K1-K3),
   and a finite non-zero gradient on the first UNet ``attn1.to_q`` (it
   arrives only through K1-bwd and K3).
   Before it, the device memory still allocated once the cli and
   quality phases' runtimes are dropped must be under 1 GiB (no runtime
   sits in a reference cycle).
14. Training-loop phase (``train_loop_path``): ``train.trainer.main`` on
   the same config with seeded 1024x1024 training PNGs and 512x768 eval
   PNGs: TRAIN_LOOP_STEPS steps, eval and a checkpoint at TRAIN_LOOP_SAVE,
   then ``--resume`` in a fresh trainer; the resumed state equals the
   uninterrupted run's bit for bit, device memory returns once the first
   trainer is dropped, launches as ``train_loop_launches``; checkpoint
   bytes, save and restore seconds, s/step.
15. Stage-I yaml phase (``stage1_yaml_path``): ``train.trainer.main`` on
   configs/train_stage1.yaml as shipped (Adafactor, the Codeformer against
   the frozen VQGAN, frozen [vae, vqgan], batch 8, remat, FSDP2 over a
   world-1 NCCL group) with only STAGE1_OVERRIDES (resolutions [512,
   1024]), a seeded random LPIPS file, seeded 1024x1024 PNGs and a
   checkpoint at STAGE1_SAVE: STAGE1_STEPS steps at 512x512
   batch 8 and 1024x1024 batch 2 with their s/step, peak memory and
   launches (``stage1_per_step``: K1 and the VAE decoder's K2 launch again
   in the backward), the first step's Codeformer CE against ln 1024, the
   VAE and VQGAN bit-identical; a 512x512 batch-8 step without remat for
   its peak; remat, grad_accum and Adafactor held on the card
   (``stage1_checks``); then ``--resume`` in a fresh trainer, whose run of
   the last step equals the first run's state bit for bit
   (``stage1_resume``: checkpoint bytes, save and restore seconds).
16. Stage-II phase (``stage2_path``): ``train.trainer_stage2.main`` on
   configs/train_stage2.yaml as shipped (the OneDC generator, the real and
   fake SD1.5 UNets, the GAN head and the CLIP text encoder at full width;
   AdamW on both turns, remat, 512x512 batch 4) with only the data and run
   directories, a seeded random LPIPS file and the step count set:
   STAGE2_STEPS steps (the generator turn at step 0, the latents alone at
   1 and 2), eval and a checkpoint at STAGE2_SAVE, ``--resume`` in a fresh
   trainer equal to the uninterrupted run bit for bit; per step its s/step,
   peak memory, launches (``stage2_per_step``), finite losses, which
   tensors moved (the generator's moments only on its turn, the critic's
   every step), a finite non-zero gradient on the fake UNet's first
   ``attn1.to_q`` (only K1-bwd carries it); the VAE, codec and real UNet
   bit-identical; the real UNet's CFG as one batch against its two
   forwards (STAGE2_CFG_TOL); the text encoder's ms; the checkpoint's
   bytes, save and restore seconds. The kernel phase holds K1, K1-bwd,
   K2 and K3 at its shapes (the "stage2" buckets), untimed.
17. Prints ``{"kernels": [...]}``: K1 bf16 and f32, K1-bwd, K2 bf16 and
   f32, K3, with their launches by path (bf16: decode, encode,
   decode_z_only, serve, bundle, decode_w8a8, cli, quality, tiled, spatial,
   data_mesh; f32:
   train, train_loop, stage1_yaml, stage2), the card line and, last, the
   device line.

The whole run holds the numerics the package pins in its entry points
(``onedc_tpu_torch/utils/numerics.py``).
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import DTensor

# Limits of the kernel phase, against the plain version's output ref on
# the same inputs, with no absolute floor:
#   ||out - ref|| <= REL_L2_TOL * ||ref||  and
#   max|out - ref| <= MAX_TOL * max|ref|.
# bf16: both sides round their output to bf16 (at most 2^-8 relative, so
# one ulp at the largest magnitude is <= 0.8 % of it). f32: the kernels
# round their operands to bf16 in shared memory (2^-9 relative each), the
# plain version computes in f32. Besides, K1 and K1-bwd round the
# probabilities (and dS) to bf16 before their second products, K2
# evaluates the SiLU with the fast intrinsics (bf16: tanh.approx, relative
# error ~2^-11; f32: __expf, __fdividef), and all sum in f32 in another
# order than the plain version. Each check also shows its power: the plain
# version with one block iteration's work left out (one 64-key tile for K1
# and K1-bwd's dQ, one 64-query tile for K1-bwd's dK and dV, one input
# chunk for K2 and K3: 64 channels) must fail it.
REL_L2_TOL = 1e-2
MAX_TOL = 2e-2
# K1's row log-sum-exp against the plain one, absolute (it enters exp()
# in the backward, so an absolute error e scales P by exp(e)), as the root
# mean square over rows and the largest over rows. The scores come from
# bf16-rounded operands: a row dominated by a few large scores carries
# their rounding error (largest 1.07e-2, at D = 8), the rest average it
# out (root mean square 3-10e-4 for q, k rounded to bf16, computed on a
# CPU). Leaving out one 64-key tile moves every row by about 64/N, one
# way: root mean square 7.0e-3 at N = 9216, and it must fail.
LSE_RMS_TOL = 3e-3
LSE_MAX_TOL = 2e-2
# decode_batch against the single decodes. Within one bucket, each row must
# depend on its own stream only: a row decodes bit-identically whatever
# stream shares its batch (checked exactly). Against a batch-1 decode a row
# drifts: cuDNN and the GroupNorm reductions pick other kernels for a batch
# of 2 than for 1 (tools/probe_port_batch.py lists the ops), bf16 rounds
# elsewhere, x0 recovery divides by sqrt(alpha_bar(999)) ~ 0.069 and the
# random-weight VAE turns 0.2 % of noise on x0 into ~2 % in the image
# (3.1e-2 relative L2 and 3.9e-2 of max|image| measured on an H100).
# Limits: the difference's L2 norm relative to the image's, and its
# largest magnitude relative to the image's largest.
BATCH_REL_L2_TOL = 0.05
BATCH_MAX_TOL = 0.06

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, SXM data sheet
H100_HBM_BYTES = 3.35e12   # bytes/s, SXM data sheet
# exponentials/s of the special-function units: 16 per clock per SM, on
# 132 SMs at 1.83 GHz, the clock at which the 989 TFLOP/s above is quoted
# (989e12 / (132 SMs * 4096 bf16 FLOP per clock) = 1.83e9)
H100_EXP_PER_S = 132 * 16 * 1.83e9

# shapes the decode path gives the kernels, with their launches per decode
# call of one bucket (768x768; K1 at /8 and /16, K2 in every VAE resnet);
# "batch2" checks the batch index of each kernel at one shape of the
# two-stream bucket that decode_batch runs; "encode768" holds the shapes of
# one 768x768 encode (K1: the encoder UNet's /16 attention, 64 heads of 8;
# K2: the VAE encoder's 10 resnets), "encode512x704" K1's one shape of a
# 500x700 encode (padded to 512x704): the VAE mid-block's single 512-wide
# head over its whole 64x88 grid, which is not a multiple of its 16-pixel
# window (the ragged decode launches it once more, in the VAE decoder)
# "spatial768" holds one band's launches of the spatial phase's 768x768
# decode over SPATIAL_BANDS bands: K1 as (B, N queries, M keys, H, D), a
# band's queries against every band's keys; K2 on a band of 48 latent rows
# (and its upsampled levels) plus one row of its neighbour
K1_SHAPES = {"768x768": [((1, 9216, 8, 40), 5), ((1, 2304, 8, 80), 5)],
             "512x768": [((1, 6144, 8, 40), 5)],
             "batch2": [((2, 2304, 8, 80), 5)],
             "encode768": [((1, 2304, 64, 8), 2)],
             "encode512x704": [((1, 5632, 1, 512), 1)],
             "spatial768": [((1, 4608, 9216, 8, 40), 5),
                            ((1, 1152, 2304, 8, 80), 5)]}
K2_SHAPES = {"768x768": [((1, 96, 96, 512, 512), 10),
                         ((1, 192, 192, 512, 512), 6),
                         ((1, 384, 384, 512, 256), 1),
                         ((1, 384, 384, 256, 256), 5),
                         ((1, 768, 768, 256, 128), 1),
                         ((1, 768, 768, 128, 128), 5)],
             "512x768": [((1, 64, 96, 512, 512), 10),
                         ((1, 128, 192, 512, 512), 6),
                         ((1, 256, 384, 512, 256), 1),
                         ((1, 256, 384, 256, 256), 5),
                         ((1, 512, 768, 256, 128), 1),
                         ((1, 512, 768, 128, 128), 5)],
             "batch2": [((2, 96, 96, 512, 512), 10)],
             "encode768": [((1, 768, 768, 128, 128), 4),
                           ((1, 384, 384, 128, 256), 1),
                           ((1, 384, 384, 256, 256), 3),
                           ((1, 192, 192, 256, 512), 1),
                           ((1, 192, 192, 512, 512), 3),
                           ((1, 96, 96, 512, 512), 8)],
             "spatial768": [((1, 49, 96, 512, 512), 10),
                            ((1, 97, 192, 512, 512), 6),
                            ((1, 193, 384, 512, 256), 1),
                            ((1, 193, 384, 256, 256), 5),
                            ((1, 385, 768, 256, 128), 1),
                            ((1, 385, 768, 128, 128), 5)]}
# launches per decode; a 500x700 stream (512x704 padded) launches K1 at /8
# (5632 tokens) and in the VAE decoder's mid-block
K1_PER_CALL = {"768x768": 10, "512x768": 5, "768x512": 5, "512x704": 6}
K2_PER_CALL = {"768x768": 28, "512x768": 28, "768x512": 28, "512x704": 28}
# the spatial phase (``spatial_path``): one SPATIAL_SIZE stream decoded by
# SPATIAL_BANDS processes, each a band of rows, in a gloo group on the one
# card (NCCL refuses two ranks on one device; gloo carries the CUDA
# tensors of all_reduce and all_gather, checked on an H100 with torch
# 2.11), against the single decode of the same stream within the BATCH_*
# limits (the same reorder of sums as a batch row's); then the batch codecs
# over a data axis of the same processes: DATA_MESH_IMAGES images through
# ``encode_batch`` (one padding row) and ``decode_batch``, each stream
# decoding to its writer's plan
SPATIAL_BANDS = 2
SPATIAL_SIZE = (768, 768)
DATA_MESH_IMAGES = 3
# launches (K1, K2) per encode of one image (or one device chunk of
# encode_many), by padded size: the encoder UNet's attention reaches K1
# only from 2048 tokens at /16 (2304 at 768x768, 1536 at 512x768 and
# 768x512, 1408 at 512x704); at 512x704 the VAE encoder's mid-block attends
# over its whole grid (5632 tokens) in K1
ENCODE_PER_CALL = {(768, 768): (2, 20), (512, 768): (0, 20),
                   (768, 512): (0, 20), (512, 704): (1, 20)}
# the encode phase's images (h, w): two 768x768, one 512x768 and a ragged
# one that pads to 512x704
ENCODE_SIZES = [(768, 768), (768, 768), (512, 768), (500, 700)]
# the card-only cases of tests/test_torch_attention_conv.py::
# test_kernels_on_card: K1 (B, N, H, D) in bf16 and f32 with the row
# log-sum-exp (K1-bwd in f32 where D <= 128, and in bf16 at the shapes of
# K1_BWD_BF16); K2 in both dtypes and K3 (B, H, W, Cin, Cout) on ragged
# images. Same limits as the kernel phase; the LSE at most 2e-2 off.
RAGGED_K1 = [(1, 2304, 8, 80), (2, 300, 2, 40), (1, 200, 1, 160),
             (1, 330, 4, 8)]
# K1 at D = 512, which it takes in bf16 only (f32 raises), on ragged N and M
RAGGED_K1_WIDE = [(2, 200, 2, 512)]
K1_BWD_BF16 = [(2, 300, 2, 40), (1, 2304, 8, 80)]
RAGGED_K2 = [(2, 24, 40, 64, 64), (1, 20, 36, 128, 128), (1, 20, 36, 64, 192),
             (1, 48, 48, 256, 192)]

# shapes the training step gives the kernels (f32), with their launches per
# forward pass: "train512" is a 512x512 step of batch 2, "train768" a
# 768x768 step of batch 1 (the training phases, no remat: per step);
# "stage512" and "stage1024" the stage-I yaml phase's 512x512 batch-8 and
# 1024x1024 batch-2 steps (remat: ``stage1_per_step``). K1: the SD UNet's
# attn1 at /8 (and /16 from 768), the encoder UNet's /16 attention (64
# heads of 8) from 768; K1-bwd runs once per K1 launch. K2: the VAE
# encoder's 20 resnet convs (forward only: the encoder is frozen and
# detached) and the decoder's 28; K3: the input gradient of each of the
# decoder's 28, (B, H, W, Cout -> Cin) of its K2 conv. The kernel phase
# times the "train" buckets and holds the "stage" ones, untimed.
K1_TRAIN_SHAPES = {"train512": [((2, 4096, 8, 40), 5)],
                   "train768": [((1, 9216, 8, 40), 5), ((1, 2304, 8, 80), 5),
                                ((1, 2304, 64, 8), 2)],
                   "stage512": [((8, 4096, 8, 40), 5)],
                   "stage1024": [((2, 16384, 8, 40), 5), ((2, 4096, 8, 80), 5),
                                 ((2, 4096, 64, 8), 2)],
                   "stage2": [((4, 4096, 8, 40), 5)]}
K2_TRAIN_SHAPES = {"train512": [((2, 64, 64, 512, 512), 18),
                                ((2, 128, 128, 512, 512), 9),
                                ((2, 128, 128, 256, 512), 1),
                                ((2, 256, 256, 512, 256), 1),
                                ((2, 256, 256, 256, 256), 8),
                                ((2, 256, 256, 128, 256), 1),
                                ((2, 512, 512, 256, 128), 1),
                                ((2, 512, 512, 128, 128), 9)],
                   "train768": [((1, 96, 96, 512, 512), 18),
                                ((1, 192, 192, 512, 512), 9),
                                ((1, 192, 192, 256, 512), 1),
                                ((1, 384, 384, 512, 256), 1),
                                ((1, 384, 384, 256, 256), 8),
                                ((1, 384, 384, 128, 256), 1),
                                ((1, 768, 768, 256, 128), 1),
                                ((1, 768, 768, 128, 128), 9)],
                   "stage512": [((8, 64, 64, 512, 512), 18),
                                ((8, 128, 128, 512, 512), 9),
                                ((8, 128, 128, 256, 512), 1),
                                ((8, 256, 256, 512, 256), 1),
                                ((8, 256, 256, 256, 256), 8),
                                ((8, 256, 256, 128, 256), 1),
                                ((8, 512, 512, 256, 128), 1),
                                ((8, 512, 512, 128, 128), 9)],
                   "stage1024": [((2, 128, 128, 512, 512), 18),
                                 ((2, 256, 256, 512, 512), 9),
                                 ((2, 256, 256, 256, 512), 1),
                                 ((2, 512, 512, 512, 256), 1),
                                 ((2, 512, 512, 256, 256), 8),
                                 ((2, 512, 512, 128, 256), 1),
                                 ((2, 1024, 1024, 256, 128), 1),
                                 ((2, 1024, 1024, 128, 128), 9)]}
K3_TRAIN_SHAPES = {"train512": [((2, 64, 64, 512, 512), 10),
                                ((2, 128, 128, 512, 512), 6),
                                ((2, 256, 256, 256, 512), 1),
                                ((2, 256, 256, 256, 256), 5),
                                ((2, 512, 512, 128, 256), 1),
                                ((2, 512, 512, 128, 128), 5)],
                   "train768": [((1, 96, 96, 512, 512), 10),
                                ((1, 192, 192, 512, 512), 6),
                                ((1, 384, 384, 256, 512), 1),
                                ((1, 384, 384, 256, 256), 5),
                                ((1, 768, 768, 128, 256), 1),
                                ((1, 768, 768, 128, 128), 5)],
                   "stage512": [((8, 64, 64, 512, 512), 10),
                                ((8, 128, 128, 512, 512), 6),
                                ((8, 256, 256, 256, 512), 1),
                                ((8, 256, 256, 256, 256), 5),
                                ((8, 512, 512, 128, 256), 1),
                                ((8, 512, 512, 128, 128), 5)],
                   "stage1024": [((2, 128, 128, 512, 512), 10),
                                 ((2, 256, 256, 512, 512), 6),
                                 ((2, 512, 512, 256, 512), 1),
                                 ((2, 512, 512, 256, 256), 5),
                                 ((2, 1024, 1024, 128, 256), 1),
                                 ((2, 1024, 1024, 128, 128), 5)]}
# the stage-II phase's 512x512 batch-4 steps: the VAE's shapes of
# "stage512" at batch 4 (its K1 at batch 8, the real UNet's CFG rows, is
# "stage512"'s own shape)
for _table in (K2_TRAIN_SHAPES, K3_TRAIN_SHAPES):
    _table["stage2"] = [((4,) + shape[1:], n)
                        for shape, n in _table["stage512"]]
# K2's autograd backward (recompute + K3 + torch dw), one shape per level
K2_BWD_SHAPES = [(2, 64, 64, 512, 512), (2, 128, 128, 512, 512),
                 (2, 256, 256, 256, 256), (2, 512, 512, 128, 128)]
# launches per training step: (K1, K1-bwd, K2, K3)
TRAIN_PER_STEP = {512: (5, 5, 48, 28), 768: (12, 12, 48, 28)}
# configs/train_stage1.yaml with these overrides (dotted keys); the phase
# adds ``lpips_weights``, a file of seeded random LPIPS weights that it
# writes (``nn/lpips.py:random_lpips_weights``). ``gradient_checkpointing``
# off keeps these phases' steps comparable with their records from before
# remat was ported
TRAIN_OVERRIDES = {"optimizer": "adamw", "fsdp": False,
                   "model.use_codeformer": False, "frozen": ["vae"],
                   "batch_size": 2, "resolutions": [512, 768],
                   "batch_scales": [1.0, 0.5], "warmup_steps": 2,
                   "gradient_checkpointing": False}
# the stage-I yaml phase: configs/train_stage1.yaml as shipped (Adafactor,
# the Codeformer, frozen [vae, vqgan], batch 8, remat, FSDP: a mesh of one
# process in a world-1 NCCL group) with only these overrides and its own
# LPIPS file, data folders, run directory and step counts: the two of the
# yaml's resolutions at which the JAX Codeformer's window divides its grid
# (ROADMAP.md, Queue 3). Steps 0-8: MultiResolutionCrop.pick gives 1024 at
# 0-4 and 6, 512 at 5, 7 and 8. Launches per forward pass as the "stage"
# buckets; per step with remat ``stage1_per_step``. A checkpoint at
# STAGE1_SAVE, resumed after the phase's checks in a fresh trainer that
# runs the last step again: its state equals the first trainer's bit for
# bit.
STAGE1_OVERRIDES = {"resolutions": [512, 1024], "batch_scales": [1.0, 0.25]}
STAGE1_STEPS = 9
STAGE1_SAVE = 8
STAGE1_PER_FORWARD = {512: (5, 5, 48, 28), 1024: (12, 12, 48, 28)}
STAGE1_TRAIN_IMAGES = 8
# the stage-I phase's checks on one batch of two 512x512 images, relative
# L2 over all the gradients together: remat against no remat, and
# grad_accum 2 against the mean of its two micro-batches run alone (the
# same arithmetic in both pairs; the run-to-run spread without remat is
# printed beside them: a run is not bit-stable where a reduction's order
# varies, and a flipped rounding of y in the codec moves the gradients by
# more than the ulp that flipped it; on an H100 1.75e-6 spread, 6.7e-6 and
# 1.9e-5), their metrics relative (9.2e-6); grad_accum 2 against one batch
# of 2, whose convs take other algorithms than a batch of 1: the random
# weights amplify those roundings (the x0 recovery divides by 0.069, and
# batch rows of a decode differ by 3.1e-2, the BATCH_* limits above), on
# an H100 2.0-2.7e-2 on the gradients and 2.8e-4 to 3.5e-3 on the metrics
# over three readings; an accumulation that drops its 1/N is off by 1 and
# one that drops a micro-batch by about 0.7. One Adafactor update on the
# card against the CPU, relative to the update's norm, at a learning rate
# of 1 (1.5e-5 at the run's 5e-5 on an H100, where the parameters' own
# rounding dominates the difference).
STAGE1_REMAT_TOL = 1e-4
STAGE1_MICRO_TOL = 1e-4
STAGE1_MICRO_METRIC_TOL = 1e-4
STAGE1_ACCUM_TOL = 0.1
STAGE1_ACCUM_METRIC_TOL = 1e-2
STAGE1_ADAFACTOR_TOL = 1e-5
FIRST_ATTN1 = ("unet.down_blocks_0.attentions_0.transformer_blocks_0.attn1."
               "to_q.weight")
# the stage-II phase: configs/train_stage2.yaml as shipped (512x512 PNGs at
# its batch 4, AdamW, remat, the generator turn every 10th step) with only
# the data, run directory, LPIPS file and step count set; steps 0-2 (the
# generator turn at 0, latents alone at 1 and 2), eval and a checkpoint at
# STAGE2_SAVE, then ``--resume`` to STAGE2_STEPS. The critics' attn1 at the
# /8 grid (4096 tokens at 512x512) runs K1, five per UNet forward and two
# on the GAN logit's down path (STAGE2_UNET_K1, STAGE2_DOWN_K1); the VAE
# encoder's K2 and the decoder's K2 / K3 as in the "stage2" buckets.
STAGE2_STEPS = 3
STAGE2_SAVE = 2
STAGE2_TRAIN_IMAGES = 8
STAGE2_EVAL_IMAGES = 2
STAGE2_SIZE = 512
STAGE2_UNET_K1 = 5
STAGE2_DOWN_K1 = 2
STAGE2_ENC_K2 = 20
STAGE2_DEC_K2 = 28
# the real UNet's CFG as one batch of 2B rows against its two B-row
# forwards, relative L2 of eps (cuDNN may round a batch's rows otherwise;
# the BATCH_* limits above are a bf16 decode's)
STAGE2_CFG_TOL = 1e-4
FAKE_ATTN1 = ("fake_unet.down_blocks_0.attentions_0.transformer_blocks_0."
              "attn1.to_q.weight")
# the cli phase's Kodak-sized serving set: 24 images, 18 landscape (512x768)
# and 6 portrait (768x512) as in Kodak, the portrait ones at Kodak's places
SERVING_SIZES = [(768, 512) if i in (4, 9, 10, 17, 18, 19) else (512, 768)
                 for i in range(1, 25)]
# encode_many's device chunk and the pipelined decode_batch's chunk (their
# default, ONEDC_PIPELINE_CHUNK unset), and the VAE sub-batch of the
# pipelined schedule (ONEDC_VAE_CHUNK unset)
SERVING_CHUNK = 8
VAE_CHUNK = 8
# the serving phase: the Kodak-sized set and SERVE_SQUARE images at 768x768,
# encoded with calibrated weights; the bundle's bucket (H, W, batch) and
# the images ServingEncoder encodes (the first of the 768x768 ones)
SERVE_SQUARE = 16
SERVE_SIZES = SERVING_SIZES + [(768, 768)] * SERVE_SQUARE
# the quality phase's images: the first half of the Kodak-sized set (nine
# at 512x768, three at 768x512), which keeps the script inside its time
# limit beside the spatial phase
QUALITY_SIZES = SERVING_SIZES[:12]
BUNDLE_BUCKET = (768, 768, 8)
BUNDLE_ENCODE = 8
# the programs each bundle exports: those its process runs (the calibrated
# streams take int8 symbols on every update, which the serving phase
# checks, so the int16 update programs and the fused decode, which no
# serving process runs, are left out); the w8a8 bundle exports its x0 and
# VAE and takes the serving bundle's prior programs, which are traced
# outside the quant mode (``utils/aot.py``)
BUNDLE_PRIOR = ("begin",) + tuple(f"update{s}_i8" for s in range(4))
BUNDLE_PROGRAMS = BUNDLE_PRIOR + ("x0", "vae", "encode")
W8A8_BUNDLE_PROGRAMS = ("x0", "vae")
# the exports, each in a process of its own (``--export-bundle``) on a
# model built as the decode phase builds it, started before the spatial
# phase and run beside it and the serving phase: (name, quant mode,
# programs). A program takes the weights as an argument, so one exported
# from another model of the same layout is the same program.
BUNDLE_EXPORTS = (("bf16", None, BUNDLE_PRIOR + ("x0", "vae")),
                  ("bf16_encode", None, ("encode",)),
                  ("w8a8", "w8a8", W8A8_BUNDLE_PROGRAMS))
# modules a bundle process must not load: the model code
MODEL_MODULES = ("onedc_tpu_torch.models", "onedc_tpu_torch.nn.unet_sd",
                 "onedc_tpu_torch.nn.vae", "onedc_tpu_torch.eval")
# tensors of the release that the cli phase reads back from the loaded
# model, (file, reference name, port key): a LoRA-merged linear, a
# LoRA-merged conv and a codec conv that the porter's rules rename
RELEASE_PROBES = [
    ("model", "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q",
     "unet.down_blocks_0.attentions_0.transformer_blocks_0.attn1.to_q."
     "weight"),
    ("model", "down_blocks.0.resnets.0.conv1",
     "unet.down_blocks_0.resnets_0.conv1.weight"),
    ("model_1", "dec.blocks.3", "codec.dec.up.conv_expand.weight"),
]
# launches (K1, K2) per TinyVAE decode (the cli phase's vae=tiny run): the
# UNet's K1 as in the large VAE's decode; the TinyVAE's convs are stock
TINY_VAE_PER_CALL = {"768x768": (10, 0)}
# the tiled phase: a seeded 3840x2160 image through TiledCodec(rt, 768, 64),
# 3 rows x 6 columns of 768x768 tiles (rows 0, 704, 1392; columns 0, 704,
# 1408, 2112, 2816, 3072), then a 768x768 image through the pass-through
TILED_SIZE = (2160, 3840)
TILED_TILE = 768
TILED_OVERLAP = 64
TILED_TILES = 18
# the training-loop phase: train.trainer.main on configs/train_stage1.yaml
# with TRAIN_OVERRIDES, TRAIN_LOOP_TRAIN seeded 1024x1024 PNGs and
# TRAIN_LOOP_EVAL 512x768 ones; TRAIN_LOOP_STEPS steps with eval and a
# checkpoint at TRAIN_LOOP_SAVE, then a resumed run from there to the end.
# EVAL_PER_IMAGE: (K1, K1-bwd, K2, K3) of one eval forward at 512x768 in
# f32 (the SD UNet's attn1 at /8; the VAE encoder's 20 and decoder's 28
# resnet convs; no backward)
TRAIN_LOOP_TRAIN = 4
TRAIN_LOOP_EVAL = 2
TRAIN_LOOP_STEPS = 3
TRAIN_LOOP_SAVE = 2
EVAL_PER_IMAGE = {(512, 768): (5, 0, 48, 0), (512, 512): (5, 0, 48, 0)}
# the w8a8 phase: ops per decode that run quantized at the default gate 512,
# by family (``nn/quant.py:family``; the full-width model's structure, held
# by tests/test_torch_chip_smoke_tables.py against a recording pass on meta
# tensors); the floors of tests/test_quant.py for a w8a8 image against the
# exact bf16 one; the gates the per-op timings are summed at
W8A8_OPS = {"conv3x3": 33, "conv3x3_s2": 2, "conv1x1": 32, "upsample": 5,
            "dense": 114, "time_dense": 18}
W8A8_PSNR_FLOOR = 25.0
W8A8_CORR_FLOOR = 0.99
W8A8_GATES = (0, 128, 320, 512, 640, 1280, 1 << 30)
# the quality phase's limits, the card's f32 metrics (TF32 off) against
# their plain references on the same PNGs: PSNR (dB) and MS-SSIM against
# numpy f64 (f32 sums over a 512x768 image, and MS-SSIM's variances as
# differences of blurred means); LPIPS and DISTS relative to the CPU's f32
# distance (floored at 1e-2), features and logits relative to the CPU's
# largest value (cuDNN's f32 algorithms sum in other orders than the CPU's
# through 13 VGG and 94 Inception convolutions)
QUALITY_PSNR_TOL = 1e-3
QUALITY_SSIM_TOL = 1e-4
QUALITY_DIST_TOL = 1e-3
QUALITY_FEAT_TOL = 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device ms of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, exps: float = 0.0):
    """The least time the card could take: the largest of the tensor-core
    operations, the bytes and the exponentials over their peak rates, and
    which of them it is."""
    times = {"operations": flops / H100_BF16_FLOPS * 1e3,
             "bytes": nbytes / H100_HBM_BYTES * 1e3,
             "exponentials": exps / H100_EXP_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def attention_bound(b, n, h, d, itemsize, lse=False, backward=False,
                    m=None):
    """bound_ms of K1 (or K1-bwd) on (b, n, h, d) q and m keys (None: n):
    the forward does 4*b*h*n*m*d FLOPs and b*h*n*m exponentials and moves
    q, k, v, o (and the row LSE); the backward recomputes P once (the same
    exponentials), does 10*b*h*n*n*d FLOPs and moves q, k, v, o, do, dq,
    dk, dv and the LSE and di rows."""
    m = n if m is None else m
    exps = float(b) * h * n * m
    if backward:
        return bound_ms(10.0 * b * h * n * n * d,
                        7 * b * n * h * d * itemsize + 2 * b * h * n * 4, exps)
    return bound_ms(4.0 * b * h * n * m * d,
                    2 * b * (n + m) * h * d * itemsize
                    + (b * h * n * 4 if lse else 0), exps)


# ---------------------------------------------------------------------------
# weights and streams
# ---------------------------------------------------------------------------

def init_random_weights(model: torch.nn.Module, seed: int) -> None:
    """Seeded weights in place (``onedc_tpu_torch/models/onedc.py:
    init_random_weights``), drawn on the model's device."""
    from onedc_tpu_torch.models import onedc

    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(seed)
    onedc.init_random_weights(model, gen)


@torch.no_grad()
def write_synthetic_stream(runtime, h: int, w: int, seed: int):
    """A lambda-family container for an h x w image, written with the
    port's own decode programs (the JAX ``write_container`` order).

    z indices are drawn at random; at each of the 4 steps the symbols are
    drawn ~ round(N(0, scale_table[index])) under the step's CDF index, with
    one symbol in 500 drawn at 8x the scale so that bypass escapes occur,
    and fed to ``decompress_update`` for the next step's indexes. Returns
    (stream, y_hat of the writer, [(indexes, symbols)] per step).
    """
    from onedc_tpu_torch.entropy.coder import EntropyCoder
    from onedc_tpu_torch.entropy.framing import encode_i, get_padding_size
    from onedc_tpu_torch.entropy.gaussian import (
        GaussianConditionalCoder,
        scale_table,
    )

    rng = np.random.default_rng(seed)
    codec = runtime.model.codec
    ds = runtime.ds
    _, pr, _, pb = get_padding_size(h, w, ds)
    zh, zw = (h + pb) // ds, (w + pr) // ds
    z = rng.integers(0, codec.z_vq.codebook_size, (1, zh, zw),
                     dtype=np.int64).astype(np.int32)
    st = codec.decompress_begin(torch.from_numpy(z).to(runtime.device))
    table = scale_table()
    steps = []
    for step in range(4):
        idx = st["indexes_r"].cpu().numpy()
        sigma = table[idx.astype(np.int64)]
        sigma = np.where(rng.random(idx.shape) < 2e-3, 8 * sigma, sigma)
        sym = np.round(rng.standard_normal(idx.shape) * sigma)
        sym = np.clip(sym, -30000, 30000).astype(np.int16)
        steps.append((idx, sym))
        st.update(codec.decompress_update(
            step, torch.from_numpy(sym).to(runtime.device), st["means"],
            st["y_hat"], st["common"]))

    ec = EntropyCoder()
    gc = GaussianConditionalCoder()
    gc.update(ec)
    for idx, sym in steps:
        gc.encode_with_indexes(sym, idx)
    ec.flush()
    stream = encode_i(h, w, ec.get_encoded_stream(),
                      codec.z_vq.pack_indices(z))
    return stream, st["y_hat"], steps


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def compare(name: str, out, ref, mutant) -> dict:
    """Holds ``out`` against ``ref`` within REL_L2_TOL / MAX_TOL, and checks
    that ``mutant`` (ref's function with one block iteration's work left
    out) would fail the same limits."""
    ref = ref.float()

    def errs(t):
        diff = t.float() - ref
        return ((diff.norm() / ref.norm()).item(),
                (diff.abs().max() / ref.abs().max()).item(),
                diff.abs().max().item())

    rel_l2, rel_max, max_abs = errs(out)
    m_rel_l2, m_rel_max, _ = errs(mutant)
    print(f"{name}: relative L2 {rel_l2:.3e} (tol {REL_L2_TOL}), max err "
          f"{max_abs:.3e} = {rel_max:.3e} of max|ref| (tol {MAX_TOL}); one "
          f"block step left out: {m_rel_l2:.3e}, {m_rel_max:.3e}", flush=True)
    if not (rel_l2 <= REL_L2_TOL and rel_max <= MAX_TOL):
        raise AssertionError(f"{name} disagrees with its plain version")
    if m_rel_l2 <= REL_L2_TOL and m_rel_max <= MAX_TOL:
        raise AssertionError(f"{name}: the limits cannot tell a kernel that "
                             f"skips one block step")
    return dict(max_abs_err=max_abs, rel_l2_err=rel_l2, rel_max_err=rel_max,
                mutant_rel_l2=m_rel_l2, mutant_rel_max=m_rel_max)


def check_k1(gen: torch.Generator):
    from onedc_tpu_torch.ops import flash_attention as k1

    rows = []
    for bucket, shapes in K1_SHAPES.items():
        for shape, count in shapes:
            # (b, n, h, d), or (b, n, m, h, d): n queries against m keys
            b, n, m, h, d = shape if len(shape) == 5 else (
                shape[0], shape[1], *shape[1:])
            q, k, v = (torch.randn((b, r, h, d), generator=gen,
                                   device="cuda", dtype=torch.bfloat16)
                       for r in (n, m, m))
            scale = d ** -0.5
            out = k1.flash_attention(q, k, v, scale)
            ref = k1.attention_plain(q, k, v, scale)
            mutant = k1.attention_plain(q, k[:, 64:], v[:, 64:], scale)
            errs = compare(f"K1 {bucket} {shape}", out, ref, mutant)
            del ref, mutant
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            ms = cuda_ms(lambda: k1.flash_attention(q, k, v, scale))
            plain = cuda_ms(lambda: k1.attention_plain(q, k, v, scale),
                            iters=3)
            lib = cuda_ms(lambda: sdpa(qt, kt, vt, scale=scale))
            bnd, by = attention_bound(b, n, h, d, 2, m=m)
            rows.append(dict(bucket=bucket, shape=list(shape), count=count,
                             **errs, ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=bnd, bound_by=by))
            print(f"K1 {bucket} {shape} x{count}: kernel {ms:.4f} ms "
                  f"plain {plain:.4f} sdpa {lib:.4f} bound {bnd:.4f} ({by})",
                  flush=True)
    return rows


def check_k2(gen: torch.Generator):
    from onedc_tpu_torch.ops import conv3x3 as k2

    rows = []
    for bucket, shapes in K2_SHAPES.items():
        for (b, hh, ww, cin, cout), count in shapes:
            x = torch.randn((b, hh, ww, cin), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            mul = 1 + 0.1 * torch.randn((b, cin), generator=gen,
                                        device="cuda")
            add = 0.1 * torch.randn((b, cin), generator=gen, device="cuda")
            w = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
                 / (9 * cin) ** 0.5).to(torch.bfloat16)
            bias = (0.1 * torch.randn((cout,), generator=gen, device="cuda")
                    ).to(torch.bfloat16)
            out = k2.affine_silu_conv3x3(x, mul, add, w, bias)
            ref = k2.affine_silu_conv3x3_plain(x, mul, add, w, bias)
            w_skip = w.clone()
            # one input chunk of the bf16 kernel left out
            w_skip[:, :, :k2.CHANNEL_MULTIPLE] = 0
            mutant = k2.affine_silu_conv3x3_plain(x, mul, add, w_skip, bias)
            errs = compare(f"K2 {bucket} {(b, hh, ww, cin, cout)}", out, ref,
                           mutant)
            del ref, mutant, w_skip
            t = torch.nn.functional.silu(
                x.float() * mul[:, None, None, :] + add[:, None, None, :]
            ).to(torch.bfloat16).permute(0, 3, 1, 2)  # channels_last NCHW
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            conv = torch.nn.functional.conv2d
            ms = cuda_ms(lambda: k2.affine_silu_conv3x3(x, mul, add, w, bias))
            plain = cuda_ms(lambda: k2.affine_silu_conv3x3_plain(
                x, mul, add, w, bias), iters=5)
            lib = cuda_ms(lambda: conv(t, w_oihw, bias, padding=1))
            flops = 2.0 * b * hh * ww * cin * cout * 9
            nbytes = (b * hh * ww * (cin + cout) * 2 + 9 * cin * cout * 2
                      + 2 * b * cin * 4 + cout * 2)
            bnd, by = bound_ms(flops, nbytes)
            rows.append(dict(bucket=bucket, shape=[b, hh, ww, cin, cout],
                             count=count, **errs, ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=bnd, bound_by=by))
            print(f"K2 {bucket} {(b, hh, ww, cin, cout)} x{count}: kernel "
                  f"{ms:.4f} ms plain {plain:.4f} cudnn {lib:.4f} bound "
                  f"{bnd:.4f} ({by})", flush=True)
    return rows


def lse_errs(lse, ref):
    """(root mean square, largest) of ``lse - ref`` over rows."""
    diff = (lse - ref).double()
    return diff.pow(2).mean().sqrt().item(), diff.abs().max().item()


def sdpa_bwd_timer(q, k, v, dout, scale):
    """A timed call of SDPA's backward alone (library yardstick of K1-bwd):
    the graph of one forward, kept for repeated gradients."""
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                           scale=scale)
    dot = dout.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def plain_by_heads(fn, *args, group: int = 2):
    """A plain attention version run on ``group`` heads at a time and
    joined: per head the same arithmetic, and only ``group`` heads' f32
    score matrices live at once (at 16384 tokens one head's is 1 GiB per
    image). (B, N, H, D) tensors split on axis 2, (B, H, N) ones (the LSE)
    on axis 1; other arguments pass as they are."""
    heads = next(a.shape[2] for a in args
                 if torch.is_tensor(a) and a.dim() == 4)

    def part(a, h0):
        if not torch.is_tensor(a):
            return a
        return a[:, :, h0:h0 + group] if a.dim() == 4 else a[:, h0:h0 + group]

    outs = [fn(*(part(a, h0) for a in args))
            for h0 in range(0, heads, group)]

    def join(ts):
        return torch.cat(ts, dim=2 if ts[0].dim() == 4 else 1)

    if isinstance(outs[0], tuple):
        return tuple(join(list(t)) for t in zip(*outs))
    return join(outs)


def timed_bucket(bucket: str) -> bool:
    """The kernel phase times the training phases' buckets; it holds the
    stage-I phase's larger ones untimed."""
    return bucket.startswith("train")


def check_k1_train(gen: torch.Generator):
    """K1 (f32, with the row log-sum-exp) and K1-bwd at the training
    shapes: (forward rows, backward rows). The plain versions run
    ``plain_by_heads``."""
    from onedc_tpu_torch.ops import flash_attention as k1

    fwd_rows, bwd_rows = [], []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for bucket, shapes in K1_TRAIN_SHAPES.items():
        for shape, count in shapes:
            b, n, h, d = shape
            q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                             for _ in range(4))
            scale = d ** -0.5
            tag = f"{bucket} {shape}"
            out, lse = k1.flash_attention_cuda(q, k, v, scale, with_lse=True)
            out_plain = plain_by_heads(k1.attention_plain, q, k, v, scale)
            errs = compare(f"K1 f32 {tag}", out, out_plain,
                           plain_by_heads(k1.attention_plain, q, k[:, 64:],
                                          v[:, 64:], scale))
            lse_plain = plain_by_heads(k1.attention_lse_plain, q, k, scale)
            lse_rms, lse_max = lse_errs(lse, lse_plain)
            m_rms, m_max = lse_errs(
                plain_by_heads(k1.attention_lse_plain, q, k[:, 64:], scale),
                lse_plain)
            print(f"K1 f32 {tag}: lse - plain: root mean square "
                  f"{lse_rms:.3e} (tol {LSE_RMS_TOL}), max {lse_max:.3e} (tol "
                  f"{LSE_MAX_TOL}); one block step left out: {m_rms:.3e}, "
                  f"{m_max:.3e}", flush=True)
            if not (lse_rms <= LSE_RMS_TOL and lse_max <= LSE_MAX_TOL):
                raise AssertionError(f"K1 {tag}: lse disagrees")
            if m_rms <= LSE_RMS_TOL and m_max <= LSE_MAX_TOL:
                raise AssertionError(f"K1 {tag}: the lse limits cannot tell a "
                                     f"kernel that skips one block step")
            errs.update(lse_rms_err=lse_rms, lse_max_err=lse_max)
            bnd, by = attention_bound(b, n, h, d, 4, lse=True)
            fwd_rows.append(dict(bucket=bucket, shape=list(shape),
                                 count=count, **errs, bound_ms=bnd,
                                 bound_by=by))
            if timed_bucket(bucket):
                ms = cuda_ms(lambda: k1.flash_attention_cuda(q, k, v, scale,
                                                             with_lse=True))
                plain = cuda_ms(lambda: k1.attention_plain(q, k, v, scale),
                                iters=3)
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                lib = cuda_ms(lambda: sdpa(qt, kt, vt, scale=scale))
                # SDPA in bf16 on the bf16-rounded operands: the arithmetic
                # the kernel does (bf16 products, f32 sums)
                qt, kt, vt = (t.to(torch.bfloat16) for t in (qt, kt, vt))
                lib_bf16 = cuda_ms(lambda: sdpa(qt, kt, vt, scale=scale))
                del qt, kt, vt
                fwd_rows[-1].update(ms=ms, plain_ms=plain, library_ms=lib,
                                    library_bf16_ms=lib_bf16)
                print(f"K1 f32 {tag} x{count}: kernel {ms:.4f} ms plain "
                      f"{plain:.4f} sdpa {lib:.4f} sdpa-bf16 {lib_bf16:.4f} "
                      f"bound {bnd:.4f} ({by})", flush=True)

            # the kernel takes the forward kernel's out and lse (di from
            # them as autograd passes it, ``bwd_di``); the plain backward
            # the plain ones, so a wrong lse shows here too
            di = k1.bwd_di(out, dout)
            grads = k1.flash_attention_bwd_cuda(q, k, v, dout, lse, di, scale)
            bwd_plain = k1.attention_bwd_plain
            refs = plain_by_heads(bwd_plain, q, k, v, out_plain, dout,
                                  lse_plain, scale)
            skip_key = plain_by_heads(bwd_plain, q, k[:, 64:], v[:, 64:],
                                      out_plain, dout, lse_plain, scale)
            skip_query = plain_by_heads(
                bwd_plain, q[:, 64:], k, v, out_plain[:, 64:], dout[:, 64:],
                lse_plain[..., 64:], scale)
            mutants = (skip_key[0], skip_query[1], skip_query[2])
            all_errs = [compare(f"K1-bwd {name} {tag}", g, r, m)
                        for name, g, r, m in zip(("dQ", "dK", "dV"), grads,
                                                 refs, mutants)]
            del refs, skip_key, skip_query, mutants
            # no atomics, one summation order: a second launch on the same
            # inputs gives the same bits
            again = k1.flash_attention_bwd_cuda(q, k, v, dout, lse, di, scale)
            if not all(torch.equal(a, g) for a, g in zip(again, grads)):
                raise AssertionError(f"K1-bwd {tag}: two launches on the same "
                                     f"inputs differ")
            print(f"K1-bwd {tag}: a second launch gives bit-identical dQ, "
                  f"dK, dV", flush=True)
            del grads, again
            torch.cuda.empty_cache()
            bnd, by = attention_bound(b, n, h, d, 4, backward=True)
            bwd_rows.append(dict(
                bucket=bucket, shape=list(shape), count=count,
                max_abs_err=max(e["max_abs_err"] for e in all_errs),
                rel_l2_err=max(e["rel_l2_err"] for e in all_errs),
                rel_max_err=max(e["rel_max_err"] for e in all_errs),
                mutant_rel_l2=min(e["mutant_rel_l2"] for e in all_errs),
                bound_ms=bnd, bound_by=by))
            if timed_bucket(bucket):
                ms = cuda_ms(lambda: k1.flash_attention_bwd_cuda(
                    q, k, v, dout, lse, di, scale))
                plain = cuda_ms(lambda: k1.attention_bwd_plain(
                    q, k, v, out, dout, lse, scale), iters=2, warmup=1)
                lib = cuda_ms(sdpa_bwd_timer(q, k, v, dout, scale))
                lib_bf16 = cuda_ms(sdpa_bwd_timer(
                    *(t.to(torch.bfloat16) for t in (q, k, v, dout)), scale))
                bwd_rows[-1].update(ms=ms, plain_ms=plain, library_ms=lib,
                                    library_bf16_ms=lib_bf16)
                print(f"K1-bwd {tag} x{count}: kernel {ms:.4f} ms plain "
                      f"{plain:.4f} sdpa-bwd {lib:.4f} sdpa-bwd-bf16 "
                      f"{lib_bf16:.4f} bound {bnd:.4f} ({by})", flush=True)
            del q, k, v, dout, out, lse, di, out_plain, lse_plain
            torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def _conv_inputs(gen, b, hh, ww, cin, cout, dtype=torch.float32):
    x = torch.randn((b, hh, ww, cin), generator=gen, device="cuda").to(dtype)
    mul = 1 + 0.1 * torch.randn((b, cin), generator=gen, device="cuda")
    add = 0.1 * torch.randn((b, cin), generator=gen, device="cuda")
    w = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
         / (9 * cin) ** 0.5).to(dtype)
    bias = (0.1 * torch.randn((cout,), generator=gen, device="cuda")
            ).to(dtype)
    return x, mul, add, w, bias


def _conv_bound(b, hh, ww, cin, cout, itemsize, affine):
    nbytes = (b * hh * ww * (cin + cout) * itemsize + 9 * cin * cout * itemsize
              + (2 * b * cin * 4 + cout * itemsize if affine else 0))
    return bound_ms(2.0 * b * hh * ww * cin * cout * 9, nbytes)


def check_k2_k3_train(gen: torch.Generator):
    """K2 and K3 in f32 at the training shapes, and K2's autograd backward
    against autograd of its plain version: (K2 rows, K3 rows). Each kernel
    is timed through its wrapper, with the bf16 weight copy it makes per
    launch; beside it cuDNN twice: in f32 (TF32 off), the same function,
    and in bf16 on the bf16-rounded operands (channels_last), the arithmetic
    the kernels do."""
    from onedc_tpu_torch.ops import conv3x3 as k2

    conv = torch.nn.functional.conv2d
    bf16 = torch.bfloat16
    chunk = k2.CHANNEL_MULTIPLE
    k2_rows, k3_rows = [], []
    for bucket, shapes in K2_TRAIN_SHAPES.items():
        for shape, count in shapes:
            x, mul, add, w, bias = _conv_inputs(gen, *shape)
            tag = f"{bucket} {shape}"
            w_skip = w.clone()
            w_skip[:, :, :chunk] = 0  # one input chunk left out
            errs = compare(
                f"K2 f32 {tag}", k2.affine_silu_conv3x3_cuda(x, mul, add, w,
                                                             bias),
                k2.affine_silu_conv3x3_plain(x, mul, add, w, bias),
                k2.affine_silu_conv3x3_plain(x, mul, add, w_skip, bias))
            del w_skip
            bnd, by = _conv_bound(*shape, 4, True)
            k2_rows.append(dict(bucket=bucket, shape=list(shape), count=count,
                                **errs, bound_ms=bnd, bound_by=by))
            if not timed_bucket(bucket):
                del x, mul, add, w, bias
                continue
            t = torch.nn.functional.silu(
                x * mul[:, None, None, :] + add[:, None, None, :]
            ).permute(0, 3, 1, 2)  # channels_last NCHW
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            ms = cuda_ms(lambda: k2.affine_silu_conv3x3_cuda(x, mul, add, w,
                                                             bias))
            plain = cuda_ms(lambda: k2.affine_silu_conv3x3_plain(
                x, mul, add, w, bias), iters=3)
            lib = cuda_ms(lambda: conv(t, w_oihw, bias, padding=1))
            t, w_oihw, bias_b = t.to(bf16), w_oihw.to(bf16), bias.to(bf16)
            lib_bf16 = cuda_ms(lambda: conv(t, w_oihw, bias_b, padding=1))
            k2_rows[-1].update(ms=ms, plain_ms=plain, library_ms=lib,
                               library_bf16_ms=lib_bf16)
            print(f"K2 f32 {tag} x{count}: kernel {ms:.4f} ms plain "
                  f"{plain:.4f} cudnn {lib:.4f} cudnn-bf16 {lib_bf16:.4f} "
                  f"bound {bnd:.4f} ({by})", flush=True)
            del x, mul, add, w, bias, t, w_oihw, bias_b
    for bucket, shapes in K3_TRAIN_SHAPES.items():
        for shape, count in shapes:
            # K3's (B, H, W, Cin -> Cout): the input gradient g (B, H, W,
            # Cin) of a forward conv Cout -> Cin with weights w
            b, hh, ww, cin, cout = shape
            g = torch.randn((b, hh, ww, cin), generator=gen, device="cuda")
            w = (torch.randn((3, 3, cout, cin), generator=gen, device="cuda")
                 / (9 * cin) ** 0.5)
            tag = f"{bucket} {shape}"
            w_skip = w.clone()
            w_skip[..., :chunk] = 0  # one chunk of g's channels left out
            errs = compare(f"K3 f32 {tag}", k2.conv3x3_dx_cuda(g, w),
                           k2.conv3x3_dx_plain(g, w),
                           k2.conv3x3_dx_plain(g, w_skip))
            del w_skip
            bnd, by = _conv_bound(*shape, 4, False)
            k3_rows.append(dict(bucket=bucket, shape=list(shape), count=count,
                                **errs, bound_ms=bnd, bound_by=by))
            if not timed_bucket(bucket):
                del g, w
                continue
            g_cl = g.permute(0, 3, 1, 2)
            w_oihw = k2.flip_weights(w).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            ms = cuda_ms(lambda: k2.conv3x3_dx_cuda(g, w))
            plain = cuda_ms(lambda: k2.conv3x3_dx_plain(g, w), iters=3)
            lib = cuda_ms(lambda: conv(g_cl, w_oihw, padding=1))
            g_cl, w_oihw = g_cl.to(bf16), w_oihw.to(bf16)
            lib_bf16 = cuda_ms(lambda: conv(g_cl, w_oihw, padding=1))
            k3_rows[-1].update(ms=ms, plain_ms=plain, library_ms=lib,
                               library_bf16_ms=lib_bf16)
            print(f"K3 f32 {tag} x{count}: kernel {ms:.4f} ms plain "
                  f"{plain:.4f} cudnn {lib:.4f} cudnn-bf16 {lib_bf16:.4f} "
                  f"bound {bnd:.4f} ({by})", flush=True)
            del g, w, g_cl, w_oihw
    names = ("dx", "dmul", "dadd", "dw", "dbias")
    for shape in K2_BWD_SHAPES:
        inputs = [t.requires_grad_() for t in _conv_inputs(gen, *shape)]
        g = torch.randn(shape[:3] + shape[4:], generator=gen, device="cuda")
        got = torch.autograd.grad(k2.affine_silu_conv3x3(*inputs), inputs, g)
        want = torch.autograd.grad(k2.affine_silu_conv3x3_plain(*inputs),
                                   inputs, g)
        for name, a, r in zip(names, got, want):
            diff = (a - r).float()
            rel_l2 = (diff.norm() / r.norm()).item()
            rel_max = (diff.abs().max() / r.abs().max()).item()
            print(f"K2 autograd {name} {shape}: relative L2 {rel_l2:.3e}, "
                  f"max err {rel_max:.3e} of max|ref|", flush=True)
            if not (rel_l2 <= REL_L2_TOL and rel_max <= MAX_TOL):
                raise AssertionError(f"K2 backward {name} {shape} disagrees "
                                     f"with autograd of the plain version")
        del inputs, g, got, want
    torch.cuda.empty_cache()
    return k2_rows, k3_rows


def check_ragged(gen: torch.Generator):
    """The card-only cases of ``test_kernels_on_card`` (RAGGED_K1,
    RAGGED_K2), each with its one-block-left-out check, K1-bwd in bf16
    (K1_BWD_BF16), which no path of the port runs yet, and K1 at D = 512
    (RAGGED_K1_WIDE). Returns the number of checks."""
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    checks = 0
    for shape in RAGGED_K1 + RAGGED_K1_WIDE:
        b, n, h, d = shape
        scale = d ** -0.5
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"{shape} {str(dtype)[6:]}"
            q, k, v = (rnd(*shape).to(dtype) for _ in range(3))
            if d > k1.MAX_HEAD_DIM and dtype == torch.float32:
                try:
                    k1.flash_attention_cuda(q, k, v, scale)
                except ValueError:
                    print(f"ragged K1 {tag}: refused, as it should be",
                          flush=True)
                    continue
                raise AssertionError(f"K1 took {tag}")
            out, lse = k1.flash_attention_cuda(q, k, v, scale, with_lse=True)
            out_plain = k1.attention_plain(q, k, v, scale)
            compare(f"ragged K1 {tag}", out, out_plain,
                    k1.attention_plain(q, k[:, 64:], v[:, 64:], scale))
            lse_plain = k1.attention_lse_plain(q, k, scale)
            lse_max = (lse - lse_plain).abs().max().item()
            print(f"ragged K1 {tag}: lse max err {lse_max:.3e} (tol "
                  f"{LSE_MAX_TOL})", flush=True)
            if lse_max > LSE_MAX_TOL:
                raise AssertionError(f"ragged K1 {tag}: lse disagrees")
            checks += 2
            bf16_bwd = dtype == torch.bfloat16 and shape in K1_BWD_BF16
            if d > k1.MAX_HEAD_DIM_BWD or not (dtype == torch.float32
                                               or bf16_bwd):
                continue
            dout = rnd(*shape).to(dtype)
            di = k1.bwd_di(out, dout)
            grads = k1.flash_attention_bwd_cuda(q, k, v, dout, lse, di, scale)
            refs = k1.attention_bwd_plain(q, k, v, out_plain, dout,
                                          lse_plain, scale)
            skip_key = k1.attention_bwd_plain(q, k[:, 64:], v[:, 64:],
                                              out_plain, dout, lse_plain,
                                              scale)
            skip_query = k1.attention_bwd_plain(
                q[:, 64:], k, v, out_plain[:, 64:], dout[:, 64:],
                lse_plain[..., 64:], scale)
            for name, g, r, m in zip(("dQ", "dK", "dV"), grads, refs,
                                     (skip_key[0], skip_query[1],
                                      skip_query[2])):
                compare(f"ragged K1-bwd {name} {tag}", g, r, m)
            again = k1.flash_attention_bwd_cuda(q, k, v, dout, lse, di, scale)
            if not all(torch.equal(a, g) for a, g in zip(again, grads)):
                raise AssertionError(f"K1-bwd {tag}: two launches on the same "
                                     f"inputs differ")
            print(f"ragged K1-bwd {tag}: a second launch gives bit-identical "
                  f"dQ, dK, dV", flush=True)
            checks += 4
    chunk = k2.CHANNEL_MULTIPLE
    for shape in RAGGED_K2:
        b, hh, ww, cin, cout = shape
        for dtype in (torch.bfloat16, torch.float32):
            x, mul, add, w, bias = _conv_inputs(gen, *shape, dtype=dtype)
            w_skip = w.clone()
            w_skip[:, :, :chunk] = 0
            compare(f"ragged K2 {shape} {str(dtype)[6:]}",
                    k2.affine_silu_conv3x3(x, mul, add, w, bias),
                    k2.affine_silu_conv3x3_plain(x, mul, add, w, bias),
                    k2.affine_silu_conv3x3_plain(x, mul, add, w_skip, bias))
            checks += 1
        # K3: the input gradient (b, hh, ww, cin -> cout) of a conv cout ->
        # cin
        g, w = rnd(b, hh, ww, cin), rnd(3, 3, cout, cin) / (9 * cin) ** 0.5
        w_skip = w.clone()
        w_skip[..., :chunk] = 0
        compare(f"ragged K3 {shape}", k2.conv3x3_dx_cuda(g, w),
                k2.conv3x3_dx_plain(g, w), k2.conv3x3_dx_plain(g, w_skip))
        checks += 1
    torch.cuda.empty_cache()
    return checks


def summarize(name, source, replaces, rows, launches, main_bucket):
    """One kernel's line entry: ``ms`` etc. are the times of one call of
    ``main_bucket`` (a 768x768 decode, or a 512x512 training step of batch
    2): the sum over its shapes of count x per-launch time. ``launches``
    counts the launches of every main-path run (``launches_by_path``)."""

    def total(key, bucket):
        return sum(r["count"] * r[key] for r in rows if r["bucket"] == bucket)

    buckets = sorted({r["bucket"] for r in rows})
    main = [r for r in rows if r["bucket"] == main_bucket]
    share = {}  # the main bucket's bound ms by what binds each shape
    for r in main:
        share[r["bound_by"]] = share.get(r["bound_by"], 0.0) \
            + r["count"] * r["bound_ms"]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "rel_l2_err": max(r["rel_l2_err"] for r in rows),
        "tolerance": {"rel_l2": REL_L2_TOL, "max_of_max_ref": MAX_TOL},
        "ms": total("ms", main_bucket),
        "plain_ms": total("plain_ms", main_bucket),
        "bound_ms": total("bound_ms", main_bucket),
        "bound_by": max(share, key=share.get),
        "library_ms": total("library_ms", main_bucket),
        "ms_of": main_bucket,
        "per_call": {bk: {**{key: total(key, bk) for key in
                             ("ms", "plain_ms", "bound_ms", "library_ms",
                              "library_bf16_ms")
                             if all(key in r for r in rows
                                    if r["bucket"] == bk)},
                          "count": sum(r["count"] for r in rows
                                       if r["bucket"] == bk)}
                     for bk in buckets},
        "per_launch": rows,
    }


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def check_batch(rt, written, singles, counts):
    """decode_batch of all streams against the single decodes; then, per
    768x768 stream, a batch of that stream twice: its row must equal the
    row the stream got beside the other stream, bit for bit."""
    streams = [s for s, _, _ in written]
    batch, got = counted(counts, lambda: rt.decode_batch(streams))
    # the 768x768 pair: one pipelined chunk; the 512x768 stream: a decode
    want = batch_launches([(768, 768), (768, 768), (512, 768)])
    if got != want:
        raise AssertionError(f"decode_batch launched K1/K2 {got}, "
                             f"expected {want}")
    for i, (a, b) in enumerate(zip(batch, singles)):
        if a.shape != b.shape:
            raise AssertionError(f"decode_batch[{i}] shape {tuple(a.shape)}")
        diff = (a - b).abs()
        rel_l2 = (diff.norm() / b.norm()).item()
        rel_max = (diff.max() / b.abs().max()).item()
        print(f"decode_batch[{i}] vs decode: relative L2 {rel_l2:.3e} (tol "
              f"{BATCH_REL_L2_TOL}), max diff {rel_max:.3e} of max |image| "
              f"(tol {BATCH_MAX_TOL})", flush=True)
        if not (rel_l2 <= BATCH_REL_L2_TOL and rel_max <= BATCH_MAX_TOL):
            raise AssertionError(f"decode_batch[{i}] differs from decode")
    # the 512x768 stream is a bucket of its own: the same program as decode
    if not torch.equal(batch[2], singles[2]):
        raise AssertionError("a one-stream bucket differs from decode")
    for row in (0, 1):
        twice, got = counted(counts,
                             lambda: rt.decode_batch([streams[row]] * 2))
        if got != batch_launches([(768, 768)] * 2):
            raise AssertionError(f"decode_batch launched K1/K2 {got}")
        if not torch.equal(twice[row], batch[row]):
            raise AssertionError(f"decode_batch row {row} depends on the "
                                 f"other stream of its bucket")
        same = torch.equal(twice[0], twice[1])
        print(f"stream {row} twice in one batch: row {row} equals its row "
              f"beside stream {1 - row}; the two rows bit-identical to each "
              f"other: {same}", flush=True)


def main_path(rt, seed: int):
    """The decode phase on the bf16 runtime ``rt``; returns the K1 and K2
    launches of its decodes."""
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1

    sizes = [(768, 768), (768, 768), (512, 768)]
    written = [write_synthetic_stream(rt, h, w, seed + i)
               for i, (h, w) in enumerate(sizes)]
    for (h, w), (s, _, _) in zip(sizes, written):
        print(f"stream {h}x{w}: {len(s)} bytes, "
              f"{len(s) * 8 / (h * w):.4f} bpp", flush=True)

    k1.launches = 0
    k2.launches = 0
    singles = []
    for (h, w), (stream, y_hat_w, steps_w) in zip(sizes, written):
        bucket = f"{h}x{w}"
        before = (k1.launches, k2.launches)
        trace = {}
        img = rt.decode(stream, trace)
        torch.cuda.synchronize()
        got = (k1.launches - before[0], k2.launches - before[1])
        want = (K1_PER_CALL[bucket], K2_PER_CALL[bucket])
        if got != want:
            raise AssertionError(f"{bucket} decode launched K1/K2 {got}, "
                                 f"expected {want}")
        for i, ((iw, sw), (ir, sr)) in enumerate(zip(steps_w,
                                                     trace["steps"])):
            if not (np.array_equal(iw, ir) and np.array_equal(sw, sr)):
                raise AssertionError(f"{bucket}: step {i} indexes/symbols "
                                     f"differ from the writer's")
        if not torch.equal(trace["y_hat"], y_hat_w):
            raise AssertionError(f"{bucket}: y_hat differs from the writer's")
        if img.shape != (1, h, w, 3) or not torch.isfinite(img).all():
            raise AssertionError(f"{bucket}: bad image {tuple(img.shape)}")
        singles.append(img)
        print(f"decode {bucket}: symbols and y_hat equal the writer's; "
              f"K1/K2 launches {got}; image range "
              f"[{img.min().item():.3f}, {img.max().item():.3f}]",
              flush=True)

    check_batch(rt, written, singles, (k1, k2))
    launches = {"K1": k1.launches, "K2": k2.launches}

    # timing, after the counted run; a traced decode waits for the device
    # at each stage's end and records each stage's host ms
    wall = {}
    for bucket, i in (("768x768", 0), ("512x768", 2)):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            rt.decode(written[i][0])
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        wall[bucket] = ts
    stages = {}
    for _ in range(3):
        trace = {}
        rt.decode(written[0][0], trace)
        for stage, ms in trace["stage_ms"].items():
            stages.setdefault(stage, []).append(ms)
    t0 = time.perf_counter()
    rt.decode_batch([s for s, _, _ in written[:2]])
    torch.cuda.synchronize()
    batch2_ms = (time.perf_counter() - t0) * 1e3
    print("decode wall ms " + json.dumps(wall), flush=True)
    print("traced stage ms (768x768, 3 decodes) " + json.dumps(stages),
          flush=True)
    print(f"decode_batch of two 768x768 streams: {batch2_ms:.1f} ms",
          flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)
    return launches


def encode_images(seed: int):
    """ENCODE_SIZES images from ``synthetic_batches``: (1, h, w, 3) f32
    crops of seeded 768x768 images."""
    batch = next(synthetic_batches(seed, len(ENCODE_SIZES), 768))["image"]
    return [np.ascontiguousarray(im[None, :h, :w])
            for im, (h, w) in zip(batch, ENCODE_SIZES)]


def padded_size(h: int, w: int, ds: int = 64):
    return (-(-h // ds) * ds, -(-w // ds) * ds)


def counted(counts, fn):
    """(fn(), (K1, K2) launches it made), after a device synchronise."""
    before = tuple(c.launches for c in counts)
    out = fn()
    torch.cuda.synchronize()
    return out, tuple(c.launches - b for c, b in zip(counts, before))


def check_stream_decodes_to_plan(rt, stream, plan, row: int, what: str):
    """``rt.decode(stream)`` reads, at every step, the indexes and symbols of
    row ``row`` of the write plan ``plan`` and rebuilds its y_hat, bit for
    bit. Returns the decoded image."""
    trace = {}
    img = rt.decode(stream, trace)
    for s, (idx, sym) in enumerate(trace["steps"]):
        want_idx = plan["indexes_w"][s][row:row + 1].cpu().numpy()
        want_sym = plan["y_q_w"][s][row:row + 1].cpu().numpy()
        if not (np.array_equal(idx, want_idx)
                and np.array_equal(sym, want_sym)):
            raise AssertionError(
                f"{what}: step {s}: {int((idx != want_idx).sum())} indexes "
                f"and {int((sym != want_sym).sum())} symbols differ from the "
                f"writer's plan")
    if not torch.equal(trace["y_hat"], plan["y_hat"][row:row + 1]):
        raise AssertionError(f"{what}: y_hat differs from the writer's plan")
    return img


def check_symbols_fit(plan, what: str) -> int:
    """Every symbol of the plan lies inside the coder's clamp (so neither
    the clamp nor int16 changed one); returns the largest magnitude."""
    from onedc_tpu_torch.models.codec import SYMBOL_LIMIT

    top = max(int(a.abs().max().item()) for a in plan["y_q_w"])
    if top >= SYMBOL_LIMIT:
        raise AssertionError(f"{what}: a symbol of magnitude {top} reached "
                             f"the coder's clamp")
    return top


def encode_path(rt, seed: int):
    """The encode phase on the decode phase's bf16 runtime: ``encode`` of
    each ENCODE_SIZES image, ``encode_batch`` of the 768x768 pair and
    ``encode_many`` of all four; every stream decodes to its writer's plan
    bit for bit. Returns the K1 and K2 launches of the phase's encodes."""
    from onedc_tpu_torch.models.runtime import WRITE_KEYS, host_arrays
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1

    counts = (k1, k2)
    images = encode_images(seed)
    k1.launches = 0
    k2.launches = 0
    singles = []
    for (h, w), im in zip(ENCODE_SIZES, images):
        (stream, bpp), got = counted(counts, lambda: rt.encode(im))
        want = ENCODE_PER_CALL[padded_size(h, w)]
        if got != want:
            raise AssertionError(f"{h}x{w} encode launched K1/K2 {got}, "
                                 f"expected {want}")
        singles.append(stream)
        print(f"encode {h}x{w}: {len(stream)} bytes, {bpp['bpp']:.4f} bpp "
              f"(y {bpp['bpp_y']:.4f}, z {bpp['bpp_z']:.5f}); K1/K2 launches "
              f"{got}", flush=True)
    pair = np.concatenate(images[:2])
    # a batch launches each kernel once per layer, as one image does
    batch, got = counted(counts, lambda: rt.encode_batch(pair))
    if got != ENCODE_PER_CALL[(768, 768)]:
        raise AssertionError(f"encode_batch launched K1/K2 {got}")
    # encode_many: one chunk per size
    many, got = counted(counts, lambda: rt.encode_many(images))
    want = tuple(map(sum, zip(*(ENCODE_PER_CALL[padded_size(h, w)]
                                for h, w in set(ENCODE_SIZES)))))
    if got != want:
        raise AssertionError(f"encode_many launched K1/K2 {got}, expected "
                             f"{want}")
    launches = {"K1": k1.launches, "K2": k2.launches}

    # every stream against its writer's plan: the single encodes' and
    # encode_many's one-image chunks against the plan of the image alone,
    # encode_batch's and encode_many's 768x768 chunk against the pair's
    pair_plan = rt.write_plan(pair)
    top = check_symbols_fit(pair_plan, "pair")
    for i, ((h, w), im) in enumerate(zip(ENCODE_SIZES, images)):
        plan = rt.write_plan(im)
        top = max(top, check_symbols_fit(plan, f"{h}x{w}"))
        img, got = counted(counts, lambda: check_stream_decodes_to_plan(
            rt, singles[i], plan, 0, f"encode {h}x{w}"))
        bucket = "{}x{}".format(*padded_size(h, w))
        if got != (K1_PER_CALL[bucket], K2_PER_CALL[bucket]):
            raise AssertionError(f"{h}x{w} decode launched K1/K2 {got}")
        if img.shape != (1, h, w, 3) or not torch.isfinite(img).all():
            raise AssertionError(f"encode {h}x{w}: bad image "
                                 f"{tuple(img.shape)}")
        if i < 2:
            for name, streams in (("encode_batch", batch), ("encode_many",
                                                            many)):
                check_stream_decodes_to_plan(rt, streams[i][0], pair_plan, i,
                                             f"{name}[{i}]")
        else:
            check_stream_decodes_to_plan(rt, many[i][0], plan, 0,
                                         f"encode_many[{i}]")
    print(f"every stream of encode, encode_batch and encode_many decodes to "
          f"its writer's indexes, symbols and y_hat; largest |symbol| {top}",
          flush=True)
    same = [b[0] == s for b, s in zip(batch, singles)]
    print(f"encode_batch bytes equal the single encodes': {same}; "
          f"encode_many: {[m[0] == s for m, s in zip(many, singles)]}",
          flush=True)

    # timing, after the counted run
    wall = {}
    for i in (0, 2, 3):
        h, w = ENCODE_SIZES[i]
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            rt.encode(images[i])
            ts.append((time.perf_counter() - t0) * 1e3)
        wall[f"{h}x{w}"] = ts
    split = {"device": [], "host_write": []}
    crt = rt._codec_rt
    for _ in range(3):
        t0 = time.perf_counter()
        plan = rt.write_plan(images[0])
        host = {k: host_arrays(plan[k]) for k in WRITE_KEYS}
        t1 = time.perf_counter()
        crt.write_streams(host, 768, 768)
        t2 = time.perf_counter()
        split["device"].append((t1 - t0) * 1e3)
        split["host_write"].append((t2 - t1) * 1e3)
    t0 = time.perf_counter()
    rt.encode_many(images)
    many_ms = (time.perf_counter() - t0) * 1e3
    print("encode wall ms " + json.dumps(wall), flush=True)
    print("768x768 encode split ms (device half to host arrays, host rANS "
          "write) " + json.dumps(split), flush=True)
    print(f"encode_many of the four images: {many_ms:.1f} ms", flush=True)
    return launches


def z_only_path(rt, seed: int):
    """The z-only phase: ``OneDC(z_only=True)`` with the lambda runtime's
    state dict, in bf16. Encodes the 768x768 and 512x768 images (no y
    stream), decodes each (launches as the lambda decode's: the same UNet
    and VAE) and both with ``decode_batch``. Returns the K1 and K2
    launches of its decodes."""
    from onedc_tpu_torch.models.onedc import OneDC, OneDCRuntime
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1

    with torch.device("cuda"):
        model = OneDC(z_only=True)
    zrt = OneDCRuntime(model, state=rt.model.state_dict(),
                       dtype=torch.bfloat16)
    images = encode_images(seed)
    streams = []
    for i in (0, 2):
        stream, bpp = zrt.encode(images[i])
        h, w = ENCODE_SIZES[i]
        if bpp["bits_y"] != 0:
            raise AssertionError(f"z-only {h}x{w}: bits_y {bpp['bits_y']}")
        streams.append(stream)
        print(f"z-only encode {h}x{w}: {len(stream)} bytes, "
              f"{bpp['bpp']:.5f} bpp", flush=True)
    counts = (k1, k2)
    k1.launches = 0
    k2.launches = 0
    singles = []
    for i, stream in zip((0, 2), streams):
        h, w = ENCODE_SIZES[i]
        img, got = counted(counts, lambda: zrt.decode(stream))
        want = (K1_PER_CALL[f"{h}x{w}"], K2_PER_CALL[f"{h}x{w}"])
        if got != want:
            raise AssertionError(f"z-only {h}x{w} decode launched K1/K2 "
                                 f"{got}, expected {want}")
        if img.shape != (1, h, w, 3) or not torch.isfinite(img).all():
            raise AssertionError(f"z-only {h}x{w}: bad image "
                                 f"{tuple(img.shape)}")
        singles.append(img)
        print(f"z-only decode {h}x{w}: K1/K2 launches {got}; image range "
              f"[{img.min().item():.3f}, {img.max().item():.3f}]", flush=True)
    batch = zrt.decode_batch(streams)
    # two sizes: two one-stream buckets, the programs of decode
    if not all(torch.equal(a, b) for a, b in zip(batch, singles)):
        raise AssertionError("z-only decode_batch differs from decode or "
                             "lost the input order")
    launches = {"K1": k1.launches, "K2": k2.launches}
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        zrt.decode(streams[0])
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    print(f"z-only decode_batch returns each image in input order; z-only "
          f"768x768 decode wall ms {json.dumps(ts)}", flush=True)
    return launches


def serve_images(seed: int):
    """SERVE_SIZES images from ``synthetic_batches``: (1, h, w, 3) f32."""
    batch = next(synthetic_batches(seed + 3, len(SERVE_SIZES), 768))["image"]
    return [np.ascontiguousarray(im[None, :h, :w])
            for im, (h, w) in zip(batch, SERVE_SIZES)]


def calibrate(rt, probe, base):
    """``pick_stream_scale`` on the 768x768 ``probe``: each candidate scale
    of ``calibrate_stream_params`` swapped into ``rt`` from the weights
    ``base``, until the probe's y stream lands in 0.02-0.15 bpp (or the
    lowest). Leaves ``rt`` calibrated; returns (scale, bpp_y)."""
    from onedc_tpu_torch.utils.calibrate import (
        calibrate_stream_params,
        pick_stream_scale,
    )

    def bpp_y(scale):
        rt.set_params(calibrate_stream_params(base, scale))
        return rt.encode(probe)[1]["bpp_y"]

    scale, bpp = pick_stream_scale(bpp_y)
    rt.set_params(calibrate_stream_params(base, scale))
    return scale, bpp


def recording(programs, y_hats, dtypes):
    """``programs`` recording the y_hat each x0 program gets and the dtype
    of the symbols each update gets."""
    def update(step):
        def f(yq, means, y_hat, common):
            dtypes.append(yq.dtype)
            return programs.update[step](yq, means, y_hat, common)
        return f

    def x0(y_hat, z_semantic):
        y_hats.append(y_hat)
        return programs.x0(y_hat, z_semantic)
    return programs._replace(x0=x0, update=[update(s) for s in range(4)])


def match_rows(y_hats, plans, what: str):
    """Every row of the recorded chunks ``y_hats`` (chunks finish in any
    order) is the y_hat of a writer's plan in ``plans`` bit for bit, and
    every plan is met once; padding rows (a bundle's ragged chunk) match
    none and are counted."""
    left = dict(enumerate(plans))
    pad = 0
    for chunk in y_hats:
        for r in range(chunk.shape[0]):
            row = chunk[r:r + 1].to(next(iter(plans)).device)
            hit = next((i for i, p in left.items() if p.shape == row.shape
                        and torch.equal(p, row)), None)
            if hit is None:
                pad += 1
            else:
                del left[hit]
    if left:
        raise AssertionError(f"{what}: {len(left)} streams' y_hat differ "
                             f"from their writer's plan, e.g. stream "
                             f"{min(left)}")
    return pad


def check_images(got, want, what: str):
    """Images of a batched decode against single decodes, within the
    BATCH_* limits; returns how many are bit-identical."""
    same = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{what}[{i}]: bad image {tuple(a.shape)}")
        diff = (a.float() - b.float()).abs()
        rel_l2 = (diff.norm() / b.float().norm()).item()
        rel_max = (diff.max() / b.float().abs().max()).item()
        if not (rel_l2 <= BATCH_REL_L2_TOL and rel_max <= BATCH_MAX_TOL):
            raise AssertionError(f"{what}[{i}] differs: relative L2 "
                                 f"{rel_l2:.3e}, max {rel_max:.3e}")
        same += bool(torch.equal(a.float(), b.float()))
    return same


def rates(fn, n: int, passes: int = 2):
    """Items per second of ``fn()`` (n items, to a synchronised device),
    one value per pass."""
    return [n / (_wall_ms(fn) / 1e3) for _ in range(passes)]


def serve_path(rt, seed: int, card: str, exports):
    """The serving phase on the decode phase's bf16 runtime: stream-rate
    calibration, the pipelined ``decode_batch`` of the Kodak-sized set
    plus SERVE_SQUARE 768x768 images (rows against the writers' plans,
    images against single decodes, launches, int8 symbols, decodes/s at
    the defaults, at depth 1 and per stream, ``serve_pipelined``), and a
    BUNDLE_BUCKET serving bundle (``exports``, ``export_processes``)
    decoded and encoded with in a fresh process (``serve_bundle``), which
    loads the bundle while the pipelined checks run. Returns the K1 and
    K2 launches of the pipelined decode ("serve") and of the bundle
    process ("bundle"), and the 768x768 streams with their writers' y_hat
    and their pipelined images (for ``w8a8_path``, with the bundle's prior
    programs)."""
    from onedc_tpu_torch.utils import aot

    images = serve_images(seed)
    base = {k: v.clone() for k, v in rt.model.state_dict().items()}
    t0 = time.perf_counter()
    scale, bpp = calibrate(rt, images[-1], base)
    del base
    print(f"serve: calibration scale {scale} (pick_stream_scale, 768x768 "
          f"probe): y stream {bpp:.4f} bpp, in 0.02-0.15: "
          f"{0.02 <= bpp <= 0.15}; {time.perf_counter() - t0:.1f} s",
          flush=True)

    encoded = rt.encode_many(images)
    streams = [s for s, _ in encoded]
    bpps = [b["bpp"] for _, b in encoded]
    plans = [None] * len(images)
    for size in bucket_counts(SERVE_SIZES):
        sel = [i for i, (h, w) in enumerate(SERVE_SIZES)
               if padded_size(h, w) == size]
        for c0 in range(0, len(sel), SERVING_CHUNK):
            chunk = sel[c0:c0 + SERVING_CHUNK]
            y_hat = rt.write_plan(np.concatenate(
                [images[i] for i in chunk]))["y_hat"]
            for j, i in enumerate(chunk):
                plans[i] = y_hat[j:j + 1]
    print(f"serve: {len(images)} streams ({SERVING_SIZES.count((512, 768))}"
          f" at 512x768, {SERVING_SIZES.count((768, 512))} at 768x512, "
          f"{SERVE_SQUARE} at 768x768), {min(bpps):.4f}-{max(bpps):.4f} bpp",
          flush=True)

    # the serving bundle (``exports``: BUNDLE_EXPORTS' processes); a fresh
    # process loads it while this one runs the pipelined decode's checks
    # and rates, then serves it
    h, w, b = BUNDLE_BUCKET
    sel = [i for i, size in enumerate(SERVE_SIZES) if size == (h, w)]
    tmp = Path(tempfile.mkdtemp(prefix="onedc_bundle_"))
    try:
        arts = exported(exports, ("bf16", "bf16_encode"))
        aot.save_bundle(arts, tmp)
        aot.save_weights(rt, tmp / "weights.safetensors")
        art_bytes = sum(len(v) for k, v in arts.items() if k != "meta")
        weight_bytes = (tmp / "weights.safetensors").stat().st_size
        seconds = arts["meta"]["export_seconds"]
        print(f"bundle {h}x{w}x{b}: exported in {sum(seconds.values()):.1f} "
              f"s on {card} by two processes beside the spatial and serving "
              f"phases (per program {json.dumps(seconds)}); "
              f"{len(arts) - 1} artifacts, {art_bytes} bytes, against "
              f"{weight_bytes} bytes of weights", flush=True)
        prior = {k: arts[k] for k in BUNDLE_PRIOR}
        del arts
        (tmp / "streams").mkdir()
        for j, i in enumerate(sel):
            (tmp / "streams" / f"{j:02d}.bin").write_bytes(streams[i])
        np.save(tmp / "encode.npy",
                np.concatenate([images[i] for i in sel[:BUNDLE_ENCODE]]))
        with bundle_process(tmp) as proc:
            launches, decoded = serve_pipelined(rt, streams, plans, card)
            torch.cuda.empty_cache()
            res = finish_bundle(proc, tmp, "bundle")
        if res["model_modules"]:
            raise AssertionError(f"the bundle process loaded model code: "
                                 f"{res['model_modules']}")
        want = pipelined_launches((h, w), len(sel), b, b)
        if res["decode_launches"] != want:
            raise AssertionError(f"ServingDecoder launched K1/K2 "
                                 f"{res['decode_launches']}, expected {want}")
        enc_want = tuple(-(-BUNDLE_ENCODE // b) * n
                         for n in ENCODE_PER_CALL[(h, w)])
        if res["encode_launches"] != enc_want:
            raise AssertionError(f"ServingEncoder launched K1/K2 "
                                 f"{res['encode_launches']}, expected "
                                 f"{enc_want}")
        pad = match_rows(res["y_hats"], [plans[i] for i in sel],
                         "ServingDecoder")
        if res["narrowed"] != res["updates"]:
            raise AssertionError(f"ServingDecoder: int8 symbols on "
                                 f"{res['narrowed']} of {res['updates']} "
                                 f"updates")
        same = check_images([im.to(rt.device) for im in res["images"]],
                            [decoded[i] for i in sel], "ServingDecoder")
        for j, (stream, plan) in enumerate(zip(res["containers"],
                                               res["plans"])):
            plan["y_hat"] = plan["y_hat"].to(rt.device)
            check_stream_decodes_to_plan(rt, stream, plan, 0,
                                         f"ServingEncoder[{j}]")
        bytes_same = [c == streams[i] for c, i in zip(res["containers"], sel)]
        square = rates(lambda: rt.decode_batch([streams[i] for i in sel]),
                       len(sel))
        print(f"bundle: the runtime's pipelined decode_batch of the same "
              f"{len(sel)} streams on {card}: decodes/s "
              f"{json.dumps(square)}", flush=True)
        print(f"bundle: ServingDecoder's rows are their writers' plans "
              f"({pad} padding rows), its images within the batch limits of "
              f"the runtime's pipelined decode ({same} of {len(sel)} "
              f"bit-identical); ServingEncoder's {len(res['containers'])} "
              f"streams decode to its plans; their bytes equal the runtime's "
              f"encode_many's: {bytes_same}", flush=True)
        bundle = {"K1": res["decode_launches"][0] + res["encode_launches"][0],
                  "K2": res["decode_launches"][1] + res["encode_launches"][1]}
    finally:
        shutil.rmtree(tmp)
    square = {"streams": [streams[i] for i in sel],
              "plans": [plans[i] for i in sel],
              "images": [decoded[i] for i in sel], "prior": prior}
    return launches, bundle, square


def serve_pipelined(rt, streams, plans, card: str):
    """The serving phase's pipelined ``decode_batch`` of the calibrated
    streams: the counted run (every row against its writer's plan, int8
    symbols on every update, launches as ``batch_launches``, images within
    the BATCH_* limits of single decodes), then decodes/s at the defaults,
    at depth 1 and per stream. Returns the launches and the images."""
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1

    counts = (k1, k2)
    # the counted run: every row against its writer's plan, the symbols'
    # dtype of every update, the launches of the tables
    y_hats, dtypes = [], []
    programs = rt.decode_programs
    rt.decode_programs = lambda: recording(programs(), y_hats, dtypes)
    torch.cuda.reset_peak_memory_stats()
    k1.launches = 0
    k2.launches = 0
    decoded, got = counted(counts, lambda: rt.decode_batch(streams))
    launches = {"K1": k1.launches, "K2": k2.launches}
    del rt.decode_programs
    want = batch_launches(SERVE_SIZES)
    if got != want:
        raise AssertionError(f"pipelined decode_batch launched K1/K2 {got}, "
                             f"expected {want}")
    match_rows(y_hats, plans, "pipelined decode_batch")
    narrowed = sum(d == torch.int8 for d in dtypes)
    if narrowed != len(dtypes):
        raise AssertionError(f"int8 symbols on {narrowed} of {len(dtypes)} "
                             f"updates of the calibrated streams")
    singles = [rt.decode(s) for s in streams]
    same = check_images(decoded, singles, "pipelined decode_batch")
    print(f"serve: pipelined decode_batch: every row's y_hat is its writer's "
          f"plan's; images within the batch limits of single decodes "
          f"({same} of {len(singles)} bit-identical); K1/K2 launches {got}; "
          f"int8 symbols on all {len(dtypes)} updates", flush=True)

    def decode_all():
        rt.decode_batch(streams)

    def decode_each():
        for s in streams:
            rt.decode(s)

    pipelined = rates(decode_all, len(streams))
    peak = torch.cuda.max_memory_allocated() / 2**30
    os.environ["ONEDC_PIPELINE_DEPTH"] = "1"
    try:
        depth1 = rates(decode_all, len(streams), passes=1)
    finally:
        del os.environ["ONEDC_PIPELINE_DEPTH"]
    each = rates(decode_each, len(streams), passes=1)
    print(f"serve decodes/s on {card} ({len(streams)} streams, after the "
          f"counted pass): pipelined (defaults) {json.dumps(pipelined)}, "
          f"depth 1 {json.dumps(depth1)}, per-stream decode "
          f"{json.dumps(each)}; peak device memory {peak:.2f} GiB",
          flush=True)
    return launches, decoded


def int8_products(ops_by_family: dict) -> int:
    """torch._int_mm calls of the quantized ops ``{family: count}``: one
    per conv and dense, four per upsample conv (its phases)."""
    return sum(ops_by_family.values()) + 3 * ops_by_family.get("upsample", 0)


def image_psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR of two [-1, 1] images (peak-to-peak 2)."""
    mse = ((a.double() - b.double()) ** 2).mean().item()
    return 10 * np.log10(4.0 / max(mse, 1e-20))


def w8a8_operands_checked(rtq, module, x):
    """``module`` on ``x`` in the w8a8 mode with every int8 product's
    operands kept: each card accumulator (``torch._int_mm``) must equal the
    exact integer product of the same int8 operands (``int8_matmul_plain``,
    a float64 product on the card). Returns (the output, the number of
    products)."""
    from onedc_tpu_torch.ops import w8a8

    seen = []
    real = w8a8.int8_matmul

    def keep(a, w):
        out = real(a, w)
        seen.append((a, w, out))
        return out
    w8a8.int8_matmul = keep
    try:
        y = rtq.quantized(module)(x)
    finally:
        w8a8.int8_matmul = real
    for a, w, out in seen:
        if not torch.equal(out, w8a8.int8_matmul_plain(a, w)):
            raise AssertionError(f"int32 accumulators of {tuple(a.shape)} x "
                                 f"{tuple(w.shape)} differ from the exact "
                                 f"integer product")
    return y, len(seen)


def op_input(shape, gen):
    """A bf16 input of a recorded op's shape on ``gen``'s device (a 4-D one
    channels_last, as the decode's activations are)."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.bfloat16)
    return x.contiguous(memory_format=torch.channels_last) if x.dim() == 4 \
        else x


def w8a8_op_costs(rtq, ops, seed: int, gate: int):
    """The cost of the w8a8 mode against bf16 on one decode's ops ``ops``
    (a gate-0 recording of a 768x768 decode: every op the mode may take),
    each op run quantized whatever its width, on a seeded input of its
    shape: per op its wall ms (CUDA events over back-to-back calls, the
    host's launches included as a decode pays them); per group of one
    family and one width (min of Cin, Cout) the device-busy ms and kernel
    launches of one pass (``torch.profiler``). Returns the rows, the
    groups, the families' sums at ``gate``, and the decode's op sums, wall
    and device, at each of W8A8_GATES (ops below the gate exact)."""
    from tools.profile_port_decode import profiled

    modules = dict(rtq.model.named_modules())
    gen = torch.Generator(device=rtq.device)
    gen.manual_seed(seed)
    rows, groups = [], {}
    saved = os.environ.get("ONEDC_Q8_MIN_CH")
    os.environ["ONEDC_Q8_MIN_CH"] = "0"
    try:
        with torch.no_grad():
            for o in ops:
                m, x = modules[o.path], op_input(o.shape, gen)
                rows.append({"path": o.path, "family": o.family,
                             "min_ch": min(o.cin, o.cout), "shape": o.shape,
                             "w8a8_ms": cuda_ms(
                                 lambda: rtq.quantized(m)(x), 3, 1),
                             "bf16_ms": cuda_ms(lambda: m(x), 3, 1)})
            for fam, ch in sorted({(r["family"], r["min_ch"]) for r in rows}):
                sel = [(modules[o.path], op_input(o.shape, gen)) for o in ops
                       if o.family == fam and min(o.cin, o.cout) == ch]
                q = profiled(rtq.quantized(lambda: [m(x) for m, x in sel]))
                e = profiled(lambda: [m(x) for m, x in sel])
                groups[f"{fam}@{ch}"] = {
                    "family": fam, "min_ch": ch, "ops": len(sel),
                    "w8a8_device_ms": q["device_busy_ms"],
                    "bf16_device_ms": e["device_busy_ms"],
                    "w8a8_launches": q["kernel_launches"],
                    "bf16_launches": e["kernel_launches"]}
                del sel
    finally:
        if saved is None:
            del os.environ["ONEDC_Q8_MIN_CH"]
        else:
            os.environ["ONEDC_Q8_MIN_CH"] = saved
    families = {}
    for fam in W8A8_OPS:
        mine = [g for g in groups.values()
                if g["family"] == fam and g["min_ch"] >= gate]
        walls = [r for r in rows if r["family"] == fam and r["min_ch"] >= gate]
        families[fam] = {
            "ops": len(walls),
            "w8a8_ms": sum(r["w8a8_ms"] for r in walls),
            "bf16_ms": sum(r["bf16_ms"] for r in walls),
            **{k: sum(g[k] for g in mine) for k in (
                "w8a8_device_ms", "bf16_device_ms", "w8a8_launches",
                "bf16_launches")}}
    gates = {str(g): {
        "wall_ms": sum(r["w8a8_ms"] if r["min_ch"] >= g else r["bf16_ms"]
                       for r in rows),
        "device_ms": sum(v["w8a8_device_ms"] if v["min_ch"] >= g
                         else v["bf16_device_ms"] for v in groups.values())}
        for g in W8A8_GATES}
    return rows, groups, families, gates


def w8a8_path(rt, square, seed: int, card: str, exports):
    """The w8a8 phase: ``OneDCRuntime(quant="w8a8")`` on the serving
    phase's calibrated bf16 model, at the default gate 512, against the
    exact runtime ``rt`` on the same SERVE_SQUARE 768x768 streams
    (``square``: the streams, their writers' y_hat, the exact pipelined
    images). Checks: (a) the pipelined ``decode_batch`` and two single
    decodes carry the writers' y_hat bit for bit, with K1/K2 launches as
    the exact decode's and the int8 products and quantized ops per family
    as W8A8_OPS gives them; (b) every image within W8A8_PSNR_FLOOR /
    W8A8_CORR_FLOOR of the exact one; (c) per family, at the largest shape
    a decode gives it, the card's int32 accumulators equal the exact
    integer products of the same int8 operands; (d) a batch row's output
    of each such op equals its B=1 output bit for bit (the other row 100x
    larger); (e) a BUNDLE_BUCKET w8a8 bundle in a fresh process gives the
    runtime's pipelined images bit for bit. Prints the costs: per op and
    family w8a8 against bf16 (ms, launches), the gate the per-op sums
    favour, one decode's wall and device busy, pipelined decodes/s.
    Returns the K1 and K2 launches of the pipelined decode."""
    from onedc_tpu_torch.models.onedc import OneDCRuntime
    from onedc_tpu_torch.utils import aot

    rtq = OneDCRuntime(rt.model, dtype=torch.bfloat16, device=rt.device,
                       quant="w8a8")
    streams = square["streams"]
    n = len(streams)

    # (e) a w8a8 bundle: its quantized x0 and VAE (``exports``), its prior
    # programs the serving phase's bundle's (traced outside the quant
    # mode, ``utils/aot.py``); a fresh process loads it while (a)-(d) and
    # the costs run, then serves it
    h, w, b = BUNDLE_BUCKET
    tmp = Path(tempfile.mkdtemp(prefix="onedc_w8a8_bundle_"))
    try:
        arts = exported(exports, ("w8a8",))
        export_s = sum(arts["meta"]["export_seconds"].values())
        aot.save_bundle({**arts, **square["prior"]}, tmp)
        aot.save_weights(rtq, tmp / "weights.safetensors")
        del arts
        (tmp / "streams").mkdir()
        for j, stream in enumerate(streams):
            (tmp / "streams" / f"{j:02d}.bin").write_bytes(stream)
        with bundle_process(tmp) as proc:
            launches, got, decoded = w8a8_checks(rt, rtq, square, seed,
                                                 card)
            torch.cuda.empty_cache()
            res = finish_bundle(proc, tmp, "w8a8 bundle")
        meta = json.loads((tmp / "meta.json").read_text())
        if meta["quant"] != "w8a8" or res["quant"] != "w8a8" \
                or res["model_modules"]:
            raise AssertionError(f"w8a8 bundle: quant {meta['quant']}, "
                                 f"model modules {res['model_modules']}")
        if res["decode_launches"] != pipelined_launches((h, w), n, b, b) \
                or res["int8_launches"] != got[2]:
            raise AssertionError(f"w8a8 bundle launched K1/K2 "
                                 f"{res['decode_launches']} and "
                                 f"{res['int8_launches']} int8 products")
        same = sum(torch.equal(a.to(c.device).float(),
                               c.bfloat16().float())
                   for a, c in zip(res["images"], decoded))
        if same != n:
            raise AssertionError(f"w8a8 bundle: {same} of {n} images equal "
                                 f"the runtime's pipelined ones")
        print(f"w8a8 bundle {h}x{w}x{b}: x0 and vae exported in "
              f"{export_s:.1f} s by a process of their own; its {n} images "
              f"equal the w8a8 runtime's pipelined ones bit for bit; meta "
              f"quant {meta['quant']}", flush=True)
    finally:
        shutil.rmtree(tmp)
    return launches


def w8a8_checks(rt, rtq, square, seed: int, card: str):
    """``w8a8_path``'s checks (a)-(d) and its costs on the w8a8 runtime
    ``rtq``. Returns the pipelined decode's K1 / K2 launches, its K1 / K2
    / int8 counts and its images."""
    from collections import Counter

    from onedc_tpu_torch.nn import quant
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1
    from onedc_tpu_torch.ops import w8a8
    from tools.profile_port_decode import profiled

    streams, plans, exact = (square[k] for k in ("streams", "plans",
                                                 "images"))
    n = len(streams)
    counts = (k1, k2, w8a8)

    # (a) the counted pipelined run, then two traced single decodes
    y_hats, dtypes = [], []
    programs = rtq.decode_programs
    rtq.decode_programs = lambda: recording(programs(), y_hats, dtypes)
    for c in counts:
        c.launches = 0
    with quant.recording() as ops:
        decoded, got = counted(counts, lambda: rtq.decode_batch(streams))
    del rtq.decode_programs
    launches = {"K1": got[0], "K2": got[1]}
    want = pipelined_launches((768, 768), n)
    chunks = -(-n // SERVING_CHUNK)
    fams = Counter(o.family for o in ops)
    if got[:2] != want or dict(fams) != {f: chunks * c for f, c in
                                         W8A8_OPS.items()} \
            or got[2] != chunks * int8_products(W8A8_OPS):
        raise AssertionError(f"w8a8 pipelined decode_batch: K1/K2/int8 "
                             f"{got}, quantized ops {dict(fams)}; expected "
                             f"{want}, {chunks} x {W8A8_OPS}")
    match_rows(y_hats, plans, "w8a8 pipelined decode_batch")
    singles = []
    for i in (0, 1):
        trace = {}
        with quant.recording() as one:
            img, got1 = counted(counts, lambda: rtq.decode(streams[i], trace))
        if not torch.equal(trace["y_hat"], plans[i]):
            raise AssertionError(f"w8a8 decode {i}: y_hat differs from the "
                                 f"writer's")
        if dict(Counter(o.family for o in one)) != W8A8_OPS or got1 != (
                *decode_launches(768, 768), int8_products(W8A8_OPS)):
            raise AssertionError(f"w8a8 decode {i}: K1/K2/int8 {got1}")
        singles.append(img)
    print(f"w8a8: pipelined decode_batch of {n} 768x768 streams and two "
          f"single decodes carry the writers' y_hat; K1/K2/int8 launches "
          f"{got} (a decode {got1}); quantized ops per decode "
          f"{json.dumps(W8A8_OPS)}", flush=True)

    # (b) against the exact bf16 images
    quality = []
    for a, b in list(zip(decoded, exact)) + list(zip(
            singles, [rt.decode(s) for s in streams[:2]])):
        corr = torch.corrcoef(torch.stack([a.flatten().double(),
                                           b.flatten().double()]))[0, 1]
        quality.append((image_psnr(a, b), corr.item(),
                        (a - b).abs().max().item()))
    psnrs, corrs, maxes = zip(*quality)
    print(f"w8a8 against the exact bf16 decode on {card} ({len(quality)} "
          f"images): PSNR min {min(psnrs):.2f} median "
          f"{float(np.median(psnrs)):.2f} dB (floor {W8A8_PSNR_FLOOR}), "
          f"correlation min {min(corrs):.5f} (floor {W8A8_CORR_FLOOR}), max "
          f"|diff| {max(maxes):.4f}", flush=True)
    if min(psnrs) < W8A8_PSNR_FLOOR or min(corrs) <= W8A8_CORR_FLOOR:
        raise AssertionError("w8a8 images below the quality floors")

    # every op the mode may take (gate 0), for the costs
    gate = os.environ.get("ONEDC_Q8_MIN_CH")
    os.environ["ONEDC_Q8_MIN_CH"] = "0"
    try:
        with quant.recording() as all_ops:
            gate0 = rtq.decode(streams[0])
    finally:
        if gate is None:
            del os.environ["ONEDC_Q8_MIN_CH"]
        else:
            os.environ["ONEDC_Q8_MIN_CH"] = gate
    print(f"w8a8 at gate 0 ({len(all_ops)} ops): PSNR "
          f"{image_psnr(gate0, exact[0]):.2f} dB against the exact image",
          flush=True)

    # (c), (d): per family the largest op a decode gives it
    modules = dict(rtq.model.named_modules())
    gen = torch.Generator(device=rtq.device)
    gen.manual_seed(seed)
    checked = {}
    with torch.no_grad():
        for fam in W8A8_OPS:
            o = max((o for o in one if o.family == fam),
                    key=lambda o: int(np.prod(o.shape)))
            m, x = modules[o.path], op_input(o.shape, gen)
            y, products = w8a8_operands_checked(rtq, m, x)
            other = op_input(o.shape, gen) * 100
            both = rtq.quantized(m)(torch.cat([x, other]))
            if not torch.equal(both[:x.shape[0]], y):
                raise AssertionError(f"w8a8 {fam} ({o.path}): a batch row "
                                     f"differs from its B=1 output")
            checked[fam] = {"path": o.path, "shape": o.shape,
                            "int8_products": products}
    print(f"w8a8 ops on {card}: int32 accumulators equal the exact integer "
          f"products and batch rows their B=1 outputs, per family at its "
          f"largest decode shape: {json.dumps(checked)}", flush=True)

    # (g) costs: per op and family, one decode, the pipelined batch
    gate = quant.min_channels()
    rows, groups, families, gates = w8a8_op_costs(rtq, all_ops, seed, gate)
    best = {k: min(gates, key=lambda g: gates[g][k])
            for k in ("wall_ms", "device_ms")}
    print(f"w8a8 cost per family at gate {gate}, one 768x768 decode's ops, "
          f"{card}: {json.dumps(families)}", flush=True)
    print(f"w8a8 cost per family and width (min of Cin, Cout) on {card}: "
          f"{json.dumps(groups)}", flush=True)
    print(f"w8a8 sums over one decode's in-scope ops by gate (ops below it "
          f"exact): {json.dumps(gates)}; favoured: {json.dumps(best)} (the "
          f"default stays 512)", flush=True)
    walls = {"bf16": [], "w8a8": []}
    for _ in range(3):
        for name, r in (("bf16", rt), ("w8a8", rtq)):
            walls[name].append(_wall_ms(lambda: r.decode(streams[0])))
    busy = {name: profiled(lambda: r.decode(streams[0]))
            for name, r in (("bf16", rt), ("w8a8", rtq))}
    rates_ = {"bf16": [], "w8a8": []}
    for _ in range(2):
        for name, r in (("bf16", rt), ("w8a8", rtq)):
            rates_[name] += rates(lambda: r.decode_batch(streams), n, 1)
    print(f"w8a8 one 768x768 decode on {card}: wall ms {json.dumps(walls)}; "
          + "; ".join(f"{k}: device busy {v['device_busy_ms']:.2f} ms in a "
                      f"{v['profiled_window_ms']:.2f} ms window, "
                      f"{v['kernel_launches']} launches"
                      for k, v in busy.items())
          + f"; pipelined decodes/s on the {n} streams {json.dumps(rates_)}",
          flush=True)
    record = {"card": card, "families": families, "groups": groups,
              "gates": gates, "favoured_gate": best, "checked": checked,
              "walls_ms": walls,
              "busy": {k: {kk: v[kk] for kk in (
                  "device_busy_ms", "profiled_window_ms", "kernel_launches",
                  "device_ms_by_family")} for k, v in busy.items()},
              "pipelined_decodes_per_s": rates_,
              "psnr_min": min(psnrs), "corr_min": min(corrs),
              "per_op": rows}
    out = Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    (out / "w8a8_costs.json").write_text(json.dumps(record))
    return launches, got, decoded


def serve_bundle(directory: Path, card: str) -> int:
    """The bundle process (``--serve-bundle DIR``): ``ServingDecoder`` on
    the 768x768 streams of DIR/streams and, where DIR/encode.npy exists,
    ``ServingEncoder`` on its images, from DIR's bundle and weights,
    importing no model code. Writes DIR/result.pt (launches, the y_hat
    rows and symbol dtypes the pipeline saw, the images in bf16, the
    containers and the encode program's plans, the model modules loaded,
    the int8 products of the decode and the bundle's quant mode) and prints
    load seconds and the bundle's decodes/s."""
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1
    from onedc_tpu_torch.ops import w8a8
    from onedc_tpu_torch.serving.decoder import ServingDecoder
    from onedc_tpu_torch.serving.encoder import ServingEncoder

    counts = (k1, k2)
    streams = [p.read_bytes()
               for p in sorted((directory / "streams").glob("*.bin"))]
    t0 = time.perf_counter()
    dec = ServingDecoder(directory, directory / "weights.safetensors")
    weights_s = time.perf_counter() - t0
    for name in ("begin", "x0", "vae") + tuple(
            f"update{s}{x}" for s in range(4) for x in ("", "_i8")):
        if dec.bundle.has(name):
            dec.bundle.program(name)
    enc = None
    if (directory / "encode.npy").exists():
        enc = ServingEncoder(directory, dec.bundle.weights)
    load_s = time.perf_counter() - t0 - weights_s
    n_programs = len(dec.bundle.modules) + (enc is not None)
    wait_for_go(directory)
    y_hats, dtypes = [], []
    programs = dec._programs
    dec._programs = lambda: recording(programs(), y_hats, dtypes)
    k1.launches = 0
    k2.launches = 0
    w8a8.launches = 0
    images, decode_launches = counted(counts,
                                      lambda: dec.decode_batch(streams))
    int8_launches = w8a8.launches
    dec._programs = programs
    bundle_rates = rates(lambda: dec.decode_batch(streams), len(streams))
    result = {"y_hats": [y.cpu() for y in y_hats], "updates": len(dtypes),
              "narrowed": sum(d == torch.int8 for d in dtypes),
              "images": [im.bfloat16().cpu() for im in images],
              "decode_launches": decode_launches,
              "int8_launches": int8_launches,
              "quant": dec.bundle.meta["quant"]}
    encoded = []
    if enc is not None:
        encoded = bundle_encode(directory, enc, counts, result)
    result["model_modules"] = sorted(m for m in sys.modules
                                     if m.startswith(MODEL_MODULES))
    torch.save(result, directory / "result.pt")
    print(f"bundle process on {card} (quant {result['quant']}): weights "
          f"placed in {weights_s:.1f} s, {n_programs} programs loaded in "
          f"{load_s:.1f} s (beside the smoke process's own work); "
          f"ServingDecoder K1/K2 launches "
          f"{decode_launches} and {int8_launches} int8 products on "
          f"{len(streams)} streams, decodes/s {json.dumps(bundle_rates)}; "
          f"ServingEncoder K1/K2 launches "
          f"{result.get('encode_launches')} on {len(encoded)} images; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB", flush=True)
    return 0


def bundle_encode(directory: Path, enc, counts, result: dict):
    """The bundle process's ``ServingEncoder`` ``enc`` on DIR/encode.npy:
    its containers, the encode program's plans and the launches go into
    ``result``; returns the containers."""
    plans = []
    encode = enc._encode

    def record(x):
        out = encode(x)
        for j in range(x.shape[0]):
            plans.append({"y_q_w": [a[j:j + 1].cpu() for a in out["y_q_w"]],
                          "indexes_w": [a[j:j + 1].cpu()
                                        for a in out["indexes_w"]],
                          "y_hat": out["y_hat"][j:j + 1].cpu()})
        return out
    enc._encode = record
    batch = np.load(directory / "encode.npy")
    for c in counts:
        c.launches = 0
    encoded, result["encode_launches"] = counted(
        counts, lambda: enc.encode_batch([im[None] for im in batch]))
    result["containers"] = [c for c, _ in encoded]
    result["plans"] = plans[:len(encoded)]
    return encoded


def wait_for_go(directory: Path) -> None:
    """The bundle process waits here, its bundle loaded, until the smoke
    process lets it decode (``finish_bundle``); it exits if that process
    is gone."""
    parent = os.getppid()
    while not (directory / "go").exists():
        if os.getppid() != parent:
            raise SystemExit("the smoke process is gone")
        time.sleep(0.01)


def start_child(flag: str, directory: Path) -> subprocess.Popen:
    """This script in a fresh process, ``flag DIRECTORY``, its output in
    DIRECTORY."""
    with open(directory / "stdout.txt", "w") as out, \
            open(directory / "stderr.txt", "w") as err:
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), flag,
             str(directory)], stdout=out, stderr=err)


def wait_child(proc, directory: Path, what: str) -> None:
    """Waits for ``start_child``'s process, prints its output and raises
    if it failed."""
    rc = proc.wait(timeout=900)
    print((directory / "stdout.txt").read_text(), end="", flush=True)
    if rc != 0:
        err = (directory / "stderr.txt").read_text()[-4000:]
        raise AssertionError(f"the {what} process failed:\n{err}")


def stop_children(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


@contextlib.contextmanager
def bundle_process(directory: Path):
    """A bundle process (``serve_bundle``) on DIRECTORY, started now: it
    loads the bundle on the host while this process goes on with the
    phase, and decodes once ``finish_bundle`` lets it, alone on the card.
    It is killed if the phase fails first."""
    proc = start_child("--serve-bundle", directory)
    try:
        yield proc
    finally:
        stop_children([proc])


def finish_bundle(proc, directory: Path, what: str) -> dict:
    """Lets the bundle process decode, waits for its end, prints its output
    and returns its DIRECTORY/result.pt."""
    (directory / "go").touch()
    wait_child(proc, directory, what)
    return torch.load(directory / "result.pt", weights_only=False)


def export_bundle(directory: Path, card: str) -> int:
    """The export process (``--export-bundle DIR``): the full-width model
    built as the decode phase builds it (bf16 runtime, then the w8a8 one
    on its model), DIR/spec.json's programs of its quant mode exported at
    BUNDLE_BUCKET into DIR (``utils/aot.py:save_bundle``)."""
    from onedc_tpu_torch.models.onedc import OneDC, OneDCRuntime
    from onedc_tpu_torch.utils import aot

    spec = json.loads((directory / "spec.json").read_text())
    with torch.device("cuda"):
        model = OneDC()
    init_random_weights(model, spec["seed"])
    rt = OneDCRuntime(model, dtype=torch.bfloat16)
    if spec["quant"] is not None:
        rt = OneDCRuntime(rt.model, dtype=torch.bfloat16, device=rt.device,
                          quant=spec["quant"])
    torch.cuda.empty_cache()
    h, w, b = BUNDLE_BUCKET
    arts = aot.export_serving_bundle(rt, h, w, batch=b,
                                     programs=spec["programs"])
    aot.save_bundle(arts, directory)
    print(f"export process on {card}: {sorted(k for k in arts if k != 'meta')}"
          f" ({spec['quant'] or 'exact'}) in "
          f"{sum(arts['meta']['export_seconds'].values()):.1f} s", flush=True)
    return 0


@contextlib.contextmanager
def export_processes(seed: int):
    """One ``export_bundle`` process per BUNDLE_EXPORTS entry, started now
    and left to run beside the phases that follow. Yields {name: (process,
    directory)}; kills what still runs on the way out."""
    root = Path(tempfile.mkdtemp(prefix="onedc_exports_"))
    procs = {}
    try:
        for name, quant, programs in BUNDLE_EXPORTS:
            directory = root / name
            directory.mkdir()
            (directory / "spec.json").write_text(json.dumps(
                {"seed": seed, "quant": quant, "programs": list(programs)}))
            procs[name] = (start_child("--export-bundle", directory),
                           directory)
        yield procs
    finally:
        stop_children([proc for proc, _ in procs.values()])
        shutil.rmtree(root)


def exported(exports, names) -> dict:
    """The artifacts of the export processes ``names`` (waited for), as one
    bundle dict: their programs' bytes and the first one's meta, with every
    program's export seconds."""
    arts = {}
    for name in names:
        proc, directory = exports[name]
        wait_child(proc, directory, f"{name} export")
        meta = json.loads((directory / "meta.json").read_text())
        if "meta" in arts:
            arts["meta"]["export_seconds"].update(meta["export_seconds"])
        else:
            arts["meta"] = meta
        for program in meta["export_seconds"]:
            arts[program] = (directory / f"{program}.pt2").read_bytes()
    return arts


def tf32_probe(seed: int):
    """Printed, not a check: on a full-width f32 runtime, a 512x768 write
    plan with TF32 on (cuDNN and cuBLAS) against the pinned plan, and a
    reader with TF32 on against the pinned plan's indexes (the decoder's
    programs on the pinned plan's z and symbols)."""
    from onedc_tpu_torch.models.onedc import OneDC, OneDCRuntime

    with torch.device("cuda"):
        model = OneDC()
    init_random_weights(model, seed)
    rt = OneDCRuntime(model)
    image = encode_images(seed)[2]
    pinned = rt.write_plan(image)
    codec = rt.model.codec
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=True):
            tf32 = rt.model.encode_device(rt.pad(image))
            st = codec.decompress_begin(pinned["z_indices"])
            reader = []
            for step in range(4):
                reader.append(st["indexes_r"])
                st.update(codec.decompress_update(
                    step, pinned["y_q_w"][step], st["means"], st["y_hat"],
                    st["common"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
    n = pinned["indexes_w"][0].numel()
    out = {
        "z_indices_differ": int((tf32["z_indices"]
                                 != pinned["z_indices"]).sum()),
        "z_indices": pinned["z_indices"].numel(),
        "writer_indexes_differ": [int((a != b).sum()) for a, b in zip(
            tf32["indexes_w"], pinned["indexes_w"])],
        "writer_symbols_differ": [int((a != b).sum()) for a, b in zip(
            tf32["y_q_w"], pinned["y_q_w"])],
        "reader_indexes_differ": [int((a != b).sum()) for a, b in zip(
            reader, pinned["indexes_w"])],
        "per_step": n,
    }
    print("TF32 probe (f32 runtime, 512x768, TF32 on against pinned) "
          + json.dumps(out), flush=True)
    return out


def write_release(directory: Path):
    """The reference's release layout at full width, ``model.safetensors``
    (SD1.5 UNet + LoRA) and ``model_1.safetensors`` (codec), from
    ``tests/twins.py`` (numpy only, not of the JAX package), written in
    F16 by the port's writer: (twins' seconds, write seconds, bytes,
    {port key: f32 array}), the last the RELEASE_PROBES as the loaded
    model must hold them: the F16 values, the LoRA adapters merged on the
    host (base + alpha / rank * B A, alpha 8, rank 64, by a matrix product
    of their own)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from twins import codec_twin, sd_unet_twin

    from onedc_tpu_torch.utils.safetensors import save_safetensors

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:  # numpy's generator drops the GIL
        unet, codec = ex.submit(sd_unet_twin), ex.submit(codec_twin)
        unet, codec = unet.result(), codec.result()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nbytes = 0
    for name, state in (("model", unet), ("model_1", codec)):
        path = directory / f"{name}.safetensors"
        save_safetensors({k: v.astype(np.float16) for k, v in state.items()},
                         path)
        nbytes += path.stat().st_size
    write_s = time.perf_counter() - t0

    def f16(a):
        return a.astype(np.float16).astype(np.float32)
    probes = {}
    for name, ref, key in RELEASE_PROBES:
        state = unet if name == "model" else codec
        if f"{ref}.weight" in state:
            probes[key] = f16(state[f"{ref}.weight"])
            continue
        base = f16(state[f"{ref}.base_layer.weight"])
        a = f16(state[f"{ref}.lora_A.default.weight"])
        b = f16(state[f"{ref}.lora_B.default.weight"])
        delta = b.reshape(b.shape[0], -1) @ a.reshape(a.shape[0], -1)
        probes[key] = base + 8.0 / 64 * delta.reshape(base.shape)
    return gen_s, write_s, nbytes, probes


def decode_launches(h: int, w: int):
    return K1_PER_CALL["{}x{}".format(*padded_size(h, w))], \
        K2_PER_CALL["{}x{}".format(*padded_size(h, w))]


def bucket_counts(sizes):
    """{padded size: number of images} of images of ``sizes``."""
    counts: dict = {}
    for h, w in sizes:
        size = padded_size(h, w)
        counts[size] = counts.get(size, 0) + 1
    return counts


def pipelined_launches(size, n: int, chunk: int = SERVING_CHUNK,
                       vae_chunk: int = VAE_CHUNK):
    """(K1, K2) launches of ``decode_batch`` on one bucket of ``n`` streams
    of padded ``size``: one stream is a decode; more run the pipelined
    schedule, K1 once per x0 chunk of ``chunk`` streams and K2 once per VAE
    sub-batch of ``vae_chunk`` rows."""
    k1, k2 = decode_launches(*size)
    if n == 1:
        return k1, k2
    rows = [min(chunk, n - c0) for c0 in range(0, n, chunk)]
    return len(rows) * k1, sum(-(-r // vae_chunk) for r in rows) * k2


def batch_launches(sizes, **kw):
    """(K1, K2) launches of ``decode_batch`` on streams of ``sizes``."""
    per = [pipelined_launches(size, n, **kw)
           for size, n in bucket_counts(sizes).items()]
    return tuple(map(sum, zip(*per)))


def serving_launches(sizes):
    """(K1, K2) launches of ``Evaluator.evaluate_batched`` on images of
    ``sizes``: per padded size, ``encode_many``'s device chunks of
    SERVING_CHUNK images, then ``decode_batch``."""
    k1, k2 = batch_launches(sizes)
    for size, n in bucket_counts(sizes).items():
        chunks = -(-n // SERVING_CHUNK)
        k1 += chunks * ENCODE_PER_CALL[size][0]
        k2 += chunks * ENCODE_PER_CALL[size][1]
    return k1, k2


def tiled_launches():
    """(K1, K2) launches of the tiled phase, in its three parts: the 4K
    encode (``encode_many``: one encode per device chunk of SERVING_CHUNK
    tiles), its decode (``decode_batch`` of the tiles' streams, pipelined)
    and the 768x768 pass-through's encode and decode."""
    tile = (TILED_TILE, TILED_TILE)
    chunks = -(-TILED_TILES // SERVING_CHUNK)
    encode = tuple(chunks * n for n in ENCODE_PER_CALL[tile])
    decode = batch_launches([tile] * TILED_TILES)
    single = tuple(a + b for a, b in zip(ENCODE_PER_CALL[tile],
                                         decode_launches(*tile)))
    return {"encode": encode, "decode": decode, "pass_through": single}


def train_loop_launches():
    """(K1, K1-bwd, K2, K3) launches of the training-loop phase: the
    uninterrupted run's TRAIN_LOOP_STEPS steps and one eval epoch, the
    resumed run's steps from TRAIN_LOOP_SAVE; each step's resolution by
    ``MultiResolutionCrop.pick`` of TRAIN_OVERRIDES' list."""
    from onedc_tpu_torch.data.crops import MultiResolutionCrop

    crop = MultiResolutionCrop(TRAIN_OVERRIDES["resolutions"],
                               TRAIN_OVERRIDES["batch_scales"])
    steps = list(range(TRAIN_LOOP_STEPS)) \
        + list(range(TRAIN_LOOP_SAVE, TRAIN_LOOP_STEPS))
    per = [TRAIN_PER_STEP[crop.pick(s)[0]] for s in steps]
    per += [EVAL_PER_IMAGE[(512, 768)]] * TRAIN_LOOP_EVAL
    return tuple(map(sum, zip(*per)))


def stage1_per_step(res: int):
    """(K1, K1-bwd, K2, K3) launches of one stage-I yaml step under remat:
    the forward's (STAGE1_PER_FORWARD), and the recompute of what autograd
    records launches K1 and the VAE decoder's K2 (one per K3) again."""
    k1, k1_bwd, k2, k3 = STAGE1_PER_FORWARD[res]
    return 2 * k1, k1_bwd, k2 + k3, k3


def stage1_launches():
    """(K1, K1-bwd, K2, K3) of the stage-I yaml phase's STAGE1_STEPS steps,
    each at the resolution ``MultiResolutionCrop.pick`` gives it."""
    from onedc_tpu_torch.data.crops import MultiResolutionCrop

    crop = MultiResolutionCrop(STAGE1_OVERRIDES["resolutions"],
                               STAGE1_OVERRIDES["batch_scales"])
    per = [stage1_per_step(crop.pick(s)[0]) for s in range(STAGE1_STEPS)]
    return tuple(map(sum, zip(*per)))


def check_release_loaded(model, probes: dict) -> float:
    """Each RELEASE_PROBES tensor of ``model`` (bf16 on the card) against
    the twins' values: within bf16's rounding (2^-8 of the largest
    magnitude). Returns the largest such error."""
    state = model.state_dict()
    worst = 0.0
    for key, want in probes.items():
        got = state[key].float().cpu().numpy()
        err = float(np.abs(got - want).max() / np.abs(want).max())
        if got.shape != want.shape or not err <= 2.0 ** -8:
            raise AssertionError(f"cli: loaded {key} is not the release's "
                                 f"(shape {got.shape}, error {err:.3e})")
        worst = max(worst, err)
    return worst


def serve_kodak_sized(ev, rt, tmp: Path, seed: int, counts):
    """``--serving`` (``evaluate_batched``) on SERVING_SIZES seeded
    synthetic PNGs: a warm pass, then two timed passes. Each pass launches
    K1 and K2 as ``serving_launches`` predicts and writes the warm pass's
    ``.bin`` bytes; the first landscape chunk's first and last streams and
    the portrait chunk's decode to their writer's plan. Returns the timed
    passes' (encodes/s, decodes/s)."""
    from onedc_tpu_torch.data.images import load_image, save_image
    from onedc_tpu_torch.entropy.framing import read_from_file

    folder = tmp / "kodak"
    folder.mkdir()
    batch = next(synthetic_batches(seed + 1, len(SERVING_SIZES), 768))
    names = [f"kodim{i + 1:02d}" for i in range(len(SERVING_SIZES))]
    for name, im, (h, w) in zip(names, batch["image"], SERVING_SIZES):
        save_image(im[:h, :w], folder / f"{name}.png")
    ev.cfg = dict(ev.cfg, dataset_path=str(folder))
    want = serving_launches(SERVING_SIZES)
    rates = []
    for run in ("warm", "timed1", "timed2"):
        ev.out_dir = tmp / f"kodak_{run}"
        for sub in ("bin", "recon"):
            (ev.out_dir / sub).mkdir(parents=True)
        summary, got = counted(counts, ev.evaluate_batched)
        if got != want:
            raise AssertionError(f"Kodak-sized --serving ({run}) launched "
                                 f"{got}, expected {want}")
        if run != "warm":
            rates.append((summary["encodes_per_sec"],
                          summary["decodes_per_sec"]))
            same = [(ev.out_dir / "bin" / f"{n}.bin").read_bytes()
                    == (tmp / "kodak_warm" / "bin" / f"{n}.bin").read_bytes()
                    for n in names]
            if not all(same):
                raise AssertionError(f"Kodak-sized --serving ({run}): "
                                     f"streams differ from the warm pass's")
    images = [load_image(folder / f"{n}.png")[None] for n in names]
    for size in sorted(set(SERVING_SIZES)):
        sel = [i for i, s in enumerate(SERVING_SIZES) if s == size]
        sel = sel[:SERVING_CHUNK]
        plan = rt.write_plan(np.concatenate([images[i] for i in sel]))
        for row in (0, len(sel) - 1):
            check_stream_decodes_to_plan(
                rt, read_from_file(tmp / "kodak_warm" / "bin"
                                   / f"{names[sel[row]]}.bin"),
                plan, row, f"Kodak-sized --serving {names[sel[row]]}")
    print(f"cli --serving, Kodak-sized set ({len(names)} images: "
          f"{SERVING_SIZES.count((512, 768))} at 512x768, "
          f"{SERVING_SIZES.count((768, 512))} at 768x512; warm pass, then "
          f"two timed): (encodes/s, decodes/s) {json.dumps(rates)}; K1/K2 "
          f"launches per pass {want}; every pass wrote the same streams, "
          f"and the checked ones decode to their writer's plan", flush=True)
    return rates


def cli_path(seed: int, release: Path, nbytes: int, probes: dict):
    """The cli phase: ``eval.inference.main`` on the full-width release
    layout (``release``, from ``write_release``: ``nbytes`` bytes, its
    ``probes``; through ``checkpoint_path=``, no ``vae_ckpt``: the VAE
    stays seeded random) and PNGs of ENCODE_SIZES,
    in bf16. The loaded model holds the release's tensors
    (``check_release_loaded``); every ``.bin`` decodes to its writer's
    plan bit for bit, with the launches of the tables; ``--serving``
    (``evaluate_batched`` on the same Evaluator) likewise on the four
    images, and on the Kodak-sized set of ``serve_kodak_sized``, whose
    rates are the phase's serving figures; a TinyVAE runtime (random
    graft) on the same model decodes a 768x768 stream with K2 at 0 while
    the Evaluator's runtime still decodes through the large VAE;
    ``--decoder_only`` in a fresh Evaluator writes ``evaluate()``'s PNG
    bytes. Returns the K1 and K2 launches of the ``main`` run of
    ``evaluate``."""
    from onedc_tpu_torch.data.images import load_image, save_image
    from onedc_tpu_torch.entropy.framing import read_from_file
    from onedc_tpu_torch.eval import inference
    from onedc_tpu_torch.models.onedc import (
        OneDCRuntime,
        ensure_tiny_vae_params,
    )
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1

    counts = (k1, k2)
    tmp = Path(tempfile.mkdtemp(prefix="onedc_cli_"))
    try:
        (tmp / "imgs").mkdir()
        names = []
        for i, ((h, w), im) in enumerate(zip(ENCODE_SIZES,
                                             encode_images(seed))):
            names.append(f"img{i}_{h}x{w}")
            save_image(im[0], tmp / "imgs" / f"{names[-1]}.png")
        base = ["--config", "configs/inference_lambda.yaml",
                f"checkpoint_path={release}", f"dataset_path={tmp / 'imgs'}",
                f"seed={seed}"]

        k1.launches = 0
        k2.launches = 0
        ev = inference.main(base + [f"output_path={tmp / 'eval'}"])
        torch.cuda.synchronize()
        launches = {"K1": k1.launches, "K2": k2.launches}
        want = tuple(map(sum, zip(*(
            tuple(a + b for a, b in zip(ENCODE_PER_CALL[padded_size(h, w)],
                                        decode_launches(h, w)))
            for h, w in ENCODE_SIZES))))
        print(f"cli: checkpoint load {ev.load_s:.2f} s ({nbytes / 1e9:.3f} "
              f"GB read); evaluate of {len(names)} images launched K1/K2 "
              f"{tuple(launches.values())}, expected {want}", flush=True)
        if tuple(launches.values()) != want:
            raise AssertionError("the cli run's launches differ from the "
                                 "tables")
        err = check_release_loaded(ev.model, probes)
        print(f"cli: the loaded model holds the release's {len(probes)} "
              f"probed tensors (LoRA merged) to {err:.3e} of their largest "
              f"magnitude", flush=True)
        del probes

        rt = ev.runtime
        images = [load_image(tmp / "imgs" / f"{n}.png")[None] for n in names]
        streams = [read_from_file(tmp / "eval" / "bin" / f"{n}.bin")
                   for n in names]
        for (h, w), name, im, stream in zip(ENCODE_SIZES, names, images,
                                            streams):
            plan = rt.write_plan(im)
            img, got = counted(counts, lambda: check_stream_decodes_to_plan(
                rt, stream, plan, 0, f"cli {name}"))
            if got != decode_launches(h, w) or img.shape != (1, h, w, 3):
                raise AssertionError(f"cli {name}: decode launched {got}, "
                                     f"image {tuple(img.shape)}")
        print("cli: every .bin decodes to its writer's indexes, symbols and "
              "y_hat", flush=True)
        with open(tmp / "eval" / "bpp_detail.csv") as f:
            rows = list(csv.DictReader(f))
        print("cli per image (name, bpp, encode ms, decode ms) " + json.dumps(
            [(r["name"], float(r["bpp"]), float(r["enc_s"]) * 1e3,
              float(r["dec_s"]) * 1e3) for r in rows]), flush=True)
        alone = {"encode": [], "decode": []}
        for _ in range(3):
            (stream, _), got = counted(counts, lambda: rt.encode(images[0]))
            if got != ENCODE_PER_CALL[(768, 768)]:
                raise AssertionError(f"cli encode launched {got}")
            alone["encode"].append(_wall_ms(lambda: rt.encode(images[0])))
            alone["decode"].append(_wall_ms(lambda: rt.decode(streams[0])))
        print("cli: OneDCRuntime alone at 768x768, wall ms " +
              json.dumps(alone) + f"; the .bin re-encoded to the same bytes: "
              f"{stream == streams[0]}", flush=True)

        # --serving on the same Evaluator: the four images (three size
        # buckets), checked stream by stream; its rates are per-call costs
        ev.out_dir = tmp / "serve"
        for sub in ("bin", "recon"):
            (ev.out_dir / sub).mkdir(parents=True)
        _, got = counted(counts, ev.evaluate_batched)
        want = serving_launches(ENCODE_SIZES)
        if got != want:
            raise AssertionError(f"--serving launched {got}, expected {want}")
        pair_plan = rt.write_plan(np.concatenate(images[:2]))
        for i, name in enumerate(names):
            plan, row = (pair_plan, i) if i < 2 else (
                rt.write_plan(images[i]), 0)
            check_stream_decodes_to_plan(
                rt, read_from_file(tmp / "serve" / "bin" / f"{name}.bin"),
                plan, row, f"cli --serving {name}")
        print(f"cli --serving of the {len(names)} images: K1/K2 launches "
              f"{got}; every stream decodes to its writer's plan",
              flush=True)
        serve_kodak_sized(ev, rt, tmp, seed, counts)

        # the TinyVAE decode on the same model, timed against the large
        # VAE's; the Evaluator's runtime keeps decoding the large VAE
        gen = torch.Generator(device=rt.device)
        gen.manual_seed(seed)
        tiny_rt = OneDCRuntime(ensure_tiny_vae_params(ev.model, gen),
                               dtype=torch.bfloat16, vae="tiny")
        img, got = counted(counts, lambda: tiny_rt.decode(streams[0]))
        if got != TINY_VAE_PER_CALL["768x768"] or img.shape != (
                1, 768, 768, 3) or not torch.isfinite(img).all():
            raise AssertionError(f"TinyVAE decode: launches {got}, image "
                                 f"{tuple(img.shape)}")
        _, got = counted(counts, lambda: rt.decode(streams[0]))
        if got != decode_launches(768, 768):
            raise AssertionError(f"the large-VAE runtime launched {got} "
                                 f"beside a TinyVAE runtime on its model")
        large_ms, tiny_ms = [], []
        for _ in range(3):
            large_ms.append(_wall_ms(lambda: rt.decode(streams[0])))
            tiny_ms.append(_wall_ms(lambda: tiny_rt.decode(streams[0])))
        print(f"cli vae=tiny 768x768 decode: K1/K2 launches "
              f"{TINY_VAE_PER_CALL['768x768']}; wall ms "
              f"{json.dumps(tiny_ms)} against the large VAE's "
              f"{json.dumps(large_ms)} (its runtime on the same model, "
              f"launches {got})", flush=True)
        del ev, rt, tiny_rt
        torch.cuda.empty_cache()

        # --decoder_only in a fresh Evaluator
        dev, got = counted(counts, lambda: inference.main(base + [
            "--decoder_only", "--decoder_bin_path", str(tmp / "eval" / "bin"),
            f"output_path={tmp / 'decoder_only'}"]))
        want = tuple(map(sum, zip(*(decode_launches(h, w)
                                    for h, w in ENCODE_SIZES))))
        same = [(tmp / "decoder_only" / "recon" / f"{n}.png").read_bytes()
                == (tmp / "eval" / "recon" / f"{n}.png").read_bytes()
                for n in names]
        print(f"cli --decoder_only (fresh Evaluator, load {dev.load_s:.2f} "
              f"s): K1/K2 launches {got}; PNG bytes equal evaluate()'s: "
              f"{same}", flush=True)
        if got != want or not all(same):
            raise AssertionError("--decoder_only differs from evaluate()")
        del dev
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp)
    return launches


def quality_launches(sizes, points: int = 2):
    """(K1, K2) launches of an RD sweep of ``points`` points over images
    of ``sizes``: per image one ``encode`` and one ``decode`` (the z-only
    model's programs launch as the lambda model's)."""
    per_point = [sum(ENCODE_PER_CALL[padded_size(h, w)][i]
                     + decode_launches(h, w)[i] for h, w in sizes)
                 for i in (0, 1)]
    return tuple(points * n for n in per_point)


def quality_reference_f64(x: np.ndarray, y: np.ndarray):
    """(PSNR, MS-SSIM) of two (H, W, 3) images in [0, 1], in numpy f64:
    the plain reference of ``eval/metrics.py`` from the same definitions
    (an 11-tap Gaussian of sigma 1.5, separable, valid padding; K1 0.01,
    K2 0.03; five scales, 2x2 average pooling between them)."""
    from numpy.lib.stride_tricks import sliding_window_view

    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    psnr = 10 * np.log10(1.0 / max(float(np.mean((x - y) ** 2)), 1e-12))
    g = np.exp(-(np.arange(11) - 5.0) ** 2 / (2 * 1.5 ** 2))
    g /= g.sum()

    def blur(a):
        a = sliding_window_view(a, 11, axis=0) @ g
        return sliding_window_view(a, 11, axis=1) @ g

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    weights = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
    value = 1.0
    for i, w in enumerate(weights):
        mx, my = blur(x), blur(y)
        sxx, syy = blur(x * x) - mx ** 2, blur(y * y) - my ** 2
        sxy = blur(x * y) - mx * my
        cs = (2 * sxy + c2) / (sxx + syy + c2)
        if i < len(weights) - 1:
            value *= max(float(cs.mean()), 0.0) ** w
            h, wd = x.shape[0] // 2, x.shape[1] // 2
            x = x[:2 * h, :2 * wd].reshape(h, 2, wd, 2, 3).mean((1, 3))
            y = y[:2 * h, :2 * wd].reshape(h, 2, wd, 2, 3).mean((1, 3))
        else:
            ssim = ((2 * mx * my + c1) / (mx ** 2 + my ** 2 + c1)) * cs
            value *= max(float(ssim.mean()), 0.0) ** w
    return psnr, value


def _timed(fn, log: list):
    """``fn`` whose every call appends its host seconds to ``log``."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            log.append(time.perf_counter() - t0)
    return wrapper


def quality_path(seed: int, release: Path, card: str):
    """The quality phase: ``eval.rd_sweep.main`` on configs/rd_sweep.yaml
    with two points on the cli phase's release (``checkpoint_path=``,
    bf16): ``lmbda`` and ``exlow`` (``model: {z_only: true}``), over
    QUALITY_SIZES (half the Kodak-sized set) as PNGs, with seeded random
    LPIPS, DISTS and InceptionV3 (1008 classes) files written through the
    port's converters and writer. ``rd_curve.csv`` must hold both points
    sorted by bpp (exlow's below lmbda's, its y rate 0) with every metric
    finite; the sweep's K1 / K2 launches are ``quality_launches``. On two
    source/recon pairs of the lmbda point the card's metrics are held
    against plain references: PSNR and MS-SSIM against numpy f64
    (``quality_reference_f64``), LPIPS, DISTS and the Inception features
    and logits of the recon's patches against the same port modules on
    the CPU in f32; LPIPS(x, x) is 0. Prints the metric nets' rates on the
    card, the host ``sqrtm`` seconds, each point's walls and the peak
    memory. Returns the K1 and K2 launches of the sweep."""
    from onedc_tpu_torch.data.images import load_image, save_image
    from onedc_tpu_torch.eval import metrics, rd_sweep
    from onedc_tpu_torch.nn import dists, inception, lpips
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1
    from onedc_tpu_torch.utils.safetensors import save_safetensors

    tmp = Path(tempfile.mkdtemp(prefix="onedc_quality_"))
    try:
        folder = tmp / "kodak"
        folder.mkdir()
        batch = next(synthetic_batches(seed + 2, len(QUALITY_SIZES), 768))
        names = [f"kodim{i + 1:02d}" for i in range(len(QUALITY_SIZES))]
        for name, im, (h, w) in zip(names, batch["image"], QUALITY_SIZES):
            save_image(im[:h, :w], folder / f"{name}.png")
        paths = {}
        for net, flat in (("lpips", lpips.random_lpips_weights(seed)),
                          ("dists", dists.random_dists_weights(seed)),
                          ("inception", inception.random_inception_weights(
                              seed, num_classes=1008))):
            paths[net] = tmp / f"{net}.safetensors"
            save_safetensors(flat, paths[net])

        sqrtm_s, point_s, metric_s = [], [], []
        wrapped = {(metrics, "frechet_distance"): sqrtm_s,
                   (rd_sweep, "run_point"): point_s,
                   (rd_sweep, "test_two_folders"): metric_s}
        originals = {key: getattr(*key) for key in wrapped}
        for (mod, attr), log in wrapped.items():
            setattr(mod, attr, _timed(getattr(mod, attr), log))
        k1.launches = 0
        k2.launches = 0
        torch.cuda.reset_peak_memory_stats()
        try:
            rows = rd_sweep.main([
                "--config", "configs/rd_sweep.yaml",
                f"dataset_path={folder}", f"output_path={tmp / 'sweep'}",
                f"checkpoint_path={release}", f"seed={seed}",
                f"lpips_weights={paths['lpips']}",
                f"dists_weights={paths['dists']}",
                f"inception_weights={paths['inception']}",
                "points=[{name: lmbda}, {name: exlow, model: {z_only: "
                "true}}]"])
            torch.cuda.synchronize()
        finally:
            for key, fn in originals.items():
                setattr(*key, fn)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = {"K1": k1.launches, "K2": k2.launches}
        want = quality_launches(QUALITY_SIZES)
        walls = list(zip(point_s, metric_s))
        print(f"quality: rd_sweep of 2 points x {len(names)} images launched "
              f"K1/K2 {tuple(launches.values())}, expected {want}; per point "
              f"(encode + decode s, metrics s) {json.dumps(walls)}; host "
              f"sqrtm s {json.dumps(sqrtm_s)}; peak {peak:.2f} GiB",
              flush=True)
        if tuple(launches.values()) != want:
            raise AssertionError("the sweep's launches differ from the "
                                 "tables")

        with open(tmp / "sweep" / "rd_curve.csv", newline="") as f:
            curve = list(csv.DictReader(f))
        cols = ("bpp", "bpp_y", "psnr", "ms_ssim", "lpips", "dists",
                "patch_fid", "patch_kid", "inception_mean")
        print("quality: rd_curve.csv " + json.dumps(
            [{k: r[k] for k in ("name",) + cols} for r in curve]), flush=True)
        if [r["name"] for r in curve] != ["exlow", "lmbda"] or len(rows) != 2:
            raise AssertionError("rd_curve.csv does not hold exlow then "
                                 "lmbda")
        if not float(curve[0]["bpp"]) < float(curve[1]["bpp"]) \
                or float(curve[0]["bpp_y"]) != 0.0:
            raise AssertionError("exlow's rate is not below lmbda's, or it "
                                 "wrote y bits")
        bad = [(r["name"], k) for r in curve for k in cols
               if not np.isfinite(float(r[k]))]
        if bad:
            raise AssertionError(f"rd_curve.csv: not finite {bad}")

        # the card against plain references on two pairs of the lmbda point
        card_fns = (lpips.make_lpips_fn(paths["lpips"]),
                    dists.make_dists_fn(paths["dists"]))
        cpu_fns = (lpips.make_lpips_fn(paths["lpips"], device="cpu"),
                   dists.make_dists_fn(paths["dists"], device="cpu"))
        card_inc = inception.make_inception_fn(paths["inception"])
        cpu_inc = inception.make_inception_fn(paths["inception"],
                                              device="cpu")
        recon = tmp / "sweep" / "lmbda" / "recon"
        worst = {"psnr_db": 0.0, "ms_ssim": 0.0, "lpips": 0.0, "dists": 0.0,
                 "features": 0.0, "logits": 0.0}
        # a landscape and a portrait image
        pairs = [names[0], names[next(i for i, size in enumerate(
            QUALITY_SIZES) if size != QUALITY_SIZES[0])]]
        for name in pairs:
            x = load_image(folder / f"{name}.png") * 0.5 + 0.5
            y = load_image(recon / f"{name}.png") * 0.5 + 0.5
            xb = torch.from_numpy(x)[None].cuda()
            yb = torch.from_numpy(y)[None].cuda()
            with torch.no_grad():
                got = (float(metrics.psnr(xb, yb)[0]),
                       float(metrics.ms_ssim(xb, yb)[0]))
                ref = quality_reference_f64(x, y)
                worst["psnr_db"] = max(worst["psnr_db"],
                                       abs(got[0] - ref[0]))
                worst["ms_ssim"] = max(worst["ms_ssim"],
                                       abs(got[1] - ref[1]))
                for key, card_fn, cpu_fn in zip(("lpips", "dists"), card_fns,
                                                cpu_fns):
                    a = float(card_fn(xb, yb)[0])
                    b = float(cpu_fn(x[None], y[None])[0])
                    worst[key] = max(worst[key], abs(a - b) / max(abs(b),
                                                                  1e-2))
                same = float(card_fns[0](xb, xb)[0])
            if abs(same) > 1e-6:
                raise AssertionError(f"quality {name}: LPIPS(x, x) = {same}")
            patches = metrics.to_uint8_range(np.stack(
                metrics.extract_patches(y * 2 - 1, 256)
                + metrics.extract_patches(y * 2 - 1, 256, True)) * 0.5 + 0.5)
            a, b = card_inc(patches), cpu_inc(patches)
            for key in ("features", "logits"):
                worst[key] = max(worst[key], float(
                    np.abs(a[key] - b[key]).max() / np.abs(b[key]).max()))
        print(f"quality: the card against plain references on {pairs} "
              f"(worst of the two): " + json.dumps(worst), flush=True)
        limits = {"psnr_db": QUALITY_PSNR_TOL, "ms_ssim": QUALITY_SSIM_TOL,
                  "lpips": QUALITY_DIST_TOL, "dists": QUALITY_DIST_TOL,
                  "features": QUALITY_FEAT_TOL, "logits": QUALITY_FEAT_TOL}
        over = {k: v for k, v in worst.items() if not v <= limits[k]}
        if over:
            raise AssertionError(f"quality: the card's metrics differ from "
                                 f"the references by {over} (limits "
                                 f"{limits})")

        # the metric nets' rates on the card, one pair per call (as the
        # harness calls them), after a warm call
        xs = [torch.from_numpy(load_image(folder / f"{n}.png") * 0.5
                               + 0.5)[None].cuda() for n in names]
        ys = [torch.from_numpy(load_image(recon / f"{n}.png") * 0.5
                               + 0.5)[None].cuda() for n in names]
        rates = {}
        with torch.no_grad():
            for key, fn in zip(("lpips", "dists"), card_fns):
                fn(xs[0], ys[0])
                rates[f"{key}_images_per_s"] = len(names) / (_wall_ms(
                    lambda: [fn(a, b) for a, b in zip(xs, ys)]) / 1e3)
        patches = metrics.to_uint8_range(np.stack([
            p for n in names for shifted in (False, True)
            for p in metrics.extract_patches(
                load_image(recon / f"{n}.png"), 256, shifted)]) * 0.5 + 0.5)
        card_inc(patches[:32])
        rates["inception_patches_per_s"] = len(patches) / (_wall_ms(
            lambda: card_inc(patches)) / 1e3)
        print(f"quality rates ({card}; {len(names)} images of "
              f"{QUALITY_SIZES[0][0]}x{QUALITY_SIZES[0][1]} or transposed, "
              f"{len(patches)} patches of 256x256): " + json.dumps(rates),
              flush=True)
        del card_fns, cpu_fns, card_inc, cpu_inc, xs, ys
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp)
    return launches


def _wall_ms(fn) -> float:
    """Host ms of ``fn()`` to a synchronised device."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def synthetic_batches(seed: int, batch: int, size: int = 1024):
    """Seeded synthetic images in [-1, 1]: 32-pixel blocks of random colour
    with fine noise on top, (batch, size, size, 3) f32, forever."""
    rng = np.random.default_rng(seed)
    while True:
        coarse = rng.uniform(-1, 1, (batch, size // 32, size // 32, 3))
        img = 0.8 * np.repeat(np.repeat(coarse, 32, 1), 32, 2) \
            + 0.2 * rng.uniform(-1, 1, (batch, size, size, 3))
        yield {"image": img.astype(np.float32)}


def train_overrides(lpips_weights) -> dict:
    """TRAIN_OVERRIDES with the LPIPS file the phase wrote."""
    return dict(TRAIN_OVERRIDES, lpips_weights=str(lpips_weights))


def train_path(seed: int):
    """The training phase: steps of ``Trainer.train_one_step`` at full
    width, with LPIPS in the loss (seeded random weights); returns each
    kernel's launches over the phase and the steps' records."""
    from onedc_tpu_torch.config import load_config
    from onedc_tpu_torch.nn.lpips import random_lpips_weights
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1
    from onedc_tpu_torch.train.step import split_frozen, warmup_constant_lr
    from onedc_tpu_torch.train.trainer import Trainer
    from onedc_tpu_torch.utils.safetensors import save_safetensors

    tmp = Path(tempfile.mkdtemp(prefix="onedc_train_"))
    try:
        save_safetensors(random_lpips_weights(seed), tmp / "lpips.safetensors")
        overrides = train_overrides(tmp / "lpips.safetensors")
        for key, value in overrides.items():
            print(f"train override: {key} = {value!r}", flush=True)
        cfg = load_config("configs/train_stage1.yaml", overrides)
        trainer = Trainer(cfg, device="cuda",
                          batches=synthetic_batches(seed, cfg["batch_size"]))
    finally:
        shutil.rmtree(tmp)
    vgg_before = [p.detach().clone() for p in trainer.lpips.parameters()]
    model = trainer.model
    init_random_weights(model, seed)
    n_params = sum(p.numel() for p in model.parameters())
    trainable = [p for _, p in split_frozen(model, trainer.frozen)[0]]
    names = [n for n, _ in split_frozen(model, trainer.frozen)[0]]
    print(f"model: {n_params / 1e9:.3f} B parameters, "
          f"{sum(p.numel() for p in trainable) / 1e9:.3f} B trainable",
          flush=True)
    # two steps at the first resolution (512) and one at the second (768),
    # by MultiResolutionCrop.pick's choice
    low, high = cfg["resolutions"]
    res = {s: trainer.crop.pick(s)[0] for s in range(64)}
    steps = sorted([s for s in res if res[s] == low][:2]
                   + [s for s in res if res[s] == high][:1])
    vae_before = [p.detach().clone() for p in model.vae.parameters()]
    params_before = [p.detach().clone() for p in trainable]
    counters = ((k1, "launches"), (k1, "bwd_launches"), (k2, "launches"),
                (k2, "conv_launches"))
    for mod, attr in counters:
        setattr(mod, attr, 0)
    records = []
    for i, step in enumerate(steps):
        before = tuple(getattr(m, a) for m, a in counters)
        lr = warmup_constant_lr(trainer.state.step, float(cfg["lr"]),
                                int(cfg["warmup_steps"]))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_one_step(step)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = tuple(getattr(m, a) - b for (m, a), b in zip(counters, before))
        want = TRAIN_PER_STEP[res[step]]
        print(f"train step {step} ({res[step]}x{res[step]}, lr {lr:.3e}): "
              f"{wall:.1f} ms wall, peak {peak:.2f} GiB, K1/K1-bwd/K2/K3 "
              f"launches {got}; " + json.dumps(metrics), flush=True)
        if got != want:
            raise AssertionError(f"step {step}: launches {got}, expected "
                                 f"{want}")
        for key in ("total_loss", "pix", "bpp", "bpp_hard_y", "grad_norm"):
            if not np.isfinite(metrics[key]):
                raise AssertionError(f"step {step}: {key} {metrics[key]}")
        for key in ("lpips", "weighted_lpips"):
            if not (np.isfinite(metrics[key]) and metrics[key] > 0):
                raise AssertionError(f"step {step}: {key} {metrics[key]}")
        grad = dict(model.named_parameters())[FIRST_ATTN1].grad
        gnorm = grad.norm().item()
        print(f"  |grad {FIRST_ATTN1}| = {gnorm:.4e}", flush=True)
        if not (np.isfinite(gnorm) and gnorm > 0):
            raise AssertionError(f"step {step}: no gradient reached "
                                 f"{FIRST_ATTN1}")
        if i < 2:
            same = [torch.equal(a, p)
                    for a, p in zip(params_before, trainable)]
        if i == 0:
            if lr != 0 or not all(same):
                raise AssertionError(f"the first update (lr {lr}) moved "
                                     f"{same.count(False)} tensors")
            print("  lr 0: every trainable tensor bit-identical", flush=True)
        elif i == 1:
            moved = same.count(False) / len(same)
            print(f"  lr {lr:.3e}: {same.count(False)} of {len(same)} "
                  f"trainable tensors changed; unchanged: "
                  f"{[n for n, sm in zip(names, same) if sm][:5]}",
                  flush=True)
            if not (lr > 0 and moved >= 0.99):
                raise AssertionError("an update with lr > 0 left the "
                                     "parameters in place")
            params_before = []  # free the copy
        records.append(dict(step=step, res=res[step], wall_ms=wall,
                            peak_gib=peak, launches=got, **metrics))
    if not all(torch.equal(a, p) for a, p in zip(vae_before,
                                                   model.vae.parameters())):
        raise AssertionError("a frozen VAE parameter changed")
    print(f"VAE: all {len(vae_before)} parameters bit-identical after "
          f"{len(steps)} steps", flush=True)
    vgg_after = trainer.lpips.parameters()
    if not all(torch.equal(a, p) for a, p in zip(vgg_before, vgg_after)):
        raise AssertionError("an LPIPS parameter changed")
    print(f"LPIPS: all {len(vgg_before)} parameters bit-identical after "
          f"{len(steps)} steps", flush=True)
    return {"K1": k1.launches, "K1-bwd": k1.bwd_launches,
            "K2": k2.launches, "K3": k2.conv_launches}, records


def tiled_image(seed: int):
    """A seeded TILED_SIZE image (1, H, W, 3) f32 in [-1, 1], built as
    ``synthetic_batches``' are: 32-pixel blocks of random colour with fine
    noise on top."""
    h, w = TILED_SIZE
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(-1, 1, (1, -(-h // 32), w // 32, 3))
    img = 0.8 * np.repeat(np.repeat(coarse, 32, 1), 32, 2)[:, :h] \
        + 0.2 * rng.uniform(-1, 1, (1, h, w, 3))
    return img.astype(np.float32)


def tiled_path(rt, seed: int):
    """The tiled phase on the decode phase's bf16 runtime: a seeded
    3840x2160 image through ``TiledCodec(rt, 768, 64)``. The container's
    header and 18 tiles; every tile stream decodes to its writer's plan
    (``write_plan`` of its device chunk) bit for bit; the stitched image
    is finite, of the image's shape, on the card, and equal bit for bit to
    ``rt.decode_batch`` of the same 18 streams wherever one tile alone
    covers a pixel at weight 1; a 768x768 image passes through to the
    runtime's own container and decode; launches as ``tiled_launches``.
    Prints encode and decode walls, tiles/s and peak memory. Returns the
    K1 and K2 launches of the phase's encodes and decodes."""
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1
    from onedc_tpu_torch.parallel.tiled import (
        MAGIC,
        TiledCodec,
        _ramp_weight,
        plan_tiles,
        split_container,
    )

    counts = (k1, k2)
    image = tiled_image(seed + 5)
    h, w = TILED_SIZE
    tc = TiledCodec(rt, TILED_TILE, TILED_OVERLAP)
    want = tiled_launches()
    k1.launches = 0
    k2.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (stream, info), got = counted(counts, lambda: tc.encode(image))
    enc_s = time.perf_counter() - t0
    if got != want["encode"]:
        raise AssertionError(f"4K encode launched K1/K2 {got}, expected "
                             f"{want['encode']}")
    if not stream.startswith(MAGIC):
        raise AssertionError("the 4K container lacks the ODTC magic")
    head, subs = split_container(stream)
    if len(stream) != len(MAGIC) + struct.calcsize(">HHHII") \
            + 4 * len(subs) + sum(map(len, subs)):
        raise AssertionError("the 4K container's lengths do not add up")
    corners = plan_tiles(h, w, TILED_TILE, TILED_OVERLAP)
    grid = (len({y for y, _ in corners}), len({x for _, x in corners}))
    if head != (TILED_TILE, *grid, h, w) or info["n_tiles"] != TILED_TILES \
            or len(subs) != TILED_TILES or len(corners) != TILED_TILES:
        raise AssertionError(f"4K container header {head}, {len(subs)} "
                             f"tiles, info {info}")
    t0 = time.perf_counter()
    out, got = counted(counts, lambda: tc.decode(stream=stream))
    dec_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if got != want["decode"]:
        raise AssertionError(f"4K decode launched K1/K2 {got}, expected "
                             f"{want['decode']}")
    if out.shape != (1, h, w, 3) or out.dtype != torch.float32 \
            or out.device.type != rt.device.type \
            or not torch.isfinite(out).all():
        raise AssertionError(f"4K decode: bad image {tuple(out.shape)} "
                             f"{out.dtype} {out.device}")
    small = np.ascontiguousarray(image[:, :TILED_TILE, :TILED_TILE])
    (single, _), got_enc = counted(counts, lambda: tc.encode(small))
    passed, got_dec = counted(counts, lambda: tc.decode(stream=single))
    got = tuple(a + b for a, b in zip(got_enc, got_dec))
    if got != want["pass_through"]:
        raise AssertionError(f"768x768 pass-through launched K1/K2 {got}")
    launches = {"K1": k1.launches, "K2": k2.launches}
    if single.startswith(MAGIC) or single != rt.encode(small)[0]:
        raise AssertionError("a 768x768 image did not pass through to the "
                             "runtime's container")
    if not torch.equal(passed, rt.decode(single)):
        raise AssertionError("the pass-through decode differs from the "
                             "runtime's")

    # every tile stream against its writer's plan: encode_many wrote the
    # tiles in device chunks of SERVING_CHUNK, in corner order
    tiles = np.concatenate([image[:, ty:ty + TILED_TILE, tx:tx + TILED_TILE]
                            for ty, tx in corners])
    for c0 in range(0, TILED_TILES, SERVING_CHUNK):
        plan = rt.write_plan(tiles[c0:c0 + SERVING_CHUNK])
        for j in range(min(SERVING_CHUNK, TILED_TILES - c0)):
            check_stream_decodes_to_plan(rt, subs[c0 + j], plan, j,
                                         f"4K tile {c0 + j}")
        del plan
    # the stitch against decode_batch of the same streams, where one tile
    # alone covers a pixel at its weight 1
    singles = rt.decode_batch(subs)
    weight = torch.from_numpy(_ramp_weight(TILED_TILE, TILED_OVERLAP)).to(
        rt.device)
    cover = torch.zeros((h, w), dtype=torch.int32, device=rt.device)
    for ty, tx in corners:
        cover[ty:ty + TILED_TILE, tx:tx + TILED_TILE] += 1
    checked = 0
    for (ty, tx), til in zip(corners, singles):
        mask = (weight == 1) & (cover[ty:ty + TILED_TILE,
                                      tx:tx + TILED_TILE] == 1)
        checked += int(mask.sum())
        if not torch.equal(out[0, ty:ty + TILED_TILE, tx:tx + TILED_TILE][
                mask], til[0][mask]):
            raise AssertionError(f"the stitched 4K image differs from "
                                 f"decode_batch's tile at ({ty}, {tx})")
    del singles
    timed = {"encode_s": [enc_s], "decode_s": [dec_s]}
    for _ in range(2):
        t0 = time.perf_counter()
        stream2, _ = tc.encode(image)
        timed["encode_s"].append(time.perf_counter() - t0)
        timed["decode_s"].append(
            _wall_ms(lambda: tc.decode(stream=stream2)) / 1e3)
    print(f"tiled: {w}x{h} in {TILED_TILES} tiles of {TILED_TILE} "
          f"(overlap {TILED_OVERLAP}): {len(stream)} bytes, "
          f"{info['bpp']:.5f} bpp ({info['bpp_tiles']:.5f} in the tiles); "
          f"every tile stream decodes to its plan; the stitch equals "
          f"decode_batch on {checked} pixels covered once at weight 1; "
          f"K1/K2 launches {tiled_launches()}", flush=True)
    print("tiled walls " + json.dumps({
        **timed,
        "encode_tiles_per_s": [TILED_TILES / t for t in timed["encode_s"]],
        "decode_tiles_per_s": [TILED_TILES / t for t in timed["decode_s"]],
        "peak_gib": peak}), flush=True)
    return launches


def data_mesh_launches():
    """(K1, K2) of one rank in the spatial phase's data-axis part: its
    ``encode_batch`` of its DATA_MESH_IMAGES / 2 rows (one device batch;
    rank 1's padding row with them) and its ``decode_batch`` of as many
    streams (pipelined)."""
    size = SPATIAL_SIZE
    rows = -(-DATA_MESH_IMAGES // SPATIAL_BANDS)
    encode = ENCODE_PER_CALL[size]
    decode = pipelined_launches(size, rows)
    return tuple(a + b for a, b in zip(encode, decode))


def _mesh_rank(rank: int, rendezvous: str, seed: int, stream: bytes,
               images: np.ndarray) -> dict:
    """One process of the spatial phase, on the one card: the seeded
    full-width bf16 runtime (the weights of the main process's), the
    stream decoded as a band of a tensor axis of SPATIAL_BANDS, then
    ``encode_batch`` and ``decode_batch`` of ``images`` over a data axis of
    SPATIAL_BANDS; launches counted around each; each stream this rank
    wrote decoded to its plan."""
    from onedc_tpu_torch.models.onedc import OneDC, OneDCRuntime
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1
    from onedc_tpu_torch.parallel.distributed import init_group
    from onedc_tpu_torch.parallel.mesh import make_mesh, rank_rows, real_rows
    from onedc_tpu_torch.parallel.spatial import enable_spatial_decode
    from onedc_tpu_torch.utils.numerics import pinned_numerics

    torch.cuda.set_device(0)
    init_group("gloo", rank, SPATIAL_BANDS,
               init_method=f"file://{rendezvous}")
    with torch.device("cuda"):
        model = OneDC()
    init_random_weights(model, seed)
    out = {}
    with pinned_numerics():
        bands = make_mesh("cuda", data=1, tensor=SPATIAL_BANDS)
        rt = enable_spatial_decode(OneDCRuntime(model, dtype=torch.bfloat16),
                                   bands)
        rt.decode(stream)  # first call: cuDNN plans, kernels loaded
        walls = []
        for i in range(3):
            torch.cuda.synchronize()
            k1.launches = k2.launches = 0
            t0 = time.perf_counter()
            image = rt.decode(stream)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                out["spatial_launches"] = (k1.launches, k2.launches)
        out["spatial_ms"] = walls
        if rank == 0:
            out["image"] = image.cpu()
        data = make_mesh("cuda", data=SPATIAL_BANDS, tensor=1)
        rtd = OneDCRuntime(model, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        k1.launches = k2.launches = 0
        t0 = time.perf_counter()
        written = rtd.encode_batch(images, mesh=data)
        streams = [s for s, _ in written]
        decoded = rtd.decode_batch(streams, mesh=data)
        torch.cuda.synchronize()
        out["data_ms"] = (time.perf_counter() - t0) * 1e3
        out["data_launches"] = (k1.launches, k2.launches)
        if len(decoded) != len(images) or any(
                d.shape != (1, *SPATIAL_SIZE, 3)
                or not torch.isfinite(d).all() for d in decoded):
            raise AssertionError(f"rank {rank}: decode_batch over the data "
                                 f"axis returned a bad image")
        rows = rank_rows(len(images), data)
        plan = rtd.write_plan(images[rows])
        for j in range(real_rows(len(images), data)):
            check_stream_decodes_to_plan(rtd, streams[rows[j]], plan, j,
                                         f"rank {rank} row {rows[j]}")
        out["streams"] = [len(x) for x in streams]
        out["checked_rows"] = rows[:real_rows(len(images), data)]
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return out


def _mesh_rank_entry(rank, tmp, seed, stream, images):
    out = _mesh_rank(rank, f"{tmp}/rendezvous", seed, stream, images)
    torch.save(out, f"{tmp}/rank{rank}.pt")


def spatial_path(rt, seed: int):
    """The spatial phase: a SPATIAL_SIZE stream written with the main
    runtime's programs, decoded once whole by ``rt`` and once by
    SPATIAL_BANDS processes (``parallel/spatial.py``: rows split over the
    ``tensor`` axis, all-gathered), the two images within the BATCH_*
    limits; each band's K1 / K2 launches as the "spatial768" tables give
    them; then the data axis's batch codecs (``_mesh_rank``). Returns the
    phase's K1 / K2 launches by path."""
    import torch.multiprocessing as mp

    h, w = SPATIAL_SIZE
    stream, _, _ = write_synthetic_stream(rt, h, w, seed + 50)
    single = rt.decode(stream)
    torch.cuda.synchronize()
    images = next(synthetic_batches(seed + 51, DATA_MESH_IMAGES, h))["image"]
    tmp = Path(tempfile.mkdtemp(prefix="onedc_spatial_"))
    t0 = time.perf_counter()
    try:
        mp.spawn(_mesh_rank_entry, nprocs=SPATIAL_BANDS,
                 args=(str(tmp), seed, stream, images))
        results = [torch.load(tmp / f"rank{r}.pt")
                   for r in range(SPATIAL_BANDS)]
    finally:
        shutil.rmtree(tmp)
    wall_s = time.perf_counter() - t0
    image = results[0]["image"].to(single.device)
    diff = (image - single).float()
    rel_l2 = (diff.norm() / single.float().norm()).item()
    rel_max = (diff.abs().max() / single.abs().max()).item()
    per_band = (sum(n for _, n in K1_SHAPES["spatial768"]),
                sum(n for _, n in K2_SHAPES["spatial768"]))
    print(f"spatial: {h}x{w} over {SPATIAL_BANDS} bands (gloo, one card) "
          f"against the single decode: relative L2 {rel_l2:.3e} (tol "
          f"{BATCH_REL_L2_TOL}), max {rel_max:.3e} of max|ref| (tol "
          f"{BATCH_MAX_TOL}); K1/K2 launches by band "
          f"{[r['spatial_launches'] for r in results]} (each {per_band}); "
          f"band decode wall ms {[r['spatial_ms'] for r in results]}; "
          f"data axis: encode_batch + decode_batch of {DATA_MESH_IMAGES} "
          f"images {[round(r['data_ms'], 1) for r in results]} ms, K1/K2 "
          f"{[r['data_launches'] for r in results]} (each "
          f"{data_mesh_launches()}), rows checked against their plans "
          f"{[r['checked_rows'] for r in results]}; the phase's processes "
          f"{wall_s:.1f} s", flush=True)
    if not (rel_l2 <= BATCH_REL_L2_TOL and rel_max <= BATCH_MAX_TOL):
        raise AssertionError("the spatial decode disagrees with the single "
                             "decode")
    for r in results:
        if r["spatial_launches"] != per_band:
            raise AssertionError(f"a band launched K1/K2 "
                                 f"{r['spatial_launches']}, expected "
                                 f"{per_band}")
        if r["data_launches"] != data_mesh_launches():
            raise AssertionError(f"a data rank launched K1/K2 "
                                 f"{r['data_launches']}, expected "
                                 f"{data_mesh_launches()}")
    if sorted(j for r in results for j in r["checked_rows"]) != list(
            range(DATA_MESH_IMAGES)):
        raise AssertionError("not every stream was checked by its writer")
    return ({"K1": sum(r["spatial_launches"][0] for r in results),
             "K2": sum(r["spatial_launches"][1] for r in results)},
            {"K1": sum(r["data_launches"][0] for r in results),
             "K2": sum(r["data_launches"][1] for r in results)})


def train_loop_path(seed: int):
    """The training-loop phase: ``train.trainer.main`` on
    configs/train_stage1.yaml with ``train_overrides`` (a seeded random
    LPIPS file), seeded 1024x1024 training PNGs and 512x768 eval PNGs in a
    temporary folder, TRAIN_LOOP_STEPS steps logged every step, eval and a
    checkpoint at TRAIN_LOOP_SAVE (``max_checkpoint`` 1); then ``main
    --resume`` on the same run directory in a fresh trainer, from the
    checkpoint to the end. Checks: finite train and eval metrics with the
    LPIPS term > 0; ``config.yaml``, the checkpoint and
    ``checkpoints_best/``; the resumed run's parameters, AdamW moments,
    step and count equal the uninterrupted run's bit for bit (its state
    kept on the host); device memory back to its level before the first
    trainer once it is dropped (no collector run); enough free disk for
    two checkpoints first. Prints the checkpoint's bytes, save and restore
    seconds, s/step and peak memory. Returns each kernel's launches over
    both runs."""
    from onedc_tpu_torch.config import load_config
    from onedc_tpu_torch.data.images import save_image
    from onedc_tpu_torch.models.onedc import OneDC
    from onedc_tpu_torch.nn.lpips import random_lpips_weights
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1
    from onedc_tpu_torch.train import trainer as tr
    from onedc_tpu_torch.train.step import split_frozen
    from onedc_tpu_torch.utils.logging import read_metrics
    from onedc_tpu_torch.utils.safetensors import save_safetensors

    tmp = Path(tempfile.mkdtemp(prefix="onedc_train_loop_"))
    try:
        rng = np.random.default_rng(seed + 11)
        for sub, n, (hh, ww) in (("train", TRAIN_LOOP_TRAIN, (1024, 1024)),
                                 ("eval", TRAIN_LOOP_EVAL, (512, 768))):
            (tmp / sub).mkdir()
            for i in range(n):
                img = next(synthetic_batches(int(rng.integers(1 << 30)), 1,
                                             1024))["image"][0, :hh, :ww]
                save_image(img, tmp / sub / f"{sub}{i}.png")
        save_safetensors(random_lpips_weights(seed), tmp / "lpips.safetensors")
        run = tmp / "run"
        overrides = dict(train_overrides(tmp / "lpips.safetensors"),
                         train_data=str(tmp / "train"),
                         eval_data=str(tmp / "eval"), run_dir=str(run),
                         total_steps=TRAIN_LOOP_STEPS,
                         save_interval=TRAIN_LOOP_SAVE, log_interval=1,
                         max_checkpoint=1)
        argv = ["--config", "configs/train_stage1.yaml"] + [
            f"{k}={json.dumps(v)}" for k, v in overrides.items()]
        cfg = load_config("configs/train_stage1.yaml", overrides)
        with torch.device("meta"):
            meta_model = OneDC(**cfg["model"])
        n_all = sum(p.numel() for p in meta_model.parameters())
        n_train = sum(p.numel() for _, p in split_frozen(
            meta_model, tuple(cfg["frozen"]))[0])
        del meta_model
        need = 2 * 4 * (n_all + 2 * n_train)
        free = shutil.disk_usage(tmp).free
        print(f"train loop: checkpoint of {n_all / 1e9:.3f} B parameters "
              f"and {2 * n_train / 1e9:.3f} B moments, "
              f"{4 * (n_all + 2 * n_train) / 1e9:.2f} GB; "
              f"{free / 1e9:.1f} GB free", flush=True)
        if free < need:
            raise AssertionError(f"{free / 1e9:.1f} GB free under {tmp}, "
                                 f"{need / 1e9:.1f} GB needed")

        counters = ((k1, "launches"), (k1, "bwd_launches"), (k2, "launches"),
                    (k2, "conv_launches"))
        for mod, attr in counters:
            setattr(mod, attr, 0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        whole = tr.main(argv)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tensors, meta = whole.checkpoint_state()
        t0 = time.perf_counter()
        want = {k: v.cpu() for k, v in tensors.items()}
        host_s = time.perf_counter() - t0
        del tensors, whole
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - base
        print(f"train loop: uninterrupted run {whole_s:.1f} s, peak "
              f"{peak:.2f} GiB; its state to the host in {host_s:.1f} s; "
              f"device memory after the trainer is dropped: {left / 2**20:+.1f}"
              f" MiB against before it", flush=True)
        if left > 256 * 2 ** 20:
            raise AssertionError(f"a dropped trainer still holds "
                                 f"{left / 2**30:.2f} GiB of device memory")
        for name in ("config.yaml", f"checkpoint_model_{TRAIN_LOOP_SAVE:06d}"
                     "/state.safetensors", "checkpoints_best/state.safetensors"):
            if not (run / name).exists():
                raise AssertionError(f"the run directory lacks {name}")

        t0 = time.perf_counter()
        resumed = tr.main(argv + ["--resume"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        tensors, meta_r = resumed.checkpoint_state()
        if meta_r != meta or sorted(tensors) != sorted(want):
            raise AssertionError(f"resumed state {meta_r}, uninterrupted "
                                 f"{meta}")
        differ = [k for k, v in tensors.items()
                  if not torch.equal(v.cpu(), want[k])]
        if differ:
            raise AssertionError(f"{len(differ)} of {len(want)} tensors of "
                                 f"the resumed run differ from the "
                                 f"uninterrupted run's, e.g. {differ[:4]}")
        del tensors, resumed, want
        got = tuple(getattr(m, a) for m, a in counters)

        rows = read_metrics(run)
        train = [r for r in rows if "train/pix" in r]
        evals = [r for r in rows if "eval/total_loss" in r]
        ckpt = [r for r in rows if any(k.startswith("checkpoint/")
                                       for k in r)]
        if [r["step"] for r in train] != list(range(1, TRAIN_LOOP_STEPS + 1)) \
                + list(range(TRAIN_LOOP_SAVE + 1, TRAIN_LOOP_STEPS + 1)) \
                or [r["step"] for r in evals] != [TRAIN_LOOP_SAVE]:
            raise AssertionError(f"metrics.jsonl rows {rows}")
        for r in train + evals + ckpt:
            bad = {k: v for k, v in r.items() if not np.isfinite(v)}
            if bad:
                raise AssertionError(f"step {r['step']}: {bad}")
        for r, key in [(r, "train/lpips") for r in train] + \
                [(evals[0], "eval/lpips")]:
            if not r[key] > 0:
                raise AssertionError(f"step {r['step']}: {key} {r[key]}")
    finally:
        shutil.rmtree(tmp)
    want_launches = train_loop_launches()
    print(f"train loop: resumed run {resume_s:.1f} s; the resumed state "
          f"equals the uninterrupted run's bit for bit ({meta}); "
          f"K1/K1-bwd/K2/K3 launches {got}, expected {want_launches}",
          flush=True)
    print("train loop records " + json.dumps({
        "checkpoint": ckpt, "sec_per_step": [
            (r["step"], r["train/sec_per_step"]) for r in train],
        "eval": evals[0], "peak_gib": peak}), flush=True)
    if got != want_launches:
        raise AssertionError(f"train loop launches {got}, expected "
                             f"{want_launches}")
    return {"K1": got[0], "K1-bwd": got[1], "K2": got[2], "K3": got[3]}


class _NoUpdate:
    """An optimizer that applies nothing: a step's gradients stay in
    ``.grad`` for the stage-I phase's checks."""

    count = 0

    def step(self) -> None:
        pass


def _grad_copies(model) -> dict:
    """Each gradient, whole: under the phase's FSDP over one process a
    shard is the whole tensor."""
    from onedc_tpu_torch.parallel.fsdp import local

    return {n: local(p.grad).detach().clone()
            for n, p in model.named_parameters() if p.grad is not None}


def _grad_rel_l2(got: dict, want: dict):
    """(||got - want|| / ||want|| over all the tensors together, tensors
    bit-identical, tensors); the same names on both sides."""
    if sorted(got) != sorted(want):
        raise AssertionError("the gradients cover other parameters")
    diff = sum(float((got[n].double() - want[n].double()).pow(2).sum())
               for n in want)
    norm = sum(float(want[n].double().pow(2).sum()) for n in want)
    same = sum(bool(torch.equal(got[n], want[n])) for n in want)
    return (diff / norm) ** 0.5, same, len(want)


def adafactor_card_against_cpu(model, names, cfg) -> float:
    """One Adafactor update of the parameters ``names`` (their live values
    and gradients) on the card and on the CPU, at a learning rate of 1 (at
    the run's 5e-5 a parameter's own rounding, 1 ulp of p, is 1e-4 of the
    step: p - lr * u then rounds the same update differently on the two
    sides): the largest relative L2 of the two steps' difference and of
    the two states' difference."""
    from onedc_tpu_torch.parallel.fsdp import local
    from onedc_tpu_torch.train.step import Adafactor

    named = dict(model.named_parameters())
    sides = {}
    for device in ("cuda", "cpu"):
        params = []
        for n in names:
            # under the phase's FSDP over one process a shard is the whole
            p = torch.nn.Parameter(local(named[n]).detach().to(device,
                                                               copy=True))
            p.grad = local(named[n].grad).detach().to(device, copy=True)
            params.append(p)
        opt = Adafactor(params, 1.0, int(cfg["warmup_steps"]),
                        float(cfg["grad_clip"]))
        opt.count = int(cfg["warmup_steps"])
        before = [p.detach().clone() for p in params]
        opt.step()
        sides[device] = ([(p.detach() - b).cpu() for p, b in
                          zip(params, before)],
                         [t.cpu() for t in opt.named_state(names).values()])
    worst = 0.0
    for got, want in zip(sides["cuda"], sides["cpu"]):
        for a, b in zip(got, want):
            worst = max(worst, ((a - b).norm() / b.norm()).item())
    print(f"stage1: Adafactor update of {len(names)} tensors ({names}) on "
          f"the card against the CPU: largest relative L2 {worst:.3e} (tol "
          f"{STAGE1_ADAFACTOR_TOL})", flush=True)
    if not worst <= STAGE1_ADAFACTOR_TOL:
        raise AssertionError("an Adafactor update on the card disagrees with "
                             "the CPU's")
    return worst


def stage1_checks(trainer, seed: int) -> dict:
    """The stage-I phase's checks on one batch of two seeded 512x512 images
    with one noise draw, the gradients read with an optimizer that applies
    nothing: remat against no remat (and no remat against itself, the
    card's run-to-run spread); ``grad_accum`` 2 against the mean of its
    micro-batches run alone and against one batch of 2; then one Adafactor
    update on the card against the CPU."""
    from onedc_tpu_torch.train.step import TrainState, make_train_step

    model = trainer.model
    images = torch.from_numpy(next(synthetic_batches(seed + 13, 2, 512))[
        "image"]).to("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    noise = model.bit_noise(images, gen)
    state = TrainState(model, _NoUpdate(), trainer.frozen)
    weight, mse_weight = trainer.codeformer_weights

    def grads_of(remat: bool, accum: int = 1, rows=slice(None)):
        step = make_train_step(trainer.loss, accum, remat=remat,
                               codeformer_loss_weight=weight,
                               codeformer_mse_weight=mse_weight)
        metrics = step(state, {"image": images[rows]}, noise=noise[rows])
        return metrics, _grad_copies(model)

    m_plain, plain = grads_of(remat=False)
    _, again = grads_of(remat=False)
    spread, same_again, n = _grad_rel_l2(again, plain)
    del again
    m_remat, remat = grads_of(remat=True)
    remat_err, same_remat, _ = _grad_rel_l2(remat, plain)
    print(f"stage1: gradients with remat against without, 512x512 batch 2: "
          f"relative L2 {remat_err:.3e} (tol {STAGE1_REMAT_TOL}), "
          f"{same_remat} of {n} tensors bit-identical; without remat twice: "
          f"{spread:.3e}, {same_again} of {n} bit-identical", flush=True)
    if not remat_err <= STAGE1_REMAT_TOL:
        raise AssertionError("remat changes the gradients")
    del plain
    m_accum, accum = grads_of(remat=True, accum=2)
    accum_err, _, _ = _grad_rel_l2(accum, remat)
    keys = ("total_loss", "pix", "lpips", "bpp", "codeformer_ce_loss",
            "codeformer_mse_loss", "grad_norm")
    metric_errs = {k: abs(m_accum[k] - m_remat[k]) / abs(m_remat[k])
                   for k in keys}
    metric_err = max(metric_errs.values())
    del remat
    singles = [grads_of(remat=True, rows=slice(i, i + 1)) for i in (0, 1)]
    mean = {n: (singles[0][1][n] + singles[1][1][n]) * 0.5
            for n in singles[0][1]}
    micro_err, same_micro, _ = _grad_rel_l2(accum, mean)
    micro_metric_err = max(
        abs(m_accum[k] - (singles[0][0][k] + singles[1][0][k]) / 2)
        / abs(m_accum[k]) for k in keys if k != "grad_norm")
    del singles, mean, accum
    print(f"stage1: grad_accum 2 against the mean of its micro-batches run "
          f"alone: gradients relative L2 {micro_err:.3e} (tol "
          f"{STAGE1_MICRO_TOL}), {same_micro} of {n} tensors bit-identical, "
          f"metrics relative {micro_metric_err:.3e} (tol "
          f"{STAGE1_MICRO_METRIC_TOL}); against one batch of 2: gradients "
          f"{accum_err:.3e} (tol {STAGE1_ACCUM_TOL}), metrics "
          f"{metric_err:.3e} (tol {STAGE1_ACCUM_METRIC_TOL}), by metric "
          f"{json.dumps(metric_errs)}; no-remat metrics "
          f"{json.dumps(m_plain)}", flush=True)
    if not (micro_err <= STAGE1_MICRO_TOL
            and micro_metric_err <= STAGE1_MICRO_METRIC_TOL
            and accum_err <= STAGE1_ACCUM_TOL
            and metric_err <= STAGE1_ACCUM_METRIC_TOL):
        raise AssertionError("grad_accum 2 disagrees with its micro-batches "
                             "or with one batch of 2")
    # a factored conv, a factored dense layer, the Swin position embedding
    # (factored, 256 x 256), an unfactored depthwise conv and a bias
    names = ["unet.down_blocks_1.resnets_0.conv1.weight",
             "unet.down_blocks_0.attentions_0.transformer_blocks_0.attn1."
             "to_q.weight",
             "codeformer.swin0.block_w.attn.pos_embedding",
             "codec.y_spatial_prior_adaptor_1.dc.depth_conv.weight",
             "unet.down_blocks_0.resnets_0.conv1.bias"]
    worst = adafactor_card_against_cpu(model, names, trainer.cfg)
    model.zero_grad(set_to_none=True)
    return dict(remat_rel_l2=remat_err, remat_bit_identical=same_remat,
                no_remat_spread=spread, tensors=n, micro_rel_l2=micro_err,
                micro_bit_identical=same_micro,
                micro_metric_rel=micro_metric_err, accum_rel_l2=accum_err,
                accum_metric_rel=metric_err, adafactor_rel_l2=worst)


def _host_state(trainer):
    """(the trainer's checkpoint tensors on the host, FSDP shards gathered
    whole; its metadata)."""
    tensors, meta = trainer.checkpoint_state()
    return {k: (v.full_tensor() if isinstance(v, DTensor) else v
                ).detach().cpu().clone() for k, v in tensors.items()}, meta


def stage1_resume(argv, want: dict, want_meta: dict, run_dir: Path) -> dict:
    """``trainer.main(argv + ["--resume"])``: a fresh FSDP trainer restores
    the STAGE1_SAVE checkpoint and runs the last step again; every tensor
    of its state equals the uninterrupted run's bit for bit. Returns the
    checkpoint's bytes, save and restore seconds and the resumed run's
    peak."""
    from onedc_tpu_torch.train import trainer as tr
    from onedc_tpu_torch.utils.logging import read_metrics

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resumed = tr.main(list(argv) + ["--resume"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    got, meta = _host_state(resumed)
    del resumed
    torch.cuda.empty_cache()
    if meta != want_meta or sorted(got) != sorted(want):
        raise AssertionError(f"resumed state {meta} against {want_meta}")
    moved = [k for k in want if not torch.equal(got[k], want[k])]
    rows = read_metrics(run_dir)
    save = next(r for r in rows if "checkpoint/save_s" in r)
    restore = next(r for r in rows if "checkpoint/restore_s" in r)
    out = dict(bytes=int(save["checkpoint/bytes"]),
               save_s=save["checkpoint/save_s"],
               restore_s=restore["checkpoint/restore_s"],
               resumed_wall_s=wall_s,
               resumed_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               tensors=len(want))
    print(f"stage1: checkpoint of step {STAGE1_SAVE} ({out['bytes']} bytes) "
          f"saved in {out['save_s']:.2f} s, restored in "
          f"{out['restore_s']:.2f} s by a fresh FSDP trainer, which ran the "
          f"last step again in {wall_s:.1f} s (build included): "
          f"{len(want) - len(moved)} of {len(want)} tensors bit-identical "
          f"to the uninterrupted run's", flush=True)
    if moved:
        raise AssertionError(f"the resumed run differs: {moved[:4]}")
    return out


def stage1_yaml_path(seed: int):
    """The stage-I yaml phase: ``train.trainer.main`` on
    configs/train_stage1.yaml as shipped (Adafactor, the Codeformer with
    frozen [vae, vqgan], batch 8, remat, the Codeformer loss weights), with
    STAGE1_OVERRIDES, a seeded random LPIPS file, STAGE1_TRAIN_IMAGES seeded
    1024x1024 training PNGs, no eval folder and a temporary run directory:
    STAGE1_STEPS steps at 512x512 batch 8 and 1024x1024 batch 2, seen
    through a wrapper of ``Trainer.train_one_step`` (s/step, peak memory,
    launches as ``stage1_per_step``, finite metrics, the first step's
    Codeformer CE against ln 1024, the frozen VAE and VQGAN bit-identical
    across the steps). Then, on the same trainer: 512x512 batch-8 steps
    with remat, without it and with it again, each from freed gradients
    and an emptied cache, for remat's peak and time at one point of the
    process (an OOM is reported, not raised), and ``stage1_checks``. Returns each kernel's launches over ``main``'s steps
    and the phase's records."""
    from onedc_tpu_torch.data.crops import MultiResolutionCrop
    from onedc_tpu_torch.data.images import save_image
    from onedc_tpu_torch.nn.lpips import random_lpips_weights
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1
    from onedc_tpu_torch.train import trainer as tr
    from onedc_tpu_torch.train.step import make_train_step
    from onedc_tpu_torch.utils.safetensors import save_safetensors

    counters = ((k1, "launches"), (k1, "bwd_launches"), (k2, "launches"),
                (k2, "conv_launches"))
    crop = MultiResolutionCrop(STAGE1_OVERRIDES["resolutions"],
                               STAGE1_OVERRIDES["batch_scales"])
    records, frozen_before, remat = [], {}, [True]
    step_fn = tr.Trainer.train_one_step

    def observed(self, step):
        if not records:
            frozen_before.update(
                {n: p.detach().clone() for n, p in
                 self.model.named_parameters()
                 if n.split(".")[0] in ("vae", "vqgan")})
        before = tuple(getattr(m, a) for m, a in counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = step_fn(self, step)
        torch.cuda.synchronize()
        res, scale = crop.pick(step)
        records.append(dict(
            step=step, res=res, batch=max(1, round(self.batch_size * scale)),
            wall_s=time.perf_counter() - t0,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches=tuple(getattr(m, a) - b
                           for (m, a), b in zip(counters, before)),
            remat=remat[0], **metrics))
        r = records[-1]
        print(f"stage1 step {step} ({res}x{res} batch {r['batch']}, remat "
              f"{r['remat']}): {r['wall_s']:.3f} s, peak {r['peak_gib']:.2f}"
              f" GiB, K1/K1-bwd/K2/K3 launches {r['launches']}; "
              + json.dumps(metrics), flush=True)
        return metrics

    tmp = Path(tempfile.mkdtemp(prefix="onedc_stage1_"))
    try:
        rng = np.random.default_rng(seed + 17)
        (tmp / "train").mkdir()
        for i in range(STAGE1_TRAIN_IMAGES):
            img = next(synthetic_batches(int(rng.integers(1 << 30)), 1,
                                         1024))["image"][0]
            save_image(img, tmp / "train" / f"train{i}.png")
        save_safetensors(random_lpips_weights(seed), tmp / "lpips.safetensors")
        overrides = dict(STAGE1_OVERRIDES,
                         lpips_weights=str(tmp / "lpips.safetensors"),
                         train_data=str(tmp / "train"), eval_data=None,
                         run_dir=str(tmp / "run"), total_steps=STAGE1_STEPS,
                         log_interval=1, save_interval=STAGE1_SAVE,
                         max_checkpoint=1)
        for key, value in overrides.items():
            print(f"stage1 override: {key} = {value!r}", flush=True)
        argv = ["--config", "configs/train_stage1.yaml"] + [
            f"{k}={json.dumps(v)}" for k, v in overrides.items()]
        for mod, attr in counters:
            setattr(mod, attr, 0)
        tr.Trainer.train_one_step = observed
        try:
            trainer = tr.main(argv)
        finally:
            tr.Trainer.train_one_step = step_fn
        got = tuple(getattr(m, a) for m, a in counters)
        # the uninterrupted run's state at its last step, for the resume
        want_state, want_meta = _host_state(trainer)
        cfg = trainer.cfg
        opt = trainer.state.optimizer
        sharded = sum(isinstance(p, DTensor) for p in opt.params)
        print(f"stage1: fsdp {cfg['fsdp']}: {sharded} of {len(opt.params)} "
              f"trainable tensors sharded over a mesh of "
              f"{trainer.mesh['data'].size()} ({torch.distributed.get_backend()}"
              f"), {len(trainer.replicated)} replicated with gradients",
              flush=True)
        if not (cfg["fsdp"] and sharded):
            raise AssertionError("the phase does not run the yaml's FSDP")
        state_bytes = sum(t.numel() * t.element_size() for t in
                          opt.named_state(trainer.trainable_names).values())
        trainable_bytes = sum(p.numel() * p.element_size()
                              for p in opt.params)
        print(f"stage1: optimizer {type(opt).__name__}, frozen "
              f"{trainer.frozen}, gradient_checkpointing "
              f"{cfg.get('gradient_checkpointing', True)}, codeformer "
              f"weights {trainer.codeformer_weights}; its state "
              f"{state_bytes} bytes for {len(opt.params)} trainable tensors "
              f"of {trainable_bytes} bytes (AdamW's two moments: "
              f"{2 * trainable_bytes})", flush=True)
        if (type(trainer.state.optimizer).__name__ != "Adafactor"
                or trainer.frozen != ("vae", "vqgan")
                or not cfg["model"]["use_codeformer"]):
            raise AssertionError("the phase does not run the yaml's recipe")
        for r in records:
            if r["launches"] != stage1_per_step(r["res"]):
                raise AssertionError(f"step {r['step']}: launches "
                                     f"{r['launches']}, expected "
                                     f"{stage1_per_step(r['res'])}")
            bad = {k: v for k, v in r.items()
                   if isinstance(v, float) and not np.isfinite(v)}
            if bad:
                raise AssertionError(f"step {r['step']}: {bad}")
            if not r["lpips"] > 0:
                raise AssertionError(f"step {r['step']}: lpips {r['lpips']}")
        ce = records[0]["codeformer_ce_loss"]
        print(f"stage1: first step's codeformer_ce_loss {ce:.4f}, ln 1024 = "
              f"{np.log(1024):.4f}", flush=True)
        if not 2.0 < ce < 20.0:
            raise AssertionError(f"codeformer_ce_loss {ce}")
        named = dict(trainer.model.named_parameters())
        moved = [n for n, t in frozen_before.items()
                 if not torch.equal(t, named[n])]
        if moved:
            raise AssertionError(f"frozen tensors moved: {moved[:4]}")
        n_vqgan = sum(n.startswith("vqgan.") for n in frozen_before)
        print(f"stage1: VAE and VQGAN, all {len(frozen_before)} tensors "
              f"({n_vqgan} of the VQGAN), bit-identical after "
              f"{len(records)} steps", flush=True)
        frozen_before.clear()
        # the optimizer's share of a step: one more Adafactor update on
        # the last step's gradients, timed alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
        print(f"stage1: one Adafactor update of the {len(opt.params)} "
              f"trainable tensors: {update_s * 1e3:.1f} ms", flush=True)
        want = stage1_launches()
        if got != want:
            raise AssertionError(f"stage1 launches {got}, expected {want}")

        # remat's memory: 512x512 batch-8 steps at one point of the
        # process, with remat, without it and with it again, each from
        # freed gradients and an emptied cache (the peak is reset in
        # ``observed``); without remat the launches are the forward's
        # alone (no recompute)
        step512 = next(s for s in range(STAGE1_STEPS, STAGE1_STEPS + 64)
                       if crop.pick(s)[0] == 512)
        paired = {}
        for key, on in (("remat", True), ("no_remat", False),
                        ("remat_again", True)):
            trainer.step_fn = make_train_step(
                trainer.loss, trainer.grad_accum, remat=on,
                codeformer_loss_weight=trainer.codeformer_weights[0],
                codeformer_mse_weight=trainer.codeformer_weights[1])
            remat[0] = on
            trainer.model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            try:
                observed(trainer, step512)
            except torch.cuda.OutOfMemoryError as err:
                print(f"stage1: a 512x512 batch-8 step with remat {on} runs "
                      f"out of the card's memory: "
                      f"{str(err).splitlines()[0]}", flush=True)
                continue
            paired[key] = records[-1]
            expected = (stage1_per_step(512) if on
                        else STAGE1_PER_FORWARD[512])
            if paired[key]["launches"] != expected:
                raise AssertionError(f"{key} step: launches "
                                     f"{paired[key]['launches']}, expected "
                                     f"{expected}")
        trainer.model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        checks = stage1_checks(trainer, seed)
        del trainer, opt
        torch.cuda.empty_cache()
        resume = stage1_resume(argv, want_state, want_meta, tmp / "run")
        del want_state
    finally:
        shutil.rmtree(tmp)
    torch.cuda.empty_cache()
    by_res = {}
    for r in records[:STAGE1_STEPS]:
        by_res.setdefault(r["res"], []).append(r)
    summary = {res: dict(batch=rs[0]["batch"],
                         s_per_step=[round(r["wall_s"], 4) for r in rs],
                         peak_gib=max(r["peak_gib"] for r in rs))
               for res, rs in by_res.items()}
    print(f"stage1: by resolution {json.dumps(summary)}", flush=True)
    print("stage1: 512x512 batch 8 at one point of the process, peak and "
          "wall: " + "; ".join(
              f"{key} " + (f"{paired[key]['peak_gib']:.4f} GiB, "
                           f"{paired[key]['wall_s']:.3f} s"
                           if key in paired else "out of memory")
              for key in ("remat", "no_remat", "remat_again")), flush=True)
    print("stage1 records " + json.dumps(dict(
        steps=records, by_resolution=summary, checks=checks,
        paired_512={k: dict(peak_gib=r["peak_gib"], wall_s=r["wall_s"])
                    for k, r in paired.items()}, resume=resume,
        adafactor_update_s=update_s, optimizer_state_bytes=state_bytes,
        trainable_bytes=trainable_bytes)), flush=True)
    print(f"stage1: K1/K1-bwd/K2/K3 launches {got}, expected {want}",
          flush=True)
    return {"K1": got[0], "K1-bwd": got[1], "K2": got[2], "K3": got[3]}


def stage2_per_step(gen_turn: bool):
    """(K1, K1-bwd, K2, K3) launches of one stage-II yaml step (remat on,
    as the yaml leaves it). The generator turn: the OneDC forward's UNet
    (STAGE2_UNET_K1, again in the recompute), the DM loss's fake and real
    UNets (no autograd; the real UNet's CFG is one launch of 2B rows), the
    GAN logit's down path of the fake UNet, whose K1-bwd carries the
    gradient to the latents; the VAE encoder's K2, the decoder's K2 (again
    in the recompute) and K3. Other steps: the latents alone (the VAE
    encoder and the UNet, no decode). Every step's guidance turn: the
    critic's UNet forward and two GAN logits, all again in the recompute,
    and their backward."""
    unet, down = STAGE2_UNET_K1, STAGE2_DOWN_K1
    guid = unet + 2 * down
    if gen_turn:
        return (4 * unet + down + 2 * guid, unet + down + guid,
                STAGE2_ENC_K2 + 2 * STAGE2_DEC_K2, STAGE2_DEC_K2)
    return unet + 2 * guid, guid, STAGE2_ENC_K2, 0


def stage2_launches(ratio: int = 10):
    """(K1, K1-bwd, K2, K3) of the stage-II phase: the uninterrupted run's
    STAGE2_STEPS steps and eval epoch (STAGE2_EVAL_IMAGES images at
    STAGE2_SIZE, as EVAL_PER_IMAGE), the resumed run's steps from
    STAGE2_SAVE."""
    steps = list(range(STAGE2_STEPS)) + list(range(STAGE2_SAVE,
                                                   STAGE2_STEPS))
    per = [stage2_per_step(s % ratio == 0) for s in steps]
    per += [EVAL_PER_IMAGE[(STAGE2_SIZE, STAGE2_SIZE)]] * STAGE2_EVAL_IMAGES
    return tuple(map(sum, zip(*per)))


def _fingerprints(tensors) -> torch.Tensor:
    """Per tensor the sum of its f32 bit patterns as int64 (on the host): a
    tensor whose bits moved almost surely sums otherwise."""
    return torch.stack([t.detach().view(torch.int32).sum(dtype=torch.int64)
                        for t in tensors]).cpu()


def stage2_path(seed: int):
    """The stage-II phase: ``train.trainer_stage2.main`` on
    configs/train_stage2.yaml as shipped (three full SD1.5 UNets beside the
    OneDC generator and the CLIP text encoder, AdamW on both turns, remat,
    512x512 batch 4) with only the data and run directories, a seeded
    random LPIPS file and the step count set, each printed; seeded
    512x512 training and eval PNGs in a temporary folder. Steps seen
    through a wrapper of ``Stage2Trainer.train_one_step``: s/step by turn,
    peak memory, launches as ``stage2_per_step``, finite losses, which
    tensors moved (the generator's moments on generator turns only and
    its parameters never in steps 0-2: the first update has lr 0; the
    critic's moments every step, its parameters from step 1), a finite
    non-zero gradient on the fake UNet's first ``attn1.to_q`` (only K1-bwd
    carries it there). Then the frozen VAE, codec and real UNet bit for bit
    as before the first step; the real UNet's CFG as one batch against its
    two forwards (STAGE2_CFG_TOL); the text encoder's ms; ``--resume`` in a
    fresh trainer from the checkpoint at STAGE2_SAVE, equal to the
    uninterrupted run bit for bit. Returns each kernel's launches over
    both runs."""
    from onedc_tpu_torch.config import load_config
    from onedc_tpu_torch.data.images import save_image
    from onedc_tpu_torch.nn.lpips import random_lpips_weights
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1
    from onedc_tpu_torch.train import trainer_stage2 as t2
    from onedc_tpu_torch.utils.logging import read_metrics
    from onedc_tpu_torch.utils.safetensors import save_safetensors

    counters = ((k1, "launches"), (k1, "bwd_launches"), (k2, "launches"),
                (k2, "conv_launches"))
    records, frozen_before = [], {}
    step_fn = t2.Stage2Trainer.train_one_step

    def groups(tr):
        out = {}
        for tag, st, names in (("gen", tr.gen_state, tr.names["gen"]),
                               ("guid", tr.guid_state, tr.names["guid"])):
            out[f"{tag}_params"] = st.optimizer.params
            out[f"{tag}_moments"] = list(
                st.optimizer.named_state(names).values())
        return out

    def observed(self, step):
        if not frozen_before:
            named = dict(self.onedc.named_parameters())
            named.update({f"guidance.{n}": p for n, p in
                          self.guidance.named_parameters()})
            frozen_before.update({
                n: p.detach().cpu() for n, p in named.items()
                if n.split(".")[0] in ("vae", "codec")
                or n.startswith("guidance.real_unet.")})
        before_fp = {k: _fingerprints(v) for k, v in groups(self).items()}
        before = tuple(getattr(m, a) for m, a in counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = step_fn(self, step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = tuple(getattr(m, a) - b
                         for (m, a), b in zip(counters, before))
        moved = {k: int((_fingerprints(v) != before_fp[k]).sum())
                 for k, v in groups(self).items()}
        grad = dict(self.guidance.named_parameters())[FAKE_ATTN1].grad
        records.append(dict(
            step=step, gen_turn=step % self.update_ratio == 0, wall_s=wall,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches=launches, moved=moved,
            attn1_grad_finite=bool(torch.isfinite(grad).all()),
            attn1_grad_max=float(grad.abs().max()), **metrics))
        r = records[-1]
        print(f"stage2 step {step} ({'generator turn' if r['gen_turn'] else 'latents only'}): "
              f"{wall:.3f} s, peak {r['peak_gib']:.2f} GiB, K1/K1-bwd/K2/K3 "
              f"launches {launches}, tensors moved {moved}, fake attn1.to_q "
              f"max|grad| {r['attn1_grad_max']:.3e}; " + json.dumps(metrics),
              flush=True)
        return metrics

    tmp = Path(tempfile.mkdtemp(prefix="onedc_stage2_"))
    try:
        rng = np.random.default_rng(seed + 23)
        for sub, n in (("train", STAGE2_TRAIN_IMAGES),
                       ("eval", STAGE2_EVAL_IMAGES)):
            (tmp / sub).mkdir()
            for i in range(n):
                img = next(synthetic_batches(int(rng.integers(1 << 30)), 1,
                                             STAGE2_SIZE))["image"][0]
                save_image(img, tmp / sub / f"{sub}{i}.png")
        save_safetensors(random_lpips_weights(seed), tmp / "lpips.safetensors")
        run = tmp / "run"
        overrides = dict(lpips_weights=str(tmp / "lpips.safetensors"),
                         train_data=str(tmp / "train"),
                         eval_data=str(tmp / "eval"), run_dir=str(run),
                         total_steps=STAGE2_STEPS, save_interval=STAGE2_SAVE,
                         log_interval=1)
        for key, value in overrides.items():
            print(f"stage2 override: {key} = {value!r}", flush=True)
        argv = ["--config", "configs/train_stage2.yaml"] + [
            f"{k}={json.dumps(v)}" for k, v in overrides.items()]
        cfg = load_config("configs/train_stage2.yaml", overrides)
        if (cfg.get("optimizer", "adamw") != "adamw"
                or cfg.get("gradient_checkpointing", True) is not True
                or cfg["batch_size"] != 4
                or cfg["dfake_gen_update_ratio"] != 10):
            raise AssertionError("the phase does not run the yaml's recipe")
        free = shutil.disk_usage(tmp).free
        print(f"stage2: {free / 1e9:.1f} GB free for the checkpoint",
              flush=True)

        for mod, attr in counters:
            setattr(mod, attr, 0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t2.Stage2Trainer.train_one_step = observed
        try:
            t0 = time.perf_counter()
            whole = t2.main(argv)
            torch.cuda.synchronize()
            whole_s = time.perf_counter() - t0
            got_whole = tuple(getattr(m, a) for m, a in counters)

            # the frozen parts, bit for bit
            named = dict(whole.onedc.named_parameters())
            named.update({f"guidance.{n}": p for n, p in
                          whole.guidance.named_parameters()})
            moved = [n for n, t in frozen_before.items()
                     if not torch.equal(t, named[n].detach().cpu())]
            if moved:
                raise AssertionError(f"frozen tensors moved: {moved[:4]}")
            print(f"stage2: VAE, codec and real UNet, all "
                  f"{len(frozen_before)} tensors, bit-identical after "
                  f"{len(records)} steps", flush=True)
            frozen_before.clear()
            del named

            # CFG as one batch of 2B rows against its two forwards
            g = whole.guidance
            cgen = torch.Generator(device="cuda").manual_seed(seed + 29)
            lat = torch.randn((4, 4, STAGE2_SIZE // 8, STAGE2_SIZE // 8),
                              generator=cgen, device="cuda")
            t = torch.randint(g.min_step, g.max_step + 1, (4,),
                              generator=cgen, device="cuda")
            text, uncond = whole.embed([""] * 4)
            text = text + 0.1 * torch.randn(text.shape, generator=cgen,
                                            device="cuda")
            with torch.no_grad():
                one = g._predict_noise(g.real_unet, lat, text, uncond, t,
                                       g.real_guidance_scale)
                eu = g.real_unet(lat, t, uncond)
                et = g.real_unet(lat, t, text)
                two = eu + g.real_guidance_scale * (et - eu)
            cfg_err = float((one - two).norm() / two.norm())
            print(f"stage2: real UNet CFG as one batch of 8 rows against "
                  f"two of 4: relative L2 {cfg_err:.3e} (tol "
                  f"{STAGE2_CFG_TOL})", flush=True)
            if not cfg_err <= STAGE2_CFG_TOL:
                raise AssertionError(f"CFG batching: {cfg_err}")
            del one, two, eu, et, lat

            ids = whole.text.tokenize([""] * 4)
            text_ms = [_wall_ms(lambda: whole.text.encode(ids))
                       for _ in range(4)]
            print(f"stage2: text encoder, 4 captions: "
                  f"{', '.join(f'{m:.2f}' for m in text_ms)} ms", flush=True)

            tensors, meta = whole.checkpoint_state()
            t0 = time.perf_counter()
            want = {k: v.cpu() for k, v in tensors.items()}
            host_s = time.perf_counter() - t0
            del tensors, whole, g, text, uncond
            torch.cuda.synchronize()
            left = torch.cuda.memory_allocated() - base
            peak = max(r["peak_gib"] for r in records)
            print(f"stage2: uninterrupted run {whole_s:.1f} s, peak "
                  f"{peak:.2f} GiB; its state to the host in {host_s:.1f} s;"
                  f" device memory after it is dropped {left / 2**20:+.1f} "
                  f"MiB", flush=True)
            if left > 256 * 2 ** 20:
                raise AssertionError(f"a dropped stage-II trainer still "
                                     f"holds {left / 2**30:.2f} GiB")

            for mod, attr in counters:
                setattr(mod, attr, 0)
            t0 = time.perf_counter()
            resumed = t2.main(argv + ["--resume"])
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            got_resumed = tuple(getattr(m, a) for m, a in counters)
        finally:
            t2.Stage2Trainer.train_one_step = step_fn
        tensors, meta_r = resumed.checkpoint_state()
        if meta_r != meta or sorted(tensors) != sorted(want):
            raise AssertionError(f"resumed state {meta_r}, uninterrupted "
                                 f"{meta}")
        differ = [k for k, v in tensors.items()
                  if not torch.equal(v.cpu(), want[k])]
        if differ:
            raise AssertionError(f"{len(differ)} of {len(want)} tensors of "
                                 f"the resumed run differ from the "
                                 f"uninterrupted run's, e.g. {differ[:4]}")
        n_bytes = sum(v.numel() * v.element_size() for v in want.values())
        del tensors, resumed, want
        print(f"stage2: resumed run {resume_s:.1f} s; its state, "
              f"{n_bytes / 1e9:.2f} GB, equals the uninterrupted run's bit "
              f"for bit ({meta})", flush=True)
        rows = read_metrics(run)
    finally:
        shutil.rmtree(tmp)
    torch.cuda.empty_cache()

    for r in records:
        want_l = stage2_per_step(r["gen_turn"])
        if r["launches"] != want_l:
            raise AssertionError(f"step {r['step']}: launches "
                                 f"{r['launches']}, expected {want_l}")
        keys = ["loss_fake_mean", "guidance_cls_loss"] + (
            ["loss_dm", "gen_cls_loss", "pix"] if r["gen_turn"] else [])
        bad = {k: r.get(k) for k in keys
               if not np.isfinite(r.get(k, float("nan")))}
        if bad:
            raise AssertionError(f"step {r['step']}: {bad}")
        m = r["moved"]
        rules = {"gen_params": m["gen_params"] == 0,
                 "gen_moments": (m["gen_moments"] > 0) == r["gen_turn"],
                 "guid_moments": m["guid_moments"] > 0,
                 "guid_params": (m["guid_params"] > 0) == (r["step"] > 0)}
        if not all(rules.values()) or not (r["attn1_grad_finite"]
                                           and r["attn1_grad_max"] > 0):
            raise AssertionError(f"step {r['step']}: moved {m}, fake attn1 "
                                 f"gradient max {r['attn1_grad_max']}")
    got = tuple(a + b for a, b in zip(got_whole, got_resumed))
    want_launches = stage2_launches()
    train = [r for r in rows if "train2/loss_fake_mean" in r]
    evals = [r for r in rows if "eval2/total_loss" in r]
    ckpt = [r for r in rows if any(k.startswith("checkpoint/") for k in r)]
    if [r["step"] for r in evals] != [STAGE2_SAVE] or len(train) != len(
            records):
        raise AssertionError(f"metrics.jsonl rows {rows}")
    by_turn = {kind: [round(r["wall_s"], 4) for r in records
                      if r["gen_turn"] == (kind == "generator")]
               for kind in ("generator", "latents_only")}
    print(f"stage2: s/step by turn {json.dumps(by_turn)}; peak "
          f"{peak:.2f} GiB; checkpoint {json.dumps(ckpt)}", flush=True)
    print("stage2 records " + json.dumps(dict(
        steps=records, by_turn=by_turn, peak_gib=peak, cfg_rel_l2=cfg_err,
        text_encoder_ms=text_ms, checkpoint=ckpt, eval=evals[0],
        state_bytes=n_bytes)), flush=True)
    print(f"stage2: K1/K1-bwd/K2/K3 launches {got}, expected "
          f"{want_launches}", flush=True)
    if got != want_launches:
        raise AssertionError(f"stage2 launches {got}, expected "
                             f"{want_launches}")
    return {"K1": got[0], "K1-bwd": got[1], "K2": got[2], "K3": got[3]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    # the serving phase's bundle process and the bundles' export processes
    # (fresh interpreters)
    parser.add_argument("--serve-bundle", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--export-bundle", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    if args.serve_bundle is not None or args.export_bundle is not None:
        from onedc_tpu_torch.utils.numerics import pinned_numerics

        with pinned_numerics():
            if args.export_bundle is not None:
                return export_bundle(args.export_bundle, card)
            return serve_bundle(args.serve_bundle, card)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from onedc_tpu_torch.models.onedc import OneDC, OneDCRuntime
    from onedc_tpu_torch.ops import build
    from onedc_tpu_torch.utils.numerics import pinned_numerics

    t0 = time.perf_counter()
    build.build_all()
    print(f"built kernels and rANS coder in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in build.CUDA_SOURCES:
        print(f"ptxas {name}:\n{build.ptxas_report(name)}", flush=True)

    # the numerics the package pins in its entry points, here for the whole
    # run: the kernel phase's library baselines and the direct calls of the
    # model's programs that the checks make
    with pinned_numerics(), contextlib.ExitStack() as stack:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed)
        k1_rows = check_k1(gen)
        k2_rows = check_k2(gen)
        k1t_rows, k1b_rows = check_k1_train(gen)
        k2t_rows, k3_rows = check_k2_k3_train(gen)
        n_ragged = check_ragged(gen)
        print(f"ragged sub-phase: {n_ragged} checks passed", flush=True)
        torch.cuda.empty_cache()

        with torch.device("cuda"):
            model = OneDC()
        init_random_weights(model, args.seed)
        rt = OneDCRuntime(model, dtype=torch.bfloat16)
        decode = main_path(rt, args.seed)
        encode = encode_path(rt, args.seed)
        z_only = z_only_path(rt, args.seed)
        # the bundles' exports (host work) run beside the spatial and
        # serving phases
        torch.cuda.empty_cache()
        exports = stack.enter_context(export_processes(args.seed))
        t0 = time.perf_counter()
        spatial, data_mesh = spatial_path(rt, args.seed)
        print(f"spatial phase: {time.perf_counter() - t0:.1f} s", flush=True)
        print(f"peak device memory (decode, encode, z-only) "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        t0 = time.perf_counter()
        serve, bundle, square = serve_path(rt, args.seed, card, exports)
        print(f"serving phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        decode_w8a8 = w8a8_path(rt, square, args.seed, card, exports)
        print(f"w8a8 phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        tiled = tiled_path(rt, args.seed)
        print(f"tiled phase: {time.perf_counter() - t0:.1f} s", flush=True)
        del rt, model, square
        torch.cuda.empty_cache()
        tf32_probe(args.seed)
        torch.cuda.empty_cache()
        # the release that the cli and quality phases load
        release = Path(tempfile.mkdtemp(prefix="onedc_release_"))
        try:
            gen_s, write_s, nbytes, probes = write_release(release)
            print(f"cli: full-layout twins generated in {gen_s:.2f} s; "
                  f"written in F16 in {write_s:.2f} s, {nbytes / 1e9:.3f} GB",
                  flush=True)
            t0 = time.perf_counter()
            cli = cli_path(args.seed, release, nbytes, probes)
            del probes
            print(f"cli phase: {time.perf_counter() - t0:.1f} s", flush=True)
            t0 = time.perf_counter()
            quality = quality_path(args.seed, release, card)
            print(f"quality phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        finally:
            shutil.rmtree(release)
        # the cli and quality phases' runtimes are gone with their last
        # references (none sits in a reference cycle)
        left = torch.cuda.memory_allocated() / 2 ** 30
        print(f"device memory held after the cli and quality phases: "
              f"{left:.3f} GiB", flush=True)
        if left > 1.0:
            raise AssertionError(f"{left:.2f} GiB still allocated after the "
                                 f"phases' runtimes were dropped")
        torch.cuda.empty_cache()
        train, records = train_path(args.seed)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        train_loop = train_loop_path(args.seed)
        print(f"training-loop phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        stage1 = stage1_yaml_path(args.seed)
        print(f"stage-I yaml phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        stage2 = stage2_path(args.seed)
        print(f"stage-II phase: {time.perf_counter() - t0:.1f} s",
              flush=True)

    # the bf16 kernels run on the serving paths, the f32 ones on the
    # training paths
    k1_bf16 = {"decode": decode["K1"], "encode": encode["K1"],
               "decode_z_only": z_only["K1"], "serve": serve["K1"],
               "bundle": bundle["K1"], "decode_w8a8": decode_w8a8["K1"],
               "cli": cli["K1"], "quality": quality["K1"],
               "tiled": tiled["K1"], "spatial": spatial["K1"],
               "data_mesh": data_mesh["K1"]}
    k2_bf16 = {"decode": decode["K2"], "encode": encode["K2"],
               "decode_z_only": z_only["K2"], "serve": serve["K2"],
               "bundle": bundle["K2"], "decode_w8a8": decode_w8a8["K2"],
               "cli": cli["K2"], "quality": quality["K2"],
               "tiled": tiled["K2"], "spatial": spatial["K2"],
               "data_mesh": data_mesh["K2"]}
    k1_f32, k1_bwd, k2_f32, k3 = (
        {"train": train[k], "train_loop": train_loop[k],
         "stage1_yaml": stage1[k], "stage2": stage2[k]}
        for k in ("K1", "K1-bwd", "K2", "K3"))
    kernels = [
        summarize("flash_attention_fwd_bf16",
                  "onedc_tpu_torch/csrc/flash_attention.cu",
                  "onedc_tpu/nn/attention.py:43", k1_rows, k1_bf16,
                  "768x768"),
        summarize("flash_attention_fwd_f32",
                  "onedc_tpu_torch/csrc/flash_attention.cu",
                  "onedc_tpu/nn/attention.py:43", k1t_rows, k1_f32,
                  "train512"),
        summarize("flash_attention_bwd",
                  "onedc_tpu_torch/csrc/flash_attention_bwd.cu",
                  "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
                  k1b_rows, k1_bwd, "train512"),
        summarize("gn_silu_conv3x3_bf16", "onedc_tpu_torch/csrc/conv3x3.cu",
                  "onedc_tpu/ops/pallas_conv.py:292", k2_rows, k2_bf16,
                  "768x768"),
        summarize("gn_silu_conv3x3_f32", "onedc_tpu_torch/csrc/conv3x3.cu",
                  "onedc_tpu/ops/pallas_conv.py:292", k2t_rows, k2_f32,
                  "train512"),
        summarize("conv3x3", "onedc_tpu_torch/csrc/conv3x3.cu",
                  "onedc_tpu/ops/pallas_conv.py:89", k3_rows, k3,
                  "train512"),
    ]
    for k in kernels:
        if any(n == 0 for n in k["launches_by_path"].values()):
            raise AssertionError(f"{k['name']} was not launched on a main "
                                 f"path: {k['launches_by_path']}")
    print("train steps " + json.dumps(records), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
