#!/usr/bin/env python3
"""Drive the PyTorch port (``mode_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``), builds the
   port's CUDA kernels from ``mode_tpu_torch/kernels/csrc`` (one ``nvcc``
   per source, in parallel) and prints the build time.
2. Served paths, each with seeded random weights and BN statistics,
   scaled so the features have unit std and the softmax is neither flat
   nor one-hot (measured on the path's first pair, which also records every
   kernel call its layers make):
   * ``regular_b1``: ``ModeDisparity(192, "Regular")``, one 1024x512
     Cassini pair per call;
   * ``sphere_b1``: ``ModeDisparity(192)``, the flagship ``conv="Sphere"``
     model, one pair per call;
   * ``sphere_b6``: the same model, a frame's six pairs per call;
   * ``erp_b1``: ``ModeDisparity(192, "Sphere", "ERP")``, one 512x1024
     equirectangular pair per call.
   Each path serves a few calls with every launch count set to 0 just
   before and read just after, checks that every kernel of the path ran, at
   the recorded count, which must be the JAX path's, profiles one more call
   (device time by kind of kernel against the host time), and runs one call
   again through the plain versions and compares; the output must not be
   degenerate.
3. Training paths: the stage-1 training step (``mode_tpu_torch.training``)
   of the Sphere model, seeded weights, at batch 2 on a seeded uint8 pair
   and ground truth with a NaN patch: ``train_b2`` (Cassini, 1024x512),
   ``train_b2_bf16`` (the same in mixed precision: bf16 activations and
   conv weights, f32 masters) and ``erp_train_b2`` (ERP, 512x1024). Step 1
   runs through the kernels (and records every kernel call, forward and
   backward) and again through the plain versions from an identical copy:
   the loss and the gradients are held against the plain step's, the
   gradients within a bar that adds the gradient's own spread under an
   input jitter at the step's precision (``STEP_BARS``; in bf16 only the
   leaves that jitter moves by less than 15% of their norm), every kernel
   launch must take the step's dtype, and in bf16 an f32 step from the same
   weights is read against the same plain step. Three more
   steps are timed with the launch counts set to 0 before and read after;
   they must launch every kernel of the path at the counts of the JAX
   package's training gates traced at the path's shape (``TRAIN_TRACED``)
   and lower the loss, and the parameters, gradients, Adam's moments and BN
   statistics must be f32 after them; each prints the host clock at which
   the step returned beside its end. One more step runs under
   ``torch.profiler`` for the time breakdown: the device time by kind of
   kernel and, on the host, the operations with the most self CPU time and
   the CUDA runtime calls (kernel launches, synchronisations, copies).
   The model rematerialises its feature extractor and hourglasses in
   training (``remat_policy="save_convs"``, the JAX model's default), so
   these steps run that way. After ``train_b2``, ``remat``: the same step
   not rematerialised, under ``"save_convs"`` and under ``"full"``, from
   identical copies, each one's step-1 launches (``"save_convs"`` exactly
   ``train_expect``, ``"full"`` that plus ``REMAT_FULL_RERUN``) and its loss
   and gradients against one plain step at ``STEP_BARS``, two more steps
   timed with their peak memory; then one f32 step at ``REMAT_BATCH``
   under ``"save_convs"``, its launches checked and its peak printed.
   After ``train_b2`` the trained weights take one step through the kernels
   and one through the plain versions on the anchor's textured pair, held
   the same way, in f32 and bf16 (``train_anchor``, ``train_anchor_bf16``).
4. Whole-frame paths (``mode_tpu_torch.pipeline.TwoStagePipeline``, what
   ``predict --stage all`` runs): six 1024x512 uint8 Cassini pairs made
   like the anchor's inputs, each with its own disparity, and the four
   views; stage 1 with the trained mid weights at batch 6, maxdisp 192; the
   bridge; the fusion net with seeded weights and random BN statistics, its
   1x1 head scaled to logits of mean 0 and std 1 on the frame; max_depth
   1000. ``frame`` (f32) records every kernel call of its first frame,
   serves three more with the launch counts set to 0 before and read after
   (the JAX path's counts, ``FRAME_JAX``), times one frame's stage 1,
   bridge and fusion by CUDA events, profiles one (device time by kind of
   kernel, host time, synchronisations and copies), and checks each stage:
   stage 1 against its plain path, the bridge on the card against the same
   function on the CPU, the bridge under each z-buffer form (``"scatter"``
   and ``"sort2x"`` bit-equal to ``"sort"``, the three timed in turns), the
   fusion net against its plain versions, and the fused depths' spread.
   ``frame_bf16`` serves the same frame with both
   stages in bf16 and holds its disparities to the f32 frame's. Then the
   fusion net's training step (``make_fusion_train_step``) on a packed
   frame of batch 4 at 1024x512 in the wire dtypes (f16 depths, uint8
   confidences and views, unpacked on the card), seeded weights with the
   head scaled to logits of mean 0 and std 1 in training, silog on an f32
   ground truth partly past max_depth: ``fusion_train_b4`` (f32) and
   ``fusion_train_b4_bf16``, driven as the stage-1 steps are, K9 forward
   and as grad-input at twice the JAX gate's traced count
   (``FUSION_TRAIN_K9``) a step. Then data parallelism
   (``mode_tpu_torch/parallel``): ``ddp_nccl``, ``train_b2`` through the
   mesh-aware step on a process group of one NCCL rank in this process
   (its launches, one broadcast per tensor when built and one gradient
   all-reduce a step, step 1 against its plain step, its time in turns
   with the step without a mesh, one profiled); ``ddp_gloo_2``, two
   processes on the card over gloo (``parallel/launch.py``), a pair each
   of a global batch of two with NaN patches of different sizes, then a
   fusion step on half each of ``fusion_train_b4``'s frame: each rank's
   launches at its batch (``RANK_TRACED``, the fusion net's
   ``FUSION_TRAIN_K9``), the ranks bit-equal after each step, rank 0's
   loss and gradients against the plain step of one process at the
   global batch (``STEP_BARS``) and its BN statistics against that
   process's kernel step; rank 0's step times and a profiled step's
   share of collectives. Then the spatial axis (``parallel/shard_ops.py``):
   ``sp_gloo_2``, two gloo ranks sharing the card on a ``(data 1, spatial
   2)`` mesh, each serving its rows of one 1024x512 pair with the trained
   mid weights, f32 then bf16 (conv weights cast): each rank's launches a
   call must be one process's per pair (``PATHS["sphere_b1"]``), the 3-D
   convs and K2 all on their halo forms (``SP_HALO``, three Cout-1 heads
   among them), with 29 collectives a call (28 halo exchanges and K2's
   gather); the maps gathered from both ranks must match the one-process
   kernel path in f32 (``PRED_MAE``, ``PRED_MAX``, ``CONF_MAE``) and the
   bf16 maps the f32 ones within ``BF16_DISP_MAE``; rank 0's ms a call (the
   two ranks share the card) and a profiled call's all-gather time; then
   the ERP model on its rows of one 512x1024 pair, f32, held the same way
   (``PATHS["erp_b1"]``'s launches). Then ``sp_frame_gloo_2``: the two ranks
   serve the whole frame (the ``frame`` phase's inputs, the trained mid
   weights and its calibrated fusion net) on the same mesh, f32 and bf16:
   stage 1 on each rank's rows, the disparities and confidences gathered,
   the bridge whole on each rank, the fusion net on each rank's rows (its
   ``FUSION_K8`` kernel convs on K8's halo form, depth_layer4's two on
   cuDNN over the haloed rows), the fused map gathered. Each rank's
   launches a frame must be one process's (``FRAME_JAX``), the halo forms
   ``SP_FRAME_HALO``, with ``SP_FRAME_COLLECTIVES`` collectives a frame;
   the f32 frame must hold the one-process ``frame`` (stage 1 at the served
   bars, the fused depths at ``FUSED_MAE``/``FUSED_MAX``) and the bf16
   disparities the f32 ones within ``BF16_DISP_MAE``. Then
   ``sp_train_gloo_2``: the two ranks train ``train_b2``'s seeded model on
   the same mesh, each on the whole global batch of two (a batch made as
   ``train_b2``'s, from its own seed) and its half of the cost volume's
   rows, f32 and bf16 (four steps each) and one ERP f32 step at 512x1024:
   each rank's launches a step one process's (``train_expect``), the 3-D
   ones on their halo forms forward and as grad-inputs (``SP_TRAIN_HALO``),
   every launch in the step's dtype, ``SP_TRAIN_COLLECTIVES`` collectives
   a step, the ranks bit-equal after every step; rank 0's first step held
   against the one-process plain step at ``STEP_BARS`` and, in f32, its BN
   statistics against this process's kernel step; rank 0's ms a step, its
   collectives' share of a profiled step's host time and its peak.
5. The serving CLIs (``mode_tpu_torch/cli``), ``cli``: a Deep360-layout
   tree of 1024x512 PNGs in a temporary directory (one episode; four frames
   in training, one in validation, two in testing; each frame the frame
   phase's six uint8 pairs, each pair's ground truth its constant
   disparity, the depth pair 12's through the bridge), the trained mid
   weights and the frame's calibrated fusion net written as reference
   ``.tar`` files; then each CLI through its ``main(argv)`` with its
   default device (the card): ``test_disparity`` at batch 1 (with its
   dumps and without), 4 and 5 (a partial last batch: 5, 5, 2),
   ``save_output_disparity_stage`` at batch 6, ``test_fusion`` on the
   bridge's output, ``predict --stage disp`` and ``--stage all``. Each
   invocation's launch counts, set to 0 before and read after, and each
   loader batch's, must be the counts the served paths and the frame
   expect per call; ``test_disparity``'s MAE must be the MAE of its own
   dumps; stage 1 at every batch size from 1 to 6 must launch its path's
   kernels and match its plain path on the same batch and the batch-1
   dumps (the anchor's bars); ``test_fusion``'s dumps must match
   ``ModeFusion`` and ``cassini_to_erp`` called directly on the same
   decoded frames, and its metrics those of its dumps; ``predict --stage
   all`` must match ``TwoStagePipeline`` called directly on the same
   decoded images (the frame's fusion bars); every output file must exist
   with its shape and range. Prints each CLI's wall time, its ms per pair
   or frame after the first batch, its loader's wait per batch and decode
   path. The native library's single-file decoders, ``decode_png`` and
   ``read_npz``, read one view and one ground truth of the tree, held
   equal to PIL's and numpy's reading. (``cli_profile.py`` profiles the
   CLIs' host work.)
6. The training CLIs, ``train_cli``, on the same tree and the bridge's
   outputs, each through its ``main(argv)`` with its default device at
   1024x512, maxdisp 192 and the CLIs' batch 4: ``train_disparity`` in f32
   from the trained mid weights for two epochs of one step (lr 1e-3, then
   1e-4; its first epoch traced with ``--trace_dir``), with ``--bf16
   --device_normalize`` for three steps, and ``--resume`` from the f32
   run's epoch-2 checkpoint for three steps of epoch 3; ``train_fusion``
   for one step with ``ModeFusion`` from packed frames (``--packed_dir``)
   in f32 and bf16, from float inputs, and with the ``Baseline``, each from
   seeded weights whose head is scaled to logits of mean 0 and std 1.
   Each step's launches (and their dtype) must be the training paths'
   (``train_expect``, ``2 x FUSION_TRAIN_K9``, ``2 x BASELINE_TRAIN_K9``)
   and each validation batch's the served counts; the first step of each
   run must match the same step built directly on the batch a loader made
   as the CLI makes it gives, from the same weights, and that step its
   plain step (``grad_check`` at ``STEP_BARS``, each leaf's spread the
   larger of the two steps' own); the f32 run's
   checkpoints must show Adam's first step at lr 1e-3 and its second at
   1e-4; every checkpoint must load strictly into a fresh model, and one of
   each stage must serve through ``test_disparity`` and ``test_fusion`` at
   the served counts; the packs must be their frames' arrays, the event
   files the returned scalars, the trace must name the training kernels;
   ``train_disparity --dp 2`` as two gloo ranks on the card (one epoch of
   two steps) and ``train_disparity --sp 2`` (one step of a global batch
   of two, the 3-D kernels on their halo forms) must launch each rank's
   steps (rank 0 also its validation) at the counts above, return the same
   losses on both ranks and write their files from rank 0 alone; in one
   process ``--dp 2`` and ``--sp 2`` must be refused. Prints each run's wall time, ms per
   step, validation ms per item, loader wait and peak memory.
7. Kernel phase: calls each kernel's wrapper at every shape the paths gave
   it (the recorded calls; the training steps add the grad-input shapes and
   the sphere conv's two backward kernels; the training CLIs' steps add
   their batch-4 and ``Baseline`` shapes) and the regression shapes, in
   f32 and bf16 (a path's per-kernel times are in its own dtype), holds
   the result against the kernel's plain PyTorch version on the same
   inputs, and times the kernel, the plain version and
   one PyTorch library call of the same function where there is one, the
   library convs in IEEE f32 as the model runs its own
   (``mode_tpu_torch.device.ieee_f32_convs``; the script sets no global
   precision flag, so the paths run as a caller's process runs them).
   Then the halo forms: each 3-D call of ``sphere_b1`` at a rank's rows
   for spatial 2 (``sp_gloo_2``'s, which the ranks recorded) and 4, with
   its halo rows (``h_halo``), against its plain halo version, beside
   cuDNN on the same rows and on the whole volume; and K2's row window
   for rank 1 of 2 and of 4; and K8's halo form at each fusion-net shape of
   the frame (``sp_frame_gloo_2``'s, which the ranks recorded) and at the
   Sphere stem's shape, for spatial 2 and 4, beside the kernel and cuDNN
   on the whole map and cuDNN on the same haloed rows.
8. Full-resolution anchor: the trained reference weights
   (``tests/data/trained_mirror_mid.npz``) on the inputs of
   ``tests/data/fullres_torch_frame.npz``, regenerated from its seed, held
   against the frame's committed (pred, conf).
9. Prints a ``{"kernels": [...]}`` line, then as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, before the last line, when there is no card or when any
check fails. Needs one card, the CUDA toolkit (``nvcc``) and no network.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import inspect
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
# peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W): memory; the
# products of a conv, f32 at what the card does at f32 accuracy (3xTF32 on
# the tensor cores, 495 / 3 TFLOP/s), bf16 on the tensor cores; the FP32
# pipes, for the work that cannot go to the tensor cores (the sphere convs'
# bilinear blends, the regression head's lerps and sums); and the special-
# function units, which take the regression head's exps (MUFU.EX2): 16
# results a clock per SM, 132 SMs at the data sheet's 1.98 GHz boost clock
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
PIPE_OPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
CONV_PY = "mode_tpu/ops/pallas/conv3d_kernel.py"
CONV2D_PY = "mode_tpu/ops/pallas/conv2d_kernel.py"
SPHERE_PY = "mode_tpu/ops/pallas/sphere_conv_kernel.py"
# kernel: (source, the TPU kernels it replaces as file:line)
KERNELS = {
    "conv3d_s1_bn_act": ("mode_tpu_torch/kernels/csrc/conv3d_s1.cu",
                         (f"{CONV_PY}:269", f"{CONV_PY}:866")),
    "conv3d_s2_bn_act": ("mode_tpu_torch/kernels/csrc/conv3d_s2.cu",
                         (f"{CONV_PY}:480",)),
    "deconv3d_bn_act": ("mode_tpu_torch/kernels/csrc/conv3d.cu",
                        (f"{CONV_PY}:677", f"{CONV_PY}:1042")),
    "fused_disparity_regression": (
        "mode_tpu_torch/kernels/csrc/regression.cu",
        ("mode_tpu/ops/pallas/regression_kernel.py:107",)),
    "sphere_conv_bn_act": (
        "mode_tpu_torch/kernels/csrc/sphere_conv.cu",
        ("mode_tpu/ops/pallas/sphere_conv_kernel.py:272",)),
    "conv2d_s1_bn_act": ("mode_tpu_torch/kernels/csrc/conv2d.cu",
                         (f"{CONV2D_PY}:162", f"{CONV2D_PY}:346")),
    "sphere_conv_bwd_input": (
        "mode_tpu_torch/kernels/csrc/sphere_conv_bwd.cu",
        (f"{SPHERE_PY}:572", f"{SPHERE_PY}:514")),
    "sphere_conv_bwd_weight": (
        "mode_tpu_torch/kernels/csrc/sphere_conv_bwd.cu",
        (f"{SPHERE_PY}:572", f"{SPHERE_PY}:559")),
    "sphere_conv_erp_bn_act": (
        "mode_tpu_torch/kernels/csrc/sphere_conv.cu", (f"{SPHERE_PY}:304",)),
    "sphere_conv_erp_bwd_input": (
        "mode_tpu_torch/kernels/csrc/sphere_conv_bwd.cu",
        (f"{SPHERE_PY}:605", f"{SPHERE_PY}:514")),
    "sphere_conv_erp_bwd_weight": (
        "mode_tpu_torch/kernels/csrc/sphere_conv_bwd.cu",
        (f"{SPHERE_PY}:605", f"{SPHERE_PY}:559")),
}
# the sphere conv's kernels (forward, dx, dw) by layout, as
# mode_tpu_torch/ops/sphere_conv.py names them
SPHERE_KERNELS = {"Cassini": ("sphere_conv_bn_act", "sphere_conv_bwd_input",
                              "sphere_conv_bwd_weight"),
                  "ERP": ("sphere_conv_erp_bn_act",
                          "sphere_conv_erp_bwd_input",
                          "sphere_conv_erp_bwd_weight")}
SPHERE_FWD = tuple(k[0] for k in SPHERE_KERNELS.values())
SPHERE_BWD = tuple(n for k in SPHERE_KERNELS.values() for n in k[1:])
# The TPU kernel (ROADMAP's numbering) each kernel took over; the hourglass
# layers at the 1/16 level, which the TPU ran M*L-folded; and the 2-D band
# kernel, per-image at batch 1 and batch-packed above.
TPU_KERNEL = {"conv3d_s1_bn_act": "K1", "conv3d_s2_bn_act": "K4",
              "deconv3d_bn_act": "K5", "fused_disparity_regression": "K2",
              "sphere_conv_bn_act": "K3", "sphere_conv_bwd_input": "K3b",
              "sphere_conv_bwd_weight": "K3b", "sphere_conv_erp_bn_act": "K10",
              "sphere_conv_erp_bwd_input": "K10b",
              "sphere_conv_erp_bwd_weight": "K10b"}
TPU_FOLDED = {"conv4": "K6", "conv5": "K7"}
MAXDISP = 192
# (H, W) of a full-resolution pair in each layout: the Deep360 Cassini
# frame, and the equirectangular panorama of the same pixel count
GEOMETRY = {"Cassini": (1024, 512), "ERP": (512, 1024)}
# path: (conv, sphere_type, pairs per call, calls served, the JAX path's
# launches per call by kernel: (TPU kernels, count))
JAX_3D = {"conv3d_s1_bn_act": ("K1 13 + K6 3", 16),
          "conv3d_s2_bn_act": ("K4 6", 6),
          "deconv3d_bn_act": ("K5 3 + K7 3", 6),
          "fused_disparity_regression": ("K2 1", 1)}
PATHS = {
    "regular_b1": ("Regular", "Cassini", 1, 2, JAX_3D),
    "sphere_b1": ("Sphere", "Cassini", 1, 3, {
        **JAX_3D, "sphere_conv_bn_act": ("K3 32", 32),
        "conv2d_s1_bn_act": ("K8 4", 4)}),
    "sphere_b6": ("Sphere", "Cassini", 6, 2, {
        **JAX_3D, "sphere_conv_bn_act": ("K3 32", 32),
        "conv2d_s1_bn_act": ("K9 64", 64)}),
    "erp_b1": ("Sphere", "ERP", 1, 3, {
        **JAX_3D, "sphere_conv_erp_bn_act": ("K10 32", 32),
        "conv2d_s1_bn_act": ("K8 4", 4)}),
}
# The whole-frame paths (mode_tpu_torch.pipeline.TwoStagePipeline): six
# Cassini pairs through stage 1 at batch 6, the bridge, the fusion net. The
# fusion net's stride-1 3x3 convs that the JAX package runs on its per-image
# 2-D band kernel at 1024x512, traced with counting stubs under
# jax.eval_shape (tests/test_torch_fusion.py traces it and holds this
# number): 16 at W = 512, 10 at 256, 10 at 128.
FUSION_K8 = 36
FRAME_JAX = {**JAX_3D, "sphere_conv_bn_act": ("K3 32", 32),
             "conv2d_s1_bn_act": (f"K9 64 + K8 {FUSION_K8}", 64 + FUSION_K8)}
# label: (dtype of both stages, frames served after a warm-up)
FRAMES = {"frame": (torch.float32, 3), "frame_bf16": (torch.bfloat16, 3)}
MAX_DEPTH = 1000.0
# the frame's stage-wise checks: the bridge on the card against the same
# function on the CPU (share of pixels per pair that may differ); the fusion
# net through the kernels against its plain versions (m); the share of
# fused pixels strictly inside (1, 999) m
BRIDGE_DIFFER, FUSED_MAE, FUSED_MAX, FUSED_INSIDE = 1e-3, 1e-3, 5e-2, 0.9
# the bf16 frame's disparities against the f32 frame's: 0.15% of the 192 px
# range, the JAX package's bar (docs/ARCHITECTURE.md)
BF16_DISP_MAE = 0.0015 * MAXDISP
# the z-buffer's forms (geometry/reprojection.py:set_zbuffer_impl), each
# run on the f32 frame's bridge and timed ZBUFFER_REPS times in turns
ZBUFFER_FORMS = ("scatter", "sort", "sort2x")
ZBUFFER_REPS = 7
# a wait of ~20 ms on the card (at 1.98 GHz), longer than the bridge's
# launches take the host, so they queue behind it
ZBUFFER_SLEEP_CYCLES = 40_000_000
# the served path whose per-pair numbers the kernels line carries for the
# kernels that do not train (the regression head)
MAIN_PATH = "sphere_b1"
# The stage-1 training paths: the Sphere model in each layout, and the
# Cassini step in mixed precision (bf16 activations and conv weights, f32
# masters); steps timed after the first. path: (sphere_type, batch, (H, W),
# compute dtype).
TRAINS = {"train_b2": ("Cassini", 2, GEOMETRY["Cassini"], torch.float32),
          "erp_train_b2": ("ERP", 2, GEOMETRY["ERP"], torch.float32),
          "train_b2_bf16": ("Cassini", 2, GEOMETRY["Cassini"],
                            torch.bfloat16)}
TRAIN_STEPS = 3
# The fusion net's training paths (mode_tpu_torch.training.
# make_fusion_train_step on the packed wire inputs): ModeFusion(1000,
# (32, 64, 128, 256)) with seeded weights, at the CLI's default batch 4
# (mode_tpu/cli/train_fusion.py:46) and the pipeline's fusion shape.
# path: (batch, (H, W), compute dtype).
FUSION_TRAINS = {"fusion_train_b4": (4, GEOMETRY["Cassini"], torch.float32),
                 "fusion_train_b4_bf16": (4, GEOMETRY["Cassini"],
                                          torch.bfloat16)}
# Per fusion training forward at that shape: the stride-1 3x3 convs that the
# JAX package's batch-packed training gate sends to conv2d_3x3_fast_train,
# traced with counting stubs under jax.eval_shape in f32 and in bf16
# (tests/test_torch_fusion_train.py traces it and holds this number): all 38
# but the two 12-channel input convs. Each launches K9 forward and as its
# grad-input.
FUSION_TRAIN_K9 = 36
# Per training forward, by kernel family: the calls that the JAX package's
# Pallas training gates send to its custom VJPs at the path's shape and
# batch, traced with counting stubs under jax.eval_shape, the strided gates
# at the bf16 itemsize so that no f32-only TPU memory budget enters
# (tests/test_torch_erp_train_step.py traces them and holds these numbers):
# the stride-1 conv at the 1/4 (7) and 1/8 (3) levels, the stride-2 convs
# and the deconvs (6 each), every stride-1 3x3 FE conv (32 per view), the
# 16 sphere convs per view.
TRAIN_TRACED = {
    label: {"conv3d_s1": 10, "conv3d_s2": 6, "deconv3d": 6, "conv2d": 64,
            "sphere": 32} for label in TRAINS}
# (the bf16 path's counts are the gates traced at the bf16 itemsize, inputs
# and conv kernels cast: tests/test_torch_train_step_bf16.py)
# The data-parallel phases split train_b2's global batch of 2 over two
# ranks, a pair each: per training forward of a rank at batch 1, the same
# gates traced (tests/test_torch_parallel.py traces them and holds these
# numbers): the stride-1 3-D and the 2-D convs need batch >= 2, the strided
# convs and the sphere conv have no batch gate. fusion_train_b4's frame
# split over two ranks leaves two a rank, where the fusion net's gate takes
# FUSION_TRAIN_K9 as at four (held by the same test).
RANK_TRACED = {"conv3d_s1": 0, "conv3d_s2": 6, "deconv3d": 6, "conv2d": 0,
               "sphere": 32}
DDP_WORLD = 2
# The convs that remat_policy="full" runs again in the backward of a
# train_b2 step, by kernel, from TRAIN_TRACED: every 2-D kernel conv (64)
# and sphere conv (32) lies in the feature extractor; the hourglasses hold
# the stride-2 convs (conv1, conv3: 6) and the deconvs (conv5, conv6: 6)
# and, of the stride-1 kernel convs, each one's 1/8-level conv2 (3; the
# other 7 are dres0, dres1 and the classifier heads, outside the
# rematerialised blocks). "save_convs" runs none of them again.
REMAT_FULL_RERUN = {"conv3d_s1_bn_act": 3, "conv3d_s2_bn_act": 6,
                    "deconv3d_bn_act": 6, "conv2d_s1_bn_act": 64,
                    "sphere_conv_bn_act": 32}
REMAT_POLICIES = {"remat_off": (False, "save_convs"),
                  "save_convs": (True, "save_convs"),
                  "full": (True, "full")}
REMAT_TURNS = 3
# the f32 step at the per-card batch that the JAX step is built for: batch 4
# peaked at 38.71 GiB without the rematerialisation (PERF.md)
REMAT_BATCH = 8
# A training step on the card against the same step through the plain
# versions from the same weights: the loss within LOSS_RTOL; each gradient
# leaf within GRAD_RTOL of its norm plus twice its spread, the largest
# distance by which the plain step's gradient moves when the normalised
# inputs are multiplied by 1 + INPUT_JITTER * N(0, 1) (two draws). With
# seeded weights the BN-ReLU stack of the feature extractor is chaotic at
# init: on an H100 that jitter moves the gradients by about 3.6% of their
# norm, more than the kernels' summation order does.
LOSS_RTOL, GRAD_RTOL, INPUT_JITTER = 1e-4, 1e-3, 1e-6
# Spread of the served model's final logits (std over the volume): enough
# for a softmax that is neither flat nor one-hot
LOGIT_STD = 4.0
# |kernel - plain| <= ATOL + RTOL * |plain| elementwise. f32: both sides sum
# up to 27 * 64 (3-D) or 9 * 320 (2-D, sphere) products in different orders,
# the tensor-core kernels as 3xTF32 (each product to ~2^-22). bf16: both
# sides compute in f32 from the same bf16 inputs and round once, so they
# may land one bf16 step (2^-8 relative) apart; the sphere kernel also
# rounds its blended A values to bf16 (as the Pallas kernel does), which
# adds ~2^-9 relative per product, summed over 9 * 128 of them.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# A training step's bars against its plain step, by compute dtype: the
# loss's relative bar; the gradients' relative bars, over all the held
# leaves ("global") and per leaf, each plus twice the spread, the largest
# distance by which "draws" draws of the input jitter move the plain step's
# gradient. In bf16 both steps round every activation to bf16 and may land
# one bf16 step apart: the loss and the global gradient are held at
# TOL[bfloat16]'s relative part, the spread is taken under a jitter of one
# bf16 step (2^-8; a 1e-6 jitter vanishes in the cast to bf16), and a leaf
# whose spread is "noise" or more of its norm is rounding noise at that
# operating point and is not held (its bar would pass a zero gradient): so
# with seeded weights, where bf16 moves the stage-1 and fusion gradients by
# 76% or more of their norm, only the leaves next to the heads are held, and
# the trained weights' step (train_anchor_bf16) is the bf16 step check. Its
# leaf bar, 0.1, lies between the most that the kernel step needed over the
# 4 anchor seeds of step_bar_study.py (0.033 on an H100) and what a zero
# gradient needs on any held leaf (at least 1 - 2 * 0.15 = 0.7). An f32
# step read against the plain bf16 step needed at most 0.046 there: the
# bars cannot tell a bf16 step from an f32 one, so the paths check the
# dtype their kernels took instead.
STEP_BARS = {
    torch.float32: {"loss": LOSS_RTOL, "global": GRAD_RTOL,
                    "leaf": GRAD_RTOL, "jitter": INPUT_JITTER, "draws": 2,
                    "noise": None},
    torch.bfloat16: {"loss": TOL[torch.bfloat16][1],
                     "global": TOL[torch.bfloat16][1], "leaf": 1e-1,
                     "jitter": 2.0**-8, "draws": 4, "noise": 0.15}}
# A served path on the card against its plain path, f32: the bars of
# tests/test_trained_parity_midres.py.
PRED_MAE, PRED_MAX, CONF_MAE = 1e-3, 1e-2, 1e-3
# The full-resolution anchor: the bars of
# tests/test_trained_parity_fullres.py.
ANCHOR_MAE, ANCHOR_MAX, ANCHOR_CONF_MAE = 1e-3, 5e-2, 1e-3


def train_expect(label: str) -> dict[str, int]:
  """Kernel launches per step of a training path, from its traced calls:
  each Function launches its kernel in the forward and again as its
  grad-input (the stride-2 conv and the deconv each as the other's), and
  each sphere conv its forward and both backward kernels."""
  return traced_launches(TRAIN_TRACED[label], TRAINS[label][0])


def traced_launches(t: dict, sphere_type: str = "Cassini") -> dict[str, int]:
  """:func:`train_expect` of the traced calls ``t``."""
  fwd, dx, dw = SPHERE_KERNELS[sphere_type]
  strided = t["conv3d_s2"] + t["deconv3d"]
  return {"conv3d_s1_bn_act": 2 * t["conv3d_s1"],
          "conv3d_s2_bn_act": strided, "deconv3d_bn_act": strided,
          "conv2d_s1_bn_act": 2 * t["conv2d"], fwd: t["sphere"],
          dx: t["sphere"], dw: t["sphere"]}


def _layout(kernel: str) -> str:
  """The map layout a sphere kernel takes."""
  return "ERP" if kernel in SPHERE_KERNELS["ERP"] else "Cassini"


def _fail(msg: str) -> None:
  print(f"FAIL: {msg}", flush=True)
  raise SystemExit(1)


def _time_ms(fn, reps: int) -> float:
  """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def _time_in_turns(fns, reps: int) -> list[float]:
  """Times of ``fns`` on one card, each taken twice in the turns a, b, ...,
  ..., b, a; the faster of its two runs for each."""
  first = [_time_ms(fn, reps) for fn in fns]
  second = [_time_ms(fn, reps) for fn in reversed(fns)][::-1]
  return [min(a, b) for a, b in zip(first, second)]


def _close(got, want, dtype):
  """(max abs err, max rel err, within tolerance)."""
  atol, rtol = TOL[dtype]
  g, w = got.float(), want.float()
  diff = (g - w).abs()
  ok = bool((diff <= atol + rtol * w.abs()).all())
  rel = float((diff / w.abs().clamp_min(1e-6)).max())
  return float(diff.max()), rel, ok


def _bound(ops_n, nbytes, dtype, pipe_ops=0, sfu_ops=0):
  """The least time for ``ops_n`` conv products at the ``dtype`` rate plus
  ``pipe_ops`` on the FP32 pipes, or for ``sfu_ops`` on the special-function
  units (which run beside the FP32 pipes), or for ``nbytes``, whichever is
  longest."""
  t_ops = max(ops_n / PEAK_OPS_PER_S[dtype] + pipe_ops / PIPE_OPS_PER_S,
              sfu_ops / SFU_OPS_PER_S) * 1e3
  t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
  return {"bound_ms": max(t_ops, t_bytes),
          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "ops_ms": t_ops, "bytes_ms": t_bytes}


def _conv_case(case, dtype, gen):
  """Compare and time one recorded conv shape; returns the row it prints.
  The kernel gets its weight packed once, as the model's layers keep it.
  A 3-D or 2-D case with a seventh entry (the spatial size) is a halo
  case: ``xs`` a rank's haloed rows, the kernel's halo form against its
  plain halo version, the library call the same function on the same
  rows."""
  from mode_tpu_torch.ops import conv2d, conv3d, sphere_conv
  name, xs, cout, res, relu, dil = case[:6]
  halo = len(case) > 6
  dev = torch.device(DEVICE)
  cin = xs[-1]
  deconv = name == "deconv3d_bn_act"
  two_d = name in ("conv2d_s1_bn_act", *SPHERE_FWD)
  x = (torch.randn(xs, generator=gen, device=dev) * 0.5).to(dtype)
  if two_d:
    wshape = (cout, cin, 3, 3)
  else:
    wshape = (cin, cout, 3, 3, 3) if deconv else (cout, cin, 3, 3, 3)
  taps = 9 if two_d else 27
  w = (torch.randn(wshape, generator=gen, device=dev)
       * (2.0 / (taps * cout)) ** 0.5).to(dtype)
  scale = torch.rand(cout, generator=gen, device=dev) * 0.4 + 0.8
  bias = torch.randn(cout, generator=gen, device=dev) * 0.1
  hx = 1 if len(xs) == 4 else 2                           # the H axis
  grid = ((*xs[:hx], xs[hx] - 2, *xs[hx + 1:-1]) if halo  # its own rows
          else xs[:-1])
  if name == "conv3d_s2_bn_act":
    oshape = (xs[0], *[(n - 1) // 2 + 1 for n in grid[1:4]], cout)
  elif deconv:
    oshape = (xs[0], *[2 * n for n in grid[1:4]], cout)
  else:
    oshape = (*grid, cout)
  r = (torch.randn(oshape, generator=gen, device=dev) * 0.5).to(dtype)
  kw = {"relu": relu}
  if res:
    kw["residual"] = r
  if halo:
    kw["h_halo"] = True
  if name == "conv2d_s1_bn_act":
    kw["dilation"] = dil
    fn, packed = conv2d.conv2d_s1_bn_act, conv2d.pack_weight_tc(w)
  elif name in SPHERE_FWD:
    fn = functools.partial(sphere_conv.sphere_conv_bn_act,
                           sphere_type=_layout(name))
    packed = conv2d.pack_weight_tc(w)
  elif name == "conv3d_s1_bn_act":
    fn, packed = conv3d.conv3d_s1_bn_act, conv3d.pack_weight_tc(w)
  elif name == "conv3d_s2_bn_act":
    fn, packed = conv3d.conv3d_s2_bn_act, conv3d.pack_weight_tc(w, 2)
  else:
    fn = conv3d.deconv3d_bn_act
    packed = conv3d.pack_weight_tc(w, transpose=True)

  def run(plain):
    return fn(x, w if plain else packed, scale, bias, plain=plain, **kw)

  got, want = run(False), run(True)
  torch.cuda.synchronize()
  abs_err, rel_err, ok = _close(got, want, dtype)

  lib = None
  if name == "conv2d_s1_bn_act":
    x_cl = x.permute(0, 3, 1, 2)          # channels-last view for cuDNN
    w_cl = w.contiguous(memory_format=torch.channels_last)
    pad = (0, 1) if halo else dil          # (haloed: W alone padded)
    def lib():
      return F.conv2d(x_cl, w_cl, padding=pad, dilation=dil)
  elif not two_d:
    x_cl = x.permute(0, 4, 1, 2, 3)       # channels-last 3-D view
    w_cl = w.contiguous(memory_format=torch.channels_last_3d)
    if deconv:
      # (haloed: the shard's rows and the lower halo row, two output rows
      # more than the halo form keeps)
      x_dc = x_cl[:, :, :, 1:] if halo else x_cl
      def lib():
        return F.conv_transpose3d(x_dc, w_cl, stride=2, padding=1,
                                  output_padding=1)
    else:
      s = 1 if name == "conv3d_s1_bn_act" else 2
      pad = (1, 0, 1) if halo else 1
      def lib():
        return F.conv3d(x_cl, w_cl, stride=s, padding=pad)

  fns = [lambda: run(False), lambda: run(True)] + ([lib] if lib else [])
  times = _time_in_turns(fns, 10)
  kernel_ms, plain_ms = times[:2]
  grid = grid if deconv else oshape[:-1]
  m = torch.Size(grid).numel()
  ops_n, pipe_ops = 2 * m * taps * cin * cout, 0
  isz = x.element_size()
  nbytes = (x.numel() + w.numel() + (r.numel() if res else 0)
            + torch.Size(oshape).numel()) * isz + 2 * cout * 4
  if name in SPHERE_FWD:
    # the bilinear blend: 4 products and 3 sums per (pixel, tap, channel);
    # the shift tables: an int4 and a float4 per (band index, tap), the
    # band being the Cassini map's columns and the ERP map's rows
    pipe_ops = 7 * m * taps * cin
    nbytes += xs[1 if _layout(name) == "ERP" else 2] * taps * 32
  return {"name": name, "dtype": str(dtype).split(".")[1],
          "shape": f"{xs}->{cout}" + (" +res" if res else "")
                   + (" relu" if relu else "") + (f" dil{dil}" if dil > 1
                                                  else "")
                   + (f" h_halo (spatial {case[6]})" if halo else ""),
          "halo": case[6] if halo else None,
          "max_abs_err": abs_err, "max_rel_err": rel_err, "pass": ok,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "library_ms": times[2] if lib else None,
          **_bound(ops_n, nbytes, dtype, pipe_ops),
          "tflops": (ops_n + pipe_ops) / kernel_ms / 1e9}


def _regression_case(case, dtype, gen):
  """Compare and time one regression shape; a fifth and sixth entry are a
  row window (``row0``, ``h_out``: a rank's output rows)."""
  from mode_tpu_torch.ops import regression
  (n, d, hq, wq), maxdisp, h, w = case[:4]
  row0, h_out = case[4:] if len(case) > 4 else (0, h)
  fn = functools.partial(regression.fused_disparity_regression, row0=row0,
                         h_out=h_out)
  cost = (torch.randn((n, d, hq, wq), generator=gen, device=DEVICE)
          * 2.0).to(dtype)
  (kp, kc), (pp, pc) = (fn(cost, maxdisp, h, w, plain=plain)
                        for plain in (False, True))
  torch.cuda.synchronize()
  # conf jumps where round(pred) does: pixels whose pred lies within f32
  # noise of k + 0.5 may probe different slices on the two sides
  tie = (pp - pp.floor() - 0.5).abs() < 1e-3
  pred_err, pred_rel, pred_ok = _close(kp, pp, torch.float32)
  conf_err, _, conf_ok = _close(kc[~tie], pc[~tie], torch.float32)
  kernel_ms, plain_ms = _time_in_turns(
      [lambda: fn(cost, maxdisp, h, w),
       lambda: fn(cost, maxdisp, h, w, plain=True)], 5)
  # operations the function needs: per output pixel, a bilinear blend of
  # each of the d source levels (3 lerps, 6 flops), and per disparity level
  # one lerp (3 flops), the shift and the two sums (an add and an FMA) on
  # the FP32 pipes, and one exp on the special-function units; the
  # confidence's three probabilities are among those levels' terms
  pipe_ops = n * h_out * w * (6 * d + 7 * maxdisp)
  exps = n * h_out * w * maxdisp
  nbytes = cost.numel() * cost.element_size() + 2 * n * h_out * w * 4
  return {"name": "fused_disparity_regression",
          "dtype": str(dtype).split(".")[1],
          "shape": f"{(n, d, hq, wq)} maxdisp {maxdisp} -> {h}x{w}"
                   + (f" rows [{row0}, {row0 + h_out})" if h_out != h
                      else ""),
          "halo": h // h_out if h_out != h else None,
          "max_abs_err": max(pred_err, conf_err), "pred_max_abs_err": pred_err,
          "conf_max_abs_err": conf_err, "conf_ties_left_out": int(tie.sum()),
          "max_rel_err": pred_rel, "pass": pred_ok and conf_ok,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
          "exps": exps, **_bound(0, nbytes, torch.float32, pipe_ops, exps)}


def _randomize_for_serving(model, seed: int) -> None:
  """Random BN statistics, so the folded affine is not the identity."""
  from mode_tpu_torch.models.blocks import TorchBatchNorm
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for m in model.modules():
      if isinstance(m, TorchBatchNorm):
        c = m.weight.numel()
        m.weight.copy_(torch.rand(c, generator=gen) * 0.4 + 0.8)
        m.bias.copy_(torch.randn(c, generator=gen) * 0.05)
        m.running_mean.copy_(torch.randn(c, generator=gen) * 0.05)
        m.running_var.copy_(torch.rand(c, generator=gen) * 0.4 + 0.8)


def _scale_features(model, factor: float) -> None:
  """Scale the feature extractor's output by ``factor``: its last conv
  (Regular, no BN after it), or its last BN's weight and bias (Sphere,
  whose ReLU after the BN keeps the scaling)."""
  from mode_tpu_torch.models.disparity import SphereFeatureExtraction
  fe = model.feature_extraction
  with torch.no_grad():
    if isinstance(fe, SphereFeatureExtraction):
      fe.lastconv[4][1].weight.mul_(factor)
      fe.lastconv[4][1].bias.mul_(factor)
    else:
      fe.lastconv[2].weight.mul_(factor)


def _record_calls(model, left, right):
  """Run one call and record the kernel calls of the model's layers:
  ``{(kernel, x shape (NHWC / NDHWC), Cout, residual, relu, dilation):
  [layer names]}`` in call order, and the summed classifier logits."""
  from mode_tpu_torch.models.blocks import (ConvBn2d, Conv3dWeight, ConvBn3d,
                                            DeconvBn3d, SphereConvBn)
  calls, logits = {}, []

  def conv_hook(name):
    def hook(mod, args, kwargs, out):
      a = inspect.signature(mod.forward).bind(*args, **kwargs).arguments
      xs, cout, dil = tuple(a["x"].shape), out.shape[-1], 1
      if isinstance(mod, (ConvBn2d, SphereConvBn)):
        if isinstance(mod, ConvBn2d) and not a.get("fused", False):
          return                           # F.conv2d, not a kernel of ours
        kernel = (SPHERE_KERNELS[mod.sphere_type][0]
                  if isinstance(mod, SphereConvBn) else "conv2d_s1_bn_act")
        xs = (xs[0], xs[2], xs[3], xs[1])  # the NHWC shape of an NCHW view
        cout = out.shape[1]
        if isinstance(mod, ConvBn2d):
          dil = mod[0].dilation[0]
      elif isinstance(mod, DeconvBn3d):
        kernel = "deconv3d_bn_act"
      else:
        stride = (mod if isinstance(mod, Conv3dWeight) else mod[0]).stride
        kernel = "conv3d_s1_bn_act" if stride == 1 else "conv3d_s2_bn_act"
      key = (kernel, xs, cout, a.get("residual") is not None,
             bool(a.get("relu", False)), dil)
      calls.setdefault(key, []).append(name)
    return hook

  # a ConvBn3d runs its conv itself, so a Conv3dWeight is called (and its
  # hook fires) only where it stands alone: the classifier heads' last conv
  kinds = (ConvBn3d, DeconvBn3d, Conv3dWeight, ConvBn2d, SphereConvBn)
  handles = [m.register_forward_hook(conv_hook(n), with_kwargs=True)
             for n, m in model.named_modules() if isinstance(m, kinds)]
  handles += [getattr(model, f"classif{i}").register_forward_hook(
      lambda mod, args, out: logits.append(out)) for i in (1, 2, 3)]
  with torch.no_grad():
    model(left, right)
  for h in handles:
    h.remove()
  return calls, sum(logits)


def _served_model(label, gen):
  """The path's model with seeded weights and random BN statistics, its
  features scaled to unit std on a random pair's left view."""
  from mode_tpu_torch.models.disparity import ModeDisparity
  conv, sphere_type = PATHS[label][:2]
  h, w = GEOMETRY[sphere_type]
  model = ModeDisparity(MAXDISP, conv, sphere_type, out_conf=True,
                        device=DEVICE,
                        generator=torch.Generator().manual_seed(0))
  _randomize_for_serving(model, 1)
  left = torch.randn((1, h, w, 3), generator=gen, device=DEVICE) * 0.5
  feat_std = _calibrate(model, left)
  print(f"{label}: features scaled by 1/{feat_std:.4g} to unit std",
        flush=True)
  return model


def _calibrate(model, left) -> float:
  """Scale the served model's features to unit std. With random weights
  nothing calibrates the BN statistics, and the feature extractor's
  residual blocks grow the activations to ~1e6."""
  from mode_tpu_torch.device import ieee_f32_convs
  with torch.no_grad(), ieee_f32_convs():
    feat_std = float(model.feature_extraction(left).std())
  _scale_features(model, 1.0 / feat_std)
  return feat_std


def _scale_heads(model, raw_std: float) -> None:
  """Scale the three 1-channel classifier heads, which the final logits are
  linear in, so those have std ``LOGIT_STD``."""
  with torch.no_grad():
    for i in (1, 2, 3):
      getattr(model, f"classif{i}")[2].weight.mul_(LOGIT_STD / raw_std)


def _tpu_kernel(case, layers, batch):
  """The TPU kernel that ran these layers' calls (or, for the training
  step's calls, would run them)."""
  kernel, xs = case[:2]
  if kernel == "conv2d_s1_bn_act":
    return "K8" if xs[0] == 1 else "K9"
  if kernel == "deconv3d_bn_act" and xs[2] % 128 and xs[3] % 128:
    return "K7"                     # no lane axis: the folded deconv
  folded = {TPU_FOLDED.get(seg) for n in layers for seg in n.split(".")}
  folded.discard(None)
  return folded.pop() if folded else TPU_KERNEL[kernel]


def _pairs(gen, batch, count, first_shift, h, w):
  """``count`` calls of ``batch`` random ``h x w`` pairs; the right view is
  the left rolled along W by a shift that differs between pairs."""
  out = []
  for i in range(count):
    left = torch.randn((batch, h, w, 3), generator=gen, device=DEVICE) * 0.5
    right = torch.stack([torch.roll(left[b], shifts=first_shift + 8 * (
        i * batch + b) % 160, dims=1) for b in range(batch)])
    out.append((left, right.contiguous()))
  return out


def _check_output(label, pred, conf, ref_pred, ref_conf, shape,
                  seeded: bool = True,
                  bars: tuple = (PRED_MAE, PRED_MAX, CONF_MAE)):
  """A served call against its plain path at ``bars`` (pred MAE and max,
  conf MAE); with ``seeded`` weights also that the output is not
  degenerate."""
  pred_mae, pred_max, conf_bar = bars
  if pred.shape != shape or conf.shape != shape:
    _fail(f"{label}: output shapes {tuple(pred.shape)} {tuple(conf.shape)}")
  if not (torch.isfinite(pred).all() and torch.isfinite(conf).all()):
    _fail(f"{label}: non-finite outputs")
  # conf sums three probabilities; a round(pred) at a border clips one tap
  # onto the border slice, counted twice, so only there may conf exceed 1
  rp = pred.round()
  inner = (rp >= 1) & (rp <= MAXDISP - 2)
  if (conf < 0).any() or (conf[inner] > 1 + 1e-5).any() or (conf > 2).any():
    _fail(f"{label}: confidence out of range")
  err = (pred - ref_pred).abs()
  conf_mae = float((conf - ref_conf).abs().mean())
  print(f"{label} vs plain path (f32, one call): pred MAE "
        f"{float(err.mean()):.3g} px (bar {pred_mae}), max "
        f"{float(err.max()):.3g} px (bar {pred_max}), conf MAE {conf_mae:.3g}"
        f" (bar {conf_bar}); pred mean {float(pred.mean()):.3f} std "
        f"{float(pred.std()):.3f}, conf mean {float(conf.mean()):.4f}",
        flush=True)
  # as tests/test_torch_disparity.py: disparities spread and the softmax is
  # neither flat nor one-hot, so the comparison can see a wrong kernel
  if seeded and (float(pred.std()) <= 0.5 or float(conf.mean()) >= 0.9):
    _fail(f"{label}: degenerate output: pred std must exceed 0.5 px and "
          "conf mean stay below 0.9")
  if (float(err.mean()) > pred_mae or float(err.max()) > pred_max
      or conf_mae > conf_bar):
    _fail(f"{label}: the served path disagrees with its plain path")
  return {"pred_mae": float(err.mean()), "pred_max": float(err.max()),
          "conf_mae": conf_mae, "pred_std": float(pred.std()),
          "conf_mean": float(conf.mean())}


def _serve_path(label, model, gen, seed_shift):
  """Calibrate, record, serve and check one path; returns what it saw."""
  from mode_tpu_torch import kernels
  conv, sphere_type, batch, ncalls, jax_counts = PATHS[label]
  h, w = GEOMETRY[sphere_type]
  inputs = _pairs(gen, batch, ncalls + 1, seed_shift, h, w)
  calls, logits = _record_calls(model, *inputs[0])
  if label != "sphere_b6":          # the b6 path serves the b1 model as is
    _scale_heads(model, float(logits.std()))
  expect = {name: 0 for name in KERNELS}
  for case, layers in calls.items():
    expect[case[0]] += len(layers)
  expect["fused_disparity_regression"] = 1
  expect = {k: v for k, v in expect.items() if v}

  from mode_tpu_torch.device import ieee_f32_convs
  with torch.no_grad(), ieee_f32_convs():
    model(*inputs[0])                                 # warm-up
    torch.cuda.synchronize()
    fe_ms = _time_ms(lambda: model.feature_extraction(inputs[0][0]), 3) * 2
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  kernels.reset_launches()
  outputs, call_ms = [], []
  for left, right in inputs[1:]:
    t = time.perf_counter()
    outputs.append(model(left, right))
    torch.cuda.synchronize()
    call_ms.append((time.perf_counter() - t) * 1e3)
  launches = dict(kernels.LAUNCHES)
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  unit = "pair" if batch == 1 else f"{batch}-pair call"
  print(f"{label}: {conv} {sphere_type}, {ncalls} calls of ({batch}, {h}, "
        f"{w}, 3) maxdisp "
        f"{MAXDISP}, median {statistics.median(call_ms):.2f} ms/{unit} "
        f"(all: " + ", ".join(f"{t:.2f}" for t in call_ms)
        + f"), feature extraction of both views {fe_ms:.2f} ms, peak memory "
        f"{peak_gib:.2f} GiB", flush=True)
  print(f"{label} launches per call: " + json.dumps(
      {k: launches.get(k, 0) / ncalls for k in KERNELS})
        + " (JAX path: " + ", ".join(t for t, _ in jax_counts.values())
        + ")", flush=True)
  for name in set(expect) | set(launches):
    if launches.get(name, 0) != expect.get(name, 0) * ncalls:
      _fail(f"{label}: {name} launched {launches.get(name, 0)} times in "
            f"{ncalls} calls, expected {expect.get(name, 0) * ncalls}")
  wrong = {k: expect.get(k, 0) for k in set(expect) | set(jax_counts)
           if expect.get(k, 0) != jax_counts.get(k, ("", 0))[1]}
  if wrong:
    _fail(f"{label}: the layers called these kernels per call {wrong}, "
          f"not as the JAX path: {jax_counts}")

  with torch.no_grad():
    prof = _profile(model, inputs[1])
  print(f"{label} profiled call: host {prof['host_ms']:.2f} ms, device "
        f"{prof['device_ms']:.2f} ms; by kind (ms): "
        + json.dumps({k: round(v, 3) for k, v in prof["by_kind_ms"].items()})
        + "; top kernels (ms, launches): " + json.dumps(prof["top_kernels_ms"]),
        flush=True)
  pred, conf = outputs[0]
  with torch.no_grad():
    ref_pred, ref_conf = model(*inputs[1], plain=True)
  torch.cuda.synchronize()
  check = _check_output(label, pred, conf, ref_pred, ref_conf,
                        (batch, h, w))
  return {"calls": calls, "batch": batch, "ncalls": ncalls,
          "launches": launches, "call_ms": call_ms, "fe_ms": fe_ms,
          "peak_gib": peak_gib, "profile": prof, "check": check}


class _Calls(dict):
  """Recorded kernel calls by case, and the dtypes their inputs had."""

  def __init__(self):
    super().__init__()
    self.dtypes = set()


@contextlib.contextmanager
def _recorded_launches(tag: str = "step"):
  """Record every kernel launch of the op modules while the block runs:
  ``{(kernel, x shape (NHWC / NDHWC; the sphere conv's backward: the dx
  shape), Cout, residual, relu, dilation): [tag, ...]}``, one entry per
  launch, forward and backward alike; ``.dtypes`` the dtypes of their
  inputs."""
  from mode_tpu_torch.ops import conv2d, conv3d, sphere_conv
  calls = _Calls()

  def note(key, x):
    calls.setdefault(key, []).append(tag)
    calls.dtypes.add(x.dtype)

  def conv3d_launch(mode, x, weight, scale, bias, residual, relu,
                    h_halo=False):
    out = orig[0](mode, x, weight, scale, bias, residual, relu, h_halo)
    note((conv3d._NAMES[mode], tuple(x.shape), out.shape[-1],
          residual is not None, bool(relu), 1), x)
    return out

  def conv2d_launch(x, weight, scale, bias, residual, relu, dilation,
                    h_halo=False):
    out = orig[1](x, weight, scale, bias, residual, relu, dilation, h_halo)
    note(("conv2d_s1_bn_act", tuple(x.shape), out.shape[-1],
          residual is not None, bool(relu), dilation), x)
    return out

  # each sphere launch under the kernel name of its layout
  def sphere_launch(x, weight, scale, bias, residual, relu, sphere_type):
    out = orig[2](x, weight, scale, bias, residual, relu, sphere_type)
    note((sphere_conv.FORWARD[sphere_type], tuple(x.shape), out.shape[-1],
          residual is not None, bool(relu), 1), x)
    return out

  def bwd_input_launch(g, weight, sphere_type):
    dx = orig[3](g, weight, sphere_type)
    note((sphere_conv.BWD_INPUT[sphere_type], tuple(dx.shape), g.shape[-1],
          False, False, 1), g)
    return dx

  def bwd_weight_launch(x, g, sphere_type):
    dw = orig[4](x, g, sphere_type)
    note((sphere_conv.BWD_WEIGHT[sphere_type], tuple(x.shape), g.shape[-1],
          False, False, 1), x)
    return dw

  names = ((conv3d, "_launch", conv3d_launch),
           (conv2d, "_launch", conv2d_launch),
           (sphere_conv, "_launch", sphere_launch),
           (sphere_conv, "_launch_bwd_input", bwd_input_launch),
           (sphere_conv, "_launch_bwd_weight", bwd_weight_launch))
  orig = [getattr(mod, name) for mod, name, _ in names]
  for mod, name, fn in names:
    setattr(mod, name, fn)
  try:
    yield calls
  finally:
    for (mod, name, _), fn in zip(names, orig):
      setattr(mod, name, fn)


def _train_batch(gen, batch, h, w, device=None, maxdisp=None):
  """A uint8 pair (the right view the left rolled by 24 and 64 columns,
  in turns) and ground truth in [0, MAXDISP) with a NaN patch, on
  ``DEVICE`` (``device``, ``maxdisp``: a spawned rank's, from its
  parent)."""
  device = device or DEVICE
  left = torch.randint(0, 256, (batch, h, w, 3), generator=gen,
                       device=device, dtype=torch.uint8)
  right = torch.stack([torch.roll(left[b], -(24, 64)[b % 2], dims=1)
                       for b in range(batch)])
  gt = torch.rand((batch, h, w), generator=gen, device=device) * (
      maxdisp or MAXDISP)
  gt[:, 300:400, 100:220] = float("nan")
  return left, right.contiguous(), gt


def plain_stepper(model, make_step, inputs):
  """``plain_step(jgen, amount, **kw) -> (loss, gradients)``: one step of
  ``make_step(m, plain=True, **kw)`` (``plain=False`` in ``kw``: the
  kernel step) from a fresh copy ``m`` of ``model`` as
  it is now, on ``inputs`` (float tensors, then the target), the float
  inputs multiplied by ``1 + amount * N(0, 1)`` drawn from ``jgen`` and
  cast back to their dtype (unchanged if ``jgen`` is None)."""
  twin = copy.deepcopy(model)

  def plain_step(jgen, amount, **kw):
    m = copy.deepcopy(twin)
    step = make_step(m, **{"plain": True, **kw})
    xs = [x if jgen is None else (x.float() * (1 + amount * torch.randn(
        x.shape, generator=jgen, device=x.device))).to(x.dtype)
          for x in inputs[:-1]]
    loss = float(step(*xs, inputs[-1]))
    return loss, {n: p.grad for n, p in m.named_parameters()}

  return plain_step


def _against(grads, ref, spread, held):
  """``grads`` against ``ref`` on the ``held`` leaves: per leaf the error
  and the spread relative to the leaf's norm, and the least per-leaf bar it
  passes, ``max(0, err - 2 spread) / norm``; then the global error, norm
  and spread."""
  rows, err2, ref2, spread2 = [], 0.0, 0.0, 0.0
  for n in held:
    err = float(torch.linalg.vector_norm(grads[n] - ref[n]))
    norm = float(torch.linalg.vector_norm(ref[n]))
    err2, ref2, spread2 = err2 + err**2, ref2 + norm**2, spread2 + spread[n]**2
    rows.append({"leaf": n, "rel": err / norm, "spread_rel": spread[n] / norm,
                 "needs": max(0.0, err - 2 * spread[n]) / norm})
  return rows, err2**0.5, ref2**0.5, spread2**0.5


def grad_check(label, plain_step, kernel_loss, kernel_grads,
               dtype=torch.float32, jitter_seed=7, bars=None,
               own_spread=False):
  """Hold a kernel step's loss and gradients against the plain step of an
  identical model (``plain_step`` from :func:`plain_stepper`) at ``bars``
  (``STEP_BARS[dtype]`` if None); the jitter is drawn from
  ``jitter_seed``. With ``own_spread`` a leaf's spread is the larger of
  the plain step's and the kernel step's own (the same draws through
  ``plain_step(..., plain=False)``, against ``kernel_grads``): the kernel
  step's 3xTF32 products make it move more than the plain step under a
  jitter, on a few ill-conditioned leaves by as much as it parts from the
  plain step (scripts/train_cli_step_noise.py). In bf16
  also an f32 step against the same plain bf16 step, read at the same bars:
  what a step that ran no bf16 would need. Returns what it saw, ``ok``
  whether it is within the bars."""
  bars = bars or STEP_BARS[dtype]
  loss, grads = plain_step(None, 0.0)
  spread = dict.fromkeys(grads, 0.0)
  jgen = torch.Generator(device=DEVICE).manual_seed(jitter_seed)
  for _ in range(bars["draws"]):
    _, other = plain_step(jgen, bars["jitter"])
    for n, g in other.items():
      spread[n] = max(spread[n], float(torch.linalg.vector_norm(g - grads[n])))
  held = [n for n, g in grads.items() if bars["noise"] is None
          or spread[n] < bars["noise"] * float(torch.linalg.vector_norm(g))]
  if own_spread:
    jgen = torch.Generator(device=DEVICE).manual_seed(jitter_seed)
    for _ in range(bars["draws"]):
      _, other = plain_step(jgen, bars["jitter"], plain=False)
      for n, g in other.items():
        spread[n] = max(spread[n], float(torch.linalg.vector_norm(
            g - kernel_grads[n])))
  check = {"loss": kernel_loss, "plain_loss": loss,
           "loss_rel": abs(kernel_loss - loss) / abs(loss),
           "held_leaves": len(held), "leaves": len(grads)}
  check["ok"] = check["loss_rel"] <= bars["loss"]
  print(f"{label} step vs plain step ({_dtype_name(dtype)}): loss "
        f"{kernel_loss:.7g} vs {loss:.7g} (rel {check['loss_rel']:.3g}, bar "
        f"{bars['loss']}); gradients: " + (
            f"all {len(grads)} leaves held" if bars["noise"] is None else
            f"{len(held)} of {len(grads)} leaves move under {bars['draws']} "
            f"draws of a {bars['jitter']:.3g} input jitter by less than "
            f"{bars['noise']} of their norm and are held") + (
            "; the spread the larger of the plain step's and the kernel "
            "step's own" if own_spread else ""), flush=True)
  if not held:
    return check
  rows, err, ref, spread_all = _against(kernel_grads, grads, spread, held)
  most = max(rows, key=lambda r: r["needs"])
  check.update({
      "grad_rel_global": err / ref, "grad_spread_global": spread_all / ref,
      "grad_global_ratio": err / (bars["global"] * ref + 2 * spread_all),
      "global_needs": max(0.0, err - 2 * spread_all) / ref,
      "grad_rel_median": statistics.median(r["rel"] for r in rows),
      "leaf_needs": most["needs"], "worst_leaf": most,
      "largest_rel_leaf": max(rows, key=lambda r: r["rel"])})
  check["ok"] = check["ok"] and (most["needs"] <= bars["leaf"]
                                 and check["grad_global_ratio"] <= 1)
  print(f"{label} held gradients: global rel {err / ref:.3g} (spread "
        f"{spread_all / ref:.3g}; ratio to the bar "
        f"{check['grad_global_ratio']:.3g}), median leaf "
        f"{check['grad_rel_median']:.3g}; the leaf needing the widest bar "
        f"{most['leaf']}: rel {most['rel']:.3g}, spread "
        f"{most['spread_rel']:.3g}, needs {most['needs']:.3g} (bar "
        f"{bars['leaf']}); largest rel {check['largest_rel_leaf']['leaf']} "
        f"{check['largest_rel_leaf']['rel']:.3g}", flush=True)
  if dtype != torch.float32:
    f32_loss, f32_grads = plain_step(None, 0.0, compute_dtype=None)
    rows, err, _, _ = _against(f32_grads, grads, spread, held)
    f32 = max(rows, key=lambda r: r["needs"])
    check["f32_step"] = {
        "loss": f32_loss,
        "loss_rel": abs(kernel_loss - f32_loss) / abs(f32_loss),
        "grad_rel_global": err / ref, "leaf_needs": f32["needs"],
        "grad_global_ratio": err / (bars["global"] * ref + 2 * spread_all),
        "global_needs": max(0.0, err - 2 * spread_all) / ref,
        "worst_leaf": f32["leaf"]}
    print(f"{label}, an f32 step against the same plain bf16 step, read at "
          f"the same bars: loss {f32_loss:.7g} (the kernel step's rel gap to "
          f"it {check['f32_step']['loss_rel']:.3g}); held gradients global "
          f"rel {err / ref:.3g} (ratio to the bar "
          f"{check['f32_step']['grad_global_ratio']:.3g}), the leaf needing "
          f"the widest bar {f32['leaf']}: {f32['needs']:.3g}", flush=True)
  return check


def _dtype_name(dtype) -> str:
  return {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]


def _assert_f32_masters(label, model, optimizer) -> None:
  """Mixed precision keeps the parameters, their gradients, Adam's moments
  and the BN statistics in f32."""
  for n, p in model.named_parameters():
    state = optimizer.state[p]
    if {p.dtype, p.grad.dtype, state["exp_avg"].dtype,
        state["exp_avg_sq"].dtype} != {torch.float32}:
      _fail(f"{label}: {n} or its gradient or Adam state is not f32")
  for n, b in model.named_buffers():
    if n.endswith(("running_mean", "running_var")) and b.dtype != torch.float32:
      _fail(f"{label}: BN statistic {n} is {b.dtype}")


def _profile(fn, args, collectives: str | None = None):
  """One call ``fn(*args)`` under torch.profiler: device time by kind of
  kernel (ms) and the host time of the call; on the host, the operations
  with the most self CPU time (the autograd engine's backward thread
  included, so their sum may exceed the call's wall time) and the counts
  of the CUDA runtime and driver calls (``cuda*``, ``cu*``): kernel
  launches, synchronisations, copies; with ``collectives`` (a regex) the
  host share of the collectives it names (:func:`_allreduce_share`; a
  dict of regexes: each one's)."""
  from torch.profiler import ProfilerActivity, profile
  kinds = (("port: sphere conv backward", ("bwd_input_tc_kernel",
                                           "bwd_weight_tc_kernel",
                                           "reduce_splits_kernel")),
           ("port: sphere conv forward", ("sphere_conv_tc_kernel",)),
           ("port: 3-D convs", ("deconv3d_tc_kernel",
                                "conv3d_s1_tc_kernel", "conv3d_s2_tc_kernel",
                                "conv3d_head_kernel")),
           ("port: 2-D convs", ("conv2d_tc_kernel",)),
           ("port: regression head", ("regression",)),
           ("BatchNorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw",
                          "welford")),
           ("sort (the bridge's z-buffer)", ("sort",)),
           # (not "index": cuDNN's "indexed" weight-gradient kernels)
           ("gathers and scatters (the bridge)", ("scatter", "gather",
                                                  "index_elementwise",
                                                  "index_put",
                                                  "indexselect")),
           ("library convs (cuDNN: grad-weight, other convs)",
            ("cudnn", "fprop", "dgrad", "wgrad", "conv", "implicit")),
           ("matmul (the heads' upsample)", ("gemm", "gemv", "cutlass")),
           ("Adam", ("adam", "multi_tensor")))
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
  other = "other (elementwise, copies, reductions)"
  by_kind = {name: 0.0 for name, _ in kinds}
  by_kind[other] = 0.0
  by_name, host_ops, runtime, copies = {}, {}, {}, {}
  for e in prof.key_averages():
    for way in ("HtoD", "DtoH", "DtoD"):
      if way in e.key:
        copies[way] = copies.get(way, 0) + e.count
    if not str(getattr(e, "device_type", "")).endswith("CUDA"):
      self_ms = e.self_cpu_time_total / 1e3
      host_ops[e.key[:90]] = (self_ms, e.count)
      if re.match(r"cu(da)?[A-Z]", e.key):
        runtime[e.key] = (e.count, self_ms)
      continue
    ms = getattr(e, "self_device_time_total",
                 getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    key = e.key.lower()
    kind = next((name for name, subs in kinds
                 if any(sub in key for sub in subs)), other)
    by_kind[kind] += ms
    by_name[e.key[:90]] = (by_name.get(e.key[:90], (0.0, 0))[0] + ms,
                           e.count)
  device_ms = sum(by_kind.values())
  top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]
  top_host = sorted(host_ops.items(), key=lambda kv: -kv[1][0])[:16]

  def calls(*subs):
    return sum(n for k, (n, _) in runtime.items() if any(t in k for t in subs))

  extra = {}
  if isinstance(collectives, str):
    extra["collectives"] = _allreduce_share(prof.key_averages(), host_ms,
                                            collectives)
  elif collectives is not None:      # {kind: regex}: each kind's share
    extra["collectives"] = {k: _allreduce_share(prof.key_averages(), host_ms,
                                                pattern)
                            for k, pattern in collectives.items()}
  return {**extra, "host_ms": host_ms, "device_ms": device_ms,
          "idle_share": (1 - device_ms / host_ms) if device_ms else None,
          "by_kind_ms": by_kind,
          "top_kernels_ms": {k: [round(v[0], 3), v[1]] for k, v in top},
          "host_self_cpu_ms": sum(v[0] for v in host_ops.values()),
          "top_host_ops_ms": {k: [round(v[0], 3), v[1]] for k, v in top_host},
          "runtime_calls": {"launch_kernel": calls("LaunchKernel"),
                            "synchronize": calls("Synchronize"),
                            "stream_synchronize": calls("StreamSynchronize"),
                            "memcpy": calls("Memcpy"),
                            "device_copies": copies,
                            "by_name": {k: [n, round(ms, 3)] for k, (n, ms)
                                        in sorted(runtime.items())}}}


def _train_path(gen, label):
  """Drive one stage-1 training path: step 1 recorded and checked, three
  timed, one profiled."""
  from mode_tpu_torch import training
  from mode_tpu_torch.models.disparity import ModeDisparity
  sphere_type, batch_size, (h, w), dtype = TRAINS[label]
  cdt = None if dtype == torch.float32 else dtype
  model = ModeDisparity(MAXDISP, "Sphere", sphere_type, device=DEVICE,
                        generator=torch.Generator().manual_seed(0))
  batch = _train_batch(gen, batch_size, h, w)
  left, right, gt = batch
  make_step = functools.partial(_stage1_step, compute_dtype=cdt)
  plain_step = plain_stepper(model, make_step, (
      training.normalize_rgb_on_device(left),
      training.normalize_rgb_on_device(right), gt))
  optimizer = training.make_optimizer(model.parameters())
  step = training.make_disparity_train_step(model, optimizer,
                                            compute_dtype=cdt)
  desc = (f"Sphere {sphere_type}, {_dtype_name(dtype)}, ({batch_size}, {h}, "
          f"{w}, 3) uint8 pair, maxdisp {MAXDISP}, seeded weights")
  return _drive_training(label, model, optimizer, step, batch, plain_step,
                         train_expect(label), dtype, batch_size, desc)


def _drive_training(label, model, optimizer, step, args, plain_step, expect,
                    dtype, batch_size, desc):
  """Step 1 recorded (every kernel launch, each in the path's dtype) and
  held against the plain step (in bf16 also an f32 step read against it),
  the masters asserted f32 after the steps; three steps
  timed with the launch counts set to 0 before and read after; one
  profiled."""
  from mode_tpu_torch import kernels
  kernels.reset_launches()
  with _recorded_launches() as calls:
    t = time.perf_counter()
    losses = [float(step(*args))]
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
  first = dict(kernels.LAUNCHES)
  if calls.dtypes != {dtype}:
    _fail(f"{label}: the kernels took {calls.dtypes}, expected {dtype}")
  check = grad_check(label, plain_step, losses[0],
                     {n: p.grad.clone() for n, p in model.named_parameters()},
                     dtype)
  if not check["ok"]:
    _fail(f"{label}: the training step disagrees with its plain step")

  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  kernels.reset_launches()
  step_ms, enqueue_ms = [], []
  for _ in range(TRAIN_STEPS):
    t = time.perf_counter()
    loss = step(*args)
    # the step has returned: its work is enqueued (or run, where a call in
    # it waited for the device)
    enqueue_ms.append((time.perf_counter() - t) * 1e3)
    losses.append(float(loss))
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - t) * 1e3)
  launches = dict(kernels.LAUNCHES)
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  _assert_f32_masters(label, model, optimizer)
  per_step = {k: launches.get(k, 0) / TRAIN_STEPS for k in KERNELS}
  ms = statistics.median(step_ms[-2:])
  print(f"{label}: {desc}; step 1 {first_ms:.2f} ms, steps "
        f"2-{TRAIN_STEPS + 1} " + ", ".join(f"{t:.2f}" for t in step_ms)
        + f" ms: {ms:.2f} ms/step (median of the last two), "
        f"{ms / batch_size:.2f} ms/example, peak memory {peak_gib:.2f} GiB; "
        "host clock until the step returned " + ", ".join(
            f"{t:.2f}" for t in enqueue_ms) + " ms; loss "
        + " -> ".join(f"{x:.5g}" for x in losses), flush=True)
  print(f"{label} launches per step: " + json.dumps(per_step)
        + " (expected from the JAX gates traced at this shape: "
        + json.dumps(expect) + ")", flush=True)
  for name in set(expect) | set(launches) | set(first):
    want = expect.get(name, 0)
    if first.get(name, 0) != want or launches.get(name, 0) != want * TRAIN_STEPS:
      _fail(f"{label}: {name} launched {first.get(name, 0)} times in step 1 "
            f"and {launches.get(name, 0)} in {TRAIN_STEPS} steps, expected "
            f"{want} per step")
  if not losses[-1] < losses[0]:
    _fail(f"{label}: the loss did not fall over {TRAIN_STEPS + 1} steps")
  prof = _profile(step, args)
  print(f"{label} profiled step: host {prof['host_ms']:.2f} ms, device "
        f"{prof['device_ms']:.2f} ms; by kind (ms): "
        + json.dumps({k: round(v, 3) for k, v in prof["by_kind_ms"].items()})
        + "; top kernels (ms, launches): " + json.dumps(prof["top_kernels_ms"]),
        flush=True)
  rt = prof["runtime_calls"]
  print(f"{label} profiled step, host side: self CPU time of all host "
        f"operations {prof['host_self_cpu_ms']:.2f} ms; CUDA runtime calls: "
        f"{rt['launch_kernel']} kernel launches, {rt['synchronize']} "
        f"synchronisations, {rt['memcpy']} copies", flush=True)
  print(f"{label} profiled step, top host operations by self CPU time (ms, "
        "calls): " + json.dumps(prof["top_host_ops_ms"]), flush=True)
  print(f"{label} profiled step, CUDA runtime and driver calls (calls, self "
        "CPU ms): " + json.dumps(rt["by_name"]), flush=True)
  return {"calls": calls, "batch": batch_size, "ncalls": TRAIN_STEPS,
          "launches": launches, "call_ms": step_ms, "first_ms": first_ms,
          "enqueue_ms": enqueue_ms, "dtype": dtype,
          "peak_gib": peak_gib, "losses": losses, "profile": prof,
          "check": check}


def _fusion_batch(gen, batch, h, w):
  """A packed fusion frame on the card, in the wire dtypes of
  ``mode_tpu/data/fusion_pack.py``: six f16 depths in (1, MAX_DEPTH) m, six
  uint8 confidences, four uint8 views; and an f32 ground truth of which
  ~9% lies past MAX_DEPTH (masked out) and a patch is 0 (no depth)."""
  def u8(c):
    return torch.randint(0, 256, (batch, h, w, c), generator=gen,
                         device=DEVICE, dtype=torch.uint8)
  depths = [(torch.rand((batch, h, w, 1), generator=gen, device=DEVICE)
             * (MAX_DEPTH - 1) + 1).half() for _ in range(6)]
  gt = torch.rand((batch, h, w), generator=gen, device=DEVICE) * 1.1 * MAX_DEPTH
  gt[:, 300:400, 100:220] = 0.0
  return depths, [u8(1) for _ in range(6)], [u8(3) for _ in range(4)], gt


def _fusion_model(batch):
  """The fusion net with seeded weights and random BN affines, its 1x1
  head scaled and shifted to logits of mean 0 and std 1 on ``batch`` in
  training (the frame's calibration, with the batch's BN statistics)."""
  from mode_tpu_torch import training
  from mode_tpu_torch.models.fusion import ModeFusion
  model = ModeFusion(MAX_DEPTH, device=DEVICE,
                     generator=torch.Generator().manual_seed(0))
  _randomize_for_serving(model, 2)
  probe = copy.deepcopy(model).train()
  logits = []
  probe.feature_extraction.depth_layer7[2].register_forward_hook(
      lambda m, a, out: logits.append(out))
  with torch.no_grad():
    probe(*training.unpack_fusion_inputs(*batch[:3]))
  del probe
  mean, std = float(logits[0].mean()), float(logits[0].std())
  head = model.feature_extraction.depth_layer7[2]
  with torch.no_grad():
    head.weight.div_(std)
    head.bias.sub_(mean).div_(std)
  print(f"fusion training: head logits (mean, std) {mean:.4g}, {std:.4g} on "
        "the batch in training, scaled to 0, 1", flush=True)
  return model


def _fusion_train_path(label, init, batch):
  """Drive one fusion training path from the weights ``init`` on the packed
  frame ``batch``: the step takes the wire dtypes and unpacks them on the
  card; its plain twin takes the same inputs unpacked (and, as the f32
  step read against it in bf16, the same values in f32)."""
  from mode_tpu_torch import training
  batch_size, (h, w), dtype = FUSION_TRAINS[label]
  cdt = None if dtype == torch.float32 else dtype
  model = copy.deepcopy(init)
  unpacked = training.unpack_fusion_inputs(*batch[:3], dtype)
  make_step = functools.partial(fusion_step, compute_dtype=cdt)
  plain_step = plain_stepper(model, make_step, (
      *[x for part in unpacked for x in part], batch[3]))
  optimizer = training.make_optimizer(model.parameters())
  training.set_learning_rate(optimizer, training.FUSION_LR)
  step = training.make_fusion_train_step(model, optimizer, MAX_DEPTH,
                                         compute_dtype=cdt, raw_inputs=True)
  desc = (f"ModeFusion(1000, (32, 64, 128, 256)), {_dtype_name(dtype)}, "
          f"packed ({batch_size}, {h}, {w}) frame (f16 depths, uint8 "
          f"confidences and views), silog, lr {training.FUSION_LR:g}, "
          "seeded weights")
  return _drive_training(label, model, optimizer, step, batch, plain_step,
                         {"conv2d_s1_bn_act": 2 * FUSION_TRAIN_K9}, dtype,
                         batch_size, desc)


def _stage1_step(m, compute_dtype=None, plain=False):
  """``make_disparity_train_step`` of ``m`` with a fresh optimizer."""
  from mode_tpu_torch import training
  return training.make_disparity_train_step(
      m, training.make_optimizer(m.parameters()), compute_dtype=compute_dtype,
      plain=plain)


def fusion_step(m, compute_dtype=None, plain=False):
  """``make_fusion_train_step`` of ``m`` at ``FUSION_LR`` with a fresh
  optimizer, as ``step(*depths, *confs, *views, gt)`` on float maps, cast
  to ``compute_dtype`` (f32 if None) first."""
  from mode_tpu_torch import training
  opt = training.make_optimizer(m.parameters())
  training.set_learning_rate(opt, training.FUSION_LR)
  step = training.make_fusion_train_step(m, opt, MAX_DEPTH,
                                         compute_dtype=compute_dtype,
                                         plain=plain)
  dt = compute_dtype or torch.float32

  def run(*xs):
    return step(*([x.to(dt) for x in xs[a:b]]
                  for a, b in ((0, 6), (6, 12), (12, 16))), xs[16])

  return run


def _train_anchor(dtype=torch.float32, seed_shift=0):
  """The trained weights take one step through the kernels and one through
  the plain versions, in ``dtype`` (bf16: mixed precision), on the anchor's
  textured pair (disparity d; a NaN patch in the ground truth): where the
  gradient is well conditioned. ``seed_shift`` draws other pairs and
  another jitter (step_bar_study.py)."""
  from mode_tpu_torch import training
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.utils.convert import load_npz
  batch, (h, w) = TRAINS["train_b2"][1:3]
  with np.load(ROOT / "tests/data/fullres_torch_frame.npz") as z:
    seed, disp = int(z["seed"]), int(z["disp"])
  lefts, rights = zip(*(_make_anchor_batch(
      seed + batch * seed_shift + b, disp, h, w) for b in range(batch)))
  left = torch.cat(lefts).permute(0, 2, 3, 1).contiguous().to(DEVICE)
  right = torch.cat(rights).permute(0, 2, 3, 1).contiguous().to(DEVICE)
  gt = torch.full((batch, h, w), float(disp), device=DEVICE)
  gt[:, 300:400, 100:220] = float("nan")
  model = load_npz(ModeDisparity(MAXDISP, device=DEVICE),
                   ROOT / "tests/data/trained_mirror_mid.npz")
  cdt = None if dtype == torch.float32 else dtype
  make_step = functools.partial(_stage1_step, compute_dtype=cdt)
  plain_step = plain_stepper(model, make_step, (left, right, gt))
  loss = float(_stage1_step(model, cdt)(left, right, gt))
  return grad_check(f"train_anchor{'' if cdt is None else '_bf16'} "
                    "(trained weights)", plain_step, loss,
                    {n: p.grad for n, p in model.named_parameters()}, dtype,
                    7 + seed_shift)


# ---- rematerialisation and data parallelism ---------------------------------


def _memoized(plain_step):
  """``plain_step`` (:func:`plain_stepper`) that computes each call once:
  a call with the same jitter generator state, amount and keywords returns
  the first one's result and leaves the generator where that call did, so
  several :func:`grad_check` calls share one plain step and its draws."""
  cache = {}

  def step(jgen, amount, **kw):
    state = None if jgen is None else jgen.get_state()
    key = (None if state is None else bytes(state.numpy()), amount,
           tuple(sorted(kw.items(), key=lambda kv: kv[0])))
    if key not in cache:
      cache[key] = (plain_step(jgen, amount, **kw),
                    None if jgen is None else jgen.get_state())
    out, after = cache[key]
    if jgen is not None:
      jgen.set_state(after)
    return out

  return step


def _launch_check(label, got, want) -> None:
  for name in set(want) | set(got):
    if got.get(name, 0) != want.get(name, 0):
      _fail(f"{label}: {name} launched {got.get(name, 0)} times, expected "
            f"{want.get(name, 0)}")


def _grads_of(model) -> dict:
  return {n: p.grad.clone() for n, p in model.named_parameters()}


def _remat_phase(gen) -> dict:
  """``train_b2``'s step, f32 and bf16, with the feature extractor and
  hourglasses not rematerialised, under ``"save_convs"`` and under
  ``"full"``, each from an identical copy of the seeded model on the same
  batch: step 1's launches (``"save_convs"``: ``train_expect``; ``"full"``:
  that plus ``REMAT_FULL_RERUN``), in f32 its loss and gradients against
  one plain step at ``STEP_BARS`` (its spread under the input jitter);
  then ``REMAT_TURNS`` steps of each, the policies in turns, timed, each
  with its peak memory above what the phase held before it. Then one f32
  step at ``REMAT_BATCH`` under ``"save_convs"``, its kernel calls recorded
  for the kernel phase."""
  from mode_tpu_torch import kernels, training
  from mode_tpu_torch.models.disparity import ModeDisparity
  sphere_type, batch_size, (h, w), _ = TRAINS["train_b2"]
  init = ModeDisparity(MAXDISP, "Sphere", sphere_type, device=DEVICE,
                       generator=torch.Generator().manual_seed(0),
                       remat=False)
  batch = _train_batch(gen, batch_size, h, w)
  plain_step = _memoized(plain_stepper(init, _stage1_step, (
      training.normalize_rgb_on_device(batch[0]),
      training.normalize_rgb_on_device(batch[1]), batch[2])))
  out = {}
  for label, dtype in (("train_b2", torch.float32),
                       ("train_b2_bf16", torch.bfloat16)):
    cdt = None if dtype == torch.float32 else dtype
    expect = train_expect(label)
    steps = {}
    for policy, (remat, name) in REMAT_POLICIES.items():
      model = copy.deepcopy(init)
      model.remat, model.remat_policy = remat, name
      step = training.make_disparity_train_step(
          model, training.make_optimizer(model.parameters()),
          compute_dtype=cdt)
      kernels.reset_launches()
      loss = float(step(*batch))
      torch.cuda.synchronize()
      launches = dict(kernels.LAUNCHES)
      want = dict(expect)
      if policy == "full":
        want = {k: want.get(k, 0) + REMAT_FULL_RERUN.get(k, 0)
                for k in set(want) | set(REMAT_FULL_RERUN)}
      tag = f"remat {policy} {_dtype_name(dtype)}"
      _launch_check(tag, launches, want)
      if not np.isfinite(loss):
        _fail(f"{tag}: loss {loss}")
      check = {"loss": loss}
      if dtype == torch.float32:
        check = grad_check(tag, plain_step, loss, _grads_of(model))
        if not check["ok"]:
          _fail(f"{tag}: the step disagrees with its plain step")
      steps[policy] = step
      out[f"{policy}_{_dtype_name(dtype)}"] = {
          "launches": launches, "step_ms": [], "peak_gib": [],
          "step_peak_gib": [], **check}
      print(f"{tag} (remat={remat}, remat_policy={name!r}): launches "
            f"{json.dumps(launches)} (expected {json.dumps(want)})",
            flush=True)
    for _ in range(REMAT_TURNS):
      for policy, step in steps.items():
        rec = out[f"{policy}_{_dtype_name(dtype)}"]
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        rec["peak_gib"].append(peak / 2**30)
        rec["step_peak_gib"].append((peak - held) / 2**30)
    for policy in steps:
      rec = out[f"{policy}_{_dtype_name(dtype)}"]
      rec["ms_per_step"] = statistics.median(rec["step_ms"])
      print(f"remat {policy} {_dtype_name(dtype)}: ms/step "
            f"{', '.join(f'{t:.2f}' for t in rec['step_ms'])} (the policies "
            f"in turns; median {rec['ms_per_step']:.2f}); peak "
            f"{max(rec['peak_gib']):.2f} GiB, "
            f"{max(rec['step_peak_gib']):.2f} GiB above what the phase held "
            "before the step", flush=True)
    del steps, model, step
    torch.cuda.empty_cache()
  del plain_step, init
  torch.cuda.empty_cache()

  # one step at the batch that the rematerialisation is for
  model = ModeDisparity(MAXDISP, "Sphere", sphere_type, device=DEVICE,
                        generator=torch.Generator().manual_seed(0))
  optimizer = training.make_optimizer(model.parameters())
  step = training.make_disparity_train_step(model, optimizer)
  big = _train_batch(gen, REMAT_BATCH, h, w)
  torch.cuda.synchronize()
  held = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  kernels.reset_launches()
  with _recorded_launches() as calls:
    t = time.perf_counter()
    loss = float(step(*big))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
  peak = torch.cuda.max_memory_allocated()
  launches = dict(kernels.LAUNCHES)
  label = f"remat_b{REMAT_BATCH}"
  _launch_check(label, launches, train_expect("train_b2"))
  if calls.dtypes != {torch.float32}:
    _fail(f"{label}: the kernels took {calls.dtypes}, expected f32")
  if not np.isfinite(loss):
    _fail(f"{label}: loss {loss}")
  out[f"save_convs_b{REMAT_BATCH}"] = {
      "loss": loss, "ms": ms, "peak_gib": peak / 2**30,
      "step_peak_gib": (peak - held) / 2**30, "launches": launches}
  # the kernel phase holds and times every shape of this step
  out["seen"] = {label: {"calls": calls, "batch": REMAT_BATCH, "ncalls": 1,
                         "launches": launches, "dtype": torch.float32,
                         "train": True}}
  print(f"{label}: one f32 step at batch {REMAT_BATCH} ({h}x{w}, "
        f"save_convs): loss {loss:.6g}, {ms:.1f} ms (its first step), peak "
        f"{peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} above the "
        f"model and batch); launches as train_b2's; {len(calls)} kernel "
        "shapes recorded for the kernel phase", flush=True)
  del model, optimizer, step, big
  torch.cuda.empty_cache()
  return out


def _allreduce_share(prof_events, host_ms,
                     pattern: str = r"all_?reduce") -> dict:
  """The host time of the collectives in a profiled step against the
  step's host time: the events whose name matches ``pattern`` (the
  all-reduces by default), by name (their time with what they wait for; a
  backend's event and the dispatcher's around it are one span seen twice,
  so the share is the largest name's)."""
  spans = {e.key: e.cpu_time_total / 1e3 for e in prof_events
           if re.search(pattern, e.key, re.I)
           and not str(getattr(e, "device_type", "")).endswith("CUDA")}
  ms = max(spans.values(), default=0.0)
  return {"allreduce_ms": ms, "host_ms": host_ms, "spans_ms": spans,
          "share": ms / host_ms if host_ms else None}


def _profiled_step(step, args) -> dict:
  """One step under ``torch.profiler``: its host ms and the collectives'
  share (:func:`_allreduce_share`); the device time of the NCCL kernels."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t = time.perf_counter()
    step(*args)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
  events = prof.key_averages()
  out = _allreduce_share(events, host_ms)
  out["nccl_device_ms"] = sum(
      getattr(e, "self_device_time_total", 0.0) for e in events
      if "nccl" in e.key.lower()
      and str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3
  return out


def _ddp_nccl_phase(gen) -> dict:
  """``train_b2`` through the mesh-aware step on a process group of one
  rank on NCCL (``init_process_group`` in this process on a local store):
  its launches, the all-reduce path taken, step 1 against the plain step of
  an identical copy at ``STEP_BARS``; then the mesh step and the step
  without a mesh timed in turns, and one mesh step profiled."""
  import torch.distributed as dist
  from mode_tpu_torch import kernels, training
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.parallel.mesh import make_mesh
  sphere_type, batch_size, (h, w), _ = TRAINS["train_b2"]
  dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                          world_size=1)
  try:
    mesh = make_mesh(device=DEVICE)
    model = ModeDisparity(MAXDISP, "Sphere", sphere_type, device=DEVICE,
                          generator=torch.Generator().manual_seed(0))
    single = copy.deepcopy(model)
    batch = _train_batch(gen, batch_size, h, w)
    plain_step = plain_stepper(model, _stage1_step, (
        training.normalize_rgb_on_device(batch[0]),
        training.normalize_rgb_on_device(batch[1]), batch[2]))
    optimizer = training.make_optimizer(model.parameters())
    step = training.make_disparity_train_step(model, optimizer, mesh=mesh)
    built = mesh.collectives
    kernels.reset_launches()
    loss = float(step(*batch))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    _launch_check("ddp_nccl", launches, train_expect("train_b2"))
    if built < len(model.state_dict()) or mesh.collectives - built != 1:
      _fail(f"ddp_nccl: {built} broadcasts when built, "
            f"{mesh.collectives - built} all-reduces in the step: expected "
            "one broadcast per tensor and one gradient all-reduce")
    check = grad_check("ddp_nccl", plain_step, loss, _grads_of(model))
    if not check["ok"]:
      _fail("ddp_nccl: the step disagrees with its plain step")
    single_step = _stage1_step(single)
    single_step(*batch)
    times = {"mesh": [], "single": []}
    for label, fn in (("mesh", step), ("single", single_step),
                      ("single", single_step), ("mesh", step)):
      torch.cuda.synchronize()
      t = time.perf_counter()
      fn(*batch)
      torch.cuda.synchronize()
      times[label].append((time.perf_counter() - t) * 1e3)
    prof = _profiled_step(step, batch)
  finally:
    dist.destroy_process_group()
  out = {"launches": launches, "broadcasts": built,
         "ms_per_step": statistics.mean(times["mesh"]),
         "single_ms_per_step": statistics.mean(times["single"]),
         "step_ms": times, "profile": prof, **check}
  print(f"ddp_nccl: one NCCL rank, the mesh step {out['ms_per_step']:.2f} "
        f"ms/step against {out['single_ms_per_step']:.2f} without a mesh "
        f"(in turns: {json.dumps(times)}); {built} broadcasts when built, "
        f"one gradient all-reduce a step; profiled step: host "
        f"{prof['host_ms']:.2f} ms, collectives {prof['allreduce_ms']:.3f} "
        f"ms on the host, NCCL kernels {prof['nccl_device_ms']:.3f} ms on "
        "the card", flush=True)
  del model, single, optimizer, step, single_step, plain_step
  torch.cuda.empty_cache()
  return out


RANK_DEVICE = "cuda:0"
DDP_SEED, DDP_FUSION_SEED = 11, 12


def _ddp_stage1_batch():
  """The ranks' global stage-1 batch, the same on every process: a
  ``train_b2`` pair with a second NaN patch on the second example, so the
  two ranks' masks differ in size."""
  gen = torch.Generator(device=DEVICE).manual_seed(DDP_SEED)
  left, right, gt = _train_batch(gen, DDP_WORLD, *GEOMETRY["Cassini"])
  gt[1, 600:800, 50:400] = float("nan")
  return left, right, gt


def _ddp_fusion_batch():
  gen = torch.Generator(device=DEVICE).manual_seed(DDP_FUSION_SEED)
  batch_size, (h, w), _ = FUSION_TRAINS["fusion_train_b4"]
  return _fusion_batch(gen, batch_size, h, w)


def _ddp_rank(fusion_state: dict) -> dict:
  """One rank of ``ddp_gloo_2`` (run by :func:`_ddp_gloo_phase` in a
  process of its own): a stage-1 step of the seeded model on its pair of
  the global batch, launches counted, then two timed and one profiled;
  a fusion step from ``fusion_state`` on its half of the packed frame.
  Returns the losses, rank 0's gradients and BN statistics, and whether
  the ranks hold bit-equal parameters, gradients and buffers."""
  from mode_tpu_torch import kernels, training
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.models.fusion import ModeFusion
  from mode_tpu_torch.parallel import mesh as pmesh
  mesh = pmesh.make_mesh(device=RANK_DEVICE)
  out = {"rank": mesh.rank}
  model = ModeDisparity(MAXDISP, device=RANK_DEVICE,
                        generator=torch.Generator().manual_seed(0))
  optimizer = training.make_optimizer(model.parameters())
  step = training.make_disparity_train_step(model, optimizer, mesh=mesh)
  rows = pmesh.shard_batch(mesh, _ddp_stage1_batch())
  kernels.reset_launches()
  built = mesh.collectives
  out["loss"] = float(step(*rows))
  torch.cuda.synchronize()
  out["launches"] = dict(kernels.LAUNCHES)
  out["collectives"] = mesh.collectives - built
  params = list(model.parameters())
  out["same"] = pmesh.same_on_every_rank(
      params + [p.grad for p in params] + list(model.buffers()), mesh)
  if mesh.rank == 0:
    out["grads"] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    out["stats"] = {n: b.cpu() for n, b in model.named_buffers()
                    if n.endswith(("running_mean", "running_var"))}
  step_ms = []
  for _ in range(2):
    t = time.perf_counter()
    step(*rows)
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - t) * 1e3)
  out["step_ms"] = step_ms
  out["profile"] = _profiled_step(step, rows)
  out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
  del model, optimizer, step, rows
  torch.cuda.empty_cache()

  fusion = ModeFusion(MAX_DEPTH, device=RANK_DEVICE)
  fusion.load_state_dict({k: torch.from_numpy(v)
                          for k, v in fusion_state.items()})
  optimizer = training.make_optimizer(fusion.parameters())
  training.set_learning_rate(optimizer, training.FUSION_LR)
  step = training.make_fusion_train_step(fusion, optimizer, MAX_DEPTH,
                                         raw_inputs=True, mesh=mesh)
  rows = pmesh.shard_batch(mesh, list(_ddp_fusion_batch()))
  kernels.reset_launches()
  out["fusion_loss"] = float(step(*rows))
  torch.cuda.synchronize()
  out["fusion_launches"] = dict(kernels.LAUNCHES)
  params = list(fusion.parameters())
  out["fusion_same"] = pmesh.same_on_every_rank(
      params + [p.grad for p in params] + list(fusion.buffers()), mesh)
  if mesh.rank == 0:
    out["fusion_grads"] = {n: p.grad.cpu()
                           for n, p in fusion.named_parameters()}
  return out


def _ddp_gloo_phase(fusion_state: dict, card: str) -> dict:
  """Two ranks on the one card over gloo, each a process of its own
  (``parallel/launch.py``), on ``train_b2``'s seeded model and a global
  batch of two pairs with NaN patches of different sizes, then on a
  fusion step of ``fusion_train_b4``'s packed frame: each rank's launches
  at its batch (``RANK_TRACED``; the fusion net's at two), the ranks
  bit-equal after each step, and rank 0's loss, gradients and BN
  statistics against this process's step at the global batch from the
  same weights: the loss and gradients at ``STEP_BARS`` against its
  plain step (the spread under the input jitter), the statistics
  against its kernel step within 1e-3 of each one's norm. A rank that
  fails fails the phase."""
  from mode_tpu_torch import training
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.models.fusion import ModeFusion
  from mode_tpu_torch.parallel.launch import run_ranks
  t0 = time.perf_counter()
  ranks = run_ranks(_ddp_rank, DDP_WORLD, ({k: v.cpu().numpy() for k, v in
                                            fusion_state.items()},),
                    timeout=600, device=RANK_DEVICE, backend="gloo")
  wall = time.perf_counter() - t0
  per_rank = traced_launches(RANK_TRACED)
  for r in ranks:
    label = f"ddp_gloo_2 rank {r['rank']}"
    _launch_check(label, r["launches"], per_rank)
    _launch_check(f"{label} fusion", r["fusion_launches"],
                  {"conv2d_s1_bn_act": 2 * FUSION_TRAIN_K9})
    if not (r["same"] and r["fusion_same"]):
      _fail(f"{label}: the ranks' parameters, gradients or buffers parted")
    if (r["loss"], r["fusion_loss"]) != (ranks[0]["loss"],
                                         ranks[0]["fusion_loss"]):
      _fail(f"{label}: its loss is not rank 0's")
  rank0 = ranks[0]
  # this process's step at the global batch, from the same weights
  model = ModeDisparity(MAXDISP, device=DEVICE,
                        generator=torch.Generator().manual_seed(0))
  batch = _ddp_stage1_batch()
  plain_step = plain_stepper(model, _stage1_step, (
      training.normalize_rgb_on_device(batch[0]),
      training.normalize_rgb_on_device(batch[1]), batch[2]))
  _stage1_step(model)(*batch)
  check = grad_check("ddp_gloo_2 rank 0", plain_step, rank0["loss"],
                     {n: torch.from_numpy(g).to(DEVICE)
                      for n, g in rank0["grads"].items()})
  if not check["ok"]:
    _fail("ddp_gloo_2: rank 0's step disagrees with the one-process step")
  stats_rel = 0.0
  for n, b in model.named_buffers():
    if n in rank0["stats"]:
      err = float(torch.linalg.vector_norm(
          torch.from_numpy(rank0["stats"][n]).to(DEVICE) - b))
      stats_rel = max(stats_rel, err / float(torch.linalg.vector_norm(b)))
  if stats_rel > GRAD_RTOL:
    _fail(f"ddp_gloo_2: rank 0's BN statistics part from the one-process "
          f"step's by {stats_rel:.3g} of their norm")
  del model, plain_step
  torch.cuda.empty_cache()
  fusion = ModeFusion(MAX_DEPTH, device=DEVICE)
  fusion.load_state_dict(fusion_state)
  fbatch = _ddp_fusion_batch()
  unpacked = training.unpack_fusion_inputs(*fbatch[:3])
  plain_step = plain_stepper(fusion, fusion_step, (
      *[x for part in unpacked for x in part], fbatch[3]))
  fcheck = grad_check("ddp_gloo_2 rank 0 fusion", plain_step,
                      rank0["fusion_loss"],
                      {n: torch.from_numpy(g).to(DEVICE)
                       for n, g in rank0["fusion_grads"].items()})
  if not fcheck["ok"]:
    _fail("ddp_gloo_2: rank 0's fusion step disagrees with the one-process "
          "step")
  del fusion, plain_step
  torch.cuda.empty_cache()
  out = {"wall_s": wall, "stats_rel": stats_rel, "check": check,
         "fusion_check": fcheck,
         "ranks": [{k: r[k] for k in ("rank", "loss", "fusion_loss",
                                      "launches", "fusion_launches",
                                      "collectives", "step_ms", "profile",
                                      "peak_gib")}
                   for r in ranks]}
  prof = rank0["profile"]
  print(f"ddp_gloo_2: two gloo ranks on one card ({card}), {wall:.1f} s "
        f"with the processes' start; rank 0 ms/step "
        f"{', '.join(f'{t:.1f}' for t in rank0['step_ms'])}, profiled step "
        f"host {prof['host_ms']:.1f} ms of which collectives "
        f"{prof['allreduce_ms']:.1f} ms ({100 * prof['share']:.1f}%), "
        f"{rank0['collectives']} collectives a step; launches a rank "
        f"{json.dumps(rank0['launches'])}; BN statistics {stats_rel:.3g} of "
        "their norm from the one-process step", flush=True)
  return out


# The spatial axis (parallel/shard_ops.py): sp_gloo_2 serves one sphere_b1
# pair on a (data 1, spatial 2) mesh of two gloo ranks sharing the card, the
# trained mid weights at 1024x512, in f32 and in bf16. Per call a rank runs
# the whole feature extractor (so the served path's sphere and 2-D
# launches) and its rows of the 3-D stack: every 3-D conv on its halo form
# after one halo exchange, and K2 on its output rows after one gather.
SP_WORLD = 2
SP_SEED_SHIFT, SP_DISP, SP_CALLS = 200, 40, 3
SP_HALO = {"conv3d_s1_bn_act": 16, "conv3d_s2_bn_act": 6,
           "deconv3d_bn_act": 6, "fused_disparity_regression": 1}
SP_HEADS = 3                            # the Cout-1 heads among the 16
SP_COLLECTIVES = 16 + 6 + 6 + 1         # 28 halo exchanges, K2's gather
# the halo forms' rows in the kernel phase: a rank's rows of the served
# path's 3-D calls at these spatial sizes (sp_gloo_2 runs the first)
SP_SIZES = (2, 4)
# the TPU kernels' halo forms (the m_halo / row-window code) and the JAX
# package's sharded wrappers around them
SHARD_PY = "mode_tpu/parallel/shard_ops.py"
HALO_KERNELS = {
    "conv3d_s1_bn_act": (f"{CONV_PY}:273", f"{SHARD_PY}:54"),
    "conv3d_s2_bn_act": (f"{CONV_PY}:484", f"{SHARD_PY}:87"),
    "deconv3d_bn_act": (f"{CONV_PY}:681", f"{SHARD_PY}:117"),
    "fused_disparity_regression": (
        "mode_tpu/ops/pallas/regression_kernel.py:107", f"{SHARD_PY}:238"),
    "conv2d_s1_bn_act": (f"{CONV2D_PY}:168", f"{SHARD_PY}:151")}
# the phase whose rank's calls a halo form's kernels-line entry counts
# (sp_gloo_2 unless named): K8's halo form serves the fusion net's rows
HALO_PHASE = {"conv2d_s1_bn_act": "sp_frame_gloo_2"}


def _sp_pair(device, h, w):
  """The sp phase's pair, the same on every process: the anchor's textured
  inputs (``_make_anchor_batch``) at ``h x w``, NHWC f32."""
  with np.load(ROOT / "tests/data/fullres_torch_frame.npz") as z:
    seed = int(z["seed"]) + SP_SEED_SHIFT
  return tuple(x.permute(0, 2, 3, 1).contiguous().to(device)
               for x in _make_anchor_batch(seed, SP_DISP, h, w))


def _sp_model(device, maxdisp, sphere_type="Cassini"):
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.utils.convert import load_npz
  return load_npz(ModeDisparity(maxdisp, "Sphere", sphere_type, out_conf=True,
                                device=device),
                  ROOT / "tests/data/trained_mirror_mid.npz")


def _sp_call(fn, args, mesh, device, calls: int, profile: bool) -> dict:
  """One call ``fn(*args)`` of a rank under ``mesh`` after a warm-up, with
  the launch counts and the collectives set to 0 before and read after,
  its outputs on the host; then ``calls`` calls timed and, with
  ``profile``, one profiled."""
  from mode_tpu_torch import kernels
  cuda = torch.device(device).type == "cuda"

  def sync():                      # (a CPU rehearsal's ranks have no card)
    if cuda:
      torch.cuda.synchronize(device)

  fn(*args)                                         # warm-up
  sync()
  kernels.reset_launches()
  before = mesh.collectives
  outputs = fn(*args)
  sync()
  got = {"launches": dict(kernels.LAUNCHES),
         "halo": dict(kernels.HALO_LAUNCHES),
         "collectives": mesh.collectives - before, "outputs": outputs}
  call_ms = []
  for _ in range(calls):
    t = time.perf_counter()
    fn(*args)
    sync()
    call_ms.append((time.perf_counter() - t) * 1e3)
  got["call_ms"] = call_ms
  got["profile"] = (_profile(fn, args, collectives=r"all_?gather")
                    if cuda and profile else None)
  return got


def _sp_rank(device: str, hw: tuple, erp_hw: tuple, maxdisp: int) -> dict:
  """One rank of ``sp_gloo_2`` (run by :func:`_sp_gloo_phase` in a process
  of its own): the trained model on the pair under the mesh, its layers'
  kernel calls recorded on the first call; then in f32 and in bf16 (conv
  weights cast, ``training.cast_conv_params``) one call with the launch
  counts and the collectives set to 0 before and read after, its rows
  gathered into the whole maps, ``SP_CALLS`` calls timed and one
  profiled; then the ERP model on its ``erp_hw`` pair the same way, f32,
  unprofiled. ``device``, ``hw``, ``erp_hw`` and ``maxdisp`` come from the
  parent (the pairs' card and shapes)."""
  from mode_tpu_torch.parallel import mesh as pmesh
  from mode_tpu_torch.training import cast_conv_params
  cuda = torch.device(device).type == "cuda"
  mesh = pmesh.make_mesh(data=1, spatial=SP_WORLD, device=device)
  out = {"place": (mesh.rank, mesh.spatial_rank)}

  def serve(label, m, args, profile):
    got = _sp_call(m, args, mesh, device, SP_CALLS, profile)
    pred, conf = got.pop("outputs")
    got["rows"] = tuple(pred.shape)
    got["pred"], got["conf"] = (pmesh.gather_rows(t, 1, mesh).cpu()
                                for t in (pred, conf))
    out[label] = got

  with pmesh.activate(mesh), torch.no_grad():
    model = _sp_model(device, maxdisp)
    left, right = _sp_pair(device, *hw)
    out["calls"] = _record_calls(model, left, right)[0]
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
      m = model if dtype == torch.float32 else cast_conv_params(
          copy.deepcopy(model), dtype).eval()
      serve(label, m, (left.to(dtype), right.to(dtype)), True)
    del model, m
    serve("erp", _sp_model(device, maxdisp, "ERP"), _sp_pair(device, *erp_hw),
          False)
  out["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30 if cuda
                     else None)
  return out


def _sp_gloo_phase(card: str) -> dict:
  """``sp_gloo_2``: two gloo ranks sharing the card on a ``(1, 2)`` mesh
  (``parallel/launch.py``), each serving the trained model on its rows of
  one 1024x512 pair, then the ERP model on its rows of one 512x1024 pair.
  Each rank's launches must be one process's per pair
  (``PATHS["sphere_b1"]``'s and ``PATHS["erp_b1"]``'s counts), ``SP_HALO``
  of them on the halo forms (``SP_HEADS`` heads among the stride-1 convs),
  with ``SP_COLLECTIVES`` collectives a call; the f32 maps gathered from
  both ranks must hold the one-process kernel path at
  ``PRED_MAE``/``PRED_MAX``/``CONF_MAE`` (Cassini and ERP), and the bf16
  maps the f32 ones within ``BF16_DISP_MAE``. A rank that fails fails the
  phase. Returns the rank's recorded 3-D calls too, which the kernel phase
  times at their haloed shapes."""
  from mode_tpu_torch.parallel.launch import run_ranks
  t0 = time.perf_counter()
  ranks = run_ranks(_sp_rank, SP_WORLD,
                    (RANK_DEVICE, GEOMETRY["Cassini"], GEOMETRY["ERP"],
                     MAXDISP), timeout=600, device=RANK_DEVICE,
                    backend="gloo")
  wall = time.perf_counter() - t0
  served = {label: {k: n for k, (_, n) in PATHS[path][4].items()}
            for label, path in (("f32", "sphere_b1"), ("bf16", "sphere_b1"),
                                ("erp", "erp_b1"))}
  for r, rank in enumerate(ranks):
    label = f"sp_gloo_2 rank {r}"
    if rank["place"] != (0, r):
      _fail(f"{label}: mesh place {rank['place']}, expected (0, {r})")
    heads = sum(len(layers) for case, layers in rank["calls"].items()
                if case[0] == "conv3d_s1_bn_act" and case[2] == 1)
    if heads != SP_HEADS:
      _fail(f"{label}: {heads} Cout-1 heads, expected {SP_HEADS}")
    for dtype in ("f32", "bf16", "erp"):
      got = rank[dtype]
      h, w = GEOMETRY["ERP" if dtype == "erp" else "Cassini"]
      _launch_check(f"{label} {dtype}", got["launches"], served[dtype])
      if got["halo"] != SP_HALO:
        _fail(f"{label} {dtype}: halo launches {got['halo']}, expected "
              f"{SP_HALO}")
      if got["collectives"] != SP_COLLECTIVES:
        _fail(f"{label} {dtype}: {got['collectives']} collectives a call, "
              f"expected {SP_COLLECTIVES}")
      if got["rows"] != (1, h // SP_WORLD, w):
        _fail(f"{label} {dtype}: its rows have the shape {got['rows']}")
    if not all(np.array_equal(rank[d][k], ranks[0][d][k])
               for d in ("f32", "bf16", "erp") for k in ("pred", "conf")):
      _fail(f"{label}: its gathered maps are not rank 0's")
  # the one-process kernel path on the same pairs
  checks = {}
  for label, sphere_type in (("f32", "Cassini"), ("erp", "ERP")):
    model = _sp_model(DEVICE, MAXDISP, sphere_type)
    left, right = _sp_pair(DEVICE, *GEOMETRY[sphere_type])
    with torch.no_grad():
      ref_pred, ref_conf = model(left, right)
    torch.cuda.synchronize()
    got = {k: torch.from_numpy(ranks[0][label][k]).to(DEVICE)
           for k in ("pred", "conf")}
    checks[label] = _check_output(
        f"sp_gloo_2 {sphere_type} f32 (gathered) vs one process",
        got["pred"], got["conf"], ref_pred, ref_conf,
        (1, *GEOMETRY[sphere_type]), seeded=False)
    del model
  f32, b16 = ({k: torch.from_numpy(ranks[0][d][k]).to(DEVICE)
               for k in ("pred", "conf")} for d in ("f32", "bf16"))
  bf16_mae = float((b16["pred"] - f32["pred"]).abs().mean())
  if not (torch.isfinite(b16["pred"]).all()
          and torch.isfinite(b16["conf"]).all()) or bf16_mae > BF16_DISP_MAE:
    _fail(f"sp_gloo_2: the bf16 maps are {bf16_mae:.4g} px (MAE) from the "
          f"f32 ones (bar {BF16_DISP_MAE})")
  torch.cuda.empty_cache()
  out = {"wall_s": wall, "check": checks["f32"], "erp_check": checks["erp"],
         "bf16_vs_f32_mae": bf16_mae,
         "ranks": [{"place": r["place"], "peak_gib": r["peak_gib"],
                    **{d: {k: r[d][k] for k in ("launches", "halo",
                                                "collectives", "call_ms",
                                                "profile")}
                       for d in ("f32", "bf16", "erp")}} for r in ranks],
         "calls": ranks[0]["calls"]}
  for d in ("f32", "bf16", "erp"):
    prof = ranks[0][d]["profile"] or {"host_ms": 0.0, "device_ms": 0.0,
                                      "collectives": {"allreduce_ms": 0.0}}
    print(f"sp_gloo_2 {d}: two gloo ranks on one card ({card}), rank 0 "
          f"ms/call {', '.join(f'{t:.1f}' for t in ranks[0][d]['call_ms'])}"
          f" (both ranks share the card); profiled call host "
          f"{prof['host_ms']:.1f} ms, device {prof['device_ms']:.1f} ms, "
          f"all-gathers {prof['collectives']['allreduce_ms']:.1f} ms on the "
          f"host; launches a rank {json.dumps(ranks[0][d]['launches'])}, "
          f"halo forms {json.dumps(ranks[0][d]['halo'])}, "
          f"{ranks[0][d]['collectives']} collectives a call", flush=True)
  print(f"sp_gloo_2: {wall:.1f} s with the processes' start; bf16 maps "
        f"{bf16_mae:.4g} px from the f32 ones (bar {BF16_DISP_MAE})",
        flush=True)
  return out


# The whole frame over the spatial axis: sp_frame_gloo_2 serves the frame
# phase's frame (TwoStagePipeline, six 1024x512 uint8 pairs and four views,
# the trained mid weights, the frame's calibrated fusion net) on a (1, 2)
# mesh of two gloo ranks sharing the card, f32 and bf16. Per frame a rank
# runs stage 1's one call on its rows (SP_HALO), gathers the disparities
# and confidences, runs the bridge whole, the fusion net on its rows (its
# FUSION_K8 kernel convs on K8's halo form, depth_layer4's two on cuDNN,
# FUSION_CONVS halo exchanges) and gathers the fused map.
FUSION_CONVS = 38                  # the fusion net's stride-1 3x3 convs
SP_FRAME_HALO = {**SP_HALO, "conv2d_s1_bn_act": FUSION_K8}
SP_FRAME_COLLECTIVES = SP_COLLECTIVES + 2 + FUSION_CONVS + 1
SP_FRAME_CALLS = 2


def _sp_frame_rank(device: str, hw: tuple, maxdisp: int,
                   fusion_state: dict) -> dict:
  """One rank of ``sp_frame_gloo_2`` (run by :func:`_sp_frame_phase`): the
  frame served under the mesh, its kernel launches recorded on the first
  f32 frame (``_recorded_launches``: the haloed shapes); then in f32 and
  in bf16 (both stages) one frame with the counts and the collectives set
  to 0 before and read after, ``SP_FRAME_CALLS`` frames timed and one
  profiled. ``device``, ``hw`` and ``maxdisp`` come from the parent."""
  from mode_tpu_torch.models.fusion import ModeFusion
  from mode_tpu_torch.parallel import mesh as pmesh
  from mode_tpu_torch.pipeline import TwoStagePipeline
  cuda = torch.device(device).type == "cuda"
  mesh = pmesh.make_mesh(data=1, spatial=SP_WORLD, device=device)
  disp = _sp_model(device, maxdisp)
  fusion = ModeFusion(MAX_DEPTH, device=device)
  fusion.load_state_dict(fusion_state, strict=True)
  inputs = _frame_inputs(device, hw)
  out = {"place": (mesh.rank, mesh.spatial_rank)}
  with pmesh.activate(mesh), torch.no_grad():
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
      pipe = TwoStagePipeline(disp, fusion, maxdisp, MAX_DEPTH, dtype=dtype,
                              stage1_chunk=6, uint8_inputs=True,
                              fusion_dtype=dtype, device=device)
      if label == "f32":
        with _recorded_launches("sp_frame") as calls:
          pipe(*inputs)
        out["calls"] = dict(calls)
      got = _sp_call(pipe, inputs, mesh, device, SP_FRAME_CALLS, True)
      got.update(zip(("fused", "disp", "conf"),
                     (t.cpu() for t in got.pop("outputs"))))
      out[label] = got
  out["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30 if cuda
                     else None)
  return out


def _sp_frame_phase(card: str, fusion_state: dict, ref: dict) -> dict:
  """``sp_frame_gloo_2``: two gloo ranks sharing the card on a ``(1, 2)``
  mesh, each serving the whole frame. Each rank's launches a frame must be
  one process's (``FRAME_JAX``), ``SP_FRAME_HALO`` of them on the halo
  forms, with ``SP_FRAME_COLLECTIVES`` collectives a frame, and both ranks
  must return the same whole frame; the f32 frame must hold the
  one-process ``frame`` (``ref``: its fused map, disparities and
  confidences): stage 1 at ``PRED_MAE``/``PRED_MAX``/``CONF_MAE``, the fused
  depths at ``FUSED_MAE``/``FUSED_MAX``, ``FUSED_INSIDE`` of them inside
  (1, 999) m; the bf16 disparities the f32 ones within ``BF16_DISP_MAE``.
  Returns the rank's recorded 2-D halo calls too, which the kernel phase
  times."""
  from mode_tpu_torch.parallel.launch import run_ranks
  t0 = time.perf_counter()
  ranks = run_ranks(_sp_frame_rank, SP_WORLD,
                    (RANK_DEVICE, GEOMETRY["Cassini"], MAXDISP, fusion_state),
                    timeout=600, device=RANK_DEVICE, backend="gloo")
  wall = time.perf_counter() - t0
  h, w = GEOMETRY["Cassini"]
  frame = {k: n for k, (_, n) in FRAME_JAX.items()}
  for r, rank in enumerate(ranks):
    label = f"sp_frame_gloo_2 rank {r}"
    if rank["place"] != (0, r):
      _fail(f"{label}: mesh place {rank['place']}, expected (0, {r})")
    for dtype in ("f32", "bf16"):
      got = rank[dtype]
      _launch_check(f"{label} {dtype}", got["launches"], frame)
      if got["halo"] != SP_FRAME_HALO:
        _fail(f"{label} {dtype}: halo launches {got['halo']}, expected "
              f"{SP_FRAME_HALO}")
      if got["collectives"] != SP_FRAME_COLLECTIVES:
        _fail(f"{label} {dtype}: {got['collectives']} collectives a frame, "
              f"expected {SP_FRAME_COLLECTIVES}")
      if got["fused"].shape != (h, w) or got["disp"].shape != (6, h, w):
        _fail(f"{label} {dtype}: a frame of shapes {got['fused'].shape}, "
              f"{got['disp'].shape}")
    if not all(np.array_equal(rank[d][k], ranks[0][d][k])
               for d in ("f32", "bf16") for k in ("fused", "disp", "conf")):
      _fail(f"{label}: its frame is not rank 0's")
  f32, b16 = ({k: torch.from_numpy(ranks[0][d][k]).to(DEVICE)
               for k in ("fused", "disp", "conf")} for d in ("f32", "bf16"))
  check = {"stage1": _check_output(
      "sp_frame_gloo_2 f32 stage 1 (gathered) vs one process", f32["disp"],
      f32["conf"], ref["disp"], ref["conf"], (6, h, w), seeded=False)}
  err = (f32["fused"] - ref["fused"]).abs()
  inside = float(((f32["fused"] > 1) & (f32["fused"] < MAX_DEPTH - 1))
                 .float().mean())
  check["fused"] = {"mae": float(err.mean()), "max": float(err.max()),
                    "inside_share": inside}
  bf16_mae = float((b16["disp"] - f32["disp"]).abs().mean())
  check["bf16_disp_mae_vs_f32"] = bf16_mae
  check["bf16_fused_mae_vs_f32"] = float(
      (b16["fused"] - f32["fused"]).abs().mean())
  print(f"sp_frame_gloo_2 f32 fused (gathered) vs one process: MAE "
        f"{check['fused']['mae']:.3g} m (bar {FUSED_MAE}), max "
        f"{check['fused']['max']:.3g} m (bar {FUSED_MAX}), {inside:.1%} "
        f"inside (1, {MAX_DEPTH - 1:g}) m; bf16 disparities {bf16_mae:.4g} px"
        f" (MAE) from the f32 ones (bar {BF16_DISP_MAE}), fused "
        f"{check['bf16_fused_mae_vs_f32']:.4g} m (no bar)", flush=True)
  if not bool(torch.isfinite(f32["fused"]).all()):
    _fail("sp_frame_gloo_2: non-finite fused depths")
  if check["fused"]["mae"] > FUSED_MAE or check["fused"]["max"] > FUSED_MAX:
    _fail("sp_frame_gloo_2: the fused map disagrees with one process's")
  if inside < FUSED_INSIDE:
    _fail("sp_frame_gloo_2: degenerate fused depth")
  if not bool(torch.isfinite(b16["fused"]).all()) or bf16_mae > BF16_DISP_MAE:
    _fail("sp_frame_gloo_2: the bf16 frame drifts from the f32 frame")
  torch.cuda.empty_cache()
  out = {"wall_s": wall, "check": check,
         "ranks": [{"place": r["place"], "peak_gib": r["peak_gib"],
                    **{d: {k: r[d][k] for k in ("launches", "halo",
                                                "collectives", "call_ms",
                                                "profile")}
                       for d in ("f32", "bf16")}} for r in ranks],
         "calls": ranks[0]["calls"]}
  for d in ("f32", "bf16"):
    prof = ranks[0][d]["profile"] or {"host_ms": 0.0, "device_ms": 0.0,
                                      "collectives": {"allreduce_ms": 0.0}}
    print(f"sp_frame_gloo_2 {d}: two gloo ranks on one card ({card}), rank "
          f"0 ms/frame "
          f"{', '.join(f'{t:.1f}' for t in ranks[0][d]['call_ms'])} (both "
          f"ranks share the card); profiled frame host "
          f"{prof['host_ms']:.1f} ms, device {prof['device_ms']:.1f} ms, "
          f"all-gathers {prof['collectives']['allreduce_ms']:.1f} ms on the "
          f"host; halo forms {json.dumps(ranks[0][d]['halo'])}, "
          f"{ranks[0][d]['collectives']} collectives a frame", flush=True)
  print(f"sp_frame_gloo_2: {wall:.1f} s with the processes' start",
        flush=True)
  return out


# Training over the spatial axis: sp_train_gloo_2 runs train_b2's step
# (the seeded weights, a batch made as _train_batch makes train_b2's, from
# SP_TRAIN_SEED) on a (data 1, spatial 2) mesh of two gloo ranks sharing the
# card, both ranks on the whole global batch of 2: each runs the feature
# extractor whole and its half of the cost volume's rows, every 3-D kernel
# conv on its halo form, forward and grad-input. f32 and bf16, SP_TRAIN_STEPS
# steps each after the first, then one ERP f32 step at 512x1024.
SP_TRAIN_SEED, SP_TRAIN_STEPS = 21, 3
# Per rank and step: train_expect's launches, the 3-D ones all haloed
SP_TRAIN_HALO = {k: n for k, n in train_expect("train_b2").items()
                 if k in ("conv3d_s1_bn_act", "conv3d_s2_bn_act",
                          "deconv3d_bn_act")}
# Collectives per rank and step, at any shape whose rows split (held by
# tests/test_torch_spatial_train.py at 64x32): the 3-D stack's 25 BN layers
# sum twice each on the forward, the three hourglasses' 18 again in their
# rerun and all 25 in the backward (50 + 36 + 50); its 28 convs exchange
# halo planes on the forward, the hourglasses' 18 in the rerun and all 28
# in the backward (74); the three losses' sums and counts (6) and the sums'
# backward (3); the heads' gather and its backward (2); the gradient
# all-reduce (1)
SP_TRAIN_COLLECTIVES = 50 + 36 + 50 + 74 + 6 + 3 + 2 + 1
SP_TRAIN_PATTERNS = {"all_reduce": r"all_?reduce",
                     "all_gather": r"all_?gather"}


def _sp_train_batch(device, h, w, maxdisp):
  gen = torch.Generator(device=device).manual_seed(SP_TRAIN_SEED)
  return _train_batch(gen, TRAINS["train_b2"][1], h, w, device, maxdisp)


def _sp_train_model(device, maxdisp, sphere_type):
  from mode_tpu_torch.models.disparity import ModeDisparity
  return ModeDisparity(maxdisp, "Sphere", sphere_type, device=device,
                       generator=torch.Generator().manual_seed(0))


def _sp_train_rank(device: str, hw: tuple, erp_hw: tuple,
                   maxdisp: int) -> dict:
  """One rank of ``sp_train_gloo_2`` (run by :func:`_sp_train_phase` in a
  process of its own): for ``f32``, ``bf16`` (Cassini, ``hw``) and ``erp``
  (f32, ``erp_hw``), the seeded model's step under the ``(1, 2)`` mesh on
  the whole global batch. Each step with the launch counts and the
  collectives set to 0 before and read after; the first with the
  kernels' input dtypes recorded, its loss and (rank 0) its gradients and
  BN statistics kept; then, but for ``erp``, ``SP_TRAIN_STEPS`` steps
  timed and one profiled. After every step whether the ranks hold
  bit-equal parameters, gradients and buffers. ``device``, ``hw``,
  ``erp_hw`` and ``maxdisp`` come from the parent (a CPU rehearsal's
  ranks have no card)."""
  from mode_tpu_torch import kernels, training
  from mode_tpu_torch.parallel import mesh as pmesh
  cuda = torch.device(device).type == "cuda"
  mesh = pmesh.make_mesh(data=1, spatial=SP_WORLD, device=device)
  out = {"place": (mesh.rank, mesh.spatial_rank)}
  for label, sphere_type, (h, w), dtype, steps in (
      ("f32", "Cassini", hw, torch.float32, SP_TRAIN_STEPS),
      ("bf16", "Cassini", hw, torch.bfloat16, SP_TRAIN_STEPS),
      ("erp", "ERP", erp_hw, torch.float32, 0)):
    model = _sp_train_model(device, maxdisp, sphere_type)
    optimizer = training.make_optimizer(model.parameters())
    step = training.make_disparity_train_step(
        model, optimizer, mesh=mesh,
        compute_dtype=None if dtype == torch.float32 else dtype)
    rows = pmesh.shard_batch(mesh, _sp_train_batch(device, h, w, maxdisp))
    params = list(model.parameters())
    got = {"losses": [], "launches": [], "halo": [], "collectives": [],
           "same": [], "step_ms": [], "dtypes": []}
    if cuda:
      torch.cuda.reset_peak_memory_stats(device)
    for i in range(1 + steps):
      kernels.reset_launches()
      before = mesh.collectives
      t = time.perf_counter()
      with (_recorded_launches() if i == 0
            else contextlib.nullcontext()) as calls:
        loss = float(step(*rows))
      if cuda:
        torch.cuda.synchronize(device)
      got["step_ms"].append((time.perf_counter() - t) * 1e3)
      got["losses"].append(loss)
      got["launches"].append(dict(kernels.LAUNCHES))
      got["halo"].append(dict(kernels.HALO_LAUNCHES))
      got["collectives"].append(mesh.collectives - before)
      got["same"].append(pmesh.same_on_every_rank(
          params + [p.grad for p in params] + list(model.buffers()), mesh))
      if i == 0:
        got["dtypes"] = sorted(str(d) for d in calls.dtypes)
        got["calls"] = {c: v for c, v in calls.items()
                        if c[0] in SP_TRAIN_HALO}
        if mesh.global_rank == 0:
          got["grads"] = {n: p.grad.detach().cpu().clone()
                          for n, p in model.named_parameters()}
          got["stats"] = {n: b.detach().cpu().clone()
                          for n, b in model.named_buffers()
                          if n.endswith(("running_mean", "running_var"))}
    got["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                       if cuda else None)
    got["profile"] = (_profile(step, rows, collectives=SP_TRAIN_PATTERNS)
                      if cuda and steps else None)
    out[label] = got
    del model, optimizer, step, rows, params
    if cuda:
      torch.cuda.empty_cache()
  return out


def _sp_train_phase(card: str) -> dict:
  """``sp_train_gloo_2``: two gloo ranks sharing the card on a ``(1, 2)``
  mesh, each training the seeded model on the whole global batch, its half
  of the cost volume's rows: f32 and bf16 (Cassini, 1024x512) and one ERP
  f32 step (512x1024). Each rank's launches a step must be one process's
  (``train_expect``), the 3-D ones on their halo forms
  (``SP_TRAIN_HALO``), every launch in the step's dtype, with
  ``SP_TRAIN_COLLECTIVES`` collectives a step; the ranks bit-equal after
  every step, with the same losses; the loss must fall over the timed
  steps. Rank 0's first step of each against the one-process plain step of
  the same model and batch (``grad_check``, ``STEP_BARS`` of its dtype) and,
  in f32, its BN statistics against this process's kernel step within
  ``GRAD_RTOL`` of their norm (as ``ddp_gloo_2``). A rank that fails fails
  the phase. Returns rank 0's haloed 3-D calls of a step too (forward and
  grad-input), which the kernel phase times."""
  from mode_tpu_torch import training
  from mode_tpu_torch.parallel.launch import run_ranks
  t0 = time.perf_counter()
  ranks = run_ranks(_sp_train_rank, SP_WORLD,
                    (RANK_DEVICE, GEOMETRY["Cassini"], GEOMETRY["ERP"],
                     MAXDISP), timeout=900, device=RANK_DEVICE,
                    backend="gloo")
  wall = time.perf_counter() - t0
  dtypes = {"f32": torch.float32, "bf16": torch.bfloat16,
            "erp": torch.float32}
  for r, rank in enumerate(ranks):
    if rank["place"] != (0, r):
      _fail(f"sp_train_gloo_2 rank {r}: mesh place {rank['place']}")
    for label, dtype in dtypes.items():
      got, tag = rank[label], f"sp_train_gloo_2 rank {r} {label}"
      want = train_expect("erp_train_b2" if label == "erp" else "train_b2")
      for i, (launches, halo) in enumerate(zip(got["launches"],
                                               got["halo"])):
        _launch_check(f"{tag} step {i + 1}", launches, want)
        if halo != SP_TRAIN_HALO:
          _fail(f"{tag} step {i + 1}: halo launches {halo}, expected "
                f"{SP_TRAIN_HALO}")
      if set(got["collectives"]) != {SP_TRAIN_COLLECTIVES}:
        _fail(f"{tag}: {got['collectives']} collectives a step, expected "
              f"{SP_TRAIN_COLLECTIVES}")
      if got["dtypes"] != [str(dtype)]:
        _fail(f"{tag}: the kernels took {got['dtypes']}, expected {dtype}")
      if not all(got["same"]) or got["losses"] != ranks[0][label]["losses"]:
        _fail(f"{tag}: the ranks parted (bit-equal after each step: "
              f"{got['same']}; losses {got['losses']})")
      if len(got["losses"]) > 1 and not got["losses"][-1] < got["losses"][0]:
        _fail(f"{tag}: the loss did not fall: {got['losses']}")
  checks = {}
  for label, dtype in dtypes.items():
    sphere_type = "ERP" if label == "erp" else "Cassini"
    rank0 = ranks[0][label]
    model = _sp_train_model(DEVICE, MAXDISP, sphere_type)
    batch = _sp_train_batch(DEVICE, *GEOMETRY[sphere_type], MAXDISP)
    cdt = None if dtype == torch.float32 else dtype
    plain_step = plain_stepper(model, functools.partial(
        _stage1_step, compute_dtype=cdt), (
            training.normalize_rgb_on_device(batch[0]),
            training.normalize_rgb_on_device(batch[1]), batch[2]))
    check = grad_check(f"sp_train_gloo_2 {label} rank 0", plain_step,
                       rank0["losses"][0],
                       {n: torch.from_numpy(g).to(DEVICE)
                        for n, g in rank0["grads"].items()}, dtype)
    if not check["ok"]:
      _fail(f"sp_train_gloo_2 {label}: rank 0's step disagrees with the "
            "one-process step")
    _stage1_step(model, cdt)(*batch)
    stats_rel = 0.0
    for n, b in model.named_buffers():
      if n in rank0["stats"]:
        err = float(torch.linalg.vector_norm(
            torch.from_numpy(rank0["stats"][n]).to(DEVICE) - b))
        stats_rel = max(stats_rel, err / float(torch.linalg.vector_norm(b)))
    check["stats_rel"] = stats_rel
    print(f"sp_train_gloo_2 {label}: rank 0's BN statistics "
          f"{stats_rel:.3g} of their norm from the one-process kernel "
          "step's" + (f" (bar {GRAD_RTOL})" if dtype == torch.float32
                      else " (no bar in bf16)"), flush=True)
    if dtype == torch.float32 and stats_rel > GRAD_RTOL:
      _fail(f"sp_train_gloo_2 {label}: rank 0's BN statistics part from the "
            f"one-process step's by {stats_rel:.3g} of their norm")
    checks[label] = check
    del model, plain_step
    torch.cuda.empty_cache()
  out = {"wall_s": wall, "checks": checks, "ranks": [
      {"place": r["place"], **{label: {k: r[label][k] for k in (
          "losses", "launches", "halo", "collectives", "step_ms",
          "peak_gib", "profile")} for label in dtypes}} for r in ranks],
         "calls": ranks[0]["f32"]["calls"]}
  for label in dtypes:
    got = ranks[0][label]
    timed = got["step_ms"][1:]
    prof = got["profile"]
    share = ""
    if prof is not None:
      coll = sum(c["allreduce_ms"] for c in prof["collectives"].values())
      share = (f"; profiled step host {prof['host_ms']:.1f} ms, device "
               f"{prof['device_ms']:.1f} ms, collectives {coll:.1f} ms on "
               f"the host ({100 * coll / prof['host_ms']:.1f}%: "
               + ", ".join(f"{k} {c['allreduce_ms']:.1f}" for k, c in
                           prof["collectives"].items()) + ")")
    print(f"sp_train_gloo_2 {label}: two gloo ranks on one card ({card}), "
          f"rank 0 step 1 {got['step_ms'][0]:.1f} ms"
          + (f", steps 2-{len(got['step_ms'])} "
             + ", ".join(f"{t:.1f}" for t in timed) + " ms (median "
             f"{statistics.median(timed):.1f}; both ranks share the card)"
             if timed else "")
          + f"; {got['collectives'][0]} collectives a step; peak "
          f"{got['peak_gib'] or 0.0:.2f} GiB a rank; loss "
          + " -> ".join(f"{x:.5g}" for x in got["losses"]) + share,
          flush=True)
  print(f"sp_train_gloo_2: {wall:.1f} s with the processes' start; "
        f"launches a rank and step {json.dumps(ranks[0]['f32']['launches'][0])}"
        f", halo forms {json.dumps(ranks[0]['f32']['halo'][0])}", flush=True)
  return out


def _halo_cases(served_calls: dict, rank_calls: dict) -> dict:
  """The kernel phase's halo cases: each 3-D call of the served
  ``sphere_b1`` path at a rank's rows for every ``SP_SIZES`` spatial size,
  haloed (H / S + 2 rows); the first size's must be the rows the
  ``sp_gloo_2`` rank recorded. Returns ``{case + (S,): (per_call,
  layers)}``."""
  three_d = {c: layers for c, layers in served_calls.items()
             if c[0] in HALO_KERNELS and c[0] not in HALO_PHASE}
  local = {(c[0], (*c[1][:2], c[1][2] // SP_SIZES[0], *c[1][3:]), *c[2:]):
           layers for c, layers in three_d.items()}
  if {c: len(v) for c, v in local.items()} != {
      c: len(v) for c, v in rank_calls.items()
      if c[0] in HALO_KERNELS and c[0] not in HALO_PHASE}:
    _fail("sp_gloo_2: the rank's 3-D calls are not sphere_b1's at half the "
          "rows")
  out = {}
  for size in SP_SIZES:
    label = "sp_gloo_2" if size == SP_WORLD else f"spatial_{size}"
    for c, layers in three_d.items():
      b, d, h, w, cin = c[1]
      out[(c[0], (b, d, h // size + 2, w, cin), *c[2:], size)] = (
          {label: len(layers)}, layers)
  return out


def _conv2d_halo_cases(frame_calls: dict, stem_calls: dict,
                       rank_calls: dict) -> dict:
  """The kernel phase's cases of K8's halo form: each of the frame's
  fusion-net shapes of the 2-D kernel (its batch-1 calls) and the served
  ``sphere_b1`` path's stem shape, at a rank's rows for every ``SP_SIZES``
  spatial size, haloed (H / S + 2 rows); at the first size the fusion
  shapes must be the haloed calls the ``sp_frame_gloo_2`` rank made.
  Returns ``{case + (S,): (per_call, layers)}``."""
  def fusion(calls):
    return {c: layers for c, layers in calls.items()
            if c[0] == "conv2d_s1_bn_act" and c[1][0] == 1}

  def haloed(c, size):
    b, h, w, cin = c[1]
    return (c[0], (b, h // size + 2, w, cin), *c[2:])

  whole = fusion(frame_calls)
  if {haloed(c, SP_WORLD): len(v) for c, v in whole.items()} != {
      c: len(v) for c, v in fusion(rank_calls).items()}:
    _fail("sp_frame_gloo_2: the rank's 2-D halo calls are not the frame's "
          "fusion calls at half the rows")
  stem = {c: layers for c, layers in stem_calls.items()
          if c[0] == "conv2d_s1_bn_act"}
  out = {}
  for size in SP_SIZES:
    for prefix, calls in (("frame", whole), ("stem", stem)):
      label = ("sp_frame_gloo_2" if prefix == "frame" and size == SP_WORLD
               else f"{prefix}_spatial_{size}")
      for c, layers in calls.items():
        key = (*haloed(c, size), size)
        if key in out:
          _fail(f"the halo case {key} stands for two paths")
        out[key] = ({label: len(layers)}, layers)
  return out


def _cli_rank(argv: list) -> dict:
  """One rank of a two-rank ``train_disparity`` run (``train_cli``): its
  launches (all, and on the halo forms) and the files it opened to write
  while ``main(argv)`` ran."""
  import builtins
  from mode_tpu_torch import kernels
  from mode_tpu_torch.cli import train_disparity
  written, real_open = [], builtins.open

  def watched(file, mode="r", *args, **kwargs):
    if any(c in mode for c in "wax+"):
      written.append(str(file))
    return real_open(file, mode, *args, **kwargs)

  kernels.reset_launches()
  builtins.open = watched
  try:
    out = train_disparity.main(argv)
  finally:
    builtins.open = real_open
  torch.cuda.synchronize()
  return {"rank": torch.distributed.get_rank(), "losses": out["losses"],
          "launches": dict(kernels.LAUNCHES),
          "halo": dict(kernels.HALO_LAUNCHES), "written": written}


def _sphere_bwd_case(case, dtype, gen):
  """Compare and time one of the sphere conv's backward kernels at a
  recorded shape; returns the row it prints."""
  from mode_tpu_torch.ops import conv2d, sphere_conv
  name, xs, cout = case[:3]
  sphere_type = _layout(name)
  dev = torch.device(DEVICE)
  n, h, w, cin = xs
  x = (torch.randn(xs, generator=gen, device=dev) * 0.5).to(dtype)
  g = (torch.randn((n, h, w, cout), generator=gen, device=dev)
       * 0.5).to(dtype)
  wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
        * (2.0 / (9 * cout)) ** 0.5).to(dtype)
  packed = conv2d.pack_weight(wt)
  m = n * h * w
  if name in SPHERE_KERNELS[sphere_type][1]:
    def run(plain):
      return sphere_conv.sphere_conv_bwd_input(
          g, wt if plain else packed, sphere_type=sphere_type, plain=plain)
    # the blend of g's channels: 4 products and 3 sums per sample
    ops_n, pipe_ops = 2 * m * 9 * cin * cout, 7 * m * 9 * cout
    nbytes = (g.numel() + wt.numel() + x.numel()) * x.element_size()
  else:
    def run(plain):
      return sphere_conv.sphere_conv_bwd_weight(
          x, g, sphere_type=sphere_type, plain=plain)
    ops_n, pipe_ops = 2 * m * 9 * cin * cout, 7 * m * 9 * cin
    nbytes = (x.numel() + g.numel()) * x.element_size() + wt.numel() * 4
  # the shift tables: 32 bytes per (band index, tap)
  nbytes += (h if sphere_type == "ERP" else w) * 9 * 32
  got, want = run(False), run(True)
  torch.cuda.synchronize()
  if name in SPHERE_KERNELS[sphere_type][1]:
    abs_err, rel_err, ok = _close(got, want, dtype)
  else:
    # dw is an f32 sum over the N*H*W pixels on both sides, in other orders
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / float(want.abs().max())
    ok = rel_err <= 1e-5
  kernel_ms, plain_ms = _time_in_turns([lambda: run(False),
                                        lambda: run(True)], 5)
  return {"name": name, "dtype": str(dtype).split(".")[1],
          "shape": f"{xs}->{cout}", "max_abs_err": abs_err,
          "max_rel_err": rel_err, "pass": ok, "kernel_ms": kernel_ms,
          "plain_ms": plain_ms, "library_ms": None,
          **_bound(ops_n, nbytes, dtype, pipe_ops),
          "tflops": (ops_n + pipe_ops) / kernel_ms / 1e9}


def _make_anchor_batch(seed: int, disp: int, h: int, w: int):
  """The inputs of ``tests/trained_mirror.py:_make_batch`` for one pair,
  made on the CPU: half-resolution noise upsampled x2 plus a coarse layer;
  the right view is the left rolled left by ``disp``. NCHW."""
  rng = np.random.default_rng(seed)
  fine = rng.normal(size=(3, h // 2, w // 2)).astype(np.float32)
  coarse = rng.normal(size=(3, h // 8, w // 8)).astype(np.float32)

  def up(a):
    return F.interpolate(torch.from_numpy(a)[None], size=(h, w),
                         mode="bilinear", align_corners=False)[0]

  left = up(fine) + 0.5 * up(coarse)
  return left[None], torch.roll(left, -disp, dims=2)[None]


def _anchor():
  """The whole flagship path with trained weights at the production shape,
  against the committed full-resolution frame."""
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.utils.convert import load_npz
  with np.load(ROOT / "tests/data/fullres_torch_frame.npz") as z:
    want_pred, want_conf = z["pred"], z["conf"]
    seed, disp = int(z["seed"]), int(z["disp"])
    maxdisp, h, w = int(z["maxdisp"]), int(z["h"]), int(z["w"])
  left, right = _make_anchor_batch(seed, disp, h, w)
  model = load_npz(ModeDisparity(maxdisp, out_conf=True, device=DEVICE),
                   ROOT / "tests/data/trained_mirror_mid.npz")
  with torch.no_grad():
    pred, conf = model(left.permute(0, 2, 3, 1).contiguous().to(DEVICE),
                       right.permute(0, 2, 3, 1).contiguous().to(DEVICE))
  err = np.abs(pred.cpu().numpy() - want_pred)
  conf_mae = float(np.abs(conf.cpu().numpy() - want_conf).mean())
  print(f"anchor: trained weights (trained_mirror_mid.npz) at "
        f"{h}x{w}/{maxdisp}, seed {seed}, disparity {disp}, against "
        f"fullres_torch_frame.npz: pred MAE {float(err.mean()):.3g} px (bar "
        f"{ANCHOR_MAE}), max {float(err.max()):.3g} px (bar {ANCHOR_MAX}), "
        f"conf MAE {conf_mae:.3g} (bar {ANCHOR_CONF_MAE}); pred mean "
        f"{float(pred.mean()):.3f}", flush=True)
  if (float(err.mean()) > ANCHOR_MAE or float(err.max()) > ANCHOR_MAX
      or conf_mae > ANCHOR_CONF_MAE):
    _fail("the flagship path disagrees with the full-resolution frame")
  return {"pred_mae": float(err.mean()), "pred_max": float(err.max()),
          "conf_mae": conf_mae}


# the pairs' disparities in a frame (px): each pair its own, around the
# anchor's 40
FRAME_DISPS = (16, 24, 32, 40, 48, 56)


def _frame_inputs(device=DEVICE, hw=None):
  """A frame's six uint8 pairs ``(6, H, W, 3)`` on ``device`` (``(H, W)``
  = ``hw``, the Cassini geometry if None), made like the anchor's inputs,
  each from its own seed and with its own disparity, and the four views
  (pair 12's left and right, pair 34's left and right). The uint8 values
  are the texture put through the inverse of the ImageNet normalisation,
  so the normalised pairs are the texture up to the 8-bit step."""
  from mode_tpu_torch.training import IMAGENET_MEAN, IMAGENET_STD
  h, w = hw or GEOMETRY["Cassini"]
  with np.load(ROOT / "tests/data/fullres_torch_frame.npz") as z:
    seed = int(z["seed"])
  mean, std = torch.tensor(IMAGENET_MEAN), torch.tensor(IMAGENET_STD)
  lefts, rights = [], []
  for k, d in enumerate(FRAME_DISPS):
    left, right = _make_anchor_batch(seed + 100 + k, d, h, w)
    for x, out in ((left, lefts), (right, rights)):
      x = x[0].permute(1, 2, 0) * std + mean
      out.append(torch.round(x * 255).clamp(0, 255).to(torch.uint8))
  lefts = torch.stack(lefts).to(device)
  rights = torch.stack(rights).to(device)
  return lefts, rights, torch.stack([lefts[0], rights[0], lefts[5],
                                     rights[5]])


def _frame_models():
  """Stage 1 with the trained mid weights; the fusion net with seeded
  weights and random BN statistics, both f32 on the card."""
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.models.fusion import ModeFusion
  from mode_tpu_torch.utils.convert import load_npz
  disp = load_npz(ModeDisparity(MAXDISP, out_conf=True, device=DEVICE),
                  ROOT / "tests/data/trained_mirror_mid.npz")
  fusion = ModeFusion(MAX_DEPTH, device=DEVICE,
                      generator=torch.Generator().manual_seed(0))
  _randomize_for_serving(fusion, 2)
  return disp, fusion


def _calibrate_head(pipe, inputs) -> tuple[float, float]:
  """Scale and shift the fusion net's 1x1 head so its logits have mean 0
  and std 1 on the frame (the seeded net's logits spread over hundreds,
  where the sigmoid is flat); returns the raw (mean, std)."""
  head = pipe.fusion.feature_extraction.depth_layer7[2]
  logits = []
  handle = head.register_forward_hook(lambda m, a, out: logits.append(out))
  with torch.no_grad():
    pipe(*inputs)
  handle.remove()
  mean, std = float(logits[0].mean()), float(logits[0].std())
  with torch.no_grad():
    head.weight.div_(std)
    head.bias.sub_(mean).div_(std)
  return mean, std


def _frame_split(pipe, inputs) -> dict[str, float]:
  """One frame's stage 1, bridge and fusion, each timed by CUDA events."""
  from mode_tpu_torch.pipeline import bridge_all_pairs
  lefts, rights, rgbs = inputs
  ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
  torch.cuda.synchronize()
  ev[0].record()
  disp, conf = pipe.stage1(lefts, rights)
  ev[1].record()
  depths, confs = bridge_all_pairs(disp, conf)
  ev[2].record()
  pipe.fuse(depths, confs, rgbs)
  ev[3].record()
  torch.cuda.synchronize()
  return {name: ev[i].elapsed_time(ev[i + 1])
          for i, name in enumerate(("stage1_ms", "bridge_ms", "fusion_ms"))}


def _zbuffer_forms(label, disp, conf, depths, confs, card) -> dict:
  """The frame's bridge (six pairs, the three "trans" pairs in one z-buffer
  of K = 3) under each z-buffer form on the card: "scatter" and "sort2x"
  held bit-equal to "sort" (``depths``, ``confs``: depth and confidence,
  every pixel), then the forms timed in turns by CUDA events, the median
  of ZBUFFER_REPS bridges each, once from an idle card (the host's
  launches included) and once queued behind a wait on the card (the
  device's own time); "sort" restored after."""
  from mode_tpu_torch.geometry import reprojection as rep
  from mode_tpu_torch.pipeline import bridge_all_pairs
  bits = lambda t: t.contiguous().view(torch.int32)
  times = {(form, queued): [] for form in ZBUFFER_FORMS
           for queued in (False, True)}
  try:
    for form in ZBUFFER_FORMS:
      rep.set_zbuffer_impl(form)
      d, c = bridge_all_pairs(disp, conf)
      if not (torch.equal(bits(d), bits(depths))
              and torch.equal(bits(c), bits(confs))):
        _fail(f"{label}: the bridge's z-buffer form {form!r} is not "
              "bit-equal to 'sort'")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for turn in range(ZBUFFER_REPS):
      order = ZBUFFER_FORMS if turn % 2 == 0 else ZBUFFER_FORMS[::-1]
      for form in order:
        rep.set_zbuffer_impl(form)
        for queued in (False, True):
          torch.cuda.synchronize()
          if queued:      # the bridge's launches queue behind a busy card
            torch.cuda._sleep(ZBUFFER_SLEEP_CYCLES)
          ev[0].record()
          bridge_all_pairs(disp, conf)
          ev[1].record()
          torch.cuda.synchronize()
          times[form, queued].append(ev[0].elapsed_time(ev[1]))
  finally:
    rep.set_zbuffer_impl("sort")
  out = {}
  for form in ZBUFFER_FORMS:
    wall, device = times[form, False], times[form, True]
    out[form] = {"median_ms": statistics.median(wall), "min_ms": min(wall),
                 "max_ms": max(wall), "ms": wall,
                 "device_median_ms": statistics.median(device),
                 "device_min_ms": min(device), "device_max_ms": max(device),
                 "device_ms": device}
  print(f"{label} bridge by z-buffer form (six pairs, bit-equal to 'sort'; "
        f"ms by CUDA events, median [min, max] of {ZBUFFER_REPS} in turns; "
        "from an idle card, its launches included / queued behind a busy "
        f"card, the device's time) on {card}: " + ", ".join(
            f"{form} {o['median_ms']:.3f} [{o['min_ms']:.3f}, "
            f"{o['max_ms']:.3f}] / {o['device_median_ms']:.3f} "
            f"[{o['device_min_ms']:.3f}, {o['device_max_ms']:.3f}]"
            for form, o in out.items()), flush=True)
  return out


def _frame_checks(label, pipe, inputs, disp, conf, card):
  """The f32 frame's stage-wise checks from one frame's stage-1 outputs:
  stage 1 against its plain path, the bridge on the card against the CPU
  and under each z-buffer form, the fusion net against its plain path, and
  the fused depths' spread."""
  from mode_tpu_torch.pipeline import bridge_all_pairs
  from mode_tpu_torch.training import normalize_rgb_on_device
  lefts, rights, rgbs = inputs
  h, w = GEOMETRY["Cassini"]
  ln, rn = normalize_rgb_on_device(lefts), normalize_rgb_on_device(rights)
  jgen = torch.Generator(device=DEVICE).manual_seed(7)
  jit = 1 + INPUT_JITTER * torch.randn(ln.shape, generator=jgen,
                                       device=DEVICE)
  with torch.no_grad():
    ref_disp, ref_conf = pipe.stage1(lefts, rights, plain=True)
    jit_disp = pipe.disp(ln * jit, rn * jit, plain=True)[0]
  spread = (jit_disp - ref_disp).abs()
  err = (disp - ref_disp).abs()
  worst = int(err.argmax())
  print(f"{label} stage 1: the plain path's own spread under a "
        f"{INPUT_JITTER} input jitter: pred MAE {float(spread.mean()):.3g} "
        f"px, max {float(spread.max()):.3g} px; the kernels' largest error "
        f"per pair " + ", ".join(f"{float(e):.3g}" for e in
                                 err.amax(dim=(1, 2)))
        + f" px, the largest at a pixel of conf "
        f"{float(ref_conf.reshape(-1)[worst]):.3f} (frame mean "
        f"{float(ref_conf.mean()):.3f})", flush=True)
  # the trained weights at full resolution: the anchor's bars
  check = {"stage1": _check_output(
      f"{label} stage 1 (trained weights)", disp, conf, ref_disp, ref_conf,
      (6, h, w), seeded=False,
      bars=(ANCHOR_MAE, ANCHOR_MAX, ANCHOR_CONF_MAE)),
           "stage1_jitter_spread": {"mae": float(spread.mean()),
                                    "max": float(spread.max())}}
  depths, confs = bridge_all_pairs(disp, conf)
  cpu_d, cpu_c = bridge_all_pairs(disp.cpu(), conf.cpu())
  depths_h, confs_h = depths.cpu(), confs.cpu()
  differ = ((confs_h != cpu_c)
            | ((depths_h - cpu_d).abs() > 4e-7 * cpu_d.abs()))
  per_pair = differ.sum(dim=(1, 2)).tolist()
  check["bridge_differing_pixels"] = per_pair
  print(f"{label} bridge on the card vs the same function on the CPU: "
        f"pixels that differ per pair {per_pair} of {h * w} (bar "
        f"{BRIDGE_DIFFER:.1%}); depth range {float(depths.min()):.3f}-"
        f"{float(depths.max()):.3f} m", flush=True)
  if max(per_pair) > BRIDGE_DIFFER * h * w:
    _fail(f"{label}: the bridge on the card disagrees with the CPU")
  check["zbuffer_forms"] = _zbuffer_forms(label, disp, conf, depths, confs,
                                          card)
  with torch.no_grad():
    fused = pipe.fuse(depths, confs, rgbs)
    ref = pipe.fuse(depths, confs, rgbs, plain=True)
  err = (fused - ref).abs()
  inside = float(((fused > 1) & (fused < MAX_DEPTH - 1)).float().mean())
  check["fusion"] = {"mae": float(err.mean()), "max": float(err.max()),
                     "inside_share": inside, "mean": float(fused.mean()),
                     "std": float(fused.std())}
  print(f"{label} fusion vs its plain versions (f32, the same bridged maps): "
        f"MAE {float(err.mean()):.3g} m (bar {FUSED_MAE}), max "
        f"{float(err.max()):.3g} m (bar {FUSED_MAX}); fused depth mean "
        f"{float(fused.mean()):.2f} m, std {float(fused.std()):.2f}, "
        f"{inside:.1%} strictly inside (1, {MAX_DEPTH - 1:g}) m (bar "
        f"{FUSED_INSIDE:.0%})", flush=True)
  if not bool(torch.isfinite(fused).all()) or fused.shape != (h, w):
    _fail(f"{label}: fused depth not finite or of shape {tuple(fused.shape)}")
  if float(err.mean()) > FUSED_MAE or float(err.max()) > FUSED_MAX:
    _fail(f"{label}: the fusion net disagrees with its plain path")
  if inside < FUSED_INSIDE:
    _fail(f"{label}: degenerate fused depth")
  return check


def _frame_path(label, disp, fusion, inputs, card, f32_frame=None):
  """Serve a path of whole frames: the first recorded (every kernel call),
  FRAMES[label][1] more timed with the launch counts set to 0 before and
  read after, one split by stage and one profiled; then the f32 frame's
  stage-wise checks, or the bf16 frame's drift from the f32 frame."""
  from mode_tpu_torch import kernels
  from mode_tpu_torch.pipeline import TwoStagePipeline
  dtype, nframes = FRAMES[label]
  h, w = GEOMETRY["Cassini"]
  pipe = TwoStagePipeline(disp, fusion, MAXDISP, MAX_DEPTH, dtype=dtype,
                          stage1_chunk=6, uint8_inputs=True,
                          fusion_dtype=dtype, device=DEVICE)
  head = None
  if f32_frame is None:
    head = _calibrate_head(pipe, inputs)
    print(f"{label}: fusion head logits (mean, std) {head[0]:.4g}, "
          f"{head[1]:.4g} on the frame, scaled to 0, 1", flush=True)
  with torch.no_grad():
    with _recorded_launches("frame") as calls:
      pipe(*inputs)                                     # warm-up, recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    frame_ms, outputs = [], []
    for _ in range(nframes):
      t = time.perf_counter()
      outputs.append(pipe(*inputs))
      torch.cuda.synchronize()
      frame_ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    split = _frame_split(pipe, inputs)
    prof = _profile(pipe, inputs)
  ms = statistics.median(frame_ms)
  print(f"{label}: TwoStagePipeline {str(dtype).split('.')[1]}, six ({h}, "
        f"{w}) uint8 Cassini pairs + four views, maxdisp {MAXDISP}, "
        f"max_depth {MAX_DEPTH:g}, stage1_chunk 6; median {ms:.2f} ms/frame "
        f"(all: " + ", ".join(f"{t:.2f}" for t in frame_ms) + "); one frame "
        "by CUDA events: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                       split.items())
        + f"; peak memory {peak_gib:.2f} GiB", flush=True)
  print(f"{label} launches per frame: " + json.dumps(
      {k: launches.get(k, 0) / nframes for k in KERNELS}) + " (JAX path: "
        + ", ".join(t for t, _ in FRAME_JAX.values()) + ")", flush=True)
  for name in set(KERNELS) | set(launches):
    want = FRAME_JAX.get(name, ("", 0))[1]
    if launches.get(name, 0) != want * nframes:
      _fail(f"{label}: {name} launched {launches.get(name, 0)} times in "
            f"{nframes} frames, expected {want} a frame")
  rt = prof["runtime_calls"]
  print(f"{label} profiled frame: host {prof['host_ms']:.2f} ms, device "
        f"{prof['device_ms']:.2f} ms; by kind (ms): "
        + json.dumps({k: round(v, 3) for k, v in prof["by_kind_ms"].items()})
        + f"; CUDA runtime: {rt['launch_kernel']} kernel launches, "
        f"{rt['stream_synchronize']} cudaStreamSynchronize, "
        f"{rt['synchronize']} synchronisations in all, device copies "
        + json.dumps(rt["device_copies"]) + "; top kernels (ms, launches): "
        + json.dumps(prof["top_kernels_ms"]), flush=True)
  fused, disp_out, conf_out = outputs[0]
  if f32_frame is None:
    check = _frame_checks(label, pipe, inputs, disp_out, conf_out, card)
    from mode_tpu_torch.pipeline import bridge_all_pairs
    bridged = bridge_all_pairs(disp_out, conf_out)
  else:
    ref_fused, ref_disp = f32_frame["fused"], f32_frame["disp"]
    with torch.no_grad():     # the fusion net's own drift, from f32 maps
      own = (pipe.fuse(*f32_frame["bridged"], inputs[2]) - ref_fused).abs()
    drift = float((disp_out - ref_disp).abs().mean())
    fdrift = (fused - ref_fused).abs()
    check = {"disp_mae_vs_f32": drift,
             "disp_max_vs_f32": float((disp_out - ref_disp).abs().max()),
             "fused_mae_vs_f32": float(fdrift.mean()),
             "fused_max_vs_f32": float(fdrift.max()),
             "fusion_own_mae_vs_f32": float(own.mean()),
             "fusion_own_max_vs_f32": float(own.max())}
    print(f"{label} vs the f32 frame: disparity MAE {drift:.4g} px (bar "
          f"{BF16_DISP_MAE:.3g}, 0.15% of {MAXDISP}), max "
          f"{check['disp_max_vs_f32']:.4g} px; fused depth drift MAE "
          f"{check['fused_mae_vs_f32']:.4g} m, max "
          f"{check['fused_max_vs_f32']:.4g} m (no bar), of which the bf16 "
          f"fusion net's own from the f32 frame's bridged maps: MAE "
          f"{check['fusion_own_mae_vs_f32']:.4g} m, max "
          f"{check['fusion_own_max_vs_f32']:.4g} m", flush=True)
    if not bool(torch.isfinite(fused).all()) or drift > BF16_DISP_MAE:
      _fail(f"{label}: the bf16 frame drifts from the f32 frame")
  return {"calls": calls if f32_frame is None else {}, "batch": 6,
          "ncalls": nframes, "launches": launches, "call_ms": frame_ms,
          "split_ms": split, "peak_gib": peak_gib, "profile": prof,
          "check": check, "head": head, "models": (pipe.disp, pipe.fusion),
          "outputs": None if f32_frame else {"fused": fused, "disp": disp_out,
                                             "conf": conf_out,
                                             "bridged": bridged}}


# ---- the serving CLIs (mode_tpu_torch/cli) on a Deep360-layout tree on
# disk: one episode, four frames in training (the training CLIs' one full
# batch of 4 frames and 24 pairs), one in validation, two in testing (42
# pairs, 12 of them tested), each frame the frame phase's six uint8 pairs,
# each pair's ground-truth disparity its FRAME_DISPS value (the maps of
# tests/synth_data.py's tree, named as it names them).
CLI_EPISODE = "ep1_500frames"
CLI_FRAMES = {"training": 4, "validation": 1, "testing": 2}
CLI_TEST_PAIRS = 6 * CLI_FRAMES["testing"]
CLI_ALL_PAIRS = 6 * sum(CLI_FRAMES.values())


def _cli_tree(root: Path, lefts, rights) -> None:
  """Write the tree under ``root``: the PNGs of one frame once, copied for
  the others; the disparities; the ground-truth depth, pair 12's ground
  truth through the bridge (pair 12 is camera 1's own)."""
  from PIL import Image

  from mode_tpu_torch.geometry.reprojection import disp_to_depth_at_cam1
  from mode_tpu_torch.pipeline import CAM_PAIRS
  h, w = GEOMETRY["Cassini"]
  depth = disp_to_depth_at_cam1(torch.full((h, w), float(FRAME_DISPS[0])),
                                torch.ones(h, w), "12")[0].numpy()
  written = {}
  for subset, frames in CLI_FRAMES.items():
    base = root / CLI_EPISODE / subset
    for sub in ("rgb", "disp", "depth"):
      (base / sub).mkdir(parents=True)
    for f in range(frames):
      for k, pair in enumerate(CAM_PAIRS):
        for side, imgs in (("l", lefts), ("r", rights)):
          path = base / "rgb" / f"{f:06d}_{pair}_rgb_{side}.png"
          if (pair, side) in written:
            shutil.copyfile(written[pair, side], path)
          else:
            Image.fromarray(imgs[k].cpu().numpy()).save(path)
            written[pair, side] = path
        np.savez(base / "disp" / f"{f:06d}_{pair}_disp.npz",
                 np.full((h, w), FRAME_DISPS[k], np.float32))
      np.savez(base / "depth" / f"{f:06d}_depth.npz", depth)


@contextlib.contextmanager
def _timed_loaders(records: list):
  """While the block runs, the dataset CLIs' loaders record each batch's
  size, the host clock at which it was asked for, how long the consumer
  waited for it, the launch counts at that moment (so each batch's
  launches are the difference to the next request) and whether the native
  decode made it."""
  from mode_tpu_torch import kernels
  from mode_tpu_torch.cli import save_output_disparity_stage as save
  from mode_tpu_torch.cli import test_disparity, test_fusion
  from mode_tpu_torch.cli import train_disparity, train_fusion
  from mode_tpu_torch.data.loader import DataLoader

  class Timed(DataLoader):
    def __iter__(self):
      rec = {"sizes": [], "wait_s": [], "t": [], "launches": [], "native": 0,
             "shuffle": self.shuffle}
      records.append(rec)
      get_batch = getattr(self.dataset, "get_batch", None)

      def counted(indices, threads):
        batch = get_batch(indices, threads)
        rec["native"] += batch is not None
        return batch

      if get_batch is not None:           # (a packed dataset has none)
        self.dataset.get_batch = counted
      it = super().__iter__()
      try:
        while True:
          t0 = time.perf_counter()
          rec["t"].append(t0)
          rec["launches"].append(dict(kernels.LAUNCHES))
          try:
            batch = next(it)
          except StopIteration:
            return
          rec["wait_s"].append(time.perf_counter() - t0)
          rec["sizes"].append(len(batch.get("dispNames")
                                  or batch["gtNames"]))
          yield batch
      finally:
        it.close()

  mods = (save, test_disparity, test_fusion, train_disparity, train_fusion)
  for mod in mods:
    mod.DataLoader = Timed
  try:
    yield
  finally:
    for mod in mods:
      mod.DataLoader = DataLoader


def _cli_expect() -> dict[str, tuple]:
  """Each invocation's batch sizes (None where no loader runs) and its
  launches by kernel, one dict per model call: the counts the served paths
  expect per call (sphere_b1 at batch 1, sphere_b6 at batch >= 2: K9 on
  every stride-1 3x3 FE conv whatever the batch), the frame's, and the
  fusion net's K8 a frame. The loaders keep a partial last batch."""
  b1, bn, frame = ({k: n for k, (_, n) in table.items()} for table in (
      PATHS["sphere_b1"][4], PATHS["sphere_b6"][4], FRAME_JAX))

  def stage1(batch, pairs):
    sizes = [min(batch, pairs - i) for i in range(0, pairs, batch)]
    return sizes, [b1 if n == 1 else bn for n in sizes]

  frames = CLI_FRAMES["testing"]
  return {"test_disparity_b1": stage1(1, CLI_TEST_PAIRS),
          "test_disparity_b1_nodump": stage1(1, CLI_TEST_PAIRS),
          "test_disparity_b4": stage1(4, CLI_TEST_PAIRS),
          "test_disparity_b5": stage1(5, CLI_TEST_PAIRS),
          "save_output_disparity_stage": stage1(6, CLI_ALL_PAIRS),
          "test_fusion": ([1] * frames,
                          [{"conv2d_s1_bn_act": FUSION_K8}] * frames),
          "predict_disp": (None, [b1]),
          "predict_all": (None, [frame])}


def _launch_diff(label, what, got, want) -> None:
  for name in set(want) | set(got):
    if got.get(name, 0) != want.get(name, 0):
      _fail(f"cli {label}: {name} launched {got.get(name, 0)} times "
            f"{what}, expected {want.get(name, 0)}")


def _cli_run(label, main, argv, expect, records, card) -> tuple:
  """Run one CLI through its ``main(argv)`` on the card with the launch
  counts set to 0 before and read after; check them, in all and per batch,
  and its batch sizes against ``expect``; print its wall time and its
  loader's numbers."""
  from mode_tpu_torch import kernels
  sizes, per_call = expect
  n = len(records)
  torch.cuda.synchronize()
  kernels.reset_launches()
  t0 = time.perf_counter()
  out = main(argv)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = dict(kernels.LAUNCHES)
  info = {"wall_s": wall, "launches": launches}
  line = f"cli {label}: {wall:.2f} s wall"
  if (len(records) > n) != (sizes is not None):
    _fail(f"cli {label}: a loader ran where none was expected, or none ran")
  if sizes is not None:
    rec = records[n]
    if rec["sizes"] != sizes:
      _fail(f"cli {label}: batches {rec['sizes']}, expected {sizes}")
    snaps = rec["launches"]
    for i, want in enumerate(per_call):
      _launch_diff(label, f"in batch {i} (of {sizes[i]})", {
          k: v - snaps[i].get(k, 0) for k, v in snaps[i + 1].items()
          if v - snaps[i].get(k, 0)}, want)
    later = sum(sizes[1:])
    info.update(
        batch_sizes=sizes,
        first_batch_ms=(rec["t"][1] - rec["t"][0]) * 1e3,
        steady_ms_per_item=(rec["t"][-1] - rec["t"][1]) * 1e3 / later,
        loader_wait_ms=[w * 1e3 for w in rec["wait_s"]],
        decode=("native" if rec["native"] == len(sizes) else
                "PIL" if rec["native"] == 0 else "mixed"))
    unit = "frame" if label == "test_fusion" else "pair"
    waits = info["loader_wait_ms"]
    line += (f", batches {sizes}, first batch "
             f"{info['first_batch_ms']:.1f} ms, then "
             f"{info['steady_ms_per_item']:.2f} ms per {unit}; loader wait "
             f"{waits[0]:.1f} ms for the first batch, "
             f"{statistics.mean(waits[1:]):.2f} ms a batch after it (max "
             f"{max(waits[1:]):.2f}); decode {info['decode']}")
  print(f"{line}; launches {json.dumps(launches)} ({card})", flush=True)
  _launch_diff(label, "in all", launches, {
      k: sum(c.get(k, 0) for c in per_call) for c in per_call for k in c})
  return out, info


def _cli_setup(root: Path, fusion_state: dict) -> tuple:
  """Under ``root``: the Deep360 tree, predict's frame (``ca_<pair>_<l|r>
  .png``), stage 1's trained mid weights and ``fusion_state`` as
  reference-layout ``.tar`` files; returns their paths, the output
  directory and each CLI invocation as ``{label: (main, argv)}``."""
  from mode_tpu_torch.cli import predict, save_output_disparity_stage
  from mode_tpu_torch.cli import test_disparity, test_fusion
  from mode_tpu_torch.pipeline import CAM_PAIRS
  h, w = GEOMETRY["Cassini"]
  data, out, frame = root / "Deep360", root / "out", root / "frame"
  lefts, rights, _ = _frame_inputs()
  _cli_tree(data, lefts, rights)
  frame.mkdir()
  for pair in CAM_PAIRS:
    for side in "lr":
      shutil.copyfile(data / CLI_EPISODE / "testing" / "rgb" /
                      f"000000_{pair}_rgb_{side}.png",
                      frame / f"ca_{pair}_{side}.png")
  with np.load(ROOT / "tests/data/trained_mirror_mid.npz") as z:
    state = {k: torch.from_numpy(z[k].astype(np.float32)
                                 if z[k].dtype == np.float16 else z[k])
             for k in z.files}
  disp_tar, fusion_tar = str(root / "disp.tar"), str(root / "fusion.tar")
  torch.save({"epoch": 0, "state_dict": state}, disp_tar)
  torch.save({"epoch": 0, "state_dict": fusion_state}, fusion_tar)

  size = ["--height", str(h), "--width", str(w), "--max_disp", str(MAXDISP)]
  stage1 = ["--checkpoint_disp", disp_tar, *size]
  predict1 = ["--checkpoint_disp", disp_tar, "--heightC", str(h),
              "--widthC", str(w), "--max_disp", str(MAXDISP),
              "--max_depth", str(MAX_DEPTH)]
  runs = {
      "test_disparity_b1": (test_disparity.main, [
          "--dataset_root", str(data), "--batch_size", "1",
          "--save_output_path", str(out / "disp_b1"), "--save_ori",
          *stage1]),
      "test_disparity_b1_nodump": (test_disparity.main, [
          "--dataset_root", str(data), "--batch_size", "1", *stage1]),
      "test_disparity_b4": (test_disparity.main, [
          "--dataset_root", str(data), "--batch_size", "4",
          "--save_output_path", str(out / "disp_b4"), "--save_ori",
          *stage1]),
      # 12 pairs in batches of 5, 5 and 2
      "test_disparity_b5": (test_disparity.main, [
          "--dataset_root", str(data), "--batch_size", "5",
          "--save_output_path", str(out / "disp_b5"), "--save_ori",
          *stage1]),
      "save_output_disparity_stage": (save_output_disparity_stage.main, [
          "--datapath", str(data), "--outpath", str(out / "bridge"),
          *stage1]),
      "test_fusion": (test_fusion.main, [
          "--datapath-input", str(out / "bridge"), "--datapath-dataset",
          str(data), "--loadmodel", fusion_tar, "--outpath",
          str(out / "fusion"), "--maxdepth", str(MAX_DEPTH)]),
      "predict_disp": (predict.main, [
          "--stage", "disp", "--left_name", str(frame / "ca_12_l.png"),
          "--right_name", str(frame / "ca_12_r.png"), "--save_root",
          str(out / "predict_disp"), *predict1]),
      "predict_all": (predict.main, [
          "--stage", "all", "--data_root", str(frame),
          "--checkpoint_fusion", fusion_tar, "--save_root",
          str(out / "predict_all"), *predict1])}
  return data, out, frame, disp_tar, fusion_tar, runs


def _single_file_decoders(data: Path) -> dict:
  """The native library's single-file entries on the tree: ``decode_png``
  on a test view against PIL's decode, ``read_npz`` on its ground truth
  against numpy's read, each equal."""
  from mode_tpu_torch.data import native_io
  from PIL import Image
  h, w = GEOMETRY["Cassini"]
  base = data / CLI_EPISODE / "testing"
  view, gt = base / "rgb" / "000000_12_rgb_l.png", base / "depth" / (
      "000000_depth.npz")
  t0 = time.perf_counter()
  png = native_io.decode_png(str(view))
  t1 = time.perf_counter()
  arr = native_io.read_npz(str(gt), (h, w))
  t2 = time.perf_counter()
  with Image.open(view) as im:
    want_png = np.asarray(im)
  with np.load(gt) as z:
    want_arr = z[z.files[0]].astype(np.float32)
  out = {"decode_png_ms": (t1 - t0) * 1e3, "read_npz_ms": (t2 - t1) * 1e3,
         "png_shape": list(png.shape), "npz_shape": list(arr.shape)}
  print(f"cli: decode_png {view.name} {png.shape} {out['decode_png_ms']:.2f}"
        f" ms, read_npz {gt.name} {arr.shape} {out['read_npz_ms']:.2f} ms "
        "(host), against PIL's and numpy's reading", flush=True)
  if png.shape != want_png.shape or not np.array_equal(png, want_png):
    _fail(f"cli: decode_png of {view} is not PIL's decode")
  if not np.array_equal(arr, want_arr):
    _fail(f"cli: read_npz of {gt} is not numpy's read")
  return out


def _cli_phase(root: Path, fusion_state: dict, card: str) -> dict:
  """The serving CLIs on the card, each through its ``main(argv)`` with its
  default device, on a tree written under ``root``: then each
  invocation's launches (in all and per batch), ``test_disparity``'s MAE
  against its own dumps, the stage-1 path at every batch size from 1 to 6
  against its plain path and the batch-1 dumps, ``test_fusion``'s dumps
  against ``ModeFusion`` and ``cassini_to_erp`` called directly and its
  metrics against its dumps, ``predict --stage all`` against
  ``TwoStagePipeline`` called directly, and every output file's shape and
  range."""
  from mode_tpu_torch import kernels
  from mode_tpu_torch.cli import common, predict, test_disparity, test_fusion
  from mode_tpu_torch.data import native_io
  from mode_tpu_torch.data.deep360 import (Deep360DatasetDisparity,
                                           Deep360DatasetFusion)
  from mode_tpu_torch.data.file_lists import list_deep360_fusion_test
  from mode_tpu_torch.data.loader import DataLoader
  from mode_tpu_torch.geometry import cassini_to_erp
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.models.fusion import ModeFusion
  from mode_tpu_torch.pipeline import CAM_PAIRS, TwoStagePipeline
  from mode_tpu_torch.utils import metrics
  from PIL import Image
  h, w = GEOMETRY["Cassini"]
  expect = _cli_expect()
  result = {"runs": {}}
  t_phase = time.perf_counter()
  t0 = time.perf_counter()
  data, out, frame, disp_tar, fusion_tar, runs = _cli_setup(root,
                                                            fusion_state)
  native = native_io.available()
  result["tree_s"] = time.perf_counter() - t0
  print(f"cli: a Deep360 tree of {CLI_ALL_PAIRS} pairs ({h}x{w} PNGs, "
        f"{CLI_TEST_PAIRS} in testing) and the .tar weights written in "
        f"{result['tree_s']:.2f} s; native decode (libmodeio) "
        f"{'available' if native else 'missing: PIL decodes'}; "
        f"predict decodes with PIL", flush=True)
  result["single_file_decoders"] = _single_file_decoders(data)

  records = []
  returned = {}
  with _timed_loaders(records):
    for label, (main, argv) in runs.items():
      returned[label], result["runs"][label] = _cli_run(
          label, main, argv, expect[label], records, card)

  # test_disparity's MAE is the MAE of its own dumps
  _, _, disps = test_disparity.list_deep360_disparity_test(str(data))
  names = [test_disparity._out_name(p, "Deep360") for p in disps]
  gts = [float(np.load(p)["arr_0"][0, 0]) for p in disps]
  for batch in (1, 4, 5):
    label, sub = f"test_disparity_b{batch}", out / f"disp_b{batch}"
    preds = [np.load(sub / f"{n}_pred.npz")["arr_0"] for n in names]
    # a pair's ground truth is one value, held where it is in (0, maxdisp]
    held = [0 < g <= MAXDISP for g in gts]
    maes = [sum(np.abs(p - g).mean() for p, g, k in zip(
        preds[i:i + batch], gts[i:i + batch], held[i:i + batch]) if k)
            / max(sum(held[i:i + batch]), 1)
            for i in range(0, len(preds), batch)]
    got, want = float(returned[label]["MAE"]), float(np.mean(maes))
    result["runs"][label]["mae"] = got
    print(f"cli {label}: MAE {got:.6f} px, from its _pred.npz dumps "
          f"{want:.6f} px; the table's row "
          + json.dumps({k: float(v) for k, v in returned[label].items()}),
          flush=True)
    if not np.isfinite(got) or abs(got - want) > 1e-5 * max(want, 1.0):
      _fail(f"cli {label}: its MAE is not its dumps' MAE")
    for p in preds:
      if p.shape != (h, w) or not np.isfinite(p).all():
        _fail(f"cli {label}: a _pred.npz dump of shape {p.shape}")
  b1 = [np.load(out / "disp_b1" / f"{n}_pred.npz")["arr_0"] for n in names]

  # stage 1 at every batch size from 1 to 6 on the decoded test pairs,
  # through the same .tar, against its plain path on the same batch and
  # against the batch-1 dumps
  model = ModeDisparity(MAXDISP, out_conf=True, device=DEVICE)
  common.load_model_checkpoint(disp_tar, model)
  ds = Deep360DatasetDisparity(*test_disparity.list_deep360_disparity_test(
      str(data)), shape=(h, w))
  errs = {}
  for b in range(1, 7):
    batch = ds.get_batch(list(range(b)), 8) if native else None
    if batch is None:
      batch = {k: np.stack([ds[i][k] for i in range(b)])
               for k in ("leftImg", "rightImg")}
    left, right = (torch.from_numpy(batch[k]).to(DEVICE)
                   for k in ("leftImg", "rightImg"))
    kernels.reset_launches()
    with torch.no_grad():
      pred, conf = model(left, right)
    launches = dict(kernels.LAUNCHES)
    with torch.no_grad():
      ref_pred, ref_conf = model(left, right, plain=True)
    want = {k: n for k, (_, n) in PATHS["sphere_b1" if b == 1 else
                                        "sphere_b6"][4].items()}
    if launches != want:
      _fail(f"cli: stage 1 at batch {b} launched {launches}, expected "
            f"{want}")
    plain = (pred - ref_pred).abs()
    conf_mae = float((conf - ref_conf).abs().mean())
    keep = [i for i in range(b) if held[i]]     # the dumps hold these
    err = np.abs(pred.cpu().numpy()[keep] - np.stack(b1[:b])[keep])
    errs[b] = {"plain_mae": float(plain.mean()),
               "plain_max": float(plain.max()), "conf_mae": conf_mae,
               "b1_mae": float(err.mean()), "b1_max": float(err.max())}
    if (errs[b]["plain_mae"] > ANCHOR_MAE or errs[b]["plain_max"] > ANCHOR_MAX
        or conf_mae > ANCHOR_CONF_MAE
        or not bool(torch.isfinite(conf).all())):
      _fail(f"cli: stage 1 at batch {b} disagrees with its plain path: "
            f"{errs[b]}")
    if err.mean() > ANCHOR_MAE or err.max() > ANCHOR_MAX:
      _fail(f"cli: stage 1 at batch {b} disagrees with the batch-1 "
            f"dumps: {errs[b]}")
  result["batch_sizes"] = errs
  print("cli: stage 1 at batch 1-6 on the test pairs (each at its path's "
        "launches), pred MAE / max (px) and conf MAE against its plain "
        "path on the same batch; pred MAE / max against test_disparity's "
        "batch-1 dumps: " + ", ".join(
            f"b{b} {e['plain_mae']:.3g}/{e['plain_max']:.3g}/"
            f"{e['conf_mae']:.3g}; {e['b1_mae']:.3g}/{e['b1_max']:.3g}"
            for b, e in errs.items())
        + f" (bars {ANCHOR_MAE}, {ANCHOR_MAX}, {ANCHOR_CONF_MAE})",
        flush=True)
  del left, right, pred, conf, ref_pred, ref_conf, plain

  # test_fusion's dumps against ModeFusion and cassini_to_erp called
  # directly on the same decoded frames, and its metrics against the dumps
  fusion = ModeFusion(MAX_DEPTH, device=DEVICE)
  common.load_model_checkpoint(fusion_tar, fusion)
  fus = out / "fusion" / "Deep360" / "fusion"
  fds = Deep360DatasetFusion(*list_deep360_fusion_test(str(out / "bridge"),
                                                       str(data)))
  direct_err, recomputed = [], []
  for batch in DataLoader(fds, batch_size=1, num_workers=1):
    depths, confs, rgbs, gt = (torch.from_numpy(batch[k]).to(DEVICE) for k
                               in ("depths", "confs", "rgbs", "gt"))
    with torch.no_grad():
      pred = fusion([depths[:, k] for k in range(6)],
                    [confs[:, k] for k in range(6)],
                    [rgbs[:, k] for k in range(4)])
    pred_erp = cassini_to_erp(pred)[0, ..., 0].cpu().numpy()
    gt_erp = cassini_to_erp(gt[..., None])[0, ..., 0].cpu()
    name = batch["gtNames"][0]           # named as test_fusion names it
    dump = np.load(fus / "depth_pred" / (re.findall(r"ep[0-9]_", name)[0]
                                         + Path(name).stem + "_pred.npy"))
    direct_err.append(np.abs(dump - pred_erp))
    m = metrics.depth_metrics(torch.from_numpy(dump), gt_erp,
                              gt_erp <= MAX_DEPTH)
    recomputed.append([float(m[k]) for k in common.METRIC_NAMES])
  direct_err = np.stack(direct_err)
  recomputed = dict(zip(common.METRIC_NAMES, np.mean(recomputed, 0)))
  got = {k: float(v) for k, v in returned["test_fusion"].items()}
  # the dumps' metrics summed in f32 on the host: 1e-4 relative; a
  # percentage within one pixel's share
  pixel = 100.0 / (h * w)
  off = {k: (got[k], v) for k, v in recomputed.items()
         if abs(got[k] - v) > (1e-4 * abs(v) if "%" not in k else pixel)}
  result["test_fusion_vs_direct"] = {"mae": float(direct_err.mean()),
                                     "max": float(direct_err.max()),
                                     "metrics": got}
  print(f"cli test_fusion's _pred.npy dumps vs ModeFusion and "
        f"cassini_to_erp called directly: MAE {direct_err.mean():.3g} m "
        f"(bar {FUSED_MAE}), max {direct_err.max():.3g} m (bar "
        f"{FUSED_MAX}); its metrics " + json.dumps(got)
        + ", from its dumps " + json.dumps(
            {k: float(v) for k, v in recomputed.items()}), flush=True)
  if direct_err.mean() > FUSED_MAE or direct_err.max() > FUSED_MAX:
    _fail("cli: test_fusion's dumps disagree with ModeFusion called "
          "directly")
  if off or not all(np.isfinite(v) for v in got.values()):
    _fail(f"cli: test_fusion's metrics are not its dumps' (got, "
          f"recomputed): {off}")

  # predict --stage all against TwoStagePipeline on the same decoded images
  pl = [predict._load(frame / f"ca_{p}_l.png", h, w) for p in CAM_PAIRS]
  pr = [predict._load(frame / f"ca_{p}_r.png", h, w) for p in CAM_PAIRS]
  pipe = TwoStagePipeline(model, fusion, MAXDISP, MAX_DEPTH, device=DEVICE)
  with torch.no_grad():
    direct = pipe(np.stack(pl), np.stack(pr),
                  np.stack([pl[0], pr[0], pl[5], pr[5]]))[0].cpu().numpy()
  served = np.load(out / "predict_all" / "output_depth.npz")["arr_0"]
  err = np.abs(served - direct)
  result["predict_all_vs_pipeline"] = {"mae": float(err.mean()),
                                       "max": float(err.max())}
  print(f"cli predict --stage all vs TwoStagePipeline called directly: "
        f"fused MAE {err.mean():.3g} m (bar {FUSED_MAE}), max "
        f"{err.max():.3g} m (bar {FUSED_MAX}); depth mean "
        f"{served.mean():.2f} m, std {served.std():.2f}", flush=True)
  if err.mean() > FUSED_MAE or err.max() > FUSED_MAX:
    _fail("cli: predict --stage all disagrees with TwoStagePipeline")

  # every output file: its count, shape and range
  def check(paths, shape, lo, hi, what):
    paths = sorted(paths)
    for p in paths:
      a = (np.load(p)["arr_0"] if p.suffix == ".npz" else np.load(p)
           if p.suffix == ".npy" else np.asarray(Image.open(p)))
      a = a.astype(np.float64) / (255.0 if a.dtype == np.uint8 and
                                  what == "conf" else 1.0)
      if (a.shape[:2] != shape or not np.isfinite(a).all()
          or a.min() < lo or a.max() > hi):
        _fail(f"cli: {p.name} of shape {a.shape}, range "
              f"{a.min():.4g}-{a.max():.4g}, expected {shape} in "
              f"[{lo}, {hi}]")
    return len(paths)

  bridge = out / "bridge" / CLI_EPISODE
  counts = {
      "disp_b1 npz": check((out / "disp_b1").glob("*.npz"), (h, w), 0,
                           MAXDISP, "disp"),
      "disp_b1 png": check((out / "disp_b1").glob("*.png"), (h, 2 * w), 0,
                           255, "png"),
      "disp_b4 npz": check((out / "disp_b4").glob("*.npz"), (h, w), 0,
                           MAXDISP, "disp"),
      "disp_b5 npz": check((out / "disp_b5").glob("*.npz"), (h, w), 0,
                           MAXDISP, "disp"),
      "depth npz": check(bridge.glob("*/disp_pred2depth/*.npz"), (h, w), 0,
                         MAX_DEPTH, "depth"),
      "conf png": check(bridge.glob("*/conf_map/*.png"), (h, w), 0, 1,
                        "conf"),
      "fusion npy": check((fus / "depth_pred").glob("*.npy"), (w, h), 0,
                          MAX_DEPTH, "depth"),
      "fusion png": check(fus.glob("*/*.png"), (w, h), 0, 255, "png"),
      "predict_disp conf": check([out / "predict_disp" /
                                  "output_conf.png"], (h, w), 0, 1,
                                 "conf"),
      "predict_disp png": check([out / "predict_disp" /
                                 "output_disp.png"], (h, w), 0, 255, "png"),
      "predict_all npz": check([out / "predict_all" / "output_depth.npz"],
                               (h, w), 0, MAX_DEPTH, "depth"),
      "predict_all png": check([out / "predict_all" / "output_depth.png"],
                               (h, w), 0, 255, "png")}
  want = {"disp_b1 npz": CLI_TEST_PAIRS, "disp_b1 png": CLI_TEST_PAIRS,
          "disp_b4 npz": CLI_TEST_PAIRS, "disp_b5 npz": CLI_TEST_PAIRS,
          "depth npz": CLI_ALL_PAIRS,
          "conf png": CLI_ALL_PAIRS, "fusion npy": CLI_FRAMES["testing"],
          "fusion png": 2 * CLI_FRAMES["testing"]}
  result["files"] = counts
  print(f"cli output files (count, each of the expected shape and range: "
        f"disparity in [0, {MAXDISP}], depth in [0, {MAX_DEPTH:g}], conf "
        f"in [0, 1]): " + json.dumps(counts), flush=True)
  for key, n in counts.items():
    if n != want.get(key, 1):
      _fail(f"cli: {n} files of {key}, expected {want.get(key, 1)}")
  del model, fusion, pipe
  result["phase_s"] = time.perf_counter() - t_phase
  print(f"cli phase: {result['phase_s']:.2f} s ({card})", flush=True)
  return result


# ---- the training CLIs (mode_tpu_torch/cli/train_disparity.py,
# train_fusion.py) on the serving phase's tree, after it: stage 1 trains on
# its 24 training pairs and validates on its 6 validation pairs; stage 2
# trains on the bridge's outputs for the 4 training frames (one full batch)
# and validates on the validation frame. The CLIs' default batch size, 4.
TRAIN_CLI_BATCH = 4
# Per Baseline training forward at that shape: the stride-1 3x3 convs that
# the JAX package's batch-packed training gate takes with its TPU memory
# budget left out, as the port's gates leave it out, traced with counting
# stubs under jax.eval_shape (tests/test_torch_train_cli_args.py traces it and
# holds this number): all 18 but the 6-channel input conv (the budget
# itself leaves one more, the conv with 256 input channels, to XLA on the
# TPU). Each launches K9 forward and as its grad-input. At the validation's
# batch 1 the Baseline runs no kernel (the JAX package runs it on the
# batch-packed gate alone).
BASELINE_TRAIN_K9 = 17
# The learning-rate check on the f32 run's checkpoints (Adam from zero, as
# the JAX CLI's): epoch 1 is Adam's first step, lr g / (|g| + eps), so a
# parameter element whose gradient in the direct step is GRAD_HELD or more
# moved by lr within LR_RTOL (eps / GRAD_HELD = 5e-4 of it, the rest left
# for the CLI's step and the direct one parting on the gradient); epoch 2
# is Adam's second step, whose |m^ / sqrt(v^)| is at most
# (1 - b1) / sqrt(1 - b2) * sqrt(1 - b2^2) / (1 - b1^2) = 1.0014 by
# Cauchy-Schwarz with b = (0.9, 0.999): no element moved by more than
# 1.0014 lr, against up to 10 lr had the decay been missed. Both up to the
# f32 rounding of the parameters.
GRAD_HELD, LR_RTOL, ADAM_STEP2 = 2e-5, 1e-3, 1.0014
# steps of the direct stage-1 step timed after its first, on one batch
DIRECT_STEPS = 3
# the CUDA kernels of a stage-1 training step, as its trace names them
TRAIN_KERNEL_NAMES = ("conv3d_s1_tc_kernel", "conv3d_s2_tc_kernel",
                      "deconv3d_tc_kernel", "conv2d_tc_kernel",
                      "sphere_conv_tc_kernel", "bwd_input_tc_kernel",
                      "bwd_weight_tc_kernel")


@contextlib.contextmanager
def _watched_steps(runs: list):
  """While the block runs, every training step the CLIs build (the
  stage-1 and fusion steps of ``mode_tpu_torch.training``, the Baseline's
  of ``cli/train_fusion.py``) records its launches by kernel, the dtypes
  its kernels took, its inputs' dtypes and device, and on the first step of
  each run a copy of its inputs; each step's kernel calls by shape
  (:func:`_recorded_launches`). ``runs`` gets one list of steps per built
  step function (one per CLI run)."""
  from mode_tpu_torch import kernels, training
  from mode_tpu_torch.cli import train_fusion

  def watch(make):
    def made(*args, **kw):
      step, steps = make(*args, **kw), []
      runs.append(steps)

      def watched(*xs):
        flat = [x for part in xs
                for x in (part if isinstance(part, list) else [part])]
        rec = {"input_dtypes": sorted({str(x.dtype) for x in flat}),
               "devices": sorted({x.device.type for x in flat}),
               "inputs": [x.clone() for x in flat] if not steps else None}
        before = dict(kernels.LAUNCHES)
        with _recorded_launches() as calls:
          loss = step(*xs)
        rec["launches"] = {k: n - before.get(k, 0)
                           for k, n in kernels.LAUNCHES.items()
                           if n - before.get(k, 0)}
        rec["kernel_dtypes"], rec["calls"] = calls.dtypes, calls
        steps.append(rec)
        return loss

      return watched

    return made

  names = ((training, "make_disparity_train_step"),
           (training, "make_fusion_train_step"),
           (train_fusion, "make_baseline_step"))
  orig = [getattr(mod, name) for mod, name in names]
  for (mod, name), fn in zip(names, orig):
    setattr(mod, name, watch(fn))
  try:
    yield
  finally:
    for (mod, name), fn in zip(names, orig):
      setattr(mod, name, fn)


def _event_scalars(log_dir: Path) -> dict:
  """``{tag: {step: value}}`` of the one event file in ``log_dir``, read
  with the port's own reader of its framing."""
  from mode_tpu_torch.utils.tb_writer import read_scalars
  (path,) = log_dir.glob("events.out.tfevents.*")
  out = {}
  for tag, step, value in read_scalars(str(path)):
    out.setdefault(tag, {})[step] = value
  return out


def _f32(x: float) -> float:
  return float(np.float32(x))


def _train_cli_run(label, main, argv, records, steps, step_expect,
                   val_expect, card) -> dict:
  """One training CLI through its ``main(argv)`` on the card: the launch
  counts set to 0 before and read after, each step's launches (and the
  dtype its kernels took) and each validation batch's against
  ``step_expect`` and ``val_expect``, their sum against the run's; its
  wall time, ms per step after the first (the host clock at which the loop
  asked for the next batch, just after the step's loss was read back), the
  validation's ms per item, the loader's wait per batch and the peak
  memory."""
  from mode_tpu_torch import kernels
  n_rec, n_steps = len(records), len(steps)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  kernels.reset_launches()
  t0 = time.perf_counter()
  out = main(argv)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = dict(kernels.LAUNCHES)
  peak = torch.cuda.max_memory_allocated() / 2**30
  if len(steps) != n_steps + 1:
    _fail(f"train_cli {label}: built {len(steps) - n_steps} training steps, "
          "expected 1")
  run_steps = steps[-1]
  if len(run_steps) != len(out["losses"]):
    _fail(f"train_cli {label}: {len(run_steps)} steps watched, "
          f"{len(out['losses'])} losses returned")
  total = {}
  for i, rec in enumerate(run_steps):
    _launch_diff(f"train_cli {label}", f"in step {i + 1}", rec["launches"],
                 step_expect)
    if rec["devices"] != [torch.device(DEVICE).type]:
      _fail(f"train_cli {label}: step {i + 1} took inputs on "
            f"{rec['devices']}: the CLI did not run on the card")
    for k, n in rec["launches"].items():
      total[k] = total.get(k, 0) + n
  train_recs = [r for r in records[n_rec:] if r["shuffle"]]
  val_recs = [r for r in records[n_rec:] if not r["shuffle"]]
  val_items, val_s = 0, 0.0
  for rec in val_recs:
    snaps = rec["launches"]
    for i in range(len(snaps) - 1):
      got = {k: v - snaps[i].get(k, 0) for k, v in snaps[i + 1].items()
             if v - snaps[i].get(k, 0)}
      _launch_diff(f"train_cli {label}", f"in validation batch {i} (of "
                   f"{rec['sizes'][i]})", got, val_expect(rec["sizes"][i]))
      for k, n in got.items():
        total[k] = total.get(k, 0) + n
    val_items += sum(rec["sizes"][:len(snaps) - 1])
    val_s += rec["t"][len(snaps) - 1] - rec["t"][0]
  _launch_diff(f"train_cli {label}", "in all (steps + validation batches)",
               launches, total)
  # each epoch's requests: t[i + 1] - t[i] is step i with its loader wait
  step_ms = [(b - a) * 1e3 for rec in train_recs
             for a, b in zip(rec["t"], rec["t"][1:])]
  waits = [w * 1e3 for rec in train_recs for w in rec["wait_s"]]
  later = step_ms[1:]
  info = {"wall_s": wall, "launches": launches, "steps": len(run_steps),
          "step_ms": step_ms,
          "ms_per_step_after_first": statistics.mean(later) if later else None,
          "val_ms_per_item": val_s * 1e3 / max(val_items, 1),
          "val_items": val_items, "loader_wait_ms": waits,
          "peak_gib": peak, "losses": out["losses"],
          "kernel_dtypes": sorted({str(d) for r in run_steps
                                   for d in r["kernel_dtypes"]}),
          "input_dtypes": sorted({d for r in run_steps
                                  for d in r["input_dtypes"]})}
  print(f"train_cli {label}: {wall:.2f} s wall, {len(run_steps)} steps, ms "
        "per step (from one batch request to the next) "
        + ", ".join(f"{t:.1f}" for t in step_ms)
        + (f", after the first {info['ms_per_step_after_first']:.1f}"
           if later else "")
        + f"; validation {info['val_ms_per_item']:.1f} ms per item over "
        f"{val_items}; loader wait per batch "
        + ", ".join(f"{t:.1f}" for t in waits)
        + f" ms; peak {peak:.2f} GiB; kernels took {info['kernel_dtypes']}, "
        f"step inputs {info['input_dtypes']}; losses "
        + ", ".join(f"{x:.6g}" for x in out["losses"])
        + f"; launches {json.dumps(launches)} ({card})", flush=True)
  return out, info


def _cli_seen(run_steps, dtype) -> dict:
  """A training CLI run as the kernel phase reads a path: its first step's
  kernel calls by shape (every step takes one full batch), its steps'
  launches, in its dtype."""
  launches = {}
  for rec in run_steps:
    for k, n in rec["launches"].items():
      launches[k] = launches.get(k, 0) + n
  return {"calls": run_steps[0]["calls"], "batch": TRAIN_CLI_BATCH,
          "ncalls": len(run_steps), "launches": launches, "dtype": dtype,
          "train": True}


def _same_tensors(xs, ys) -> bool:
  """Equal dtypes, shapes and values, NaN where the other has NaN."""
  def same(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
      return False
    if not a.is_floating_point():
      return torch.equal(a, b)
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a.nan_to_num(), b.nan_to_num())
  return len(xs) == len(ys) and all(same(a, b) for a, b in zip(xs, ys))


def _check_logs(label, log_dir: Path, want: dict) -> None:
  """The run's event file holds exactly ``want`` (``{tag: {step: value}}``,
  values as the writer's f32)."""
  got = _event_scalars(log_dir)
  want = {tag: {s: _f32(v) for s, v in steps.items()}
          for tag, steps in want.items()}
  if got != want:
    _fail(f"train_cli {label}: the event file holds {got}, expected {want}")


def _check_checkpoint(label, path: Path, make_model, epoch: int) -> dict:
  """The checkpoint exists, loads with ``weights_only=True``, holds the
  reference layout at ``epoch`` and loads into a fresh model with
  ``strict=True``; returns its state_dict."""
  if not path.exists():
    _fail(f"train_cli {label}: no checkpoint {path.name}")
  obj = torch.load(path, map_location="cpu", weights_only=True)
  if sorted(obj) != ["epoch", "state_dict", "train_loss"] or \
      obj["epoch"] != epoch:
    _fail(f"train_cli {label}: {path.name} holds {sorted(obj)} at epoch "
          f"{obj.get('epoch')}")
  model = make_model()
  model.load_state_dict(obj["state_dict"], strict=True)
  del model
  return obj["state_dict"]


def _baseline_state(bridge: Path, data: Path) -> dict:
  """The Baseline with seeded weights, its 1x1 head scaled and shifted to
  logits of mean 0 and std 1 on the first four training frames in training
  (as ``_fusion_model`` calibrates the fusion net); its state_dict on the
  CPU."""
  from mode_tpu_torch.data.deep360 import Deep360DatasetFusion
  from mode_tpu_torch.data.file_lists import list_deep360_fusion_train
  from mode_tpu_torch.models.fusion import Baseline
  model = Baseline(MAX_DEPTH, device=DEVICE,
                   generator=torch.Generator().manual_seed(0))
  td, tc, tr, tg, *_ = list_deep360_fusion_train(str(bridge), str(data))
  ds = Deep360DatasetFusion(td, tc, tr, tg, training=True)
  depths = torch.from_numpy(np.stack([ds[i]["depths"] for i in range(
      TRAIN_CLI_BATCH)])).to(DEVICE)
  probe = copy.deepcopy(model).train()
  head = probe.feature_extraction.layer7[2]
  logits = []
  head.register_forward_hook(lambda m, a, out: logits.append(out))
  with torch.no_grad():
    probe([depths[:, k] for k in range(6)])
  mean, std = float(logits[0].mean()), float(logits[0].std())
  head = model.feature_extraction.layer7[2]
  with torch.no_grad():
    head.weight.div_(std)
    head.bias.sub_(mean).div_(std)
  print(f"train_cli: Baseline head logits (mean, std) {mean:.4g}, {std:.4g} "
        "on the training batch in training, scaled to 0, 1", flush=True)
  return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _fusion_val_expect(label, model, n):
  """A fusion validation batch's launches: the validation frame alone, at
  batch 1, where ModeFusion runs K8 on its lane-major convs and the
  Baseline no kernel."""
  if n != 1:
    _fail(f"train_cli {label}: a validation batch of {n} frames, expected 1")
  return {"conv2d_s1_bn_act": FUSION_K8} if model == "ModeFusion" else {}


def _train_cli_phase(root: Path, fusion_state: dict, card: str) -> dict:
  """The training CLIs on the card, each through its ``main(argv)`` with
  its default device, on the serving phase's tree under ``root``: then
  each run's launches per step and per validation batch, its first step
  against the same step built directly and run on the same batch from the
  same weights and that step against its plain step, the learning rate
  read from the f32 run's checkpoints, every checkpoint loaded strictly
  and two of them served, the packs, the event files, the trace and the
  refusal of more than one card."""
  from mode_tpu_torch import training
  from mode_tpu_torch.cli import common, test_disparity, test_fusion
  from mode_tpu_torch.cli import train_disparity, train_fusion
  from mode_tpu_torch.data.deep360 import (Deep360DatasetDisparity,
                                           Deep360DatasetFusion)
  from mode_tpu_torch.data.file_lists import (list_deep360_disparity_train,
                                              list_deep360_fusion_train)
  from mode_tpu_torch.data.fusion_pack import read_pack
  from mode_tpu_torch.data.loader import DataLoader
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.models.fusion import Baseline, ModeFusion
  from PIL import Image
  h, w = GEOMETRY["Cassini"]
  t_phase = time.perf_counter()
  data, bridge, work = root / "Deep360", root / "out" / "bridge", root / "train"
  disp_tar, fusion_tar = root / "disp.tar", work / "fusion_init.tar"
  work.mkdir()
  torch.save({"epoch": 0, "state_dict": fusion_state}, fusion_tar)
  baseline_tar = work / "baseline_init.tar"
  torch.save({"epoch": 0, "state_dict": _baseline_state(bridge, data)},
             baseline_tar)
  expect = _cli_expect()
  stage1_step = train_expect("train_b2")
  b1, bn = ({k: n for k, (_, n) in PATHS[p][4].items()}
            for p in ("sphere_b1", "sphere_b6"))
  size = ["--height", str(h), "--width", str(w), "--max_disp", str(MAXDISP)]
  stage1 = ["--dataset_root", str(data), "--checkpoint_disp", str(disp_tar),
            *size]
  fusion = ["--datapath-input", str(bridge), "--datapath-dataset", str(data),
            "--maxdepth", str(MAX_DEPTH), "--epochs", "1",
            "--steps_per_epoch", "1"]
  tars = {"ModeFusion": fusion_tar, "Baseline": baseline_tar}
  stage1_runs = {
      # (argv, step dtype)
      "disp_f32": ([*stage1, "--epochs", "2", "--start_decay", "1",
                    "--steps_per_epoch", "1", "--trace_dir",
                    str(work / "trace")], torch.float32),
      "disp_bf16": ([*stage1, "--bf16", "--device_normalize", "--epochs", "1",
                     "--steps_per_epoch", "3"], torch.bfloat16),
      "disp_resume": ([*size, "--dataset_root", str(data), "--resume",
                       "--checkpoint_disp", str(
                           work / "disp_f32" / "ModeDisparity" / "Deep360" /
                           "ckpt_disp_ModeDisparity_Deep360_2.tar"),
                       "--epochs", "3", "--start_decay", "1",
                       "--steps_per_epoch", "3"], torch.float32)}
  fusion_runs = {
      "fusion_packed_f32": ("ModeFusion", ["--packed_dir",
                                           str(work / "packs")],
                            torch.float32),
      "fusion_packed_bf16": ("ModeFusion", ["--packed_dir",
                                            str(work / "packs"), "--bf16"],
                             torch.bfloat16),
      "fusion_float": ("ModeFusion", [], torch.float32),
      "baseline": ("Baseline", [], torch.float32)}
  # each run's kernel calls by shape, for the kernel phase
  result = {"runs": {}, "seen": {}}
  returned = {}
  records, steps = [], []
  with _timed_loaders(records), _watched_steps(steps):
    for label, (argv, dtype) in stage1_runs.items():
      argv = [*argv, "--save_checkpoint_path", str(work / label)]
      returned[label], result["runs"][label] = _train_cli_run(
          label, train_disparity.main, argv, records, steps, stage1_step,
          lambda n: b1 if n == 1 else bn, card)
      result["runs"][label]["first_inputs"] = steps[-1][0]["inputs"]
      result["seen"][f"train_cli_{label}"] = _cli_seen(steps[-1], dtype)
      if result["runs"][label]["kernel_dtypes"] != [str(dtype)]:
        _fail(f"train_cli {label}: the kernels took "
              f"{result['runs'][label]['kernel_dtypes']}, expected {dtype}")
      torch.cuda.empty_cache()
    for label, (model, extra, dtype) in fusion_runs.items():
      argv = [*fusion, "--model", model, "--loadmodel", str(tars[model]),
              "--savemodel", str(work / label), *extra]
      k9 = FUSION_TRAIN_K9 if model == "ModeFusion" else BASELINE_TRAIN_K9
      returned[label], result["runs"][label] = _train_cli_run(
          label, train_fusion.main, argv, records, steps,
          {"conv2d_s1_bn_act": 2 * k9},
          functools.partial(_fusion_val_expect, label, model), card)
      result["runs"][label]["first_inputs"] = steps[-1][0]["inputs"]
      result["seen"][f"train_cli_{label}"] = _cli_seen(steps[-1], dtype)
      if result["runs"][label]["kernel_dtypes"] != [str(dtype)]:
        _fail(f"train_cli {label}: the kernels took "
              f"{result['runs'][label]['kernel_dtypes']}, expected {dtype}")
      torch.cuda.empty_cache()
    # the checkpoints serve: a stage-1 and a fusion checkpoint through the
    # serving CLIs, at their served launches
    served = {
        "test_disparity": (test_disparity.main, [
            "--dataset_root", str(data), "--batch_size", "4",
            "--checkpoint_disp", str(work / "disp_resume" / "ModeDisparity" /
                                     "Deep360" /
                                     "ckpt_disp_ModeDisparity_Deep360_3.tar"),
            *size], expect["test_disparity_b4"]),
        "test_fusion": (test_fusion.main, [
            "--datapath-input", str(bridge), "--datapath-dataset", str(data),
            "--loadmodel", str(work / "fusion_packed_f32" / "ModeFusion" /
                               "Deep360" / "ckpt_fusion_epoch0.tar"),
            "--outpath", str(work / "served_fusion"), "--maxdepth",
            str(MAX_DEPTH)], expect["test_fusion"])}
    for label, (main, argv, want) in served.items():
      metrics, result[f"served_{label}"] = _cli_run(
          f"{label} of a trained checkpoint", main, argv, want, records, card)
      if not all(np.isfinite(float(v)) for v in metrics.values()):
        _fail(f"train_cli: {label} of a trained checkpoint gave {metrics}")
      result[f"served_{label}"]["metrics"] = {k: float(v)
                                              for k, v in metrics.items()}
  torch.cuda.empty_cache()

  # ---- stage 1: the runs' epochs, checkpoints and event files
  ck = {label: work / label / "ModeDisparity" / "Deep360"
        for label in stage1_runs}
  epochs = {"disp_f32": [1, 2], "disp_bf16": [1], "disp_resume": [3]}
  states = {}
  for label, eps in epochs.items():
    out = returned[label]
    if list(out["train_loss"]) != eps or list(out["val"]) != eps:
      _fail(f"train_cli {label}: ran epochs {list(out['train_loss'])}, "
            f"expected {eps}")
    for ep in eps:
      states[label, ep] = _check_checkpoint(
          label, ck[label] / f"ckpt_disp_ModeDisparity_Deep360_{ep}.tar",
          lambda: ModeDisparity(MAXDISP, device=DEVICE), ep)
      if not all(np.isfinite(v) for v in out["val"][ep]):
        _fail(f"train_cli {label}: validation {out['val'][ep]}")
    _check_logs(label, ck[label] / "logs", {
        "loss disp": dict(enumerate(out["losses"], 1)),
        "total disp train loss": out["train_loss"],
        "total disp validation loss": {e: v[0] for e, v in
                                       out["val"].items()},
        "total disp validation d1": {e: v[1] for e, v in out["val"].items()}})
    for ep in eps:
      if not (ck[label] / "outputs" / f"{ep:03d}_val.png").exists():
        _fail(f"train_cli {label}: no validation colormap for epoch {ep}")
  if result["runs"]["disp_bf16"]["input_dtypes"] != ["torch.float32",
                                                     "torch.uint8"]:
    _fail("train_cli disp_bf16: --device_normalize uploaded "
          f"{result['runs']['disp_bf16']['input_dtypes']}, expected uint8 "
          "images and the f32 ground truth")
  if result["runs"]["disp_f32"]["input_dtypes"] != ["torch.float32"]:
    _fail("train_cli disp_f32: the images were not uploaded normalised")

  # the trace of disp_f32's first epoch names the port's training kernels
  (trace,) = (work / "trace").glob("trace.*.json")
  text = trace.read_text()
  named = {k: k in text for k in TRAIN_KERNEL_NAMES}
  result["trace"] = {"bytes": len(text), "names": named}
  print(f"train_cli trace of disp_f32's first epoch: {trace.name}, "
        f"{len(text) / 2**20:.1f} MiB; the port's kernels named in it: "
        + json.dumps(named), flush=True)
  if not all(named.values()):
    _fail("train_cli: the trace does not name every training kernel")

  # ---- the first step of each stage-1 run against the step built directly
  # on the batch that a loader made as the CLI makes it gives, from the
  # same weights, and that step against its plain step (_plain_check); the
  # f32 one's gradients for the learning-rate check
  lists = list_deep360_disparity_train(str(data))
  result["direct"] = {}
  grads = None
  for label, weights, epoch in (("disp_f32", disp_tar, 1),
                                ("disp_bf16", disp_tar, 1),
                                ("disp_resume", ck["disp_f32"] /
                                 "ckpt_disp_ModeDisparity_Deep360_2.tar", 3)):
    dtype = stage1_runs[label][1]
    ds = Deep360DatasetDisparity(*lists[:3], shape=(h, w),
                                 device_normalize=label == "disp_bf16")
    loader = DataLoader(ds, batch_size=TRAIN_CLI_BATCH, num_workers=4,
                        shuffle=True, seed=123)
    loader.set_epoch(epoch)
    batch = next(iter(loader))
    inputs = [torch.from_numpy(batch[k]).to(DEVICE)
              for k in ("leftImg", "rightImg", "dispMap")]
    cli_inputs = result["runs"][label].pop("first_inputs")
    if not _same_tensors(inputs, cli_inputs):
      _fail(f"train_cli {label}: the first step's batch is not the batch a "
            "loader made as the CLI makes it gives")
    model = ModeDisparity(MAXDISP, device=DEVICE)
    common.load_model_checkpoint(str(weights), model)
    cdt = None if dtype == torch.float32 else dtype
    plain_step = plain_stepper(
        model, functools.partial(_stage1_step, compute_dtype=cdt),
        (*[training.normalize_rgb_on_device(x) if x.dtype == torch.uint8
           else x for x in inputs[:2]], inputs[2]))
    optimizer = training.make_optimizer(model.parameters())
    step = training.make_disparity_train_step(model, optimizer,
                                              compute_dtype=cdt)
    loss = float(step(*inputs))
    got = returned[label]["losses"][0]
    bar = STEP_BARS[dtype]["loss"]
    result["direct"][label] = {"cli": got, "direct": loss,
                               "rel": abs(got - loss) / abs(loss), "bar": bar}
    print(f"train_cli {label}: the first step's loss {got:.7g}, the step "
          f"built directly on the same batch from the same weights {loss:.7g}"
          f" (rel {abs(got - loss) / abs(loss):.3g}, bar {bar})", flush=True)
    if abs(got - loss) > bar * abs(loss):
      _fail(f"train_cli {label}: the first step disagrees with the direct "
            "step")
    _plain_check(f"train_cli {label}", result["direct"][label], plain_step,
                 loss, model, dtype)
    del plain_step
    if label == "disp_f32":
      grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    else:
      # the direct step's own time on the same batch, its loss read back as
      # the CLI reads it, beside the CLI's steps after its first
      times = []
      for _ in range(DIRECT_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        float(step(*inputs))
        times.append((time.perf_counter() - t) * 1e3)
      result["direct"][label]["ms_per_step"] = statistics.mean(times)
      print(f"train_cli {label}: the direct step {statistics.mean(times):.1f}"
            f" ms a step over {DIRECT_STEPS} on one batch, the CLI's "
            f"{result['runs'][label]['ms_per_step_after_first']:.1f} after "
            "its first", flush=True)
    del model, optimizer, step, inputs, cli_inputs
    torch.cuda.empty_cache()

  # ---- the learning rate, read from disp_f32's checkpoints
  w0 = torch.load(disp_tar, weights_only=True)["state_dict"]
  eps32 = torch.finfo(torch.float32).eps
  lr1, lr2 = 1e-3, 1e-4
  held = bad1 = bad2 = total = 0
  dev1 = step2 = 0.0
  for n, g in grads.items():
    p0, p1, p2 = w0[n].float(), states["disp_f32", 1][n], \
        states["disp_f32", 2][n]
    d1, d2 = (p1 - p0).abs(), (p2 - p1).abs()
    mask = g.abs() >= GRAD_HELD
    dev = (d1 - lr1).abs()
    round1 = eps32 * torch.maximum(p0.abs(), p1.abs())
    bad1 += int((mask & (dev > LR_RTOL * lr1 + round1)).sum())
    held += int(mask.sum())
    total += g.numel()
    if mask.any():
      dev1 = max(dev1, float((dev - round1)[mask].max()))
    round2 = eps32 * torch.maximum(p1.abs(), p2.abs())
    bad2 += int((d2 > ADAM_STEP2 * lr2 + round2).sum())
    step2 = max(step2, float(d2.max()))
  result["learning_rate"] = {"held": held, "of": total, "epoch1_bad": bad1,
                             "epoch1_max_dev": dev1, "epoch2_bad": bad2,
                             "epoch2_max_step": step2}
  print(f"train_cli disp_f32 learning rate from its checkpoints: epoch 1, "
        f"{held} of {total} parameter elements with a direct-step gradient "
        f">= {GRAD_HELD}, each moved by {lr1} within {LR_RTOL} of it "
        f"({bad1} off; largest deviation {dev1:.3g} beyond f32 rounding); "
        f"epoch 2, the largest move {step2:.4g} (bar {ADAM_STEP2} x {lr2}; "
        f"{bad2} over)", flush=True)
  if bad1 or bad2 or not held:
    _fail("train_cli disp_f32: the checkpoints do not show lr 1e-3 in "
          "epoch 1 and 1e-4 in epoch 2")

  # ---- stage 2: checkpoints, event files, the packs and the direct step
  fk = {label: work / label / model / "Deep360"
        for label, (model, _, _) in fusion_runs.items()}
  for label, (model, _, _) in fusion_runs.items():
    out = returned[label]
    make = (lambda: ModeFusion(MAX_DEPTH, device=DEVICE)) \
        if model == "ModeFusion" else (lambda: Baseline(MAX_DEPTH,
                                                        device=DEVICE))
    _check_checkpoint(label, fk[label] / "ckpt_fusion_epoch0.tar", make, 0)
    val = out["val"][0]
    if not all(np.isfinite(v) for v in val.values()) or len(val) != 8:
      _fail(f"train_cli {label}: validation {val}")
    _check_logs(label, fk[label] / "log", {
        "Training Loss": out["train_loss"],
        **{k.split(" ")[0]: {0: v} for k, v in list(val.items())[:6]}})
  td, tc, tr, tg, *_ = list_deep360_fusion_train(str(bridge), str(data))
  packs = sorted((work / "packs" / "train").glob("*.mfp"))
  items = Deep360DatasetFusion(td, tc, tr, tg)
  if len(packs) != CLI_FRAMES["training"]:
    _fail(f"train_cli: {len(packs)} packs, expected {CLI_FRAMES['training']}")
  for i, path in enumerate(packs):
    nbytes = 28 + h * w * (6 * 2 + 6 + 4 * 3 + 4)
    depths, confs, rgbs, gt = read_pack(str(path))
    item = items[i]
    views = np.stack([np.asarray(Image.open(tr[k][i]).convert("RGB"))
                      for k in range(4)])
    same = (path.stat().st_size == nbytes
            and np.array_equal(depths, item["depths"][..., 0].astype(
                np.float16))
            and np.array_equal(confs, (item["confs"][..., 0] * 255.0
                                       + 0.5).astype(np.uint8))
            and np.array_equal(rgbs, views)
            and np.array_equal(gt, item["gt"]))
    if not same:
      _fail(f"train_cli: {path.name} ({path.stat().st_size} bytes, expected "
            f"{nbytes}) is not its frame's decoded arrays")
  print(f"train_cli packs: {len(packs)} .mfp files of {nbytes} bytes, each "
        "its frame's decoded arrays (f16 depths, uint8 confidences and "
        "views, f32 ground truth)", flush=True)
  result["direct"].update(_fusion_direct_steps(
      work, fusion_runs, returned, result, tars, (td, tc, tr, tg)))

  # ---- two ranks over gloo on the card (--dp 2 and --sp 2 at a world of
  # 2), then --dp 2 and --sp 2 at a world of 1 refused
  result["two_ranks"] = _train_cli_two_ranks(stage1, work, bn, card)
  result["two_ranks_sp"] = _train_cli_two_ranks(stage1, work, bn, card,
                                                "--sp")
  for flag in (["--dp", "2"], ["--sp", "2"]):
    try:
      train_disparity.main([*stage1, *flag, "--save_checkpoint_path",
                            str(work / "refused")])
    except ValueError as e:
      print(f"train_cli: {' '.join(flag)} refused in one process: {e}",
            flush=True)
    else:
      _fail(f"train_cli: train_disparity {' '.join(flag)} ran in one process")
    if (work / "refused").exists():
      _fail(f"train_cli: the refused {' '.join(flag)} run wrote files")
  result["phase_s"] = time.perf_counter() - t_phase
  print(f"train_cli phase: {result['phase_s']:.2f} s ({card})", flush=True)
  return result


def _train_cli_two_ranks(stage1: list, work: Path, served: dict,
                         card: str, axis: str = "--dp") -> dict:
  """``train_disparity`` as two gloo ranks on the card: with ``--dp 2`` one
  epoch of two steps of the CLI's global batch 4 (two pairs a rank); with
  ``--sp 2`` one step of a global batch of 2 (both pairs on each rank, each
  on its half of the cost volume's rows, the 3-D kernels on their halo
  forms). Each rank's launches (rank 1 its steps', rank 0 also the
  validation's batches, as many as the steps, at the served counts: 4 and
  2 pairs, or 2), the halo launches (none under ``--dp``), rank 0 alone
  writing files, the checkpoint loading strictly."""
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.parallel.launch import run_ranks
  sp = axis == "--sp"
  n = 1 if sp else 2                      # steps, and validation batches
  root = work / ("disp_2ranks_sp" if sp else "disp_2ranks")
  argv = [*stage1, "--epochs", "1", "--steps_per_epoch", str(n),
          "--save_checkpoint_path", str(root), axis, str(DDP_WORLD),
          "--device", RANK_DEVICE, *(["--batch_size", "2"] if sp else [])]
  label = f"train_cli two ranks ({axis} 2)"
  t0 = time.perf_counter()
  ranks = run_ranks(_cli_rank, DDP_WORLD, (argv,), timeout=600,
                    device=RANK_DEVICE, backend="gloo")
  wall = time.perf_counter() - t0
  steps = {k: n * c for k, c in train_expect("train_b2").items()}
  halo = {k: n * c for k, c in SP_TRAIN_HALO.items()} if sp else {}
  _launch_check(f"{label}, rank 1", ranks[1]["launches"], steps)
  _launch_check(f"{label}, rank 0", ranks[0]["launches"], {
      k: steps.get(k, 0) + n * served.get(k, 0)
      for k in set(steps) | set(served)})
  for r in ranks:
    if r["halo"] != halo:
      _fail(f"{label}, rank {r['rank']}: halo launches {r['halo']}, "
            f"expected {halo}")
  if ranks[0]["losses"] != ranks[1]["losses"] or len(ranks[0]["losses"]) != n:
    _fail(f"{label}: losses {ranks[0]['losses']} and "
          f"{ranks[1]['losses']}")
  if ranks[1]["written"] or not ranks[0]["written"]:
    _fail(f"{label}: rank 0 wrote {ranks[0]['written']}, rank 1 "
          f"{ranks[1]['written']}")
  save = root / "ModeDisparity" / "Deep360"
  files = sorted(str(p.relative_to(save)) for p in save.rglob("*")
                 if p.is_file())
  if (len(files) != 3 or files[0] != "ckpt_disp_ModeDisparity_Deep360_1.tar"
      or not files[1].startswith("logs/events.out.tfevents.")
      or files[2] != "outputs/001_val.png"):
    _fail(f"{label}: wrote {files}")
  ModeDisparity(MAXDISP, device=DEVICE).load_state_dict(torch.load(
      save / files[0], weights_only=True)["state_dict"], strict=True)
  print(f"{label} (gloo, {card}): {wall:.1f} s with the processes' start; "
        f"losses {ranks[0]['losses']}; rank 0 wrote "
        f"{len(ranks[0]['written'])} files, rank 1 none; launches rank 0 "
        f"{json.dumps(ranks[0]['launches'])}, halo forms "
        f"{json.dumps(ranks[0]['halo'])}", flush=True)
  return {"wall_s": wall, "losses": ranks[0]["losses"], "files": files,
          "launches": [r["launches"] for r in ranks],
          "halo": [r["halo"] for r in ranks]}


def _plain_check(label, out, plain_step, loss, model, dtype) -> None:
  """A direct step (its ``loss`` and ``model``'s gradients) against its
  plain step at ``STEP_BARS[dtype]``, each leaf's spread the larger of the
  two steps' own, into ``out["plain"]``."""
  out["plain"] = grad_check(label, plain_step, loss, {
      n: p.grad.clone() for n, p in model.named_parameters()}, dtype,
      own_spread=True)
  if not out["plain"]["ok"]:
    _fail(f"{label}: the direct step disagrees with its plain step")


def _baseline_step(m, plain=False):
  """The ``Baseline``'s CLI step of ``m`` at ``FUSION_LR`` with a fresh
  optimizer, as ``step(*depths, gt)``."""
  from mode_tpu_torch import training
  from mode_tpu_torch.cli import train_fusion
  opt = training.make_optimizer(m.parameters())
  training.set_learning_rate(opt, training.FUSION_LR)
  step = train_fusion.make_baseline_step(m, opt, MAX_DEPTH, plain=plain)
  return lambda *xs: step(list(xs[:6]), xs[6])


def _fusion_direct_steps(work, fusion_runs, returned, result, tars,
                         lists) -> dict:
  """Each fusion run's first step against the step built directly on the
  batch that a loader made as the CLI makes it gives (epoch 0, seed 1),
  from the same weights, and that step against its plain step (the packed
  frames unpacked for it, as ``_fusion_train_path`` unpacks them)."""
  from mode_tpu_torch import training
  from mode_tpu_torch.cli import common, train_fusion
  from mode_tpu_torch.data.deep360 import Deep360DatasetFusion
  from mode_tpu_torch.data.fusion_pack import PackedFusionDataset
  from mode_tpu_torch.data.loader import DataLoader
  from mode_tpu_torch.models.fusion import Baseline, ModeFusion
  td, tc, tr, tg = lists
  out = {}
  for label, (model_name, extra, dtype) in fusion_runs.items():
    packed = bool(extra)
    ds = (PackedFusionDataset(sorted(str(p) for p in (
        work / "packs" / "train").glob("*.mfp")), gt_names=tg) if packed
          else Deep360DatasetFusion(td, tc, tr, tg, training=True))
    loader = DataLoader(ds, batch_size=TRAIN_CLI_BATCH, shuffle=True,
                        num_workers=TRAIN_CLI_BATCH, seed=1)
    loader.set_epoch(0)
    keys = (("depths", "confs", "rgbs", "gt") if model_name == "ModeFusion"
            else ("depths", "gt"))
    inputs = train_fusion.upload(next(iter(loader)), keys, DEVICE)
    flat = [x for part in inputs
            for x in (part if isinstance(part, list) else [part])]
    cli_inputs = result["runs"][label].pop("first_inputs")
    if not _same_tensors(flat, cli_inputs):
      _fail(f"train_cli {label}: the first step's batch is not the batch a "
            "loader made as the CLI makes it gives")
    model = (ModeFusion(MAX_DEPTH, device=DEVICE) if model_name ==
             "ModeFusion" else Baseline(MAX_DEPTH, device=DEVICE))
    common.load_model_checkpoint(str(tars[model_name]), model)
    cdt = None if dtype == torch.float32 else dtype
    if model_name == "Baseline":
      plain_step = plain_stepper(model, _baseline_step, flat)
    else:
      floats = (training.unpack_fusion_inputs(*inputs[:3], dtype) if packed
                else inputs[:3])
      plain_step = plain_stepper(
          model, functools.partial(fusion_step, compute_dtype=cdt),
          (*[x for part in floats for x in part], inputs[3]))
    optimizer = training.make_optimizer(model.parameters())
    training.set_learning_rate(optimizer, training.FUSION_LR)
    if model_name == "ModeFusion":
      step = training.make_fusion_train_step(model, optimizer, MAX_DEPTH,
                                             compute_dtype=cdt,
                                             raw_inputs=packed)
    else:
      step = train_fusion.make_baseline_step(model, optimizer, MAX_DEPTH)
    loss = float(step(*inputs))
    got = returned[label]["losses"][0]
    bar = STEP_BARS[dtype]["loss"]
    out[label] = {"cli": got, "direct": loss,
                  "rel": abs(got - loss) / abs(loss), "bar": bar}
    print(f"train_cli {label}: the first step's loss {got:.7g}, the step "
          f"built directly on the same batch from the same weights {loss:.7g}"
          f" (rel {out[label]['rel']:.3g}, bar {bar})", flush=True)
    if abs(got - loss) > bar * abs(loss):
      _fail(f"train_cli {label}: the first step disagrees with the direct "
            "step")
    _plain_check(f"train_cli {label}", out[label], plain_step, loss, model,
                 dtype)
    del model, optimizer, step, inputs, flat, cli_inputs, plain_step
    torch.cuda.empty_cache()
  return out


def _kernel_phase(cases, reg_cases, gen, halo_cases):
  """Every recorded kernel shape once, f32 and bf16, then the halo forms
  at a rank's rows, each beside the kernel's and cuDNN's times of its
  unsharded call (``unsharded_ms``, ``unsharded_library_ms``): the rows it
  prints."""
  rows = []

  def emit(row, **extra):
    row.update(extra)
    rows.append(row)
    print("kernel " + json.dumps(row), flush=True)

  for dtype in (torch.float32, torch.bfloat16):
    library, kernel = {}, {}
    for case, (per_call, layers, batch) in cases.items():
      if case[0] in SPHERE_BWD:
        row = _sphere_bwd_case(case, dtype, gen)
      else:
        row = _conv_case(case, dtype, gen)
      library[case], kernel[case] = row["library_ms"], row["kernel_ms"]
      emit(row, per_call=per_call, tpu=_tpu_kernel(case, layers, batch),
           layers=" ".join(layers[:4]) + (" ..." if len(layers) > 4
                                          else ""))
    for case, per_call in reg_cases.items():
      emit(_regression_case(case, dtype, gen), per_call=per_call,
           tpu="K2" + (" row window" if len(case) > 4 else ""))
    for case, (per_call, layers) in halo_cases.items():
      xs, size = case[1], case[6]
      hx = 1 if len(xs) == 4 else 2                     # the H axis
      whole = (case[0], (*xs[:hx], (xs[hx] - 2) * size, *xs[hx + 1:]),
               *case[2:6])
      emit(_conv_case(case, dtype, gen), per_call=per_call,
           tpu=_tpu_kernel(whole, layers, 1) + " halo form",
           unsharded_ms=kernel.get(whole),
           unsharded_library_ms=library.get(whole),
           layers=" ".join(layers[:4]) + (" ..." if len(layers) > 4
                                          else ""))
  return rows


def _halo_summary(rows, sp_gloo, sp_frame) -> list:
  """The kernels line's entries of the halo forms (and K2's window): f32
  ms per call of one rank of the form's phase (``HALO_PHASE``: a pair's
  rows in ``sp_gloo_2``, a frame's in ``sp_frame_gloo_2``; each shape's
  time alone times its launches per call, summed), its launches in that
  phase's f32 call, and per spatial size the same sums in f32 and bf16,
  beside the unsharded shapes' kernel and cuDNN times."""
  out = []
  phases = {"sp_gloo_2": sp_gloo, "sp_frame_gloo_2": sp_frame}
  for name, (replaces, wrapper) in HALO_KERNELS.items():
    phase = HALO_PHASE.get(name, "sp_gloo_2")
    launched = phases[phase]["ranks"][0]["f32"]["halo"]
    mine = [r for r in rows
            if r["name"] == name and r.get("halo") is not None]
    by_size = {}
    for r in mine:
      label, n = next(iter(r["per_call"].items()))
      t = by_size.setdefault(f"{label} {r['dtype']}", {
          "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
          "unsharded_ms": 0.0, "unsharded_library_ms": 0.0, "ops_ms": 0.0,
          "bytes_ms": 0.0, "launches_per_call": 0})
      t["launches_per_call"] += n
      for key in ("plain_ms", "bound_ms", "library_ms", "unsharded_ms",
                  "unsharded_library_ms", "ops_ms", "bytes_ms"):
        value = r.get(key)
        t[key] = None if value is None or t[key] is None else (
            t[key] + value * n)
      t["ms"] += r["kernel_ms"] * n
    main = by_size[f"{phase} float32"]
    f32 = [r for r in mine if r["dtype"] == "float32"]
    b16 = [r for r in mine if r["dtype"] == "bfloat16"]
    what = ("a 1024x512 pair's rows at spatial 2" if phase == "sp_gloo_2"
            else "a 1024x512 frame's fusion rows at spatial 2")
    out.append({
        "name": f"{name} (h_halo)" if name != "fused_disparity_regression"
                else f"{name} (row window)",
        "route": "cuda", "source": KERNELS[name][0], "replaces": replaces,
        "also_replaces": [wrapper], "main_path": phase,
        "launches": launched.get(name, 0),
        "launches_per_call": main["launches_per_call"],
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        "max_abs_err_bf16": max(r["max_abs_err"] for r in b16),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": ("operations" if main["ops_ms"] >= main["bytes_ms"]
                     else "bytes"),
        "library_ms": main["library_ms"],
        "unsharded_ms": main["unsharded_ms"],
        "unsharded_library_ms": main["unsharded_library_ms"],
        "times": f"f32, ms per call of one {phase} rank ({what}); by_size "
                 "gives spatial 2 and 4 in f32 and bf16 (and a step of "
                 "one sp_train_gloo_2 rank, forward and grad-input, for "
                 "the 3-D convs); library_ms is "
                 "cuDNN on the same haloed rows, unsharded_ms and "
                 "unsharded_library_ms the kernel and cuDNN on the whole "
                 "shapes",
        "by_size": by_size,
        "pass": all(r["pass"] for r in mine)})
  return out


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    return 1
  from mode_tpu_torch.device import ieee_f32_convs
  from mode_tpu_torch.kernels import build

  t_start = time.time()
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
  card = smi.stdout.strip().splitlines()[0]
  print(card, flush=True)
  print(f"card: {card} (nvidia-smi name, power.limit); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

  # ---- build
  t0 = time.time()
  build.build()
  print(f"build: {time.time() - t0:.1f} s for {len(build.SOURCES)} sources "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)
  for name in build.SOURCES:
    log = (build.BUILD_DIR / f"{name}.log").read_text()
    regs = [int(t) for t in re.findall(r"Used (\d+) registers", log)]
    spills = [int(t) for t in re.findall(r"(\d+) bytes spill stores", log)]
    print(f"  ptxas {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
          f"registers, spill stores up to {max(spills)} bytes", flush=True)

  # ---- the Cassini paths: served, trained, the trained weights' step
  gen = torch.Generator(device=DEVICE).manual_seed(0)
  seen = {}
  for label in ("regular_b1", "sphere_b1"):
    model = _served_model(label, gen)
    seen[label] = _serve_path(label, model, gen, 4)
  seen["sphere_b6"] = _serve_path("sphere_b6", model, gen, 12)
  del model
  torch.cuda.empty_cache()
  seen["train_b2"] = _train_path(gen, "train_b2")
  torch.cuda.empty_cache()
  remat = _remat_phase(gen)
  seen.update(remat.pop("seen"))
  seen["train_b2_bf16"] = _train_path(gen, "train_b2_bf16")
  torch.cuda.empty_cache()
  train_anchor = _train_anchor()
  torch.cuda.empty_cache()
  train_anchor_bf16 = _train_anchor(torch.bfloat16)
  torch.cuda.empty_cache()
  for check in (train_anchor, train_anchor_bf16):
    if not check["ok"]:
      _fail("train_anchor: the training step disagrees with its plain step")

  # ---- the ERP paths
  model = _served_model("erp_b1", gen)
  seen["erp_b1"] = _serve_path("erp_b1", model, gen, 4)
  del model
  torch.cuda.empty_cache()
  seen["erp_train_b2"] = _train_path(gen, "erp_train_b2")
  torch.cuda.empty_cache()

  # ---- the whole frame, f32 then bf16 (stage 1 and fusion)
  inputs = _frame_inputs()
  disp, fusion = _frame_models()
  seen["frame"] = _frame_path("frame", disp, fusion, inputs, card)
  # the f32 pipeline's own copies, the fusion head calibrated on the frame
  disp, fusion = seen["frame"].pop("models")
  cli_fusion = {k: v.detach().cpu() for k, v in fusion.state_dict().items()}
  torch.cuda.empty_cache()
  seen["frame_bf16"] = _frame_path("frame_bf16", disp, fusion, inputs, card,
                                   seen["frame"]["outputs"])
  seen["frame_bf16"].pop("models")
  del disp, fusion, inputs
  torch.cuda.empty_cache()

  # ---- training the fusion net, f32 then bf16, from the same weights
  batch_size, (h, w), _ = FUSION_TRAINS["fusion_train_b4"]
  batch = _fusion_batch(gen, batch_size, h, w)
  init = _fusion_model(batch)
  for label in FUSION_TRAINS:
    seen[label] = _fusion_train_path(label, init, batch)
    torch.cuda.empty_cache()
  train_fusion_state = {k: v.detach().cpu() for k, v in
                        init.state_dict().items()}
  del init, batch
  torch.cuda.empty_cache()

  # ---- data parallelism: one NCCL rank in this process, two gloo ranks;
  # then the spatial axis: two gloo ranks serving a pair's rows
  ddp_nccl = _ddp_nccl_phase(gen)
  ddp_gloo = _ddp_gloo_phase(train_fusion_state, card)
  torch.cuda.empty_cache()
  sp_gloo = _sp_gloo_phase(card)
  torch.cuda.empty_cache()
  # the whole frame over the spatial axis, held against the f32 frame
  sp_frame = _sp_frame_phase(card, cli_fusion,
                             seen["frame"].pop("outputs"))
  torch.cuda.empty_cache()
  # training over the spatial axis, held against one process's step
  sp_train = _sp_train_phase(card)
  torch.cuda.empty_cache()

  # ---- the serving CLIs on a Deep360 tree on disk, then the training
  # CLIs on the same tree and the serving phase's stage-1 outputs
  with tempfile.TemporaryDirectory() as tmp:
    cli = _cli_phase(Path(tmp), cli_fusion, card)
    torch.cuda.empty_cache()
    train_cli = _train_cli_phase(Path(tmp), train_fusion_state, card)
    seen.update(train_cli.pop("seen"))
    torch.cuda.empty_cache()

  # ---- kernel phase: every recorded shape once, f32 and bf16
  cases = {}                 # case -> {path: launches per call}, layers
  for label, s in seen.items():
    for case, layers in s["calls"].items():
      # a training call at the shape of a served call shares its timing
      # (the epilogue's residual and ReLU aside)
      same = [c for c in cases if c[:3] == case[:3] and c[5] == case[5]]
      train = label in TRAINS or label in FUSION_TRAINS or s.get("train")
      entry = (cases[same[0]] if train and same
               else cases.setdefault(case, ({}, layers, s["batch"])))
      entry[0][label] = len(layers)
  reg_cases = {}             # the served paths' regression shapes
  for label in PATHS:
    h, w = GEOMETRY[PATHS[label][1]]
    case = ((seen[label]["batch"], MAXDISP // 4, h // 4, w // 4), MAXDISP, h,
            w)
    reg_cases.setdefault(case, {})[label] = 1
  # the halo forms at a rank's rows, and K2's window for rank 1
  halo_cases = _halo_cases(seen["sphere_b1"]["calls"], sp_gloo.pop("calls"))
  halo_cases.update(_conv2d_halo_cases(seen["frame"]["calls"],
                                       seen["sphere_b1"]["calls"],
                                       sp_frame.pop("calls")))
  # and the training step's, forward and grad-input, at a rank's rows
  for case, layers in sp_train.pop("calls").items():
    key = (*case, SP_WORLD)
    if key in halo_cases:
      _fail(f"the halo case {key} stands for two paths")
    halo_cases[key] = ({"sp_train_gloo_2": len(layers)}, layers)
  h, w = GEOMETRY["Cassini"]
  for size in SP_SIZES:
    label = "sp_gloo_2" if size == SP_WORLD else f"spatial_{size}"
    reg_cases[((1, MAXDISP // 4, h // 4, w // 4), MAXDISP, h, w, h // size,
               h // size)] = {label: 1}
  # the plain versions and the library calls in IEEE f32, as the model's
  # forward and training step run their library convs
  with ieee_f32_convs():
    rows = _kernel_phase(cases, reg_cases, gen, halo_cases)
  bad = [r for r in rows if not r["pass"]]
  if bad:
    _fail(f"{len(bad)} kernel comparisons out of tolerance: "
          + "; ".join(f"{r['name']} {r['dtype']} {r['shape']}" for r in bad))

  # ---- full-resolution anchor
  anchor = _anchor()

  # ---- summary: per kernel, the time of each path's calls in the path's
  # dtype (f32, or bf16 for the mixed-precision training steps), each
  # shape's time alone times its launches per call, summed
  summary = []
  whole_rows = [r for r in rows if r.get("halo") is None]
  for name, (source, replaces) in KERNELS.items():
    f32 = [r for r in whole_rows
           if r["name"] == name and r["dtype"] == "float32"]
    b16 = [r for r in whole_rows
           if r["name"] == name and r["dtype"] == "bfloat16"]
    per_path = {}
    for label, s in seen.items():
      mine = [r for r in (b16 if s.get("dtype") == torch.bfloat16 else f32)
              if r["per_call"].get(label)]
      if not mine:
        continue

      def total(key, mine=mine, label=label):
        if any(r[key] is None for r in mine):
          return None
        return sum(r[key] * r["per_call"][label] for r in mine)

      by_tpu = {}
      for r in mine:
        t = by_tpu.setdefault(r["tpu"], {"launches": 0, "ms": 0.0,
                                         "plain_ms": 0.0, "bound_ms": 0.0,
                                         "library_ms": 0.0})
        n = r["per_call"][label]
        t["launches"] += n
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
          value = r["kernel_ms" if key == "ms" else key]
          t[key] = None if value is None or t[key] is None else (
              t[key] + value * n)
      per_path[label] = {
          "dtype": mine[0]["dtype"], "by_tpu": by_tpu,
          "launches": s["launches"].get(name, 0),
          "launches_per_call": s["launches"].get(name, 0) / s["ncalls"],
          "pairs_per_call": s["batch"], "ms": total("kernel_ms"),
          "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
          "library_ms": total("library_ms"),
          "bound_by": ("operations" if total("ops_ms") >= total("bytes_ms")
                       else "bytes")}
    # a training step where the kernel trains, else one pair served
    main_path = next(p for p in (*TRAINS, MAIN_PATH, "erp_b1")
                     if p in per_path)
    main = per_path[main_path]
    summary.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces[0], "also_replaces": list(replaces[1:]),
        "main_path": main_path, "launches": main["launches"],
        "launches_per_call": main["launches_per_call"],
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        "max_abs_err_bf16": max(r["max_abs_err"] for r in b16),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "times": "f32, ms per call of main_path (a training step, or one "
                 "pair served): each shape's time alone times its launches "
                 "per call, summed; per_path gives every path, each in its "
                 "own dtype",
        "per_path": per_path,
        "train_cli_launches": sum(r["launches"].get(name, 0)
                                  for r in train_cli["runs"].values()),
        "pass": all(r["pass"] for r in f32 + b16)})
  summary += _halo_summary(rows, sp_gloo, sp_frame)
  print("kernels: " + ", ".join(
      f"{s['name']} (replaces {', '.join([s['replaces'], *s['also_replaces']])}"
      f") {'pass' if s['pass'] else 'FAIL'}" for s in summary))
  print("paths: " + json.dumps({label: {
      "median_ms_per_call": statistics.median(s["call_ms"]),
      "pairs_per_call": s["batch"], "fe_ms": s["fe_ms"],
      "peak_gib": s["peak_gib"], "profile": s["profile"], **s["check"]}
      for label, s in seen.items() if label in PATHS} | {
          label: {"ms_per_step": statistics.median(s["call_ms"][-2:]),
                  "step_ms": s["call_ms"], "first_step_ms": s["first_ms"],
                  "enqueue_ms": s["enqueue_ms"],
                  "batch": s["batch"], "peak_gib": s["peak_gib"],
                  "losses": s["losses"], "profile": s["profile"],
                  **s["check"]}
          for label, s in seen.items()
          if label in TRAINS or label in FUSION_TRAINS} | {
          label: {"median_ms_per_frame": statistics.median(s["call_ms"]),
                  "frame_ms": s["call_ms"], **s["split_ms"],
                  "peak_gib": s["peak_gib"], "profile": s["profile"],
                  "head_logits": s["head"], **s["check"]}
          for label, s in seen.items() if label in FRAMES} | {
          "train_anchor": train_anchor,
          "train_anchor_bf16": train_anchor_bf16, "anchor": anchor,
          "remat": remat, "ddp_nccl": ddp_nccl, "ddp_gloo_2": ddp_gloo,
          "sp_gloo_2": sp_gloo, "sp_frame_gloo_2": sp_frame,
          "sp_train_gloo_2": sp_train,
          "cli": cli, "train_cli": train_cli}, default=str))
  print(f"total {time.time() - t_start:.1f} s", flush=True)
  print(json.dumps({"kernels": summary}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
