"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device  — a CUDA device is required (no CPU fallback); prints the
               `nvidia-smi --query-gpu=name,power.limit` line.
  2. build   — compiles the CUDA kernels from csrc/ with nvcc.
  3. kernels — each of the six kernels (unprojection in the fused and the
               per-view layout and reprojection, forward and backward)
               against its plain torch version at the flagship shapes
               (B=1, C=64, 40^3 grid, 20 depth samples; P4/P5/P6 =
               40^2/20^2/10^2; V=2 for the fused unprojection, and V=4
               at P4 too, V=4 for the per-view one), float32 with TF32
               off and bfloat16: max abs error vs the stated tolerance;
               the device time per call (CUDA events around 20 calls queued
               behind a spinning kernel) of the kernel, of the plain
               version and of F.grid_sample (the library call that
               computes the same gather, or its backward: timed only,
               never used by the port); the median host-clock call time;
               the bound (bytes over 3.35 TB/s or operations over
               67 TFLOP/s, whichever is larger) from this run's inputs,
               the achieved GB/s and the share of the bound (or, where a
               kernel runs under its HBM bound because the repeated calls
               are served from the 50 MB L2, l2_served=True and no
               share). Every line names the variant launched (the
               flagship tensors must launch the vector forward, the
               unprojection's walk backward and the reprojection's vector
               backward); the unprojection lines also the largest and mean
               number of valid taps that land on one pixel of a view (the
               adds a direct scatter makes to one address per channel).
               The reprojection backward is held to the plain version on a
               CPU copy, exactly, and to itself run to run. Then one level
               of each other variant against plain: the scalar forward and
               the direct backward of both unprojection layouts and the
               reprojection's scalar forward and backward (P4 tensors
               offset by one element, so not 16-byte aligned), and the
               reprojection's chunked backward (80^2 pixels a sample).
               Last, one profiled reprojection backward a dtype: one
               kernel, no memset, no cast.
  4. main    — inference: the engine (compat.MaskRCNN.detect) at the
               flagship config (2 views at 640^2, ResNet-50 with a 5-block
               stage 4, pyramid 64, conv3d, 40^3 grid, 20 samples,
               bfloat16) with seeded random weights, on 3 requests after one
               warm-up; forward launches must be 3 levels x 3 calls (the
               unprojection's in its vector variant) and no backward
               kernel runs; every reprojection launch the vector
               variants. Then the same requests once more, timed part by
               part on the host clock, and one under torch.profiler: its
               host synchronisations. Then the device time of the layout
               copies on either side of the reprojection at each level
               (the fused grid made [B, X, Y, Z, C] for the kernel, the
               rays reshaped by DepthCollapse, and their gradients).
  5. train   — training: compat.MaskRCNN("training").train on a 640^2
               2-view synthetic dataset at the flagship training config
               (bench_train.py's: POST_NMS_ROIS_TRAINING 500,
               TRAIN_ROIS_PER_IMAGE 200, MAX_GT_INSTANCES 100, stage "all",
               frozen BatchNorm), 1 epoch of 3 steps (every kernel launched
               exactly 3 levels x 3 steps; the unprojection's forward in
               its vector variant, its backward in the walk), then a new
               engine resumes from the checkpoint to epoch 2 with
               validation. Losses finite,
               parameters float32. Then the step time after warm-up (host
               clock) and one profiled step's device time.
  6. parity  — inference in float32, TF32 off: detections of the CPU run
               (plain versions) and the GPU run (kernels) must agree, for
               conv3d, add, mean, ident and lstm3d at 256^2 (16^3 grid, 8
               samples) and for the transformer at its 640^2 config (at
               256^2 no ROI routes to P5, the one level it fills).
  7. train parity — one training step each of conv3d (stage "all") and
               lstm3d (stage "grid+": the backbone frozen, so that the
               backbone's ReLU flips stay out of the per-view backward's
               check) at 256^2 in float32, TF32 off, CPU (plain versions)
               against GPU (kernels) from the same weights, batch and ROI
               priorities:
               the five losses within 1e-4 relative, every gradient within
               1e-3 of its tensor's largest magnitude (floor: 1e-6 of the
               step's largest) for 95% of the tensors, and within 1e-2 for
               all (ReLU flips, see GRAD_TOL).
  8. lstm3d main — inference at the per-view kernel's configuration of
               record (phase 4's model with 4 views and lstm3d fusion,
               tools/profile_variants.py:90-93), 3 requests after one
               warm-up: the per-view forward launches 3 levels x 3 calls,
               the fused one never, no backward kernel; the host-clock
               breakdown of each request.
  9. lstm3d train — 3 training steps of that model on a 640^2 4-view
               synthetic dataset (phase 5's training settings): the
               per-view forward and backward launch 3 x 3 times; losses
               finite, parameters float32; step time and one profiled
               step's device time.
 10. transformer — the transformer config (tools/profile_variants.py:
               94-101: 2 views, pyramid and d_model 72, one sample, the
               XFORMER_* defaults) with seeded depths: 3 detect requests
               and 3 training steps (dropout 0.1 from the engine's
               generator); no geometry kernel launches.
 11. cli     — the InteriorNet command line (cli/interior_multi.py) at its
               own flagship config (2 views at 640^2, ResNet-50 with the
               5-block stage 4, pyramid 64, conv3d on a 40^3 grid, 20
               samples, bfloat16; STEPS_PER_EPOCH=2, VALIDATION_STEPS=1):
               the port's exporter writes a synthetic HD7 tree (3 train and
               2 val scenes of 8 views at 640^2, focal 600, so the
               hard-coded InteriorNet K holds) under build/; `train
               --epochs 1,2,3 --save-every 1` runs as a subprocess, killed
               with SIGKILL once epoch 1's checkpoint is on disk; the same
               command with --model last then resumes in this process
               (main()), skipping the finished stages, to epoch 3: one
               metrics.jsonl line and one tfevents scalar event per epoch
               run, finite losses; then `evaluate --model last --limit 2`
               prints a finite mAP@50 in [0, 1]; then `visualize --model
               last --limit 2` (drawn with OpenCV where matplotlib is not
               installed) writes <results>/NV2/<key>.jpg for the first 2
               val keys, each a 640^2 JPEG that OpenCV decodes. The resumed
               run must launch the fused unprojection and the reprojection,
               forward and backward (3 levels a step, forwards in the
               validation step too), the evaluation and the drawing both
               forwards, all in the main paths' variants, on an engine
               whose weights are all on the card. One JSON line: the step
               times, each key's evaluate time, the drawing's time and
               bytes, and the launches.
 12. serve   — the serving path (cli/serve.py's and cli/serve_bench.py's
               config: the flagship at bfloat16 with FOLD_BN, here with
               UINT8_IMAGE_TRANSFER on, batch 4). First the fused
               unprojection forward and the reprojection forward at B = 4,
               at P4, P5 and P6, each scene with its own poses and focal
               length, in float32 (TF32 off) and bfloat16, against plain
               at phase 3's tolerance and timed as phase 3 times them.
               Then, in float32 at the parity phase's 256^2 with mildly
               randomised BN statistics, 4 scenes through the MicroBatcher
               to a folded, uint8, batch-4 GPU engine against a batch-1,
               unfolded, float-molded CPU engine, each at the parity bar.
               Then the flagship at 640^2 (BN statistics mildly
               randomised too): the fold in bfloat16 against a float32
               unfolded engine with the same weights (the fused pyramid,
               the RPN outputs, and both heads on the reference's maps and
               proposals: the folded engine's relative error at most
               FOLD_NOISE times the unfolded bfloat16 engine's; printed
               beside it, how few detections bfloat16 rounding alone
               leaves matched; then the folded copy with one BN's fold
               undone, for a conv of the backbone, a U-Net and the mask
               head in turn, must fail that bar); the
               MicroBatcher's results equal a direct detect of the same 4
               scenes (class ids, boxes and scores within 1e-5); 16 POSTs
               from 4 client threads through the stdlib HTTP server
               (serve/http_server.py) on localhost, all resolved with
               640^2 masks and finite scores, /stats counting 16 in at
               least 4 batches, /healthz ok, 3 fused unprojection and 3
               reprojection forwards a batch in their vector variants and
               nothing else; the device events of one profiled forward
               unfolded and folded (each BN's two kernels and one device
               copy gone, no BN kernel left); serve_bench's requests/s,
               mean latency and detections a request at batch 1 and 4 (32
               requests, at the tool's 0.7 confidence threshold); one
               batch's host breakdown (at threshold 0.0: 100 masks a
               scene), the uint8 upload's bytes against float32's, the
               folded copy's size and the peak device memory. One JSON
               line {"phase": "serve", ...}.
 13. train_options — the training options, at full width. (a) The
               flagship training config with TRAIN_BN and REMAT: 3 steps
               through compat.MaskRCNN.train; every BatchNorm's running
               statistics move (backbone, fusion, collapse, heads); then
               a step at stage "heads" moves the frozen backbone's
               statistics and none of its parameters; a validation step
               moves none; the kernels launch 3 levels x 3 steps forward
               and backward in the main variants (none from a REMAT
               recomputation), the validation step forwards only; step
               time and a profiled step. (b) The 4-view conv3d step at
               640^2 in bf16, REMAT off then on, same weights, batch and
               priorities: the peak device memory of a step, the step
               time, the first step's losses within REMAT_LOSS_REL. (c)
               TRILINEAR_REPROJECTION: CPU vs GPU detections (phase 6's
               bar) and a train step at stage "all" (phase 7's rule, the
               backbone's CPU-vs-GPU ReLU flips pinned to the CPU's
               values) at 256^2 in float32, TF32 off, the reprojection
               kernels never launched; then 3 flagship requests in bf16, the fused
               unprojection 3 x 3 times and nothing else. (d) Two spawned
               ProcessPrefetcher workers feed 3 flagship steps, each batch
               equal to make_batch for its seed (workers report any CUDA
               initialisation as a failure); a worker killed with SIGKILL
               surfaces as PrefetchError within KILL_BOUND_S; no worker
               left alive. (e) Two ranks on the card over gloo, spawned
               here: at 256^2 in float32, TF32 off, one step with frozen
               BN and one with TRAIN_BN, the ranks holding different
               numbers of positive anchors: the ranks bit-equal, and
               against the single-process batch-2 step the losses and the
               updated statistics within 1e-4, the gradients by phase 7's
               rule with frozen BN and by DP_BN_GRAD_TOL / DP_BN_NORM_TOL
               with TRAIN_BN, the biases whose exact gradient is zero
               left out (`rounding_only`); a third step with the
               BatchNorm sums' backward all-reduce dropped must fail that
               rule; then 2 flagship steps in
               bf16 through compat.MaskRCNN.train, each step's time and
               its gradient all-reduce's share; rank 0 alone writes. One
               JSON line {"phase": "train_options", ...}.
 14. mesh    — the device mesh (parallel/mesh.py), 4 ranks spawned on the
               one card over gloo, each with its own CUDA context; every
               number labelled "4 processes on one H100 over gloo" with
               the nvidia-smi line. The one-process references come
               first, in this process. (a) 256^2 float32, TF32 off,
               frozen BN, conv3d: one step through
               make_parallel_train_step (views sharded, the TP rule
               applied) on (data, view, model) = (1, 2, 2), (2, 2, 1) and
               (2, 1, 2) against the one-process step on the same global
               batch and ROI priorities, the backbone ReLU inputs whose
               sign differs from the one-process step's counted on each
               rank, at most MESH_FLIP_MAX (32), and on (1, 2, 2) and
               (2, 1, 2) pinned to the one-process value
               (`_BackboneRelu`, phase 7's pin for all of them: cuDNN
               rounds the ranks' convolutions otherwise, and a flip at a
               residual sum moves the gradients below it by percents);
               (2, 2, 1) runs unpinned: losses within 1e-4 * max(1,
               |v|), gradients (split ones gathered) by phase 7's rule, the split leaves' updates by
               it beyond one float32 spacing of the weight, every whole
               parameter bit-equal on every rank and every split one on
               the ranks that hold it (sha1 digests). Then (1, 2, 2) once
               more with a sharding fault planted before the views'
               gather (MESH_PLANTED: the second view rank reads the first
               view's images): the flip gate or the gradient gate must
               refuse it; one line `[mesh_planted]` with each rank's
               flips, the largest gradient error and which gate refused.
               (b) lstm3d
               inference at 256^2 float32 on (2, 2, 1), each scene on its
               own (1, 2, 1): each rank's detections against the
               one-process run at phase 6's bar, the raw detections'
               largest difference, 3 per-view unprojection and 3
               reprojection forwards a rank. (c) the flagship training
               config in bf16 on (1, 2, 2): 3 steps timed (host clock to
               a synchronisation), each rank's peak device memory
               against the one-process steps', the fused unprojection and
               the reprojection 9 times each way a rank; then one more
               step with every collective timed between two
               synchronisations for their share of it. One JSON line
               {"phase": "mesh", ...}; each rank's launches of (b) and
               (c) are paths of the kernels' record.
 15. eval_step — train/step.py::make_eval_step once at the flagship
               config with TRAIN_BN and BN_EVAL_BATCH_STATS (the BatchNorm
               statistics mildly randomised): 3 fused unprojection and 3
               reprojection forwards in their vector variants, finite
               outputs, every BatchNorm buffer bit-unchanged, the outputs
               other than the frozen BatchNorms'. One JSON line
               {"phase": "eval_step", ...}; its launches are a path of the
               kernels' record.
 16. train_to_ap — the quality harness (cli/train_to_ap.py) at 64^2, 2
               views, conv3d: first every kernel call of a 2-step run
               and its evaluation (min confidence 0) held to its plain
               version on a CPU copy of its inputs, at this path's shapes
               (C = 64, P2-P6 maps of 16^2 down to 1^2, a 16^3 grid, 8
               samples), with phase 3's tolerances; then (a) 200 steps
               from scratch with --smoke
               --diagnostics (TRAIN_BN, 5 projected levels), its
               evaluation and diagnostics; the mean loss of the last 20
               steps must fall below TTA_LOSS_FRACTION of the first 20's,
               and a 60-step run with its learning rate planted at 1e-9
               (no evaluation) must fail that gate. The fused
               unprojection and the reprojection, forward and backward,
               launched 5 levels a step, the forwards also 5 a detect and
               a run_graph call of the evaluation, in the main paths'
               variants. (b), started after (a)'s timed run and run
               beside the planted one: cli/train_supervisor.py as a
               subprocess with
               --max-rss-gb 0.001 (every segment passes its budget after
               one step) to --until-step 2: two segments exit 75, a third
               resumes at step 2 and ends with cumulative_seconds. One
               JSON line {"phase": "train_to_ap", ...}; (a)'s launches are
               a path of the kernels' record. Before (a), the records'
               batch: every kernel call of a 2-step run at --batch 4 and
               its evaluation (at batch 1, as the harness evaluates) held
               to plain, each of the four kernels with batch-4 calls
               among them; then TTA_B4_STEPS steps at --batch 4, timed
               (step_ms under "batch4" in the phase's line, beside the
               card's name and power limit) and counted as the path
               train_to_ap_b4: the four kernels launched 5 levels a step.
 17. examples — the two example programs (mulit_view_object_detection_
               torch/examples/): every kernel call of demo_synthetic's
               run_demo and of projection_playground's run_playground
               (both lattices) held to its plain version on a CPU copy
               (`held_to_plain`); then each program's main() in this
               process, from a scratch working directory: the demo (2
               views at 64^2, add fusion, pyramid 32) launches the
               per-view unprojection and the reprojection forwards 3
               levels each in their vector variants, the playground (RGB
               as 3 channels on a 32^3 lattice, 6 depth samples) one of
               each in their scalar variants, with and without
               --camera-anchored; each writes its image (demo_output.jpg,
               projection_playground.png), which OpenCV must decode; the
               three `python -m` commands run as subprocesses beside
               them and must exit 0 with their images written. One JSON
               line {"phase": "examples", ...}; the launches are the
               paths demo_synthetic and projection_playground of the
               kernels' record.
 18. tools   — the four measurement tools (mulit_view_object_detection_
               torch/cli/) at full width on the card. First every kernel
               call of one forward of each variant below and of one
               flagship train step held to its plain version
               (`held_to_plain`, not counted); then profile_variants
               for every variant at batch 1 and conv3d at batch 4
               (loop-difference ms/frame); mfu_report for conv3d
               inference at batch 1 and 4 and the flagship train step
               (exact FLOPs, the must-move and the eager bytes, ms, MFU
               and the roofline floor); trace_analysis of conv3d
               inference (its top 15 device ops, the device's busy time
               against the trace's span); bench_input at 640^2, 2
               views, thread mode, workers 1 and 4, 16 batches. Every line must parse, every
               ms be > 0, every MFU lie in (0, 1]; conv3d's FLOPs at
               batch 4 must be exactly 4 times batch 1's; the trace's
               device events must hold the unprojection and reprojection
               kernels; every kernel the tools launched must have been
               held to plain. One JSON line {"phase": "tools", ...}; the
               launches of the whole phase are the path `tools` of the
               kernels' record.
The line before the last is the kernels' JSON record; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import hashlib
import io
import itertools
import json
import multiprocessing
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock
from urllib.request import urlopen

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False — needs a GPU")

import cv2  # noqa: E402

import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from mulit_view_object_detection_torch.cli import interior_multi as cli  # noqa: E402
from mulit_view_object_detection_torch.cli import serve_bench  # noqa: E402
from mulit_view_object_detection_torch.cli import (  # noqa: E402
    train_to_ap as tta)
from mulit_view_object_detection_torch.cli.export_synthetic_interiornet import (  # noqa: E402
    export_subset)
from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from mulit_view_object_detection_torch.compat import model as engine  # noqa: E402
from mulit_view_object_detection_torch.cli.measure import (  # noqa: E402
    flagship_train_config)
from mulit_view_object_detection_torch.cli.profile_variants import (  # noqa: E402
    variant_config)
from mulit_view_object_detection_torch.data.generator import (  # noqa: E402
    PrefetchError, ProcessPrefetcher, make_batch)
from mulit_view_object_detection_torch.data.synthetic import (  # noqa: E402
    SyntheticMultiViewDataset)
from mulit_view_object_detection_torch.kernels import (  # noqa: E402
    build, reproject, unproject)
from mulit_view_object_detection_torch.models.layers import shard_of  # noqa: E402
from mulit_view_object_detection_torch.models import (  # noqa: E402
    resnet as resnet_module)
from mulit_view_object_detection_torch.models.resnet import BatchNorm  # noqa: E402
from mulit_view_object_detection_torch.ops import projection as plain  # noqa: E402
from mulit_view_object_detection_torch.ops.roi_align import (  # noqa: E402
    pyramid_roi_align)
from mulit_view_object_detection_torch.parallel import (  # noqa: E402
    data_parallel_group, host_local_batch_slice, init_distributed)
from mulit_view_object_detection_torch.parallel import (  # noqa: E402
    distributed as parallel_dist)
from mulit_view_object_detection_torch.parallel import (  # noqa: E402
    mesh as parallel_mesh)
from mulit_view_object_detection_torch.serve import (  # noqa: E402
    MicroBatcher, detect_remote, make_server)
from mulit_view_object_detection_torch.train.optim import (  # noqa: E402
    make_optimizer)
from mulit_view_object_detection_torch.train import (  # noqa: E402
    step as step_module)
from mulit_view_object_detection_torch.train.step import (  # noqa: E402
    draw_priorities, loss_and_grads, make_eval_step, train_step, val_step)
from mulit_view_object_detection_torch.train.trainable import (  # noqa: E402
    trainable_mask)
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    bn_module_names)
from mulit_view_object_detection_torch.utils.logging_utils import (  # noqa: E402
    read_tb_events)
from tools.torch_kernel_ab import host_syncs  # noqa: E402

DEV = torch.device("cuda", 0)
ROOT = os.path.dirname(os.path.abspath(__file__))
LEVELS = {"P4": 40, "P5": 20, "P6": 10}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12                 # outside the tensor cores (the kernels'
                                   # arithmetic is float32 in any dtype)
BF16_STEP = 2.0 ** -7           # a bf16 step: at most 2^-7 of the value
# Forward: unprojection plain and kernel round the same float32 ops in the
# same order (explicitly rounded in the kernel), then the same ReLU;
# bfloat16 rounds the same float32 sum once: exact in both layouts.
# Reprojection copies values: exact. Its backward adds each voxel's g rows
# in float32 from 0 in ascending (sample, pixel) order and rounds once, as
# the plain index_add_ does on the CPU: exact against the plain version
# computed on a CPU copy (on the card the plain version adds with atomics
# in no fixed order). Absolute tolerances.
TOL = {("unproject", torch.float32): 0.0,
       ("unproject", torch.bfloat16): 0.0,
       ("unproject_view", torch.float32): 0.0,
       ("unproject_view", torch.bfloat16): 0.0,
       ("reproject", torch.float32): 0.0,
       ("reproject", torch.bfloat16): 0.0,
       ("reproject_bwd", torch.float32): 0.0,
       ("reproject_bwd", torch.bfloat16): 0.0}
# The unprojection's backward: both sides sum in float32 with atomics in
# no fixed order (up to 4,720 terms per element at P6, phase 3's
# adds_per_pixel_max), so |got - ref| <= 1e-4 * max|ref|; bfloat16 casts
# that sum once: where the two sums straddle a rounding boundary they
# differ by one bf16 step of the element more.
BWD_REL = 1e-4
REPLACES = {
    "unproject": "mulit_view_object_detection_tpu/kernels/"
                 "unproject_pallas.py:185",
    "unproject_bwd": "mulit_view_object_detection_tpu/kernels/"
                     "unproject_pallas.py:293",
    "unproject_view": "mulit_view_object_detection_tpu/kernels/"
                      "unproject_pallas.py:250",
    "unproject_view_bwd": "mulit_view_object_detection_tpu/kernels/"
                          "unproject_pallas.py:293",
    "reproject": "mulit_view_object_detection_tpu/kernels/"
                 "reproject_pallas.py:168",
    "reproject_bwd": "mulit_view_object_detection_tpu/kernels/"
                     "reproject_pallas.py:228",
}
JSON_NAMES = {"unproject": "unproject_fused",
              "unproject_bwd": "unproject_fused_bwd",
              "unproject_view": "unproject",
              "unproject_view_bwd": "unproject_bwd",
              "reproject": "reproject_nearest",
              "reproject_bwd": "reproject_nearest_bwd"}
# Train-step parity, CPU vs GPU: a ReLU whose input lies within float32
# noise of zero passes its gradient on one device and not the other. At
# this size one such input (|x| < 3e-5) in each of res4e's and res4f's
# bn2a changes sign between the CPU and the H100: it moves the tensors
# before it by up to 0.6%, and every layer below by ~0.1% through the
# backward pass; run to run on the GPU alone (same forward) the step
# repeats to 3e-6. So every gradient is held within GRAD_FLIP_TOL of its
# tensor's largest magnitude, and all but GRAD_FLIP_SHARE of the tensors
# within GRAD_TOL.
GRAD_TOL = 1e-3
GRAD_FLIP_TOL = 1e-2
GRAD_FLIP_SHARE = 0.05
_CSRC = "mulit_view_object_detection_torch/csrc/"
SOURCES = {"unproject": _CSRC + "unproject.cu",
           "unproject_bwd": _CSRC + "unproject.cu",
           "unproject_view": _CSRC + "unproject.cu",
           "unproject_view_bwd": _CSRC + "unproject.cu",
           "reproject": _CSRC + "reproject.cu",
           "reproject_bwd": _CSRC + "reproject.cu"}
KERNELS = ("unproject", "unproject_bwd", "unproject_view",
           "unproject_view_bwd", "reproject", "reproject_bwd")


class FlagshipConfig(type(variant_config("conv3d"))):
    """bench.py's flagship: cli/profile_variants.py's conv3d variant (the
    TPU-only lowerings off, the port runs the plain layers they lower),
    with the BatchNorms left unfolded."""
    NAME = "flagship_640"
    DETECTION_MIN_CONFIDENCE = 0.0   # random weights still give rows
    FOLD_BN = False


class FlagshipTrainConfig(type(flagship_train_config())):
    """bench_train.py:22-53's flagship training config
    (cli/measure.py::flagship_train_config); 3 steps an epoch, 1
    validation step, its detections at the flagship's 500 proposals."""
    NAME = "flagship_train_640"
    DETECTION_MIN_CONFIDENCE = 0.0
    POST_NMS_ROIS_INFERENCE = 500
    STEPS_PER_EPOCH = 3
    VALIDATION_STEPS = 1


class Lstm4Config(type(variant_config("lstm3d4"))):
    """The per-view kernel's configuration of record: the lstm3d4 variant,
    bench.py:97-116's BenchConfig with 4 views and lstm3d fusion
    (tools/profile_variants.py:90-93, BENCH_4VIEW_r05.json's
    4view_640_lstm3d row)."""
    NAME = "lstm3d4_640"
    DETECTION_MIN_CONFIDENCE = 0.0
    FOLD_BN = False


class Lstm4TrainConfig(Lstm4Config):
    """Lstm4Config with FlagshipTrainConfig's training settings."""
    NAME = "lstm3d4_train_640"
    POST_NMS_ROIS_TRAINING = 500
    TRAIN_ROIS_PER_IMAGE = 200
    MAX_GT_INSTANCES = 100
    STEPS_PER_EPOCH = 3


class XformerConfig(type(variant_config("xformer"))):
    """tools/profile_variants.py:94-101: 2 views, the transformer on P5
    (pyramid and d_model 72, one sample per ray), XFORMER_* defaults
    (6 layers, 8 heads, dff 256, dropout 0.1)."""
    NAME = "xformer_640"
    DETECTION_MIN_CONFIDENCE = 0.0
    FOLD_BN = False


class XformerTrainConfig(XformerConfig):
    NAME = "xformer_train_640"
    POST_NMS_ROIS_TRAINING = 500
    TRAIN_ROIS_PER_IMAGE = 200
    MAX_GT_INSTANCES = 100
    STEPS_PER_EPOCH = 3


class Flagship256(FlagshipConfig):
    """The shape of __graft_entry__._flagship_config(256), in float32."""
    NAME = "flagship_256"
    IMAGE_MIN_DIM = 256
    IMAGE_MAX_DIM = 256
    RPN_ANCHOR_SCALES = (16, 32, 64, 128, 256)
    nvox = 16
    nvox_z = 16
    samples = 8
    COMPUTE_DTYPE = "float32"


class Flagship256Train(Flagship256):
    """The 256^2 parity model training, with fewer proposals and ROIs so
    that fewer NMS and top-k decisions sit near a float32 tie."""
    NAME = "flagship_train_256"
    PRE_NMS_LIMIT = 500
    POST_NMS_ROIS_TRAINING = 100
    TRAIN_ROIS_PER_IMAGE = 50
    MAX_GT_INSTANCES = 10


def with_fusion(cls, mode):
    """`cls` with GRID_REAS = mode (its name suffixed)."""
    return type(f"{cls.__name__}_{mode}", (cls,), {
        "NAME": f"{cls.NAME}_{mode}", "GRID_REAS": mode})


class Xformer640F32(XformerConfig):
    """The transformer's parity config: its config of record in float32."""
    NAME = "xformer_640_f32"
    COMPUTE_DTYPE = "float32"


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def poses(rng, b, v):
    """Seeded cam->world poses: view 0 is the grid's frame, the others
    turn by up to ~17 degrees and shift by up to 0.6 m, so that part of
    the grid falls outside them."""
    out = np.tile(np.eye(3, 4, dtype=np.float32), (b, v, 1, 1))
    for i in range(b):
        for j in range(1, v):
            a = rng.uniform(-0.3, 0.3, 3)
            c, s = np.cos(a), np.sin(a)
            rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
            ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
            rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
            out[i, j, :, :3] = rx @ ry @ rz
            out[i, j, :, 3] = rng.uniform(-0.6, 0.6, 3)
    return out


def intrinsics(b, hw):
    return np.tile(np.array([[0.9 * hw, 0, hw / 2], [0, 0.9 * hw, hw / 2],
                             [0, 0, 1]], np.float32), (b, 1, 1))


def median_ms(fn, runs=30):
    """Median host-clock time of one call that ends in a synchronise
    (CUDA events around each call: host launch overhead included)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, runs=20):
    """Device time per call, ms: the calls are queued behind a kernel that
    spins (torch.cuda._sleep) for longer than the host takes to launch
    them, so the CUDA events around them time the device running them back
    to back, not the host's launch overhead. (A call that synchronises the
    host would stall the queue and count host time too.)"""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * runs * host_ms + 5) * 2e6))   # <= 2 GHz
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def device_profile(fn, attempts=3):
    """One profiled call of fn (torch.profiler). Returns (device time of
    its kernels, copies and memsets in ms, device events), or
    (None, None) if no attempt recorded device time."""
    torch.cuda.synchronize()
    for _ in range(attempts):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in events)
        if busy_us > 0:
            return busy_us / 1e3, sum(e.count for e in events)
    return None, None


def device_events(fn):
    """The device events of one profiled call of fn (torch.profiler):
    {kernel, memset or copy name: count}."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def bound_ms(nbytes, flops):
    """(least time the card could take in ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


SMI = []        # the nvidia-smi line, once phase_device has read it


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    SMI.append(smi)
    name = torch.cuda.get_device_name(0)
    say("device", name=json.dumps(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return name


def phase_build():
    t = time.perf_counter()
    build.build()
    build.library.cache_clear()
    build.library()
    say("build", seconds=round(time.perf_counter() - t, 3),
        library=build.library_path().relative_to(build.BUILD_DIR.parents[1]))


def _unproject_cases(feats, x, y, s, v, dtype):
    """The unprojection's forward and backward: (kernel, plain, library,
    bytes, flops, tolerance check) for each, at one level."""
    bv, p, c = feats.shape
    n = x.shape[1]
    es = feats.element_size()
    saved = unproject.gather_fused(feats, x, y, s, s, v, True)
    gen = torch.Generator(DEV).manual_seed(s)
    g = torch.randn(saved.shape, generator=gen, device=DEV).to(dtype)
    # F.grid_sample: NCHW view of the features, coordinates normalised for
    # align_corners=True, in the input's dtype (the library's rule)
    inp = feats.reshape(bv, s, s, c).permute(0, 3, 1, 2)
    coords = torch.stack([2 * x / (s - 1) - 1, 2 * y / (s - 1) - 1],
                         -1)[:, None].to(dtype)
    lib_in = inp.detach().clone().requires_grad_()
    lib_out = F.grid_sample(lib_in, coords, mode="bilinear",
                            padding_mode="zeros", align_corners=True)
    lib_g = torch.randn(lib_out.shape, generator=gen, device=DEV).to(dtype)
    passing = int((saved > 0).sum())
    coord_bytes = 2 * bv * n * 4
    return {
        "unproject": (
            lambda: unproject.gather_fused(feats, x, y, s, s, v, True),
            lambda: plain.bilinear_gather_fused(feats, x, y, s, s, v, True),
            lambda: F.grid_sample(inp, coords, mode="bilinear",
                                  padding_mode="zeros", align_corners=True),
            bv * p * c * es + coord_bytes + saved.numel() * es,
            7 * saved.numel()),
        # the backward reads saved everywhere and g where saved > 0
        "unproject_bwd": (
            lambda: unproject.gather_fused_bwd(g, saved, x, y, s, s, v, True),
            lambda: plain.bilinear_gather_fused_bwd(g, saved, x, y, s, s, v,
                                                    True, dtype),
            lambda: torch.autograd.grad(lib_out, lib_in, lib_g,
                                        retain_graph=True),
            saved.numel() * es + passing * es + coord_bytes
            + bv * p * c * es,
            8 * passing),
    }


def _unproject_view_cases(feats, x, y, s, dtype):
    """The per-view unprojection's forward and backward, as
    _unproject_cases gives the fused one's."""
    bv, p, c = feats.shape
    n = x.shape[1]
    es = feats.element_size()
    gen = torch.Generator(DEV).manual_seed(s + 1)
    g = torch.randn((bv, n, c), generator=gen, device=DEV).to(dtype)
    inp = feats.reshape(bv, s, s, c).permute(0, 3, 1, 2)
    coords = torch.stack([2 * x / (s - 1) - 1, 2 * y / (s - 1) - 1],
                         -1)[:, None].to(dtype)
    lib_in = inp.detach().clone().requires_grad_()
    lib_out = F.grid_sample(lib_in, coords, mode="bilinear",
                            padding_mode="zeros", align_corners=True)
    lib_g = torch.randn(lib_out.shape, generator=gen, device=DEV).to(dtype)
    coord_bytes = 2 * bv * n * 4
    return {
        "unproject_view": (
            lambda: unproject.gather(feats, x, y, s, s),
            lambda: plain.bilinear_gather(feats, x, y, s, s),
            lambda: F.grid_sample(inp, coords, mode="bilinear",
                                  padding_mode="zeros", align_corners=True),
            bv * p * c * es + coord_bytes + bv * n * c * es,
            7 * bv * n * c),
        # reads all of g, writes dfeats
        "unproject_view_bwd": (
            lambda: unproject.gather_bwd(g, x, y, s, s),
            lambda: plain.bilinear_gather_bwd(g, x, y, s, s, dtype),
            lambda: torch.autograd.grad(lib_out, lib_in, lib_g,
                                        retain_graph=True),
            bv * n * c * es + coord_bytes + bv * p * c * es,
            8 * bv * n * c),
    }


def adds_per_pixel(x, y, s):
    """(largest, mean) number of valid taps of x, y [BV, N] that land on
    one pixel of one view's s x s map: the adds a direct scatter makes to
    one address per channel."""
    counts = torch.zeros(x.shape[0] * s * s, device=x.device)
    base = torch.arange(x.shape[0], device=x.device)[:, None] * s * s
    for idx, _, valid in plain._bilinear_taps(x, y, s, s):
        hit = (base + idx)[valid]
        counts.index_add_(0, hit, torch.ones_like(hit, dtype=torch.float32))
    return int(counts.max()), float(counts.mean())


def variants_of(name):
    """The launch counter by variant of kernel `name` (its layout's, for
    the unprojection)."""
    if name.startswith("unproject_view"):
        return unproject.view_variants
    if name.startswith("unproject"):
        return unproject.fused_variants
    return reproject.variants


def launched_variant(name, fn):
    """fn's result and the variant of kernel `name` that it launched."""
    counter = variants_of(name)
    before = dict(counter)
    out = fn()
    grew = [k for k, n in counter.items() if n > before.get(k, 0)]
    return out, ",".join(grew) or None


def _reproject_cases(grid, xg, yg, iz, dtype):
    """The reprojection's forward and backward, as _unproject_cases gives
    the unprojection's; the backward's tuple ends with its exact
    reference, the plain version on a CPU copy."""
    b, nx, ny, nz, c = grid.shape
    s_d, npix = xg.shape[1], xg.shape[2]
    es = grid.element_size()
    idx, valid = plain._nearest_voxels(xg, yg, iz, nx, ny, nz)
    n_valid = int(valid.sum())
    touched = int(torch.unique(
        (idx + torch.arange(b, device=DEV)[:, None, None] * nx * ny * nz)
        [valid]).numel())
    gen = torch.Generator(DEV).manual_seed(nz + s_d)
    g = torch.randn((b, s_d, npix, c), generator=gen, device=DEV).to(dtype)
    # F.grid_sample 5-D nearest: [B, C, D=nx, H=ny, W=nz] view of the
    # grid, coordinates (W, H, D) = (iz, y, x) normalised for
    # align_corners=True (iz = -1 lands outside: zeros)
    vol = grid.permute(0, 4, 1, 2, 3)
    izt = torch.as_tensor(np.asarray(iz, np.float32), device=DEV)
    coords = torch.stack([
        (2 * izt / (nz - 1) - 1)[None, :, None].expand(b, s_d, npix),
        2 * yg / (ny - 1) - 1, 2 * xg / (nx - 1) - 1], -1)[:, :, :, None]
    coords = coords.to(dtype)
    lib_in = vol.detach().clone().requires_grad_()
    lib_out = F.grid_sample(lib_in, coords, mode="nearest",
                            padding_mode="zeros", align_corners=True)
    lib_g = torch.randn(lib_out.shape, generator=gen, device=DEV).to(dtype)
    coord_bytes = 2 * b * s_d * npix * 4
    return {
        # the gather reads the voxels it selects, once each
        "reproject": (
            lambda: reproject.gather(grid, xg, yg, iz),
            lambda: plain.zslice_gather(grid, xg, yg, iz),
            lambda: F.grid_sample(vol, coords, mode="nearest",
                                  padding_mode="zeros", align_corners=True),
            touched * c * es + coord_bytes + b * s_d * npix * c * es, 0),
        # the scatter reads g of the valid samples, writes the whole grid
        "reproject_bwd": (
            lambda: reproject.gather_bwd(g, xg, yg, iz, tuple(grid.shape)),
            lambda: plain.zslice_gather_bwd(g, xg, yg, iz, tuple(grid.shape),
                                            dtype),
            lambda: torch.autograd.grad(lib_out, lib_in, lib_g,
                                        retain_graph=True),
            n_valid * c * es + coord_bytes + grid.numel() * es,
            n_valid * c,
            lambda: plain.zslice_gather_bwd(g.cpu(), xg.cpu(), yg.cpu(), iz,
                                            tuple(grid.shape), dtype)),
    }


def _check(name, got, want, dtype):
    """(max abs error, tolerance description); raises past tolerance."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                           f"{tuple(want.shape)} {want.dtype}")
    err = (got.float().to(want.device) - want.float()).abs()
    max_err = float(err.max())
    if (name, dtype) in TOL:
        tol = TOL[(name, dtype)]
        ok = max_err <= tol
    else:
        scale = float(want.float().abs().max())
        allowed = BWD_REL * scale
        tol = f"{BWD_REL}*{scale:.4g}"
        if dtype == torch.bfloat16:
            allowed = allowed + BF16_STEP * want.float().abs()
            tol += "+2^-7*|ref|"
        ok = bool((err <= allowed).all())
    if not ok:
        raise RuntimeError(f"{name} {dtype}: max abs error {max_err} "
                           f"beyond {tol}")
    return max_err, tol


def rate(nbytes, ms, b_ms):
    """Achieved GB/s and the share of the bound; where the kernel ran
    under its HBM bound, the calls were served from L2: no share."""
    out = {"gbps": round(nbytes / ms / 1e6, 1)}
    if ms < b_ms:
        out["l2_served"] = True
    else:
        out["bound_share"] = round(b_ms / ms, 3)
    return out


def variant_checks(rcam, rcam4, kmat, pts, gen):
    """One level (P4: 40^2, C=64, 40^3 voxels; 2 views in the fused layout,
    4 in the per-view one) of the variants that the flagship tensors do
    not reach, against plain: the scalar forward and the direct backward
    of each layout, on features and g offset by one element from their
    allocations (not 16-byte aligned); then the reprojection's
    (`_reproject_variant_checks`)."""
    c, s = 64, LEVELS["P4"]
    for dtype in (torch.float32, torch.bfloat16):
        for name, r, v in (("unproject", rcam, 2),
                           ("unproject_view", rcam4, 4)):
            x, y = plain.project_voxel_coords(r, kmat, (640, 640), pts, s, s)
            x, y = x.contiguous(), y.contiguous()
            n = x.shape[1]
            feats = torch.randn(v * s * s * c + 1, generator=gen).to(
                DEV, dtype)[1:].view(v, s * s, c)
            g = torch.randn(v * n * c + 1, generator=gen).to(
                DEV, dtype)[1:]
            if name == "unproject":
                g = g.view(1, n, v * c)
                saved = plain.bilinear_gather_fused(feats, x, y, s, s, v,
                                                    True)
                checks = (
                    (name, "fwd_scalar",
                     lambda: unproject.gather_fused(feats, x, y, s, s, v,
                                                    True),
                     lambda: plain.bilinear_gather_fused(feats, x, y, s, s,
                                                         v, True)),
                    (name + "_bwd", "bwd_direct",
                     lambda: unproject.gather_fused_bwd(g, saved, x, y, s,
                                                        s, v, True),
                     lambda: plain.bilinear_gather_fused_bwd(
                         g, saved, x, y, s, s, v, True, dtype)))
            else:
                g = g.view(v, n, c)
                checks = (
                    (name, "fwd_scalar",
                     lambda: unproject.gather(feats, x, y, s, s),
                     lambda: plain.bilinear_gather(feats, x, y, s, s)),
                    (name + "_bwd", "bwd_direct",
                     lambda: unproject.gather_bwd(g, x, y, s, s),
                     lambda: plain.bilinear_gather_bwd(g, x, y, s, s,
                                                       dtype)))
            run_variant_checks([(v, "P4") + check for check in checks],
                               dtype)
        run_variant_checks(_reproject_variant_checks(kmat, gen, dtype),
                           dtype)


def run_variant_checks(runs, dtype):
    """Each (views, level, kernel, variant, kernel call, reference) of
    `runs`: the kernel against its reference, the variant it launched,
    and its device time; one line each."""
    for v, level, kname, expect, kern, ref in runs:
        got, variant = launched_variant(kname, kern)
        want = ref()
        torch.cuda.synchronize()
        err, tol = _check(kname, got, want, dtype)
        if variant != expect:
            raise RuntimeError(f"{kname} launched {variant}, not {expect}")
        say("kernels", kernel=kname, variant=variant, level=level, views=v,
            dtype=str(dtype).split(".")[1], max_abs_err=err, tol=tol,
            ms=round(device_ms(kern), 5))


def _reproject_variant_checks(kmat, gen, dtype):
    """The reprojection's variants that the flagship tensors do not reach,
    as (views, level, kernel, variant, kernel call, exact reference): at
    P4 (40^2 pixels, 20 samples, C=64, 40^3 grid) the scalar forward on a
    grid and the scalar backward on a g offset by one element (not
    16-byte aligned); and the vector backward on 80^2 pixels a sample, a
    P3-sized map, which a block maps in chunks of MAX_CHUNK. The
    backward's reference is the plain version on a CPU copy."""
    cfg = FlagshipConfig()
    n, c, shape = cfg.nvox, 64, (1, 40, 40, 40, 64)
    out = []
    for level, s, offset in (("P4", LEVELS["P4"], 1), ("P3", 80, 0)):
        xg, yg, iz = plain.reprojection_coords(kmat, (640, 640), s,
                                               cfg.samples, cfg, n, n, n)
        xg, yg = xg.contiguous(), yg.contiguous()
        size = cfg.samples * s * s * c
        g = torch.randn(size + offset, generator=gen).to(DEV, dtype)[
            offset:].view(1, cfg.samples, s * s, c)
        grid = torch.randn(n ** 3 * c + offset, generator=gen).to(
            DEV, dtype)[offset:].view(shape)
        variant = "scalar" if offset else "vector_chunked"
        if offset:
            out.append((1, level, "reproject", "fwd_scalar",
                        lambda grid=grid, xg=xg, yg=yg, iz=iz:
                        reproject.gather(grid, xg, yg, iz),
                        lambda grid=grid, xg=xg, yg=yg, iz=iz:
                        plain.zslice_gather(grid, xg, yg, iz)))
        out.append((1, level, "reproject_bwd", "bwd_" + variant,
                    lambda g=g, xg=xg, yg=yg, iz=iz:
                    reproject.gather_bwd(g, xg, yg, iz, shape),
                    lambda g=g, xg=xg, yg=yg, iz=iz:
                    plain.zslice_gather_bwd(g.cpu(), xg.cpu(), yg.cpu(), iz,
                                            shape, dtype)))
    return out


def measure(name, case, level, dtype, views, adds, outside, phase="kernels"):
    """Kernel `name` at one level against its plain version (the
    tolerance, the variant launched), then the device times of the
    kernel, the plain version and the library call, the host-clock call
    times and the bound; prints one line (tagged `phase`) and returns its
    numbers."""
    kern, ref, lib, nbytes, flops, *exact = case
    got, variant = launched_variant(name, kern)
    want = exact[0]() if exact else ref()
    torch.cuda.synchronize()
    err, tol = _check(name, got, want, dtype)
    # the flagship tensors take the vector forward and the walk backward
    # (the reprojection: its vector backward)
    want_variant = "fwd_vector"
    if name.endswith("_bwd"):
        want_variant = ("bwd_vector" if name.startswith("reproject")
                        else "bwd_walk")
    if variant != want_variant:
        raise RuntimeError(f"{name} launched {variant}, not {want_variant}")
    # runs of the same kernel on the same inputs: the spread that float
    # atomics leave in a backward's last bits (none in the reprojection's)
    spread = (max(float((kern().float() - got.float()).abs().max())
                  for _ in range(3)) if name.endswith("_bwd") else 0.0)
    if name == "reproject_bwd" and spread != 0.0:
        raise RuntimeError(f"{name} {dtype}: two runs differ by {spread}")
    ms, plain_ms, lib_ms = device_ms(kern), device_ms(ref), device_ms(lib)
    call_ms, plain_call_ms = median_ms(kern), median_ms(ref)
    b_ms, b_by = bound_ms(nbytes, flops)
    extra = dict(variant=variant)
    if name.startswith("unproject"):
        extra.update(adds_per_pixel_max=adds[0],
                     adds_per_pixel_mean=round(adds[1], 2))
    say(phase, kernel=name, level=level, views=views,
        dtype=str(dtype).split(".")[1], shape=list(got.shape),
        max_abs_err=err, tol=tol, run_to_run=spread,
        ms=round(ms, 5), plain_ms=round(plain_ms, 5),
        library_ms=round(lib_ms, 5), bound_ms=round(b_ms, 5),
        bound_by=b_by, mbytes=round(nbytes / 1e6, 3),
        **rate(nbytes, ms, b_ms), **extra,
        call_ms=round(call_ms, 4), plain_call_ms=round(plain_call_ms, 4),
        view2_voxels_outside=round(outside, 3))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = FlagshipConfig()
    rng = np.random.RandomState(0)
    g = torch.Generator().manual_seed(0)
    b, v, c = 1, 2, 64
    rcam = torch.from_numpy(poses(rng, b, v)).to(DEV)
    rcam4 = torch.from_numpy(poses(rng, b, 4)).to(DEV)
    kmat = torch.from_numpy(intrinsics(b, 640)).to(DEV)
    pts = torch.from_numpy(plain.voxel_grid_points(cfg)).to(DEV)
    nx = ny = cfg.nvox
    nz = cfg.nvox_z
    record = {}

    def keep(name, level, dtype, got):
        """The JSON record: the largest error over every run; P4 bf16 at
        the flagship's views (V=2 fused) as the kernel's numbers, and
        every bf16 level's times beside them."""
        rec = record.setdefault(name, {"max_abs_err": 0.0,
                                       "bf16_by_level": {}})
        rec["max_abs_err"] = max(rec["max_abs_err"], got["max_abs_err"])
        if dtype == torch.bfloat16:
            rec["bf16_by_level"][level] = {
                k: got[k] for k in ("ms", "bound_ms", "library_ms")}
            if level == "P4":
                rec.update({k: got[k] for k in ("ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")})

    for dtype in (torch.float32, torch.bfloat16):
        for level, s in LEVELS.items():
            feats = torch.randn(b * v, s * s, c, generator=g).to(DEV, dtype)
            x, y = plain.project_voxel_coords(rcam, kmat, (640, 640), pts,
                                              s, s)
            x, y = x.contiguous(), y.contiguous()
            outside = float(((x[1] < -1) | (x[1] > s) | (y[1] < -1)
                             | (y[1] > s)).float().mean())
            feats4 = torch.randn(b * 4, s * s, c, generator=g).to(DEV, dtype)
            x4, y4 = plain.project_voxel_coords(rcam4, kmat, (640, 640), pts,
                                                s, s)
            x4, y4 = x4.contiguous(), y4.contiguous()
            grid = torch.randn(b, nx, ny, nz, c, generator=g).to(DEV, dtype)
            xg, yg, iz = plain.reprojection_coords(kmat, (640, 640), s,
                                                   cfg.samples, cfg, nx, ny,
                                                   nz)
            xg, yg = xg.contiguous(), yg.contiguous()
            adds, adds4 = adds_per_pixel(x, y, s), adds_per_pixel(x4, y4, s)
            # (kernel, case, views, taps a pixel, record label)
            runs = [(name, case, v, adds, level) for name, case in
                    _unproject_cases(feats, x, y, s, v, dtype).items()]
            runs += [(name, case, 4, adds4, level) for name, case in
                     _unproject_view_cases(feats4, x4, y4, s, dtype).items()]
            runs += [(name, case, 1, adds, level) for name, case in
                     _reproject_cases(grid, xg, yg, iz, dtype).items()]
            if level == "P4":
                # the fused kernels at the 4-view conv3d's width too
                runs += [(name, case, 4, adds4, "P4_v4") for name, case in
                         _unproject_cases(feats4, x4, y4, s, 4,
                                          dtype).items()]
            for name, case, views, a, label in runs:
                keep(name, label, dtype,
                     measure(name, case, level, dtype, views, a, outside))
    variant_checks(rcam, rcam4, kmat, pts, g)
    trace_reproject_bwd(kmat, g)
    return record


def trace_reproject_bwd(kmat, gen):
    """One profiled call of the reprojection backward at P4 in each dtype:
    it must run as one kernel, with no memset and no cast pass."""
    cfg = FlagshipConfig()
    n = cfg.nvox
    xg, yg, iz = plain.reprojection_coords(kmat, (640, 640), LEVELS["P4"],
                                           cfg.samples, cfg, n, n, n)
    xg, yg = xg.contiguous(), yg.contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn(1, cfg.samples, xg.shape[2], 64, generator=gen).to(
            DEV, dtype)
        events = device_events(lambda: reproject.gather_bwd(
            g, xg, yg, iz, (1, n, n, n, 64)))
        say("kernels", kernel="reproject_bwd", level="P4",
            dtype=str(dtype).split(".")[1],
            device_events=json.dumps(events, separators=(",", ":")))
        if len(events) != 1 or sum(events.values()) != 1 or \
                "bwd_kernel" not in next(iter(events)):
            raise RuntimeError(f"reproject_bwd ran {events}, not one "
                               f"kernel")


def request_images(rng, n, hw, views=2):
    return [rng.randint(0, 256, (views, hw, hw, 3)).astype(np.uint8)
            for _ in range(n)]


def request_depths(rng, n, cfg):
    """Seeded depth maps [1, V, h5, w5] at P5's resolution, 1.5-8 m."""
    s5 = cfg.IMAGE_MAX_DIM // cfg.BACKBONE_STRIDES[3]
    return [rng.uniform(1.5, 8.0, (1, cfg.NUM_VIEWS, s5, s5)).astype(
        np.float32) for _ in range(n)]


def reset_counts():
    unproject.launches = unproject.bwd_launches = 0
    unproject.view_launches = unproject.view_bwd_launches = 0
    unproject.view_variants.clear()
    unproject.fused_variants.clear()
    reproject.launches = reproject.bwd_launches = 0
    reproject.variants.clear()


def read_counts():
    return {"unproject": unproject.launches,
            "unproject_bwd": unproject.bwd_launches,
            "unproject_view": unproject.view_launches,
            "unproject_view_bwd": unproject.view_bwd_launches,
            "reproject": reproject.launches,
            "reproject_bwd": reproject.bwd_launches}


def launched_variants():
    """The kernel variants launched since the counts were reset, by kernel
    family and variant."""
    got = {f"fused_{k}": n for k, n in unproject.fused_variants.items() if n}
    got.update({f"view_{k}": n for k, n in unproject.view_variants.items()
                if n})
    got.update({f"reproject_{k}": n for k, n in reproject.variants.items()
                if n})
    return got


def check_variants(tag, counts):
    """The kernel variants launched since the counts were reset: on the
    main paths every launch must be the vector forward, the walk backward
    of the unprojection or the reprojection's one-pass vector backward.
    Returns them, by kernel family and variant."""
    got = launched_variants()
    want = {k: n for k, n in (
        ("fused_fwd_vector", counts["unproject"]),
        ("fused_bwd_walk", counts["unproject_bwd"]),
        ("view_fwd_vector", counts["unproject_view"]),
        ("view_bwd_walk", counts["unproject_view_bwd"]),
        ("reproject_fwd_vector", counts["reproject"]),
        ("reproject_bwd_vector", counts["reproject_bwd"])) if n}
    if got != want:
        raise RuntimeError(f"{tag} launched the variants {got}, not {want}")
    return got


def expected(**counts):
    """A launch count for every kernel: those named, 0 for the others."""
    return {k: counts.get(k, 0) for k in KERNELS}


def run_requests(tag, cfg, per_request, probe=None):
    """The engine's detect at `cfg` with seeded weights: one warm-up
    request (every raw output must be finite), 3 counted requests, then
    the same 3 once more, timed part by part on the host clock, and one
    more under torch.profiler, for its host synchronisations. `probe`,
    if given, is called with the engine and a call of run_model on a
    request. `per_request` is the launch count each kernel must reach per
    request. Returns the counts of the counted run."""
    t = time.perf_counter()
    eng = MaskRCNN("inference", cfg, "build")
    eng.init_weights(torch.Generator().manual_seed(0))
    setup_s = time.perf_counter() - t
    rng = np.random.RandomState(1)
    reqs = request_images(rng, 4, cfg.IMAGE_MAX_DIM, cfg.NUM_VIEWS)
    rcams = [poses(rng, 1, cfg.NUM_VIEWS) for _ in reqs]
    depths = (request_depths(rng, len(reqs), cfg) if cfg.TRANSFORMER
              else [None] * len(reqs))
    kmat = intrinsics(1, cfg.IMAGE_MAX_DIM)

    outs, _, _ = eng.run_model([reqs[0]], rcams[0], kmat, depths[0])
    torch.cuda.synchronize()
    for k, t_ in outs.items():
        if not torch.isfinite(t_.float()).all():
            raise RuntimeError(f"{tag} output {k} is not finite")
    say(tag, warmup="ok", setup_s=round(setup_s, 3),
        outputs={k: list(t_.shape) for k, t_ in outs.items()})

    reset_counts()
    lat = []
    for img, rcam, dep in zip(reqs[1:], rcams[1:], depths[1:]):
        t = time.perf_counter()
        r = eng.detect([img], rcam, kmat, dep)[0]
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        n = len(r["class_ids"])
        if not (np.isfinite(r["scores"]).all() and r["masks"].shape
                == img.shape[1:3] + (n,) and r["rois"].shape == (n, 4)):
            raise RuntimeError(f"{tag} produced malformed detections")
        say(tag, detections=n, rois=list(r["rois"].shape),
            masks=list(r["masks"].shape),
            classes=sorted(set(int(c) for c in r["class_ids"])),
            latency_ms=round(lat[-1], 3))
    launches = read_counts()
    expect = expected(**{k: n * len(lat) for k, n in per_request.items()})
    say(tag, calls=len(lat), launches=launches, expected=expect,
        variants=check_variants(tag, launches),
        latency_ms_median=round(statistics.median(lat), 3))
    if launches != expect:
        raise RuntimeError(f"{tag} kernel launches {launches} != {expect}")

    # host-clock breakdown of the same requests, unprofiled, after the
    # counted run: detect() is run_model (molding included), the copy of
    # its outputs to the host, and unmolding
    for img, rcam, dep in zip(reqs[1:], rcams[1:], depths[1:]):
        t0 = time.perf_counter()
        eng.mold_inputs(list(img))
        t1 = time.perf_counter()
        outs, shape, windows = eng.run_model([img], rcam, kmat, dep)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        det = outs["detections"].float().cpu().numpy()
        masks = outs["mrcnn_masks"].float().cpu().numpy()
        t3 = time.perf_counter()
        eng.unmold_detections(det[0], masks[0], img.shape[1:], shape,
                              windows[0])
        t4 = time.perf_counter()
        say(tag, breakdown_ms=json.dumps({
            "mold": round((t1 - t0) * 1e3, 3),
            "run_model_incl_mold": round((t2 - t1) * 1e3, 3),
            "copy_out": round((t3 - t2) * 1e3, 3),
            "unmold": round((t4 - t3) * 1e3, 3),
            "request": round((t4 - t1) * 1e3, 3)}, separators=(",", ":")))
    img, rcam, dep = reqs[1], rcams[1], depths[1]
    syncs = host_syncs(lambda: eng.detect([img], rcam, kmat, dep))
    say(tag, host_syncs_per_request=sum(syncs.values()),
        host_syncs=json.dumps(syncs, separators=(",", ":")))
    if probe is not None:
        probe(eng, lambda: eng.run_model([img], rcam, kmat, dep))
    return launches


def phase_main():
    return run_requests("main", FlagshipConfig(),
                        {"unproject": 3, "reproject": 3},
                        probe=layout_copies)


def layout_copies(eng, forward):
    """The device time of the layout copies on either side of the
    reprojection at each level, on the tensors of one forward: the fused
    grid [B, C, X, Y, Z] (the U-Net's output, in its memory format) made
    [B, X, Y, Z, C] contiguous for the kernel, and its gradient made the
    U-Net's format again; the rays [B, D, S, S, C] permuted and reshaped
    to [B, C*D, S, S] by DepthCollapse, and its gradient made [B, D, S, S,
    C] contiguous for the backward kernel. A copy that is a view costs
    nothing (copy=False)."""
    taken, hooks = {}, []
    for lvl in (4, 5, 6):
        hooks.append(getattr(eng.model, f"grid_fusion_p{lvl}")
                     .register_forward_hook(
                         lambda m, a, out, lvl=lvl: taken.__setitem__(
                             ("fused", lvl), out.detach())))
        hooks.append(getattr(eng.model, f"depth_collapse_p{lvl}")
                     .register_forward_hook(
                         lambda m, a, out, lvl=lvl: taken.__setitem__(
                             ("rays", lvl), a[0].detach())))
    forward()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    for lvl in (4, 5, 6):
        fused, rays = taken[("fused", lvl)], taken[("rays", lvl)]
        b, c, x, y, z = fused.shape
        fmt = (torch.channels_last_3d if fused.is_contiguous(
            memory_format=torch.channels_last_3d) else torch.contiguous_format)
        d, s1, s2 = rays.shape[1:4]
        dgrid = torch.randn(b, x, y, z, c, device=DEV).to(fused.dtype)
        drays = torch.randn(b, c * d, s1, s2, device=DEV).to(rays.dtype)
        copies = {
            "grid_fwd": lambda: fused.permute(0, 2, 3, 4, 1).contiguous(),
            "grid_bwd": lambda: dgrid.permute(0, 4, 1, 2, 3).contiguous(
                memory_format=fmt),
            "collapse_fwd": lambda: rays.permute(0, 4, 1, 2, 3).reshape(
                b, c * d, s1, s2),
            "collapse_bwd": lambda: drays.reshape(b, c, d, s1, s2).permute(
                0, 2, 3, 4, 1).contiguous()}
        sources = {"grid_fwd": fused, "grid_bwd": dgrid,
                   "collapse_fwd": rays, "collapse_bwd": drays}
        say("layouts", level=f"P{lvl}", fused_format=str(fmt).split(".")[1],
            **{k: json.dumps({
                "ms": round(device_ms(fn), 5),
                "copy": fn().data_ptr() != sources[k].data_ptr(),
                "mbytes": round(sources[k].numel()
                                * sources[k].element_size() / 1e6, 3)},
                separators=(",", ":")) for k, fn in copies.items()})


def time_steps(tag, eng, ds, cfg):
    """Step time after warm-up (host clock around train_step, which ends
    in a copy of the losses to the host), then one profiled step for the
    device's share."""
    model = eng.model
    mask = trainable_mask(model, "all")
    opt = make_optimizer([p for n, p in model.named_parameters()
                          if mask[n]], cfg.LEARNING_RATE,
                         cfg.LEARNING_MOMENTUM)
    batch = eng.to_device(make_batch(ds, cfg, rnd_state=99,
                                     with_depth=bool(cfg.TRANSFORMER)))
    gen = torch.Generator(DEV).manual_seed(1)

    def step():
        return train_step(model, opt, batch, cfg, mask, gen)

    step()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    reset_counts()
    busy_ms, device_events = device_profile(step)
    per_step = read_counts()
    step_ms = statistics.median(times)
    say(tag, step_ms=[round(t_, 3) for t_ in times],
        step_ms_median=round(step_ms, 3),
        device_busy_ms=busy_ms and round(busy_ms, 3),
        device_idle_share=busy_ms and round(1 - busy_ms / step_ms, 4),
        device_events_per_step=device_events,
        kernel_launches_per_step=per_step,
        peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))


def check_trained(losses, model):
    for ep, means in losses.items():
        if not all(np.isfinite(v) for v in means.values()):
            raise RuntimeError(f"epoch {ep} losses not finite: {means}")
    bad = [n for n, p in model.named_parameters() if p.dtype != torch.float32]
    if bad:
        raise RuntimeError(f"parameters not float32: {bad[:5]}")


def phase_train():
    cfg = FlagshipTrainConfig()
    ds = SyntheticMultiViewDataset(num_scenes=4, num_views=2, image_size=640,
                                   num_classes=cfg.NUM_CLASSES, seed=0)
    val = SyntheticMultiViewDataset(num_scenes=1, num_views=2,
                                    image_size=640,
                                    num_classes=cfg.NUM_CLASSES, seed=1)
    losses = {}                     # epoch -> the epoch's mean losses
    keep = losses.__setitem__
    with tempfile.TemporaryDirectory(dir="build") as model_dir:
        eng = MaskRCNN("training", cfg, model_dir)
        reset_counts()
        t = time.perf_counter()
        eng.train(ds, None, cfg.LEARNING_RATE, 1, "all",
                  custom_callbacks=[keep], prefetch_threads=2)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t
        launches = read_counts()
        n = 3 * cfg.STEPS_PER_EPOCH
        expect = expected(unproject=n, unproject_bwd=n, reproject=n,
                          reproject_bwd=n)
        say("train", epoch=1, steps=cfg.STEPS_PER_EPOCH, launches=launches,
            expected=expect, variants=check_variants("train", launches),
            seconds=round(epoch_s, 3),
            losses=json.dumps(losses[1], separators=(",", ":")))
        if launches != expect:
            raise RuntimeError(f"train launches {launches} != {expect}")

        # resume: a new engine loads the checkpoint (its epoch count
        # included) and trains to epoch 2, with a validation step
        ckpt = eng.find_last()
        eng2 = MaskRCNN("training", cfg, model_dir)
        eng2.load_weights(ckpt)
        if eng2.epoch != 1:
            raise RuntimeError(f"resumed at epoch {eng2.epoch}, not 1")
        for (n1, p1), (_, p2) in zip(eng.model.named_parameters(),
                                     eng2.model.named_parameters()):
            if not torch.equal(p1, p2):
                raise RuntimeError(f"checkpoint lost {n1}")
        reset_counts()
        eng2.train(ds, val, cfg.LEARNING_RATE, 2, "all",
                   custom_callbacks=[keep], prefetch_threads=2)
        torch.cuda.synchronize()
        resumed = read_counts()
        say("train", epoch=2, resumed_from=ckpt.split(model_dir)[-1],
            launches=resumed, variants=check_variants("train", resumed),
            losses=json.dumps(losses[2], separators=(",", ":")))
        want = expected(unproject=3 * (cfg.STEPS_PER_EPOCH + 1),
                        reproject=3 * (cfg.STEPS_PER_EPOCH + 1),
                        unproject_bwd=n, reproject_bwd=n)
        if resumed != want:
            raise RuntimeError(f"resumed launches {resumed} != {want}")
        check_trained(losses, eng2.model)
        time_steps("train", eng2, ds, cfg)
    return launches


def run_training(tag, cfg, per_step):
    """compat.MaskRCNN("training").train for one epoch of
    cfg.STEPS_PER_EPOCH steps on a seeded 640^2 synthetic dataset with
    cfg.NUM_VIEWS views; each kernel must launch per_step[k] times a
    step. Then the step time and a profiled step. Returns the counts."""
    ds = SyntheticMultiViewDataset(num_scenes=4, num_views=cfg.NUM_VIEWS,
                                   image_size=cfg.IMAGE_MAX_DIM,
                                   num_classes=cfg.NUM_CLASSES, seed=0)
    losses = {}
    with tempfile.TemporaryDirectory(dir="build") as model_dir:
        eng = MaskRCNN("training", cfg, model_dir)
        reset_counts()
        t = time.perf_counter()
        eng.train(ds, None, cfg.LEARNING_RATE, 1, "all",
                  custom_callbacks=[losses.__setitem__], prefetch_threads=2)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t
        launches = read_counts()
        expect = expected(**{k: n * cfg.STEPS_PER_EPOCH
                             for k, n in per_step.items()})
        say(tag, epoch=1, steps=cfg.STEPS_PER_EPOCH, launches=launches,
            expected=expect, variants=check_variants(tag, launches),
            seconds=round(epoch_s, 3),
            losses=json.dumps(losses[1], separators=(",", ":")))
        if launches != expect:
            raise RuntimeError(f"{tag} launches {launches} != {expect}")
        check_trained(losses, eng.model)
        time_steps(tag, eng, ds, cfg)
    return launches


def phase_lstm_main():
    return run_requests("lstm3d_main", Lstm4Config(),
                        {"unproject_view": 3, "reproject": 3})


def phase_lstm_train():
    return run_training("lstm3d_train", Lstm4TrainConfig(),
                        {"unproject_view": 3, "unproject_view_bwd": 3,
                         "reproject": 3, "reproject_bwd": 3})


def phase_xformer():
    """3 detect requests and 3 training steps; the transformer path runs
    no geometry kernel."""
    return (run_requests("xformer_main", XformerConfig(), {}),
            run_training("xformer_train", XformerTrainConfig(), {}))


def _step_clock(times):
    """Wrap the engine's train_step to append each step's host time in ms
    (the step ends in a copy of its losses to the host); returns the
    original, to put back."""
    original = engine.train_step

    def timed_step(*args, **kwargs):
        t = time.perf_counter()
        out = original(*args, **kwargs)
        times.append((time.perf_counter() - t) * 1e3)
        return out
    engine.train_step = timed_step
    return original


def _epoch_records(log_dir, after):
    """(metrics.jsonl steps, tfevents steps) of `log_dir` past epoch
    `after`, each loss finite."""
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    events = []
    for path in sorted(glob.glob(os.path.join(log_dir, "events.out.*"))):
        events += read_tb_events(path)
    for rec in recs:
        if not all(np.isfinite(v) for k, v in rec.items() if "loss" in k):
            raise RuntimeError(f"cli: a logged loss is not finite: {rec}")
    for _, scalars in events:
        if not all(np.isfinite(v) for v in scalars.values()):
            raise RuntimeError(f"cli: an event is not finite: {scalars}")
    return ([r["step"] for r in recs if r["step"] > after],
            [s for s, _ in events if s > after])


def _cli(argv, log):
    """cli.main(argv) in this process, its standard output appended to
    `log`; returns (its result, that output)."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            result = cli.main(argv)
    finally:
        log.write(out.getvalue())
    return result, out.getvalue()


def phase_cli():
    """The InteriorNet command line at 640²: export a tree, train in a
    subprocess and SIGKILL it after epoch 1's checkpoint, resume in this
    process to epoch 3, evaluate 2 keys, draw 2 keys (`visualize`).
    Returns the launch counts of the resumed training, the evaluation
    and the drawing."""
    steps, val_steps, epochs, image_size = 2, 1, 3, 640
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        t = time.perf_counter()
        export_subset(work, "train", 3, seed=21, image_size=image_size,
                      num_views=8)
        export_subset(work, "val", 2, seed=521, image_size=image_size,
                      num_views=8)
        export_s = time.perf_counter() - t
        common = ["--dataset", os.path.join(work, "HD7"), "--logs",
                  os.path.join(work, "logs"), "--device", "cuda",
                  "--overrides",
                  f"STEPS_PER_EPOCH={steps},VALIDATION_STEPS={val_steps}"]
        train = ["train", *common, "--epochs", f"1,2,{epochs}",
                 "--save-every", "1"]
        log = open(os.path.join(work, "cli.log"), "w")
        first = os.path.join(work, "logs", "*", "checkpoints", "1",
                             "state.pt")
        try:
            t = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "mulit_view_object_detection_torch.cli.interior_multi",
                 *train], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=ROOT))
            try:
                while not glob.glob(first):
                    if proc.poll() is not None:
                        raise RuntimeError(
                            f"cli: the training subprocess exited with "
                            f"{proc.returncode} before epoch 1's checkpoint")
                    if time.perf_counter() - t > 600:
                        raise RuntimeError("cli: no epoch-1 checkpoint in "
                                           "600 s")
                    time.sleep(0.1)
                first_ckpt_s = time.perf_counter() - t
            finally:
                proc.kill()                                # SIGKILL
                proc.wait()
            killed = max(int(p.split(os.sep)[-2]) for p in glob.glob(
                os.path.join(work, "logs", "*", "checkpoints", "*",
                             "state.pt")))

            step_ms = []
            original = _step_clock(step_ms)
            reset_counts()
            try:
                eng, out = _cli([*train, "--model", "last"], log)
            finally:
                engine.train_step = original
            train_launches = read_counts()
            ran = list(range(killed + 1, epochs + 1))
            logged = _epoch_records(eng.log_dir, killed)
            if eng.epoch != epochs or logged != (ran, ran):
                raise RuntimeError(
                    f"cli: resumed from epoch {killed} to {eng.epoch}, "
                    f"logged (jsonl, tfevents) {logged}, not {ran}")
            if "epoch 1:" in out or len(step_ms) != steps * len(ran):
                raise RuntimeError(
                    f"cli: the resume ran a finished stage ({len(step_ms)} "
                    f"steps for epochs {ran})")
            bad = [n for n, p in eng.model.named_parameters()
                   if p.device.type != "cuda"]
            if bad:
                raise RuntimeError(f"cli: parameters off the card: {bad[:3]}")
            n = 3 * len(ran)
            want = expected(unproject=n * (steps + val_steps),
                            reproject=n * (steps + val_steps),
                            unproject_bwd=n * steps, reproject_bwd=n * steps)
            variants = check_variants("cli_train", train_launches)
            if train_launches != want:
                raise RuntimeError(
                    f"cli train launches {train_launches} != {want}")
            del eng

            reset_counts()
            t = time.perf_counter()
            mean_ap, out = _cli(["evaluate", *common, "--model", "last",
                                 "--limit", "2"], log)
            torch.cuda.synchronize()
            evaluate_s = time.perf_counter() - t
            eval_launches = read_counts()
            key_ms = [float(m) for m in re.findall(r" ms=([0-9.]+)", out)]
            printed = re.findall(r"^mAP@50: ([0-9.naif]+)$", out, re.M)
            if (len(key_ms) != 2 or printed != [f"{mean_ap:.4f}"]
                    or not 0.0 <= mean_ap <= 1.0):
                raise RuntimeError(f"cli evaluate printed {printed}, keys "
                                   f"{key_ms}, mAP {mean_ap}")
            want_eval = expected(unproject=3 * 2, reproject=3 * 2)
            check_variants("cli_evaluate", eval_launches)
            if eval_launches != want_eval:
                raise RuntimeError(
                    f"cli evaluate launches {eval_launches} != {want_eval}")

            results = os.path.join(work, "Results")
            reset_counts()
            t = time.perf_counter()
            written, _ = _cli(["visualize", *common, "--model", "last",
                               "--limit", "2", "--results", results], log)
            torch.cuda.synchronize()
            visualize_s = time.perf_counter() - t
            vis_launches = read_counts()
            keys = list(cli.load_dataset(os.path.join(work, "HD7"),
                                         "val").view_map)[:2]
            want_paths = [os.path.join(results, "NV2", f"{k}.jpg")
                          for k in keys]
            shapes = [getattr(cv2.imread(p), "shape", None)
                      for p in want_paths]
            if written != want_paths or shapes != [(image_size,
                                                    image_size, 3)] * 2:
                raise RuntimeError(f"cli visualize wrote {written} "
                                   f"({shapes}), not {want_paths}")
            check_variants("cli_visualize", vis_launches)
            if vis_launches != want_eval:
                raise RuntimeError(
                    f"cli visualize launches {vis_launches} != {want_eval}")
            vis_bytes = [os.path.getsize(p) for p in written]
        except Exception:
            log.flush()
            with open(log.name) as f:
                print(f.read()[-6000:], flush=True)
            raise
        finally:
            log.close()
    print(json.dumps({
        "phase": "cli", "image_size": image_size,
        "export_s": round(export_s, 3),
        "subprocess_first_checkpoint_s": round(first_ckpt_s, 3),
        "killed_after_epoch": killed, "resumed_epochs": ran,
        "train_step_ms": [round(x, 3) for x in step_ms],
        "train_step_ms_median": round(statistics.median(step_ms), 3),
        "evaluate_ms_per_key": key_ms, "evaluate_s": round(evaluate_s, 3),
        "mAP@50": mean_ap, "train_launches": train_launches,
        "train_variants": variants, "evaluate_launches": eval_launches,
        "visualize_s": round(visualize_s, 3), "visualize_bytes": vis_bytes,
        "visualize_launches": vis_launches}), flush=True)
    return train_launches, eval_launches, vis_launches


def _iou(a, b):
    lo = np.maximum(a[:2], b[:2])
    hi = np.minimum(a[2:], b[2:])
    inter = float(np.prod(np.clip(hi - lo, 0, None)))
    union = (float(np.prod(a[2:] - a[:2])) + float(np.prod(b[2:] - b[:2]))
             - inter)
    return inter / union if union > 0 else 0.0


PARITY_CONFIGS = (Flagship256, with_fusion(Flagship256, "add"),
                  with_fusion(Flagship256, "mean"),
                  with_fusion(Flagship256, "ident"),
                  with_fusion(Flagship256, "lstm3d"), Xformer640F32)


def phase_parity(cfg):
    """CPU plain versions vs GPU kernels at `cfg` (float32), TF32 off:
    the bar of tests/test_fullgraph_parity.py (counts within one; each
    reference detection matched by class and box IoU >= 0.9 with score
    within 0.02 and mask IoU > 0.85, at most one unmatched)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(2)
    hw = cfg.IMAGE_MAX_DIM
    img = request_images(rng, 1, hw, cfg.NUM_VIEWS)[0]
    rcam, kmat = poses(rng, 1, cfg.NUM_VIEWS), intrinsics(1, hw)
    depths = request_depths(rng, 1, cfg)[0] if cfg.TRANSFORMER else None
    ref, got = [
        MaskRCNN("inference", cfg, "build", device=dev)
        .init_weights(torch.Generator().manual_seed(3))
        .detect([img], rcam, kmat, depths)[0]
        for dev in ("cpu", "cuda")]
    n_ref, n_got, matched, worst_score, worst_mask = match_detections(
        ref, got)
    say("parity", config=cfg.NAME, cpu_detections=n_ref,
        gpu_detections=n_got, matched=matched, max_score_diff=worst_score,
        min_mask_iou=round(float(worst_mask), 4))
    check_parity(cfg.NAME, n_ref, n_got, matched, worst_score, worst_mask)


def match_detections(ref, got):
    """(reference count, count, matched, largest score difference,
    smallest mask IoU): each reference detection matched greedily to the
    unused detection of its class with the largest box IoU, if >= 0.9."""
    n_ref, n_got = len(ref["class_ids"]), len(got["class_ids"])
    used, matched, worst_score, worst_mask = set(), 0, 0.0, 1.0
    for i in range(n_ref):
        best, best_iou = None, 0.0
        for j in range(n_got):
            if j in used or got["class_ids"][j] != ref["class_ids"][i]:
                continue
            iou = _iou(ref["rois"][i].astype(np.float64),
                       got["rois"][j].astype(np.float64))
            if iou > best_iou:
                best, best_iou = j, iou
        if best is None or best_iou < 0.9:
            continue
        used.add(best)
        matched += 1
        worst_score = max(worst_score, abs(float(ref["scores"][i])
                                           - float(got["scores"][best])))
        a, b = ref["masks"][..., i], got["masks"][..., best]
        union = np.logical_or(a, b).sum()
        if union:
            worst_mask = min(worst_mask,
                             np.logical_and(a, b).sum() / union)
    return n_ref, n_got, matched, worst_score, worst_mask


def check_parity(tag, n_ref, n_got, matched, worst_score, worst_mask):
    """The bar of tests/test_fullgraph_parity.py on match_detections'
    numbers; a reference with no detection compares nothing: an error."""
    if n_ref == 0:
        raise RuntimeError(f"{tag} parity run produced no detections to "
                           f"compare")
    if (abs(n_ref - n_got) > 1 or matched < n_ref - 1
            or worst_score >= 0.02 or worst_mask <= 0.85):
        raise RuntimeError(f"{tag}: CPU and GPU detections disagree")


def _grad_errs(ref, got, floor):
    """Per tensor: max |got - ref| over max(max |ref|, floor)."""
    return {n: float((got[n] - r).abs().max()) / max(float(r.abs().max()),
                                                      floor)
            for n, r in ref.items()}


def _pin(out, ref):
    """`out` with `ref`'s value where their signs differ; the gradient
    passes to `out` everywhere."""
    ref = ref.to(out.device)
    return out + ((ref - out) * ((ref > 0) != (out > 0))).detach()


def phase_train_parity(cfg, kernels, stage="all", pin_flips=False):
    """One train step's losses and gradients at `cfg` and trainable
    `stage`, CPU plain versions vs GPU kernels, in float32 with TF32 off,
    same weights, batch and ROI sampling priorities; the GPU step twice,
    for its own spread; each of `kernels` launched 3 times (P4, P5, P6) in
    the GPU step. Also counts the backbone ReLU inputs (bn2a, bn2b
    outputs) whose sign differs between the CPU and the GPU forward. With
    `pin_flips`, the GPU steps take the CPU's value at those inputs (a
    change under 3e-5 that leaves the gradient's path as it is), so both
    devices run the same ReLU masks and the flips' share of the
    difference is taken out of it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = SyntheticMultiViewDataset(num_scenes=2, num_views=2, image_size=256,
                                   num_classes=cfg.NUM_CLASSES, seed=2)
    host = make_batch(ds, cfg, rnd_state=0)
    runs, cpu_out = [], {}
    with tempfile.TemporaryDirectory(dir="build") as model_dir:
        for dev in ("cpu", "cuda", "cuda"):
            eng = MaskRCNN("training", cfg, model_dir, device=dev)
            eng.init_weights(torch.Generator().manual_seed(3))
            batch = draw_priorities(eng.to_device(host), cfg,
                                    torch.Generator().manual_seed(0))
            signs = {}
            for name, mod in eng.model.backbone.named_modules():
                if name.endswith((".bn2a", ".bn2b")):
                    mod.register_forward_hook(
                        lambda m, a, out, name=name: signs.__setitem__(
                            name, (out > 0).cpu()))
                    if dev == "cpu":
                        mod.register_forward_hook(
                            lambda m, a, out, name=name: cpu_out.__setitem__(
                                name, out.detach()))
                    elif pin_flips:
                        mod.register_forward_hook(
                            lambda m, a, out, name=name: _pin(
                                out, cpu_out[name]))
            reset_counts()
            mask = trainable_mask(eng.model, stage)
            for n, p in eng.model.named_parameters():
                p.requires_grad_(mask[n])
            _, parts = loss_and_grads(eng.model, batch, cfg, mask)
            runs.append((
                {k: v.item() for k, v in parts.items()},
                {n: p.grad.detach().float().cpu()
                 for n, p in eng.model.named_parameters()
                 if p.grad is not None},
                read_counts(), signs))
    (lc, gc, _, sc), (lg, gg, counts, sg), (_, gg2, _, _) = runs
    if set(gc) != set(gg):
        raise RuntimeError("CPU and GPU steps reached different parameters")
    loss_err = max(abs(lc[k] - lg[k]) / max(abs(lc[k]), 1e-6) for k in lc)
    floor = 1e-6 * max(float(t.abs().max()) for t in gc.values())
    errs = _grad_errs(gc, gg, floor)
    repeat = max(_grad_errs(gg, gg2, floor).values())
    flips = {n: int((sc[n] != sg[n]).sum()) for n in sc}
    worst_name = max(errs, key=errs.get)
    beyond = sorted(n for n, e in errs.items() if e > GRAD_TOL)
    say("train_parity", config=cfg.NAME, stage=stage, pin_flips=pin_flips,
        losses_cpu=json.dumps(lc, separators=(",", ":")),
        losses_gpu=json.dumps(lg, separators=(",", ":")),
        max_loss_rel_err=loss_err, max_grad_err=errs[worst_name],
        worst_tensor=worst_name, tensors=len(gc),
        beyond_1e_3=json.dumps({n: round(errs[n], 6) for n in beyond}),
        relu_flips=json.dumps({n: k for n, k in flips.items() if k}),
        gpu_repeat_max_grad_err=repeat, gpu_launches=counts)
    want = expected(**{k: 3 for k in kernels})
    if counts != want:
        raise RuntimeError(f"GPU step launched {counts}, not {want}")
    if not (loss_err <= 1e-4 and errs[worst_name] <= GRAD_FLIP_TOL
            and len(beyond) <= GRAD_FLIP_SHARE * len(errs)):
        raise RuntimeError(f"{cfg.NAME}: CPU and GPU train steps disagree")


# ---------------------------------------------------------------------------
# phase 12: serving
# ---------------------------------------------------------------------------

SERVE_BATCH = 4
SERVE_SIZE = 640          # the flagship serving image
SERVE_REQUESTS = 32       # each serve_bench run
HTTP_REQUESTS = 16        # from 4 client threads
DTOD = "Memcpy DtoD (Device -> Device)"
FOLD_NOISE = 1.5          # serve_fold_check's bar, in units of bf16 rounding


class Serve256(Flagship256):
    """The parity phase's 256^2 float32 model served: BatchNorms folded,
    uint8 images de-molded on the card, batches of 4."""
    NAME = "serve_256"
    FOLD_BN = True
    UINT8_IMAGE_TRANSFER = True
    IMAGES_PER_GPU = SERVE_BATCH


def serve_config():
    """cli/serve_bench.py's config (the flagship at bfloat16 with FOLD_BN,
    batch 4) with the uint8 image transfer on and detections kept at any
    confidence (random weights score below the tool's 0.7)."""
    cfg = serve_bench.build_config(SERVE_BATCH, SERVE_SIZE)
    cfg.UINT8_IMAGE_TRANSFER = True
    cfg.DETECTION_MIN_CONFIDENCE = 0.0
    return cfg


def serve_kernels(record):
    """The two forwards of the serving path at B = 4 and each level the
    path gives them (P4, P5, P6): the fused unprojection (2 views) and
    the reprojection, each scene with its own poses and focal length,
    against the plain versions (phase 3's tolerance) and timed as phase 3
    times them; the bfloat16 numbers join the kernels' record as
    "bf16_b4_p4", "bf16_b4_p5" and "bf16_b4_p6"."""
    cfg = FlagshipConfig()
    b, v, c, n = SERVE_BATCH, 2, 64, cfg.nvox
    rng = np.random.RandomState(4)
    gen = torch.Generator().manual_seed(4)
    rcam = torch.from_numpy(poses(rng, b, v)).to(DEV)
    kmat = intrinsics(b, 640)
    kmat[:, 0, 0] *= 1 + 0.05 * np.arange(b)
    kmat[:, 1, 1] = kmat[:, 0, 0]
    kmat = torch.from_numpy(kmat).to(DEV)
    pts = torch.from_numpy(plain.voxel_grid_points(cfg)).to(DEV)
    out = {}
    for level, s in LEVELS.items():
        x, y = plain.project_voxel_coords(rcam, kmat, (640, 640), pts, s, s)
        x, y = x.contiguous(), y.contiguous()
        xg, yg, iz = plain.reprojection_coords(kmat, (640, 640), s,
                                               cfg.samples, cfg, n, n, n)
        xg, yg = xg.contiguous(), yg.contiguous()
        outside = float(((x[1::2] < -1) | (x[1::2] > s) | (y[1::2] < -1)
                         | (y[1::2] > s)).float().mean())
        adds = adds_per_pixel(x, y, s)
        for dtype in (torch.float32, torch.bfloat16):
            feats = torch.randn(b * v, s * s, c, generator=gen).to(DEV, dtype)
            grid = torch.randn(b, n, n, n, c, generator=gen).to(DEV, dtype)
            cases = (
                ("unproject", _unproject_cases(feats, x, y, s, v, dtype), v),
                ("reproject", _reproject_cases(grid, xg, yg, iz, dtype), 1))
            for name, case, views in cases:
                got = measure(name, case[name], level, dtype, views, adds,
                              outside, phase="serve")
                dt = str(dtype).split(".")[1]
                out[f"{name}_{dt}_{level}"] = {k: got[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "library_ms")}
                if dtype == torch.bfloat16:
                    record[name][f"bf16_b4_{level.lower()}"] = {
                        k: got[k] for k in ("ms", "bound_ms", "library_ms")}
    return out


def mildly_randomise_bns(model, seed):
    """Every BatchNorm's scale and variance times U(0.8, 1.25), its bias
    and mean plus N(0, 0.05^2), in place: folding then changes every
    conv (with identity statistics it only divides by sqrt(1 + eps))."""
    sd = model.state_dict()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in sorted(bn_module_names(sd)):
            for leaf, spread in (("weight", 0), ("running_var", 0),
                                 ("bias", 1), ("running_mean", 1)):
                t = sd[f"{bn}.{leaf}"]
                draw = (torch.randn(t.shape, generator=gen) * 0.05
                        if spread else
                        0.8 + 0.45 * torch.rand(t.shape, generator=gen))
                (t.add_ if spread else t.mul_)(draw.to(t.device))
    return sd


def serve_parity():
    """The fold and the batching in float32 (TF32 off): 4 different
    scenes through the MicroBatcher to a GPU engine at Serve256 (folded,
    uint8 transfer, one batch of 4) against a batch-1, unfolded,
    float-molded CPU engine with the same weights, scene by scene, at
    the parity phase's bar."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_eng = MaskRCNN("inference", Flagship256(), "build", device="cpu")
    ref_eng.init_weights(torch.Generator().manual_seed(3))
    weights = mildly_randomise_bns(ref_eng.model, seed=6)
    eng = MaskRCNN("inference", Serve256(), "build")
    eng.model.load_state_dict(weights)
    rng = np.random.RandomState(5)
    hw = Serve256.IMAGE_MAX_DIM
    scenes = request_images(rng, SERVE_BATCH, hw)
    rcams = [poses(rng, 1, 2) for _ in scenes]
    kmat = intrinsics(1, hw)
    with MicroBatcher(eng, batch_size=SERVE_BATCH,
                      max_delay_ms=1000) as mb:
        futures = [mb.submit(img, Rcam=r, Kmat=kmat)
                   for img, r in zip(scenes, rcams)]
        got = [f.result(timeout=600) for f in futures]
        batches = mb.stats()["batches"]
    if batches != 1:
        raise RuntimeError(f"4 scenes took {batches} batches, not 1")
    rows = []
    for img, rcam, g in zip(scenes, rcams, got):
        nums = match_detections(ref_eng.detect([img], rcam, kmat)[0], g)
        check_parity(Serve256.NAME, *nums)
        rows.append(dict(zip(("cpu_detections", "gpu_detections", "matched",
                              "max_score_diff", "min_mask_iou"), nums)))
    say("serve", step="fold_batch_parity", config=Serve256.NAME,
        batches=batches, scenes=json.dumps(rows, separators=(",", ":")))
    return rows


def _same(direct, served, tag):
    """Class ids equal, boxes and scores within 1e-5 (tests/
    test_serve.py:185-190); returns the largest box and score
    differences."""
    worst = [0.0, 0.0]
    for d, b in zip(direct, served):
        if not np.array_equal(d["class_ids"], b["class_ids"]):
            raise RuntimeError(f"{tag}: class ids differ")
        for i, k in enumerate(("rois", "scores")):
            diff = float(np.abs(np.asarray(d[k], np.float64)
                                - np.asarray(b[k], np.float64)).max(
                                    initial=0.0))
            worst[i] = max(worst[i], diff)
    if max(worst) > 1e-5:
        raise RuntimeError(f"{tag}: boxes or scores differ by {worst}")
    return worst


def http_run(eng, scenes, rcams, kmat):
    """HTTP_REQUESTS POSTs of `scenes` from 4 client threads through
    detect_remote to make_server(eng) on localhost: every request must
    resolve with 640^2 masks and finite scores, /stats count them in at
    least HTTP_REQUESTS / 4 batches and /healthz answer ok. Returns
    (wall seconds, the batcher's stats)."""
    server, batcher = make_server(eng, port=0, batch_size=SERVE_BATCH,
                                  max_delay_ms=50)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    results, errors = {}, []

    def client(first):
        try:
            for i in range(first, HTTP_REQUESTS, 4):
                results[i] = detect_remote(url, scenes[i], Rcam=rcams[i],
                                           Kmat=kmat, timeout=600)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    try:
        t = time.perf_counter()
        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=600)
        wall = time.perf_counter() - t
        with urlopen(f"{url}/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
        with urlopen(f"{url}/healthz", timeout=60) as resp:
            health = resp.read()
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=60)
    if errors or len(results) != HTTP_REQUESTS:
        raise RuntimeError(f"HTTP requests failed: {errors}")
    if stats["requests"] != HTTP_REQUESTS or stats["batches"] < \
            HTTP_REQUESTS // SERVE_BATCH or health != b"ok":
        raise RuntimeError(f"HTTP server stats {stats}, health {health!r}")
    for r in results.values():
        if r["masks"].shape[:2] != (SERVE_SIZE, SERVE_SIZE) or \
                not np.isfinite(r["scores"]).all():
            raise RuntimeError("HTTP results malformed")
    return wall, stats


def host_breakdown(eng, scenes, rcam, kmat):
    """One batch, unprofiled, on the host clock: molding, the upload (the
    device batch built and synchronised), the forward, the copy of the
    outputs to the host and unmolding; and the uint8 upload's bytes
    against float32's."""
    t0 = time.perf_counter()
    molded, metas, windows = eng._mold_batch(scenes)
    t1 = time.perf_counter()
    batch = eng._device_batch(molded, metas, rcam, kmat, None)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    outs = eng.inference_model()(batch)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    det = outs["detections"].float().cpu().numpy()
    masks = outs["mrcnn_masks"].float().cpu().numpy()
    t4 = time.perf_counter()
    for i, img in enumerate(scenes):
        eng.unmold_detections(det[i], masks[i], img.shape[1:],
                              molded.shape[2:5], windows[i])
    t5 = time.perf_counter()
    if molded.dtype != np.uint8:
        raise RuntimeError("the serving batch did not stay uint8")
    as_f32 = molded.astype(np.float32)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    torch.from_numpy(as_f32).to(DEV)
    torch.cuda.synchronize()
    f32_upload = time.perf_counter() - t6
    ms = {"mold": t1 - t0, "upload": t2 - t1, "forward": t3 - t2,
          "copy_out": t4 - t3, "unmold": t5 - t4, "batch": t5 - t0}
    return ({k: v * 1e3 for k, v in ms.items()},
            {"uint8_bytes": molded.nbytes, "float32_bytes": as_f32.nbytes,
             "float32_upload_ms": f32_upload * 1e3})


FOLD_OUTPUTS = ("fused_p2", "fused_p3", "fused_p4", "fused_p5",
                "rpn_class_logits", "rpn_bbox")
FOLD_HEADS = ("mrcnn_class_logits", "mrcnn_bbox", "mrcnn_masks")
# one conv each of the backbone, the P5 U-Net and the mask head
FOLD_MUTANTS = ("backbone.res3b.conv2a", "grid_fusion_p5.up1",
                "mask_head.mrcnn_mask_conv2")


def _fold_outputs(eng, scenes, rcam, kmat, maps, rois):
    """The engine's inference model on `scenes` (FOLD_OUTPUTS, from
    run_graph with EXPOSE_FUSED_PYRAMID), and its two heads on the
    reference's `maps` (cast to its compute dtype) and `rois`: every
    BatchNorm of the model on inputs its own forward gives it, the heads'
    on inputs equal across models. {name: float64 CPU tensor}."""
    eng.config.EXPOSE_FUSED_PYRAMID = True
    try:
        out = {k: torch.from_numpy(v).double() for k, v in
               eng.run_graph(scenes, FOLD_OUTPUTS, rcam, kmat).items()}
    finally:
        eng.config.EXPOSE_FUSED_PYRAMID = False
    model, cfg = eng.inference_model(), eng.config
    hw = tuple(int(d) for d in cfg.IMAGE_SHAPE[:2])
    fmaps = [m.to(model.compute_dtype) for m in maps]
    with torch.no_grad():
        logits, _, bbox = model.classifier_head(
            pyramid_roi_align(rois, fmaps, hw, cfg.POOL_SIZE))
        masks = model.mask_head(
            pyramid_roi_align(rois, fmaps, hw, cfg.MASK_POOL_SIZE))
    out.update({k: t.double().cpu() for k, t in zip(
        FOLD_HEADS, (logits, bbox, masks))})
    return out


def fold_reference(eng, scenes, rcam, kmat):
    """A float32, unfolded engine with `eng`'s weights (TF32 off): its
    outputs (_fold_outputs), the fused maps and proposals that every
    engine's heads are then run on, and its detections."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = serve_config()
    cfg.COMPUTE_DTYPE = "float32"
    cfg.FOLD_BN = False
    ref_eng = MaskRCNN("inference", cfg, "build")
    ref_eng.model.load_state_dict(eng.model.state_dict())
    cfg.EXPOSE_FUSED_PYRAMID = True
    graph = ref_eng.run_graph(scenes, FOLD_OUTPUTS[:4] + ("proposals",),
                              rcam, kmat)
    cfg.EXPOSE_FUSED_PYRAMID = False
    maps = [torch.from_numpy(graph[k]).to(DEV) for k in FOLD_OUTPUTS[:4]]
    rois = torch.from_numpy(graph["proposals"]).to(DEV)
    return (_fold_outputs(ref_eng, scenes, rcam, kmat, maps, rois), maps,
            rois, ref_eng.detect(scenes, rcam, kmat))


def fold_errors(eng, ref, maps, rois, scenes, rcam, kmat):
    """{name: ||out - ref|| / ||ref||} of the engine's inference model
    (folded or not, as its config says) against the float32 reference."""
    got = _fold_outputs(eng, scenes, rcam, kmat, maps, rois)
    # fused_p2 and fused_p3 are zero in conv3d (no grid at P2, P3): there
    # the error is the output's own norm
    return {k: float((got[k] - r).norm() / (r.norm() if r.any() else 1.0))
            for k, r in ref.items()}


def serve_fold_check(eng, scenes, rcam, kmat, folded_dets):
    """The served configuration's fold in bfloat16 (`folded_dets`: the
    engine's detections of `scenes`). Detections cannot tell a bfloat16
    fold from a bad one: with seeded weights the scores crowd at 1.0, and
    bfloat16 rounding alone reorders them (the matched counts printed
    here, of 100 a scene, folded against unfolded and unfolded against
    float32, say how far). So each output of FOLD_OUTPUTS and FOLD_HEADS
    is held to a float32 unfolded engine with the same weights: the
    folded bfloat16 engine's relative error may be at most FOLD_NOISE
    times the unfolded bfloat16 engine's (its rounding alone). Then
    fold_mutants shows that the bar catches one BN left unfolded.
    Returns the phase's numbers."""
    ref, maps, rois, ref_dets = fold_reference(eng, scenes, rcam, kmat)
    errs = {}
    for fold in (False, True):
        eng.config.FOLD_BN = fold
        try:
            errs[fold] = fold_errors(eng, ref, maps, rois, scenes, rcam, kmat)
            if not fold:
                unfolded_dets = eng.detect(scenes, rcam, kmat)
        finally:
            eng.config.FOLD_BN = True
    rows = {k: (errs[True][k], errs[False][k]) for k in ref}
    matched = {
        "folded_vs_unfolded": [match_detections(u, f)[2] for u, f in
                               zip(unfolded_dets, folded_dets)],
        "unfolded_vs_float32": [match_detections(r, u)[2] for r, u in
                                zip(ref_dets, unfolded_dets)]}
    say("serve", step="fold_vs_float32",
        detections_matched=json.dumps(matched, separators=(",", ":")), **{
            k: f"{f:.3e}/{u:.3e}" for k, (f, u) in rows.items()})
    bad = {k: v for k, v in rows.items() if not v[0] <= FOLD_NOISE * v[1]}
    if bad:
        raise RuntimeError(f"the bfloat16 fold's error exceeds {FOLD_NOISE}x "
                           f"bfloat16's own (folded, unfolded): {bad}")
    return {"errors": rows, "detections_matched": matched,
            "mutants": fold_mutants(eng, ref, maps, rois, scenes, rcam,
                                    kmat, rows)}


def fold_mutants(eng, ref, maps, rois, scenes, rcam, kmat, rows):
    """serve_fold_check's power: for each conv of FOLD_MUTANTS, the folded
    copy with that conv's unfolded weight and bias put back (its BN's
    fold undone, the BN still the identity) must fail the bar. The copy
    is restored after each. Returns {conv: the largest ratio of its error
    to the unfolded bfloat16 error over the outputs}."""
    fsd, sd = eng.inference_model().state_dict(), eng.model.state_dict()
    out = {}
    for conv in FOLD_MUTANTS:
        keys = (f"{conv}.weight", f"{conv}.bias")
        kept = [fsd[k].clone() for k in keys]
        with torch.no_grad():
            for k in keys:
                fsd[k].copy_(sd[k])
        try:
            errs = fold_errors(eng, ref, maps, rois, scenes, rcam, kmat)
        finally:
            with torch.no_grad():
                for k, t in zip(keys, kept):
                    fsd[k].copy_(t)
        out[conv] = max(errs[k] / rows[k][1] for k in errs if rows[k][1])
    say("serve", step="fold_mutants", **out)
    missed = [c for c, r in out.items() if not r > FOLD_NOISE]
    if missed:
        raise RuntimeError(f"the fold check passes a fold undone at {missed}")
    return out


def serve_flagship():
    """The flagship served at 640^2, bfloat16, batch 4, folded, uint8
    transfer: the batcher against a direct detect, the HTTP run (the
    path's launch counts), the device events the fold removes, the
    serve_bench throughput at batch 1 and 4, one batch's host breakdown
    and the peak device memory. Returns (the HTTP run's launches, the
    phase's numbers)."""
    cfg = serve_config()
    t = time.perf_counter()
    eng = MaskRCNN("inference", cfg, "build")
    eng.init_weights(torch.Generator().manual_seed(0))
    mildly_randomise_bns(eng.model, seed=8)
    rng = np.random.RandomState(7)
    scenes = request_images(rng, HTTP_REQUESTS, SERVE_SIZE)
    rcams = [poses(rng, 1, 2) for _ in scenes]
    kmat = intrinsics(1, SERVE_SIZE)
    first = scenes[:SERVE_BATCH]
    rc4 = np.concatenate(rcams[:SERVE_BATCH])
    k4 = np.concatenate([kmat] * SERVE_BATCH)
    direct = eng.detect(first, rc4, k4)          # folds; the warm-up
    setup_s = time.perf_counter() - t
    folded = eng.inference_model()
    fold_check = serve_fold_check(eng, first, rc4, k4, direct)
    copy_mb = sum(t_.numel() * t_.element_size() for t_ in itertools.chain(
        folded.parameters(), folded.buffers())) / 1e6

    with MicroBatcher(eng, batch_size=SERVE_BATCH, max_delay_ms=1000) as mb:
        futures = [mb.submit(img, Rcam=r, Kmat=kmat)
                   for img, r in zip(first, rcams)]
        served = [f.result(timeout=600) for f in futures]
    worst = _same(direct, served, "batcher vs direct")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    wall, stats = http_run(eng, scenes, rcams, kmat)
    launches = read_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    want = expected(unproject=3 * stats["batches"],
                    reproject=3 * stats["batches"])
    variants = check_variants("serve", launches)
    if launches != want:
        raise RuntimeError(f"serve launched {launches}, not {want}")
    say("serve", step="http", requests=stats["requests"],
        batches=stats["batches"], padded_slots=stats["padded_slots"],
        mean_latency_ms=stats["mean_latency_ms"], wall_s=wall,
        launches=launches, variants=variants,
        batcher_vs_direct_max_diff=worst, peak_device_mb=peak_mb,
        folded_copy_mb=copy_mb, setup_s=setup_s)

    cfg.FOLD_BN = False
    unfolded_events = device_events(lambda: eng.run_model(first, rc4, k4))
    cfg.FOLD_BN = True
    folded_events = device_events(lambda: eng.run_model(first, rc4, k4))
    gone = {k: n - folded_events.get(k, 0) for k, n in
            unfolded_events.items() if n > folded_events.get(k, 0)}
    batch_norms = sum(isinstance(m, BatchNorm) for m in eng.model.modules())
    n_unfolded = sum(unfolded_events.values())
    n_folded = sum(folded_events.values())
    # an unfolded BN launches 3 device events: a device-to-device copy,
    # then the batch_norm_calc_invstd and batch_norm_* transform kernels;
    # the rest of the difference is the detection-dependent
    # post-processing (the two forwards' detections differ)
    bn_kernels = [sum(n for k, n in ev.items() if "batch_norm" in k)
                  for ev in (unfolded_events, folded_events)]
    copies = [ev.get(DTOD, 0) for ev in (unfolded_events, folded_events)]
    other_gone = (n_unfolded - n_folded - bn_kernels[0] + bn_kernels[1]
                  - copies[0] + copies[1])
    say("serve", step="fold_events", batch_norms=batch_norms,
        events_unfolded=n_unfolded, events_folded=n_folded,
        bn_kernels=bn_kernels, dtod_copies=copies,
        other_events_gone=other_gone,
        gone=json.dumps(gone, separators=(",", ":")),
        unfolded=json.dumps(unfolded_events, separators=(",", ":")),
        folded=json.dumps(folded_events, separators=(",", ":")))
    if (bn_kernels != [2 * batch_norms, 0]
            or copies[0] - copies[1] != batch_norms):
        raise RuntimeError(f"folding left BatchNorm kernels {bn_kernels} "
                           f"and device copies {copies}, not "
                           f"[{2 * batch_norms}, 0] and {batch_norms} fewer")

    throughput = {}
    # at the tool's own detection threshold
    cfg.DETECTION_MIN_CONFIDENCE = serve_bench.build_config(
        SERVE_BATCH, SERVE_SIZE).DETECTION_MIN_CONFIDENCE
    for b in (1, SERVE_BATCH):
        r = serve_bench.measure(eng, b, SERVE_REQUESTS)
        throughput[f"batch{b}"] = {k: r[k] for k in (
            "value", "mean_latency_ms", "batches", "padded_slots",
            "mean_detections")}
        say("serve", step="serve_bench", **r)
    cfg.DETECTION_MIN_CONFIDENCE = 0.0
    breakdown, upload = host_breakdown(eng, first, rc4, k4)
    say("serve", step="breakdown", breakdown_ms=json.dumps(
        breakdown, separators=(",", ":")), **upload)
    return launches, {
        "http": {"requests": stats["requests"], "batches": stats["batches"],
                 "mean_latency_ms": stats["mean_latency_ms"],
                 "wall_s": wall},
        "batcher_vs_direct_max_diff": worst,
        "fold_vs_float32": fold_check,
        "fold_events": {"batch_norms": batch_norms,
                        "unfolded": n_unfolded, "folded": n_folded,
                        "bn_kernels": bn_kernels, "dtod_copies": copies,
                        "other_gone": other_gone},
        "throughput": throughput, "breakdown_ms": breakdown,
        "upload": upload, "peak_device_mb": peak_mb,
        "folded_copy_mb": copy_mb}


def phase_serve(record):
    """Phase 12; returns the launch counts of its HTTP run."""
    t = time.perf_counter()
    kernels_b4 = serve_kernels(record)
    parity = serve_parity()
    launches, numbers = serve_flagship()
    print(json.dumps({"phase": "serve", "kernels_b4": kernels_b4,
                      "fold_batch_parity": parity, **numbers,
                      "launches": launches,
                      "seconds": time.perf_counter() - t}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 13: the training options
# ---------------------------------------------------------------------------
class BNRematTrainConfig(FlagshipTrainConfig):
    """The flagship training config with TRAIN_BN and REMAT."""
    NAME = "flagship_bn_remat_640"
    TRAIN_BN = True
    REMAT = True


class Conv4TrainConfig(FlagshipTrainConfig):
    """The flagship training config at 4 views (BENCH_4VIEW_r05.json's
    4view_640_conv3d row, trained): REMAT's memory case."""
    NAME = "conv3d4_train_640"
    NUM_VIEWS = 4


class TrilinearConfig(FlagshipConfig):
    NAME = "flagship_trilinear_640"
    TRILINEAR_REPROJECTION = True


class Trilinear256(Flagship256):
    NAME = "flagship_trilinear_256"
    TRILINEAR_REPROJECTION = True


class Trilinear256Train(Flagship256Train):
    NAME = "flagship_trilinear_train_256"
    TRILINEAR_REPROJECTION = True


class DP256(Flagship256Train):
    """The train-parity model with a global batch of 2 (one a rank)."""
    NAME = "dp_train_256"
    GPU_COUNT = 2


class DP640(FlagshipTrainConfig):
    """The flagship training config with a global batch of 2, 2 steps."""
    NAME = "dp_train_640"
    GPU_COUNT = 2
    STEPS_PER_EPOCH = 2


PREFETCH_SEED = 100
DP_DATA_SEED = 1          # a 256^2 batch of scenes with 4 and 3 positives
# (e) with TRAIN_BN, in float32: a conv bias before a batch-statistics
# BatchNorm has an exact gradient of zero, so its computed gradient is
# rounding alone and is left out (`rounding_only`, a rule on the
# reference gradient: such a bias's largest magnitude reads at most 1e-5
# of its weight gradient's, every other bias's at least 0.10). The other
# gradients, normalised as phase 7's, are held to DP_BN_GRAD_TOL for all
# but GRAD_FLIP_SHARE of the tensors, and their difference's norm to
# DP_BN_NORM_TOL of theirs. Readings (NVIDIA H100 80GB HBM3, 700 W): 95%
# of the tensors within 0.048, the norm 0.0091; with the BatchNorm sums'
# backward all-reduce dropped (the planted fault), 0.58 and 0.31.
ZERO_GRAD_REL = 1e-2
DP_BN_GRAD_TOL = 0.1
DP_BN_NORM_TOL = 2e-2
KILL_BOUND_S = 15.0       # a killed prefetch worker surfaces within this
REMAT_LOSS_REL = 1e-3     # REMAT on vs off: the same forward in bf16


def _bn_buffers(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _moved(before, model):
    """The BatchNorm statistics of `model` that differ from `before`, by
    top-level module."""
    after = _bn_buffers(model)
    out = {}
    for n, t in before.items():
        top = n.split(".")[0].rsplit("_p", 1)[0]
        moved, total = out.get(top, (0, 0))
        out[top] = (moved + (not torch.equal(t, after[n])), total + 1)
    return out


def train_options_bn_remat():
    """(a) TRAIN_BN + REMAT at the flagship: 3 steps through
    compat.MaskRCNN.train; every BatchNorm's statistics move; a "heads"
    step moves the frozen backbone's; a validation step moves none; the
    kernels launch once a level a step, forward and backward, none in a
    recomputation. Returns (launches, numbers)."""
    cfg = BNRematTrainConfig()
    ds = SyntheticMultiViewDataset(num_scenes=4, num_views=2, image_size=640,
                                   num_classes=cfg.NUM_CLASSES, seed=0)
    losses = {}
    with tempfile.TemporaryDirectory(dir="build") as model_dir:
        eng = MaskRCNN("training", cfg, model_dir)
        before = _bn_buffers(eng.model)
        reset_counts()
        eng.train(ds, None, cfg.LEARNING_RATE, 1, "all",
                  custom_callbacks=[losses.__setitem__], prefetch_threads=2)
        torch.cuda.synchronize()
        launches = read_counts()
        n = 3 * cfg.STEPS_PER_EPOCH
        expect = expected(unproject=n, unproject_bwd=n, reproject=n,
                          reproject_bwd=n)
        variants = check_variants("bn_remat", launches)
        if launches != expect:
            raise RuntimeError(f"bn_remat launches {launches} != {expect}")
        check_trained(losses, eng.model)
        moved = _moved(before, eng.model)
        if any(m != t for m, t in moved.values()):
            raise RuntimeError(f"TRAIN_BN left statistics unmoved: {moved}")

        mask = trainable_mask(eng.model, "heads")
        for name, p in eng.model.named_parameters():
            p.requires_grad_(mask[name])
        opt = make_optimizer([p for n_, p in eng.model.named_parameters()
                              if mask[n_]], cfg.LEARNING_RATE,
                             cfg.LEARNING_MOMENTUM)
        batch = eng.to_device(make_batch(ds, cfg, rnd_state=7))
        before = _bn_buffers(eng.model)
        frozen = {n_: p.detach().clone()
                  for n_, p in eng.model.backbone.named_parameters()}
        train_step(eng.model, opt, batch, cfg, mask,
                   torch.Generator(DEV).manual_seed(1))
        heads_moved = _moved(before, eng.model)
        if heads_moved["backbone"][0] != heads_moved["backbone"][1] or any(
                not torch.equal(p, frozen[n_])
                for n_, p in eng.model.backbone.named_parameters()):
            raise RuntimeError(f"a heads step moved the frozen backbone or "
                               f"not its statistics: {heads_moved}")

        before = _bn_buffers(eng.model)
        reset_counts()
        vals = val_step(eng.model, batch, cfg,
                        torch.Generator(DEV).manual_seed(2))
        val_launches = read_counts()
        if val_launches != expected(unproject=3, reproject=3) or any(
                m for m, _ in _moved(before, eng.model).values()):
            raise RuntimeError(f"the validation step launched "
                               f"{val_launches} or wrote statistics")
        if not all(np.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"validation losses not finite: {vals}")
        say("bn_remat", launches=launches, expected=expect,
            variants=variants, moved=json.dumps(moved),
            heads_step_moved=json.dumps(heads_moved),
            val_launches=val_launches,
            losses=json.dumps(losses[1], separators=(",", ":")))
        for n_, p in eng.model.named_parameters():
            p.requires_grad_(True)
        time_steps("bn_remat", eng, ds, cfg)
    return launches, {"losses": losses[1], "val_losses": vals}


def train_options_remat_memory():
    """(b) The 4-view conv3d step at 640^2 in bf16, REMAT off then on,
    from the same weights, batch and priorities: the peak device memory
    of a step after a warm-up step, the step time, the first step's
    losses."""
    ds = SyntheticMultiViewDataset(num_scenes=2, num_views=4, image_size=640,
                                   num_classes=Conv4TrainConfig.NUM_CLASSES,
                                   seed=0)
    host = make_batch(ds, Conv4TrainConfig(), rnd_state=99)
    out = {}
    for remat in (False, True):
        cfg = Conv4TrainConfig()
        cfg.REMAT = remat
        eng = MaskRCNN("training", cfg, "build")
        mask = trainable_mask(eng.model, "all")
        opt = make_optimizer(eng.model.parameters(), cfg.LEARNING_RATE,
                             cfg.LEARNING_MOMENTUM)
        batch = eng.to_device(host)
        gen = torch.Generator(DEV).manual_seed(1)
        first = train_step(eng.model, opt, batch, cfg, mask, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        for _ in range(3):
            t = time.perf_counter()
            train_step(eng.model, opt, batch, cfg, mask, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        out["on" if remat else "off"] = {
            "peak_gb": peak / 1e9, "step_peak_over_base_gb": (peak - base)
            / 1e9, "step_ms": times, "step_ms_median": statistics.median(
                times), "first_losses": first}
        del eng, opt, batch
        torch.cuda.empty_cache()
    rel = max(abs(out["on"]["first_losses"][k] - v) / max(abs(v), 1e-6)
              for k, v in out["off"]["first_losses"].items())
    say("remat_memory", **{k: json.dumps(v, separators=(",", ":"))
                           for k, v in out.items()}, loss_rel_err=rel)
    if rel > REMAT_LOSS_REL:
        raise RuntimeError(f"REMAT changed the losses by {rel}")
    return dict(out, loss_rel_err=rel)


def train_options_trilinear():
    """(c) TRILINEAR_REPROJECTION: CPU vs GPU detections and a train step
    at 256^2 in float32, then 3 requests at the flagship in bf16 (the
    reprojection kernels never launch). Returns the requests' launches.
    The train step trains stage "all" with the CPU-vs-H100 ReLU flips in
    res4e's and res4f's bn2a (GRAD_TOL) pinned. Unpinned, they put
    1.0-1.7e-3 errors on more than 5% of the backbone's tensors, worst
    9.3e-3; pinned, 2 of 350 tensors pass 1e-3, worst 1.3e-3 (NVIDIA H100
    80GB HBM3, 700 W): the flips, not the trilinear gather's backward."""
    phase_parity(Trilinear256())
    phase_train_parity(Trilinear256Train(), ("unproject", "unproject_bwd"),
                       pin_flips=True)
    return run_requests("trilinear_main", TrilinearConfig(),
                        {"unproject": 3})


def train_options_prefetch():
    """(d) Two spawned ProcessPrefetcher workers feed 3 flagship steps;
    each batch equals make_batch for its seed; a SIGKILLed worker
    surfaces as PrefetchError within KILL_BOUND_S."""
    cfg = FlagshipTrainConfig()
    ds = SyntheticMultiViewDataset(num_scenes=4, num_views=2, image_size=640,
                                   num_classes=cfg.NUM_CLASSES, seed=0)
    eng = MaskRCNN("training", cfg, "build")
    mask = trainable_mask(eng.model, "all")
    opt = make_optimizer(eng.model.parameters(), cfg.LEARNING_RATE,
                         cfg.LEARNING_MOMENTUM)
    gen = torch.Generator(DEV).manual_seed(1)
    t = time.perf_counter()
    pf = ProcessPrefetcher(functools.partial(make_batch, ds, cfg),
                           num_procs=2, seed=PREFETCH_SEED)
    try:
        waits, steps = [], []
        for k in range(3):
            t0 = time.perf_counter()
            batch = next(pf)
            waits.append((time.perf_counter() - t0) * 1e3)
            want = make_batch(ds, cfg, PREFETCH_SEED + k)
            if set(batch) != set(want) or not all(
                    np.array_equal(batch[key], v) for key, v in want.items()):
                raise RuntimeError(f"prefetched batch {k} != make_batch")
            t0 = time.perf_counter()
            metrics = train_step(eng.model, opt, eng.to_device(batch), cfg,
                                 mask, gen)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            if not all(np.isfinite(v) for v in metrics.values()):
                raise RuntimeError(f"losses not finite: {metrics}")
        first_batch_s = time.perf_counter() - t
        os.kill(pf._procs[1].pid, signal.SIGKILL)
        t0 = time.perf_counter()
        try:
            for _ in range(100):
                next(pf)
            raise RuntimeError("a killed prefetch worker went unnoticed")
        except PrefetchError as e:
            detect_s = time.perf_counter() - t0
            error = str(e).splitlines()[0]
        if detect_s > KILL_BOUND_S:
            raise RuntimeError(f"the killed worker took {detect_s} s")
    finally:
        pf.close()
    alive = [p.pid for p in pf._procs if p.is_alive()]
    if alive:
        raise RuntimeError(f"prefetch workers still alive: {alive}")
    out = {"batch_wait_ms": waits, "step_ms": steps,
           "three_steps_s": first_batch_s, "kill_detected_s": detect_s,
           "error": error}
    say("prefetch", **{k: json.dumps(v) for k, v in out.items()})
    return out


def _dp_step(cfg, group):
    """One 256^2 train step from seeded weights on this rank's rows of a
    2-scene batch (both rows without a group), ROI priorities from a CUDA
    generator seeded 0. Returns (metrics, gradients, state) on the CPU."""
    ds = SyntheticMultiViewDataset(num_scenes=2, num_views=2, image_size=256,
                                   num_classes=cfg.NUM_CLASSES, seed=2)
    host = make_batch(ds, cfg, rnd_state=DP_DATA_SEED)
    rows = host_local_batch_slice(cfg.BATCH_SIZE)
    local = {k: v if k == "anchors" else v[rows] for k, v in host.items()}
    eng = MaskRCNN("training", cfg, "build")
    eng.init_weights(torch.Generator().manual_seed(3))
    mask = trainable_mask(eng.model, "all")
    opt = make_optimizer(eng.model.parameters(), cfg.LEARNING_RATE,
                         cfg.LEARNING_MOMENTUM)
    metrics = train_step(eng.model, opt, eng.to_device(local), cfg, mask,
                         torch.Generator(DEV).manual_seed(0), group)
    return {"metrics": metrics,
            "grads": {n: p.grad.detach().cpu()
                      for n, p in eng.model.named_parameters()},
            "state": {k: v.detach().cpu()
                      for k, v in eng.model.state_dict().items()},
            "positives": int((host["rpn_match"][rows] == 1).sum())}


def _dp_rank(rank, port, outdir):
    """A rank of phase 13 (e): the 256^2 float32 steps (frozen BN, then
    TRAIN_BN), then 2 flagship steps through compat.MaskRCNN.train with
    the step and the gradient all-reduce timed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo"):
        raise RuntimeError("no process group")
    try:
        group = data_parallel_group()
        for train_bn in (False, True):
            cfg = DP256()
            cfg.TRAIN_BN = train_bn
            torch.save(_dp_step(cfg, group),
                       os.path.join(outdir, f"dp256_{train_bn}_{rank}.pt"))
        # the planted fault: the backward of the BatchNorm sums' all-reduce
        # reduces nothing, which leaves every forward as it was
        with mock.patch.object(parallel_dist._AllReduceSum, "backward",
                               staticmethod(lambda ctx, g: (g, None))):
            cfg = DP256()
            cfg.TRAIN_BN = True
            torch.save(_dp_step(cfg, group),
                       os.path.join(outdir, f"dp256_fault_{rank}.pt"))
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        cfg = DP640()
        ds = SyntheticMultiViewDataset(num_scenes=4, num_views=2,
                                       image_size=640,
                                       num_classes=cfg.NUM_CLASSES, seed=0)
        steps, reduces = [], []
        original_step, original_reduce = engine.train_step, \
            step_module.all_reduce_gradients

        def timed_reduce(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            original_reduce(*args, **kwargs)
            torch.cuda.synchronize()
            reduces.append((time.perf_counter() - t) * 1e3)

        def timed_step(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = original_step(*args, **kwargs)
            steps.append((time.perf_counter() - t) * 1e3)
            return out
        engine.train_step, step_module.all_reduce_gradients = \
            timed_step, timed_reduce
        losses = {}
        with tempfile.TemporaryDirectory(dir="build") as model_dir:
            eng = MaskRCNN("training", cfg, model_dir)
            eng.train(ds, None, cfg.LEARNING_RATE, 1, "all",
                      custom_callbacks=[losses.__setitem__],
                      prefetch_threads=1)
            wrote = sorted(os.path.relpath(os.path.join(d, f), model_dir)
                           for d, _, files in os.walk(model_dir)
                           for f in files)
        torch.save({"step_ms": steps, "all_reduce_ms": reduces,
                    "losses": losses[1], "wrote": wrote},
                   os.path.join(outdir, f"dp640_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def rounding_only(grads):
    """The biases whose gradient is zero but for rounding (a conv bias
    before a batch-statistics BatchNorm): the largest magnitude under
    ZERO_GRAD_REL of its layer's weight gradient's."""
    return {n for n, g in grads.items() if n.endswith(".bias")
            and n[:-4] + "weight" in grads
            and float(g.abs().max()) < ZERO_GRAD_REL * float(
                grads[n[:-4] + "weight"].abs().max())}


def _dp_grad_case(ref, got, train_bn):
    """The gradients of a 2-rank step against one process's, by phase 7's
    rule with frozen BN; with TRAIN_BN, the `rounding_only` biases left
    out, all but GRAD_FLIP_SHARE of the rest within DP_BN_GRAD_TOL and
    their difference's norm within DP_BN_NORM_TOL of theirs."""
    floor = 1e-6 * max(float(g.abs().max()) for g in ref.values())
    errs = _grad_errs(ref, got, floor)
    if not train_bn:
        beyond = [n for n, e in errs.items() if e > GRAD_TOL]
        return {"max_grad_err": max(errs.values()),
                "beyond_1e_3": len(beyond), "tensors": len(errs),
                "grads_agree": max(errs.values()) <= GRAD_FLIP_TOL
                and len(beyond) <= GRAD_FLIP_SHARE * len(errs)}
    zero = rounding_only(ref)
    live = sorted(set(ref) - zero)
    ratio = {n[:-6] + "bias": float(ref[n[:-6] + "bias"].abs().max())
             / float(g.abs().max())
             for n, g in ref.items() if n.endswith(".weight")
             and n[:-6] + "bias" in ref and float(g.abs().max()) > 0}
    e = np.array([errs[n] for n in live])
    norm = (sum(float((got[n] - ref[n]).double().pow(2).sum())
                for n in live)
            / sum(float(ref[n].double().pow(2).sum()) for n in live)) ** .5
    beyond = int((e > DP_BN_GRAD_TOL).sum())
    worst = max(live, key=errs.get)
    return {"tensors": len(errs), "rounding_only": len(zero),
            "rounding_only_max_ratio": max(ratio[n] for n in zero),
            "kept_bias_min_ratio": min(r for n, r in ratio.items()
                                       if n not in zero),
            "rounding_only_max_err": max(errs[n] for n in zero),
            "median_grad_err": float(np.median(e)),
            "p95_grad_err": float(np.quantile(e, 0.95)),
            "max_grad_err": errs[worst], "worst_tensor": worst,
            "beyond_tol": beyond, "global_rel_err": norm,
            "grads_agree": beyond <= GRAD_FLIP_SHARE * len(live)
            and norm <= DP_BN_NORM_TOL}


def train_options_data_parallel():
    """(e) Two ranks on the card over gloo, spawned here: at 256^2 in
    float32 (TF32 off) one step with frozen BN and one with TRAIN_BN,
    each rank bit-equal to the other and held to the single-process
    batch-2 step, and a TRAIN_BN step with a planted fault that the
    gradient rule must refuse; then 2 flagship steps in bf16, timed."""
    ctx = multiprocessing.get_context("spawn")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out = {}
    with tempfile.TemporaryDirectory(dir="build") as outdir:
        t = time.perf_counter()
        procs = [ctx.Process(target=_dp_rank, args=(r, port, outdir))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        for p in procs:
            if p.is_alive():
                p.kill()
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"data-parallel ranks exited "
                               f"{[p.exitcode for p in procs]}")
        out["ranks_s"] = time.perf_counter() - t
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for train_bn in (False, True):
            cfg = DP256()
            cfg.TRAIN_BN = train_bn
            ranks = [torch.load(os.path.join(outdir,
                                              f"dp256_{train_bn}_{r}.pt"))
                     for r in range(2)]
            if ranks[0]["positives"] == ranks[1]["positives"]:
                raise RuntimeError("the ranks hold equal positive counts")
            if ranks[0]["metrics"] != ranks[1]["metrics"] or any(
                    not torch.equal(t_, ranks[1][key][n])
                    for key in ("grads", "state")
                    for n, t_ in ranks[0][key].items()):
                raise RuntimeError(f"ranks differ (TRAIN_BN {train_bn})")
            ref, got = _dp_step(cfg, None), ranks[0]
            loss_err = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-6)
                           for k, v in ref["metrics"].items())
            stats = {n: t_ for n, t_ in ref["state"].items()
                     if n.endswith(("running_mean", "running_var"))}
            stat_errs = _grad_errs(stats, {n: got["state"][n]
                                           for n in stats}, 1e-30)
            case = {"positives": [r["positives"] for r in ranks],
                    "max_loss_rel_err": loss_err,
                    "max_stat_err": max(stat_errs.values()),
                    **_dp_grad_case(ref["grads"], got["grads"], train_bn)}
            out[f"train_bn_{train_bn}"] = case
            say("data_parallel", train_bn=train_bn, **case)
            if loss_err > 1e-4 or max(stat_errs.values()) > 1e-4 \
                    or not case["grads_agree"]:
                raise RuntimeError(f"2 ranks != 1 process (TRAIN_BN "
                                   f"{train_bn}): {case}")
        # ref: the single-process TRAIN_BN step, the loop's last
        fault = _dp_grad_case(
            ref["grads"], torch.load(os.path.join(
                outdir, "dp256_fault_0.pt"))["grads"], True)
        out["planted_fault"] = fault
        say("data_parallel", planted_fault="bn_sums_backward_not_reduced",
            **fault)
        if fault["grads_agree"]:
            raise RuntimeError(f"the TRAIN_BN gradient rule passes a "
                               f"dropped all-reduce: {fault}")
        flagship = [torch.load(os.path.join(outdir, f"dp640_{r}.pt"))
                    for r in range(2)]
    if flagship[0]["losses"] != flagship[1]["losses"] or not all(
            np.isfinite(v) for v in flagship[0]["losses"].values()):
        raise RuntimeError(f"flagship ranks' losses: {flagship}")
    if flagship[1]["wrote"] or not flagship[0]["wrote"]:
        raise RuntimeError(f"rank 0 alone writes: {flagship}")
    steps = flagship[0]["step_ms"]
    reduce_ms = flagship[0]["all_reduce_ms"]
    out["flagship"] = {
        "step_ms": steps, "all_reduce_ms": reduce_ms,
        "all_reduce_share": [r / s_ for r, s_ in zip(reduce_ms, steps)],
        "rank1_step_ms": flagship[1]["step_ms"],
        "losses": flagship[0]["losses"], "rank0_wrote": flagship[0]["wrote"]}
    say("data_parallel", flagship=json.dumps(out["flagship"]))
    return out


class EvalBNConfig(FlagshipConfig):
    """The flagship inference config with BatchNorms in batch-statistics
    mode at inference (make_eval_step's diagnostic)."""
    NAME = "flagship_eval_bn"
    TRAIN_BN = True
    BN_EVAL_BATCH_STATS = True


def phase_eval_step():
    """train/step.py::make_eval_step once at the flagship config with
    TRAIN_BN and BN_EVAL_BATCH_STATS, the BatchNorm statistics mildly
    randomised: the fused unprojection and the reprojection launched 3
    times each in their vector variants, every output finite, every
    BatchNorm buffer bit-unchanged, and the outputs other than those of
    the frozen BatchNorms. Returns the launches."""
    cfg = EvalBNConfig()
    eng = MaskRCNN("inference", cfg, "build")
    eng.init_weights(torch.Generator().manual_seed(3))
    mildly_randomise_bns(eng.model, 7)
    rng = np.random.RandomState(4)
    hw = cfg.IMAGE_MAX_DIM
    molded, metas, _ = eng._mold_batch(request_images(rng, 1, hw,
                                                      cfg.NUM_VIEWS))
    batch = eng._device_batch(molded, metas, poses(rng, 1, cfg.NUM_VIEWS),
                              intrinsics(1, hw), None)
    before = {n: b.clone() for n, b in eng.model.named_buffers()}
    step = make_eval_step(cfg)
    step(eng.model, batch)                                 # warm-up
    reset_counts()
    t = time.perf_counter()
    out = step(eng.model, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = read_counts()
    check_variants("eval_step", launches)
    changed = [n for n, b in eng.model.named_buffers()
               if not torch.equal(b, before[n])]
    finite = all(bool(torch.isfinite(v.float()).all()) for v in out.values())
    eng.model.config = FlagshipConfig()
    frozen = step(eng.model, batch)
    moved = float((frozen["rpn_probs"].float()
                   - out["rpn_probs"].float()).abs().max())
    print(json.dumps({"phase": "eval_step", "ms": round(ms, 3),
                      "launches": launches, "buffers_changed": changed,
                      "finite": finite,
                      "rpn_probs_vs_frozen_bn_max_diff": moved}), flush=True)
    if (launches != expected(unproject=3, reproject=3) or changed
            or not finite or moved == 0.0):
        raise RuntimeError(f"eval_step: launches {launches}, buffers "
                           f"changed {changed[:3]}, finite {finite}, "
                           f"vs frozen {moved}")
    return launches


TTA_STEPS = 200
TTA_DEVICE = "cuda"
TTA_SIZE = ["--image-size", "64", "--num-views", "2", "--scenes", "2"]
# final_loss (mean of the last 20 steps) below this share of initial_loss
# (the first 20's): the geometric middle of the first run's 0.0685 and the
# planted run's 0.9637 (NVIDIA H100 80GB HBM3, 700 W), 3.6x from each
TTA_LOSS_FRACTION = 0.25
TTA_PLANTED_LR = "1e-9"
TTA_PLANTED_STEPS = 60    # first and last 20 steps apart
TTA_B4 = ["--batch", "4"]  # the JAX AP records' training batch
TTA_B4_STEPS = 20


# the harness path's kernel wrappers: (kernel, module, wrapper, its plain
# version, the arguments the plain version takes after the wrapper's)
_WRAPPERS = (
    ("unproject", unproject, "gather_fused", plain.bilinear_gather_fused,
     lambda a: ()),
    ("unproject_bwd", unproject, "gather_fused_bwd",
     plain.bilinear_gather_fused_bwd,
     lambda a: (a[0].dtype,) if len(a) == 8 else (True, a[0].dtype)),
    ("unproject_view", unproject, "gather", plain.bilinear_gather,
     lambda a: ()),
    ("unproject_view_bwd", unproject, "gather_bwd", plain.bilinear_gather_bwd,
     lambda a: (a[0].dtype,)),
    ("reproject", reproject, "gather", plain.zslice_gather, lambda a: ()),
    ("reproject_bwd", reproject, "gather_bwd", plain.zslice_gather_bwd,
     lambda a: (a[0].dtype,)),
)


@contextlib.contextmanager
def held_to_plain(record):
    """Inside, every kernel call also runs the kernel's plain version on
    a CPU copy of its inputs and is held to it with `_check`'s tolerance
    (raising past it); record[kernel] = [calls, max abs error, shapes of
    its first input]."""
    saved = []
    for key, mod, name, ref, extra in _WRAPPERS:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def held(*a, _fn=fn, _key=key, _ref=ref, _extra=extra, **k):
            out = _fn(*a, **k)
            want = _ref(*[x.detach().cpu() if torch.is_tensor(x) else x
                          for x in a], *_extra(a), **k)
            err, _ = _check(_key, out.detach(), want, out.dtype)
            entry = record.setdefault(_key, [0, 0.0, []])
            entry[0] += 1
            entry[1] = max(entry[1], err)
            if list(a[0].shape) not in entry[2]:
                entry[2].append(list(a[0].shape))
            return out
        setattr(mod, name, held)
    try:
        yield record
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _tta(argv, log):
    """train_to_ap.main(argv) in this process, its standard output
    appended to `log`; returns its result."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            return tta.main(argv)
    finally:
        log.write(out.getvalue())


def phase_train_to_ap():
    """Phase 16: (a) the harness trains 200 steps at 64^2 and must pass
    the loss gate, a planted learning rate of 1e-9 must not; (b) the
    supervisor restarts segments to --until-step 2, in subprocesses
    that run beside the planted run; before (a), the batch-4 leg: every
    kernel call of 2 steps at --batch 4 held to plain, then
    TTA_B4_STEPS steps timed. Returns (a)'s launches and the batch-4
    steps'."""
    t0 = time.perf_counter()
    failures = []
    levels = 5 - len(tta.build_config(64, 2).ZERO_PG_LEVELS)
    sup = None
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        log = open(os.path.join(work, "train_to_ap.log"), "w")
        ckpt, out = os.path.join(work, "ck"), os.path.join(work, "sup.json")
        sup_log = open(os.path.join(work, "supervisor.log"), "w+")
        try:
            # every kernel call of 2 steps and an evaluation with detections
            # (min confidence 0) against its plain version, at this path's
            # shapes; not counted
            held = {}
            with held_to_plain(held):
                _tta(TTA_SIZE + ["--steps", "2", "--smoke", "--min-conf", "0",
                                 "--device", TTA_DEVICE], log)
            for key in ("unproject", "unproject_bwd", "reproject",
                        "reproject_bwd"):
                if not held.get(key, [0])[0]:
                    failures.append(f"{key} never held to its plain version")
            # the same at the records' batch 4: every call of 2 steps and
            # an evaluation (at batch 1, as the harness evaluates) held to
            # plain, each kernel's calls including batch-4 ones
            held_b4 = {}
            with held_to_plain(held_b4):
                _tta(TTA_SIZE + TTA_B4 + ["--steps", "2", "--smoke",
                                          "--min-conf", "0",
                                          "--device", TTA_DEVICE], log)
            # (the unprojection's first input holds B * V rows, 2 views)
            for key, rows in (("unproject", 4 * 2), ("unproject_bwd", 4),
                              ("reproject", 4), ("reproject_bwd", 4)):
                calls, _, shapes = held_b4.get(key, [0, 0.0, []])
                if not calls or not any(sh[0] == rows for sh in shapes):
                    failures.append(f"{key} not held to its plain version at "
                                    f"batch 4: {held_b4.get(key)}")
            # then a few steps at batch 4, timed, their launches counted
            # (path train_to_ap_b4); the 2 steps above warmed its shapes
            reset_counts()
            result_b4 = _tta(TTA_SIZE + TTA_B4 + [
                "--steps", str(TTA_B4_STEPS), "--smoke", "--skip-eval",
                "--device", TTA_DEVICE], log)
            launches_b4 = read_counts()
            check_variants("train_to_ap_b4", launches_b4)
            want_b4 = expected(unproject=levels * TTA_B4_STEPS,
                               unproject_bwd=levels * TTA_B4_STEPS,
                               reproject=levels * TTA_B4_STEPS,
                               reproject_bwd=levels * TTA_B4_STEPS)
            if launches_b4 != want_b4:
                failures.append(f"batch 4: launches {launches_b4} != "
                                f"{want_b4}")
            if not all(np.isfinite([result_b4["initial_loss"],
                                    result_b4["final_loss"]])):
                failures.append(f"batch 4: losses {result_b4}")
            reset_counts()
            t = time.perf_counter()
            args = TTA_SIZE + ["--steps", str(TTA_STEPS), "--smoke",
                               "--device", TTA_DEVICE]
            result = _tta(args + ["--diagnostics"], log)
            seconds = time.perf_counter() - t
            launches = read_counts()
            check_variants("train_to_ap", launches)
            # evaluation: a detect a scene; diagnostics: a detect and a
            # run_graph a scene
            calls = TTA_STEPS + 3 * len(result["diagnostics"]["per_scene"])
            want = expected(unproject=levels * calls,
                            unproject_bwd=levels * TTA_STEPS,
                            reproject=levels * calls,
                            reproject_bwd=levels * TTA_STEPS)
            if launches != want:
                failures.append(f"launches {launches} != {want}")
            ratio = result["final_loss"] / result["initial_loss"]
            if not ratio < TTA_LOSS_FRACTION:
                failures.append(f"final/initial loss {ratio:.4f} is not below "
                                f"{TTA_LOSS_FRACTION}")
            # (b) the supervisor, its segments in subprocesses, after (a)'s
            # timed run and beside the planted one
            t_sup = time.perf_counter()
            sup = subprocess.Popen(
                [sys.executable, "-m",
                 "mulit_view_object_detection_torch.cli.train_supervisor",
                 "--max-rss-gb", "0.001", "--", "--until-step", "2",
                 "--ckpt", ckpt, "--smoke", "--skip-eval", "--device",
                 TTA_DEVICE, *TTA_SIZE, "--out", out], cwd=ROOT,
                stdout=sup_log, stderr=subprocess.STDOUT,
                start_new_session=True)
            planted = _tta(TTA_SIZE + ["--steps", str(TTA_PLANTED_STEPS),
                                       "--smoke", "--device", TTA_DEVICE,
                                       "--lr", TTA_PLANTED_LR, "--skip-eval"],
                           log)
            planted_ratio = planted["final_loss"] / planted["initial_loss"]
            if planted_ratio < TTA_LOSS_FRACTION:
                failures.append(f"the planted lr {TTA_PLANTED_LR} passed the "
                                f"gate ({planted_ratio:.4f})")
        except BaseException:
            # stop the supervisor and its segment on a failure
            if sup is not None:
                os.killpg(sup.pid, signal.SIGKILL)
                sup.wait()
            raise
        sup.wait(timeout=600)
        sup_seconds = time.perf_counter() - t_sup
        sup_log.seek(0)
        sup_out = sup_log.read()
        sup_log.close()
        log.write(sup_out)
        log.close()
        exits_75 = sup_out.count("exiting 75 for supervised restart")
        sup_result = {}
        if os.path.exists(out):
            with open(out) as f:
                sup_result = json.load(f)
        if (sup.returncode != 0 or exits_75 != 2
                or sup_result.get("steps") != 2
                or not sup_result.get("cumulative_seconds")):
            failures.append(f"supervisor: rc {sup.returncode}, {exits_75} "
                            f"exits 75, result {sup_result}: "
                            f"{sup_out[-1500:]}")
        if failures:
            with open(os.path.join(work, "train_to_ap.log")) as f:
                tail = f.read()[-3000:]
    diag = result["diagnostics"]
    print(json.dumps({
        "phase": "train_to_ap", "card": SMI[0], "steps": TTA_STEPS,
        "seconds": round(seconds, 2),
        "step_ms": round(result["seconds"] / TTA_STEPS * 1e3, 2),
        "initial_loss": result["initial_loss"],
        "final_loss": result["final_loss"],
        "loss_ratio": round(ratio, 4), "gate": TTA_LOSS_FRACTION,
        "planted_lr": float(TTA_PLANTED_LR),
        "planted_loss_ratio": round(planted_ratio, 4),
        "planted_refused": planted_ratio >= TTA_LOSS_FRACTION,
        "ap50": result["ap50"],
        "diagnostics": {k: v for k, v in diag.items() if k != "per_scene"},
        "device": result["device"], "launches": launches,
        "held_to_plain": held,
        "batch4": {"steps": TTA_B4_STEPS,
                   "step_ms": round(result_b4["seconds"] / TTA_B4_STEPS
                                    * 1e3, 2),
                   "initial_loss": result_b4["initial_loss"],
                   "final_loss": result_b4["final_loss"],
                   "launches": launches_b4, "held_to_plain": held_b4},
        "supervisor": {"rc": sup.returncode, "exits_75": exits_75,
                       "steps": sup_result.get("steps"),
                       "cumulative_seconds":
                           sup_result.get("cumulative_seconds"),
                       "seconds": round(sup_seconds, 2)},
        "phase_seconds": round(time.perf_counter() - t0, 2)}), flush=True)
    if failures:
        raise RuntimeError(f"train_to_ap phase: {failures}\n{tail}")
    return launches, launches_b4


EXAMPLES = "mulit_view_object_detection_torch.examples."
EXAMPLE_RUNS = (("demo_synthetic", ()), ("projection_playground", ()),
                ("projection_playground", ("--camera-anchored",)))


def _image_shape(path):
    """(height, width, channels) of the image file that OpenCV decodes
    at `path`, or None where it is missing, empty or does not decode."""
    if not os.path.exists(path) or not os.path.getsize(path):
        return None
    im = cv2.imread(path)
    return None if im is None else im.shape


def phase_examples():
    """Phase 17: the two example programs on the card. First every kernel
    call of their run_* functions held to its plain version on a CPU copy
    (not counted); then each program's main() in this process from a
    scratch working directory, its launches counted and its variants
    read (the demo: the per-view unprojection and the reprojection
    forwards at C = 32 in their vector variants, 3 levels each; the
    playground at C = 3: one scalar forward of each, per lattice), its
    output image decoded; and the three `python -m` commands as
    subprocesses beside it, each exiting 0 with its image written.
    Returns the launches by program."""
    from mulit_view_object_detection_torch.examples import (
        demo_synthetic as demo, projection_playground as playground)
    t0 = time.perf_counter()
    failures, out, paths = [], {}, {}
    geo = playground.GeoCfg()
    levels = 5 - len(demo.DemoConfig().ZERO_PG_LEVELS)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        procs = []
        for i, (name, flags) in enumerate(EXAMPLE_RUNS):
            cwd = os.path.join(work, f"cmd{i}")
            os.makedirs(cwd)
            procs.append((name, flags, cwd, subprocess.Popen(
                [sys.executable, "-m", EXAMPLES + name, *flags],
                cwd=cwd, env=dict(os.environ, PYTHONPATH=ROOT),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                start_new_session=True)))
        try:
            held = {}
            with held_to_plain(held):
                demo.run_demo(demo.build_model(), demo.make_dataset())
                for anchored in (False, True):
                    playground.run_playground(geo, anchored)
            out["held_to_plain"] = held
            for key in ("unproject_view", "reproject"):
                if not held.get(key, [0])[0]:
                    failures.append(f"{key} never held to its plain version")
            want = {
                "demo_synthetic": (
                    expected(unproject_view=levels, reproject=levels),
                    {"view_fwd_vector": levels,
                     "reproject_fwd_vector": levels}),
                "projection_playground": (
                    expected(unproject_view=1, reproject=1),
                    {"view_fwd_scalar": 1, "reproject_fwd_scalar": 1})}
            for i, (name, flags) in enumerate(EXAMPLE_RUNS):
                module = demo if name == "demo_synthetic" else playground
                tag = " ".join((name,) + flags)
                cwd = os.path.join(work, f"main{i}")
                os.makedirs(cwd)
                reset_counts()
                t = time.perf_counter()
                with contextlib.chdir(cwd), \
                        contextlib.redirect_stdout(io.StringIO()):
                    module.main([*flags])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t
                launches, variants = read_counts(), launched_variants()
                image = (demo.DEMO_OUTPUT if module is demo
                         else playground.OUTPUT)
                shape = _image_shape(os.path.join(cwd, image))
                out[tag] = {"seconds": round(seconds, 3),
                            "launches": launches, "variants": variants,
                            "image": image, "image_shape": shape}
                if (launches, variants) != want[name]:
                    failures.append(f"{tag}: launches {launches}, variants "
                                    f"{variants}, not {want[name]}")
                if shape is None:
                    failures.append(f"{tag}: {image} not written")
                paths[name] = {k: paths.get(name, {}).get(k, 0) + n
                               for k, n in launches.items()}
        finally:
            for name, flags, cwd, proc in procs:
                try:
                    log, _ = proc.communicate(timeout=300)
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGKILL)
                    log, _ = proc.communicate()
                image = (demo.DEMO_OUTPUT if name == "demo_synthetic"
                         else playground.OUTPUT)
                shape = _image_shape(os.path.join(cwd, image))
                out["python -m " + " ".join((name,) + flags)] = {
                    "rc": proc.returncode, "image_shape": shape}
                if proc.returncode != 0 or shape is None:
                    failures.append(f"python -m {name} {flags}: rc "
                                    f"{proc.returncode}, {image} {shape}: "
                                    f"{log[-1500:]}")
    out["phase_seconds"] = round(time.perf_counter() - t0, 2)
    print(json.dumps({"phase": "examples", "card": SMI[0], **out}),
          flush=True)
    if failures:
        raise RuntimeError(f"examples phase: {failures}")
    return paths


# phase 18: the measurement tools
TOOL_TOP = 15
INPUT_WORKERS = (1, 4)
INPUT_BATCHES = 16


def _trace_kernels(rows):
    """The unprojection's and the reprojection's forward kernels among a
    trace's device ops: both live in csrc/'s namespace mvod as fwd_kernel;
    the reprojection's takes a ZIndex, the unprojection's does not."""
    ours = [name for name, _, _ in rows if "mvod" in name
            and "fwd_kernel" in name]
    return ([n for n in ours if "ZIndex" not in n],
            [n for n in ours if "ZIndex" in n])


def _held_tools(variants, failures):
    """Every kernel call of one forward of each (variant, batch) and of
    one flagship train step, held to its plain version at the shapes
    these tools give it (not counted): {workload: held_to_plain's
    record}."""
    from mulit_view_object_detection_torch.cli import measure, mfu_report
    held = {}
    runs = [(f"{name}:b{batch}", functools.partial(
        measure.inference_setup, variant_config(name, batch), DEV),
        lambda model, inputs: measure.infer_loop(model, inputs, 1))
        for name, batch in variants]
    runs.append(("train_step", functools.partial(
        mfu_report.train_workload, DEV), lambda _m, _b, steps: steps(1)))
    for workload, setup, run in runs:
        record = held.setdefault(workload, {})
        try:
            made = setup()
            with held_to_plain(record):
                run(*made)
            torch.cuda.synchronize()
        except RuntimeError as e:
            failures.append(f"{workload} held to plain: {e}")
        made = None
    return held


def phase_tools():
    """Phase 18: the four tools on the card, as their CLIs run them, each
    JSON line parsed back; before them, every kernel call of one forward
    of each variant and of one train step held to its plain version.
    Returns the phase's launches."""
    from mulit_view_object_detection_torch.cli import (
        bench_input, mfu_report, profile_variants, trace_analysis)
    t0 = time.perf_counter()
    failures, out = [], {"card": SMI[0]}
    variants = [(v, 1) for v in profile_variants.VARIANTS] + [("conv3d", 4)]
    out["held_to_plain"] = _held_tools(variants, failures)
    out["held_seconds"] = round(time.perf_counter() - t0, 2)
    torch.cuda.empty_cache()
    reset_counts()

    def line(fields):
        parsed = json.loads(json.dumps(fields))
        print(json.dumps({"tool_line": parsed}), flush=True)
        return parsed

    out["profile_variants"] = []
    for name, batch in variants:
        t = time.perf_counter()
        row = line(profile_variants.time_variant(name, batch, "cuda"))
        row["seconds"] = round(time.perf_counter() - t, 2)
        out["profile_variants"].append(row)
        if not row["ms_per_frame"] > 0:
            failures.append(f"profile_variants {name}:b{batch}: {row}")

    out["mfu_report"] = []
    for fn in (lambda: mfu_report.inference_report("conv3d", "cuda"),
               lambda: mfu_report.inference_report("conv3d", "cuda", 4),
               lambda: mfu_report.train_report("cuda")):
        t = time.perf_counter()
        row = line(fn())
        row["seconds"] = round(time.perf_counter() - t, 2)
        out["mfu_report"].append(row)
        if not (row["ms"] > 0 and 0 < row["mfu"] <= 1 and row["flops"] > 0
                and 0 < row["min_bytes"] <= row["eager_bytes"]):
            failures.append(f"mfu_report {row['workload']}: {row}")
    b1, b4 = out["mfu_report"][0]["flops"], out["mfu_report"][1]["flops"]
    out["flops_b4_over_b1"] = b4 / b1
    if b4 != 4 * b1:
        failures.append(f"conv3d inference FLOPs at batch 4 ({b4}) are not "
                        f"4 x batch 1's ({b1})")

    t = time.perf_counter()
    path = trace_analysis.capture(
        "conv3d", "cuda", os.path.join(ROOT, "build", "tools_trace.json"))
    trace = trace_analysis.load(path)
    scope, total_ms, rows = trace_analysis.top_ops(trace, n=10 ** 6)
    print(trace_analysis.format_top(scope, total_ms, rows[:TOOL_TOP]),
          flush=True)
    unproj, reproj = _trace_kernels(rows)
    busy, span = trace_analysis.busy_and_span(trace)
    out["trace_analysis"] = {
        "scope": scope, "device_ms_3_steps": round(total_ms, 4),
        "device_busy_ms": round(busy, 4), "trace_span_ms": round(span, 4),
        "idle_share": round(1 - busy / span, 4) if span else None,
        "ops": len(rows), "unprojection_kernels": unproj,
        "reprojection_kernels": reproj,
        "top": [[n, round(ms, 4), c] for n, ms, c in rows[:TOOL_TOP]],
        "seconds": round(time.perf_counter() - t, 2)}
    if scope != "device" or not unproj or not reproj:
        failures.append(f"trace_analysis: scope {scope}, unprojection "
                        f"{unproj}, reprojection {reproj}; mvod kernels "
                        f"{[n for n, _, _ in rows if 'mvod' in n]}")

    cfg, fn = bench_input.make_fn(640, 2)
    out["bench_input"] = []
    for workers in INPUT_WORKERS:
        row = line(bench_input.measure("thread", fn, cfg, workers,
                                       INPUT_BATCHES))
        out["bench_input"].append(row)
        if not row["frames_per_sec"] > 0:
            failures.append(f"bench_input workers {workers}: {row}")

    torch.cuda.synchronize()
    launches = read_counts()
    out["launches"] = launches
    for key in ("unproject", "unproject_bwd", "unproject_view", "reproject",
                "reproject_bwd"):
        if not launches[key]:
            failures.append(f"the tools launched no {key}")
    for key in KERNELS:
        calls = sum(rec.get(key, [0])[0]
                    for rec in out["held_to_plain"].values())
        if launches[key] and not calls:
            failures.append(f"{key}: launched by the tools, never held to "
                            f"its plain version")
    out["phase_seconds"] = round(time.perf_counter() - t0, 2)
    print(json.dumps({"phase": "tools", **out}), flush=True)
    if failures:
        raise RuntimeError(f"tools phase: {failures}")
    return launches


def phase_train_options():
    """Phase 13; returns the launch counts of (a)'s training and (c)'s
    requests."""
    t = time.perf_counter()
    bn_launches, bn_numbers = train_options_bn_remat()
    remat = train_options_remat_memory()
    tri_launches = train_options_trilinear()
    prefetch = train_options_prefetch()
    dp = train_options_data_parallel()
    print(json.dumps({"phase": "train_options", "bn_remat": bn_numbers,
                      "remat_memory": remat, "prefetch": prefetch,
                      "data_parallel": dp,
                      "launches": {"bn_remat_train": bn_launches,
                                   "trilinear_inference": tri_launches},
                      "seconds": time.perf_counter() - t}), flush=True)
    return bn_launches, tri_launches


# ---------------------------------------------------------------------------
# phase 14: the device mesh
# ---------------------------------------------------------------------------
MESH_RANKS = 4
MESH_SHAPES = ((1, 2, 2), (2, 2, 1), (2, 1, 2))
# (a)'s meshes whose backbone ReLU inputs are pinned to the one-process
# signs; (2, 2, 1) flipped none on the H100 and runs unpinned
MESH_PINNED = ((1, 2, 2), (2, 1, 2))
# the most backbone ReLU inputs of a rank whose sign may differ from the
# one-process step's: sound runs on the H100 flipped 0-6 a mesh, while a
# sharding fault upstream of the gather flips a share of all of them
MESH_FLIP_MAX = 32
# (a) once more on this mesh with a sharding fault planted before the
# views' gather (the second view rank reads the first one's images): the
# flip gate or the gradient gate must refuse it
MESH_PLANTED = (1, 2, 2)
MESH_LABEL = "4 processes on one H100 over gloo"
MESH_JOIN_S = 600


class MeshLstm256(Flagship256):
    """Phase 6's lstm3d parity config with a batch of 2 scenes."""
    NAME = "mesh_lstm3d_256"
    GRID_REAS = "lstm3d"
    GPU_COUNT = 2


def _digest(t):
    return hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes()
                        ).hexdigest()


def _mesh_reference(cfg, host):
    """(a)'s one-process step from seeded weights on the global batch,
    ROI priorities from a CUDA generator seeded 0: metrics, gradients
    and the parameters before and after, on the CPU."""
    eng = MaskRCNN("training", cfg, "build")
    eng.init_weights(torch.Generator().manual_seed(3))
    model = eng.model
    before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(model.parameters(), cfg.LEARNING_RATE,
                         cfg.LEARNING_MOMENTUM)
    relu = _BackboneRelu()
    with mock.patch.object(resnet_module, "F", relu):
        metrics = train_step(model, opt, eng.to_device(host), cfg,
                             trainable_mask(model, "all"),
                             torch.Generator(DEV).manual_seed(0))
    return {"metrics": metrics, "before": before, "relu": relu.inputs,
            "grads": {n: (p.grad if p.grad is not None
                          else torch.zeros_like(p)).detach().cpu()
                      for n, p in model.named_parameters()},
            "after": {n: p.detach().cpu() for n, p in
                      model.named_parameters()}}


class _BackboneRelu:
    """`models/resnet.py`'s torch.nn.functional with its relu watched:
    every backbone ReLU (the stem's, and bn2a's, bn2b's and the residual
    sum's of each block) records its input, or, given `recorded` (one
    process's, in call order) and `rows` (this rank's images in the
    global batch's), counts the inputs whose sign differs from the
    recorded one's and, with `pin`, takes the recorded value there
    (phase 7's `_pin`)."""

    def __init__(self, recorded=None, rows=None, pin=True):
        self.recorded, self.rows, self.pin = recorded, rows, pin
        self.inputs, self.flips = [], []

    def __getattr__(self, name):
        return getattr(F, name)

    def relu(self, x, inplace=False):
        if self.recorded is None:
            self.inputs.append(x.detach().cpu())
        else:
            want = self.recorded[len(self.flips)][self.rows].to(x.device)
            self.flips.append(int(((want > 0) != (x > 0)).sum()))
            if self.pin:
                x = _pin(x, want)
        return F.relu(x)


def _image_rows(mesh, b, v):
    """This rank's backbone images as rows of the global batch's
    (scene-major, b scenes of v views)."""
    d, vc = mesh.coord("data"), mesh.coord("view")
    bl, vl = b // mesh.size("data"), v // mesh.size("view")
    return torch.tensor([(d * bl + i // vl) * v + vc * vl + i % vl
                         for i in range(bl * vl)])


def _wrong_view_slice(mesh):
    """`parallel/mesh.py::shard_batch` with a sharding fault planted:
    the view ranks past the first take the first view rank's images."""
    shard_batch = parallel_mesh.shard_batch

    def planted(batch, shardings):
        local = shard_batch(batch, shardings)
        if mesh.coord("view") > 0:
            first = dict(batch, images=np.repeat(
                batch["images"][:, :1], batch["images"].shape[1], axis=1))
            local["images"] = shard_batch(first, shardings)["images"]
        return local
    return planted


def _mesh_parity_case(shape, cfg, host, ref, plant=False):
    """(a) on one mesh: the step through make_parallel_train_step with
    the views sharded and the TP rule applied, the backbone's ReLU
    inputs' sign flips against the one-process step counted and, on the
    meshes of MESH_PINNED, pinned (`_BackboneRelu`); the losses, the
    gradients and the updated parameters (split ones gathered) against
    the one-process step; digests of the whole parameters. `plant`: with
    the wrong view slice on the second view rank (`_wrong_view_slice`),
    a fault the gates must refuse."""
    mesh = parallel_mesh.make_mesh(*shape)
    eng = MaskRCNN("training", cfg, "build")
    eng.init_weights(torch.Generator().manual_seed(3))
    model = eng.model
    relu = _BackboneRelu(ref["relu"], _image_rows(mesh, cfg.BATCH_SIZE,
                                                  cfg.NUM_VIEWS),
                         pin=shape in MESH_PINNED)
    opt = make_optimizer(model.parameters(), cfg.LEARNING_RATE,
                         cfg.LEARNING_MOMENTUM)
    parallel_mesh.shard_state_tp(model, opt, mesh)
    step = parallel_mesh.make_parallel_train_step(train_step, mesh, True)
    fault = (mock.patch.object(parallel_mesh, "shard_batch",
                               _wrong_view_slice(mesh)) if plant
             else contextlib.nullcontext())
    with mock.patch.object(resnet_module, "F", relu), fault:
        metrics = step(model, opt, host, cfg, trainable_mask(model, "all"),
                       torch.Generator(DEV).manual_seed(0))
    # the backbone's ReLUs in call order: the stem's, then each block's
    # after bn2a, after bn2b and on the residual sum
    names = ["bn_conv1"] + [f"{blk}.{at}" for stage in
                            model.backbone.stage_names for blk in stage
                            for at in ("bn2a", "bn2b", "sum")]
    named = list(model.named_parameters())
    split = {n for n, p in named if shard_of(p) is not None}
    grads = parallel_mesh.gather_shards(
        (n, p.grad if p.grad is not None else torch.zeros_like(p),
         shard_of(p)) for n, p in named)
    after = parallel_mesh.gather_shards(
        (n, p.detach(), shard_of(p)) for n, p in named)
    grads = {n: g.float().cpu() for n, g in grads.items()}
    after = {n: t.cpu() for n, t in after.items()}
    loss_err = max(abs(metrics[k] - v) / max(1.0, abs(v))
                   for k, v in ref["metrics"].items())
    floor = 1e-6 * max(float(g.abs().max()) for g in ref["grads"].values())
    gerrs = _grad_errs(ref["grads"], grads, floor)
    # the updated slices, held to the update's size beyond one float32
    # spacing of the weight: a step of lr 1e-3 moves a weight by a few
    # hundred of its spacings, so gradients equal to 5e-6 may still land
    # on neighbouring floats
    upd = {n: ref["after"][n] - ref["before"][n] for n in split}
    ufloor = 1e-6 * max([float(u.abs().max()) for u in upd.values()] + [0])
    uerrs = {}
    for n in split:
        want = ref["after"][n]
        spacing = (torch.nextafter(want, want.new_tensor(float("inf")))
                   - want).abs()
        beyond = ((after[n] - want).abs() - spacing).clamp_min(0)
        uerrs[n] = float(beyond.max()) / max(float(upd[n].abs().max()),
                                             ufloor, 1e-30)
    beyond = [n for n, e in gerrs.items() if e > GRAD_TOL]
    ubeyond = [n for n, e in uerrs.items() if e > GRAD_TOL]
    return {
        "mesh": shape, "metrics": metrics, "max_loss_err": loss_err,
        "relu_flips": {names[i]: k for i, k in enumerate(relu.flips) if k},
        "relu_calls": len(relu.flips), "relu_pinned": relu.pin,
        "relu_flip_total": sum(relu.flips),
        "worst_grads": {n: gerrs[n] for n in sorted(
            gerrs, key=gerrs.get)[-8:]},
        "max_grad_err": max(gerrs.values()), "grad_tensors": len(gerrs),
        "grads_beyond_1e_3": len(beyond),
        "grads_agree": max(gerrs.values()) <= GRAD_FLIP_TOL
        and len(beyond) <= GRAD_FLIP_SHARE * len(gerrs),
        "split_leaves": len(split),
        "max_split_update_err": max(uerrs.values()) if uerrs else None,
        "split_updates_beyond_1e_3": len(ubeyond),
        "split_updates_agree": not uerrs or (
            max(uerrs.values()) <= GRAD_FLIP_TOL
            and len(ubeyond) <= GRAD_FLIP_SHARE * len(uerrs)),
        "whole": {n: _digest(p) for n, p in named if n not in split},
        "own_split": {n: _digest(p) for n, p in named if n in split}}


def _mesh_detect_inputs(eng, cfg):
    """(b)'s two 256^2 scenes, molded, as the engine's device batch."""
    rng = np.random.RandomState(2)
    hw = cfg.IMAGE_MAX_DIM
    images = request_images(rng, 2, hw, cfg.NUM_VIEWS)
    molded, metas, windows = eng._mold_batch(images)
    batch = eng._device_batch(molded, metas, poses(rng, 2, cfg.NUM_VIEWS),
                              intrinsics(2, hw), None)
    return images, batch, molded.shape[2:5], windows


def _mesh_detect(mesh):
    """(b): lstm3d inference with the views sharded, each data rank its
    own scene (a (1, 2, 1) mesh a scene). Returns this rank's unmolded
    detections and launches."""
    cfg = MeshLstm256()
    eng = MaskRCNN("inference", cfg, "build")
    eng.init_weights(torch.Generator().manual_seed(3))
    images, batch, molded_shape, windows = _mesh_detect_inputs(eng, cfg)
    local = parallel_mesh.shard_batch(
        batch, parallel_mesh.batch_sharding(mesh, True))
    d = mesh.coord("data")
    reset_counts()
    with torch.no_grad():
        out = eng.model(local, mesh=mesh)
    torch.cuda.synchronize()
    launches = read_counts()
    check_variants("mesh_lstm3d", launches)
    res = eng._unmold_all(out, [images[d][0].shape], molded_shape,
                          windows[d:d + 1])[0]
    return {"scene": d, "detections": res,
            "raw": out["detections"][0].float().cpu()}, launches


class _CollectiveClock:
    """Host time inside torch.distributed's all_reduce, all_gather and
    broadcast, each call between two device synchronisations."""

    def __init__(self):
        self.ms = 0.0
        self.calls = 0

    def wrap(self, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms += (time.perf_counter() - t) * 1e3
            self.calls += 1
            return out
        return timed

    @contextlib.contextmanager
    def running(self):
        with mock.patch.multiple(
                dist, all_reduce=self.wrap(dist.all_reduce),
                all_gather=self.wrap(dist.all_gather),
                broadcast=self.wrap(dist.broadcast)):
            yield self


def _flagship_steps(cfg, ds, step_fn, model, opt):
    """(c): 3 steps, each timed on the host clock to a synchronisation,
    the peak device memory over them (reset before the first) and the
    kernels' launches; then one step more with the collectives timed.
    Returns the numbers and the launches."""
    mask = trainable_mask(model, "all")
    gen = torch.Generator(DEV).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for k in range(3):
        host = make_batch(ds, cfg, rnd_state=k)
        t = time.perf_counter()
        metrics = step_fn(model, opt, host, cfg, mask, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if not all(np.isfinite(v) for v in metrics.values()):
            raise RuntimeError(f"flagship mesh losses not finite: {metrics}")
    launches = read_counts()
    check_variants("mesh_flagship", launches)
    peak = torch.cuda.max_memory_allocated()
    clock = _CollectiveClock()
    with clock.running():
        t = time.perf_counter()
        step_fn(model, opt, make_batch(ds, cfg, rnd_state=3), cfg, mask, gen)
        torch.cuda.synchronize()
        timed_ms = (time.perf_counter() - t) * 1e3
    return {"step_ms": times, "step_ms_median": statistics.median(times),
            "peak_gb": peak / 1e9, "timed_step_ms": timed_ms,
            "collective_ms": clock.ms, "collective_calls": clock.calls,
            "collective_share": clock.ms / timed_ms,
            "losses": metrics}, launches


def _one_process_flagship(cfg, ds):
    """(c)'s one-process baseline on the same data."""
    eng = MaskRCNN("training", cfg, "build")
    opt = make_optimizer(eng.model.parameters(), cfg.LEARNING_RATE,
                         cfg.LEARNING_MOMENTUM)

    def step_fn(model, opt_, host, cfg_, mask, gen):
        return train_step(model, opt_, eng.to_device(host), cfg_, mask, gen)

    numbers, _ = _flagship_steps(cfg, ds, step_fn, eng.model, opt)
    return numbers


def _mesh_rank(rank, port, outdir):
    """A rank of phase 14: (a) the 256^2 float32 parity steps on every
    mesh, (b) the lstm3d inference on (2, 2, 1), (c) the flagship steps
    on (1, 2, 2)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not init_distributed(f"127.0.0.1:{port}", MESH_RANKS, rank,
                            backend="gloo"):
        raise RuntimeError("no process group")
    try:
        out = {"device": str(torch.cuda.current_device())}
        ref = torch.load(os.path.join(outdir, "ref_a.pt"))
        host = torch.load(os.path.join(outdir, "host_a.pt"),
                          weights_only=False)
        cfg = DP256()
        out["parity"] = [_mesh_parity_case(shape, cfg, host, ref)
                         for shape in MESH_SHAPES]
        out["planted"] = _mesh_parity_case(MESH_PLANTED, cfg, host, ref,
                                           plant=True)
        del ref
        out["detect"], out["detect_launches"] = _mesh_detect(
            parallel_mesh.make_mesh(2, 2, 1))
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        cfg = FlagshipTrainConfig()
        ds = SyntheticMultiViewDataset(num_scenes=4, num_views=2,
                                       image_size=640,
                                       num_classes=cfg.NUM_CLASSES, seed=0)
        mesh = parallel_mesh.make_mesh(1, 2, 2)
        eng = MaskRCNN("training", cfg, "build")
        opt = make_optimizer(eng.model.parameters(), cfg.LEARNING_RATE,
                             cfg.LEARNING_MOMENTUM)
        parallel_mesh.shard_state_tp(eng.model, opt, mesh)
        step_fn = parallel_mesh.make_parallel_train_step(train_step, mesh,
                                                         True)
        out["flagship"], out["flagship_launches"] = _flagship_steps(
            cfg, ds, step_fn, eng.model, opt)
        torch.save(out, os.path.join(outdir, f"mesh_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_mesh():
    """Phase 14. Returns each rank's launches of (b)'s inference and (c)'s
    flagship steps, by path."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DP256()
    ds = SyntheticMultiViewDataset(num_scenes=2, num_views=2, image_size=256,
                                   num_classes=cfg.NUM_CLASSES, seed=2)
    host = make_batch(ds, cfg, rnd_state=DP_DATA_SEED)
    out = {"label": MESH_LABEL, "card": SMI[0]}
    with tempfile.TemporaryDirectory(dir="build") as outdir:
        ref = _mesh_reference(cfg, host)
        again = _mesh_reference(cfg, host)
        floor = 1e-6 * max(float(g.abs().max()) for g in ref["grads"].values())
        out["one_process_repeat_max_grad_err"] = max(_grad_errs(
            ref["grads"], again["grads"], floor).values())
        say("mesh_reference", repeat_max_grad_err=out[
            "one_process_repeat_max_grad_err"])
        torch.save(ref, os.path.join(outdir, "ref_a.pt"))
        del ref, again
        torch.save(host, os.path.join(outdir, "host_a.pt"))
        lstm = MeshLstm256()
        eng = MaskRCNN("inference", lstm, "build")
        eng.init_weights(torch.Generator().manual_seed(3))
        images, batch, molded_shape, windows = _mesh_detect_inputs(eng, lstm)
        with torch.no_grad():
            ref_out = eng.model(batch)
        ref_dets = eng._unmold_all(ref_out, [im[0].shape for im in images],
                                   molded_shape, windows)
        ref_raw = ref_out["detections"].float().cpu()
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        flag = FlagshipTrainConfig()
        fds = SyntheticMultiViewDataset(num_scenes=4, num_views=2,
                                        image_size=640,
                                        num_classes=flag.NUM_CLASSES, seed=0)
        out["one_process"] = _one_process_flagship(flag, fds)
        del eng, ref_out, batch
        torch.cuda.empty_cache()
        ctx = multiprocessing.get_context("spawn")
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        t = time.perf_counter()
        procs = [ctx.Process(target=_mesh_rank, args=(r, port, outdir))
                 for r in range(MESH_RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=MESH_JOIN_S)
        for p in procs:
            if p.is_alive():
                p.kill()
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"mesh ranks exited "
                               f"{[p.exitcode for p in procs]}")
        out["ranks_s"] = time.perf_counter() - t
        ranks = [torch.load(os.path.join(outdir, f"mesh_{r}.pt"),
                            weights_only=False) for r in range(MESH_RANKS)]
    # (a) each mesh against one process, the ranks against each other
    failures = []
    out["parity"] = []
    for i, shape in enumerate(MESH_SHAPES):
        cases = [r["parity"][i] for r in ranks]
        case = {k: v for k, v in cases[0].items()
                if k not in ("whole", "own_split")}
        case["whole_bit_equal"] = all(c["whole"] == cases[0]["whole"]
                                      for c in cases)
        # the ranks of one data x view group hold the same slice
        model = shape[2]
        case["split_bit_equal"] = all(
            cases[r]["own_split"] == cases[r % model]["own_split"]
            for r in range(MESH_RANKS))
        case["ranks_metrics_equal"] = all(c["metrics"] == cases[0]["metrics"]
                                          for c in cases)
        case["rank_metrics"] = [c["metrics"]["loss"] for c in cases]
        case["rank_relu_flips"] = [c["relu_flip_total"] for c in cases]
        out["parity"].append(case)
        say("mesh_parity", **{k: json.dumps(v) if isinstance(v, dict)
                              else v for k, v in case.items()})
        if not (case["max_loss_err"] <= 1e-4 and case["grads_agree"]
                and case["split_updates_agree"] and case["whole_bit_equal"]
                and case["split_bit_equal"]
                and case["ranks_metrics_equal"]
                and max(case["rank_relu_flips"]) <= MESH_FLIP_MAX
                and bool(case["split_leaves"]) == (model > 1)):
            failures.append(f"mesh {shape} != one process")
    # the planted fault: refused by the flip gate or the gradient gate
    planted = [r["planted"] for r in ranks]
    flips = [c["relu_flip_total"] for c in planted]
    out["planted"] = {
        "mesh": MESH_PLANTED, "fault": "second view rank reads view 0",
        "rank_relu_flips": flips,
        "max_grad_err": max(c["max_grad_err"] for c in planted),
        "grads_beyond_1e_3": max(c["grads_beyond_1e_3"] for c in planted),
        "max_loss_err": max(c["max_loss_err"] for c in planted),
        "flip_gate_refuses": max(flips) > MESH_FLIP_MAX,
        "grad_gate_refuses": not all(c["grads_agree"] and
                                     c["split_updates_agree"]
                                     for c in planted)}
    say("mesh_planted", **{k: json.dumps(v) if isinstance(v, (list, tuple))
                           else v for k, v in out["planted"].items()})
    if not (out["planted"]["flip_gate_refuses"]
            or out["planted"]["grad_gate_refuses"]):
        failures.append("mesh: the planted sharding fault passed both gates")
    # (b) each rank's scene against the one-process detect
    out["detect"] = []
    for r, rank in enumerate(ranks):
        d = rank["detect"]["scene"]
        n_ref, n_got, matched, worst_score, worst_mask = match_detections(
            ref_dets[d], rank["detect"]["detections"])
        raw = float((rank["detect"]["raw"] - ref_raw[d]).abs().max())
        case = {"rank": r, "scene": d, "detections": n_ref,
                "mesh_detections": n_got, "matched": matched,
                "max_score_diff": worst_score,
                "min_mask_iou": float(worst_mask),
                "max_raw_detection_diff": raw,
                "launches": rank["detect_launches"]}
        out["detect"].append(case)
        say("mesh_detect", **{k: json.dumps(v) if isinstance(v, dict)
                              else v for k, v in case.items()})
        try:
            check_parity(f"mesh lstm3d rank {r}", n_ref, n_got, matched,
                         worst_score, worst_mask)
        except RuntimeError as e:
            failures.append(str(e))
        if rank["detect_launches"] != expected(unproject_view=3,
                                               reproject=3):
            failures.append(f"mesh detect launches "
                            f"{rank['detect_launches']}")
    # (c) the flagship on (1, 2, 2)
    n = 3 * 3
    want = expected(unproject=n, unproject_bwd=n, reproject=n,
                    reproject_bwd=n)
    out["flagship"] = [dict(r["flagship"], rank=i)
                       for i, r in enumerate(ranks)]
    for i, r in enumerate(ranks):
        if r["flagship_launches"] != want:
            failures.append(f"rank {i} flagship launches "
                            f"{r['flagship_launches']} != {want}")
    if any(r["flagship"]["losses"] != ranks[0]["flagship"]["losses"]
           for r in ranks):
        failures.append("flagship mesh ranks' losses differ")
    say("mesh_flagship", label=json.dumps(MESH_LABEL), card=json.dumps(SMI[0]),
        one_process=json.dumps(out["one_process"]),
        ranks=json.dumps(out["flagship"]))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"phase": "mesh", **out}), flush=True)
    if failures:
        raise RuntimeError(f"mesh phase: {failures}")
    paths = {}
    for i, r in enumerate(ranks):
        paths[f"mesh_lstm3d_rank{i}"] = r["detect_launches"]
        paths[f"mesh_flagship_rank{i}"] = r["flagship_launches"]
    return paths



def main():
    name = phase_device()
    phase_build()
    record = phase_kernels()
    paths = {"inference": phase_main(), "train": phase_train()}
    for cfg_cls in PARITY_CONFIGS:
        phase_parity(cfg_cls())
    phase_train_parity(Flagship256Train(), ("unproject", "unproject_bwd",
                                            "reproject", "reproject_bwd"))
    # the lstm3d step checks the per-view backward kernel: with the
    # backbone frozen (stage grid+), every gradient it feeds is compared,
    # and the backbone's CPU-vs-GPU ReLU flips (GRAD_TOL) stay out of it
    phase_train_parity(with_fusion(Flagship256Train, "lstm3d")(),
                       ("unproject_view", "unproject_view_bwd", "reproject",
                        "reproject_bwd"), stage="grid+")
    paths["lstm3d_inference"] = phase_lstm_main()
    paths["lstm3d_train"] = phase_lstm_train()
    paths["xformer_inference"], paths["xformer_train"] = phase_xformer()
    paths["cli_train"], paths["cli_evaluate"], paths["cli_visualize"] = \
        phase_cli()
    paths["serve"] = phase_serve(record)
    paths["bn_remat_train"], paths["trilinear_inference"] = \
        phase_train_options()
    paths.update(phase_mesh())
    paths["eval_step"] = phase_eval_step()
    paths["train_to_ap"], paths["train_to_ap_b4"] = phase_train_to_ap()
    paths.update(phase_examples())
    paths["tools"] = phase_tools()
    kernels = []
    for key in KERNELS:
        by_path = {path: counts[key] for path, counts in paths.items()}
        kernels.append({
            "name": JSON_NAMES[key], "route": "cuda",
            "source": SOURCES[key],
            "replaces": REPLACES[key],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **record[key]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
