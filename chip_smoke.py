"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:
  1. device   the card's name and power limit (nvidia-smi); fails without CUDA
  2. build    nvcc builds adaptive_stereo_tpu_torch/csrc/*.cu for sm_90a; the
              -Xptxas -v registers, shared memory and spills and the SASS
              HMMA count of kernels 2 and 4 and of the tower's kernels (no
              spills; HMMA in the bf16 instances of kernels 2 and 4 and in
              the tower's bf16 tensor-core convs and weight gradients), and
              the registers and spills of kernels 1 and 3, forward and
              backward (no spills)
  3. kernels  the launch floor (an empty kernel through the same ctypes path),
              then each kernel against its plain PyTorch version on the card
              at the serving shapes (320x1216, k=4: features (1,20,76,32),
              cost volume (1,12,20,76,32), cost (1,12,20,76)), with times by
              CUDA events: kernels 1 and 3 also at the training shape and at
              RAGGED (the scalar path, D > W) and kernel 3 at SOFT_ARGMIN_D
              (its other register instances and its loop over memory),
              kernel 1 also at CV_ODD_C and on a view off a 16-byte
              boundary (the scalar path); kernels 2 and 4 (the fused
              coarse head) in eval and train mode, f32 and bf16, kernel 4
              also against kernels 1-3
              composed, both also at the training shape (2,12,20,60) and at
              CHECK_SHAPES; kernel 2's train mode and the train-mode cuDNN
              yardsticks timed at the serving and training shapes
  4. serving  StereoDepthEngine at ServingConfig() defaults (bf16) with seeded
              random weights answers FRAMES requests; the launch counters
              show kernels 1-3 on the path. Then the same frames and weights
              at ServingConfig(fused_coarse_head=True): the counters show
              the fused head alone, the disparities agree with the default
              engine's, and an AsyncStereoDepthEngine does one round
  5. forward  each served model's forward (default and fused) against the same
              forward composed of the plain versions, on the same frame
  6. profile  device time by kernel over served frames (torch.profiler), for
              both engines
  7. tower    the refinement-tower kernels (csrc/tower.cu) at the training
              shape (2, 320, 960) and at TOWER_TAIL: the forward chain
              against tower_ref (output, x/y buffers, mu/var) in f32 and
              bf16, train and eval; the backward chain against autograd
              through tower_ref (dx0, dW, db, dgamma, dbeta), and twice on
              the same inputs in bf16 (bitwise equal); times beside the
              bound and the plain chain (cuDNN F.conv2d + the port's BN and
              LeakyReLU), whose backward is timed alone as the sum of its
              kernels' device times; each chain's launches timed one by one;
              the refinement module's device time, forward + backward,
              forward alone and backward alone, with the kernels and on the
              module path (the tower rows' library yardstick)
  8. autograd kernels 1-3 at the training shapes (batch 2, coarse 20x60):
              their forward outputs against the plain versions, f32 and
              bf16, kernel 2 in train mode; the gradients through the
              wrappers of kernels 1, 3 and 4 against the plain versions';
              the backward kernels of kernels 1 and 3 through autograd
              against their plain versions (kernel 1 bitwise in f32 and
              bf16 at the training shape, at D > W, RAGGED and CV_ODD_C
              (the scalar path in f32 too); kernel 3
              within 1e-5 (1 + max|grad|) at the training shape, RAGGED and
              SOFT_ARGMIN_D),
              and their times, one launch each, against the plain versions'
              device-time sums
  9. training the online adaptation step (engine/flat_stream.py) at bench.py's
              configuration, 320x960, k=4, bf16, with fused_siamese and
              fused_tower, from seeded random weights: STEPS adapt steps
              (median ms/step, launches per step, the ring log's
              decisions), a done and a validate step; the same steps with
              fused_tower=False (the cuDNN yardstick); one step with the
              kernels against one with the plain versions from the same
              state, on two frames, per module, beside a control (a plain
              step on another frame); device time by kernel over a few steps;
              every adapt step launches the backward kernels of kernels 1
              and 3 exactly once each; launches and host operators a step
 10. driver   the streaming adaptation driver (engine/stream_driver.py,
              adapt --engine flat) on synthetic datasets written by the
              port's generator at 320x960 (two spawned processes write them
              while phases 3-9 run) from seeded random weights saved with
              save_variables; first the host's decode time of one frame's
              PNG. Run A at bench.py's step settings (k=4, bf16, fused
              siamese, the tower, VS+ER, fused ER forward, uint8 frames,
              done_batch 4, lr 5e-5, clip) with all four guard channels
              over two epochs; the saved stream state of its last step
              loads bit for bit (the reservoir's generator included) and a
              run resumed from its middle checkpoint reaches the same step
              count; run B with the left-right loss (the batch-3 forward);
              then `adapt --engine flat` through cli.main. Fails unless
              runs A, resumed A and B each launched kernels 1, 2, 3 and 5
              and the backward kernels of 1 and 3 and never kernel 4, and
              the command line's run launched kernels 1, 2 and 3 and the
              two backward kernels and neither kernel 4 nor 5 (its parser,
              like the JAX package's, has no flag for s2d_refinement, so
              it takes the refinement module path); an adapt step, a
              batched done step and a validation ran, the ring log is
              finite and trials.csv has its rows. Prints steps/s and the
              median interval between adapt steps inside the driver beside
              phase 9's bare step (the driver's own host overhead), with
              its parts on the loop's thread
 11. classic  train / the classic engine / evaluate / timing at 320x960 on
              phase 10's novel domain and a 16 + 2 frame training domain
              (a third spawned writer): (b) each kernel call of one
              train-mode forward and backward of the bf16 model (fused
              siamese, tower) at batch 8 against its plain version on the
              recorded inputs, with phase 8's bands (the tower with phase
              7's), and the step's outputs and per-module gradients
              against the plain versions' (printed); the same per call for
              the f32 train step at batch 8 of the command line, one
              classic-engine step at batch 1 (stream and replay) and the
              f32 eval forward at batch 2 of evaluate; (c) train(cfg) at
              training_config's settings (bf16, fused siamese, tower, two
              epochs, the learning rate halved each epoch), its checkpoint
              loaded back bit for bit; (d) the bare train step at batch 8:
              median ms/step of BARE_TRAIN_STEPS, launches per step,
              device time by kernel, busy share, host operators; (e)
              adapt(cfg), the classic engine, at adaptation_config's
              settings (VS+ER, reservoir 4, validation every 4 steps, 12
              steps) from (c)'s checkpoint, and its interval between steps;
              (f) cli.main for train (f32), adapt (classic), evaluate eval
              and playback and timing at its defaults. Each run (each
              command of (f) on its own) resets the launch counts and fails
              unless kernels 1, 2, 3 and 5 and both backward kernels
              launched and kernel 4 did not (the command line: train, adapt
              and timing 1-3 and the backward kernels; evaluate 1-3 and no
              backward kernel; none of them 4 or 5)
 12. rest     the rest of the single-card surface: (a) the native host
              library (data/native.py) built, its voxel grid against the
              numpy plain version on the points of one of phase 4's served
              frames (the same voxel count and rows within 1e-6 on the
              points away from voxel faces), both timed on the host, and
              serving p50 with each grid in turns; (b) the pytree engine
              (the flat engine with the replay frame as a second forward):
              PYTREE_STEPS bare adapt steps (launches per step), one step
              with the kernels against the same step on the plain versions
              in bf16 and float32 within STEP_LIMITS (a control, a plain
              step on another frame, outside them), then
              adapt_streaming(engine="pytree") on phase 10's data; (c) the
              flat driver with device_cache=True and with the uint8
              upload path, deterministic cuDNN: every step's inputs, the
              ring log and the parameters bitwise equal; the cache's
              bytes; (d) train_autoencoder on the
              card, the threshold at the median of its scores on the novel
              stream, then the classic engine gated by the reconstruction
              error (both branches must fire); (e) compute_fcs_for_loader
              on both domains and derive_percentile_threshold. Each run
              fails unless kernels 1, 2, 3 and 5 and both backward kernels
              launched and kernel 4 did not (the OOD analysis: no backward
              kernel)
 13. fleet    the fleet and data-parallel layer (parallel/) at phase 9's
              configuration (320x960, k=4, bf16, fused siamese, the tower,
              VS+ER, ood_threshold 12.76, lr 5e-5, clip) on the one-rank
              NCCL group make_mesh starts: (a) make_fleet_fwd_bwd's
              per-stream gradients and FCS at N=2 against
              make_adapt_forward_backward on each stream alone (JAX's
              --certify bands, rtol 5e-3, atol 1e-5); (b) one fused fleet
              step at N=2 with the kernels against the same step on the
              plain versions, per module, in both bn_modes, bf16 and
              float32, within FLEET_STEP_LIMITS, a control (a plain step
              on other frames) outside them; then every kernel call of one
              bf16 shared-mode step (the merged forwards at batch N) at
              N=2 and N=4 against its plain version on that call's own
              inputs (check_kernel_calls); (c) every stream DONE, or
              every frame diverted, leaves the parameters, Adam moments
              and count bitwise unchanged, a mixed mask moves them, and
              remat=True gives the same bits as remat=False; (d)
              N = 1, 2, 4 in both modes: median ms per fleet step of
              FLEET_STEPS after WARMUP_STEPS and per stream, device time
              and busy share, peak memory, launches and all_reduces per
              step; (e) fleet_adapt, 4 streams on phase 10's novel domain
              (reservoir 2, validation every 2 steps); (f)
              make_parallel_train_step at batch 8 and one rank bit for bit
              against make_train_step (deterministic cuDNN); (g) two
              spawned ranks of a gloo group on the card (NCCL refuses two
              ranks on one device), one stream each, two per-stream steps
              against the same steps on one rank. Fails unless every fleet
              run launched kernels 1, 2, 3 and 5 and both backward kernels
              and never kernel 4
 14. analysis save_cost_volumes, flops and a trace, run_adaptation_suite
              with its results, plots and event files, the OOD plots
              (analysis_phase)
 15. paper    JPEG frames and the paper protocol's runners
              (adaptive_stereo_tpu_torch/scripts/, paper_phase): (a) the
              seeded JPEG_FRAME_SHAPE frame encoded by the port at
              JPEG_QUALITY 4:2:0 decodes to the pixels whose SHA-256 is
              JPEG_FRAME_SHA256 (the CPU tests hold the same bytes against
              cv2); decode_jpeg and read_png of the frame timed on the
              host; (b) make_readiness_minidata's datasets (PAPER_FRAMES a
              split at PAPER_FRAME_SHAPE, written by a spawned process while
              phases 3-14 run) through run_paper_suite over
              PAPER_ENVIRONMENTS, 4 methods x PAPER_STEPS at 320x960: each
              method writes trials.csv and launches kernels 1-3 and both
              backward kernels, never 4 or 5; the interval between adapt
              steps on JPEG data; every kernel call of one adapt step on
              those JPEG frames against its plain version
              (check_kernel_calls); (c) run_paper_scale_synth with
              SYNTH_FLAGS through phase 4 (pretraining with bench's
              model): the tower's chains 15 + 31 launches a train step in
              pretraining and in the bench suite, none in faithful; (d)
              synthetic_pipeline_demo at its defaults: results.csv and
              both plots
 16. study    the GT-free guard study and what it needs (study_phase): (a)
              EXIF Orientation 1-8 in both TIFF byte orders spliced into
              phase 15's JPEG frame, a PNG of it (_load_rgb) and a 16-bit
              depth PNG (load_disp_vkitti), each read equal to numpy's
              transform of the untagged read (the CPU tests tie the reads
              to cv2); (b) the progressive JPEGs of tests/data/jpeg/
              hash to PROGRESSIVE_JPEGS (cv2's pixels), the KITTI-size one
              timed on the host beside the baseline decode of the same
              frame; (c) the tower's eval-mode backward chain against
              autograd through tower_ref in eval mode at (2, 320, 960) and
              TOWER_TAIL, f32 on the plain chain's buffers and bf16 end to
              end through tower_cuda, with phase 7's bands, 31 launches a
              chain, timed by CUDA events at the probe's call (1, 320, 960)
              f32 and at (2, 320, 960) bf16 beside the plain backward and
              the module path's; (d) run_gtfree_guard_study with
              STUDY_FLAGS at 320x960 on phase 15 (c)'s datasets, weights
              and threshold, deterministic cuDNN: two CSV rows a config,
              31 eval-mode tower backward launches (and 16 forward) a
              probe for fused and vser, no tower launch in faithful, and
              the fused run bitwise equal to the same adapt_streaming call
              without the hook

The last two lines are the card's name and power limit, then
{"ok": true, "device": {...}}; the line before them holds the kernel table,
whose "launches" count the served frames of phase 4 (kernels 1-4), the
adapt steps of phase 9 (the tower) or phase 16's probes (the tower's
eval-mode backward chain, "tower_backward_eval"), "train_launches" the adapt steps of
phase 9 for every kernel, "train11_launches" the launches per bare
train step at batch 8 of phase 11, "pytree_launches" (with
"backward_pytree_launches") those per bare pytree adapt step of phase 12
and "fleet_launches" (with "backward_fleet_launches") those per fused
fleet step at N=4 of phase 13, in each bn_mode;
"floor_ms" is the launch floor, and the rows
of kernels 1 and 3 also carry their backward kernel's time, plain
version's time, bound and launches over the adapt steps of phase 9.
Float32 references run with TF32 off (cudnn.allow_tf32 and
cuda.matmul.allow_tf32 both False), set at the start.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import json
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): the bound of a
# kernel is max(bytes / HBM rate, operations / peak rate for their type).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16_tensor": 989e12, "f32_cuda_core": 67e12}

AGG_BF16_ABS, AGG_BF16_REL = 0.05, 0.05   # PERFORMANCE.md:80 bf16 band
AGG_F32_ABS = 1e-3
DISP_ABS = 1e-5
# Kernels 2 and 4 are also checked at the coarse shape of the adapt step,
# (B, D, H, W) = (2, 12, 20, 60), and where their row tiles can break: a
# tail in every dimension (W = 7 fills 7 of the 16 rows of a GEMM tile,
# D = 3 and H = 5 put most rows at the zero padding) and a width that
# tile_plan splits (W = 300: four row tiles of 75).
TRAIN_COARSE = (2, 12, 20, 60)
CHECK_SHAPES = ((2, 3, 5, 7), (1, 12, 3, 300))
# The tower is also checked where its 8x16 pixel tiles leave a tail in H and
# in W (37 = 4 x 8 + 5, 53 = 3 x 16 + 5).
TOWER_TAIL = (1, 37, 53)
# Kernels 1 and 3 are also checked where their paths split: features (B, H,
# W, C) and D with D > W (every slice from d = W on is zero) whose bf16 rows
# (C * 2 = 8 bytes) take the scalar path, and kernel 3 at the two other D it
# holds in registers (6, 24) and at D it does not (3, 40: the loop over
# memory).
RAGGED = ((2, 5, 7, 4), 9)
SOFT_ARGMIN_D = (3, 6, 24, 40)
# Kernel 1's backward is also checked at D > W with 16-byte chunks, and
# both of its directions at a C whose rows take the scalar path in f32 too.
CV_WIDE_D = ((1, 3, 5, 32), 9)
CV_ODD_C = ((2, 5, 7, 3), 9)
# The adapt step before kernels 1 and 3 had backward kernels (PERF.md §5).
STEP_LAUNCHES_BEFORE, STEP_OPERATORS_BEFORE = 1474, 9928
FRAMES = 8  # served frames in phase 4, by each engine
STEPS = 20  # timed adapt steps in phase 9, after WARMUP_STEPS
WARMUP_STEPS = 3
LR = 5e-5
# Phase 10: the synthetic datasets of the driver's runs (train, val frames).
DRIVER_SHAPE = (320, 960)
DRIVER_FRAMES = (12, 2)  # novel-domain stream (domain_shift=True)
REPLAY_FRAMES = (4, 2)   # training-domain replay and train-val set
# Phase 11: the training domain of `train` (and the classic engine's replay
# and train-val set), 16 + 2 frames at DRIVER_SHAPE; the classic engine's
# stream is phase 10's novel domain. The batch of the training
# configuration (adaptive_stereo_tpu_torch/experiments.py training_config).
TRAIN_FRAMES = (16, 2)
TRAIN_BATCH = 8
BARE_TRAIN_STEPS = 10    # timed bare train steps, after WARMUP_STEPS
PYTREE_STEPS = 5         # phase 12: counted bare pytree adapt steps, after WARMUP_STEPS
# Phase 14: cost volumes of CV_FRAMES synthetic frames at phase 4's serving
# input CV_SHAPE (a dataset a fourth spawned writer makes while phases 3-9
# run); the adaptation suite cut to SUITE_STEPS steps a method; the kernels
# a trace of served frames must name.
CV_FRAMES = 5
CV_SHAPE = (320, 1216)
SUITE_STEPS = 4
PROFILE_ITERS = {"forward": 20, "step": 10}
TRACE_KERNELS = ("cost_volume_kernel", "conv3d_layer_kernel", "soft_argmin_fcs_kernel")
# Phase 15: the paper protocol's runners. The JPEG frame of (a) at KITTI's
# size, encoded at JPEG_QUALITY 4:2:0 by the port and decoded again, hashes to
# JPEG_FRAME_SHA256 (tests/test_torch_jpeg.py holds those bytes against cv2);
# the drill's frames (PAPER_FRAMES a split, at PAPER_FRAME_SHAPE), its
# environments and steps; the paper-scale run's flags.
JPEG_FRAME_SHAPE = (375, 1242)
JPEG_QUALITY = 95
JPEG_FRAME_SHA256 = "5a47dc24f64049f5a33f5945f1c1fb0dd17b13f037fa4d3d55f911624881da55"
JPEG_DECODES = 20
# Phase 16 (b): progressive JPEGs written by cv2 (IMWRITE_JPEG_PROGRESSIVE)
# and committed under tests/data/jpeg/, each with the SHA-256 of cv2's
# decode (tests/test_torch_image_reads.py holds the files against cv2):
# phase 15's frame at 4:2:0 quality 95 (the pixels of JPEG_FRAME_SHA256), an
# odd-sized gray file and a 4:4:4 file with a restart interval of 2 MCUs.
PROGRESSIVE_JPEGS = {
    "frame_375x1242_420_q95_progressive.jpg":
        "5a47dc24f64049f5a33f5945f1c1fb0dd17b13f037fa4d3d55f911624881da55",
    "gray_37x53_q90_progressive.jpg":
        "da4fe283cb096eb2c592a81295b5af39e0bb17dd71809a0200797a88257f916b",
    "rgb_61x83_444_q85_rst2_progressive.jpg":
        "384d087962022fbe7279c5dd3a0edb4f66ff28f6ad5958b83eaebdb2e93a8f64",
}
PAPER_FRAME_SHAPE = (375, 1242)
PAPER_FRAMES = 12
PAPER_ENVIRONMENTS = ("flying_to_vk01", "clone_to_campus")
PAPER_STEPS = 8
SYNTH_FLAGS = ("--configs", "faithful", "bench", "--n_train", "8", "--n_val", "2",
               "--n_novel", "16", "--pretrain_steps", "10", "--adapt_steps", "8",
               "--eval_hz", "4")


def jpeg_frame(seed: int = 0, shape=JPEG_FRAME_SHAPE) -> np.ndarray:
    """A seeded (H, W, 3) uint8 frame in integer arithmetic only (so every
    host and numpy version makes the same bytes): 8x8-pixel random colour
    cells, box-blurred over 9x9 pixels, plus noise in [-6, 6]."""
    h, w = shape
    rng = np.random.RandomState(seed)
    cells = rng.randint(0, 256, size=(h // 8 + 3, w // 8 + 3, 3)).astype(np.int64)
    img = np.repeat(np.repeat(cells, 8, axis=0), 8, axis=1)[:h + 8, :w + 8]
    c = np.cumsum(np.cumsum(np.pad(img, ((1, 0), (1, 0), (0, 0))), axis=0), axis=1)
    box = (c[9:, 9:] - c[:-9, 9:] - c[9:, :-9] + c[:-9, :-9])[:h, :w] // 81
    return np.clip(box + rng.randint(-6, 7, size=(h, w, 3)), 0, 255).astype(np.uint8)


# Values a later phase reads: phase 10's intervals between adapt steps,
# phase 12's FCS of both domains.
CARRY = {}
# Tower, f32 (phase 7): outputs and buffers within 1e-3 + 1e-4 |ref|, mu/var
# within 1e-4 + 1e-4 |ref| (float32 sums in other orders; 1.3e-4 was
# measured on an H100 at |ref| = 93). bf16: the kernel chain's error against
# the f32 chain on the same bf16 inputs, in max and in mean, at most
# TOWER_BF16_FACTOR times the plain bf16 chain's own error. Backward with
# the plain version's buffers, f32: each gradient within TOWER_F32_GRAD_L2
# of the plain autograd's in relative L2 norm; bf16 end to end: within
# TOWER_BF16_FACTOR times the plain bf16 autograd's relative L2 error
# against f32, plus TOWER_F32_GRAD_L2. db of layers 0-6 is 0 in exact
# arithmetic (the BatchNorm after it removes a bias): it is held to
# 1e-4 of the largest gradient instead.
TOWER_BF16_FACTOR = 2.0
TOWER_F32_GRAD_L2 = 1e-3
# Training step, kernels vs plain versions from one state, phase 9, in
# bf16 and in float32: relative differences of the Monodepth and replay
# losses and of the stereo-net gradient norm; per module (feature net,
# aggregation, tower) the relative L2 difference of the gradients ("grad")
# and the median |theta_kernels - theta_plain| over the median update
# ("param"). Each limit is the geometric mean, rounded, of the largest sound
# reading and the smallest control reading (a plain step on another frame)
# of the chip runs on an H100 in PERF.md (PR 7: three in bf16, two in
# float32), and the control must fall outside it. A reading without a limit
# is printed only: the gradient norm's, and the bf16 Monodepth loss's,
# smallest control reading was less than 3x their largest sound reading.
STEP_LIMITS = {
    "bfloat16": {"replay": 1.8e-3, "feature grad": 0.59, "aggregation grad": 0.12,
                 "tower grad": 0.085, "feature param": 0.069, "aggregation param": 0.015,
                 "tower param": 0.033},
    "float32": {"mono": 1e-5, "replay": 2.7e-5, "feature grad": 0.079,
                "aggregation grad": 0.016, "tower grad": 0.013, "feature param": 8.9e-3,
                "aggregation param": 2.0e-3, "tower param": 3.7e-3},
}
# Phase 12's pytree step (the replay frame a second forward) is held to
# STEP_LIMITS with these overrides, each the geometric mean, rounded down,
# of its sound and control readings (one frame each) on an H100 where that
# is tighter: there a control on another frame read 0.059 for the bf16
# tower gradient, within phase 9's 0.085 (PERF.md).
PYTREE_STEP_LIMITS = {
    "bfloat16": {"tower grad": 0.025, "tower param": 0.022},
    "float32": {"aggregation param": 1.7e-3, "tower grad": 3.4e-3, "tower param": 2.3e-3},
}

# Whole forward, kernels vs plain, bf16. If every aggregated cost entry
# agrees within e, FCS = m1 - (sum - m1 - m2) / (D - 2) agrees within
# e * (1 + (D + 2) / (D - 2)), so FCS gets that multiple of the band
# (2.4 at D = 12). The coarse and refined disparities, in full-resolution
# pixels, get 1 px + 2 %: the two paths round the aggregated cost to bf16 at different
# points (the kernel adds the conv bias before rounding, cuDNN after), which
# moves the soft-argmin by a small fraction of a coarse pixel.
DISP0_ABS_PX, DISP0_REL = 1.0, 0.02


def fcs_band_factor(num_disp: int) -> float:
    return 1 + (num_disp + 2) / (num_disp - 2)


def log(msg: str) -> None:
    print(msg, flush=True)


def conv_kernel_report(path) -> None:
    """Log registers, shared memory and spills (nvcc -Xptxas -v) and the
    HMMA count of the SASS (cuobjdump -sass) of kernels 2 and 4, which share
    the conv body of csrc/conv3d.cuh, and of every kernel of the tower
    (csrc/tower.cu). Fails if one spills, if a bfloat16 instance of kernels
    2 and 4 has no HMMA, or if one of the tower's six bf16 tensor-core
    instances (tower_conv_mma_kernel for 32, 4 and 1 output channels,
    tower_wgrad_mma_kernel for layers 1-6, 7 and 0) has none: its product
    does not run on the tensor cores. Also reads the instances of kernels 1
    and 3, forward and backward (one line a kernel: instances, registers,
    spills), and fails if one of the four is missing or an instance
    spills."""
    import re
    from pathlib import Path

    from adaptive_stereo_tpu_torch.ops.cuda import _build

    conv3d = ("conv3d_layer_kernel", "coarse_head_kernel")
    small = ("cost_volume_kernel", "cost_volume_backward_kernel", "soft_argmin_fcs_kernel",
             "soft_argmin_backward_kernel")
    names = conv3d + ("tower_",) + small
    ptxas, current = {}, None
    for line in _build.ptxas_report_path().read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1) if any(n in m.group(1) for n in names) else None
            if current:
                ptxas[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            ptxas[current]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            ptxas[current]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            ptxas[current]["static_smem"] = int(m.group(1)) if m else 0
    sass = subprocess.run([str(Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass",
                           str(path)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    hmma, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            hmma[current] = 0
        elif current is not None and "HMMA" in line:
            hmma[current] += 1
    n_conv3d = sum(any(n in name for n in conv3d) for name in ptxas)
    n_mma = sum("mma_kernel" in name for name in ptxas)
    if n_conv3d != 6 or n_mma != 6:
        raise AssertionError(f"expected 6 conv3d kernel instances and the tower's 6 tensor-core "
                             f"instances in the ptxas report: {sorted(ptxas)}")
    failed = []
    for kernel in small:
        # Mangled names carry the length of the name first: 18cost_volume_kernel.
        tag = f"{len(kernel)}{kernel}"
        found = {n: i for n, i in ptxas.items() if tag in n}
        spill = sum(i.get("spill", 1) for i in found.values())
        regs = [i.get("registers") or 0 for i in found.values()]
        log(f"[build] {kernel}: {len(found)} instances, registers {min(regs, default=0)}-"
            f"{max(regs, default=0)}, spill {spill} bytes")
        if not found or spill:
            failed.append(f"{kernel}: {len(found)} instances, spill {spill} bytes")
    for name, info in sorted(ptxas.items()):
        if any(f"{len(k)}{k}" in name for k in small):
            continue
        count = hmma.get(name, 0)
        log(f"[build] {name}: {info.get('registers')} registers, {info.get('static_smem')} "
            f"bytes static smem (+ dynamic staging), spill {info.get('spill')} bytes, HMMA "
            f"{count}")
        if info.get("spill") != 0:
            failed.append(f"{name} spills")
        tensor_core = "mma_kernel" in name or (
            "bfloat16" in name and any(n in name for n in conv3d))
        if tensor_core and count == 0:
            failed.append(f"{name} has no HMMA")
    if failed:
        raise AssertionError("; ".join(failed))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# A sleep kernel of at least this many cycles (about 50 ms at the H100's
# clocks) holds the device while the host enqueues the calls that are timed.
SLEEP_CYCLES = 100_000_000


class Timing:
    """Device time per call (ms), the host's enqueue time per call (ms), and
    whether the host stayed ahead of the device in every round."""

    def __init__(self, ms: float, host_ms: float, host_ahead: bool):
        self.ms, self.host_ms, self.host_ahead = ms, host_ms, host_ahead

    def __str__(self):
        flag = "" if self.host_ahead else ", HOST-BOUND: includes launch gaps"
        return f"{self.ms:.4f} ms (host {self.host_ms:.4f} ms/call{flag})"


def time_ms(fn, calls: int = 10, rounds: int = 5, warmup: int = 3) -> Timing:
    """Device time per call of fn(), the median of `rounds` rounds.

    In each round a sleep kernel holds the device while the host enqueues
    `calls` calls between two CUDA events, so the events measure the calls'
    device work back to back, not the host's launch rate. A round in which
    the device reached the first event before the host had enqueued
    everything is run again with a longer sleep, up to three times; after
    that (a call that waits for the device) rounds still count, but the
    result is flagged host-bound: it then includes the gaps between
    launches. `calls` stays small because the host also stalls once about
    a thousand launches are pending (the plain aggregation makes about 60
    per call). Inputs stay in the 50 MB L2, as on the serving path, where
    each stage's input was just written by the stage before.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    sleep = SLEEP_CYCLES
    per_call, host, ahead = [], [], True
    retries = 3
    while len(per_call) < rounds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        behind = start.query()
        end.synchronize()
        if behind and retries:
            # Sleep for twice this round's enqueue time (2e6 cycles per ms
            # at the H100's ~2 GHz) and run the round again.
            retries -= 1
            sleep = max(2 * sleep, int(2 * host_ms * 2e6))
            continue
        ahead = ahead and not behind
        host.append(host_ms / calls)
        per_call.append(start.elapsed_time(end) / calls)
    return Timing(statistics.median(per_call), statistics.median(host), ahead)


def device_profile(fn, repeats: int):
    """torch.profiler over `repeats` calls of fn(): (the profiler, the wall
    time in us, [(device us, calls, name)] of every kernel, copy and memset
    that took device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_name = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            per_name.append((dev_us, evt.count, evt.key))
    return prof, wall_us, per_name


def device_ms(fn, repeats: int = 3, warmup: int = 2) -> float:
    """Device time per call of fn() (ms), the sum of its kernels' times from
    torch.profiler: no launch gaps, whether or not the host keeps ahead."""
    for _ in range(warmup):
        fn()
    per_name = device_profile(fn, repeats)[2]
    total = sum(t for t, _, _ in per_name)
    if total == 0:
        raise AssertionError("torch.profiler recorded no device time")
    return total / repeats / 1e3


def launch_times(fn):
    """[(kernel name, device us)] of one call of fn(), in launch order, from
    torch.profiler."""
    from torch.autograd import DeviceType

    fn()
    prof = device_profile(fn, 1)[0]
    evts = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    short = lambda n: n.split("(")[0].replace("void ", "")
    return [(short(e.name), e.time_range.end - e.time_range.start) for e in evts]


def cv_path(c: int, *tensors: torch.Tensor) -> str:
    """The path the cost-volume entry points pick for these tensors (the
    rule of vec_ok in csrc/cost_volume.cu): 16-byte chunks when C * itemsize
    is a multiple of 16 and every pointer is on a 16-byte boundary, else
    the scalar path."""
    chunks = c * tensors[0].element_size() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)
    return "16-byte" if chunks else "scalar"


def profile_breakdown(fn, repeats: int = 3, top: int = 12, unit: str = "frame",
                      host_top: int = 0) -> None:
    """Print device time by kernel name over `repeats` calls of fn() and the
    device's busy share of the wall time, from torch.profiler; with
    host_top, also the host's operator count and its largest self CPU
    times (inflated by the profiler's own cost per operator). Returns the
    host operators, the kernel launches (cudaLaunchKernel calls) and the
    device ms per call of fn(), and the device's busy share of the wall
    time in % (all None without device time)."""
    from torch.autograd import DeviceType

    prof, wall_us, per_name = device_profile(fn, repeats)
    total = sum(t for t, _, _ in per_name)
    if total == 0:
        log("[profile] torch.profiler recorded no device time")
        return None, None, None, None
    log(f"[profile] {repeats} {unit}s: wall {wall_us / repeats / 1e3:.3f} ms/{unit}, device "
        f"busy {total / repeats / 1e3:.3f} ms/{unit} ({100 * total / wall_us:.1f}% of wall)")
    log(f"[profile]   {sum(c for _, c, _ in per_name) / repeats:.0f} device calls/{unit}")
    for dev_us, count, name in sorted(per_name, reverse=True)[:top]:
        log(f"[profile]   {dev_us / repeats / 1e3:8.4f} ms/{unit}  {count // repeats:4d} "
            f"calls/{unit}  {100 * dev_us / total:5.1f}%  {name[:90]}")
    if host_top:
        host = [(evt.self_cpu_time_total, evt.count, evt.key) for evt in prof.key_averages()
                if evt.device_type == DeviceType.CPU]
        log(f"[profile] host: {sum(c for _, c, _ in host) / repeats:.0f} operators/{unit}, "
            f"self CPU {sum(t for t, _, _ in host) / repeats / 1e3:.3f} ms/{unit}")
        for cpu_us, count, name in sorted(host, reverse=True)[:host_top]:
            log(f"[profile]   {cpu_us / repeats / 1e3:8.4f} ms/{unit}  {count // repeats:4d} "
                f"calls/{unit}  {name[:90]}")
    host = [evt for evt in prof.key_averages() if evt.device_type == DeviceType.CPU]
    return (sum(evt.count for evt in host) / repeats,
            sum(evt.count for evt in host if evt.key == "cudaLaunchKernel") / repeats,
            total / repeats / 1e3, 100 * total / wall_us)


def bound(nbytes: float, ops: float, op_type: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[op_type]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def launch_floor() -> Timing:
    """Device time per launch of an empty kernel (stereo_noop) through the
    same ctypes path as the wrappers: the least a launch-bound kernel can
    take on this card, beside each kernel's bound."""
    from adaptive_stereo_tpu_torch.ops.cuda import _build

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    floor = time_ms(lambda: _build.check(lib.stereo_noop(stream), "stereo_noop"))
    log(f"[kernels] launch floor, an empty kernel through the wrappers' ctypes path: {floor}")
    return floor


def soft_argmin_shapes(num_disp, h, w):
    """The costs (B, D, H, W) kernel 3 is checked at: the serving shape
    first, the training shape, RAGGED and SOFT_ARGMIN_D."""
    (rb, rh, rw, _), rd = RAGGED
    return [(1, num_disp, h, w), TRAIN_COARSE, (rb, rd, rh, rw)] + [
        (rb, d, rh, rw) for d in SOFT_ARGMIN_D]


def kernel_row(name, source, replaces, wrapper, per_frame, max_abs_err, kernel_fn,
               plain_fn, library_fn, nbytes, ops, op_type, note, floor=None):
    """Time a kernel, its plain version and (if any) the library call; log
    them with the bound (and the launch floor, if given); return the
    kernel's row of the table."""
    kern, plain = time_ms(kernel_fn), time_ms(plain_fn)
    lib = time_ms(library_fn) if library_fn is not None else None
    b_ms, b_by = bound(nbytes, ops, op_type)
    log(f"[kernels] {name} {note}: kernel {kern}; plain {plain}; library "
        f"{lib if lib is not None else '-'}; bound {b_ms:.5f} ms ({b_by})"
        + (f"; launch floor {floor.ms:.4f} ms" if floor is not None else ""))
    return dict(name=name, route="cuda", source=f"adaptive_stereo_tpu_torch/csrc/{source}",
                replaces=f"adaptive_stereo_tpu/ops/pallas/{replaces}", wrapper=wrapper,
                per_frame=per_frame, max_abs_err=max_abs_err, ms=kern.ms, plain_ms=plain.ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None if lib is None else lib.ms)


def library_aggregation(cost, params, run_stats, train=False, eps=1e-5):
    """cuDNN yardstick: F.conv3d + F.batch_norm + F.leaky_relu per layer on
    NCDHW (train: batch statistics, no running update), timed here only;
    the port never calls it."""
    dt = cost.dtype
    x = cost.permute(0, 4, 1, 2, 3)
    for i in range(4):
        w = params["kernels"][i].permute(4, 3, 0, 1, 2).to(dt)
        x = F.conv3d(x, w, params["biases"][i].to(dt), padding=1)
        stats = (None, None) if train else (run_stats[0][i], run_stats[1][i])
        x = F.batch_norm(x, *stats, params["scales"][i], params["bn_biases"][i], train, 0.0,
                         eps)
        x = F.leaky_relu(x, 0.2)
    w = params["final_kernel"].permute(4, 3, 0, 1, 2).to(dt)
    return F.conv3d(x, w, params["final_bias"].to(dt), padding=1)[:, 0]


def check_aggregation(cost, params, run_stats, train):
    """Kernel 2 against its plain version on one cost volume: out (and in
    train mode mu/var) within the aggregation band of its dtype. Returns the
    max abs error of out."""
    from adaptive_stereo_tpu_torch.ops.cuda import (aggregate_cost_volume_cuda,
                                                    aggregate_cost_volume_ref)

    dt = cost.dtype
    got = aggregate_cost_volume_cuda(cost, params, run_stats, train=train)
    want = aggregate_cost_volume_ref(cost, params, run_stats, train=train)
    torch.cuda.synchronize()
    names = ("out", "mu", "var") if train else ("out",)
    checked = [(n, *agg_band_err(g, r, dt)) for n, g, r in zip(names, got, want)]
    log(f"[kernels] aggregation {'train' if train else 'eval'} {tuple(cost.shape)} {dt}: max "
        "abs err " + ", ".join(f"{n} {e:.3g}" for n, e, _ in checked)
        + f" (|ref| max {want[0].float().abs().max().item():.3g})")
    if not all(ok for _, _, ok in checked):
        raise AssertionError(f"aggregation train={train} {tuple(cost.shape)} {dt}: outside "
                             f"tolerance, {checked}")
    return checked[0][1]


def check_head(fl, fr, params, run_stats, train, num_disp, k):
    """Kernel 4 on one pair of feature maps. Against the plain version:
    disparity (coarse pixels) within DISP0_ABS_PX / 2^k + DISP0_REL |ref|,
    FCS within fcs_band_factor x the aggregation band, mu/var within the
    aggregation band. Against kernels 1-3 composed: disparity and FCS within
    DISP_ABS, mu/var equal (the same arithmetic over the same row tiles).
    Returns the larger max abs error of disparity and FCS against plain."""
    from adaptive_stereo_tpu_torch.ops.cuda import (
        aggregate_cost_volume_cuda, coarse_head_cuda, coarse_head_ref,
        difference_cost_volume_cuda, soft_argmin_fcs_cuda)

    dt = fl.dtype
    got = coarse_head_cuda(fl, fr, params, run_stats, train, num_disp)
    want = coarse_head_ref(fl, fr, params, run_stats, train, num_disp)
    agg, mu, var = aggregate_cost_volume_cuda(
        difference_cost_volume_cuda(fl, fr, num_disp), params, run_stats, train)
    comp = (*soft_argmin_fcs_cuda(agg.float()), mu, var)
    torch.cuda.synchronize()
    d_diff = (got[0] - want[0]).abs()
    d_ok = bool((d_diff <= DISP0_ABS_PX / 2 ** k + DISP0_REL * want[0].abs()).all())
    f_err, f_ok = agg_band_err(got[1], want[1], dt, fcs_band_factor(num_disp))
    stats = [agg_band_err(g, r, dt) for g, r in zip(got[2:], want[2:])]
    comp_err = max((got[i] - comp[i]).abs().max().item() for i in (0, 1))
    comp_stats = all(torch.equal(got[i], comp[i]) for i in (2, 3))
    mode = "train" if train else "eval"
    label = f"{mode} features {tuple(fl.shape)} D={num_disp} {dt}"
    log(f"[kernels] coarse_head {label}: vs plain disp {d_diff.max().item():.3g} "
        f"(|ref| max {want[0].abs().max().item():.3g}), fcs {f_err:.3g} "
        f"(|ref| max {want[1].abs().max().item():.3g}), mu {stats[0][0]:.3g}, "
        f"var {stats[1][0]:.3g}; vs kernels 1-3 disp/fcs {comp_err:.3g}, "
        f"mu/var equal {comp_stats}")
    if not (d_ok and f_ok and all(ok for _, ok in stats)):
        raise AssertionError(f"coarse head {label}: outside tolerance of plain")
    if comp_err > DISP_ABS or not comp_stats:
        raise AssertionError(f"coarse head {label}: disagrees with kernels 1-3")
    return max(d_diff.max().item(), f_err)


def agg_band_err(got, want, dt, factor=1.0):
    """Max abs error of got against want, and whether every entry is within
    factor times the aggregation band of dt (bf16: 0.05 + 0.05|ref|; f32:
    1e-3 with TF32 off)."""
    diff = (got.float() - want.float()).abs()
    if dt == torch.bfloat16:
        ok = bool((diff <= factor * (AGG_BF16_ABS + AGG_BF16_REL * want.float().abs())).all())
    else:
        ok = bool((diff <= factor * AGG_F32_ABS).all())
    return diff.max().item(), ok


def serve(engine, frames, wrappers):
    """Serve the frames through engine.process with every launch counter set
    to 0 just before; return (results, latencies ms, forward ms, launches)."""
    for wrapper in wrappers:
        wrapper.launches = 0
    lat, fwd, results = [], [], []
    for i, (left, right) in enumerate(frames):
        t0 = time.perf_counter()
        res = engine.process(left, right, timestamp=float(i))
        lat.append((time.perf_counter() - t0) * 1e3)
        fwd.append(engine.last_inference_sec * 1e3)
        results.append(res)
    launches = [wrapper.launches for wrapper in wrappers]
    for res in results:
        if res["disparity"].shape != frames[0][0].shape[:2] or not np.isfinite(
                res["disparity"]).all():
            raise AssertionError(f"disparity {res['disparity'].shape} not finite or not "
                                 f"{frames[0][0].shape[:2]}")
        if res["depth"].size == 0 or len(res["points"]) == 0:
            raise AssertionError("empty depth or point cloud")
    return results, lat, fwd, launches


def whole_forward(model, left, right, k, s, label):
    """The model's forward against the same forward composed of the plain
    versions, on one frame, within the whole-forward bands."""
    from adaptive_stereo_tpu_torch.models import aggregation_args
    from adaptive_stereo_tpu_torch.ops.cuda import (
        aggregate_cost_volume_ref, difference_cost_volume_ref, soft_argmin_fcs_ref)

    coarse = f"fcs_l/{k + s}"
    with torch.inference_mode():
        out_k = model(left, right)
        net = model.stereo_net
        fl, fr = model.feature_net(left), model.feature_net(right)
        cost = difference_cost_volume_ref(fl, fr, net.num_disp).to(net.dtype or fl.dtype)
        p, st = aggregation_args(net)
        agg = aggregate_cost_volume_ref(cost, p, st, train=False)[0]
        pred, fcs = soft_argmin_fcs_ref(agg.float())
        out_p = net.finish({coarse: fcs}, pred, left, "l")
    torch.cuda.synchronize()
    fcs_factor = fcs_band_factor(net.num_disp)
    for key, abs_tol, rel_tol in ((f"pred_disp_l/{s}", DISP0_ABS_PX, DISP0_REL),
                                  (f"pred_disp_l/{k + s}", DISP0_ABS_PX, DISP0_REL),
                                  (coarse, fcs_factor * AGG_BF16_ABS,
                                   fcs_factor * AGG_BF16_REL)):
        a, b = out_k[key].float(), out_p[key].float()
        diff = (a - b).abs()
        over = (diff > abs_tol + rel_tol * b.abs()).sum().item()
        log(f"[forward] {label} {key} {tuple(a.shape)}: max abs diff {diff.max().item():.4g}, "
            f"mean {diff.mean().item():.4g}, p99 {diff.flatten().quantile(0.99).item():.4g}, "
            f"|plain| max {b.abs().max().item():.4g}; over {abs_tol} + {rel_tol}|ref|: {over}")
        if not torch.isfinite(a).all() or over:
            raise AssertionError(f"whole forward {label} {key}: kernels and plain disagree")


def rel_l2(a, b) -> float:
    """|a - b|_2 / |b|_2 in float32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def tower_flops(b, h, w) -> float:
    """Operations of the tower's forward over taps inside the image: per
    layer 2 * B * (3H - 2d)(3W - 2d) * cin * cout."""
    from adaptive_stereo_tpu_torch.ops.cuda.tower import DILATIONS

    chans = [(4, 32)] + [(32, 32)] * 6 + [(32, 1)]
    return sum(2.0 * b * (3 * h - 2 * d) * (3 * w - 2 * d) * ci * co
               for d, (ci, co) in zip(DILATIONS, chans))


def tower_bytes(b, h, w, itemsize=2):
    """Bytes of the tower's forward and backward chains at (b, h, w) with
    activations of itemsize bytes (the bound's bytes): per layer the
    activations each chain must read and write once."""
    n_pix = b * h * w
    act_bytes = n_pix * itemsize  # one channel
    fwd_bytes = n_pix * 4 * itemsize + (7 * 32 + 1) * act_bytes + 7 * 32 * act_bytes
    bwd_bytes = act_bytes + n_pix * 4 * itemsize + 7 * 32 * act_bytes \
        + (7 * 32 + 1) * act_bytes + n_pix * 4 * itemsize
    return fwd_bytes, bwd_bytes


def tower_setup(model_cpu, dev, seed):
    """The refinement tower of model_cpu on dev: (base, run_stats, g,
    inputs, params_for, grads). base holds its weights (kernels HWIO),
    run_stats its running statistics; inputs(b, h, w) draws (x0, g_out)
    from the seeded generator g; params_for(dt, requires_grad) gives the
    weights rounded to dt; grads(fn, x, params, g_out) the gradients of
    sum(fn(x, params) * g_out) in x and every weight."""
    ref = model_cpu.stereo_net.edge_aware_refinements[0]
    convs, bns = ref.tower_layers()
    with torch.no_grad():
        base = {"kernels": [c.weight.permute(2, 3, 1, 0).to(dev) for c in convs],
                "biases": [c.bias.to(dev) for c in convs],
                "gammas": torch.stack([n.weight for n in bns]).to(dev),
                "betas": torch.stack([n.bias for n in bns]).to(dev)}
        run_stats = (torch.stack([n.running_mean for n in bns]).to(dev),
                     torch.stack([n.running_var for n in bns]).to(dev))
    g = torch.Generator(device=dev).manual_seed(seed + 7)

    def inputs(b, h, w):
        x0 = torch.rand(b, h, w, 4, generator=g, device=dev)
        x0[..., 0] *= 60.0  # the upsampled disparity channel, in pixels
        return x0, torch.randn(b, h, w, 1, generator=g, device=dev)

    def params_for(dt, requires_grad=False):
        """The weights rounded to dt (the kernels' inputs), as float32 or dt."""
        out = {}
        for key, v in base.items():
            vals = [t.to(dt).float() if key == "kernels" else t.float() for t in v] \
                if isinstance(v, list) else v.float()
            if requires_grad:
                vals = [t.clone().requires_grad_() for t in vals] if isinstance(vals, list) \
                    else vals.clone().requires_grad_()
            out[key] = vals
        return out

    def grads(fn, x, params, g_out):
        y = fn(x, params)
        gs = torch.autograd.grad((y.float() * g_out).sum(),
                                 [x] + params["kernels"] + params["biases"]
                                 + [params["gammas"], params["betas"]])
        return [t.float() for t in gs]
    return base, run_stats, g, inputs, params_for, grads


TOWER_GRAD_NAMES = (["dx0"] + [f"dW{p}" for p in range(8)] + [f"db{p}" for p in range(8)]
                    + ["dgamma", "dbeta"])


def tower_phase(model_cpu, dev, seed, rows):
    """Phase 7: the tower kernels against tower_ref at the training shape
    and at TOWER_TAIL, then their times at the training shape."""
    from adaptive_stereo_tpu_torch.ops.cuda import (
        tower_backward_cuda, tower_cuda, tower_forward_cuda, tower_ref)

    ref = model_cpu.stereo_net.edge_aware_refinements[0]
    base, run_stats, g, inputs, params_for, grads = tower_setup(model_cpu, dev, seed)
    names = TOWER_GRAD_NAMES
    # db of the layers followed by a BatchNorm: 0 in exact arithmetic.
    bn_bias_grads = {f"db{p}" for p in range(7)}
    errs = {}

    def check(shape):
        """Forward and backward against tower_ref at one shape; returns the
        bf16 errors of the output and of dx0 against the plain chain."""
        x0, g_out = inputs(*shape)
        out = {}
        for dt in (torch.float32, torch.bfloat16):
            xd = x0.to(dt)
            for train in (True, False):
                mode = f"{'train' if train else 'eval'} {shape}"
                with torch.no_grad():
                    p32 = params_for(dt)
                    want = tower_ref(xd.float(), p32, run_stats, train, buffers=True)
                    plain = tower_ref(xd, {**p32, "kernels": [k.to(dt) for k in p32["kernels"]]},
                                      run_stats, train, buffers=True)
                    got = tower_forward_cuda(xd, [k.to(dt).contiguous() for k in p32["kernels"]],
                                             p32["biases"], p32["gammas"], p32["betas"],
                                             run_stats, train)
                torch.cuda.synchronize()
                y_err = (got[0].float() - plain[0].float()).abs().max().item()
                if dt == torch.float32:
                    pairs = [("y7", got[0], want[0]), ("mu", got[1], want[1]),
                             ("var", got[2], want[2])]
                    pairs += [(f"x{i + 1}", a, r) for i, (a, r) in enumerate(zip(got[3], want[3]))]
                    pairs += [(f"y{i}", a, r) for i, (a, r) in enumerate(zip(got[4], want[4]))]
                    worst = 0.0
                    for name, a, r in pairs:
                        tol = 1e-4 if name in ("mu", "var") else 1e-3
                        d = (a.float() - r.float()).abs()
                        worst = max(worst, d.max().item())
                        if not bool((d <= tol + 1e-4 * r.float().abs()).all()):
                            raise AssertionError(f"tower forward f32 {mode} {name}: max abs err "
                                                 f"{d.max().item():.3g}")
                    log(f"[tower] forward f32 {mode}: output, 7 x and 8 y buffers and mu/var "
                        f"within the f32 band; max abs err {worst:.3g} (|y7| max "
                        f"{want[0].abs().max().item():.3g})")
                else:
                    checks = [("y7", 0)] + ([("mu", 1), ("var", 2)] if train else [])
                    for name, i in checks:
                        e_k = (got[i].float() - want[i].float()).abs()
                        e_p = (plain[i].float() - want[i].float()).abs()
                        log(f"[tower] forward bf16 {mode} {name}: error vs f32, kernels max "
                            f"{e_k.max().item():.4g} mean {e_k.mean().item():.4g}; plain max "
                            f"{e_p.max().item():.4g} mean {e_p.mean().item():.4g}")
                        if (e_k.max() > TOWER_BF16_FACTOR * e_p.max()
                                or e_k.mean() > TOWER_BF16_FACTOR * e_p.mean()):
                            raise AssertionError(f"tower forward bf16 {mode} {name}: kernel "
                                                 f"error beyond {TOWER_BF16_FACTOR} x the "
                                                 "plain bf16's")
                    if train:
                        out["fwd"] = y_err
            # Backward, train mode.
            p_ref = params_for(torch.float32, requires_grad=True)
            x_ref = xd.float().clone().requires_grad_()
            g_ref = grads(lambda x, p: tower_ref(x, p, run_stats, True)[0], x_ref, p_ref, g_out)
            gmax = max(t.abs().max().item() for t in g_ref)
            if dt == torch.float32:
                with torch.no_grad():
                    y7, mu, var, xs, ys = tower_ref(xd, params_for(dt), run_stats, True,
                                                    buffers=True)
                    got = tower_backward_cuda(
                        g_out, xd, [t.contiguous() for t in xs], [t.contiguous() for t in ys],
                        [k.contiguous() for k in base["kernels"]], base["gammas"],
                        base["betas"], mu, var)
                torch.cuda.synchronize()
                flat = [got[0]] + list(got[1]) + list(got[2]) + [got[3], got[4]]
                worst = []
                for name, a, r in zip(names, flat, g_ref):
                    if name in bn_bias_grads:
                        ok = a.abs().max().item() <= 1e-4 * gmax
                        worst.append((a.abs().max().item() / gmax, name))
                    else:
                        e = rel_l2(a, r)
                        ok = e <= TOWER_F32_GRAD_L2
                        worst.append((e, name))
                    if not ok:
                        raise AssertionError(f"tower backward f32 {shape} {name}: {worst[-1]}")
                log(f"[tower] backward f32 {shape} on the plain chain's buffers: every gradient "
                    f"within {TOWER_F32_GRAD_L2} relative L2 (worst {max(worst)})")
            else:
                p_k = params_for(dt, requires_grad=True)
                x_k = xd.clone().requires_grad_()
                g_k = grads(lambda x, p: tower_cuda(x, {**p, "kernels": [k.to(dt) for k in
                                                                         p["kernels"]]},
                                                    run_stats, True)[0], x_k, p_k, g_out)
                p_p = params_for(dt, requires_grad=True)
                x_p = xd.clone().requires_grad_()
                g_p = grads(lambda x, p: tower_ref(x, {**p, "kernels": [k.to(dt) for k in
                                                                        p["kernels"]]},
                                                   run_stats, True)[0], x_p, p_p, g_out)
                torch.cuda.synchronize()
                out["bwd"] = (g_k[0] - g_p[0]).abs().max().item()
                for name, a, pl, r in zip(names, g_k, g_p, g_ref):
                    if name in bn_bias_grads:
                        continue
                    e_k, e_p = rel_l2(a, r), rel_l2(pl, r)
                    log(f"[tower] backward bf16 {shape} {name}: relative L2 error vs f32, "
                        f"kernels {e_k:.4g}, plain {e_p:.4g}")
                    if e_k > TOWER_BF16_FACTOR * e_p + TOWER_F32_GRAD_L2:
                        raise AssertionError(f"tower backward bf16 {shape} {name}: kernel error "
                                             f"beyond {TOWER_BF16_FACTOR} x the plain bf16's")
                # The cross-block sums run in a fixed order: a second run on
                # the same inputs gives the same bits.
                p16 = {**params_for(dt), "kernels": [k.to(dt).contiguous()
                                                     for k in base["kernels"]]}
                with torch.no_grad():
                    _, mu, var, xs, ys = tower_forward_cuda(
                        xd, p16["kernels"], p16["biases"], p16["gammas"], p16["betas"],
                        run_stats, True)
                    runs = [tower_backward_cuda(g_out, xd, xs, ys, p16["kernels"],
                                                p16["gammas"], p16["betas"], mu, var)
                            for _ in range(2)]
                torch.cuda.synchronize()
                flat = [[r[0]] + list(r[1]) + list(r[2]) + [r[3], r[4]] for r in runs]
                unequal = [n for n, a, c in zip(names, *flat) if not torch.equal(a, c)]
                log(f"[tower] backward bf16 {shape}, two runs on the same inputs: every "
                    f"gradient bitwise equal {not unequal}")
                if unequal:
                    raise AssertionError(f"tower backward bf16 {shape}: runs differ in {unequal}")
        return out

    b, h, w = 2, 320, 960
    errs = check((b, h, w))
    check(TOWER_TAIL)
    x0, g_out = inputs(b, h, w)

    # Times at the training shape, bf16, train mode. The kernels by CUDA
    # events with the host ahead; the plain chain's forward the same way.
    # Its backward (autograd.grad over a graph built beforehand) cannot be
    # enqueued ahead of the device, so its time is the sum of its kernels'
    # device times (torch.profiler); the kernels' chains get that sum too.
    dt = torch.bfloat16
    xd = x0.to(dt)
    p16 = {**params_for(dt), "kernels": [k.to(dt).contiguous() for k in base["kernels"]]}
    fwd = lambda: tower_forward_cuda(xd, p16["kernels"], p16["biases"], p16["gammas"],
                                     p16["betas"], run_stats, True)
    with torch.no_grad():
        y7, mu, var, xs, ys = fwd()
    bwd = lambda: tower_backward_cuda(g_out, xd, xs, ys, p16["kernels"], p16["gammas"],
                                      p16["betas"], mu, var)
    p_req = params_for(dt, requires_grad=True)
    x_req = xd.clone().requires_grad_()
    leaves = [x_req] + p_req["kernels"] + p_req["biases"] + [p_req["gammas"], p_req["betas"]]
    y_plain = tower_ref(x_req, {**p_req, "kernels": [k.to(dt) for k in p_req["kernels"]]},
                        run_stats, True)[0]
    loss_plain = (y_plain.float() * g_out).sum()
    plain_bwd_fn = lambda: torch.autograd.grad(loss_plain, leaves, retain_graph=True)
    plain_fwd_fn = lambda: tower_ref(xd, p16, run_stats, True)

    with torch.no_grad():
        t_fwd, t_plain = time_ms(fwd, calls=5), time_ms(plain_fwd_fn, calls=5)
        d_fwd, d_plain_fwd = device_ms(fwd), device_ms(plain_fwd_fn)
    t_bwd, t_plain_bwd = time_ms(bwd, calls=5), time_ms(plain_bwd_fn, calls=1)
    d_bwd, d_plain_bwd = device_ms(bwd), device_ms(plain_bwd_fn)
    del y_plain, loss_plain
    # The step's yardstick at this layer: the refinement module forward +
    # backward in train mode, its module path (cuDNN, fused_tower=False)
    # against fused_tower=True, as the sum of device times.
    coarse_disp = torch.rand(b, h // 16, w // 16, generator=g, device=dev) * 4
    refine_ms, refine_fwd, refine_bwd = {}, {}, {}
    for fused in (True, False):
        mod = copy.deepcopy(ref).to(dev).train()
        mod.dtype, mod.fused_tower = dt, fused
        mod_params = list(mod.parameters())
        refine_ms[fused] = device_ms(lambda mod=mod, ps=mod_params: torch.autograd.grad(
            (mod(coarse_disp, x0[..., 1:]) * g_out).sum(), ps, allow_unused=True))
        # Forward alone, and backward alone over a graph built beforehand.
        with torch.no_grad():
            refine_fwd[fused] = device_ms(lambda mod=mod: mod(coarse_disp, x0[..., 1:]))
        loss_mod = (mod(coarse_disp, x0[..., 1:]) * g_out).sum()
        refine_bwd[fused] = device_ms(lambda loss=loss_mod, ps=mod_params: torch.autograd.grad(
            loss, ps, retain_graph=True, allow_unused=True))
        del loss_mod
    flops = tower_flops(b, h, w)
    fwd_bytes, bwd_bytes = tower_bytes(b, h, w)
    log(f"[tower] (2,{h},{w}) bf16 train, kernels: forward {t_fwd}, device sum {d_fwd:.4f} ms; "
        f"backward {t_bwd}, device sum {d_bwd:.4f} ms. Plain chain (cuDNN F.conv2d + the "
        f"port's BN and LeakyReLU): forward {t_plain}, device sum {d_plain_fwd:.4f} ms; "
        f"backward alone (autograd.grad, graph built beforehand) {t_plain_bwd}, device sum "
        f"{d_plain_bwd:.4f} ms; {flops / 1e9:.2f} GFLOP forward, {2 * flops / 1e9:.2f} "
        f"GFLOP backward")
    log(f"[tower] refinement module (2,{h},{w}) bf16 train, forward + backward, device sum: "
        f"fused_tower=True {refine_ms[True]:.4f} ms, module path (cuDNN, the step's "
        f"yardstick) {refine_ms[False]:.4f} ms; forward alone: fused_tower=True "
        f"{refine_fwd[True]:.4f} ms, module path {refine_fwd[False]:.4f} ms; backward alone "
        f"(autograd.grad, graph built beforehand): fused_tower=True {refine_bwd[True]:.4f} ms, "
        f"module path {refine_bwd[False]:.4f} ms")
    with torch.no_grad():
        for label, fn in (("forward", fwd), ("backward", bwd)):
            times = launch_times(fn)
            own = [(name, us) for name, us in times if not name.startswith("at::")]
            torch_us = sum(us for name, us in times if name.startswith("at::"))
            log(f"[tower] {label} chain, device us of its {len(own)} launches in order: "
                + ", ".join(f"{name} {us:.1f}" for name, us in own)
                + f"; beside them {len(times) - len(own)} PyTorch kernels (BN terms, "
                f"casts), {torch_us:.1f} us")
    # The library yardstick of each chain: the refinement module path's
    # forward alone and backward alone (cuDNN conv2d + the port's BN and
    # LeakyReLU), which the port never calls with fused_tower=True.
    for name, replaces, t, plain_ms, nbytes, ops, err, wrapper, lib_ms in (
            ("tower_forward", "tower.py:285", t_fwd, t_plain.ms, fwd_bytes, flops,
             errs["fwd"], tower_forward_cuda, refine_fwd[False]),
            ("tower_backward", "tower.py:501", t_bwd, d_plain_bwd, bwd_bytes, 2 * flops,
             errs["bwd"], tower_backward_cuda, refine_bwd[False])):
        b_ms, b_by = bound(nbytes, ops, "bf16_tensor")
        log(f"[kernels] {name}: kernel {t}; plain {plain_ms:.4f} ms; module path "
            f"{lib_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by})")
        rows.append(dict(name=name, route="cuda",
                         source="adaptive_stereo_tpu_torch/csrc/tower.cu",
                         replaces=f"adaptive_stereo_tpu/ops/pallas/{replaces}", wrapper=wrapper,
                         max_abs_err=err, ms=t.ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, launches=0))


def autograd_phase(params, run_stats, dev, seed, rows):
    """Phase 8: kernels 1-3 at the training shapes (batch 2, coarse 20x60,
    D = 12). Their forward outputs against the plain versions, f32 and bf16,
    kernel 2 in train mode (batch statistics over both images): the cost
    volume bitwise, the aggregation's out/mu/var within the aggregation
    band, soft-argmin + FCS within DISP_ABS. Then the gradients of kernels 1
    and 3 through the wrappers against those through the plain versions,
    and their backward kernels through autograd against the plain
    backwards (backward_kernels), timed into their rows.
    Kernel 2's gradient is not compared here: its backward recomputes
    through the plain version, so both sides would run the same code.
    Kernel 4's backward recomputes too, through coarse_head_ref; its check
    (eval and train) holds the Function's wiring: the saved inputs, which
    inputs get a gradient, the float32 incoming gradient."""
    from adaptive_stereo_tpu_torch.ops.cuda import (
        aggregate_cost_volume_cuda, aggregate_cost_volume_ref, coarse_head_cuda,
        coarse_head_ref, difference_cost_volume_cuda, difference_cost_volume_ref,
        soft_argmin_fcs_cuda, soft_argmin_fcs_ref)
    from adaptive_stereo_tpu_torch.ops.cuda.aggregation import PARAM_NAMES

    b, d, h, w, c = 2, 12, 20, 60, 32
    g = torch.Generator(device=dev).manual_seed(seed + 8)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)

    for dt in (torch.float32, torch.bfloat16):
        fl, fr = rn(b, h, w, c).to(dt), rn(b, h, w, c).to(dt)
        with torch.no_grad():
            cv = difference_cost_volume_cuda(fl, fr, d)
            cv_equal = torch.equal(cv, difference_cost_volume_ref(fl, fr, d))
            got = aggregate_cost_volume_cuda(cv, params, run_stats, True)
            want = aggregate_cost_volume_ref(cv, params, run_stats, True)
            agg = [(n, *agg_band_err(a, r, dt)) for n, a, r in zip(("out", "mu", "var"), got,
                                                                   want)]
            cost = want[0].float()
            sa = max((a - r).abs().max().item() for a, r in zip(soft_argmin_fcs_cuda(cost),
                                                                 soft_argmin_fcs_ref(cost)))
        torch.cuda.synchronize()
        log(f"[autograd] forward at ({b},{d},{h},{w},{c}) {dt}: cost volume bitwise equal "
            f"{cv_equal}; aggregation train max abs err "
            + ", ".join(f"{n} {e:.3g}" for n, e, _ in agg)
            + f" (|ref| max {want[0].float().abs().max().item():.3g}); soft-argmin + FCS on "
            f"the aggregated cost {sa:.3g}")
        if not cv_equal:
            raise AssertionError(f"cost volume {dt} at the training shape: not bitwise equal")
        if not all(ok for _, _, ok in agg):
            raise AssertionError(f"aggregation train {dt} at the training shape: {agg}")
        if sa > DISP_ABS:
            raise AssertionError(f"soft-argmin + FCS at the training shape: {sa} > {DISP_ABS}")

    def both(fn_k, fn_p, inputs, g_out):
        out = []
        for fn in (fn_k, fn_p):
            xs = [t.detach().clone().requires_grad_() for t in inputs]
            y = fn(*xs)
            out.append(torch.autograd.grad((y.float() * g_out).sum(), xs))
        return out

    fl, fr = rn(b, h, w, c), rn(b, h, w, c)
    gk, gp = both(lambda x, y: difference_cost_volume_cuda(x, y, d),
                  lambda x, y: difference_cost_volume_ref(x, y, d), [fl, fr], rn(b, d, h, w, c))
    cv_err = max((a - r).abs().max().item() for a, r in zip(gk, gp))
    cost = rn(b, d, h, w) * 5
    gk, gp = both(lambda x: soft_argmin_fcs_cuda(x)[0], lambda x: soft_argmin_fcs_ref(x)[0],
                  [cost], rn(b, h, w))
    sa_err = (gk[0] - gp[0]).abs().max().item()
    sa_scale = gp[0].abs().max().item()
    log(f"[autograd] gradients f32: cost volume max abs diff {cv_err:.3g} (the wrapper's "
        f"backward is the kernel stereo_cost_volume_backward, against autograd through the "
        f"plain forward's slices); soft-argmin max abs diff {sa_err:.3g} (|grad| max "
        f"{sa_scale:.3g}; the backward kernel stereo_soft_argmin_backward uses the forward "
        f"kernel's disparity)")
    if cv_err > 1e-5 or sa_err > 1e-5 * (1 + sa_scale):
        raise AssertionError("kernel 1 or 3: gradients through the wrapper disagree")
    backward_kernels(dev, seed, rows)

    for train in (False, True):
        def head(fn):
            return lambda fl, fr, *ps: fn(fl, fr, dict(zip(PARAM_NAMES, ps)), run_stats, train,
                                          d)[0]

        gk, gp = both(head(coarse_head_cuda), head(coarse_head_ref),
                      [rn(b, h, w, c), rn(b, h, w, c)] + [params[n] for n in PARAM_NAMES],
                      rn(b, h, w))
        scale = max(t.abs().max().item() for t in gp)
        err = max((a - r).abs().max().item() for a, r in zip(gk, gp))
        log(f"[autograd] gradients f32, coarse head {'train' if train else 'eval'}: max abs "
            f"diff {err:.3g} over f_l, f_r and the six params (|grad| max {scale:.3g}; the "
            f"backward recomputes through coarse_head_ref: this checks its wiring)")
        if err > 1e-5 * (1 + scale):
            raise AssertionError(f"kernel 4 train={train}: gradients through the wrapper "
                                 "disagree")


def backward_kernels(dev, seed, rows):
    """The backward kernels of kernels 1 and 3 through autograd (the
    wrappers' Functions on CUDA tensors) against their plain versions, then
    their times. Kernel 1 (stereo_cost_volume_backward): torch.equal with
    difference_cost_volume_backward in f32 and bf16 at the training shape,
    at CV_WIDE_D (D > W, 16-byte chunks), at RAGGED (in bf16 the scalar
    path) and at CV_ODD_C (the scalar path in both). Kernel 3
    (stereo_soft_argmin_backward): within 1e-5 (1 + max|grad|) of
    soft_argmin_fcs_backward on the kernel's own disparity (torch's softmax
    sums in its own order), at the training shape, RAGGED and
    SOFT_ARGMIN_D. Each backward must launch its kernel once. Times at
    the training shape (bf16 volume, f32 cost), by CUDA events for the one
    launch, and the plain versions' device-time sums (torch.profiler), with
    their kernel counts."""
    from adaptive_stereo_tpu_torch.ops.cuda import (difference_cost_volume_cuda,
                                                    soft_argmin_fcs_cuda)
    from adaptive_stereo_tpu_torch.ops.cuda import cost_volume as cv_mod
    from adaptive_stereo_tpu_torch.ops.cuda import disparity as disp_mod

    g = torch.Generator(device=dev).manual_seed(seed + 10)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    b, d, h, w = TRAIN_COARSE
    c = 32
    for dt in (torch.float32, torch.bfloat16):
        for (fb, fh, fw, fc), fd in [((b, h, w, c), d), CV_WIDE_D, RAGGED, CV_ODD_C]:
            fl, fr = (rn(fb, fh, fw, fc).to(dt).requires_grad_() for _ in range(2))
            g_out = rn(fb, fd, fh, fw, fc).to(dt)
            before = difference_cost_volume_cuda.backward_launches
            got = torch.autograd.grad(difference_cost_volume_cuda(fl, fr, fd), (fl, fr), g_out)
            want = cv_mod.difference_cost_volume_backward(g_out)
            torch.cuda.synchronize()
            launched = difference_cost_volume_cuda.backward_launches - before
            equal = all(torch.equal(a, r) for a, r in zip(got, want))
            path = cv_path(fc, g_out, *got)
            log(f"[autograd] cost volume backward kernel ({fb},{fd},{fh},{fw},{fc}) {dt}, {path} "
                f"path: bitwise equal to difference_cost_volume_backward {equal}; launches "
                f"{launched}")
            if not equal or launched != 1:
                raise AssertionError(f"cost volume backward ({fb},{fd},{fh},{fw},{fc}) {dt}: "
                                     f"equal {equal}, launches {launched}")
    (rb, rh, rw, _), rd = RAGGED
    for shape in [TRAIN_COARSE, (rb, rd, rh, rw)] + [(rb, dd, rh, rw) for dd in SOFT_ARGMIN_D]:
        cost = (rn(*shape) * 5).requires_grad_()
        g_out = rn(shape[0], *shape[2:])
        before = soft_argmin_fcs_cuda.backward_launches
        disp = soft_argmin_fcs_cuda(cost)[0]
        got, = torch.autograd.grad(disp, cost, g_out)
        want = disp_mod.soft_argmin_fcs_backward(cost.detach(), disp.detach(), g_out)
        torch.cuda.synchronize()
        launched = soft_argmin_fcs_cuda.backward_launches - before
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        log(f"[autograd] soft-argmin backward kernel {shape}: max abs diff to "
            f"soft_argmin_fcs_backward {err:.3g} (|grad| max {scale:.3g}); launches {launched}")
        if err > 1e-5 * (1 + scale) or launched != 1:
            raise AssertionError(f"soft-argmin backward {shape}: err {err}, launches {launched}")

    # Times at the training shape.
    g16 = rn(b, d, h, w, c).to(torch.bfloat16)
    cost = rn(b, d, h, w) * 5
    with torch.no_grad():
        disp = soft_argmin_fcs_cuda(cost)[0]
    g_disp = rn(b, h, w)
    n_add = 2 * b * h * c * sum(w - i for i in range(min(d, w)))
    for name, kernel_fn, plain_fn, nbytes, ops, label in (
            ("difference_cost_volume", lambda: cv_mod._launch_backward(g16),
             lambda: cv_mod.difference_cost_volume_backward(g16),
             (n_add // 2 + 2 * b * h * w * c) * 2, n_add, f"({b},{d},{h},{w},{c}) bf16"),
            ("soft_argmin_fcs", lambda: disp_mod._launch_backward(cost, disp, g_disp),
             lambda: disp_mod.soft_argmin_fcs_backward(cost, disp, g_disp),
             2 * cost.numel() * 4 + 2 * disp.numel() * 4, 6 * cost.numel(),
             f"({b},{d},{h},{w}) f32")):
        kern = time_ms(kernel_fn)
        plain_kernels = len(launch_times(plain_fn))
        plain = device_ms(plain_fn)
        b_ms, b_by = bound(nbytes, ops, "f32_cuda_core")
        log(f"[kernels] {name} backward {label}: kernel {kern}, one launch; plain version "
            f"{plain:.4f} ms of device time over its {plain_kernels} kernels; bound {b_ms:.5f} "
            f"ms ({b_by})")
        row = next(r for r in rows if r["name"] == name)
        row.update(backward_ms=kern.ms, backward_plain_ms=plain, backward_bound_ms=b_ms)


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to their plain versions (which the
    wrappers take for CPU tensors only), for a step to compare against."""
    import adaptive_stereo_tpu_torch.models.aggregation as agg
    import adaptive_stereo_tpu_torch.models.stereo_net as sn
    from adaptive_stereo_tpu_torch.ops.cuda import (
        aggregate_cost_volume_ref, difference_cost_volume_ref, soft_argmin_fcs_ref, tower_ref)

    swaps = [(sn, "difference_cost_volume_cuda", difference_cost_volume_ref),
             (sn, "soft_argmin_fcs_cuda", soft_argmin_fcs_ref), (sn, "tower_cuda", tower_ref),
             (agg, "aggregate_cost_volume_cuda", aggregate_cost_volume_ref)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def copy_model(model, float32=False):
    """An independent copy of model; with float32, it computes in float32."""
    m2 = copy.deepcopy(model)
    if float32:
        for mod in m2.modules():
            if isinstance(getattr(mod, "dtype", None), torch.dtype):
                mod.dtype = None
    return m2


def copy_reservoir(r):
    from adaptive_stereo_tpu_torch.engine import DeviceReservoir

    gen = torch.Generator(device=r.values.device)
    gen.set_state(r.generator.get_state())
    return DeviceReservoir(r.left.clone(), r.right.clone(), r.values.clone(),
                           r.reg_indices.clone(), r.size.clone(), r.count.clone(), gen)


def fork(model, ss, float32=False):
    """An independent copy of (model, engine state); with float32, the copy
    computes in float32 (the same weights and state)."""
    from adaptive_stereo_tpu_torch.engine import FlatStreamState, live_parameters

    m2 = copy_model(model, float32)
    return m2, FlatStreamState(
        params=live_parameters(m2), n_feature=ss.n_feature, m=[t.clone() for t in ss.m],
        v=[t.clone() for t in ss.v], count=ss.count.clone(), lr=ss.lr.clone(),
        ema_value=ss.ema_value.clone(), ema_init=ss.ema_init.clone(),
        reservoir=copy_reservoir(ss.reservoir), log=ss.log.clone(),
        log_pos=ss.log_pos.clone())


def param_modules(model, params):
    """{module: indices into params} for the per-module comparisons of an
    adapt step: the feature net, the aggregation and the tower."""
    owner = {id(p): name for name, p in model.named_parameters()}
    modules = {}
    for i, p in enumerate(params):
        name = owner[id(p)]
        module = ("feature" if name.startswith("feature_net.") else
                  "tower" if name.startswith("stereo_net.edge_aware_refinements.") else
                  "aggregation" if name.startswith(("stereo_net.filter.",
                                                    "stereo_net.conv3d_alone.")) else None)
        if module is None:
            raise AssertionError(f"parameter {name} belongs to no module of the comparison")
        modules.setdefault(module, []).append(i)
    return modules


def training_phase(seed, dev, rows):
    """Phase 9: the adaptation step at bench.py's configuration."""
    from adaptive_stereo_tpu_torch.engine import (LOG_COLS, init_flat_stream_state,
                                                  live_parameters, make_flat_streaming_steps)
    from adaptive_stereo_tpu_torch.models import StereoModel, random_init_
    from adaptive_stereo_tpu_torch.ops.losses import khamis_robust_loss, monodepth_single_loss

    k, s, h, w = 4, 0, 320, 960
    options = dict(use_er=True, use_vs=True, ood_threshold=12.76, clip_grad_norm=True,
                   fused_er_forward=True)

    def build(fused_tower):
        model = StereoModel(k=k, input_scale=s, dtype=torch.bfloat16, device=dev,
                            fused_siamese=True, fused_tower=fused_tower)
        return random_init_(model, torch.Generator().manual_seed(seed + 9))

    rng = np.random.RandomState(seed)
    to_dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    left, right = to_dev(rng.rand(1, h, w, 3)), to_dev(rng.rand(1, h, w, 3))
    gt = to_dev(rng.rand(1, h, w, 1) * 60)
    batch = (left, right, gt, left, right, gt, 0)  # bench.py: the same frame, index 0

    def run(model, ss, n, frame=batch):
        adapt = make_flat_streaming_steps(model, s, k, **options)[0]
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            ss = adapt(ss, *frame)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return ss, times

    wrappers = [row["wrapper"] for row in rows]
    # The wrappers whose backward is a kernel of their own, with its count.
    backward = {row["name"]: row["wrapper"] for row in rows
                if hasattr(row["wrapper"], "backward_launches")}

    def counts():
        return [(wr.launches, getattr(wr, "backward_launches", 0)) for wr in wrappers]

    results = {}
    for fused_tower in (True, False):
        model = build(fused_tower)
        ss = init_flat_stream_state(model, LR, 16, h, w, 64, seed=seed, device=dev)
        ss, warm = run(model, ss, WARMUP_STEPS)
        for wrapper in wrappers:
            wrapper.launches = 0
        for wrapper in backward.values():
            wrapper.backward_launches = 0
        ss, times = run(model, ss, STEPS)
        launches = {row["name"]: row["wrapper"].launches for row in rows}
        bwd = {name: wr.backward_launches for name, wr in backward.items()}
        med = statistics.median(times)
        results[fused_tower] = (model, ss, med)
        log(f"[training] fused_tower={fused_tower}: {STEPS} adapt steps at {h}x{w} k={k} bf16 "
            f"(after {WARMUP_STEPS} warm-up steps, the first {warm[0]:.1f} ms): median "
            f"{med:.2f} ms/step ({1e3 / med:.2f} steps/s), min {min(times):.2f}, max "
            f"{max(times):.2f}; launches per step "
            + ", ".join(f"{n}={c / STEPS:g}" for n, c in launches.items())
            + "; backward kernels per step "
            + ", ".join(f"{n}={c / STEPS:g}" for n, c in bwd.items()))
        if sorted(bwd) != ["difference_cost_volume", "soft_argmin_fcs"] or any(
                c != STEPS for c in bwd.values()):
            raise AssertionError(f"fused_tower={fused_tower}: the backward kernels of kernels 1 "
                                 f"and 3 did not launch once a step: {bwd} over {STEPS} steps")
        if fused_tower:
            for row in rows:
                row["train_launches"] = launches[row["name"]]
                if row["name"] in bwd:
                    row["backward_train_launches"] = bwd[row["name"]]
                if row["name"].startswith("tower"):
                    row["launches"] = launches[row["name"]]
            missing = [n for n, c in launches.items() if (c == 0) != (n == "coarse_head")]
            if missing:
                raise AssertionError(f"launch counts of the training path: {launches}")
            # The tower's chains: at most 15 forward and 32 backward launches.
            if (launches["tower_forward"] > 15 * STEPS
                    or launches["tower_backward"] > 32 * STEPS):
                raise AssertionError(f"the tower's launches per step: {launches}")
        elif launches["tower_forward"] or launches["tower_backward"]:
            raise AssertionError("fused_tower=False launched the tower kernels")
        log_rows = ss.log[:int(ss.log_pos)].cpu().numpy()
        cols = {c: i for i, c in enumerate(LOG_COLS)}
        if not np.isfinite(log_rows).all():
            raise AssertionError("the ring log holds non-finite values")
        last = log_rows[-1]
        total = lambda col: int(log_rows[:, cols[col]].sum())
        log(f"[training]   ring log, {len(log_rows)} rows: novel {total('novel')}, did_add "
            f"{total('did_add')}, do_update {total('do_update')}; last row "
            + ", ".join(f"{c}={last[i]:.4g}" for c, i in cols.items()))
    model, ss, med = results[True]
    log(f"[training] kernels vs cuDNN yardstick (fused_tower=False): {med:.2f} vs "
        f"{results[False][2]:.2f} ms/step")

    # done and validate steps (eval mode, the tower in eval mode).
    _, done, validate, _ = make_flat_streaming_steps(model, s, k, **options)
    ss = done(ss, left, right, gt, 1)
    ss, avg, size, mean_disp = validate(ss)
    torch.cuda.synchronize()
    row = ss.log[(int(ss.log_pos) - 1) % ss.log.shape[0]].cpu().numpy()
    log(f"[training] done step: {', '.join(f'{c}={v:.4g}' for c, v in zip(LOG_COLS, row))}; "
        f"validate: mean value {float(avg):.4g}, size {int(size)}, mean |disp| "
        f"{float(mean_disp):.4g}")
    if not (np.isfinite(row).all() and np.isfinite([float(avg), float(mean_disp)]).all()):
        raise AssertionError("done or validate step gave non-finite values")

    # One step with the kernels against one with the plain versions from one
    # state, on two frames (the sound readings), and one plain step on frame
    # B against one on frame A (the control: a step as sound in form and
    # scale whose gradient is wrong), in bf16 and in float32. Per module: the
    # relative L2 difference of the gradients, and the median |theta -
    # theta_plain| over the median update of the plain step. Every sound
    # reading must lie within its limit, every control reading outside it.
    frame_b = (to_dev(rng.rand(1, h, w, 3)), to_dev(rng.rand(1, h, w, 3)),
               to_dev(rng.rand(1, h, w, 1) * 60), left, right, gt, 0)
    modules = param_modules(model, ss.params)
    stereo = modules["aggregation"] + modules["tower"]

    def loss_grads(m, frame):
        m.train()
        l, r, _, er_l, er_r, er_gt, _ = frame
        out = m(torch.cat([l, er_l]), torch.cat([r, er_r]), side="l", output_cost_volume=True)
        pred = out[f"pred_disp_l/{s}"]
        mono = monodepth_single_loss(l, r, pred[:1], 1e-3, max_disp=192)[0]
        replay = khamis_robust_loss(pred[1:], er_gt)
        params = live_parameters(m)
        gs = torch.autograd.grad(mono + 0.05 * replay, params, allow_unused=True)
        return [torch.zeros_like(p) if t is None else t.float() for t, p in zip(gs, params)]

    def one_step(plain, frame, float32):
        before = counts()
        with plain_versions() if plain else contextlib.nullcontext():
            gs = loss_grads(fork(model, ss, float32)[0], frame)
            m_b, ss_b = fork(model, ss, float32)
            ss_b, _ = run(m_b, ss_b, 1, frame)
        if plain and counts() != before:
            raise AssertionError("the plain-version step launched a kernel")
        row = ss_b.log[(int(ss_b.log_pos) - 1) % ss_b.log.shape[0]].cpu().numpy()
        return gs, [p.detach() for p in ss_b.params], row

    def cat(ts, idx):
        return torch.cat([ts[i].flatten().float() for i in idx])

    def readings(got, ref):
        (g_a, p_a, row_a), (g_r, p_r, row_r) = got, ref
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
        out = {"mono": rel(row_a[2], row_r[2]), "replay": rel(row_a[3], row_r[3]),
               "stereo grad norm": rel(cat(g_a, stereo).norm().item(),
                                       cat(g_r, stereo).norm().item()),
               "do_update": float(row_a[7] != row_r[7])}
        for module, idx in modules.items():
            out[f"{module} grad"] = rel_l2(cat(g_a, idx), cat(g_r, idx))
            upd = (cat(p_r, idx) - cat(before, idx)).abs().median()
            out[f"{module} param"] = ((cat(p_a, idx) - cat(p_r, idx)).abs().median()
                                      / upd).item()
        return out

    before = [p.detach().clone() for p in ss.params]
    failed, plain_a = [], {}
    for label, limits in STEP_LIMITS.items():
        f32 = label == "float32"
        plain_a[label], plain_b = one_step(True, batch, f32), one_step(True, frame_b, f32)
        sound = [readings(one_step(False, batch, f32), plain_a[label]),
                 readings(one_step(False, frame_b, f32), plain_b)]
        control = readings(plain_b, plain_a[label])
        for key in sound[0]:
            limit = limits.get(key)
            worst = max(r[key] for r in sound)
            log(f"[training] one step {label}, kernels vs plain versions, {key}: frame A "
                f"{sound[0][key]:.4g}, frame B {sound[1][key]:.4g}; limit "
                f"{'-' if limit is None else f'{limit:g}'}; control (plain, frame B vs A) "
                f"{control[key]:.4g}")
            if key == "do_update" and worst:
                failed.append(f"{label}: do_update differs")
            if limit is not None and worst > limit:
                failed.append(f"{label} {key}: sound reading {worst:.4g} > {limit:g}")
            if limit is not None and control[key] <= limit:
                failed.append(f"{label} {key}: the control {control[key]:.4g} is within "
                              f"{limit:g}")
    noise = readings(plain_a["bfloat16"], plain_a["float32"])
    log("[training] one step, plain versions bf16 vs float32 (the scale of bf16 rounding), "
        "frame A: " + ", ".join(f"{key} {v:.4g}" for key, v in noise.items()))
    if failed:
        raise AssertionError("training step, kernels vs plain versions: " + "; ".join(failed))

    log("[profile] training, fused_tower=True")
    adapt = make_flat_streaming_steps(model, s, k, **options)[0]
    operators, launches, _, _ = profile_breakdown(lambda: adapt(ss, *batch), repeats=3, top=24,
                                            unit="step", host_top=10)
    log(f"[training] kernel launches (cudaLaunchKernel) a step {launches:.0f} (before kernels 1 "
        f"and 3 had backward kernels: {STEP_LAUNCHES_BEFORE}, "
        f"{launches - STEP_LAUNCHES_BEFORE:+.0f}); host operators a step {operators:.0f} "
        f"(before: {STEP_OPERATORS_BEFORE}, {operators - STEP_OPERATORS_BEFORE:+.0f})")
    log("[profile] training, fused_tower=False (yardstick)")
    m_y, ss_y, _ = results[False]
    adapt_y = make_flat_streaming_steps(m_y, s, k, **options)[0]
    profile_breakdown(lambda: adapt_y(ss_y, *batch), repeats=3, top=8, unit="step", host_top=5)
    return med


def generate_driver_data(root: str, seed: int):
    """Start generating the datasets of phases 10, 11 and 14 in three spawned
    processes (the numpy generator takes about half a second a 320x960
    frame), so they are written while phases 3-9 run. Returns (pool,
    futures)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from adaptive_stereo_tpu_torch.data import generate_synthetic_dataset

    pool = ProcessPoolExecutor(max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    h, w = DRIVER_SHAPE
    futures = [
        pool.submit(generate_synthetic_dataset, f"{root}/novel", name="synth",
                    num_train=DRIVER_FRAMES[0], num_val=DRIVER_FRAMES[1], height=h, width=w,
                    max_disp=40.0, seed=seed + 50, domain_shift=True),
        pool.submit(generate_synthetic_dataset, f"{root}/train", name="synth",
                    num_train=REPLAY_FRAMES[0], num_val=REPLAY_FRAMES[1], height=h, width=w,
                    max_disp=40.0, seed=seed),
        pool.submit(generate_synthetic_dataset, f"{root}/train16", name="synth",
                    num_train=TRAIN_FRAMES[0], num_val=TRAIN_FRAMES[1], height=h, width=w,
                    max_disp=40.0, seed=seed + 20),
        pool.submit(generate_synthetic_dataset, f"{root}/serve14", name="synth",
                    num_train=CV_FRAMES, num_val=1, height=CV_SHAPE[0], width=CV_SHAPE[1],
                    max_disp=40.0, seed=seed + 40)]
    return pool, futures



def wait_timers(waits):
    """Stand-ins for the streaming driver's _ReplayPrefetch.item and
    BatchLoader.__iter__ that add the time the loop's thread waits for the
    replay frame and for the loader's next batch to waits["replay"] and
    waits["loader"] (seconds)."""
    import adaptive_stereo_tpu_torch.engine.stream_driver as sd

    replay_item, loader_iter = sd._ReplayPrefetch.item, sd.BatchLoader.__iter__

    def timed_replay_item(self, step):
        t = time.perf_counter()
        item = replay_item(self, step)
        waits["replay"] += time.perf_counter() - t
        return item

    def timed_loader_iter(self):
        batches = loader_iter(self)
        while True:
            t = time.perf_counter()
            try:
                batch = next(batches)
            except StopIteration:
                return
            waits["loader"] += time.perf_counter() - t
            yield batch
    return timed_replay_item, timed_loader_iter


def driver_phase(seed, dev, rows, card, bare_ms, root, data):
    """Phase 10: the streaming adaptation driver (adapt --engine flat)."""
    import csv
    import os

    import adaptive_stereo_tpu_torch.engine.stream_driver as sd
    from adaptive_stereo_tpu_torch import cli
    from adaptive_stereo_tpu_torch.data import decode_png
    from adaptive_stereo_tpu_torch.engine import (LOG_COLS, AdaptConfig, DataConfig,
                                                  ExperimentConfig, ModelConfig, OptimConfig,
                                                  init_flat_stream_state,
                                                  load_stream_checkpoint, save_variables)
    from adaptive_stereo_tpu_torch.models import (StereoModel, random_init_,
                                                  variables_from_state_dicts)

    pool, futures = data
    t_phase = t0 = time.perf_counter()
    for future in futures:
        future.result()
    pool.shutdown()
    log(f"[driver] datasets ready (waited {time.perf_counter() - t0:.1f} s): novel domain "
        f"{DRIVER_FRAMES[0]} + {DRIVER_FRAMES[1]} frames, training domain {REPLAY_FRAMES[0]} + "
        f"{REPLAY_FRAMES[1]} (phase 11's: {TRAIN_FRAMES[0]} + {TRAIN_FRAMES[1]}), "
        f"{DRIVER_SHAPE[0]}x{DRIVER_SHAPE[1]}")
    k, h, w = 4, *DRIVER_SHAPE
    # The host's cost of one frame's PNG: the generator picks each row's
    # filter as libpng and PIL do (mostly paeth on these images).
    left = os.path.join(root, "novel", "left")
    with open(os.path.join(left, sorted(os.listdir(left))[0]), "rb") as f:
        frame_png = f.read()
    decode_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        decode_png(frame_png)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    start = frame_png.index(b"IDAT") + 4
    filtered = np.frombuffer(zlib.decompressobj().decompress(frame_png[start:]), np.uint8)
    kinds = np.bincount(filtered.reshape(h, -1)[:, 0], minlength=5)
    log(f"[driver] decode_png of one {h}x{w} RGB frame on the host: median "
        f"{statistics.median(decode_ms):.2f} ms of 5; rows by filter type 0-4: "
        f"{kinds.tolist()}")
    cpu_model = random_init_(StereoModel(k=k, input_scale=0, device="cpu"),
                             torch.Generator().manual_seed(seed + 10))
    weights = os.path.join(root, "weights")
    save_variables(weights, variables_from_state_dicts(
        cpu_model.feature_net.state_dict(), cpu_model.stereo_net.state_dict(), k))
    novel, train = os.path.join(root, "novel"), os.path.join(root, "train")

    def config(name, num_epochs, **adapt):
        base = dict(adapt_mode="VS+ER", ood_threshold=1e9, train_dataset_path=train,
                    train_dataset_name="Synthetic", train_split="synth")
        base.update(adapt)
        return ExperimentConfig(
            model_name=name, log_dir=os.path.join(root, "logs"), num_epochs=num_epochs,
            log_frequency=4, load_weights_folder=weights,
            model=ModelConfig(k=k, input_scale=0, compute_dtype="bfloat16",
                              fused_siamese=True, s2d_refinement=True),
            optim=OptimConfig(learning_rate=LR, clip_grad_norm=True),
            data=DataConfig(dataset_path=novel, dataset_name="Synthetic", split="synth",
                            height=h, width=w, batch_size=1, num_workers=4),
            adapt=AdaptConfig(**base))

    # Count the driver's step calls, and time on the host clock (the driver
    # runs ahead of the card between its drains) what its loop's thread does
    # between two adapt steps: the adapt call itself, the wait for the
    # loader's next batch, the wait for the replay frame (read a step ahead
    # on a worker thread) and the rest (uploads, uint8 frames, drains).
    calls = {"adapt": [], "adapt_ms": [], "parts": [], "done": 0, "done_batched": 0,
             "validate": 0}
    waits = {"loader": 0.0, "replay": 0.0}
    make_steps, replay_item, loader_iter = (sd.make_flat_streaming_steps,
                                            sd._ReplayPrefetch.item, sd.BatchLoader.__iter__)
    timed_replay_item, timed_loader_iter = wait_timers(waits)

    def counted_steps(*a, **kw):
        adapt, done, validate, make_batched = make_steps(*a, **kw)

        def adapt_c(*args):
            t = time.perf_counter()
            calls["adapt"].append(t)
            calls["parts"].append(dict(waits))
            waits.update(loader=0.0, replay=0.0)
            out = adapt(*args)
            calls["adapt_ms"].append((time.perf_counter() - t) * 1e3)
            return out

        def done_c(*args):
            calls["done"] += 1
            return done(*args)

        def validate_c(ss):
            calls["validate"] += 1
            return validate(ss)

        def make_batched_c(n):
            batched = make_batched(n)

            def batched_c(*args):
                calls["done_batched"] += 1
                return batched(*args)
            return batched_c
        return adapt_c, done_c, validate_c, make_batched_c

    wrappers = {row["name"]: row["wrapper"] for row in rows}

    def reset():
        calls.update(adapt=[], adapt_ms=[], parts=[], done=0, done_batched=0, validate=0)
        for wr in wrappers.values():
            wr.launches = 0
            if hasattr(wr, "backward_launches"):
                wr.backward_launches = 0

    def check_launches(label, absent=("coarse_head",)):
        """Fail unless every kernel launched in this run but those absent."""
        got = {name: wr.launches for name, wr in wrappers.items()}
        got.update({f"{name} backward": wr.backward_launches for name, wr in wrappers.items()
                    if hasattr(wr, "backward_launches")})
        log(f"[driver] {label}: kernel launches " + ", ".join(f"{n}={c}" for n, c in got.items()))
        missing = [n for n, c in got.items() if (c == 0) != (n in absent)]
        if missing:
            raise AssertionError(f"{label}: launch counts of the driver's path: {got}")

    def check_run(label, result, n_rows):
        ss = result["stream_state"]
        log_rows = ss.log[:int(ss.log_pos)].cpu().numpy()
        cols = {c: i for i, c in enumerate(LOG_COLS)}
        if len(log_rows) != n_rows or not np.isfinite(log_rows).all():
            raise AssertionError(f"{label}: the ring log has {len(log_rows)} rows (want "
                                 f"{n_rows}) or non-finite values")
        adapt_rows = int((log_rows[:, cols["replay_loss"]] != 0).sum())
        log(f"[driver] {label}: {result['steps']} steps, {result['steps_per_sec']:.2f} steps/s, "
            f"{result['gradient_updates']} gradient updates, {result['guard_rollbacks']} "
            f"rollbacks, final state {result['final_state']}; ring log: {adapt_rows} adapt rows, "
            f"{len(log_rows) - adapt_rows} done rows, did_add "
            f"{int(log_rows[:, cols['did_add']].sum())}; calls: {len(calls['adapt'])} adapt, "
            f"{calls['done']} done, {calls['done_batched']} batched done, {calls['validate']} "
            f"validate")
        if not (adapt_rows and len(calls["adapt"]) and calls["validate"]):
            raise AssertionError(f"{label}: no adapt step or no validation ran")
        return log_rows

    sd.make_flat_streaming_steps = counted_steps
    sd._ReplayPrefetch.item = timed_replay_item
    sd.BatchLoader.__iter__ = timed_loader_iter
    try:
        # Run A: bench.py's step settings through the driver, two epochs.
        reset()
        guard = dict(ovs_guard_tolerance=0.5, ovs_guard_disp_band=4.0,
                     ovs_guard_train_epe_factor=3.0, ovs_guard_lr_factor=3.0)
        cfg_a = config("run_a", 2, ovs_buffer_size=DRIVER_FRAMES[0], ovs_validate_hz=4,
                       val_improve_retries=1, eval_hz=DRIVER_FRAMES[0], **guard)
        options = dict(transfer_uint8=True, fused_er_forward=True, done_batch=4)
        t0 = time.perf_counter()
        result = sd.adapt_streaming(cfg_a, device=dev, **options)
        wall = time.perf_counter() - t0
        steps = 2 * DRIVER_FRAMES[0]
        if result["steps"] != steps:
            raise AssertionError(f"run A took {result['steps']} steps, want {steps}")
        check_launches("run A")
        check_run("run A", result, steps)
        if not calls["done_batched"]:
            raise AssertionError("run A: the machine never reached DONE, so no batched done "
                                 "step ran")
        starts = calls["adapt"]
        gaps = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
        driver_ms = statistics.median(gaps)
        CARRY["driver_gaps"] = gaps
        log(f"[driver] run A: {wall:.1f} s wall; median interval between adapt-step calls inside "
            f"the driver {driver_ms:.2f} ms against phase 9's bare step {bare_ms:.2f} ms "
            f"(x{driver_ms / bare_ms:.2f}; the driver's own host overhead "
            f"{driver_ms - bare_ms:+.2f} ms a step); {card}")
        parts = {"adapt call": calls["adapt_ms"][:-1],
                 "loader wait": [p["loader"] * 1e3 for p in calls["parts"][1:]],
                 "replay frame wait": [p["replay"] * 1e3 for p in calls["parts"][1:]]}
        parts["rest"] = [g - sum(v[i] for v in parts.values()) for i, g in enumerate(gaps)]
        log("[driver] run A, the interval between adapt steps on the loop's thread, median ms: "
            + ", ".join(f"{name} {statistics.median(v):.2f}" for name, v in parts.items()))
        with open(os.path.join(root, "logs", "run_a", "trials.csv"), newline="") as f:
            trials = list(csv.reader(f))
        if len(trials) != 1 + 3:
            raise AssertionError(f"trials.csv has {len(trials) - 1} rows, want 3")
        log(f"[driver] trials.csv: {trials[0]}; " + "; ".join(",".join(r[:3]) for r in trials[1:]))

        # The saved stream state loads bit for bit; a resumed run reaches the
        # same step count.
        ckpt = os.path.join(root, "logs", "run_a", "models", f"weights_{steps}")
        model = StereoModel(k=k, input_scale=0, dtype=torch.bfloat16, device=dev,
                            fused_siamese=True, fused_tower=True)
        fresh = init_flat_stream_state(model, LR, DRIVER_FRAMES[0], h, w, 512, seed=123,
                                       device=dev)
        fresh, host, *_ = load_stream_checkpoint(ckpt, fresh)
        a = result["stream_state"]
        same = all(torch.equal(x, y) for f in ("params", "m", "v", "buffers")
                   for x, y in zip(getattr(fresh, f), getattr(a, f)))
        same &= all(torch.equal(getattr(fresh, f), getattr(a, f))
                    for f in ("count", "lr", "ema_value", "ema_init", "log", "log_pos"))
        same &= all(torch.equal(getattr(fresh.reservoir, f), getattr(a.reservoir, f))
                    for f in ("left", "right", "values", "reg_indices", "size", "count"))
        same &= torch.equal(fresh.reservoir.generator.get_state(),
                            a.reservoir.generator.get_state())
        if not same or host["step"] != steps:
            raise AssertionError("the saved stream state does not load bit for bit")
        reset()
        resumed = sd.adapt_streaming(cfg_a, resume_from=os.path.join(
            root, "logs", "run_a", "models", f"weights_{DRIVER_FRAMES[0]}"), device=dev,
            **options)
        drift = max((x.float() - y.float()).abs().max().item()
                    for x, y in zip(resumed["stream_state"].params, a.params))
        log(f"[driver] stream state of step {steps} loaded bit for bit (generator included); "
            f"resumed from step {DRIVER_FRAMES[0]}: {resumed['steps']} steps, "
            f"{resumed['gradient_updates']} gradient updates (uninterrupted "
            f"{result['gradient_updates']}), parameters within {drift:.3g} of the "
            f"uninterrupted run")
        if resumed["steps"] != steps:
            raise AssertionError(f"the resumed run took {resumed['steps']} steps, want {steps}")
        check_launches("resumed run A")

        # Run B: left-right consistency with the fused ER forward (batch 3).
        reset()
        cfg_b = config("run_b", 1, leftright_consistency=True, num_steps=4, ovs_buffer_size=4,
                       ovs_validate_hz=2, eval_hz=4, skip_initial_eval=True)
        result_b = sd.adapt_streaming(cfg_b, fused_er_forward=True, device=dev)
        check_launches("run B (left-right, batch-3 forward)")
        check_run("run B", result_b, 4)
    finally:
        sd.make_flat_streaming_steps = make_steps
        sd._ReplayPrefetch.item = replay_item
        sd.BatchLoader.__iter__ = loader_iter

    # The command line, a short run.
    argv = ["adapt", "--engine", "flat", "--model_name", "cli", "--log_dir",
            os.path.join(root, "logs"), "--dataset_path", novel, "--dataset_name", "Synthetic",
            "--split", "synth", "--height", str(h), "--width", str(w), "--stereonet_k", "4",
            "--stereonet_input_scale", "0", "--compute_dtype", "bfloat16", "--batch_size", "1",
            "--learning_rate", str(LR), "--clip_grad_norm", "--adapt_mode", "VS+ER",
            "--num_steps", "4", "--eval_hz", "4", "--ovs_buffer_size", "4",
            "--ovs_validate_hz", "2", "--ood_threshold", "1e9", "--num_epochs", "1",
            "--log_frequency", "2", "--skip_initial_eval", "--fused_er_forward",
            "--transfer_uint8", "--train_dataset_path", train, "--train_dataset_name",
            "Synthetic", "--train_split", "synth", "--load_weights_folder", weights,
            "--device", dev.type]
    # The parser, like the JAX package's, has no flag for fused_siamese or
    # s2d_refinement, so this run takes the refinement module path: the
    # tower's kernels are not on it.
    reset()
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError("adapt --engine flat failed")
    check_launches("adapt --engine flat", absent=("coarse_head", "tower_forward",
                                                  "tower_backward"))
    with open(os.path.join(root, "logs", "cli", "trials.csv"), newline="") as f:
        cli_rows = list(csv.reader(f))[1:]
    if [r[1] for r in cli_rows] != ["4"]:
        raise AssertionError(f"the command line's trials.csv: {cli_rows}")
    log(f"[driver] python -m adaptive_stereo_tpu_torch.cli adapt --engine flat: 4 steps, exit 0, "
        f"{time.perf_counter() - t0:.1f} s; phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return driver_ms


@contextlib.contextmanager
def captured_kernel_calls(calls):
    """Record each kernel call the model makes (the names plain_versions()
    swaps) in calls[key]: its inputs and outputs, detached copies, and the
    gradient that reaches its first output."""
    import adaptive_stereo_tpu_torch.models.aggregation as agg
    import adaptive_stereo_tpu_torch.models.stereo_net as sn

    def keep(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, dict):
            return {key: keep(v) for key, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(keep(v) for v in x)
        return x

    def wrap(fn, key):
        def captured(*args, **kwargs):
            rec = {"args": keep(args), "kwargs": keep(kwargs)}
            out = fn(*args, **kwargs)
            rec["out"] = keep(out)
            first = out[0] if isinstance(out, tuple) else out
            if first.requires_grad:
                first.register_hook(lambda g: rec.__setitem__("grad", g.detach().clone()))
            calls.setdefault(key, []).append(rec)
            return out
        return captured

    swaps = [(sn, "difference_cost_volume_cuda", "cost volume"),
             (sn, "soft_argmin_fcs_cuda", "soft-argmin"), (sn, "tower_cuda", "tower"),
             (agg, "aggregate_cost_volume_cuda", "aggregation")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, key in swaps:
        setattr(mod, name, wrap(getattr(mod, name), key))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_batch(root, indices, dev, domain="train16"):
    """Items `indices` of one of phase 11's domains as one batch on dev
    (color and ground truth at scales 0 and 4)."""
    from adaptive_stereo_tpu_torch.data import StereoDataset

    h, w = DRIVER_SHAPE
    ds = StereoDataset(f"{root}/{domain}", "Synthetic", "synth", h, w, "train", scales=[0, 4],
                       load_disp_left=True, load_disp_right=False)
    items = [ds[i] for i in indices]
    return {key: torch.from_numpy(np.stack([it[key] for it in items])).to(dev)
            for key in items[0]}


def check_kernel_calls(calls, label, forwards, tower, backward):
    """Hold every kernel call recorded by captured_kernel_calls against its
    plain version on that call's own inputs, with phase 8's bands (kernel 1
    and its backward bitwise; kernel 2's out/mu/var within the aggregation
    band of its dtype; kernel 3 within DISP_ABS and its backward within
    1e-5 (1 + max|grad|)) and the tower with phase 7's (bf16: each output's
    and gradient's error against float32 at most TOWER_BF16_FACTOR times
    the plain bf16 chain's, gradients + TOWER_F32_GRAD_L2). `forwards`
    model forwards were recorded, through the tower if `tower`, each with
    its incoming gradient if `backward`. Returns the failed checks."""
    from adaptive_stereo_tpu_torch.ops.cuda import (aggregate_cost_volume_ref,
                                                    difference_cost_volume_ref,
                                                    soft_argmin_fcs_ref)
    from adaptive_stereo_tpu_torch.ops.cuda import cost_volume as cv_mod
    from adaptive_stereo_tpu_torch.ops.cuda import disparity as disp_mod

    want_calls = {"aggregation": forwards, "cost volume": forwards, "soft-argmin": forwards}
    if tower:
        want_calls["tower"] = forwards
    recorded = {key: len(v) for key, v in calls.items()}
    graded = [key for key, v in calls.items() if key != "aggregation"
              and any(("grad" in r) != backward for r in v)]
    if recorded != want_calls or graded:
        raise AssertionError(f"{label}: kernel calls recorded {recorded} (want {want_calls}); "
                             f"incoming gradient {'missing' if backward else 'present'} for "
                             f"{graded}")
    failed = []

    def report(name, err, limit, ok=None):
        ok = err <= limit if ok is None else ok
        log(f"[{label}] {name}: {err:.4g} (limit {limit})")
        if not ok:
            failed.append(name)

    with torch.no_grad():
        for rec in calls["cost volume"]:
            fl, fr, d = rec["args"]
            equal = torch.equal(rec["out"], difference_cost_volume_ref(fl, fr, d))
            bwd_equal = None
            if backward:
                g = rec["grad"].contiguous()
                bwd_equal = all(torch.equal(a, b) for a, b in zip(
                    cv_mod._launch_backward(g), cv_mod.difference_cost_volume_backward(g)))
            log(f"[{label}] cost volume {tuple(rec['out'].shape)} {rec['out'].dtype}: bitwise "
                f"equal {equal}" + ("" if bwd_equal is None else "; its backward kernel on the "
                                    f"step's gradient bitwise equal {bwd_equal}"))
            if not equal or bwd_equal is False:
                failed.append("cost volume")
        for rec in calls["aggregation"]:
            cost, params, run_stats = rec["args"]
            train = rec["kwargs"]["train"]
            want = aggregate_cost_volume_ref(cost, params, run_stats, train, rec["kwargs"]["eps"])
            band = (f"{AGG_BF16_ABS} + {AGG_BF16_REL}|ref|" if cost.dtype == torch.bfloat16
                    else f"{AGG_F32_ABS}")
            names = ("out", "mu", "var") if train else ("out",)
            for name, got_t, want_t in zip(names, rec["out"], want):
                err, ok = agg_band_err(got_t, want_t, cost.dtype)
                report(f"aggregation {'train' if train else 'eval'} {tuple(cost.shape)} "
                       f"{cost.dtype} {name}, max abs err", err, band, ok)
        for rec in calls["soft-argmin"]:
            (cost,) = rec["args"]
            err = max((a - b).abs().max().item()
                      for a, b in zip(rec["out"], soft_argmin_fcs_ref(cost)))
            report(f"soft-argmin + FCS {tuple(cost.shape)}, max abs err", err, DISP_ABS)
            if backward:
                disp, g = rec["out"][0], rec["grad"].contiguous()
                want = disp_mod.soft_argmin_fcs_backward(cost, disp, g)
                err = (disp_mod._launch_backward(cost, disp, g) - want).abs().max().item()
                scale = want.abs().max().item()
                report(f"soft-argmin backward kernel, max abs err (|grad| max {scale:.3g})", err,
                       1e-5 * (1 + scale))
    for rec in calls.get("tower", []):
        check_tower_call(rec, label, failed)
    return failed


def check_tower_call(rec, label, failed):
    """The bf16 tower call rec (train mode, with its incoming gradient)
    against float32 beside the plain bf16 chain (phase 7's bands)."""
    from adaptive_stereo_tpu_torch.ops.cuda import tower_cuda, tower_ref

    x0, params, run_stats, train, eps = rec["args"]
    if x0.dtype != torch.bfloat16 or not train:
        raise AssertionError(f"{label}: tower call {x0.dtype} train={train}; the check holds "
                             "bf16 train-mode calls")
    g_out = rec["grad"].float()
    dt = x0.dtype
    rounded = {**params, "kernels": [kk.to(dt).float() for kk in params["kernels"]]}

    def leaves(p, x):
        p = {key: [t.clone().requires_grad_() for t in v] if isinstance(v, list)
             else v.clone().requires_grad_() for key, v in p.items()}
        x = x.clone().requires_grad_()
        return p, x, [x] + p["kernels"] + p["biases"] + [p["gammas"], p["betas"]]

    def tower_grads(fn, p, x):
        p, x, ls = leaves(p, x)
        y = fn(x, p)
        return [t.float() for t in torch.autograd.grad((y[0].float() * g_out).sum(), ls)]

    with torch.no_grad():
        want = tower_ref(x0.float(), rounded, run_stats, True)
        plain = tower_ref(x0, rounded, run_stats, True)
    for name, got_t, want_t, plain_t in zip(("y7", "mu", "var"), rec["out"], want, plain):
        e_k, e_p = (got_t.float() - want_t).abs(), (plain_t.float() - want_t).abs()
        log(f"[{label}] tower forward {tuple(x0.shape)} {name}: error vs f32, kernels max "
            f"{e_k.max().item():.4g} mean {e_k.mean().item():.4g}; plain bf16 max "
            f"{e_p.max().item():.4g} mean {e_p.mean().item():.4g}")
        if (e_k.max() > TOWER_BF16_FACTOR * e_p.max()
                or e_k.mean() > TOWER_BF16_FACTOR * e_p.mean()):
            failed.append(f"tower forward {name}")
    del want, plain
    ref_g = tower_grads(lambda x, p: tower_ref(x, p, run_stats, True), rounded, x0.float())
    kern_g = tower_grads(lambda x, p: tower_cuda(x, p, run_stats, True, eps), params, x0)
    plain_g = tower_grads(lambda x, p: tower_ref(x, {**p, "kernels": [kk.to(dt) for kk in
                                                                     p["kernels"]]},
                                                 run_stats, True), params, x0)
    names = ["dx0"] + [f"dW{p}" for p in range(8)] + [f"db{p}" for p in range(8)] + \
        ["dgamma", "dbeta"]
    worst = (-1.0, "", 0.0, 0.0)
    for name, a, pl, r in zip(names, kern_g, plain_g, ref_g):
        if name in {f"db{p}" for p in range(7)}:
            continue  # 0 in exact arithmetic: the BatchNorm after the conv removes it
        e_k, e_p = rel_l2(a, r), rel_l2(pl, r)
        limit = TOWER_BF16_FACTOR * e_p + TOWER_F32_GRAD_L2
        worst = max(worst, (e_k / limit, name, e_k, e_p))
        if e_k > limit:
            failed.append(f"tower backward {name}: kernels {e_k:.4g}, plain {e_p:.4g}")
    log(f"[{label}] tower backward {tuple(x0.shape)}: relative L2 error of each gradient vs "
        f"f32 against {TOWER_BF16_FACTOR} x the plain bf16 chain's + {TOWER_F32_GRAD_L2}; "
        f"closest to its limit {worst[1]}: kernels {worst[2]:.4g}, plain {worst[3]:.4g} "
        f"({worst[0]:.2f} of the limit)")


def batch8_phase(seed, dev, root):
    """Phase 11b: one train-mode forward and backward of the bf16 model with
    fused_siamese and the tower at (TRAIN_BATCH, 320, 960), with the kernels
    and with their plain versions, from the same weights and batch. Each
    kernel's call is recorded (inputs, outputs and incoming gradient) and
    held against its plain version on those inputs (check_kernel_calls).
    Then, printed, the largest error per output and the relative L2
    difference per module gradient of the whole step, kernels against
    plain versions (bf16 rounding compounds through the model, so these
    have no band of their own; they must be finite), beside the plain
    versions on another batch for scale."""
    from adaptive_stereo_tpu_torch.engine import live_parameters
    from adaptive_stereo_tpu_torch.models import StereoModel, random_init_
    from adaptive_stereo_tpu_torch.ops import khamis_robust_loss_multiscale

    t0 = time.perf_counter()
    k, s = 4, 0
    n = TRAIN_BATCH
    model = random_init_(StereoModel(k=k, input_scale=s, dtype=torch.bfloat16, device=dev,
                                     fused_siamese=True, fused_tower=True),
                         torch.Generator().manual_seed(seed + 11))
    batch_a = train_batch(root, range(n), dev)
    batch_b = train_batch(root, range(n, 2 * n), dev)

    def loss_grads(batch):
        m = copy.deepcopy(model).train()
        out = m(batch["color_l/0"], batch["color_r/0"], side="l")
        loss = khamis_robust_loss_multiscale(batch, out, scales=[s, s + k])["total_loss"]
        params = live_parameters(m)
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        return ({key: v.detach().float() for key, v in out.items()},
                [torch.zeros_like(p) if g is None else g.float() for g, p in zip(gs, params)])

    calls = {}
    with captured_kernel_calls(calls):
        out_k, g_k = loss_grads(batch_a)
    with plain_versions():
        out_p, g_p = loss_grads(batch_a)
        out_c, g_c = loss_grads(batch_b)
    torch.cuda.synchronize()
    failed = check_kernel_calls(calls, "batch8", forwards=1, tower=True, backward=True)

    # The whole step, kernels vs plain versions, beside the control.
    owner = {id(p): name for name, p in model.named_parameters()}
    modules = {}
    for i, p in enumerate(live_parameters(model)):
        name = owner[id(p)]
        module = ("feature" if name.startswith("feature_net.") else
                  "tower" if name.startswith("stereo_net.edge_aware_refinements.") else
                  "aggregation")
        modules.setdefault(module, []).append(i)
    cat = lambda gs, idx: torch.cat([gs[i].flatten() for i in idx])
    for key in out_p:
        err = (out_k[key] - out_p[key]).abs().max().item()
        log(f"[batch8] output {key} {tuple(out_p[key].shape)}, kernels vs plain: max abs diff "
            f"{err:.4g} (|plain| max {out_p[key].abs().max().item():.4g}); control (plain, "
            f"another batch) {(out_c[key] - out_p[key]).abs().max().item():.4g}")
        if not torch.isfinite(out_k[key]).all():
            failed.append(f"output {key} not finite")
    for module, idx in modules.items():
        sound, control = rel_l2(cat(g_k, idx), cat(g_p, idx)), rel_l2(cat(g_c, idx), cat(g_p, idx))
        log(f"[batch8] {module} gradient, kernels vs plain: relative L2 {sound:.4g}; for scale, "
            f"the plain versions on another batch {control:.4g} and phase 9's limit for one "
            f"adapt step at batch 2 {STEP_LIMITS['bfloat16'][f'{module} grad']}")
        if not torch.isfinite(cat(g_k, idx)).all():
            failed.append(f"{module} gradient not finite")
    if failed:
        raise AssertionError(f"batch {n}, kernels vs plain versions: " + "; ".join(failed))
    log(f"[batch8] batch {n} at {DRIVER_SHAPE[0]}x{DRIVER_SHAPE[1]}: every kernel within its "
        f"band, {time.perf_counter() - t0:.1f} s")
    return batch_a


def kernel_shapes_phase(seed, dev, root):
    """Phase 11b, continued: the kernels against their plain versions at
    the other dtypes and shapes that phase 11's paths give them, each
    call recorded and checked by check_kernel_calls: the command line's
    f32 train step at batch 8 (the module path: no fused siamese, no
    tower), one step of the classic engine (bf16, fused siamese, tower) at
    batch 1, its stream and replay forwards, and evaluate's f32 eval
    forward at batch 2."""
    from adaptive_stereo_tpu_torch.engine import (create_train_state, init_fcs_ema,
                                                  live_parameters, make_fused_adapt_step)
    from adaptive_stereo_tpu_torch.models import StereoModel, random_init_
    from adaptive_stereo_tpu_torch.ops import khamis_robust_loss_multiscale

    t0 = time.perf_counter()
    failed = []
    gen = lambda i: torch.Generator().manual_seed(seed + 20 + i)

    model = random_init_(StereoModel(k=4, device=dev), gen(0)).train()
    batch = train_batch(root, range(TRAIN_BATCH), dev)
    calls = {}
    with captured_kernel_calls(calls):
        out = model(batch["color_l/0"], batch["color_r/0"], side="l")
        loss = khamis_robust_loss_multiscale(batch, out, scales=[0, 4])["total_loss"]
        torch.autograd.grad(loss, live_parameters(model), allow_unused=True)
    failed += check_kernel_calls(calls, f"f32 train batch {TRAIN_BATCH}", forwards=1,
                                 tower=False, backward=True)

    model = random_init_(StereoModel(k=4, dtype=torch.bfloat16, device=dev, fused_siamese=True,
                                     fused_tower=True), gen(1))
    step = make_fused_adapt_step(model, 0, 4, use_er=True, use_vs=True, ood_threshold=1e9,
                                 clip_grad_norm=True)
    calls = {}
    with captured_kernel_calls(calls):
        step(create_train_state(model, None, 5e-5), init_fcs_ema(dev),
             train_batch(root, [0], dev, "novel"), train_batch(root, [0], dev), True)
    failed += check_kernel_calls(calls, "classic step batch 1", forwards=2, tower=True,
                                 backward=True)

    model = random_init_(StereoModel(k=4, device=dev), gen(2)).eval()
    batch = train_batch(root, range(2), dev, "novel")
    calls = {}
    with captured_kernel_calls(calls), torch.no_grad():
        model(batch["color_l/0"], batch["color_r/0"])
    failed += check_kernel_calls(calls, "f32 eval batch 2", forwards=1, tower=False,
                                 backward=False)
    torch.cuda.synchronize()
    if failed:
        raise AssertionError("kernels vs plain versions at phase 11's other shapes: "
                             + "; ".join(failed))
    log(f"[kernels11] f32 train at batch {TRAIN_BATCH}, the classic step at batch 1 and f32 "
        f"eval at batch 2: every kernel call within its band, {time.perf_counter() - t0:.1f} s")


def launch_counter(wrappers):
    """(reset, counts) over the kernel wrappers {name: wrapper}: reset sets
    every launch count (and backward launch count) to 0; counts returns
    them as {name: launches, "<name> backward": launches}."""
    def reset():
        for wr in wrappers.values():
            wr.launches = 0
            if hasattr(wr, "backward_launches"):
                wr.backward_launches = 0

    def counts():
        got = {name: wr.launches for name, wr in wrappers.items()}
        got.update({f"{name} backward": wr.backward_launches for name, wr in wrappers.items()
                    if hasattr(wr, "backward_launches")})
        return got
    return reset, counts


def require_launches(label, got, absent):
    """Fail unless every kernel in `got` ({name: launches}) launched but
    those in `absent`, which must not have."""
    wrong = [n for n, c in got.items() if (c == 0) != (n in absent)]
    if wrong:
        raise AssertionError(f"{label}: launch counts {got}; wrong: {wrong}")


def classic_phase(seed, dev, rows, card, bare_ms, driver_ms, root):
    """Phase 11: train, the classic engine, evaluate and timing."""
    import importlib
    import io
    import os

    from adaptive_stereo_tpu_torch import cli
    from adaptive_stereo_tpu_torch.data import read_png
    from adaptive_stereo_tpu_torch.engine import (create_train_state, load_checkpoint,
                                                  make_train_step, train)
    from adaptive_stereo_tpu_torch.experiments import adaptation_config, training_config
    from adaptive_stereo_tpu_torch.models import StereoModel, random_init_

    adapt_mod = importlib.import_module("adaptive_stereo_tpu_torch.engine.adapt")
    t_phase = time.perf_counter()
    h, w = DRIVER_SHAPE
    logs, novel, train16 = (os.path.join(root, name) for name in ("logs11", "novel", "train16"))
    wrappers = {row["name"]: row["wrapper"] for row in rows}

    reset, counts = launch_counter(wrappers)

    def check_launches(label, absent):
        got = counts()
        log(f"[classic] {label}: kernel launches " + ", ".join(f"{n}={c}" for n, c in got.items()))
        require_launches(label, got, absent)

    def quiet(fn, *args, **kwargs):
        """fn's console output goes to a buffer (returned with its result)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = fn(*args, **kwargs)
        return result, buf.getvalue()

    # (b) The kernels at batch 8 against their plain versions.
    batch = batch8_phase(seed, dev, root)
    kernel_shapes_phase(seed, dev, root)

    # (c) train(cfg) at training_config's settings on the synthetic domain.
    cfg = training_config("SceneFlowFlying", train16, log_dir=logs)
    cfg.model_name = "train11"
    cfg.num_epochs, cfg.log_frequency = 2, 1
    cfg.optim.scheduler_step_size = 1
    cfg.model.compute_dtype, cfg.model.fused_siamese, cfg.model.s2d_refinement = \
        "bfloat16", True, True
    cfg.data.dataset_name, cfg.data.split = "Synthetic", "synth"
    cfg.data.height, cfg.data.width = h, w
    reset()
    t0 = time.perf_counter()
    result, text = quiet(train, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    state = result["state"]
    metrics = result["final_metrics"]
    log(f"[classic] train: {result['steps']} steps of batch {cfg.data.batch_size} at {h}x{w} "
        f"k={cfg.model.k} bf16, {cfg.num_epochs} epochs, in {wall:.1f} s with {result['steps']} "
        f"evals ({result['steps'] / wall:.2f} steps/s); final eval "
        + ", ".join(f"{key}={v:.4g}" for key, v in metrics.items())
        + f"; learning rate {state.learning_rate:.6g}")
    check_launches("train", absent=("coarse_head",))
    expect_steps = cfg.num_epochs * (TRAIN_FRAMES[0] // cfg.data.batch_size)
    if result["steps"] != expect_steps or not np.isfinite(metrics["EPE"]):
        raise AssertionError(f"train: {result['steps']} steps (want {expect_steps}), metrics "
                             f"{metrics}")
    if state.learning_rate != np.float32(cfg.optim.learning_rate / 4):
        raise AssertionError(f"train: learning rate {state.learning_rate}, want it halved twice")
    weights = os.path.join(logs, "train11", "models", "weights_1")
    fresh = create_train_state(StereoModel(k=cfg.model.k, dtype=torch.bfloat16, device=dev,
                                           fused_siamese=True, fused_tower=True),
                               torch.Generator().manual_seed(seed), 1.0)
    load_checkpoint(weights, fresh)
    same = all(torch.equal(a, b) for f in ("params", "buffers", "m", "v")
               for a, b in zip(getattr(fresh, f), getattr(state, f)))
    same &= all(torch.equal(getattr(fresh, f), getattr(state, f)) for f in ("count", "step", "lr"))
    log(f"[classic] train: {sorted(os.listdir(os.path.dirname(weights)))}; weights_1 "
        f"(the JAX TrainState layout) loads back bit for bit {same}: step {int(fresh.step)}, "
        f"count {int(fresh.count)}")
    if not same:
        raise AssertionError("train: the checkpoint does not load back bit for bit")

    # (d) The bare train step on one batch in memory.
    model = random_init_(StereoModel(k=4, dtype=torch.bfloat16, device=dev, fused_siamese=True,
                                     fused_tower=True), torch.Generator().manual_seed(seed + 12))
    bare = create_train_state(model, None, 1e-4)
    step = make_train_step(model, 0, [0, 4], True)
    times = []
    for i in range(WARMUP_STEPS + BARE_TRAIN_STEPS):
        if i == WARMUP_STEPS:
            reset()
        t0 = time.perf_counter()
        bare, losses = step(bare, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_step = {name: c / BARE_TRAIN_STEPS for name, c in counts().items()}
    for row in rows:
        row["train11_launches"] = per_step[row["name"]]
    train_ms = statistics.median(times[WARMUP_STEPS:])
    log(f"[classic] bare train step, batch {TRAIN_BATCH} at {h}x{w} k=4 bf16 (fused siamese, "
        f"tower, clip): median {train_ms:.2f} ms/step of {BARE_TRAIN_STEPS} after "
        f"{WARMUP_STEPS} warm-up (the first {times[0]:.1f} ms), {1e3 / train_ms:.2f} steps/s, "
        f"{TRAIN_BATCH * 1e3 / train_ms:.1f} pairs/s; total loss "
        f"{float(losses['total_loss']):.4g}; launches per step "
        + ", ".join(f"{n}={c:g}" for n, c in per_step.items()))
    require_launches("bare train step", per_step, absent=("coarse_head",))
    log("[profile] bare train step, batch 8")
    operators, launches, device_ms_step, busy = profile_breakdown(
        lambda: step(bare, batch), repeats=3, top=16, unit="step", host_top=6)
    log(f"[classic] bare train step: device {device_ms_step:.3f} ms/step, busy {busy:.1f} % "
        f"of wall; {launches:.0f} kernel launches (cudaLaunchKernel) and {operators:.0f} host "
        f"operators a step; {card}")
    del model, bare

    # (e) The classic engine from (c)'s checkpoint at adaptation_config's
    # settings, cut to a smoke run.
    acfg = adaptation_config("flying_to_vk01", "VS+ER", {}, load_weights_folder=weights,
                             log_dir=logs, num_steps=12, height=h, width=w, eval_hz=12,
                             ovs_validate_hz=4)
    acfg.model_name = "classic11"
    acfg.model.compute_dtype, acfg.model.fused_siamese, acfg.model.s2d_refinement = \
        "bfloat16", True, True
    acfg.data.dataset_path, acfg.data.dataset_name, acfg.data.split = novel, "Synthetic", "synth"
    acfg.adapt.ovs_buffer_size, acfg.adapt.ood_threshold = 4, 1e9
    acfg.adapt.train_dataset_path, acfg.adapt.train_dataset_name = train16, "Synthetic"
    acfg.adapt.train_split, acfg.adapt.skip_initial_eval = "synth", False
    hook_times, records, validations = [], [], [0]
    validate = adapt_mod.StateMachine.validate

    def counted_validate(self):
        validations[0] += 1
        return validate(self)

    def hook(step_i, record):
        hook_times.append(time.perf_counter())
        records.append(record)

    reset()
    adapt_mod.StateMachine.validate = counted_validate
    try:
        t0 = time.perf_counter()
        summary, text = quiet(adapt_mod.adapt, acfg, step_hook=hook, device=dev)
        wall = time.perf_counter() - t0
    finally:
        adapt_mod.StateMachine.validate = validate
    gaps = [(b - a) * 1e3 for a, b in zip(hook_times, hook_times[1:])]
    classic_ms = statistics.median(gaps)
    diverted = sum(r["did_add"] for r in records)
    with open(os.path.join(logs, "classic11", "trials.csv"), newline="") as f:
        trials = list(csv.reader(f))
    steps_col = [r[trials[0].index("step")] for r in trials[1:]]
    log(f"[classic] adapt (the classic engine, {acfg.adapt.adapt_mode}): {summary['steps']} "
        f"steps in {wall:.1f} s, {summary['gradient_updates']} gradient updates, {diverted} "
        f"frames diverted to the OVS, {validations[0]} validations, final state "
        f"{summary['final_state']}; trials.csv steps {steps_col}; final eval "
        + ", ".join(f"{key}={v:.4g}" for key, v in summary["final_metrics"]["adapt"].items()))
    log(f"[classic] median interval between classic adapt steps {classic_ms:.2f} ms against "
        f"the bare train step at batch {TRAIN_BATCH} {train_ms:.2f} ms (above), the bare adapt "
        f"step {bare_ms:.2f} ms (phase 9) and the flat driver's interval {driver_ms:.2f} ms "
        f"(phase 10); {card}")
    check_launches("adapt --engine classic (adapt())", absent=("coarse_head",))
    if not (summary["steps"] == 12 and summary["gradient_updates"] > 0 and diverted > 0
            and validations[0] > 0 and steps_col == ["-1", "12"]
            and all(np.isfinite(r["mono_loss"]) for r in records)):
        raise AssertionError(f"classic adapt: {summary['steps']} steps, "
                             f"{summary['gradient_updates']} updates, {diverted} diverted, "
                             f"{validations[0]} validations, trials steps {steps_col}")

    # (f) The command line.
    common = ["--dataset_name", "Synthetic", "--split", "synth", "--height", str(h), "--width",
              str(w), "--stereonet_k", "4", "--stereonet_input_scale", "0", "--log_dir", logs,
              "--device", dev.type]
    adapted = os.path.join(logs, "classic11", "models", "weights_12")
    playback_dir = os.path.join(root, "playback11")
    commands = {
        "train": ["train", "--model_name", "cli_train", "--dataset_path", train16,
                  "--batch_size", str(TRAIN_BATCH), "--num_epochs", "1", "--learning_rate",
                  "1e-4", "--clip_grad_norm", "--do_hflip", *common],
        "adapt": ["adapt", "--model_name", "cli_classic", "--dataset_path", novel,
                  "--batch_size", "1", "--learning_rate", "5e-5", "--clip_grad_norm",
                  "--adapt_mode", "VS+ER", "--num_steps", "4", "--eval_hz", "4",
                  "--ovs_buffer_size", "4", "--ovs_validate_hz", "2", "--ood_threshold", "1e9",
                  "--num_epochs", "1", "--log_frequency", "2", "--train_dataset_path", train16,
                  "--train_dataset_name", "Synthetic", "--train_split", "synth",
                  "--load_weights_folder", weights, *common],
        "evaluate eval": ["evaluate", "--mode", "eval", "--dataset_path", novel,
                          "--batch_size", "2", "--load_weights_folder", adapted, *common],
        "evaluate playback": ["evaluate", "--mode", "playback", "--limit", "2",
                              "--output_folder", playback_dir, "--dataset_path", novel,
                              "--load_weights_folder", adapted, *common],
        "timing": ["timing", "--iterations", "20", "--device", dev.type],
    }
    # The command line builds the module path (no tower flag, as in JAX's
    # parser): kernels 1-3, and the backward kernels where it trains.
    module_path = ("coarse_head", "tower_forward", "tower_backward")
    forward_only = module_path + ("difference_cost_volume backward", "soft_argmin_fcs backward")
    absent = {"train": module_path, "adapt": module_path, "evaluate eval": forward_only,
              "evaluate playback": forward_only, "timing": module_path}
    outputs = {}
    for label, argv in commands.items():
        reset()
        t0 = time.perf_counter()
        rc, outputs[label] = quiet(cli.main, argv)
        if rc != 0:
            raise AssertionError(f"{label}: exit {rc}")
        log(f"[classic] python -m adaptive_stereo_tpu_torch.cli {' '.join(argv[:3])} ...: exit 0 "
            f"in {time.perf_counter() - t0:.1f} s")
        check_launches(f"cli {label}", absent=absent[label])
    line = [ln for ln in outputs["evaluate eval"].splitlines() if ln.startswith("EVAL")][-1]
    epe = float(line.split("EPE=")[1].split()[0])
    log(f"[classic] evaluate --mode eval on the adapted checkpoint: {line}")
    shapes = [read_png(os.path.join(playback_dir, f"{i:06d}.png")).shape for i in range(2)]
    log(f"[classic] evaluate --mode playback: PNGs {shapes} (decoded by data/png.py); "
        + "; ".join(ln for ln in outputs["evaluate playback"].splitlines()
                    if ln.startswith(("[playback]", "Playback"))))
    timing = [ln for ln in outputs["timing"].splitlines() if ln.startswith("-- Timing")]
    log(f"[classic] timing at its defaults (320x1216, k=4, bf16, batch 1, 20 iterations): "
        + "; ".join(timing) + f"; {card}")
    if not np.isfinite(epe) or shapes != [(h, 3 * w, 3)] * 2 or len(timing) != 2:
        raise AssertionError(f"command line: EPE {epe}, playback {shapes}, timing {timing}")
    log(f"[classic] phase 11 took {time.perf_counter() - t_phase:.1f} s")


def rest_phase(seed, dev, rows, card, serving, bare_ms, driver_ms, root):
    """Phase 12: the native voxel grid on the serving path, the pytree
    engine, the device cache, the reconstruction gate and the OOD analysis.
    serving: (phase 4's default engine, its frames, its p50 ms)."""
    import importlib
    import os

    import adaptive_stereo_tpu_torch.engine.flat_stream as fs
    import adaptive_stereo_tpu_torch.engine.stream_driver as sd
    import adaptive_stereo_tpu_torch.serving.stream as serving_stream
    from adaptive_stereo_tpu_torch.analysis import (compute_fcs_for_loader,
                                                    compute_precision_recall,
                                                    derive_percentile_threshold,
                                                    reconstruction_scores, train_autoencoder)
    from adaptive_stereo_tpu_torch.data import BatchLoader, StereoDataset, native
    from adaptive_stereo_tpu_torch.engine.flat_stream import dequantize_u8
    from adaptive_stereo_tpu_torch.engine import (LOG_COLS, AdaptConfig, DataConfig,
                                                  DeviceStreamCache, ExperimentConfig,
                                                  ModelConfig, OptimConfig,
                                                  init_flat_stream_state, load_variables,
                                                  make_flat_streaming_steps)
    from adaptive_stereo_tpu_torch.models import StereoModel, random_init_, state_dicts_from_jax
    from adaptive_stereo_tpu_torch.serving import voxel_downsample

    t_phase = time.perf_counter()
    wrappers = {row["name"]: row["wrapper"] for row in rows}
    cols = {c: i for i, c in enumerate(LOG_COLS)}
    h, w = DRIVER_SHAPE
    novel, train, train16 = (os.path.join(root, name) for name in ("novel", "train", "train16"))
    weights = os.path.join(root, "weights")

    reset, counts = launch_counter(wrappers)

    def check_launches(label, absent):
        got = counts()
        log(f"[rest] {label}: kernel launches " + ", ".join(f"{n}={c}" for n, c in got.items()))
        require_launches(label, got, absent)

    # (a) The native voxel grid against its numpy plain version, on the
    # points of one served 320x1216 frame (phase 4's default engine).
    t0 = time.perf_counter()
    lib_path = native.build()
    native.library()
    engine, frames, p50_phase4 = serving
    cfg_s = engine.config
    pending = engine._dispatch(*frames[0], 0.0)
    torch.cuda.synchronize()
    depth = serving_stream.disparity_to_depth(pending.disp_v.numpy(), engine.k_voxel[0, 0],
                                              cfg_s.stereo_baseline_meters, cfg_s.max_depth)
    pts, colors = serving_stream.depth_to_pointcloud(depth, engine.k_voxel,
                                                     pending.color_v.numpy())
    voxel = cfg_s.voxel_scale_meters
    grids = {"native": native.voxel_downsample_native, "numpy": voxel_downsample}
    grid_ms = {name: [] for name in grids}
    for _ in range(5):
        for name, fn in grids.items():
            t = time.perf_counter()
            fn(pts, voxel, colors)
            grid_ms[name].append((time.perf_counter() - t) * 1e3)
    full = {name: len(fn(pts, voxel, colors)[0]) for name, fn in grids.items()}
    frac = pts.astype(np.float64) / voxel
    frac -= np.floor(frac)
    keep = ((frac > 0.01) & (frac < 0.99)).all(axis=1)

    def sorted_rows(p, c):
        rows_ = np.concatenate([p, c], axis=1)
        return rows_[np.lexsort(rows_.T[::-1])]

    got = sorted_rows(*native.voxel_downsample_native(pts[keep], voxel, colors[keep]))
    want = sorted_rows(*voxel_downsample(pts[keep], voxel, colors[keep]))
    grid_err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    log(f"[rest] native voxel grid ({lib_path.name}, built and loaded in "
        f"{time.perf_counter() - t0:.2f} s with the time of one served frame): {len(pts)} points "
        f"of a served {cfg_s.model_input_height}x{cfg_s.model_input_width} frame (voxel scale "
        f"{cfg_s.voxel_disp_scale}, {voxel} m): native {full['native']} voxels, numpy "
        f"{full['numpy']}; median of 5 on the host: native "
        f"{statistics.median(grid_ms['native']):.3f} ms, numpy "
        f"{statistics.median(grid_ms['numpy']):.3f} ms; away from faces ({int(keep.sum())} "
        f"points): {len(got)} vs {len(want)} voxels, rows within {grid_err:.3g}")
    if got.shape != want.shape or grid_err > 1e-6:
        raise AssertionError(f"native voxel grid vs numpy: {got.shape} vs {want.shape}, "
                             f"max err {grid_err}")
    # Serving p50 with the native grid (as phase 4 served) and with the
    # numpy grid in its place, in turns.
    p50 = {"native": [], "numpy": []}
    for name in ("native", "numpy", "numpy", "native"):
        grid = native.voxel_downsample_native if name == "native" else voxel_downsample
        saved = serving_stream.voxel_downsample_native
        serving_stream.voxel_downsample_native = grid
        try:
            _, lat, _, _ = serve(engine, frames, wrappers.values())
        finally:
            serving_stream.voxel_downsample_native = saved
        p50[name].append(statistics.median(lat))
    log(f"[rest] serving p50 over {FRAMES} frames, default head: native grid "
        f"{p50['native'][0]:.2f} / {p50['native'][1]:.2f} ms, numpy grid {p50['numpy'][0]:.2f} / "
        f"{p50['numpy'][1]:.2f} ms (in turns); phase 4 (native grid) {p50_phase4:.2f} ms; {card}")

    def config(name, steps, model_kw=None, **adapt):
        base = dict(adapt_mode="VS+ER", ood_threshold=1e9, train_dataset_path=train,
                    train_dataset_name="Synthetic", train_split="synth", num_steps=steps,
                    ovs_buffer_size=2, ovs_validate_hz=4, eval_hz=steps, skip_initial_eval=True)
        base.update(adapt)
        model = dict(k=4, input_scale=0, compute_dtype="bfloat16", fused_siamese=True,
                     s2d_refinement=True)
        model.update(model_kw or {})
        return ExperimentConfig(
            model_name=name, log_dir=os.path.join(root, "logs12"), num_epochs=1,
            log_frequency=4, load_weights_folder=weights, model=ModelConfig(**model),
            optim=OptimConfig(learning_rate=LR, clip_grad_norm=True),
            data=DataConfig(dataset_path=novel, dataset_name="Synthetic", split="synth",
                            height=h, width=w, batch_size=1, num_workers=4),
            adapt=AdaptConfig(**base))

    def check_log(label, ss, n_rows):
        log_rows = ss.log[:int(ss.log_pos)].cpu().numpy()
        if len(log_rows) != n_rows or not np.isfinite(log_rows).all():
            raise AssertionError(f"{label}: ring log of {len(log_rows)} rows (want {n_rows}) "
                                 f"or not finite")
        return log_rows

    # (b) engine="pytree": the flat engine with the replay frame as a
    # second, sequential train-mode forward (fused_er_forward=False, float32
    # frames; engine/flat_stream.py). The bare step (launches per step, one
    # step with the kernels against the plain versions), then the driver.
    model = random_init_(StereoModel(k=4, dtype=torch.bfloat16, device=dev, fused_siamese=True,
                                     fused_tower=True), torch.Generator().manual_seed(seed + 9))
    ss = init_flat_stream_state(model, LR, 16, h, w, 64, seed=seed, device=dev)
    options = dict(use_er=True, use_vs=True, ood_threshold=12.76, clip_grad_norm=True,
                   fused_er_forward=False)
    adapt = make_flat_streaming_steps(model, 0, 4, **options)[0]
    rng = np.random.RandomState(seed + 12)
    to_dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)

    def frame():
        """A stream frame and a replay frame: (left, right, gt) each."""
        return tuple(to_dev(rng.rand(1, h, w, c) * scale)
                     for _ in range(2) for c, scale in ((3, 1), (3, 1), (1, 60)))

    frame_a, frame_b = frame(), frame()
    times = []
    for i in range(WARMUP_STEPS + PYTREE_STEPS):
        if i == WARMUP_STEPS:
            reset()
        t0 = time.perf_counter()
        ss = adapt(ss, *frame_a, 0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_step = {name: c / PYTREE_STEPS for name, c in counts().items()}
    for row in rows:
        row["pytree_launches"] = per_step[row["name"]]
        if f"{row['name']} backward" in per_step:
            row["backward_pytree_launches"] = per_step[f"{row['name']} backward"]
    pytree_ms = statistics.median(times[WARMUP_STEPS:])
    log(f"[rest] bare pytree adapt step at {h}x{w} k=4 bf16 (fused siamese, tower, VS+ER, the "
        f"replay frame as a second forward): median {pytree_ms:.2f} ms of {PYTREE_STEPS} after "
        f"{WARMUP_STEPS} warm-up, against phase 9's flat step {bare_ms:.2f} ms; launches per "
        "step " + ", ".join(f"{n}={c:g}" for n, c in per_step.items()) + f"; {card}")
    require_launches("bare pytree step", per_step, absent=("coarse_head",))
    if int(ss.log_pos) != WARMUP_STEPS + PYTREE_STEPS:
        raise AssertionError(f"pytree step: {int(ss.log_pos)} log rows")

    # One step with the kernels against the same step on the plain versions
    # (the sound reading) and a plain step on frame B against one on frame A
    # (the control), in bf16 and float32, with phase 9's readings and rule
    # (STEP_LIMITS tightened by PYTREE_STEP_LIMITS): every sound reading
    # within its limit, every control reading outside.
    modules = param_modules(model, ss.params)
    recorded = {}
    adam = fs.adam_masked

    def recording_adam(state, grads, do_update=None):
        recorded["grads"] = [g.detach().float().clone() for g in grads]
        return adam(state, grads, do_update)

    def one_step(plain, frame_, float32):
        m2, ss2 = fork(model, ss, float32)
        before = counts()
        fs.adam_masked = recording_adam
        try:
            with plain_versions() if plain else contextlib.nullcontext():
                ss2 = make_flat_streaming_steps(m2, 0, 4, **options)[0](ss2, *frame_, 0)
        finally:
            fs.adam_masked = adam
        if plain and counts() != before:
            raise AssertionError("the plain-version pytree step launched a kernel")
        row = ss2.log[(int(ss2.log_pos) - 1) % ss2.log.shape[0]].cpu().numpy()
        return recorded.pop("grads"), [p.detach().float() for p in ss2.params], row

    start = [p.detach().float().clone() for p in ss.params]

    def readings(got, ref):
        (g_a, p_a, row_a), (g_r, p_r, row_r) = got, ref
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
        cat = lambda ts, idx: torch.cat([ts[i].flatten() for i in idx])
        out = {"mono": rel(row_a[cols["mono_loss"]], row_r[cols["mono_loss"]]),
               "replay": rel(row_a[cols["replay_loss"]], row_r[cols["replay_loss"]]),
               "do_update": float(row_a[cols["do_update"]] != row_r[cols["do_update"]])}
        for module, idx in modules.items():
            out[f"{module} grad"] = rel_l2(cat(g_a, idx), cat(g_r, idx))
            upd = (cat(p_r, idx) - cat(start, idx)).abs().median()
            out[f"{module} param"] = ((cat(p_a, idx) - cat(p_r, idx)).abs().median()
                                      / upd).item()
        return out

    failed = []
    for label, limits in STEP_LIMITS.items():
        limits = {**limits, **PYTREE_STEP_LIMITS[label]}
        f32 = label == "float32"
        plain_a = one_step(True, frame_a, f32)
        sound = readings(one_step(False, frame_a, f32), plain_a)
        control = readings(one_step(True, frame_b, f32), plain_a)
        for key, value in sound.items():
            limit = limits.get(key)
            log(f"[rest] one pytree step {label}, kernels vs plain versions, {key}: {value:.4g}; "
                f"limit {'-' if limit is None else f'{limit:g}'}; control (plain, frame B vs A) "
                f"{control[key]:.4g}")
            if (key == "do_update" and value) or (limit is not None and value > limit):
                failed.append(f"{label} {key}: sound reading {value:.4g}")
            if limit is not None and control[key] <= limit:
                failed.append(f"{label} {key}: the control {control[key]:.4g} is within "
                              f"{limit:g}")
    if failed:
        raise AssertionError("pytree step, kernels vs plain versions: " + "; ".join(failed))
    del model, ss

    calls = {"adapt": [], "validate": 0}
    make_flat = sd.make_flat_streaming_steps

    def counted_steps(*a, **kw):
        if kw.get("fused_er_forward") or kw.get("images_uint8"):
            raise AssertionError(f"engine='pytree' built the flat engine with {kw}")
        adapt_fn, done_fn, validate_fn, make_batched = make_flat(*a, **kw)

        def adapt_c(*args):
            calls["adapt"].append(time.perf_counter())
            return adapt_fn(*args)

        def validate_c(state):
            calls["validate"] += 1
            return validate_fn(state)
        return adapt_c, done_fn, validate_c, make_batched

    sd.make_flat_streaming_steps = counted_steps
    reset()
    try:
        t0 = time.perf_counter()
        result = sd.adapt_streaming(config("pytree12", DRIVER_FRAMES[0]), engine="pytree",
                                    device=dev)
        wall = time.perf_counter() - t0
    finally:
        sd.make_flat_streaming_steps = make_flat
    check_launches("adapt_streaming(engine='pytree')", absent=("coarse_head",))
    log_rows = check_log("pytree driver", result["stream_state"], DRIVER_FRAMES[0])
    starts = calls["adapt"]
    pytree_driver_ms = statistics.median([(b - a) * 1e3 for a, b in zip(starts, starts[1:])])
    log(f"[rest] adapt_streaming(engine='pytree'), VS+ER: {result['steps']} steps in {wall:.1f} s "
        f"({result['steps_per_sec']:.2f} steps/s), {result['gradient_updates']} updates, "
        f"{calls['validate']} validations, {len(log_rows)} log rows; did_add "
        f"{int(log_rows[:, cols['did_add']].sum())}; median interval between adapt steps "
        f"{pytree_driver_ms:.2f} ms against phase 10's flat driver {driver_ms:.2f} ms; {card}")
    if not (len(starts) > 1 and calls["validate"] and result["gradient_updates"]):
        raise AssertionError("pytree driver: no adapt step, validation or update")

    # (c) The device cache against the upload path at input_scale 0. The
    # cache holds uint8 frames and forces transfer_uint8, so the upload path
    # it replaces uploads uint8 frames: with deterministic cuDNN, every
    # input of every step, the ring log and the parameters must be bitwise
    # equal.
    runs = {}
    make_flat = sd.make_flat_streaming_steps
    cudnn_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for label, kw in (("cached", dict(device_cache=True)),
                          ("upload", dict(transfer_uint8=True))):
            inputs, starts = [], []

            def recorded_flat(*a, **k):
                steps = list(make_flat(*a, **k))

                def wrap(fn, timed):
                    def call(*args):
                        if timed:
                            starts.append(time.perf_counter())
                        inputs.append([x.clone() for x in args[1:-1]])
                        return fn(*args)
                    return call
                steps[0], steps[1] = wrap(steps[0], True), wrap(steps[1], False)
                return tuple(steps)

            sd.make_flat_streaming_steps = recorded_flat
            reset()
            try:
                result = sd.adapt_streaming(config(f"cache12_{label.replace(' ', '_')}",
                                                   DRIVER_FRAMES[0]),
                                            fused_er_forward=True, device=dev, **kw)
            finally:
                sd.make_flat_streaming_steps = make_flat
            check_launches(f"flat driver, {label}", absent=("coarse_head",))
            check_log(f"flat driver, {label}", result["stream_state"], DRIVER_FRAMES[0])
            runs[label] = (result["stream_state"], inputs,
                           statistics.median([(b - a) * 1e3 for a, b in zip(starts, starts[1:])]))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags

    (ss_c, inputs_c, _), (ss_u, inputs_u, _) = runs["cached"], runs["upload"]
    same_inputs = len(inputs_c) == len(inputs_u) and all(
        torch.equal(x, y) for xs, ys in zip(inputs_c, inputs_u) for x, y in zip(xs, ys))
    same_log = torch.equal(ss_c.log, ss_u.log)
    same_params = all(torch.equal(x, y) for x, y in zip(ss_c.params, ss_u.params))
    drift = max((x.float() - y.float()).abs().max().item()
                for x, y in zip(ss_c.params, ss_u.params))
    log(f"[rest] flat driver, device cache against the uint8 upload path ({DRIVER_FRAMES[0]} "
        f"steps, VS+ER, fused ER forward, deterministic cuDNN): bitwise equal step inputs "
        f"{same_inputs}, ring log {same_log}, parameters {same_params} (max difference "
        f"{drift:.3g}); median interval between adapt steps: "
        + ", ".join(f"{label} {run[2]:.2f} ms" for label, run in runs.items())
        + f", phase 10's driver {driver_ms:.2f} ms; {card}")
    if not (same_inputs and same_log and same_params):
        raise AssertionError("device cache vs the upload path: the cached run differs")
    # The uint8 frames' dequantization on the card against the dataset's
    # float32 division on the host, level by level.
    levels = torch.arange(256, dtype=torch.uint8)
    host = torch.from_numpy(levels.numpy().astype(np.float32) / 255.0)
    same = {"dequantize_u8": int((dequantize_u8(levels.to(dev)).cpu() == host).sum()),
            "/ 255.0 (a Python scalar)": int(((levels.to(dev).float() / 255.0).cpu()
                                              == host).sum())}
    log("[rest] uint8 -> float32 / 255 on the card, levels equal to the host's float32 "
        "division: " + ", ".join(f"{name} {n} of 256" for name, n in same.items()))
    if same["dequantize_u8"] != 256:
        raise AssertionError(f"dequantize_u8 on the card: {same}")
    stream_ds = StereoDataset(novel, "Synthetic", "synth", h, w, "train", scales=[0, 4],
                              load_disp_right=False, color_uint8=True)
    cache_bytes = DeviceStreamCache(stream_ds, 0, True, dev, num_workers=4).nbytes
    log(f"[rest] device cache: the {len(stream_ds)}-frame stream holds {cache_bytes / 1e6:.2f} MB "
        f"on the card (uint8 colour, float32 ground truth)")

    # (d) The reconstruction gate: an AE trained a few steps on the card,
    # the threshold at the median of its scores on the novel stream, then
    # the classic engine gated by it.
    def loader(root_, subsplit, batch):
        ds = StereoDataset(root_, "Synthetic", "synth", h, w, subsplit, scales=[0, 4],
                           load_disp_right=False)
        return BatchLoader(ds, batch, shuffle=False, num_workers=4)

    t0 = time.perf_counter()
    ae, ae_weights, ae_losses = train_autoencoder(loader(train16, "train", 2), num_steps=6,
                                                  learning_rate=1e-3, seed=seed, device=dev)
    scores = reconstruction_scores(ae, None, loader(novel, "train", 4))
    threshold = float(np.median(scores))
    log(f"[rest] train_autoencoder (AE, latent 32, 4 stages) at {h}x{w}, 6 steps of batch 2 on "
        f"the card: losses {', '.join(f'{x:.5f}' for x in ae_losses)}, "
        f"{time.perf_counter() - t0:.1f} s; novel-domain scores "
        f"{', '.join(f'{x:.5f}' for x in scores)}, threshold (median) {threshold:.5f}")
    if not np.isfinite(ae_losses).all() or not np.isfinite(scores).all():
        raise AssertionError("autoencoder: non-finite losses or scores")
    adapt_mod = importlib.import_module("adaptive_stereo_tpu_torch.engine.adapt")
    records = []
    reset()
    gated = config("gate12", 8, gate="reconstruction", ood_threshold=threshold,
                   train_dataset_path=train16)
    summary = adapt_mod.adapt(gated, gate_model=ae, gate_variables=ae_weights, gate_kind="ae",
                              step_hook=lambda i, r: records.append(r), device=dev)
    check_launches("adapt (classic, reconstruction gate)", absent=("coarse_head",))
    novel_flags = [r["novel"] for r in records]
    log(f"[rest] classic adapt with the reconstruction gate: {summary['steps']} steps, "
        f"{summary['gradient_updates']} updates, novel {novel_flags}, states "
        f"{[r['state'] for r in records]}")
    if not (any(novel_flags) and not all(novel_flags) and summary["gradient_updates"]
            and all(np.isfinite(r["mono_loss"]) for r in records)):
        raise AssertionError("reconstruction gate: both branches must fire")

    # (e) The FCS OOD analysis on both domains (eval forwards).
    model = StereoModel(k=4, dtype=torch.bfloat16, device=dev, fused_siamese=True,
                        fused_tower=True)
    model.load_state_dicts(*state_dicts_from_jax(load_variables(weights), 4))
    reset()
    fcs = {name: compute_fcs_for_loader(model, None, loader(path, "train", 4), 0, 4)
           for name, path in (("training", train16), ("novel", novel))}
    check_launches("compute_fcs_for_loader", absent=("coarse_head", "tower_backward",
                                                      "difference_cost_volume backward",
                                                      "soft_argmin_fcs backward"))
    CARRY["fcs"] = fcs
    ood = derive_percentile_threshold(fcs["training"], 0.05)
    pr = compute_precision_recall(fcs["training"], fcs["novel"], ood)
    log("[rest] FCS per image: " + "; ".join(
        f"{name} domain " + ", ".join(f"{v:.4f}" for v in values) for name, values in fcs.items())
        + f"; 5th-percentile threshold {ood:.4f}; precision / recall at it {pr[0]:.3f} / "
        f"{pr[1]:.3f}")
    if not (np.isfinite(ood) and all(np.isfinite(v).all() for v in fcs.values())):
        raise AssertionError("OOD analysis: non-finite FCS or threshold")
    log(f"[rest] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return pytree_ms


# Phase 13: the fleet (parallel/). bench.py's step configuration for every
# stream; FLEET_N streams timed per mode, FLEET_STEPS steps after
# WARMUP_STEPS; fleet_adapt over FLEET_ADAPT_STEPS frames per stream.
FLEET_OPTIONS = dict(input_scale=0, k=4, use_er=True, use_vs=True, ood_threshold=12.76,
                     clip_grad_norm=True, warp_precision="highest")
FLEET_N = (1, 2, 4)
FLEET_STEPS = 20
FLEET_ADAPT_STEPS = 4
FLEET_MODES = ("per_stream", "shared")
FLEET_SPAWN_TIMEOUT_S = 300
# (a) make_fleet_fwd_bwd against make_adapt_forward_backward on each stream
# alone: JAX's bands (scripts/bench_multistream_tpu.py --certify).
CERTIFY_RTOL, CERTIFY_ATOL = 5e-3, 1e-5
# (b) one fused fleet step (N=2) with the kernels against the same step on
# the plain versions, per mode, dtype and module, phase 9's readings and
# rule: each limit the geometric mean, rounded down, of the sound reading
# and the control's on an H100 (PERF.md, §6); a reading whose control
# was less than 3x it is printed only (shared mode's bf16 tower: 2.7x).
# Shared mode's bf16 tower is held instead call by call: every kernel call
# of a shared bf16 step at N=2 and N=4 against its plain version on the
# call's own inputs (check_kernel_calls, phases 7 and 8's bands).
FLEET_STEP_LIMITS = {
    "per_stream": {
        "bfloat16": {"mono": 3.2e-4, "replay": 1.6e-3, "feature grad": 0.55,
                     "feature param": 0.069, "aggregation grad": 0.078,
                     "aggregation param": 8.6e-3, "tower grad": 0.015, "tower param": 9.3e-3},
        "float32": {"mono": 1.1e-5, "replay": 6.4e-5, "feature grad": 0.063,
                    "feature param": 8.1e-3, "aggregation grad": 9.1e-3,
                    "aggregation param": 1.2e-3, "tower grad": 1.4e-3, "tower param": 3.7e-4}},
    "shared": {
        "bfloat16": {"mono": 1.3e-4, "replay": 1.9e-3, "feature grad": 0.55,
                     "feature param": 0.068, "aggregation grad": 0.079,
                     "aggregation param": 8.7e-3},
        "float32": {"mono": 1.1e-5, "replay": 6.4e-5, "feature grad": 0.06,
                    "feature param": 7.3e-3, "aggregation grad": 8.7e-3,
                    "aggregation param": 1.0e-3, "tower grad": 1.5e-3, "tower param": 7.6e-4}},
}
# (g) two ranks against one: the per-stream values of a step within 1e-5
# absolute and relative, the parameters within 2 lr per applied update
# (plus one float32 spacing of each, per update) with a median under
# 0.1 lr (tests/test_torch_parallel.py's bands).
RANKS_TOL = dict(atol=1e-5, rtol=1e-5)


def fleet_model(seed, dev):
    """Phase 13's model and train state: bench.py's configuration (k=4,
    bf16, fused siamese, the tower) from seeded random weights."""
    from adaptive_stereo_tpu_torch.engine import create_train_state
    from adaptive_stereo_tpu_torch.models import StereoModel, random_init_

    model = random_init_(StereoModel(k=4, dtype=torch.bfloat16, device=dev, fused_siamese=True,
                                     fused_tower=True), torch.Generator().manual_seed(seed + 13))
    return model, create_train_state(model, learning_rate=LR)


def fleet_frames(rng, n, shape):
    """n streams' frames of `shape` (H, W) as numpy: colour uniform in [0,
    1], ground truth uniform in [0, 60)."""
    h, w = shape
    return {"color_l/0": rng.rand(n, h, w, 3).astype(np.float32),
            "color_r/0": rng.rand(n, h, w, 3).astype(np.float32),
            "gt_disp_l/0": (rng.rand(n, h, w, 1) * 60).astype(np.float32)}


def fleet_two_steps(model, state, mesh, seed, shape):
    """Phase 13 (g)'s run: two per-stream fleet steps of the N=2 fleet, each
    rank on its rows; returns each step's aux and the state on the host."""
    from adaptive_stereo_tpu_torch.parallel import (data_sharding, init_fleet_fcs_ema,
                                                    local_data_slice, make_fused_fleet_step)

    shard = data_sharding(mesh)
    rng = np.random.RandomState(seed + 14)
    step = make_fused_fleet_step(model, mesh, **FLEET_OPTIONS)
    ema = init_fleet_fcs_ema(2 // mesh.world_size, mesh.device)
    auxes = []
    for would in ([False, True], [False, False]):
        b, e = fleet_frames(rng, 2, shape), fleet_frames(rng, 2, shape)
        _, ema, aux = step(state, ema, {k: shard(v) for k, v in b.items()},
                           {k: shard(v) for k, v in e.items()}, local_data_slice(would, mesh),
                           local_data_slice([True, True], mesh))
        auxes.append({k: v.cpu() for k, v in aux.items()})
    out = {g: [t.detach().cpu() for t in getattr(state, g)] for g in ("params", "buffers", "m",
                                                                      "v")}
    out.update(aux=auxes, count=int(state.count))
    return out


def fleet_rank(rank, world, init_file, seed, device, shape, out_path):
    """Phase 13 (g): one rank of a two-rank gloo group on the card (NCCL
    refuses two ranks on one device), run in a spawned process."""
    from adaptive_stereo_tpu_torch.parallel import (initialize_multihost, make_mesh,
                                                    replicated_sharding)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    initialize_multihost(f"file://{init_file}", world, rank, backend="gloo")
    mesh = make_mesh(device=device)
    model, state = fleet_model(seed, mesh.device)
    replicated_sharding(mesh)(state)
    torch.save(fleet_two_steps(model, state, mesh, seed, shape), out_path)
    torch.distributed.destroy_process_group()


def fleet_phase(seed, dev, rows, card, pytree_ms, root):
    """Phase 13: the fleet and data-parallel layer (parallel/) on the card,
    with a one-rank NCCL group from make_mesh; (g) two spawned gloo ranks."""
    import multiprocessing
    import os

    import adaptive_stereo_tpu_torch.parallel.fleet as fleet_mod
    from adaptive_stereo_tpu_torch.data import StereoDataset
    from adaptive_stereo_tpu_torch.engine import (TrainState, live_buffers, live_parameters,
                                                  make_adapt_forward_backward, make_train_step)
    from adaptive_stereo_tpu_torch.parallel import (FleetStream, fleet_adapt,
                                                    init_fleet_fcs_ema, make_fleet_fwd_bwd,
                                                    make_fused_fleet_step, make_mesh,
                                                    make_parallel_train_step)

    t_phase = time.perf_counter()
    wrappers = {row["name"]: row["wrapper"] for row in rows}
    failed = []

    reset, counts = launch_counter(wrappers)

    mesh = make_mesh(device=dev)
    log(f"[fleet] mesh: rank {mesh.rank} of {mesh.world_size}, backend "
        f"{torch.distributed.get_backend()}, device {mesh.device}")
    rng = np.random.RandomState(seed + 13)
    to_dev = lambda batch: {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    pair = lambda n: tuple(to_dev(fleet_frames(rng, n, DRIVER_SHAPE)) for _ in range(2))
    model, state = fleet_model(seed, dev)

    # (a) Certification at N=2: per-stream gradients and FCS of
    # make_fleet_fwd_bwd against make_adapt_forward_backward on each stream
    # alone, from the same shared statistics.
    b, e = pair(2)
    single = make_adapt_forward_backward(model, 0, 4, use_er=True)
    grads_n, stats_n, aux_n = make_fleet_fwd_bwd(single)(state, b, e)
    shared = [t.clone() for t in state.buffers]
    for i in range(2):
        g_i, aux_i = single(state, {k: v[i:i + 1] for k, v in b.items()},
                            {k: v[i:i + 1] for k, v in e.items()})
        torch._foreach_copy_(state.buffers, shared)
        excess = max(((g - gs[i]).abs() - CERTIFY_ATOL - CERTIFY_RTOL * g.abs()).max().item()
                     for g, gs in zip(g_i, grads_n))
        fcs_err = abs(aux_i["fcs_raw"].item() - aux_n["fcs_raw"][i].item())
        bitwise = all(torch.equal(g, gs[i]) for g, gs in zip(g_i, grads_n))
        log(f"[fleet] (a) certify stream {i}: gradients bitwise equal {bitwise}, largest excess "
            f"over rtol {CERTIFY_RTOL} + atol {CERTIFY_ATOL}: {excess:.3g}; FCS "
            f"{aux_n['fcs_raw'][i].item():.6g} vs {aux_i['fcs_raw'].item():.6g}")
        if excess > 0 or fcs_err > CERTIFY_ATOL + CERTIFY_RTOL * abs(aux_i["fcs_raw"].item()):
            failed.append(f"(a) stream {i}: fleet gradients or FCS outside JAX's bands")
    del grads_n, stats_n

    # (b) One fused fleet step with the kernels against the same step on the
    # plain versions from one state, per module, in both modes, bf16 and
    # float32, beside a control (a plain step on other frames). The state
    # first takes phase 12's warm-up and counted steps (Adam's first step
    # moves every entry by +-lr, which makes the parameter readings 0).
    warm = make_fused_fleet_step(model, mesh, **FLEET_OPTIONS)
    ema = init_fleet_fcs_ema(2, dev)
    for _ in range(WARMUP_STEPS + PYTREE_STEPS):
        warm(state, ema, b, e, [False, False], [True, True])
    modules = param_modules(model, state.params)
    recorded = {}
    adam = fleet_mod.adam_masked

    def recording_adam(st, grads, do_update=None):
        recorded["grads"] = [g.detach().float().clone() for g in grads]
        return adam(st, grads, do_update)

    def fork_state(float32=False):
        m2 = copy_model(model, float32)
        return m2, TrainState(model=m2, params=live_parameters(m2), n_feature=state.n_feature,
                              buffers=live_buffers(m2), m=[t.clone() for t in state.m],
                              v=[t.clone() for t in state.v], count=state.count.clone(),
                              step=state.step.clone(), lr=state.lr.clone())

    def one_step(bn_mode, plain, frame, float32=False, would=(False, False),
                 prog=(True, True), threshold=FLEET_OPTIONS["ood_threshold"], remat=False):
        m2, st2 = fork_state(float32)
        before = counts()
        fleet_mod.adam_masked = recording_adam
        try:
            with plain_versions() if plain else contextlib.nullcontext():
                step = make_fused_fleet_step(m2, mesh, **{**FLEET_OPTIONS, "bn_mode": bn_mode,
                                                          "ood_threshold": threshold,
                                                          "remat": remat})
                _, _, aux = step(st2, init_fleet_fcs_ema(2, dev), *frame, list(would),
                                 list(prog))
        finally:
            fleet_mod.adam_masked = adam
        if plain and counts() != before:
            raise AssertionError("the plain-version fleet step launched a kernel")
        return recorded.pop("grads"), [p.detach().float() for p in st2.params], aux, st2

    start = [p.detach().float().clone() for p in state.params]

    def readings(got, ref):
        (g_a, p_a, aux_a, _), (g_r, p_r, aux_r, _) = got, ref
        rel = lambda key: ((aux_a[key] - aux_r[key]).abs() / aux_r[key].abs().clamp(min=1e-12)
                           ).max().item()
        cat = lambda ts, idx: torch.cat([ts[i].flatten() for i in idx])
        out = {"mono": rel("Monodepth/total_loss"), "replay": rel("Replay/total_loss"),
               "do_update": float(not torch.equal(aux_a["do_update"], aux_r["do_update"]))}
        for module, idx in modules.items():
            out[f"{module} grad"] = rel_l2(cat(g_a, idx), cat(g_r, idx))
            upd = (cat(p_r, idx) - cat(start, idx)).abs().median()
            out[f"{module} param"] = ((cat(p_a, idx) - cat(p_r, idx)).abs().median()
                                      / upd).item()
        return out

    frame_a = (b, e)
    frame_b = pair(2)
    for bn_mode in FLEET_MODES:
        for label, limits in FLEET_STEP_LIMITS[bn_mode].items():
            f32 = label == "float32"
            plain_a = one_step(bn_mode, True, frame_a, f32)
            sound = readings(one_step(bn_mode, False, frame_a, f32), plain_a)
            control = readings(one_step(bn_mode, True, frame_b, f32), plain_a)
            for key, value in sound.items():
                limit = limits.get(key)
                log(f"[fleet] (b) one fleet step N=2 {bn_mode} {label}, kernels vs plain "
                    f"versions, {key}: {value:.4g}; limit {'-' if limit is None else f'{limit:g}'}"
                    f"; control (plain, frames B vs A) {control[key]:.4g}")
                if (key == "do_update" and value) or (limit is not None and value > limit):
                    failed.append(f"(b) {bn_mode} {label} {key}: sound reading {value:.4g}")
                if limit is not None and control[key] <= limit:
                    failed.append(f"(b) {bn_mode} {label} {key}: the control {control[key]:.4g} "
                                  f"is within {limit:g}")
    # Every kernel call of one bf16 shared-mode step (the merged forwards at
    # batch N, the shapes (d) times) at N=2 and N=4, each held against its
    # plain version on that call's own inputs.
    for n in (2, 4):
        m2, st2 = fork_state()
        step = make_fused_fleet_step(m2, mesh, **{**FLEET_OPTIONS, "bn_mode": "shared"})
        calls = {}
        with captured_kernel_calls(calls):
            step(st2, init_fleet_fcs_ema(n, dev), *(frame_a if n == 2 else pair(n)),
                 [False] * n, [True] * n)
        torch.cuda.synchronize()
        failed += [f"(b) shared bf16 N={n}: {name}" for name in check_kernel_calls(
            calls, f"fleet shared N={n}", forwards=2, tower=True, backward=True)]
        del m2, st2, calls

    # (c) Masks: every stream DONE, or every stream's frame diverted, leaves
    # the parameters, the Adam moments and the count bitwise unchanged (and
    # with every stream DONE the statistics); a mixed mask moves them.
    for bn_mode in FLEET_MODES:
        for label, would, prog, threshold, want in (
                ("every stream DONE", (False, False), (False, False), 12.76, True),
                ("every frame diverted", (True, True), (True, True), 1e9, True),
                ("mixed", (True, False), (True, True), 1e9, False)):
            _, _, aux, st2 = one_step(bn_mode, False, frame_a, would=would, prog=prog,
                                      threshold=threshold)
            same = {g: all(torch.equal(x, y) for x, y in zip(getattr(st2, g), getattr(state, g)))
                    for g in ("params", "m", "v", "buffers")}
            same["count"] = torch.equal(st2.count, state.count)
            log(f"[fleet] (c) {bn_mode}, {label}: do_update {aux['do_update'].tolist()}; "
                f"unchanged " + ", ".join(f"{g} {v}" for g, v in same.items()))
            kept = [same[g] for g in ("params", "m", "v", "count")]
            if label == "every stream DONE":
                kept.append(same["buffers"])
            if (want and not all(kept)) or (not want and any(kept)):
                failed.append(f"(c) {bn_mode} {label}: {same}")
    # remat changes memory, never results: one step with and without it,
    # deterministic cuDNN, the same bits (the running statistics included).
    cudnn_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for bn_mode in FLEET_MODES:
            runs = []
            for remat in (False, True):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _, _, aux, st2 = one_step(bn_mode, False, frame_a, remat=remat)
                torch.cuda.synchronize()
                runs.append((st2, aux, torch.cuda.max_memory_allocated() / 2 ** 30))
            (st_a, aux_a, mem_a), (st_b, aux_b, mem_b) = runs
            same = all(torch.equal(x, y) for g in ("params", "m", "v", "buffers")
                       for x, y in zip(getattr(st_a, g), getattr(st_b, g)))
            same &= all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a)
            log(f"[fleet] (c) {bn_mode}, remat=True against remat=False, N=2: the same bits "
                f"{same}; peak memory {mem_b:.2f} against {mem_a:.2f} GiB")
            if not same:
                failed.append(f"(c) {bn_mode}: remat changed a result")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    del frame_b

    # (d) Time per fleet step for N in FLEET_N, in both modes.
    pytree = {row["name"]: row["pytree_launches"] for row in rows}
    pytree.update({f"{row['name']} backward": row["backward_pytree_launches"] for row in rows
                   if "backward_pytree_launches" in row})
    fleet_launches = {}
    timings = {}
    for bn_mode in FLEET_MODES:
        for n in FLEET_N:
            step = make_fused_fleet_step(model, mesh, bn_mode=bn_mode, **FLEET_OPTIONS)
            frame = pair(n)
            ema = init_fleet_fcs_ema(n, dev)
            args = (ema, *frame, [False] * n, [True] * n)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for i in range(WARMUP_STEPS + FLEET_STEPS):
                if i == WARMUP_STEPS:
                    reset()
                    mesh.all_reduces = 0
                t0 = time.perf_counter()
                step(state, *args)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            per_step = {name: c / FLEET_STEPS for name, c in counts().items()}
            reduces = mesh.all_reduces / FLEET_STEPS
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            require_launches(f"fleet step {bn_mode} N={n}", per_step, absent=("coarse_head",))
            want = {k: v * (n if bn_mode == "per_stream" else 1) for k, v in pytree.items()}
            med = statistics.median(times[WARMUP_STEPS:])
            log(f"[fleet] (d) {bn_mode} N={n}: median {med:.2f} ms per fleet step "
                f"({med / n:.2f} ms per stream) of {FLEET_STEPS} after {WARMUP_STEPS} warm-up; "
                f"peak memory {peak:.2f} GiB; all_reduces per step {reduces:g}; launches per "
                "step " + ", ".join(f"{k}={v:g}" for k, v in per_step.items())
                + f" (as the pytree step's{' x N' if bn_mode == 'per_stream' else ''}: "
                f"{per_step == want}); {card}")
            if per_step != want:
                failed.append(f"(d) {bn_mode} N={n}: launches per step {per_step}, want {want}")
            if reduces != 1:
                failed.append(f"(d) {bn_mode} N={n}: {reduces} all_reduces per step")
            log(f"[profile] fleet step {bn_mode} N={n}")
            operators, launches, dev_ms, busy = profile_breakdown(
                lambda: step(state, *args), repeats=3, top=6, unit="fleet step")
            timings[(bn_mode, n)] = (med, dev_ms, busy, peak, operators, launches)
            if n == FLEET_N[-1]:
                fleet_launches[bn_mode] = per_step
    for row in rows:
        row["fleet_launches"] = {m: fleet_launches[m][row["name"]] for m in FLEET_MODES}
        if f"{row['name']} backward" in fleet_launches[FLEET_MODES[0]]:
            row["backward_fleet_launches"] = {
                m: fleet_launches[m][f"{row['name']} backward"] for m in FLEET_MODES}
    log("[fleet] (d) summary, ms per fleet step / per stream / device ms / busy % / peak GiB / "
        "host operators / kernel launches (cudaLaunchKernel) per step: "
        + "; ".join(f"{m} N={n} {t[0]:.2f} / {t[0] / n:.2f} / "
                    + " / ".join("-" if v is None else f"{v:.{d}f}"
                                 for v, d in zip(t[1:], (3, 1, 2, 0, 0)))
                    for (m, n), t in timings.items())
        + f"; phase 12's bare pytree step {pytree_ms:.2f} ms; {card}")

    # (e) fleet_adapt: 4 streams on phase 10's novel domain (each from
    # another frame), replay from its training domain.
    h, w = DRIVER_SHAPE

    class Offset:
        """A dataset read from frame `offset` on, wrapping around."""

        def __init__(self, ds, offset):
            self.ds, self.offset = ds, offset

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            return self.ds[(i + self.offset) % len(self.ds)]

    novel_ds, train_ds = (StereoDataset(os.path.join(root, name), "Synthetic", "synth", h, w,
                                        "train", scales=[0], load_disp_right=False)
                          for name in ("novel", "train"))
    streams = [FleetStream(Offset(novel_ds, 3 * i), f"cam{i}", er_dataset=Offset(train_ds, i))
               for i in range(4)]
    reset()
    t0 = time.perf_counter()
    result = fleet_adapt(model, state, streams, 0, 4, num_steps=FLEET_ADAPT_STEPS,
                         ood_threshold=1e9, adapt_mode="VS+ER", ovs_buffer_size=2,
                         ovs_validate_hz=2, clip_grad_norm=True, mesh=mesh, seed=seed)
    wall = time.perf_counter() - t0
    got = counts()
    log(f"[fleet] (e) fleet_adapt, 4 streams x {FLEET_ADAPT_STEPS} steps (VS+ER, reservoir 2, "
        f"validation every 2 steps) in {wall:.1f} s: {result['streams']}; kernel launches "
        + ", ".join(f"{k}={v}" for k, v in got.items()))
    require_launches("fleet_adapt", got, absent=("coarse_head",))
    if any(s["steps"] != FLEET_ADAPT_STEPS for s in result["streams"]) or len(
            result["streams"]) != 4:
        failed.append(f"(e) fleet_adapt summaries: {result['streams']}")

    # (f) make_parallel_train_step at batch 8 with one rank against
    # make_train_step from the same state: bit for bit (deterministic cuDNN).
    cudnn_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        batch = train_batch(root, range(TRAIN_BATCH), dev)
        runs = []
        for make in (lambda m: make_parallel_train_step(m, mesh, 0, [0, 4], True),
                     lambda m: make_train_step(m, 0, [0, 4], True)):
            m_f, st_f = fleet_model(seed, dev)
            st_f, losses = make(m_f)(st_f, batch)
            runs.append((st_f, losses))
        (st_p, l_p), (st_t, l_t) = runs
        same = {g: all(torch.equal(x, y) for x, y in zip(getattr(st_p, g), getattr(st_t, g)))
                for g in ("params", "buffers", "m", "v")}
        same["losses"] = all(torch.equal(l_p[k], l_t[k]) for k in l_t) and l_p.keys() == l_t.keys()
        log(f"[fleet] (f) make_parallel_train_step (one rank) vs make_train_step, batch "
            f"{TRAIN_BATCH}: bitwise equal " + ", ".join(f"{g} {v}" for g, v in same.items())
            + f"; total loss {l_p['total_loss'].item():.6g}")
        if not all(same.values()):
            failed.append(f"(f) parallel train step vs train step: {same}")
        del runs, st_p, st_t

        # (g) Two spawned ranks (gloo on CUDA tensors, one stream each)
        # against the one-rank run of the same two steps.
        m_g, st_g = fleet_model(seed, dev)
        ref = fleet_two_steps(m_g, st_g, mesh, seed, DRIVER_SHAPE)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    work = tempfile.mkdtemp(prefix="chip_smoke_fleet_", dir=root)
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=fleet_rank, args=(r, 2, os.path.join(work, "store"), seed,
                                                   str(dev), DRIVER_SHAPE,
                                                   os.path.join(work, f"rank{r}.pt")))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(FLEET_SPAWN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"(g) the two ranks exited with {codes}")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(2)]
    same_ranks = all(torch.equal(x, y) for g in ("params", "buffers", "m", "v")
                     for x, y in zip(ranks[0][g], ranks[1][g]))
    bitwise = all(torch.equal(x, y) for g in ("params", "buffers", "m", "v")
                  for x, y in zip(ranks[0][g], ref[g]))
    updates = ref["count"]
    diffs = torch.cat([(x - y).abs().flatten() for x, y in zip(ranks[0]["params"], ref["params"])])
    spacing = torch.cat([updates * torch.from_numpy(np.spacing(y.abs().numpy())).flatten()
                         for y in ref["params"]])
    aux_ok = True
    for i, aux in enumerate(ref["aux"]):
        merged = {k: torch.cat([r["aux"][i][k] for r in ranks]) for k in aux}
        for k, v in aux.items():
            if v.dtype == torch.bool:
                aux_ok &= torch.equal(merged[k], v)
            else:
                aux_ok &= bool(((merged[k] - v).abs() <= RANKS_TOL["atol"]
                                + RANKS_TOL["rtol"] * v.abs()).all())
    log(f"[fleet] (g) two spawned ranks (gloo on CUDA tensors, one stream each, 2 per-stream "
        f"steps, {updates} updates) against one rank (NCCL) in {time.perf_counter() - t0:.1f} s: "
        f"ranks agree bitwise {same_ranks}; bitwise equal to one rank {bitwise}; parameters max "
        f"diff {diffs.max().item():.3g}, median {diffs.median().item():.3g}; per-stream values "
        f"within {RANKS_TOL}: {aux_ok}")
    if not (same_ranks and aux_ok and updates and bool((diffs <= 2 * LR * updates + spacing).all())
            and diffs.median().item() <= 0.1 * LR):
        failed.append("(g) two ranks vs one rank outside the stated band")
    torch.distributed.destroy_process_group()
    log(f"[fleet] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError("phase 13 (fleet): " + "; ".join(failed))

def check_pdf(path, texts):
    """Fail unless path is a PDF whose every xref offset lands on its
    object and whose content stream draws `texts` (the structural check of
    tests/test_torch_analysis.py)."""
    import re

    with open(path, "rb") as f:
        data = f.read()
    start = int(re.search(rb"startxref\s+(\d+)", data).group(1))
    lines = data[start:].split(b"\n")
    ok = data.startswith(b"%PDF-") and lines[0] == b"xref"
    count = int(lines[1].split()[1]) if ok else 0
    for i, entry in enumerate(lines[2:2 + count]):
        offset, _gen, kind = entry.split()
        ok &= len(entry) == 19 and (kind == b"f" or data[int(offset):].startswith(
            f"{i} 0 obj".encode()))
    stream = data[data.find(b"stream\n") + 7:data.find(b"endstream")]
    missing = [t for t in texts if "({}) Tj".format(
        t.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")).encode() not in stream]
    if not ok or count < 6 or missing:
        raise AssertionError(f"{path}: not a sound PDF (xref ok {ok}, {count} entries) or "
                             f"texts missing {missing}")
    return len(data)


@contextlib.contextmanager
def plain_coarse_head():
    """Route the fused coarse head to its plain version (plain_versions()
    covers kernels 1, 2, 3 and 5)."""
    import adaptive_stereo_tpu_torch.models.aggregation as agg
    from adaptive_stereo_tpu_torch.ops.cuda import coarse_head_ref

    saved = agg.coarse_head_cuda
    agg.coarse_head_cuda = coarse_head_ref
    try:
        yield
    finally:
        agg.coarse_head_cuda = saved


def analysis_phase(seed, dev, rows, card, engines, frames, root):
    """Phase 14: the rest of analysis/ on the card. engines: phase 4's
    {fused_coarse_head: StereoDepthEngine}; frames: its (left, right)
    frames; root: the datasets and weights of phases 10-14."""
    import dataclasses
    import os

    import adaptive_stereo_tpu_torch.engine.stream_driver as sd
    import adaptive_stereo_tpu_torch.experiments as experiments
    from adaptive_stereo_tpu_torch.analysis import (collate_trials, plot_fcs_histogram,
                                                    plot_precision_recall, results_to_csv)
    from adaptive_stereo_tpu_torch.analysis.cost_volume import (plot_cost_volume_slices,
                                                                save_cost_volumes)
    from adaptive_stereo_tpu_torch.analysis.profiling import achieved_flops, count_work, trace
    from adaptive_stereo_tpu_torch.analysis.results import (plot_adaptation_curves,
                                                            plot_gradient_updates_bar)
    from adaptive_stereo_tpu_torch.analysis.tb_extract import read_scalars, scalars_to_csv
    from adaptive_stereo_tpu_torch.data import BatchLoader, StereoDataset
    from adaptive_stereo_tpu_torch.engine import init_flat_stream_state, make_flat_streaming_steps
    from adaptive_stereo_tpu_torch.models import StereoModel, random_init_
    from adaptive_stereo_tpu_torch.ops.cuda import aggregation_flops, coarse_head_flops
    from adaptive_stereo_tpu_torch.utils.event_file import EventFileWriter

    t_phase = time.perf_counter()
    wrappers = {row["name"]: row["wrapper"] for row in rows}
    out = os.path.join(root, "analysis14")
    peak = PEAK_OPS_PER_S["bf16_tensor"]

    reset, counts = launch_counter(wrappers)

    # (a) Cost volumes: save_cost_volumes on phase 4's default-head model
    # (320x1216, k=4, bf16) over CV_FRAMES synthetic frames, every kernel
    # call held against its plain version, the dumps against the
    # aggregation kernel's outputs; then the slice plots.
    engine = engines[False]
    cfg = engine.config
    h, w, k = cfg.model_input_height, cfg.model_input_width, cfg.stereonet_k
    if (h, w) != CV_SHAPE:
        raise AssertionError(f"phase 14's dataset is {CV_SHAPE}, the serving input {(h, w)}")
    ds = StereoDataset(os.path.join(root, "serve14"), "Synthetic", "synth", h, w, "train",
                       scales=[0, k], load_disp_right=False)
    calls = {}
    cv_dir = os.path.join(out, "cost_volumes")
    reset()
    t0 = time.perf_counter()
    with captured_kernel_calls(calls):
        saved = save_cost_volumes(engine.model, None, BatchLoader(ds, 1, shuffle=False,
                                                                  num_workers=2),
                                  cv_dir, cfg.input_scale, k, CV_FRAMES)
    torch.cuda.synchronize()
    cv_s = time.perf_counter() - t0
    got = counts()
    num_disp = engine.model.stereo_net.num_disp
    per_frame = {"difference_cost_volume": 1, "aggregate_cost_volume": 5, "soft_argmin_fcs": 1}
    want = {name: CV_FRAMES * per_frame.get(name, 0) for name in got}
    log(f"[analysis] save_cost_volumes: {saved} frames {h}x{w} k={k} {cfg.compute_dtype}, D = "
        f"{num_disp}, {cv_s:.2f} s; kernel launches "
        + ", ".join(f"{n}={c}" for n, c in got.items()))
    expect_launches("save_cost_volumes", got, want)
    failed = check_kernel_calls(calls, "analysis", CV_FRAMES, tower=False, backward=False)
    if saved != CV_FRAMES or failed:
        raise AssertionError(f"save_cost_volumes: {saved} saved; kernel calls outside their "
                             f"bands: {failed}")
    equal = []
    for i, rec in enumerate(calls["aggregation"]):
        dump = np.load(os.path.join(cv_dir, f"{i}_cost_volume.npy"))
        equal.append(dump.shape == (num_disp, h // 2 ** k, w // 2 ** k) and torch.equal(
            torch.from_numpy(dump), rec["out"][0][0].float().cpu()))
    log(f"[analysis] dumped volumes bitwise equal to the aggregation kernel's outputs: {equal}")
    if not all(equal):
        raise AssertionError("a dumped cost volume differs from the kernel's output")
    t0 = time.perf_counter()
    plot_cost_volume_slices(cv_dir, saved)
    sizes = [check_pdf(os.path.join(cv_dir, f"{i}_cost_volume_slice.pdf"),
                       ["disparity", "feature similarity score C(u, v)", "max", "mean"])
             for i in range(saved)]
    log(f"[analysis] plot_cost_volume_slices: {saved} PDFs ({min(sizes)}-{max(sizes)} bytes) "
        f"in {time.perf_counter() - t0:.2f} s")

    # (b) cost_analysis and achieved_flops of three workloads, the flops
    # with the kernels against the same call on the plain versions.
    left, right = (torch.from_numpy(x[None]).to(dev) for x in frames[0])

    def forward(model):
        def fn():
            with torch.no_grad():
                return model(left, right)
        return fn

    dh, dw = DRIVER_SHAPE
    step_model = random_init_(StereoModel(k=4, input_scale=0, dtype=torch.bfloat16, device=dev,
                                          fused_siamese=True, fused_tower=True),
                              torch.Generator().manual_seed(seed + 9))
    adapt = make_flat_streaming_steps(step_model, 0, 4, use_er=True, use_vs=True,
                                      ood_threshold=12.76, clip_grad_norm=True,
                                      fused_er_forward=True)[0]
    rng = np.random.RandomState(seed + 14)
    to_dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    l9, r9, gt9 = to_dev(rng.rand(1, dh, dw, 3)), to_dev(rng.rand(1, dh, dw, 3)), to_dev(
        rng.rand(1, dh, dw, 1) * 60)
    state = [init_flat_stream_state(step_model, LR, 16, dh, dw, 64, seed=seed, device=dev)]

    def step():
        state[0] = adapt(state[0], l9, r9, gt9, l9, r9, gt9, 0)
        return state[0].log

    hc, wc = h // 2 ** k, w // 2 ** k
    workloads = [
        ("serving forward, default head", forward(engines[False].model), "forward",
         {"aggregate_cost_volume": aggregation_flops(1, num_disp, hc, wc),
          "difference_cost_volume": 0, "soft_argmin_fcs": 0}),
        ("serving forward, fused head", forward(engines[True].model), "forward",
         {"coarse_head": coarse_head_flops(1, hc, wc, num_disp)}),
        ("adapt step (phase 9's)", step, "step", None)]
    for label, fn, kind, per_call in workloads:
        fn()
        torch.cuda.synchronize()
        kern = count_work(fn)
        with plain_versions(), plain_coarse_head():
            plain = count_work(fn)
        flops = kern["aten_flops"] + kern["kernel_flops"]
        plain_flops = plain["aten_flops"] + plain["kernel_flops"]
        decomposed = (None if per_call is None else
                      sum(kern["kernel_calls"].get(n, 0) * f for n, f in per_call.items()))
        stats = achieved_flops(fn, iters=PROFILE_ITERS[kind], device=dev)
        log(f"[analysis] {label}: flops {flops} (aten {kern['aten_flops']} + the wrappers' "
            f"{kern['kernel_flops']}: " + ", ".join(
                f"{n} {c} calls {kern['kernel_flops_by_name'][n]}"
                for n, c in sorted(kern["kernel_calls"].items()))
            + f"); on the plain versions {plain_flops}; bytes accessed "
            f"{kern['aten_bytes'] + kern['kernel_bytes']} (plain {plain['aten_bytes']}); "
            f"achieved_flops: seconds_per_call {stats['seconds_per_call']!r}, model_flops "
            f"{stats['model_flops']!r}, achieved_tflops {stats['achieved_tflops']!r} "
            f"({100 * stats['achieved_tflops'] * 1e12 / peak:.3f} % of the bf16 dense peak "
            f"{peak / 1e12:g} TFLOP/s, host clock); {card}")
        if flops != plain_flops or stats["model_flops"] != flops or plain["kernel_flops"] or (
                decomposed is not None and decomposed != kern["kernel_flops"]):
            raise AssertionError(f"{label}: flops through the kernels {flops} (the wrappers' "
                                 f"{kern['kernel_flops']}, by their functions {decomposed}) "
                                 f"against the plain versions' {plain_flops}")
    trace_dir = os.path.join(out, "trace")
    t0 = time.perf_counter()
    trace(lambda: engine.process(*frames[0]), log_dir=trace_dir, iters=3, device=dev)
    with open(trace.last_path) as f:
        events = json.load(f)["traceEvents"]
    named = {name: sum(name in str(e.get("name", "")) for e in events) for name in TRACE_KERNELS}
    log(f"[analysis] trace of 3 served frames: {os.path.basename(trace.last_path)}, "
        f"{os.path.getsize(trace.last_path)} bytes, {len(events)} events, "
        f"{time.perf_counter() - t0:.2f} s; events naming the kernels: "
        + ", ".join(f"{n} {c}" for n, c in named.items()))
    if any(c < 3 for c in named.values()):
        raise AssertionError(f"the trace does not name the port's kernels: {named}")

    # (c) The adaptation suite on phase 10's data, its results and event files.
    novel, train = os.path.join(root, "novel"), os.path.join(root, "train")
    suite_dir = os.path.join(out, "suite")
    paper_config = experiments.adaptation_config

    def on_synthetic(*args, **kw):
        """The paper protocol's configuration on phase 10's synthetic domains."""
        c = paper_config(*args, **kw)
        return dataclasses.replace(
            c, data=dataclasses.replace(c.data, dataset_path=novel, dataset_name="Synthetic",
                                        split="synth", num_workers=4),
            adapt=dataclasses.replace(c.adapt, train_dataset_path=train,
                                      train_dataset_name="Synthetic", train_split="synth"))

    writes = {"records": 0, "bytes": 0, "seconds": 0.0}
    write = EventFileWriter._write

    def timed_write(self, event):
        t = time.perf_counter()
        before = self.bytes_written
        write(self, event)
        writes["seconds"] += time.perf_counter() - t
        writes["records"] += 1
        writes["bytes"] += self.bytes_written - before

    starts, run_firsts = [], []
    make_steps = sd.make_flat_streaming_steps

    def timed_steps(*a, **kw):
        adapt_fn, *rest = make_steps(*a, **kw)
        run_firsts.append(len(starts))

        def adapt_t(*args):
            starts.append(time.perf_counter())
            return adapt_fn(*args)
        return (adapt_t, *rest)

    reset()
    t0 = time.perf_counter()
    experiments.adaptation_config = on_synthetic
    EventFileWriter._write = timed_write
    sd.make_flat_streaming_steps = timed_steps
    try:
        trials = experiments.run_adaptation_suite(
            "flying_to_vk01", {}, os.path.join(root, "weights"), log_dir=suite_dir,
            streaming=True, device=dev, num_steps=SUITE_STEPS, height=dh, width=dw,
            eval_hz=SUITE_STEPS, ovs_validate_hz=2)
    finally:
        experiments.adaptation_config = paper_config
        EventFileWriter._write = write
        sd.make_flat_streaming_steps = make_steps
    suite_s = time.perf_counter() - t0
    got = counts()
    log(f"[analysis] run_adaptation_suite (flying_to_vk01's protocol on phase 10's domains, "
        f"{SUITE_STEPS} steps a method, {dh}x{dw}): {suite_s:.1f} s; kernel launches "
        + ", ".join(f"{n}={c}" for n, c in got.items()))
    require_launches("run_adaptation_suite", got, absent=("coarse_head", "tower_forward",
                                                           "tower_backward"))
    steps_run = len(trials) * SUITE_STEPS
    table = collate_trials(trials, steps=(SUITE_STEPS,))
    results_csv = os.path.join(out, "results.csv")
    results_to_csv(trials, results_csv, steps=(SUITE_STEPS,))
    with open(results_csv, newline="") as f:
        result_rows = list(csv.reader(f))
    plot_adaptation_curves(table, os.path.join(out, "curves.pdf"))
    plot_gradient_updates_bar(table, os.path.join(out, "bar.pdf"), step=SUITE_STEPS)
    check_pdf(os.path.join(out, "curves.pdf"), ["ADAPT domain", "TRAIN domain", "EPE"])
    check_pdf(os.path.join(out, "bar.pdf"), [f"gradient updates @ {SUITE_STEPS} steps"])
    log(f"[analysis] results.csv: {result_rows[0]}; " + "; ".join(
        ",".join(r) for r in result_rows[1:]))
    if len(result_rows) != 1 + 2 + 2 * len(trials):
        raise AssertionError(f"results.csv has {len(result_rows) - 1} rows")
    for method, path in trials.items():
        adapt_dir = os.path.join(os.path.dirname(path), "adapt")
        series = read_scalars(adapt_dir)
        with open(path, newline="") as f:
            trial_rows = list(csv.DictReader(f))
        updates = {int(r["step"]): float(r["GRADIENT_UPDATES"]) for r in trial_rows
                   if r.get("GRADIENT_UPDATES")}
        gu = dict(zip(series["GRADIENT_UPDATES"][0].tolist(),
                      series["GRADIENT_UPDATES"][1].tolist()))
        fcs_steps = series["fcs/raw"][0].tolist()
        scalars_to_csv(adapt_dir, os.path.join(out, f"{method}_scalars.csv"))
        log(f"[analysis] {method}: event files of adapt/ hold " + ", ".join(
            f"{t} x{len(v[0])}" for t, v in sorted(series.items()))
            + f"; GRADIENT_UPDATES {gu}, trials.csv {updates}")
        if fcs_steps != list(range(SUITE_STEPS)) or not updates or any(
                gu.get(s) != v for s, v in updates.items()):
            raise AssertionError(f"{method}: fcs/raw at steps {fcs_steps}, GRADIENT_UPDATES "
                                 f"{gu} against trials.csv {updates}")
    gaps = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    # Phase 15 compares its JPEG-fed suite with these intervals, within runs.
    CARRY["suite_gaps"] = [g for i, g in enumerate(gaps) if i + 1 not in run_firsts]
    p10 = CARRY["driver_gaps"]
    q = statistics.quantiles(p10, n=4)
    writer_ms = writes["seconds"] * 1e3 / steps_run
    log(f"[analysis] event files of the suite: {writes['records']} records, {writes['bytes']} "
        f"bytes, {writes['bytes'] / steps_run:.1f} bytes and {writer_ms:.4f} ms of the writer's "
        f"host time an adapt step; median interval between adapt steps in the suite's driver "
        f"{statistics.median(gaps):.2f} ms (float32, the refinement module); phase 10's run A "
        f"{statistics.median(p10):.2f} ms, quartiles {q[0]:.2f}-{q[2]:.2f} ms; {card}")
    if writer_ms > q[2] - q[0]:
        raise AssertionError(f"the event writer takes {writer_ms:.3f} ms a step, more than "
                             f"phase 10's interquartile spread {q[2] - q[0]:.3f} ms")

    # (d) The OOD plots of phase 12's FCS.
    fcs = CARRY["fcs"]
    plot_fcs_histogram(fcs["training"], fcs["novel"], os.path.join(out, "fcs_hist.pdf"))
    plot_precision_recall(fcs["training"], fcs["novel"], os.path.join(out, "pr.pdf"))
    check_pdf(os.path.join(out, "fcs_hist.pdf"), ["feature contrast score", "frequency",
                                                  "train", "novel"])
    check_pdf(os.path.join(out, "pr.pdf"), ["recall", "precision"])
    log(f"[analysis] OOD plots of phase 12's FCS ({len(fcs['training'])} training, "
        f"{len(fcs['novel'])} novel frames) written; phase 14 took "
        f"{time.perf_counter() - t_phase:.1f} s")


def generate_paper_data(root: str):
    """Start writing phase 15's data in two spawned processes: the drill's
    datasets (make_readiness_minidata, PAPER_FRAMES a split at
    PAPER_FRAME_SHAPE, the splits of PAPER_ENVIRONMENTS) under root/drill,
    and phase 0 of run_paper_scale_synth under root/synth. Returns (pool,
    futures)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from adaptive_stereo_tpu_torch.scripts import make_readiness_minidata, run_paper_scale_synth

    pool = ProcessPoolExecutor(max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    h, w = DRIVER_SHAPE
    futures = [
        pool.submit(make_readiness_minidata.make_minidata, os.path.join(root, "drill"),
                    PAPER_FRAMES, *PAPER_FRAME_SHAPE, PAPER_ENVIRONMENTS),
        pool.submit(run_paper_scale_synth.main, [
            "--work", os.path.join(root, "synth"), "--height", str(h), "--width", str(w),
            *SYNTH_FLAGS, "--through", "0"])]
    return pool, futures


def tower_chains(label, got, steps):
    """The failure, if any, of a run whose `steps` train-mode steps must
    each have launched the tower's backward chain (31 launches) once and
    its forward chain (15) at least once (eval forwards add 8 each)."""
    fwd, bwd = got["tower_forward"], got["tower_backward"]
    if bwd != 31 * steps or fwd < 15 * steps:
        return [f"{label}: tower launches {fwd} / {bwd}, want >= {15 * steps} / {31 * steps}"]
    return []


def paper_phase(seed, dev, rows, card, root):
    """Phase 15: JPEG frames in the data layer and the paper protocol's
    runners (adaptive_stereo_tpu_torch/scripts/), with their datasets
    written under root. The writers start after (a)'s host timings, so
    that no earlier phase's host-clock times run beside them."""
    import hashlib
    import os

    import adaptive_stereo_tpu_torch.engine.stream_driver as sd
    from adaptive_stereo_tpu_torch.data import (StereoDataset, decode_jpeg, encode_jpeg,
                                                read_png, write_png)
    from adaptive_stereo_tpu_torch.engine import (create_train_state, init_fcs_ema,
                                                  load_variables, make_fused_adapt_step)
    from adaptive_stereo_tpu_torch.models import StereoModel, state_dicts_from_jax
    from adaptive_stereo_tpu_torch.scripts import (run_paper_scale_synth, run_paper_suite,
                                                   synthetic_pipeline_demo)

    t_phase = time.perf_counter()
    wrappers = {row["name"]: row["wrapper"] for row in rows}
    dev_name = dev.type
    h, w = DRIVER_SHAPE
    failed = []

    reset, counts = launch_counter(wrappers)

    # (a) The JPEG decoder on this host: the seeded KITTI-size frame, encoded
    # by the port at JPEG_QUALITY 4:2:0, decodes to the pixels whose hash the
    # CPU tests hold against cv2.
    frame = jpeg_frame(seed)
    data_jpeg = encode_jpeg(frame, quality=JPEG_QUALITY, subsampling="4:2:0")
    decoded = decode_jpeg(data_jpeg)
    digest = hashlib.sha256(decoded.tobytes()).hexdigest()
    png_path = os.path.join(root, "frame.png")
    write_png(png_path, frame)
    jpeg_ms, png_ms = [], []
    for _ in range(JPEG_DECODES):
        t0 = time.perf_counter()
        decode_jpeg(data_jpeg)
        jpeg_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        read_png(png_path)
        png_ms.append((time.perf_counter() - t0) * 1e3)
    psnr = 10 * np.log10(255.0 ** 2 / np.mean((decoded.astype(np.float64) - frame) ** 2))
    log(f"[paper] (a) JPEG {JPEG_FRAME_SHAPE[0]}x{JPEG_FRAME_SHAPE[1]} 4:2:0 quality "
        f"{JPEG_QUALITY}: {len(data_jpeg)} bytes, PSNR {psnr:.2f} dB, decoded sha256 {digest} "
        f"(want {JPEG_FRAME_SHA256}); host ms a frame, median of {JPEG_DECODES}: decode_jpeg "
        f"{statistics.median(jpeg_ms):.3f} (min {min(jpeg_ms):.3f}), read_png of the same frame "
        f"{statistics.median(png_ms):.3f} (min {min(png_ms):.3f}); {card}")
    if digest != JPEG_FRAME_SHA256:
        failed.append("(a) the decoded JPEG frame's hash differs from the CPU tests'")

    t0 = time.perf_counter()
    pool, futures = generate_paper_data(root)
    for future in futures:
        if future.result() not in (None, 0):
            raise AssertionError("phase 15's data writers failed")
    pool.shutdown()
    log(f"[paper] datasets written in {time.perf_counter() - t0:.1f} s")

    # (b) The drill at real size: the port's run_paper_suite over the
    # JPEG splits make_readiness_minidata wrote, each method's launches
    # counted on its own, the intervals between adapt steps timed and split
    # as phase 10 splits them (the loader's threads decode the JPEGs).
    drill = os.path.join(root, "drill")
    per_run, starts, step_waits, call_ms = {}, [], [], []
    waits = {"loader": 0.0, "replay": 0.0}
    adapt_streaming, make_steps = sd.adapt_streaming, sd.make_flat_streaming_steps
    replay_item, loader_iter = sd._ReplayPrefetch.item, sd.BatchLoader.__iter__
    timed_replay_item, timed_loader_iter = wait_timers(waits)

    def counted(cfg, *a, **kw):
        reset()
        result = adapt_streaming(cfg, *a, **kw)
        per_run[cfg.model_name] = counts()
        return result

    def timed_steps(*a, **kw):
        adapt_fn, *rest = make_steps(*a, **kw)
        run_starts, run_waits, run_ms = [], [], []
        starts.append(run_starts)
        step_waits.append(run_waits)
        call_ms.append(run_ms)

        def adapt_t(*args):
            t = time.perf_counter()
            run_starts.append(t)
            run_waits.append(dict(waits))
            waits.update(loader=0.0, replay=0.0)
            out = adapt_fn(*args)
            run_ms.append((time.perf_counter() - t) * 1e3)
            return out
        return (adapt_t, *rest)

    argv = ["--sceneflow", os.path.join(drill, "sceneflow"),
            "--vkitti", os.path.join(drill, "vkitti"),
            "--kitti_raw", os.path.join(drill, "kitti_raw"),
            "--sf_weights", os.path.join(drill, "weights", "sf"),
            "--vk_weights", os.path.join(drill, "weights", "vk"),
            "--environments", *PAPER_ENVIRONMENTS, "--num_steps", str(PAPER_STEPS),
            "--height", str(h), "--width", str(w), "--eval_hz", "4", "--ovs_validate_hz", "2",
            "--log_dir", os.path.join(drill, "logs"), "--device", dev_name]
    t0 = time.perf_counter()
    sd.adapt_streaming, sd.make_flat_streaming_steps = counted, timed_steps
    sd._ReplayPrefetch.item, sd.BatchLoader.__iter__ = timed_replay_item, timed_loader_iter
    try:
        rc = run_paper_suite.main(argv)
    finally:
        sd.adapt_streaming, sd.make_flat_streaming_steps = adapt_streaming, make_steps
        sd._ReplayPrefetch.item, sd.BatchLoader.__iter__ = replay_item, loader_iter
    suite_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"run_paper_suite exited {rc}")
    for name, got in per_run.items():
        log(f"[paper] (b) {name}: launches " + ", ".join(f"{n}={c}" for n, c in got.items()))
        require_launches(f"drill {name}", got, absent=("coarse_head", "tower_forward",
                                                       "tower_backward"))
    methods = ("nonstop", "vs", "er", "vs+er")
    for env in PAPER_ENVIRONMENTS:
        for method in methods:
            path = os.path.join(drill, "logs", env, f"adapt_{env}_{method}", "trials.csv")
            if not os.path.exists(path) or f"adapt_{env}_{method}" not in per_run:
                failed.append(f"(b) {env} {method}: no trials.csv or no run")
    gaps = [(b - a) * 1e3 for run in starts for a, b in zip(run, run[1:])]
    parts = {"adapt call": [t for run in call_ms for t in run[:-1]],
             "loader wait": [p["loader"] * 1e3 for run in step_waits for p in run[1:]],
             "replay frame wait": [p["replay"] * 1e3 for run in step_waits for p in run[1:]]}
    parts["rest"] = [g - sum(v[i] for v in parts.values()) for i, g in enumerate(gaps)]
    p14 = CARRY["suite_gaps"]
    log(f"[paper] (b) run_paper_suite over {', '.join(PAPER_ENVIRONMENTS)} ({len(methods)} "
        f"methods x {PAPER_STEPS} steps, {h}x{w}, JPEG frames of {PAPER_FRAME_SHAPE[0]}x"
        f"{PAPER_FRAME_SHAPE[1]}): {suite_s:.1f} s; median interval between adapt steps on "
        f"JPEG data {statistics.median(gaps):.2f} ms over {len(gaps)} intervals beside phase "
        f"14's suite on PNG data {statistics.median(p14):.2f} ms over {len(p14)} (both float32, "
        f"the refinement module, {h}x{w}); {card}")
    log("[paper] (b) the interval between adapt steps on the loop's thread, median ms: "
        + ", ".join(f"{name} {statistics.median(v):.2f}" for name, v in parts.items())
        + "; largest loader wait " + f"{max(parts['loader wait']):.2f}, largest replay frame "
        f"wait {max(parts['replay frame wait']):.2f}")

    # One adapt step of each environment's configuration on the JPEG-loaded
    # frames (stream and replay), every kernel call against its plain version.
    variables = load_variables(os.path.join(drill, "weights", "sf"))
    pairs = (("VirtualKitti", "vkitti", "virtual_kitti_01_adapt", "SceneFlowFlying",
              "sceneflow", "sceneflow_flying_er_1000"),
             ("KittiRaw", "kitti_raw", "kitti_raw_campus_adapt", "VirtualKitti", "vkitti",
              "virtual_kitti_clone_er_1000"))

    def batch(name, sub, split, subsplit):
        ds = StereoDataset(os.path.join(drill, sub), name, split, h, w, subsplit, scales=[0, 4],
                           load_disp_left=True, load_disp_right=False)
        return {key: torch.from_numpy(v[None]).to(dev) for key, v in ds[0].items()}

    for name, sub, split, rname, rsub, rsplit in pairs:
        model = StereoModel(k=4, device=dev)
        model.load_state_dicts(*state_dicts_from_jax(variables, 4))
        step = make_fused_adapt_step(model, 0, 4, use_er=True, use_vs=True, ood_threshold=1e9,
                                     clip_grad_norm=True)
        calls = {}
        with captured_kernel_calls(calls):
            step(create_train_state(model, None, LR), init_fcs_ema(dev),
                 batch(name, sub, split, "train"), batch(rname, rsub, rsplit, "val"), True)
        failed += check_kernel_calls(calls, f"paper {name} step", forwards=2, tower=False,
                                     backward=True)

    # (c) run_paper_scale_synth through its entry point, three times, the
    # launches counted after each: pretraining (faithful's model, as JAX),
    # then the faithful suite with the OOD analysis, then the bench suite.
    # Each call skips the phases whose outputs exist.
    synth = os.path.join(root, "synth")
    flags = ["--work", synth, "--height", str(h), "--width", str(w), *SYNTH_FLAGS,
             "--device", dev_name]
    a = run_paper_scale_synth.parse_args(flags)
    t0 = time.perf_counter()
    launches = {}
    for label, extra in (("pretraining", ["--through", "1"]),
                         ("faithful", ["--configs", "faithful"]),
                         ("bench", ["--configs", "bench"])):
        reset()
        if run_paper_scale_synth.main(flags + extra) != 0:
            failed.append(f"(c) run_paper_scale_synth {' '.join(extra)} failed")
        launches[label] = counts()
        log(f"[paper] (c) {label}: launches " + ", ".join(
            f"{n}={c}" for n, c in launches[label].items()))
    synth_s = time.perf_counter() - t0
    tower = ("tower_forward", "tower_backward")
    require_launches("paper-scale pretraining", launches["pretraining"],
                     absent=("coarse_head", *tower))
    require_launches("paper-scale faithful", launches["faithful"], absent=("coarse_head", *tower))
    require_launches("paper-scale bench", launches["bench"], absent=("coarse_head",))
    failed += tower_chains("(c) bench suite", launches["bench"],
                           a.adapt_steps * len(a.methods))
    with open(os.path.join(a.artifacts, "ood_threshold.json")) as f:
        ood = json.load(f)
    log(f"[paper] (c) run_paper_scale_synth {' '.join(SYNTH_FLAGS)} at {h}x{w}: {synth_s:.1f} s; "
        f"threshold {ood['threshold']:.4f} ({ood['threshold_source']}-derived, "
        f"P={ood['precision_at_threshold']:.3f} R={ood['recall_at_threshold']:.3f})")
    for cname in a.configs:
        wanted = [f"results_{cname}.csv"] + [f"adapt_{cname}_{m}_summary.json" for m in a.methods]
        missing = [f for f in wanted if not os.path.exists(os.path.join(a.artifacts, f))]
        if missing:
            failed.append(f"(c) {cname}: missing {missing}")
    if not os.path.exists(os.path.join(a.artifacts, "pretrain_metrics.json")):
        failed.append("(c) pretraining wrote no pretrain_metrics.json")
    check_pdf(os.path.join(a.artifacts, "fcs_histogram.pdf"), ["feature contrast score"])

    # (d) The demo at its defaults.
    demo = os.path.join(root, "demo")
    t0 = time.perf_counter()
    reset()
    rc = synthetic_pipeline_demo.main(["--work", demo, "--device", dev_name])
    got = counts()
    log(f"[paper] (d) synthetic_pipeline_demo: exit {rc} in {time.perf_counter() - t0:.1f} s; "
        "launches " + ", ".join(f"{n}={c}" for n, c in got.items()))
    require_launches("demo", got, absent=("coarse_head", "tower_forward", "tower_backward"))
    if rc != 0 or not os.path.exists(os.path.join(demo, "results.csv")):
        failed.append("(d) the demo wrote no results.csv")
    check_pdf(os.path.join(demo, "adaptation_curves.pdf"), ["ADAPT domain", "TRAIN domain"])
    check_pdf(os.path.join(demo, "gradient_updates.pdf"), ["gradient updates @ 16 steps"])
    log(f"[paper] phase 15 took {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError("phase 15: " + "; ".join(failed))


# Phase 16: numpy's transform of each EXIF Orientation (the CPU tests tie
# the port's reads to cv2's, and data/exif.py's transforms to cv2's rotate
# and flip); the GT-free study's flags (50 adapt steps, a probe every 25).
NUMPY_ORIENTATIONS = {
    1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: np.rot90(a, 2), 4: lambda a: a[::-1],
    5: lambda a: np.swapaxes(a, 0, 1), 6: lambda a: np.rot90(a, -1),
    7: lambda a: np.rot90(np.swapaxes(a, 0, 1), 2), 8: lambda a: np.rot90(a, 1)}
STUDY_FLAGS = ("--configs", "fused", "faithful", "vser", "--adapt_steps", "50", "--probe_hz",
               "25")


def exif_block(orientation: int, order: str) -> bytes:
    """A TIFF block (byte order II or MM) whose IFD0 holds the Orientation."""
    import struct

    e = "<" if order == "II" else ">"
    return (order.encode() + struct.pack(e + "HIH", 42, 8, 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))


def with_exif(data: bytes, block: bytes) -> bytes:
    """A PNG or JPEG file with the EXIF block spliced in: a PNG eXIf chunk
    after IHDR, or a JPEG APP1 segment after SOI."""
    import struct

    if data[:2] == b"\xff\xd8":
        body = b"Exif\0\0" + block
        return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]
    chunk = (struct.pack(">I", len(block)) + b"eXIf" + block
             + struct.pack(">I", zlib.crc32(b"eXIf" + block) & 0xFFFFFFFF))
    return data[:33] + chunk + data[33:]  # the signature and IHDR take 33 bytes


def study_phase(seed, dev, rows, card, model_cpu, root):
    """Phase 16: the image reads' EXIF orientation and progressive JPEG on
    the card's host, the tower's eval-mode backward chain, then the GT-free
    guard study at 320x960 on phase 15 (c)'s work directory (root)."""
    import dataclasses
    import hashlib
    import os

    import adaptive_stereo_tpu_torch.engine.stream_driver as sd
    from adaptive_stereo_tpu_torch.data import decode_jpeg, encode_jpeg, encode_png
    from adaptive_stereo_tpu_torch.data.loaders import load_disp_vkitti
    from adaptive_stereo_tpu_torch.data.stereo_dataset import _load_rgb
    from adaptive_stereo_tpu_torch.ops.cuda import (tower_backward_cuda, tower_cuda,
                                                    tower_forward_cuda, tower_ref)
    from adaptive_stereo_tpu_torch.scripts import run_gtfree_guard_study as study

    t_phase = time.perf_counter()
    failed = []

    # (a) EXIF: Orientation 1-8 in both byte orders, in phase 15's JPEG frame,
    # a PNG of it and a 16-bit depth PNG, against numpy's transform of the
    # untagged read.
    frame = jpeg_frame(seed)
    files = {"jpeg": encode_jpeg(frame, quality=JPEG_QUALITY, subsampling="4:2:0"),
             "png": encode_png(frame),
             "depth": encode_png(np.random.RandomState(seed).randint(
                 100, 65535, JPEG_FRAME_SHAPE).astype(np.uint16))}
    path = os.path.join(root, "exif")
    untagged = {}
    for kind, data in files.items():
        with open(path, "wb") as f:
            f.write(data)
        untagged[kind] = (load_disp_vkitti(path) if kind == "depth"
                          else _load_rgb(path, uint8=True))
    t0 = time.perf_counter()
    wrong = []
    for kind, data in files.items():
        for order in ("II", "MM"):
            for orientation in range(1, 9):
                with open(path, "wb") as f:
                    f.write(with_exif(data, exif_block(orientation, order)))
                got = load_disp_vkitti(path) if kind == "depth" else _load_rgb(path, uint8=True)
                want = NUMPY_ORIENTATIONS[orientation](untagged[kind])
                if got.shape != want.shape or not np.array_equal(got, want):
                    wrong.append(f"{kind} {order} {orientation}")
    log(f"[study] (a) EXIF Orientation 1-8, II and MM, in a {JPEG_FRAME_SHAPE[0]}x"
        f"{JPEG_FRAME_SHAPE[1]} JPEG, a PNG of it (_load_rgb) and a 16-bit depth PNG "
        f"(load_disp_vkitti): 48 reads equal to numpy's transform of the untagged read: "
        f"{not wrong} ({time.perf_counter() - t0:.2f} s)")
    if wrong:
        failed.append(f"(a) EXIF reads differ from numpy's transform: {wrong}")

    # (b) Progressive JPEG: the committed fixtures hash to cv2's pixels; the
    # KITTI-size one is phase 15's frame, timed beside its baseline decode.
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "jpeg")
    progressive = {}
    for name, want in PROGRESSIVE_JPEGS.items():
        with open(os.path.join(fixtures, name), "rb") as f:
            progressive[name] = f.read()
        digest = hashlib.sha256(decode_jpeg(progressive[name]).tobytes()).hexdigest()
        log(f"[study] (b) {name}: {len(progressive[name])} bytes, decoded sha256 {digest} "
            f"(want {want})")
        if digest != want:
            failed.append(f"(b) {name}: the decoded hash differs from cv2's")
    prog = progressive["frame_375x1242_420_q95_progressive.jpg"]
    if hashlib.sha256(decode_jpeg(files["jpeg"]).tobytes()).hexdigest() != JPEG_FRAME_SHA256:
        failed.append("(b) the baseline frame's hash differs from JPEG_FRAME_SHA256")
    prog_ms, base_ms = [], []
    for _ in range(JPEG_DECODES):
        t0 = time.perf_counter()
        decode_jpeg(prog)
        prog_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        decode_jpeg(files["jpeg"])
        base_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[study] (b) decode_jpeg of the {JPEG_FRAME_SHAPE[0]}x{JPEG_FRAME_SHAPE[1]} 4:2:0 "
        f"frame, host ms, median of {JPEG_DECODES} in turns: progressive "
        f"{statistics.median(prog_ms):.3f} (min {min(prog_ms):.3f}), baseline "
        f"{statistics.median(base_ms):.3f} (min {min(base_ms):.3f}); {card}")

    # (c) The tower's eval-mode backward chain against autograd through
    # tower_ref in eval mode, with phase 7's train-mode bands.
    base, run_stats, g, inputs, params_for, grads = tower_setup(model_cpu, dev, seed + 16)
    names = TOWER_GRAD_NAMES
    bf16_err = None
    for shape in ((2, *DRIVER_SHAPE), TOWER_TAIL):
        x0, g_out = inputs(*shape)
        p_ref = params_for(torch.float32, requires_grad=True)
        x_ref = x0.clone().requires_grad_()
        g_ref = grads(lambda x, p: tower_ref(x, p, run_stats, False)[0], x_ref, p_ref, g_out)
        # f32: the kernels' chain on the plain chain's buffers.
        with torch.no_grad():
            _, mu, var, xs, ys = tower_ref(x0, params_for(torch.float32), run_stats, False,
                                           buffers=True)
            before = tower_backward_cuda.launches
            got = tower_backward_cuda(g_out, x0, [t.contiguous() for t in xs],
                                      [t.contiguous() for t in ys],
                                      [k.contiguous() for k in base["kernels"]], base["gammas"],
                                      base["betas"], mu, var, train=False)
            launches = tower_backward_cuda.launches - before
        torch.cuda.synchronize()
        flat = [got[0]] + list(got[1]) + list(got[2]) + [got[3], got[4]]
        errs = [(rel_l2(a, r), n) for n, a, r in zip(names, flat, g_ref)]
        log(f"[study] (c) eval backward f32 {shape} on the plain chain's buffers: {launches} "
            f"launches; worst relative L2 error {max(errs)} (band {TOWER_F32_GRAD_L2})")
        if launches != 31 or max(errs)[0] > TOWER_F32_GRAD_L2:
            failed.append(f"(c) eval backward f32 {shape}: {launches} launches, {max(errs)}")
        # bf16 end to end through tower_cuda's autograd against the plain bf16
        # autograd, each against the f32 gradients.
        dt = torch.bfloat16
        xd = x0.to(dt)
        p_k, p_p = params_for(dt, requires_grad=True), params_for(dt, requires_grad=True)
        x_k, x_p = xd.clone().requires_grad_(), xd.clone().requires_grad_()
        before = tower_backward_cuda.launches
        g_k = grads(lambda x, p: tower_cuda(x, {**p, "kernels": [k.to(dt) for k in p["kernels"]]},
                                            run_stats, False)[0], x_k, p_k, g_out)
        launches = tower_backward_cuda.launches - before
        g_p = grads(lambda x, p: tower_ref(x, {**p, "kernels": [k.to(dt) for k in p["kernels"]]},
                                           run_stats, False)[0], x_p, p_p, g_out)
        torch.cuda.synchronize()
        if bf16_err is None:
            bf16_err = (g_k[0] - g_p[0]).abs().max().item()
        worst = max((rel_l2(a, r) - TOWER_BF16_FACTOR * rel_l2(pl, r), n, rel_l2(a, r),
                     rel_l2(pl, r)) for n, a, pl, r in zip(names, g_k, g_p, g_ref))
        log(f"[study] (c) eval backward bf16 {shape} through tower_cuda: {launches} launches; "
            f"largest kernel error less {TOWER_BF16_FACTOR} x the plain bf16's, relative L2 "
            f"vs f32: {worst[0]:.4g} ({worst[1]}: kernels {worst[2]:.4g}, plain "
            f"{worst[3]:.4g}; band {TOWER_F32_GRAD_L2})")
        if launches != 31 or worst[0] > TOWER_F32_GRAD_L2:
            failed.append(f"(c) eval backward bf16 {shape}: {launches} launches, {worst}")
    # Times by CUDA events: at the probe's call (batch 1, 320x960, f32, the
    # study's dtype) and beside phase 7's train chain (batch 2, bf16). The
    # plain backward and the module path's (cuDNN) as device sums.
    times = {}
    ref = model_cpu.stereo_net.edge_aware_refinements[0]
    for b, dt in ((1, torch.float32), (2, torch.bfloat16)):
        h, w = DRIVER_SHAPE
        x0, g_out = inputs(b, h, w)
        xd = x0.to(dt)
        pk = {**params_for(dt), "kernels": [k.to(dt).contiguous() for k in base["kernels"]]}
        with torch.no_grad():
            _, mu, var, xs, ys = tower_forward_cuda(xd, pk["kernels"], pk["biases"],
                                                    pk["gammas"], pk["betas"], run_stats, False)
        bwd = lambda: tower_backward_cuda(g_out, xd, xs, ys, pk["kernels"], pk["gammas"],
                                          pk["betas"], mu, var, train=False)
        p_req = params_for(dt, requires_grad=True)
        x_req = xd.clone().requires_grad_()
        leaves = [x_req] + p_req["kernels"] + p_req["biases"] + [p_req["gammas"],
                                                                p_req["betas"]]
        loss = (tower_ref(x_req, {**p_req, "kernels": [k.to(dt) for k in p_req["kernels"]]},
                          run_stats, False)[0].float() * g_out).sum()
        mod = copy.deepcopy(ref).to(dev).eval()
        mod.dtype, mod.fused_tower = (None if dt == torch.float32 else dt), False
        coarse_disp = torch.rand(b, h // 16, w // 16, generator=g, device=dev) * 4
        loss_mod = (mod(coarse_disp, x0[..., 1:]) * g_out).sum()
        mod_params = list(mod.parameters())
        t = time_ms(bwd, calls=5)
        plain = device_ms(lambda: torch.autograd.grad(loss, leaves, retain_graph=True))
        module = device_ms(lambda: torch.autograd.grad(loss_mod, mod_params, retain_graph=True,
                                                       allow_unused=True))
        flops = 2 * tower_flops(b, h, w)
        b_ms, b_by = bound(tower_bytes(b, h, w, torch.finfo(dt).bits // 8)[1], flops,
                           "f32_cuda_core" if dt == torch.float32 else "bf16_tensor")
        times[(b, dt)] = (t, plain, module, b_ms, b_by)
        log(f"[study] (c) eval backward chain ({b},{h},{w}) {dt}: kernels {t}; plain "
            f"(tower_ref autograd) device sum {plain:.4f} ms; module path (cuDNN) backward "
            f"alone, device sum {module:.4f} ms; bound {b_ms:.5f} ms ({b_by}, "
            f"{flops / 1e9:.2f} GFLOP); {card}")
        del loss, loss_mod

    # (d) The study at 320x960 on phase 15 (c)'s datasets, pretrained weights
    # and threshold, each config's launches counted, and the probes' own.
    synth = os.path.join(root, "synth")
    out = os.path.join(root, "study")
    h, w = DRIVER_SHAPE
    reset, counts = launch_counter({row["name"]: row["wrapper"] for row in rows})
    per_run, calls, probe_launches = {}, {}, {}
    adapt_streaming, probe = sd.adapt_streaming, study.probe

    def counted(cfg, *a, **kw):
        reset()
        probe_launches[cfg.model_name] = []
        result = adapt_streaming(cfg, *a, **kw)
        per_run[cfg.model_name] = counts()
        calls[cfg.model_name] = (cfg, a, kw, result)
        return result

    def counted_probe(model, *a, **kw):
        before = (tower_backward_cuda.launches, tower_forward_cuda.launches)
        values = probe(model, *a, **kw)
        name = list(probe_launches)[-1]
        probe_launches[name].append((tower_backward_cuda.launches - before[0],
                                     tower_forward_cuda.launches - before[1]))
        return values

    cudnn_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    t0 = time.perf_counter()
    sd.adapt_streaming, study.probe = counted, counted_probe
    try:
        rc = study.main(["--work", synth, "--artifacts", os.path.join(synth, "artifacts"),
                         "--out", out, "--height", str(h), "--width", str(w), *STUDY_FLAGS,
                         "--device", dev.type])
    finally:
        sd.adapt_streaming, study.probe = adapt_streaming, probe
    study_s = time.perf_counter() - t0
    if rc != 0:
        failed.append(f"(d) run_gtfree_guard_study exited {rc}")
    # The same fused run without the hook ends on the same bits.
    cfg, a, kw, probed = calls["gtfree_fused"]
    t0 = time.perf_counter()
    bare = adapt_streaming(dataclasses.replace(cfg, model_name="gtfree_fused_no_probe"), *a,
                           **{**kw, "probe_hook": None})
    bare_s = time.perf_counter() - t0
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    ss_p, ss_b = probed["stream_state"], bare["stream_state"]
    same = all(torch.equal(x, y) for x, y in zip(list(ss_p.params) + list(ss_p.buffers),
                                                  list(ss_b.params) + list(ss_b.buffers)))
    log(f"[study] (d) the fused run with and without the probe hook: parameters and running "
        f"statistics bitwise equal {same} ({probed['gradient_updates']} / "
        f"{bare['gradient_updates']} updates; the run without the hook {bare_s:.1f} s)")
    if not same or probed["gradient_updates"] != bare["gradient_updates"]:
        failed.append("(d) the probe hook changed the fused run's trajectory")
    eval_launches = 0
    for cname in ("fused", "faithful", "vser"):
        name = f"gtfree_{cname}"
        got, pl = per_run.get(name, {}), probe_launches.get(name, [])
        log(f"[study] (d) {cname}: launches " + ", ".join(f"{n}={c}" for n, c in got.items())
            + f"; per probe (tower backward, tower forward): {pl}")
        csv_path = os.path.join(out, f"probes_{cname}.csv")
        if not os.path.exists(csv_path):
            failed.append(f"(d) {cname}: no probes_{cname}.csv")
            continue
        with open(csv_path) as f:
            lines = f.read().splitlines()
        log(f"[study] (d) {csv_path.split(os.sep)[-1]}: " + " | ".join(lines))
        values = np.loadtxt(csv_path, delimiter=",", skiprows=1, ndmin=2)
        if lines[0] != study.CSV_HEADER or values.shape != (2, 8) or \
                not np.isfinite(values).all():
            failed.append(f"(d) {cname}: the CSV is not two finite rows under the header")
        fused = cname != "faithful"
        if len(pl) != 2 or any(bwd != (31 if fused else 0) or fwd != (16 if fused else 0)
                               for bwd, fwd in pl):
            failed.append(f"(d) {cname}: tower launches per probe {pl}")
        if not fused and (got.get("tower_forward") or got.get("tower_backward")):
            failed.append(f"(d) faithful launched the tower: {got}")
        if fused:
            eval_launches += sum(bwd for bwd, _ in pl)
        require_launches(f"study {cname}", got, absent=("coarse_head",) + (
            () if fused else ("tower_forward", "tower_backward")))
    log(f"[study] (d) run_gtfree_guard_study {' '.join(STUDY_FLAGS)} at {h}x{w}: {study_s:.1f} s")

    t, plain, module, b_ms, b_by = times[(1, torch.float32)]
    rows.append(dict(name="tower_backward_eval", route="cuda",
                     source="adaptive_stereo_tpu_torch/csrc/tower.cu",
                     replaces="adaptive_stereo_tpu/ops/pallas/tower.py:501",
                     wrapper=tower_backward_cuda, launches=eval_launches, max_abs_err=bf16_err,
                     ms=t.ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=module))
    log(f"[study] phase 16 took {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError("phase 16: " + "; ".join(failed))


def expect_launches(label, got, want):
    """Fail unless the launch counts are exactly `want`."""
    if got != want:
        raise AssertionError(f"{label}: launch counts {got}, want {want}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # Phase 1: device.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs a GPU", file=sys.stderr)
        return 1
    from adaptive_stereo_tpu_torch.models import (
        StereoModel, aggregation_args, random_init_)
    from adaptive_stereo_tpu_torch.ops.cuda import (
        _build,
        aggregate_cost_volume_cuda,
        aggregate_cost_volume_ref,
        coarse_head_cuda,
        coarse_head_ref,
        difference_cost_volume_cuda,
        difference_cost_volume_ref,
        soft_argmin_fcs_cuda,
        soft_argmin_fcs_ref,
    )
    from adaptive_stereo_tpu_torch.ops.cuda import cost_volume as cv_mod
    from adaptive_stereo_tpu_torch.serving import (
        AsyncStereoDepthEngine, ServingConfig, StereoDepthEngine)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi()
    dev = torch.device("cuda")
    log(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}; TF32 off for float32 references")

    # Phase 2: build.
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.library()
    log(f"[build] {path.name} built and loaded in {time.perf_counter() - t0:.1f} s")

    # Phase 10's datasets are written meanwhile, by two spawned processes
    # started after the build, whose nvcc processes they would slow (if a
    # phase fails first, the pool joins them and the directory is removed
    # as the interpreter exits).
    driver_root = tempfile.TemporaryDirectory(prefix="chip_smoke_driver_")
    driver_data = generate_driver_data(driver_root.name, args.seed)
    conv_kernel_report(path)
    # Phase 3: kernels against their plain versions at the serving shapes.
    cfg = ServingConfig()
    k, s = cfg.stereonet_k, cfg.input_scale
    gen = torch.Generator().manual_seed(args.seed)
    model_cpu = random_init_(StereoModel(k=k, input_scale=s, device="cpu"), gen)
    weights = (model_cpu.feature_net.state_dict(), model_cpu.stereo_net.state_dict())
    num_disp = model_cpu.stereo_net.num_disp
    h, w = cfg.model_input_height // 2 ** (k + s), cfg.model_input_width // 2 ** (k + s)
    c = 32
    params, run_stats = aggregation_args(model_cpu.stereo_net)
    params = {n: t.detach().to(dev) for n, t in params.items()}
    run_stats = tuple(t.to(dev) for t in run_stats)
    cg = torch.Generator(device=dev).manual_seed(args.seed + 1)
    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=cg, device=dev) * scale).to(dtype)
    rows = []
    with torch.inference_mode():
        floor = launch_floor()
        # Cost volume: bitwise equal in bf16 and f32, at the serving and
        # training shapes, at RAGGED and on a view off a 16-byte boundary.
        errs = {}
        train_features = (TRAIN_COARSE[0], *TRAIN_COARSE[2:], c)
        cases = [((1, h, w, c), num_disp, False), (train_features, TRAIN_COARSE[1], False),
                 (*RAGGED, False), (*CV_ODD_C, False), ((1, h, w, c), num_disp, True)]
        for dt in (torch.float32, torch.bfloat16):
            for (fb, fh, fw, fc), fd, offset in cases:
                fl, fr = randn(fb, fh, fw, fc, dtype=dt), randn(fb, fh, fw, fc, dtype=dt)
                label = f"({fb},{fd},{fh},{fw},{fc}) {dt}"
                if offset:  # f_l one element past a 16-byte boundary
                    fl = torch.cat([fl.flatten()[:1], fl.flatten()])[1:].view(fl.shape)
                    label += " off a 16-byte boundary"
                got = difference_cost_volume_cuda(fl, fr, fd)
                want = difference_cost_volume_ref(fl, fr, fd)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                errs.setdefault(dt, err)
                log(f"[kernels] cost volume {label}, {cv_path(fc, fl, fr, got)} path: bitwise "
                    f"equal {torch.equal(got, want)}")
                if not torch.equal(got, want):
                    raise AssertionError(f"cost volume {label}: not bitwise equal, max err {err}")
        fl, fr = randn(1, h, w, c, dtype=torch.bfloat16), randn(1, h, w, c, dtype=torch.bfloat16)
        n_sub = h * c * sum(w - d for d in range(min(num_disp, w)))
        rows.append(kernel_row(
            "difference_cost_volume", "cost_volume.cu", "cost_volume.py:66",
            difference_cost_volume_cuda, 1, errs[torch.bfloat16],
            lambda: difference_cost_volume_cuda(fl, fr, num_disp),
            lambda: difference_cost_volume_ref(fl, fr, num_disp), None,
            2 * fl.numel() * 2 + num_disp * fl.numel() * 2, n_sub, "f32_cuda_core",
            f"(1,{num_disp},{h},{w},{c}) bf16, bitwise equal in f32 and bf16", floor))
        # Aggregation, eval and train mode, f32 and bf16, against the plain
        # version at the serving and training shapes and at CHECK_SHAPES.
        agg_err = None
        for shape in [(1, num_disp, h, w), TRAIN_COARSE, *CHECK_SHAPES]:
            for train in (False, True):
                for dt in (torch.float32, torch.bfloat16):
                    err = check_aggregation(randn(*shape, c, dtype=dt), params, run_stats, train)
                    if agg_err is None and dt == torch.bfloat16:
                        agg_err = err  # the serving shape, eval
        cost = randn(1, num_disp, h, w, c, dtype=torch.bfloat16)
        cost_t = randn(*TRAIN_COARSE, c, dtype=torch.bfloat16)
        train_times = {name: [time_ms(lambda x=x: fn(x, params, run_stats, True))
                              for x in (cost, cost_t)]
                       for name, fn in (("kernel", aggregate_cost_volume_cuda),
                                        ("cuDNN", library_aggregation))}
        log(f"[kernels] aggregate_cost_volume train mode bf16 (13 launches) against its "
            f"yardstick, cuDNN conv3d + F.batch_norm(training=True) + LeakyReLU: at "
            f"(1,{num_disp},{h},{w},{c}) kernel {train_times['kernel'][0]}, cuDNN "
            f"{train_times['cuDNN'][0]}; at the training shape {TRAIN_COARSE + (c,)} kernel "
            f"{train_times['kernel'][1]}, cuDNN {train_times['cuDNN'][1]}")
        lib_err = (library_aggregation(cost, params, run_stats).float()
                   - aggregate_cost_volume_ref(cost, params, run_stats, False)[0].float()
                   ).abs().max().item()
        valid_taps = (3 * num_disp - 2) * (3 * h - 2) * (3 * w - 2)
        stack_ops = 2 * valid_taps * c * (4 * c + 1)
        weight_bytes = (4 * 27 * c * c + 27 * c) * 2 + (4 * 5 * c + 1) * 4
        rows.append(kernel_row(
            "aggregate_cost_volume", "aggregation.cu", "aggregation.py:401",
            aggregate_cost_volume_cuda, 5, agg_err,
            lambda: aggregate_cost_volume_cuda(cost, params, run_stats, False),
            lambda: aggregate_cost_volume_ref(cost, params, run_stats, False),
            lambda: library_aggregation(cost, params, run_stats),
            cost.numel() * 2 + cost.numel() // c * 2 + weight_bytes, stack_ops, "bf16_tensor",
            f"(1,{num_disp},{h},{w},{c}) bf16, 5 launches, {stack_ops / 1e9:.3f} GFLOP; "
            f"cuDNN stack max abs diff to plain {lib_err:.3g}"))
        # Soft-argmin + FCS: within 1e-5 absolute, at the serving shape (the
        # error in the row), the training shape, RAGGED and SOFT_ARGMIN_D.
        err = None
        for shape in soft_argmin_shapes(num_disp, h, w):
            scost = randn(*shape, scale=5.0)
            disp, fcs = soft_argmin_fcs_cuda(scost)
            disp_r, fcs_r = soft_argmin_fcs_ref(scost)
            torch.cuda.synchronize()
            e = max((disp - disp_r).abs().max().item(), (fcs - fcs_r).abs().max().item())
            log(f"[kernels] soft-argmin + FCS {shape}: max abs err {e:.3g}")
            if e > DISP_ABS:
                raise AssertionError(f"soft-argmin+FCS {shape}: max abs err {e} > {DISP_ABS}")
            err = e if err is None else err
        scost = randn(1, num_disp, h, w, scale=5.0)
        rows.append(kernel_row(
            "soft_argmin_fcs", "disparity.cu", "disparity.py:64", soft_argmin_fcs_cuda, 1, err,
            lambda: soft_argmin_fcs_cuda(scost), lambda: soft_argmin_fcs_ref(scost), None,
            scost.numel() * 4 + 2 * h * w * 4, 8 * scost.numel(), "f32_cuda_core",
            f"(1,{num_disp},{h},{w}) f32, max abs err {err:.3g}", floor))
        # Fused coarse head, eval and train, f32 and bf16, against the plain
        # version and against kernels 1-3 composed, at the serving and
        # training shapes and at CHECK_SHAPES (features (B, H, W), D).
        head_err = None
        for hb, hd, hh, hw in [(1, num_disp, h, w), TRAIN_COARSE, *CHECK_SHAPES]:
            for dt in (torch.float32, torch.bfloat16):
                fl, fr = randn(hb, hh, hw, c, dtype=dt), randn(hb, hh, hw, c, dtype=dt)
                for train in (False, True):
                    err = check_head(fl, fr, params, run_stats, train, hd, k)
                    if head_err is None and dt == torch.bfloat16:
                        head_err = err  # the serving shape, eval
        fl, fr = randn(1, h, w, c, dtype=torch.bfloat16), randn(1, h, w, c, dtype=torch.bfloat16)
        head_train = time_ms(lambda: coarse_head_cuda(fl, fr, params, run_stats, True,
                                                      num_disp))
        composed = time_ms(lambda: soft_argmin_fcs_cuda(aggregate_cost_volume_cuda(
            difference_cost_volume_cuda(fl, fr, num_disp), params, run_stats, False)[0].float()))
        cudnn = [time_ms(lambda t=t: library_aggregation(
            difference_cost_volume_cuda(fl, fr, num_disp), params, run_stats, t))
            for t in (False, True)]
        log(f"[kernels] coarse_head yardsticks (no single PyTorch call computes the head): "
            f"kernels 1-3 composed {composed}; cost-volume kernel + cuDNN stack {cudnn[0]}; "
            f"fused head in train mode {head_train}, its yardstick the cost-volume kernel + "
            f"cuDNN conv3d + F.batch_norm(training=True) + LeakyReLU {cudnn[1]}")
        rows.append(kernel_row(
            "coarse_head", "coarse_head.cu", "coarse_head.py:225", coarse_head_cuda, 1,
            head_err,
            lambda: coarse_head_cuda(fl, fr, params, run_stats, False, num_disp),
            lambda: coarse_head_ref(fl, fr, params, run_stats, False, num_disp), None,
            2 * fl.numel() * 2 + weight_bytes + 2 * h * w * 4 + 2 * 4 * c * 4, stack_ops,
            "bf16_tensor",
            f"features (1,{h},{w},{c}) bf16, D={num_disp}, one cooperative launch"))
    wrappers = [row["wrapper"] for row in rows]
    # Phase 4: serving at ServingConfig() defaults, then with the fused head.
    rng = np.random.RandomState(args.seed)
    hh, ww = cfg.model_input_height, cfg.model_input_width
    frames = [(rng.rand(hh, ww, 3).astype(np.float32), rng.rand(hh, ww, 3).astype(np.float32))
              for _ in range(FRAMES)]
    engines = {}
    served = {}
    p50 = {}
    for fused in (False, True):
        config = ServingConfig(fused_coarse_head=fused)
        engine = engines[fused] = StereoDepthEngine(config, weights, device="cuda")
        results, lat, fwd, launches = serve(engine, frames, wrappers)
        served[fused] = results
        want = {row["name"]: 0 for row in rows}
        if fused:
            want["coarse_head"] = FRAMES
        else:
            want.update({row["name"]: row["per_frame"] * FRAMES for row in rows
                         if row["name"] != "coarse_head"})
        got = {row["name"]: n for row, n in zip(rows, launches)}
        if got != want:
            raise AssertionError(f"launches while serving {FRAMES} frames with "
                                 f"fused_coarse_head={fused}: {got}, expected {want}")
        for row, n in zip(rows, launches):
            if (row["name"] == "coarse_head") == fused:
                row["launches"] = n
        p50[fused] = statistics.median(lat)
        log(f"[serving] fused_coarse_head={fused}: {FRAMES} frames {hh}x{ww} k={k} "
            f"{config.compute_dtype}: p50 {statistics.median(lat):.2f} ms/frame (first "
            f"{lat[0]:.1f} ms, min {min(lat):.2f}); of which upload + forward + download p50 "
            f"{statistics.median(fwd):.2f} ms; points {len(results[-1]['points'])}; launches "
            + ", ".join(f"{name}={n}" for name, n in got.items()))
    def disagree(got, want):
        """Max abs difference and the pixels outside the whole-forward band."""
        diff = np.abs(got - want)
        return diff.max(), int((diff > DISP0_ABS_PX + DISP0_REL * np.abs(want)).sum())
    checks = [disagree(a["disparity"], b["disparity"])
              for a, b in zip(served[True], served[False])]
    log(f"[serving] fused vs default engine disparity, {FRAMES} frames: max abs diff "
        f"{max(d for d, _ in checks):.4g} px; outside {DISP0_ABS_PX} + {DISP0_REL}|ref|: "
        f"{sum(n for _, n in checks)} px")
    if any(n for _, n in checks):
        raise AssertionError("fused and default engines disagree")
    async_engine = AsyncStereoDepthEngine(ServingConfig(fused_coarse_head=True), weights,
                                          device="cuda")
    if async_engine.submit(*frames[0], timestamp=0.0) is not None:
        raise AssertionError("async engine: the first submit returned a result")
    res = async_engine.flush()
    diff, over = disagree(res["disparity"], served[True][0]["disparity"])
    log(f"[serving] async fused engine, one submit/flush round: max abs diff to the sync "
        f"engine {diff:.4g} px, {len(res['points'])} points")
    if over or len(res["points"]) == 0:
        raise AssertionError("async fused engine disagrees with the sync one")
    # Phase 5: whole forward, kernels vs the same forward of plain versions.
    left = torch.from_numpy(frames[0][0][None]).to(dev)
    right = torch.from_numpy(frames[0][1][None]).to(dev)
    for fused in (False, True):
        whole_forward(engines[fused].model, left, right, k, s,
                      "fused" if fused else "default")
    # Phase 6: where the time of a served frame goes, on the device.
    for fused in (False, True):
        log(f"[profile] fused_coarse_head={fused}")
        profile_breakdown(lambda: engines[fused].process(*frames[0]))
    # Phase 7: the tower kernels; phase 8: autograd of kernels 1-3.
    tower_phase(model_cpu, dev, args.seed, rows)
    autograd_phase(params, run_stats, dev, args.seed, rows)
    # Phase 9: training.
    bare_ms = training_phase(args.seed, dev, rows)
    # Phase 10: the streaming adaptation driver.
    driver_ms = driver_phase(args.seed, dev, rows, card, bare_ms, driver_root.name, driver_data)
    # Phase 11: train, the classic engine, evaluate and timing.
    classic_phase(args.seed, dev, rows, card, bare_ms, driver_ms, driver_root.name)
    # Phase 12: the native voxel grid, the pytree engine, the device cache,
    # the reconstruction gate and the OOD analysis.
    pytree_ms = rest_phase(args.seed, dev, rows, card, (engines[False], frames, p50[False]),
                           bare_ms, driver_ms, driver_root.name)
    # Phase 13: the fleet and data-parallel layer.
    fleet_phase(args.seed, dev, rows, card, pytree_ms, driver_root.name)
    # Phase 14: cost volumes, profiling, the results pipeline with its event
    # files, and the OOD plots.
    analysis_phase(args.seed, dev, rows, card, engines, frames, driver_root.name)
    driver_root.cleanup()
    # Phase 15: JPEG frames and the paper protocol's runners.
    paper_root = tempfile.TemporaryDirectory(prefix="chip_smoke_paper_")
    paper_phase(args.seed, dev, rows, card, paper_root.name)
    # Phase 16: EXIF orientation and progressive JPEG, the tower's eval-mode
    # backward, the GT-free guard study on phase 15 (c)'s work directory.
    study_phase(args.seed, dev, rows, card, model_cpu, paper_root.name)
    paper_root.cleanup()
    keys = ("name", "route", "source", "replaces", "launches", "train_launches",
            "train11_launches", "pytree_launches", "fleet_launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "floor_ms", "backward_ms",
            "backward_plain_ms", "backward_bound_ms", "backward_train_launches",
            "backward_pytree_launches", "backward_fleet_launches")
    for row in rows:
        row["floor_ms"] = floor.ms
    table = [{key: row[key] for key in keys if key in row} for row in rows]
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
