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

The last two lines are the card's name and power limit, then
{"ok": true, "device": {...}}; the line before them holds the kernel table,
whose "launches" count the served frames of phase 4 (kernels 1-4) or the
adapt steps of phase 9 (the tower), and "train_launches" the adapt steps
of phase 9 for every kernel; "floor_ms" is the launch floor, and the rows
of kernels 1 and 3 also carry their backward kernel's time, plain
version's time, bound and launches over the adapt steps of phase 9.
Float32 references run with TF32 off (cudnn.allow_tf32 and
cuda.matmul.allow_tf32 both False), set at the start.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time

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
    host operators and the kernel launches (cudaLaunchKernel calls) per
    call of fn() (None, None without device time)."""
    from torch.autograd import DeviceType

    prof, wall_us, per_name = device_profile(fn, repeats)
    total = sum(t for t, _, _ in per_name)
    if total == 0:
        log("[profile] torch.profiler recorded no device time")
        return None, None
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
            sum(evt.count for evt in host if evt.key == "cudaLaunchKernel") / repeats)


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


def tower_phase(model_cpu, dev, seed, rows):
    """Phase 7: the tower kernels against tower_ref at the training shape
    and at TOWER_TAIL, then their times at the training shape."""
    from adaptive_stereo_tpu_torch.ops.cuda import (
        tower_backward_cuda, tower_cuda, tower_forward_cuda, tower_ref)

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

    names = ["dx0"] + [f"dW{p}" for p in range(8)] + [f"db{p}" for p in range(8)] + \
        ["dgamma", "dbeta"]
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
    n_pix = b * h * w
    act_bytes = n_pix * 2  # one bf16 channel
    fwd_bytes = n_pix * 4 * 2 + (7 * 32 + 1) * act_bytes + 7 * 32 * act_bytes
    bwd_bytes = act_bytes + n_pix * 4 * 2 + 7 * 32 * act_bytes + (7 * 32 + 1) * act_bytes \
        + n_pix * 4 * 2
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


def fork(model, ss, float32=False):
    """An independent copy of (model, engine state); with float32, the copy
    computes in float32 (the same weights and state)."""
    from adaptive_stereo_tpu_torch.engine import DeviceReservoir, FlatStreamState, live_parameters

    m2 = copy.deepcopy(model)
    if float32:
        for mod in m2.modules():
            if isinstance(getattr(mod, "dtype", None), torch.dtype):
                mod.dtype = None
    r = ss.reservoir
    gen = torch.Generator(device=r.values.device)
    gen.set_state(r.generator.get_state())
    res = DeviceReservoir(r.left.clone(), r.right.clone(), r.values.clone(),
                          r.reg_indices.clone(), r.size.clone(), r.count.clone(), gen)
    return m2, FlatStreamState(
        params=live_parameters(m2), n_feature=ss.n_feature, m=[t.clone() for t in ss.m],
        v=[t.clone() for t in ss.v], count=ss.count.clone(), lr=ss.lr.clone(),
        ema_value=ss.ema_value.clone(), ema_init=ss.ema_init.clone(), reservoir=res,
        log=ss.log.clone(), log_pos=ss.log_pos.clone())


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
    _, done, validate = make_flat_streaming_steps(model, s, k, **options)
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
    owner = {id(p): name for name, p in model.named_parameters()}
    modules = {}
    for i, p in enumerate(ss.params):
        name = owner[id(p)]
        module = ("feature" if name.startswith("feature_net.") else
                  "tower" if name.startswith("stereo_net.edge_aware_refinements.") else
                  "aggregation" if name.startswith(("stereo_net.filter.",
                                                    "stereo_net.conv3d_alone.")) else None)
        if module is None:
            raise AssertionError(f"parameter {name} belongs to no module of the comparison")
        modules.setdefault(module, []).append(i)
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
    operators, launches = profile_breakdown(lambda: adapt(ss, *batch), repeats=3, top=24,
                                            unit="step", host_top=10)
    log(f"[training] kernel launches (cudaLaunchKernel) a step {launches:.0f} (before kernels 1 "
        f"and 3 had backward kernels: {STEP_LAUNCHES_BEFORE}, "
        f"{launches - STEP_LAUNCHES_BEFORE:+.0f}); host operators a step {operators:.0f} "
        f"(before: {STEP_OPERATORS_BEFORE}, {operators - STEP_OPERATORS_BEFORE:+.0f})")
    log("[profile] training, fused_tower=False (yardstick)")
    m_y, ss_y, _ = results[False]
    adapt_y = make_flat_streaming_steps(m_y, s, k, **options)[0]
    profile_breakdown(lambda: adapt_y(ss_y, *batch), repeats=3, top=8, unit="step", host_top=5)


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
    training_phase(args.seed, dev, rows)

    keys = ("name", "route", "source", "replaces", "launches", "train_launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "floor_ms", "backward_ms",
            "backward_plain_ms", "backward_bound_ms", "backward_train_launches")
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
