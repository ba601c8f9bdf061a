"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:
  1. device   the card's name and power limit (nvidia-smi); fails without CUDA
  2. build    nvcc builds adaptive_stereo_tpu_torch/csrc/*.cu for sm_90a
  3. kernels  each kernel against its plain PyTorch version on the card at the
              serving shapes (320x1216, k=4: features (1,20,76,32), cost volume
              (1,12,20,76,32), cost (1,12,20,76)), with times by CUDA events:
              kernels 1-3, kernel 2 in train mode, and the fused coarse head
              (kernel 4) in eval and train mode, f32 and bf16, also against
              kernels 1-3 composed
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

The last two lines are the card's name and power limit, then
{"ok": true, "device": {...}}; the line before them holds the kernel table.
Float32 references run with TF32 off (cudnn.allow_tf32 and
cuda.matmul.allow_tf32 both False), set at the start.
"""

from __future__ import annotations

import argparse
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
FRAMES = 8  # served frames in phase 4, by each engine
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


def profile_breakdown(fn, repeats: int = 3, top: int = 12) -> None:
    """Print device time by kernel name over `repeats` calls of fn() and the
    device's busy share of the wall time, from torch.profiler."""
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
        if evt.device_type != DeviceType.CUDA:  # kernels, copies, memsets only
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            per_name.append((dev_us, evt.count, evt.key))
    total = sum(t for t, _, _ in per_name)
    if total == 0:
        log("[profile] torch.profiler recorded no device time")
        return
    log(f"[profile] {repeats} frames: wall {wall_us / repeats / 1e3:.3f} ms/frame, device "
        f"busy {total / repeats / 1e3:.3f} ms/frame ({100 * total / wall_us:.1f}% of wall)")
    for dev_us, count, name in sorted(per_name, reverse=True)[:top]:
        log(f"[profile]   {dev_us / repeats / 1e3:8.4f} ms/frame  {count // repeats:4d} calls/frame"
            f"  {100 * dev_us / total:5.1f}%  {name[:90]}")


def bound(nbytes: float, ops: float, op_type: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[op_type]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_row(name, source, replaces, wrapper, per_frame, max_abs_err, kernel_fn,
               plain_fn, library_fn, nbytes, ops, op_type, note):
    """Time a kernel, its plain version and (if any) the library call; log
    them with the bound; return the kernel's row of the table."""
    kern, plain = time_ms(kernel_fn), time_ms(plain_fn)
    lib = time_ms(library_fn) if library_fn is not None else None
    b_ms, b_by = bound(nbytes, ops, op_type)
    log(f"[kernels] {name} {note}: kernel {kern}; plain {plain}; library "
        f"{lib if lib is not None else '-'}; bound {b_ms:.5f} ms ({b_by})")
    return dict(name=name, route="cuda", source=f"adaptive_stereo_tpu_torch/csrc/{source}",
                replaces=f"adaptive_stereo_tpu/ops/pallas/{replaces}", wrapper=wrapper,
                per_frame=per_frame, max_abs_err=max_abs_err, ms=kern.ms, plain_ms=plain.ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None if lib is None else lib.ms)


def library_aggregation(cost, params, run_stats, eps=1e-5):
    """cuDNN yardstick: F.conv3d + F.batch_norm + F.leaky_relu per layer on
    NCDHW, timed here only; the port never calls it."""
    dt = cost.dtype
    x = cost.permute(0, 4, 1, 2, 3)
    for i in range(4):
        w = params["kernels"][i].permute(4, 3, 0, 1, 2).to(dt)
        x = F.conv3d(x, w, params["biases"][i].to(dt), padding=1)
        x = F.batch_norm(x, run_stats[0][i], run_stats[1][i], params["scales"][i],
                         params["bn_biases"][i], False, 0.0, eps)
        x = F.leaky_relu(x, 0.2)
    w = params["final_kernel"].permute(4, 3, 0, 1, 2).to(dt)
    return F.conv3d(x, w, params["final_bias"].to(dt), padding=1)[:, 0]


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
        # Cost volume: bitwise equal in bf16 and f32.
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            fl, fr = randn(1, h, w, c, dtype=dt), randn(1, h, w, c, dtype=dt)
            got = difference_cost_volume_cuda(fl, fr, num_disp)
            want = difference_cost_volume_ref(fl, fr, num_disp)
            torch.cuda.synchronize()
            errs[dt] = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError(f"cost volume {dt}: not bitwise equal, max err {errs[dt]}")
        n_sub = h * c * sum(w - d for d in range(min(num_disp, w)))
        rows.append(kernel_row(
            "difference_cost_volume", "cost_volume.cu", "cost_volume.py:66",
            difference_cost_volume_cuda, 1, errs[torch.bfloat16],
            lambda: difference_cost_volume_cuda(fl, fr, num_disp),
            lambda: difference_cost_volume_ref(fl, fr, num_disp), None,
            2 * fl.numel() * 2 + num_disp * fl.numel() * 2, n_sub, "f32_cuda_core",
            f"(1,{num_disp},{h},{w},{c}) bf16, bitwise equal in f32 and bf16"))

        # Aggregation, eval and train mode: bf16 within 0.05 + 0.05|ref|; f32
        # within 1e-3; train-mode mu/var (means of the conv outputs) within
        # the same bands.
        for train in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                cost = randn(1, num_disp, h, w, c, dtype=dt)
                got = aggregate_cost_volume_cuda(cost, params, run_stats, train=train)
                want = aggregate_cost_volume_ref(cost, params, run_stats, train=train)
                torch.cuda.synchronize()
                names = ("out", "mu", "var") if train else ("out",)
                checked = [(n, *agg_band_err(g, r, dt)) for n, g, r in zip(names, got, want)]
                errs[dt] = checked[0][1]
                log(f"[kernels] aggregation {'train' if train else 'eval'} {dt}: max abs err "
                    + ", ".join(f"{n} {e:.3g}" for n, e, _ in checked)
                    + f" (|ref| max {want[0].float().abs().max().item():.3g})")
                if not all(ok for _, _, ok in checked):
                    raise AssertionError(f"aggregation train={train} {dt}: outside tolerance, "
                                         f"{checked}")
            if not train:
                agg_err = errs[torch.bfloat16]
        agg_train = time_ms(lambda: aggregate_cost_volume_cuda(cost, params, run_stats, True))
        log(f"[kernels] aggregate_cost_volume train mode (1,{num_disp},{h},{w},{c}) bf16, "
            f"13 launches: kernel {agg_train}")
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

        # Soft-argmin + FCS: within 1e-5 absolute.
        scost = randn(1, num_disp, h, w, scale=5.0)
        disp, fcs = soft_argmin_fcs_cuda(scost)
        disp_r, fcs_r = soft_argmin_fcs_ref(scost)
        torch.cuda.synchronize()
        err = max((disp - disp_r).abs().max().item(), (fcs - fcs_r).abs().max().item())
        if err > DISP_ABS:
            raise AssertionError(f"soft-argmin+FCS: max abs err {err} > {DISP_ABS}")
        rows.append(kernel_row(
            "soft_argmin_fcs", "disparity.cu", "disparity.py:64", soft_argmin_fcs_cuda, 1, err,
            lambda: soft_argmin_fcs_cuda(scost), lambda: soft_argmin_fcs_ref(scost), None,
            scost.numel() * 4 + 2 * h * w * 4, 8 * scost.numel(), "f32_cuda_core",
            f"(1,{num_disp},{h},{w}) f32, max abs err {err:.3g}"))

        # Fused coarse head, eval and train, f32 and bf16. Against the plain
        # version: disparity (coarse pixels) within DISP0_ABS_PX / 2^k +
        # DISP0_REL |ref|, FCS within fcs_band_factor x the aggregation band,
        # mu/var within the aggregation band. Against kernels 1-3 composed:
        # disparity and FCS within DISP_ABS, mu/var equal (the same
        # arithmetic over the same tiles).
        head_err = 0.0
        for dt in (torch.float32, torch.bfloat16):
            fl, fr = randn(1, h, w, c, dtype=dt), randn(1, h, w, c, dtype=dt)
            for train in (False, True):
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
                log(f"[kernels] coarse_head {mode} {dt}: vs plain disp {d_diff.max().item():.3g} "
                    f"(|ref| max {want[0].abs().max().item():.3g}), fcs {f_err:.3g} "
                    f"(|ref| max {want[1].abs().max().item():.3g}), mu {stats[0][0]:.3g}, "
                    f"var {stats[1][0]:.3g}; vs kernels 1-3 disp/fcs {comp_err:.3g}, "
                    f"mu/var equal {comp_stats}")
                if not (d_ok and f_ok and all(ok for _, ok in stats)):
                    raise AssertionError(f"coarse head {mode} {dt}: outside tolerance of plain")
                if comp_err > DISP_ABS or not comp_stats:
                    raise AssertionError(f"coarse head {mode} {dt}: disagrees with kernels 1-3")
                if dt == torch.bfloat16 and not train:
                    head_err = max(d_diff.max().item(), f_err)
        head_train = time_ms(lambda: coarse_head_cuda(fl, fr, params, run_stats, True,
                                                      num_disp))
        composed = time_ms(lambda: soft_argmin_fcs_cuda(aggregate_cost_volume_cuda(
            difference_cost_volume_cuda(fl, fr, num_disp), params, run_stats, False)[0].float()))
        cudnn = time_ms(lambda: library_aggregation(
            difference_cost_volume_cuda(fl, fr, num_disp), params, run_stats))
        log(f"[kernels] coarse_head yardsticks (no single PyTorch call computes the head): "
            f"kernels 1-3 composed {composed}; cost-volume kernel + cuDNN stack {cudnn}; "
            f"fused head in train mode {head_train}")
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

    table = [{key: row[key] for key in ("name", "route", "source", "replaces", "launches",
                                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")} for row in rows]
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
