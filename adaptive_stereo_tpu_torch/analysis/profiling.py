"""Profiling: torch.profiler traces and a cost analysis of the port's forwards
and steps (counterpart of adaptive_stereo_tpu/analysis/profiling.py, which
uses jax.profiler and XLA's compiled cost model).

- trace(...): a torch.profiler trace (CPU and, on CUDA, CUDA activities) of
  a few calls, written as Chrome trace JSON (view in Perfetto or
  chrome://tracing);
- cost_analysis(...): flops and bytes accessed of one call, the
  denominator of speed-of-light claims;
- achieved_flops(...): seconds per call on the host clock against those
  flops.

Definitions (the port's own; XLA's differ on convolutions):
- flops: torch.utils.flop_counter.FlopCounterMode over the aten ops (2 x
  multiply-adds over the full window of a convolution, padded taps
  included; a matmul as XLA counts it), plus, for each CUDA kernel that
  launches, the count of the plain version it replaces (ops/cuda/work.py;
  the kernels are called through ctypes, where no dispatch mode sees
  them). On CPU tensors the wrappers run their plain versions, whose aten
  ops are counted, so one call counts the same on either device. A
  backward's recompute of a plain forward is not counted.
- bytes accessed: the bytes of every operand and result of each aten op
  (a view or an allocation moves none; an in-place result is its operand),
  as XLA's "bytes accessed" sums operands and outputs, plus what each
  kernel launch reads and writes.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..device import DeviceLike, resolve_device
from ..ops.cuda import work

_ALLOCATIONS = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
                torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default}


class _ByteCounter(TorchDispatchMode):
    """Operand and result bytes of each aten op."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func in _ALLOCATIONS:
            return out
        inputs = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        results = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
                   and not any(t is a for a in inputs)]
        self.bytes += sum(t.numel() * t.element_size() for t in inputs + results)
        return out


def count_work(fn: Callable, *args) -> Dict:
    """Run fn(*args) once and count its work: {'aten_flops', 'aten_bytes',
    'kernel_flops', 'kernel_bytes', 'kernel_calls' {name: calls},
    'kernel_flops_by_name' {name: flops}}."""
    flops = FlopCounterMode(display=False)
    with work.counting() as kernels, flops, _ByteCounter() as nbytes:
        fn(*args)
    return {"aten_flops": flops.get_total_flops(), "aten_bytes": nbytes.bytes,
            "kernel_flops": kernels["flops"], "kernel_bytes": kernels["bytes"],
            "kernel_calls": dict(kernels["calls"]),
            "kernel_flops_by_name": dict(kernels["by_kernel"])}


def cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """{'flops', 'bytes accessed'} of one call of fn(*args) (JAX's keys
    that apply), by the definitions of the module docstring."""
    c = count_work(fn, *args)
    return {"flops": float(c["aten_flops"] + c["kernel_flops"]),
            "bytes accessed": float(c["aten_bytes"] + c["kernel_bytes"])}


def _barrier(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def trace(fn: Callable, *args, log_dir: Optional[str] = None, iters: int = 3,
          device: DeviceLike = None):
    """One warm call, then `iters` calls under torch.profiler (CPU and, on
    CUDA, CUDA activities), each ended by a device barrier; the trace goes
    to log_dir (default <tmp>/torch-trace, /tmp/torch-trace unless TMPDIR
    says otherwise) as <host>.<pid>.<ns>.pt.trace.json. device: where fn
    runs, "cuda" (None) or "cpu". Returns the last output; the trace's path
    is trace.last_path."""
    dev = resolve_device(device)
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    out = fn(*args)
    _barrier(dev)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            out = fn(*args)
            _barrier(dev)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
                                 ".pt.trace.json")
    prof.export_chrome_trace(path)
    trace.last_path = path
    return out


trace.last_path = None


def achieved_flops(fn: Callable, *args, iters: int = 20,
                   device: DeviceLike = None) -> Dict[str, float]:
    """Seconds per call of fn(*args), over `iters` calls after a warm one,
    on the host clock between device barriers (JAX's read-back barrier),
    against cost_analysis's flops. device: "cuda" (None) or "cpu"."""
    dev = resolve_device(device)
    stats = cost_analysis(fn, *args)
    fn(*args)
    _barrier(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _barrier(dev)
    sec = (time.perf_counter() - t0) / iters
    flops = stats["flops"]
    return {
        "seconds_per_call": sec,
        "model_flops": flops,
        "achieved_tflops": flops / sec / 1e12 if sec > 0 else 0.0,
        "bytes_accessed": stats["bytes accessed"],
    }
