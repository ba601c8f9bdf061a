"""Timing benchmark (reference evaluation/stereonet_timing.py:22-75;
counterpart of adaptive_stereo_tpu/analysis/timing.py): N-iteration
inference and inference + backprop at 1x320x1216, k=4, with the device
synchronized around every call (torch.cuda.synchronize) and the median
reported.

The model has random weights (random_init_ from a generator seeded with
0; JAX's flax init is not reproduced) and zero images, as in JAX.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, optional_dtype, resolve_device
from ..engine.state import create_train_state
from ..engine.steps import make_adapt_forward_backward, make_apply_updates
from ..models import StereoModel


def time_stereonet(n: int = 100, height: int = 320, width: int = 1216, k: int = 4,
                   input_scale: int = 0, compute_dtype: Optional[str] = "bfloat16",
                   include_backprop: bool = True, batch_size: int = 1,
                   device: DeviceLike = None) -> Dict[str, float]:
    """Returns {'inference_sec', 'inference_hz', 'backprop_sec',
    'backprop_hz'} (the last two with include_backprop). The backprop step
    is the adaptation step without replay: forward, Monodepth loss,
    backward and an Adam update. device: "cuda" (None) or "cpu"."""
    dev = resolve_device(device)
    model = StereoModel(k=k, input_scale=input_scale, dtype=optional_dtype(compute_dtype),
                        device=dev)
    state = create_train_state(model, torch.Generator().manual_seed(0), 1e-4)
    left = torch.zeros((batch_size, height, width, 3), device=dev)
    right = torch.zeros((batch_size, height, width, 3), device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run_timed(fn):
        fn()
        sync()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    @torch.no_grad()
    def forward():
        model.eval()
        return model(left, right, side="l")

    results: Dict[str, float] = {}
    t = run_timed(forward)
    results["inference_sec"] = t
    results["inference_hz"] = batch_size / t

    if include_backprop:
        s = input_scale
        batch = {f"color_l/{s}": left, f"color_r/{s}": right}
        fwd_bwd = make_adapt_forward_backward(model, s, k, use_er=False)
        apply_updates = make_apply_updates(clip_grad_norm=False)
        do_update = torch.ones((), dtype=torch.bool, device=dev)

        def step():
            grads, _ = fwd_bwd(state, batch, batch)
            return apply_updates(state, grads, do_update)

        t = run_timed(step)
        results["backprop_sec"] = t
        results["backprop_hz"] = 1.0 / t
    return results
