"""Cost-volume aggregation stack: CUDA kernel wrapper and its plain version.

Counterpart of adaptive_stereo_tpu/ops/pallas/aggregation.py. The stack is
4 x [Conv3d 32->32 k3 + bias, BatchNorm, LeakyReLU 0.2] + Conv3d 32->1 k3
(reference stereo_net.py:155-162,185-187).

Both functions take the JAX package's arguments, so tests compare like with
like:
  cost       (B, D, H, W, 32) in the compute dtype (float32 or bfloat16)
  params     kernels (4, 3, 3, 3, 32, 32) DHWIO, biases (4, 32),
             scales (4, 32), bn_biases (4, 32),
             final_kernel (3, 3, 3, 32, 1), final_bias (1,)
  run_stats  (running mean (4, 32), running var (4, 32))
and return (out (B, D, H, W) in the compute dtype, mu (4, 32), var (4, 32)).

aggregate_cost_volume_ref is the plain version (mirrors
aggregate_cost_volume_ref of the JAX package). aggregate_cost_volume_cuda
launches csrc/aggregation.cu once per layer on CUDA tensors (eval mode
only), and takes the plain version for CPU tensors only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["aggregate_cost_volume_cuda", "aggregate_cost_volume_ref"]

LEAKY_SLOPE = 0.2
NUM_BN_LAYERS = 4
CHANNELS = 32


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1, 1)


def _oidhw(kernel_dhwio: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return kernel_dhwio.to(dtype).permute(4, 3, 0, 1, 2)


def aggregate_cost_volume_ref(
    cost: torch.Tensor,
    params: Dict[str, torch.Tensor],
    run_stats: Tuple[torch.Tensor, torch.Tensor],
    train: bool,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain aggregation stack (F.conv3d per layer). train=True normalises
    with batch statistics (fast variance, E[y^2] - E[y]^2); train=False with
    the running statistics, which are echoed back as mu/var."""
    cdtype = cost.dtype
    x = cost.permute(0, 4, 1, 2, 3)  # NCDHW
    mus, vars_ = [], []
    for i in range(NUM_BN_LAYERS):
        y = F.conv3d(x, _oidhw(params["kernels"][i], cdtype), padding=1)
        y = y + _per_channel(params["biases"][i].to(cdtype))
        yf = y.float()
        if train:
            mu = yf.mean(dim=(0, 2, 3, 4))
            var = (yf * yf).mean(dim=(0, 2, 3, 4)) - mu * mu
        else:
            mu, var = run_stats[0][i].float(), run_stats[1][i].float()
        mus.append(mu)
        vars_.append(var)
        yn = (yf - _per_channel(mu)) * _per_channel(torch.rsqrt(var + eps))
        yn = yn * _per_channel(params["scales"][i].float()) + _per_channel(
            params["bn_biases"][i].float())
        x = F.leaky_relu(yn.to(cdtype), LEAKY_SLOPE)
    out = F.conv3d(x, _oidhw(params["final_kernel"], cdtype), padding=1)
    out = out + params["final_bias"].to(cdtype)
    return out[:, 0], torch.stack(mus), torch.stack(vars_)


def aggregate_cost_volume_cuda(
    cost: torch.Tensor,
    params: Dict[str, torch.Tensor],
    run_stats: Tuple[torch.Tensor, torch.Tensor],
    train: bool,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The aggregation stack through csrc/aggregation.cu: five launches, one
    per layer. Eval mode only on CUDA (train=True raises)."""
    if cost.device.type == "cpu":
        return aggregate_cost_volume_ref(cost, params, run_stats, train, eps)
    if train:
        raise NotImplementedError(
            "aggregate_cost_volume_cuda: train-mode batch statistics are not "
            "implemented on CUDA yet (eval mode only)")
    _build.require_cuda(cost, "cost", tuple(_build.DTYPE_CODES))
    if cost.dim() != 5 or cost.shape[-1] != CHANNELS:
        raise ValueError(f"cost must be (B, D, H, W, {CHANNELS}), got {tuple(cost.shape)}")
    _build.forward_only("aggregate_cost_volume_cuda", cost, *params.values(), *run_stats)
    b, d, h, w, _ = cost.shape
    cdtype = cost.dtype
    dev = cost.device

    def weights(kernel, cout):
        k = kernel.to(cdtype).contiguous()
        _build.require_cuda(k, "kernel", shape=(3, 3, 3, CHANNELS, cout))
        return k

    def f32(v, name, n):
        v = v.float().contiguous()
        _build.require_cuda(v, name, shape=(n,))
        return v

    layers = []
    for i in range(NUM_BN_LAYERS):
        layers.append((weights(params["kernels"][i], CHANNELS),
                       f32(params["biases"][i], "bias", CHANNELS),
                       tuple(f32(v, name, CHANNELS) for v, name in (
                           (run_stats[0][i], "running mean"),
                           (run_stats[1][i], "running var"),
                           (params["scales"][i], "bn scale"),
                           (params["bn_biases"][i], "bn bias")))))
    layers.append((weights(params["final_kernel"], 1),
                   f32(params["final_bias"], "final bias", 1), None))

    lib = _build.library()
    x = cost
    with torch.cuda.device(dev):
        stream = _build.stream_of(cost)
        for kernel, bias, bn in layers:
            cout = kernel.shape[-1]
            out = torch.empty((b, d, h, w, cout), dtype=cdtype, device=dev)
            bn_ptrs = [t.data_ptr() for t in bn] if bn is not None else [None] * 4
            status = lib.stereo_conv3d_bn_leaky_forward(
                x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), *bn_ptrs,
                out.data_ptr(), b, d, h, w, CHANNELS, cout, int(bn is not None),
                eps, LEAKY_SLOPE, _build.DTYPE_CODES[cdtype], stream)
            _build.check(status, "stereo_conv3d_bn_leaky_forward")
            aggregate_cost_volume_cuda.launches += 1
            x = out
    return x[..., 0], run_stats[0], run_stats[1]


aggregate_cost_volume_cuda.launches = 0
