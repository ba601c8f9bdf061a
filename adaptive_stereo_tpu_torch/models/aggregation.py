"""The aggregation stack's weights, gathered for the kernels.

Counterpart of adaptive_stereo_tpu/models/pallas_aggregation.py
(apply_pallas_aggregation, apply_pallas_coarse_head): the stack's
parameters live in the reference layout on StereoNet (filter.{i}.0.0
Conv3d, filter.{i}.0.1 BatchNorm3d, conv3d_alone), and this module hands
them to the kernels in the JAX layout (DHWIO kernels, stacked per-channel
vectors). In train mode (stereo_net.training) the kernels normalise with
the batch statistics, which update the running statistics.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from ..ops.cuda import aggregate_cost_volume_cuda, coarse_head_cuda


def _dhwio(weight: torch.Tensor) -> torch.Tensor:
    """Conv3d weight (O, I, kd, kh, kw) -> (kd, kh, kw, I, O)."""
    return weight.permute(2, 3, 4, 1, 0)


def aggregation_args(stereo_net: nn.Module) -> Tuple[Dict[str, torch.Tensor],
                                                     Tuple[torch.Tensor, torch.Tensor]]:
    """(params, run_stats) of StereoNet's aggregation stack, in the argument
    layout of ops/cuda/aggregation.py."""
    convs = [f[0][0] for f in stereo_net.filter]
    bns = [f[0][1] for f in stereo_net.filter]
    params = {
        "kernels": torch.stack([_dhwio(c.weight) for c in convs]),
        "biases": torch.stack([c.bias for c in convs]),
        "scales": torch.stack([b.weight for b in bns]),
        "bn_biases": torch.stack([b.bias for b in bns]),
        "final_kernel": _dhwio(stereo_net.conv3d_alone.weight),
        "final_bias": stereo_net.conv3d_alone.bias,
    }
    run_stats = (torch.stack([b.running_mean for b in bns]),
                 torch.stack([b.running_var for b in bns]))
    return params, run_stats


BN_MOMENTUM = 0.1


@torch.no_grad()
def update_running_stats(bns, mu: torch.Tensor, var: torch.Tensor) -> None:
    """flax's running-average update of each BatchNorm in bns from the rows
    of the batch statistics mu, var: running = 0.9 * running + 0.1 * batch."""
    for bn, m, v in zip(bns, mu, var):
        bn.running_mean.copy_((1 - BN_MOMENTUM) * bn.running_mean + BN_MOMENTUM * m)
        bn.running_var.copy_((1 - BN_MOMENTUM) * bn.running_var + BN_MOMENTUM * v)


def _update(stereo_net: nn.Module, mu: torch.Tensor, var: torch.Tensor) -> None:
    if stereo_net.training:
        update_running_stats([f[0][1] for f in stereo_net.filter], mu, var)


def apply_aggregation(stereo_net: nn.Module, cost: torch.Tensor) -> torch.Tensor:
    """Aggregation of a (B, D, H, W, 32) cost volume through the CUDA kernel
    (its plain version for CPU tensors), in stereo_net's mode. Returns
    (B, D, H, W) in the cost's dtype."""
    params, run_stats = aggregation_args(stereo_net)
    out, mu, var = aggregate_cost_volume_cuda(cost, params, run_stats,
                                              train=stereo_net.training,
                                              eps=stereo_net.filter[0][0][1].eps)
    _update(stereo_net, mu, var)
    return out


def apply_coarse_head(stereo_net: nn.Module, f_l: torch.Tensor,
                      f_r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse head (cost volume, aggregation, soft-argmin + FCS) of
    (B, h, w, 32) features through the fused CUDA kernel (its plain version
    for CPU tensors), in stereo_net's mode. Returns (disp, fcs), each
    (B, h, w) float32."""
    params, run_stats = aggregation_args(stereo_net)
    disp, fcs, mu, var = coarse_head_cuda(f_l, f_r, params, run_stats,
                                          train=stereo_net.training,
                                          num_disp=stereo_net.num_disp,
                                          eps=stereo_net.filter[0][0][1].eps)
    _update(stereo_net, mu, var)
    return disp, fcs
