"""The aggregation stack's weights, gathered for the kernels.

Counterpart of adaptive_stereo_tpu/models/pallas_aggregation.py
(apply_pallas_aggregation, apply_pallas_coarse_head): the stack's
parameters live in the reference layout on StereoNet (filter.{i}.0.0
Conv3d, filter.{i}.0.1 BatchNorm3d, conv3d_alone), and this module hands
them to the kernels in the JAX layout (DHWIO kernels, stacked per-channel
vectors). Eval mode only: the running-statistics update of train mode comes
with the model's train forward.
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


def apply_aggregation(stereo_net: nn.Module, cost: torch.Tensor) -> torch.Tensor:
    """Eval-mode aggregation of a (B, D, H, W, 32) cost volume through the
    CUDA kernel (its plain version for CPU tensors). Returns (B, D, H, W) in
    the cost's dtype."""
    params, run_stats = aggregation_args(stereo_net)
    out, _, _ = aggregate_cost_volume_cuda(cost, params, run_stats, train=False,
                                           eps=stereo_net.filter[0][0][1].eps)
    return out


def apply_coarse_head(stereo_net: nn.Module, f_l: torch.Tensor,
                      f_r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode coarse head (cost volume, aggregation, soft-argmin + FCS) of
    (B, h, w, 32) features through the fused CUDA kernel (its plain version
    for CPU tensors). Returns (disp, fcs), each (B, h, w) float32."""
    params, run_stats = aggregation_args(stereo_net)
    disp, fcs, _, _ = coarse_head_cuda(f_l, f_r, params, run_stats, train=False,
                                       num_disp=stereo_net.num_disp,
                                       eps=stereo_net.filter[0][0][1].eps)
    return disp, fcs
