"""StereoNet (Khamis et al. 2018) as PyTorch nn.Modules.

Counterpart of adaptive_stereo_tpu/models/stereo_net.py with
StereoModel(use_pallas=True, pallas_aggregation=True): the coarse head runs
the three CUDA kernels of ops/cuda (cost volume, aggregation stack, fused
soft-argmin + FCS), or with fused_coarse_head=True the one fused coarse-head
kernel; the feature tower is F.conv2d. The full-resolution refinement is
F.conv2d, or with fused_tower=True the refinement-tower kernels
(ops/cuda/tower.py; JAX: pallas_tower=True, s2d_refinement=True).

The modules carry the reference's state-dict keys (downsample.{i},
residual_blocks.{i}.conv1.0.{0,1}, filter.{i}.0.{0,1}, conv3d_alone,
edge_aware_refinements.0.*), so the reference's feature_net.pth /
stereo_net.pth load with load_state_dict(strict=True).

Layouts at the public surface are the JAX package's: images (B, H, W, 3),
features (B, h, w, 32), cost volume (B, D, h, w, 32), disparities
(B, H, W, 1). Inside, the 2D convolutions run NCHW.

Train mode (module.train()) is flax's BatchNorm, not nn.BatchNorm's: the
batch statistics are mu = E[y] and the biased var = E[y^2] - mu^2 in f32,
and the running statistics update as 0.9 * running + 0.1 * batch (no
gradient), on every train-mode forward. Eval mode normalises with the
running statistics.

Quirks of the reference kept on purpose:
- BasicBlock is x + leaky_relu(convbn(x), 0.2); its conv2 exists only so the
  state-dict keys load (reference stereo_net.py:44-51).
- Convs inside conv+BN keep their bias. BatchNorm eps 1e-5, momentum 0.1.
- The coarse output is 2**k * bilinear(pred), while the refinement scales
  the upsampled disparity by the true width ratio W / w.
- Softmax (not softmin) over the pre-softmax cost.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike, optional_dtype, resolve_device
from ..ops.cuda import difference_cost_volume_cuda, soft_argmin_fcs_cuda, tower_cuda
from .aggregation import (BN_MOMENTUM, apply_aggregation, apply_coarse_head,
                          update_running_stats)

LEAKY_SLOPE = 0.2
BN_EPS = 1e-5


def coarse_num_disparities(maxdisp: int, input_scale: int, k: int) -> int:
    """Candidate disparities at the coarse cost-volume scale:
    (maxdisp + 1) // 2^(input_scale + k) (reference stereo_net.py:169)."""
    return (maxdisp + 1) // (2 ** (input_scale + k))


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor with half-pixel centres
    (align_corners=False), which equals jax.image.resize(method='linear')
    when upsampling. On CUDA tensors its gradient sums in a fixed order
    (_ResizeBilinear), so that a training step repeats bit for bit."""
    if x.device.type == "cuda":
        return _ResizeBilinear.apply(x, tuple(size))
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


@functools.lru_cache(maxsize=None)
def _resize_matrix(out_size: int, in_size: int, device: str) -> torch.Tensor:
    """(out_size, in_size) float32 weights of the bilinear resize along one
    axis, as F.interpolate computes them: source index max((o + 0.5) * in /
    out - 0.5, 0), its floor and the next index (clamped to the edge),
    weighted 1 - frac and frac."""
    scale = torch.tensor(in_size, dtype=torch.float32) / out_size
    src = ((torch.arange(out_size, dtype=torch.float32) + 0.5) * scale - 0.5).clamp(min=0)
    i0 = src.long()
    i1 = (i0 + 1).clamp(max=in_size - 1)
    frac = src - i0
    rows = torch.arange(out_size)
    a = torch.zeros(out_size, in_size)
    a.index_put_((rows, i0), 1 - frac, accumulate=True)
    a.index_put_((rows, i1), frac, accumulate=True)
    return a.to(device)


class _ResizeBilinear(torch.autograd.Function):
    """F.interpolate's bilinear resize whose backward is the transposed
    resize as two matrix products. PyTorch's CUDA backward of the resize
    accumulates with float atomics, in an order that changes from run to
    run, so two runs of one adapt step would end with different weights."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.in_hw = tuple(x.shape[-2:])
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False)

    @staticmethod
    def backward(ctx, g):
        (h, w), (oh, ow), dev = ctx.in_hw, g.shape[-2:], str(g.device)
        gx = _resize_matrix(oh, h, dev).t() @ g.float() @ _resize_matrix(ow, w, dev)
        return gx.to(g.dtype), None


def convbn(cin: int, cout: int, kernel_size: int, stride: int = 1, pad: int = 1,
           dilation: int = 1, device=None) -> nn.Sequential:
    """Conv2d(+bias) + BatchNorm2d, reference convbn (stereo_net.py:8-18)."""
    p = dilation if dilation > 1 else pad
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel_size, stride, p, dilation, bias=True, device=device),
        nn.BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM, device=device))


def _conv(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """conv's own arguments, computed in x's dtype."""
    fn = F.conv2d if isinstance(conv, nn.Conv2d) else F.conv3d
    return fn(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), conv.stride,
              conv.padding, conv.dilation)


def _bn(x: torch.Tensor, bn: nn.Module) -> torch.Tensor:
    """BatchNorm with bn's float32 parameters on x (channels at dim 1); the
    result is in x's dtype (computed in float32 for a bfloat16 x). Eval mode
    uses the running statistics; train mode the batch statistics by flax's
    rule (max(E[y^2] - E[y]^2, 0) for the variance), and updates the
    running statistics."""
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            False, 0.0, bn.eps)
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    xf = x.float()
    mu = xf.mean(dim=dims)
    var = torch.clamp((xf * xf).mean(dim=dims) - mu * mu, min=0.0)
    update_running_stats([bn], mu[None], var[None])
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((xf - mu.view(shape)) * mul.view(shape) + bn.bias.view(shape)).to(x.dtype)


def _convbn(x: torch.Tensor, seq: nn.Sequential) -> torch.Tensor:
    return _bn(_conv(x, seq[0]), seq[1])


class BasicBlock(nn.Module):
    """Residual block, reference stereo_net.py:33-51: x + leaky(convbn(x)).
    conv2 is never applied (the reference quirk) but owns state-dict keys."""

    def __init__(self, channels: int = 32, dilation: int = 1, device=None):
        super().__init__()
        self.conv1 = nn.Sequential(convbn(channels, channels, 3, 1, 1, dilation, device),
                                   nn.LeakyReLU(LEAKY_SLOPE))
        self.conv2 = convbn(channels, channels, 3, 1, 1, dilation, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + F.leaky_relu(_convbn(x, self.conv1[0]), LEAKY_SLOPE)


class FeatureExtractorNetwork(nn.Module):
    """Siamese feature tower, reference stereo_net.py:54-85: k stride-2 5x5
    convs (3 -> 32), six residual blocks, a final 3x3 conv.

    forward takes (B, H, W, 3) and returns (B, H/2^k, W/2^k, 32) in the
    compute dtype (float32 when dtype is None)."""

    def __init__(self, k: int, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.k = k
        self.dtype = dtype
        self.downsample = nn.ModuleList(
            nn.Conv2d(3 if i == 0 else 32, 32, 5, 2, 2, device=device) for i in range(k))
        self.residual_blocks = nn.ModuleList(BasicBlock(32, 1, device) for _ in range(6))
        self.conv_alone = nn.Conv2d(32, 32, 3, 1, 1, device=device)

    def forward(self, rgb_img: torch.Tensor) -> torch.Tensor:
        x = rgb_img.permute(0, 3, 1, 2)
        if self.dtype is not None:
            x = x.to(self.dtype)
        for conv in self.downsample:
            x = _conv(x, conv)
        for block in self.residual_blocks:
            x = block(x)
        return _conv(x, self.conv_alone).permute(0, 2, 3, 1).contiguous()


class EdgeAwareRefinement(nn.Module):
    """Edge-aware refinement, reference stereo_net.py:88-121: upsample the
    coarse disparity, scale it by W / w, concatenate the RGB guide, run a
    dilated residual tower (1, 2, 4, 8, 1, 1) and add a 1-channel residual,
    then ReLU. fused_tower=True runs the 8 layers through the tower kernels
    (ops/cuda/tower.py, the counterpart of JAX
    s2d_refinement.py:_apply_pallas_tower), with the same parameters."""

    def __init__(self, dtype: Optional[torch.dtype] = None, device=None,
                 fused_tower: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fused_tower = fused_tower
        self.conv2d_feature = nn.Sequential(convbn(4, 32, 3, 1, 1, 1, device),
                                            nn.LeakyReLU(LEAKY_SLOPE))
        self.residual_astrous_blocks = nn.ModuleList(
            BasicBlock(32, d, device) for d in (1, 2, 4, 8, 1, 1))
        self.conv2d_out = nn.Conv2d(32, 1, 3, 1, 1, device=device)

    def forward(self, coarse_disparity: torch.Tensor, guidance_rgb: torch.Tensor) -> torch.Tensor:
        """coarse_disparity (B, h, w) float32, guidance_rgb (B, H, W, 3) ->
        refined disparity (B, H, W, 1) float32."""
        h, w = guidance_rgb.shape[1], guidance_rgb.shape[2]
        up = resize_bilinear(coarse_disparity[:, None], (h, w))
        up = up * (w / coarse_disparity.shape[2])
        guide = guidance_rgb.permute(0, 3, 1, 2)
        x = torch.cat([up.to(guide.dtype), guide], dim=1)
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.fused_tower:
            residual = self.tower(x.permute(0, 2, 3, 1))
            return F.relu(up.permute(0, 2, 3, 1) + residual.to(up.dtype))
        x = F.leaky_relu(_convbn(x, self.conv2d_feature[0]), LEAKY_SLOPE)
        for block in self.residual_astrous_blocks:
            x = block(x)
        residual = _conv(x, self.conv2d_out)
        return F.relu(up + residual.to(up.dtype)).permute(0, 2, 3, 1)

    def tower_layers(self):
        """The tower's 8 convs and 7 BatchNorms, in layer order."""
        convs = [self.conv2d_feature[0][0]] + [
            blk.conv1[0][0] for blk in self.residual_astrous_blocks] + [self.conv2d_out]
        bns = [self.conv2d_feature[0][1]] + [blk.conv1[0][1]
                                             for blk in self.residual_astrous_blocks]
        return convs, bns

    def tower(self, x0: torch.Tensor) -> torch.Tensor:
        """The 8 layers through tower_cuda on x0 (B, H, W, 4) in the compute
        dtype; updates the running statistics in train mode. Returns the
        residual (B, H, W, 1)."""
        convs, bns = self.tower_layers()
        params = {
            "kernels": [c.weight.permute(2, 3, 1, 0) for c in convs],
            "biases": [c.bias for c in convs],
            "gammas": torch.stack([b.weight for b in bns]),
            "betas": torch.stack([b.bias for b in bns]),
        }
        run_stats = (torch.stack([b.running_mean for b in bns]),
                     torch.stack([b.running_var for b in bns]))
        residual, mu, var = tower_cuda(x0.contiguous(), params, run_stats, self.training,
                                       bns[0].eps)
        if self.training:
            update_running_stats(bns, mu, var)
        return residual


class StereoNet(nn.Module):
    """Cost volume + aggregation + soft-argmin/FCS + refinement, reference
    stereo_net.py:137-207, with the coarse head on the CUDA kernels of
    ops/cuda: the three stages in turn, or (fused_coarse_head=True) the one
    fused kernel. Both paths use the same parameters.

    forward(left_img, left_features, right_features, side, output_cost_volume)
    returns
      pred_disp_{side}/{input_scale + k}: 2^k * bilinear(coarse), (B, H, W, 1)
      pred_disp_{side}/{input_scale}:     refined disparity, (B, H, W, 1)
      fcs_{side}/{input_scale + k}:       per-pixel FCS, (B, h, w)
      cost_volume_{side}/{input_scale + k}: the float32 pre-softmax cost
                                          (B, D, h, w), if output_cost_volume
    (JAX stereo_net.py:238-296). output_cost_volume takes the three-stage
    path, which materialises the cost, whatever fused_coarse_head says.
    Train mode runs the kernels with batch statistics and updates the
    running statistics; the three-stage path is differentiable, the fused
    head (forward only) is not.
    """

    def __init__(self, k: int, r: int = 1, input_scale: int = 0, maxdisp: int = 192,
                 dtype: Optional[torch.dtype] = None, device=None,
                 fused_coarse_head: bool = False, fused_tower: bool = False):
        super().__init__()
        self.k = k
        self.input_scale = input_scale
        self.maxdisp = maxdisp
        self.dtype = dtype
        self.fused_coarse_head = fused_coarse_head
        self.filter = nn.ModuleList(
            nn.Sequential(
                nn.Sequential(nn.Conv3d(32, 32, 3, 1, 1, device=device),
                              nn.BatchNorm3d(32, eps=BN_EPS, momentum=BN_MOMENTUM,
                                             device=device)),
                nn.LeakyReLU(LEAKY_SLOPE))
            for _ in range(4))
        self.conv3d_alone = nn.Conv3d(32, 1, 3, 1, 1, device=device)
        self.edge_aware_refinements = nn.ModuleList(
            EdgeAwareRefinement(dtype, device, fused_tower) for _ in range(r))

    @property
    def num_disp(self) -> int:
        return coarse_num_disparities(self.maxdisp, self.input_scale, self.k)

    def forward(self, left_img: torch.Tensor, left_features: torch.Tensor,
                right_features: torch.Tensor, side: str = "l",
                output_cost_volume: bool = False) -> Dict[str, torch.Tensor]:
        coarse_scale = self.input_scale + self.k
        if self.fused_coarse_head and not output_cost_volume:
            fl, fr = left_features, right_features
            if self.dtype is not None:
                fl, fr = fl.to(self.dtype), fr.to(self.dtype)
            pred, fcs = apply_coarse_head(self, fl, fr)
            return self.finish({f"fcs_{side}/{coarse_scale}": fcs}, pred, left_img, side)
        cost = difference_cost_volume_cuda(left_features, right_features, self.num_disp)
        if self.dtype is not None:
            cost = cost.to(self.dtype)
        cost = apply_aggregation(self, cost).float()
        pred, fcs = soft_argmin_fcs_cuda(cost)
        outputs = {f"fcs_{side}/{coarse_scale}": fcs}
        if output_cost_volume:
            outputs[f"cost_volume_{side}/{coarse_scale}"] = cost
        return self.finish(outputs, pred, left_img, side)

    def finish(self, outputs: Dict[str, torch.Tensor], pred: torch.Tensor,
               left_img: torch.Tensor, side: str) -> Dict[str, torch.Tensor]:
        """Coarse upsample (the x2^k quirk) and edge-aware refinement of the
        coarse disparity pred (B, h, w)."""
        h, w = left_img.shape[1], left_img.shape[2]
        coarse = (2 ** self.k) * resize_bilinear(pred[:, None], (h, w))
        outputs[f"pred_disp_{side}/{self.input_scale + self.k}"] = coarse.permute(0, 2, 3, 1)
        outputs[f"pred_disp_{side}/{self.input_scale}"] = \
            self.edge_aware_refinements[0](pred, left_img)
        return outputs


class StereoModel(nn.Module):
    """Feature tower on both views + the StereoNet head, one forward
    (reference train.py:19-22). Built on `device` ("cuda" unless the caller
    passes "cpu"); the CUDA kernels serve the coarse head there, three in
    turn or, with fused_coarse_head=True, the fused one, and with
    fused_tower=True the refinement tower.

    fused_siamese: both views through the feature tower as one batch-2B
    forward (JAX stereo_net.py:354-362): BatchNorm statistics are over both
    views jointly, and the running statistics update once.
    """

    def __init__(self, k: int, input_scale: int = 0, maxdisp: int = 192,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 fused_coarse_head: bool = False, fused_siamese: bool = False,
                 fused_tower: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.fused_siamese = fused_siamese
        self.feature_net = FeatureExtractorNetwork(k, dtype, dev)
        self.stereo_net = StereoNet(k, 1, input_scale, maxdisp, dtype, dev, fused_coarse_head,
                                    fused_tower)

    def load_state_dicts(self, feature_sd, stereo_sd) -> "StereoModel":
        """Load the reference-layout pair (strict), e.g. from
        models/weights.py."""
        self.feature_net.load_state_dict(feature_sd, strict=True)
        self.stereo_net.load_state_dict(stereo_sd, strict=True)
        return self

    def forward(self, left_img: torch.Tensor, right_img: torch.Tensor,
                side: str = "l", output_cost_volume: bool = False) -> Dict[str, torch.Tensor]:
        if self.fused_siamese:
            b = left_img.shape[0]
            f = self.feature_net(torch.cat([left_img, right_img], dim=0))
            fl, fr = f[:b], f[b:]
        else:
            fl = self.feature_net(left_img)
            fr = self.feature_net(right_img)
        return self.stereo_net(left_img, fl, fr, side, output_cost_volume)


def build_model(model_cfg, device: DeviceLike = None) -> StereoModel:
    """The StereoModel of a ModelConfig (engine/config.py) on `device`
    (s2d_refinement selects the refinement-tower kernels, the port's
    counterpart of JAX's space-to-depth tower)."""
    mc = model_cfg
    return StereoModel(k=mc.k, input_scale=mc.input_scale, maxdisp=mc.maxdisp,
                       dtype=optional_dtype(mc.compute_dtype), device=device,
                       fused_siamese=mc.fused_siamese, fused_tower=mc.s2d_refinement)


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter and BatchNorm statistic of module from generator
    (random weights for smoke runs and tests). Conv weights:
    U(-sqrt(3/fan_in), sqrt(3/fan_in)), variance 1/fan_in, the scale of the
    JAX package's lecun_normal init (PyTorch's default is a third of that,
    which shrinks the aggregated cost to ~0.05 and the softmax to uniform).
    Conv biases: U(-1/sqrt(fan_in), 1/sqrt(fan_in)). The refinement's
    output conv (conv2d_out) is drawn at 1/100 of that scale, so the
    residual head starts near zero and the refined disparity near the
    upsampled coarse one; at full scale its random residual outweighs the
    disparity and the final ReLU zeroes most pixels for some seeds.
    BatchNorm: weight U(0.9, 1.1), bias U(-0.1, 0.1), running mean
    U(-0.1, 0.1), running var U(0.9, 1.1), so the normalisation is not an
    identity."""
    def uniform(t, lo, hi):
        # Drawn on the generator's device, then moved: one stream of numbers
        # whatever device the module lives on.
        t.copy_(torch.empty(t.shape, dtype=t.dtype, device=generator.device)
                .uniform_(lo, hi, generator=generator))

    residual_heads = {id(m.conv2d_out) for m in module.modules()
                      if isinstance(m, EdgeAwareRefinement)}
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            fan_in = float(m.weight[0].numel())
            scale = 0.01 if id(m) in residual_heads else 1.0
            bound = scale * (3.0 / fan_in) ** 0.5
            uniform(m.weight, -bound, bound)
            uniform(m.bias, -scale * fan_in ** -0.5, scale * fan_in ** -0.5)
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            uniform(m.weight, 0.9, 1.1)
            uniform(m.bias, -0.1, 0.1)
            uniform(m.running_mean, -0.1, 0.1)
            uniform(m.running_var, 0.9, 1.1)
    return module
