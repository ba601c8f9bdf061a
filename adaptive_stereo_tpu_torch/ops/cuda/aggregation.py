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
launches csrc/aggregation.cu on CUDA tensors, and takes the plain version
for CPU tensors only. Eval mode is one launch per layer (five); train mode
adds, per BatchNorm layer, the batch statistics (a deterministic reduction
across blocks, csrc/bn_stats.cuh) and the normalisation as launches of
their own (thirteen in all). Each layer launch runs one block per row tile
of tile_plan (csrc/conv3d.cuh), shared with the fused coarse head.

On CUDA the wrapper is a torch.autograd.Function, differentiable in the cost
and the params (the running statistics carry no gradient, nor do mu/var).
Its backward is the JAX custom VJP (ops/pallas/aggregation.py:455-467):
recompute the stack through aggregate_cost_volume_ref and take autograd of
it, with the incoming gradient cast to float32 and then to the cost's dtype.

Each call that launches the kernels adds aggregation_flops (the plain
stack's convolutions as FlopCounterMode counts them) and the bytes of its
launches to the open counts of work.py; the backward's recompute is not
counted, its autograd is.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import _build, work

__all__ = ["aggregate_cost_volume_cuda", "aggregate_cost_volume_ref", "aggregation_flops",
           "tile_plan"]

PARAM_NAMES = ("kernels", "biases", "scales", "bn_biases", "final_kernel", "final_bias")

LEAKY_SLOPE = 0.2
NUM_BN_LAYERS = 4
CHANNELS = 32
# Most w positions of one row tile (STEREO_TILE_MAX_W in csrc/conv3d.cuh).
TILE_MAX_W = 80


def aggregation_flops(b: int, d: int, h: int, w: int) -> int:
    """FlopCounterMode's count of the plain stack on a (b, d, h, w, 32)
    cost: four 3x3x3 convolutions 32 -> 32 and one 32 -> 1, 2 x
    multiply-adds over the full window."""
    n = b * d * h * w
    return (NUM_BN_LAYERS * work.conv_flops(n, CHANNELS, CHANNELS, 27)
            + work.conv_flops(n, CHANNELS, 1, 27))


def aggregation_bytes(b: int, d: int, h: int, w: int, itemsize: int, train: bool) -> int:
    """Bytes the stack's launches read and write: each layer's input and
    output (train mode: the normalisation reads and writes the output once
    more), and the weights."""
    n = b * d * h * w
    layers = NUM_BN_LAYERS * (4 if train else 2) * n * CHANNELS + n * CHANNELS + n
    weights = (NUM_BN_LAYERS * 27 * CHANNELS * CHANNELS + 27 * CHANNELS)
    return (layers + weights) * itemsize


class TilePlan(NamedTuple):
    """How csrc/conv3d.cuh cuts a (B, D, H, W) volume into row tiles: each
    tile is one (b, d, h) and a run of at most wc consecutive w, one block
    each; tile j covers w from (j % tiles_per_row) * wc of row
    j // tiles_per_row. nparts is the number of tiles, the rows of the
    train-mode partial sums; smem is a block's dynamic shared memory."""
    wc: int
    tiles_per_row: int
    nparts: int
    smem: int


def tile_plan(b: int, d: int, h: int, w: int, dtype: torch.dtype = torch.bfloat16) -> TilePlan:
    """The row split for every width: as few tiles per row as runs of at
    most TILE_MAX_W allow, of nearly equal length (W = 76: one tile of 76;
    W = 300: four of 75). bfloat16 stages the halo, 3 x 3 x (mt + 2) rows
    of 32 channels with mt = wc rounded up to 16, and the 27 x 32 x 32
    weights: at most 102,528 bytes, so two blocks fit on an SM. float32
    stages nothing."""
    per_row = -(-w // TILE_MAX_W)
    wc = -(-w // per_row)
    per_row = -(-w // wc)
    mt = -(-wc // 16) * 16
    smem = 9 * (mt + 2) * CHANNELS * 2 + 27 * CHANNELS * CHANNELS * 2 \
        if dtype == torch.bfloat16 else 0
    return TilePlan(wc, per_row, b * d * h * per_row, smem)


def _partials(plan: TilePlan, device) -> torch.Tensor:
    """Scratch for the train-mode partial sums: one row of (sum y, sum y^2)
    per channel for each row tile."""
    return torch.empty((plan.nparts, 2, CHANNELS), dtype=torch.float32, device=device)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1, 1)


def _oidhw(kernel_dhwio: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return kernel_dhwio.to(dtype).permute(4, 3, 0, 1, 2)


def _stack_weights(params: Dict[str, torch.Tensor],
                  run_stats: Tuple[torch.Tensor, torch.Tensor], cdtype: torch.dtype):
    """The stack's weights as the kernels take them, each validated on CUDA:
    four (kernel (3,3,3,32,32) in cdtype, bias (32,), (running mean, running
    var, bn scale, bn bias) each (32,) float32) and the final (kernel
    (3,3,3,32,1) in cdtype, bias (1,) float32)."""
    def weights(kernel, cout):
        k = kernel.to(cdtype).contiguous()
        _build.require_cuda(k, "kernel", shape=(3, 3, 3, CHANNELS, cout))
        _build.require_aligned(k, "kernel")
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
    final = (weights(params["final_kernel"], 1), f32(params["final_bias"], "final bias", 1))
    return layers, final


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


class _Aggregation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cost, rmean, rvar, train, eps, *values):
        params = dict(zip(PARAM_NAMES, values))
        out, mu, var = _launch(cost, params, (rmean, rvar), train, eps)
        ctx.save_for_backward(cost, rmean, rvar, *values)
        ctx.train, ctx.eps = train, eps
        ctx.mark_non_differentiable(mu, var)
        return out, mu, var

    @staticmethod
    def backward(ctx, g_out, _g_mu, _g_var):
        cost, rmean, rvar, *values = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (cost, *values)]
            with work.uncounted():
                out = aggregate_cost_volume_ref(inputs[0], dict(zip(PARAM_NAMES, inputs[1:])),
                                                (rmean, rvar), ctx.train, ctx.eps)[0]
            grads = torch.autograd.grad(out, inputs, g_out.float().to(cost.dtype))
        return (grads[0], None, None, None, None, *grads[1:])


def aggregate_cost_volume_cuda(
    cost: torch.Tensor,
    params: Dict[str, torch.Tensor],
    run_stats: Tuple[torch.Tensor, torch.Tensor],
    train: bool,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The aggregation stack through csrc/aggregation.cu. Eval mode: five
    launches, one per layer, normalising with run_stats, which come back as
    mu/var. Train mode: per BatchNorm layer the conv with per-block sums,
    the reduction to the batch statistics (fast variance) and the
    normalisation, then the final layer; mu/var are the batch statistics.
    Differentiable in cost and params."""
    if cost.device.type == "cpu":
        return aggregate_cost_volume_ref(cost, params, run_stats, train, eps)
    return _Aggregation.apply(cost, run_stats[0], run_stats[1], train, eps,
                              *(params[name] for name in PARAM_NAMES))


def _launch(cost, params, run_stats, train, eps):
    _build.require_cuda(cost, "cost", tuple(_build.DTYPE_CODES))
    if cost.dim() != 5 or cost.shape[-1] != CHANNELS:
        raise ValueError(f"cost must be (B, D, H, W, {CHANNELS}), got {tuple(cost.shape)}")
    _build.require_aligned(cost, "cost")
    b, d, h, w, _ = cost.shape
    cdtype = cost.dtype
    dev = cost.device
    dcode = _build.DTYPE_CODES[cdtype]
    layers, final = _stack_weights(params, run_stats, cdtype)
    plan = tile_plan(b, d, h, w, cdtype)
    n = cost.numel()
    if train:
        mu = torch.empty((NUM_BN_LAYERS, CHANNELS), dtype=torch.float32, device=dev)
        var = torch.empty_like(mu)
        partials = _partials(plan, dev)

    lib = _build.library()
    x = cost
    with torch.cuda.device(dev):
        stream = _build.stream_of(cost)
        for i, (kernel, bias, (rmean, rvar, gamma, beta)) in enumerate(layers):
            out = torch.empty_like(cost)
            if not train:
                _build.check(lib.stereo_conv3d_bn_leaky_forward(
                    x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), rmean.data_ptr(),
                    rvar.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                    b, d, h, w, CHANNELS, 1, plan.wc, plan.smem, eps, LEAKY_SLOPE, dcode,
                    stream), "stereo_conv3d_bn_leaky_forward")
                aggregate_cost_volume_cuda.launches += 1
                x = out
                continue
            _build.check(lib.stereo_conv3d_stats_forward(
                x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), out.data_ptr(),
                partials.data_ptr(), plan.nparts, b, d, h, w, plan.wc, plan.smem, dcode,
                stream), "stereo_conv3d_stats_forward")
            _build.check(lib.stereo_bn_stats_finalize(
                partials.data_ptr(), plan.nparts, CHANNELS, n // CHANNELS, mu[i].data_ptr(),
                var[i].data_ptr(), stream), "stereo_bn_stats_finalize")
            _build.check(lib.stereo_bn_leaky_apply(
                out.data_ptr(), mu[i].data_ptr(), var[i].data_ptr(), gamma.data_ptr(),
                beta.data_ptr(), n, CHANNELS, eps, LEAKY_SLOPE, dcode, stream),
                "stereo_bn_leaky_apply")
            aggregate_cost_volume_cuda.launches += 3
            x = out
        kernel, bias = final
        out = torch.empty((b, d, h, w, 1), dtype=cdtype, device=dev)
        _build.check(lib.stereo_conv3d_bn_leaky_forward(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), None, None, None, None,
            out.data_ptr(), b, d, h, w, 1, 0, plan.wc, plan.smem, eps, LEAKY_SLOPE, dcode,
            stream), "stereo_conv3d_bn_leaky_forward")
        aggregate_cost_volume_cuda.launches += 1
    work.add("aggregate_cost_volume", aggregation_flops(b, d, h, w),
             aggregation_bytes(b, d, h, w, cost.element_size(), train))
    if train:
        return out[..., 0], mu, var
    return out[..., 0], run_stats[0], run_stats[1]


aggregate_cost_volume_cuda.launches = 0
