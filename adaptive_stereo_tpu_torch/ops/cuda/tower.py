"""The edge-aware refinement tower: CUDA kernel wrappers and the plain version.

Counterpart of adaptive_stereo_tpu/ops/pallas/tower.py (tower_pallas, its
forward chain tower_forward and backward chain tower_backward) and of its
golden twin models/s2d_refinement.py:_tower_ref_raw, on the plain
channels-last layout instead of the TPU's 2x2 space-to-depth packing.

The tower is 8 layers of 3x3 convolutions with dilations DILATIONS:
layer 0 maps the 4-channel input (upsampled disparity + RGB) to 32
channels, layers 1-6 are residual blocks x + leaky(bn(conv(x))), layer 7
maps 32 channels to the 1-channel residual. Layers 0-6 carry BatchNorm
(batch statistics in train mode, running statistics in eval mode) and
LeakyReLU 0.2.

Arguments, in the JAX package's layout:
  x0         (B, H, W, 4) in the compute dtype (float32 or bfloat16)
  params     "kernels": 8 HWIO kernels (3, 3, cin, cout) (the kernel path
             casts them to the compute dtype), "biases": 8 vectors (cout,),
             "gammas", "betas": (7, 32) BatchNorm scale and bias
  run_stats  (running mean (7, 32), running var (7, 32))
and the result is (y7 (B, H, W, 1) in the compute dtype, mu (7, 32), var
(7, 32)): the batch statistics in train mode, the running statistics
echoed in eval mode.

tower_ref is the plain version with _tower_ref_raw's numerics: each conv
runs in the compute dtype (f32 accumulation, rounded) and adds the bias
there; the BN epilogue is f32 from f32 statistics; the activation is
rounded to the compute dtype and then added to the residual. tower_cuda
runs the chain through csrc/tower.cu on CUDA tensors (a
torch.autograd.Function whose backward is the kernels' backward chain), and
takes tower_ref for CPU tensors only. The kernels round as the TPU kernel
does: the bias is added before the conv output is rounded, and the residual
add before the activation is rounded. In bfloat16 the convs with 32 input
channels and every weight gradient run on the tensor cores. Launches are counted per chain:
tower_forward_cuda.launches (15 in train mode, 8 in eval mode) and
tower_backward_cuda.launches (31).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["DILATIONS", "tower_backward_cuda", "tower_cuda", "tower_forward_cuda",
           "tower_ref"]

DILATIONS = (1, 1, 2, 4, 8, 1, 1, 1)
NUM_LAYERS = 8
NUM_BN = 7
CHANNELS = 32
IN_CHANNELS = 4
LEAKY_SLOPE = 0.2
# Pixel tile of csrc/tower.cu's conv kernels (TOWER_TH x TOWER_TW), and the
# block count of its weight-gradient kernels (two waves' worth of 132 SMs):
# fixed, so the reduction order depends on the shape alone.
TILE_H, TILE_W = 8, 16
WGRAD_BLOCKS = 264
# The C entry points take element counts as int.
_MAX_ELEMENTS = 2**31 - 1
# Prologue and epilogue codes of csrc/tower.cu.
_PLAIN, _BN, _BN_RESIDUAL = 0, 1, 2
_FORWARD, _INPUT_GRAD = 0, 1

Params = Dict[str, Sequence[torch.Tensor]]


def _channels(p: int) -> Tuple[int, int]:
    return (IN_CHANNELS if p == 0 else CHANNELS), (1 if p == NUM_LAYERS - 1 else CHANNELS)


def tower_ref(x0: torch.Tensor, params: Params, run_stats: Tuple[torch.Tensor, torch.Tensor],
              train: bool, eps: float = 1e-5, buffers: bool = False):
    """Plain tower (F.conv2d per layer). Returns (y7, mu, var), and with
    buffers=True also the lists x_1..x_7 and y_0..y_7, each (B, H, W, C)."""
    cdtype = x0.dtype
    x = x0.permute(0, 3, 1, 2)
    xs, ys, mus, vars_ = [], [], [], []
    for p in range(NUM_LAYERS):
        d = DILATIONS[p]
        w = params["kernels"][p].to(cdtype).permute(3, 2, 0, 1)
        y = F.conv2d(x, w, padding=d, dilation=d) + params["biases"][p].to(cdtype).view(1, -1, 1, 1)
        ys.append(y)
        if p == NUM_LAYERS - 1:
            break
        yf = y.float()
        if train:
            mu = yf.mean(dim=(0, 2, 3))
            var = (yf * yf).mean(dim=(0, 2, 3)) - mu * mu
        else:
            mu, var = run_stats[0][p].float(), run_stats[1][p].float()
        mus.append(mu)
        vars_.append(var)
        yn = (yf - mu.view(1, -1, 1, 1)) * torch.rsqrt(var + eps).view(1, -1, 1, 1)
        yn = yn * params["gammas"][p].float().view(1, -1, 1, 1) + \
            params["betas"][p].float().view(1, -1, 1, 1)
        act = F.leaky_relu(yn, LEAKY_SLOPE).to(cdtype)
        x = act if p == 0 else x + act
        xs.append(x)
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    out = (nhwc(ys[-1]), torch.stack(mus), torch.stack(vars_))
    if buffers:
        return out + ([nhwc(t) for t in xs], [nhwc(t) for t in ys])
    return out


def _vec(t: torch.Tensor, name: str, n: int) -> torch.Tensor:
    t = t.float().contiguous()
    _build.require_cuda(t, name, shape=(n,))
    return t


def _bn_terms(mu, var, gamma, beta, eps):
    inv = torch.rsqrt(var + eps)
    nrm = gamma * inv
    return inv, nrm, beta - mu * nrm


def tile_count(b: int, h: int, w: int) -> int:
    """The TILE_H x TILE_W pixel tiles of a (b, h, w) activation: the rows of
    the conv kernels' per-tile channel sums."""
    return b * -(-h // TILE_H) * -(-w // TILE_W)


def _partials(rows: int, cols: int, device) -> torch.Tensor:
    """Scratch for per-block or per-tile partial sums, reduced by a later
    launch."""
    return torch.empty((rows, cols), dtype=torch.float32, device=device)


def transposed_taps(k: torch.Tensor) -> torch.Tensor:
    """The weights of a layer's input gradient: the HWIO kernel (3, 3, cin,
    cout) with its taps reversed and its channels swapped, (3, 3, cout,
    cin), so that the input gradient is the same dilated conv of gy."""
    return k.flip(0, 1).transpose(2, 3).contiguous()


def tower_forward_cuda(x0: torch.Tensor, kernels: List[torch.Tensor],
                       biases: List[torch.Tensor], gammas: torch.Tensor, betas: torch.Tensor,
                       run_stats: Tuple[torch.Tensor, torch.Tensor], train: bool,
                       eps: float = 1e-5):
    """The forward chain through csrc/tower.cu: one conv launch per layer,
    plus in train mode one statistics reduction per BatchNorm layer (15
    launches; 8 in eval mode). kernels are HWIO in x0's dtype. Returns (y7,
    mu, var, xs, ys): xs = x_1..x_7, ys = y_0..y_7 (the backward's
    buffers)."""
    _build.require_cuda(x0, "x0", tuple(_build.DTYPE_CODES))
    if x0.dim() != 4 or x0.shape[-1] != IN_CHANNELS:
        raise ValueError(f"x0 must be (B, H, W, {IN_CHANNELS}), got {tuple(x0.shape)}")
    b, h, w, _ = x0.shape
    if b * h * w * CHANNELS > _MAX_ELEMENTS:
        raise ValueError(f"x0 {tuple(x0.shape)}: a 32-channel activation of this size "
                         "overflows the kernels' 32-bit element counts")
    cdtype, dev = x0.dtype, x0.device
    dcode = _build.DTYPE_CODES[cdtype]
    count = b * h * w
    tiles = tile_count(b, h, w)
    partials = _partials(tiles, 2 * CHANNELS, dev)
    lib = _build.library()
    xs, ys, mus, vars_ = [], [], [], []
    nrm = shift = None
    with torch.cuda.device(dev):
        stream = _build.stream_of(x0)
        for p in range(NUM_LAYERS):
            cin, cout = _channels(p)
            k = kernels[p]
            _build.require_cuda(k, "kernel", (cdtype,), (3, 3, cin, cout))
            _build.require_aligned(k, "kernel")
            bias = _vec(biases[p], "bias", cout)
            y = torch.empty((b, h, w, cout), dtype=cdtype, device=dev)
            x = None if p == 0 else torch.empty((b, h, w, CHANNELS), dtype=cdtype, device=dev)
            stats = train and p < NUM_BN
            _build.check(lib.stereo_tower_conv(
                (x0 if p == 0 else ys[-1]).data_ptr(), xs[-1].data_ptr() if p >= 2 else None,
                None if p == 0 else nrm.data_ptr(), None if p == 0 else shift.data_ptr(),
                None if x is None else x.data_ptr(), k.data_ptr(), bias.data_ptr(),
                y.data_ptr(), partials.data_ptr() if stats else None, None, None, None, None,
                None, None, b, h, w, cin, cout, DILATIONS[p],
                _PLAIN if p == 0 else (_BN if p == 1 else _BN_RESIDUAL), _FORWARD,
                LEAKY_SLOPE, dcode, stream), "stereo_tower_conv")
            tower_forward_cuda.launches += 1
            ys.append(y)
            if x is not None:
                xs.append(x)
            if p == NUM_LAYERS - 1:
                break
            if stats:
                mu = torch.empty(CHANNELS, dtype=torch.float32, device=dev)
                var = torch.empty_like(mu)
                _build.check(lib.stereo_tower_stats(
                    partials.data_ptr(), tiles, count, mu.data_ptr(), var.data_ptr(), stream),
                    "stereo_tower_stats")
                tower_forward_cuda.launches += 1
            else:
                mu = _vec(run_stats[0][p], "running mean", CHANNELS)
                var = _vec(run_stats[1][p], "running var", CHANNELS)
            mus.append(mu)
            vars_.append(var)
            _, nrm, shift = _bn_terms(mu, var, _vec(gammas[p], "gamma", CHANNELS),
                                      _vec(betas[p], "beta", CHANNELS), eps)
            nrm, shift = nrm.contiguous(), shift.contiguous()
    return ys[-1], torch.stack(mus), torch.stack(vars_), xs, ys


tower_forward_cuda.launches = 0


def tower_backward_cuda(g_y7: torch.Tensor, x0: torch.Tensor, xs: List[torch.Tensor],
                        ys: List[torch.Tensor], kernels: List[torch.Tensor],
                        gammas: torch.Tensor, betas: torch.Tensor, mu: torch.Tensor,
                        var: torch.Tensor, eps: float = 1e-5):
    """The backward chain through csrc/tower.cu, train mode (batch
    statistics), layer 7 down to 0. Per layer: the BN backward to gy (layers
    0-6; layer 7's gy is g_y7), the weight and bias gradients (per-block
    rows), the input gradient (with per-tile S1/S2 sums for the layer below)
    and one launch that reduces all those rows: at most 4 launches a layer,
    31 a chain. Returns (dx0, dW list (in x0's dtype), db list, dgamma (7,
    32), dbeta (7, 32))."""
    b, h, w, _ = x0.shape
    cdtype, dev = x0.dtype, x0.device
    dcode = _build.DTYPE_CODES[cdtype]
    count = float(b * h * w)
    inv, nrm, shift = _bn_terms(mu.float(), var.float(), gammas.float(), betas.float(), eps)
    inv, nrm, shift = inv.contiguous(), nrm.contiguous(), shift.contiguous()
    mu = mu.float().contiguous()
    n_pix = b * h * w
    tiles = tile_count(b, h, w)
    wgrad_blocks = min(tiles, WGRAD_BLOCKS)
    s_partials = _partials(tiles, 2 * CHANNELS, dev)
    for name, ts in (("x0", [x0]), ("xs", xs), ("ys", ys), ("kernels", kernels)):
        for t in ts:
            _build.require_aligned(t, name)
    lib = _build.library()
    dws, dbs = [None] * NUM_LAYERS, [None] * NUM_LAYERS
    dgammas, dbetas = [None] * NUM_BN, [None] * NUM_BN
    gx_next = g_y7.to(cdtype).contiguous()
    _build.require_cuda(gx_next, "g_y7", shape=(b, h, w, 1))
    s1 = s2 = None
    with torch.cuda.device(dev):
        stream = _build.stream_of(x0)
        for p in range(NUM_LAYERS - 1, -1, -1):
            cin, cout = _channels(p)
            d = DILATIONS[p]
            x_p = x0 if p == 0 else xs[p - 1]
            if p < NUM_LAYERS - 1:
                m1, m2 = (s1 / count).contiguous(), (s2 / count).contiguous()
                dgammas[p], dbetas[p] = s2, s1
                gy = torch.empty((b, h, w, cout), dtype=cdtype, device=dev)
                vecs = (mu[p], inv[p], nrm[p], shift[p], m1, m2)
                _build.check(lib.stereo_tower_grad_y(
                    gx_next.data_ptr(), ys[p].data_ptr(), *(v.data_ptr() for v in vecs),
                    gy.data_ptr(), n_pix * cout, cout, LEAKY_SLOPE, dcode, stream),
                    "stereo_tower_grad_y")
                tower_backward_cuda.launches += 1
            else:
                gy = gx_next  # the tower's output gradient, rounded to the compute dtype

            entries = 9 * cin * cout
            w_partials = _partials(wgrad_blocks, entries + cout, dev)
            _build.check(lib.stereo_tower_wgrad(
                x_p.data_ptr(), gy.data_ptr(), w_partials.data_ptr(), wgrad_blocks, b, h, w,
                cin, cout, d, dcode, stream), "stereo_tower_wgrad")
            tower_backward_cuda.launches += 1

            gx = torch.empty((b, h, w, cin), dtype=cdtype, device=dev)
            below = p >= 1
            q = p - 1
            _build.check(lib.stereo_tower_conv(
                gy.data_ptr(), None, None, None, None, transposed_taps(kernels[p]).data_ptr(),
                None, gx.data_ptr(), s_partials.data_ptr() if below else None,
                gx_next.data_ptr() if 1 <= p <= NUM_LAYERS - 2 else None,
                ys[q].data_ptr() if below else None,
                *((mu[q].data_ptr(), inv[q].data_ptr(), nrm[q].data_ptr(), shift[q].data_ptr())
                  if below else (None,) * 4),
                b, h, w, cout, cin, d, _PLAIN, _INPUT_GRAD, LEAKY_SLOPE, dcode, stream),
                "stereo_tower_conv")
            tower_backward_cuda.launches += 1

            w_sums = torch.empty(entries + cout, dtype=torch.float32, device=dev)
            s_sums = torch.empty(2 * CHANNELS, dtype=torch.float32, device=dev) if below else None
            _build.check(lib.stereo_tower_sums(
                w_partials.data_ptr(), wgrad_blocks, entries + cout, w_sums.data_ptr(),
                s_partials.data_ptr() if below else None, tiles if below else 0,
                2 * CHANNELS if below else 0, s_sums.data_ptr() if below else None, stream),
                "stereo_tower_sums")
            tower_backward_cuda.launches += 1
            dws[p] = w_sums[:entries].view(3, 3, cin, cout).to(cdtype)
            dbs[p] = w_sums[entries:]
            if below:
                s1, s2 = s_sums[:CHANNELS], s_sums[CHANNELS:]
            gx_next = gx
    return gx_next, dws, dbs, torch.stack(dgammas), torch.stack(dbetas)


tower_backward_cuda.launches = 0


class _Tower(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, rmean, rvar, train, eps, gammas, betas, *wb):
        kernels, biases = list(wb[:NUM_LAYERS]), list(wb[NUM_LAYERS:])
        y7, mu, var, xs, ys = tower_forward_cuda(x0, kernels, biases, gammas, betas,
                                                 (rmean, rvar), train, eps)
        ctx.train, ctx.eps = train, eps
        ctx.save_for_backward(x0, gammas, betas, mu, var, *kernels, *xs, *ys)
        ctx.mark_non_differentiable(mu, var)
        return y7, mu, var

    @staticmethod
    def backward(ctx, g_y7, _g_mu, _g_var):
        if not ctx.train:
            raise NotImplementedError("the tower's backward needs train=True")
        x0, gammas, betas, mu, var, *rest = ctx.saved_tensors
        kernels = rest[:NUM_LAYERS]
        xs = rest[NUM_LAYERS:NUM_LAYERS + NUM_BN]
        ys = rest[NUM_LAYERS + NUM_BN:]
        dx0, dws, dbs, dgamma, dbeta = tower_backward_cuda(
            g_y7, x0, list(xs), list(ys), list(kernels), gammas, betas, mu, var, ctx.eps)
        return (dx0, None, None, None, None, dgamma, dbeta, *dws, *dbs)


def tower_cuda(x0: torch.Tensor, params: Params, run_stats: Tuple[torch.Tensor, torch.Tensor],
               train: bool, eps: float = 1e-5):
    """The tower through csrc/tower.cu, differentiable in x0 and params
    (train mode). CPU tensors take tower_ref."""
    if x0.device.type == "cpu":
        return tower_ref(x0, params, run_stats, train, eps)
    kernels = [k.to(x0.dtype).contiguous() for k in params["kernels"]]
    return _Tower.apply(x0.contiguous(), run_stats[0], run_stats[1], train, eps,
                        params["gammas"], params["betas"], *kernels, *params["biases"])
