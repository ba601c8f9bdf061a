"""Streaming online adaptation: the adapt, done and validate steps.

Counterpart of adaptive_stereo_tpu/engine/flat_stream.py
(init_flat_stream_state, make_flat_streaming_steps), the engine that
bench.py times. One adapt_step is:
  - the train-mode StereoModel forward (the stream frame, and with
    use_er + fused_er_forward the replay frame as a second batch row);
  - the Monodepth single-sided loss of the stream frame, plus 0.05 x the
    Khamis loss of the replay frame against its ground truth;
  - the gradients; FCS -> EMA -> novelty gate -> reservoir add;
    do_update = not did_add;
  - the stereo-net-only gradient clip and the masked Adam update;
  - one row of the ring log, in LOG_COLS order.
Nothing in a step reads the device back: every decision is a tensor
(torch.where), so the host runs ahead of the card.

The JAX engine flattens parameters and optimizer state into single vectors
to cut TPU dispatch cost; the port keeps per-parameter tensors and updates
them in place (the model's parameters and BatchNorm buffers are the
state's). The Adam math and its skip semantics are the JAX engine's: torch
parity bias correction, eps outside the square root, and a skipped step
leaves the count, the moments and the parameters unchanged; the BatchNorm
running statistics update on every adapt step, skipped or not.

Deviation: the warp is exact (F.grid_sample), JAX's warp_precision
"highest"; bench.py's "default" is a TPU matrix-unit precision setting.
Not ported yet: use_leftright (the left-right consistency loss), uint8
frames (images_uint8), loss_dtype and make_done_step_batched.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from ..device import DeviceLike, resolve_device
from ..ops.losses import khamis_robust_loss, monodepth_single_loss
from .device_reservoir import (DeviceReservoir, init_device_reservoir,
                               reservoir_average_value, reservoir_maybe_add,
                               reservoir_set_values)
from .steps import epe, mean_fcs_from_outputs

# Ring-log column layout (adaptive_stereo_tpu/engine/stream_adapt.py:LOG_COLS).
LOG_COLS = (
    "fcs_raw", "fcs_smoothed", "mono_loss", "replay_loss", "epe",
    "novel", "did_add", "do_update",
)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def live_parameters(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The parameters the forward uses, feature net first: every parameter
    but the BasicBlocks' dead conv2 (which the JAX model does not have)."""
    return [p for name, p in model.named_parameters() if ".conv2." not in name]


@dataclass
class FlatStreamState:
    params: List[torch.nn.Parameter]  # live parameters, [feature_net | stereo_net]
    n_feature: int                    # params[:n_feature] belong to the feature net
    m: List[torch.Tensor]             # Adam first moments
    v: List[torch.Tensor]             # Adam second moments
    count: torch.Tensor               # () int32 applied updates
    lr: torch.Tensor                  # () float32 learning rate
    ema_value: torch.Tensor           # () float32 FCS EMA
    ema_init: torch.Tensor            # () bool
    reservoir: DeviceReservoir
    log: torch.Tensor                 # (chunk, len(LOG_COLS)) float32
    log_pos: torch.Tensor             # () int32


def init_flat_stream_state(model: torch.nn.Module, learning_rate: float, capacity: int,
                           h: int, w: int, log_chunk: int, seed: int = 123,
                           device: DeviceLike = None) -> FlatStreamState:
    """The engine state for model (a StereoModel on `device`, "cuda" unless
    the caller passes "cpu"): zero Adam moments, an empty reservoir of
    `capacity` (h, w) frame pairs and a ring log of `log_chunk` rows."""
    dev = resolve_device(device)
    params = live_parameters(model)
    if any(p.device.type != dev.type or dev.index not in (None, p.device.index)
           for p in params):
        raise ValueError(f"the model's parameters are not on {dev}")
    n_feature = len(live_parameters(model.feature_net))
    scalar = lambda value, dtype: torch.tensor(value, dtype=dtype, device=dev)
    return FlatStreamState(
        params=params,
        n_feature=n_feature,
        m=[torch.zeros_like(p) for p in params],
        v=[torch.zeros_like(p) for p in params],
        count=scalar(0, torch.int32),
        lr=scalar(learning_rate, torch.float32),
        ema_value=scalar(0.0, torch.float32),
        ema_init=scalar(False, torch.bool),
        reservoir=init_device_reservoir(capacity, h, w, 3, seed, dev),
        log=torch.zeros((log_chunk, len(LOG_COLS)), dtype=torch.float32, device=dev),
        log_pos=scalar(0, torch.int32),
    )


def _masked_assign(dst: List[torch.Tensor], new: List[torch.Tensor], keep: torch.Tensor) -> None:
    """dst <- dst where keep else new, for every tensor, in a few launches."""
    sizes = [t.numel() for t in dst]
    old = torch.cat([t.reshape(-1) for t in dst])
    sel = torch.where(keep, old, torch.cat([t.reshape(-1) for t in new]))
    torch._foreach_copy_(dst, [s.view_as(d) for s, d in zip(sel.split(sizes), dst)])


def make_flat_streaming_steps(
    model: torch.nn.Module,
    input_scale: int,
    k: int,
    smoothness_weight: float = 1e-3,
    er_loss_weight: float = 0.05,
    use_er: bool = False,
    use_vs: bool = False,
    ood_threshold: float = 15.0,
    fcs_ema_weight: float = 0.999,
    clip_grad_norm: bool = False,
    fused_er_forward: bool = False,
):
    """Returns (adapt_step, done_step, validate_step) over FlatStreamState.

    adapt_step(ss, left, right, gt, er_left, er_right, er_gt, frame_idx)
      float32 images (1, H, W, 3) in [0, 1], ground truths
      (1, H, W, 1); returns ss, updated in place.
    done_step(ss, left, right, gt, frame_idx): the eval-mode forward, the
      gate and the reservoir, no update; returns ss.
    validate_step(ss): eval-mode loss of every reservoir item; returns
      (ss, mean value over the filled slots, fill, mean |disparity| over
      the filled slots).

    fused_er_forward: the stream frame and the replay frame run as one
    batch-2 forward (BatchNorm statistics over both; documented deviation of
    the JAX engine from the reference's two sequential forwards).
    """
    coarse = input_scale + k
    s = input_scale
    warp_max_disp = -(-model.stereo_net.maxdisp // 2 ** input_scale)

    def mono_loss(left, right, pred):
        return monodepth_single_loss(left, right, pred, smoothness_weight,
                                     max_disp=warp_max_disp)[0].float()

    def clip(ss, grads):
        if not clip_grad_norm:
            return
        stereo = grads[ss.n_feature:]
        norm = torch.stack(torch._foreach_norm(stereo)).square().sum().sqrt()
        scale = torch.clamp(1.0 / (norm + 1e-6), max=1.0)
        torch._foreach_mul_(stereo, scale)

    def adam_masked(ss, grads, do_update):
        new_count = ss.count + 1
        c = new_count.float()
        m = torch._foreach_add(torch._foreach_mul(ss.m, ADAM_B1),
                               torch._foreach_mul(grads, 1 - ADAM_B1))
        gg = torch._foreach_mul(grads, 1 - ADAM_B2)
        torch._foreach_mul_(gg, grads)
        v = torch._foreach_add(torch._foreach_mul(ss.v, ADAM_B2), gg)
        mhat = torch._foreach_div(m, 1 - torch.pow(ADAM_B1, c))
        vhat = torch._foreach_div(v, 1 - torch.pow(ADAM_B2, c))
        step = torch._foreach_mul(mhat, ss.lr)
        denom = torch._foreach_add(torch._foreach_sqrt(vhat), ADAM_EPS)
        theta = torch._foreach_sub([p.detach() for p in ss.params],
                                   torch._foreach_div(step, denom))
        keep = ~do_update
        with torch.no_grad():
            _masked_assign(ss.params, theta, keep)
        _masked_assign(ss.m, m, keep)
        _masked_assign(ss.v, v, keep)
        ss.count.copy_(torch.where(keep, ss.count, new_count))

    def gate(ss, fcs_raw, left, right, mono, frame_idx):
        smoothed = torch.where(
            ss.ema_init, ss.ema_value * fcs_ema_weight + (1 - fcs_ema_weight) * fcs_raw,
            fcs_raw)
        novel = (smoothed < ood_threshold) if use_vs else torch.zeros_like(ss.ema_init)
        _, did_add = reservoir_maybe_add(ss.reservoir, left, right, mono, frame_idx, novel)
        ss.ema_value.copy_(smoothed)
        ss.ema_init.fill_(True)
        return smoothed, novel, did_add

    def write_log(ss, values):
        row = torch.stack([v.float().reshape(()) for v in values])
        pos = (ss.log_pos % ss.log.shape[0]).long().view(1)
        ss.log.index_copy_(0, pos, row[None])
        ss.log_pos.add_(1)

    def adapt_step(ss: FlatStreamState, left, right, gt, er_left, er_right, er_gt, frame_idx):
        model.train()
        zero = torch.zeros((), dtype=torch.float32, device=left.device)
        if use_er and fused_er_forward:
            outputs = model(torch.cat([left, er_left]), torch.cat([right, er_right]),
                            side="l", output_cost_volume=True)
            pred_b = outputs[f"pred_disp_l/{s}"]
            pred = pred_b[0:1]
            mono = mono_loss(left, right, pred)
            replay = khamis_robust_loss(pred_b[1:2], er_gt)
            total = mono + er_loss_weight * replay
            fcs_outputs = {key: v[0:1] for key, v in outputs.items()}
        else:
            outputs = model(left, right, side="l", output_cost_volume=True)
            pred = outputs[f"pred_disp_l/{s}"]
            mono = mono_loss(left, right, pred)
            total, replay = mono, zero
            if use_er:
                er_out = model(er_left, er_right, side="l", output_cost_volume=False)
                replay = khamis_robust_loss(er_out[f"pred_disp_l/{s}"], er_gt)
                total = total + er_loss_weight * replay
            fcs_outputs = outputs
        fcs_raw = mean_fcs_from_outputs(fcs_outputs, "l", coarse).detach()
        grads = torch.autograd.grad(total, ss.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, ss.params)]
        error = epe(pred.detach(), gt)
        mono, replay = mono.detach(), replay.detach()

        smoothed, novel, did_add = gate(ss, fcs_raw, left, right, mono, frame_idx)
        do_update = ~did_add
        clip(ss, grads)
        adam_masked(ss, grads, do_update)
        write_log(ss, (fcs_raw, smoothed, mono, replay, error, novel, did_add, do_update))
        return ss

    @torch.no_grad()
    def done_step(ss: FlatStreamState, left, right, gt, frame_idx):
        model.eval()
        outputs = model(left, right, side="l", output_cost_volume=True)
        pred = outputs[f"pred_disp_l/{s}"]
        mono = mono_loss(left, right, pred)
        fcs_raw = mean_fcs_from_outputs(outputs, "l", coarse)
        error = epe(pred, gt)
        smoothed, novel, did_add = gate(ss, fcs_raw, left, right, mono, frame_idx)
        zero = torch.zeros_like(mono)
        write_log(ss, (fcs_raw, smoothed, mono, zero, error, novel, did_add, zero))
        return ss

    @torch.no_grad()
    def validate_step(ss: FlatStreamState):
        model.eval()
        res = ss.reservoir
        pred = model(res.left, res.right, side="l", output_cost_volume=False)[
            f"pred_disp_l/{s}"]
        cap = pred.shape[0]
        losses = torch.stack([mono_loss(res.left[i:i + 1], res.right[i:i + 1], pred[i:i + 1])
                              for i in range(cap)])
        mask = torch.arange(cap, device=pred.device) < res.size
        reservoir_set_values(res, torch.where(mask, losses, res.values))
        # Mean |disparity| over the filled entries (the guard's second channel).
        mean_disp = (torch.where(mask[:, None, None, None], pred.abs(), 0.0).sum()
                     / torch.clamp(mask.float().sum() * pred[0].numel(), min=1.0))
        return ss, reservoir_average_value(res), res.size, mean_disp

    return adapt_step, done_step, validate_step
