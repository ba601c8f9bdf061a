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
(torch.where), so the host runs ahead of the card. The forward and losses
(make_forward_losses), the FCS EMA, the clip and the masked Adam are the
pieces engine/steps.py and engine/state.py share with the classic engine.

The JAX engine flattens parameters and optimizer state into single vectors
to cut TPU dispatch cost; the port keeps per-parameter tensors and updates
them in place (the model's parameters and BatchNorm buffers are the
state's). The Adam math and its skip semantics are the JAX engine's: torch
parity bias correction, eps outside the square root, and a skipped step
leaves the count, the moments and the parameters unchanged; the BatchNorm
running statistics update on every adapt step, skipped or not.

Options of the JAX engine, all ported: images_uint8 (uint8 frames,
dequantized on the device as f32 / 255, dequantize_u8), use_leftright with
consistency_weight (the flipped-batch left-right consistency loss),
loss_dtype (the single-sided loss in a reduced dtype, cast back to f32),
warp_precision and make_done_step_batched (N done steps in one eval
forward).

The JAX package's structured engine (engine/stream_adapt.py, `adapt
--engine pytree`) computes this engine's step with fused_er_forward=False
(the replay frame as a second, sequential train-mode forward), float32
frames and one done frame per forward; its only extra state, train.step,
counts frames as log_pos does and no output reads it. The JAX split exists
for XLA's dispatch cost; here both are the same tensors, so the driver
runs engine="pytree" as this engine with those settings.

Deviations from the JAX engine, both named in make_flat_streaming_steps:
- warp_precision: the port's warp is exact (F.grid_sample), which is the
  JAX engine's "highest". "high" and "default" are precisions of the TPU
  matrix unit that the JAX warp's banded one-hot matmul runs on; the port
  has no such matmul and raises ValueError for them.
- loss_dtype="float32" together with use_leftright is accepted and equals
  loss_dtype=None (JAX rejects any explicit loss_dtype there,
  flat_stream.py:164-170); a reduced dtype with use_leftright raises, as
  in JAX, because the left-right loss has no reduced-dtype form.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import torch

from ..device import DeviceLike, resolve_device
from .device_reservoir import (DeviceReservoir, init_device_reservoir,
                               reservoir_average_value, reservoir_maybe_add,
                               reservoir_set_values)
from .state import adam_masked, live_buffers, live_parameters
from .steps import (check_warp_precision, clip_stereo_net_grads, epe, make_forward_losses,
                    mean_fcs_from_outputs, smoothed_fcs)

# Ring-log column layout (adaptive_stereo_tpu/engine/stream_adapt.py:LOG_COLS).
LOG_COLS = (
    "fcs_raw", "fcs_smoothed", "mono_loss", "replay_loss", "epe",
    "novel", "did_add", "do_update",
)


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
    # The model's live BatchNorm running statistics (live_buffers), which
    # the train-mode forward updates in place: the JAX state's `bn`.
    buffers: List[torch.Tensor] = field(default_factory=list)


def dequantize_u8(img: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> float32 / 255, correctly rounded as the dataset's
    host-side float32 division is, so uint8 frames give the float32 path's
    bits. The divisor is a tensor on the frame's device: PyTorch's CUDA
    division by a Python scalar multiplies by its rounded reciprocal, which
    moves 126 of the 256 levels by an ulp on an H100."""
    return img.to(torch.float32) / torch.full((), 255.0, device=img.device)


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
        buffers=live_buffers(model),
    )


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
    images_uint8: bool = False,
    fused_er_forward: bool = False,
    use_leftright: bool = False,
    consistency_weight: float = 1e-3,
    warp_precision: str = "highest",
    loss_dtype=None,
):
    """Returns (adapt_step, done_step, validate_step, make_done_step_batched)
    over FlatStreamState.

    adapt_step(ss, left, right, gt, er_left, er_right, er_gt, frame_idx)
      images (1, H, W, 3), float32 in [0, 1] (uint8 with images_uint8),
      ground truths (1, H, W, 1) float32; returns ss, updated in place.
    done_step(ss, left, right, gt, frame_idx): the eval-mode forward, the
      gate and the reservoir, no update; returns ss.
    validate_step(ss): eval-mode loss of every reservoir item; returns
      (ss, mean value over the filled slots, fill, mean |disparity| over
      the filled slots).
    make_done_step_batched(n) -> done_step_batched(ss, lefts, rights, gts,
      frame_idxs): N frames (N, H, W, 3) in one eval forward, then the EMA,
      the reservoir adds and the log rows in frame order, as N done_step
      calls; frame_idxs is an (N,) int32 tensor. Reads nothing back.

    fused_er_forward: the stream frame and the replay frame run as one
    batch-2 forward (BatchNorm statistics over both; documented deviation of
    the JAX engine from the reference's two sequential forwards).
    use_leftright: the left-right consistency loss by the flipped-batch
    trick: rows [left, flip(right)] / [right, flip(left)] in one forward
    predict the left view and the mirrored right view; with use_er and
    fused_er_forward the replay frame is a third row, else it runs as a
    second train-mode forward. FCS and the reservoir use row 0.
    loss_dtype: None, "" or "float32" (the same), or "bfloat16": the
    single-sided loss computed in that dtype and cast back to float32.
    warp_precision: "highest" only (see the module docstring).
    """
    check_warp_precision(warp_precision)
    coarse = input_scale + k
    pred_key = f"pred_disp_l/{input_scale}"
    forward_losses, mono_loss = make_forward_losses(
        model, input_scale, smoothness_weight, er_loss_weight, use_er=use_er,
        fused_er_forward=fused_er_forward, use_leftright=use_leftright,
        consistency_weight=consistency_weight, loss_dtype=loss_dtype)

    def dec(img):
        return dequantize_u8(img) if images_uint8 else img

    def gate(ss, fcs_raw, left, right, mono, frame_idx):
        smoothed = smoothed_fcs(ss.ema_value, ss.ema_init, fcs_raw, fcs_ema_weight)
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
        left, right, er_left, er_right = dec(left), dec(right), dec(er_left), dec(er_right)
        total, mono, replay, pred, fcs_outputs = forward_losses(left, right, er_left,
                                                                er_right, er_gt)
        fcs_raw = mean_fcs_from_outputs(fcs_outputs, "l", coarse).detach()
        grads = torch.autograd.grad(total, ss.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, ss.params)]
        error = epe(pred.detach(), gt)
        mono, replay = mono.detach(), replay.detach()

        smoothed, novel, did_add = gate(ss, fcs_raw, left, right, mono, frame_idx)
        do_update = ~did_add
        if clip_grad_norm:
            clip_stereo_net_grads(grads, ss.n_feature)
        adam_masked(ss, grads, do_update)
        write_log(ss, (fcs_raw, smoothed, mono, replay, error, novel, did_add, do_update))
        return ss

    def observe(ss, fcs_raw, left, right, mono, error, frame_idx):
        """The done step's gate, reservoir add and log row for one frame."""
        smoothed, novel, did_add = gate(ss, fcs_raw, left, right, mono, frame_idx)
        zero = torch.zeros_like(mono)
        write_log(ss, (fcs_raw, smoothed, mono, zero, error, novel, did_add, zero))

    @torch.no_grad()
    def done_step(ss: FlatStreamState, left, right, gt, frame_idx):
        model.eval()
        left, right = dec(left), dec(right)
        outputs = model(left, right, side="l", output_cost_volume=True)
        pred = outputs[pred_key]
        observe(ss, mean_fcs_from_outputs(outputs, "l", coarse), left, right,
                mono_loss(left, right, pred), epe(pred, gt), frame_idx)
        return ss

    def make_done_step_batched(n: int):
        """N done steps in one eval forward of batch N (eval mode: every
        sample independent); the per-frame FCS, losses and EPE, then the
        EMA, the reservoir adds and the log rows in frame order, as N
        done_step calls (JAX flat_stream.py:372-433)."""

        @torch.no_grad()
        def done_step_batched(ss: FlatStreamState, lefts, rights, gts, frame_idxs):
            if lefts.shape[0] != n:
                raise ValueError(f"done_step_batched({n}) got {lefts.shape[0]} frames")
            model.eval()
            lefts, rights = dec(lefts), dec(rights)
            outputs = model(lefts, rights, side="l", output_cost_volume=True)
            preds = outputs[pred_key]
            rows = []
            for i in range(n):
                one = {key: v[i:i + 1] for key, v in outputs.items()}
                l, r, p = lefts[i:i + 1], rights[i:i + 1], preds[i:i + 1]
                rows.append((mean_fcs_from_outputs(one, "l", coarse), l, r,
                             mono_loss(l, r, p), epe(p, gts[i:i + 1])))
            for i, (fcs_raw, l, r, mono, error) in enumerate(rows):
                observe(ss, fcs_raw, l, r, mono, error, frame_idxs[i])
            return ss

        return done_step_batched

    @torch.no_grad()
    def validate_step(ss: FlatStreamState):
        model.eval()
        res = ss.reservoir
        pred = model(res.left, res.right, side="l", output_cost_volume=False)[pred_key]
        cap = pred.shape[0]
        losses = torch.stack([mono_loss(res.left[i:i + 1], res.right[i:i + 1], pred[i:i + 1])
                              for i in range(cap)])
        mask = torch.arange(cap, device=pred.device) < res.size
        reservoir_set_values(res, torch.where(mask, losses, res.values))
        # Mean |disparity| over the filled entries (the guard's second channel).
        mean_disp = (torch.where(mask[:, None, None, None], pred.abs(), 0.0).sum()
                     / torch.clamp(mask.float().sum() * pred[0].numel(), min=1.0))
        return ss, reservoir_average_value(res), res.size, mean_disp

    return adapt_step, done_step, validate_step, make_done_step_batched
