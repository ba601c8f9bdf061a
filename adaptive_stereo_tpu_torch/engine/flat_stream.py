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

Options of the JAX engine, all ported: images_uint8 (uint8 frames,
dequantized on the device as f32 / 255), use_leftright with
consistency_weight (the flipped-batch left-right consistency loss),
loss_dtype (the single-sided loss in a reduced dtype, cast back to f32),
warp_precision and make_done_step_batched (N done steps in one eval
forward).

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
from ..ops.losses import (khamis_robust_loss, monodepth_leftright_loss,
                          monodepth_single_loss)
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


def live_buffers(model: torch.nn.Module) -> List[torch.Tensor]:
    """The BatchNorm running statistics the forward uses and train mode
    updates (every running_mean and running_var but the dead conv2's)."""
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var")) and ".conv2." not in name]


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


def _masked_assign(dst: List[torch.Tensor], new: List[torch.Tensor], keep: torch.Tensor) -> None:
    """dst <- dst where keep else new, for every tensor, in a few launches."""
    sizes = [t.numel() for t in dst]
    old = torch.cat([t.reshape(-1) for t in dst])
    sel = torch.where(keep, old, torch.cat([t.reshape(-1) for t in new]))
    torch._foreach_copy_(dst, [s.view_as(d) for s, d in zip(sel.split(sizes), dst)])


def _loss_dtype(loss_dtype, use_leftright: bool):
    """The reduced dtype of the single-sided loss, or None for float32."""
    if loss_dtype in (None, "", "float32"):
        return None
    if loss_dtype == "bfloat16":
        if use_leftright:
            raise ValueError("loss_dtype is only implemented for the single-sided Monodepth "
                             "path; it cannot be combined with use_leftright")
        return torch.bfloat16
    raise ValueError(f"unsupported loss_dtype {loss_dtype!r}")


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
    if warp_precision != "highest":
        raise ValueError(f"warp_precision {warp_precision!r} is a TPU matrix-unit precision "
                         "of the JAX warp; the port's warp (F.grid_sample) is exact, which "
                         "is 'highest'")
    loss_dt = _loss_dtype(loss_dtype, use_leftright)
    coarse = input_scale + k
    s = input_scale
    pred_key = f"pred_disp_l/{s}"
    warp_max_disp = -(-model.stereo_net.maxdisp // 2 ** input_scale)

    def dec(img):
        return img.to(torch.float32) / 255.0 if images_uint8 else img

    def flip(x):
        return torch.flip(x, dims=(2,))

    def mono_loss(left, right, pred):
        if loss_dt is not None:
            left, right, pred = left.to(loss_dt), right.to(loss_dt), pred.to(loss_dt)
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

    def replay_forward(er_left, er_right, er_gt):
        er_out = model(er_left, er_right, side="l", output_cost_volume=False)
        return khamis_robust_loss(er_out[pred_key], er_gt)

    def forward_losses(left, right, er_left, er_right, er_gt):
        """Train-mode forward(s) and losses: (total, mono, replay, pred of the
        stream frame, outputs of the stream frame for FCS)."""
        zero = torch.zeros((), dtype=torch.float32, device=left.device)
        fused = use_er and fused_er_forward
        if use_leftright:
            rows_l, rows_r = [left, flip(right)], [right, flip(left)]
            if fused:
                rows_l.append(er_left)
                rows_r.append(er_right)
            outputs = model(torch.cat(rows_l), torch.cat(rows_r), side="l",
                            output_cost_volume=True)
            preds = outputs[pred_key]
            pred = preds[0:1]
            mono = monodepth_leftright_loss(left, right, pred, flip(preds[1:2]),
                                            smoothness_weight, consistency_weight,
                                            max_disp=warp_max_disp)[0]
            replay = khamis_robust_loss(preds[2:3], er_gt) if fused else zero
        elif fused:
            outputs = model(torch.cat([left, er_left]), torch.cat([right, er_right]),
                            side="l", output_cost_volume=True)
            preds = outputs[pred_key]
            pred = preds[0:1]
            mono = mono_loss(left, right, pred)
            replay = khamis_robust_loss(preds[1:2], er_gt)
        else:
            outputs = model(left, right, side="l", output_cost_volume=True)
            pred = outputs[pred_key]
            mono = mono_loss(left, right, pred)
            replay = zero
        if use_er and not fused:
            replay = replay_forward(er_left, er_right, er_gt)
        total = mono + er_loss_weight * replay if use_er else mono
        fcs_outputs = {key: v[0:1] for key, v in outputs.items()}
        return total, mono, replay, pred, fcs_outputs

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
        clip(ss, grads)
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
