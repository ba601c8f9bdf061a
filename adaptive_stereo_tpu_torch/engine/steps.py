"""Step functions of the training and adaptation engines (counterpart of
adaptive_stereo_tpu/engine/steps.py).

The JAX module jits each loop body into one XLA program over an immutable
state. Here a step runs eagerly on the model's own tensors and updates
them in place (engine/state.py TrainState): BatchNorm running statistics
update on every train-mode forward (the main forward, then the replay
forward, as the reference's sequential torch forwards do, adapt.py:309-314),
eval-mode forwards use them and change nothing. Decisions stay tensors
(torch.where), so a step reads nothing back to the host; the engines read
the scalars they need.

The adaptation losses are the flat engine's pieces (make_forward_losses,
the gate arithmetic smoothed_fcs, clip_stereo_net_grads and the masked Adam
of engine/state.py), so the two engines compute one step the same way.

warp_precision other than "highest" raises ValueError (the port's warp is
exact; see engine/flat_stream.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..ops.fcs import feature_contrast_mean
from ..ops.losses import (khamis_robust_loss, khamis_robust_loss_multiscale,
                          monodepth_leftright_loss, monodepth_single_loss)
from .state import TrainState, adam_masked

Batch = Dict[str, torch.Tensor]


def mean_fcs_from_outputs(outputs: Dict[str, torch.Tensor], side: str,
                          coarse: int) -> torch.Tensor:
    """Mean image FCS: the fused epilogue's per-pixel map
    (outputs['fcs_<side>/<coarse>']) if present, else derived from the cost
    volume (JAX steps.py:36-43)."""
    key = f"fcs_{side}/{coarse}"
    if key in outputs:
        return outputs[key].mean()
    return feature_contrast_mean(outputs[f"cost_volume_{side}/{coarse}"]).mean()


def epe(pred_disp: torch.Tensor, gt_disp: torch.Tensor) -> torch.Tensor:
    """Mean absolute disparity error over gt > 0 (reference train.py:103;
    JAX steps.py:61-65)."""
    mask = (gt_disp > 0).float()
    err = torch.abs(pred_disp - gt_disp) * mask
    return err.sum() / torch.clamp(mask.sum(), min=1.0)


def clip_stereo_net_grads(grads: List[torch.Tensor], n_feature: int,
                          max_norm: float = 1.0) -> List[torch.Tensor]:
    """Clip ONLY the stereo-net gradients, grads[n_feature:], to a global
    norm, in place (JAX steps.py:46-58). Reference quirk kept: both engines
    clip stereo_net.parameters() and never feature_net's
    (train.py:220-222, adapt.py:391-392). torch semantics: scale by
    max_norm / (total_norm + 1e-6) when that is < 1."""
    stereo = grads[n_feature:]
    norm = torch.stack(torch._foreach_norm(stereo)).square().sum().sqrt()
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(stereo, scale)
    return grads


def check_warp_precision(warp_precision: str) -> None:
    if warp_precision != "highest":
        raise ValueError(f"warp_precision {warp_precision!r} is a TPU matrix-unit precision "
                         "of the JAX warp; the port's warp (F.grid_sample) is exact, which "
                         "is 'highest'")


def loss_compute_dtype(loss_dtype, use_leftright: bool) -> Optional[torch.dtype]:
    """The reduced dtype of the single-sided loss, or None for float32."""
    if loss_dtype in (None, "", "float32"):
        return None
    if loss_dtype == "bfloat16":
        if use_leftright:
            raise ValueError("loss_dtype is only implemented for the single-sided Monodepth "
                             "path; it cannot be combined with use_leftright")
        return torch.bfloat16
    raise ValueError(f"unsupported loss_dtype {loss_dtype!r}")


def check_gate(gate: str) -> None:
    """The novelty gates: 'fcs' and 'reconstruction'."""
    if gate not in ("fcs", "reconstruction"):
        raise ValueError(f"unknown gate {gate!r}")


def _warp_max_disp(model: torch.nn.Module, input_scale: int) -> int:
    """The model's maxdisp at the loss scale, the warp's disparity bound."""
    return -(-model.stereo_net.maxdisp // 2 ** input_scale)


def _flip(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(2,))


def make_forward_losses(model: torch.nn.Module, input_scale: int,
                        smoothness_weight: float = 1e-3, er_loss_weight: float = 0.05,
                        use_er: bool = False, fused_er_forward: bool = False,
                        use_leftright: bool = False, consistency_weight: float = 1e-3,
                        loss_dtype=None):
    """The adaptation step's train-mode forward(s) and losses, shared by the
    flat engine (engine/flat_stream.py) and the classic steps below.
    Returns (forward_losses, mono_loss):

    forward_losses(left, right, er_left, er_right, er_gt) -> (total, mono,
      replay, pred of the stream frame, outputs of the stream frame for
      FCS). The stream frame's Monodepth loss (single-sided, or with
      use_leftright the flipped-batch left-right loss: rows [left,
      flip(right)] / [right, flip(left)] in one forward), plus
      er_loss_weight x the Khamis loss of the replay frame with use_er. The
      replay frame runs as a second train-mode forward after the stream's
      (BatchNorm statistics chained), or with fused_er_forward as one more
      batch row (statistics over both; the JAX flat engine's documented
      deviation).
    mono_loss(left, right, pred): the single-sided loss, in loss_dtype
      (see loss_compute_dtype) and cast back to float32.
    """
    loss_dt = loss_compute_dtype(loss_dtype, use_leftright)
    pred_key = f"pred_disp_l/{input_scale}"
    warp_max_disp = _warp_max_disp(model, input_scale)

    def mono_loss(left, right, pred):
        if loss_dt is not None:
            left, right, pred = left.to(loss_dt), right.to(loss_dt), pred.to(loss_dt)
        return monodepth_single_loss(left, right, pred, smoothness_weight,
                                     max_disp=warp_max_disp)[0].float()

    def replay_forward(er_left, er_right, er_gt):
        er_out = model(er_left, er_right, side="l", output_cost_volume=False)
        return khamis_robust_loss(er_out[pred_key], er_gt)

    def forward_losses(left, right, er_left, er_right, er_gt):
        zero = torch.zeros((), dtype=torch.float32, device=left.device)
        fused = use_er and fused_er_forward
        if use_leftright:
            rows_l, rows_r = [left, _flip(right)], [right, _flip(left)]
            if fused:
                rows_l.append(er_left)
                rows_r.append(er_right)
            outputs = model(torch.cat(rows_l), torch.cat(rows_r), side="l",
                            output_cost_volume=True)
            preds = outputs[pred_key]
            pred = preds[0:1]
            mono = monodepth_leftright_loss(left, right, pred, _flip(preds[1:2]),
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

    return forward_losses, mono_loss


def smoothed_fcs(ema_value: torch.Tensor, ema_init: torch.Tensor, fcs_raw: torch.Tensor,
                 fcs_ema_weight: float) -> torch.Tensor:
    """The FCS EMA on the device: the raw value on the first frame, then
    w * ema + (1 - w) * raw (JAX steps.py:466-471)."""
    return torch.where(ema_init, ema_value * fcs_ema_weight + (1 - fcs_ema_weight) * fcs_raw,
                       fcs_raw)


def _grads(total: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


def make_train_step(model: torch.nn.Module, input_scale: int, scales: Sequence[int],
                    clip_grad_norm: bool, train_bn: bool = True):
    """Supervised training step (reference train.py:204-223; JAX
    steps.py:68-114): the multiscale Khamis loss, its gradients, the
    stereo-net clip and an Adam update. train_bn=False runs BatchNorm on the
    running statistics (eval mode) and leaves them unchanged. JAX's `tx`
    argument has no counterpart: Adam is engine/state.py's.

    train_step(state, batch) -> (state, losses): batch holds
    color_l/<s>, color_r/<s> and gt_disp_l/<s> on the model's device;
    losses are detached 0-d tensors (nothing is read back)."""

    def train_step(state: TrainState, batch: Batch):
        losses, grads = supervised_losses_grads(model, state, batch, input_scale, scales,
                                                train_bn)
        apply_train_update(state, grads, clip_grad_norm)
        return state, {name: v.detach() for name, v in losses.items()}

    return train_step


def supervised_losses_grads(model: torch.nn.Module, state: TrainState, batch: Batch,
                            input_scale: int, scales: Sequence[int], train_bn: bool):
    """The forward, multiscale Khamis loss and parameter gradients of a
    supervised step (make_train_step; parallel/train.py reduces them over
    ranks in between): returns (losses, grads)."""
    model.train(train_bn)
    outputs = model(batch[f"color_l/{input_scale}"], batch[f"color_r/{input_scale}"],
                    side="l", output_cost_volume=False)
    losses = khamis_robust_loss_multiscale(batch, outputs, scales=scales,
                                           gt_disp_scale=input_scale)
    return losses, _grads(losses["total_loss"], state.params)


def apply_train_update(state: TrainState, grads: List[torch.Tensor],
                       clip_grad_norm: bool) -> None:
    """The stereo-net clip, an Adam update and the step count, in place."""
    if clip_grad_norm:
        clip_stereo_net_grads(grads, state.n_feature)
    adam_masked(state, grads)
    state.step.add_(1)


def make_eval_step(model: torch.nn.Module, input_scale: int, k: int):
    """Per-batch eval metrics, the comparison contract (reference
    train.py:74-126; JAX steps.py:117-146): EPE over gt > 0, D1-all at
    2/3/4/5 px and the mean image FCS, from an eval-mode forward of the
    model's current weights. eval_step(batch) takes a dict of tensors on
    the model's device and returns a dict of 0-d tensors."""
    coarse = input_scale + k

    @torch.no_grad()
    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        model.eval()
        outputs = model(batch[f"color_l/{input_scale}"], batch[f"color_r/{input_scale}"],
                        side="l", output_cost_volume=True)
        pred = outputs[f"pred_disp_l/{input_scale}"]
        gt = batch[f"gt_disp_l/{input_scale}"]
        maskf = (gt > 0).float()
        n_valid = torch.clamp(maskf.sum(), min=1.0)
        abs_err = torch.abs(pred - gt)
        metrics = {"EPE": (abs_err * maskf).sum() / n_valid}
        for t in (2, 3, 4, 5):
            # The reference divides by the unfloored count here.
            metrics[f"D1_all_{t}px"] = (maskf * (abs_err > t)).sum() / maskf.sum()
        metrics["FCS"] = mean_fcs_from_outputs(outputs, "l", coarse)
        # In sorted key order, as the JAX step's output dict (and so the
        # columns of trials.csv) comes back.
        return dict(sorted(metrics.items()))

    return eval_step


def make_viz_step(model: torch.nn.Module, input_scale: int):
    """Eval-mode forward returning the raw output dict, for image panels
    (reference train.py:44-71 log_images; JAX steps.py:149-162)."""

    @torch.no_grad()
    def viz_step(batch: Batch) -> Dict[str, torch.Tensor]:
        model.eval()
        return model(batch[f"color_l/{input_scale}"], batch[f"color_r/{input_scale}"],
                     side="l", output_cost_volume=False)

    return viz_step


def make_adapt_loss(model: torch.nn.Module, input_scale: int, k: int,
                    smoothness_weight: float = 1e-3, er_loss_weight: float = 0.05,
                    use_er: bool = False, warp_precision: str = "highest"):
    """The adaptation loss (reference adapt.py:327-396 loop body; JAX
    steps.py:165-227): the train-mode stream forward and its Monodepth
    loss, plus with use_er the replay forward's Khamis loss, BatchNorm
    statistics chained main -> replay (updated in place on the model).

    Returns loss_fn(batch, er_batch) -> (total, (losses, fcs_raw, pred))."""
    check_warp_precision(warp_precision)
    coarse = input_scale + k
    s = input_scale
    forward_losses, _ = make_forward_losses(model, s, smoothness_weight, er_loss_weight,
                                            use_er=use_er)

    def loss_fn(batch: Batch, er_batch: Batch):
        model.train()
        er = er_batch if use_er else batch
        total, mono, replay, pred, fcs_outputs = forward_losses(
            batch[f"color_l/{s}"], batch[f"color_r/{s}"], er[f"color_l/{s}"],
            er[f"color_r/{s}"], er.get(f"gt_disp_l/{s}"))
        losses = {"Monodepth/total_loss": mono}
        if use_er:
            losses["Replay/total_loss"] = replay
        fcs_raw = mean_fcs_from_outputs(fcs_outputs, "l", coarse)
        return total, (losses, fcs_raw, pred)

    return loss_fn


def make_adapt_forward_backward(model: torch.nn.Module, input_scale: int, k: int,
                                smoothness_weight: float = 1e-3, er_loss_weight: float = 0.05,
                                use_er: bool = False, warp_precision: str = "highest"):
    """Adaptation forward + backward (JAX steps.py:230-267).

    fwd_bwd(state, batch, er_batch) -> (grads, aux): the gradients of the
    live parameters, and aux with the Monodepth loss, the replay loss (with
    use_er), the raw FCS and the EPE against the frame's ground truth (when
    the batch has one), all detached 0-d tensors. BatchNorm running
    statistics update in place (main forward, then replay)."""
    loss_fn = make_adapt_loss(model, input_scale, k, smoothness_weight, er_loss_weight,
                              use_er, warp_precision)
    gt_key = f"gt_disp_l/{input_scale}"

    def fwd_bwd(state: TrainState, batch: Batch, er_batch: Batch):
        total, (losses, fcs_raw, pred) = loss_fn(batch, er_batch)
        grads = _grads(total, state.params)
        aux = {name: v.detach() for name, v in losses.items()}
        aux["fcs_raw"] = fcs_raw.detach()
        if gt_key in batch:
            aux["EPE"] = epe(pred.detach(), batch[gt_key])
        return grads, aux

    return fwd_bwd


def make_infer_step(model: torch.nn.Module, input_scale: int, k: int,
                    smoothness_weight: float = 1e-3, warp_precision: str = "highest"):
    """Eval-mode stream step for the DONE state (reference adapt.py:309-311;
    JAX steps.py:270-300): forward, Monodepth loss and FCS, no gradients,
    no BatchNorm update. infer(batch) -> (aux, pred)."""
    check_warp_precision(warp_precision)
    coarse = input_scale + k
    _, mono_loss = make_forward_losses(model, input_scale, smoothness_weight)
    gt_key = f"gt_disp_l/{input_scale}"

    @torch.no_grad()
    def infer(batch: Batch):
        model.eval()
        left, right = batch[f"color_l/{input_scale}"], batch[f"color_r/{input_scale}"]
        outputs = model(left, right, side="l", output_cost_volume=True)
        pred = outputs[f"pred_disp_l/{input_scale}"]
        aux = {"Monodepth/total_loss": mono_loss(left, right, pred),
               "fcs_raw": mean_fcs_from_outputs(outputs, "l", coarse)}
        if gt_key in batch:
            aux["EPE"] = epe(pred, batch[gt_key])
        return aux, pred

    return infer


def make_apply_updates(clip_grad_norm: bool):
    """Masked Adam update (JAX steps.py:303-325): do_update=False keeps the
    parameters and the optimizer state (both counts) bit for bit; the step
    advances either way. apply(state, grads, do_update) -> state, with
    do_update a () bool tensor."""

    def apply(state: TrainState, grads: List[torch.Tensor], do_update: torch.Tensor):
        if clip_grad_norm:
            clip_stereo_net_grads(grads, state.n_feature)
        adam_masked(state, grads, do_update)
        state.step.add_(1)
        return state

    return apply


def init_fcs_ema(device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh device-side FCS EMA (value, initialized) for
    make_fused_adapt_step (JAX steps.py:512-514)."""
    dev = resolve_device(device)
    return (torch.zeros((), dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))


def make_fused_adapt_step(model: torch.nn.Module, input_scale: int, k: int,
                          smoothness_weight: float = 1e-3, er_loss_weight: float = 0.05,
                          use_er: bool = False, use_vs: bool = False,
                          ood_threshold: float = 15.0, fcs_ema_weight: float = 0.999,
                          clip_grad_norm: bool = False, use_leftright: bool = False,
                          consistency_weight: float = 1e-3, gate: str = "fcs",
                          gate_apply=None, warp_precision: str = "highest"):
    """The whole adaptation step (JAX steps.py:328-509): forward, Monodepth
    loss, FCS, replay, backward, the FCS EMA and OOD gate on the device and
    the masked Adam update. The reservoir's accept decision depends on the
    stream state only, so the host draws it ahead (`would_add_if_novel`):

        novel     = smoothed_fcs < ood_threshold      (VS modes only)
        did_add   = novel & would_add_if_novel
        do_update = ~did_add

    use_leftright: the flipped-batch left-right consistency loss; FCS from
    the left-centred row.
    gate: the novelty signal of the gate (VS modes). "fcs": novel iff the
    smoothed FCS < ood_threshold (the reference's live path,
    adapt.py:351-378). "reconstruction": novel iff gate_apply(gate_params,
    left), the image's reconstruction error under an AE / VAE
    (engine/adapt.py make_reconstruction_gate), exceeds ood_threshold, raw,
    with no EMA (the reference's graveyard/adapt_vae.py); the FCS EMA is
    still computed and logged.

    Returns step(state, ema, batch, er_batch, would_add_if_novel,
    gate_params=None) -> (state, ema, aux): ema = (value, initialized) ()
    tensors (updated in place and returned), would_add_if_novel a bool or
    () bool tensor, gate_params the gate model's weights (required by the
    reconstruction gate), aux the detached 0-d tensors fcs_raw,
    fcs_smoothed, novel, did_add, do_update, the losses, EPE (when the
    batch has ground truth) and gate_score (reconstruction gate)."""
    check_gate(gate)
    if gate == "reconstruction" and gate_apply is None:
        raise ValueError("gate='reconstruction' requires gate_apply")
    check_warp_precision(warp_precision)
    coarse = input_scale + k
    s = input_scale
    forward_losses, _ = make_forward_losses(model, s, smoothness_weight, er_loss_weight,
                                            use_er=use_er, use_leftright=use_leftright,
                                            consistency_weight=consistency_weight)
    gt_key = f"gt_disp_l/{s}"

    def step(state: TrainState, ema, batch: Batch, er_batch: Batch, would_add_if_novel,
             gate_params=None):
        model.train()
        er = er_batch if use_er else batch
        total, mono, replay, pred, fcs_outputs = forward_losses(
            batch[f"color_l/{s}"], batch[f"color_r/{s}"], er[f"color_l/{s}"],
            er[f"color_r/{s}"], er.get(f"gt_disp_l/{s}"))
        fcs_raw = mean_fcs_from_outputs(fcs_outputs, "l", coarse).detach()
        grads = _grads(total, state.params)

        ema_value, ema_init = ema
        smoothed = smoothed_fcs(ema_value, ema_init, fcs_raw, fcs_ema_weight)
        ema_value.copy_(smoothed)
        ema_init.fill_(True)
        gate_score = None
        if gate == "reconstruction":
            # High reconstruction error means novel (graveyard direction).
            gate_score = gate_apply(gate_params, batch[f"color_l/{s}"])
        if use_vs:
            novel = smoothed < ood_threshold if gate_score is None else gate_score > ood_threshold
            did_add = novel & torch.as_tensor(would_add_if_novel, device=novel.device)
        else:
            novel = torch.zeros((), dtype=torch.bool, device=fcs_raw.device)
            did_add = novel
        do_update = ~did_add
        if clip_grad_norm:
            clip_stereo_net_grads(grads, state.n_feature)
        adam_masked(state, grads, do_update)
        state.step.add_(1)

        aux = {"Monodepth/total_loss": mono.detach()}
        if use_er:
            aux["Replay/total_loss"] = replay.detach()
        aux.update(fcs_raw=fcs_raw, fcs_smoothed=smoothed, novel=novel, did_add=did_add,
                   do_update=do_update)
        if gate_score is not None:
            aux["gate_score"] = gate_score
        if gt_key in batch:
            aux["EPE"] = epe(pred.detach(), batch[gt_key])
        return state, ema, aux

    return step


def make_ovs_validate_step(model: torch.nn.Module, input_scale: int,
                           smoothness_weight: float = 1e-3, warp_precision: str = "highest"):
    """Recompute the Monodepth loss of every OVS pair with the current
    weights in one batched eval-mode forward (the reference loops per image,
    adapt.py:122-142; JAX steps.py:517-557). The JAX step pads the stack to
    the buffer's capacity so that one XLA program serves every fill; here
    the live pairs alone are batched. validate(left_stack, right_stack) ->
    (N,) per-pair losses."""
    check_warp_precision(warp_precision)
    _, mono_loss = make_forward_losses(model, input_scale, smoothness_weight)

    @torch.no_grad()
    def validate(left_stack: torch.Tensor, right_stack: torch.Tensor) -> torch.Tensor:
        model.eval()
        pred = model(left_stack, right_stack, side="l",
                     output_cost_volume=False)[f"pred_disp_l/{input_scale}"]
        return torch.stack([mono_loss(left_stack[i:i + 1], right_stack[i:i + 1], pred[i:i + 1])
                            for i in range(pred.shape[0])])

    return validate
