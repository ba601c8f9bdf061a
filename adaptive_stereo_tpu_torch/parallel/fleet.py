"""Fleet adaptation: N camera streams adapt one shared model (counterpart
of adaptive_stereo_tpu/parallel/fleet.py).

Each rank of the mesh (parallel/mesh.py) holds its own streams, the rows of
the stream axis it was given. Per stream: the adaptation loss, the FCS EMA,
the novelty gate and the pre-drawn reservoir decision, on the device. The
shared update: the do_update-weighted mean of the per-stream gradients over
every rank's streams, one masked Adam step (engine/state.py adam_masked),
computed alike on every rank from one all_reduce of a flat bucket.

JAX runs the streams under vmap inside one shard_map program, with a psum
that XLA inserts. The port's model updates its BatchNorm running statistics
in place on every train-mode forward (models/stereo_net.py _bn,
models/aggregation.py update_running_stats), so a loop over streams would
chain them from stream to stream. Here:

- bn_mode="per_stream" (default): each stream's forward normalizes with its
  own batch statistics (the reference's batch-1 train-mode BN,
  adapt.py:313-314) and starts from the same shared running statistics: a
  snapshot taken once, restored after each stream. Stream i's gate weight
  w_i depends on its own FCS only, so its backward runs right after its
  forward and adds w_i * g_i to the bucket: one stream's activations are
  alive at a time. JAX differentiates sum_i w_i * total_i in one backward;
  this is the same sum in another order. The shared statistics become the
  in_progress-weighted mean of the streams' updated ones over every rank
  (unchanged if no stream is active).
- bn_mode="shared": one merged train forward over the rank's streams (and
  one merged replay forward); BatchNorm statistics span them (JAX's
  documented deviation). The statistics become their mean over the ranks
  when any stream is active.
- remat=True wraps the per-stream loss (per_stream) or each merged forward
  (shared) in torch.utils.checkpoint. The recomputation in the backward
  would update the running statistics again; the step restores the values
  its forwards left, so remat changes memory, never results.

Nothing is read back to the host inside a step: the gate and the masks stay
tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..engine.state import TrainState, adam_masked
from ..engine.steps import (_grads, check_warp_precision, clip_stereo_net_grads, epe,
                            make_adapt_loss, make_forward_losses, smoothed_fcs)
from ..ops import feature_contrast_mean, khamis_robust_loss, online_ema
from .mesh import Mesh

Batch = Dict[str, torch.Tensor]


def _stream(batch: Batch, i: int) -> Batch:
    """Stream i of a stacked batch, with a batch axis of 1."""
    return {key: v[i:i + 1] for key, v in batch.items()}


def _snapshot(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    return [t.clone() for t in tensors]


@torch.no_grad()
def _restore(tensors: List[torch.Tensor], values: List[torch.Tensor]) -> None:
    torch._foreach_copy_(tensors, values)


def make_fleet_fwd_bwd(single_fwd_bwd):
    """Per-stream gradients of the rank's streams (JAX: the vmapped step
    under shard_map over a mesh; no collective runs, so the port's takes no
    mesh), from single_fwd_bwd(state, batch, er_batch) -> (grads, aux)
    (engine/steps.py make_adapt_forward_backward).

    fleet_fwd_bwd(state, batch_n, er_batch_n) -> (grads_n, stats_n, aux_n):
    each stream runs alone from the shared running statistics; grads_n and
    stats_n hold one tensor per parameter / statistic with a leading stream
    axis, aux_n one (n,) tensor per entry. The state's statistics are left
    as they were."""

    def fleet_fwd_bwd(state: TrainState, batch_n: Batch, er_batch_n: Batch):
        shared = _snapshot(state.buffers)
        grads, stats, auxes = [], [], []
        for i in range(len(next(iter(batch_n.values())))):
            g, aux = single_fwd_bwd(state, _stream(batch_n, i), _stream(er_batch_n, i))
            grads.append(g)
            stats.append(_snapshot(state.buffers))
            auxes.append(aux)
            _restore(state.buffers, shared)
        stack = lambda per: [torch.stack(ts) for ts in zip(*per)]
        return (stack(grads), stack(stats),
                {key: torch.stack([a[key] for a in auxes]) for key in auxes[0]})

    return fleet_fwd_bwd


def make_fleet_apply_updates(clip_grad_norm: bool):
    """Combine per-stream gradients by the do_update-weighted mean and apply
    one masked Adam update (JAX: a jit over the global arrays; here over
    the arrays given). apply(state, grads_n, stats_n, do_update_n) ->
    state: the parameters and Adam state move iff any do_update; the
    running statistics become the mean of stats_n; the step advances."""

    def apply(state: TrainState, grads_n: List[torch.Tensor], stats_n: List[torch.Tensor],
              do_update_n: torch.Tensor) -> TrainState:
        w = do_update_n.float()
        denom = torch.clamp(w.sum(), min=1.0)
        grads = [torch.tensordot(w, g, dims=([0], [0])) / denom for g in grads_n]
        if clip_grad_norm:
            clip_stereo_net_grads(grads, state.n_feature)
        adam_masked(state, grads, w.sum() > 0)
        _restore(state.buffers, [s.mean(dim=0) for s in stats_n])
        state.step.add_(1)
        return state

    return apply


class _Bucket:
    """One flat float32 buffer holding the gradient sum, sum(w), sum(wa) and
    the statistics sum, so one all_reduce combines them all."""

    def __init__(self, params: List[torch.Tensor], buffers: List[torch.Tensor]):
        sizes = [p.numel() for p in params] + [1, 1] + [b.numel() for b in buffers]
        self.flat = torch.zeros(sum(sizes), dtype=torch.float32, device=params[0].device)
        views = self.flat.split(sizes)
        n = len(params)
        self.grads = [v.view_as(p) for v, p in zip(views[:n], params)]
        self.sum_w, self.sum_wa = views[n].view(()), views[n + 1].view(())
        self.stats = [v.view_as(b) for v, b in zip(views[n + 2:], buffers)]


def make_fused_fleet_step(model: torch.nn.Module, mesh: Mesh, input_scale: int, k: int,
                          smoothness_weight: float = 1e-3, er_loss_weight: float = 0.05,
                          use_er: bool = False, use_vs: bool = False,
                          ood_threshold: float = 15.0, fcs_ema_weight: float = 0.999,
                          clip_grad_norm: bool = False, warp_precision: str = "highest",
                          bn_mode: str = "per_stream",
                          remat: bool = False):
    """The whole fleet adaptation step over the rank's streams, combined
    across ranks by one all_reduce (see the module docstring for bn_mode
    and remat).

    step(state, ema_n, batch_n, er_batch_n, would_add_n, in_progress_n)
      -> (state, ema_n, aux_n)
    batch_n / er_batch_n: the rank's streams stacked on the leading axis
    (n, H, W, C) on the mesh's device; ema_n = ((n,) values, (n,) bool
    initialized), updated in place; would_add_n: the pre-drawn reservoir
    decisions; in_progress_n masks DONE streams (no gradient; in per_stream
    mode no statistics either). Per stream:

        novel     = smoothed FCS < ood_threshold      (use_vs)
        did_add   = novel & would_add
        do_update = in_progress & ~did_add

    The state (parameters, Adam state, statistics, step) updates in place.
    aux_n: (n,) tensors Monodepth/total_loss, Replay/total_loss (use_er),
    fcs_raw, EPE (when the batch has ground truth), fcs_smoothed, novel,
    did_add, do_update."""
    if bn_mode not in ("per_stream", "shared"):
        raise ValueError(f"unknown bn_mode {bn_mode!r}")
    check_warp_precision(warp_precision)
    s, coarse = input_scale, input_scale + k
    loss_one = make_adapt_loss(model, s, k, smoothness_weight=smoothness_weight,
                               er_loss_weight=er_loss_weight, use_er=use_er,
                               warp_precision=warp_precision)
    _, mono_loss = make_forward_losses(model, s, smoothness_weight)
    pred_key, gt_key = f"pred_disp_l/{s}", f"gt_disp_l/{s}"

    def call(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    def gate(ema_value, ema_init, fcs_raw, would_add, in_progress):
        smoothed = smoothed_fcs(ema_value, ema_init, fcs_raw, fcs_ema_weight)
        if use_vs:
            novel = smoothed < ood_threshold
            did_add = novel & would_add
        else:
            novel = did_add = torch.zeros_like(would_add)
        do_update = in_progress & ~did_add
        return smoothed, novel, did_add, do_update

    def per_stream(state, bucket, shared, batch_n, er_batch_n, ema_n, would_add_n,
                   in_progress_n):
        wa_n = in_progress_n.float()
        rows = []
        for i in range(len(would_add_n)):
            batch = _stream(batch_n, i)
            total, (losses, fcs_raw, pred) = call(loss_one, batch, _stream(er_batch_n, i))
            torch._foreach_add_(bucket.stats, torch._foreach_mul(state.buffers, wa_n[i]))
            _restore(state.buffers, shared)
            fcs_raw = fcs_raw.detach()
            smoothed, novel, did_add, do_update = gate(ema_n[0][i], ema_n[1][i], fcs_raw,
                                                       would_add_n[i], in_progress_n[i])
            w = do_update.float()
            torch._foreach_add_(bucket.grads, _grads(w * total, state.params))
            if remat:  # the backward's recomputation ran the forwards again
                _restore(state.buffers, shared)
            bucket.sum_w.add_(w)
            row = {name: v.detach() for name, v in losses.items()}
            row["fcs_raw"] = fcs_raw
            if gt_key in batch:
                row["EPE"] = epe(pred.detach(), batch[gt_key])
            row.update(fcs_smoothed=smoothed, novel=novel, did_add=did_add,
                       do_update=do_update)
            rows.append(row)
        bucket.sum_wa.add_(wa_n.sum())
        return {key: torch.stack([r[key] for r in rows]) for key in rows[0]}

    def forward_train(left, right, output_cost_volume):
        return model(left, right, side="l", output_cost_volume=output_cost_volume)

    def shared_batch(state, bucket, _, batch_n, er_batch_n, ema_n, would_add_n, in_progress_n):
        model.train()
        n = len(would_add_n)
        left, right = batch_n[f"color_l/{s}"], batch_n[f"color_r/{s}"]
        outputs = call(forward_train, left, right, True)
        pred_n = outputs[pred_key]
        mono_n = torch.stack([mono_loss(left[i:i + 1], right[i:i + 1], pred_n[i:i + 1])
                              for i in range(n)])
        aux = {"Monodepth/total_loss": mono_n.detach()}
        totals_n = mono_n
        if use_er:
            er_out = call(forward_train, er_batch_n[f"color_l/{s}"],
                          er_batch_n[f"color_r/{s}"], False)
            er_pred, er_gt = er_out[pred_key], er_batch_n[gt_key]
            rep_n = torch.stack([khamis_robust_loss(er_pred[i:i + 1], er_gt[i:i + 1])
                                 for i in range(n)])
            aux["Replay/total_loss"] = rep_n.detach()
            totals_n = totals_n + er_loss_weight * rep_n
        fkey = f"fcs_l/{coarse}"
        fmap = (outputs[fkey] if fkey in outputs else
                feature_contrast_mean(outputs[f"cost_volume_l/{coarse}"]))
        fcs_n = fmap.detach().reshape(n, -1).mean(dim=1)
        stats = _snapshot(state.buffers)
        smoothed, novel, did_add, do_update = gate(*ema_n, fcs_n, would_add_n, in_progress_n)
        w = do_update.float()
        torch._foreach_add_(bucket.grads, _grads((w * totals_n).sum(), state.params))
        if remat:
            _restore(state.buffers, stats)
        torch._foreach_add_(bucket.stats, stats)
        bucket.sum_w.add_(w.sum())
        bucket.sum_wa.add_(in_progress_n.float().sum())
        aux["fcs_raw"] = fcs_n
        if gt_key in batch_n:
            aux["EPE"] = torch.stack([epe(pred_n[i:i + 1].detach(), batch_n[gt_key][i:i + 1])
                                      for i in range(n)])
        aux.update(fcs_smoothed=smoothed, novel=novel, did_add=did_add, do_update=do_update)
        return aux

    local = shared_batch if bn_mode == "shared" else per_stream

    def step(state: TrainState, ema_n, batch_n: Batch, er_batch_n: Batch, would_add_n,
             in_progress_n):
        dev = state.params[0].device
        would_add_n = torch.as_tensor(would_add_n, dtype=torch.bool, device=dev)
        in_progress_n = torch.as_tensor(in_progress_n, dtype=torch.bool, device=dev)
        er_batch_n = er_batch_n if use_er else batch_n
        old_stats = _snapshot(state.buffers)
        bucket = _Bucket(state.params, state.buffers)
        aux = local(state, bucket, old_stats, batch_n, er_batch_n, ema_n, would_add_n,
                    in_progress_n)
        mesh.all_reduce(bucket.flat)

        grads = torch._foreach_div(bucket.grads, torch.clamp(bucket.sum_w, min=1.0))
        if clip_grad_norm:
            clip_stereo_net_grads(grads, state.n_feature)
        adam_masked(state, grads, bucket.sum_w > 0)
        denom = (torch.clamp(bucket.sum_wa, min=1.0) if bn_mode == "per_stream"
                 else float(mesh.world_size))
        mean = torch._foreach_div(bucket.stats, denom)
        _restore(state.buffers, [torch.where(bucket.sum_wa > 0, m, old)
                                 for m, old in zip(mean, old_stats)])
        state.step.add_(1)
        ema_n[0].copy_(aux["fcs_smoothed"])
        ema_n[1].fill_(True)
        return state, ema_n, aux

    return step


def init_fleet_fcs_ema(num_streams: int, device: DeviceLike = None):
    """Fresh per-stream FCS EMA ((n,) values, (n,) initialized flags) on
    `device` ("cuda" unless the caller passes "cpu")."""
    dev = resolve_device(device)
    return (torch.zeros((num_streams,), dtype=torch.float32, device=dev),
            torch.zeros((num_streams,), dtype=torch.bool, device=dev))


class FleetDriver:
    """Host-side per-stream OOD gating for a fleet of adaptation streams:
    one FCS EMA and novelty decision per stream (ops/ema.py online_ema);
    deterministic given stream order."""

    def __init__(self, num_streams: int, ood_threshold: float, fcs_ema_weight: float = 0.999):
        self.num_streams = num_streams
        self.ood_threshold = ood_threshold
        self.fcs_ema_weight = fcs_ema_weight
        self._ema: list = [None] * num_streams

    def smooth_and_gate(self, fcs_raw_n) -> Dict[str, Any]:
        """Update the per-stream EMAs with this step's raw FCS vector and
        return the smoothed values and the novelty mask."""
        fcs_raw_n = np.asarray(fcs_raw_n)
        smoothed = np.empty(self.num_streams, np.float64)
        for i in range(self.num_streams):
            if self._ema[i] is None:
                self._ema[i] = float(fcs_raw_n[i])
            else:
                self._ema[i] = online_ema(self._ema[i], float(fcs_raw_n[i]),
                                          self.fcs_ema_weight)
            smoothed[i] = self._ema[i]
        return {"fcs_smoothed": smoothed, "novel": smoothed < self.ood_threshold}
