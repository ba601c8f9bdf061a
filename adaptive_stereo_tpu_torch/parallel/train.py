"""Data-parallel supervised training over a mesh (counterpart of
adaptive_stereo_tpu/parallel/train.py).

Each rank runs the multiscale Khamis loss and its gradients on its own
shard of the batch (parallel/mesh.py data_sharding), with local BatchNorm
statistics (the batch is the rank's batch, as in the reference). One
all_reduce then averages the gradients, the losses and the updated running
statistics over the ranks, and every rank applies the same clip and Adam
step (engine/steps.py apply_train_update).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..engine.state import TrainState
from ..engine.steps import apply_train_update, supervised_losses_grads
from .fleet import _restore
from .mesh import Mesh


def make_parallel_train_step(model: torch.nn.Module, mesh: Mesh, input_scale: int,
                             scales: Sequence[int], clip_grad_norm: bool,
                             train_bn: bool = True):
    """train_step(state, batch) -> (state, losses), batch the rank's shard
    (color_l/<s>, color_r/<s>, gt_disp_l/<s> on the mesh's device); the
    state updates in place and the losses are the ranks' mean, detached
    0-d tensors. JAX's `tx` argument has no counterpart: Adam is
    engine/state.py's.

    train_bn=False runs BatchNorm on the running statistics (eval mode,
    statistics unchanged): no sample then couples to another through the
    normalization, so the mean of the ranks' gradients is exactly the
    gradient of the whole batch."""

    def train_step(state: TrainState, batch):
        losses, grads = supervised_losses_grads(model, state, batch, input_scale, scales,
                                                train_bn)
        names = list(losses)
        parts = grads + [torch.stack([losses[n].detach() for n in names])] + state.buffers
        sizes = [t.numel() for t in parts]
        bucket = torch.cat([t.reshape(-1) for t in parts])
        mesh.all_reduce(bucket)
        bucket /= mesh.world_size
        views = [v.view_as(t) for v, t in zip(bucket.split(sizes), parts)]
        grads, mean_losses = views[:len(grads)], views[len(grads)]
        _restore(state.buffers, views[len(grads) + 1:])
        apply_train_update(state, grads, clip_grad_norm)
        return state, {n: mean_losses[i] for i, n in enumerate(names)}

    return train_step
