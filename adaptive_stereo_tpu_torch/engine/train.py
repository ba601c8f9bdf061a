"""Supervised trainer (reference train.py:140-243; counterpart of
adaptive_stereo_tpu/engine/train.py).

One step is the multiscale Khamis loss, its gradients, the stereo-net clip
and Adam (engine/steps.py make_train_step); the learning rate halves every
scheduler_step_size epochs by a host-side write; an eval runs at each log
point of the reference's early/late cadence; checkpoints hold the whole
train state (engine/checkpoint.py). Between log points nothing is read
back to the host.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data import BatchLoader, StereoDataset
from ..device import DeviceLike, resolve_device, to_device
from ..models import build_model
from ..utils.logging_utils import MetricsWriter, write_opt_json
from .checkpoint import load_variables, save_checkpoint
from .config import ExperimentConfig
from .evaluate import evaluate
from .state import create_train_state
from .steps import make_eval_step, make_train_step, make_viz_step


def train(cfg: ExperimentConfig, variables: Optional[dict] = None,
          splits_root: Optional[str] = None, device: DeviceLike = None) -> Dict:
    """Supervised training per cfg. variables: JAX-layout weights to start
    from, else cfg.load_weights_folder, else random_init_ from a generator
    seeded with cfg.seed. device: "cuda" (None) or "cpu".

    Returns {'state': the TrainState, 'final_metrics': the last eval's
    metrics, 'steps': steps taken}."""
    dev = resolve_device(device)
    mc, dc, oc = cfg.model, cfg.data, cfg.optim
    s, k = mc.input_scale, mc.k
    log_path = os.path.join(cfg.log_dir, cfg.model_name)
    write_opt_json(log_path, cfg)

    np.random.seed(cfg.seed)

    model = build_model(cfg.model, dev)
    if variables is None and cfg.load_weights_folder is not None:
        print("Loading models from:", cfg.load_weights_folder)
        variables = load_variables(cfg.load_weights_folder)
    state = create_train_state(model, torch.Generator().manual_seed(cfg.seed),
                               learning_rate=oc.learning_rate, variables=variables)

    loss_scales = [s, s + k]
    mk = dict(scales=loss_scales, splits_root=splits_root)
    train_dataset = StereoDataset(dc.dataset_path, dc.dataset_name, dc.split,
                                  dc.height, dc.width, "train", do_hflip=dc.do_hflip,
                                  random_crop=True, load_disp_left=True,
                                  load_disp_right=True, seed=cfg.seed, **mk)
    val_dataset = StereoDataset(dc.dataset_path, dc.dataset_name, dc.split,
                                dc.height, dc.width, "val", do_hflip=False,
                                random_crop=False, load_disp_left=True,
                                load_disp_right=False, **mk)
    train_loader = BatchLoader(train_dataset, dc.batch_size, shuffle=not dc.no_shuffle,
                               num_workers=dc.num_workers, seed=cfg.seed)
    val_loader = BatchLoader(val_dataset, dc.batch_size, shuffle=False,
                             num_workers=dc.num_workers, seed=cfg.seed)

    print("-" * 70)
    print(f"DATASET SIZES:\n  TRAIN={len(train_dataset)} VAL={len(val_dataset)}")
    print("-" * 70)

    writer = MetricsWriter(os.path.join(log_path, "val"))
    train_step = make_train_step(model, s, loss_scales, oc.clip_grad_norm)
    eval_step = make_eval_step(model, s, k)
    viz_step = make_viz_step(model, s) if cfg.log_images else None

    step = 0
    metrics: Dict = {}
    for epoch in range(cfg.num_epochs):
        for bi, raw_batch in enumerate(train_loader):
            t0 = time.time()
            batch = to_device(raw_batch, dev)
            state, losses = train_step(state, batch)

            early_phase = (step % cfg.log_frequency) == 0 and step < 2000
            late_phase = (step % 2000) == 0 or bi == 0
            if early_phase or late_phase:
                # Reading the losses waits for the step; then time it.
                losses = {n: float(v) for n, v in losses.items()}
                elapsed = time.time() - t0
                metrics = evaluate(eval_step, model, val_loader, cfg.fast_eval)
                writer.log_scalars(metrics, losses, dc.batch_size / max(elapsed, 1e-9),
                                   epoch, step)
                if viz_step is not None:
                    writer.log_images(batch, viz_step(batch), step)
            step += 1

        if epoch >= 1 and (epoch % cfg.save_freq) == 0:
            save_checkpoint(log_path, state, epoch, {"config": cfg.to_json()})

        # StepLR(gamma=0.5) per epoch (reference train.py:167,240).
        if (epoch + 1) % oc.scheduler_step_size == 0:
            state = state.with_learning_rate(state.learning_rate * 0.5)

    save_checkpoint(log_path, state, cfg.num_epochs - 1, {"config": cfg.to_json()})
    writer.close()
    return {"state": state, "final_metrics": metrics, "steps": step}
