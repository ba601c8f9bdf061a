"""Evaluation loop, the metrics comparison contract (counterpart of
adaptive_stereo_tpu/engine/evaluate.py; reference train.py:74-126).

EPE, D1-all at 2/3/4/5 px and FCS: per-batch means averaged over batches.
The fast_eval (a tenth of the batches) and num_steps capping quirks are
kept, so the numbers compare with the reference's logs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def evaluate(eval_step, model: torch.nn.Module, loader, fast_eval: bool = False,
             num_steps: int = -1) -> Dict[str, float]:
    """eval_step from engine/steps.py:make_eval_step(model, ...); the loader's
    numpy batches are copied to the model's device (non_blocking)."""
    num_batches = len(loader) // 10 if fast_eval else len(loader)
    if num_steps > 0:
        num_batches = min(num_steps // loader.batch_size, len(loader))
    num_batches = max(num_batches, 1)

    device = next(model.parameters()).device
    acc: Dict[str, list] = {}
    for i, batch in enumerate(loader):
        if i >= num_batches:
            break
        device_batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
                        for k, v in batch.items()}
        metrics = eval_step(device_batch)
        for k, v in metrics.items():
            acc.setdefault(k, []).append(float(v))
    return {k: float(np.mean(v)) for k, v in acc.items()}
