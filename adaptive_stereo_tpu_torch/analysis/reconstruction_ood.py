"""Reconstruction-based OOD baselines (counterpart of
adaptive_stereo_tpu/analysis/reconstruction_ood.py; the reference's
graveyard train_autoencoder.py / adapt_vae.py, which FCS superseded).

A small trainer for the AE / VAE image-reconstruction models, the
per-image reconstruction score (high error means novel, the opposite sign
of FCS) and its precision / recall, so that the two signals compare.

Adam is optax.adam's arithmetic through the port's one masked Adam
(engine/state.py adam_masked, every entry live), so a run from the same
weights follows the JAX trainer to rounding. Deviations: the weights start
from random_autoencoder_init_ (a torch.Generator) unless `variables` are
given, and the VAE's sampling noise comes from a torch.Generator seeded
with seed + 2, not a JAX key.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..engine.state import adam_masked
from ..models.autoencoder import (VAE, Autoencoder, random_autoencoder_init_,
                                  reconstruction_error, vae_loss)


@dataclass
class _Adam:
    """The fields adam_masked reads: parameters, moments, count, lr."""

    params: List[torch.nn.Parameter]
    m: List[torch.Tensor]
    v: List[torch.Tensor]
    count: torch.Tensor
    lr: torch.Tensor


def _images(batch, input_scale: int, device: torch.device) -> torch.Tensor:
    img = batch[f"color_l/{input_scale}"]
    if not isinstance(img, torch.Tensor):
        img = torch.from_numpy(np.ascontiguousarray(img))
    return img.to(device, torch.float32)


def train_autoencoder(
    loader,
    input_scale: int = 0,
    num_steps: int = 1000,
    learning_rate: float = 1e-4,
    latent_channels: int = 32,
    stages: int = 4,
    use_vae: bool = False,
    seed: int = 123,
    variables: Optional[Dict[str, torch.Tensor]] = None,
    device: DeviceLike = None,
):
    """Train an AE (L1 reconstruction) or a VAE (L1 + beta-KL) on the
    loader's left images at input_scale, cycling the loader, for num_steps
    Adam steps on `device` ("cuda" unless the caller passes "cpu").

    variables: a state dict to start from (models/autoencoder.py
    autoencoder_state_dict_from_jax carries JAX's); else random weights
    from `seed`. The VAE takes the first batch's size (JAX's unused
    image_hw argument is not kept).

    Returns (model, state_dict, losses): the trained module, a copy of its
    weights (the gate's variables) and each step's loss."""
    dev = resolve_device(device)
    first = _images(next(iter(loader)), input_scale, dev)
    h, w = first.shape[1], first.shape[2]
    model = (VAE(z_dim=latent_channels, input_height=h, input_width=w) if use_vae
             else Autoencoder(latent_channels=latent_channels, stages=stages)).to(dev)
    if variables is not None:
        model.load_state_dict(variables)
    else:
        random_autoencoder_init_(model, torch.Generator(device=dev).manual_seed(seed))
    params = list(model.parameters())
    opt = _Adam(params, [torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params],
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.tensor(learning_rate, dtype=torch.float32, device=dev))
    noise = torch.Generator(device=dev).manual_seed(seed + 2)

    losses = []
    it = iter(loader)
    for _ in range(num_steps):
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            batch = next(it)
        x = _images(batch, input_scale, dev)
        if use_vae:
            recon, mu, logvar = model(x, generator=noise)
            loss = vae_loss(x, recon, mu, logvar)[0]
        else:
            loss = torch.mean(torch.abs(model(x) - x))
        grads = torch.autograd.grad(loss, params)
        adam_masked(opt, list(grads))
        losses.append(float(loss.detach()))
    state_dict = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return model, state_dict, losses


def reconstruction_scores(model: torch.nn.Module, variables: Optional[Dict[str, torch.Tensor]],
                          loader, input_scale: int = 0, use_vae: bool = False,
                          max_batches: Optional[int] = None) -> np.ndarray:
    """Per-image reconstruction L1 error over a loader, the graveyard OOD
    signal (high error means novel), on the model's device. Returns (N,)."""
    dev = next(model.parameters()).device
    out = []
    for i, batch in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        out.append(reconstruction_error(model, variables, _images(batch, input_scale, dev),
                                        use_vae).cpu().numpy())
    return np.concatenate(out)


def reconstruction_precision_recall(train_scores: np.ndarray, novel_scores: np.ndarray,
                                    cutoff: float) -> Dict[str, float]:
    """Precision and recall of the classifier 'novel iff reconstruction
    error >= cutoff'."""
    tp = int((novel_scores >= cutoff).sum())
    fn = int((novel_scores < cutoff).sum())
    fp = int((train_scores >= cutoff).sum())
    pr = tp / (tp + fp) if (tp + fp) > 0 else 1.0
    re = tp / (tp + fn)
    return {"precision": pr, "recall": re}
