"""Cost-volume dump and per-pixel slice plots (counterpart of
adaptive_stereo_tpu/analysis/cost_volume.py; reference
evaluation/cost_volume_analysis.py:34-131, the paper's cost-slice figure).

save_cost_volumes runs the eval forward with output_cost_volume=True on
the model's device: the three-stage coarse head (the cost-volume,
aggregation and soft-argmin + FCS kernels of ops/cuda on the card; never
the fused head, which does not materialise the cost). It saves each
image's float32 cost (D, h, w) and the coarse-scale ground truth as .npy.
plot_cost_volume_slices then draws the cost along the disparity axis at
the pixel of least (most novel) or greatest FCS, with the max and the mean
of the rest as dashed lines and the ground-truth disparity marked, through
analysis/figure.py.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..models import state_dicts_from_jax
from ..ops.fcs import feature_contrast_mean
from .figure import subplots


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_cost_volumes(model: torch.nn.Module, variables: Optional[dict], loader,
                      output_folder: str, input_scale: int, k: int,
                      num_images: int = 5) -> int:
    """Dump per-image cost volumes ({i}_cost_volume.npy, (D, h, w) float32)
    and coarse-scale GT disparities ({i}_gt.npy, (h, w)). variables:
    JAX-layout {'params', 'batch_stats'} loaded into the model first, or
    None for the model's own weights. Returns the number saved."""
    if variables is not None:
        model.load_state_dicts(*state_dicts_from_jax(variables, k))
    dev = next(model.parameters()).device
    os.makedirs(output_folder, exist_ok=True)
    coarse = input_scale + k
    model.eval()
    saved = 0
    with torch.no_grad():
        for batch in loader:
            if saved >= num_images:
                break
            for b in range(batch[f"color_l/{input_scale}"].shape[0]):
                if saved >= num_images:
                    break
                left, right = (torch.as_tensor(batch[f"color_{side}/{input_scale}"][b:b + 1])
                               .to(dev) for side in "lr")
                out = model(left, right, side="l", output_cost_volume=True)
                cv = _host(out[f"cost_volume_l/{coarse}"])[0]
                np.save(os.path.join(output_folder, f"{saved}_cost_volume.npy"), cv)
                gt_key = f"gt_disp_l/{coarse}"
                if gt_key in batch:
                    np.save(os.path.join(output_folder, f"{saved}_gt.npy"),
                            _host(batch[gt_key][b])[..., 0])
                saved += 1
    return saved


def _slice_pixel(cv: np.ndarray, use_min_fcs: bool):
    """(row, col) of the pixel of least (or greatest) FCS of a (D, h, w)
    cost, by the port's feature_contrast_mean on the CPU."""
    fcs = feature_contrast_mean(torch.from_numpy(np.ascontiguousarray(cv)[None]))[0].numpy()
    idx = int(fcs.argmin() if use_min_fcs else fcs.argmax())
    return idx // fcs.shape[-1], idx % fcs.shape[-1]


def plot_cost_volume_slices(output_folder: str, num_images: int, use_min_fcs: bool = True,
                            line_color: str = "tab:blue",
                            ylim: Optional[tuple] = None) -> None:
    """For each dumped cost volume, plot cost against disparity at the pixel
    of least (novel-est) or greatest (most confident) FCS into
    {i}_cost_volume_slice.pdf."""
    for i in range(num_images):
        cv = np.load(os.path.join(output_folder, f"{i}_cost_volume.npy"))  # (D, h, w)
        gt_path = os.path.join(output_folder, f"{i}_gt.npy")
        gt = np.load(gt_path) if os.path.exists(gt_path) else None

        row, col = _slice_pixel(cv, use_min_fcs)
        cost_slice = cv[:, row, col]
        s = np.sort(cost_slice)[::-1]
        max_value, mean_value = s[0], s[2:].mean()

        fig, ax = subplots(figsize=(4, 3))
        d = len(cost_slice)
        ax.plot(np.arange(d), cost_slice, color=line_color)
        ax.set_xticks(np.arange(0, d, step=2))
        ax.set_xlabel("disparity")
        ax.set_ylabel(r"feature similarity score $\mathcal{C}(u, v)$")
        ax.hlines(max_value, 0, d - 2.5, linestyles="dashed", colors="gray")
        ax.hlines(mean_value, 0, d - 2.5, linestyles="dashed", colors="gray")
        ax.text(d - 2.5, max_value, "max", va="center")
        ax.text(d - 2.5, mean_value, "mean", va="center")
        if gt is not None:
            ax.vlines(gt[row, col], cost_slice.min(), cost_slice.max(), linestyles="dashed",
                      colors="black")
        if ylim is not None:
            ax.set_ylim(*ylim)
        fig.savefig(os.path.join(output_folder, f"{i}_cost_volume_slice.pdf"))
