"""Device-resident frame caches for the streaming driver (counterpart of
adaptive_stereo_tpu/engine/device_cache.py).

The adaptation protocol streams a finite dataset (the reference replays a
recorded sequence, adapt.py:214-230), so adapt_streaming(device_cache=True)
ships the whole stream, the replay pool and both validation sets to the
device once and slices frames there: no host-to-device copy a step.

- Colors are cached as uint8 at input_scale 0 (4x smaller than float32)
  and dequantized on the device as f32 / 255 (engine/flat_stream.py
  dequantize_u8), the same correctly rounded division the dataset does on
  the host, so the cached path gives the upload path's frames bit for bit
  there. At input_scale > 0 the pyramid is resized in float32 on the host,
  so the cache stores float32.
- Ground-truth disparity is cached as float32, zeros where the dataset has
  none (it feeds only the ring log's EPE and the evals).

At 320x960 a 500-frame stream is about 0.92 GB of uint8 colour (both
views) and 0.61 GB of float32 ground truth.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def _load_all(dataset, num_workers: int = 8) -> List[dict]:
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        return list(pool.map(dataset.__getitem__, range(len(dataset))))


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


class DeviceStreamCache:
    """The frames color_l/<s>, color_r/<s> and gt_disp_l/<s> of `dataset`
    stacked into three tensors on `device` ("cuda" unless the caller passes
    "cpu"). With uint8_colors the dataset must yield uint8 colours (build it
    with color_uint8=True). fetch(i) returns (1, H, W, 3) colour and
    (1, H, W, 1) float32 slices, views into the cache."""

    def __init__(self, dataset, scale: int, uint8_colors: bool, device: DeviceLike = None,
                 num_workers: int = 8, items: Optional[List[dict]] = None):
        dev = resolve_device(device)
        items = _load_all(dataset, num_workers) if items is None else items
        lk, rk, gk = f"color_l/{scale}", f"color_r/{scale}", f"gt_disp_l/{scale}"
        cdt = np.uint8 if uint8_colors else np.float32
        self.left = _upload(np.stack([it[lk] for it in items]).astype(cdt), dev)
        self.right = _upload(np.stack([it[rk] for it in items]).astype(cdt), dev)
        if gk in items[0]:
            gt = np.stack([it[gk] for it in items]).astype(np.float32)
        else:
            h, w = items[0][lk].shape[:2]
            gt = np.zeros((len(items), h, w, 1), np.float32)
        self.gt = _upload(gt, dev)
        self.keys = (lk, rk, gk)

    def __len__(self) -> int:
        return self.left.shape[0]

    @property
    def nbytes(self) -> int:
        """Bytes the cache holds on its device."""
        return sum(t.numel() * t.element_size() for t in (self.left, self.right, self.gt))

    def fetch(self, index: int) -> Dict[str, torch.Tensor]:
        """Frame `index` as batch-1 views on the device (no copy, no sync)."""
        lk, rk, gk = self.keys
        return {lk: self.left[index:index + 1], rk: self.right[index:index + 1],
                gk: self.gt[index:index + 1]}


class DeviceCachedLoader:
    """A BatchLoader's batches copied to `device` once: the same len,
    batch_size and iteration, yielding dicts of tensors on the device, which
    engine/evaluate.py takes as they are."""

    def __init__(self, loader, device: DeviceLike = None):
        dev = resolve_device(device)
        self.batch_size = loader.batch_size
        self._batches = [{k: _upload(np.asarray(v), dev) for k, v in b.items()} for b in loader]

    def __len__(self) -> int:
        return len(self._batches)

    def __iter__(self):
        return iter(self._batches)
