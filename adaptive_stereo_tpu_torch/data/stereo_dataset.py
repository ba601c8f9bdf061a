"""Split-file-driven stereo dataset + threaded prefetching batch loader.

Behavioral contract from reference datasets/stereo_dataset.py:13-145:
- items come from `<splits_root>/<split>/<subsplit>_lines.txt`;
- random or center crop to (height, width);
- optional joint horizontal flip: swap left/right AND mirror each image
  (reference utils/dataset_utils.py:19-23);
- multiscale pyramid: color and GT disparity bilinearly resized to each scale
  s, disparity VALUES divided by 2^s;
- outputs keyed `color_{l,r}/{s}` (H, W, 3) and `gt_disp_{l,r}/{s}` (H, W, 1),
  float32, NHWC, colors in [0, 1].

Counterpart of adaptive_stereo_tpu/data/stereo_dataset.py. The cv2
decode is data/png.py for PNG and data/jpeg.py for JPEG; the cv2
INTER_LINEAR resize is a half-pixel bilinear resize in numpy
(_resize_bilinear). Batches are numpy; a thread
pool prefetches them ahead of the step, which copies them to the device.
"""

from __future__ import annotations

import os
import queue
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from .loaders import get_disp_loader
from .jpeg import decode_jpeg
from .png import PNG_SIGNATURE, decode_png
from .splits import default_splits_root, read_lines, split_lines_path


def _axis_taps(n_in: int, n_out: int):
    """Half-pixel bilinear taps along one axis, as cv2 INTER_LINEAR computes
    them: source x = (i + 0.5) * n_in / n_out - 0.5, clamped to the image
    (a weight of 0 on the far tap at the borders)."""
    scale = n_in / n_out
    fx = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    x0 = np.floor(fx).astype(np.int64)
    frac = fx - x0
    frac[x0 < 0] = 0.0
    x0 = np.clip(x0, 0, n_in - 1)
    frac[x0 >= n_in - 1] = 0.0
    x1 = np.minimum(x0 + 1, n_in - 1)
    return x0, x1, frac.astype(np.float32)


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Half-pixel-center bilinear resize of an (H, W) or (H, W, C) image to
    (h, w, C) (torch F.interpolate align_corners=False semantics, without
    antialiasing), along the width first, then the height, as cv2 does.
    Float images in float32; uint8 images in cv2's fixed point (11-bit
    weights, a rounding shift by 22 bits), whose vector path agrees with it
    at the dyadic scales of the pyramid (every weight 1/2)."""
    x = img if img.ndim == 3 else img[..., None]
    x0, x1, fx = _axis_taps(x.shape[1], w)
    y0, y1, fy = _axis_taps(x.shape[0], h)
    if x.dtype == np.uint8:
        one = 1 << 11
        ax = np.round(fx * one).astype(np.int64)[None, :, None]
        ay = np.round(fy * one).astype(np.int64)[:, None, None]
        xi = x.astype(np.int64)
        rows = xi[:, x0] * (one - ax) + xi[:, x1] * ax
        out = (rows[y0] * (one - ay) + rows[y1] * ay + (1 << 21)) >> 22
        return np.clip(out, 0, 255).astype(np.uint8)
    x = x.astype(np.float32, copy=False)
    wx = fx[None, :, None]
    x = x[:, x0] * (np.float32(1) - wx) + x[:, x1] * wx
    wy = fy[:, None, None]
    return x[y0] * (np.float32(1) - wy) + x[y1] * wy


def _load_rgb(path: str, uint8: bool = False) -> np.ndarray:
    """Decode an RGB PNG or JPEG to (H, W, 3), picking the decoder by the
    file's first bytes as cv2.imread does: gray is repeated, alpha dropped,
    16-bit PNG samples keep their high byte (as cv2's 8-bit color read);
    JPEG is data/jpeg.py, cv2's pixels bit for bit. Any other file raises
    ValueError naming it. uint8=True keeps the 8-bit pixels (the engines'
    images_uint8 frames); else float32 in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        arr = decode_png(data)
    elif data[:2] == b"\xff\xd8":
        arr = decode_jpeg(data)
    else:
        raise ValueError(f"{path}: neither a PNG nor a JPEG file")
    if arr.dtype == np.uint16:
        arr = (arr >> 8).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    rgb = np.ascontiguousarray(arr[..., :3])
    return rgb if uint8 else rgb.astype(np.float32) / 255.0


class StereoDataset:
    """Map-style dataset over a split file. Items are dicts of numpy arrays."""

    def __init__(
        self,
        dataset_path: str,
        dataset_name: str,
        split: str,
        height: int,
        width: int,
        subsplit: str,
        scales: Sequence[int] = (0,),
        do_hflip: bool = False,
        random_crop: bool = False,
        load_disp_left: bool = True,
        load_disp_right: bool = True,
        splits_root: Optional[str] = None,
        seed: int = 123,
        color_uint8: bool = False,
    ):
        self.dataset_path = dataset_path
        self.dataset_name = dataset_name
        self.height = height
        self.width = width
        self.scales = list(scales)
        self.do_hflip = do_hflip
        self.random_crop = random_crop
        self.load_disp_left = load_disp_left
        self.load_disp_right = load_disp_right
        # uint8 colors end to end (the engines' images_uint8 frames are
        # normalized on the device).
        self.color_uint8 = color_uint8
        self._rng = random.Random(seed)

        if splits_root is None:
            splits_root = os.path.join(dataset_path, "splits")
            if not os.path.isdir(os.path.join(splits_root, split)):
                # Fall back to the vendored repo-level splits directory (the
                # reference's committed split manifests — splits/README.md).
                splits_root = default_splits_root()
        self.lines = read_lines(split_lines_path(splits_root, split, subsplit))
        self.load_disp_fn = get_disp_loader(dataset_name)

    def __len__(self) -> int:
        return len(self.lines)

    def _transform(self, rgb_l, rgb_r, disp_l, disp_r):
        h_img, w_img = rgb_l.shape[:2]
        if self.height > h_img or self.width > w_img:
            raise ValueError(
                f"crop {self.height}x{self.width} larger than image {h_img}x{w_img}"
            )
        if self.random_crop:
            i = self._rng.randint(0, h_img - self.height)
            j = self._rng.randint(0, w_img - self.width)
        else:
            i = (h_img - self.height) // 2
            j = (w_img - self.width) // 2

        if self.do_hflip and self._rng.random() < 0.5:
            rgb_l, rgb_r = rgb_r[:, ::-1], rgb_l[:, ::-1]
            if disp_l is not None and disp_r is not None:
                disp_l, disp_r = disp_r[:, ::-1], disp_l[:, ::-1]

        sl = np.s_[i : i + self.height, j : j + self.width]
        crop = lambda x: None if x is None else np.ascontiguousarray(x[sl])
        return crop(rgb_l), crop(rgb_r), crop(disp_l), crop(disp_r)

    def _resolve(self, p: str) -> str:
        # The vendored KITTI-raw manifests carry the original author's
        # absolute paths (/home/milo/datasets/kitti_data_raw/...); rebase any
        # absolute prefix up to and including the dataset directory onto our
        # dataset_path (reference keeps them absolute — stereo_dataset.py:85-87).
        if os.path.isabs(p) and not p.startswith(self.dataset_path):
            marker = "/datasets/"
            if marker in p:
                rel = p.split(marker, 1)[1]          # "<dsname>/<rel path>"
                rel = rel.split("/", 1)[1] if "/" in rel else rel
                return os.path.join(self.dataset_path, rel)
        return os.path.join(self.dataset_path, p)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        paths = [self._resolve(p) for p in self.lines[index].split(" ")]
        rgb_l_path, rgb_r_path, disp_l_path, disp_r_path = paths

        rgb_l = _load_rgb(rgb_l_path, uint8=self.color_uint8)
        rgb_r = _load_rgb(rgb_r_path, uint8=self.color_uint8)
        disp_l = self.load_disp_fn(disp_l_path) if self.load_disp_left else None
        disp_r = self.load_disp_fn(disp_r_path) if self.load_disp_right else None

        rgb_l, rgb_r, disp_l, disp_r = self._transform(rgb_l, rgb_r, disp_l, disp_r)

        out: Dict[str, np.ndarray] = {}
        for s in self.scales:
            if s == 0:
                continue
            hs, ws = self.height // 2 ** s, self.width // 2 ** s
            out[f"color_l/{s}"] = _resize_bilinear(rgb_l, hs, ws)
            out[f"color_r/{s}"] = _resize_bilinear(rgb_r, hs, ws)
            if disp_l is not None:
                out[f"gt_disp_l/{s}"] = _resize_bilinear(disp_l, hs, ws) / 2 ** s
            if disp_r is not None:
                out[f"gt_disp_r/{s}"] = _resize_bilinear(disp_r, hs, ws) / 2 ** s

        out["color_l/0"] = rgb_l
        out["color_r/0"] = rgb_r
        if disp_l is not None:
            out["gt_disp_l/0"] = disp_l
        if disp_r is not None:
            out["gt_disp_r/0"] = disp_r
        return out


def _collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class BatchLoader:
    """Threaded, order-preserving batch loader with bounded prefetch
    (reference train.py:184-188 uses DataLoader worker processes): zlib's
    inflate, data/png.py's unfilter (C through ctypes) and numpy's array
    work release the GIL, so threads overlap the decode of the next
    batches with the step."""

    def __init__(
        self,
        dataset: StereoDataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 123,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        from concurrent.futures import ThreadPoolExecutor

        def load_batch(idxs):
            return _collate([self.dataset[int(i)] for i in idxs])

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: "queue.Queue" = queue.Queue()
            it = iter(batches)
            for _ in range(min(self.prefetch, len(batches))):
                pending.put(pool.submit(load_batch, next(it)))
            while not pending.empty():
                fut = pending.get()
                try:
                    nxt = next(it)
                except StopIteration:
                    nxt = None
                if nxt is not None:
                    pending.put(pool.submit(load_batch, nxt))
                yield fut.result()
