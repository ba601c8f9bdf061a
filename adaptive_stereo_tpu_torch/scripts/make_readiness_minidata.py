"""Write mini on-disk datasets at the vendored split-manifest paths, so the
paper suite runs through the real file loaders (counterpart of
scripts/make_readiness_minidata.py).

For each split this script reads the vendored manifest
(splits/<split>/<subsplit>_lines.txt, the files a real dataset mount
uses), takes the first N lines, and writes synthetic but consistent stereo
frames at those relative paths in the reference's on-disk formats:

  SceneFlow:     PNG RGB pairs + PFM disparities (data/png.py, data/io.py)
  VirtualKitti:  JPEG RGB pairs (data/jpeg.py, quality 75, 4:2:0, as
                 imageio writes them) + 16-bit depth PNGs in centimetres
                 (disp = baseline * focal / z; reference
                 dataset_utils.py:38-47)
  KittiRaw:      JPEG RGB pairs + npy disparities scaled x128 (reference
                 dataset_utils.py:34-35); the manifests' absolute
                 /home/milo/datasets/... paths are rebased as the dataset
                 layer rebases them (data/stereo_dataset.py _resolve)

and random initial weights for both source models (engine/checkpoint.py
save_variables).

Usage:
  python -m adaptive_stereo_tpu_torch.scripts.make_readiness_minidata \\
      --out /tmp/readiness_data [--frames 96]

make_minidata(out, frames, height, width, environments) writes other frame
sizes, or only the splits that some environments read.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Sequence

import numpy as np

from ..data.io import write_pfm
from ..data.jpeg import write_jpeg
from ..data.png import write_png
from ..data.splits import default_splits_root, read_lines, split_lines_path
from ..data.synthetic import make_stereo_pair
from ..experiments import ADAPTATION_ENVIRONMENTS, SOURCE_DOMAINS

H, W = 64, 96
# VKITTI intrinsics (reference dataset_utils.py:44-45).
VK_BF = 0.532725 * 725.0087

# (root, split, subsplits, disparity format, seed), in the JAX script's order.
SPLITS = (
    ("sceneflow", "sceneflow_flying_er_1000", ("val",), "pfm", 1),
    ("vkitti", "virtual_kitti_01_adapt", ("train", "val"), "vkitti_depth", 2),
    ("vkitti", "virtual_kitti_fog", ("train", "val"), "vkitti_depth", 3),
    ("vkitti", "virtual_kitti_clone_er_1000", ("val",), "vkitti_depth", 4),
    ("vkitti", "virtual_kitti_20_adapt", ("train", "val"), "vkitti_depth", 7),
    ("vkitti", "virtual_kitti_rain", ("train", "val"), "vkitti_depth", 8),
    ("kitti_raw", "kitti_raw_campus_adapt", ("train", "val"), "kitti_npy", 9),
    ("kitti_raw", "kitti_raw_city_adapt", ("train", "val"), "kitti_npy", 10),
    ("kitti_raw", "kitti_raw_road_adapt", ("train", "val"), "kitti_npy", 11),
)


def _frames(split: str, subsplits, n: int):
    """Unique (rgb_l, rgb_r, disp_l, disp_r) relative-path tuples from the
    first n lines of each vendored subsplit manifest."""
    seen = {}
    for subsplit in subsplits:
        path = split_lines_path(default_splits_root(), split, subsplit)
        for line in read_lines(path)[:n]:
            parts = tuple(line.split(" "))
            seen[parts[0]] = parts
    return list(seen.values())


def _write_rgb(path: str, img: np.ndarray):
    """An RGB frame in [0, 1] as 8-bit PNG or JPEG, by the path's suffix."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pixels = (np.clip(img, 0, 1) * 255).round().astype(np.uint8)
    suffix = os.path.splitext(path)[1].lower()
    if suffix == ".png":
        write_png(path, pixels)
    elif suffix in (".jpg", ".jpeg"):
        write_jpeg(path, pixels, quality=75, subsampling="4:2:0")
    else:
        raise ValueError(f"no image writer for {path}")


def _rebase(root: str, p: str) -> str:
    """Mirror data/stereo_dataset.py:_resolve for absolute manifest paths."""
    if os.path.isabs(p):
        marker = "/datasets/"
        if marker in p:
            rel = p.split(marker, 1)[1]
            rel = rel.split("/", 1)[1] if "/" in rel else rel
            return os.path.join(root, rel)
    return os.path.join(root, p)


def materialize_split(root: str, split: str, subsplits, n: int, disp_format: str, seed: int,
                      height: int = H, width: int = W) -> int:
    rng = np.random.RandomState(seed)
    frames = _frames(split, subsplits, n)
    for rgb_l, rgb_r, d_l, d_r in frames:
        left, right, dl, dr = make_stereo_pair(rng, height, width, max_disp=16.0)
        _write_rgb(_rebase(root, rgb_l), left)
        _write_rgb(_rebase(root, rgb_r), right)
        for rel, disp in ((d_l, dl), (d_r, dr)):
            out = _rebase(root, rel)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            if disp_format == "pfm":
                write_pfm(out, disp.astype(np.float32))
            elif disp_format == "vkitti_depth":
                depth_cm = np.clip(100.0 * VK_BF / np.maximum(disp, 1e-3),
                                   1, 65000).astype(np.uint16)
                write_png(out, depth_cm)
            elif disp_format == "kitti_npy":
                # KITTI-raw contract: npy scaled x128 (dataset_utils.py:34-35).
                np.save(out, (disp * 128.0).astype(np.float32))
            else:
                raise ValueError(disp_format)
    print(f"  {split}: {len(frames)} frames under {root}")
    return len(frames)


def make_weights(folder: str, seed: int):
    """Random StereoNet weights (k=4, s=0, maxdisp 192) from a generator
    seeded with `seed`, saved in the container both packages load."""
    import torch

    from ..engine.checkpoint import save_variables
    from ..models import StereoModel, random_init_, variables_from_state_dicts

    model = random_init_(StereoModel(k=4, input_scale=0, maxdisp=192, device="cpu"),
                         torch.Generator().manual_seed(seed))
    variables = variables_from_state_dicts(model.feature_net.state_dict(),
                                           model.stereo_net.state_dict(), 4)
    save_variables(folder, variables, {"note": "readiness-drill init (untrained)"})
    print(f"  weights: {folder}")


def needed_splits(environments: Sequence[str]):
    """The split names the adaptation and replay of `environments` read."""
    names = set()
    for env in environments:
        spec = ADAPTATION_ENVIRONMENTS[env]
        names.add(spec["split"])
        names.add(SOURCE_DOMAINS[spec["source"]]["train_split"])
    return names


def make_minidata(out: str, frames: int, height: int = H, width: int = W,
                  environments: Sequence[str] = tuple(ADAPTATION_ENVIRONMENTS)) -> None:
    """Write `frames` pairs of each split that `environments` read, at
    height x width, and both source models' weights, under `out`."""
    wanted = needed_splits(environments)
    print("Materializing mini datasets at vendored-manifest paths:")
    for root, split, subsplits, disp_format, seed in SPLITS:
        if split in wanted:
            materialize_split(os.path.join(out, root), split, subsplits, frames, disp_format,
                              seed, height, width)
    make_weights(os.path.join(out, "weights", "sf"), seed=5)
    make_weights(os.path.join(out, "weights", "vk"), seed=6)
    print("Done.")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=96)
    args = ap.parse_args(argv)
    make_minidata(args.out, args.frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
