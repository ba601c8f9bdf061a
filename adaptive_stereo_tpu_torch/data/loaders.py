"""Per-dataset disparity loaders and camera metadata (counterpart of
adaptive_stereo_tpu/data/loaders.py:19-92). The 16-bit PNGs of KITTI and
VKITTI are decoded by data/png.py, SceneFlow's PFMs by the native host
library (data/native.py pfm_read_native, as the JAX loader when its library
is built; the port has no fallback to data/io.py's numpy reader).

Behavioral contract from reference adaptive_stereo/utils/dataset_utils.py:26-57
and datasets/stereo_dataset.py:147-184:
- SceneFlow*: PFM disparity.
- KittiStereo2012/2015: uint16 PNG / 256.
- KittiRaw: npy / 128 (produced by scripts/export_gt_disp.py).
- VirtualKitti: 16-bit depth PNG in centimeters -> disparity = b*f/z
  (b = 0.532725 m, f = 725.0087 px).

The JAX loaders read VKITTI depth with cv2.imread, which applies the EXIF
Orientation tag, and KITTI disparity with imageio, which does not; so
load_disp_vkitti applies it (data/exif.py) and load_disp_kitti_stereo
does not.

All loaders return float32 (H, W, 1) numpy arrays (NHWC channel-last).
"""

from __future__ import annotations

import numpy as np

from .exif import apply_orientation, exif_orientation
from .native import pfm_read_native
from .png import decode_png, read_png


def load_disp_sceneflow(path: str) -> np.ndarray:
    data, _scale = pfm_read_native(path)
    if data.ndim == 3:
        data = data[..., 0]
    return data.astype(np.float32)[..., None]


def load_disp_kitti_stereo(path: str) -> np.ndarray:
    return (read_png(path).astype(np.float32) / 256.0)[..., None]


def load_disp_kitti_raw(path: str) -> np.ndarray:
    return (np.load(path).astype(np.float32) / 128.0)[..., None]


VKITTI_BASELINE_M = 0.532725
VKITTI_FOCAL_PX = 725.0087


def load_disp_vkitti(path: str) -> np.ndarray:
    """VKITTI stores depth (cm) as 16-bit PNG; convert to disparity."""
    with open(path, "rb") as f:
        data = f.read()
    depth_m = 0.01 * apply_orientation(decode_png(data), exif_orientation(data))
    return (VKITTI_BASELINE_M * VKITTI_FOCAL_PX / depth_m).astype(np.float32)[..., None]


def load_disp_npy(path: str) -> np.ndarray:
    """Raw float npy disparity (synthetic test datasets)."""
    d = np.load(path).astype(np.float32)
    return d[..., None] if d.ndim == 2 else d


_LOADERS = {
    "SceneFlowDriving": load_disp_sceneflow,
    "SceneFlowFlying": load_disp_sceneflow,
    "SceneFlowMonkaa": load_disp_sceneflow,
    "KittiStereo2015": load_disp_kitti_stereo,
    "KittiStereo2012": load_disp_kitti_stereo,
    "KittiRaw": load_disp_kitti_raw,
    "VirtualKitti": load_disp_vkitti,
    "Synthetic": load_disp_npy,
}


def get_disp_loader(dataset_name: str):
    return _LOADERS[dataset_name]


DATASET_BASELINES_M = {
    "KittiStereo2012": 0.54,
    "KittiStereo2015": 0.54,
    "KittiRaw": 0.54,
    "SceneFlowFlying": 1.0,
    "SceneFlowMonkaa": 1.0,
    "SceneFlowDriving": 1.0,
    "VirtualKitti": VKITTI_BASELINE_M,
    "Synthetic": 0.54,
}


def get_intrinsics_normalized(dataset_name: str) -> np.ndarray:
    """Normalized K (multiply row 0 by width, row 1 by height) — reference
    stereo_dataset.py:159-178."""
    if dataset_name in ("KittiStereo2012", "KittiStereo2015", "KittiRaw", "Synthetic"):
        return np.array(
            [[0.5885, 0.0, 0.4972], [0.0, 1.9501, 0.4972], [0.0, 0.0, 1.0]], np.float32
        )
    if "SceneFlow" in dataset_name:
        return np.array(
            [[1.09375, 0.0, 0.5], [0.0, 1.94444, 0.5], [0.0, 0.0, 1.0]], np.float32
        )
    raise NotImplementedError(f"no intrinsics for {dataset_name}")
