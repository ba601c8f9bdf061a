"""Stream-ingest stereo depth serving engine.

Counterpart of adaptive_stereo_tpu/serving/stream.py (the reference ROS node,
ros/stereo_depth_node.py:113-197): per synchronized stereo pair, one
eval-mode StereoNet forward, then disparity -> depth -> voxelized coloured
point cloud. The forward and the resizes to the voxel scale run on the
device (F.interpolate, bilinear, align_corners=False); the geometry is
numpy.

ServingConfig.fused_coarse_head selects the model's coarse head: the fused
CUDA kernel, or the three kernels in turn (the default). Unlike the JAX
engine, which takes the fused head on a TPU backend only, the port runs the
fused kernel on CUDA whenever the config asks for it.

Not ported yet: the on_disparity colormap callback (raises
NotImplementedError), the flax msgpack checkpoint and the native voxel
grid.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, optional_dtype, resolve_device
from ..models import StereoModel, load_reference_folder

Weights = Union[str, Tuple[dict, dict], None]


def disparity_to_depth(disp: np.ndarray, fx: float, baseline_m: float,
                       max_depth: float = 100.0) -> np.ndarray:
    """depth = fx * b / disp, clamped to [0, max_depth] (reference :159-160)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        depth = fx * baseline_m / disp
    return np.clip(np.nan_to_num(depth, posinf=max_depth), 0.0, max_depth)


def depth_to_pointcloud(depth: np.ndarray, k_mat: np.ndarray,
                        color: Optional[np.ndarray] = None,
                        depth_trunc: float = 80.0) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Backproject a depth image to camera-frame points (N, 3) (+colors)."""
    h, w = depth.shape[:2]
    fx, fy = k_mat[0, 0], k_mat[1, 1]
    cx, cy = k_mat[0, 2], k_mat[1, 2]
    ys, xs = np.mgrid[0:h, 0:w]
    z = depth.reshape(-1)
    valid = (z > 0) & (z < depth_trunc)
    z = z[valid]
    x = (xs.reshape(-1)[valid] - cx) * z / fx
    y = (ys.reshape(-1)[valid] - cy) * z / fy
    pts = np.stack([x, y, z], axis=-1)
    cols = color.reshape(-1, 3)[valid] if color is not None else None
    return pts, cols


def voxel_downsample(points: np.ndarray, voxel_size: float,
                     colors: Optional[np.ndarray] = None):
    """Average points (and colors) within each voxel (replaces
    open3d.geometry.voxel_down_sample, reference :184)."""
    if len(points) == 0:
        return points, colors
    keys = np.floor(points / voxel_size).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)
    n_vox = counts.shape[0]
    sums = np.zeros((n_vox, 3), np.float64)
    np.add.at(sums, inverse, points)
    out_pts = (sums / counts[:, None]).astype(np.float32)
    out_cols = None
    if colors is not None:
        csum = np.zeros((n_vox, 3), np.float64)
        np.add.at(csum, inverse, colors)
        out_cols = (csum / counts[:, None]).astype(np.float32)
    return out_pts, out_cols


@dataclass
class _Pending:
    """One dispatched frame: host copies of the results, and the CUDA event
    that marks them complete (None on the CPU)."""

    disp: torch.Tensor
    disp_v: torch.Tensor
    color_v: Optional[torch.Tensor]
    event: Optional[torch.cuda.Event]
    timestamp: float


class StereoDepthEngine:
    """Synchronous serving loop: call process(left, right) per frame.

    weights: a (feature_net, stereo_net) pair of reference-layout state
    dicts, or a folder holding feature_net.pth / stereo_net.pth; None reads
    config.load_weights_folder.
    on_pointcloud(points_n3, colors_n3, timestamp) is called per frame.
    device: "cuda" unless the caller passes "cpu".
    """

    def __init__(self, config, weights: Weights = None,
                 on_disparity: Optional[Callable] = None,
                 on_pointcloud: Optional[Callable] = None,
                 device: DeviceLike = None):
        if on_disparity is not None:
            raise NotImplementedError(
                "on_disparity needs the disparity colormap, which is not ported yet")
        self.config = config
        self.on_pointcloud = on_pointcloud
        self.device = resolve_device(device)

        if weights is None:
            weights = config.load_weights_folder
        if isinstance(weights, str):
            if not weights:
                raise ValueError("no weights: pass a state-dict pair or a weights folder")
            weights = load_reference_folder(weights)
        self.model = StereoModel(
            k=config.stereonet_k, input_scale=config.input_scale,
            dtype=optional_dtype(config.compute_dtype), device=self.device,
            fused_coarse_head=config.fused_coarse_head,
        ).load_state_dicts(*weights).eval()
        self._disp_key = f"pred_disp_l/{config.input_scale}"

        # Intrinsics at the voxel pyramid scale (reference :98-101).
        self.k_voxel = config.camera_intrinsics.copy()
        self.k_voxel[0] /= 2 ** config.voxel_disp_scale
        self.k_voxel[1] /= 2 ** config.voxel_disp_scale
        self.last_inference_sec = None

    def _to_device(self, rgb: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(rgb, np.float32)[None]).to(self.device)

    @torch.inference_mode()
    def _dispatch(self, left_rgb: np.ndarray, right_rgb: np.ndarray,
                  timestamp: float) -> _Pending:
        """Enqueue the forward and the voxel-scale resizes; start the copies
        to the host. Returns without waiting for the device."""
        left = self._to_device(left_rgb)
        disp = self.model(left, self._to_device(right_rgb))[self._disp_key]  # (1,H,W,1)
        disp = disp.permute(0, 3, 1, 2)
        vs = 2 ** self.config.voxel_disp_scale
        size = (disp.shape[2] // vs, disp.shape[3] // vs)
        # Disparity VALUES keep the full-res convention; the voxel
        # intrinsics were scaled instead (reference :145-150,159).
        disp_v = F.interpolate(disp, size=size, mode="bilinear", align_corners=False)
        color_v = None
        if self.config.publish_color_point_cloud:
            color_v = F.interpolate(left.permute(0, 3, 1, 2), size=size, mode="bilinear",
                                    align_corners=False).permute(0, 2, 3, 1)
        outs = [disp[0, 0], disp_v[0, 0], None if color_v is None else color_v[0]]
        event = None
        if self.device.type == "cuda":
            host = []
            for t in outs:
                if t is None:
                    host.append(None)
                    continue
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                host.append(buf)
            outs = host
            event = torch.cuda.Event()
            event.record()
        return _Pending(*outs, event, timestamp)

    def _collect(self, p: _Pending) -> Dict[str, np.ndarray]:
        """Wait for a dispatched frame and run the host geometry."""
        if p.event is not None:
            p.event.synchronize()
        cfg = self.config
        disp = p.disp.numpy()
        depth = disparity_to_depth(p.disp_v.numpy(), self.k_voxel[0, 0],
                                   cfg.stereo_baseline_meters, cfg.max_depth)
        color_v = None if p.color_v is None else p.color_v.numpy()
        pts, cols = depth_to_pointcloud(depth, self.k_voxel, color_v)
        pts, cols = voxel_downsample(pts, cfg.voxel_scale_meters, cols)
        if self.on_pointcloud is not None:
            self.on_pointcloud(pts, cols, p.timestamp)
        return {"disparity": disp, "depth": depth, "points": pts, "colors": cols}

    def process(self, left_rgb: np.ndarray, right_rgb: np.ndarray,
                timestamp: Optional[float] = None) -> Dict[str, np.ndarray]:
        """Process one synchronized pair (H, W, 3) float in [0, 1].

        Returns {'disparity': (H, W), 'depth': (h_v, w_v), 'points': (N, 3),
        'colors': (N, 3) | None}.
        """
        _check_rgb(left_rgb, right_rgb)
        ts = time.time() if timestamp is None else timestamp
        t0 = time.perf_counter()
        pending = self._dispatch(left_rgb, right_rgb, ts)
        if pending.event is not None:
            pending.event.synchronize()
        self.last_inference_sec = time.perf_counter() - t0
        return self._collect(pending)


class AsyncStereoDepthEngine(StereoDepthEngine):
    """Pipelined variant: submit(left, right) enqueues this frame's forward
    and returns the PREVIOUS frame's result, whose device work (enqueued
    earlier on the same stream) is complete or nearly so. One frame of
    latency; the host geometry of frame n overlaps the device forward of
    frame n + 1. Call flush() for the last frame.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pending: Optional[_Pending] = None

    def submit(self, left_rgb: np.ndarray, right_rgb: np.ndarray,
               timestamp: Optional[float] = None):
        """Dispatch this frame; return the completed previous frame's result
        (None on the first call)."""
        _check_rgb(left_rgb, right_rgb)
        ts = time.time() if timestamp is None else timestamp
        prev, self._pending = self._pending, self._dispatch(left_rgb, right_rgb, ts)
        return None if prev is None else self._collect(prev)

    def flush(self):
        prev, self._pending = self._pending, None
        return None if prev is None else self._collect(prev)


def _check_rgb(left_rgb: np.ndarray, right_rgb: np.ndarray) -> None:
    for name, img in (("left", left_rgb), ("right", right_rgb)):
        if img.min() < 0 or img.max() > 1.0:
            raise ValueError(f"{name} image must be float in [0, 1]")
