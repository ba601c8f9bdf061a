"""Data layer (counterpart of adaptive_stereo_tpu/data/): split-file
datasets, image and disparity IO (PNG through data/png.py, JPEG through
data/jpeg.py, the EXIF orientation through data/exif.py), the threaded
batch loader, the synthetic dataset generator and the native host library
(data/native.py)."""

from .exif import apply_orientation, exif_orientation
from .io import read_flo, read_float3, read_pfm, write_flo, write_float3, write_pfm
from .native import (pfm_read_native, resize_bilinear_native, u8_to_f32_native,
                     voxel_downsample_native)
from .jpeg import decode_jpeg, encode_jpeg, read_jpeg, write_jpeg
from .loaders import DATASET_BASELINES_M, get_disp_loader, get_intrinsics_normalized
from .png import decode_png, encode_png, read_png, write_png
from .splits import read_lines
from .stereo_dataset import BatchLoader, StereoDataset
from .synthetic import generate_synthetic_dataset

__all__ = [
    "BatchLoader",
    "DATASET_BASELINES_M",
    "StereoDataset",
    "apply_orientation",
    "decode_jpeg",
    "decode_png",
    "encode_jpeg",
    "encode_png",
    "exif_orientation",
    "generate_synthetic_dataset",
    "get_disp_loader",
    "get_intrinsics_normalized",
    "read_flo",
    "read_float3",
    "read_lines",
    "pfm_read_native",
    "read_pfm",
    "read_jpeg",
    "read_png",
    "resize_bilinear_native",
    "u8_to_f32_native",
    "voxel_downsample_native",
    "write_flo",
    "write_float3",
    "write_pfm",
    "write_jpeg",
    "write_png",
]
