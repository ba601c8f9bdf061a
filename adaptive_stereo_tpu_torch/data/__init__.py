"""Data layer (counterpart of adaptive_stereo_tpu/data/): split-file
datasets, image and disparity IO (PNG through data/png.py), the threaded
batch loader and the synthetic dataset generator."""

from .io import read_flo, read_float3, read_pfm, write_flo, write_float3, write_pfm
from .loaders import DATASET_BASELINES_M, get_disp_loader, get_intrinsics_normalized
from .png import decode_png, encode_png, read_png, write_png
from .splits import read_lines
from .stereo_dataset import BatchLoader, StereoDataset
from .synthetic import generate_synthetic_dataset

__all__ = [
    "BatchLoader",
    "DATASET_BASELINES_M",
    "StereoDataset",
    "decode_png",
    "encode_png",
    "generate_synthetic_dataset",
    "get_disp_loader",
    "get_intrinsics_normalized",
    "read_flo",
    "read_float3",
    "read_lines",
    "read_pfm",
    "read_png",
    "write_flo",
    "write_float3",
    "write_pfm",
    "write_png",
]
