"""Build and load the port's CUDA kernel library.

All sources under adaptive_stereo_tpu_torch/csrc/ are compiled by ONE nvcc
command for sm_90a into a plain-C shared library, which ctypes loads:

    nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a \
         -Xcompiler -fPIC -shared -o libstereo_kernels_<hash>.so csrc/*.cu

No PyTorch headers and no torch.utils.cpp_extension: the C entry points take
raw device pointers and the CUDA stream as void*, and return the launch's
cudaGetLastError() as an int. The library is named by a hash of the sources
and the flags, and written to adaptive_stereo_tpu_torch/_build/ (git-ignored);
an existing library with the same hash is loaded without rebuilding.

Nothing here runs at import: the build happens at the first CUDA use of a
kernel (or when chip_smoke.py asks for it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-shared")

# Storage-type codes of csrc/common.cuh (enum StereoDType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point: pointers and the stream as c_void_p, so
# ctypes never truncates a 64-bit address to a 32-bit int.
_SIGNATURES = {
    "stereo_cost_volume_forward": [_P] * 3 + [_I] * 6 + [_P],
    "stereo_cost_volume_backward": [_P] * 3 + [_I] * 6 + [_P],
    "stereo_noop": [_P],
    "stereo_conv3d_bn_leaky_forward": [_P] * 8 + [_I] * 8 + [_F, _F, _I, _P],
    "stereo_conv3d_stats_forward": [_P] * 5 + [_I] * 8 + [_P],
    "stereo_bn_stats_finalize": [_P, _I, _I, _I, _P, _P, _P],
    "stereo_bn_leaky_apply": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _P],
    "stereo_soft_argmin_fcs_forward": [_P, _P, _P, _I, _I, _I, _P],
    "stereo_soft_argmin_backward": [_P] * 4 + [_I] * 3 + [_P],
    "stereo_coarse_head_forward": [_P] * 18 + [_I] * 9 + [_F, _F, _I, _P],
    "stereo_tower_conv": [_P] * 15 + [_I] * 8 + [_F, _I, _P],
    "stereo_tower_grad_y": [_P] * 9 + [_I] * 2 + [_F, _I, _P],
    "stereo_tower_wgrad": [_P] * 3 + [_I] * 8 + [_P],
    "stereo_tower_sums": [_P, _I, _I, _P, _P, _I, _I, _P, _P],
    "stereo_tower_stats": [_P, _I, _I, _P, _P, _P],
}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, /usr/local/cuda/bin, or PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin or PATH")
    return found


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Path of the library for the current sources and flags."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libstereo_kernels_{h.hexdigest()[:16]}.so"


def ptxas_report_path() -> Path:
    """Where build(verbose=True) keeps nvcc's -Xptxas -v report."""
    return library_path().with_suffix(".ptxas.txt")


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the shared library unless it exists already.
    Returns its path; raises RuntimeError with nvcc's stderr on failure.
    verbose adds -Xptxas -v (registers, shared memory and spills of every
    kernel), prints nvcc's report and keeps it beside the library in
    ptxas_report_path()."""
    out = library_path()
    if out.exists():
        return out
    cu, _ = _sources()
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, cu)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    if verbose:
        ptxas_report_path().write_text(proc.stderr)
        print(proc.stderr, end="", flush=True)
        print(f"built {out.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name} failed with CUDA error {status}")


def stream_of(t: torch.Tensor) -> int:
    """The raw cudaStream_t of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_aligned(t: torch.Tensor, name: str, nbytes: int = 16) -> None:
    """Refuse a tensor whose data does not start on an nbytes boundary: the
    conv kernels stage it in 16-byte chunks (cp.async)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name} must start on a {nbytes}-byte boundary")


def require_cuda(t: torch.Tensor, name: str, dtypes=None,
                 shape: Optional[tuple] = None) -> None:
    """Validate a tensor handed to a kernel: on CUDA, contiguous, of an
    accepted dtype and (optionally) of the given shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtypes is not None and t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {list(dtypes)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
