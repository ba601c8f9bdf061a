"""adaptive_stereo_tpu_torch: the PyTorch / CUDA (NVIDIA H100) port of
adaptive_stereo_tpu.

The JAX package beside this one is the reference: every module here mirrors
its counterpart's name and is held against it by the CPU tests
(tests/test_torch_*.py). The port imports torch, numpy and the standard
library only.

Layout (mirrors adaptive_stereo_tpu/):
  ops/         plain PyTorch ops (cost volume, soft-argmin, FCS, warp,
               losses, EMA)
  ops/cuda/    hand-written CUDA kernels for sm_90a (sources in csrc/),
               each with its plain PyTorch version beside it
  models/      StereoNet as nn.Modules with the reference state-dict keys
  serving/     stream-ingest depth engine (eval forward -> depth -> cloud)
  engine/      online adaptation (adapt / done / validate steps, reservoir)

Entry points run on "cuda" unless the caller passes device="cpu"; asking for
CUDA on a machine without it raises.
"""

from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
