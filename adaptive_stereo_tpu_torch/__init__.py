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
  engine/      supervised training, the classic and the streaming
               adaptation engines (steps, reservoirs, drivers), eval,
               offline inference tools, config, train state, checkpoints
  data/        datasets, loaders, PNG / PFM IO, the synthetic generator
  utils/       console banners, run provenance, trials.csv, the OVS
               reservoir and priority queue, the disparity colormap
  parallel/    torch.distributed scale-out: the mesh, the fleet
               adaptation step and driver (N streams, one shared model),
               the data-parallel supervised step
  analysis/    the timing benchmark
  experiments.py  the reference's named experiment configurations
  cli.py       `python -m adaptive_stereo_tpu_torch.cli train | adapt |
               evaluate | timing`

Entry points run on "cuda" unless the caller passes device="cpu"; asking for
CUDA on a machine without it raises.
"""

from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
