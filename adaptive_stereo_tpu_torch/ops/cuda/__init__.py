"""Hand-written CUDA kernels for sm_90a (sources in adaptive_stereo_tpu_torch/csrc/).

Counterparts of adaptive_stereo_tpu/ops/pallas/. Each wrapper takes its
plain PyTorch version for CPU tensors only; on CUDA tensors it launches its
kernel or raises. Each wrapper counts its kernel launches in `.launches`.
Nothing is compiled at import: the library is built at the first CUDA use.
"""

from .aggregation import aggregate_cost_volume_cuda, aggregate_cost_volume_ref
from .coarse_head import coarse_head_cuda, coarse_head_cuda_supported, coarse_head_ref
from .cost_volume import difference_cost_volume_cuda, difference_cost_volume_ref
from .disparity import soft_argmin_fcs_cuda, soft_argmin_fcs_ref
from .tower import tower_backward_cuda, tower_cuda, tower_forward_cuda, tower_ref

__all__ = [
    "aggregate_cost_volume_cuda",
    "aggregate_cost_volume_ref",
    "coarse_head_cuda",
    "coarse_head_cuda_supported",
    "coarse_head_ref",
    "difference_cost_volume_cuda",
    "difference_cost_volume_ref",
    "soft_argmin_fcs_cuda",
    "soft_argmin_fcs_ref",
    "tower_backward_cuda",
    "tower_cuda",
    "tower_forward_cuda",
    "tower_ref",
]
