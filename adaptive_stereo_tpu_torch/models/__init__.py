"""StereoNet as PyTorch nn.Modules (counterpart of adaptive_stereo_tpu/models/)."""

from .aggregation import aggregation_args, apply_aggregation, apply_coarse_head
from .stereo_net import (
    BasicBlock,
    EdgeAwareRefinement,
    FeatureExtractorNetwork,
    StereoModel,
    StereoNet,
    build_model,
    coarse_num_disparities,
    random_init_,
    resize_bilinear,
)
from .weights import load_reference_folder, state_dicts_from_jax, variables_from_state_dicts

__all__ = [
    "BasicBlock",
    "EdgeAwareRefinement",
    "FeatureExtractorNetwork",
    "StereoModel",
    "StereoNet",
    "aggregation_args",
    "apply_aggregation",
    "apply_coarse_head",
    "build_model",
    "coarse_num_disparities",
    "load_reference_folder",
    "random_init_",
    "resize_bilinear",
    "state_dicts_from_jax",
    "variables_from_state_dicts",
]
