"""StereoNet, and the AE / VAE reconstruction baselines, as PyTorch
nn.Modules (counterpart of adaptive_stereo_tpu/models/)."""

from .autoencoder import (VAE, Autoencoder, ConvolutionalDecoder, ConvolutionalEncoder,
                          autoencoder_state_dict_from_jax, random_autoencoder_init_,
                          reconstruction_error, vae_loss)
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
    "Autoencoder",
    "ConvolutionalDecoder",
    "ConvolutionalEncoder",
    "VAE",
    "autoencoder_state_dict_from_jax",
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
    "random_autoencoder_init_",
    "random_init_",
    "reconstruction_error",
    "resize_bilinear",
    "state_dicts_from_jax",
    "vae_loss",
    "variables_from_state_dicts",
]
