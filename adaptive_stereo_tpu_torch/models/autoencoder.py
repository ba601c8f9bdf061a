"""Convolutional autoencoder and VAE, the reconstruction-based OOD baselines
(counterpart of adaptive_stereo_tpu/models/autoencoder.py; reference
models/autoencoder.py:5-105 and models/vae.py:24-91, the graveyard
approach that FCS superseded).

Images are NHWC (B, H, W, C) in and out, as everywhere in the port; the
convolutions run NCHW inside. The module and layer order follows the JAX
modules, so autoencoder_state_dict_from_jax carries flax parameters across
by position:
  Conv           (kh, kw, I, O)  -> Conv2d (O, I, kh, kw);
  TorchConvTranspose (k, k, I, O), an lhs-dilated correlation with padding
                 k - 1 - p       -> ConvTranspose2d (I, O, k, k), the same
                 map with the kernel flipped in space;
  Dense          (I, O)          -> Linear (O, I).
The VAE flattens the encoder's output in NHWC order and reshapes fc3's
output as NHWC (JAX :125 and :134-136); so does the port, so fc1 and fc3
carry over without a permutation.

Deviations: the reference ConvolutionalEncoder crashes at construction
(autoencoder.py:40); the port, like JAX, zero-initializes the biases.
random_autoencoder_init_ draws weights from a torch.Generator (lecun
scale, zero biases), not flax's init; the tests carry JAX's parameters
across instead. VAE sampling takes an explicit torch.Generator.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

ENCODER_CHANNELS = (8, 12, 16, 16, 16)
VAE_CHANNELS = (32, 64, 128, 256)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ConvolutionalEncoder(nn.Module):
    """Stride-2 conv pyramid: per stage a 5x5 stride-2 conv and a 5x5 conv,
    each with ReLU, channels 8, 12, 16, 16, ...; then a 3x3 head to
    output_channels (reference autoencoder.py:5-47). NCHW."""

    def __init__(self, output_channels: int, downsample_stages: int, in_channels: int = 3):
        super().__init__()
        layers, c_in = [], in_channels
        for stage in range(downsample_stages):
            c = ENCODER_CHANNELS[min(stage, len(ENCODER_CHANNELS) - 1)]
            layers += [nn.Conv2d(c_in, c, 5, stride=2, padding=2), nn.Conv2d(c, c, 5, padding=2)]
            c_in = c
        layers.append(nn.Conv2d(c_in, output_channels, 3, padding=1))
        self.convs = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs[:-1]:
            x = F.relu(conv(x))
        return self.convs[-1](x)


class ConvolutionalDecoder(nn.Module):
    """Transposed-conv pyramid back to image space: per stage a 6x6 stride-2
    and a 5x5 stride-1 transposed conv (16 channels, ReLU), then a 5x5 conv
    to output_channels and a sigmoid (reference autoencoder.py:50-105).
    NCHW."""

    def __init__(self, output_channels: int, upsample_stages: int, in_channels: int):
        super().__init__()
        layers, c_in = [], in_channels
        for _ in range(upsample_stages):
            layers += [nn.ConvTranspose2d(c_in, 16, 6, stride=2, padding=2),
                       nn.ConvTranspose2d(16, 16, 5, stride=1, padding=2)]
            c_in = 16
        self.transposed = nn.ModuleList(layers)
        self.head = nn.Conv2d(c_in, output_channels, 5, padding=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.transposed:
            x = F.relu(layer(x))
        return torch.sigmoid(self.head(x))


class Autoencoder(nn.Module):
    """Encoder + decoder reconstruction model for OOD scoring:
    forward(x) -> reconstruction, both (B, H, W, C) NHWC."""

    def __init__(self, latent_channels: int = 32, stages: int = 4, image_channels: int = 3):
        super().__init__()
        self.encoder = ConvolutionalEncoder(latent_channels, stages, image_channels)
        self.decoder = ConvolutionalDecoder(image_channels, stages, latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.decoder(self.encoder(_nchw(x))))


class VAE(nn.Module):
    """Vanilla VAE (reference models/vae.py:24-78): four 5x5 stride-2 convs
    (32, 64, 128, 256, ReLU), fc1 / fc2 to mu / logvar (z_dim), fc3 back
    to 256 x (H/16) x (W/16), three 6x6 stride-2 transposed convs (128, 64,
    32, ReLU) and one to image_channels, then a sigmoid.

    forward(x, sample=True, generator=None) -> (reconstruction, mu, logvar),
    x and the reconstruction (B, H, W, C) NHWC. sample=False decodes from
    mu (deterministic, the gate's path); sampling draws its noise from
    `generator`."""

    def __init__(self, z_dim: int = 32, input_height: int = 64, input_width: int = 64,
                 image_channels: int = 3):
        super().__init__()
        self.z_dim, self.input_height, self.input_width = z_dim, input_height, input_width
        chans = (image_channels,) + VAE_CHANNELS
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 5, stride=2, padding=2)
                                   for a, b in zip(chans, chans[1:]))
        h_dim = 256 * (input_height // 16) * (input_width // 16)
        self.fc1 = nn.Linear(h_dim, z_dim)
        self.fc2 = nn.Linear(h_dim, z_dim)
        self.fc3 = nn.Linear(z_dim, h_dim)
        outs = (128, 64, 32, image_channels)
        self.transposed = nn.ModuleList(nn.ConvTranspose2d(a, b, 6, stride=2, padding=2)
                                        for a, b in zip((256,) + outs[:-1], outs))

    def forward(self, x: torch.Tensor, sample: bool = True,
                generator: Optional[torch.Generator] = None):
        b = x.shape[0]
        h = _nchw(x)
        for conv in self.convs:
            h = F.relu(conv(h))
        h = _nhwc(h).reshape(b, -1)
        mu, logvar = self.fc1(h), self.fc2(h)
        if sample:
            noise = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
            z = mu + torch.exp(0.5 * logvar) * noise
        else:
            z = mu
        y = self.fc3(z).reshape(b, self.input_height // 16, self.input_width // 16, 256)
        y = _nchw(y)
        for layer in self.transposed[:-1]:
            y = F.relu(layer(y))
        return _nhwc(torch.sigmoid(self.transposed[-1](y))), mu, logvar


def vae_loss(x_true: torch.Tensor, x_pred: torch.Tensor, mu: torch.Tensor,
             logvar: torch.Tensor, beta_kl: float = 0.001
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """L1 reconstruction + beta-weighted KL to N(0, I) (reference
    vae.py:81-91): (total, l1, beta * kl)."""
    l_re = torch.mean(torch.abs(x_pred - x_true))
    l_kl = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
    return l_re + beta_kl * l_kl, l_re, beta_kl * l_kl


def reconstruction_error(model: nn.Module, variables: Optional[Dict[str, torch.Tensor]],
                         images: torch.Tensor, use_vae: bool = False) -> torch.Tensor:
    """Per-image mean |reconstruction - image| of (B, H, W, C) images under
    `model` with the weights `variables` (a state dict; None: the model's
    own), without gradient; the VAE decodes from mu. Returns (B,)."""
    kwargs = {"sample": False} if use_vae else {}
    with torch.no_grad():
        out = (model(images, **kwargs) if variables is None
               else functional_call(model, variables, (images,), kwargs))
    recon = out[0] if use_vae else out
    return torch.mean(torch.abs(recon - images), dim=(1, 2, 3))


@torch.no_grad()
def random_autoencoder_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Weights of every conv, transposed conv and linear layer of module
    drawn U(-sqrt(3/fan_in), sqrt(3/fan_in)) from generator (variance
    1/fan_in, the scale of flax's lecun_normal; fan_in counts the input
    channels times the kernel's taps), biases zero."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            fan_in = w.shape[0] * w[0, 0].numel() if isinstance(m, nn.ConvTranspose2d) \
                else w[0].numel()
            bound = (3.0 / fan_in) ** 0.5
            w.copy_(torch.empty(w.shape, device=generator.device)
                    .uniform_(-bound, bound, generator=generator))
            m.bias.zero_()
    return module


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(p) -> Tuple[torch.Tensor, torch.Tensor]:
    return _f32(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))), _f32(p["bias"])


def _conv_transpose(p) -> Tuple[torch.Tensor, torch.Tensor]:
    kernel = np.asarray(p["kernel"])[::-1, ::-1]
    return _f32(np.transpose(kernel, (2, 3, 0, 1))), _f32(p["bias"])


def _dense(p) -> Tuple[torch.Tensor, torch.Tensor]:
    return _f32(np.asarray(p["kernel"]).T), _f32(p["bias"])


def _numbered(tree: dict, prefix: str):
    return [tree[f"{prefix}_{i}"] for i in range(sum(k.startswith(f"{prefix}_") for k in tree))]


def autoencoder_state_dict_from_jax(params: dict, kind: str = "ae") -> Dict[str, torch.Tensor]:
    """The state dict of the port's Autoencoder (kind "ae") or VAE ("vae")
    from the flax parameters of the JAX module of the same configuration
    (variables["params"])."""
    sd: Dict[str, torch.Tensor] = {}

    def put(name, pair):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = pair

    if kind == "ae":
        enc, dec = params["encoder"], params["decoder"]
        for i, p in enumerate(_numbered(enc, "Conv")):
            put(f"encoder.convs.{i}", _conv(p))
        for i, p in enumerate(_numbered(dec, "TorchConvTranspose")):
            put(f"decoder.transposed.{i}", _conv_transpose(p))
        put("decoder.head", _conv(dec["Conv_0"]))
    elif kind == "vae":
        for i, p in enumerate(_numbered(params, "Conv")):
            put(f"convs.{i}", _conv(p))
        for name in ("fc1", "fc2", "fc3"):
            put(name, _dense(params[name]))
        for i, p in enumerate(_numbered(params, "TorchConvTranspose")):
            put(f"transposed.{i}", _conv_transpose(p))
    else:
        raise ValueError(f"unknown autoencoder kind {kind!r}: 'ae' or 'vae'")
    return sd
