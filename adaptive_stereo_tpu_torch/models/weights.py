"""Weights carried across: JAX variables <-> the port's state dicts, and the
reference's .pth pair.

Counterpart of adaptive_stereo_tpu/models/torch_import.py
(export_feature_net_state_dict / export_stereo_net_state_dict, kept here as
an own copy). Layout conversions:
  Conv2d  (kh, kw, I, O)     -> (O, I, kh, kw)
  Conv3d  (kd, kh, kw, I, O) -> (O, I, kd, kh, kw)
  BatchNorm scale/bias + batch_stats mean/var -> weight/bias +
  running_mean/running_var.
The dead BasicBlock conv2 tensors (never applied by the reference forward)
are zero-filled with an identity BatchNorm, so strict loading works.
variables_from_state_dicts is the inverse (the conv2 tensors have no JAX
counterpart and are dropped), which lets the port write the JAX package's
checkpoint container (engine/checkpoint.py).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv2d(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _conv3d(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (4, 3, 0, 1, 2)))


def _put_conv(sd: StateDict, prefix: str, p: dict, conv=_conv2d) -> None:
    sd[f"{prefix}.weight"] = conv(p["kernel"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _put_bn(sd: StateDict, prefix: str, p: dict, st: dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(st["mean"])
    sd[f"{prefix}.running_var"] = _t(st["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _put_basic_block(sd: StateDict, prefix: str, p: dict, st: dict) -> None:
    _put_conv(sd, f"{prefix}.conv1.0.0", p["conv1"]["conv"])
    _put_bn(sd, f"{prefix}.conv1.0.1", p["conv1"]["bn"], st["conv1"]["bn"])
    c = np.asarray(p["conv1"]["conv"]["kernel"]).shape[-1]
    # Dead conv2 (never applied in the reference forward): zeros.
    sd[f"{prefix}.conv2.0.weight"] = torch.zeros((c, c, 3, 3))
    sd[f"{prefix}.conv2.0.bias"] = torch.zeros((c,))
    _put_bn(sd, f"{prefix}.conv2.1",
            {"scale": np.ones(c), "bias": np.zeros(c)},
            {"mean": np.zeros(c), "var": np.ones(c)})


def feature_net_state_dict_from_jax(params: dict, stats: dict, k: int) -> StateDict:
    """FeatureExtractorNetwork state dict from the JAX feature_net
    params / batch_stats."""
    sd: StateDict = {}
    for i in range(k):
        _put_conv(sd, f"downsample.{i}", params[f"downsample_{i}"])
    for i in range(6):
        _put_basic_block(sd, f"residual_blocks.{i}", params[f"residual_{i}"],
                         stats[f"residual_{i}"])
    _put_conv(sd, "conv_alone", params["conv_alone"])
    return sd


def stereo_net_state_dict_from_jax(params: dict, stats: dict) -> StateDict:
    """StereoNet state dict from the JAX stereo_net params / batch_stats."""
    sd: StateDict = {}
    for i in range(4):
        p, st = params[f"filter_{i}"], stats[f"filter_{i}"]
        _put_conv(sd, f"filter.{i}.0.0", p["conv"], _conv3d)
        _put_bn(sd, f"filter.{i}.0.1", p["bn"], st["bn"])
    _put_conv(sd, "conv3d_alone", params["conv3d_alone"], _conv3d)

    ref = "edge_aware_refinements.0"
    rp, rs = params["refinement_0"], stats["refinement_0"]
    _put_conv(sd, f"{ref}.conv2d_feature.0.0", rp["conv2d_feature"]["conv"])
    _put_bn(sd, f"{ref}.conv2d_feature.0.1", rp["conv2d_feature"]["bn"],
            rs["conv2d_feature"]["bn"])
    for i in range(6):
        _put_basic_block(sd, f"{ref}.residual_astrous_blocks.{i}", rp[f"astrous_{i}"],
                         rs[f"astrous_{i}"])
    _put_conv(sd, f"{ref}.conv2d_out", rp["conv2d_out"])
    return sd


def state_dicts_from_jax(variables: dict, k: int) -> Tuple[StateDict, StateDict]:
    """The port's (feature_net, stereo_net) state dicts from the JAX
    StereoModel variables {'params': ..., 'batch_stats': ...}, given as
    nested dicts of numpy arrays."""
    params, stats = variables["params"], variables["batch_stats"]
    return (feature_net_state_dict_from_jax(params["feature_net"],
                                            stats["feature_net"], k),
            stereo_net_state_dict_from_jax(params["stereo_net"], stats["stereo_net"]))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _get_conv(sd: StateDict, prefix: str, perm) -> dict:
    return {"kernel": np.transpose(_np(sd[f"{prefix}.weight"]), perm),
            "bias": _np(sd[f"{prefix}.bias"])}


_CONV2D_TO_JAX = (2, 3, 1, 0)     # (O, I, kh, kw) -> (kh, kw, I, O)
_CONV3D_TO_JAX = (2, 3, 4, 1, 0)  # (O, I, kd, kh, kw) -> (kd, kh, kw, I, O)


def _get_convbn(sd: StateDict, conv: str, bn: str, perm=_CONV2D_TO_JAX):
    """(params, batch_stats) of a conv + BatchNorm pair."""
    params = {"conv": _get_conv(sd, conv, perm),
              "bn": {"scale": _np(sd[f"{bn}.weight"]), "bias": _np(sd[f"{bn}.bias"])}}
    return params, {"bn": {"mean": _np(sd[f"{bn}.running_mean"]),
                           "var": _np(sd[f"{bn}.running_var"])}}


def _get_basic_block(sd: StateDict, prefix: str):
    p, st = _get_convbn(sd, f"{prefix}.conv1.0.0", f"{prefix}.conv1.0.1")
    return {"conv1": p}, {"conv1": st}


def variables_from_state_dicts(feature_sd: StateDict, stereo_sd: StateDict, k: int) -> dict:
    """JAX StereoModel variables {'params': ..., 'batch_stats': ...}, nested
    dicts of float32 numpy arrays, from the port's (feature_net,
    stereo_net) state dicts: the inverse of state_dicts_from_jax."""
    fp, fs = {}, {}
    for i in range(k):
        fp[f"downsample_{i}"] = _get_conv(feature_sd, f"downsample.{i}", _CONV2D_TO_JAX)
    for i in range(6):
        fp[f"residual_{i}"], fs[f"residual_{i}"] = _get_basic_block(
            feature_sd, f"residual_blocks.{i}")
    fp["conv_alone"] = _get_conv(feature_sd, "conv_alone", _CONV2D_TO_JAX)

    sp, ss = {}, {}
    for i in range(4):
        sp[f"filter_{i}"], ss[f"filter_{i}"] = _get_convbn(
            stereo_sd, f"filter.{i}.0.0", f"filter.{i}.0.1", _CONV3D_TO_JAX)
    sp["conv3d_alone"] = _get_conv(stereo_sd, "conv3d_alone", _CONV3D_TO_JAX)
    ref = "edge_aware_refinements.0"
    rp, rs = {}, {}
    rp["conv2d_feature"], rs["conv2d_feature"] = _get_convbn(
        stereo_sd, f"{ref}.conv2d_feature.0.0", f"{ref}.conv2d_feature.0.1")
    for i in range(6):
        rp[f"astrous_{i}"], rs[f"astrous_{i}"] = _get_basic_block(
            stereo_sd, f"{ref}.residual_astrous_blocks.{i}")
    rp["conv2d_out"] = _get_conv(stereo_sd, f"{ref}.conv2d_out", _CONV2D_TO_JAX)
    sp["refinement_0"], ss["refinement_0"] = rp, rs
    return {"params": {"feature_net": fp, "stereo_net": sp},
            "batch_stats": {"feature_net": fs, "stereo_net": ss}}


def load_reference_folder(path: str) -> Tuple[StateDict, StateDict]:
    """The reference's (feature_net.pth, stereo_net.pth) state dicts from a
    weights folder, on the CPU."""
    return tuple(
        torch.load(os.path.join(path, name), map_location="cpu", weights_only=True)
        for name in ("feature_net.pth", "stereo_net.pth"))
