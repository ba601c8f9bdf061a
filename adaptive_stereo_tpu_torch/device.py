"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the torch.device an entry point runs on.

    None means "cuda". A CUDA device on a machine without CUDA raises
    RuntimeError: nothing quietly carries on on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev


def optional_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """Map a compute-dtype name ('float32', 'bfloat16', None) to the model's
    dtype argument (None means float32 compute)."""
    if name in (None, "", "float32"):
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unsupported compute dtype {name!r}")
