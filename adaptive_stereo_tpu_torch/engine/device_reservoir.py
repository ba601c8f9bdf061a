"""Device-resident reservoir (online validation set): Algorithm R on tensors.

Counterpart of adaptive_stereo_tpu/engine/device_reservoir.py. The whole
reservoir lives on the device, and an add decides on the device too
(torch.where, tensor indices), so the adaptation step reads nothing back.

Semantics mirror the reference's reservoir (utils/stereo_reservoir.py:5-69)
with its quirks:
  - the dedup registry records only appended indices (replacements do not
    register), so it is bounded by the capacity;
  - the stream counter increments on every add() call (here: every novel
    frame), before the dedup check.
Divergence (documented, as in the JAX module): the random draws come from a
torch.Generator on the reservoir's device, not python's random: the same
distribution, another stream of numbers. Unlike the JAX module, which
returns a new reservoir, reservoir_maybe_add updates the tensors in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import torch

from ..device import DeviceLike, resolve_device


@dataclass
class DeviceReservoir:
    left: torch.Tensor         # (cap, H, W, C) float32
    right: torch.Tensor        # (cap, H, W, C) float32
    values: torch.Tensor       # (cap,) float32 per-item loss values
    reg_indices: torch.Tensor  # (cap,) int32 dedup registry (-1 = empty)
    size: torch.Tensor         # () int32 current fill
    count: torch.Tensor        # () int32 add() calls so far (novel frames)
    generator: torch.Generator


def init_device_reservoir(capacity: int, h: int, w: int, c: int = 3, seed: int = 123,
                          device: DeviceLike = None) -> DeviceReservoir:
    dev = resolve_device(device)
    return DeviceReservoir(
        left=torch.zeros((capacity, h, w, c), dtype=torch.float32, device=dev),
        right=torch.zeros((capacity, h, w, c), dtype=torch.float32, device=dev),
        values=torch.zeros(capacity, dtype=torch.float32, device=dev),
        reg_indices=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        size=torch.zeros((), dtype=torch.int32, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        generator=torch.Generator(device=dev).manual_seed(seed),
    )


def reservoir_maybe_add(res: DeviceReservoir, left_img: torch.Tensor, right_img: torch.Tensor,
                        value: torch.Tensor, img_index: Union[int, torch.Tensor],
                        novel: torch.Tensor) -> Tuple[DeviceReservoir, torch.Tensor]:
    """One gated Algorithm-R add of a (1, H, W, C) or (H, W, C) pair, in
    place. Only novel frames reach add(). Returns (res, did_add)."""
    if left_img.dim() == 4:
        left_img, right_img = left_img[0], right_img[0]
    cap = res.values.shape[0]
    new_count = res.count + novel.to(torch.int32)
    dup = (res.reg_indices == img_index).any()
    not_full = res.size < cap
    # j = randint(1, count) after the increment, drawn unconditionally (and
    # masked out when unused): floor(u * n) + 1 for u uniform in [0, 1).
    u = torch.rand((), generator=res.generator, device=res.values.device, dtype=torch.float64)
    n = torch.clamp(new_count, min=1).to(torch.float64)
    j = (torch.floor(u * n) + 1).to(torch.int64)
    do_append = novel & ~dup & not_full
    do_replace = novel & ~dup & ~not_full & (j <= cap)
    did_add = do_append | do_replace
    slot = torch.where(do_append, res.size.to(torch.int64), j - 1).clamp(0, cap - 1).view(1)

    def write(buf, item):
        old = buf.index_select(0, slot)
        buf.index_copy_(0, slot, torch.where(did_add, item.to(buf.dtype)[None], old))

    write(res.left, left_img)
    write(res.right, right_img)
    write(res.values, value.detach().reshape(()))
    # The registry records appends only (reference quirk, stereo_reservoir.py:53).
    old = res.reg_indices.index_select(0, slot)
    index = torch.as_tensor(img_index, dtype=torch.int32, device=old.device).view(1)
    res.reg_indices.index_copy_(0, slot, torch.where(do_append, index, old))
    res.size.add_(do_append.to(torch.int32))
    res.count.copy_(new_count)
    return res, did_add


def reservoir_average_value(res: DeviceReservoir) -> torch.Tensor:
    """Mean value over the filled slots (0 if empty)."""
    cap = res.values.shape[0]
    mask = (torch.arange(cap, device=res.values.device) < res.size).float()
    return (res.values * mask).sum() / torch.clamp(res.size.float(), min=1.0)


def reservoir_set_values(res: DeviceReservoir, new_values: torch.Tensor) -> DeviceReservoir:
    """Replace the per-slot values (after a batched validation), in place."""
    res.values.copy_(new_values)
    return res
