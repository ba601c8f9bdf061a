"""Reservoir-sampled online validation set (OVS) buffer: a copy of
adaptive_stereo_tpu/utils/stereo_reservoir.py (pure Python; the port
imports nothing of the JAX package).

Behavioral contract from reference utils/stereo_reservoir.py:5-69 (Algorithm
R with index dedup). Host-side by design: it owns python RNG and stores
device tensors (the images stay on device so OVS validation runs without a
host->device copy).

Determinism: takes an explicit seeded random.Random (reference seeds global
random to 123, adapt.py:28); per-stream instances get per-stream seeds.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, List, Optional, Set


@dataclass
class PreDecision:
    """A reservoir decision drawn BEFORE knowing whether the frame is novel —
    possible because Algorithm R's accept/reject depends only on stream state
    (count, fill, index dedup), never on the frame's score. Used by the fused
    adaptation step, whose on-device OOD gate needs `add` ahead of time."""

    add: bool
    slot: int  # -1 = append; >=0 = replacement index


class StereoReservoir:
    def __init__(self, max_size: int, rng: Optional[random.Random] = None):
        self.max_size = max_size
        self.buf: List[list] = []          # entries: [value, img_index, img_l, img_r]
        self.indices: Set[int] = set()
        self.i = 0                         # items streamed so far
        self._rng = rng if rng is not None else random.Random(123)

    def add(self, img_l: Any, img_r: Any, value: float, img_index: int) -> bool:
        """(Maybe) add an item via Algorithm R. Returns True iff stored.

        Mirrors the reference exactly, including its quirks: the stream
        counter increments before the dedup check, and replacement does NOT
        update the dedup index set (reference stereo_reservoir.py:39-54).
        """
        self.i += 1
        if img_index in self.indices:
            return False
        if len(self.buf) < self.max_size:
            self.buf.append([value, img_index, img_l, img_r])
            self.indices.add(img_index)
            return True
        j = self._rng.randint(1, self.i)
        if j <= self.max_size:
            self.buf[j - 1] = [value, img_index, img_l, img_r]
            return True
        return False

    def pre_decide(self, img_index: int) -> PreDecision:
        """Peek at what add() would do for this index, WITHOUT mutating
        buffer state. Consumes one RNG draw when the buffer is full — even if
        the frame later turns out non-novel and commit() is never applied.
        (The reference draws only on novel-and-full frames; the streams are
        distributionally identical since draws are independent. Documented
        divergence enabling the single-dispatch fused step.)"""
        if img_index in self.indices:
            return PreDecision(add=False, slot=-1)
        if len(self.buf) < self.max_size:
            return PreDecision(add=True, slot=-1)
        j = self._rng.randint(1, self.i + 1)
        if j <= self.max_size:
            return PreDecision(add=True, slot=j - 1)
        return PreDecision(add=False, slot=-1)

    def commit(self, pre: PreDecision, img_l: Any, img_r: Any, value: float,
               img_index: int) -> bool:
        """Apply a pre-drawn decision for a frame that WAS novel. Mirrors
        add()'s mutations (including the no-dedup-update-on-replace quirk)."""
        self.i += 1
        if not pre.add:
            return False
        if pre.slot < 0:
            self.buf.append([value, img_index, img_l, img_r])
            self.indices.add(img_index)
        else:
            self.buf[pre.slot] = [value, img_index, img_l, img_r]
        return True

    def update_value(self, buf_index: int, new_value: float) -> None:
        self.buf[buf_index][0] = new_value

    def size(self) -> int:
        return len(self.buf)

    def average_value(self) -> float:
        return sum(item[0] for item in self.buf) / len(self.buf)
