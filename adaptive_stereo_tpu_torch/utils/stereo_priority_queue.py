"""Bounded min/max-heap replay buffer: a copy of
adaptive_stereo_tpu/utils/stereo_priority_queue.py (pure Python).

Behavioral contract from reference utils/stereo_priority_queue.py:4-56: keeps
the `max_size` best items; once full, a new item replaces the current worst
only if it is strictly better. (Built + tested but not wired into the live
adapt path in the reference — same status here: available as an alternative
OVS policy.)
"""

from __future__ import annotations

import heapq
from typing import Any, List, Set


class StereoPriorityQueue:
    def __init__(self, max_size: int, min_heap: bool = True):
        self.max_size = max_size
        self.buf: List[list] = []
        self.multiplier = 1 if min_heap else -1
        self.min_heap = min_heap
        self.indices: Set[int] = set()

    def add(self, img_l: Any, img_r: Any, value: float, index: int) -> bool:
        if index in self.indices:
            return False
        if len(self.buf) < self.max_size:
            heapq.heappush(self.buf, [self.multiplier * value, index, img_l, img_r])
            self.indices.add(index)
            return True
        largest = heapq.nlargest(1, self.buf)[0]
        if (self.multiplier * value) < largest[0]:
            self.buf.remove(largest)
            self.indices.remove(largest[1])
            heapq.heapify(self.buf)
            heapq.heappush(self.buf, [self.multiplier * value, index, img_l, img_r])
            self.indices.add(index)
            return True
        return False

    def size(self) -> int:
        return len(self.buf)

    def pop(self):
        return heapq.heappop(self.buf)

    def average_value(self) -> float:
        return sum(self.multiplier * item[0] for item in self.buf) / len(self.buf)
