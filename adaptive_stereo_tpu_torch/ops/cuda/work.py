"""The work of the kernels' launches, for analysis/profiling.py cost_analysis.

The kernels are called through ctypes, so no dispatch mode (FlopCounterMode,
a byte counter) sees them. While a count is open (counting()), each wrapper
adds, when it launches its kernel, the flops of the plain version it
replaces as FlopCounterMode counts them (2 x multiply-adds over the full
window of each convolution; 0 for the cost volume and the soft-argmin,
whose plain versions hold no product) and the bytes its launches read and
write. On CPU tensors the wrappers take their plain versions, whose aten
ops are counted by the modes themselves, and add nothing.

A backward that recomputes the plain forward to take its gradient (the
aggregation stack's and the fused coarse head's) runs that recompute under
uncounted(): the count is the work of the plain path, forward once and
backward once, whatever a backward recomputes.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

_open: List[Dict] = []


@contextlib.contextmanager
def counting():
    """Open a count: {'flops', 'bytes', 'calls': {name: n}, 'by_kernel':
    {name: flops}} of the launches made inside."""
    tally = {"flops": 0, "bytes": 0, "calls": {}, "by_kernel": {}}
    _open.append(tally)
    try:
        yield tally
    finally:
        _open.remove(tally)


def add(name: str, flops: int, nbytes: int) -> None:
    """Add one call's work to every open count (nothing when none is open)."""
    for tally in _open:
        tally["flops"] += flops
        tally["bytes"] += nbytes
        tally["calls"][name] = tally["calls"].get(name, 0) + 1
        tally["by_kernel"][name] = tally["by_kernel"].get(name, 0) + flops


@contextlib.contextmanager
def uncounted():
    """Hide the aten ops inside from the dispatch modes while a count is
    open (a backward's recompute of the plain forward)."""
    if not _open:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


def conv_flops(n_out: int, cin: int, cout: int, taps: int) -> int:
    """FlopCounterMode's count of a convolution: 2 x multiply-adds over the
    full window, n_out output positions (batch included)."""
    return 2 * n_out * cin * cout * taps
