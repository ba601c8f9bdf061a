"""The adaptation state of the plateau machine (counterpart of the State
enum of adaptive_stereo_tpu/engine/adapt.py; the classic engine of that
module is not ported yet)."""

from __future__ import annotations

from enum import Enum


class State(Enum):
    DONE = 0          # Adaptation finished; no gradient updates.
    IN_PROGRESS = 1   # Adaptation in progress.
    VALIDATION = 2    # Validating (no gradients), used transiently.
