"""Online adaptation engine (counterpart of adaptive_stereo_tpu/engine/):
the streaming adapt, done and validate steps and the device reservoir."""

from .device_reservoir import (DeviceReservoir, init_device_reservoir,
                               reservoir_average_value, reservoir_maybe_add,
                               reservoir_set_values)
from .flat_stream import (LOG_COLS, FlatStreamState, init_flat_stream_state, live_parameters,
                          make_flat_streaming_steps)
from .steps import epe, mean_fcs_from_outputs

__all__ = [
    "DeviceReservoir",
    "FlatStreamState",
    "LOG_COLS",
    "epe",
    "init_device_reservoir",
    "init_flat_stream_state",
    "live_parameters",
    "make_flat_streaming_steps",
    "mean_fcs_from_outputs",
    "reservoir_average_value",
    "reservoir_maybe_add",
    "reservoir_set_values",
]
