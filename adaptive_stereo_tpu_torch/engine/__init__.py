"""Online adaptation engine (counterpart of adaptive_stereo_tpu/engine/):
the streaming adapt, done and validate steps, the device reservoir, the
streaming driver (adapt_streaming), the eval step and loop, configuration
and checkpoints."""

from .adapt import State
from .checkpoint import load_variables, save_variables
from .config import (AdaptConfig, DataConfig, ExperimentConfig, ModelConfig, OptimConfig,
                     canonical_adapt_config, regression_adapt_config)

from .device_reservoir import (DeviceReservoir, init_device_reservoir,
                               reservoir_average_value, reservoir_maybe_add,
                               reservoir_set_values)
from .flat_stream import (LOG_COLS, FlatStreamState, init_flat_stream_state, live_buffers,
                          live_parameters, make_flat_streaming_steps)
from .evaluate import evaluate
from .steps import epe, make_eval_step, mean_fcs_from_outputs
from .stream_driver import (TrustRegionGuard, adapt_streaming, load_stream_checkpoint,
                            save_stream_checkpoint)

__all__ = [
    "AdaptConfig",
    "DataConfig",
    "DeviceReservoir",
    "ExperimentConfig",
    "FlatStreamState",
    "LOG_COLS",
    "ModelConfig",
    "OptimConfig",
    "State",
    "TrustRegionGuard",
    "adapt_streaming",
    "canonical_adapt_config",
    "epe",
    "evaluate",
    "init_device_reservoir",
    "init_flat_stream_state",
    "live_buffers",
    "live_parameters",
    "load_stream_checkpoint",
    "load_variables",
    "make_eval_step",
    "make_flat_streaming_steps",
    "mean_fcs_from_outputs",
    "reservoir_average_value",
    "reservoir_maybe_add",
    "regression_adapt_config",
    "reservoir_set_values",
    "save_stream_checkpoint",
    "save_variables",
]
