"""Training and online adaptation engines (counterpart of
adaptive_stereo_tpu/engine/): the supervised trainer (train), the classic
adaptation engine (adapt) with its steps, the streaming adapt, done and
validate steps, the device reservoir, the device frame caches, the
streaming driver (adapt_streaming), the eval step and loop, the offline
inference tools, configuration, the train state and checkpoints."""

from .adapt import State, StateMachine, adapt
from .checkpoint import load_checkpoint, load_variables, save_checkpoint, save_variables
from .config import (AdaptConfig, DataConfig, ExperimentConfig, ModelConfig, OptimConfig,
                     canonical_adapt_config, regression_adapt_config)
from .device_reservoir import (DeviceReservoir, init_device_reservoir,
                               reservoir_average_value, reservoir_maybe_add,
                               reservoir_set_values)
from .device_cache import DeviceCachedLoader, DeviceStreamCache
from .evaluate import evaluate
from .flat_stream import (LOG_COLS, FlatStreamState, init_flat_stream_state,
                          make_flat_streaming_steps)
from .inference_tools import playback, render_video_frames, save_disparities
from .state import (TrainState, adam_masked, create_train_state, live_buffers, live_parameters,
                    make_optimizer)
from .steps import (clip_stereo_net_grads, epe, init_fcs_ema, make_adapt_forward_backward,
                    make_adapt_loss, make_apply_updates, make_eval_step, make_forward_losses,
                    make_fused_adapt_step, make_infer_step, make_ovs_validate_step,
                    make_train_step, make_viz_step, mean_fcs_from_outputs)
from .stream_driver import (TrustRegionGuard, adapt_streaming, load_stream_checkpoint,
                            save_stream_checkpoint)
from .train import train

__all__ = [
    "adam_masked",
    "adapt",
    "adapt_streaming",
    "AdaptConfig",
    "canonical_adapt_config",
    "clip_stereo_net_grads",
    "create_train_state",
    "DataConfig",
    "DeviceCachedLoader",
    "DeviceStreamCache",
    "DeviceReservoir",
    "epe",
    "evaluate",
    "ExperimentConfig",
    "FlatStreamState",
    "init_device_reservoir",
    "init_fcs_ema",
    "init_flat_stream_state",
    "live_buffers",
    "live_parameters",
    "load_checkpoint",
    "load_stream_checkpoint",
    "load_variables",
    "LOG_COLS",
    "make_adapt_forward_backward",
    "make_adapt_loss",
    "make_apply_updates",
    "make_eval_step",
    "make_flat_streaming_steps",
    "make_forward_losses",
    "make_fused_adapt_step",
    "make_infer_step",
    "make_optimizer",
    "make_ovs_validate_step",
    "make_train_step",
    "make_viz_step",
    "mean_fcs_from_outputs",
    "ModelConfig",
    "OptimConfig",
    "playback",
    "regression_adapt_config",
    "render_video_frames",
    "reservoir_average_value",
    "reservoir_maybe_add",
    "reservoir_set_values",
    "save_checkpoint",
    "save_disparities",
    "save_stream_checkpoint",
    "save_variables",
    "State",
    "StateMachine",
    "train",
    "TrainState",
    "TrustRegionGuard",
]
