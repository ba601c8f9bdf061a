"""Scale-out over torch.distributed (counterpart of
adaptive_stereo_tpu/parallel/): the process group and its mesh, the fleet
adaptation step (N camera streams adapt one shared model, gradients
combined by one all_reduce), the fleet driver and the data-parallel
supervised step."""

from .fleet import (FleetDriver, init_fleet_fcs_ema, make_fleet_apply_updates,
                    make_fleet_fwd_bwd, make_fused_fleet_step)
from .fleet_adapt import FleetStream, fleet_adapt
from .mesh import (Mesh, data_sharding, initialize_multihost, local_data_slice, make_mesh,
                   replicated_sharding)
from .train import make_parallel_train_step

__all__ = [
    "data_sharding",
    "fleet_adapt",
    "FleetDriver",
    "FleetStream",
    "init_fleet_fcs_ema",
    "initialize_multihost",
    "local_data_slice",
    "make_fleet_apply_updates",
    "make_fleet_fwd_bwd",
    "make_fused_fleet_step",
    "make_mesh",
    "make_parallel_train_step",
    "Mesh",
    "replicated_sharding",
]
