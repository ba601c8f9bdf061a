"""Fleet adaptation driver: N camera streams, one shared model (counterpart
of adaptive_stereo_tpu/parallel/fleet_adapt.py, the JAX package's
north-star workload).

Every stream keeps its own OOD gate, FCS EMA, reservoir OVS and DONE /
IN_PROGRESS state machine (engine/adapt.py StateMachine); every gradient
update is the fleet's combined update of the shared model
(parallel/fleet.py make_fused_fleet_step). Each rank of the mesh runs the
host side of its own streams, the rows local_data_slice gives it: the OVS
validation at the cadence, the pre-drawn reservoir decisions, the commits
of novel frames, the restart of a DONE stream that sees one, the counts.
Per step the rank reads its streams' scalars back once.

A DONE stream keeps running through the same train-mode step with its
gradient weight and statistics masked out (JAX's documented fleet policy).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..engine.adapt import State, StateMachine
from ..engine.steps import make_ovs_validate_step
from .fleet import init_fleet_fcs_ema, make_fused_fleet_step
from .mesh import local_data_slice, make_mesh


@dataclass
class FleetStream:
    """One camera stream: its dataset plus per-stream adaptation state."""

    dataset: object                 # map-style dataset of frame dicts
    name: str = "stream"
    er_dataset: Optional[object] = None
    state_machine: Optional[StateMachine] = None
    steps: int = 0
    gradient_updates: int = 0
    fcs_history: List[float] = field(default_factory=list)


def fleet_adapt(model, state, streams: List[FleetStream], input_scale: int, k: int,
                num_steps: int, ood_threshold: float = 15.0, fcs_ema_weight: float = 0.999,
                smoothness_weight: float = 1e-3, er_loss_weight: float = 0.05,
                adapt_mode: str = "VS+ER", ovs_buffer_size: int = 8,
                ovs_validate_hz: int = 100, val_improve_retries: int = 1,
                clip_grad_norm: bool = True, mesh=None, seed: int = 123,
                warp_precision: str = "highest", bn_mode: str = "per_stream") -> Dict:
    """Run synchronized fleet adaptation for num_steps frames per stream.

    streams: the whole fleet, the same list on every rank (its length
    divides over the ranks); rank r drives rows [r * n / world, (r + 1) * n
    / world). Stream i's reservoir draws from random.Random(seed + i), so
    its decisions do not depend on the world size. mesh: None makes one on
    "cuda" (parallel/mesh.py make_mesh; make_mesh(device="cpu") for the
    CPU); frames are uploaded to the mesh's device.

    Returns {'state': the final TrainState, 'streams': every stream's
    summary, in fleet order, gathered from every rank}."""
    if mesh is None:
        mesh = make_mesh()
    if len(streams) % mesh.world_size:
        raise ValueError(f"{len(streams)} streams do not divide over {mesh.world_size} ranks")
    first = mesh.rank * (len(streams) // mesh.world_size)
    local = local_data_slice(streams, mesh)
    s = input_scale
    use_er = adapt_mode in ("ER", "VS+ER")
    use_vs = adapt_mode not in ("NONSTOP", "ER", "NONE")

    fused = make_fused_fleet_step(
        model, mesh, s, k, smoothness_weight=smoothness_weight, er_loss_weight=er_loss_weight,
        use_er=use_er, use_vs=use_vs, ood_threshold=ood_threshold,
        fcs_ema_weight=fcs_ema_weight, clip_grad_norm=clip_grad_norm,
        warp_precision=warp_precision, bn_mode=bn_mode)
    validate_fn = make_ovs_validate_step(model, s, smoothness_weight,
                                         warp_precision=warp_precision)
    for i, st in enumerate(local):
        if st.state_machine is None:
            initial = State.DONE if adapt_mode == "NONE" else State.IN_PROGRESS
            st.state_machine = StateMachine(initial, ovs_buffer_size, validate_fn,
                                            rng=random.Random(seed + first + i))

    ema = init_fleet_fcs_ema(len(local), mesh.device)

    def stack_frames(step_idx: int, er: bool):
        frames = []
        for st in local:
            ds = (st.er_dataset or st.dataset) if er else st.dataset
            frames.append(ds[step_idx % len(ds)])
        return {key: torch.from_numpy(np.stack([f[key] for f in frames])).to(mesh.device)
                for key in frames[0]}

    left_key, right_key = f"color_l/{s}", f"color_r/{s}"
    for step_idx in range(num_steps):
        # Per-stream OVS validation / transition at the cadence boundary.
        if step_idx % ovs_validate_hz == 0:
            for st in local:
                sm = st.state_machine
                if sm.ovs_buffer_size() > 0 and sm.state() == State.IN_PROGRESS:
                    sm.validate()
                    if use_vs:
                        sm.transition(val_improve_retries)

        batch_n = stack_frames(step_idx, er=False)
        er_batch_n = stack_frames(step_idx, er=True) if use_er else batch_n
        pres = [st.state_machine.ovs.pre_decide(step_idx) if use_vs else None for st in local]
        would_add_n = [bool(p.add) if p else False for p in pres]
        in_progress_n = [st.state_machine.state() == State.IN_PROGRESS for st in local]

        state, ema, aux = fused(state, ema, batch_n, er_batch_n, would_add_n, in_progress_n)

        keys = ("novel", "did_add", "do_update", "fcs_smoothed", "Monodepth/total_loss")
        novel, _, do_update, fcs_smoothed, mono = torch.stack(
            [aux[key].float() for key in keys]).cpu().numpy()

        for i, st in enumerate(local):
            st.steps += 1
            st.fcs_history.append(float(fcs_smoothed[i]))
            sm = st.state_machine
            if use_vs and novel[i]:
                left = batch_n[left_key][i:i + 1].clone()
                right = batch_n[right_key][i:i + 1].clone()
                if sm.state() == State.IN_PROGRESS:
                    sm.commit_novel(pres[i], left, right, float(mono[i]), step_idx)
                else:
                    # DONE + novel frame -> restart (reference adapt.py:111-114).
                    sm.ovs.commit(pres[i], left, right, float(mono[i]), step_idx)
                    sm.restart()
            if do_update[i]:
                st.gradient_updates += 1

    summaries = [{"name": st.name, "steps": st.steps, "gradient_updates": st.gradient_updates,
                  "final_state": st.state_machine.state().name,
                  "ovs_size": st.state_machine.ovs_buffer_size()} for st in local]
    gathered = [None] * mesh.world_size
    dist.all_gather_object(gathered, summaries, group=mesh.group)
    return {"state": state, "streams": [x for part in gathered for x in part]}
