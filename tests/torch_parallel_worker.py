"""One rank of tests/test_torch_parallel_multiprocess.py: a gloo process
group on the CPU, started by initialize_multihost with a file store, that
runs the port's fleet step and data-parallel train step on its own rows
and saves what it computed. Imports torch, numpy and the port only.

run(rank, world, init_file, inputs_path, out_path): inputs_path holds (torch.save)
  weights     the port's (feature, stereo) state dicts
  model       StereoModel keyword arguments; options the fleet step's
  chain       [(batch, er_batch, would_add, in_progress)] of global numpy
              arrays, one entry per step
  starts      {bn_mode: [(port-named train state, (ema values, flags))]},
              a state before each step of the chain
  train       the global batch of the data-parallel train step
"""

import torch
import torch.distributed as dist

from adaptive_stereo_tpu_torch.engine import create_train_state, live_parameters
from adaptive_stereo_tpu_torch.models import StereoModel
from adaptive_stereo_tpu_torch.parallel import (data_sharding, initialize_multihost,
                                                local_data_slice, make_fused_fleet_step,
                                                make_mesh, make_parallel_train_step,
                                                replicated_sharding)

GROUPS = ("params", "buffers", "m", "v")


def fresh(inputs):
    model = StereoModel(device="cpu", **inputs["model"])
    model.load_state_dicts(*inputs["weights"])
    return model, create_train_state(model, learning_rate=inputs["lr"])


def snapshot(state):
    out = {g: [t.detach().clone() for t in getattr(state, g)] for g in GROUPS}
    out.update(count=int(state.count), step=int(state.step))
    return out


@torch.no_grad()
def load(state, saved):
    for g in GROUPS:
        for t, v in zip(getattr(state, g), saved[g]):
            t.copy_(v)
    state.count.fill_(saved["count"])
    state.step.fill_(saved["step"])


def run(rank, world, init_file, inputs_path, out_path):
    torch.set_num_threads(2)
    initialize_multihost(f"file://{init_file}", world, rank, backend="gloo")
    mesh = make_mesh(device="cpu")
    inputs = torch.load(inputs_path)
    shard = data_sharding(mesh)
    local = lambda batch: {key: shard(v) for key, v in batch.items()}
    out = {"rank": mesh.rank, "world": mesh.world_size, "backend": dist.get_backend(),
           "slice": local_data_slice(list(range(len(inputs["chain"][0][2]))), mesh),
           "dict_slice": {k: v.tolist() for k, v in local_data_slice(
               {"a": torch.arange(8), "b": torch.arange(8) * 10}, mesh).items()}}

    # replicated_sharding: rank 1 starts from other bits, then takes rank 0's.
    model, state = fresh(inputs)
    if rank:
        with torch.no_grad():
            for t in live_parameters(model) + state.buffers + state.m + state.v:
                t.add_(1.0)
        state.count.fill_(7)
        state.lr.fill_(1.0)
    replicated_sharding(mesh)(state)
    out["replicated"] = snapshot(state)
    out["replicated"]["lr"] = float(state.lr)

    for bn_mode in ("per_stream", "shared"):
        model, state = fresh(inputs)
        step = make_fused_fleet_step(model, mesh, bn_mode=bn_mode, **inputs["options"])
        ema = tuple(local_data_slice(torch.zeros(len(inputs["chain"][0][2]), dtype=dt), mesh)
                    for dt in (torch.float32, torch.bool))
        auxes = []
        for batch, er_batch, would, prog in inputs["chain"]:
            _, ema, aux = step(state, ema, local(batch), local(er_batch),
                               local_data_slice(would, mesh), local_data_slice(prog, mesh))
            auxes.append(aux)
        out[f"{bn_mode} chain"] = dict(snapshot(state), aux=auxes, ema=[t.clone() for t in ema])
        # Each step of the chain again from the given state before it.
        steps = []
        for (batch, er_batch, would, prog), (saved, saved_ema) in zip(inputs["chain"],
                                                                      inputs["starts"][bn_mode]):
            load(state, saved)
            ema = tuple(local_data_slice(t.clone(), mesh) for t in saved_ema)
            _, ema, aux = step(state, ema, local(batch), local(er_batch),
                               local_data_slice(would, mesh), local_data_slice(prog, mesh))
            steps.append(dict(snapshot(state), aux=aux, ema=[t.clone() for t in ema]))
        out[f"{bn_mode} steps"] = steps
        out[f"{bn_mode} all_reduces"] = mesh.all_reduces
        mesh.all_reduces = 0

    model, state = fresh(inputs)
    step = make_parallel_train_step(model, mesh, inputs["model"]["input_scale"],
                                    inputs["scales"], clip_grad_norm=True, train_bn=True)
    state, losses = step(state, local(inputs["train"]))
    out["train"] = dict(snapshot(state), losses={k: float(v) for k, v in losses.items()})
    torch.save(out, out_path)
    dist.destroy_process_group()
