"""The port's fleet and data-parallel steps across two processes: two ranks
of a gloo group on the CPU (tests/torch_parallel_worker.py, spawned with
torch.multiprocessing, started by initialize_multihost with a file store),
at tests/test_torch_parallel.py's sizes (k=3, input_scale 1, 32x64, N=4
streams, two on each rank), against the port's one-rank run and against
the JAX package on make_mesh(2) (two streams on each virtual device):

- the fused fleet step's chain, per_stream and shared, run freely and step
  by step from JAX's state before each step, in tests/test_torch_parallel.py's
  bands; in shared mode each rank's BatchNorm statistics span its two
  streams, as each JAX device's do;
- make_parallel_train_step with train_bn=True (local BatchNorm over each
  rank's two samples, as on each JAX device);
- initialize_multihost, local_data_slice, data_sharding and
  replicated_sharding (rank 1 starts from other bits and takes rank 0's);
- both ranks end every run with the same bits.

The world-1 run sums the four streams' weighted gradients as ((g0 + g1) +
g2) + g3, the world-2 run as (g0 + g1) + (g2 + g3): the two chains are held
to each other in the chain's bands. Each spawn has a timeout of its own.
"""

import multiprocessing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker
from adaptive_stereo_tpu.parallel import init_fleet_fcs_ema as jax_ema
from adaptive_stereo_tpu.parallel import make_fused_fleet_step as jax_fused
from adaptive_stereo_tpu.parallel import make_mesh as jax_mesh
from adaptive_stereo_tpu.parallel import make_parallel_train_step as jax_parallel_train
from test_torch_parallel import (AFTER_UPDATE_TOL, CHAIN_SEEDS, IN_PROGRESS, K,
                                 LOG_TOL, LR, MEDIAN_PARAM_LR, OPTIONS, THRESHOLD, WOULD_ADD,
                                 N, S, assert_aux_matches, assert_weights_match, buffer_names,
                                 frames, jax_setup, jax_variables, jnp_batch, live_names,
                                 named, port_chain, port_setup)

WORLD = 2
SPAWN_TIMEOUT_S = 300
MODES = ("per_stream", "shared")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def jax_chain_states(variables, bn_mode):
    """JAX's chain on two devices: the states and EMAs before each step and
    after the last, and each step's aux."""
    model, js = jax_setup(variables)
    step = jax_fused(model, jax_mesh(WORLD), S, K, ood_threshold=THRESHOLD, bn_mode=bn_mode,
                     **OPTIONS)
    states, emas, auxes = [js], [jax_ema(N)], []
    for (sb, se), would, prog in zip(CHAIN_SEEDS, WOULD_ADD, IN_PROGRESS):
        js, ema, aux = step(states[-1], emas[-1], jnp_batch(frames(sb)), jnp_batch(frames(se)),
                            jnp.asarray(would), jnp.asarray(prog))
        states.append(js)
        emas.append(ema)
        auxes.append({key: np.asarray(v) for key, v in aux.items()})
    return states, [tuple(np.asarray(x) for x in e) for e in emas], auxes


def port_named_state(model, jstate):
    """A JAX train state as the worker's saved-state layout."""
    adam = jstate.opt_state.inner_state[0]
    want = named(jstate.params, jstate.batch_stats)
    names, bufs = live_names(model), buffer_names(model)
    t = lambda d, ns: [torch.from_numpy(np.ascontiguousarray(d[n])) for n in ns]
    return {"params": t(want, names), "buffers": t(want, bufs),
            "m": t(named(adam.mu, jstate.batch_stats), names),
            "v": t(named(adam.nu, jstate.batch_stats), names),
            "count": int(adam.count), "step": int(jstate.step)}


def torch_tensors(batch):
    return {key: torch.from_numpy(v) for key, v in batch.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's references on make_mesh(2), then one spawn of two ranks."""
    variables = jax_variables()
    model, _ = port_setup(variables)
    chains = {mode: jax_chain_states(variables, mode) for mode in MODES}
    train_batch = frames(20)
    jmodel, js = jax_setup(variables)
    jstep = jax_parallel_train(jmodel, js.tx, jax_mesh(WORLD), S, [S, S + K],
                               clip_grad_norm=True, train_bn=True)
    j_train, j_losses = jstep(js, jnp_batch(train_batch))

    work = tmp_path_factory.mktemp("ranks")
    inputs = {
        "weights": (model.feature_net.state_dict(), model.stereo_net.state_dict()),
        "model": dict(k=K, input_scale=S), "lr": LR, "scales": [S, S + K],
        "options": dict(input_scale=S, k=K, ood_threshold=THRESHOLD, **OPTIONS),
        "chain": [(torch_tensors(frames(sb)), torch_tensors(frames(se)), would, prog)
                  for (sb, se), would, prog in zip(CHAIN_SEEDS, WOULD_ADD, IN_PROGRESS)],
        "starts": {mode: [(port_named_state(model, states[i]),
                           tuple(torch.from_numpy(x.copy()) for x in emas[i]))
                          for i in range(len(CHAIN_SEEDS))]
                   for mode, (states, emas, _) in chains.items()},
        "train": torch_tensors(train_batch)}
    torch.save(inputs, work / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_parallel_worker.run,
                         args=(r, WORLD, str(work / "store"), str(work / "inputs.pt"),
                               str(work / f"rank{r}.pt")))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
        hung = [p.pid for p in procs if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {SPAWN_TIMEOUT_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0] * WORLD
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(WORLD)]
    return dict(variables=variables, chains=chains, train=(j_train, j_losses), ranks=ranks)


def merged_aux(ranks, key, step=None):
    """Each step's aux of a run, the two ranks' streams concatenated."""
    pick = (lambda r: r[key]["aux"]) if step is None else (lambda r: r[key][step]["aux"])
    if step is None:
        return [{k: torch.cat([pick(r)[i][k] for r in ranks]) for k in pick(ranks[0])[i]}
                for i in range(len(pick(ranks[0])))]
    return {k: torch.cat([pick(r)[k] for r in ranks]) for k in pick(ranks[0])}


def load_port(variables, saved):
    """A port model and train state holding a rank's saved state."""
    model, state = port_setup(variables)
    torch_parallel_worker.load(state, saved)
    return model, state


def test_initialize_multihost_and_the_mesh(runs):
    got = [(r["rank"], r["world"], r["backend"]) for r in runs["ranks"]]
    assert got == [(0, WORLD, "gloo"), (1, WORLD, "gloo")]
    assert [r["per_stream all_reduces"] for r in runs["ranks"]] == [2 * len(CHAIN_SEEDS)] * 2


def test_local_data_slice_gives_each_rank_its_rows(runs):
    assert [r["slice"] for r in runs["ranks"]] == [[0, 1], [2, 3]]
    assert [r["dict_slice"] for r in runs["ranks"]] == [
        {"a": [0, 1, 2, 3], "b": [0, 10, 20, 30]}, {"a": [4, 5, 6, 7], "b": [40, 50, 60, 70]}]


def test_replicated_sharding_starts_every_rank_from_rank_0s_bits(runs):
    _, state = port_setup(runs["variables"])
    want = torch_parallel_worker.snapshot(state)
    for r in runs["ranks"]:
        got = r["replicated"]
        for g in torch_parallel_worker.GROUPS:
            assert all(torch.equal(x, y) for x, y in zip(got[g], want[g])), (r["rank"], g)
        assert got["count"] == 0 and got["lr"] == float(torch.tensor(LR))


@pytest.mark.parametrize("run", ["per_stream chain", "per_stream steps", "shared chain",
                                 "shared steps", "train"])
def test_both_ranks_end_with_the_same_bits(runs, run):
    a, b = (r[run] for r in runs["ranks"])
    for x, y in ([(a, b)] if run.endswith(("chain", "train")) else zip(a, b)):
        for g in torch_parallel_worker.GROUPS:
            assert all(torch.equal(s, t) for s, t in zip(x[g], y[g])), g
        assert (x["count"], x["step"]) == (y["count"], y["step"])


def test_per_stream_chain_at_world_2_matches_world_1(runs):
    """The same chain on one rank: each step's aux and the final parameters
    in the chain's bands (the sums of the streams' gradients associate
    differently)."""
    model, state, ema, auxes = port_chain(runs["variables"], "per_stream")
    got = merged_aux(runs["ranks"], "per_stream chain")
    updates = 0
    for i, (a, b) in enumerate(zip(got, auxes)):
        assert_aux_matches(a, {k: v.numpy() for k, v in b.items()},
                           LOG_TOL if updates == 0 else AFTER_UPDATE_TOL, f"step {i}")
        updates += int(b["do_update"].any())
    saved = runs["ranks"][0]["per_stream chain"]
    assert saved["count"] == int(state.count) == updates
    diffs = torch.cat([(x - y).abs().flatten() for x, y in zip(saved["params"], state.params)])
    spacing = torch.cat([updates * torch.from_numpy(np.spacing(y.detach().abs().numpy())).flatten()
                         for y in state.params])
    print(f"world 2 vs world 1 parameters: max {diffs.max():.3g}, median {diffs.median():.3g}")
    assert (diffs <= 2 * LR * updates + spacing).all()
    assert diffs.median() <= MEDIAN_PARAM_LR * LR
    world2_ema = torch.cat([r["per_stream chain"]["ema"][0] for r in runs["ranks"]])
    np.testing.assert_allclose(world2_ema.numpy(), ema[0].numpy(), **AFTER_UPDATE_TOL)


@pytest.mark.parametrize("bn_mode", MODES)
def test_fused_fleet_step_at_world_2_matches_jax(runs, bn_mode):
    """The chain run freely (aux rows, parameters, the count) and each step
    from JAX's state before it (aux, EMA, parameters, statistics, moments),
    against JAX on two devices."""
    states, emas, j_auxes = runs["chains"][bn_mode]
    variables = runs["variables"]
    updates = 0
    for i, (aux, jaux) in enumerate(zip(merged_aux(runs["ranks"], f"{bn_mode} chain"), j_auxes)):
        assert_aux_matches(aux, jaux, LOG_TOL if updates == 0 else AFTER_UPDATE_TOL,
                           f"chain step {i}")
        updates += int(np.asarray(jaux["do_update"]).any())
    model, state = load_port(variables, runs["ranks"][0][f"{bn_mode} chain"])
    assert_weights_match(model, state, states[-1], named(variables["params"],
                                                         variables["batch_stats"]),
                         updates, step_by_step=False)
    for i in range(len(CHAIN_SEEDS)):
        assert_aux_matches(merged_aux(runs["ranks"], f"{bn_mode} steps", i), j_auxes[i],
                           LOG_TOL, f"step {i}")
        ema = torch.cat([r[f"{bn_mode} steps"][i]["ema"][0] for r in runs["ranks"]])
        np.testing.assert_allclose(ema.numpy(), emas[i + 1][0], **LOG_TOL)
        model, state = load_port(variables, runs["ranks"][0][f"{bn_mode} steps"][i])
        assert int(state.step) == int(states[i + 1].step)
        assert_weights_match(model, state, states[i + 1],
                             named(states[i].params, states[i].batch_stats), 1)


def test_parallel_train_step_at_world_2_matches_jax(runs):
    j_train, j_losses = runs["train"]
    saved = runs["ranks"][0]["train"]
    assert set(saved["losses"]) == set(j_losses)
    for key, value in j_losses.items():
        np.testing.assert_allclose(saved["losses"][key], float(value), err_msg=key, **LOG_TOL)
    variables = runs["variables"]
    model, state = load_port(variables, saved)
    assert_weights_match(model, state, j_train, named(variables["params"],
                                                      variables["batch_stats"]), 1)
