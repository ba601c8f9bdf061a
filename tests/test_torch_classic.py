"""The classic adaptation engine (engine/adapt.py, engine/steps.py
make_fused_adapt_step) and its host-side buffers against the JAX package,
on the CPU:

- StereoReservoir, StereoPriorityQueue, _PriorityQueueOVS and
  StateMachine against the JAX classes on scripted random sequences: every
  return value and every attribute equal after every call (the buffers
  hold tokens or constant images of dyadic values, so the validation
  losses are exact in both);
- make_fused_adapt_step against JAX's from one state (32x64, k=2,
  maxdisp 47), on a novel frame (the update is skipped: parameters and
  Adam state unchanged bit for bit) and on a frame that updates, single-
  sided, and with the left-right loss on the fused siamese model with the
  tower: the step's scalars within LOG_TOL (1e-5; no update precedes
  them), the running statistics within STATS_TOL, the parameters within
  2 lr of JAX's with a median under 0.1 lr (tests/test_torch_train.py's
  bands).

adapt() against JAX adapt() is in tests/test_torch_classic_adapt.py and
tests/test_torch_classic_policies.py.
"""

import importlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_stereo_tpu.engine.state import create_train_state as jax_create_state
from adaptive_stereo_tpu.engine.steps import init_fcs_ema as jax_init_ema
from adaptive_stereo_tpu.engine.steps import make_fused_adapt_step as jax_make_fused_step
from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu.utils.stereo_priority_queue import StereoPriorityQueue as JaxPQ
from adaptive_stereo_tpu.utils.stereo_reservoir import StereoReservoir as JaxReservoir
from adaptive_stereo_tpu_torch.engine import (create_train_state, init_fcs_ema,
                                              make_fused_adapt_step)
from adaptive_stereo_tpu_torch.models import StereoModel, state_dicts_from_jax
from adaptive_stereo_tpu_torch.utils.stereo_priority_queue import StereoPriorityQueue
from adaptive_stereo_tpu_torch.utils.stereo_reservoir import StereoReservoir
from test_torch_train import LOG_TOL, MEDIAN_PARAM_LR, STATS_TOL, _variables

# The engine packages export their adapt() functions under the modules' names.
jax_adapt_mod = importlib.import_module("adaptive_stereo_tpu.engine.adapt")
port_adapt_mod = importlib.import_module("adaptive_stereo_tpu_torch.engine.adapt")

H, W, K, S, MAXDISP = 32, 64, 2, 0, 47
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads (see tests/test_torch_driver.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# --- the host-side buffers and the state machine ----------------------------

def _entries(buf):
    return [list(e) for e in buf]


@pytest.mark.parametrize("capacity", [1, 3])
def test_reservoir_matches_jax(capacity):
    """Algorithm R with its quirks (the counter increments before the dedup
    check; a replacement leaves the dedup set alone), add() and the
    pre_decide()/commit() pair of the fused step."""
    pair = [JaxReservoir(capacity, rng=random.Random(7)),
            StereoReservoir(capacity, rng=random.Random(7))]
    rng = np.random.RandomState(capacity)
    for i in range(400):
        op, index, value = rng.randint(4), int(rng.randint(12)), float(rng.rand())
        if op == 0:
            out = [r.add(f"l{i}", f"r{i}", value, index) for r in pair]
        elif op == 1:
            pres = [r.pre_decide(index) for r in pair]
            assert pres[0].add == pres[1].add and pres[0].slot == pres[1].slot, i
            novel = rng.rand() < 0.7  # commit() only for a frame found novel
            out = [r.commit(p, f"l{i}", f"r{i}", value, index) if novel else None
                   for r, p in zip(pair, pres)]
        elif op == 2 and pair[0].size():
            slot = int(rng.randint(pair[0].size()))
            out = [r.update_value(slot, value) for r in pair]
        else:
            out = [r.average_value() if r.size() else None for r in pair]
        a, b = pair
        assert out[0] == out[1], (i, op)
        assert (_entries(a.buf), a.indices, a.i, a._rng.getstate()) == \
            (_entries(b.buf), b.indices, b.i, b._rng.getstate()), (i, op)
    assert pair[1].i > capacity


@pytest.mark.parametrize("min_heap", [True, False])
def test_priority_queue_matches_jax(min_heap):
    pair = [JaxPQ(4, min_heap=min_heap), StereoPriorityQueue(4, min_heap=min_heap)]
    rng = np.random.RandomState(int(min_heap))
    for i in range(300):
        op, index, value = rng.randint(3), int(rng.randint(20)), float(rng.randint(50)) / 8
        if op == 0 or not pair[0].size():
            out = [q.add(f"l{i}", f"r{i}", value, index) for q in pair]
        elif op == 1:
            out = [q.pop() for q in pair]
        else:
            out = [q.average_value() for q in pair]
        assert out[0] == out[1], (i, op)
        assert (pair[0].buf, pair[0].indices) == (pair[1].buf, pair[1].indices), (i, op)


def _images(value):
    """A (1, H, W, 3) constant pair as JAX and torch arrays."""
    arr = np.full((1, 4, 6, 3), value, np.float32)
    return jnp.asarray(arr), torch.from_numpy(arr)


def _validate_fns():
    """Per-pair 'loss' = mean(left * right): exact for constant dyadic
    images. The JAX engine pads the stack to capacity with zeros."""
    return (lambda params, stats, l, r: jnp.mean(l * r, axis=(1, 2, 3)),
            lambda l, r: (l * r).mean(dim=(1, 2, 3)))


@pytest.mark.parametrize("policy", ["reservoir", "priority_queue"])
def test_state_machine_matches_jax(policy, capsys):
    j_validate, p_validate = _validate_fns()
    machines = [jax_adapt_mod.StateMachine(jax_adapt_mod.State.IN_PROGRESS, 3, j_validate,
                                           (4, 6), rng=random.Random(3), ovs_policy=policy),
                port_adapt_mod.StateMachine(port_adapt_mod.State.IN_PROGRESS, 3, p_validate,
                                            rng=random.Random(3), ovs_policy=policy)]
    rng = np.random.RandomState(5)
    transitions = {"DONE": 0, "IN_PROGRESS": 0}
    for i in range(250):
        op, index = rng.randint(6), int(rng.randint(10))
        value = float(rng.randint(1, 16)) / 16
        (jl, pl), (jr, pr) = _images(value), _images(float(rng.randint(1, 8)) / 8)
        loss = float(rng.randint(64)) / 64
        if op == 0:
            out = [machines[0].add_to_ovs(jl, jr, loss, index),
                   machines[1].add_to_ovs(pl, pr, loss, index)]
        elif op == 1:
            pres = [m.ovs.pre_decide(index) for m in machines]
            out = [machines[0].commit_novel(pres[0], jl, jr, loss, index),
                   machines[1].commit_novel(pres[1], pl, pr, loss, index)]
        elif op == 2:
            out = [machines[0].validate(None, None), machines[1].validate()]
        elif op in (3, 4) and machines[0].ovs_buffer_size():
            out = [m.transition(1 + i % 3).name for m in machines]
            transitions[out[0]] += 1
        else:
            out = [m.restart() for m in machines]
        a, b = machines
        assert out[0] == out[1], (i, op)
        assert (a.current_state.name, a.prev_ovs_loss, a.ovs_did_change,
                a.ovs_iters_without_improvement, a.ovs_buffer_size()) == \
            (b.current_state.name, b.prev_ovs_loss, b.ovs_did_change,
             b.ovs_iters_without_improvement, b.ovs_buffer_size()), (i, op)
        assert [(e[0], e[1], float(e[2].mean()), float(e[3].mean())) for e in a.ovs.buf] == \
            [(e[0], e[1], float(e[2].mean()), float(e[3].mean())) for e in b.ovs.buf], (i, op)
    capsys.readouterr()
    print(f"{policy}: transitions {transitions}")
    assert transitions["DONE"] > 0 and transitions["IN_PROGRESS"] > 0


# --- the fused adaptation step ----------------------------------------------

def _frame(rng):
    return {f"color_l/{S}": rng.rand(1, H, W, 3).astype(np.float32),
            f"color_r/{S}": rng.rand(1, H, W, 3).astype(np.float32),
            f"gt_disp_l/{S}": (rng.rand(1, H, W, 1) * 30).astype(np.float32)}


def _prefixed(variables):
    fsd, ssd = state_dicts_from_jax(variables, K)
    return {**{f"feature_net.{k}": v.numpy() for k, v in fsd.items()},
            **{f"stereo_net.{k}": v.numpy() for k, v in ssd.items()}}


def _port_variables(model):
    from adaptive_stereo_tpu_torch.models import variables_from_state_dicts

    return variables_from_state_dicts(model.feature_net.state_dict(),
                                      model.stereo_net.state_dict(), K)


@pytest.mark.parametrize("case", ["novel", "update", "update_leftright"])
def test_fused_adapt_step_matches_jax(case):
    variables = _variables(21)
    rng = np.random.RandomState(22)
    batch, er_batch = _frame(rng), _frame(rng)
    leftright = case == "update_leftright"
    options = dict(use_er=True, use_vs=True, clip_grad_norm=True,
                   ood_threshold=1e9 if case == "novel" else -1e9, use_leftright=leftright)
    jmodel = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP, fused_siamese=leftright,
                            s2d_refinement=leftright)
    x = jnp.zeros((1, H, W, 3))
    jstate = jax_create_state(jmodel, jax.random.PRNGKey(0), x, x, LR, variables=variables)
    j_step = jax_make_fused_step(jmodel, S, K, warp_precision="highest", **options)
    jstate, j_ema, j_aux = j_step(jstate, jax_init_ema(),
                                  {k: jnp.asarray(v) for k, v in batch.items()},
                                  {k: jnp.asarray(v) for k, v in er_batch.items()},
                                  jnp.asarray(True))

    model = StereoModel(k=K, input_scale=S, maxdisp=MAXDISP, device="cpu",
                        fused_siamese=leftright, fused_tower=leftright)
    state = create_train_state(model, None, LR, variables=variables)
    before = [p.detach().clone() for p in state.params]
    step = make_fused_adapt_step(model, S, K, **options)
    ema = init_fcs_ema("cpu")
    t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    state, ema, aux = step(state, ema, t(batch), t(er_batch), True)

    assert sorted(aux) == sorted(j_aux)
    for key in ("novel", "did_add", "do_update"):
        assert bool(aux[key]) == bool(j_aux[key]), key
    for key in aux:
        print(f"{key}: port {float(aux[key]):.6g}, JAX {float(j_aux[key]):.6g}")
        np.testing.assert_allclose(float(aux[key]), float(j_aux[key]), err_msg=key, **LOG_TOL)
    np.testing.assert_allclose(float(ema[0]), float(j_ema[0]), **LOG_TOL)
    assert bool(ema[1]) and bool(j_ema[1])
    assert int(state.step) == int(jstate.step) == 1
    updated = case != "novel"
    assert int(state.count) == int(jstate.opt_state.inner_state[0].count) == int(updated)
    assert bool(aux["did_add"]) != updated
    mine = _prefixed(_port_variables(model))
    want = _prefixed({"params": jax.tree.map(np.asarray, jstate.params),
                      "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)})
    if not updated:  # the skipped update keeps the weights and moments
        assert all(torch.equal(a, b) for a, b in zip(state.params, before))
        assert all(not m.any() for m in state.m + state.v)
    live = [n for n in want if ".conv2." not in n and not n.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    diffs = np.concatenate([np.abs(mine[n] - want[n]).ravel() for n in live])
    print(f"parameters: max {diffs.max():.3g}, median {np.median(diffs):.3g}")
    assert diffs.max() <= 2 * LR * int(updated) and np.median(diffs) <= MEDIAN_PARAM_LR * LR
    for n in want:
        if n.endswith(("running_mean", "running_var")) and ".conv2." not in n:
            np.testing.assert_allclose(mine[n], want[n], err_msg=n, **STATS_TOL)
