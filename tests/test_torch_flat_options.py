"""The flat engine's remaining options against the JAX flat engine, float32
unless named, at the shapes of tests/test_torch_train.py (32x64, k=2,
maxdisp 47, bench.py's model options: fused_siamese, the tower; JAX
s2d_refinement=True):

- use_leftright (the flipped-batch left-right consistency loss) on adapt
  chains with fused ER (the replay frame as a third batch row) and without
  (a second train-mode forward);
- images_uint8 against JAX's uint8 chain, and bit for bit against the
  port's float32 chain on the dequantized frames (u8 / 255 in float32 is
  the same division on both paths);
- loss_dtype="bfloat16" against JAX's, each held against JAX's float32
  loss: the port's error at most BF16_FACTOR times JAX's own, with JAX's
  error nonzero;
- loss_dtype="float32" with use_leftright equals loss_dtype=None (JAX
  rejects that pair; a documented deviation), a reduced dtype with
  use_leftright raises, and so does a TPU warp precision;
- make_done_step_batched(n) against n done_step calls and against JAX's
  batched done step;
- ops/entropy.py against JAX.

Chain tolerances are tests/test_torch_train.py's (see its docstring): the
decisions equal, log rows up to the first applied update 1e-5 absolute and
relative, later rows and reservoir values 1e-4 + 2e-3 relative, parameters
within 2 lr per applied update with a median under 0.1 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_stereo_tpu.engine.flat_stream import (
    flat_state_to_variables,
    init_flat_stream_state as jax_init_state,
    make_flat_streaming_steps as jax_make_steps,
)
from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu.ops.entropy import (gradient_shannon_entropy as jax_grad_entropy,
                                              grayscale_shannon_entropy as jax_gray_entropy)
from adaptive_stereo_tpu_torch.engine import (LOG_COLS, init_flat_stream_state,
                                              make_flat_streaming_steps)
from adaptive_stereo_tpu_torch.models import state_dicts_from_jax
from adaptive_stereo_tpu_torch.ops import gradient_shannon_entropy, grayscale_shannon_entropy
from test_torch_train import (AFTER_UPDATE_TOL, H, K, LOG_TOL, LR, MAXDISP, MEDIAN_PARAM_LR, S,
                              W, _frames, _port, _variables)

OPTIONS = dict(use_er=True, use_vs=True, ood_threshold=12.76, clip_grad_norm=True)
INDICES = [0, 0, 1, 0]
BF16_FACTOR = 2.0
# Batched vs sequential done steps on the CPU: measured 3.0e-8 (one ulp of
# a loss of 0.35).
BATCHED_TOL = dict(atol=1e-7, rtol=1e-6)
COLS = {c: i for i, c in enumerate(LOG_COLS)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the driver's loader threads and the test
    runner's other worker processes share the cores, and a full team of
    spinning threads a process slows these CPU runs by an order of
    magnitude when the suite runs in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _engines(variables, **kw):
    """(JAX state, spec, steps) and (port model, state, steps), one config."""
    jmodel = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP, fused_siamese=True,
                            s2d_refinement=True)
    jss, spec = jax_init_state(variables["params"], variables["batch_stats"], LR, 16, H, W, 64,
                               seed=0)
    jsteps = jax_make_steps(jmodel, spec, S, K, warp_precision="highest", **OPTIONS, **kw)
    model = _port(variables, fused_siamese=True, fused_tower=True)
    ss = init_flat_stream_state(model, LR, 16, H, W, 64, seed=0, device="cpu")
    return (jss, spec, jsteps), (model, ss, make_flat_streaming_steps(model, S, K, **OPTIONS,
                                                                      **kw))


def _inputs(seed, uint8=False):
    rng = np.random.RandomState(seed)
    if uint8:
        frames = [[rng.randint(0, 256, (1, H, W, 3)).astype(np.uint8) for _ in range(2)]
                  for _ in range(2)]
        er = [rng.randint(0, 256, (1, H, W, 3)).astype(np.uint8) for _ in range(2)]
    else:
        frames = [_frames(rng) for _ in range(2)]
        er = _frames(rng)
    gt = (rng.rand(1, H, W, 1) * 30).astype(np.float32)
    return frames, er, gt


def _run_jax(jss, jsteps, frames, er, gt, indices=INDICES):
    j_adapt = jsteps[0]
    for idx in indices:
        left, right = frames[idx]
        jss = j_adapt(jss, *map(jnp.asarray, (left, right, gt, er[0], er[1], gt)),
                      jnp.asarray(idx, jnp.int32))
    return jss


def _run_port(ss, steps, frames, er, gt, indices=INDICES):
    t = torch.from_numpy
    for idx in indices:
        left, right = frames[idx]
        ss = steps[0](ss, t(left), t(right), t(gt), t(er[0]), t(er[1]), t(gt), idx)
    return ss


def _prefixed(variables):
    fsd, ssd = state_dicts_from_jax(variables, K)
    return {**{f"feature_net.{k}": v for k, v in fsd.items()},
            **{f"stereo_net.{k}": v for k, v in ssd.items()}}


def _assert_chain_matches(jss, spec, model, ss, n):
    ref_log, log = np.asarray(jss.log)[:n], ss.log.numpy()[:n]
    print("JAX log:\n", ref_log, "\nport log:\n", log)
    for c in ("novel", "did_add", "do_update"):
        np.testing.assert_array_equal(log[:, COLS[c]], ref_log[:, COLS[c]], err_msg=c)
    assert (log[:, COLS["mono_loss"]] > 0).all()
    updates = int(log[:, COLS["do_update"]].sum())
    assert 1 <= updates < n
    first = list(log[:, COLS["do_update"]]).index(1.0)
    np.testing.assert_allclose(log[:first + 1], ref_log[:first + 1], **LOG_TOL)
    np.testing.assert_allclose(log[first + 1:], ref_log[first + 1:], **AFTER_UPDATE_TOL)
    assert int(ss.count) == int(jss.count) == updates
    np.testing.assert_array_equal(ss.reservoir.reg_indices.numpy(),
                                  np.asarray(jss.reservoir.reg_indices))
    np.testing.assert_allclose(ss.reservoir.values.numpy(), np.asarray(jss.reservoir.values),
                               **AFTER_UPDATE_TOL)
    want = _prefixed(jax.tree.map(np.asarray, flat_state_to_variables(jss, spec)))
    diffs = np.concatenate([np.abs(p.detach().numpy() - want[n].numpy()).ravel()
                            for n, p in model.named_parameters() if ".conv2." not in n])
    print(f"parameters: port vs JAX max {diffs.max():.3g}, median {np.median(diffs):.3g}")
    assert diffs.max() <= 2 * LR * updates
    assert np.median(diffs) <= MEDIAN_PARAM_LR * LR


@pytest.mark.parametrize("fused_er", [True, False])
def test_leftright_chain_matches_jax(fused_er):
    """Rows [left, flip(right)] / [right, flip(left)] (+ the replay frame as
    a third row with fused ER); FCS and the reservoir from row 0."""
    variables = _variables(21)
    frames, er, gt = _inputs(22)
    (jss, spec, jsteps), (model, ss, steps) = _engines(
        variables, use_leftright=True, consistency_weight=1e-3, fused_er_forward=fused_er)
    jss = _run_jax(jss, jsteps, frames, er, gt)
    ss = _run_port(ss, steps, frames, er, gt)
    assert (ss.log.numpy()[:len(INDICES), COLS["replay_loss"]] > 0).all()
    _assert_chain_matches(jss, spec, model, ss, len(INDICES))


def test_uint8_chain_matches_jax_and_the_float32_chain():
    variables = _variables(23)
    frames, er, gt = _inputs(24, uint8=True)
    (jss, spec, jsteps), (model, ss, steps) = _engines(
        variables, images_uint8=True, fused_er_forward=True)
    jss = _run_jax(jss, jsteps, frames, er, gt)
    ss = _run_port(ss, steps, frames, er, gt)
    _assert_chain_matches(jss, spec, model, ss, len(INDICES))

    # The float32 chain on u8 / 255: the same bits.
    dq = lambda u: u.astype(np.float32) / 255.0
    model_f = _port(variables, fused_siamese=True, fused_tower=True)
    ss_f = init_flat_stream_state(model_f, LR, 16, H, W, 64, seed=0, device="cpu")
    steps_f = make_flat_streaming_steps(model_f, S, K, fused_er_forward=True, **OPTIONS)
    ss_f = _run_port(ss_f, steps_f, [[dq(a), dq(b)] for a, b in frames], [dq(e) for e in er],
                     gt)
    assert torch.equal(ss.log, ss_f.log)
    assert torch.equal(ss.reservoir.left, ss_f.reservoir.left)
    assert torch.equal(ss.reservoir.values, ss_f.reservoir.values)
    for a, b in zip(ss.params, ss_f.params):
        assert torch.equal(a, b)


def test_bf16_loss_dtype_within_a_factor_of_jax():
    """Two adapt steps (an add, then a duplicate that updates), a done step
    and a validation with the single-sided loss in bfloat16, on both sides;
    the loss values (the log's mono_loss column and the reservoir values
    after the validation) against JAX's float32 loss."""
    variables = _variables(25)
    frames, er, gt = _inputs(26)
    indices = [0, 0]
    readings = {}
    for name, dtype in (("ref", None), ("jax", "bfloat16")):
        (jss, _, jsteps), _ = _engines(variables, fused_er_forward=True, loss_dtype=dtype)
        jss = _run_jax(jss, jsteps, frames, er, gt, indices)
        jss = jsteps[1](jss, *map(jnp.asarray, (frames[1][0], frames[1][1], gt)),
                        jnp.asarray(1, jnp.int32))
        jss, *_ = jsteps[2](jss)
        readings[name] = (np.asarray(jss.log)[:3, COLS["mono_loss"]],
                          np.asarray(jss.reservoir.values)[:int(jss.reservoir.size)])
    _, (model, ss, steps) = _engines(variables, fused_er_forward=True, loss_dtype="bfloat16")
    ss = _run_port(ss, steps, frames, er, gt, indices)
    t = torch.from_numpy
    ss = steps[1](ss, t(frames[1][0]), t(frames[1][1]), t(gt), 1)
    ss, *_ = steps[2](ss)
    readings["port"] = (ss.log.numpy()[:3, COLS["mono_loss"]],
                        ss.reservoir.values.numpy()[:int(ss.reservoir.size)])
    np.testing.assert_array_equal(ss.log.numpy()[:3, COLS["do_update"]], [0, 1, 0])
    for i, what in enumerate(("mono loss of the adapt and done steps", "reservoir values")):
        want = readings["ref"][i]
        assert want.size >= 2
        jax_err = np.abs(readings["jax"][i] - want)
        port_err = np.abs(readings["port"][i] - want)
        for stat in (np.max, np.mean):
            assert stat(jax_err) > 0, what
            print(f"{what}, {stat.__name__}: JAX bf16 error {stat(jax_err):.4g}, port/JAX ratio "
                  f"{stat(port_err) / stat(jax_err):.3f}")
            assert stat(port_err) <= BF16_FACTOR * stat(jax_err), (what, port_err, jax_err)


def test_loss_dtype_float32_with_leftright_equals_none():
    variables = _variables(27)
    frames, er, gt = _inputs(28)
    runs = []
    for dtype in (None, "float32"):
        model = _port(variables, fused_siamese=True, fused_tower=True)
        ss = init_flat_stream_state(model, LR, 16, H, W, 64, seed=0, device="cpu")
        steps = make_flat_streaming_steps(model, S, K, use_leftright=True, loss_dtype=dtype,
                                          fused_er_forward=True, **OPTIONS)
        runs.append(_run_port(ss, steps, frames, er, gt, [0, 0]))
    assert torch.equal(runs[0].log, runs[1].log)
    for a, b in zip(runs[0].params, runs[1].params):
        assert torch.equal(a, b)
    model = _port(variables)
    with pytest.raises(ValueError, match="use_leftright"):
        make_flat_streaming_steps(model, S, K, use_leftright=True, loss_dtype="bfloat16")
    with pytest.raises(ValueError, match="TPU"):
        make_flat_streaming_steps(model, S, K, warp_precision="default")


def test_batched_done_step_matches_sequential_and_jax():
    """make_done_step_batched(3) after one adapt step, against three
    done_step calls from the same state and against JAX's batched step (the
    log rows and reservoir values 1e-4 + 2e-3 relative, after the update of
    the adapt step). The CPU forward is not batch-invariant (oneDNN picks
    its convolution by batch), so batched and sequential agree to
    BATCHED_TOL, not bit for bit; the decisions and the reservoir's frames
    and indices are equal."""
    variables = _variables(29)
    rng = np.random.RandomState(30)
    frames = [_frames(rng) for _ in range(3)]
    er = _frames(rng)
    gt = (rng.rand(1, H, W, 1) * 30).astype(np.float32)
    gts = np.concatenate([gt, gt * 0.5, gt * 2])
    lefts = np.concatenate([f[0] for f in frames])
    rights = np.concatenate([f[1] for f in frames])
    idxs = [7, 8, 7]
    options = dict(fused_er_forward=True, ood_threshold=1e9)

    jmodel = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP, fused_siamese=True,
                            s2d_refinement=True)
    jss, spec = jax_init_state(variables["params"], variables["batch_stats"], LR, 16, H, W, 64,
                               seed=0)
    opts = dict(OPTIONS, **options)
    j_adapt, _, _, j_make = jax_make_steps(jmodel, spec, S, K, warp_precision="highest", **opts)
    jss = _run_jax(jss, (j_adapt,), frames, er, gt, [0])
    jss = j_make(3)(jss, jnp.asarray(lefts), jnp.asarray(rights), jnp.asarray(gts),
                    jnp.asarray(idxs, jnp.int32))

    t = torch.from_numpy
    logs = []
    for batched in (True, False):
        model = _port(variables, fused_siamese=True, fused_tower=True)
        ss = init_flat_stream_state(model, LR, 16, H, W, 64, seed=0, device="cpu")
        adapt, done, _, make_batched = make_flat_streaming_steps(model, S, K, **opts)
        ss = _run_port(ss, (adapt,), frames, er, gt, [0])
        if batched:
            ss = make_batched(3)(ss, t(lefts), t(rights), t(gts),
                                 torch.tensor(idxs, dtype=torch.int32))
        else:
            for i in range(3):
                ss = done(ss, t(lefts[i:i + 1]), t(rights[i:i + 1]), t(gts[i:i + 1]), idxs[i])
        logs.append(ss)
    batched, sequential = logs
    assert int(batched.log_pos) == 4
    d_log = (batched.log - sequential.log).abs().max().item()
    print(f"batched vs sequential: log rows differ by up to {d_log:.3g}")
    for c in ("novel", "did_add", "do_update"):
        assert torch.equal(batched.log[:, COLS[c]], sequential.log[:, COLS[c]]), c
    torch.testing.assert_close(batched.log, sequential.log, **BATCHED_TOL)
    torch.testing.assert_close(batched.reservoir.values, sequential.reservoir.values,
                               **BATCHED_TOL)
    for f in ("left", "right", "reg_indices", "size", "count"):
        assert torch.equal(getattr(batched.reservoir, f), getattr(sequential.reservoir, f)), f
    log, ref = batched.log.numpy()[:4], np.asarray(jss.log)[:4]
    print("JAX log:\n", ref, "\nport log:\n", log)
    np.testing.assert_array_equal(log[:, COLS["did_add"]], [1, 1, 1, 0])  # 7 twice: a dup
    for c in ("novel", "did_add", "do_update"):
        np.testing.assert_array_equal(log[:, COLS[c]], ref[:, COLS[c]], err_msg=c)
    np.testing.assert_allclose(log, ref, **AFTER_UPDATE_TOL)
    np.testing.assert_array_equal(batched.reservoir.reg_indices.numpy(),
                                  np.asarray(jss.reservoir.reg_indices))
    np.testing.assert_allclose(batched.reservoir.values.numpy(),
                               np.asarray(jss.reservoir.values), **AFTER_UPDATE_TOL)
    with pytest.raises(ValueError, match="got 2 frames"):
        make_batched(3)(batched, t(lefts[:2]), t(rights[:2]), t(gts[:2]),
                        torch.tensor(idxs[:2], dtype=torch.int32))


def test_entropy_matches_jax():
    """Both entropies count integer bins of the same float32 products:
    equal to 1e-6."""
    rng = np.random.RandomState(31)
    for img in (rng.rand(40, 56).astype(np.float32),
                (rng.rand(40, 56) * 0.3 + 0.2).astype(np.float32),
                np.zeros((8, 8), np.float32)):
        np.testing.assert_allclose(grayscale_shannon_entropy(torch.from_numpy(img)).item(),
                                   float(jax_gray_entropy(jnp.asarray(img))), atol=1e-6)
        np.testing.assert_allclose(gradient_shannon_entropy(torch.from_numpy(img)).item(),
                                   float(jax_grad_entropy(jnp.asarray(img))), atol=1e-6)
    rgb = rng.rand(12, 16, 3).astype(np.float32)
    np.testing.assert_allclose(grayscale_shannon_entropy(torch.from_numpy(rgb)).item(),
                               float(jax_gray_entropy(jnp.asarray(rgb))), atol=1e-6)
    with pytest.raises(ValueError, match="single"):
        gradient_shannon_entropy(torch.from_numpy(rgb))
