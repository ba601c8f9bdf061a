"""The GT-free guard study on the port
(adaptive_stereo_tpu_torch/scripts/run_gtfree_guard_study.py) against the
JAX package, on the CPU:

- the port's probe against the same probe built from the JAX package's
  functions as scripts/run_gtfree_guard_study.py:124-160 builds it
  (model.apply in eval mode, feature_contrast_mean, linear_warp,
  monodepth_single_loss, jax.value_and_grad), on the same weights
  (models/weights.py state_dicts_from_jax) at 64x128, with s2d_refinement
  off (the refinement module) and on (the refinement tower; JAX's plain
  space-to-depth module; marked slow). Tolerance: 1e-4 relative on fcs,
  lr_cons, epe, mean_disp and mono, 1e-3 relative on grad_norm (float32 on
  both sides, convolutions summed in other orders; the gradient norm sums
  the most);
- main end to end at 64x128 with --adapt_steps 4 --probe_hz 2 --device cpu
  on the port's synthetic domains and a port checkpoint: each config's CSV
  has JAX's header and a row per probe, every value finite, the drift 0
  where no update was applied;
- the probe leaves the trajectory alone: adapt_streaming with the study's
  hook ends with bitwise the parameters and running statistics of the same
  run without it (NONSTOP, so that every step updates), and the probe
  model is built without drawing from the global generators.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu.ops import (feature_contrast_mean, linear_warp,
                                     monodepth_single_loss)
from adaptive_stereo_tpu_torch.data import generate_synthetic_dataset
from adaptive_stereo_tpu_torch.engine import (AdaptConfig, DataConfig, ExperimentConfig,
                                              ModelConfig, OptimConfig)
from adaptive_stereo_tpu_torch.engine.checkpoint import save_variables
from adaptive_stereo_tpu_torch.engine.stream_driver import adapt_streaming
from adaptive_stereo_tpu_torch.models import (StereoModel, random_init_,
                                              variables_from_state_dicts)
from adaptive_stereo_tpu_torch.scripts import run_gtfree_guard_study as study

H, W = 64, 128
REL = (1e-4, 1e-4, 1e-4, 1e-4, 1e-4, 1e-3)
NAMES = ("fcs", "lr_cons", "epe", "mean_disp", "mono", "grad_norm")


def _variables(seed):
    model = random_init_(StereoModel(k=4, device="cpu"), torch.Generator().manual_seed(seed))
    return variables_from_state_dicts(model.feature_net.state_dict(),
                                      model.stereo_net.state_dict(), 4)


def _jax_probe(variables, fused, left, right, gt, max_disp=192):
    """scripts/run_gtfree_guard_study.py's probe (:124-160), float32."""
    model = JaxStereoModel(k=4, input_scale=0, dtype=None, fused_siamese=fused,
                           s2d_refinement=fused)
    pl_, pr_, pgt = jnp.asarray(left), jnp.asarray(right), jnp.asarray(gt)

    @jax.jit
    def probe(params, bn):
        v = {"params": params, "batch_stats": bn}
        flip = lambda x: x[:, :, ::-1, :]  # noqa: E731
        outs = model.apply(v, jnp.concatenate([pl_, flip(pr_)], 0),
                           jnp.concatenate([pr_, flip(pl_)], 0), side="l",
                           output_cost_volume=True, train=False)
        pred = outs["pred_disp_l/0"]
        d_l, d_r = pred[0:1], flip(pred[1:2])
        fcs = jnp.mean(feature_contrast_mean(outs["cost_volume_l/4"][0:1]))
        warped, mask = linear_warp(d_r, d_l, max_disp=max_disp)
        lr_cons = jnp.sum(jnp.abs(warped - d_l) * mask) / jnp.maximum(jnp.sum(mask), 1.0)
        epe = jnp.mean(jnp.abs(d_l - pgt))
        mean_disp = jnp.mean(jnp.abs(d_l))

        def mono_of(p):
            o = model.apply({"params": p, "batch_stats": bn}, pl_, pr_, side="l", train=False)
            return monodepth_single_loss(pl_, pr_, o["pred_disp_l/0"], 1e-3,
                                         max_disp=max_disp)[0]

        mono, g = jax.value_and_grad(mono_of)(params)
        gnorm = jnp.sqrt(sum(jnp.sum(x.astype(jnp.float32) ** 2)
                             for x in jax.tree.leaves(g["stereo_net"])))
        return fcs, lr_cons, epe, mean_disp, mono, gnorm

    return tuple(float(x) for x in probe(variables["params"], variables["batch_stats"]))


def _frame(seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(1, H, W, 3).astype(np.float32), rng.rand(1, H, W, 3).astype(np.float32),
            (20 * rng.rand(1, H, W, 1)).astype(np.float32))


# The JAX side compiles its plain space-to-depth tower for about 15 s on the
# CPU: the tower case is marked slow (the tower's eval-mode gradient is held
# to JAX's in tests/test_torch_tower.py).
@pytest.mark.parametrize("fused", [False, pytest.param(True, marks=pytest.mark.slow)])
def test_probe_equals_the_jax_built_probe(fused):
    variables = _variables(1)
    left, right, gt = _frame(2)
    cfg = ModelConfig(k=4, input_scale=0, compute_dtype="float32", fused_siamese=fused,
                      s2d_refinement=fused)
    model = study.probe_model(cfg, "cpu")
    assert model.stereo_net.edge_aware_refinements[0].fused_tower == fused
    got = study.probe(model, variables, *(torch.from_numpy(x) for x in (left, right, gt)))
    want = _jax_probe(variables, fused, left, right, gt)
    for name, g, w, rel in zip(NAMES, got, want, REL):
        print(f"{name}: port {g:.7g} jax {w:.7g} rel {abs(g - w) / abs(w):.2e}")
        assert abs(g - w) <= rel * abs(w), name
    assert not model.training
    assert all(p.grad is None for p in model.parameters())


def test_probe_model_draws_nothing_from_the_global_generators():
    torch.manual_seed(5)
    want = torch.rand(3)
    torch.manual_seed(5)
    study.probe_model(ModelConfig(k=4, s2d_refinement=True), "cpu")
    assert torch.equal(torch.rand(3), want)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Synthetic train and novel domains, a port checkpoint at
    logs/pretrain/models/weights_final and an ood_threshold.json: what
    phases 0-2 of run_paper_scale_synth leave for the study."""
    root = str(tmp_path_factory.mktemp("study"))
    generate_synthetic_dataset(os.path.join(root, "train_domain"), name="synth", num_train=4,
                               num_val=2, height=H, width=W, max_disp=16.0, seed=0)
    generate_synthetic_dataset(os.path.join(root, "novel_domain"), name="synth", num_train=4,
                               num_val=2, height=H, width=W, max_disp=16.0, seed=50,
                               domain_shift=True)
    save_variables(os.path.join(root, "logs", "pretrain", "models", "weights_final"),
                   _variables(3))
    artifacts = os.path.join(root, "artifacts")
    os.makedirs(artifacts)
    with open(os.path.join(artifacts, "ood_threshold.json"), "w") as f:
        json.dump({"threshold": 1e9}, f)
    return root, artifacts


def test_main_writes_the_probe_csvs(work, capsys):
    root, artifacts = work
    out = os.path.join(root, "out")
    configs = ["fused", "faithful", "vser"]
    assert study.main(["--work", root, "--artifacts", artifacts, "--out", out, "--configs",
                       *configs, "--adapt_steps", "4", "--probe_hz", "2", "--height", str(H),
                       "--width", str(W), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "[study] weights" in printed
    for cname in configs:
        with open(os.path.join(out, f"probes_{cname}.csv")) as f:
            lines = f.read().splitlines()
        assert lines[0] == "step,fcs,lr_cons,epe,mean_disp,mono,grad_norm,drift"
        rows = np.loadtxt(os.path.join(out, f"probes_{cname}.csv"), delimiter=",", skiprows=1)
        assert rows.shape == (2, 8) and np.isfinite(rows).all()
        np.testing.assert_array_equal(rows[:, 0], [2, 4])
        assert (rows[:, 6] > 0).all()  # a gradient norm
        assert f"[{cname}] step 2:" in printed and f"[{cname}] done in" in printed


def test_probe_hook_leaves_the_trajectory_alone(work):
    root, _ = work
    variables = _variables(3)
    model_cfg = ModelConfig(k=4, input_scale=0, compute_dtype="float32", fused_siamese=True,
                            s2d_refinement=True)

    def run(name, hook):
        cfg = ExperimentConfig(
            model_name=name, log_dir=os.path.join(root, "logs"), num_epochs=100,
            log_frequency=2, seed=123, log_images=False, model=model_cfg,
            optim=OptimConfig(learning_rate=5e-5, clip_grad_norm=True,
                              scheduler_step_size=10 ** 6),
            data=DataConfig(dataset_path=os.path.join(root, "novel_domain"),
                            dataset_name="Synthetic", split="synth", height=H, width=W,
                            batch_size=1, num_workers=2),
            adapt=AdaptConfig(adapt_mode="NONSTOP", num_steps=4, eval_hz=1000,
                              skip_initial_eval=True))
        return adapt_streaming(cfg, variables=variables, engine="flat", fused_er_forward=True,
                               device_cache=True, probe_hook=hook, device="cpu")

    pmodel = study.probe_model(model_cfg, "cpu")
    left, right, gt = (torch.from_numpy(x) for x in _frame(4))
    probes = []
    probed = run("probed", lambda step, get_vars: probes.append(
        study.probe(pmodel, get_vars(), left, right, gt)))
    plain = run("plain", None)
    assert len(probes) == 2 and probed["gradient_updates"] == plain["gradient_updates"] == 4
    a, b = probed["stream_state"], plain["stream_state"]
    for x, y in zip(list(a.params) + list(a.buffers), list(b.params) + list(b.buffers)):
        assert torch.equal(x, y)
