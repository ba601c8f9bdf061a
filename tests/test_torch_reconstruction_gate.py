"""The reconstruction gate (gate="reconstruction": an AE's reconstruction
error of the left image as the novelty signal, high means novel) against
the JAX package's, float32 on the CPU, at 32x64, k=2, maxdisp 47:

- make_reconstruction_gate against JAX's, AE and VAE: within 1e-5;
- one fused adapt step of each branch (a frame the gate calls novel and
  one it does not) against JAX's make_fused_adapt_step: gate_score within
  1e-5, the decisions equal, the losses and FCS within the flat engine's
  first-step band (1e-5);
- the classic engine, adapt(cfg, gate_model=...) in VS+ER over two epochs
  at lr 2e-6 (see GATED_LR), against JAX's with
  tests/test_torch_classic_adapt.py's bands and checks,
  the threshold in the middle of the widest gap between the frames'
  scores, so that both branches fire and each frame's score lies 2e-3
  relative or more from it; the DONE state scores through the gate too;
- the same run at the classic tests' lr 2e-5 against the same run with a
  table gate (each frame's AE score looked up, no AE computed), in each
  package: the AE adds nothing but the decisions, bit for bit;
- the named errors: no gate_apply, no gate model, an unknown kind.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptive_stereo_tpu.engine.config as jax_config
import adaptive_stereo_tpu_torch.engine.config as port_config
from adaptive_stereo_tpu.engine.steps import init_fcs_ema as jax_init_ema
from adaptive_stereo_tpu.engine.steps import make_fused_adapt_step as jax_make_step
from adaptive_stereo_tpu.engine.state import create_train_state as jax_train_state
from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu.models.autoencoder import VAE as JaxVAE
from adaptive_stereo_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from adaptive_stereo_tpu_torch.data import StereoDataset
from adaptive_stereo_tpu_torch.engine import (create_train_state, init_fcs_ema,
                                              make_fused_adapt_step)
from adaptive_stereo_tpu_torch.models import (VAE, Autoencoder, autoencoder_state_dict_from_jax,
                                              reconstruction_error)
from test_torch_classic_adapt import (LR as CLASSIC_LR, MARGIN, _cfg,  # noqa: F401
                                      _few_threads, check_adapt_against_jax, data)
from test_torch_train import H, K, LOG_TOL, LR, MAXDISP, S, W, _frames, _port, _variables

jax_adapt_mod = importlib.import_module("adaptive_stereo_tpu.engine.adapt")
port_adapt_mod = importlib.import_module("adaptive_stereo_tpu_torch.engine.adapt")
GATE_TOL = dict(atol=1e-5, rtol=0)
# The gated classic run's learning rate. At the classic tests' 2e-5 the
# running statistics of this run pass the classic band of 2e-3 relative +
# 1e-4 + 2 lr per update by 2.2 lr per update (feature_net.residual_blocks.
# 0.conv1's BatchNorm mean, 3.6e-4 past 2e-3 relative after 6 updates; every
# parameter within 0.72 lr per update). The cause is the frames the updates
# fall on, not the gate: the same run with the AE replaced by a table of its
# scores (the same decisions, no AE; test_the_gate_adds_nothing_but_its_
# decisions) drifts alike to the last digit, and the same table with every
# frame novel (the ungated VS+ER run's decisions, 6 updates as well) stays
# 4.1e-5 past 2e-3 relative, inside the band (measured on the CPU). The drift
# scales with lr (8.0e-5 at 2e-6, 4.8e-6 at 0), so at 2e-6 the band holds.
GATED_LR = 2e-6


def _gate_models(kind, seed=0):
    x = jnp.zeros((1, H, W, 3))
    if kind == "vae":
        jax_model = JaxVAE(z_dim=8, input_height=H, input_width=W)
        variables = jax_model.init({"params": jax.random.PRNGKey(seed),
                                    "latent": jax.random.PRNGKey(seed + 1)}, x)
        model = VAE(8, H, W)
    else:
        jax_model = JaxAutoencoder(latent_channels=8, stages=2)
        variables = jax_model.init(jax.random.PRNGKey(seed), x)
        model = Autoencoder(8, 2)
    state_dict = autoencoder_state_dict_from_jax(variables["params"], kind)
    model.load_state_dict(state_dict)
    return jax_model, variables, model, state_dict


@pytest.mark.parametrize("kind", ["ae", "vae"])
def test_gate_score_matches_jax(kind):
    jax_model, variables, model, state_dict = _gate_models(kind)
    left = _frames(np.random.RandomState(1))[0]
    want = float(jax_adapt_mod.make_reconstruction_gate(jax_model, kind)(
        variables["params"], jnp.asarray(left)))
    gate = port_adapt_mod.make_reconstruction_gate(model, kind)
    got = gate(state_dict, torch.from_numpy(left))
    assert got.shape == () and not got.requires_grad
    np.testing.assert_allclose(float(got), want, **GATE_TOL)
    np.testing.assert_allclose(float(reconstruction_error(model, None, torch.from_numpy(left),
                                                          kind == "vae")[0]), want, **GATE_TOL)


def test_fused_step_with_the_gate_matches_jax():
    """Two fused steps from one state: the first frame's score above the
    threshold (novel: the reservoir's pre-drawn add diverts it, no update),
    the second's below (an update)."""
    jax_gate_model, gate_vars, gate_model, gate_sd = _gate_models("ae", 2)
    variables = _variables(3)
    rng = np.random.RandomState(4)
    frames = [_frames(rng) for _ in range(2)]
    gt = (rng.rand(1, H, W, 1) * 30).astype(np.float32)
    port_gate = port_adapt_mod.make_reconstruction_gate(gate_model, "ae")
    scores = [float(port_gate(gate_sd, torch.from_numpy(f[0]))) for f in frames]
    threshold = float(np.mean(scores))
    order = np.argsort(scores)[::-1]  # the novel frame first
    options = dict(use_er=True, use_vs=True, ood_threshold=threshold, clip_grad_norm=True,
                   gate="reconstruction")

    jmodel = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP)
    x = jnp.zeros((1, H, W, 3))
    jstate = jax_train_state(jmodel, jax.random.PRNGKey(0), x, x, LR, variables)
    j_step = jax_make_step(jmodel, S, K, gate_apply=jax_adapt_mod.make_reconstruction_gate(
        jax_gate_model, "ae"), warp_precision="highest", **options)
    model = _port(variables)
    state = create_train_state(model, learning_rate=LR)
    step = make_fused_adapt_step(model, S, K, gate_apply=port_gate, **options)
    jema, ema = jax_init_ema(), init_fcs_ema("cpu")
    keys = (f"color_l/{S}", f"color_r/{S}", f"gt_disp_l/{S}")
    er = dict(zip(keys, (*frames[1], gt)))
    for i in order:
        batch = dict(zip(keys, (*frames[i], gt)))
        jstate, jema, j_aux = j_step(jstate, jema, {k: jnp.asarray(v) for k, v in batch.items()},
                                     {k: jnp.asarray(v) for k, v in er.items()},
                                     jnp.asarray(True), gate_vars["params"])
        state, ema, aux = step(state, ema, {k: torch.from_numpy(v) for k, v in batch.items()},
                               {k: torch.from_numpy(v) for k, v in er.items()}, True, gate_sd)
        print(f"frame {i}: gate_score port {float(aux['gate_score']):.6g} JAX "
              f"{float(j_aux['gate_score']):.6g}, threshold {threshold:.6g}")
        np.testing.assert_allclose(float(aux["gate_score"]), float(j_aux["gate_score"]),
                                   **GATE_TOL)
        for key in ("novel", "did_add", "do_update"):
            assert bool(aux[key]) == bool(j_aux[key]), key
        for key in ("fcs_raw", "fcs_smoothed", "Monodepth/total_loss", "Replay/total_loss"):
            np.testing.assert_allclose(float(aux[key]), float(j_aux[key]), err_msg=key,
                                       **LOG_TOL)
        assert abs(scores[i] - threshold) / threshold > MARGIN
    assert bool(aux["do_update"])
    assert int(state.count) == int(jstate.opt_state.count) == 1


def test_classic_adapt_with_the_gate_matches_jax(data, tmp_path, monkeypatch):
    jax_model, jax_vars, model, state_dict = _gate_models("ae", 5)
    stream = StereoDataset(data[1], "Synthetic", "synth", H, W, "train", scales=[S, S + K],
                           load_disp_right=False)
    gate = port_adapt_mod.make_reconstruction_gate(model, "ae")
    scores = [float(gate(state_dict, torch.from_numpy(stream[i][f"color_l/{S}"][None])))
              for i in range(len(stream))]
    ranked = np.sort(scores)
    widest = int(np.argmax(np.diff(ranked)))
    threshold = float(ranked[widest:widest + 2].mean())  # both branches fire
    margins = [("novelty: reconstruction score vs ood_threshold",
                abs(v - threshold) / threshold) for v in scores]
    records = check_adapt_against_jax(
        "VS+ER", dict(gate="reconstruction", ood_threshold=threshold), data, tmp_path,
        monkeypatch,
        jax_kw=dict(gate_model=jax_model, gate_variables=jax_vars, gate_kind="ae"),
        port_kw=dict(gate_model=model, gate_variables=state_dict, gate_kind="ae"),
        margins=margins, lr=GATED_LR)
    novel = [r["novel"] for r in records["port"]]
    expected = [scores[i % len(scores)] > threshold for i in range(len(novel))]
    print(f"scores {scores}, threshold {threshold}; novel {novel}; states "
          f"{[r['state'] for r in records['port']]}")
    assert novel == expected and any(novel) and not all(novel)


class _JaxTableGate:
    """A flax-like gate model whose reconstruction is left + the table's
    score of the nearest stored frame: gate_apply gives that score."""

    def __init__(self, frames, scores):
        self.frames, self.scores = jnp.asarray(frames), jnp.asarray(scores, jnp.float32)

    def apply(self, variables, left):
        i = jnp.argmin(jnp.sum(jnp.abs(left[0] - self.frames), axis=(1, 2, 3)))
        return left + self.scores[i]


class _TableGate(torch.nn.Module):
    """The port's _JaxTableGate."""

    def __init__(self, frames, scores):
        super().__init__()
        self.register_buffer("frames", torch.from_numpy(frames))
        self.register_buffer("scores", torch.tensor(scores, dtype=torch.float32))

    def forward(self, left):
        i = torch.argmin(torch.sum(torch.abs(left[0] - self.frames), dim=(1, 2, 3)))
        return left + self.scores[i]


def test_the_gate_adds_nothing_but_its_decisions(data, tmp_path):
    """At the classic tests' lr, the AE-gated classic run against the same
    run gated by a table of the AE's scores, in each package: the same step
    records and the same final checkpoint, byte for byte."""
    jax_model, jax_vars, model, state_dict = _gate_models("ae", 5)
    stream = StereoDataset(data[1], "Synthetic", "synth", H, W, "train", scales=[S, S + K],
                           load_disp_right=False)
    frames = np.stack([stream[i][f"color_l/{S}"] for i in range(len(stream))])
    gate = port_adapt_mod.make_reconstruction_gate(model, "ae")
    scores = [float(gate(state_dict, torch.from_numpy(f[None]))) for f in frames]
    ranked = np.sort(scores)
    widest = int(np.argmax(np.diff(ranked)))
    threshold = float(ranked[widest:widest + 2].mean())
    table = _TableGate(frames, scores)
    gates = {
        "jax": {"ae": dict(gate_model=jax_model, gate_variables=jax_vars, gate_kind="ae"),
                "table": dict(gate_model=_JaxTableGate(frames, scores),
                              gate_variables={"params": {}}, gate_kind="ae")},
        "port": {"ae": dict(gate_model=model, gate_variables=state_dict, gate_kind="ae"),
                 "table": dict(gate_model=table, gate_variables=dict(table.state_dict()),
                               gate_kind="ae")}}
    packages = {"jax": (jax_adapt_mod, jax_config, {}), "port": (port_adapt_mod, port_config,
                                                                 {"device": "cpu"})}
    for package, (mod, config, kw) in packages.items():
        runs = {}
        for name, gate_kw in gates[package].items():
            records = []
            cfg = _cfg(config, data, tmp_path / package, name, "VS+ER", CLASSIC_LR,
                       gate="reconstruction", ood_threshold=threshold)
            mod.adapt(cfg, variables=data[2], step_hook=lambda s, r: records.append(r),
                      **gate_kw, **kw)
            with open(tmp_path / package / name / "models" / "weights_12" / "state.msgpack",
                      "rb") as f:
                runs[name] = (records, f.read())
        (ae_records, ae_bytes), (table_records, table_bytes) = runs["ae"], runs["table"]
        novel = [r["novel"] for r in ae_records]
        print(f"{package}: novel {novel}, updates {sum(r['do_update'] for r in ae_records)}")
        assert any(novel) and not all(novel)
        assert ae_records == table_records and ae_bytes == table_bytes, package


def test_gate_errors(data, tmp_path):
    with pytest.raises(ValueError, match="requires gate_apply"):
        make_fused_adapt_step(_port(_variables(0)), S, K, gate="reconstruction")
    with pytest.raises(ValueError, match="unknown gate 'entropy'"):
        make_fused_adapt_step(_port(_variables(0)), S, K, gate="entropy")
    with pytest.raises(ValueError, match="unknown gate kind"):
        port_adapt_mod.make_reconstruction_gate(Autoencoder(8, 2), "gan")
    gated = port_config.ExperimentConfig(log_dir=str(tmp_path),
                                         adapt=port_config.AdaptConfig(gate="reconstruction"))
    with pytest.raises(ValueError, match="requires gate_model and gate_variables"):
        port_adapt_mod.adapt(gated, variables=data[2], device="cpu")
