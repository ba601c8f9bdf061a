"""The AE / VAE reconstruction baselines (models/autoencoder.py) and their
trainer and scores (analysis/reconstruction_ood.py) against the JAX
package's, float32 on the CPU, from flax's initial parameters carried
across by autoencoder_state_dict_from_jax.

- forward passes, AE and VAE (sample=False), on non-square images with
  three channels and one: within 1e-5 absolute (the transposed convs' flip,
  the layouts and the VAE's NHWC flatten order all show at this band);
- vae_loss within 1e-6;
- five train_autoencoder steps (AE, the same loader) from JAX's initial
  parameters: each loss within 1e-4 relative (Adam's arithmetic is
  optax's through the port's adam_masked);
- the VAE trainer runs, with its noise from a torch.Generator (JAX draws
  from a PRNG key: no parity);
- reconstruction_scores within 1e-5, and the precision / recall equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_stereo_tpu.analysis.reconstruction_ood import (
    reconstruction_precision_recall as jax_pr,
    reconstruction_scores as jax_scores,
    train_autoencoder as jax_train,
)
from adaptive_stereo_tpu.models.autoencoder import VAE as JaxVAE
from adaptive_stereo_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from adaptive_stereo_tpu.models.autoencoder import vae_loss as jax_vae_loss
from adaptive_stereo_tpu_torch.analysis import (reconstruction_precision_recall,
                                                reconstruction_scores, train_autoencoder)
from adaptive_stereo_tpu_torch.models import (VAE, Autoencoder, autoencoder_state_dict_from_jax,
                                              random_autoencoder_init_, vae_loss)

FWD_TOL = dict(atol=1e-5, rtol=0)


def _images(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _ae(shape, latent, stages, seed=0):
    x = _images(seed, shape)
    jax_model = JaxAutoencoder(latent_channels=latent, stages=stages, image_channels=shape[-1])
    variables = jax_model.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    model = Autoencoder(latent, stages, shape[-1])
    model.load_state_dict(autoencoder_state_dict_from_jax(variables["params"], "ae"))
    return x, jax_model, variables, model


def _vae(shape, z_dim, seed=0):
    x = _images(seed, shape)
    jax_model = JaxVAE(z_dim=z_dim, input_height=shape[1], input_width=shape[2],
                       image_channels=shape[-1])
    variables = jax_model.init({"params": jax.random.PRNGKey(seed),
                                "latent": jax.random.PRNGKey(seed + 1)}, jnp.asarray(x))
    model = VAE(z_dim, shape[1], shape[2], shape[-1])
    model.load_state_dict(autoencoder_state_dict_from_jax(variables["params"], "vae"))
    return x, jax_model, variables, model


@pytest.mark.parametrize("shape, latent, stages", [((2, 32, 48, 3), 8, 2),
                                                   ((1, 64, 32, 3), 32, 4),
                                                   ((2, 16, 48, 1), 4, 1)])
def test_autoencoder_forward_matches_jax(shape, latent, stages):
    x, jax_model, variables, model = _ae(shape, latent, stages)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x)))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("shape, z_dim", [((2, 32, 48, 3), 16), ((1, 64, 32, 1), 8)])
def test_vae_forward_and_loss_match_jax(shape, z_dim):
    x, jax_model, variables, model = _vae(shape, z_dim)
    want = jax_model.apply(variables, jnp.asarray(x), sample=False)
    got = model(torch.from_numpy(x), sample=False)
    for name, a, b in zip(("reconstruction", "mu", "logvar"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=name, **FWD_TOL)
    target = _images(9, shape)
    ref = jax_vae_loss(jnp.asarray(target), *want)
    mine = vae_loss(torch.from_numpy(target), *got)
    np.testing.assert_allclose([float(v.detach()) for v in mine], [float(v) for v in ref],
                               atol=1e-6)


def test_vae_samples_from_its_generator():
    model = random_autoencoder_init_(VAE(8, 32, 32), torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images(1, (2, 32, 32, 3)))
    a = model(x, generator=torch.Generator().manual_seed(5))
    b = model(x, generator=torch.Generator().manual_seed(5))
    mean = model(x, sample=False)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], mean[0])
    assert torch.equal(a[1], mean[1]) and a[0].shape == x.shape


def _loader(seed, n_batches=3, shape=(2, 32, 64, 3)):
    return [{"color_l/0": _images(seed + i, shape), "color_r/0": _images(seed + 50 + i, shape)}
            for i in range(n_batches)]


def test_train_autoencoder_matches_jax():
    """Five AE steps over a loader of three batches (so it cycles), from
    the parameters JAX's trainer initializes with (PRNGKey(seed))."""
    loader, seed = _loader(0), 4
    model_j, vars_j, losses_j = jax_train(loader, num_steps=5, learning_rate=1e-3,
                                          latent_channels=8, stages=2, seed=seed)
    init = model_j.init(jax.random.PRNGKey(seed), jnp.asarray(loader[0]["color_l/0"]))
    model, state_dict, losses = train_autoencoder(
        loader, num_steps=5, learning_rate=1e-3, latent_channels=8, stages=2, seed=seed,
        variables=autoencoder_state_dict_from_jax(init["params"], "ae"), device="cpu")
    print(f"JAX losses {losses_j}\nport losses {losses}")
    np.testing.assert_allclose(losses, losses_j, rtol=1e-4, atol=0)
    assert losses[-1] < losses[0]
    trained = autoencoder_state_dict_from_jax(vars_j["params"], "ae")
    assert set(state_dict) == set(trained)
    moved = max((trained[k] - v).abs().max().item() for k, v in
                autoencoder_state_dict_from_jax(init["params"], "ae").items())
    diff = max((state_dict[k] - trained[k]).abs().max().item() for k in trained)
    print(f"weights moved up to {moved:.3g}; port vs JAX {diff:.3g}")
    assert diff < 0.05 * moved


def test_train_vae_runs_from_random_weights():
    model, state_dict, losses = train_autoencoder(_loader(3), num_steps=4, learning_rate=1e-3,
                                                  latent_channels=8, use_vae=True, seed=1,
                                                  device="cpu")
    assert isinstance(model, VAE) and len(losses) == 4 and np.isfinite(losses).all()
    assert all(torch.equal(state_dict[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("use_vae", [False, True])
def test_reconstruction_scores_and_precision_recall_match_jax(use_vae):
    shape = (2, 32, 64, 3)
    x, jax_model, variables, model = _vae(shape, 8) if use_vae else _ae(shape, 8, 2)
    train, novel = _loader(10, 2), _loader(20, 3)
    got = {name: reconstruction_scores(model, None, loader, use_vae=use_vae)
           for name, loader in (("train", train), ("novel", novel))}
    want = {name: jax_scores(jax_model, variables, loader, use_vae=use_vae)
            for name, loader in (("train", train), ("novel", novel))}
    for name in got:
        assert got[name].shape == want[name].shape == (2 * len(train if name == "train"
                                                               else novel),)
        np.testing.assert_allclose(got[name], want[name], **FWD_TOL)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    np.testing.assert_array_equal(reconstruction_scores(model, sd, novel, use_vae=use_vae,
                                                        max_batches=2), got["novel"][:4])
    for cutoff in np.quantile(np.concatenate(list(want.values())), [0.2, 0.5, 0.8]):
        assert reconstruction_precision_recall(want["train"], want["novel"], cutoff) == \
            jax_pr(want["train"], want["novel"], cutoff)


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown autoencoder kind"):
        autoencoder_state_dict_from_jax({}, "gan")
