"""Train state: the model's live parameters and BatchNorm statistics, the
Adam state, the step and an injectable learning rate (counterpart of
adaptive_stereo_tpu/engine/state.py).

The JAX TrainState is an immutable pytree; here the state holds the
StereoModel's own tensors, and the steps update them in place. The learning
rate is a 0-d tensor, so the reference's per-epoch StepLR halving
(train.py:167, gamma 0.5) is a host-side write, as in JAX.

Adam is optax.adam's (= torch's defaults): b1 0.9, b2 0.999, eps 1e-8
outside the square root, bias correction by the count. adam_masked is the
one implementation that every engine of the port calls (the flat streaming
engine and the classic steps); a skipped update leaves the parameters, the
moments and the count unchanged.

Deviation: create_train_state without variables draws the weights with the
port's random_init_ from a torch.Generator, not flax's init (which cannot
be reproduced bit for bit); the tests carry JAX's variables across instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ..models import random_init_, state_dicts_from_jax

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def live_parameters(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The parameters the forward uses, feature net first: every parameter
    but the BasicBlocks' dead conv2 (which the JAX model does not have)."""
    return [p for name, p in model.named_parameters() if ".conv2." not in name]


def live_buffers(model: torch.nn.Module) -> List[torch.Tensor]:
    """The BatchNorm running statistics the forward uses and train mode
    updates (every running_mean and running_var but the dead conv2's)."""
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var")) and ".conv2." not in name]


@dataclass
class TrainState:
    """The training state of a StereoModel. params and buffers are the
    model's own tensors (live_parameters / live_buffers), so a forward of
    `model` always sees the current weights."""

    model: torch.nn.Module
    params: List[torch.nn.Parameter]  # live parameters, [feature_net | stereo_net]
    n_feature: int                    # params[:n_feature] belong to the feature net
    buffers: List[torch.Tensor]       # live BatchNorm running statistics
    m: List[torch.Tensor]             # Adam first moments
    v: List[torch.Tensor]             # Adam second moments
    count: torch.Tensor               # () int32 applied updates (optax keeps it twice)
    step: torch.Tensor                # () int32 steps taken, applied or skipped
    lr: torch.Tensor                  # () float32 learning rate

    @property
    def learning_rate(self) -> float:
        return float(self.lr)

    def with_learning_rate(self, lr: float) -> "TrainState":
        """Host-side learning-rate write (reference scheduler.step(),
        train.py:240); in place, returns the state."""
        self.lr.fill_(lr)
        return self


def make_optimizer(learning_rate: float) -> Dict[str, float]:
    """Adam's hyperparameters as optax.inject_hyperparams(optax.adam) holds
    them (the checkpoint stores them under opt_state/hyperparams)."""
    return {"b1": ADAM_B1, "b2": ADAM_B2, "eps": ADAM_EPS, "eps_root": 0.0,
            "learning_rate": learning_rate}


@torch.no_grad()
def create_train_state(model: torch.nn.Module, generator: Optional[torch.Generator] = None,
                       learning_rate: float = 1e-5,
                       variables: Optional[dict] = None) -> TrainState:
    """The train state of `model` (a StereoModel on its device): its weights
    from `variables` (JAX layout {'params', 'batch_stats'}, e.g. from
    engine/checkpoint.py load_variables; copied into the model, never
    adopted), else drawn by random_init_ from `generator` (a seeded
    torch.Generator; None keeps the model's weights as they are). Adam
    starts at zero moments and count 0."""
    if variables is not None:
        model.load_state_dicts(*state_dicts_from_jax(variables, model.feature_net.k))
    elif generator is not None:
        random_init_(model, generator)
    params = live_parameters(model)
    dev = params[0].device
    return TrainState(
        model=model,
        params=params,
        n_feature=len(live_parameters(model.feature_net)),
        buffers=live_buffers(model),
        m=[torch.zeros_like(p) for p in params],
        v=[torch.zeros_like(p) for p in params],
        count=torch.zeros((), dtype=torch.int32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        lr=torch.tensor(learning_rate, dtype=torch.float32, device=dev),
    )


def _masked_assign(dst: List[torch.Tensor], new: List[torch.Tensor], keep: torch.Tensor) -> None:
    """dst <- dst where keep else new, for every tensor, in a few launches."""
    sizes = [t.numel() for t in dst]
    old = torch.cat([t.reshape(-1) for t in dst])
    sel = torch.where(keep, old, torch.cat([t.reshape(-1) for t in new]))
    torch._foreach_copy_(dst, [s.view_as(d) for s, d in zip(sel.split(sizes), dst)])


def adam_masked(state, grads: List[torch.Tensor],
                do_update: Optional[torch.Tensor] = None) -> None:
    """One Adam step on state.params (in place) from grads, with the state's
    moments m / v, count and learning rate lr (a TrainState or the flat
    engine's FlatStreamState). do_update: a () bool tensor; where it is
    False the parameters, moments and count keep their values, with no
    host read-back. None applies the update unconditionally."""
    new_count = state.count + 1
    c = new_count.float()
    m = torch._foreach_add(torch._foreach_mul(state.m, ADAM_B1),
                           torch._foreach_mul(grads, 1 - ADAM_B1))
    gg = torch._foreach_mul(grads, 1 - ADAM_B2)
    torch._foreach_mul_(gg, grads)
    v = torch._foreach_add(torch._foreach_mul(state.v, ADAM_B2), gg)
    mhat = torch._foreach_div(m, 1 - torch.pow(ADAM_B1, c))
    vhat = torch._foreach_div(v, 1 - torch.pow(ADAM_B2, c))
    step = torch._foreach_mul(mhat, state.lr)
    denom = torch._foreach_add(torch._foreach_sqrt(vhat), ADAM_EPS)
    theta = torch._foreach_sub([p.detach() for p in state.params],
                               torch._foreach_div(step, denom))
    if do_update is None:
        with torch.no_grad():
            torch._foreach_copy_(state.params, theta)
        torch._foreach_copy_(state.m, m)
        torch._foreach_copy_(state.v, v)
        state.count.copy_(new_count)
        return
    keep = ~do_update
    with torch.no_grad():
        _masked_assign(state.params, theta, keep)
    _masked_assign(state.m, m, keep)
    _masked_assign(state.v, v, keep)
    state.count.copy_(torch.where(keep, state.count, new_count))
