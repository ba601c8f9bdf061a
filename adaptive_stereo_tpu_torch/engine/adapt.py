"""Online adaptation, the classic engine (reference adapt.py; counterpart of
adaptive_stereo_tpu/engine/adapt.py): the step-for-step reference-parity
engine behind `adapt --engine classic`.

The fused step (engine/steps.py make_fused_adapt_step) does the forward,
Monodepth loss, FCS, replay, backward, the FCS EMA and OOD gate and the
masked Adam update; this module is the host shell: the DONE / IN_PROGRESS
state machine, the reservoir-sampled online validation set (OVS), the
evaluations, trials.csv and checkpoints. Modes: NONSTOP | VS | ER | VS+ER |
NONE (reference train.py:289).

Per step the host reads the step's scalars back (FCS, novelty, the update
decision and the Monodepth loss, in one copy): the OOD gate and the host
reservoir (a random.Random seeded with cfg.seed) decide on them before the
next frame, which is this engine's nature. The streaming driver
(engine/stream_driver.py) is the engine without these reads.

Differences from the JAX engine:
- OVS validation batches the live pairs only (no padding to the buffer's
  capacity, which served one XLA program for every fill).
- The reconstruction gate's variables are the gate model's state dict
  (analysis/reconstruction_ood.py train_autoencoder returns it), not flax
  parameters.
- `device` (a port-only argument, "cuda" unless the caller passes "cpu")
  picks where the model and the state live.
"""

from __future__ import annotations

import heapq
import os
import random
import time
from enum import Enum
from typing import Dict, Optional

import numpy as np
import torch

from ..data import BatchLoader, StereoDataset
from ..device import DeviceLike, resolve_device, to_device
from ..models import build_model, reconstruction_error
from ..ops import online_ema
from ..utils.logging_utils import MetricsWriter, TrialsLog, write_opt_json
from ..utils.stereo_priority_queue import StereoPriorityQueue
from ..utils.stereo_reservoir import PreDecision, StereoReservoir
from .checkpoint import load_variables, save_checkpoint
from .config import ExperimentConfig
from .evaluate import evaluate
from .state import create_train_state
from .steps import (check_gate, init_fcs_ema, make_eval_step, make_fused_adapt_step,
                    make_infer_step, make_ovs_validate_step, make_viz_step)


class State(Enum):
    DONE = 0          # Adaptation finished; no gradient updates.
    IN_PROGRESS = 1   # Adaptation in progress.
    VALIDATION = 2    # Validating (no gradients), used transiently.


class _PriorityQueueOVS:
    """The reservoir's interface over the bounded max-heap that keeps the
    WORST-loss pairs (JAX adapt.py:59-101). Framework-defined policy: the
    reference builds the priority queue but never wires it; here novel
    frames always divert from the gradient update and heap admission is
    decided by loss at commit time."""

    def __init__(self, max_size: int):
        self._pq = StereoPriorityQueue(max_size, min_heap=False)
        self.max_size = max_size

    @property
    def buf(self):
        m = self._pq.multiplier
        return [[m * it[0], it[1], it[2], it[3]] for it in self._pq.buf]

    def add(self, img_l, img_r, value, img_index) -> bool:
        return bool(self._pq.add(img_l, img_r, float(value), img_index))

    def pre_decide(self, img_index):
        return PreDecision(add=True, slot=-1)

    def commit(self, pre, img_l, img_r, value, img_index) -> bool:
        return self.add(img_l, img_r, value, img_index)

    def update_value(self, buf_index: int, new_value: float) -> None:
        self._pq.buf[buf_index][0] = self._pq.multiplier * float(new_value)
        heapq.heapify(self._pq.buf)

    def size(self) -> int:
        return self._pq.size()

    def average_value(self) -> float:
        return self._pq.average_value()


class StateMachine:
    """DONE / IN_PROGRESS state machine with an OVS reservoir (reference
    adapt.py:89-172; JAX adapt.py:104-193). validate_fn(left_stack,
    right_stack) returns the per-pair losses of the stacked OVS pairs
    (engine/steps.py make_ovs_validate_step)."""

    def __init__(self, initial_state: State, ovs_buffer_size: int, validate_fn,
                 rng: Optional[random.Random] = None, ovs_policy: str = "reservoir"):
        self.initial_state = initial_state
        self.current_state = initial_state
        if ovs_policy == "priority_queue":
            self.ovs = _PriorityQueueOVS(ovs_buffer_size)
        else:
            self.ovs = StereoReservoir(ovs_buffer_size, rng=rng)
        self.prev_ovs_loss = float("inf")
        self.ovs_did_change = True
        self.ovs_iters_without_improvement = 0
        self._validate_fn = validate_fn

    def add_to_ovs(self, left_img, right_img, loss: float, batch_idx: int) -> bool:
        return self._on_novel(self.ovs.add(left_img, right_img, float(loss), batch_idx),
                              loss, batch_idx)

    def commit_novel(self, pre, left_img, right_img, loss: float, batch_idx: int) -> bool:
        """The fused step's variant of add_to_ovs: applies a pre-drawn
        reservoir decision for a frame the device gate flagged as novel."""
        return self._on_novel(self.ovs.commit(pre, left_img, right_img, float(loss), batch_idx),
                              loss, batch_idx)

    def _on_novel(self, did_add: bool, loss: float, batch_idx: int) -> bool:
        if did_add:
            print(f"[ OVS ] ADDED a new pair to the OVS (INDEX={batch_idx} LOSS={loss})")
            self.ovs_did_change = True
        # A novel frame arriving while DONE restarts adaptation, even if the
        # reservoir declined to store it (reference adapt.py:111-114).
        if self.current_state == State.DONE:
            self.restart()
        return did_add

    def restart(self) -> None:
        self.current_state = self.initial_state
        print("[ OVS ] RESTARTING adaptation!")

    def validate(self) -> None:
        """Recompute each OVS pair's Monodepth loss with the current weights,
        in one batched eval forward."""
        n = self.ovs.size()
        if n == 0:
            return
        buf = self.ovs.buf
        losses = self._validate_fn(torch.cat([buf[i][2] for i in range(n)]),
                                   torch.cat([buf[i][3] for i in range(n)])).tolist()
        for i in range(n):
            self.ovs.update_value(i, float(losses[i]))

    def transition(self, val_improve_retries: int) -> State:
        ovs_loss = self.ovs.average_value()
        print("\n[ OVS ] -----------------------------------------")
        print(f"[ OVS ] VALIDATION LOSS | PREVIOUS={self.prev_ovs_loss} | UPDATED={ovs_loss}")
        print("[ OVS ] -----------------------------------------\n")

        if ovs_loss >= self.prev_ovs_loss and self.ovs_did_change is False:
            self.ovs_iters_without_improvement += 1
            if self.ovs_iters_without_improvement >= val_improve_retries:
                print(f"[ OVS ] Transitioned to DONE! Loss didn't improve in the last "
                      f"{self.ovs_iters_without_improvement} evaluations")
                self.current_state = State.DONE
                self.prev_ovs_loss = float("inf")
        else:
            self.ovs_did_change = False
            self.ovs_iters_without_improvement = 0
            self.prev_ovs_loss = ovs_loss
            print("[ OVS ] Transitioned to IN_PROGRESS. Loss improved or buffer changed.")
        return self.current_state

    def state(self) -> State:
        return self.current_state

    def ovs_buffer_size(self) -> int:
        return self.ovs.size()


def make_reconstruction_gate(gate_model: torch.nn.Module, kind: str = "ae"):
    """The gate score of gate="reconstruction": the mean L1 reconstruction
    error of the left image under an AE ("ae") or VAE ("vae") of
    models/autoencoder.py (the graveyard OOD signal, reference
    graveyard/adapt_vae.py ~:400: `torch.abs(decoded - input).mean()`).
    The VAE decodes from mu, so the score is deterministic. Returns
    gate_apply(params, left) -> () float32 tensor, params the model's
    weights (a state dict on left's device), computed without gradient."""
    if kind not in ("ae", "vae"):
        raise ValueError(f"unknown gate kind {kind!r}: 'ae' or 'vae'")

    def gate_apply(params: Dict[str, torch.Tensor], left: torch.Tensor) -> torch.Tensor:
        return reconstruction_error(gate_model, params, left, kind == "vae").mean()

    return gate_apply


def adapt(cfg: ExperimentConfig, variables: Optional[dict] = None,
          splits_root: Optional[str] = None, train_splits_root: Optional[str] = None,
          gate_model: Optional[torch.nn.Module] = None,
          gate_variables: Optional[Dict[str, torch.Tensor]] = None, gate_kind: str = "ae",
          step_hook=None, device: DeviceLike = None) -> Dict:
    """Run online adaptation per the reference protocol (adapt.py:187-443).

    variables: JAX-layout {'params', 'batch_stats'}; else loaded from
      cfg.load_weights_folder (either package's checkpoint, or the
      reference's .pth pair).
    splits_root / train_splits_root: split-directory overrides of the
      stream and of the training-domain (replay, train-val) dataset.
    gate_model / gate_variables / gate_kind: with cfg.adapt.gate ==
      "reconstruction", the trained AE ("ae") or VAE ("vae") whose
      reconstruction error replaces FCS as the novelty signal, and its
      weights (a state dict; analysis/reconstruction_ood.py
      train_autoencoder returns both): novel iff the error >
      cfg.adapt.ood_threshold, in the IN_PROGRESS and the DONE state.
    step_hook(step, record): called once per stream frame with fcs_raw,
      fcs_smoothed, novel, did_add, do_update, mono_loss, replay_loss, epe
      and state (the JAX engine's records).
    device: "cuda" (None) or "cpu".

    Returns {'steps', 'gradient_updates', 'steps_per_sec', 'final_metrics',
    'final_state', 'state'}.
    """
    dev = resolve_device(device)
    mc, ac, dc, oc = cfg.model, cfg.adapt, cfg.data, cfg.optim
    s, k = mc.input_scale, mc.k
    check_gate(ac.gate)
    use_recon_gate = ac.gate == "reconstruction"
    if use_recon_gate and (gate_model is None or gate_variables is None):
        raise ValueError("cfg.adapt.gate='reconstruction' requires gate_model and "
                         "gate_variables (see analysis/reconstruction_ood.py train_autoencoder)")
    log_path = os.path.join(cfg.log_dir, cfg.model_name)
    write_opt_json(log_path, cfg)

    rng = random.Random(cfg.seed)
    np.random.seed(cfg.seed)

    if variables is None:
        if cfg.load_weights_folder is None:
            raise ValueError("adapt() needs pretrained weights")
        variables = load_variables(cfg.load_weights_folder)
    model = build_model(cfg.model, dev)
    state = create_train_state(model, learning_rate=oc.learning_rate, variables=variables)

    image_scales = [s, s + k]
    mk = dict(scales=image_scales, do_hflip=False, random_crop=False, splits_root=splits_root)
    adapt_dataset = StereoDataset(dc.dataset_path, dc.dataset_name, dc.split,
                                  dc.height, dc.width, "train",
                                  load_disp_left=True, load_disp_right=True, **mk)
    adapt_val_dataset = StereoDataset(dc.dataset_path, dc.dataset_name, dc.split,
                                      dc.height, dc.width, "val",
                                      load_disp_left=True, load_disp_right=False, **mk)
    # The training-domain (replay / train-val) dataset lives under another
    # root than the stream, so it gets its own splits override.
    mk_train = dict(mk, splits_root=train_splits_root)
    train_val_dataset = StereoDataset(ac.train_dataset_path or dc.dataset_path,
                                      ac.train_dataset_name or dc.dataset_name,
                                      ac.train_split or dc.split,
                                      dc.height, dc.width, "val",
                                      load_disp_left=True, load_disp_right=False,
                                      **mk_train)

    adapt_loader = BatchLoader(adapt_dataset, dc.batch_size, shuffle=False,
                               num_workers=dc.num_workers, seed=cfg.seed)
    adapt_val_loader = BatchLoader(adapt_val_dataset, min(6, max(1, len(adapt_val_dataset))),
                                   shuffle=False, num_workers=dc.num_workers, seed=cfg.seed)
    train_val_loader = BatchLoader(train_val_dataset, min(6, max(1, len(train_val_dataset))),
                                   shuffle=False, num_workers=dc.num_workers, seed=cfg.seed)

    print("-" * 70)
    print(f"DATASET SIZES:\n  ADAPT={len(adapt_dataset)} VAL={len(adapt_val_dataset)} "
          f"TRAIN_VAL={len(train_val_dataset)}")
    print("-" * 70)

    adapt_writer = MetricsWriter(os.path.join(log_path, "adapt"))
    train_writer = MetricsWriter(os.path.join(log_path, "train"))

    use_er = ac.adapt_mode in ("ER", "VS+ER")
    use_vs = ac.adapt_mode not in ("NONSTOP", "ER", "NONE")
    if use_vs and dc.batch_size != 1:
        # The OVS stores per-frame pairs; every published configuration
        # uses batch_size=1.
        raise ValueError("VS adaptation modes require batch_size=1")

    gate_apply = gate_params = None
    if use_recon_gate:
        gate_apply = make_reconstruction_gate(gate_model, gate_kind)
        gate_params = {name: t.to(dev) for name, t in gate_variables.items()}
    fused_step = make_fused_adapt_step(
        model, s, k, smoothness_weight=ac.smoothness_weight,
        er_loss_weight=ac.er_loss_weight, use_er=use_er, use_vs=use_vs,
        ood_threshold=ac.ood_threshold, fcs_ema_weight=ac.fcs_ema_weight,
        clip_grad_norm=oc.clip_grad_norm, use_leftright=ac.leftright_consistency,
        consistency_weight=ac.consistency_weight, gate=ac.gate, gate_apply=gate_apply,
        warp_precision=ac.warp_precision)
    infer = make_infer_step(model, s, k, smoothness_weight=ac.smoothness_weight,
                            warp_precision=ac.warp_precision)
    eval_step = make_eval_step(model, s, k)
    viz_step = make_viz_step(model, s) if cfg.log_images else None
    validate_fn = make_ovs_validate_step(model, s, smoothness_weight=ac.smoothness_weight,
                                         warp_precision=ac.warp_precision)

    initial_state = State.DONE if ac.adapt_mode == "NONE" else State.IN_PROGRESS
    sm = StateMachine(initial_state, ac.ovs_buffer_size, validate_fn, rng=rng,
                      ovs_policy=ac.ovs_policy)

    trials = TrialsLog(os.path.join(log_path, "trials.csv"))

    def run_eval():
        metrics_adapt = evaluate(eval_step, model, adapt_val_loader, cfg.fast_eval,
                                 ac.num_steps)
        metrics_train = evaluate(eval_step, model, train_val_loader, cfg.fast_eval,
                                 ac.num_steps)
        return metrics_adapt, metrics_train

    if not ac.skip_initial_eval:
        print("=" * 25 + " PRE-ADAPTATION EVALUATION " + "=" * 25)
        metrics_adapt, metrics_train = run_eval()
        adapt_writer.log_scalars(metrics_adapt, {}, 0, 0, 0)
        train_writer.log_scalars(metrics_train, {}, 0, 0, 0)
        trials.append(metrics_adapt, metrics_train, {}, step=-1)

    def er_item(step_idx):
        item = train_val_dataset[step_idx % len(train_val_dataset)]
        return to_device({key: np.asarray(v)[None] for key, v in item.items()}, dev)

    def host_scalars(aux, keys):
        """The named 0-d tensors of aux in one copy to the host."""
        present = [key for key in keys if key in aux]
        values = torch.stack([aux[key].float() for key in present]).tolist()
        return dict(zip(present, values))

    scalar_keys = ("fcs_raw", "fcs_smoothed", "novel", "do_update", "Monodepth/total_loss",
                   "Replay/total_loss", "EPE", "gate_score")

    def novel_message(vals):
        if use_recon_gate:
            return (f"[ OOD ] Novel image detected! recon_loss={vals['gate_score']:.5f} "
                    f"threshold={ac.ood_threshold:.5f}")
        return (f"[ OOD ] Novel image detected! fcs_raw={vals['fcs_raw']:.3f} "
                f"fcs_smoothed={fcs_smoothed:.3f} threshold={ac.ood_threshold:.3f}")
    epoch, step, gradient_updates = 0, 0, 0
    fcs_smoothed = None           # host mirror of the device EMA
    ema = init_fcs_ema(dev)       # device-side EMA of the fused step
    final_metrics: Dict = {}
    t_start = time.time()

    for epoch in range(cfg.num_epochs):
        if ac.num_steps > 0 and step >= ac.num_steps:
            break
        t0_epoch = time.time()

        for batch_idx, raw_batch in enumerate(adapt_loader):
            do_validation = (step % ac.ovs_validate_hz == 0)
            if do_validation and sm.ovs_buffer_size() > 0 and sm.state() == State.IN_PROGRESS:
                sm.validate()
                if use_vs:
                    sm.transition(ac.val_improve_retries)

            t0 = time.time()
            batch = to_device(raw_batch, dev)
            in_progress = sm.state() == State.IN_PROGRESS

            if in_progress:
                # One step: forward, backward, FCS, OOD gate and masked Adam.
                # The reservoir decision is drawn ahead (it does not depend
                # on the FCS); the device gate applies it only if the frame
                # is novel.
                pre = sm.ovs.pre_decide(batch_idx) if use_vs else None
                er_batch = er_item(step) if use_er else batch
                state, ema, aux = fused_step(state, ema, batch, er_batch,
                                             pre.add if pre else False, gate_params)
                vals = host_scalars(aux, scalar_keys)
                fcs_raw, fcs_smoothed = vals["fcs_raw"], vals["fcs_smoothed"]
                image_is_novel = bool(vals["novel"])
                did_add_to_ovs = False
                if use_vs and image_is_novel:
                    print(novel_message(vals))
                    did_add_to_ovs = sm.commit_novel(
                        pre, batch[f"color_l/{s}"], batch[f"color_r/{s}"],
                        vals["Monodepth/total_loss"], batch_idx)
                # Count what the device did: the update is masked by the
                # pre-drawn decision, so a novel frame skips its update even
                # when the priority queue later declines to store it.
                if bool(vals["do_update"]):
                    gradient_updates += 1
                else:
                    print("[ ADAPT ] Skipping gradient update because image "
                          "was diverted to the OVS.")
            else:
                aux, _pred = infer(batch)
                if use_recon_gate:
                    aux["gate_score"] = gate_apply(gate_params, batch[f"color_l/{s}"])
                vals = host_scalars(aux, scalar_keys)
                fcs_raw = vals["fcs_raw"]
                fcs_smoothed = fcs_raw if fcs_smoothed is None else online_ema(
                    fcs_smoothed, fcs_raw, ac.fcs_ema_weight)
                # Keep the device EMA consistent for a possible restart.
                ema[0].fill_(fcs_smoothed)
                ema[1].fill_(True)
                if use_recon_gate:
                    image_is_novel = vals["gate_score"] > ac.ood_threshold
                else:
                    image_is_novel = fcs_smoothed < ac.ood_threshold
                if use_vs and image_is_novel:
                    print(novel_message(vals))
                    # DONE state: the classic add path (restarts adaptation).
                    sm.add_to_ovs(batch[f"color_l/{s}"], batch[f"color_r/{s}"],
                                  vals["Monodepth/total_loss"], batch_idx)

            adapt_writer.add_scalar("fcs/raw", fcs_raw, step)
            adapt_writer.add_scalar("fcs/smoothed", fcs_smoothed, step)

            if step_hook is not None:
                step_hook(step, {
                    "fcs_raw": fcs_raw,
                    "fcs_smoothed": fcs_smoothed,
                    "novel": bool(image_is_novel) if use_vs else False,
                    "did_add": bool(did_add_to_ovs) if in_progress else False,
                    "do_update": bool(vals["do_update"]) if in_progress else False,
                    "mono_loss": vals["Monodepth/total_loss"],
                    "replay_loss": vals.get("Replay/total_loss"),
                    "epe": vals.get("EPE"),
                    "state": sm.state().name,
                })

            elapsed = time.time() - t0
            if (step % cfg.log_frequency) == 0 and step > 0:
                metrics = {"EPE": vals["EPE"]} if "EPE" in vals else {}
                losses = {n: v for n, v in vals.items() if "loss" in n}
                adapt_writer.log_scalars(metrics, losses,
                                         dc.batch_size / max(elapsed, 1e-9), epoch, step)
                if viz_step is not None:
                    adapt_writer.log_images(batch, viz_step(batch), step)

            step += 1

            mid_eval = ac.eval_hz > 0 and step % ac.eval_hz == 0
            end_eval = ac.eval_hz <= 0 and batch_idx == len(adapt_loader) - 1
            if mid_eval or end_eval:
                print(f"=== MID-ADAPTATION EVALUATION (step {step}) ===")
                adapt_writer.add_scalar("GRADIENT_UPDATES", gradient_updates, step)
                metrics_adapt, metrics_train = run_eval()
                adapt_writer.log_scalars(metrics_adapt, {}, 0, epoch, step)
                train_writer.log_scalars(metrics_train, {}, 0, epoch, step)
                save_checkpoint(log_path, state, step,
                                {"config": cfg.to_json(), "gradient_updates": gradient_updates})
                trials.append(metrics_adapt, metrics_train,
                              {"GRADIENT_UPDATES": gradient_updates}, step)
                final_metrics = {"adapt": metrics_adapt, "train": metrics_train}

            if ac.num_steps > 0 and step >= ac.num_steps:
                break

        elapsed_epoch = time.time() - t0_epoch
        print(f"Finished {len(adapt_loader)} adaptation steps in {elapsed_epoch:.2f}s "
              f"({len(adapt_loader) / max(elapsed_epoch, 1e-9):.2f} examples/s)")

    total_time = time.time() - t_start
    adapt_writer.close()
    train_writer.close()
    return {
        "steps": step,
        "gradient_updates": gradient_updates,
        "steps_per_sec": step / max(total_time, 1e-9),
        "final_metrics": final_metrics,
        "final_state": sm.state().name,
        "state": state,
    }
