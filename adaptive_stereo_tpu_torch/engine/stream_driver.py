"""Driver of the streaming adaptation engine: the `adapt --engine flat`
entry point (counterpart of adaptive_stereo_tpu/engine/stream_driver.py).

The same protocol and outputs as the JAX driver: the plateau state machine
(DONE / IN_PROGRESS), OVS (online validation set) validation, the
four-channel trust-region guard, experience replay, evaluation,
trials.csv, checkpoints and resume, on top of the flat engine
(engine/flat_stream.py). The host and the device synchronize only at
boundaries:
  - one read-back of the ring log at every log / validation / eval
    boundary (drain);
  - one scalar read-back per OVS validation for the plateau transition.

Differences from the JAX driver:
- engine='pytree' (engine/stream_adapt.py) and device_cache=True
  (engine/device_cache.py) are not ported yet and raise
  NotImplementedError.
- `device` (a port-only argument, "cuda" unless the caller passes "cpu")
  picks where the model and the engine state live; it changes no result.
- The stream state file is the port's own layout (per-parameter tensors,
  not JAX's flat vectors) in the same msgpack container, and it holds the
  reservoir's torch.Generator state, so a resumed run continues bit for
  bit on the CPU.
- A non-finite pre-adaptation probe leaves the guard's reference unset;
  the driver says so instead of failing to format it (JAX
  stream_driver.py:726).
- The replay frame of the next adapt step is read on a worker thread
  while this step runs (_ReplayPrefetch); the frames are the same.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from ..data import BatchLoader, StereoDataset
from ..device import DeviceLike, optional_dtype, resolve_device
from ..models import StereoModel, state_dicts_from_jax, variables_from_state_dicts
from ..ops.warp import linear_warp
from ..utils.logging_utils import MetricsWriter, TrialsLog, write_opt_json
from .adapt import State
from .checkpoint import load_variables, packb, unpackb
from .config import ExperimentConfig
from .evaluate import evaluate
from .flat_stream import (LOG_COLS, FlatStreamState, init_flat_stream_state,
                          make_flat_streaming_steps)
from .steps import make_eval_step


class TrustRegionGuard:
    """Divergence guard, four channels (framework-new; no reference
    counterpart; JAX stream_driver.py:35-300). Keeps a snapshot of the
    model / optimizer state and rolls back to it when a channel flags the
    current trajectory as diverged. Each channel is independently optional;
    all off is the reference's behavior.

    1. ``tol``: OVS-loss trust region. Rolls back when a validation
       regresses past ``best * (1 + tol)`` or comes back non-finite. After
       OVS churn (``mark_churn()``) losses on the changed buffer are not
       comparable to ``best``: the next validation re-baselines with a
       one-band ratchet, and only a catastrophic (``CHURN_HARD_FACTOR``) or
       non-finite loss rolls back.
    2. ``disp_band``: prediction-scale plausibility band over the OVS mean
       |disparity| (see check()).
    3. ``train_epe_factor``: ground-truth-supervised forgetting
       containment at eval boundaries (see check_train_epe()).
    4. ``lr_factor``: ground-truth-free left-right cross-consistency
       against its pre-adaptation value (see check_lr()).
    """

    CHURN_HARD_FACTOR = 10.0

    def __init__(self, tol: float, snapshot_fn, restore_fn,
                 disp_band: float = 0.0, train_epe_factor: float = 0.0,
                 lr_factor: float = 0.0):
        self.tol = float(tol)
        self.disp_band = float(disp_band)
        self.train_epe_factor = float(train_epe_factor)
        self.lr_factor = float(lr_factor)
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.best = float("inf")
        # Per-channel snapshots: `snap` belongs to the loss and disparity
        # channels and is always paired with `best`; the train-EPE and L-R
        # channels refresh their own (`epe_snap`, `lr_snap`).
        self.snap = None
        self.epe_snap = None
        self.lr_snap = None
        self.stale = False
        self.rollbacks = 0
        self.disp_ref = None
        self.train_epe_ref = None
        self.lr_ref = None

    @property
    def enabled(self) -> bool:
        return self.tol > 0.0 or self.disp_band > 0.0 or \
            self.train_epe_factor > 0.0 or self.lr_factor > 0.0

    def mark_churn(self):
        self.stale = True

    def check_train_epe(self, ss, train_epe: float, factor: float):
        """Third channel, at eval boundaries: roll back when the training-
        domain EPE exceeds factor x its pre-adaptation value (catastrophic
        forgetting containment). Returns (ss, rolled)."""
        if factor <= 0.0:
            return ss, False
        if self.train_epe_ref is None:
            if np.isfinite(train_epe):
                self.train_epe_ref = float(train_epe)
                self.epe_snap = self.snapshot_fn(ss)
                if self.snap is None:
                    # Also seed the loss / disparity channels' snapshot so a
                    # non-finite validation before their own first pin has a
                    # rollback target; `best` is still inf, so the pairing
                    # (snap achieved <= best) holds.
                    self.snap = self.epe_snap
            return ss, False
        if not np.isfinite(train_epe) or \
                train_epe > self.train_epe_ref * factor:
            target = self.epe_snap if self.epe_snap is not None else self.snap
            if target is None:
                return ss, False
            self.rollbacks += 1
            print(f"[ OVS-GUARD ] train-domain EPE {train_epe:.3f} exceeds "
                  f"{factor:.1f}x its pre-adaptation value "
                  f"{self.train_epe_ref:.3f} (catastrophic forgetting / "
                  f"collapse); rolling back to the last certified "
                  f"non-forgetting snapshot (rollback #{self.rollbacks})")
            # The restored trajectory invalidates the loss channel's
            # baseline: re-baseline at the next validation.
            self.stale = True
            return self.restore_fn(ss, target), True
        # In-band eval: refresh this channel's snapshot only.
        self.epe_snap = self.snapshot_fn(ss)
        return ss, False

    def check_lr(self, ss, lr_cons: float):
        """Fourth channel: left-right cross-consistency relative to its
        pre-adaptation value. Rolls back when lr_cons exceeds factor x the
        pinned reference (or is non-finite); in-band checks refresh this
        channel's own snapshot. Returns (ss, rolled)."""
        if self.lr_factor <= 0.0:
            return ss, False
        if self.lr_ref is None:
            if np.isfinite(lr_cons):
                self.lr_ref = max(float(lr_cons), 1e-6)
                self.lr_snap = self.snapshot_fn(ss)
                if self.snap is None:
                    self.snap = self.lr_snap
            return ss, False
        if not np.isfinite(lr_cons) or \
                lr_cons > self.lr_ref * self.lr_factor:
            target = self.lr_snap if self.lr_snap is not None else self.snap
            if target is None:
                return ss, False
            self.rollbacks += 1
            print(f"[ OVS-GUARD ] L-R cross-consistency {lr_cons:.3f} "
                  f"exceeds {self.lr_factor:.2f}x its pre-adaptation value "
                  f"{self.lr_ref:.3f} (geometric disagreement under a flat "
                  f"photometric loss = collapse signature); rolling back "
                  f"(rollback #{self.rollbacks})")
            self.stale = True   # re-baseline the loss channel
            return self.restore_fn(ss, target), True
        self.lr_snap = self.snapshot_fn(ss)
        return ss, False

    def pin_initial(self, ss, mean_disp: float):
        """Pin the plausible prediction scale and an initial snapshot from
        the pre-adaptation model (a collapse can complete before the first
        OVS validation)."""
        self.disp_ref = max(float(mean_disp), 1e-3)
        self.snap = self.snapshot_fn(ss)

    def check(self, ss, avg_loss: float, mean_disp: Optional[float] = None):
        """Returns (ss, rolled_back).

        mean_disp: mean |predicted disparity| over the OVS (second channel,
        active when disp_band > 0): a validation whose mean |disp| leaves
        [ref/band, ref*band] rolls back, churn or not.
        """
        if not self.enabled:
            return ss, False
        nonfinite = not np.isfinite(avg_loss)
        disp_bad = False
        if self.disp_band > 0.0 and mean_disp is not None:
            if not np.isfinite(mean_disp):
                disp_bad = True
            elif self.disp_ref is not None:
                disp_bad = (mean_disp > self.disp_ref * self.disp_band or
                            mean_disp < self.disp_ref / self.disp_band)
        if self.snap is not None and (disp_bad or nonfinite):
            self.rollbacks += 1
            if nonfinite:
                why = "is non-finite"
            elif not np.isfinite(mean_disp) or self.disp_ref is None:
                why = f"has non-finite mean |disp| ({mean_disp})"
            else:
                why = (f"mean |disp| {mean_disp:.3f} left the plausibility "
                       f"band [{self.disp_ref / self.disp_band:.3f}, "
                       f"{self.disp_ref * self.disp_band:.3f}]")
            print(f"[ OVS-GUARD ] validation {avg_loss:.5f} {why}; rolling "
                  f"back to the best snapshot (rollback #{self.rollbacks})")
            return self.restore_fn(ss, self.snap), True
        if self.tol > 0.0 and self.snap is not None and not nonfinite:
            limit = self.best * (self.CHURN_HARD_FACTOR if self.stale
                                 else (1.0 + self.tol))
            if avg_loss > limit:
                self.rollbacks += 1
                why = (f"exceeds the {'churn-hardened ' if self.stale else ''}"
                       f"limit {limit:.5f} (best {self.best:.5f})")
                print(f"[ OVS-GUARD ] validation {avg_loss:.5f} {why}; rolling "
                      f"back to the best snapshot (rollback #{self.rollbacks})")
                return self.restore_fn(ss, self.snap), True
        # Snapshot acceptance: with the disparity channel armed, only models
        # inside the inner band sqrt(disp_band) may become the snapshot (a
        # collapse lowers the photometric loss).
        disp_ok = True
        if self.disp_band > 0.0 and self.disp_ref is not None and \
                mean_disp is not None and np.isfinite(mean_disp):
            inner = float(np.sqrt(self.disp_band))
            disp_ok = (self.disp_ref / inner <= mean_disp
                       <= self.disp_ref * inner)
        if not nonfinite:
            if self.disp_ref is None and self.disp_band > 0.0 and \
                    mean_disp is not None and np.isfinite(mean_disp):
                # pin_initial was not called: the first validation pins the
                # plausible prediction scale.
                self.disp_ref = max(float(mean_disp), 1e-3)
            if not disp_ok:
                return ss, False
            if self.tol <= 0.0:
                # Loss channel off: check() does not move the snapshot (only
                # the armed channels' own policies manage it); a pure
                # disparity-band guard without pin_initial keeps its first
                # in-band validation as the snapshot.
                if self.snap is None:
                    self.snap = self.snapshot_fn(ss)
                self.stale = False
                return ss, False
            if self.stale:
                # First validation on a churned buffer: re-baseline, ratchet
                # `best` up by at most one band, and snapshot only models
                # within the band.
                cap = self.best * (1.0 + self.tol)
                if avg_loss <= cap:
                    self.best = avg_loss
                    self.snap = self.snapshot_fn(ss)
                else:
                    self.best = cap
                self.stale = False
            elif avg_loss < self.best:
                self.best = avg_loss
                self.snap = self.snapshot_fn(ss)
        return ss, False


class _PlateauMachine:
    """Host mirror of the DONE/IN_PROGRESS plateau logic (the heavy state,
    the EMA and the reservoir, lives on the device)."""

    def __init__(self, initial: State, val_improve_retries: int):
        self.state = initial
        self.initial = initial
        self.retries = val_improve_retries
        self.prev_loss = float("inf")
        self.ovs_did_change = True
        self.iters_without_improvement = 0

    def transition(self, avg_loss: float) -> State:
        print(f"[ OVS ] VALIDATION LOSS | PREVIOUS={self.prev_loss} | UPDATED={avg_loss}")
        if avg_loss >= self.prev_loss and not self.ovs_did_change:
            self.iters_without_improvement += 1
            if self.iters_without_improvement >= self.retries:
                print("[ OVS ] Transitioned to DONE!")
                self.state = State.DONE
                self.prev_loss = float("inf")
        else:
            self.ovs_did_change = False
            self.iters_without_improvement = 0
            self.prev_loss = avg_loss
        return self.state

    def restart(self):
        print("[ OVS ] RESTARTING adaptation!")
        self.state = self.initial


# The model state a guard snapshot holds and a rollback restores; the
# observations (FCS EMA, reservoir, ring log) are never rolled back.
_GUARD_LISTS = ("params", "m", "v", "buffers")


class _ReplayPrefetch:
    """Experience replay reads training-domain item step % len at every
    adapt step. That order is fixed, so the next step's item is read on a
    worker thread while this step runs; a step whose item was not read
    ahead (the first, or one after DONE steps) reads it itself."""

    def __init__(self, dataset: StereoDataset):
        self.dataset = dataset
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.ahead = None  # (index, future) of the next step's item

    def item(self, step: int) -> Dict:
        index = step % len(self.dataset)
        if self.ahead is not None and self.ahead[0] == index:
            item = self.ahead[1].result()
        else:
            item = self.dataset[index]
        following = (step + 1) % len(self.dataset)
        self.ahead = (following, self.pool.submit(self.dataset.__getitem__, following))
        return item

    def close(self) -> None:
        self.pool.shutdown(cancel_futures=True)


def guard_snapshot(ss: FlatStreamState) -> Dict:
    """Copies of the parameters, the Adam moments and count and the
    BatchNorm running statistics."""
    snap = {f: [t.detach().clone() for t in getattr(ss, f)] for f in _GUARD_LISTS}
    snap["count"] = ss.count.clone()
    return snap


@torch.no_grad()
def guard_restore(ss: FlatStreamState, snap: Dict) -> FlatStreamState:
    """Copy a snapshot back into the live tensors (the snapshot stays
    intact for later rollbacks)."""
    for f in _GUARD_LISTS:
        torch._foreach_copy_(getattr(ss, f), snap[f])
    ss.count.copy_(snap["count"])
    return ss


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _state_payload(ss: FlatStreamState) -> Dict:
    res = ss.reservoir
    return {
        "params": [_host(p) for p in ss.params], "m": [_host(t) for t in ss.m],
        "v": [_host(t) for t in ss.v], "buffers": [_host(t) for t in ss.buffers],
        "count": _host(ss.count), "lr": _host(ss.lr), "ema_value": _host(ss.ema_value),
        "ema_init": _host(ss.ema_init), "log": _host(ss.log), "log_pos": _host(ss.log_pos),
        "reservoir": {
            "left": _host(res.left), "right": _host(res.right), "values": _host(res.values),
            "reg_indices": _host(res.reg_indices), "size": _host(res.size),
            "count": _host(res.count), "generator": _host(res.generator.get_state()),
        },
    }


def _snap_payload(snap: Dict) -> Dict:
    out = {f: [_host(t) for t in snap[f]] for f in _GUARD_LISTS}
    out["count"] = _host(snap["count"])
    return out


def save_stream_checkpoint(folder: str, ss: FlatStreamState, host_state: dict,
                           guard_snap=None, guard_epe_snap=None,
                           guard_lr_snap=None) -> None:
    """Serialize the whole streaming-adaptation state: the engine state
    (parameters, Adam moments and count, BatchNorm running statistics, FCS
    EMA, the reservoir with its generator state, the ring log) into
    stream_state.msgpack, and the host side (plateau machine, guard,
    counters) into host_state.json. A resumed run continues bit for bit on
    the CPU."""
    payload = {"ss": _state_payload(ss)}
    for key, snap in (("guard_snap", guard_snap), ("guard_epe_snap", guard_epe_snap),
                      ("guard_lr_snap", guard_lr_snap)):
        if snap is not None:
            payload[key] = _snap_payload(snap)
    with open(os.path.join(folder, "stream_state.msgpack"), "wb") as f:
        f.write(packb(payload))
    with open(os.path.join(folder, "host_state.json"), "w") as f:
        json.dump(host_state, f, indent=2)


@torch.no_grad()
def load_stream_checkpoint(folder: str, ss: FlatStreamState):
    """Restore what save_stream_checkpoint wrote into ss (built by the same
    configuration), in place. Returns (ss, host_state, guard_snap,
    guard_epe_snap, guard_lr_snap), the snapshots as tensors on ss's
    device (None where none was saved)."""
    with open(os.path.join(folder, "stream_state.msgpack"), "rb") as f:
        payload = unpackb(f.read())
    dev = ss.count.device

    def tensors(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    saved = payload["ss"]
    for f in _GUARD_LISTS:
        dst = getattr(ss, f)
        if len(saved[f]) != len(dst):
            raise ValueError(f"stream state has {len(saved[f])} {f}, the engine {len(dst)}")
        torch._foreach_copy_(dst, tensors(saved[f]))
    for f in ("count", "lr", "ema_value", "ema_init", "log", "log_pos"):
        getattr(ss, f).copy_(torch.from_numpy(saved[f]))
    res, saved_res = ss.reservoir, saved["reservoir"]
    for f in ("left", "right", "values", "reg_indices", "size", "count"):
        getattr(res, f).copy_(torch.from_numpy(saved_res[f]))
    res.generator.set_state(torch.from_numpy(saved_res["generator"]))

    def snap(key):
        if key not in payload:
            return None
        out = {f: tensors(payload[key][f]) for f in _GUARD_LISTS}
        out["count"] = torch.from_numpy(payload[key]["count"]).to(dev)
        return out

    with open(os.path.join(folder, "host_state.json")) as f:
        host_state = json.load(f)
    return ss, host_state, snap("guard_snap"), snap("guard_epe_snap"), snap("guard_lr_snap")


def adapt_streaming(cfg: ExperimentConfig, variables: Optional[dict] = None,
                    splits_root: Optional[str] = None,
                    train_splits_root: Optional[str] = None,
                    log_chunk: int = 512, engine: str = "flat",
                    transfer_uint8: bool = False,
                    fused_er_forward: bool = False,
                    done_batch: int = 1,
                    device_cache: bool = False,
                    resume_from: Optional[str] = None,
                    probe_hook=None,
                    device: DeviceLike = None) -> Dict:
    """Online adaptation over the stream of cfg.data with the flat engine.

    variables: JAX-layout {'params', 'batch_stats'} (engine/checkpoint.py
      load_variables), else loaded from cfg.load_weights_folder.
    transfer_uint8: upload stream frames as uint8 and normalize on the
      device (re-quantizes resized colors; the source images are 8-bit).
    fused_er_forward: the stream and replay frames in one batch-2 forward.
    done_batch: DONE-state frames queue on the host and run N at a time in
      one eval forward; the queue flushes at every sync boundary, so the
      state machine's semantics are unchanged.
    resume_from: a weights_<step> folder holding stream_state.msgpack and
      host_state.json (written at every eval boundary): restores the whole
      streaming state and fast-forwards the stream to the saved step.
    probe_hook(step, get_variables): called at log boundaries with a
      function returning the live JAX-layout variables; read-only.
    device: "cuda" (None) or "cpu".

    Returns {'steps', 'gradient_updates', 'guard_rollbacks',
    'steps_per_sec', 'final_metrics', 'final_state', 'stream_state'}.
    """
    if engine != "flat":
        raise NotImplementedError(f"engine={engine!r} (engine/stream_adapt.py) is not ported "
                                  "yet; use engine='flat'")
    if device_cache:
        raise NotImplementedError("device_cache (engine/device_cache.py) is not ported yet")
    dev = resolve_device(device)
    mc, ac, dc, oc = cfg.model, cfg.adapt, cfg.data, cfg.optim
    # The ring must cover the longest possible gap between drains.
    log_chunk = max(log_chunk, 2 * cfg.log_frequency, 2 * max(ac.ovs_validate_hz, 1))
    s, k = mc.input_scale, mc.k
    log_path = os.path.join(cfg.log_dir, cfg.model_name)
    write_opt_json(log_path, cfg)

    if variables is None:
        if cfg.load_weights_folder is None:
            raise ValueError("adapt_streaming() needs pretrained weights")
        variables = load_variables(cfg.load_weights_folder)
    model = StereoModel(k=k, input_scale=s, maxdisp=mc.maxdisp,
                        dtype=optional_dtype(mc.compute_dtype), device=dev,
                        fused_siamese=mc.fused_siamese, fused_tower=mc.s2d_refinement)
    model.load_state_dicts(*state_dicts_from_jax(variables, k))
    hs, ws = dc.height // 2 ** s, dc.width // 2 ** s

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

    adapt_writer = MetricsWriter(os.path.join(log_path, "adapt"))
    train_writer = MetricsWriter(os.path.join(log_path, "train"))

    use_er = ac.adapt_mode in ("ER", "VS+ER")
    use_vs = ac.adapt_mode not in ("NONSTOP", "ER", "NONE")
    if use_vs and dc.batch_size != 1:
        raise ValueError("VS adaptation modes require batch_size=1")

    def to_dev(x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, non_blocking=True)

    step_kwargs = dict(
        smoothness_weight=ac.smoothness_weight,
        er_loss_weight=ac.er_loss_weight, use_er=use_er, use_vs=use_vs,
        ood_threshold=ac.ood_threshold, fcs_ema_weight=ac.fcs_ema_weight,
        clip_grad_norm=oc.clip_grad_norm,
        use_leftright=ac.leftright_consistency,
        consistency_weight=ac.consistency_weight,
        warp_precision=ac.warp_precision)
    if ac.loss_dtype:
        step_kwargs["loss_dtype"] = ac.loss_dtype
    eval_step = make_eval_step(model, s, k)

    ss = init_flat_stream_state(model, oc.learning_rate, ac.ovs_buffer_size, hs, ws,
                                log_chunk, seed=cfg.seed, device=dev)
    f_adapt, f_done, validate_step, make_done_batched = make_flat_streaming_steps(
        model, s, k, images_uint8=transfer_uint8, fused_er_forward=fused_er_forward,
        **step_kwargs)
    f_done_b = make_done_batched(done_batch) if done_batch > 1 else None

    def current_variables(ss):
        return variables_from_state_dicts(model.feature_net.state_dict(),
                                          model.stereo_net.state_dict(), k)

    def color(batch, key):
        # With transfer_uint8 the colors stay host numpy in `batch` and go up
        # as uint8 here; otherwise they were uploaded as float32.
        img = batch[key]
        if transfer_uint8 and not isinstance(img, torch.Tensor):
            img = to_dev(np.clip(np.asarray(img) * 255.0, 0, 255).round().astype(np.uint8))
        return img

    def no_gt():
        return torch.zeros((1, hs, ws, 1), dtype=torch.float32, device=dev)

    def adapt_step(ss, batch, er_batch, idx):
        return f_adapt(ss, color(batch, f"color_l/{s}"), color(batch, f"color_r/{s}"),
                       batch.get(f"gt_disp_l/{s}", no_gt()),
                       color(er_batch, f"color_l/{s}"), color(er_batch, f"color_r/{s}"),
                       er_batch.get(f"gt_disp_l/{s}", no_gt()), idx)

    def done_step(ss, batch, idx):
        return f_done(ss, color(batch, f"color_l/{s}"), color(batch, f"color_r/{s}"),
                      batch.get(f"gt_disp_l/{s}", no_gt()), idx)

    machine = _PlateauMachine(
        State.DONE if ac.adapt_mode == "NONE" else State.IN_PROGRESS,
        ac.val_improve_retries)

    # --- OVS trust-region guard (AdaptConfig.ovs_guard_tolerance) ---------
    guard = TrustRegionGuard(
        ac.ovs_guard_tolerance, guard_snapshot, guard_restore,
        disp_band=ac.ovs_guard_disp_band,
        train_epe_factor=ac.ovs_guard_train_epe_factor,
        lr_factor=ac.ovs_guard_lr_factor)

    def flip(x):
        return torch.flip(x, dims=(2,))

    if guard.lr_factor > 0.0:
        # Ground-truth-free L-R cross-consistency probe on a fixed adapt-val
        # pair, one eval-mode flipped-batch forward per OVS validation.
        first_val = next(iter(adapt_val_loader))
        probe_l = to_dev(first_val[f"color_l/{s}"][:1])
        probe_r = to_dev(first_val[f"color_r/{s}"][:1])

        @torch.no_grad()
        def lr_probe(ss):
            model.eval()
            outs = model(torch.cat([probe_l, flip(probe_r)]), torch.cat([probe_r, flip(probe_l)]),
                         side="l")
            pred = outs[f"pred_disp_l/{s}"]
            d_l, d_r = pred[0:1], flip(pred[1:2])
            warped, mask = linear_warp(d_r, d_l, max_disp=mc.maxdisp)
            mask = mask.to(warped.dtype)
            return float((torch.abs(warped - d_l) * mask).sum()
                         / torch.clamp(mask.sum(), min=1.0))

    resume_step = 0
    if resume_from is not None:
        ss, host, guard.snap, guard.epe_snap, guard.lr_snap = \
            load_stream_checkpoint(resume_from, ss)
        machine.state = State[host["machine_state"]]
        machine.prev_loss = float(host["prev_loss"])
        machine.ovs_did_change = bool(host["ovs_did_change"])
        machine.iters_without_improvement = int(host["iters_without_improvement"])
        guard.best = float(host["guard"]["best"])
        guard.stale = bool(host["guard"]["stale"])
        guard.rollbacks = int(host["guard"]["rollbacks"])
        if host["guard"].get("disp_ref") is not None:
            guard.disp_ref = float(host["guard"]["disp_ref"])
        if host["guard"].get("train_epe_ref") is not None:
            guard.train_epe_ref = float(host["guard"]["train_epe_ref"])
        if host["guard"].get("lr_ref") is not None:
            guard.lr_ref = float(host["guard"]["lr_ref"])
        resume_step = int(host["step"])
        print(f"[ RESUME ] restored streaming state at step {resume_step} "
              f"(machine={machine.state.name}, OVS size={int(ss.reservoir.size)})")

    if guard.disp_band > 0.0 and resume_from is None:
        # Pin the disparity-plausibility reference and an initial snapshot
        # from the pre-adaptation model: one eval forward over the first
        # adapt-val batch.
        first = next(iter(adapt_val_loader))
        model.eval()
        with torch.no_grad():
            pred0 = model(to_dev(first[f"color_l/{s}"]), to_dev(first[f"color_r/{s}"]),
                          side="l")[f"pred_disp_l/{s}"]
        guard.pin_initial(ss, float(torch.abs(pred0).mean()))
        print(f"[ OVS-GUARD ] pre-adaptation mean |disp| = "
              f"{guard.disp_ref:.3f}; plausibility band "
              f"[{guard.disp_ref / guard.disp_band:.3f}, "
              f"{guard.disp_ref * guard.disp_band:.3f}]")

    trials = TrialsLog(os.path.join(log_path, "trials.csv"))

    def run_eval():
        ma = evaluate(eval_step, model, adapt_val_loader, cfg.fast_eval, ac.num_steps)
        mt = evaluate(eval_step, model, train_val_loader, cfg.fast_eval, ac.num_steps)
        return ma, mt

    def save_ckpt(tag):
        v = current_variables(ss)
        folder = os.path.join(log_path, "models", f"weights_{tag}")
        os.makedirs(folder, exist_ok=True)
        payload = {"step": np.asarray(tag), "params": v["params"],
                   "batch_stats": v["batch_stats"]}
        with open(os.path.join(folder, "state.msgpack"), "wb") as fo:
            fo.write(packb(payload))
        with open(os.path.join(folder, "meta.json"), "w") as fo:
            json.dump({"config": cfg.to_json(), "gradient_updates": gradient_updates}, fo)
        # The whole streaming state beside the weights: every eval boundary
        # is a resume point (see save_stream_checkpoint).
        save_stream_checkpoint(
            folder, ss,
            {"machine_state": machine.state.name,
             "prev_loss": machine.prev_loss,
             "ovs_did_change": machine.ovs_did_change,
             "iters_without_improvement": machine.iters_without_improvement,
             "guard": {"best": guard.best, "stale": guard.stale,
                       "rollbacks": guard.rollbacks,
                       "disp_ref": guard.disp_ref,
                       "train_epe_ref": guard.train_epe_ref,
                       "lr_ref": guard.lr_ref},
             "step": int(tag), "gradient_updates": gradient_updates},
            guard_snap=guard.snap, guard_epe_snap=guard.epe_snap,
            guard_lr_snap=guard.lr_snap)

    if guard.lr_factor > 0.0 and resume_from is None:
        # Pin the pre-adaptation L-R cross-consistency before the stream.
        value = lr_probe(ss)
        ss, _ = guard.check_lr(ss, value)
        if guard.lr_ref is None:
            print(f"[ OVS-GUARD ] pre-adaptation L-R cross-consistency {value} is not "
                  f"finite; the L-R channel pins at its first finite probe")
        else:
            print(f"[ OVS-GUARD ] pre-adaptation L-R cross-consistency = "
                  f"{guard.lr_ref:.3f}; rollback above "
                  f"{guard.lr_ref * guard.lr_factor:.3f}")

    if guard.train_epe_factor > 0.0 and resume_from is None:
        # Pin the pre-adaptation train-domain EPE (the forgetting guard's
        # reference) whatever skip_initial_eval says.
        mt0 = evaluate(eval_step, model, train_val_loader, cfg.fast_eval, ac.num_steps)
        if "EPE" in mt0:
            ss, _ = guard.check_train_epe(ss, float(mt0["EPE"]), guard.train_epe_factor)
            if guard.train_epe_ref is None:
                print(f"[ OVS-GUARD ] pre-adaptation train-domain EPE {mt0['EPE']} is not "
                      f"finite; the forgetting channel pins at its first finite eval")
            else:
                print(f"[ OVS-GUARD ] pre-adaptation train-domain EPE = "
                      f"{guard.train_epe_ref:.3f}; forgetting limit "
                      f"{guard.train_epe_ref * guard.train_epe_factor:.3f}")

    if not ac.skip_initial_eval and resume_from is None:
        ma, mt = run_eval()
        adapt_writer.log_scalars(ma, {}, 0, 0, 0)
        train_writer.log_scalars(mt, {}, 0, 0, 0)
        trials.append(ma, mt, {}, step=-1)

    gradient_updates = 0
    drained_through = 0
    epoch, step = 0, 0
    if resume_from is not None:
        gradient_updates = int(host["gradient_updates"])
        step = resume_step
        drained_through = resume_step
    final_metrics: Dict = {}
    t_start = time.time()

    # DONE-state micro-batch queue of (left, right, gt, frame_idx), flushed
    # when full and at every sync boundary (drain), so the ring log always
    # covers [0, step) before a read-back.
    pending = []

    def flush_pending():
        nonlocal ss
        while f_done_b is not None and len(pending) >= done_batch:
            chunk = [pending.pop(0) for _ in range(done_batch)]
            ss = f_done_b(
                ss, torch.cat([c[0] for c in chunk]), torch.cat([c[1] for c in chunk]),
                torch.cat([c[2] for c in chunk]),
                torch.tensor([c[3] for c in chunk], dtype=torch.int32).to(dev))
        while pending:  # a tail shorter than done_batch: one frame at a time
            left, right, gt, i = pending.pop(0)
            ss = f_done(ss, left, right, gt, i)

    def drain(upto_step: int):
        """One read-back of the ring log covering [drained_through, upto_step)."""
        nonlocal drained_through, gradient_updates
        flush_pending()
        n = upto_step - drained_through
        if n <= 0:
            return
        assert n <= log_chunk, "log_chunk too small for the drain cadence"
        rows = ss.log.cpu().numpy()
        idx = [(drained_through + i) % log_chunk for i in range(n)]
        data = rows[idx]  # (n, len(LOG_COLS))
        col = {name: data[:, j] for j, name in enumerate(LOG_COLS)}
        for i in range(n):
            t = drained_through + i
            adapt_writer.add_scalar("fcs/raw", col["fcs_raw"][i], t)
            adapt_writer.add_scalar("fcs/smoothed", col["fcs_smoothed"][i], t)
        gradient_updates += int(col["do_update"].sum())
        added = int(col["did_add"].sum())
        if added:
            machine.ovs_did_change = True
            # Losses on the new buffer contents are not comparable to the
            # guard's best on the old ones: re-baseline at its next check.
            guard.mark_churn()
            print(f"[ OVS ] {added} pair(s) entered the OVS in steps "
                  f"[{drained_through}, {upto_step})")
        novel_count = int(col["novel"].sum())
        if novel_count and machine.state == State.DONE:
            # Restart, at most one drain cadence late.
            machine.restart()
        last = n - 1
        if (upto_step - 1) % cfg.log_frequency == 0 and upto_step > 1:
            adapt_writer.log_scalars(
                {"EPE": float(col["epe"][last])},
                {"Monodepth/total_loss": float(col["mono_loss"][last]),
                 "Replay/total_loss": float(col["replay_loss"][last])},
                0, epoch, upto_step - 1)
        drained_through = upto_step

    steps_per_epoch = len(adapt_loader)
    replay = _ReplayPrefetch(train_val_dataset) if use_er else None
    for epoch in range(cfg.num_epochs):
        if ac.num_steps > 0 and step >= ac.num_steps:
            break
        for batch_idx, raw_batch in enumerate(adapt_loader):
            if epoch * steps_per_epoch + batch_idx < resume_step:
                continue  # fast-forward the stream to the resume point
            if step % ac.ovs_validate_hz == 0 and step > 0:
                drain(step)
                if machine.state == State.IN_PROGRESS:
                    ss, avg, size, mean_disp = validate_step(ss)
                    if int(size) > 0 and use_vs:
                        ss, rolled = guard.check(ss, float(avg), float(mean_disp))
                        if not rolled and guard.lr_factor > 0.0:
                            ss, rolled = guard.check_lr(ss, lr_probe(ss))
                        if rolled:
                            # A rolled-back validation does not feed the
                            # plateau machine: its loss belongs to the
                            # discarded trajectory.
                            machine.iters_without_improvement = 0
                        else:
                            machine.transition(float(avg))

            if transfer_uint8:
                # Colors go up as uint8 inside color(); upload only the rest.
                batch = {key: (v if key.startswith("color") else to_dev(v))
                         for key, v in raw_batch.items()}
            else:
                batch = {key: to_dev(v) for key, v in raw_batch.items()}
            if machine.state == State.IN_PROGRESS:
                if use_er:
                    it = replay.item(step)
                    er_batch = {key: (v[None] if transfer_uint8 and key.startswith("color")
                                      else to_dev(v[None])) for key, v in it.items()}
                else:
                    er_batch = batch
                ss = adapt_step(ss, batch, er_batch, batch_idx)
            elif f_done_b is not None:
                pending.append((color(batch, f"color_l/{s}"), color(batch, f"color_r/{s}"),
                                batch.get(f"gt_disp_l/{s}", no_gt()), batch_idx))
                if len(pending) >= done_batch:
                    flush_pending()
            else:
                ss = done_step(ss, batch, batch_idx)
            step += 1

            if step % cfg.log_frequency == 0:
                drain(step)
                if probe_hook is not None:
                    # Read-only access to the live model at drain boundaries.
                    probe_hook(step, lambda: current_variables(ss))

            mid_eval = ac.eval_hz > 0 and step % ac.eval_hz == 0
            end_eval = ac.eval_hz <= 0 and batch_idx == steps_per_epoch - 1
            if mid_eval or end_eval:
                drain(step)
                adapt_writer.add_scalar("GRADIENT_UPDATES", gradient_updates, step)
                if guard.enabled:
                    adapt_writer.add_scalar("OVS_GUARD_ROLLBACKS", guard.rollbacks, step)
                ma, mt = run_eval()
                if guard.train_epe_factor > 0.0 and "EPE" in mt:
                    ss, rolled_epe = guard.check_train_epe(
                        ss, float(mt["EPE"]), guard.train_epe_factor)
                    if rolled_epe:
                        # Log and record the restored model.
                        ma, mt = run_eval()
                adapt_writer.log_scalars(ma, {}, 0, epoch, step)
                train_writer.log_scalars(mt, {}, 0, epoch, step)
                save_ckpt(step)
                trials.append(ma, mt, {"GRADIENT_UPDATES": gradient_updates}, step)
                final_metrics = {"adapt": ma, "train": mt}

            if ac.num_steps > 0 and step >= ac.num_steps:
                break

    if replay is not None:
        replay.close()
    drain(step)
    total = time.time() - t_start
    adapt_writer.close()
    train_writer.close()
    return {
        "steps": step,
        "gradient_updates": gradient_updates,
        "guard_rollbacks": guard.rollbacks,
        "steps_per_sec": step / max(total, 1e-9),
        "final_metrics": final_metrics,
        "final_state": machine.state.name,
        "stream_state": ss,
    }
