"""Named, serializable experiment configuration (a copy of
adaptive_stereo_tpu/engine/config.py: dataclasses only, the same fields,
defaults and JSON form, so a config written by either package loads in
the other).

The reference drives everything through a single ~40-flag argparse object
(reference train.py:246-301) with canonical hyperparameter sets scattered
across experiments/**/*.sh. Here the same surface is factored into typed
dataclasses with JSON round-tripping, plus named presets reproducing the
reference's canonical experiment configurations
(experiments/adaptation/adapt_vs_er.sh, regression.sh, run_all_*.sh).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ModelConfig:
    """StereoNet architecture (reference stereo_net.py:137-166)."""

    k: int = 3                     # cost-volume downsampling factor (3 or 4)
    input_scale: int = 0           # input/output scale (1 = 1/2 resolution)
    maxdisp: int = 192             # max disparity at FULL resolution
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' (params stay f32)
    # Performance options (documented BN-batching deviation / exact layout
    # twin — see PERFORMANCE.md "BN deviations A/B" for the measured
    # behavioral cost at paper scale):
    fused_siamese: bool = False    # one batch-2 feature forward per view pair
    # The JAX space-to-depth refinement tower (exact); in the port it selects
    # the refinement-tower kernels, StereoModel(fused_tower=True).
    s2d_refinement: bool = False

    @property
    def scales(self) -> List[int]:
        return [self.input_scale, self.input_scale + self.k]


@dataclass
class OptimConfig:
    """Adam + epoch-halving schedule (reference train.py:166-167)."""

    learning_rate: float = 1e-5
    scheduler_step_size: int = 5   # halve LR every N epochs
    clip_grad_norm: bool = False   # clip stereo_net grads to global norm 1.0


@dataclass
class DataConfig:
    dataset_path: str = ""
    dataset_name: str = "SceneFlowDriving"
    split: str = ""
    height: int = 320
    width: int = 960
    batch_size: int = 2
    do_hflip: bool = False
    no_shuffle: bool = False
    num_workers: int = 4


@dataclass
class AdaptConfig:
    """Online adaptation engine knobs (reference adapt.py + TrainOptions)."""

    adapt_mode: str = "VS+ER"      # NONSTOP | VS | ER | VS+ER | NONE
    num_steps: int = -1
    ovs_buffer_size: int = 10
    # 'reservoir' (reference behavior) | 'priority_queue' (keep worst-loss
    # pairs; the reference builds this buffer but never wires it — SURVEY §2
    # C11; under it a novel frame always diverts from the gradient update
    # even when the heap rejects the pair).
    ovs_policy: str = "reservoir"
    ovs_validate_hz: int = 100
    val_improve_retries: int = 1
    eval_hz: int = 1000
    er_loss_weight: float = 0.05
    # Novelty signal for the OOD gate: 'fcs' (live reference path, novel iff
    # smoothed FCS < ood_threshold) | 'reconstruction' (graveyard
    # adapt_vae.py baseline: novel iff AE/VAE recon loss > ood_threshold;
    # pass gate_model/gate_variables to engine.adapt.adapt).
    gate: str = "fcs"
    ood_threshold: float = 15.0
    # OVS trust-region guard (framework-new robustness; no reference
    # counterpart — motivated by an observed VS divergence at paper scale,
    # artifacts/paper_scale_r3/ANALYSIS.md). At every OVS validation the
    # driver snapshots model+optimizer state when the validation loss makes
    # a new best; if a later validation comes in worse than
    # best * (1 + ovs_guard_tolerance) the stream state rolls back to the
    # best snapshot (observations — FCS EMA, reservoir, logs — are kept).
    # 0.0 disables the guard (exact reference behavior).
    ovs_guard_tolerance: float = 0.0
    fcs_ema_weight: float = 0.999
    smoothness_weight: float = 1e-3
    consistency_weight: float = 1e-3
    leftright_consistency: bool = False
    # Precision of the JAX loss warp's matrix-unit contraction: "highest" =
    # exact grid_sample parity (default). The port's warp is exact and
    # accepts "highest" only (engine/flat_stream.py).
    warp_precision: str = "highest"
    # Dtype of the single-sided Monodepth loss in the flat streaming engine
    # ('' = float32; 'bfloat16' halves the bytes of the full-resolution loss
    # maps). Flat engine only; a reduced dtype is incompatible with
    # leftright_consistency (the L-R loss has no reduced-dtype form).
    loss_dtype: str = ""
    # Second guard channel: roll back when the OVS mean |predicted disparity|
    # leaves [ref/band, ref*band] of the first validation's scale — catches
    # photometric-consistent collapse, which keeps the OVS LOSS flat and is
    # invisible to ovs_guard_tolerance (measured:
    # artifacts/paper_scale_r4/ANALYSIS.md). 0 disables.
    ovs_guard_disp_band: float = 0.0
    # Third guard channel (eval-boundary, GT-supervised): roll back when the
    # TRAIN-domain EPE exceeds factor x its pre-adaptation value
    # (catastrophic-forgetting containment — the one signal measured to
    # catch photometric-consistent collapse; artifacts/paper_scale_r4).
    # 0 disables.
    ovs_guard_train_epe_factor: float = 0.0
    # Fourth guard channel (OVS-validation boundary, GT-FREE): roll back
    # when the L-R cross-consistency error on a fixed probe pair exceeds
    # factor x its pre-adaptation value. The round-5 study measured healthy
    # adaptation REPAIRING cross-view geometry (29.2 -> 5.6) while
    # photometric-consistent collapse breaks it (-> 30-44) — 5.3x
    # late-stage separation with no ground truth required
    # (artifacts/gtfree_study_r5/ANALYSIS.md; measured factor 1.3 separates
    # all three studied trajectories). 0 disables.
    ovs_guard_lr_factor: float = 0.0
    skip_initial_eval: bool = False
    # Experience-replay (training-domain) dataset.
    train_dataset_path: str = ""
    train_dataset_name: str = ""
    train_split: str = ""


@dataclass
class ExperimentConfig:
    """Top-level config mirroring the full TrainOptions surface."""

    model_name: str = "experiment"
    log_dir: str = "training_logs"
    load_weights_folder: Optional[str] = None
    num_epochs: int = 100
    log_frequency: int = 250
    save_freq: int = 1
    fast_eval: bool = False
    seed: int = 123
    # TensorBoard image panels (reference train.py:44-71) at the scalar-log
    # cadence. Off by default on the streaming path: each panel dump is a
    # full-image device readback.
    log_images: bool = True

    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    adapt: AdaptConfig = field(default_factory=AdaptConfig)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True, indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        d = json.loads(s)
        return cls(
            **{k: v for k, v in d.items() if k not in ("model", "optim", "data", "adapt")},
            model=ModelConfig(**d.get("model", {})),
            optim=OptimConfig(**d.get("optim", {})),
            data=DataConfig(**d.get("data", {})),
            adapt=AdaptConfig(**d.get("adapt", {})),
        )


def regression_adapt_config() -> ExperimentConfig:
    """The reference's adaptation regression run
    (experiments/adaptation/regression.sh): VKITTI-01 stream, k=3 s=1,
    VS+ER, lr 5e-5, 4000 steps."""
    return ExperimentConfig(
        model_name="stereonet_adapt_regression",
        num_epochs=1,
        log_frequency=20,
        model=ModelConfig(k=3, input_scale=1),
        optim=OptimConfig(learning_rate=5e-5, scheduler_step_size=100000, clip_grad_norm=True),
        data=DataConfig(
            dataset_name="VirtualKitti", split="virtual_kitti_01_adapt",
            height=320, width=960, batch_size=1,
        ),
        adapt=AdaptConfig(
            adapt_mode="VS+ER", num_steps=4000, ovs_buffer_size=8,
            ovs_validate_hz=20, val_improve_retries=2, eval_hz=100,
            er_loss_weight=0.05, train_dataset_name="SceneFlowFlying",
            train_split="sceneflow_flying_er_1000", skip_initial_eval=True,
        ),
    )


def canonical_adapt_config(ood_threshold: float) -> ExperimentConfig:
    """The canonical paper adaptation configuration
    (experiments/adaptation/adapt_vs_er.sh): k=4 s=0, 320x960, lr 5e-5,
    4000 steps, OVS 16, validate every 200, retries 2, ER weight 0.05."""
    return ExperimentConfig(
        num_epochs=100,
        log_frequency=20,
        model=ModelConfig(k=4, input_scale=0),
        optim=OptimConfig(learning_rate=5e-5, scheduler_step_size=100000, clip_grad_norm=True),
        data=DataConfig(height=320, width=960, batch_size=1),
        adapt=AdaptConfig(
            adapt_mode="VS+ER", num_steps=4000, ovs_buffer_size=16,
            ovs_validate_hz=200, val_improve_retries=2, eval_hz=1000,
            er_loss_weight=0.05, ood_threshold=ood_threshold, skip_initial_eval=True,
        ),
    )


# OOD FCS thresholds derived by the reference's analysis
# (experiments/adaptation/run_all_flying_to_vk20.sh:3, run_all_clone_to_fog.sh:3).
OOD_THRESHOLD_SCENEFLOW_TRAINED = 12.760914523256847
OOD_THRESHOLD_VKITTI_TRAINED = 11.898818196844609
