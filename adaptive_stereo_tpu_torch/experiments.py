"""Canonical experiment launcher, a copy of adaptive_stereo_tpu/experiments.py
over the port's engines: the reference's experiments/*.sh as named, typed
configurations (reference experiments/adaptation/{adapt_*.sh,
run_all_*.sh}, experiments/training/*.sh).

Each entry reproduces the exact hyperparameters of the corresponding shell
script; `run_adaptation_suite` mirrors run_all_<env>.sh (4 methods over one
domain shift, accumulating trials.csv for the results pipeline).

Usage:
    from adaptive_stereo_tpu_torch.experiments import adaptation_config, run_adaptation_suite
    cfg = adaptation_config("flying_to_vk01", "VS+ER", dataset_paths={...})
"""

from __future__ import annotations

from typing import Dict, Optional

from .device import DeviceLike
from .engine.config import (
    AdaptConfig,
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    OOD_THRESHOLD_SCENEFLOW_TRAINED,
    OOD_THRESHOLD_VKITTI_TRAINED,
)

# Domain-shift environments from the paper (reference
# experiments/adaptation/run_all_*.sh + resources/adaptation.csv).
# source model: 'sf' (SceneFlow-Flying-trained) or 'vk' (VKITTI-clone-trained)
ADAPTATION_ENVIRONMENTS: Dict[str, Dict] = {
    "flying_to_vk01": dict(source="sf", dataset_name="VirtualKitti",
                           split="virtual_kitti_01_adapt"),
    "flying_to_vk20": dict(source="sf", dataset_name="VirtualKitti",
                           split="virtual_kitti_20_adapt"),
    "flying_to_campus": dict(source="sf", dataset_name="KittiRaw",
                             split="kitti_raw_campus_adapt"),
    "flying_to_city": dict(source="sf", dataset_name="KittiRaw",
                           split="kitti_raw_city_adapt"),
    "flying_to_road": dict(source="sf", dataset_name="KittiRaw",
                           split="kitti_raw_road_adapt"),
    "clone_to_fog": dict(source="vk", dataset_name="VirtualKitti",
                         split="virtual_kitti_fog"),
    "clone_to_rain": dict(source="vk", dataset_name="VirtualKitti",
                          split="virtual_kitti_rain"),
    "clone_to_campus": dict(source="vk", dataset_name="KittiRaw",
                            split="kitti_raw_campus_adapt"),
    "clone_to_city": dict(source="vk", dataset_name="KittiRaw",
                          split="kitti_raw_city_adapt"),
    "clone_to_road": dict(source="vk", dataset_name="KittiRaw",
                          split="kitti_raw_road_adapt"),
}

# Training-domain (experience replay + train-val) per source model.
SOURCE_DOMAINS = {
    "sf": dict(train_dataset_name="SceneFlowFlying",
               train_split="sceneflow_flying_er_1000",
               ood_threshold=OOD_THRESHOLD_SCENEFLOW_TRAINED),
    "vk": dict(train_dataset_name="VirtualKitti",
               train_split="virtual_kitti_clone_er_1000",
               ood_threshold=OOD_THRESHOLD_VKITTI_TRAINED),
}

ADAPT_METHODS = ("nonstop", "vs", "er", "vs+er", "none")
_METHOD_MODE = {"nonstop": "NONSTOP", "vs": "VS", "er": "ER",
                "vs+er": "VS+ER", "none": "NONE"}


def adaptation_config(
    environment: str,
    method: str,
    dataset_paths: Dict[str, str],
    load_weights_folder: Optional[str] = None,
    log_dir: str = "training_logs",
    num_steps: int = 4000,
    height: int = 320,
    width: int = 960,
    eval_hz: int = 1000,
    ovs_validate_hz: int = 200,
) -> ExperimentConfig:
    """One adaptation run with the canonical paper hyperparameters
    (reference experiments/adaptation/adapt_vs_er.sh and siblings): k=4, s=0,
    320x960, batch 1, lr 5e-5, clip, OVS 16, validate every 200, retries 2,
    ER weight 0.05, per-source OOD threshold. The shape/cadence overrides
    serve reduced-scale runs (e.g. the readiness drill,
    scripts/run_readiness_drill.py); defaults are the paper protocol."""
    env = ADAPTATION_ENVIRONMENTS[environment]
    src = SOURCE_DOMAINS[env["source"]]
    method = method.lower()
    return ExperimentConfig(
        model_name=f"adapt_{environment}_{method}",
        log_dir=log_dir,
        load_weights_folder=load_weights_folder,
        num_epochs=100,
        log_frequency=20,
        model=ModelConfig(k=4, input_scale=0),
        optim=OptimConfig(learning_rate=5e-5, scheduler_step_size=100000,
                          clip_grad_norm=True),
        data=DataConfig(
            dataset_path=dataset_paths.get(env["dataset_name"], ""),
            dataset_name=env["dataset_name"], split=env["split"],
            height=height, width=width, batch_size=1,
        ),
        adapt=AdaptConfig(
            adapt_mode=_METHOD_MODE[method], num_steps=num_steps,
            ovs_buffer_size=16, ovs_validate_hz=ovs_validate_hz,
            val_improve_retries=2,
            eval_hz=eval_hz, er_loss_weight=0.05,
            ood_threshold=src["ood_threshold"],
            train_dataset_path=dataset_paths.get(src["train_dataset_name"], ""),
            train_dataset_name=src["train_dataset_name"],
            train_split=src["train_split"],
            skip_initial_eval=(method != "nonstop"),
        ),
    )


def training_config(
    dataset: str,
    dataset_path: str,
    log_dir: str = "training_logs",
    k: int = 4,
    input_scale: int = 0,
) -> ExperimentConfig:
    """Supervised pretraining (reference experiments/training/*.sh shapes):
    320x960 crops, Adam 1e-4 halved every 5 epochs, hflip augmentation."""
    split = {"SceneFlowFlying": "sceneflow_flying",
             "VirtualKitti": "virtual_kitti_clone_aug"}[dataset]
    return ExperimentConfig(
        model_name=f"stereonet_{split}_320x960_L{input_scale}_{2**(k+input_scale)}X",
        log_dir=log_dir,
        num_epochs=20,
        model=ModelConfig(k=k, input_scale=input_scale),
        optim=OptimConfig(learning_rate=1e-4, scheduler_step_size=5,
                          clip_grad_norm=True),
        data=DataConfig(dataset_path=dataset_path, dataset_name=dataset,
                        split=split, height=320, width=960, batch_size=8,
                        do_hflip=True),
    )


def run_adaptation_suite(environment: str, dataset_paths: Dict[str, str],
                         load_weights_folder: str,
                         log_dir: str = "training_logs",
                         methods=("nonstop", "vs", "er", "vs+er"),
                         streaming: bool = True,
                         device: DeviceLike = None,
                         **config_overrides) -> Dict[str, str]:
    """run_all_<environment>.sh equivalent: run every method over one domain
    shift, with the streaming driver (engine/stream_driver.py, the flat
    engine) or, with streaming=False, the classic engine (engine/adapt.py).
    Returns {method: trials.csv path}. config_overrides are forwarded to
    adaptation_config (num_steps/height/width/eval_hz/ovs_validate_hz);
    device: "cuda" (None) or "cpu"."""
    import os

    trials = {}
    for method in methods:
        cfg = adaptation_config(environment, method, dataset_paths,
                                load_weights_folder, log_dir,
                                **config_overrides)
        if streaming:
            from .engine.stream_driver import adapt_streaming

            adapt_streaming(cfg, device=device)
        else:
            from .engine.adapt import adapt

            adapt(cfg, device=device)
        trials[method] = os.path.join(log_dir, cfg.model_name, "trials.csv")
    return trials
