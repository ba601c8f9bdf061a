"""Command-line interface of the port (counterpart of
adaptive_stereo_tpu/cli.py): the JAX package's parser, subcommands and
flag checks:

    python -m adaptive_stereo_tpu_torch.cli train --dataset_path ... --split ...
    python -m adaptive_stereo_tpu_torch.cli adapt --adapt_mode VS+ER ...
    python -m adaptive_stereo_tpu_torch.cli adapt --engine flat [--device_cache] ...
    python -m adaptive_stereo_tpu_torch.cli adapt --engine pytree ...
    python -m adaptive_stereo_tpu_torch.cli evaluate --mode playback ...
    python -m adaptive_stereo_tpu_torch.cli timing

Flag names match the reference's (reference train.py:246-301). --device
(default cuda; every subcommand) is the one flag the JAX parser lacks; it
changes no result.
"""

from __future__ import annotations

import argparse
import sys

from .device import resolve_device
from .engine.config import (
    AdaptConfig,
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Adaptive stereo, PyTorch / CUDA port")
    sub = p.add_subparsers(dest="command", required=True)

    def add_common(sp):
        sp.add_argument("--height", type=int, default=320)
        sp.add_argument("--width", type=int, default=960)
        sp.add_argument("--model_name", type=str, default="experiment")
        sp.add_argument("--stereonet_input_scale", type=int, default=0)
        sp.add_argument("--stereonet_k", type=int, default=3, choices=[3, 4])
        sp.add_argument("--dataset_path", type=str, default="")
        sp.add_argument("--dataset_name", type=str, default="SceneFlowDriving")
        sp.add_argument("--split", type=str, default="")
        sp.add_argument("--batch_size", type=int, default=2)
        sp.add_argument("--do_hflip", action="store_true", default=False)
        sp.add_argument("--no_shuffle", action="store_true", default=False)
        sp.add_argument("--log_dir", type=str, default="training_logs")
        sp.add_argument("--load_weights_folder", default=None, type=str)
        sp.add_argument("--scheduler_step_size", default=5, type=int)
        sp.add_argument("--num_workers", type=int, default=4)
        sp.add_argument("--num_epochs", type=int, default=100)
        sp.add_argument("--log_frequency", type=int, default=250)
        sp.add_argument("--save_freq", type=int, default=1)
        sp.add_argument("--fast_eval", action="store_true", default=False)
        sp.add_argument("--learning_rate", default=1e-5, type=float)
        sp.add_argument("--clip_grad_norm", action="store_true", default=False)
        sp.add_argument("--compute_dtype", default="float32",
                        choices=["float32", "bfloat16"])
        sp.add_argument("--splits_root", default=None, type=str)
        sp.add_argument("--train_splits_root", default=None, type=str,
                        help="splits dir for the training-domain (replay) "
                             "dataset; default: auto under its dataset root")
        # Adaptation options (accepted by both, used by adapt).
        sp.add_argument("--leftright_consistency", action="store_true", default=False)
        sp.add_argument("--smoothness_weight", type=float, default=1e-3)
        sp.add_argument("--consistency_weight", type=float, default=1e-3)
        sp.add_argument("--num_steps", type=int, default=-1)
        sp.add_argument("--ovs_buffer_size", type=int, default=10)
        sp.add_argument("--skip_initial_eval", action="store_true")
        sp.add_argument("--ovs_validate_hz", type=int, default=100)
        sp.add_argument("--adapt_mode", default="VS+ER",
                        choices=["NONSTOP", "VS", "ER", "VS+ER", "NONE"])
        sp.add_argument("--val_improve_retries", type=int, default=1)
        sp.add_argument("--eval_hz", type=int, default=1000)
        sp.add_argument("--er_loss_weight", type=float, default=0.05)
        sp.add_argument("--train_dataset_path", type=str, default="")
        sp.add_argument("--train_dataset_name", type=str, default="")
        sp.add_argument("--train_split", type=str, default="")
        sp.add_argument("--ood_threshold", type=float, default=15.0)
        sp.add_argument("--fcs_ema_weight", type=float, default=0.999)
        sp.add_argument("--ovs_guard_train_epe_factor", type=float,
                        default=0.0,
                        help="streaming engines: roll back at eval "
                             "boundaries when the train-domain EPE exceeds "
                             "factor x its pre-adaptation value "
                             "(GT-supervised forgetting/collapse guard); "
                             "0 disables")
        sp.add_argument("--ovs_guard_disp_band", type=float, default=0.0,
                        help="streaming engines: roll back when the OVS "
                             "mean |disparity| leaves [ref/band, ref*band] "
                             "of the first validation's scale (catches "
                             "photometric-consistent collapse, which the "
                             "loss-threshold guard cannot see); 0 disables")
        sp.add_argument("--ovs_guard_lr_factor", type=float, default=0.0,
                        help="streaming engines: GT-FREE guard channel — "
                             "roll back when the L-R cross-consistency "
                             "error on a fixed probe pair exceeds factor x "
                             "its pre-adaptation value (healthy adaptation "
                             "repairs cross-view geometry, collapse breaks "
                             "it); 0 disables")
        sp.add_argument("--loss_dtype", default="",
                        choices=["", "float32", "bfloat16"],
                        help="flat engine: dtype of the single-sided "
                             "Monodepth loss (''/'float32' = parity; "
                             "'bfloat16' halves the full-resolution "
                             "loss-map bytes; incompatible with "
                             "--leftright_consistency)")
        sp.add_argument("--warp_precision", default="highest",
                        choices=["highest", "high", "default"],
                        help="precision of the JAX loss warp's matrix-unit "
                             "contraction; the port's warp is exact and "
                             "takes 'highest' only")
        sp.add_argument("--ovs_guard_tolerance", type=float, default=0.0,
                        help="streaming engines: roll the model/optimizer "
                             "state back to the best-validation snapshot "
                             "when an OVS validation comes in worse than "
                             "best*(1+tol); 0 disables (reference behavior)")
        # Streaming (zero-sync) engine selection — 'classic' is the
        # step-for-step reference-parity engine (engine/adapt.py).
        sp.add_argument("--engine", default="classic",
                        choices=["classic", "flat", "pytree"],
                        help="adaptation engine: classic (per-step sync, "
                             "reference parity) | flat / pytree (zero-sync "
                             "streaming, production throughput)")
        sp.add_argument("--transfer_uint8", action="store_true", default=False,
                        help="flat engine: upload stream frames as uint8")
        sp.add_argument("--fused_er_forward", action="store_true", default=False,
                        help="flat engine: batch-2 siamese stream+replay "
                             "forward (documented BN-batching deviation)")
        sp.add_argument("--done_batch", type=int, default=1,
                        help="flat engine: micro-batch N DONE-state frames "
                             "into one inference dispatch")
        sp.add_argument("--device_cache", action="store_true", default=False,
                        help="flat engine: keep the whole finite stream, ER "
                             "pool and val sets device-resident (zero "
                             "per-step uploads; bit-exact at input_scale 0)")
        sp.add_argument("--resume_from", type=str, default="",
                        help="flat engine: weights_<step> checkpoint folder "
                             "to resume a killed adaptation from — restores "
                             "the full streaming state (OVS reservoir, FCS "
                             "EMA, plateau machine, guard, counters) and "
                             "continues bit-identically")
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the model and the engine state live "
                             "(the port's only flag beyond the JAX parser's; "
                             "it changes no result)")

    add_common(sub.add_parser("train", help="supervised training"))
    add_common(sub.add_parser("adapt", help="online adaptation"))

    ev = sub.add_parser("evaluate", help="offline inference tooling")
    add_common(ev)
    ev.add_argument("--mode", choices=["save", "playback", "video", "eval"],
                    default="playback")
    ev.add_argument("--output_folder", type=str, default="eval_output")
    ev.add_argument("--limit", type=int, default=None)
    ev.add_argument("--subsplit", type=str, default="val")

    tm = sub.add_parser("timing", help="StereoNet timing benchmark")
    tm.add_argument("--iterations", type=int, default=100)
    tm.add_argument("--height", type=int, default=320)
    tm.add_argument("--width", type=int, default=1216)
    tm.add_argument("--stereonet_k", type=int, default=4)
    tm.add_argument("--compute_dtype", default="bfloat16")
    tm.add_argument("--batch_size", type=int, default=1)
    tm.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (the port's only flag beyond the JAX parser's)")
    return p


def options_to_config(opt) -> ExperimentConfig:
    return ExperimentConfig(
        model_name=opt.model_name,
        log_dir=opt.log_dir,
        load_weights_folder=opt.load_weights_folder,
        num_epochs=opt.num_epochs,
        log_frequency=opt.log_frequency,
        save_freq=opt.save_freq,
        fast_eval=opt.fast_eval,
        model=ModelConfig(k=opt.stereonet_k, input_scale=opt.stereonet_input_scale,
                          compute_dtype=opt.compute_dtype),
        optim=OptimConfig(learning_rate=opt.learning_rate,
                          scheduler_step_size=opt.scheduler_step_size,
                          clip_grad_norm=opt.clip_grad_norm),
        data=DataConfig(dataset_path=opt.dataset_path, dataset_name=opt.dataset_name,
                        split=opt.split, height=opt.height, width=opt.width,
                        batch_size=opt.batch_size, do_hflip=opt.do_hflip,
                        no_shuffle=opt.no_shuffle, num_workers=opt.num_workers),
        adapt=AdaptConfig(adapt_mode=opt.adapt_mode, num_steps=opt.num_steps,
                          ovs_buffer_size=opt.ovs_buffer_size,
                          ovs_validate_hz=opt.ovs_validate_hz,
                          val_improve_retries=opt.val_improve_retries,
                          eval_hz=opt.eval_hz, er_loss_weight=opt.er_loss_weight,
                          ood_threshold=opt.ood_threshold,
                          fcs_ema_weight=opt.fcs_ema_weight,
                          ovs_guard_tolerance=opt.ovs_guard_tolerance,
                          warp_precision=opt.warp_precision,
                          loss_dtype=opt.loss_dtype,
                          ovs_guard_disp_band=opt.ovs_guard_disp_band,
                          ovs_guard_train_epe_factor=opt.ovs_guard_train_epe_factor,
                          ovs_guard_lr_factor=opt.ovs_guard_lr_factor,
                          smoothness_weight=opt.smoothness_weight,
                          consistency_weight=opt.consistency_weight,
                          leftright_consistency=opt.leftright_consistency,
                          skip_initial_eval=opt.skip_initial_eval,
                          train_dataset_path=opt.train_dataset_path,
                          train_dataset_name=opt.train_dataset_name,
                          train_split=opt.train_split),
    )


def main(argv=None) -> int:
    opt = build_parser().parse_args(argv)

    if opt.command == "timing":
        from .analysis.timing import time_stereonet

        r = time_stereonet(n=opt.iterations, height=opt.height, width=opt.width,
                           k=opt.stereonet_k, compute_dtype=opt.compute_dtype,
                           batch_size=opt.batch_size, device=opt.device)
        print("-" * 67)
        print("-- Timing (inference only): %f sec (%f hz)"
              % (r["inference_sec"], r["inference_hz"]))
        print("-- Timing (inference + backprop): %f sec (%f hz)"
              % (r["backprop_sec"], r["backprop_hz"]))
        print("-" * 67)
        return 0

    cfg = options_to_config(opt)

    if opt.command == "train":
        from .engine.train import train

        train(cfg, splits_root=opt.splits_root, device=opt.device)
        print("Done with training!")
        return 0

    if opt.command == "adapt":
        print("\nStarting adaptation ...")
        if opt.engine == "classic":
            guard_flags = [f"--{name}" for name in (
                "ovs_guard_tolerance", "ovs_guard_disp_band", "ovs_guard_train_epe_factor",
                "ovs_guard_lr_factor") if getattr(opt, name) > 0.0]
            if guard_flags:
                # The trust-region guard lives in the streaming driver.
                raise SystemExit(
                    f"{', '.join(guard_flags)} require(s) a streaming "
                    "engine (--engine flat or --engine pytree); the "
                    "classic reference-parity engine does not implement "
                    "the guard")
            if opt.resume_from:
                raise SystemExit(
                    "--resume_from requires --engine flat; the classic "
                    "engine does not support streaming-state resume")
            if opt.loss_dtype:
                raise SystemExit("--loss_dtype requires --engine flat")
            from .engine.adapt import adapt

            adapt(cfg, splits_root=opt.splits_root, train_splits_root=opt.train_splits_root,
                  device=opt.device)
        else:
            from .engine.stream_driver import adapt_streaming

            adapt_streaming(cfg, splits_root=opt.splits_root,
                            train_splits_root=opt.train_splits_root,
                            engine=opt.engine,
                            transfer_uint8=opt.transfer_uint8,
                            fused_er_forward=opt.fused_er_forward,
                            done_batch=opt.done_batch,
                            device_cache=opt.device_cache,
                            resume_from=opt.resume_from or None,
                            device=opt.device)
        print("Done with adaptation!")
        return 0

    if opt.command == "evaluate":
        from .data import BatchLoader, StereoDataset
        from .engine.checkpoint import load_variables
        from .engine.evaluate import evaluate as run_eval
        from .engine.inference_tools import playback, render_video_frames, save_disparities
        from .engine.steps import make_eval_step
        from .models import build_model, state_dicts_from_jax

        s = cfg.model.input_scale
        model = build_model(cfg.model, resolve_device(opt.device))
        model.load_state_dicts(*state_dicts_from_jax(load_variables(cfg.load_weights_folder),
                                                     cfg.model.k))
        dataset = StereoDataset(cfg.data.dataset_path, cfg.data.dataset_name,
                                cfg.data.split, cfg.data.height, cfg.data.width,
                                opt.subsplit, scales=[s],
                                load_disp_right=False, splits_root=opt.splits_root)
        if opt.mode == "eval":
            loader = BatchLoader(dataset, max(1, cfg.data.batch_size), shuffle=False,
                                 num_workers=cfg.data.num_workers)
            metrics = run_eval(make_eval_step(model, s, cfg.model.k), model, loader,
                               cfg.fast_eval)
            print("EVAL    // " + " | ".join(f"{n}={v:.4f}"
                                             for n, v in sorted(metrics.items())))
            return 0
        if opt.mode == "save":
            n = save_disparities(model, None, dataset, opt.output_folder, s, opt.limit)
            print(f"Saved {n} disparity maps to {opt.output_folder}")
        elif opt.mode == "playback":
            r = playback(model, None, dataset, opt.output_folder, s, opt.limit)
            print(f"Playback done: mean EPE={r['EPE']:.3f} over {r['count']} images")
        else:
            n = render_video_frames(model, None, dataset, opt.output_folder, s, opt.limit)
            print(f"Rendered {n} frames to {opt.output_folder}")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
