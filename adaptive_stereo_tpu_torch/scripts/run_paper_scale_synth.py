"""The paper-scale adaptation protocol on synthetic data, on the port
(counterpart of scripts/run_paper_scale_synth.py).

Runs the reference experiment protocol (experiments/adaptation/
run_all_*.sh + evaluation/ood_analysis.py + preprocess_adapt_results.py)
at the canonical configuration, 320x960, k=4, s=0, lr 5e-5, 4000 steps,
ovs_validate_hz 200, ovs_buffer_size 16, val_improve_retries 2 (reference
adapt_vs_er.sh), with synthetic stereo domains standing in for the real
datasets:

  phase 0  generate train + domain-shifted novel datasets (exact GT)
  phase 1  supervised pretraining on the train domain
  phase 2  FCS OOD analysis: train vs novel distributions, PR curve, and the
           percentile-derived threshold (reference ood_analysis.py:196-236)
  phase 3  4-method adaptation suite (NONSTOP/VS/ER/VS+ER) x N configs:
             faithful  reference BN semantics (sequential batch-1
                       forwards), f32, the refinement module
             fused     fused_siamese + fused_er_forward BN batching and the
                       refinement-tower kernels, f32
             bench     fused + bfloat16 compute (bench.py's configuration)
  phase 4  collate trials -> results_<config>.csv, plots, and the trials

Artifacts land under --artifacts (default <work>/artifacts); datasets and
checkpoints under --work. Every phase skips itself if its outputs exist,
so the run is resumable.

Usage:
  python -m adaptive_stereo_tpu_torch.scripts.run_paper_scale_synth --through 2
  python -m adaptive_stereo_tpu_torch.scripts.run_paper_scale_synth --configs faithful fused
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

METHODS = [("nonstop", "NONSTOP"), ("vs", "VS"), ("er", "ER"), ("vs+er", "VS+ER")]
CONFIGS = {
    # name -> (fused_siamese/s2d/fused_er_forward, compute_dtype)
    "faithful": dict(fused=False, dtype="float32"),
    "fused": dict(fused=True, dtype="float32"),
    "bench": dict(fused=True, dtype="bfloat16"),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--work", default=os.path.join(tempfile.gettempdir(),
                                                  "paper_scale_synth_torch"))
    p.add_argument("--artifacts", default=None, help="default: <work>/artifacts")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--input_scale", type=int, default=0)
    p.add_argument("--max_disp_gt", type=float, default=64.0)
    p.add_argument("--n_train", type=int, default=120)
    p.add_argument("--n_val", type=int, default=24)
    p.add_argument("--n_novel", type=int, default=500)
    p.add_argument("--pretrain_steps", type=int, default=3000)
    p.add_argument("--pretrain_lr", type=float, default=1e-4)
    p.add_argument("--adapt_steps", type=int, default=4000)
    p.add_argument("--eval_hz", type=int, default=1000)
    p.add_argument("--percentile", type=float, default=0.05)
    p.add_argument("--configs", nargs="*", default=["faithful", "fused", "bench"])
    p.add_argument("--methods", nargs="*", default=[m for m, _ in METHODS])
    p.add_argument("--through", type=int, default=4, help="run phases 0..N then stop")
    p.add_argument("--num_workers", type=int, default=6)
    p.add_argument("--shift_kind", default="night", choices=["photometric", "fog", "night"],
                   help="novel-domain shift (data/synthetic.py): night = consistent fog + "
                        "inversion, the largest adaptable gap")
    p.add_argument("--name_suffix", default="",
                   help="suffix for adaptation run names (probe runs that must not collide "
                        "with the main suite)")
    p.add_argument("--ovs_guard_tolerance", type=float, default=0.0,
                   help="enable the OVS trust-region guard for phase-3 runs")
    p.add_argument("--ovs_guard_disp_band", type=float, default=0.0,
                   help="second guard channel: mean-|disp| plausibility band")
    p.add_argument("--ovs_guard_train_epe_factor", type=float, default=0.0,
                   help="third guard channel: train-domain EPE forgetting limit")
    p.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    a = p.parse_args(argv)
    if a.artifacts is None:
        a.artifacts = os.path.join(a.work, "artifacts")
    return a


T0 = time.perf_counter()


def log(msg):
    print(f"[paper_scale +{time.perf_counter() - T0:8.1f}s] {msg}", flush=True)


def phase0_data(a):
    from ..data import generate_synthetic_dataset

    train_root = os.path.join(a.work, "train_domain")
    novel_root = os.path.join(a.work, "novel_domain")
    if os.path.exists(os.path.join(novel_root, "splits")):
        log("phase 0: datasets exist, skipping")
        return train_root, novel_root
    log(f"phase 0: generating {a.n_train}+{a.n_val} train-domain and "
        f"{a.n_novel}+{a.n_val} novel-domain pairs at {a.height}x{a.width}")
    generate_synthetic_dataset(train_root, name="synth", num_train=a.n_train, num_val=a.n_val,
                               height=a.height, width=a.width, max_disp=a.max_disp_gt, seed=0)
    generate_synthetic_dataset(novel_root, name="synth", num_train=a.n_novel, num_val=a.n_val,
                               height=a.height, width=a.width, max_disp=a.max_disp_gt, seed=50,
                               domain_shift=True, shift_kind=a.shift_kind)
    log("phase 0: done")
    return train_root, novel_root


def base_cfg(a, train_root, name, cfg_opts=None):
    from ..engine import (AdaptConfig, DataConfig, ExperimentConfig, ModelConfig,
                          OptimConfig)

    cfg_opts = cfg_opts or CONFIGS["faithful"]
    return ExperimentConfig(
        model_name=name, log_dir=os.path.join(a.work, "logs"),
        num_epochs=1000, log_frequency=200, save_freq=1000,
        model=ModelConfig(k=a.k, input_scale=a.input_scale, compute_dtype=cfg_opts["dtype"],
                          fused_siamese=cfg_opts["fused"], s2d_refinement=cfg_opts["fused"]),
        optim=OptimConfig(learning_rate=5e-5, scheduler_step_size=100000, clip_grad_norm=True),
        data=DataConfig(dataset_path=train_root, dataset_name="Synthetic", split="synth",
                        height=a.height, width=a.width, batch_size=1,
                        num_workers=a.num_workers),
        adapt=AdaptConfig())


def model_variables(model):
    """JAX-layout {'params', 'batch_stats'} (numpy) of a StereoModel."""
    from ..models import variables_from_state_dicts

    return variables_from_state_dicts(model.feature_net.state_dict(),
                                      model.stereo_net.state_dict(), model.feature_net.k)


def phase1_pretrain(a, train_root):
    from ..engine import train
    from ..engine.checkpoint import load_variables, save_variables

    ckpt = os.path.join(a.work, "logs", "pretrain", "models", "weights_final")
    if os.path.exists(ckpt):
        log("phase 1: pretrained checkpoint exists, skipping")
        return ckpt, load_variables(ckpt)
    steps_per_epoch = max(1, a.n_train // 2)
    epochs = max(1, a.pretrain_steps // steps_per_epoch)
    log(f"phase 1: supervised pretraining {epochs} epochs "
        f"(~{epochs * steps_per_epoch} steps, batch 2, lr {a.pretrain_lr})")
    cfg = base_cfg(a, train_root, "pretrain")
    cfg.num_epochs = epochs
    cfg.optim.learning_rate = a.pretrain_lr
    cfg.optim.scheduler_step_size = max(1, epochs // 2)  # one halving mid-run
    cfg.data.batch_size = 2
    cfg.fast_eval = True
    result = train(cfg, device=a.device)
    log(f"phase 1: final metrics {result['final_metrics']}")
    variables = model_variables(result["state"].model)
    save_variables(ckpt, variables)
    with open(os.path.join(a.artifacts, "pretrain_metrics.json"), "w") as f:
        json.dump({k: float(v) for k, v in result["final_metrics"].items()}, f, indent=2)
    return ckpt, variables


def phase2_ood(a, train_root, novel_root, variables):
    import torch

    from ..analysis import ood
    from ..data import BatchLoader, StereoDataset
    from ..models import StereoModel, state_dicts_from_jax
    from ..ops import feature_contrast_mean

    out_json = os.path.join(a.artifacts, "ood_threshold.json")
    if os.path.exists(out_json):
        with open(out_json) as f:
            d = json.load(f)
        log(f"phase 2: threshold exists ({d['threshold']:.4f}), skipping")
        return d["threshold"]

    s, k = a.input_scale, a.k
    model = StereoModel(k=k, input_scale=s, device=a.device)

    def loader(root, subsplit):
        ds = StereoDataset(root, "Synthetic", "synth", a.height, a.width, subsplit,
                           scales=[s, s + k], do_hflip=False, random_crop=False)
        return BatchLoader(ds, 4, shuffle=False, num_workers=a.num_workers, seed=0)

    log("phase 2: computing FCS distributions (train-domain train split vs novel stream)")
    fcs_train = ood.compute_fcs_for_loader(model, variables, loader(train_root, "train"), s, k)
    fcs_novel = ood.compute_fcs_for_loader(model, variables, loader(novel_root, "train"), s, k,
                                           max_batches=a.n_train // 4)
    thr = ood.derive_percentile_threshold(fcs_train, percentile=a.percentile)
    pr, re = ood.compute_precision_recall(fcs_train, fcs_novel, thr)

    # Diagnostic: FCS as the gate sees it, train-mode BN (batch statistics),
    # batch 1 (the IN_PROGRESS forward, reference adapt.py:313-314). The
    # threshold stays eval-derived (reference ood_analysis.py), but the run
    # is only meaningful if train-mode novel FCS crosses it. The model is
    # this phase's own: the running statistics it updates are not kept.
    model.load_state_dicts(*state_dicts_from_jax(variables, k))
    model.train()
    dev = next(model.parameters()).device

    @torch.no_grad()
    def fcs_train_mode(left, right):
        out = model(left, right, side="l", output_cost_volume=True)
        return float(torch.mean(feature_contrast_mean(out[f"cost_volume_l/{s + k}"])))

    def train_mode_scores(root, n=32):
        scores = []
        for i, b in enumerate(loader(root, "train")):
            if i * 4 >= n:
                break
            for j in range(b[f"color_l/{s}"].shape[0]):
                scores.append(fcs_train_mode(torch.from_numpy(b[f"color_l/{s}"][j:j + 1]).to(dev),
                                             torch.from_numpy(b[f"color_r/{s}"][j:j + 1]).to(dev)))
        return np.asarray(scores)

    tm_train = train_mode_scores(train_root)
    tm_novel = train_mode_scores(novel_root)
    gate_fire_rate = float((tm_novel < thr).mean())
    log(f"phase 2: TRAIN-MODE FCS train {tm_train.mean():.3f}+-{tm_train.std():.3f} "
        f"novel {tm_novel.mean():.3f}+-{tm_novel.std():.3f}; "
        f"novel frames below eval-derived threshold: {100 * gate_fire_rate:.0f}%")

    # Threshold selection: the reference derives from the eval distribution
    # and applies it to train-mode scores (ood_analysis.py -> adapt.py). If
    # the gate would never or always fire here, the same percentile of the
    # train-mode training-domain distribution is used instead; the json
    # records both and which was used.
    thr_eval = float(thr)
    thr_tm = ood.derive_percentile_threshold(tm_train, percentile=a.percentile)
    tm_fpr = float((tm_train < thr).mean())
    threshold_source = "eval"
    if gate_fire_rate < 0.10 or tm_fpr > 0.50:
        thr = float(thr_tm)
        threshold_source = "trainmode"
        gate_fire_rate = float((tm_novel < thr).mean())
        log(f"phase 2: eval-derived threshold unusable for the train-mode gate; using "
            f"train-mode-derived {thr:.4f} (novel fire rate {100 * gate_fire_rate:.0f}%)")
    d = {
        "threshold": float(thr), "percentile": a.percentile,
        "fcs_train_mean": float(fcs_train.mean()), "fcs_train_std": float(fcs_train.std()),
        "fcs_novel_mean": float(fcs_novel.mean()), "fcs_novel_std": float(fcs_novel.std()),
        "precision_at_threshold": float(pr), "recall_at_threshold": float(re),
        "n_train": int(fcs_train.size), "n_novel": int(fcs_novel.size),
        "trainmode_fcs_train_mean": float(tm_train.mean()),
        "trainmode_fcs_train_std": float(tm_train.std()),
        "trainmode_fcs_novel_mean": float(tm_novel.mean()),
        "trainmode_fcs_novel_std": float(tm_novel.std()),
        "trainmode_gate_fire_rate": gate_fire_rate,
        "threshold_eval_derived": thr_eval,
        "threshold_trainmode_derived": float(thr_tm),
        "threshold_source": threshold_source,
    }
    log(f"phase 2: FCS train {d['fcs_train_mean']:.3f}+-{d['fcs_train_std']:.3f} "
        f"novel {d['fcs_novel_mean']:.3f}+-{d['fcs_novel_std']:.3f} "
        f"threshold {thr:.4f} (P={pr:.3f} R={re:.3f})")
    with open(out_json, "w") as f:
        json.dump(d, f, indent=2)
    ood.plot_fcs_histogram(fcs_train, fcs_novel, os.path.join(a.artifacts, "fcs_histogram.pdf"),
                           percentile=a.percentile)
    ood.plot_precision_recall(fcs_train, fcs_novel,
                              os.path.join(a.artifacts, "fcs_pr_curve.pdf"))
    np.savez(os.path.join(a.artifacts, "fcs_distributions.npz"), train=fcs_train,
             novel=fcs_novel)
    return float(thr)


def phase3_suite(a, train_root, novel_root, variables, threshold):
    from ..engine.stream_driver import adapt_streaming

    results = {}
    for cname in a.configs:
        copts = CONFIGS[cname]
        for method, mode in METHODS:
            if method not in a.methods:
                continue
            run_name = f"adapt_{cname}_{method}{a.name_suffix}"
            trials_csv = os.path.join(a.work, "logs", run_name, "trials.csv")
            if os.path.exists(trials_csv):
                log(f"phase 3: {run_name} trials exist, skipping")
                results[(cname, method)] = trials_csv
                continue
            log(f"phase 3: {run_name} ({a.adapt_steps} steps, mode {mode}, "
                f"fused={copts['fused']}, dtype={copts['dtype']})")
            cfg = base_cfg(a, train_root, run_name, copts)
            cfg.data.dataset_path = novel_root
            cfg.adapt.adapt_mode = mode
            cfg.adapt.num_steps = a.adapt_steps
            cfg.adapt.eval_hz = a.eval_hz
            cfg.adapt.ovs_buffer_size = 16
            cfg.adapt.ovs_validate_hz = 200
            cfg.adapt.val_improve_retries = 2
            cfg.adapt.er_loss_weight = 0.05
            cfg.adapt.ood_threshold = threshold
            cfg.adapt.train_dataset_path = train_root
            cfg.adapt.train_dataset_name = "Synthetic"
            cfg.adapt.train_split = "synth"
            # Pre-adaptation row once per config (the reference table's
            # 0-step EPE; other methods share the same pretrained weights).
            cfg.adapt.skip_initial_eval = (method != "nonstop")
            cfg.adapt.ovs_guard_tolerance = a.ovs_guard_tolerance
            cfg.adapt.ovs_guard_disp_band = a.ovs_guard_disp_band
            cfg.adapt.ovs_guard_train_epe_factor = a.ovs_guard_train_epe_factor
            t0 = time.perf_counter()
            # device_cache: the whole stream lives in device memory (bit-exact
            # at s=0 with the upload path, engine/device_cache.py).
            r = adapt_streaming(cfg, variables=variables, fused_er_forward=copts["fused"],
                                device_cache=True, device=a.device)
            dt = time.perf_counter() - t0
            log(f"phase 3: {run_name} done in {dt:.0f}s — "
                f"updates={r['gradient_updates']}/{r['steps']} "
                f"final_state={r['final_state']} "
                f"steps/s={r['steps_per_sec']:.2f} "
                f"EPE_adapt={r['final_metrics']['adapt']['EPE']:.3f} "
                f"EPE_train={r['final_metrics']['train']['EPE']:.3f}")
            results[(cname, method)] = trials_csv
            with open(os.path.join(a.artifacts, f"{run_name}_summary.json"), "w") as f:
                json.dump({"gradient_updates": r["gradient_updates"],
                           "guard_rollbacks": r.get("guard_rollbacks", 0),
                           "steps": r["steps"],
                           "steps_per_sec": r["steps_per_sec"],
                           "final_state": r["final_state"],
                           "EPE_adapt": float(r["final_metrics"]["adapt"]["EPE"]),
                           "EPE_train": float(r["final_metrics"]["train"]["EPE"]),
                           "wall_s": dt}, f, indent=2)
    return results


def table_text(table) -> str:
    """A {column: list} table as right-aligned text columns, no index (the
    layout of pandas' to_string(index=False))."""
    cols = [[name] + [f"{v:.6f}" if isinstance(v, float) else str(v) for v in values]
            for name, values in table.items()]
    widths = [max(len(c) for c in col) for col in cols]
    return "\n".join(" ".join(col[i].rjust(w) for col, w in zip(cols, widths))
                     for i in range(len(cols[0]) if cols else 0))


def phase4_collate(a, results):
    from ..analysis.results import (collate_trials, plot_adaptation_curves,
                                    plot_gradient_updates_bar, results_to_csv)

    steps = tuple(range(a.eval_hz, a.adapt_steps + 1, a.eval_hz))
    for cname in a.configs:
        trials = {m: results[(cname, m)] for m, _ in METHODS if (cname, m) in results}
        if not trials:
            continue
        table = collate_trials(trials, steps=steps)
        csv = os.path.join(a.artifacts, f"results_{cname}.csv")
        results_to_csv(trials, csv, steps=steps)
        plot_adaptation_curves(table, os.path.join(a.artifacts, f"adaptation_curves_{cname}.pdf"))
        plot_gradient_updates_bar(table,
                                  os.path.join(a.artifacts, f"gradient_updates_{cname}.pdf"),
                                  step=a.adapt_steps)
        log(f"phase 4: wrote {csv}")
        print(table_text(table), flush=True)
        # Copy per-run trials.csv next to the results for the record.
        for m, path in trials.items():
            shutil.copy(path, os.path.join(a.artifacts,
                                           f"trials_{cname}_{m.replace('+', '_')}.csv"))


def main(argv=None) -> int:
    a = parse_args(argv)
    os.makedirs(a.work, exist_ok=True)
    os.makedirs(a.artifacts, exist_ok=True)

    train_root, novel_root = phase0_data(a)
    if a.through < 1:
        return 0
    ckpt, variables = phase1_pretrain(a, train_root)
    if a.through < 2:
        return 0
    threshold = phase2_ood(a, train_root, novel_root, variables)
    if a.through < 3:
        return 0
    results = phase3_suite(a, train_root, novel_root, variables, threshold)
    if a.through < 4:
        return 0
    phase4_collate(a, results)
    log("all phases complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
