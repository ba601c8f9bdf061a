"""Full-pipeline demo on synthetic data, on the port (counterpart of
examples/synthetic_pipeline_demo.py): pretrain -> 4-method adaptation
suite -> results collation -> paper plots.

Runs the experiment protocol (reference experiments/adaptation/
run_all_*.sh + evaluation/preprocess_adapt_results.py +
generate_adaptation_plots.py) end to end without real datasets:

    python -m adaptive_stereo_tpu_torch.scripts.synthetic_pipeline_demo \\
        --work /tmp/demo [--device cpu]

Writes under --work: the pretrained checkpoint, per-method trials.csv,
results.csv, adaptation_curves.pdf, gradient_updates.pdf.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--work", default=os.path.join(tempfile.gettempdir(),
                                                  "adaptive_stereo_demo_torch"))
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--pretrain_epochs", type=int, default=8)
    p.add_argument("--adapt_steps", type=int, default=16)
    p.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    a = p.parse_args(argv)

    from ..analysis.results import (collate_trials, plot_adaptation_curves,
                                    plot_gradient_updates_bar, results_to_csv)
    from ..data import generate_synthetic_dataset
    from ..engine import (AdaptConfig, DataConfig, ExperimentConfig, ModelConfig, OptimConfig,
                          adapt, train)
    from .run_paper_scale_synth import model_variables, table_text

    H, W, K, S = a.height, a.width, 3, 1
    os.makedirs(a.work, exist_ok=True)

    print("=== 1/4: synthetic datasets ===")
    train_root = os.path.join(a.work, "train_domain")
    novel_root = os.path.join(a.work, "novel_domain")
    generate_synthetic_dataset(train_root, name="synth", num_train=8, num_val=2,
                               height=H, width=W, max_disp=16.0, seed=0)
    generate_synthetic_dataset(novel_root, name="synth", num_train=24, num_val=2,
                               height=H, width=W, max_disp=16.0, seed=50, domain_shift=True)

    print("=== 2/4: supervised pretraining ===")
    pre_cfg = ExperimentConfig(
        model_name="pretrain", log_dir=os.path.join(a.work, "logs"),
        num_epochs=a.pretrain_epochs, log_frequency=1000, save_freq=100,
        model=ModelConfig(k=K, input_scale=S),
        optim=OptimConfig(learning_rate=1e-4, scheduler_step_size=1000, clip_grad_norm=True),
        data=DataConfig(dataset_path=train_root, dataset_name="Synthetic", split="synth",
                        height=H, width=W, batch_size=2, num_workers=2))
    variables = model_variables(train(pre_cfg, device=a.device)["state"].model)

    print("=== 3/4: 4-method adaptation suite ===")
    trials = {}
    for method, mode in [("nonstop", "NONSTOP"), ("vs", "VS"), ("er", "ER"),
                         ("vs+er", "VS+ER")]:
        cfg = ExperimentConfig(
            model_name=f"adapt_demo_{method}", log_dir=os.path.join(a.work, "logs"),
            num_epochs=10, log_frequency=8,
            model=ModelConfig(k=K, input_scale=S),
            optim=OptimConfig(learning_rate=3e-4, scheduler_step_size=100000,
                              clip_grad_norm=True),
            data=DataConfig(dataset_path=novel_root, dataset_name="Synthetic", split="synth",
                            height=H, width=W, batch_size=1, num_workers=2),
            adapt=AdaptConfig(
                adapt_mode=mode, num_steps=a.adapt_steps, eval_hz=a.adapt_steps // 2,
                ovs_buffer_size=3, ovs_validate_hz=5, val_improve_retries=2,
                ood_threshold=1e9,  # synthetic FCS scale; treat all as novel
                er_loss_weight=0.05, train_dataset_path=train_root,
                train_dataset_name="Synthetic", train_split="synth",
                skip_initial_eval=(method != "nonstop")))
        r = adapt(cfg, variables=variables, device=a.device)
        print(f"  {method}: updates={r['gradient_updates']} final={r['final_state']} "
              f"EPE_adapt={r['final_metrics']['adapt']['EPE']:.3f}")
        trials[method] = os.path.join(a.work, "logs", cfg.model_name, "trials.csv")

    print("=== 4/4: results pipeline ===")
    steps = (a.adapt_steps // 2, a.adapt_steps)
    table = collate_trials(trials, steps=steps)
    results_csv = os.path.join(a.work, "results.csv")
    results_to_csv(trials, results_csv, steps=steps)
    plot_adaptation_curves(table, os.path.join(a.work, "adaptation_curves.pdf"))
    plot_gradient_updates_bar(table, os.path.join(a.work, "gradient_updates.pdf"),
                              step=a.adapt_steps)
    print(f"wrote {results_csv} + plots")
    print(table_text(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
