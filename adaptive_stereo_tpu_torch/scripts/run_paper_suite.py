"""One-command paper-parity runner on the port (counterpart of
scripts/run_paper_suite.py).

Runs when the datasets and pretrained checkpoints are mounted; otherwise
prints what is missing and exits 2 without touching the device. When it
can run, it executes experiments.run_adaptation_suite for each requested
environment and compares the trials.csv numbers against the published
resources/adaptation.csv (the reference's ICRA-2021 results).

Usage:
  python -m adaptive_stereo_tpu_torch.scripts.run_paper_suite \\
      --sceneflow /data/sceneflow --vkitti /data/vkitti --kitti_raw /data/kitti \\
      --sf_weights /ckpt/sf_model --vk_weights /ckpt/vk_model \\
      [--environments flying_to_vk01 clone_to_fog ...] [--log_dir runs/] [--device cpu]

Datasets use the reference's directory layouts (split manifests in
splits/; frames PNG or JPEG); checkpoints are state.msgpack folders
(either package's) or the reference's feature_net.pth / stereo_net.pth
folders (engine/checkpoint.py load_variables reads both).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

from ..analysis.results import read_csv_columns
from ..experiments import ADAPTATION_ENVIRONMENTS, SOURCE_DOMAINS, run_adaptation_suite

# Published EPE (train, adapt, gradient updates) at 4000 steps, VS+ER rows of
# resources/adaptation.csv: the headline parity anchors (SURVEY.md §6).
PUBLISHED_VSER_4000 = {
    "flying_to_vk01": (4.329, 3.521, 3968),
    "flying_to_vk20": (4.410, 3.726, 2484),
    "flying_to_campus": (4.464, 5.548, 2570),
    "flying_to_city": (4.527, 4.207, 2400),
    "flying_to_road": (4.543, 4.792, 2000),
    "clone_to_fog": (1.312, 4.104, 2605),
    "clone_to_rain": (1.293, 3.211, 3621),
}


def _flag(dataset: str) -> str:
    return {"SceneFlowFlying": "sceneflow", "VirtualKitti": "vkitti"}.get(dataset, "kitti_raw")


def last_row(trials_csv: str) -> dict:
    """The last row of trials.csv among those at its largest step."""
    table = read_csv_columns(trials_csv)
    steps = table["step"]
    i = max(j for j, s in enumerate(steps) if s == max(steps))
    return {name: values[i] for name, values in table.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sceneflow", default="")
    ap.add_argument("--vkitti", default="")
    ap.add_argument("--kitti_raw", default="")
    ap.add_argument("--sf_weights", default="")
    ap.add_argument("--vk_weights", default="")
    ap.add_argument("--environments", nargs="*", default=list(PUBLISHED_VSER_4000))
    ap.add_argument("--methods", nargs="*", default=["nonstop", "vs", "er", "vs+er"])
    ap.add_argument("--log_dir", default=os.path.join(tempfile.gettempdir(),
                                                      "paper_suite_logs_torch"))
    # Reduced-scale overrides (readiness drill, smoke runs). The defaults are
    # the paper protocol: 4000 steps at 320x960, eval every 1000.
    ap.add_argument("--num_steps", type=int, default=4000)
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--eval_hz", type=int, default=1000)
    ap.add_argument("--ovs_validate_hz", type=int, default=200)
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)

    roots = {"SceneFlowFlying": args.sceneflow, "VirtualKitti": args.vkitti,
             "KittiRaw": args.kitti_raw}
    weights = {"sf": args.sf_weights, "vk": args.vk_weights}

    missing = []
    for env_name in args.environments:
        spec = ADAPTATION_ENVIRONMENTS[env_name]
        src = spec["source"]
        for ds in {spec["dataset_name"], SOURCE_DOMAINS[src]["train_dataset_name"]}:
            if not roots.get(ds) or not os.path.isdir(roots[ds]):
                missing.append(f"{env_name}: dataset root for {ds} (--{_flag(ds)})")
        if not weights.get(src) or not os.path.isdir(weights[src]):
            missing.append(f"{env_name}: pretrained weights for source '{src}' "
                           f"(--{src}_weights)")

    if missing:
        print("Paper suite NOT runnable — missing mounts:")
        for m in sorted(set(missing)):
            print(f"  - {m}")
        print("\nMount the datasets/checkpoints and re-run; nothing was executed.")
        return 2

    summary = {}
    for env_name in args.environments:
        spec = ADAPTATION_ENVIRONMENTS[env_name]
        src = spec["source"]
        # adaptation_config resolves roots by dataset name (experiments.py).
        train_ds = SOURCE_DOMAINS[src]["train_dataset_name"]
        dataset_paths = {spec["dataset_name"]: roots[spec["dataset_name"]],
                         train_ds: roots[train_ds]}
        print(f"\n=== {env_name}: {args.methods} ===")
        trials = run_adaptation_suite(
            env_name, dataset_paths, weights[src], log_dir=os.path.join(args.log_dir, env_name),
            methods=tuple(args.methods), device=args.device, num_steps=args.num_steps,
            height=args.height, width=args.width, eval_hz=args.eval_hz,
            ovs_validate_hz=args.ovs_validate_hz)
        summary[env_name] = trials

        if "vs+er" in trials and env_name in PUBLISHED_VSER_4000:
            last = last_row(trials["vs+er"])
            pt, pa, pg = PUBLISHED_VSER_4000[env_name]
            print(f"[{env_name}] VS+ER @ {int(last['step'])} steps: "
                  f"EPE train {last.get('EPE_TRAIN', math.nan):.3f} (published {pt}), adapt "
                  f"{last.get('EPE_ADAPT', math.nan):.3f} (published {pa}), updates "
                  f"{last.get('GRADIENT_UPDATES', math.nan)} (published {pg})")

    print("\nAll trials.csv paths:")
    for env_name, trials in summary.items():
        for method, path in trials.items():
            print(f"  {env_name}/{method}: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
