"""Real-data readiness drill on the port (counterpart of
scripts/run_readiness_drill.py): one command that runs the paper-parity
pipeline end to end through the real file loaders.

  python -m adaptive_stereo_tpu_torch.scripts.run_readiness_drill \\
      [--data /tmp/readiness_data_torch] [--device cpu]

Steps:
  1. make_readiness_minidata writes mini on-disk datasets at the vendored
     split-manifest paths (PNG / JPEG frames, PFM, 16-bit depth PNG and npy
     disparities) and random initial checkpoints.
  2. run_paper_suite runs the ten paper environments x four methods x
     --num_steps at 64x96 against those mounts: the command a real-data
     parity run uses, with only the roots and the reduced-scale flags
     changed.

Both run as subprocesses; their output is copied to the log (default
<data>/drill.log). Exit 0 = every method of every environment ran to
completion and wrote a trials.csv through the real dataset layer.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ENVIRONMENTS = ("flying_to_vk01", "flying_to_vk20", "flying_to_campus", "flying_to_city",
                "flying_to_road", "clone_to_fog", "clone_to_rain", "clone_to_campus",
                "clone_to_city", "clone_to_road")


def run(cmd, log_f):
    print(f"\n$ {' '.join(cmd)}", flush=True)
    log_f.write(f"\n$ {' '.join(cmd)}\n")
    log_f.flush()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=REPO, env=env)
    for line in proc.stdout:
        sys.stdout.write(line)
        log_f.write(line)
    proc.wait()
    log_f.flush()
    return proc.returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=os.path.join(tempfile.gettempdir(),
                                                   "readiness_data_torch"))
    ap.add_argument("--log", default=None, help="default: <data>/drill.log")
    ap.add_argument("--num_steps", type=int, default=50)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)

    log_path = os.path.abspath(args.log or os.path.join(args.data, "drill.log"))
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    py = sys.executable
    scripts = "adaptive_stereo_tpu_torch.scripts."

    with open(log_path, "w") as log_f:
        rc = run([py, "-m", scripts + "make_readiness_minidata", "--out", args.data,
                  "--frames", str(args.frames)], log_f)
        if rc != 0:
            print("mini-data generation FAILED", file=sys.stderr)
            return rc

        rc = run([py, "-m", scripts + "run_paper_suite",
                  "--sceneflow", os.path.join(args.data, "sceneflow"),
                  "--vkitti", os.path.join(args.data, "vkitti"),
                  "--kitti_raw", os.path.join(args.data, "kitti_raw"),
                  "--sf_weights", os.path.join(args.data, "weights", "sf"),
                  "--vk_weights", os.path.join(args.data, "weights", "vk"),
                  "--environments", *ENVIRONMENTS,
                  "--num_steps", str(args.num_steps),
                  "--height", "64", "--width", "96",
                  "--eval_hz", "25", "--ovs_validate_hz", "10",
                  "--log_dir", os.path.join(args.data, "logs"), "--device", args.device], log_f)
        if rc != 0:
            print("paper suite drill FAILED", file=sys.stderr)
            return rc
        log_f.write("\nREADINESS DRILL PASSED\n")
    print(f"\nREADINESS DRILL PASSED — log: {log_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
