"""Metrics logging: console banners, run provenance and trials.csv
(counterpart of adaptive_stereo_tpu/utils/logging_utils.py; behavioral
contract from reference train.py:25-71 and adapt.py:175-184,247-271).

The port does not import tensorboardX, so MetricsWriter behaves as the JAX
package's does without it: the console banner, and no event file.
TrialsLog writes the same trials.csv as the JAX package's pandas table
(columns in order of first appearance, a column with a missing cell
written as floats, a missing or NaN cell empty), with the csv module.
"""

from __future__ import annotations

import csv
import json
import os
import subprocess
from typing import Dict, Optional

import numpy as np


def git_sha(default: str = "unknown") -> str:
    """Current repo commit hash for run provenance (reference train.py:149-152
    uses gitpython; a subprocess keeps this dependency-free)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else default
    except Exception:
        return default


def write_opt_json(log_path: str, cfg) -> dict:
    """Dump the run configuration + git commit hash to <log_path>/opt.json
    (reference train.py:149-160: opt.commit_hash = sha; json dump)."""
    d = json.loads(cfg.to_json())
    d["commit_hash"] = git_sha()
    os.makedirs(log_path, exist_ok=True)
    with open(os.path.join(log_path, "opt.json"), "w") as f:
        f.write(json.dumps(d, sort_keys=True, indent=2) + "\n")
    return d


class MetricsWriter:
    """The reference's console banner; scalars and images go nowhere (the
    JAX package's writer without tensorboardX)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)

    def add_scalar(self, name: str, value, step: int) -> None:
        """No event file: nothing to write."""

    def add_image(self, name: str, img_hwc: np.ndarray, step: int) -> None:
        """No event file: nothing to write."""

    def log_images(self, inputs: Dict, outputs: Dict, step: int, skip_prefixes=()) -> None:
        """No event file: nothing to write."""

    def log_scalars(self, metrics: Dict, losses: Dict, examples_per_sec: float,
                    epoch: int, step: int) -> None:
        for name, v in losses.items():
            self.add_scalar(name, v, step)
        for name, v in metrics.items():
            self.add_scalar(name, v, step)
        self.add_scalar("examples_per_sec", examples_per_sec, step)

        print(f"\n{epoch}|{step}" + "=" * 70)
        print(f"TIMING  // examples/sec={examples_per_sec:.3f}")
        if metrics:
            print("METRICS // EPE={:.3f} | >2px={:.3f} | >3px={:.3f} | >4px={:.3f} | "
                  ">5px={:.3f}".format(*(float(metrics.get(k, -1)) for k in (
                      "EPE", "D1_all_2px", "D1_all_3px", "D1_all_4px", "D1_all_5px"))))
        if losses:
            print("LOSS    // " + " | ".join(
                f"{n}={float(v):.3f}" for n, v in losses.items()))
        print("=" * 75 + "\n")

    def close(self) -> None:
        """Nothing to close."""


def _parse_cell(text: str):
    if text == "":
        return None
    try:
        return int(text)
    except ValueError:
        return float(text)


class TrialsLog:
    """Durable per-run results table: trials.csv with resume semantics
    (reference adapt.py:247-271)."""

    def __init__(self, path: str):
        self.path = path
        self.columns = []
        self.rows = []
        if os.path.exists(path):
            with open(path, newline="") as f:
                reader = csv.DictReader(f)
                self.columns = list(reader.fieldnames or [])
                self.rows = [{k: _parse_cell(v) for k, v in row.items()} for row in reader]
            self.trial_index = max(int(r["trial"]) for r in self.rows) + 1
            print(f"\nNOTE: Found existing trials.csv, running trial #{self.trial_index}")
        else:
            self.trial_index = 0
            print("\nNOTE: No existing trials.csv, starting from trial #0")

    def append(self, metrics_adapt: Dict, metrics_train: Dict,
               gradient_updates: Optional[Dict], step: int) -> None:
        d: Dict = {"trial": self.trial_index, "step": step}
        for k, v in metrics_adapt.items():
            d[k + "_ADAPT"] = float(v)
        for k, v in metrics_train.items():
            d[k + "_TRAIN"] = float(v)
        for k, v in (gradient_updates or {}).items():
            d[k] = v
        self.columns += [k for k in d if k not in self.columns]
        self.rows.append(d)
        self._write()

    def _format(self, column: str):
        values = [row.get(column) for row in self.rows]
        ints = all(isinstance(v, (int, np.integer)) and not isinstance(v, bool)
                   for v in values)
        # pandas writes a missing or NaN cell as "" and floats by repr.
        return lambda v: ("" if v is None or (not ints and np.isnan(float(v)))
                          else str(int(v)) if ints else repr(float(v)))

    def _write(self) -> None:
        fmt = {c: self._format(c) for c in self.columns}
        with open(self.path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(self.columns)
            for row in self.rows:
                writer.writerow([fmt[c](row.get(c)) for c in self.columns])
