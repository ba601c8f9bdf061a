"""Metrics logging: console banners, run provenance and trials.csv
(counterpart of adaptive_stereo_tpu/utils/logging_utils.py; behavioral
contract from reference train.py:25-71 and adapt.py:175-184,247-271).

MetricsWriter writes TensorBoard event files through utils/event_file.py
(the port imports no tensorboardX): the scalars and images of the JAX
package's writer, which tensorboard reads alike, and the console banner.
TrialsLog writes the same trials.csv as the JAX package's pandas table
(columns in order of first appearance, a column with a missing cell
written as floats, a missing or NaN cell empty), with the csv module.
"""

from __future__ import annotations

import csv
import json
import math
import os
import subprocess
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .event_file import EventFileWriter
from .visualization import apply_disparity_colormap


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


def _contains_prefix(name: str, prefixes: Iterable[str]) -> bool:
    return any(p in name for p in prefixes)


def _first_on_host(v) -> np.ndarray:
    """The first batch element of a tensor or array as float32 numpy."""
    x = v[0]
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


class MetricsWriter:
    """A TensorBoard event file in log_dir (utils/event_file.py) and the
    reference's console banner."""

    def __init__(self, log_dir: str):
        self._writer = EventFileWriter(log_dir)

    def add_scalar(self, name: str, value, step: int) -> None:
        self._writer.add_scalar(name, float(value), step)

    def add_image(self, name: str, img_hwc: np.ndarray, step: int) -> None:
        self._writer.add_image(name, img_hwc, step)

    def log_images(self, inputs: Dict, outputs: Dict, step: int,
                   skip_prefixes: Iterable[str] = ("cost_volume", "fcs")) -> None:
        """Colorized disparity / raw RGB panels of the first batch element
        (reference train.py:54-71 log_images; JAX logging_utils.py:67-95):
        keys containing 'disp' get the per-image-normalized colormap, other
        image-shaped entries go through raw, and names containing a skipped
        prefix (the cost volumes and FCS maps) are left out."""
        for io in (inputs, outputs):
            for name, v in io.items():
                if _contains_prefix(name, skip_prefixes):
                    continue
                arr = _first_on_host(v)
                if arr.ndim != 3:
                    continue
                if "disp" in name:
                    viz = apply_disparity_colormap(arr)
                else:
                    viz = np.clip(arr, 0.0, 1.0)
                    if viz.shape[-1] == 1:
                        viz = np.repeat(viz, 3, axis=-1)
                    elif viz.shape[-1] != 3:
                        continue
                self.add_image(name, viz, step)

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
        self._writer.close()


def pandas_float_cell(v) -> str:
    """A float64 cell as pandas' to_csv writes it: empty for NaN, else repr."""
    v = float(v)
    return "" if math.isnan(v) else repr(v)


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
        return lambda v: ("" if v is None else str(int(v)) if ints
                          else pandas_float_cell(v))

    def _write(self) -> None:
        fmt = {c: self._format(c) for c in self.columns}
        with open(self.path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(self.columns)
            for row in self.rows:
                writer.writerow([fmt[c](row.get(c)) for c in self.columns])
