"""TensorBoard scalar extraction (counterpart of
adaptive_stereo_tpu/analysis/tb_extract.py; reference
evaluation/tensorboard_plot.py).

Pulls scalar series (EPE / FCS / losses) out of the event files written by
the engines' MetricsWriter, optionally applies the TensorBoard-style EMA
smoothing (ops/ema.py online_ema, the smoothing the OOD gate uses), and
exports them to CSV. The event files are parsed by utils/event_file.py, not
by tensorboard, and the CSV is written with the csv module, not pandas.

One departure from the JAX package, on purpose: each record is read once.
The JAX read_scalars builds an EventAccumulator per event *file* but on the
file's *directory*, and each accumulator loads every file there, so a
directory with two event files (a run resumed with --resume_from opens a
second writer in the same log directory) gives every record twice. Records
are kept as written, as EventAccumulator keeps files of file_version 2
that hold no SessionLog.START: nothing is purged.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.ema import online_ema
from ..utils.event_file import decode_event, read_records
from ..utils.logging_utils import pandas_float_cell


def _find_event_files(log_dir: str) -> List[str]:
    out = []
    for dirpath, _dirs, files in os.walk(log_dir):
        for fn in files:
            if "tfevents" in fn:
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def read_scalars(log_dir: str,
                 tags: Optional[List[str]] = None) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{tag: (steps int64, values float64)} for every scalar tag (or the
    requested subset) under log_dir, each series sorted by (step, value).
    A value is the float32 the file holds, widened to float64."""
    series: Dict[str, List[Tuple[int, float]]] = {}
    for path in _find_event_files(log_dir):
        for data in read_records(path):
            event = decode_event(data)
            for tag, value in event["scalars"]:
                if tags is None or tag in tags:
                    series.setdefault(tag, []).append((event["step"], value))
    out = {}
    for tag, pairs in series.items():
        pairs.sort()
        out[tag] = (np.asarray([p[0] for p in pairs]), np.asarray([p[1] for p in pairs]))
    return out


def smooth_series(values: np.ndarray, weight: float = 0.999) -> np.ndarray:
    """TensorBoard EMA smoothing (ops/ema.py semantics), in float64."""
    out = np.empty_like(values, dtype=np.float64)
    s = float(values[0])
    for i, v in enumerate(values):
        s = online_ema(s, float(v), weight)
        out[i] = s
    return out


def scalars_to_csv(log_dir: str, output_csv: str, tags: Optional[List[str]] = None,
                   smooth_weight: Optional[float] = None) -> None:
    """Long-form CSV of the series: columns step, tag, value[, smoothed],
    one row a record, the tags in order of first appearance; the bytes of
    the JAX package's pandas to_csv (floats by repr)."""
    data = read_scalars(log_dir, tags)
    if not data:
        raise ValueError(f"no scalar series under {log_dir}")
    header = ["step", "tag", "value"] + (["smoothed"] if smooth_weight is not None else [])
    with open(output_csv, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        for tag, (steps, values) in data.items():
            cols = [steps.tolist(), [tag] * len(steps), map(pandas_float_cell, values)]
            if smooth_weight is not None:
                cols.append(map(pandas_float_cell, smooth_series(values, smooth_weight)))
            writer.writerows(zip(*cols))
