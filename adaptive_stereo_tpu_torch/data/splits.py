"""Split-file contract (reference splits/ directory); a copy of
adaptive_stereo_tpu/data/splits.py. default_splits_root is the repo's
splits/ folder, a data folder beside both packages.

A split is a directory containing `{train,val,test}_lines.txt`; each line is
4 space-separated paths: rgb_left rgb_right disp_left disp_right, relative to
the dataset root (absolute for KITTI-raw) — reference
datasets/stereo_dataset.py:39-48,85-87.
"""

from __future__ import annotations

import os
from typing import List


def default_splits_root() -> str:
    """The vendored reference split manifests at the repo root (splits/)."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "splits",
    )


def read_lines(filename: str) -> List[str]:
    with open(filename, "r") as f:
        return f.read().splitlines()


def split_lines_path(splits_root: str, split: str, subsplit: str) -> str:
    return os.path.join(splits_root, split, f"{subsplit}_lines.txt")


def write_split(splits_root: str, split: str, subsplit: str, lines: List[str]) -> str:
    d = os.path.join(splits_root, split)
    os.makedirs(d, exist_ok=True)
    p = os.path.join(d, f"{subsplit}_lines.txt")
    with open(p, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return p
