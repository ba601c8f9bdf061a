"""Synthetic on-disk stereo mini-dataset generator (a copy of
adaptive_stereo_tpu/data/synthetic.py whose PNGs are written by data/png.py:
for the same seed the arrays, and so the decoded images and the .npy
disparities, equal the JAX generator's byte for byte).

Replaces the reference's hard-coded /home/milo dataset paths in tests
(SURVEY.md §4 implication (c)): generates photometrically consistent stereo
pairs with EXACT ground-truth disparity, so end-to-end training/adaptation
tests exercise real geometry:

  L(x, y) = R(x - d(x, y), y)

with R drawn on a wider canvas (no missing pixels) from smooth random
texture, and d a piecewise-constant scene (background plane + floating
boxes). Warping R by the GT disparity reconstructs L exactly (up to PNG
quantization), so the Monodepth photometric loss has its minimum at the true
disparity. A `domain_shift` option applies gamma/color/noise perturbations to
emulate a novel domain for OOD/adaptation tests.
"""

from __future__ import annotations

import os
import numpy as np

from .png import write_png
from .splits import write_split


def _smooth_texture(rng: np.random.RandomState, h: int, w: int,
                    freq_band=(0.01, 0.15)) -> np.ndarray:
    """Smooth colorful texture in [0,1]: random sinusoid mix drawn from
    `freq_band` (cycles/pixel). The band IS the domain's texture statistic:
    the novel domain draws from a higher band, which degrades a model
    pretrained on the default band (OOD features, harder matching) while
    remaining fully adaptable — the sim2real texture-gap analog."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        acc = np.zeros((h, w), np.float32)
        for _ in range(6):
            fx, fy = rng.uniform(freq_band[0], freq_band[1], 2)
            phase = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.3, 1.0)
            acc += amp * np.sin(2 * np.pi * (fx * x + fy * y) + phase)
        acc = (acc - acc.min()) / (acc.max() - acc.min() + 1e-9)
        img[..., c] = acc
    return 0.1 + 0.8 * img


def _sample_rows(canvas: np.ndarray, sample_x: np.ndarray) -> np.ndarray:
    """Bilinear sample along x for each row; canvas (H, Wc, 3), sample_x (H, W)."""
    wc = canvas.shape[1]
    px = np.clip(sample_x, 0, wc - 1.001)
    x0 = np.floor(px).astype(np.int64)
    frac = (px - x0)[..., None]
    rows = np.arange(canvas.shape[0])[:, None]
    return canvas[rows, x0] * (1 - frac) + canvas[rows, x0 + 1] * frac


def make_stereo_pair(
    rng: np.random.RandomState, h: int, w: int, max_disp: float = 40.0,
    freq_band=(0.01, 0.15),
):
    """Returns (left, right, disp_l, disp_r) with exact L(x)=R(x-d(x))."""
    pad = int(np.ceil(max_disp)) + 2
    canvas = _smooth_texture(rng, h, w + pad, freq_band)

    # Piecewise-constant left disparity: background plane + 2-4 boxes.
    d_bg = rng.uniform(4.0, 10.0)
    disp_l = np.full((h, w), d_bg, np.float32)
    for _ in range(rng.randint(2, 5)):
        bh, bw = rng.randint(h // 6, h // 2), rng.randint(w // 8, w // 3)
        by, bx = rng.randint(0, h - bh), rng.randint(0, w - bw)
        disp_l[by : by + bh, bx : bx + bw] = rng.uniform(d_bg + 4, max_disp)

    x = np.arange(w, dtype=np.float32)[None, :]
    # Right image = canvas columns [0, w); left samples canvas at x+pad-d... We
    # place the right view at canvas offset 0 and the left view at offset pad,
    # so every left sample x + pad - d lands inside the canvas for d<=max_disp.
    right = canvas[:, :w].copy()
    left = _sample_rows(canvas, x + 0.0 + np.zeros((h, 1), np.float32))  # placeholder
    left = _sample_rows(canvas, (x - disp_l) + pad)
    # Note: right view must correspond to canvas offset pad - ... For
    # L(x) = R(x - d): L samples canvas at (x - d) + pad only if R(u) = canvas
    # at u + pad. So redefine right accordingly:
    right = canvas[:, pad : pad + w].copy()
    left = _sample_rows(canvas, (x - disp_l) + pad)

    # Right-centered disparity via the fixed-point d_r(x) = d_l(x + d_r(x));
    # one iteration from the background estimate is exact for the plane and a
    # close approximation on boxes.
    xi = np.clip((x + d_bg).astype(np.int64), 0, w - 1)
    d0 = disp_l[np.arange(h)[:, None], xi]
    xi = np.clip(np.round(x + d0).astype(np.int64), 0, w - 1)
    disp_r = disp_l[np.arange(h)[:, None], xi].astype(np.float32)

    return left.astype(np.float32), right, disp_l, disp_r


def _box_blur_1d(img: np.ndarray, radius: int, axis: int) -> np.ndarray:
    """Separable box blur along one axis (edge-padded)."""
    if radius <= 0:
        return img
    pad = [(0, 0)] * img.ndim
    pad[axis] = (radius, radius)
    x = np.pad(img, pad, mode="edge")
    c = np.cumsum(x, axis=axis, dtype=np.float64)
    zero = np.zeros_like(np.take(c, [0], axis=axis))
    c = np.concatenate([zero, c], axis=axis)
    n = img.shape[axis]
    w = 2 * radius + 1
    hi = np.take(c, np.arange(w, w + n), axis=axis)
    lo = np.take(c, np.arange(0, n), axis=axis)
    return ((hi - lo) / w).astype(np.float32)


def _blur(img: np.ndarray, radius: int) -> np.ndarray:
    """Approximate gaussian blur: two box-blur passes per axis."""
    out = img
    for _ in range(2):
        out = _box_blur_1d(out, radius, 0)
        out = _box_blur_1d(out, radius, 1)
    return out


def _haze_field(rng: np.random.RandomState, h: int, w: int,
                lo: float, hi: float) -> np.ndarray:
    """Smooth low-frequency haze-density map in [lo, hi] (patchy fog)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    acc = np.zeros((h, w), np.float32)
    for _ in range(4):
        fx, fy = rng.uniform(0.002, 0.02, 2)
        phase = rng.uniform(0, 2 * np.pi)
        acc += rng.uniform(0.4, 1.0) * np.sin(2 * np.pi * (fx * x + fy * y) + phase)
    acc = (acc - acc.min()) / (acc.max() - acc.min() + 1e-9)
    # Sharpen toward bimodal: large contiguous regions at near-max density
    # (fully fogged-out) rather than a gentle gradient — matching real fog's
    # texture erasure, and the regime that actually flattens cost curves.
    acc = 1.0 / (1.0 + np.exp(-8.0 * (acc - 0.45)))
    return (lo + (hi - lo) * acc)[..., None]


def _apply_domain_shift(img: np.ndarray, rng: np.random.RandomState,
                        shift=None, kind: str = "photometric") -> np.ndarray:
    """Novel-domain perturbation: blur + PATCHY saturating fog + gamma +
    channel gains + noise.

    Design note (what actually moves the Feature Contrast Score): the OOD
    gate consumes FCS from a TRAIN-mode forward (reference adapt.py:313-337),
    where per-frame BatchNorm renormalizes away any GLOBAL photometric change
    — uniform haze/gamma/gain leave train-mode FCS unchanged (measured:
    6.02 train vs 6.05 novel with a global-only shift). What survives
    normalization is the SHAPE of the cost curve along disparity, so the
    shift must genuinely impair matching the way real fog does: blur makes
    neighboring disparities similar, and near-saturating haze patches erase
    local texture entirely (flat cost curves in those regions).

    `shift`: parameters from _draw_shift_params — pass the SAME dict for
    both views of a pair so the shift impairs texture, not L-R photometric
    consistency (a physical fog field is shared by both cameras). Noise
    stays per-view."""
    p = shift or _draw_shift_params(rng, img.shape[0], img.shape[1], kind)
    out = _blur(img, p["blur_radius"])
    out = (out ** p["gamma"]) * p["gains"]
    if p["invert"]:
        # Day->night analog: color inversion pushes features far off the
        # training manifold (large pre-adaptation EPE) while keeping the
        # views photometrically consistent — self-supervised adaptation can
        # recover, exactly the reference's headline dynamic.
        out = 1.0 - out
    out = (1 - p["haze"]) * out + p["haze"] * 0.75
    out = out + rng.normal(0, p["noise"], img.shape).astype(np.float32)
    return np.clip(out, 0, 1)


def _draw_shift_params(rng: np.random.RandomState, h: int, w: int,
                       kind: str = "photometric") -> dict:
    """Shift parameter draw for one frame.

    kind="photometric": the classic perturbation (gamma + channel gains +
      uniform haze + noise), drawn INDEPENDENTLY per view — emulates harsh
      exposure/color miscalibration between cameras; degrades pre-adaptation
      EPE and is what the toy end-to-end tests gate on.
    kind="fog": view-CONSISTENT patchy saturating fog + blur + mild
      photometric shift — erases local texture (flattens cost curves along
      disparity, the train-mode-FCS-visible signal) while preserving L-R
      photometric consistency for the self-supervised loss.
    kind="night": fog + color inversion (day->night analog; features far
      off the training manifold, large pre-adaptation EPE, fully adaptable).
    """
    if kind == "photometric":
        return {
            "gamma": rng.uniform(1.6, 2.2),
            "gains": rng.uniform(0.6, 0.9, size=(1, 1, 3)).astype(np.float32),
            "haze": np.float32(rng.uniform(0.25, 0.4)),
            "blur_radius": 0,
            "invert": False,
            "noise": 0.02,
        }
    if kind not in ("fog", "night"):
        raise ValueError(f"unknown shift kind {kind!r}")
    return {
        "gamma": rng.uniform(1.4, 1.9),
        "gains": rng.uniform(0.7, 0.95, size=(1, 1, 3)).astype(np.float32),
        "haze": _haze_field(rng, h, w, 0.25, 0.85),
        "blur_radius": rng.randint(2, 4),
        "invert": kind == "night",
        "noise": 0.03,
    }


def generate_synthetic_dataset(
    root: str,
    name: str = "synthetic",
    num_train: int = 8,
    num_val: int = 4,
    height: int = 96,
    width: int = 160,
    max_disp: float = 24.0,
    domain_shift: bool = False,
    seed: int = 0,
    shift_kind: str = "photometric",
    novel_freq_band=(0.05, 0.35),
) -> str:
    """Write a synthetic dataset under `root` and a split named `name` with
    train/val/test line files. Returns the dataset root (== `root`).

    Layout: root/{left,right,disp_l,disp_r}/<name>_NNN.(png|npy);
    splits at root/splits/<name>/. Use dataset_name="Synthetic".
    """
    rng = np.random.RandomState(seed)
    for sub in ("left", "right", "disp_l", "disp_r"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    n_total = num_train + num_val
    lines = []
    # The texture-statistics shift applies only to the scene-level kinds;
    # the photometric kind keeps the training band (its gap is appearance).
    band = (novel_freq_band if domain_shift and shift_kind != "photometric"
            else (0.01, 0.15))
    for i in range(n_total):
        left, right, dl, dr = make_stereo_pair(rng, height, width, max_disp,
                                               freq_band=band)
        if domain_shift:
            shift_rng = np.random.RandomState(seed + 1000 + i)
            if shift_kind == "photometric":
                # Independent per-view draws (sequential rng) — the classic
                # harsh-miscalibration gap.
                left = _apply_domain_shift(left, shift_rng,
                                           kind=shift_kind)
                right = _apply_domain_shift(right, shift_rng,
                                            kind=shift_kind)
            else:
                # Scene-level (fog/night): one shared field per pair.
                shift = _draw_shift_params(shift_rng, height, width,
                                           kind=shift_kind)
                left = _apply_domain_shift(left, shift_rng, shift)
                right = _apply_domain_shift(right, shift_rng, shift)
        stem = f"{name}_{i:04d}"
        write_png(
            os.path.join(root, "left", stem + ".png"),
            (np.clip(left, 0, 1) * 255).round().astype(np.uint8),
        )
        write_png(
            os.path.join(root, "right", stem + ".png"),
            (np.clip(right, 0, 1) * 255).round().astype(np.uint8),
        )
        np.save(os.path.join(root, "disp_l", stem + ".npy"), dl)
        np.save(os.path.join(root, "disp_r", stem + ".npy"), dr)
        lines.append(
            f"left/{stem}.png right/{stem}.png disp_l/{stem}.npy disp_r/{stem}.npy"
        )

    splits_root = os.path.join(root, "splits")
    write_split(splits_root, name, "train", lines[:num_train])
    write_split(splits_root, name, "val", lines[num_train:])
    write_split(splits_root, name, "test", lines[num_train:])
    return root
