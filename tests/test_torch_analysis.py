"""The rest of analysis/ (results, tb_extract, cost_volume, profiling, the OOD
plots, and the figure writer they draw with) against the JAX package's,
on the CPU.

Tolerances:
- smooth_series, and the CSV files of scalars_to_csv and results_to_csv:
  bitwise and byte for byte (the same float64 arithmetic; pandas' number
  formatting reproduced);
- the plotted series (line data, bar and histogram rectangles, hlines /
  vlines segments, text positions, ylim, xticks), recorded from
  matplotlib by patching Figure.savefig in the test: within 1e-12 of the
  series' largest magnitude (rect positions are sums of bin edges and
  half widths in matplotlib); the percentile line through
  scipy.stats.norm.ppf against statistics.NormalDist.inv_cdf: 1e-9;
- save_cost_volumes: the volumes within the model band of
  tests/test_torch_model.py (2e-3 + 1e-4 relative), the ground truth
  bitwise, and plot_cost_volume_slices picks the same pixel on JAX's dumps;
- profiling: flop counts exact (integers).
"""

import io
import json
import math
import os
import re
import shutil
import xml.etree.ElementTree as ET

import jax.numpy as jnp
import matplotlib
import matplotlib.figure
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import adaptive_stereo_tpu.analysis.cost_volume as jax_cv
import adaptive_stereo_tpu.analysis.ood as jax_ood
import adaptive_stereo_tpu.analysis.profiling as jax_prof
import adaptive_stereo_tpu.analysis.results as jax_results
import adaptive_stereo_tpu.analysis.tb_extract as jax_tb
from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu.utils.logging_utils import MetricsWriter as JaxWriter
from adaptive_stereo_tpu.utils.logging_utils import TrialsLog as JaxTrialsLog
from adaptive_stereo_tpu_torch.analysis import collate_trials, results_to_csv
from adaptive_stereo_tpu_torch.analysis import cost_volume as port_cv
from adaptive_stereo_tpu_torch.analysis import figure as port_figure
from adaptive_stereo_tpu_torch.analysis import ood as port_ood
from adaptive_stereo_tpu_torch.analysis import profiling
from adaptive_stereo_tpu_torch.analysis import results as port_results
from adaptive_stereo_tpu_torch.analysis import tb_extract as port_tb
from adaptive_stereo_tpu_torch.models import StereoModel
from adaptive_stereo_tpu_torch.ops.cuda import (aggregate_cost_volume_ref, aggregation_flops,
                                                coarse_head_flops, coarse_head_ref,
                                                difference_cost_volume_flops,
                                                difference_cost_volume_ref,
                                                soft_argmin_fcs_flops, soft_argmin_fcs_ref,
                                                tower_flops, tower_ref, work)
from adaptive_stereo_tpu_torch.ops.cuda import aggregation as agg_mod
from adaptive_stereo_tpu_torch.ops.cuda import coarse_head as head_mod
from adaptive_stereo_tpu_torch.ops.cuda import tower as tower_mod
from adaptive_stereo_tpu_torch.utils.logging_utils import TrialsLog as PortTrialsLog
from test_torch_guards import PORT, REPO, _imported_roots
from test_torch_train import H, K, MAXDISP, OUT_TOL, S, W, _frames, _variables

SERIES_REL = 1e-12
PPF_ABS = 1e-9
ANALYSIS_MODULES = ("figure.py", "results.py", "tb_extract.py", "cost_volume.py",
                    "profiling.py", "ood.py")


def test_port_imports_no_pandas_scipy_tensorboard_or_protobuf():
    """The analysis modules, the event files and the rest of the port (a
    static scan, as tests/test_torch_guards.py's)."""
    forbidden = {"pandas", "scipy", "tensorboard", "tensorboardX", "google", "matplotlib",
                 "PIL", "jax", "adaptive_stereo_tpu"}
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert all((PORT / "analysis" / m).exists() for m in ANALYSIS_MODULES)
    bad = [f"{f.relative_to(REPO)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f) if mod in forbidden]
    assert not bad, bad


# --- tb_extract --------------------------------------------------------------

def test_smooth_series_matches_jax():
    values = np.random.RandomState(0).randn(300).astype(np.float32).astype(np.float64)
    for weight in (0.0, 0.6, 0.999):
        assert port_tb.smooth_series(values, weight).tobytes() == \
            jax_tb.smooth_series(values, weight).tobytes()


@pytest.mark.parametrize("smooth", [None, 0.9])
def test_scalars_to_csv_matches_pandas(tmp_path, smooth):
    w = JaxWriter(str(tmp_path / "logs"))
    rng = np.random.RandomState(1)
    for step in range(40):
        w.add_scalar("fcs/raw", 12 + rng.randn(), step)
        if step % 5 == 0:
            w.add_scalar("EPE", float(rng.rand() * 3), step)
            w.add_scalar("GRADIENT_UPDATES", step // 2, step)
    w.add_scalar("EPE", float("nan"), 41)
    w.close()
    for tags in (None, ["EPE", "fcs/raw"]):
        port_tb.scalars_to_csv(str(tmp_path / "logs"), str(tmp_path / "port.csv"), tags, smooth)
        jax_tb.scalars_to_csv(str(tmp_path / "logs"), str(tmp_path / "jax.csv"), tags, smooth)
        got, want = ((tmp_path / n).read_bytes() for n in ("port.csv", "jax.csv"))
        assert got == want, tags
    assert got.count(b"\n") == 1 + 40 + 9


# --- results -----------------------------------------------------------------

def _write_trials(root, log_cls):
    """trials.csv of four methods through a TrialsLog: nonstop with its
    pre-adaptation row (no gradient updates there, so the column has a
    missing cell), vs with integer updates, er without the column, vs+er
    with two steps and a NaN metric."""
    rng = np.random.RandomState(2)
    paths = {}
    plan = {"nonstop": [-1, 1000, 2000, 3000, 4000], "vs": [1000, 2000, 3000, 4000],
            "er": [1000, 2000, 4000], "vs+er": [1000, 3000]}
    for method, steps in plan.items():
        os.makedirs(root / method, exist_ok=True)
        log = log_cls(str(root / method / "trials.csv"))
        for step in steps:
            adapt = {"EPE": float(rng.rand() * 4), "D1_all_3px": float(rng.rand()),
                     "FCS": float(10 + rng.rand())}
            train = {"EPE": float(rng.rand() * 2), "FCS": float(12 + rng.rand())}
            if method == "vs+er" and step == 3000:
                adapt["EPE"] = float("nan")
            updates = None
            if method != "er" and step >= 0:
                updates = {"GRADIENT_UPDATES": step // 3}
            log.append(adapt, train, updates, step)
        paths[method] = str(root / method / "trials.csv")
    return paths


def test_csv_float_reading_matches_pandas():
    """pandas_float against pandas.read_csv's default converter on repr'd
    floats of many magnitudes (plain float() differs on about a quarter of
    them) and on other spellings."""
    import pandas as pd

    rng = np.random.RandomState(3)
    values = np.concatenate([rng.rand(3000) * 4, rng.randn(3000) * 1e3,
                             10.0 ** rng.uniform(-12, 12, 3000),
                             [0.0, -0.0, 1e300, 5e-324, 2.2250738585072014e-308]])
    texts = [repr(float(v)) for v in values] + ["1e5", "1E-5", "-.5", "+3.", "007.50", "inf",
                                                "-inf", "", "nan"]
    want = pd.read_csv(io.StringIO("x\n" + "\n".join(texts) + "\n"),
                       keep_default_na=True)["x"].tolist()
    got = [port_results.pandas_float(t) for t in texts]
    differs = sum(float(t) != w for t, w in zip(texts[:len(values)], want))
    print(f"{len(texts)} cells; float() differs from pandas on {differs}")
    assert differs > 0
    assert all(map(_same, got, want))
    with pytest.raises(ValueError, match="not a number"):
        port_results.pandas_float("MAD-FULL")


def _same(a, b):
    return a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kw", [{}, dict(steps=(1000, 4000), pre_adapt_method="vs")])
def test_results_to_csv_matches_pandas(tmp_path, writer, kw):
    paths = _write_trials(tmp_path, JaxTrialsLog if writer == "jax" else PortTrialsLog)
    table = collate_trials(paths, **kw)
    frame = jax_results.collate_trials(paths, **kw)
    assert list(table) == list(frame.columns)
    for name in table:
        want = frame[name].tolist()
        assert len(table[name]) == len(want) and all(map(_same, table[name], want)), name
    results_to_csv(paths, str(tmp_path / "port.csv"), **kw)
    jax_results.results_to_csv(paths, str(tmp_path / "jax.csv"), **kw)
    got, want = (tmp_path / "port.csv").read_bytes(), (tmp_path / "jax.csv").read_bytes()
    print(got.decode())
    assert got == want


def test_collate_trials_errors_match_jax(tmp_path):
    paths = _write_trials(tmp_path, PortTrialsLog)
    for fn in (collate_trials, jax_results.collate_trials):
        with pytest.raises(FileNotFoundError, match="missing trials.csv for x"):
            fn({**paths, "x": str(tmp_path / "nope.csv")})
    again = PortTrialsLog(paths["vs"])  # a second trial in the same file
    again.append({"EPE": 1.0, "FCS": 1.0}, {"EPE": 1.0, "FCS": 1.0}, None, 1000)
    for fn in (collate_trials, jax_results.collate_trials):
        with pytest.raises(ValueError, match="expected a single trial"):
            fn(paths)


# --- plots -------------------------------------------------------------------

def _mpl_axes(ax):
    return {
        "lines": [np.asarray(ln.get_xydata(), np.float64) for ln in ax.lines],
        "rects": np.array([(p.get_x(), p.get_y(), p.get_width(), p.get_height())
                           for p in ax.patches], np.float64).reshape(-1, 4),
        "segments": [np.asarray(s, np.float64) for c in ax.collections
                     for s in c.get_segments()],
        "texts": [(float(t.get_position()[0]), float(t.get_position()[1]), t.get_text())
                  for t in ax.texts],
        "ylim": tuple(ax.get_ylim()), "xticks": list(ax.get_xticks()),
        "labels": (ax.get_xlabel(), ax.get_ylabel(), ax.get_title()),
    }


def _port_axes(ax):
    return {
        "lines": [np.stack([ln["x"], ln["y"]], axis=1) for ln in ax.lines],
        "rects": np.array([(r["x"], r["y"], r["width"], r["height"]) for r in ax.rects],
                          np.float64).reshape(-1, 4),
        "segments": [np.array([[h["xmin"], h["y"]], [h["xmax"], h["y"]]])
                     for h in ax.hline_data]
                    + [np.array([[v["x"], v["ymin"]], [v["x"], v["ymax"]]])
                       for v in ax.vline_data],
        "texts": [(t["x"], t["y"], t["s"]) for t in ax.texts],
        "ylim": ax.ylim, "xticks": ax.xticks,
        "labels": (ax.xlabel, ax.ylabel, ax.title),
    }


@pytest.fixture
def recorded(monkeypatch):
    """Figures saved by matplotlib (their axes' series, nothing written) and
    by the port's figure writer (the Figure, and the file written)."""
    out = {"mpl": [], "port": []}
    matplotlib.use("Agg")
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda self, *a, **k: out["mpl"].append(
                            [_mpl_axes(ax) for ax in self.axes]))
    save = port_figure.Figure.savefig

    def port_save(self, path):
        save(self, path)
        out["port"].append((self, path))
    monkeypatch.setattr(port_figure.Figure, "savefig", port_save)
    yield out
    plt.close("all")


def _close(a, b, what, rel=SERIES_REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = np.nanmax(np.abs(b)) if np.isfinite(b).any() else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(scale, 1e-300), equal_nan=True,
                               err_msg=what)


def _compare(port_fig, mpl_axes, rel_segments=SERIES_REL, check_ylim=False, check_xticks=False):
    assert len(port_fig.axes) == len(mpl_axes)
    for i, (pa, ma) in enumerate(zip(map(_port_axes, port_fig.axes), mpl_axes)):
        assert len(pa["lines"]) == len(ma["lines"]), i
        for j, (x, y) in enumerate(zip(pa["lines"], ma["lines"])):
            _close(x, y, f"axes {i} line {j}")
        _close(pa["rects"], ma["rects"], f"axes {i} rects")
        assert len(pa["segments"]) == len(ma["segments"]), i
        for j, (x, y) in enumerate(zip(pa["segments"], ma["segments"])):
            _close(x, y, f"axes {i} segment {j}", rel_segments)
        assert [t[2] for t in pa["texts"]] == [t[2] for t in ma["texts"]]
        _close([t[:2] for t in pa["texts"]], [t[:2] for t in ma["texts"]], "texts")
        assert pa["labels"] == ma["labels"], i
        if check_ylim:
            assert pa["ylim"] == ma["ylim"]
        if check_xticks:
            _close(pa["xticks"], ma["xticks"], "xticks")


def _check_pdf(path, texts):
    """A PDF whose every xref offset lands on its object, with the texts in
    its (uncompressed) content stream."""
    data = open(path, "rb").read()
    assert data.startswith(b"%PDF-") and data.rstrip().endswith(b"%%EOF")
    start = int(re.search(rb"startxref\s+(\d+)", data).group(1))
    assert data[start:start + 4] == b"xref"
    lines = data[start:].split(b"\n")
    first, count = map(int, lines[1].split())
    assert first == 0 and count >= 6
    for i, entry in enumerate(lines[2:2 + count]):
        assert len(entry) + 1 == 20, entry  # each entry is 20 bytes with its newline
        offset, _gen, kind = entry.split()
        if kind == b"n":
            assert data[int(offset):].startswith(f"{i} 0 obj".encode()), (i, offset)
    stream = data[data.index(b"stream\n") + 7:data.index(b"endstream")]
    length = int(re.search(rb"/Length (\d+)", data).group(1))
    assert len(stream) == length
    for t in texts:
        escaped = t.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")
        assert f"({escaped}) Tj".encode() in stream, t


def _check_svg(path, series_lengths):
    root = ET.parse(path).getroot()
    polylines = root.findall(".//{http://www.w3.org/2000/svg}polyline")
    assert [len(p.get("points").split()) for p in polylines] == series_lengths


def test_adaptation_plots_match_matplotlib(tmp_path, recorded):
    paths = _write_trials(tmp_path, PortTrialsLog)
    table, frame = collate_trials(paths), jax_results.collate_trials(paths)
    for metric in ("EPE", "FCS"):
        port_results.plot_adaptation_curves(table, str(tmp_path / f"{metric}.pdf"), metric)
        jax_results.plot_adaptation_curves(frame, str(tmp_path / "unused.pdf"), metric)
    port_results.plot_gradient_updates_bar(table, str(tmp_path / "bar.pdf"), step=4000)
    jax_results.plot_gradient_updates_bar(frame, str(tmp_path / "unused.pdf"), step=4000)
    assert len(recorded["port"]) == len(recorded["mpl"]) == 3
    for (fig, path), mpl_axes in zip(recorded["port"], recorded["mpl"]):
        _compare(fig, mpl_axes, check_xticks=path.endswith("bar.pdf"))
        texts = [t for ax in fig.axes for t in (ax.xlabel, ax.ylabel, ax.title) if t]
        _check_pdf(path, texts)
    curves = recorded["port"][0][0]
    assert [len(ln["x"]) for ln in curves.axes[0].lines] == [5, 4, 3, 2]
    bars = recorded["port"][2][0].axes[0]
    assert bars.xticklabels == ["MAD-FULL", "VS", "ER"]
    port_results.plot_adaptation_curves(table, str(tmp_path / "curves.svg"))
    # vs+er's ADAPT EPE at step 3000 is NaN: its line keeps the finite point.
    _check_svg(str(tmp_path / "curves.svg"), [5, 4, 3, 1, 5, 4, 3, 2])


def _fcs_values():
    rng = np.random.RandomState(5)
    return (rng.normal(12.0, 1.0, 300).astype(np.float32),
            rng.normal(9.5, 1.5, 120).astype(np.float32))


def test_ood_plots_match_matplotlib(tmp_path, recorded):
    train, novel = _fcs_values()
    port_ood.plot_fcs_histogram(train, novel, str(tmp_path / "hist.pdf"))
    jax_ood.plot_fcs_histogram(train, novel, str(tmp_path / "unused.pdf"))
    port_ood.plot_precision_recall(train, novel, str(tmp_path / "pr.pdf"))
    jax_ood.plot_precision_recall(train, novel, str(tmp_path / "unused.pdf"))
    (hist, hist_path), (pr, pr_path) = recorded["port"]
    _compare(hist, recorded["mpl"][0], rel_segments=PPF_ABS)
    _compare(pr, recorded["mpl"][1], check_ylim=True)
    vline = hist.axes[0].vline_data[0]
    want_x = recorded["mpl"][0][0]["segments"][0][0, 0]
    print(f"percentile line: NormalDist {vline['x']!r}, scipy {want_x!r}")
    assert abs(vline["x"] - want_x) <= PPF_ABS
    assert len(hist.axes[0].rects) == 80 and pr.axes[0].ylim == (0.0, 1.05)
    _check_pdf(hist_path, ["feature contrast score", "frequency", "train", "novel"])
    _check_pdf(pr_path, ["recall", "precision"])
    port_ood.plot_fcs_histogram(train, novel, str(tmp_path / "hist.svg"))
    port_ood.plot_precision_recall(train, novel, str(tmp_path / "pr.svg"))
    _check_svg(str(tmp_path / "hist.svg"), [41])
    _check_svg(str(tmp_path / "pr.svg"), [100])


def test_figure_writer_formats(tmp_path):
    fig, ax = port_figure.subplots()
    ax.plot([0, 1, 2], [1, 4, 9], marker="o", label="a (b)")
    ax.set_xlabel("x \\ (y)")
    ax.legend()
    fig.savefig(str(tmp_path / "f.PDF"))
    _check_pdf(str(tmp_path / "f.PDF"), ["x \\ (y)", "a (b)"])
    with pytest.raises(ValueError, match=r"PDF \(.pdf\) and SVG \(.svg\)"):
        fig.savefig(str(tmp_path / "f.png"))
    with pytest.raises(ValueError, match="unknown color"):
        ax.plot([0], [0], color="chartreuse-ish")


# --- cost volumes ------------------------------------------------------------

def _cv_loader(seed):
    rng = np.random.RandomState(seed)
    batches = []
    for n in (2, 1, 2):
        left, right = _frames(rng, n)
        gt = (rng.rand(n, H // 2 ** (S + K), W // 2 ** (S + K), 1) * 10).astype(np.float32)
        batches.append({f"color_l/{S}": left, f"color_r/{S}": right,
                        f"gt_disp_l/{S + K}": gt})
    return batches


def test_save_cost_volumes_matches_jax(tmp_path, recorded):
    variables = _variables(7)
    loader = _cv_loader(8)
    model = StereoModel(k=K, input_scale=S, maxdisp=MAXDISP, device="cpu")
    n = port_cv.save_cost_volumes(model, variables, loader, str(tmp_path / "port"), S, K,
                                  num_images=4)
    jax_model = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP)
    assert jax_cv.save_cost_volumes(jax_model, variables, loader, str(tmp_path / "jax"), S, K,
                                    num_images=4) == n == 4
    for i in range(n):
        got = np.load(tmp_path / "port" / f"{i}_cost_volume.npy")
        want = np.load(tmp_path / "jax" / f"{i}_cost_volume.npy")
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (
            model.stereo_net.num_disp, H // 4, W // 4)
        print(f"volume {i}: max abs diff {np.abs(got - want).max():.3g}")
        np.testing.assert_allclose(got, want, **OUT_TOL)
        gt_got, gt_want = (np.load(tmp_path / d / f"{i}_gt.npy") for d in ("port", "jax"))
        assert gt_got.dtype == gt_want.dtype and gt_got.tobytes() == gt_want.tobytes()
    # The slice plots of both on JAX's dumps.
    shutil.copytree(tmp_path / "jax", tmp_path / "jax_dumps")
    jax_cv.plot_cost_volume_slices(str(tmp_path / "jax"), n)
    port_cv.plot_cost_volume_slices(str(tmp_path / "jax_dumps"), n)
    assert len(recorded["port"]) == len(recorded["mpl"]) == n
    for (fig, path), mpl_axes in zip(recorded["port"], recorded["mpl"]):
        _compare(fig, mpl_axes, check_xticks=True)
        _check_pdf(path, ["disparity", "feature similarity score C(u, v)", "max", "mean"])
    assert sorted(f for f in os.listdir(tmp_path / "jax_dumps") if f.endswith(".pdf")) == \
        [f"{i}_cost_volume_slice.pdf" for i in range(n)]


# --- profiling ---------------------------------------------------------------

def test_matmul_flops_match_xla():
    a, b = np.ones((64, 128), np.float32), np.ones((128, 32), np.float32)
    got = profiling.cost_analysis(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    want = jax_prof.cost_analysis(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    print(f"matmul: port {got}, XLA {want}")
    assert got["flops"] == want["flops"] == 524288
    assert got["bytes accessed"] == want["bytes accessed"] == (64 * 128 + 128 * 32 + 64 * 32) * 4


def _analytic_forward_flops(b, h, w, k, d):
    """2 x multiply-adds over the full window of every conv of the model's
    forward at (b, h, w): both views' feature towers, the aggregation
    stack and the refinement tower."""
    conv = lambda n, cin, cout, taps: 2 * n * cin * cout * taps
    feat, hh, ww = 0, h, w
    for i in range(k):
        hh, ww = -(-hh // 2), -(-ww // 2)
        feat += conv(b * hh * ww, 3 if i == 0 else 32, 32, 25)
    feat += 7 * conv(b * hh * ww, 32, 32, 9)
    agg = 4 * conv(b * d * hh * ww, 32, 32, 27) + conv(b * d * hh * ww, 32, 1, 27)
    refine = conv(b * h * w, 4, 32, 9) + 6 * conv(b * h * w, 32, 32, 9) + conv(b * h * w, 32, 1, 9)
    return 2 * feat + agg + refine


@pytest.mark.parametrize("options", [{}, dict(fused_siamese=True, fused_tower=True),
                                     dict(fused_coarse_head=True)])
def test_forward_flops_are_the_sum_of_its_convs(options):
    model = StereoModel(k=K, input_scale=S, maxdisp=MAXDISP, device="cpu", **options).eval()
    left, right = map(torch.from_numpy, _frames(np.random.RandomState(9), 2))
    with torch.no_grad():
        got = profiling.cost_analysis(lambda: model(left, right))
    want = _analytic_forward_flops(2, H, W, K, model.stereo_net.num_disp)
    print(f"{options}: flops {got['flops']:.0f}, analytic {want}, bytes {got['bytes accessed']:.0f}")
    assert got["flops"] == want and got["bytes accessed"] > 0


def _flop_count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _agg_args(rng, b, d, h, w):
    params = {"kernels": torch.randn(4, 3, 3, 3, 32, 32) * 0.05,
              "biases": torch.randn(4, 32) * 0.1, "scales": 1 + 0.1 * torch.randn(4, 32),
              "bn_biases": torch.randn(4, 32) * 0.1,
              "final_kernel": torch.randn(3, 3, 3, 32, 1) * 0.05, "final_bias": torch.randn(1)}
    stats = (torch.randn(4, 32) * 0.1, 1 + torch.rand(4, 32))
    return torch.from_numpy(rng.randn(b, d, h, w, 32).astype(np.float32)), params, stats


def _tower_args(b, h, w):
    g = torch.Generator().manual_seed(3)
    chans = [tower_mod._channels(p) for p in range(8)]
    params = {"kernels": [torch.randn(3, 3, ci, co, generator=g) * 0.1 for ci, co in chans],
              "biases": [torch.randn(co, generator=g) * 0.1 for _, co in chans],
              "gammas": 1 + 0.1 * torch.randn(7, 32, generator=g),
              "betas": 0.1 * torch.randn(7, 32, generator=g)}
    stats = (torch.zeros(7, 32), torch.ones(7, 32))
    return torch.randn(b, h, w, 4, generator=g), params, stats


@pytest.mark.parametrize("shape", [(1, 5, 3, 8), (2, 12, 4, 6)])
def test_count_functions_match_flop_counter(shape):
    """Each wrapper's count function against FlopCounterMode over its plain
    version: kernels 2 and 4 forward, kernels 1 and 3 (0, forward and
    backward), the tower forward and backward."""
    b, d, h, w = shape
    rng = np.random.RandomState(d)
    cost, params, stats = _agg_args(rng, b, d, h, w)
    for train in (False, True):
        assert _flop_count(lambda: aggregate_cost_volume_ref(cost, params, stats, train)) == \
            aggregation_flops(b, d, h, w)
        fl, fr = cost[:, 0], cost[:, 1]
        assert _flop_count(lambda: coarse_head_ref(fl, fr, params, stats, train, d)) == \
            coarse_head_flops(b, h, w, d) == aggregation_flops(b, d, h, w)
    fl, fr = (cost[:, i].clone().requires_grad_() for i in (0, 1))
    scost = torch.randn(b, d, h, w, requires_grad=True)

    def plain_1_and_3():
        difference_cost_volume_ref(fl, fr, d).sum().backward()
        soft_argmin_fcs_ref(scost)[0].sum().backward()
    assert _flop_count(plain_1_and_3) == 0
    assert difference_cost_volume_flops(b, h, w, 32, d) == soft_argmin_fcs_flops(b, d, h, w) == 0
    # The tower at batch 2 (CPU torch's conv backward at batch 1 refuses the
    # plain tower's permuted weights), 2h x 3w.
    th, tw = 2 * h, 3 * w
    x0, tparams, tstats = _tower_args(2, th, tw)
    assert _flop_count(lambda: tower_ref(x0, tparams, tstats, False)) == tower_flops(2, th, tw)
    for x0_grad in (True, False):
        x = x0.clone().requires_grad_(x0_grad)
        p = {key: [t.clone().requires_grad_() for t in v] if isinstance(v, list)
             else v.clone().requires_grad_() for key, v in tparams.items()}
        y = tower_ref(x, p, tstats, True)[0]
        backward = _flop_count(lambda: y.sum().backward())
        want = tower_flops(2, th, tw, backward=True, input_grad=[x0_grad] + [True] * 7)
        print(f"tower {2, th, tw} backward, x0 grad {x0_grad}: {backward} flops")
        assert backward == want


def _as_kernel(name, plain, flops):
    """A stand-in for a kernel launch on CPU tensors: the plain version,
    unseen by the counts, and the wrapper's own count added."""
    def launch(*args):
        with work.uncounted():
            out = plain(*args)
        work.add(name, flops(*args), 0)
        return tuple(t.detach() for t in out)
    return launch


@pytest.mark.parametrize("x0_grad", [True, False])
def test_kernel_path_counts_the_plain_path(monkeypatch, x0_grad):
    """The autograd Functions of kernels 2, 4 and 5 with their launches
    replaced by stand-ins (the plain version unseen plus the count
    function), forward and backward in train mode: the same flops as the
    plain versions' forward and backward, so a backward's recompute is not
    counted and each launch counts its plain version once."""
    b, d, h, w = 2, 5, 3, 4
    cost, params, stats = _agg_args(np.random.RandomState(4), b, d, h, w)
    names = agg_mod.PARAM_NAMES
    monkeypatch.setattr(agg_mod, "_launch", _as_kernel(
        "aggregate_cost_volume", aggregate_cost_volume_ref,
        lambda c, *_: aggregation_flops(*c.shape[:4])))
    monkeypatch.setattr(head_mod, "_launch", _as_kernel(
        "coarse_head", lambda fl, fr, p, rs, tr, n, eps: coarse_head_ref(fl, fr, p, rs, tr, n,
                                                                         eps),
        lambda fl, fr, p, rs, tr, n, eps: coarse_head_flops(*fl.shape[:3], n)))

    def tower_fwd(x0, kernels, biases, gammas, betas, run_stats, train, eps):
        p = {"kernels": kernels, "biases": biases, "gammas": gammas, "betas": betas}
        with work.uncounted():
            y7, mu, var, xs, ys = tower_ref(x0, p, run_stats, train, eps, buffers=True)
        return y7, mu, var, xs, ys

    def tower_bwd(g, x0, xs, ys, kernels, gammas, betas, mu, var, eps):
        with work.uncounted(), torch.enable_grad():
            leaves = [x0.detach().requires_grad_(), gammas.detach().requires_grad_(),
                      betas.detach().requires_grad_()]
            ks = [k.detach().requires_grad_() for k in kernels]
            bs = [torch.zeros(k.shape[-1], requires_grad=True) for k in kernels]
            y = tower_ref(leaves[0], {"kernels": ks, "biases": bs, "gammas": leaves[1],
                                      "betas": leaves[2]}, (mu, var), True, eps)[0]
            grads = torch.autograd.grad(y, leaves + ks + bs, g)
        return grads[0], list(grads[3:11]), list(grads[11:]), grads[1], grads[2]
    monkeypatch.setattr(tower_mod, "tower_forward_cuda", tower_fwd)
    monkeypatch.setattr(tower_mod, "tower_backward_cuda", tower_bwd)
    x0, tparams, tstats = _tower_args(b, 6, 7)

    def leaves():
        tp = {key: [t.clone().requires_grad_() for t in v] if isinstance(v, list)
              else v.clone().requires_grad_() for key, v in tparams.items()}
        return (x0.clone().requires_grad_(x0_grad), tp, cost.clone().requires_grad_(),
                {k: v.clone().requires_grad_() for k, v in params.items()})

    def kernel_path():
        x, tp, c, p = leaves()
        y = tower_mod._Tower.apply(x, *tstats, True, 1e-5, tp["gammas"], tp["betas"],
                                   *tp["kernels"], *tp["biases"])[0]
        out = agg_mod._Aggregation.apply(c, *stats, True, 1e-5, *(p[n] for n in names))[0]
        disp = head_mod._CoarseHead.apply(c[:, 0], c[:, 1], *stats, True, d, 1e-5,
                                          *(p[n] for n in names))[0]
        (y.sum() + out.sum() + disp.sum()).backward()

    def plain_path():
        x, tp, c, p = leaves()
        y = tower_ref(x, tp, tstats, True)[0]
        out = aggregate_cost_volume_ref(c, p, stats, True)[0]
        disp = coarse_head_ref(c[:, 0], c[:, 1], p, stats, True, d)[0]
        (y.sum() + out.sum() + disp.sum()).backward()

    got = profiling.count_work(kernel_path)
    want = profiling.cost_analysis(plain_path)
    print(f"x0 grad {x0_grad}: kernel path {got['aten_flops']} aten + {got['kernel_flops']} "
          f"by the wrappers {got['kernel_flops_by_name']}; plain path {want['flops']:.0f}")
    assert got["kernel_calls"] == {"aggregate_cost_volume": 1, "coarse_head": 1, "tower": 1,
                                   "tower backward": 1}
    assert got["aten_flops"] + got["kernel_flops"] == want["flops"]


def test_trace_and_achieved_flops_on_cpu(tmp_path, monkeypatch):
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    out = profiling.trace(lambda: a @ b, log_dir=str(tmp_path / "trace"), iters=2, device="cpu")
    assert torch.equal(out, a @ b)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert profiling.trace.last_path == str(tmp_path / "trace" / files[0])
    events = json.load(open(tmp_path / "trace" / files[0]))["traceEvents"]
    assert sum(e.get("name") == "aten::mm" for e in events) == 2
    got = profiling.achieved_flops(lambda: a @ b, iters=3, device="cpu")
    want = jax_prof.achieved_flops(lambda x, y: x @ y, jnp.ones((64, 128)), jnp.ones((128, 32)),
                                   iters=3)
    assert set(got) == set(want)
    assert got["model_flops"] == want["model_flops"] == 524288 and got["seconds_per_call"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (profiling.achieved_flops, profiling.trace):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(lambda: a @ b)
