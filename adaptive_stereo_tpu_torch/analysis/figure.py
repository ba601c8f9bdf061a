"""A figure writer of the port's own, in place of matplotlib: vector PDF and SVG.

The JAX package draws its analysis plots with matplotlib, which the port
does not import. This module draws what those plots need: linear axes with
ticks and labels, polylines with markers, dashed horizontal and vertical
lines, bars (categorical), histogram bars with alpha, text, a legend and a
fixed y range. Each Axes keeps the series it was given (lines, rects,
hline_data, vline_data, texts), so that they can be compared with what
matplotlib drew for the same data.

Figure.savefig writes by the extension: ".pdf" (PDF 1.4, one page, the
base-14 font Helvetica, nothing embedded, an uncompressed content stream)
or ".svg"; any other extension raises ValueError. In the SVG each line of
data is one <polyline> with one point per sample (a NaN breaks it into one
polyline a run, as matplotlib leaves a gap); frames, ticks and dashed lines
are <path>s, bars <rect>s and markers <circle>s.

Colors are matplotlib's names for those the plots use and its default
cycle (tab10). A label of TeX mathtext ("$\\mathcal{C}(u, v)$") is drawn
as its plain text ("C(u, v)"). The layout (margins, tick spacing, legend
place) is this module's own, not matplotlib's.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# matplotlib's default color cycle (tab10) and the named colors in use.
CYCLE = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b", "#e377c2",
         "#7f7f7f", "#bcbd22", "#17becf")
NAMED = {"blue": "#0000ff", "red": "#ff0000", "black": "#000000", "gray": "#808080",
         "white": "#ffffff",
         **{f"tab:{n}": c for n, c in zip(("blue", "orange", "green", "red", "purple",
                                           "brown", "pink", "gray", "olive", "cyan"), CYCLE)}}
# Helvetica advance widths (1/1000 em) of the characters 32-126, from the
# font's Adobe metrics, to place and centre text.
_HELVETICA = (
    278, 278, 355, 556, 556, 889, 667, 222, 333, 333, 389, 584, 278, 333, 278, 278, 556, 556,
    556, 556, 556, 556, 556, 556, 556, 556, 278, 278, 584, 584, 584, 556, 1015, 667, 667, 722,
    722, 667, 611, 778, 722, 278, 500, 667, 556, 833, 722, 778, 667, 778, 722, 667, 611, 722,
    667, 944, 667, 667, 611, 278, 278, 278, 469, 556, 222, 556, 556, 500, 556, 556, 278, 556,
    556, 222, 222, 500, 222, 833, 556, 556, 556, 556, 333, 500, 278, 556, 500, 722, 500, 500,
    500, 334, 260, 334, 584)
FONT_SIZE = 10.0
LINE_WIDTH = 1.5
MARKER_SIZE = 6.0
BAR_WIDTH = 0.8
MAX_TICKS = 8
# matplotlib's dash patterns, in multiples of the line width.
_DASHED = (3.7, 1.6)
_FORMATS = (".pdf", ".svg")


def color_rgb(color: str) -> Tuple[float, float, float]:
    c = NAMED.get(color, color)
    if not (isinstance(c, str) and re.fullmatch(r"#[0-9a-fA-F]{6}", c)):
        raise ValueError(f"unknown color {color!r}: use #rrggbb or one of {sorted(NAMED)}")
    return tuple(int(c[i:i + 2], 16) / 255.0 for i in (1, 3, 5))


def plain_text(s: str) -> str:
    """Mathtext as plain text: the $ signs go and \\cmd{X} becomes X."""
    s = re.sub(r"\\[a-zA-Z]+\{([^{}]*)\}", r"\1", s)
    return re.sub(r"\\[a-zA-Z]+", "", s).replace("$", "")


def text_width(s: str, size: float) -> float:
    return sum(_HELVETICA[ord(ch) - 32] if 32 <= ord(ch) <= 126 else 556 for ch in s) \
        * size / 1000.0


def _dashes(linestyle, width: float) -> Tuple[float, ...]:
    """A line style ('solid', 'dashed' or matplotlib's (offset, (on, off,
    ...))) as a dash array in points."""
    if linestyle in ("solid", "-", None):
        return ()
    if linestyle in ("dashed", "--"):
        pattern = _DASHED
    elif isinstance(linestyle, tuple) and len(linestyle) == 2:
        pattern = tuple(linestyle[1])
    else:
        raise ValueError(f"unsupported line style {linestyle!r}")
    return tuple(p * width for p in pattern)


def nice_ticks(lo: float, hi: float) -> List[float]:
    """Ticks at multiples of 1, 2, 2.5 or 5 x 10^k inside [lo, hi], at most
    MAX_TICKS of them."""
    if not (np.isfinite(lo) and np.isfinite(hi)) or hi <= lo:
        return [lo]
    raw = (hi - lo) / (MAX_TICKS - 1)
    exp = math.floor(math.log10(raw))
    for m in (1, 2, 2.5, 5, 10):
        step = m * 10.0 ** exp
        first = math.ceil(lo / step - 1e-9)
        last = math.floor(hi / step + 1e-9)
        if last - first + 1 <= MAX_TICKS:
            return [i * step for i in range(first, last + 1)]
    return [lo, hi]


def tick_labels(ticks: Sequence[float]) -> List[str]:
    """Labels with the decimals the tick spacing needs."""
    if len(ticks) < 2:
        return [f"{t:g}" for t in ticks]
    step = abs(ticks[1] - ticks[0])
    decimals = 0
    while decimals < 10 and abs(round(step, decimals) - step) > 1e-9 * max(step, 1e-300):
        decimals += 1
    labels = [f"{t:.{decimals}f}" for t in ticks]
    return [lab[1:] if lab.startswith("-") and float(lab) == 0 else lab for lab in labels]


class Axes:
    """One plot: the series it holds and how they are drawn."""

    def __init__(self):
        self.lines: List[Dict] = []    # x, y (float64), color, marker, dashes, width, label
        self.rects: List[Dict] = []    # x, y, width, height, color, alpha, label
        self.hline_data: List[Dict] = []  # y, xmin, xmax, color, dashes
        self.vline_data: List[Dict] = []  # x, ymin, ymax, color, dashes
        self.texts: List[Dict] = []    # x, y, s, va
        self.title = self.xlabel = self.ylabel = ""
        self.ylim: Optional[Tuple[float, float]] = None
        self.xticks: Optional[List[float]] = None
        self.xticklabels: Optional[List[str]] = None
        self.legend_loc: Optional[str] = None
        self.legend_size = FONT_SIZE
        self._next_color = 0

    def _color(self, color: Optional[str]) -> str:
        if color is None:
            color = CYCLE[self._next_color % len(CYCLE)]
            self._next_color += 1
        color_rgb(color)  # an unknown name raises here, not when saving
        return color

    def plot(self, x, y, color: Optional[str] = None, marker: Optional[str] = None,
             label: Optional[str] = None) -> None:
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        if x.shape != y.shape:
            raise ValueError(f"plot: x has {x.size} points, y {y.size}")
        if marker not in (None, "o"):
            raise ValueError(f"unsupported marker {marker!r}: None or 'o'")
        self.lines.append(dict(x=x, y=y, color=self._color(color), marker=marker,
                               dashes=(), width=LINE_WIDTH, label=label))

    def bar(self, categories: Sequence[str], heights, color: Optional[str] = None) -> None:
        """One bar per category, centred at the category's place on a
        categorical axis: 0, 1, ... in order of first appearance, labelled
        by the category (matplotlib's categorical axis)."""
        color = self._color(color)
        places = {c: i for i, c in enumerate(dict.fromkeys(str(c) for c in categories))}
        for c, h in zip(categories, np.asarray(heights, np.float64).ravel()):
            self.rects.append(dict(x=places[str(c)] - BAR_WIDTH / 2, y=0.0, width=BAR_WIDTH,
                                   height=float(h), color=color, alpha=1.0, label=None))
        self.xticks = list(places.values())
        self.xticklabels = list(places)

    def hist(self, values, bins, color: Optional[str] = None, alpha: float = 1.0,
             label: Optional[str] = None):
        """Bars of the densities np.histogram(values, bins, density=True), as
        plt.hist(density=True) draws them. Returns (densities, bins)."""
        heights, edges = np.histogram(np.asarray(values), bins, density=True)
        color = self._color(color)
        for i, h in enumerate(heights):
            self.rects.append(dict(x=float(edges[i]), y=0.0,
                                   width=float(edges[i + 1] - edges[i]), height=float(h),
                                   color=color, alpha=alpha, label=label if i == 0 else None))
        return heights, edges

    def hlines(self, y: float, xmin: float, xmax: float, colors: str = "black",
               linestyles="solid") -> None:
        self.hline_data.append(dict(y=float(y), xmin=float(xmin), xmax=float(xmax),
                                color=self._color(colors),
                                dashes=_dashes(linestyles, LINE_WIDTH)))

    def vlines(self, x: float, ymin: float, ymax: float, colors: str = "black",
               linestyles="solid") -> None:
        self.vline_data.append(dict(x=float(x), ymin=float(ymin), ymax=float(ymax),
                                color=self._color(colors),
                                dashes=_dashes(linestyles, LINE_WIDTH)))

    def text(self, x: float, y: float, s: str, va: str = "baseline") -> None:
        """Text starting at (x, y), its baseline or its middle there."""
        if va not in ("baseline", "center"):
            raise ValueError(f"text alignment va={va!r}: 'baseline' or 'center'")
        self.texts.append(dict(x=float(x), y=float(y), s=str(s), va=va))

    def set_title(self, s: str) -> None:
        self.title = s

    def set_xlabel(self, s: str) -> None:
        self.xlabel = s

    def set_ylabel(self, s: str) -> None:
        self.ylabel = s

    def set_ylim(self, lo: float, hi: float) -> None:
        self.ylim = (float(lo), float(hi))

    def set_xticks(self, ticks, labels: Optional[Sequence[str]] = None) -> None:
        self.xticks = [float(t) for t in ticks]
        self.xticklabels = None if labels is None else [str(s) for s in labels]

    def legend(self, loc: str = "upper right", fontsize: float = FONT_SIZE) -> None:
        if loc not in ("upper right", "upper left", "best"):
            raise ValueError(f"unsupported legend location {loc!r}")
        self.legend_loc = "upper right" if loc == "best" else loc
        self.legend_size = fontsize

    # --- layout and drawing -------------------------------------------------

    def _limits(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        xs, ys = [], []
        for ln in self.lines:
            xs += [ln["x"]]
            ys += [ln["y"]]
        for r in self.rects:
            xs += [np.array([r["x"], r["x"] + r["width"]])]
            ys += [np.array([r["y"], r["y"] + r["height"]])]
        for h in self.hline_data:
            xs += [np.array([h["xmin"], h["xmax"]])]
            ys += [np.array([h["y"]])]
        for v in self.vline_data:
            xs += [np.array([v["x"]])]
            ys += [np.array([v["ymin"], v["ymax"]])]

        def span(parts, sticky_zero=False):
            vals = np.concatenate(parts) if parts else np.array([0.0, 1.0])
            vals = vals[np.isfinite(vals)]
            lo, hi = (float(vals.min()), float(vals.max())) if vals.size else (0.0, 1.0)
            if hi == lo:
                lo, hi = lo - 0.5, hi + 0.5
            pad = 0.05 * (hi - lo)
            lo_p, hi_p = lo - pad, hi + pad
            if sticky_zero and lo >= 0.0:  # bars stand on the axis, as matplotlib's
                lo_p = 0.0
            return lo_p, hi_p

        xlim = span(xs)
        ylim = self.ylim if self.ylim is not None else span(ys, sticky_zero=bool(self.rects))
        return xlim, ylim

    def _draw(self, canvas: "_Canvas", box: Tuple[float, float, float, float]) -> None:
        """Draw into canvas within box (left, bottom, right, top) in points;
        the box holds the labels too."""
        (x0, x1), (y0, y1) = self._limits()
        yticks = nice_ticks(y0, y1)
        ylabels = tick_labels(yticks)
        if self.xticks is not None:
            xticks = [t for t in self.xticks if x0 - 1e-9 <= t <= x1 + 1e-9]
            xlabels = (self.xticklabels if self.xticklabels is not None
                       else tick_labels(self.xticks))
            xlabels = [lab for t, lab in zip(self.xticks, xlabels) if x0 - 1e-9 <= t <= x1 + 1e-9]
        else:
            xticks = nice_ticks(x0, x1)
            xlabels = tick_labels(xticks)
        fs = FONT_SIZE
        left = box[0] + 6 + (fs + 4 if self.ylabel else 0) + max(
            [text_width(s, fs) for s in ylabels] + [0]) + 6
        bottom = box[1] + 6 + (fs + 6 if self.xlabel else 0) + fs + 6
        right = box[2] - 12
        top = box[3] - (1.2 * fs + 10 if self.title else 8)
        sx = (right - left) / (x1 - x0)
        sy = (top - bottom) / (y1 - y0)
        px = lambda x: left + (x - x0) * sx
        py = lambda y: bottom + (y - y0) * sy

        canvas.clip_begin(left, bottom, right - left, top - bottom)
        for r in self.rects:
            xa, xb = px(r["x"]), px(r["x"] + r["width"])
            ya, yb = py(r["y"]), py(r["y"] + r["height"])
            canvas.rect(min(xa, xb), min(ya, yb), abs(xb - xa), abs(yb - ya), r["color"],
                        r["alpha"])
        for ln in self.lines:
            # A NaN breaks the line, as in matplotlib: one polyline a run.
            finite = np.isfinite(ln["x"]) & np.isfinite(ln["y"])
            runs = np.split(np.arange(len(finite)), np.flatnonzero(~finite))
            for run in runs:
                run = run[finite[run]]
                if not run.size:
                    continue
                pts = [(px(ln["x"][i]), py(ln["y"][i])) for i in run]
                canvas.polyline(pts, ln["color"], ln["width"], ln["dashes"])
                if ln["marker"] == "o":
                    for cx, cy in pts:
                        canvas.circle(cx, cy, MARKER_SIZE / 2, ln["color"])
        for h in self.hline_data:
            canvas.path([(px(h["xmin"]), py(h["y"])), (px(h["xmax"]), py(h["y"]))],
                        h["color"], LINE_WIDTH, h["dashes"])
        for v in self.vline_data:
            canvas.path([(px(v["x"]), py(v["ymin"])), (px(v["x"]), py(v["ymax"]))],
                        v["color"], LINE_WIDTH, v["dashes"])
        canvas.clip_end()
        for t in self.texts:
            canvas.text(px(t["x"]), py(t["y"]), t["s"], fs, "left", t["va"])

        # Frame, ticks and labels.
        canvas.path([(left, bottom), (right, bottom), (right, top), (left, top), (left, bottom)],
                    "black", 0.8, ())
        for t, lab in zip(xticks, xlabels):
            canvas.path([(px(t), bottom), (px(t), bottom - 3.5)], "black", 0.8, ())
            canvas.text(px(t), bottom - 5, lab, fs, "center", "top")
        for t, lab in zip(yticks, ylabels):
            canvas.path([(left, py(t)), (left - 3.5, py(t))], "black", 0.8, ())
            canvas.text(left - 5, py(t), lab, fs, "right", "center")
        if self.xlabel:
            canvas.text((left + right) / 2, box[1] + 6, self.xlabel, fs, "center", "bottom")
        if self.ylabel:
            canvas.text(box[0] + 6 + fs, (bottom + top) / 2, self.ylabel, fs, "center",
                        "baseline", rotate=True)
        if self.title:
            canvas.text((left + right) / 2, top + 6, self.title, 1.2 * fs, "center", "bottom")
        if self.legend_loc is not None:
            self._draw_legend(canvas, left, right, top)

    def _draw_legend(self, canvas, left, right, top) -> None:
        entries = [("line", ln) for ln in self.lines if ln["label"]] + \
                  [("patch", r) for r in self.rects if r["label"]]
        if not entries:
            return
        fs = self.legend_size
        row = 1.4 * fs
        handle = 2.0 * fs
        width = handle + 0.8 * fs + max(text_width(plain_text(e[1]["label"]), fs)
                                        for e in entries) + 0.8 * fs
        height = row * len(entries) + 0.6 * fs
        bx = left + 6 if self.legend_loc == "upper left" else right - 6 - width
        by = top - 6 - height
        canvas.rect(bx, by, width, height, "white", 0.8, stroke="#cccccc")
        for i, (kind, e) in enumerate(entries):
            cy = top - 6 - 0.3 * fs - row * (i + 0.5)
            hx = bx + 0.5 * fs
            if kind == "line":
                canvas.path([(hx, cy), (hx + handle, cy)], e["color"], e["width"], e["dashes"])
                if e["marker"] == "o":
                    canvas.circle(hx + handle / 2, cy, MARKER_SIZE / 2, e["color"])
            else:
                canvas.rect(hx, cy - 0.35 * fs, handle, 0.7 * fs, e["color"], e["alpha"])
            canvas.text(hx + handle + 0.5 * fs, cy, e["label"], fs, "left", "center")


class Figure:
    """A figure of `ncols` axes side by side, figsize in inches."""

    def __init__(self, figsize: Tuple[float, float] = (6.4, 4.8), ncols: int = 1):
        self.width, self.height = 72.0 * figsize[0], 72.0 * figsize[1]
        self.axes = [Axes() for _ in range(ncols)]

    def savefig(self, path: str) -> None:
        ext = os.path.splitext(path)[1].lower()
        if ext not in _FORMATS:
            raise ValueError(f"cannot write {path!r}: the figure writer writes PDF (.pdf) "
                             "and SVG (.svg)")
        canvas = _Canvas(self.width, self.height)
        n = len(self.axes)
        for i, ax in enumerate(self.axes):
            ax._draw(canvas, (self.width * i / n, 0.0, self.width * (i + 1) / n, self.height))
        data = canvas.pdf() if ext == ".pdf" else canvas.svg()
        with open(path, "wb") as f:
            f.write(data)


class _Canvas:
    """Drawing operations in points (origin bottom left), emitted as PDF or
    SVG."""

    def __init__(self, width: float, height: float):
        self.width, self.height = width, height
        self.ops: List[Tuple] = []

    def path(self, pts, color, width, dashes):
        self.ops.append(("path", pts, color, width, dashes))

    def polyline(self, pts, color, width, dashes):
        self.ops.append(("polyline", pts, color, width, dashes))

    def rect(self, x, y, w, h, color, alpha, stroke=None):
        self.ops.append(("rect", x, y, w, h, color, alpha, stroke))

    def circle(self, cx, cy, r, color):
        self.ops.append(("circle", cx, cy, r, color))

    def text(self, x, y, s, size, ha, va, rotate=False):
        self.ops.append(("text", x, y, plain_text(s), size, ha, va, rotate))

    def clip_begin(self, x, y, w, h):
        self.ops.append(("clip", x, y, w, h))

    def clip_end(self):
        self.ops.append(("unclip",))

    @staticmethod
    def _offsets(s, size, ha, va):
        dx = {"left": 0.0, "center": -0.5, "right": -1.0}[ha] * text_width(s, size)
        dy = {"baseline": 0.0, "bottom": 0.22, "center": -0.35, "top": -0.75}[va] * size
        return dx, dy

    # --- PDF ---------------------------------------------------------------

    def pdf(self) -> bytes:
        f = _num
        rgb = lambda c: " ".join(f(v) for v in color_rgb(c))
        alphas: Dict[float, str] = {}
        out = []
        for op in self.ops:
            kind = op[0]
            if kind in ("path", "polyline"):
                _, pts, color, width, dashes = op
                if len(pts) < 2:
                    continue
                dash = "[" + " ".join(f(d) for d in dashes) + "] 0 d"
                out.append(f"{rgb(color)} RG {f(width)} w {dash} 1 J 1 j")
                out.append(f"{f(pts[0][0])} {f(pts[0][1])} m " + " ".join(
                    f"{f(x)} {f(y)} l" for x, y in pts[1:]) + " S")
            elif kind == "rect":
                _, x, y, w, h, color, alpha, stroke = op
                gs = ""
                if alpha < 1.0:
                    gs = f"/{alphas.setdefault(alpha, f'A{len(alphas)}')} gs "
                paint = "f"
                if stroke is not None:
                    gs += f"{rgb(stroke)} RG 0.8 w [] 0 d "
                    paint = "B"
                out.append(f"q {gs}{rgb(color)} rg {f(x)} {f(y)} {f(w)} {f(h)} re {paint} Q")
            elif kind == "circle":
                _, cx, cy, r, color = op
                k = 0.5523 * r
                out.append(
                    f"{rgb(color)} rg {f(cx + r)} {f(cy)} m "
                    f"{f(cx + r)} {f(cy + k)} {f(cx + k)} {f(cy + r)} {f(cx)} {f(cy + r)} c "
                    f"{f(cx - k)} {f(cy + r)} {f(cx - r)} {f(cy + k)} {f(cx - r)} {f(cy)} c "
                    f"{f(cx - r)} {f(cy - k)} {f(cx - k)} {f(cy - r)} {f(cx)} {f(cy - r)} c "
                    f"{f(cx + k)} {f(cy - r)} {f(cx + r)} {f(cy - k)} {f(cx + r)} {f(cy)} c f")
            elif kind == "text":
                _, x, y, s, size, ha, va, rotate = op
                dx, dy = self._offsets(s, size, ha, va)
                if rotate:  # reads bottom to top; the offsets turn with it
                    m = f"0 1 -1 0 {f(x - dy)} {f(y + dx)} Tm"
                else:
                    m = f"1 0 0 1 {f(x + dx)} {f(y + dy)} Tm"
                out.append(f"0 g BT /F1 {f(size)} Tf {m} ({_pdf_string(s)}) Tj ET")
            elif kind == "clip":
                _, x, y, w, h = op
                out.append(f"q {f(x)} {f(y)} {f(w)} {f(h)} re W n")
            elif kind == "unclip":
                out.append("Q")
        content = ("\n".join(out) + "\n").encode("latin-1")
        gstates = " ".join(f"/{name} << /Type /ExtGState /ca {a} /CA {a} >>"
                           for a, name in alphas.items())
        objects = [
            b"<< /Type /Catalog /Pages 2 0 R >>",
            b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
            (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {f(self.width)} {f(self.height)}] "
             f"/Resources << /Font << /F1 4 0 R >> /ExtGState << {gstates} >> >> "
             f"/Contents 5 0 R >>").encode(),
            b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica "
            b"/Encoding /WinAnsiEncoding >>",
            b"<< /Length " + str(len(content)).encode() + b" >>\nstream\n" + content
            + b"endstream",
        ]
        pdf = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = []
        for i, body in enumerate(objects, start=1):
            offsets.append(len(pdf))
            pdf += f"{i} 0 obj\n".encode() + body + b"\nendobj\n"
        xref = len(pdf)
        pdf += f"xref\n0 {len(objects) + 1}\n0000000000 65535 f \n".encode()
        for off in offsets:
            pdf += f"{off:010d} 00000 n \n".encode()
        pdf += (f"trailer\n<< /Size {len(objects) + 1} /Root 1 0 R >>\n"
                f"startxref\n{xref}\n%%EOF\n").encode()
        return bytes(pdf)

    # --- SVG ---------------------------------------------------------------

    def svg(self) -> bytes:
        H = self.height
        f = _num
        hexc = lambda c: "#" + "".join(f"{round(v * 255):02x}" for v in color_rgb(c))
        out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{f(self.width)}pt" '
               f'height="{f(H)}pt" viewBox="0 0 {f(self.width)} {f(H)}">',
               f'<rect x="0" y="0" width="{f(self.width)}" height="{f(H)}" fill="#ffffff"/>']
        clips = 0
        for op in self.ops:
            kind = op[0]
            if kind in ("path", "polyline"):
                _, pts, color, width, dashes = op
                if not pts:
                    continue
                style = (f'fill="none" stroke="{hexc(color)}" stroke-width="{f(width)}" '
                         f'stroke-linecap="round" stroke-linejoin="round"')
                if dashes:
                    style += f' stroke-dasharray="{",".join(f(d) for d in dashes)}"'
                coords = " ".join(f"{f(x)},{f(H - y)}" for x, y in pts)
                if kind == "polyline":
                    out.append(f'<polyline points="{coords}" {style}/>')
                else:
                    out.append(f'<path d="M {coords.replace(" ", " L ")}" {style}/>')
            elif kind == "rect":
                _, x, y, w, h, color, alpha, stroke = op
                extra = f' stroke="{hexc(stroke)}" stroke-width="0.8"' if stroke else ""
                out.append(f'<rect x="{f(x)}" y="{f(H - y - h)}" width="{f(w)}" '
                           f'height="{f(h)}" fill="{hexc(color)}" fill-opacity="{alpha}"'
                           f'{extra}/>')
            elif kind == "circle":
                _, cx, cy, r, color = op
                out.append(f'<circle cx="{f(cx)}" cy="{f(H - cy)}" r="{f(r)}" '
                           f'fill="{hexc(color)}"/>')
            elif kind == "text":
                _, x, y, s, size, ha, va, rotate = op
                dx, dy = self._offsets(s, size, ha, va)
                body = s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
                if rotate:
                    tx, ty = x - dy, y + dx
                    tf = f' transform="rotate(-90 {f(tx)} {f(H - ty)})"'
                else:
                    tx, ty, tf = x + dx, y + dy, ""
                out.append(f'<text x="{f(tx)}" y="{f(H - ty)}" font-family="Helvetica" '
                           f'font-size="{f(size)}"{tf}>{body}</text>')
            elif kind == "clip":
                _, x, y, w, h = op
                out.append(f'<clipPath id="clip{clips}"><rect x="{f(x)}" y="{f(H - y - h)}" '
                           f'width="{f(w)}" height="{f(h)}"/></clipPath>'
                           f'<g clip-path="url(#clip{clips})">')
                clips += 1
            elif kind == "unclip":
                out.append("</g>")
        out.append("</svg>")
        return ("\n".join(out) + "\n").encode()


def _num(v: float) -> str:
    """A coordinate to a thousandth of a point, without trailing zeros."""
    out = f"{v:.3f}".rstrip("0").rstrip(".")
    return "0" if out == "-0" else out


def _pdf_string(s: str) -> str:
    s = s.encode("latin-1", "replace").decode("latin-1")
    return s.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")


def subplots(ncols: int = 1, figsize: Tuple[float, float] = (6.4, 4.8)):
    """(figure, axes): one Axes for ncols == 1, else the list."""
    fig = Figure(figsize, ncols)
    return fig, (fig.axes[0] if ncols == 1 else fig.axes)
