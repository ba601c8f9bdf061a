"""Adaptation results pipeline (counterpart of
adaptive_stereo_tpu/analysis/results.py; reference
evaluation/preprocess_adapt_results.py and generate_adaptation_plots.py).

Collates per-method trials.csv files into the long-form results table
(Method / Step / EPE / FCS / Domain / GradientUpdates) and draws the
paper's line plots and bar chart through analysis/figure.py.

The JAX package builds the table with pandas; the port keeps it as a dict
of lists, one per column, in the same row order, and reads and writes the
CSV files with the csv module. Reading follows pandas' inference for a
numeric column (integers when every cell is one, else floats with an
empty cell as NaN) and its default float converter (pandas_float), and
writing follows its to_csv (a column of integers as integers, any other
numeric column as floats by repr, NaN empty), so results_to_csv writes
the bytes the JAX package writes.
"""

from __future__ import annotations

import csv
import math
import os
import re
from typing import Dict, List, Optional, Sequence

from ..utils.logging_utils import pandas_float_cell
from .figure import subplots

METHOD_LEGEND = {"nonstop": "MAD-FULL", "vs": "VS", "er": "ER", "vs+er": "VS + ER"}
COLUMNS = ("Method", "Step", "EPE", "FCS", "Domain", "GradientUpdates")

Table = Dict[str, List]

_INT = re.compile(r"[+-]?[0-9]+")
_FLOAT = re.compile(r"([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([+-]?[0-9]+))?")
_POW10 = [float(f"1e{k}") for k in range(309)]
_NAN_TEXT = {"", "nan", "NaN", "-nan", "-NaN", "NA", "N/A", "n/a", "NULL", "null", "None",
             "<NA>", "#N/A", "#NA", "1.#IND", "-1.#IND", "1.#QNAN", "-1.#QNAN"}
_INF_TEXT = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf, "infinity": math.inf,
             "+infinity": math.inf, "-infinity": -math.inf}


def pandas_float(text: str) -> float:
    """A CSV cell as pandas.read_csv's default float converter reads it (the
    "high" precision converter, precise_xstrtod of pandas' C tokenizer): at
    most 17 digits, leading zeros included, accumulated in a double as
    number * 10 + digit, then one multiplication or division by the exact
    power of ten. Not always correctly rounded: '2.4845353310771796' reads
    as 2.48453533107718, an ulp off. Raises ValueError on text that is not
    a number."""
    if text in _NAN_TEXT:
        return math.nan
    if text.strip().lower() in _INF_TEXT:
        return _INF_TEXT[text.strip().lower()]
    m = _FLOAT.fullmatch(text.strip())
    if m is None or not (m.group(2) or m.group(3)):
        raise ValueError(f"not a number: {text!r}")
    sign, whole, frac, exp = m.groups()
    number, digits, exponent = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in frac or "":
        if digits >= 17:
            break
        number = number * 10.0 + (ord(ch) - 48)
        digits += 1
        exponent -= 1
    if sign == "-":
        number = -number
    if exp:
        exponent += int(exp)
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 * number if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _typed(cells: List[str]) -> List:
    """A column of CSV cells as pandas.read_csv types it: ints, else floats
    (an empty cell NaN), else strings."""
    if cells and all(_INT.fullmatch(c) for c in cells):
        return [int(c) for c in cells]
    try:
        return [pandas_float(c) for c in cells]
    except ValueError:
        return [c if c != "" else math.nan for c in cells]


def read_csv_columns(path: str) -> Table:
    """{column: typed values} of a CSV file with a header row."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    return {name: _typed([r[j] if j < len(r) else "" for r in rows])
            for j, name in enumerate(header)}


def _is_nan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def collate_trials(trials_by_method: Dict[str, str],
                   steps: Sequence[int] = (1000, 2000, 3000, 4000),
                   pre_adapt_method: Optional[str] = "nonstop") -> Table:
    """The long-form results table of per-method trials.csv paths, as
    {column: list}.

    pre_adapt_method: the method whose step == -1 (pre-adaptation) row is
    included (the reference evaluates pre-adaptation once, for nonstop;
    preprocess_adapt_results.py:44-46)."""
    rows: Table = {name: [] for name in COLUMNS}
    for method, csv_path in trials_by_method.items():
        if not os.path.exists(csv_path):
            raise FileNotFoundError(f"missing trials.csv for {method}: {csv_path}")
        df = read_csv_columns(csv_path)
        if len({v for v in df["trial"] if not _is_nan(v)}) != 1:
            raise ValueError(f"{csv_path}: expected a single trial")

        use_steps = list(steps)
        if method == pre_adapt_method:
            use_steps.insert(0, -1)

        for step in use_steps:
            sel = [i for i, s in enumerate(df["step"]) if s == step]
            if not sel:
                continue
            first = sel[0]
            for domain in ("TRAIN", "ADAPT"):
                rows["Method"].append(METHOD_LEGEND.get(method, method))
                rows["Step"].append(step)
                rows["EPE"].append(df[f"EPE_{domain}"][first])
                rows["FCS"].append(df[f"FCS_{domain}"][first])
                rows["Domain"].append(domain)
                gu = df["GRADIENT_UPDATES"][first] if "GRADIENT_UPDATES" in df else 0
                rows["GradientUpdates"].append(gu)
    return rows


def _column_format(values: List):
    """pandas' to_csv of a column: strings as they are, a column of ints
    as ints, any other numeric column as floats (repr, NaN empty)."""
    if all(isinstance(v, str) for v in values):
        return str
    if all(isinstance(v, int) and not isinstance(v, bool) for v in values):
        return lambda v: str(int(v))
    return pandas_float_cell


def results_to_csv(trials_by_method: Dict[str, str], output_path: str, **kw) -> None:
    table = collate_trials(trials_by_method, **kw)
    fmt = {name: _column_format(values) for name, values in table.items()}
    with open(output_path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(table))
        writer.writerows(zip(*([fmt[name](v) for v in values]
                               for name, values in table.items())))


def plot_adaptation_curves(results: Table, output_path: str, metric: str = "EPE") -> None:
    """Per-domain metric-vs-step line plots, one line per method."""
    fig, axes = subplots(2, figsize=(10, 4))
    for ax, domain in zip(axes, ("ADAPT", "TRAIN")):
        idx = [i for i, d in enumerate(results["Domain"]) if d == domain]
        methods = list(dict.fromkeys(results["Method"][i] for i in idx))
        for method in methods:
            points = sorted(((results["Step"][i], results[metric][i]) for i in idx
                             if results["Method"][i] == method), key=lambda p: p[0])
            ax.plot([p[0] for p in points], [p[1] for p in points], marker="o", label=method)
        ax.set_title(f"{domain} domain")
        ax.set_xlabel("adaptation step")
        ax.set_ylabel(metric)
    axes[0].legend()
    fig.savefig(output_path)


def plot_gradient_updates_bar(results: Table, output_path: str, step: int = 4000) -> None:
    """Gradient-updates-at-budget bar chart (efficiency headline)."""
    idx = [i for i, (s, d) in enumerate(zip(results["Step"], results["Domain"]))
           if s == step and d == "ADAPT"]
    fig, ax = subplots(figsize=(5, 4))
    ax.bar([results["Method"][i] for i in idx], [results["GradientUpdates"][i] for i in idx])
    ax.set_ylabel(f"gradient updates @ {step} steps")
    fig.savefig(output_path)
