"""Figures of the experiments, from the port's JSON outputs.

Counterpart of ``deeprecsys_tpu/experiments/plots.py:58-345`` (the
reference ships its characterization as figures:
``experiments/operator_breakdown/png/op_breakdown_{cpu,gpu}.png``,
``experiments/speedup/png/model_speedup.png``). Each function reads one
output of the port's experiments and writes one PNG:

  op_breakdown.png    per-stage shares of a forward, stacked bars, at the
                      largest batch (``experiments/op_breakdown.py``'s JSON)
  model_speedup.png   card over host, ms a forward at the largest common
                      batch of each model's ``gpu_<model>.json`` and
                      ``cpu_<model>.json`` ladders (``experiments/sweep.py``)
  qps_sla.png         latency-bounded QPS at the p95 SLA per model and
                      backend (``experiments/qps_sweep.py``'s JSON)
  zipf_bench.png      direct against hot/cold forward on zipf ids
                      (``experiments/skew_bench.py --json``)
  train_quality.png   holdout AUC against steps beside the Bayes ceiling
                      (``experiments/train_quality.py``'s JSON)

The JAX package's drift figure reads TPU jobs that the port has no
counterpart of. ``matplotlib`` is imported inside each function (the card's
machine has none); a figure whose input is missing is skipped with a line
that says so.

Usage: python -m deeprecsys_tpu_torch.experiments.plots [--bench-dir build/experiments]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

# Validated categorical palette (fixed slot order, never cycled) + ink and
# surface tokens; stages map to slots in one canonical order so a stage
# keeps its hue across charts and models.
SERIES = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300",
          "#4a3aa7")
STAGE_ORDER = ("embedding", "bottom_mlp", "interaction", "top_mlp",
               "attention", "rnn", "task_heads")
STAGE_LABEL = {"embedding": "embedding gather", "bottom_mlp": "bottom MLP",
               "interaction": "interaction", "top_mlp": "top MLP",
               "attention": "attention", "rnn": "RNN",
               "task_heads": "task heads"}
SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK_2 = "#52514e"
GRID = "#e4e3df"


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _style(ax):
    ax.set_facecolor(SURFACE)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(GRID)
    ax.tick_params(colors=INK_2, labelcolor=INK)
    ax.grid(True, axis="x" if ax.get_xscale() == "log" else "y",
            color=GRID, linewidth=0.7, zorder=0)
    ax.set_axisbelow(True)


def _save(fig, plt, out: Path):
    fig.tight_layout()
    fig.savefig(out, dpi=150, facecolor=SURFACE)
    plt.close(fig)


def plot_op_breakdown(path: Path, out: Path):
    """Stacked stage shares at the largest batch of ``op_breakdown.json``."""
    plt = _pyplot()
    all_rows = json.loads(Path(path).read_text())
    unknown = {s for r in all_rows for s in r["stage_fraction"]} - set(STAGE_ORDER)
    if unknown:  # a silent omission would make a stack top out under 100%
        raise ValueError(f"stages missing from STAGE_ORDER: {sorted(unknown)}")
    batch = max(r["batch"] for r in all_rows)
    rows = [r for r in all_rows if r["batch"] == batch]
    models = [r["model"] for r in rows]
    if len(set(models)) != len(models):
        raise ValueError(f"duplicate models at batch {batch}: {models}")
    fig, ax = plt.subplots(figsize=(7, 4), facecolor=SURFACE)
    _style(ax)
    bottoms = [0.0] * len(models)
    for si, stage in enumerate(STAGE_ORDER):
        vals = [r["stage_fraction"].get(stage, 0.0) * 100 for r in rows]
        if not any(vals):
            continue
        ax.bar(models, vals, bottom=bottoms, width=0.55, color=SERIES[si], edgecolor=SURFACE,
               linewidth=2, label=STAGE_LABEL[stage], zorder=3)
        bottoms = [b + v for b, v in zip(bottoms, vals)]
    for i, r in enumerate(rows):  # direct label on the lookup's share
        emb = r["stage_fraction"].get("embedding", 0.0) * 100
        ax.text(i, emb / 2, f"{emb:.0f}%", ha="center", va="center", color=SURFACE,
                fontsize=10, fontweight="bold")
    ax.set_ylabel("share of the stages' time (%)", color=INK)
    ax.set_ylim(0, 100)
    ax.set_title(f"Per-stage time, batch {batch}, {rows[0].get('device', '')}",
                 color=INK, fontsize=11)
    ax.legend(frameon=False, labelcolor=INK, fontsize=9, loc="center left",
              bbox_to_anchor=(1.0, 0.5))
    _save(fig, plt, out)


def plot_model_speedup(char_dir: Path, out: Path):
    """Card over host per model: the ratio of the ``cpu_`` ladder's ms to the
    ``gpu_`` ladder's at their largest common batch."""
    char_dir = Path(char_dir)
    models, sp, batches = [], [], []
    for g in sorted(char_dir.glob("gpu_*.json")):
        c = char_dir / ("cpu_" + g.name[len("gpu_"):])
        if not c.exists():
            continue
        gd, cd = json.loads(g.read_text()), json.loads(c.read_text())
        common = sorted(set(gd["batch_sizes"]) & set(cd["batch_sizes"]))
        if not common:
            continue
        b = common[-1]
        models.append(g.stem[len("gpu_"):])
        sp.append(cd["latencies_ms"][cd["batch_sizes"].index(b)]
                  / gd["latencies_ms"][gd["batch_sizes"].index(b)])
        batches.append(b)
    if not models:
        print(f"skip speedup figure: no model has both gpu_ and cpu_ ladders in {char_dir}")
        return
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4), facecolor=SURFACE)
    ax.set_xscale("log")
    _style(ax)
    y = list(range(len(models)))[::-1]
    ax.barh(y, sp, height=0.55, color=SERIES[0], edgecolor=SURFACE, linewidth=2, zorder=3)
    for yi, v, b in zip(y, sp, batches):
        ax.text(v * 1.1, yi, f"{v:.1f}x (batch {b})", va="center", color=INK, fontsize=9)
    ax.set_yticks(y, models)
    ax.set_xlabel("host ms / card ms a forward (log scale)", color=INK)
    ax.set_xlim(min(1.0, min(sp) / 2), max(sp) * 4)
    ax.set_title("Model speedup of the card over the host (latency ladders)", color=INK,
                 fontsize=11)
    _save(fig, plt, out)


def plot_qps_sla(path: Path, out: Path):
    """Latency-bounded QPS per model, one series a backend."""
    plt = _pyplot()
    d = json.loads(Path(path).read_text())
    by_backend: dict[str, dict[str, float]] = {}
    slas = set()
    for key, rec in d.items():
        slas.add(rec["sla_ms"])
        model, _, backend = key.partition(":")
        ok = [p["qps"] for p in rec["sweep"] if p["meets_sla"]]
        by_backend.setdefault(backend, {})[model] = max(ok) if ok else 0.0
    if len(slas) > 1:
        raise ValueError(f"{path} mixes SLAs {sorted(slas)}; plot one SLA at a time")
    sla = slas.pop()
    backends = sorted(by_backend)
    models = sorted({m for v in by_backend.values() for m in v})
    fig, ax = plt.subplots(figsize=(7, 4), facecolor=SURFACE)
    _style(ax)
    x = np.arange(len(models))
    width = 0.8 / len(backends)
    for i, backend in enumerate(backends):
        qps = [by_backend[backend].get(m, 0.0) for m in models]
        xs = x - 0.4 + width * (i + 0.5)
        ax.bar(xs, qps, width=width, color=SERIES[i % len(SERIES)], edgecolor=SURFACE,
               linewidth=2, zorder=3, label=backend)
        for xi, v in zip(xs, qps):
            ax.text(xi, v, f"{v:.0f}", ha="center", va="bottom", color=INK, fontsize=8)
    ax.set_xticks(list(x), models)
    ax.set_ylabel("QPS", color=INK)
    ax.legend(frameon=False, labelcolor=INK, fontsize=8)
    ax.set_title(f"Latency-bounded QPS, p95 <= {sla:.0f} ms SLA", color=INK, fontsize=11)
    _save(fig, plt, out)


def plot_zipf_bench(path: Path, out: Path):
    """Direct against hot/cold forward wall on zipf ids, from the JSON of
    ``skew_bench --json``."""
    path = Path(path)
    if not path.exists():
        print(f"skip zipf figure: {path} missing")
        return
    d = json.loads(path.read_text())
    rows = d["models"]
    if not rows:
        print("skip zipf figure: no models recorded")
        return
    plt = _pyplot()
    models = [r["model"] for r in rows]
    direct = [r["xla_ms"] * 1e3 for r in rows]
    hotcold = [r["hotcold_ms"] * 1e3 for r in rows]
    fig, ax = plt.subplots(figsize=(7, 4), facecolor=SURFACE)
    _style(ax)
    y = list(range(len(models)))[::-1]
    h = 0.32
    ax.barh([yi + h / 2 + 0.02 for yi in y], direct, height=h, color=SERIES[0],
            edgecolor=SURFACE, linewidth=2, zorder=3, label="direct lookup")
    ax.barh([yi - h / 2 - 0.02 for yi in y], hotcold, height=h, color=SERIES[1],
            edgecolor=SURFACE, linewidth=2, zorder=3, label="hot/cold split")
    for yi, r in zip(y, rows):
        ax.text(max(r["xla_ms"], r["hotcold_ms"]) * 1e3 * 1.04, yi,
                f"{r['speedup']:.2f}x (hot {r['hot_coverage']:.0%}, auto: {r['auto_impl']})",
                va="center", color=INK, fontsize=9)
    ax.set_yticks(y, models)
    ax.set_xlabel(f"forward wall, us: zipf({rows[0]['alpha']}) ids, batch {rows[0]['batch']} "
                  "(lower is better)", color=INK)
    ax.set_xlim(0, max(direct + hotcold) * 1.6)
    ax.legend(loc="lower right", frameon=False, labelcolor=INK, fontsize=9)
    ax.set_title(f"Skewed traffic: direct against hot/cold [{d.get('card', '')}]", color=INK,
                 fontsize=10)
    _save(fig, plt, out)


def plot_train_quality(path: Path, out: Path):
    """Holdout AUC against steps per model, with the Bayes ceiling."""
    plt = _pyplot()
    rec = json.loads(Path(path).read_text())
    models = sorted(rec)
    fig, axes = plt.subplots(1, len(models), figsize=(5.4 * len(models), 3.8),
                             facecolor=SURFACE, squeeze=False)
    for ax, model in zip(axes[0], models):
        r = rec[model]
        steps = [p["step"] for p in r["auc_curve"]]
        aucs = [p["auc"] for p in r["auc_curve"]]
        _style(ax)
        ax.plot(steps, aucs, color=SERIES[0], linewidth=2, label="holdout AUC", zorder=3)
        ax.axhline(r["bayes_auc"], color=INK_2, linestyle="--", linewidth=1,
                   label=f"Bayes ceiling {r['bayes_auc']:.3f}", zorder=2)
        ax.axhline(0.5, color=GRID, linewidth=1, zorder=1)
        ax.set_xlabel("training step", color=INK)
        ax.set_ylabel("holdout ROC-AUC", color=INK)
        ax.set_ylim(0.45, 1.0)
        ax.set_title(f"{model}: sparse touched-rows trainer, zipf(1.2) stream", color=INK,
                     fontsize=10)
        ax.legend(loc="lower right", frameon=False, fontsize=8, labelcolor=INK)
    fig.suptitle("Training to quality: a planted table-only signal", color=INK, fontsize=11)
    _save(fig, plt, out)


def main(argv=None):
    from deeprecsys_tpu_torch.serving.latency_model import CHAR_DIR

    ap = argparse.ArgumentParser(description="figures of the port's experiments")
    ap.add_argument("--bench-dir", default="build/experiments",
                    help="op_breakdown.json, qps_sweep.json, train_quality.json, skew.json")
    ap.add_argument("--char-dir", default=str(CHAR_DIR))
    args = ap.parse_args(argv)
    bench = Path(args.bench_dir)
    png = bench / "png"
    png.mkdir(parents=True, exist_ok=True)
    for name, fn, src in (("op_breakdown", plot_op_breakdown, bench / "op_breakdown.json"),
                          ("qps_sla", plot_qps_sla, bench / "qps_sweep.json"),
                          ("train_quality", plot_train_quality, bench / "train_quality.json")):
        if src.exists():
            fn(src, png / f"{name}.png")
        else:
            print(f"skip {name} figure: {src} missing")
    plot_model_speedup(Path(args.char_dir), png / "model_speedup.png")
    plot_zipf_bench(bench / "skew.json", png / "zipf_bench.png")
    print(f"figures in {png}")


if __name__ == "__main__":
    main()
