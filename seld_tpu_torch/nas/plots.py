"""NAS result visualization (headless matplotlib).

Covers the reference's plotting layer: score-CDF curves per stage type /
stage count (plot_results.py:56-65,208-241), overall CDF comparison across
result files (plot_overall.py:31-65), and Pareto scatter (analyzer.py
:243-287). All functions save to file (Agg backend, no display).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

from seld_tpu_torch.nas.analyzer import count_blocks, is_1d, pareto_frontier


def sort_pairs(pairs: Sequence[dict], keyword: str = "test_seld_score",
               reverse: bool = True) -> List[dict]:
    return sorted(pairs, key=lambda x: x["perf"][keyword], reverse=reverse)


def _cdf(ax, pairs, keyword, label):
    values = sorted(x["perf"][keyword] for x in pairs)
    ax.plot(values, np.linspace(0, 1, len(values)), label=label)


def plot_score_cdf(groups: Dict[str, Sequence[dict]], keyword: str,
                   out_path: str, title: Optional[str] = None) -> str:
    """One CDF curve per named group of {config, perf} pairs."""
    fig, ax = plt.subplots(figsize=(7, 5))
    for label, pairs in groups.items():
        if pairs:
            _cdf(ax, pairs, keyword, f"{label} (n={len(pairs)})")
    ax.set_xlabel(keyword)
    ax.set_ylabel("CDF")
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_cdf_by_stage_count(pairs: Sequence[dict], keyword: str,
                            out_path: str,
                            criteria: Callable = is_1d) -> str:
    """CDFs grouped by the number of 1D stages in the body."""
    groups: Dict[str, list] = {}
    for pair in pairs:
        n = count_blocks(pair["config"], criteria)
        groups.setdefault(f"{n} 1d-stages", []).append(pair)
    return plot_score_cdf(dict(sorted(groups.items())), keyword, out_path)


def plot_cdf_by_stage_type(pairs: Sequence[dict], keyword: str,
                           out_path: str) -> str:
    """CDFs grouped by which stage types appear in the body."""
    stages = set()
    for pair in pairs:
        for key in pair["config"]:
            if key.startswith("BLOCK") and not key.endswith("ARGS"):
                stages.add(pair["config"][key])
    groups = {
        stage: [p for p in pairs
                if count_blocks(p["config"], lambda b: b == stage) > 0]
        for stage in sorted(stages)
    }
    return plot_score_cdf(groups, keyword, out_path)


def plot_violin_by_feature(table: Dict[str, np.ndarray], feature: str,
                           keyword: str, out_path: str) -> str:
    """Violin plot of the perf distribution per feature value."""
    values = sorted(np.unique(table[feature]).tolist())
    data = [table[keyword][table[feature] == v] for v in values]
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.violinplot([d for d in data if len(d)], showmedians=True)
    ax.set_xticks(range(1, len(values) + 1))
    ax.set_xticklabels([str(v) for v in values], rotation=30)
    ax.set_xlabel(feature)
    ax.set_ylabel(keyword)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_pareto(table: Dict[str, np.ndarray], keyword: str, keyword2: str,
                out_path: str, color_by: Optional[str] = None) -> str:
    """Scatter of two perf axes with the Pareto frontier overlaid."""
    xs, ys = table[keyword], table[keyword2]
    fig, ax = plt.subplots(figsize=(7, 5))
    if color_by is not None:
        for v in sorted(np.unique(table[color_by]).tolist()):
            mask = table[color_by] == v
            ax.plot(xs[mask], ys[mask], ".", alpha=0.7, label=str(v))
        ax.legend()
    else:
        ax.plot(xs, ys, ".", alpha=0.7)
    fx, fy = pareto_frontier(xs, ys)
    ax.plot(fx, fy, color="gray", alpha=0.6)
    ax.set_xlabel(keyword)
    ax.set_ylabel(keyword2)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
