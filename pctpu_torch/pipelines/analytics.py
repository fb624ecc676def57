"""Extracted-dataset analytics: the plots that drive preprocessing choices.

Re-design of `Final_Project/scripts/1_generating-training-set.py:60-158`
(C41): class-distribution pie chart and measurement-count-vs-distance
curves — the evidence behind the reference's ROI <= 25 m and
resample-to-64-points decisions (`Final_Project/README.md:54-64`). Headless
matplotlib PNGs + returned summary dicts.

The port's numpy copy of `pctpu/pipelines/analytics.py`
(matplotlib is imported inside `plot_analytics`).
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import numpy as np


def load_metadata(extracted_dir: str) -> Dict[str, list]:
    """Read the per-class metadata CSVs written by pipelines.kitti_etl."""
    out = {}
    for fn in os.listdir(extracted_dir):
        if not fn.endswith(".csv"):
            continue
        category = os.path.splitext(fn)[0]
        with open(os.path.join(extracted_dir, fn)) as f:
            out[category] = list(csv.DictReader(f))
    return out


def class_distribution(metadata: Dict[str, list]) -> Dict[str, int]:
    return {c: len(rows) for c, rows in metadata.items()}


def distance_stats(metadata: Dict[str, list], bin_width: float = 2.5
                   ) -> Dict[str, dict]:
    """Per class: distance (sqrt(vx^2+vy^2)) bins vs median measurement
    count — the reference's lineplot data."""
    out = {}
    for category, rows in metadata.items():
        if not rows:
            continue
        d = np.array([np.hypot(float(r["vx"]), float(r["vy"]))
                      for r in rows])
        n = np.array([int(r["num_measurements"]) for r in rows])
        bins = np.floor(d / bin_width).astype(int)
        centers, medians, counts = [], [], []
        for b in np.unique(bins):
            sel = bins == b
            centers.append((b + 0.5) * bin_width)
            medians.append(float(np.median(n[sel])))
            counts.append(int(sel.sum()))
        out[category] = {"distance": centers, "median_points": medians,
                         "count": counts}
    return out


def plot_analytics(extracted_dir: str, output_dir: str,
                   roi_line: Optional[float] = 25.0) -> Dict:
    """Write class_distribution.png + points_vs_distance.png."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    metadata = load_metadata(extracted_dir)
    dist = class_distribution(metadata)
    stats = distance_stats(metadata)

    fig, ax = plt.subplots(figsize=(5, 5))
    ax.pie(list(dist.values()), labels=list(dist.keys()),
           autopct="%1.1f%%")
    ax.set_title("class distribution")
    fig.savefig(os.path.join(output_dir, "class_distribution.png"), dpi=120)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(7, 4))
    for category, s in stats.items():
        ax.plot(s["distance"], s["median_points"], label=category)
    if roi_line:
        ax.axvline(roi_line, color="k", linestyle="--",
                   label=f"ROI {roi_line} m")
    ax.set_xlabel("distance to sensor [m]")
    ax.set_ylabel("median measurements per object")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, "points_vs_distance.png"), dpi=120)
    plt.close(fig)
    return {"class_distribution": dist, "distance_stats": stats}
