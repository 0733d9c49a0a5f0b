"""mIoU against clicks from the evaluation's IoU pickles.

Counterpart of ``isegprobe_tpu/plots/plot_iou_vs_clicks.py``, with its
flags and its output, ``iou_vs_clicks_<date>.png``. A trajectory shorter
than the longest keeps its last IoU.

Usage (on the CPU):
    python -m isegprobe_torch.plots.plot_iou_vs_clicks \\
        --pickle_paths a.pickle,b.pickle --legend_names A,B \\
        --output_folder out/ [--title T]
"""

from __future__ import annotations

import argparse
import pickle
from datetime import datetime
from pathlib import Path
from typing import List

import numpy as np

__all__ = ["MARKERS", "miou_curve", "plot_iou_vs_clicks"]

MARKERS = ["o", "s", "^", "D", "v", "P", "*", "X"]


def miou_curve(all_ious) -> np.ndarray:
    """mIoU at 1..max clicks, each trajectory padded with its last IoU."""
    max_clicks = max(len(a) for a in all_ious)
    table = np.stack([
        np.concatenate([a, np.full(max_clicks - len(a), a[-1])])
        for a in all_ious])
    return table.mean(axis=0)


def plot_iou_vs_clicks(pickle_paths: List[str], legend_names: List[str],
                       output_folder: str, title: str = "") -> Path:
    """One mIoU curve a pickle, saved to ``<output_folder>/
    iou_vs_clicks_<date>.png`` at 150 dpi; returns the file's path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if len(pickle_paths) != len(legend_names):
        raise ValueError("Number of paths must match number of legend names")
    out_dir = Path(output_folder)
    out_dir.mkdir(parents=True, exist_ok=True)

    fig, ax = plt.subplots(figsize=(7, 5))
    for i, (path, name) in enumerate(zip(pickle_paths, legend_names)):
        with open(path, "rb") as f:
            data = pickle.load(f)
        miou = miou_curve(data["all_ious"])
        ax.plot(np.arange(1, len(miou) + 1), miou, label=name,
                marker=MARKERS[i % len(MARKERS)], markersize=4)
    ax.set_xlabel("Number of clicks")
    ax.set_ylabel("mIoU")
    ax.grid(alpha=0.3)
    ax.legend()
    if title:
        ax.set_title(title)
    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M")
    out = out_dir / f"iou_vs_clicks_{stamp}.png"
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"Saved: {out}")
    return out


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser()
    parser.add_argument("--pickle_paths", required=True)
    parser.add_argument("--legend_names", required=True)
    parser.add_argument("--output_folder", default="./plots")
    parser.add_argument("--title", default="")
    args = parser.parse_args(argv)
    return plot_iou_vs_clicks(args.pickle_paths.split(","),
                              args.legend_names.split(","),
                              args.output_folder, args.title)


if __name__ == "__main__":
    main()
