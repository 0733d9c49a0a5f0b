"""NoC, mIoU@k and timing metrics, and the results table.

Counterpart of ``isegprobe_tpu/inference/metrics.py``.
"""

from __future__ import annotations

import datetime
from typing import List, Sequence, Tuple

import numpy as np


def compute_noc_metric(all_ious: List[np.ndarray], iou_thrs: Sequence[float],
                       max_clicks: int = 20
                       ) -> Tuple[List[float], List[float], List[int]]:
    """Mean number of clicks to reach each IoU threshold (capped at
    ``max_clicks``), its std, and the count of samples that never reach it."""

    def _get_noc(iou_arr, thr):
        vals = iou_arr >= thr
        return np.argmax(vals) + 1 if np.any(vals) else max_clicks

    noc_list, noc_std, over_max = [], [], []
    for thr in iou_thrs:
        scores = np.array([_get_noc(a, thr) for a in all_ious], dtype=np.int64)
        noc_list.append(float(scores.mean()))
        noc_std.append(float(scores.std()))
        over_max.append(int((scores == max_clicks).sum()))
    return noc_list, noc_std, over_max


def get_time_metrics(all_ious: List[np.ndarray],
                     elapsed_time: float) -> Tuple[float, float]:
    """Seconds per click and per object over an evaluation."""
    n_clicks = sum(map(len, all_ious))
    return elapsed_time / n_clicks, elapsed_time / len(all_ious)


def miou_at_k(all_ious: List[np.ndarray], max_clicks: int = 20) -> np.ndarray:
    """Mean IoU after k clicks for k = 1..max_clicks; a sample that stopped
    early keeps its final IoU for later k."""
    table = np.zeros((len(all_ious), max_clicks), dtype=np.float64)
    for i, arr in enumerate(all_ious):
        table[i] = np.concatenate(
            [arr, np.full(max_clicks - len(arr), arr[-1])])
    return table.mean(axis=0)


def get_results_table(noc_list, over_max_list, brs_type: str,
                      dataset_name: str, mean_spc: float,
                      elapsed_time: float, n_clicks: int = 20,
                      model_name: str = "", print_header: bool = True) -> str:
    """The text results table of the JAX package (and its reference):
    NoC@80/85/90, the objects over the click budget at 85 and 90, seconds
    per click and the wall time."""
    table_header = (
        f'|{"BRS Type":^13}|{"Dataset":^11}|'
        f'{"NoC@80%":^9}|{"NoC@85%":^9}|{"NoC@90%":^9}|'
        f'{">=" + str(n_clicks) + "@85%":^9}|'
        f'{">=" + str(n_clicks) + "@90%":^9}|'
        f'{"SPC,s":^7}|{"Time":^9}|')
    row_width = len(table_header)
    header = f"Eval results for model: {model_name}\n" if model_name else ""
    header += "-" * row_width + "\n"
    header += table_header + "\n" + "-" * row_width

    eval_time = str(datetime.timedelta(seconds=int(elapsed_time)))
    row = f"|{brs_type:^13}|{dataset_name:^11}|"
    row += f"{noc_list[0]:^9.2f}|"
    for i in (1, 2):
        row += f"{noc_list[i]:^9.2f}|" if len(noc_list) > i else f'{"?":^9}|'
    for i in (1, 2):
        row += (f"{over_max_list[i]:^9}|" if len(over_max_list) > i
                else f'{"?":^9}|')
    row += f"{mean_spc:^7.3f}|{eval_time:^9}|"
    return (header + "\n" + row) if print_header else row
