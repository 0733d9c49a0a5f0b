"""What an evaluation leaves behind: prediction and feature dumps, the IoU
pickles, checkpoint discovery and the optional wandb summary.

Counterpart of ``isegprobe_tpu/inference/eval_utils.py``, with the same
file names and contents. The JAX callbacks write with ``cv2.imwrite``;
these write the same JPEG files through ``data/image_io.encode_jpeg`` and
draw through ``utils/viz.py``. Features go to ``.npy`` as float32 (the JAX
package, in bf16, writes ml_dtypes' bfloat16, which numpy alone cannot
read).
"""

from __future__ import annotations

import json
import pickle
from datetime import datetime
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np

from isegprobe_torch.data.image_io import write_jpeg
from isegprobe_torch.inference.evaluation import get_iou
from isegprobe_torch.utils.viz import draw_points, draw_with_blend_and_clicks

__all__ = ["get_prediction_vis_callback", "get_save_feats_callback",
           "save_iou_analysis_data", "find_checkpoint",
           "get_checkpoints_list", "log_eval_to_wandb"]


def get_prediction_vis_callback(logs_path, dataset_name: str,
                                prob_thresh: float) -> Callable:
    """A callback of ``evaluate_sample`` that writes each click's
    prediction (the darkened image, the mask's contour, the clicks) to
    ``<logs_path>/predictions_vis/<dataset>/<tag>_<click>.jpg``, its IoU
    × 100 to ``iou/<tag>_<click>.json`` and the GT mask to
    ``<tag>_gt.jpg`` at the first click. ``tag`` is the sample id, with
    ``_obj<n>`` for the n-th further object of a sample (the evaluation
    passes the image's index for each of its objects)."""
    logs_path = Path(logs_path)
    save_path = logs_path / "predictions_vis" / dataset_name
    iou_save_path = save_path / "iou"
    save_path.mkdir(parents=True, exist_ok=True)
    iou_save_path.mkdir(parents=True, exist_ok=True)
    obj_counts: Dict = {}

    def callback(image, gt_mask, pred_probs, sample_id, click_indx,
                 clicks_list):
        if click_indx == 0:
            obj_counts[sample_id] = obj_counts.get(sample_id, -1) + 1
        n = obj_counts.get(sample_id, 0)
        tag = f"{sample_id}" if n == 0 else f"{sample_id}_obj{n}"
        pred_mask = pred_probs > prob_thresh
        image_with_mask = draw_with_blend_and_clicks(
            image, pred_mask, alpha=0.5, clicks_list=clicks_list)
        iou = get_iou(gt_mask, pred_mask) * 100
        with open(iou_save_path / f"{tag}_{click_indx}.json", "w") as f:
            json.dump({"iou": float(iou)}, f)
        write_jpeg(save_path / f"{tag}_{click_indx}.jpg", image_with_mask)
        if click_indx == 0:
            write_jpeg(save_path / f"{tag}_gt.jpg",
                       gt_mask.astype(np.uint8) * 255)

    return callback


def get_save_feats_callback(logs_path, dataset_name: str,
                            save_folder_name: str,
                            exec_for_n_imgs: int = 10) -> Callable:
    """A ``feats_callback`` of ``evaluate_sample`` that writes the first
    click's maps of the first ``exec_for_n_imgs`` samples to
    ``<logs_path>/feats/<dataset>/<folder>_<date>/<id>_0_<name>.npy``
    (float32) and the image with its clicks (radius 6) to
    ``images/<id>_0_image.jpg``."""
    logs_path = Path(logs_path)
    current_time = datetime.now().strftime("%Y-%m-%d_%H:%M")
    save_path = (logs_path / "feats" / dataset_name /
                 f"{save_folder_name}_{current_time}")
    save_imgs_path = save_path / "images"
    save_path.mkdir(parents=True, exist_ok=True)
    save_imgs_path.mkdir(parents=True, exist_ok=True)

    def callback(image, feats, sample_id, click_indx, clicks_list):
        if sample_id >= exec_for_n_imgs or click_indx >= 1:
            return
        for k, v in feats.items():
            if hasattr(v, "detach"):
                v = v.detach().float().cpu().numpy()
            np.save(str(save_path / f"{sample_id}_{click_indx}_{k}.npy"),
                    np.asarray(v, np.float32))
        if isinstance(image, dict):
            image = image["image"]
        image = np.ascontiguousarray(image[:, :, ::-1])  # BGR, as cv2 draws
        if clicks_list:
            pos = [c.coords for c in clicks_list if c.is_positive]
            neg = [c.coords for c in clicks_list if not c.is_positive]
            image = draw_points(image, pos, color=(0, 255, 0), radius=6)
            image = draw_points(image, neg, color=(255, 0, 0), radius=6)
        write_jpeg(save_imgs_path / f"{sample_id}_{click_indx}_image.jpg",
                   image[:, :, ::-1])

    return callback


def save_iou_analysis_data(logs_path, dataset_name: str, model_name: str,
                           all_ious: List[np.ndarray], n_clicks: int = 20,
                           mode: str = "NoBRS") -> Path:
    """The per-object IoU trajectories, pickled to
    ``<logs_path>/<dataset>_<mode>_<n_clicks>_<model>.pickle``; returns
    its path."""
    logs_path = Path(logs_path)
    logs_path.mkdir(parents=True, exist_ok=True)
    name_prefix = f"{dataset_name}_{mode}_{n_clicks}"
    path = logs_path / f"{name_prefix}_{model_name}.pickle"
    with open(path, "wb") as f:
        pickle.dump({"dataset_name": dataset_name,
                     "model_name": f"{model_name}_{mode}",
                     "all_ious": all_ious}, f)
    return path


def find_checkpoint(weights_folder, checkpoint_name: str) -> str:
    """A checkpoint by name: ``<model prefix>:<name>`` looks in the one
    folder of ``weights_folder`` that the prefix names; a name ending in
    ``.ckpt`` or ``.pth`` is taken as it is when it exists, else under the
    folder; any other is the one ``<name>*.ckpt`` or ``<name>*.pth`` below
    it."""
    weights_folder = Path(weights_folder)
    if ":" in checkpoint_name:
        model_name, checkpoint_name = checkpoint_name.split(":")
        models_candidates = [
            x for x in weights_folder.glob(f"{model_name}*") if x.is_dir()]
        assert len(models_candidates) == 1
        weights_folder = models_candidates[0]
    if checkpoint_name.endswith(".ckpt") or checkpoint_name.endswith(".pth"):
        if Path(checkpoint_name).exists():
            return checkpoint_name
        checkpoint_path = weights_folder / checkpoint_name
    else:
        candidates = (list(weights_folder.rglob(f"{checkpoint_name}*.ckpt"))
                      + list(weights_folder.rglob(f"{checkpoint_name}*.pth")))
        assert len(candidates) == 1, (
            f"ambiguous or missing checkpoint '{checkpoint_name}' "
            f"under {weights_folder}: {candidates}")
        checkpoint_path = candidates[0]
    return str(checkpoint_path)


def get_checkpoints_list(eval_cfg: Dict, exps_path) -> List[str]:
    """The checkpoints an evaluation runs: with ``exp_path`` (a run
    directory's path under ``exps_path``, or its unique prefix, and
    ``:<prefix>`` to pick checkpoints by name) every matching ``.ckpt`` of
    its ``checkpoints/`` in name order, else ``[checkpoint]``."""
    exps_path = Path(exps_path)
    if eval_cfg.get("exp_path"):
        rel_exp_path = eval_cfg["exp_path"]
        prefix = ""
        if ":" in rel_exp_path:
            rel_exp_path, prefix = rel_exp_path.split(":")
        exp_path_prefix = exps_path / rel_exp_path
        candidates = sorted(exp_path_prefix.parent.glob(
            exp_path_prefix.name + "*"))
        assert len(candidates) == 1, "Invalid experiment path."
        exp_path = candidates[0]
        checkpoints = sorted((exp_path / "checkpoints").glob(
            f"{prefix}*.ckpt"))
        assert checkpoints, f"No checkpoints under {exp_path}"
        return [str(c) for c in checkpoints]
    return [eval_cfg["checkpoint"]]


def log_eval_to_wandb(eval_cfg: Dict, dataset_name: str, model_name: str,
                      noc: List[float], over_max: List[int],
                      miou: List[float], spc: float, elapsed: float) -> bool:
    """One dataset × checkpoint result to Weights & Biases, as the JAX
    package logs it: the summary (NoC@80/85/90, the objects over the click
    budget, IoU@1, SPC, seconds), then the mIoU-vs-clicks and
    NoC-vs-IoU line plots. Nothing (False) unless ``wandb`` is on and the
    package can be imported."""
    if not eval_cfg.get("wandb", False):
        return False
    try:
        import wandb
    except ImportError:
        return False
    run_name = (eval_cfg.get("wandb_name")
                or f"{model_name}__{dataset_name}__{eval_cfg['mode']}")
    wandb.init(
        project=eval_cfg.get("wandb_project") or "iSegProbe-Eval",
        name=run_name,
        config={**{k: v for k, v in eval_cfg.items()
                   if isinstance(v, (int, float, bool, str, type(None)))},
                "dataset": dataset_name, "model": model_name},
        dir=eval_cfg.get("wandb_dir") or None)
    summary = {"dataset": dataset_name, "model": model_name,
               "SPC": spc, "time_s": elapsed}
    for thr, value, over in zip((80, 85, 90), noc, over_max):
        summary[f"NoC@{thr}%"] = value
        summary[f">={eval_cfg['n_clicks']}@{thr}%"] = over
    if miou:
        summary["IoU@1"] = miou[0]
    wandb.log(summary)

    miou_table = wandb.Table(columns=["k (Clicks)", "mIoU@k"])
    for k, v in enumerate(miou, start=1):
        miou_table.add_data(int(k), float(v))
    wandb.log({"mIoU_vs_Clicks": wandb.plot.line(
        miou_table, "k (Clicks)", "mIoU@k", title="mIoU Given k Clicks")})

    noc_table = wandb.Table(columns=["X (IoU, %)", "NoC@X"])
    for thr, value in zip((80, 85, 90), noc):
        noc_table.add_data(int(thr), float(value))
    wandb.log({"NoC_vs_IoU": wandb.plot.line(
        noc_table, "X (IoU, %)", "NoC@X",
        title="Number of Clicks to Reach X% IoU")})
    wandb.finish()
    return True
