"""Evaluate a trained checkpoint of the JAX package with the port, by NoC.

Counterpart of the root ``evaluate.py`` (``load_model_for_eval`` and, in
``main``, the ``Synthetic`` dataset with the fixed-crop ZoomIn). No JAX is
involved: the checkpoint is read by ``utils/serialization.py``, the frozen
parts it leaves out are rebuilt from ``PRNGKey(0)`` by
``models/init_tree.py``, and the scenes come from a stored file
(``data/scenes.py``), since the JAX package draws them with OpenCV.

Usage (on a CUDA GPU; ``device=cpu`` runs the plain PyTorch path):

    python -m isegprobe_torch.evaluate \\
        checkpoint=assets/trained/synthetic_dinov2_noup_160ep.ckpt \\
        scenes=isegprobe_torch/fixtures/synthetic2026_50.npz \\
        device_loop=true device_batch=8 [dtype=bfloat16] [eval_mode=fixed448]
        [n_clicks=20] [target_iou=0.9]

It prints the results table and mIoU@k as the root ``evaluate.py`` does.
"""

from __future__ import annotations

import sys
from time import time
from typing import Dict, Optional, Tuple

import torch

from isegprobe_torch import resolve_device
from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
from isegprobe_torch.inference.metrics import (
    compute_noc_metric,
    get_results_table,
    get_time_metrics,
    miou_at_k,
)
from isegprobe_torch.models.convert import (
    interpolate_pos_embed_params,
    load_jax_params,
    load_upsampler_params,
)
from isegprobe_torch.models.featurizers.dinov2 import DINOV2_ARCHS
from isegprobe_torch.models.init_tree import count_params, init_tree
from isegprobe_torch.utils.serialization import (
    build_model,
    load_checkpoint,
    merge_params,
)

__all__ = ["load_model_for_eval", "main"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_model_for_eval(checkpoint: str, dtype=torch.float32,
                        target_size: Tuple[int, int] = (448, 448),
                        device=None) -> Tuple[torch.nn.Module, Dict]:
    """The checkpoint's probe as the root ``evaluate.py:load_model_for_eval``
    builds it, as a model of the port on ``device`` (CUDA unless ``device=
    "cpu"``) in ``dtype``. Returns (model, info): ``info`` holds the
    config the model was built from (``config``), the seconds the frozen
    parts took to rebuild (``init_seconds``) and their count of scalars
    (``frozen_params``).

    The frozen parts (every top-level subtree the checkpoint leaves out) are
    ``model.init(PRNGKey(0))``'s; the checkpoint's subtrees replace theirs
    whole (a missing leaf fails the load). The upsampler's configured
    weights are overlaid when the file exists (``models.convert.
    load_upsampler_params`` warns when it does not). The DINOv2 pos-embed is
    resized once to the eval grid, as ``interpolate_backbone_pos_embed``
    does, so that the forward's own interpolation is a no-op. In bf16 the
    f32 params are rounded into the bf16 model, as the root ``evaluate.py``
    casts its params. LoftUp's
    padded ``mxu_pad`` layout, which that script uses for bf16, is the same
    function with zero-padded channels and is not ported."""
    device = resolve_device(device)
    params, config, _ = load_checkpoint(checkpoint)
    t0 = time()
    frozen = init_tree(config["params"], skip=params)
    init_seconds = time() - t0
    params = merge_params(frozen, params)
    up_loaded = load_upsampler_params(config["params"].get("upsampler_cfg"))
    if up_loaded is not None:
        params = dict(params, upsampler=merge_params(params["upsampler"],
                                                     up_loaded))
    config, params = _preinterpolate_pos_embed(config, params, target_size)
    model = load_jax_params(build_model(config, device, dtype), params)
    return model, dict(config=config, init_seconds=init_seconds,
                       frozen_params=count_params(frozen))


def _preinterpolate_pos_embed(config: Dict, params: Dict,
                              target_size: Tuple[int, int]
                              ) -> Tuple[Dict, Dict]:
    """Resize the backbone pos-embed to the eval grid and set the config's
    ``pretrain_grid`` to it (root ``evaluate.py:
    interpolate_backbone_pos_embed``, DINOv2 backbones)."""
    backbone_cfg = dict(config["params"]["backbone_cfg"])
    bparams = dict(backbone_cfg.get("params") or {})
    arch = DINOV2_ARCHS[bparams.get("arch", "dinov2_vits14")]
    old_grid = tuple(arch.pretrain_grid)
    new_grid = (target_size[0] // arch.patch_size,
                target_size[1] // arch.patch_size)
    if new_grid == old_grid:
        return config, params
    vit = dict(params["backbone"]["model"])
    vit["pos_embed"] = interpolate_pos_embed_params(vit["pos_embed"],
                                                    old_grid, new_grid)
    params = dict(params, backbone=dict(params["backbone"], model=vit))
    bparams["pretrain_grid"] = new_grid
    backbone_cfg["params"] = bparams
    config = dict(config, params=dict(config["params"],
                                      backbone_cfg=backbone_cfg))
    return config, params


# -- command line -------------------------------------------------------------

# keys of the root evaluate.py that the port does not take yet, and the
# ROADMAP item that brings each
_NOT_PORTED = {
    "datasets": "ROADMAP Queue 1 item 6 (the data layer: the other "
                "datasets' loaders)",
    "mode": "ROADMAP Queue 1 item 9 (BRS)",
    "eval_ritm": "ROADMAP Queue 1 item 8 (adaptive RITM protocol)",
    "device_refill": "ROADMAP Queue 1 item 5 (continuous batching)",
    "group_max_jobs": "ROADMAP Queue 1 item 5 (continuous batching)",
    "device_mesh": "ROADMAP Queue 1 item 9 (parallel/mesh.py)",
    "mxu_pad": "ROADMAP Queue 1 item 7 (LoftUp's mxu_pad layout)",
    "fuse_hr_head": "ROADMAP Queue 1 item 7 (the fused LoftUp head)",
    "vis_preds": "ROADMAP Queue 1 item 9 (plots and eval_utils)",
    "save_feats": "ROADMAP Queue 1 item 9 (plots and eval_utils)",
    "save_ious": "ROADMAP Queue 1 item 9 (eval_utils)",
    "iou_analysis": "ROADMAP Queue 1 item 9 (eval_utils)",
    "wandb": "ROADMAP Queue 1 item 9 (eval_utils)",
    "profile_dir": "ROADMAP Queue 1 item 2 (the port's bench leg)",
}
_DEFAULTS = dict(checkpoint=None, scenes=str(SYNTHETIC_FIXTURE),
                 eval_mode="fixed448", device_loop="false", device_batch="1",
                 dtype="float32", n_clicks="20", target_iou="0.90",
                 device=None)


def parse_args(argv) -> Dict:
    """``key=value`` overrides into the run's settings; a key of the root
    ``evaluate.py`` that is not ported raises ``NotImplementedError``
    naming its ROADMAP item, any other unknown key ``ValueError``."""
    cfg = dict(_DEFAULTS)
    for arg in argv:
        key, sep, value = arg.partition("=")
        if not sep:
            raise ValueError(f"expected key=value, got {arg!r}")
        if key in _NOT_PORTED:
            raise NotImplementedError(
                f"{key}= is not ported to isegprobe_torch.evaluate yet: "
                f"{_NOT_PORTED[key]}")
        if key not in cfg:
            raise ValueError(f"unknown key {key!r}; takes "
                             f"{sorted(_DEFAULTS)}")
        cfg[key] = value
    if not cfg["checkpoint"]:
        raise ValueError("checkpoint=<path to a .ckpt> is required")
    mode = cfg["eval_mode"]
    if not mode.startswith("fixed"):
        raise NotImplementedError(
            f"eval_mode={mode}: only the fixed-crop ZoomIn is ported; the "
            "adaptive 'cvpr' mode is ROADMAP Queue 1 item 8")
    crop = mode[5:].split(",")
    cfg["target_size"] = (int(crop[0]), int(crop[-1]))
    if cfg["dtype"] not in DTYPES:
        raise NotImplementedError(
            f"dtype={cfg['dtype']}: the port evaluates in float32 or "
            "bfloat16; int8 W8A8 is ROADMAP Queue 1 item 9 (ops/quant.py)")
    cfg["device_loop"] = cfg["device_loop"].lower() in ("true", "1")
    cfg["device_batch"] = int(cfg["device_batch"])
    cfg["n_clicks"] = int(cfg["n_clicks"])
    # the root evaluate.py's floor on the target IoU
    cfg["target_iou"] = max(0.8, float(cfg["target_iou"]))
    return cfg


def evaluate(cfg: Dict, model: Optional[torch.nn.Module] = None) -> Dict:
    """Run one checkpoint over the scenes with the settings of
    :func:`parse_args`. Returns the per-object IoUs, the NoC, mIoU@k, the
    wall seconds and the results table."""
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_device,
        make_device_evaluator,
    )
    from isegprobe_torch.inference.evaluation import (
        evaluate_dataset,
        latency_percentiles,
    )
    from isegprobe_torch.inference.predictor import Predictor

    device = resolve_device(cfg["device"])
    if model is None:
        model, _ = load_model_for_eval(cfg["checkpoint"],
                                       DTYPES[cfg["dtype"]],
                                       cfg["target_size"], device)
    dataset = SceneDataset(cfg["scenes"])
    protocol = dict(pred_thr=0.5, min_clicks=1, max_clicks=cfg["n_clicks"])
    latencies: list = []
    t0 = time()
    if cfg["device_loop"]:
        run = make_device_evaluator(
            model, target_size=cfg["target_size"],
            net_clicks_limit=cfg["n_clicks"], target_iou=cfg["target_iou"],
            with_flip=True, batch_size=cfg["device_batch"], device=device,
            **protocol)
        all_ious = evaluate_dataset_device(run, dataset)
    else:
        predictor = Predictor(model, target_size=cfg["target_size"],
                              skip_clicks=-1, with_flip=True,
                              net_clicks_limit=cfg["n_clicks"],
                              device=device)
        all_ious, _ = evaluate_dataset(dataset, predictor,
                                       latencies=latencies,
                                       max_iou_thr=cfg["target_iou"],
                                       **protocol)
    elapsed = time() - t0
    noc, _, over_max = compute_noc_metric(all_ious, [0.8, 0.85, 0.9],
                                          cfg["n_clicks"])
    spc, _ = get_time_metrics(all_ious, elapsed)
    name = str(cfg["checkpoint"]).rsplit("/", 1)[-1].removesuffix(".ckpt")
    table = get_results_table(noc, over_max, "NoBRS", "Synthetic", spc,
                              elapsed, n_clicks=cfg["n_clicks"],
                              model_name=name)
    return dict(all_ious=all_ious, noc=noc, over_max=over_max,
                miou=miou_at_k(all_ious, cfg["n_clicks"]), elapsed=elapsed,
                table=table, latency=(latency_percentiles(latencies)
                                      if latencies else None))


def main(argv=None) -> int:
    out = evaluate(parse_args(sys.argv[1:] if argv is None else argv))
    print(out["table"])
    print("mIoU@k:", " ".join(f"{v:.3f}" for v in out["miou"]))
    if out["latency"]:
        print("per-click latency:", out["latency"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
