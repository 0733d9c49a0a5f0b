"""Evaluate a trained checkpoint of the JAX package with the port, by NoC.

Counterpart of the root ``evaluate.py`` (``load_model_for_eval``,
``get_dataset`` and ``main``: the fixed-crop ZoomIn, the RITM adaptive
ZoomIn and continuous batching, datasets × checkpoint). No JAX is
involved: the checkpoint is read by ``utils/serialization.py``, the frozen
parts it leaves out are rebuilt from ``PRNGKey(0)`` by
``models/init_tree.py``, the datasets are read without OpenCV
(``data/datasets/standard.py``), and the Synthetic scenes come from a
stored file (``data/scenes.py``), since the JAX package draws them with
OpenCV.

Usage (on a CUDA GPU; ``device=cpu`` runs the plain PyTorch path):

    python -m isegprobe_torch.evaluate \\
        checkpoint=assets/trained/synthetic_dinov2_noup_160ep.ckpt \\
        [datasets=GrabCut,Berkeley,DAVIS,SBD,PascalVOC] \\
        [DATASETS.GRABCUT_PATH=/data/grabcut ...] \\
        [scenes=isegprobe_torch/fixtures/synthetic2026_50.npz] \\
        device_loop=true device_batch=8 [dtype=bfloat16] [eval_mode=fixed448]
        [eval_ritm=false] [device_refill=false] [group_max_jobs=0]
        [n_clicks=20] [target_iou=0.9] [print_ious=true] [min_n_clicks=1]
        [thresh=0.5] [clicks_limit=null] [mode=NoBRS] [mxu_pad=auto]
        [fuse_hr_head=false]

``datasets`` is a comma-separated list of the root's ``get_dataset`` keys:
``GrabCut``, ``Berkeley``, ``DAVIS``, ``SBD``, ``SBD_Train``,
``PascalVOC``, ``COCO_MVal`` (each read from its ``DATASETS.*_PATH`` key,
``configs/main_cfg.yaml``'s defaults; the port reads no YAML) and
``Synthetic`` (the stored scenes of ``scenes=``). ``eval_mode`` and
``eval_ritm`` pick each dataset's ZoomIn as the root's
``get_zoomin_params`` does: ``fixed<n>`` (or ``fixed<h>,<w>``) crops to
that size, ``cvpr`` to 448² (672² on DAVIS), and ``eval_ritm=true
eval_mode=cvpr`` runs the RITM adaptive protocol (scalar target 400, 600 on
DAVIS, ``skip_clicks=1``): the host transform chain, or with
``device_loop=true`` the adaptive device loop. ``device_refill=true`` with
``device_batch > 1`` runs the device loop as a job queue (continuous
batching, windows of ``group_max_jobs`` frames, 0 for 32); with
``device_batch <= 1`` it warns and runs lockstep, as the root does.

It prints a results table for each dataset and, with ``print_ious``,
mIoU@k as the root ``evaluate.py`` does, with its rule for the target IoU:
1.01 (every object runs all ``n_clicks``) when ``print_ious`` is on and
``min_n_clicks <= 1``, as with ``configs/eval_cfg.yaml``'s defaults, else
``target_iou`` floored at 0.8 (``print_ious=false`` gives the early-stop
protocol).

``mode`` picks the predictor, as the root's does: ``NoBRS`` (the default),
``f-BRS-A``, ``f-BRS-B``, ``f-BRS-C``, ``RGB-BRS`` or ``DistMap-BRS``
(``inference/brs.py``), with ``thresh`` as the BRS optimizer's
``prob_thresh``. The device loop runs NoBRS only: a BRS mode with
``device_loop=true`` runs the host protocol and says so.

A LoftUp probe is evaluated in its zero-padded layout in bfloat16 and
unpadded in float32, the faster of the two on the H100 in each dtype
(PERF.md): ``mxu_pad`` is accepted for the root's command lines, and a
value other than ``auto`` that names the other layout is ignored with a
warning. ``fuse_hr_head=true`` runs the head inside LoftUp's slab loop, so
that LoftUp's ``[B, H, W, C]`` map never exists whole (a quarter of the
peak memory at 448² on the H100, PERF.md). Both are the same function
(``load_model_for_eval``); other probes ignore them.
"""

from __future__ import annotations

import logging
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
    overlay_upsampler_params,
    pad_loftup_params,
)
from isegprobe_torch.models.featurizers.dino import DINO_TRUNK
from isegprobe_torch.models.featurizers.dinov2 import DINOV2_ARCHS
from isegprobe_torch.models.init_tree import count_params, init_tree
from isegprobe_torch.utils.serialization import (
    build_model,
    load_checkpoint,
    merge_params,
)

__all__ = ["load_model_for_eval", "get_dataset", "parse_args", "evaluate",
           "evaluate_all", "main"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_model_for_eval(checkpoint: str, dtype=torch.float32,
                        target_size: Tuple[int, int] = (448, 448),
                        device=None, eval_ritm: bool = False,
                        frozen: Optional[Dict] = None,
                        mxu_pad: Optional[bool] = None,
                        fuse_hr_head: bool = False
                        ) -> Tuple[torch.nn.Module, Dict]:
    """The checkpoint's probe as the root ``evaluate.py:load_model_for_eval``
    builds it, as a model of the port on ``device`` (CUDA unless ``device=
    "cpu"``) in ``dtype``. Returns (model, info): ``info`` holds the
    config the model was built from (``config``), the frozen parts
    (``frozen``), the seconds they took to rebuild (``init_seconds``) and
    their count of scalars (``frozen_params``). ``frozen`` reuses the
    frozen parts of an earlier load (its ``info["frozen"]``) or any tree
    drawn by ``init_tree(config, 0)`` for the same backbone and upsampler
    config, instead of drawing them again: they are a function of that
    config alone.

    The frozen parts (every top-level subtree the checkpoint leaves out) are
    ``model.init(PRNGKey(0))``'s; the checkpoint's subtrees replace theirs
    whole (a missing leaf fails the load). The upsampler's configured
    weights are overlaid when the file exists (``models.convert.
    load_upsampler_params`` warns when it does not). The DINOv2 and DINO
    pos-embeds are resized once to the eval grid, as
    ``interpolate_backbone_pos_embed`` does, so that the forward's own
    interpolation is a no-op (:func:`_preinterpolate_pos_embed`). In bf16 the
    f32 params are rounded into the bf16 model, as the root ``evaluate.py``
    casts its params. ``eval_ritm`` (the RITM protocol) skips the pos-embed
    resize, as the root's does. The root also forces ``use_rgb_conv`` on
    there; the port builds the checkpoint's own model instead. Where the
    root's build succeeds the two agree (a click embedding that takes the
    RITM transform's 64 channels was trained with it, and its config says
    so); a probe that embeds the raw click maps, as every probe of the paper
    does, the root cannot build with the transform, and the port evaluates
    it as it was trained.

    ``mxu_pad`` (None: on for bfloat16 and off for float32, as the root's
    ``auto``; True or False force it) builds a LoftUp probe in the
    zero-padded layout: its params are padded by ``models.convert.pad_loftup_params``
    after the unpadded init and overlay, so that the init stream is
    unchanged, and the config's upsampler params carry ``mxu_pad=True``.
    ``fuse_hr_head`` runs the head inside LoftUp's slab loop (a build
    override, as the root's; the saved config does not hold it)."""
    device = resolve_device(device)
    params, config, _ = load_checkpoint(checkpoint)
    t0 = time()
    if frozen is None:
        frozen = init_tree(config["params"], skip=params)
    else:
        frozen = {k: v for k, v in frozen.items() if k not in params}
    init_seconds = time() - t0
    params = merge_params(frozen, params)
    params = overlay_upsampler_params(params,
                                      config["params"].get("upsampler_cfg"))
    if mxu_pad is None:
        mxu_pad = dtype == torch.bfloat16
    up_cfg = dict(config["params"].get("upsampler_cfg") or {})
    if up_cfg.get("type") == "loftup" and mxu_pad:
        up_params = dict(up_cfg.get("params") or {})
        params = dict(params, upsampler=pad_loftup_params(
            params["upsampler"], n_dim=int(up_params.get("n_dim", 384)),
            n_freqs=int(up_params.get("n_freqs", 20)),
            heads=int(up_params.get("num_heads", 4)),
            num_layers=int(up_params.get("num_layers", 2))))
        up_params["mxu_pad"] = True
        config = dict(config, params=dict(
            config["params"], upsampler_cfg=dict(up_cfg, params=up_params)))
    if not eval_ritm:
        config, params = _preinterpolate_pos_embed(config, params,
                                                   target_size)
    model = load_jax_params(build_model(config, device, dtype,
                                        fuse_hr_head=fuse_hr_head), params)
    return model, dict(config=config, frozen=frozen,
                       init_seconds=init_seconds,
                       frozen_params=count_params(frozen))


def _preinterpolate_pos_embed(config: Dict, params: Dict,
                              target_size: Tuple[int, int]
                              ) -> Tuple[Dict, Dict]:
    """Resize the backbone pos-embed to the eval grid and set the config's
    ``pretrain_grid`` to it (root ``evaluate.py:
    interpolate_backbone_pos_embed``): DINOv2 at its arch's patch and grid,
    the DINO ``vit`` at the config's patch (16 by default) from its 14²
    grid. MaskCLIP interpolates its table on every forward and SimpleViT
    has none, so those configs come back unchanged."""
    backbone_cfg = dict(config["params"]["backbone_cfg"])
    btype = backbone_cfg["type"].lower()
    bparams = dict(backbone_cfg.get("params") or {})
    if btype == "dinov2":
        arch = DINOV2_ARCHS[bparams.get("arch", "dinov2_vits14")]
        patch, old_grid = arch.patch_size, tuple(arch.pretrain_grid)
    elif btype == "vit":
        patch = bparams.get("patch_size", 16)
        old_grid = tuple(DINO_TRUNK.pretrain_grid)
    else:
        return config, params
    new_grid = (target_size[0] // patch, target_size[1] // patch)
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
    "device_mesh": "ROADMAP Queue 1 item 9 (parallel/mesh.py)",
    "vis_preds": "ROADMAP Queue 1 item 9 (plots and eval_utils)",
    "save_feats": "ROADMAP Queue 1 item 9 (plots and eval_utils)",
    "save_ious": "ROADMAP Queue 1 item 9 (eval_utils)",
    "iou_analysis": "ROADMAP Queue 1 item 9 (eval_utils)",
    "wandb": "ROADMAP Queue 1 item 9 (eval_utils)",
    "profile_dir": "ROADMAP Queue 1 item 2 (the port's bench leg)",
}
# the root get_dataset's keys and the path key each reads
DATASET_PATHS = {
    "GrabCut": "DATASETS.GRABCUT_PATH",
    "Berkeley": "DATASETS.BERKELEY_PATH",
    "DAVIS": "DATASETS.DAVIS_PATH",
    "SBD": "DATASETS.SBD_PATH",
    "SBD_Train": "DATASETS.SBD_PATH",
    "PascalVOC": "DATASETS.PASCALVOC_PATH",
    "COCO_MVal": "DATASETS.COCO_MVAL_PATH",
    "Synthetic": "scenes",
}
# configs/main_cfg.yaml's paths
_PATH_DEFAULTS = {
    "DATASETS.SBD_PATH": "/data/sbd",
    "DATASETS.GRABCUT_PATH": "/data/grabcut",
    "DATASETS.BERKELEY_PATH": "/data/berkeley",
    "DATASETS.DAVIS_PATH": "/data/davis",
    "DATASETS.COCO_MVAL_PATH": "/data/coco_mval",
    "DATASETS.PASCALVOC_PATH": "/data/pascalvoc",
}
_DEFAULTS = dict(checkpoint=None, datasets="Synthetic", **_PATH_DEFAULTS,
                 scenes=str(SYNTHETIC_FIXTURE),
                 eval_mode="fixed448", eval_ritm="false",
                 device_loop="false", device_batch="1",
                 device_refill="false", group_max_jobs="0",
                 dtype="float32", n_clicks="20", target_iou="0.90",
                 print_ious="true", min_n_clicks="1", thresh="0.5",
                 clicks_limit="null", mode="NoBRS", mxu_pad="auto",
                 fuse_hr_head="false", device=None)


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
    cfg["dataset_names"] = [n for n in cfg["datasets"].split(",") if n]
    for name in cfg["dataset_names"]:
        if name not in DATASET_PATHS:
            raise NotImplementedError(
                f"Dataset key: {name} is not found; takes "
                f"{sorted(DATASET_PATHS)}")
    if not cfg["dataset_names"]:
        raise ValueError("datasets= names no dataset")
    from isegprobe_torch.inference.brs import BRS_MODES

    if cfg["mode"] not in BRS_MODES:
        raise ValueError(f"mode={cfg['mode']!r} is not a predictor mode; "
                         f"takes {list(BRS_MODES)}")
    cfg["eval_ritm"] = _flag(cfg["eval_ritm"])
    # the first dataset's ZoomIn; evaluate() computes each dataset's
    cfg["zoomin"] = get_zoomin_params(cfg["eval_ritm"], cfg["eval_mode"],
                                      cfg["dataset_names"][0])
    cfg["target_size"] = _pos_embed_size(cfg["zoomin"])
    if cfg["dtype"] not in DTYPES:
        raise NotImplementedError(
            f"dtype={cfg['dtype']}: the port evaluates in float32 or "
            "bfloat16; int8 W8A8 is ROADMAP Queue 1 item 9 (ops/quant.py)")
    cfg["device_loop"] = _flag(cfg["device_loop"])
    cfg["device_batch"] = int(cfg["device_batch"])
    refill = cfg["device_refill"].lower()
    if refill == "host":
        raise ValueError("device_refill=host was removed (it measured 0.98x "
                         "lockstep in the JAX package); use "
                         "device_refill=true (on-device job queue)")
    if refill not in ("false", "true", "0", "1", "device"):
        raise ValueError(f"device_refill={refill!r} not recognized; use "
                         "false or true/'device' (on-device job queue)")
    cfg["device_refill"] = refill in ("true", "1", "device")
    if cfg["device_refill"] and cfg["device_batch"] <= 1:
        logging.getLogger(__name__).warning(
            "device_refill ignored: continuous batching needs device_batch>1 "
            f"(got {cfg['device_batch']})")
        cfg["device_refill"] = False
    cfg["group_max_jobs"] = int(cfg["group_max_jobs"])
    pad = cfg.pop("mxu_pad").lower()
    if pad != "auto" and _flag(pad) != (cfg["dtype"] == "bfloat16"):
        logging.getLogger(__name__).warning(
            f"mxu_pad={pad} ignored: LoftUp's layout follows dtype (padded "
            "in bfloat16, unpadded in float32), the faster one in each")
    cfg["fuse_hr_head"] = _flag(cfg["fuse_hr_head"])
    cfg["n_clicks"] = int(cfg["n_clicks"])
    cfg["print_ious"] = _flag(cfg["print_ious"])
    cfg["min_n_clicks"] = int(cfg["min_n_clicks"])
    cfg["thresh"] = float(cfg["thresh"])
    limit = cfg["clicks_limit"]
    cfg["clicks_limit"] = (None if limit.lower() in ("null", "none", "")
                           else int(limit))
    # the root evaluate.py's rule: every click when the IoUs are printed
    # (iou_analysis, the rule's other key, raises above), else the target
    # floored at 0.8
    if cfg["print_ious"] and cfg["min_n_clicks"] <= 1:
        cfg["target_iou"] = 1.01
    else:
        cfg["target_iou"] = max(0.8, float(cfg["target_iou"]))
    return cfg


def _pos_embed_size(zoomin: Dict) -> Tuple[int, int]:
    """The size the pos-embed is resized to (the root's ``_ts``)."""
    size = zoomin["target_size"]
    return (size, size) if isinstance(size, int) else tuple(size)


def get_dataset(name: str, cfg: Dict):
    """The root ``evaluate.py:get_dataset``: ``name``'s dataset, read from
    its path key of ``cfg``."""
    from isegprobe_torch.data.datasets import (
        BerkeleyDataset,
        DavisDataset,
        GrabCutDataset,
        PascalVocDataset,
        SBDEvaluationDataset,
    )

    path = cfg[DATASET_PATHS[name]]
    if name == "GrabCut":
        return GrabCutDataset(path)
    if name == "Berkeley":
        return BerkeleyDataset(path)
    if name in ("DAVIS", "COCO_MVal"):
        return DavisDataset(path)
    if name == "SBD":
        return SBDEvaluationDataset(path)
    if name == "SBD_Train":
        return SBDEvaluationDataset(path, split="train")
    if name == "PascalVOC":
        return PascalVocDataset(path, split="test")
    if name == "Synthetic":
        return SceneDataset(path)
    raise NotImplementedError(f"Dataset key: {name} is not found.")


def _flag(value: str) -> bool:
    return value.lower() in ("true", "1")


def _parse_fixed_mode(eval_mode: str) -> Tuple[int, int]:
    """'fixed<n>' or 'fixed<h>,<w>' -> (h, w)."""
    crop = eval_mode[5:].split(",")
    return int(crop[0]), int(crop[-1])


def get_zoomin_params(eval_ritm: bool, eval_mode: str,
                      dataset_name: str) -> Dict:
    """The ZoomIn of a run (the root ``evaluate.py:get_zoomin_params``):
    ``skip_clicks`` and ``target_size``, a pair for the fixed crop and a
    scalar for the RITM adaptive one."""
    if eval_ritm:
        if eval_mode == "cvpr":
            return {"skip_clicks": 1,
                    "target_size": 600 if dataset_name == "DAVIS" else 400}
        if eval_mode.startswith("fixed"):
            return {"skip_clicks": -1,
                    "target_size": _parse_fixed_mode(eval_mode)}
        raise NotImplementedError(f"Unknown eval_mode: {eval_mode}")
    if eval_mode == "cvpr":
        return {"skip_clicks": -1, "target_size": (672, 672)
                if dataset_name == "DAVIS" else (448, 448)}
    if eval_mode.startswith("fixed"):
        return {"skip_clicks": -1,
                "target_size": _parse_fixed_mode(eval_mode)}
    raise NotImplementedError(f"Unknown eval_mode: {eval_mode}")


def evaluate(cfg: Dict, model: Optional[torch.nn.Module] = None,
             dataset_name: Optional[str] = None,
             clicks: Optional[list] = None, dataset=None) -> Dict:
    """Run one checkpoint over one dataset (by default the first of
    ``datasets=``) with the settings of :func:`parse_args` and that
    dataset's ZoomIn. ``model`` must have been loaded for that ZoomIn's
    size (:func:`evaluate_all` does so); by default it is loaded here.
    Returns the dataset's name, the per-object IoUs, the NoC, mIoU@k, the
    wall seconds, the results table, the protocol that ran (``"host"`` or
    ``"device_loop"``), a note where a BRS mode asked for the device loop
    ran the host protocol, and, for a job queue, its stats.
    ``clicks=[]`` collects each object's clicks, (y, x, is_positive)
    rows (the fixed-crop protocols; the adaptive loop records none).
    ``dataset`` runs those samples (a subset) in place of the named
    dataset's."""
    from isegprobe_torch.inference.adaptive_eval import make_adaptive_evaluator
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_device,
        evaluate_dataset_group,
        make_device_evaluator,
    )
    from isegprobe_torch.inference.evaluation import (
        evaluate_dataset,
        latency_percentiles,
    )
    from isegprobe_torch.inference.brs import get_predictor

    device = resolve_device(cfg["device"])
    name = dataset_name or cfg["dataset_names"][0]
    zoom = get_zoomin_params(cfg["eval_ritm"], cfg["eval_mode"], name)
    if model is None:
        model, _ = load_model_for_eval(cfg["checkpoint"],
                                       DTYPES[cfg["dtype"]],
                                       _pos_embed_size(zoom), device,
                                       eval_ritm=cfg["eval_ritm"],
                                       fuse_hr_head=cfg["fuse_hr_head"])
    if dataset is None:
        dataset = get_dataset(name, cfg)
    protocol = dict(pred_thr=cfg["thresh"], min_clicks=cfg["min_n_clicks"],
                    max_clicks=cfg["n_clicks"])
    net_clicks_limit = cfg["clicks_limit"] or cfg["n_clicks"]
    latencies: list = []
    stats: Optional[dict] = None
    note = None
    use_device_loop = cfg["device_loop"] and cfg["mode"] == "NoBRS"
    if cfg["device_loop"] and not use_device_loop:
        note = (f"mode={cfg['mode']}: the device loop runs NoBRS only; "
                "running the host protocol")
        logging.getLogger(__name__).info(note)
    t0 = time()
    if use_device_loop:
        kw = dict(batch_size=cfg["device_batch"],
                  net_clicks_limit=net_clicks_limit,
                  target_iou=cfg["target_iou"], with_flip=True,
                  device=device, **protocol)
        refill = cfg["device_refill"]
        if zoom["skip_clicks"] >= 0 and isinstance(zoom["target_size"], int):
            # the RITM adaptive ZoomIn, scalar target
            if clicks is not None:
                raise ValueError("the adaptive device loop records no clicks")
            run = make_adaptive_evaluator(model, zoom["target_size"],
                                          skip_clicks=zoom["skip_clicks"],
                                          group_api=refill, **kw)
        else:
            run = make_device_evaluator(model,
                                        target_size=zoom["target_size"],
                                        group_api=refill,
                                        record_clicks=clicks is not None,
                                        **kw)
        if refill:
            stats = {}
            all_ious = evaluate_dataset_group(
                run, dataset, stats=stats,
                max_jobs_per_dispatch=cfg["group_max_jobs"], clicks=clicks)
        else:
            all_ious = evaluate_dataset_device(run, dataset, clicks=clicks)
    else:
        predictor = get_predictor(
            model, brs_mode=cfg["mode"], prob_thresh=cfg["thresh"],
            with_flip=True, zoom_in_params=zoom,
            predictor_params={"net_clicks_limit": net_clicks_limit},
            device=device)
        all_ious, _ = evaluate_dataset(dataset, predictor,
                                       latencies=latencies, clicks=clicks,
                                       max_iou_thr=cfg["target_iou"],
                                       **protocol)
    elapsed = time() - t0
    noc, _, over_max = compute_noc_metric(all_ious, [0.8, 0.85, 0.9],
                                          cfg["n_clicks"])
    spc, _ = get_time_metrics(all_ious, elapsed)
    model_name = str(cfg["checkpoint"]).rsplit("/", 1)[-1].removesuffix(
        ".ckpt")
    table = get_results_table(noc, over_max, cfg["mode"], name, spc,
                              elapsed, n_clicks=cfg["n_clicks"],
                              model_name=model_name)
    return dict(dataset=name, all_ious=all_ious, noc=noc, over_max=over_max,
                miou=miou_at_k(all_ious, cfg["n_clicks"]), elapsed=elapsed,
                table=table, latency=(latency_percentiles(latencies)
                                      if latencies else None),
                protocol="device_loop" if use_device_loop else "host",
                note=note, group_stats=stats)


def evaluate_all(cfg: Dict) -> list:
    """Every dataset of ``datasets=`` in turn, as the root's loop over
    datasets × checkpoint: the checkpoint is loaded for each dataset's
    ZoomIn size (once a size, the frozen parts drawn once). Returns
    :func:`evaluate`'s results in order."""
    device = resolve_device(cfg["device"])
    models: Dict = {}
    frozen = None
    results = []
    for name in cfg["dataset_names"]:
        zoom = get_zoomin_params(cfg["eval_ritm"], cfg["eval_mode"], name)
        size = _pos_embed_size(zoom)
        if size not in models:
            models.clear()  # one model resident at a time
            models[size], info = load_model_for_eval(
                cfg["checkpoint"], DTYPES[cfg["dtype"]], size, device,
                eval_ritm=cfg["eval_ritm"], frozen=frozen,
                fuse_hr_head=cfg["fuse_hr_head"])
            frozen = info["frozen"]
        results.append(evaluate(cfg, models[size], name))
    return results


def main(argv=None) -> int:
    cfg = parse_args(sys.argv[1:] if argv is None else argv)
    for out in evaluate_all(cfg):
        if out["note"]:
            print(out["note"])
        print(out["table"])
        if cfg["print_ious"]:
            print("mIoU@k:", " ".join(f"{v:.3f}" for v in out["miou"]))
        if out["latency"]:
            print("per-click latency:", out["latency"])
        if out["group_stats"]:
            print("group-eval stats:", out["group_stats"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
