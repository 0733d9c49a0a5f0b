"""The slice end to end: the port's Predictor and evaluate_sample against the
JAX package's TPUPredictor on the NoC protocol (fixed ZoomIn, flip TTA),
from the same weights.

Click sequences (positions and signs) must be identical and NoC equal. Per
click IoU may differ by a few pixels at the 0.49 threshold, where f32
probabilities computed in another summation order can land on either side,
so IoUs are held to 1e-3.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from tests.test_torch_model import (
    jax_model_and_params,
    tiny_arch,  # noqa: F401  (fixture)
    tiny_config,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "assets" / "trained" / "synthetic_dinov2_noup_160ep.ckpt"
LOFTUP_CKPT = (REPO / "assets" / "trained"
               / "synthetic_dinov2_loftup448_160ep.ckpt")
IOU_TOL = 1e-3


def _scene(seed, hw=(60, 70)):
    rng = np.random.default_rng(seed)
    img = (rng.random((*hw, 3)) * 70).astype(np.uint8)
    gt = np.zeros(hw, np.int32)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    cy, cx = rng.uniform(0.3, 0.7) * hw[0], rng.uniform(0.3, 0.7) * hw[1]
    gt[((yy - cy) / (0.3 * hw[0])) ** 2 + ((xx - cx) / (0.35 * hw[1])) ** 2
       <= 1] = 1
    img[gt == 1] = rng.integers(120, 255, size=3)
    return img, gt


def _run_both(jmodel, params, tmodel, scenes, size, max_clicks, iou_thr):
    from isegprobe_tpu.inference.evaluation import evaluate_sample as j_eval
    from isegprobe_tpu.inference.metrics import compute_noc_metric as j_noc
    from isegprobe_tpu.inference.predictor import TPUPredictor
    from isegprobe_torch.inference.evaluation import evaluate_sample
    from isegprobe_torch.inference.metrics import compute_noc_metric
    from isegprobe_torch.inference.predictor import Predictor

    j_pred = TPUPredictor(jmodel, params, target_size=(size, size),
                          skip_clicks=-1, with_flip=True,
                          net_clicks_limit=max_clicks)
    t_pred = Predictor(tmodel, target_size=(size, size), skip_clicks=-1,
                       with_flip=True, net_clicks_limit=max_clicks,
                       device="cpu")
    j_all, t_all = [], []
    for img, gt in scenes:
        j_clicks, j_ious, _ = j_eval(img, gt, j_pred, max_iou_thr=iou_thr,
                                     pred_thr=0.49, max_clicks=max_clicks)
        t_clicks, t_ious, t_probs = evaluate_sample(
            img, gt, t_pred, max_iou_thr=iou_thr, pred_thr=0.49,
            max_clicks=max_clicks)
        assert ([(c.is_positive, c.coords) for c in t_clicks]
                == [(c.is_positive, c.coords) for c in j_clicks])
        assert len(t_ious) == len(j_ious)
        np.testing.assert_allclose(t_ious, j_ious, rtol=0, atol=IOU_TOL)
        assert t_probs.shape == gt.shape and np.isfinite(t_probs).all()
        j_all.append(j_ious)
        t_all.append(t_ious)
    thrs = [0.5, 0.8, 0.85, 0.9]
    t_noc, _, t_over = compute_noc_metric(t_all, thrs, max_clicks)
    j_noc_v, _, j_over = j_noc(j_all, thrs, max_clicks)
    assert t_noc == j_noc_v and t_over == j_over
    return t_all


def test_predictor_trajectory_matches_jax(tiny_arch):  # noqa: F811
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel

    size = 56
    cfg = tiny_config(size)
    jmodel, params = jax_model_and_params(cfg, size, gamma=0.5)
    tmodel = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    _run_both(jmodel, params, tmodel, [_scene(0), _scene(5)], size,
              max_clicks=4, iou_thr=0.99)


def _load_evaluate_cli():
    spec = importlib.util.spec_from_file_location(
        "isegprobe_evaluate_cli_torch_port", REPO / "evaluate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _trained_trajectories(ckpt, seeds):
    """A trained checkpoint at full width, merged over the JAX package's
    frozen-backbone (and frozen-upsampler) init and pos-embed
    pre-interpolation exactly as evaluate.py loads it, bridged into the
    port: same clicks, IoUs and NoC on synthetic scenes at a 112² ZoomIn
    crop. Returns the port's trajectories."""
    import jax

    from isegprobe_tpu.data.datasets.synthetic import render_scene
    from isegprobe_tpu.utils.serialization import load_checkpoint
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel

    size = 112
    evaluate = _load_evaluate_cli()
    jmodel, params = evaluate.load_model_for_eval(
        str(ckpt), {"dtype": "float32"}, target_size=(size, size))
    params = jax.tree.map(np.asarray, jax.device_get(params))
    # the checkpoint's own constructor config builds the port's model; the
    # backbone config carries the pre-interpolated pos-embed grid
    _, ckpt_config, _ = load_checkpoint(ckpt)
    cfg = dict(ckpt_config["params"], backbone_cfg=jmodel.backbone_cfg)
    assert cfg["backbone_cfg"]["params"]["pretrain_grid"] == (8, 8)
    tmodel = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)

    scenes = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        image, labels = render_scene(rng, (size, size), 2)
        obj = max(range(1, 3), key=lambda i: (labels == i).sum())
        scenes.append((image, (labels == obj).astype(np.int32)))
    return _run_both(jmodel, params, tmodel, scenes, size, max_clicks=4,
                     iou_thr=0.95)


def test_trained_checkpoint_trajectory_matches_jax():
    all_ious = _trained_trajectories(CKPT, (11, 12))
    # the trained probe does segment: IoU rises above chance
    assert max(float(a.max()) for a in all_ious) > 0.5


def test_trained_loftup_checkpoint_trajectory_matches_jax():
    """The trained 448² LoftUp checkpoint (DINOv2-S/14, LoftUp n_dim 384,
    the upsampler from the JAX package's PRNGKey(0) init as evaluate.py
    builds it): the LoftUp family's click trajectory in the port equals
    the JAX predictor's."""
    all_ious = _trained_trajectories(LOFTUP_CKPT, (11,))
    assert max(float(a.max()) for a in all_ious) > 0.5


class _Scenes:
    """Scenes in the shape both packages' evaluate_dataset read."""

    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def get_sample(self, index):
        image, gt = self.scenes[index]
        return SimpleNamespace(image=image, objects_ids=[1],
                               gt_mask=lambda _: gt)


def test_evaluate_dataset_matches_jax(tiny_arch):  # noqa: F811
    from isegprobe_tpu.inference.evaluation import evaluate_dataset as j_eval
    from isegprobe_tpu.inference.predictor import TPUPredictor
    from isegprobe_torch.inference.evaluation import (
        evaluate_dataset,
        latency_percentiles,
    )
    from isegprobe_torch.inference.predictor import Predictor
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel

    size = 56
    cfg = tiny_config(size)
    jmodel, params = jax_model_and_params(cfg, size, gamma=0.5)
    tmodel = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    data = _Scenes([_scene(3)])
    kw = dict(max_iou_thr=0.99, pred_thr=0.49, max_clicks=3)
    j_ious, _ = j_eval(data, TPUPredictor(jmodel, params,
                                          target_size=(size, size)), **kw)
    latencies = []
    t_ious, _ = evaluate_dataset(
        data, Predictor(tmodel, target_size=(size, size), device="cpu"),
        latencies=latencies, **kw)
    assert [len(a) for a in t_ious] == [len(a) for a in j_ious] == [3]
    np.testing.assert_allclose(t_ious[0], j_ious[0], rtol=0, atol=IOU_TOL)
    assert len(latencies) == 1
    assert set(latency_percentiles(latencies)) == {"p50_ms", "p95_ms",
                                                   "mean_ms"}
