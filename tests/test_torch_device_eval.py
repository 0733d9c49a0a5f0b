"""The port's on-device NoC loop (inference/device_eval.py) against the JAX
package's make_device_evaluator from the same weights, against the port's
own host Predictor, and its trunk cache against the uncached loop.

Click counts must be equal. IoUs are held to 1e-3 across the two packages
and against the host path, because f32 probabilities computed in another
summation order can put a few pixels on either side of the 0.49 threshold
(as in tests/test_torch_predictor.py); the trunk-cached loop against the
uncached one runs the same arithmetic in the port, so 1e-4.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_model import (
    jax_model_and_params,
    tiny_arch,  # noqa: F401  (fixture)
    tiny_config,
)
from tests.test_torch_predictor import _scene, _Scenes
from tests.test_torch_upsamplers import FAMILIES, family_model_and_params
from tests.test_torch_upsamplers import tiny_arch as upsampler_arch  # noqa: F401

torch.set_num_threads(2)

SIZE = 56
IOU_TOL = 1e-3
CACHE_TOL = 1e-4


def _models(injection="before_backbone"):
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel

    cfg = tiny_config(SIZE)
    cfg["backbone_cfg"]["params"]["feats_injection_mode"] = injection
    jmodel, params = jax_model_and_params(cfg, SIZE, gamma=0.5)
    tmodel = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    return jmodel, params, tmodel


def _common(max_clicks=4, **kw):
    return dict(target_size=(SIZE, SIZE), max_clicks=max_clicks,
                net_clicks_limit=max_clicks, pred_thr=0.49, with_flip=True,
                **kw)


def _assert_same(got, want, tol):
    assert [len(a) for a in got] == [len(a) for a in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


# (batch size, scene seeds, protocol settings): the padded tail (5 jobs in
# lanes of 3) with a target that stops lanes at different clicks, the
# min-clicks gate (target 0 holds from click 1), and a net-clicks limit
# below the click budget. A 20-pixel minimum crop lets the ZoomIn ROI
# move inside the 60x70 scenes (the default 200 pins it to the frame).
CASES = {
    "batch1": (1, [0, 5], _common(target_iou=0.3)),
    "batch3_tail": (3, [0, 3, 5, 7, 11], _common(target_iou=0.3,
                                                 min_crop_size=20)),
    "min_clicks": (1, [0], _common(max_clicks=5, target_iou=0.0,
                                   min_clicks=3)),
    "net_clicks_limit": (3, [5, 3], dict(_common(target_iou=0.99,
                                                 min_crop_size=20),
                                         net_clicks_limit=2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_device_loop_matches_jax(tiny_arch, case):  # noqa: F811
    from isegprobe_tpu.inference import device_eval as j_eval
    from isegprobe_torch.inference import device_eval

    batch, seeds, kw = CASES[case]
    jmodel, params, tmodel = _models()
    data = _Scenes([_scene(s) for s in seeds])
    want = j_eval.evaluate_dataset_device(
        j_eval.make_device_evaluator(jmodel, batch_size=batch, **kw),
        params, data, batch_size=batch)
    run = device_eval.make_device_evaluator(tmodel, batch_size=batch,
                                            device="cpu", **kw)
    got = device_eval.evaluate_dataset_device(run, data)
    _assert_same(got, want, IOU_TOL)
    if case == "batch3_tail":
        # lanes stopped at different clicks, so lane masking was exercised
        assert len({len(a) for a in got}) > 1
    if case == "min_clicks":
        assert [len(a) for a in got] == [3]
    # one host read per loop step for the loop condition, plus the final one
    assert run.host_reads == run.steps + -(-len(seeds) // batch)


def test_device_loop_matches_host_predictor(tiny_arch):  # noqa: F811
    from isegprobe_torch.inference.device_eval import (
        evaluate_sample_device,
        make_device_evaluator,
    )
    from isegprobe_torch.inference.evaluation import evaluate_sample
    from isegprobe_torch.inference.predictor import Predictor

    _, _, tmodel = _models()
    kw = _common(target_iou=0.3, min_crop_size=20)
    run = make_device_evaluator(tmodel, device="cpu", **kw)
    pred = Predictor(tmodel, target_size=(SIZE, SIZE), with_flip=True,
                     net_clicks_limit=kw["net_clicks_limit"],
                     min_crop_size=20, device="cpu")
    for seed in (0, 3, 5):
        img, gt = _scene(seed)
        _, host, _ = evaluate_sample(img, gt, pred, max_iou_thr=0.3,
                                     pred_thr=0.49,
                                     max_clicks=kw["max_clicks"])
        _assert_same([evaluate_sample_device(run, img, gt)], [host], IOU_TOL)


def test_trunk_cache(tiny_arch):  # noqa: F811
    """after_backbone: the cached loop equals the uncached one, and JAX's
    cached loop; forcing the cache on an early-injection model raises."""
    from isegprobe_tpu.inference import device_eval as j_eval
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_device,
        make_device_evaluator,
    )

    jmodel, params, tmodel = _models("after_backbone")
    data = _Scenes([_scene(s) for s in (0, 3, 5, 7)])
    kw = _common(target_iou=0.3, batch_size=3, min_crop_size=20)
    cached = make_device_evaluator(tmodel, device="cpu", **kw)
    assert cached.use_cache
    uncached = make_device_evaluator(tmodel, trunk_cache="off",
                                     device="cpu", **kw)
    got = evaluate_dataset_device(cached, data)
    _assert_same(got, evaluate_dataset_device(uncached, data), CACHE_TOL)
    # the trunk is recomputed only on clicks whose ROI moved
    assert 0 < cached.trunk_recomputes < cached.steps
    want = j_eval.evaluate_dataset_device(
        j_eval.make_device_evaluator(jmodel, **kw), params, data,
        batch_size=3)
    _assert_same(got, want, IOU_TOL)

    _, _, early = _models("before_backbone")
    with pytest.raises(ValueError, match="after_backbone"):
        make_device_evaluator(early, trunk_cache="on", device="cpu",
                              **_common())


def test_evaluate_dataset_device_order_and_times(tiny_arch):  # noqa: F811
    """Scenes of two padded shapes interleaved: results come back in
    dataset order, one wall time per sample, equal to per-sample runs."""
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_device,
        evaluate_sample_device,
        make_device_evaluator,
    )

    _, _, tmodel = _models()
    scenes = [_scene(s, hw) for s, hw in ((0, (60, 70)), (1, (70, 130)),
                                          (2, (60, 70)), (3, (70, 130)),
                                          (4, (60, 70)))]
    kw = _common(max_clicks=3, target_iou=0.3)
    run1 = make_device_evaluator(tmodel, device="cpu", **kw)
    run2 = make_device_evaluator(tmodel, batch_size=2, device="cpu", **kw)
    times = []
    got = evaluate_dataset_device(run2, _Scenes(scenes), sample_times=times)
    assert len(times) == len(scenes) and all(t > 0 for t in times)
    want = [evaluate_sample_device(run1, img, gt) for img, gt in scenes]
    _assert_same(got, want, CACHE_TOL)
    with pytest.raises(ValueError, match="batch_size 1"):
        evaluate_sample_device(run2, *scenes[0])


@pytest.mark.parametrize("batch", [1, 2])
def test_click_record_is_opt_in(tiny_arch, batch):  # noqa: F811
    """Without ``record_clicks`` the loop keeps no click record and
    ``clicks=`` raises; with it, the same IoUs, and one (y, x, positive)
    row a click, -1 past each lane's count."""
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_device,
        make_device_evaluator,
    )

    _, _, tmodel = _models()
    data = _Scenes([_scene(s, (60, 70)) for s in (0, 3, 5)])
    kw = _common(max_clicks=3, target_iou=0.3, batch_size=batch)
    plain = make_device_evaluator(tmodel, device="cpu", **kw)
    want = evaluate_dataset_device(plain, data)
    assert plain.clicks is None
    with pytest.raises(ValueError, match="record_clicks"):
        evaluate_dataset_device(plain, data, clicks=[])
    rec = make_device_evaluator(tmodel, record_clicks=True, device="cpu",
                                **kw)
    clicks: list = []
    got = evaluate_dataset_device(rec, data, clicks=clicks)
    _assert_same(got, want, 0.0)
    assert [len(c) for c in clicks] == [len(a) for a in want]
    for c, (img, gt) in zip(clicks, data.scenes):
        assert (c >= 0).all() and c[0, 2] == 1 and gt[c[0, 0], c[0, 1]] == 1
    n_last = len(want[-1])
    assert (rec.clicks[0, n_last:] == -1).all()


def test_unported_options_and_devices_raise(tiny_arch):  # noqa: F811
    """The options and devices of the evaluator: ``mesh`` (ported) splits
    the lanes over a device list, a repeated device included, and gives
    the one-device run's clicks and IoUs; group_api with a mesh and a
    batch the devices do not divide raise; a GPU is the default device."""
    from isegprobe_torch.inference.device_eval import (
        MeshEvaluator,
        evaluate_dataset_device,
        make_device_evaluator,
    )
    from isegprobe_torch.models.probe_model import (
        flagship_config,
        iSegProbeModel,
    )

    _, _, tiny = _models()
    data = _Scenes([_scene(s) for s in (0, 3, 5, 7)])
    kw = _common(target_iou=0.3, min_crop_size=20, record_clicks=True)
    one = make_device_evaluator(tiny, batch_size=4, device="cpu", **kw)
    mesh = make_device_evaluator(tiny, batch_size=4, mesh=["cpu", "cpu"],
                                 device="cpu", **kw)
    assert isinstance(mesh, MeshEvaluator) and mesh.batch_size == 4
    assert [s.batch_size for s in mesh.shards] == [2, 2]
    assert mesh.shards[0].model is tiny and mesh.shards[1].model is not tiny
    want_clicks, got_clicks = [], []
    want = evaluate_dataset_device(one, data, clicks=want_clicks)
    got = evaluate_dataset_device(mesh, data, clicks=got_clicks)
    _assert_same(got, want, 0.0)
    for a, b in zip(got_clicks, want_clicks):
        np.testing.assert_array_equal(a, b)
    assert mesh.steps == one.steps
    model = iSegProbeModel(**flagship_config((56, 56)), device="cpu")
    with pytest.raises(ValueError, match="group_api"):
        make_device_evaluator(model, batch_size=8, mesh=["cpu", "cpu"],
                              group_api=True, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        make_device_evaluator(model, batch_size=3, mesh=["cpu", "cpu"],
                              device="cpu")
    # continuous batching is ported: group_api gives the job queue
    group = make_device_evaluator(model, batch_size=8, group_api=True,
                                  device="cpu")
    assert group.batch_size == 8 and group.protocol.batch_size == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_device_evaluator(model)
    run = make_device_evaluator(model, device="cpu")
    assert run.device == torch.device("cpu") and not run.use_cache


@pytest.mark.parametrize("family", list(FAMILIES))
def test_learned_upsampler_loop_matches_jax(upsampler_arch, family):  # noqa: F811
    """The LoftUp (banded) and JBU-FeatUp probes through the on-device loop
    at batch 2 (a padded tail of 3 jobs), against JAX make_device_evaluator
    from the same weights: the lanes run the upsamplers batched, as JAX
    vmaps them."""
    from isegprobe_tpu.inference import device_eval as j_eval
    from isegprobe_torch.inference import device_eval
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel

    cfg, jmodel, params = family_model_and_params(family, SIZE)
    tmodel = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    data = _Scenes([_scene(s) for s in (0, 3, 5)])
    kw = _common(max_clicks=3, target_iou=0.3, min_crop_size=20)
    want = j_eval.evaluate_dataset_device(
        j_eval.make_device_evaluator(jmodel, batch_size=2, **kw), params,
        data, batch_size=2)
    run = device_eval.make_device_evaluator(tmodel, batch_size=2,
                                            device="cpu", **kw)
    _assert_same(device_eval.evaluate_dataset_device(run, data), want,
                 IOU_TOL)
