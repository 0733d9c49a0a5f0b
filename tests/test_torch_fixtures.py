"""The trained-evaluation fixture, ``isegprobe_torch/fixtures/
synthetic2026_50.npz``: the JAX package's ``Synthetic`` evaluation scenes and
its device evaluator's results on them, for the GPU machine, which has
neither JAX nor OpenCV.

It holds:
* the 50 scenes of ``evaluate.py:get_dataset("Synthetic")``
  (``SyntheticShapesDataset(n_samples=50, seed=2026, image_size=(224, 224),
  min_instance_area=1400)``): ``images`` uint8 [50,224,224,3], instance
  ``labels`` uint8 [50,224,224] and the evaluated ``objects`` [78, 2]
  (scene, label) in the dataset's order;
* the JAX f32 device evaluator on the trained 160-epoch flagship
  (``synthetic_dinov2_noup_160ep.ckpt`` through ``evaluate.py:
  load_model_for_eval``; ``make_device_evaluator`` with ``evaluate.py``'s
  settings: fixed 448² ZoomIn, flip, 20 clicks, target IoU 0.9, threshold
  0.5, ``device_batch=8``): ``flagship_ious`` [78, 20] (0 past
  ``flagship_n``), ``flagship_clicks`` [78, 20, 3] (y, x, is_positive; -1
  past ``flagship_n``), ``flagship_noc`` (NoC@80/85/90),
  ``flagship_over_max`` and ``flagship_miou`` (mIoU@1..20);
* the same for the 448² LoftUp checkpoint
  (``synthetic_dinov2_loftup448_160ep.ckpt``) on the first 2 objects and 4
  clicks (``loftup_*``): a longer LoftUp run is too slow on the CPU.

The JAX device evaluator returns IoUs only; its clicks are read by wrapping
``next_click_from_error`` in ``jax.debug.callback`` (keyed by each lane's
object and click count), in this file only.

Write it with ``JAX_PLATFORMS=cpu python tests/test_torch_fixtures.py
--export`` (on an 8-core CPU host: 866 s for the flagship, 192 s for
LoftUp; 6,149,457 bytes written). The tests hold the committed file
against a fresh render and the port's ``data/scenes.py`` against the JAX
dataset; under ``RUN_SLOW=1`` they
rerun the JAX flagship evaluator on the first eight objects.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "isegprobe_torch" / "fixtures" / "synthetic2026_50.npz"
TRAINED = REPO / "assets" / "trained"
FLAGSHIP_CKPT = TRAINED / "synthetic_dinov2_noup_160ep.ckpt"
LOFTUP_CKPT = TRAINED / "synthetic_dinov2_loftup448_160ep.ckpt"
TARGET = (448, 448)
# the early-stop protocol: configs/eval_cfg.yaml's n_clicks, target_iou,
# thresh and min_n_clicks, with a stop at the target IoU (the root
# evaluate.py's defaults print the IoUs and so run every click instead)
PROTOCOL = dict(max_clicks=20, net_clicks_limit=20, pred_thr=0.5,
                target_iou=0.9, min_clicks=1, with_flip=True)
LOFTUP_OBJECTS, LOFTUP_CLICKS = 2, 4


def _evaluate_cli():
    spec = importlib.util.spec_from_file_location(
        "isegprobe_evaluate_cli_fixture", REPO / "evaluate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def render_synthetic():
    """The JAX ``Synthetic`` dataset and its scenes as arrays: (dataset,
    images, labels, objects)."""
    from types import SimpleNamespace

    dataset = _evaluate_cli().get_dataset("Synthetic",
                                          SimpleNamespace(DATASETS=None))
    images, labels, objects = [], [], []
    for index in range(len(dataset.dataset_samples)):
        sample = dataset.get_sample(index)
        images.append(sample.image)
        label_map = sample._encoded_masks[:, :, 0]
        labels.append(label_map.astype(np.uint8))
        assert label_map.max() < 256
        for obj in sample.objects_ids:
            objects.append((index, sample.nodes[obj].mapping[1]))
    return (dataset, np.stack(images), np.stack(labels),
            np.asarray(objects, np.int16))


def _objects(images, labels, objects, pick=slice(None)):
    """The picked objects of stored scenes, one object a sample."""
    from isegprobe_torch.data.scenes import SceneDataset

    return SceneDataset(dict(images=images, labels=labels, objects=objects),
                        objects=pick)


def _lane_key(gt):
    """An object's identity as the device loop sees it: area and the sums
    of its rows and columns (unique over the fixture's objects)."""
    import jax.numpy as jnp

    g = gt.astype(jnp.int32)
    rows = jnp.arange(g.shape[0], dtype=jnp.int32)[:, None]
    cols = jnp.arange(g.shape[1], dtype=jnp.int32)[None, :]
    return jnp.stack([g.sum(), (g * rows).sum(), (g * cols).sum()])


def _np_lane_key(mask):
    rows, cols = np.nonzero(mask == 1)
    return (len(rows), int(rows.sum()), int(cols.sum()))


def jax_device_run(ckpt, objects_data, batch_size, max_clicks,
                   dtype="float32"):
    """The JAX device evaluator (f32, or ``evaluate.py``'s ``dtype``) over
    ``objects_data`` (``_objects``): per-object IoUs, click counts and
    clicks [N, max_clicks, 3]."""
    import jax
    import jax.numpy as jnp

    from isegprobe_tpu.inference import device_eval as jde

    evaluate = _evaluate_cli()
    model, params = evaluate.load_model_for_eval(
        str(ckpt), {"dtype": dtype}, target_size=TARGET)
    seen = {}

    def record(key, n_prior, is_pos, cy, cx):
        seen[(tuple(int(v) for v in key), int(n_prior))] = (
            int(cy), int(cx), int(bool(is_pos)))

    inner = jde.next_click_from_error

    def recording_clicker(gt, pred_mask, not_clicked, not_ignore):
        is_pos, cy, cx = inner(gt, pred_mask, not_clicked, not_ignore)
        n_prior = (~not_clicked).astype(jnp.int32).sum()
        jax.debug.callback(record, _lane_key(gt), n_prior, is_pos, cy, cx)
        return is_pos, cy, cx

    jde.next_click_from_error = recording_clicker
    try:
        run = jde.make_device_evaluator(
            model, target_size=TARGET,
            **dict(PROTOCOL, max_clicks=max_clicks,
                   net_clicks_limit=max_clicks),
            batch_size=batch_size)
        all_ious = jde.evaluate_dataset_device(run, params, objects_data,
                                               batch_size=batch_size)
    finally:
        jde.next_click_from_error = inner
    n = len(all_ious)
    ious = np.zeros((n, max_clicks), np.float32)
    clicks = np.full((n, max_clicks, 3), -1, np.int16)
    counts = np.zeros(n, np.int16)
    keys = set()
    for i, arr in enumerate(all_ious):
        key = _np_lane_key(objects_data.get_sample(i).gt_mask(0))
        assert key not in keys, "two objects share a lane key"
        keys.add(key)
        counts[i] = len(arr)
        ious[i, :len(arr)] = arr
        for k in range(len(arr)):
            clicks[i, k] = seen[(key, k)]
    return ious, counts, clicks


def export(path=FIXTURE):
    from isegprobe_tpu.inference.metrics import compute_noc_metric, miou_at_k

    _, images, labels, objects = render_synthetic()
    out = dict(images=images, labels=labels, objects=objects)

    t0 = time.time()
    ious, n, clicks = jax_device_run(
        FLAGSHIP_CKPT, _objects(images, labels, objects), batch_size=8,
        max_clicks=20)
    print(f"flagship: {time.time() - t0:.0f} s")
    per_object = [ious[i, :n[i]] for i in range(len(n))]
    noc, _, over_max = compute_noc_metric(per_object, [0.8, 0.85, 0.9], 20)
    out.update(flagship_ious=ious, flagship_n=n, flagship_clicks=clicks,
               flagship_noc=np.asarray(noc), flagship_over_max=np.asarray(
                   over_max), flagship_miou=miou_at_k(per_object, 20))
    print("flagship NoC@80/85/90", noc, "over max", over_max)

    t0 = time.time()
    ious, n, clicks = jax_device_run(
        LOFTUP_CKPT,
        _objects(images, labels, objects, slice(0, LOFTUP_OBJECTS)),
        batch_size=LOFTUP_OBJECTS, max_clicks=LOFTUP_CLICKS)
    print(f"loftup: {time.time() - t0:.0f} s")
    out.update(loftup_ious=ious, loftup_n=n, loftup_clicks=clicks)
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


# -- tests --------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as data:
        return dict(data)


@pytest.fixture(scope="module")
def rendered():
    return render_synthetic()


def test_fixture_size_and_keys(fixture):
    assert FIXTURE.stat().st_size <= 8 * 2**20
    assert fixture["images"].shape == (50, 224, 224, 3)
    assert fixture["objects"].shape == (78, 2)
    assert fixture["flagship_ious"].shape == (78, 20)
    assert fixture["flagship_clicks"].shape == (78, 20, 3)
    assert fixture["loftup_ious"].shape == (LOFTUP_OBJECTS, LOFTUP_CLICKS)


def test_scenes_equal_a_fresh_render(fixture, rendered):
    _, images, labels, objects = rendered
    np.testing.assert_array_equal(fixture["images"], images)
    np.testing.assert_array_equal(fixture["labels"], labels)
    np.testing.assert_array_equal(fixture["objects"], objects)


def test_scene_dataset_masks_equal_the_jax_dataset(rendered):
    from isegprobe_torch.data.scenes import SceneDataset

    dataset = rendered[0]
    data = SceneDataset(FIXTURE)
    assert len(data) == len(dataset.dataset_samples)
    assert data.n_objects == 78
    for index in range(len(data)):
        want, got = dataset.get_sample(index), data.get_sample(index)
        np.testing.assert_array_equal(got.image, want.image)
        assert got.objects_ids == want.objects_ids
        for obj in got.objects_ids:
            mask = got.gt_mask(obj)
            assert mask.dtype == np.int32
            np.testing.assert_array_equal(mask, want.gt_mask(obj))


@pytest.mark.parametrize("pick", [slice(None), slice(0, 2), [77, 5, 0]])
def test_scene_dataset_object_mode(fixture, pick):
    """With ``objects``, each picked stored object is a sample of its own,
    with its scene's image and the mask the scene mode gives it."""
    from isegprobe_torch.data.scenes import SceneDataset

    scenes = SceneDataset(FIXTURE)
    by_scene = [(s, o) for s in range(len(scenes))
                for o in scenes.get_sample(s).objects_ids]
    picked = [by_scene[i] for i in range(len(by_scene))[pick]] if isinstance(
        pick, slice) else [by_scene[i] for i in pick]
    for data in (SceneDataset(FIXTURE, objects=pick),
                 SceneDataset(fixture, objects=pick)):
        assert len(data) == data.n_objects == len(picked)
        for index, (scene, obj) in enumerate(picked):
            got, want = data.get_sample(index), scenes.get_sample(scene)
            assert got.objects_ids == [0]
            np.testing.assert_array_equal(got.image, want.image)
            np.testing.assert_array_equal(got.gt_mask(0), want.gt_mask(obj))


def test_stored_results_are_consistent(fixture):
    """NoC and mIoU@k recomputed from the stored IoUs; clicks present
    exactly up to each object's count, first clicks positive and inside
    the object."""
    from isegprobe_tpu.inference.metrics import compute_noc_metric, miou_at_k

    for name, n_clicks in (("flagship", 20), ("loftup", LOFTUP_CLICKS)):
        ious, n = fixture[f"{name}_ious"], fixture[f"{name}_n"]
        clicks = fixture[f"{name}_clicks"]
        for i, k in enumerate(n):
            assert 1 <= k <= n_clicks
            assert (clicks[i, :k] >= 0).all() and (clicks[i, k:] == -1).all()
            assert (ious[i, k:] == 0).all()
            scene, label = fixture["objects"][i]
            y, x, pos = clicks[i, 0]
            assert pos == 1 and fixture["labels"][scene, y, x] == label
    per_object = [fixture["flagship_ious"][i, :k]
                  for i, k in enumerate(fixture["flagship_n"])]
    noc, _, over_max = compute_noc_metric(per_object, [0.8, 0.85, 0.9], 20)
    np.testing.assert_array_equal(fixture["flagship_noc"], noc)
    np.testing.assert_array_equal(fixture["flagship_over_max"], over_max)
    np.testing.assert_array_equal(fixture["flagship_miou"],
                                  miou_at_k(per_object, 20))
    # the trained probe segments: most objects reach the target
    assert noc[2] < 10


@pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                    reason="reruns the JAX device evaluator (RUN_SLOW=1)")
def test_jax_device_evaluator_reproduces_stored_results(fixture):
    """The first chunk of eight objects, as the export ran it."""
    ious, n, clicks = jax_device_run(
        FLAGSHIP_CKPT, _objects(fixture["images"], fixture["labels"],
                                fixture["objects"], slice(0, 8)),
        batch_size=8, max_clicks=20)
    np.testing.assert_array_equal(n, fixture["flagship_n"][:8])
    np.testing.assert_array_equal(clicks, fixture["flagship_clicks"][:8])
    np.testing.assert_array_equal(ious, fixture["flagship_ious"][:8])


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    if "--export" not in sys.argv[1:]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_fixtures.py"
                 " --export")
    export()
