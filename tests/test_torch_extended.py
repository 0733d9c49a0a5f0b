"""The port's extended training loaders (``data/datasets/extended.py``)
against the JAX package's, on small trees in each dataset's on-disk
layout: ``isegprobe_torch/fixtures/datasets/{coco_lvis,lvis,coco,ade20k,
openimages}/``.

The trees hold Synthetic scenes (the port's ``render_scene``), four images
a layout at most 320×256, written as those datasets ship them:

* ``coco_lvis/train/``: ``images/*.jpg``, ``masks/*.pickle`` (the mask
  layers as PNG buffers and the (layer, label) mapping; stuff in the slots
  past ``num_instance_masks``) and ``hannotation.pickle`` (two samples with
  a two-level hierarchy: a parent instance over two children on another
  layer);
* ``lvis/``: ``train/lvis_train.json`` with polygon rings (non-convex,
  self-intersecting, partly off the image, with fewer than three points,
  several rings an annotation), its images under ``train/images`` and one
  ``val2017`` image under ``val/images``, and ``train_categories.json``
  (written by the JAX loader, committed so that nothing writes into the
  tree);
* ``coco/``: ``train/*.jpg``, ``annotations/panoptic_train.json`` and the
  colour-coded segment PNGs (ids over all three channels, crowds, stuff);
* ``ade20k/``: ``train-annotations-object-segmentation.pkl`` and
  ``images/training/...`` with each image's instance layers (RGB PNGs, the
  labels in the blue channel; one of them interlaced);
* ``openimages/train/``: ``images/*.jpg``, ``masks/*.png`` (1-bit gray
  PNGs, one of them interlaced, one 8-bit; some at another resolution than
  their image) and the annotation pickle.

Ten of the twenty JPEGs are progressive.

``isegprobe_torch/fixtures/extended_datasets.npz`` holds what the GPU
machine (no JAX, no OpenCV) checks against:

* ``file_names`` / ``file_digests`` / ``file_digests_unchanged``: sha256
  of ``cv2.imread``'s pixels of every file of the five trees, in colour and
  with ``IMREAD_UNCHANGED``;
* ``items_<layout>``: sha256 of the JAX package's process-mode items of
  each loader (the SBD train augmentations at 224², ``stuff_prob`` 0.3
  where a loader takes it, the hierarchy sampler ``MultiPointSampler(24,
  prob_gamma=0.80, merge_objects_prob=0.15, max_num_merged_objects=2,
  use_hierarchy=True)``) for seeds 0 and 1, index = position;
  ``items_compose``: the same for the ``ComposeDataset`` of the five;
* ``step_positions`` / ``step_item_digests`` / ``step_losses`` /
  ``step_digest_names`` / ``step_digests``: the JAX trainer's first two
  step losses and its trainable leaves' digests for
  ``models/sbd/dinov2/patch-embed_noup.py`` from ``PRNGKey(0)`` at 224²,
  num_iters=0, on a fresh composed set's seed-0 items at
  ``step_positions`` (every loader's), and those items' digests.

Write both with ``JAX_PLATFORMS=cpu python tests/test_torch_extended.py
--export``. The tests read the committed trees and copy a tree to
``tmp_path`` where a file is written.
"""

from __future__ import annotations

import json
import pickle
import shutil
import struct
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests.test_torch_datasets import (  # noqa: E402
    _jpeg,
    _scene,
    item_digest,
    jax_items,
    jax_sbd_cfg,
    jax_sbd_datasets,
    jax_sbd_trainer,
    pixel_digest,
)

TREES = REPO / "isegprobe_torch" / "fixtures" / "datasets"
FIXTURE = REPO / "isegprobe_torch" / "fixtures" / "extended_datasets.npz"
LAYOUTS = ("coco_lvis", "lvis", "coco", "ade20k", "openimages")
ITEM_SEEDS = (0, 1)
# RITM's COCO-LVIS recipe keeps stuff with probability 0.30
STUFF_PROB = 0.3
STEP_MODEL = "sbd_dinov2_noup"
# the composed set's positions of the step batch: each loader's first
# sample, then the third of CocoLvis, COCO and OpenImages
STEP_POSITIONS = (0, 4, 8, 12, 16, 2, 10, 18)


def png_bytes(samples: np.ndarray, depth: int, ctype: int,
              interlace: bool = False) -> bytes:
    """A PNG of ``samples`` ``[h, w, ch]`` (PNG channel order), Adam7
    interlaced or not, written as other encoders write it."""
    from tests.test_torch_image_io import _rows, encode_png, png_adam7

    if interlace:
        return png_adam7(samples, depth, ctype)
    h, w = samples.shape[:2]
    return encode_png(_rows(samples, depth), w, h, depth, ctype)


# -- writing the trees (the export only) --------------------------------------

def _objects(labels: np.ndarray) -> list:
    from isegprobe_torch.utils.misc import get_labels_with_sizes

    return list(get_labels_with_sizes(labels)[0])


def _progressive(k: int) -> tuple:
    import cv2

    return (cv2.IMWRITE_JPEG_PROGRESSIVE, 1) if k % 2 == 0 else ()


def _write_coco_lvis(root: Path) -> None:
    import cv2

    split = root / "train"
    (split / "images").mkdir(parents=True)
    (split / "masks").mkdir()
    annos = {}
    for k, (image_id, h, w) in enumerate([
            ("000000000009", 240, 320), ("000000000025", 256, 256),
            ("000000000030", 192, 288), ("000000000034", 256, 320)]):
        image, labels = _scene(600 + k, h, w, n_shapes=4)
        _jpeg(split / "images" / f"{image_id}.jpg", image,
              extra=_progressive(k))
        objs = _objects(labels)
        layers = np.zeros((2, h, w), np.uint8)
        mapping, hierarchy = [], {}
        if k % 2 == 0 and len(objs) >= 3:
            # a parent over two children, the children on layer 1
            a, b = objs[0], objs[1]
            layers[0][(labels == a) | (labels == b)] = 1
            layers[1][labels == a] = 1
            layers[1][labels == b] = 2
            mapping += [(0, 1), (1, 1), (1, 2)]
            hierarchy = {0: {"parent": None, "children": [1, 2]},
                         1: {"parent": 0, "children": []},
                         2: {"parent": 0, "children": []}}
            rest = objs[2:]
        else:
            rest = objs
        for j, obj in enumerate(rest):
            layers[0][labels == obj] = 10 + j
            mapping.append((0, 10 + j))
            if j == 0:
                hierarchy[len(mapping) - 1] = None
        n_inst = len(mapping)
        # stuff: the background's top half on layer 0, its bottom half on 1
        bg = labels == 0
        top = np.zeros_like(bg)
        top[:h // 2] = True
        layers[0][bg & top] = 50
        layers[1][bg & ~top] = 60
        mapping += [(0, 50), (1, 60)]
        packed = [cv2.imencode(".png", layer)[1] for layer in layers]
        (split / "masks" / f"{image_id}.pickle").write_bytes(
            pickle.dumps((packed, mapping)))
        annos[image_id] = {"hierarchy": hierarchy,
                           "num_instance_masks": n_inst}
    (split / "hannotation.pickle").write_bytes(pickle.dumps(annos))


def _ring(mask: np.ndarray, jitter: float) -> list:
    """An object's outer contour as a flat float ring."""
    import cv2

    contours, _ = cv2.findContours(mask.astype(np.uint8), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    pts = max(contours, key=len).reshape(-1, 2).astype(np.float64)
    pts = pts[::max(1, len(pts) // 24)] + jitter
    return [round(float(v), 2) for v in pts.reshape(-1)]


def _write_lvis(root: Path) -> None:
    for split in ("train", "val"):
        (root / split / "images").mkdir(parents=True)
    images, annotations = [], []
    for k, (h, w) in enumerate([(240, 320), (256, 320), (200, 300),
                                (256, 256)]):
        image_id = 139 + 97 * k
        fold = "val2017" if k == 3 else "train2017"
        name = f"{image_id:012d}.jpg"
        image, labels = _scene(700 + k, h, w, n_shapes=4)
        _jpeg(root / ("val" if k == 3 else "train") / "images" / name,
              image, extra=_progressive(k + 1))
        images.append({"id": image_id, "height": h, "width": w,
                       "coco_url": f"http://images.cocodataset.org/{fold}/"
                                   f"{name}"})
        rings = [[_ring(labels == obj, 0.37 * (j + 1))]
                 for j, obj in enumerate(_objects(labels))]
        if k == 0:  # a self-intersecting bow tie over the first object
            rings.append([[40.2, 30.7, 150.6, 120.1, 40.4, 120.3,
                           150.2, 30.5]])
        if k == 1:  # partly off the image, and a line of two points
            rings.append([[w - 40.5, -12.2, w + 30.1, 60.8, w - 10.3,
                           h + 9.6, w - 80.7, h - 30.2],
                          [10.2, 10.4, 60.7, 12.1]])
        if k == 2:  # a star (non-convex), and a single point
            t = np.arange(10) * np.pi / 5
            r = np.where(np.arange(10) % 2 == 0, 70.0, 28.0)
            star = np.stack([150 + r * np.cos(t), 100 + r * np.sin(t)], 1)
            rings.append([[round(float(v), 2) for v in star.reshape(-1)],
                          [5.5, 190.4]])
        if k == 3:  # one annotation of two rings, mostly covering another
            rings.append([[0.4, 0.2, 250.3, 0.6, 250.1, 250.8, 0.3, 250.4],
                          [20.6, 20.2, 60.1, 22.7, 40.3, 70.9]])
        for j, segmentation in enumerate(rings):
            annotations.append({"id": 1000 * k + j, "image_id": image_id,
                                "category_id": 1 + j % 3,
                                "segmentation": segmentation})
    categories = [{"id": i, "name": n, "frequency": "f"}
                  for i, n in ((1, "ball"), (2, "cup"), (3, "kite"))]
    (root / "train" / "lvis_train.json").write_text(json.dumps(
        {"images": images, "annotations": annotations,
         "categories": categories}))


def _write_coco(root: Path) -> None:
    import cv2

    (root / "train").mkdir(parents=True)
    labels_dir = root / "annotations" / "panoptic_train"
    labels_dir.mkdir(parents=True)
    annotations = []
    for k, (h, w) in enumerate([(256, 320), (240, 320), (200, 300),
                                (256, 256)]):
        image_id = 285 + 11 * k
        name = f"{image_id:012d}"
        image, labels = _scene(800 + k, h, w, n_shapes=4)
        _jpeg(root / "train" / f"{name}.jpg", image, extra=_progressive(k))
        segments, ids = [], np.zeros((h, w), np.int64)
        for j, obj in enumerate(_objects(labels)):
            seg_id = 3 + 7 * j + 256 * (5 + 3 * k) + 65536 * (2 + j + k)
            ids[labels == obj] = seg_id
            segments.append({"id": int(seg_id), "category_id": 1 + j % 2,
                             "iscrowd": int(j == 2)})
        bg = labels == 0
        left = np.zeros_like(bg)
        left[:, :w // 2] = True
        for j, part in enumerate((bg & left, bg & ~left)):
            seg_id = 1000 + 65536 * (30 + j) + 256 * k
            ids[part] = seg_id
            segments.append({"id": int(seg_id), "category_id": 184 + j,
                             "iscrowd": 0})
        rgb = np.stack([ids % 256, ids // 256 % 256, ids // 65536], 2)
        cv2.imwrite(str(labels_dir / f"{name}.png"),
                    np.ascontiguousarray(rgb[:, :, ::-1]).astype(np.uint8))
        annotations.append({"file_name": f"{name}.png", "image_id": image_id,
                            "segments_info": segments})
    categories = [{"id": 1, "isthing": 1, "name": "person"},
                  {"id": 2, "isthing": 1, "name": "bicycle"},
                  {"id": 184, "isthing": 0, "name": "tree-merged"},
                  {"id": 185, "isthing": 0, "name": "sky-other-merged"}]
    (root / "annotations" / "panoptic_train.json").write_text(json.dumps(
        {"annotations": annotations, "categories": categories}))


def _write_ade20k(root: Path) -> None:
    import cv2

    annos = {}
    for k, (h, w) in enumerate([(240, 320), (256, 256), (192, 256),
                                (256, 320)]):
        image_id = f"ADE_train_{k + 1:08d}"
        folder = f"images/training/{'abcd'[k]}/scene{k}"
        (root / folder).mkdir(parents=True)
        image, labels = _scene(900 + k, h, w, n_shapes=4)
        _jpeg(root / folder / f"{image_id}.jpg", image,
              extra=_progressive(k + 1))
        layers = []
        for depth_level in range(1 + k % 2):
            name = (f"{image_id}_seg.png" if depth_level == 0
                    else f"{image_id}_parts_1.png")
            inst = labels.astype(np.uint8) * (3 if depth_level else 1)
            bgr = np.stack([inst, (inst * 37) % 251,
                            np.full_like(inst, 10 * k)], 2)
            if k == 2:  # interlaced (Adam7), as some encoders write it
                (root / folder / name).write_bytes(
                    png_bytes(bgr[:, :, ::-1], 8, 2, interlace=True))
            else:
                cv2.imwrite(str(root / folder / name), bgr)
            layers.append({"mask_name": name,
                           "stuff_instances": [0] if depth_level == 0
                           else [1]})
        annos[image_id] = {"folder": folder, "layers": layers}
    (root / "train-annotations-object-segmentation.pkl").write_bytes(
        pickle.dumps(annos))


def _write_openimages(root: Path) -> None:
    import cv2

    split = root / "train"
    (split / "images").mkdir(parents=True)
    (split / "masks").mkdir()
    id_to_masks, samples = {}, []
    for k, (h, w, mh, mw) in enumerate([
            (240, 320, 240, 320), (256, 256, 200, 180),
            (192, 288, 256, 300), (256, 320, 128, 160)]):
        image_id = f"{0x1a2b3c4d + 4099 * k:016x}"
        image, labels = _scene(1000 + k, h, w, n_shapes=3)
        _jpeg(split / "images" / f"{image_id}.jpg", image,
              extra=_progressive(k))
        names = []
        for j, obj in enumerate(_objects(labels)[:2]):
            mask = cv2.resize((labels == obj).astype(np.uint8), (mw, mh),
                              interpolation=cv2.INTER_NEAREST)
            name = f"{image_id}_m0{k}{j}abc_{j:08x}.png"
            if (k, j) == (1, 1):  # 8-bit, as cv2 writes it
                cv2.imwrite(str(split / "masks" / name), mask * 255)
            else:  # 1-bit gray, as OpenImages ships them
                (split / "masks" / name).write_bytes(png_bytes(
                    mask[:, :, None], 1, 0, interlace=(k, j) == (2, 0)))
            names.append(name)
        id_to_masks[image_id] = names
        samples.append(image_id)
    (split / "train-annotations-object-segmentation_clean.pkl").write_bytes(
        pickle.dumps({"image_id_to_masks": id_to_masks,
                      "dataset_samples": samples}))


WRITERS = {"coco_lvis": _write_coco_lvis, "lvis": _write_lvis,
           "coco": _write_coco, "ade20k": _write_ade20k,
           "openimages": _write_openimages}


def write_trees(root=TREES) -> None:
    from isegprobe_tpu.data.datasets.extended import LvisDataset

    for layout, write in WRITERS.items():
        if (root / layout).exists():
            shutil.rmtree(root / layout)
        write(root / layout)
    LvisDataset(root / "lvis")  # writes train_categories.json


def tree_files(root=TREES) -> list:
    """Every image and mask file of the five trees, relative to ``root``."""
    return sorted(str(p.relative_to(root)) for layout in LAYOUTS
                  for p in (root / layout).rglob("*")
                  if p.suffix in (".jpg", ".png"))


# -- the loaders of both packages ------------------------------------------------

def loader(pkg: str, layout: str, root=TREES, stuff_prob=STUFF_PROB,
           **kw):
    """``layout``'s loader of the JAX package (``pkg="jax"``) or the port,
    with the SBD train augmentations at 224² and the hierarchy sampler."""
    if pkg == "jax":
        from isegprobe_tpu.data import datasets as ds
        from isegprobe_tpu.data.points_sampler import MultiPointSampler

        template, _ = jax_sbd_datasets()
    else:
        from isegprobe_torch.data import datasets as ds
        from isegprobe_torch.data.points_sampler import MultiPointSampler
        from isegprobe_torch.train import sbd_datasets

        template, _ = sbd_datasets(TREES / "sbd")
    kw = dict(augmentator=template.augmentator,
              points_sampler=MultiPointSampler(
                  24, prob_gamma=0.80, merge_objects_prob=0.15,
                  max_num_merged_objects=2, use_hierarchy=True),
              min_object_area=80, keep_background_prob=0.01, **kw)
    root = Path(root)
    if layout == "coco_lvis":
        return ds.CocoLvisDataset(root / layout, stuff_prob=stuff_prob, **kw)
    if layout == "lvis":
        return ds.LvisDataset(root / layout, **kw)
    if layout == "coco":
        return ds.CocoDataset(root / layout, stuff_prob=stuff_prob, **kw)
    if layout == "ade20k":
        return ds.ADE20kDataset(root / layout, stuff_prob=stuff_prob, **kw)
    return ds.OpenImagesDataset(root / layout, **kw)


def composed(pkg: str, root=TREES, **kw):
    """The ``ComposeDataset`` of the five loaders (their own augmentator and
    sampler unused: the composition's run)."""
    if pkg == "jax":
        from isegprobe_tpu.data.compose_dataset import ComposeDataset
    else:
        from isegprobe_torch.data.compose_dataset import ComposeDataset
    members = [loader(pkg, layout, root) for layout in LAYOUTS]
    template = members[0]
    return ComposeDataset(members, augmentator=template.augmentator,
                          points_sampler=template.points_sampler,
                          min_object_area=80, keep_background_prob=0.01,
                          **kw)


def port_items(dataset, seed: int, salt: str, positions) -> list:
    from isegprobe_torch.data.loader import item_seed

    return [dataset.get_item(p, item_seed(seed, zlib.crc32(salt.encode()),
                                          0, p)) for p in positions]


# -- the export --------------------------------------------------------------------

def export_fixture(path=FIXTURE) -> None:
    import cv2

    out = {}
    t0 = time.time()
    names = tree_files()
    out["file_names"] = np.asarray(names)
    out["file_digests"] = np.asarray(
        [pixel_digest(cv2.imread(str(TREES / n))) for n in names])
    out["file_digests_unchanged"] = np.asarray(
        [pixel_digest(cv2.imread(str(TREES / n), cv2.IMREAD_UNCHANGED))
         for n in names])
    for layout in LAYOUTS:
        ds = loader("jax", layout)
        positions = range(len(ds))
        out[f"items_{layout}"] = np.asarray(
            [[item_digest(it) for it in jax_items(ds, seed, layout,
                                                  positions)]
             for seed in ITEM_SEEDS])
    compose = composed("jax")
    out["items_compose"] = np.asarray(
        [[item_digest(it) for it in jax_items(compose, seed, "train",
                                              range(len(compose)))]
         for seed in ITEM_SEEDS])
    print(f"files and items: {time.time() - t0:.1f} s")

    import jax

    from isegprobe_tpu.data.loader import _stack
    from tests.test_torch_training import digest

    # a fresh set: LVIS shuffles an image's annotations in place, so a
    # set's items depend on its earlier draws
    step_items = jax_items(composed("jax"), 0, "train", STEP_POSITIONS)
    out["step_item_digests"] = np.asarray(
        [item_digest(it) for it in step_items])
    batch = _stack(step_items)
    trainset, valset = jax_sbd_datasets()
    trainer = jax_sbd_trainer(STEP_MODEL, jax_sbd_cfg(), trainset, valset)
    rng = jax.random.PRNGKey(1)
    losses = []
    for _ in range(2):
        (trainer.params, trainer.opt_state, loss, _, _, _) = \
            trainer._train_step(trainer.params, trainer.opt_state,
                                trainer._prep_batch(batch), rng, 0, 0.4,
                                0.025, click_trees=())
        losses.append(float(loss))
    dig = digest(jax.device_get(trainer.params["trainable"]))
    out["step_positions"] = np.asarray(STEP_POSITIONS)
    out["step_losses"] = np.asarray(losses)
    out["step_digest_names"] = np.asarray(sorted(dig))
    out["step_digests"] = np.stack([dig[k] for k in sorted(dig)])
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes) in "
          f"{time.time() - t0:.1f} s; step losses {losses}")


# -- tests -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as data:
        return dict(data)


def test_trees_layout_and_formats(fixture):
    """Four images a layout, at most 320×256; progressive JPEGs, an
    interlaced and a 1-bit PNG among the files; the fixture names every
    file, and the trees stay small."""
    import cv2

    names = tree_files()
    assert list(fixture["file_names"]) == names
    jpegs = [n for n in names if n.endswith(".jpg")]
    assert len(jpegs) == 4 * len(LAYOUTS)
    progressive = [n for n in jpegs
                   if b"\xff\xc2" in (TREES / n).read_bytes()]
    assert len(progressive) >= 2
    ihdr = {n: struct.unpack(">IIBBBBB", (TREES / n).read_bytes()[16:29])
            for n in names if n.endswith(".png")}
    assert any(v[6] == 1 for v in ihdr.values())  # Adam7
    assert any(v[2] == 1 for v in ihdr.values())  # 1-bit
    for n in jpegs:
        h, w = cv2.imread(str(TREES / n)).shape[:2]
        assert h <= 256 and w <= 320
    total = sum(p.stat().st_size for layout in LAYOUTS
                for p in (TREES / layout).rglob("*") if p.is_file())
    assert total < 2**20
    assert (TREES / "lvis" / "train_categories.json").exists()


def test_tree_files_decode_to_the_fixture(fixture):
    """Every file in colour (``read_bgr``) and unchanged
    (``read_unchanged``) to ``cv2.imread``'s pixels: the digests the
    export took with OpenCV, and OpenCV here."""
    import cv2

    from isegprobe_torch.data import image_io

    for name, want, want_u in zip(fixture["file_names"],
                                  fixture["file_digests"],
                                  fixture["file_digests_unchanged"]):
        got = image_io.read_bgr(TREES / name)
        assert pixel_digest(got) == want, name
        got_u = image_io.read_unchanged(TREES / name)
        assert pixel_digest(got_u) == want_u, name
        np.testing.assert_array_equal(
            got_u, cv2.imread(str(TREES / name), cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_samples_equal_jax(layout):
    """``get_sample`` of each loader, drawing from a ``random.Random``
    seeded alike on both sides (the JAX loader from the global ``random``):
    images, mask layers, objects and the hierarchy, at two seeds each."""
    import random

    from isegprobe_torch.data import datasets as tds
    from isegprobe_tpu.data import datasets as jds

    cls = {"coco_lvis": "CocoLvisDataset", "lvis": "LvisDataset",
           "coco": "CocoDataset", "ade20k": "ADE20kDataset",
           "openimages": "OpenImagesDataset"}[layout]
    kw = {"stuff_prob": 0.5} if layout in ("coco_lvis", "coco",
                                           "ade20k") else {}
    want_set = getattr(jds, cls)(TREES / layout, **kw)
    got_set = getattr(tds, cls)(TREES / layout, **kw)
    assert len(got_set) == len(want_set) == 4
    for index in range(4):
        for seed in (5, 6):
            random.seed(seed)
            w = want_set.get_sample(index)
            g = got_set.get_sample(index, random.Random(seed))
            np.testing.assert_array_equal(g.image, w.image)
            np.testing.assert_array_equal(g._encoded_masks, w._encoded_masks)
            assert g.objects_ids == w.objects_ids
            assert g.sample_id == w.sample_id
            for obj in w.objects_ids:
                a, b = g.nodes[obj], w.nodes[obj]
                assert (a.mapping, a.parent, a.children) == (
                    b.mapping, b.parent, b.children)
                np.testing.assert_array_equal(g.gt_mask(obj), w.gt_mask(obj))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_items_equal_jax_and_the_fixture(fixture, layout):
    """Each loader's training items (augmentation, hierarchy sampler,
    ``stuff_prob`` 0.3) are the JAX package's process-mode items seed for
    seed: the fixture's digests."""
    ds = loader("torch", layout)
    for row, seed in enumerate(ITEM_SEEDS):
        got = port_items(ds, seed, layout, range(len(ds)))
        assert [item_digest(it) for it in got] == list(
            fixture[f"items_{layout}"][row])


@pytest.mark.parametrize("stuff_prob", [0.0, 1.0])
@pytest.mark.parametrize("layout", ["coco_lvis", "coco", "ade20k"])
def test_stuff_items_equal_jax(layout, stuff_prob):
    """``stuff_prob`` 0 (stuff scrubbed) and 1 (stuff kept): the items
    against the JAX package's, computed here."""
    want_set = loader("jax", layout, stuff_prob=stuff_prob)
    got_set = loader("torch", layout, stuff_prob=stuff_prob)
    positions = range(len(want_set))
    want = jax_items(want_set, 3, layout, positions)
    got = port_items(got_set, 3, layout, positions)
    for w, g in zip(want, got):
        for key in ("images", "points", "instances"):
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


def test_composed_items_equal_the_fixture(fixture):
    """The ``ComposeDataset`` of the five loaders: every item of seeds 0
    and 1 equals the JAX item's digest, through ``get_item`` and through
    the loader's threads."""
    from isegprobe_torch.data.loader import DataLoader

    ds = composed("torch")
    assert len(ds) == 20
    got = port_items(ds, 0, "train", range(len(ds)))
    assert [item_digest(it) for it in got] == list(
        fixture["items_compose"][0])
    loader_ = DataLoader(ds, 4, shuffle=False, num_workers=2, seed=1,
                         salt="train")
    try:
        batches = list(loader_)
    finally:
        loader_.shutdown()
    items = [{k: v[i] for k, v in b.items()} for b in batches
             for i in range(len(b["images"]))]
    assert [item_digest(it) for it in items] == list(
        fixture["items_compose"][1])


def test_lvis_writes_the_categories_as_jax(tmp_path):
    """Without ``train_categories.json`` the LVIS loader writes it into the
    dataset root, byte for byte the JAX loader's file."""
    from isegprobe_torch.data.datasets import LvisDataset
    from isegprobe_tpu.data.datasets import LvisDataset as JLvis

    for side in ("port", "jax"):
        shutil.copytree(TREES / "lvis", tmp_path / side)
        (tmp_path / side / "train_categories.json").unlink()
    LvisDataset(tmp_path / "port")
    JLvis(tmp_path / "jax")
    got = (tmp_path / "port" / "train_categories.json").read_bytes()
    assert got == (tmp_path / "jax" / "train_categories.json").read_bytes()
    assert got == (TREES / "lvis" / "train_categories.json").read_bytes()


def _lvis_rings(rng, h, w):
    """LVIS-like rings: random, non-convex, self-intersecting, partly off
    the image, with fewer than three points."""
    n = int(rng.integers(1, 14))
    cx, cy = rng.uniform(-20, w + 20), rng.uniform(-20, h + 20)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    if rng.random() < 0.3:
        rng.shuffle(ang)  # self-intersecting
    r = rng.uniform(2, max(h, w) * 0.6, n)
    return np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1)


def test_fill_poly_matches_cv2_on_lvis_rings():
    """``raster.fill_poly`` of one ring a call, as the loaders call
    ``cv2.fillPoly(mask, pts[None], 1)``, on 300 LVIS-like rings."""
    import cv2

    from isegprobe_torch.data import raster

    rng = np.random.default_rng(0)
    for _ in range(300):
        h, w = int(rng.integers(20, 90)), int(rng.integers(20, 90))
        pts = np.round(_lvis_rings(rng, h, w)).astype(np.int32)
        want = np.zeros((h, w), np.int32)
        cv2.fillPoly(want, pts[None], 1)
        got = np.zeros((h, w), np.int32)
        raster.fill_poly(got, pts, 1)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


def test_fixture_step_batch_covers_every_loader(fixture):
    """The step batch draws on every loader and is a fresh composed set's
    items, as the port builds them."""
    assert tuple(fixture["step_positions"]) == STEP_POSITIONS
    assert {p // 4 for p in STEP_POSITIONS} == set(range(len(LAYOUTS)))
    got = port_items(composed("torch"), 0, "train", STEP_POSITIONS)
    assert [item_digest(it) for it in got] == list(
        fixture["step_item_digests"])
    assert np.isfinite(fixture["step_losses"]).all()
    assert len(fixture["step_digest_names"]) == len(fixture["step_digests"])


if __name__ == "__main__":
    if "--export" not in sys.argv[1:]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_extended.py"
                 " --export")
    t0 = time.time()
    write_trees()
    export_fixture()
    print(f"export: {time.time() - t0:.1f} s")
