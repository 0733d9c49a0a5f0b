"""The port's dataset loaders against the JAX package's, on small trees in
each dataset's on-disk layout: ``isegprobe_torch/fixtures/datasets/``.

The trees hold Synthetic scenes (the port's ``render_scene``) rendered at
the real datasets' sizes and written as those datasets ship them:

* ``sbd/``: ``img/*.jpg``, ``inst/*.mat`` (a ``GTinst`` struct whose first
  field is ``Segmentation``; one train image carries a one-pixel sliver
  that the thin-instance scrub removes), ``train.txt`` (8 names),
  ``val.txt`` (2) and both ``<split>_images_and_ids_list.pkl`` caches;
* ``grabcut/``: ``data_GT`` (two JPEGs, one of them grayscale, and one BMP
  image) and ``boundary_GT`` (8-bit BMP masks: 255 the object, 128 the
  ignore band, 0 the rest);
* ``berkeley/``: ``images`` (one with the EXIF orientation tag 6, written
  with PIL) and ``masks`` (gray PNGs in GrabCut's encoding);
* ``davis/``: ``img`` (854×480; one JPEG at 4:4:4) and ``gt`` (PNG);
* ``pascalvoc/``: ``JPEGImages``, ``SegmentationObject`` (palette PNGs with
  VOC's palette and a 255 border, written with PIL) and
  ``ImageSets/Segmentation/test.pickle``.

One SBD val JPEG has a restart interval. The sizes include 500×375,
375×500, 481×321 and 854×480.

``isegprobe_torch/fixtures/datasets.npz`` holds what the GPU machine
(no JAX, no OpenCV) checks against:

* ``file_names`` / ``file_digests``: sha256 of ``cv2.imread``'s pixels of
  every image and mask file of the trees;
* ``items_*``: sha256 of the JAX package's process-mode items (images,
  points, instances) of the SBD train and val sets
  (``models/defaults.py:get_sbd_train_val_datasets`` on the tree) for
  seeds 0 and 1 at positions 0-7 (``item_seed(seed, crc32(split), 0,
  position)``, index = position);
* ``step_<model>_losses`` / ``step_<model>_digests``: the JAX trainer's
  first two step losses and its trainable leaves' digests for
  ``models/sbd/dinov2/patch-embed_noup.py`` and ``patch-embed_bilinear.py``
  from ``PRNGKey(0)`` at batch 8, 224², num_iters=0, on the train items
  of seed 0 (``step_digest_names`` names the leaves);
* ``eval_<dataset>_ious`` / ``_n`` / ``_clicks``: the JAX f32 device
  evaluator on the trained flagship with ``synthetic2026_50.npz``'s
  protocol (fixed 448², flip, at most 20 clicks, stopping at IoU 0.9),
  batch 1, on every object of the five evaluation trees (SBD's val
  split, GrabCut, Berkeley, DAVIS, PascalVOC's test split).

Write both with ``JAX_PLATFORMS=cpu python tests/test_torch_datasets.py
--export`` (the seconds it took are in CHANGES.md). The tests read the
committed trees and copy a tree to ``tmp_path`` where a cache is written.
"""

from __future__ import annotations

import hashlib
import pickle
import shutil
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TREES = REPO / "isegprobe_torch" / "fixtures" / "datasets"
FIXTURE = REPO / "isegprobe_torch" / "fixtures" / "datasets.npz"
FLAGSHIP_CKPT = REPO / "assets" / "trained" / "synthetic_dinov2_noup_160ep.ckpt"
EVAL_DATASETS = ("SBD", "GrabCut", "Berkeley", "DAVIS", "PascalVOC")
DATASET_DIRS = {"SBD": "sbd", "GrabCut": "grabcut", "Berkeley": "berkeley",
                "DAVIS": "davis", "PascalVOC": "pascalvoc"}
ITEM_SEEDS = (0, 1)
ITEM_POSITIONS = tuple(range(8))
STEP_MODELS = ("sbd_dinov2_noup", "sbd_dinov2_bilinear")
STEP_SCRIPTS = {"sbd_dinov2_noup": "patch-embed_noup.py",
                "sbd_dinov2_bilinear": "patch-embed_bilinear.py"}
EVAL_CLICKS = 20

SBD_TRAIN = [("2008_000002", 375, 500), ("2008_000003", 500, 375),
             ("2008_000007", 333, 500), ("2008_000008", 375, 500),
             ("2008_000009", 500, 375), ("2008_000015", 366, 500),
             ("2008_000016", 375, 500), ("2008_000019", 334, 500)]
SBD_VAL = [("2008_000021", 375, 500), ("2008_000023", 500, 375)]
SLIVER_IMAGE = "2008_000003"
RESTART_IMAGE = "2008_000021"


def dataset_paths(root=TREES) -> dict:
    """The evaluate CLI's path keys for the trees under ``root``."""
    root = Path(root)
    return {"DATASETS.SBD_PATH": str(root / "sbd"),
            "DATASETS.GRABCUT_PATH": str(root / "grabcut"),
            "DATASETS.BERKELEY_PATH": str(root / "berkeley"),
            "DATASETS.DAVIS_PATH": str(root / "davis"),
            "DATASETS.PASCALVOC_PATH": str(root / "pascalvoc")}


# -- writing the trees (the export only) ---------------------------------------

def _scene(seed: int, h: int, w: int, n_shapes: int = 3):
    from isegprobe_torch.data.datasets.synthetic import render_scene

    return render_scene(np.random.default_rng(seed), (h, w), n_shapes)


def _largest(labels: np.ndarray) -> np.ndarray:
    from isegprobe_torch.utils.misc import get_labels_with_sizes

    ids, sizes = get_labels_with_sizes(labels)
    return labels == ids[int(np.argmax(sizes))]


def _band_mask(obj: np.ndarray, width: int = 3) -> np.ndarray:
    """GrabCut's encoding: 255 inside, 128 a band about the boundary."""
    from scipy import ndimage

    grown = ndimage.binary_dilation(obj, iterations=width)
    core = ndimage.binary_erosion(obj, iterations=width)
    out = np.zeros(obj.shape, np.uint8)
    out[grown] = 128
    out[core] = 255
    return out


def voc_palette() -> np.ndarray:
    """PASCAL VOC's colour map, [256, 3] RGB."""
    cmap = np.zeros((256, 3), np.uint8)
    for i in range(256):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def _jpeg(path, rgb, quality=85, extra=()):
    import cv2

    bgr = rgb[:, :, ::-1] if rgb.ndim == 3 else rgb
    assert cv2.imwrite(str(path), np.ascontiguousarray(bgr),
                       [cv2.IMWRITE_JPEG_QUALITY, quality, *extra])


def write_trees(root=TREES) -> None:
    import cv2
    from PIL import Image
    from scipy.io import savemat

    root = Path(root)
    if root.exists():
        shutil.rmtree(root)
    # SBD
    sbd = root / "sbd"
    (sbd / "img").mkdir(parents=True)
    (sbd / "inst").mkdir()
    for k, (name, h, w) in enumerate(SBD_TRAIN + SBD_VAL):
        image, labels = _scene(100 + k, h, w, n_shapes=2 + k % 2)
        if name == SLIVER_IMAGE:
            n = np.arange(min(h, w) // 2)
            labels[n + h // 4, n + w // 4] = labels.max() + 1
        extra = ([cv2.IMWRITE_JPEG_RST_INTERVAL, 4] if name == RESTART_IMAGE
                 else [])
        _jpeg(sbd / "img" / f"{name}.jpg", image, extra=extra)
        n_inst = int(labels.max())
        savemat(str(sbd / "inst" / f"{name}.mat"), {"GTinst": {
            "Segmentation": labels.astype(np.uint8),
            "Categories": np.arange(1, n_inst + 1, dtype=np.uint8)[:, None],
        }}, do_compression=True)
    (sbd / "train.txt").write_text("".join(f"{n}\n" for n, _, _ in SBD_TRAIN))
    (sbd / "val.txt").write_text("".join(f"{n}\n" for n, _, _ in SBD_VAL))
    # GrabCut: a colour and a grayscale JPEG, one BMP image
    gc = root / "grabcut"
    (gc / "data_GT").mkdir(parents=True)
    (gc / "boundary_GT").mkdir()
    for k, (name, h, w, kind) in enumerate([
            ("banana1", 213, 320, "jpg"), ("cross", 320, 213, "gray"),
            ("llama", 160, 240, "bmp")]):
        image, labels = _scene(200 + k, h, w)
        if kind == "jpg":
            _jpeg(gc / "data_GT" / f"{name}.jpg", image)
        elif kind == "gray":
            gray = cv2.cvtColor(image[:, :, ::-1], cv2.COLOR_BGR2GRAY)
            _jpeg(gc / "data_GT" / f"{name}.jpg", gray)
        else:
            cv2.imwrite(str(gc / "data_GT" / f"{name}.bmp"),
                        np.ascontiguousarray(image[:, :, ::-1]))
        cv2.imwrite(str(gc / "boundary_GT" / f"{name}.bmp"),
                    _band_mask(_largest(labels)))
    # Berkeley (BSDS sizes); the second image carries EXIF orientation 6
    bk = root / "berkeley"
    (bk / "images").mkdir(parents=True)
    (bk / "masks").mkdir()
    for k, (name, h, w) in enumerate([("101087", 321, 481),
                                      ("126007", 481, 321)]):
        image, labels = _scene(300 + k, h, w)
        if k == 1:
            # stored so that the orientation's transpose + horizontal flip
            # gives the scene back
            stored = np.ascontiguousarray(image[:, ::-1].transpose(1, 0, 2))
            exif = Image.Exif()
            exif[0x0112] = 6
            Image.fromarray(stored).save(bk / "images" / f"{name}.jpg",
                                         quality=85, exif=exif.tobytes())
        else:
            _jpeg(bk / "images" / f"{name}.jpg", image)
        cv2.imwrite(str(bk / "masks" / f"{name}.png"),
                    _band_mask(_largest(labels)))
    # DAVIS at 854x480; the first JPEG at 4:4:4
    dv = root / "davis"
    (dv / "img").mkdir(parents=True)
    (dv / "gt").mkdir()
    for k, name in enumerate(["bear", "dog"]):
        image, labels = _scene(400 + k, 480, 854)
        extra = ([cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444] if k == 0 else [])
        _jpeg(dv / "img" / f"{name}.jpg", image, quality=75, extra=extra)
        cv2.imwrite(str(dv / "gt" / f"{name}.png"),
                    (_largest(labels) * 255).astype(np.uint8))
    # PASCAL VOC: palette PNGs, the test split's (image, instance) pairs
    voc = root / "pascalvoc"
    for sub in ("JPEGImages", "SegmentationObject", "ImageSets/Segmentation"):
        (voc / sub).mkdir(parents=True)
    from isegprobe_torch.data.image_io import bgr_to_gray

    palette = voc_palette()
    gray_of = bgr_to_gray(palette[None, :, ::-1])[0]
    names, ids = [], []
    for k, (name, h, w) in enumerate([("2007_000033", 366, 500),
                                      ("2007_000129", 500, 375)]):
        image, labels = _scene(500 + k, h, w, n_shapes=3)
        _jpeg(voc / "JPEGImages" / f"{name}.jpg", image)
        index = labels.astype(np.uint8)
        from scipy import ndimage

        edge = np.zeros(labels.shape, bool)
        for lab in np.unique(labels[labels > 0]):
            obj = labels == lab
            edge |= ndimage.binary_dilation(obj, iterations=2) & ~obj
        index[edge] = 255
        im = Image.fromarray(index, "P")
        im.putpalette(palette.reshape(-1).tolist())
        im.save(voc / "SegmentationObject" / f"{name}.png")
        for lab in np.unique(index):
            if lab not in (0, 255) and (index == lab).sum() > 0:
                names.append(name)
                ids.append(int(gray_of[lab]))
    (voc / "ImageSets/Segmentation/test.pickle").write_bytes(
        pickle.dumps((names, ids)))
    # the SBD evaluation caches, written by the JAX loader itself
    from isegprobe_tpu.data.datasets import SBDEvaluationDataset

    for split in ("train", "val"):
        SBDEvaluationDataset(sbd, split=split)


# -- digests --------------------------------------------------------------------

def pixel_digest(array: np.ndarray) -> str:
    a = np.ascontiguousarray(array)
    return hashlib.sha256(f"{a.dtype}{a.shape}".encode()
                          + a.tobytes()).hexdigest()


def item_digest(item: dict) -> str:
    h = hashlib.sha256()
    for key in ("images", "points", "instances"):
        a = np.ascontiguousarray(item[key])
        h.update(f"{key}{a.dtype}{a.shape}".encode() + a.tobytes())
    return h.hexdigest()


def tree_files(root=TREES):
    """Every image and mask file of the trees, relative to ``root``."""
    root = Path(root)
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.suffix in (".jpg", ".png", ".bmp"))


# -- the JAX side (the export and the CPU tests) ----------------------------------

def jax_sbd_cfg(path=TREES / "sbd"):
    from isegprobe_tpu.utils.config import EDict

    return EDict.convert(dict(
        dataloader=dict(batch_size=8, val_batch_size=8, workers=2, mp=False),
        training_params=dict(crop_size=[224, 224], num_max_points=24,
                             lr_milestones=[17, 20], epochs=20,
                             checkpoint_interval=[[0, 3], [15, 1]]),
        training=dict(seed=0, start_epoch=0, weights=None),
        DATASETS=dict(SBD_PATH=str(path)), CHECKPOINTS_PATH="/nonexistent"))


def jax_sbd_datasets(path=TREES / "sbd"):
    from models.defaults import get_sbd_train_val_datasets

    return get_sbd_train_val_datasets(jax_sbd_cfg(path))


def jax_items(dataset, seed, salt, positions):
    from isegprobe_tpu.data import loader as jl

    jl._process_worker_init(dataset, seed, zlib.crc32(salt.encode()))
    return [jl._process_worker_get(0, p, p) for p in positions]


def jax_sbd_trainer(model_key, cfg, trainset, valset):
    import importlib.util

    from isegprobe_tpu.parallel.mesh import make_mesh
    from isegprobe_tpu.training.metrics import AdaptiveIoU
    from isegprobe_tpu.training.trainer import iSegTrainer
    from models.common import init_model_from_modules_cfg
    from models.defaults import get_loss_cfg, get_optimizer_cfg

    spec = importlib.util.spec_from_file_location(
        f"isegprobe_models_{model_key}",
        REPO / "models" / "sbd" / "dinov2" / STEP_SCRIPTS[model_key])
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    model = init_model_from_modules_cfg(script.define_modules_cfg(cfg), cfg)
    name, opt = get_optimizer_cfg(cfg)
    return iSegTrainer(
        model, cfg, get_loss_cfg(cfg), trainset, valset, optimizer=name,
        optimizer_params=opt,
        lr_scheduler={"milestones": cfg.training_params.lr_milestones,
                      "gamma": 0.1},
        metrics=[AdaptiveIoU()], max_interactive_points=24,
        max_num_next_clicks=3, seed=0, mesh=make_mesh(n_devices=1))


def jax_eval_dataset(name, root=TREES):
    from isegprobe_tpu.data.datasets import (
        BerkeleyDataset,
        DavisDataset,
        GrabCutDataset,
        PascalVocDataset,
        SBDEvaluationDataset,
    )

    root = Path(root)
    return {"SBD": lambda: SBDEvaluationDataset(root / "sbd"),
            "GrabCut": lambda: GrabCutDataset(root / "grabcut"),
            "Berkeley": lambda: BerkeleyDataset(root / "berkeley"),
            "DAVIS": lambda: DavisDataset(root / "davis"),
            "PascalVOC": lambda: PascalVocDataset(root / "pascalvoc",
                                                  split="test")}[name]()


def port_eval_dataset(name, root=TREES):
    from isegprobe_torch.evaluate import get_dataset

    return get_dataset(name, dataset_paths(root))


def export_fixture(path=FIXTURE, parts=("files", "items", "steps", "eval")):
    import cv2

    out = {}
    if path.exists():
        with np.load(path) as old:
            out.update(old)
    t0 = time.time()
    if "files" in parts:
        names = tree_files()
        out["file_names"] = np.asarray(names)
        out["file_digests"] = np.asarray(
            [pixel_digest(cv2.imread(str(TREES / n))) for n in names])
    trainset, valset = jax_sbd_datasets()
    if "items" in parts:
        for split, ds in (("train", trainset), ("val", valset)):
            out[f"items_{split}"] = np.asarray(
                [[item_digest(it) for it in jax_items(ds, seed, split,
                                                      ITEM_POSITIONS)]
                 for seed in ITEM_SEEDS])
    print(f"files and items: {time.time() - t0:.1f} s")
    if "steps" in parts:
        import jax

        from isegprobe_tpu.data.loader import _stack
        from tests.test_torch_training import digest

        batch = _stack(jax_items(trainset, 0, "train", ITEM_POSITIONS))
        for key in STEP_MODELS:
            t1 = time.time()
            cfg = jax_sbd_cfg()
            trainer = jax_sbd_trainer(key, cfg, trainset, valset)
            rng = jax.random.PRNGKey(1)
            losses = []
            for _ in range(2):
                (trainer.params, trainer.opt_state, loss, _, _, _) = \
                    trainer._train_step(trainer.params, trainer.opt_state,
                                        trainer._prep_batch(batch), rng, 0,
                                        0.4, 0.025, click_trees=())
                losses.append(float(loss))
            dig = digest(jax.device_get(trainer.params["trainable"]))
            out["step_digest_names"] = np.asarray(sorted(dig))
            out[f"step_{key}_losses"] = np.asarray(losses)
            out[f"step_{key}_digests"] = np.stack(
                [dig[k] for k in sorted(dig)])
            print(f"{key}: losses {losses} in {time.time() - t1:.1f} s")
    if "eval" in parts:
        from tests.test_torch_fixtures import jax_device_run

        for name in EVAL_DATASETS:
            t1 = time.time()
            ious, n, clicks = jax_device_run(
                FLAGSHIP_CKPT, jax_eval_dataset(name), batch_size=1,
                max_clicks=EVAL_CLICKS)
            out[f"eval_{name}_ious"] = ious
            out[f"eval_{name}_n"] = n
            out[f"eval_{name}_clicks"] = clicks
            print(f"{name}: {len(n)} objects in {time.time() - t1:.1f} s")
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes) in "
          f"{time.time() - t0:.1f} s")


# -- tests ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as data:
        return dict(data)


def _marker_file(path):
    return Path(path).read_bytes()


def test_trees_layout_and_size():
    total = sum(p.stat().st_size for p in TREES.rglob("*") if p.is_file())
    assert total < 2 * 2**20
    sbd = TREES / "sbd"
    assert len((sbd / "train.txt").read_text().split()) == 8
    assert len((sbd / "val.txt").read_text().split()) == 2
    for split in ("train", "val"):
        assert (sbd / f"{split}_images_and_ids_list.pkl").exists()
    from scipy.io import loadmat

    gt = loadmat(str(sbd / "inst" / f"{SLIVER_IMAGE}.mat"))["GTinst"]
    assert gt.dtype.names[0] == "Segmentation"
    from isegprobe_torch.data import image_io

    sizes = {image_io.read_bgr(TREES / n).shape[:2] for n in tree_files()}
    assert {(375, 500), (500, 375), (321, 481), (480, 854)} <= sizes
    # the JPEG variants: a restart interval, 4:4:4, one component, EXIF
    assert b"\xff\xdd" in _marker_file(sbd / "img" / f"{RESTART_IMAGE}.jpg")
    sof = _marker_file(TREES / "davis/img/bear.jpg")
    at = sof.index(b"\xff\xc0")
    assert sof[at + 9] == 3 and sof[at + 11] == sof[at + 14] == 0x11
    gray = _marker_file(TREES / "grabcut/data_GT/cross.jpg")
    assert gray[gray.index(b"\xff\xc0") + 9] == 1
    assert b"Exif" in _marker_file(TREES / "berkeley/images/126007.jpg")
    assert (TREES / "grabcut/data_GT/llama.bmp").exists()


def test_tree_files_decode_to_the_fixture(fixture):
    """Every file decodes to ``cv2.imread``'s pixels: the digests the
    export took with OpenCV, and OpenCV here."""
    import cv2

    from isegprobe_torch.data import image_io

    assert list(fixture["file_names"]) == tree_files()
    for name, want in zip(fixture["file_names"], fixture["file_digests"]):
        got = image_io.read_bgr(TREES / name)
        assert pixel_digest(got) == want, name
        np.testing.assert_array_equal(got, cv2.imread(str(TREES / name)))


LOADERS = {
    "GrabCut": lambda m, r: m.GrabCutDataset(r / "grabcut"),
    "Berkeley": lambda m, r: m.BerkeleyDataset(r / "berkeley"),
    "DAVIS": lambda m, r: m.DavisDataset(r / "davis"),
    "SBD_train": lambda m, r: m.SBDDataset(r / "sbd"),
    "SBD_val": lambda m, r: m.SBDDataset(r / "sbd", split="val",
                                         buggy_mask_thresh=0),
    "SBDEvaluation": lambda m, r: m.SBDEvaluationDataset(r / "sbd"),
    "SBDEvaluation_train": lambda m, r: m.SBDEvaluationDataset(
        r / "sbd", split="train"),
    "PascalVOC": lambda m, r: m.PascalVocDataset(r / "pascalvoc",
                                                 split="test"),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_samples_equal_jax(name):
    from isegprobe_torch.data import datasets as tds
    from isegprobe_tpu.data import datasets as jds

    want = LOADERS[name](jds, TREES)
    got = LOADERS[name](tds, TREES)
    assert got.dataset_samples == want.dataset_samples
    assert len(got) == len(want) > 0
    for index in range(len(want.dataset_samples)):
        w, g = want.get_sample(index), got.get_sample(index)
        assert g.image.dtype == np.uint8 and g.image.shape == w.image.shape
        np.testing.assert_array_equal(g.image, w.image)
        np.testing.assert_array_equal(g._encoded_masks, w._encoded_masks)
        assert g.objects_ids == w.objects_ids
        assert g._ignored == w._ignored
        assert g.sample_id == w.sample_id
        for obj in w.objects_ids:
            np.testing.assert_array_equal(g.gt_mask(obj), w.gt_mask(obj))


def test_thin_instance_scrub():
    """The sliver of the SBD train tree is scrubbed, by both packages."""
    from isegprobe_torch.data.datasets import SBDDataset
    from isegprobe_torch.data.datasets.standard import _load_sbd_mask

    ds = SBDDataset(TREES / "sbd")
    index = ds.dataset_samples.index(SLIVER_IMAGE)
    raw = _load_sbd_mask(TREES / "sbd" / "inst" / f"{SLIVER_IMAGE}.mat")
    sample = ds.get_sample(index)
    assert ds._thin_cache[index] == [int(raw.max())]
    assert len(sample.objects_ids) == len(np.unique(raw)) - 2


def test_sbd_evaluation_cache_round_trip(tmp_path):
    """The port writes ``<split>_images_and_ids_list.pkl`` as the JAX
    package does (bytes equal), and each reads the other's."""
    from isegprobe_torch.data.datasets import SBDEvaluationDataset as T
    from isegprobe_tpu.data.datasets import SBDEvaluationDataset as J

    shutil.copytree(TREES / "sbd", tmp_path / "port")
    shutil.copytree(TREES / "sbd", tmp_path / "jax")
    for split in ("train", "val"):
        for d in ("port", "jax"):
            (tmp_path / d / f"{split}_images_and_ids_list.pkl").unlink()
        got = T(tmp_path / "port", split=split).dataset_samples
        want = J(tmp_path / "jax", split=split).dataset_samples
        assert got == want
        cache = f"{split}_images_and_ids_list.pkl"
        assert (tmp_path / "port" / cache).read_bytes() == (
            tmp_path / "jax" / cache).read_bytes() == (
            TREES / "sbd" / cache).read_bytes()
        assert J(tmp_path / "port", split=split).dataset_samples == want


@pytest.mark.parametrize("split", ["train", "val"])
def test_sbd_items_equal_jax_process_items(fixture, split):
    """The train CLI's SBD sets (``train.sbd_datasets``) give the JAX
    package's process-mode items seed for seed, and the fixture's
    digests."""
    from isegprobe_torch.data.loader import item_seed
    from isegprobe_torch.train import sbd_datasets

    jtrain, jval = jax_sbd_datasets()
    ttrain, tval = sbd_datasets(TREES / "sbd")
    jset, tset = (jtrain, ttrain) if split == "train" else (jval, tval)
    assert (len(tset), tset.epoch_len) == (len(jset), jset.epoch_len)
    salt = zlib.crc32(split.encode())
    for row, seed in enumerate(ITEM_SEEDS):
        want = jax_items(jset, seed, split, ITEM_POSITIONS)
        for pos, w in zip(ITEM_POSITIONS, want):
            got = tset.get_item(pos, item_seed(seed, salt, 0, pos))
            for key in ("images", "points", "instances"):
                assert got[key].dtype == w[key].dtype
                np.testing.assert_array_equal(got[key], w[key])
            assert item_digest(got) == fixture[f"items_{split}"][row][pos]


@pytest.mark.parametrize("kind", ["compose", "proportional"])
def test_compose_datasets_equal_jax(kind):
    """A concatenation and a mixture of the SBD and GrabCut trees under
    the train augmentations: the JAX process-mode items seed for seed."""
    from isegprobe_torch.data import compose_dataset as tc
    from isegprobe_torch.data import datasets as tds
    from isegprobe_torch.data.loader import item_seed
    from isegprobe_tpu.data import compose_dataset as jc
    from isegprobe_tpu.data import datasets as jds

    jtrain, _ = jax_sbd_datasets()
    from isegprobe_torch.train import sbd_datasets

    ttrain, _ = sbd_datasets(TREES / "sbd")

    def build(c, ds, template):
        members = [ds.SBDDataset(TREES / "sbd"),
                   ds.GrabCutDataset(TREES / "grabcut")]
        kw = dict(augmentator=template.augmentator,
                  points_sampler=template.points_sampler,
                  min_object_area=80, keep_background_prob=0.01)
        if kind == "compose":
            return c.ComposeDataset(members, **kw)
        return c.ProportionalComposeDataset(members, [0.6, 0.4], **kw)

    want_set, got_set = build(jc, jds, jtrain), build(tc, tds, ttrain)
    assert len(got_set) == len(want_set) == 11
    positions = list(range(len(want_set)))
    salt = zlib.crc32(b"train")
    for seed in (0, 3):
        want = jax_items(want_set, seed, "train", positions)
        for pos, w in zip(positions, want):
            got = got_set.get_item(pos, item_seed(seed, salt, 0, pos))
            assert item_digest(got) == item_digest(w), (seed, pos)
    with pytest.raises(ValueError, match="sum to 1"):
        tc.ProportionalComposeDataset([ttrain], [0.5])
    with pytest.raises(ValueError, match="one mixing ratio"):
        tc.ProportionalComposeDataset([ttrain], [0.5, 0.5])


def test_loader_batches_equal_for_threads_and_processes():
    """Batches do not depend on the workers: none, 2 threads, 2 spawned
    processes (``dataloader.mp``)."""
    from isegprobe_torch.data.loader import DataLoader
    from isegprobe_torch.train import sbd_datasets

    trainset, _ = sbd_datasets(TREES / "sbd", epoch_len=8)
    runs = []
    for workers, procs in ((0, False), (2, False), (2, True)):
        loader = DataLoader(trainset, 4, num_workers=workers, seed=0,
                            salt="train", use_processes=procs)
        try:
            runs.append([b for _ in range(2) for b in loader])
        finally:
            loader.shutdown()
    assert len(runs[0]) == 4
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert sorted(a) == sorted(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


def test_fixture_evaluation_is_consistent(fixture):
    """Every object of the five trees: its clicks up to its count, the
    first positive, a stop only at IoU 0.9 or at 20 clicks."""
    for name in EVAL_DATASETS:
        n = fixture[f"eval_{name}_n"]
        ious = fixture[f"eval_{name}_ious"]
        clicks = fixture[f"eval_{name}_clicks"]
        assert len(n) == len(port_eval_dataset(name)) > 0
        assert ious.shape == (len(n), EVAL_CLICKS)
        assert ((ious >= 0) & (ious <= 1)).all()
        for i, k in enumerate(n):
            assert 1 <= k <= EVAL_CLICKS and clicks[i, 0, 2] == 1
            assert (clicks[i, :k, 2] >= 0).all() and (clicks[i, k:] == -1).all()
            assert (ious[i, :k - 1] < 0.9).all()
            assert ious[i, k - 1] >= 0.9 or k == EVAL_CLICKS


def test_evaluate_cli_datasets_and_zoomin_per_dataset(monkeypatch):
    """Every key of the root's ``get_dataset`` builds its loader from its
    path key; ``evaluate_all`` runs datasets × checkpoint with each
    dataset's ZoomIn (DAVIS at 672² under ``cvpr``), loading the
    checkpoint once a size and drawing its frozen parts once; an unknown
    key raises."""
    from isegprobe_torch import evaluate as ev
    from isegprobe_torch.data import datasets as tds
    from isegprobe_torch.data.scenes import SceneDataset

    paths = dict(dataset_paths(), **{
        "DATASETS.COCO_MVAL_PATH": str(TREES / "davis")})
    cfg = ev.parse_args(["checkpoint=x", "eval_mode=cvpr", "datasets="
                         "GrabCut,Berkeley,DAVIS,SBD,SBD_Train,PascalVOC,"
                         "COCO_MVal,Synthetic",
                         *(f"{k}={v}" for k, v in paths.items())])
    kinds = {"GrabCut": tds.GrabCutDataset, "Berkeley": tds.BerkeleyDataset,
             "DAVIS": tds.DavisDataset, "SBD": tds.SBDEvaluationDataset,
             "SBD_Train": tds.SBDEvaluationDataset,
             "PascalVOC": tds.PascalVocDataset,
             "COCO_MVal": tds.DavisDataset, "Synthetic": SceneDataset}
    for name in cfg["dataset_names"]:
        ds = ev.get_dataset(name, cfg)
        assert type(ds) is kinds[name] and len(ds) > 0
    assert ev.get_dataset("SBD_Train", cfg).dataset_split == "train"
    loads, runs = [], []
    frozens = []

    def load(ckpt, dtype, size, device, eval_ritm, frozen, **layout):
        # LoftUp's fused head, at the command line's default (the padded
        # layout follows the dtype inside load_model_for_eval)
        assert layout == {"fuse_hr_head": False}
        loads.append(size)
        frozens.append(frozen)
        return size, {"frozen": frozen or {"drawn": size}}

    monkeypatch.setattr(ev, "load_model_for_eval", load)
    monkeypatch.setattr(ev, "evaluate", lambda cfg, model, name: (
        runs.append((name, model)) or {"dataset": name}))
    cfg["device"] = "cpu"
    out = ev.evaluate_all(cfg)
    assert [r["dataset"] for r in out] == cfg["dataset_names"]
    assert loads == [(448, 448), (672, 672), (448, 448)]
    # the frozen parts are drawn by the first load only
    assert frozens == [None, {"drawn": (448, 448)}, {"drawn": (448, 448)}]
    assert dict(runs)["DAVIS"] == (672, 672)
    assert dict(runs)["SBD"] == (448, 448)
    with pytest.raises(NotImplementedError, match="Dataset key"):
        ev.parse_args(["checkpoint=x", "datasets=GrabCut,ImageNet"])


def test_load_model_for_eval_reuses_frozen_parts():
    """A load with an earlier load's frozen parts (at another size, in
    another dtype) builds the model a fresh load builds, bitwise."""
    import torch

    from isegprobe_torch.evaluate import load_model_for_eval

    _, info = load_model_for_eval(str(FLAGSHIP_CKPT), torch.float32,
                                  (112, 112), device="cpu")
    assert sorted(info["frozen"]) == ["backbone"]
    for dtype in (torch.float32, torch.bfloat16):
        fresh, fresh_info = load_model_for_eval(
            str(FLAGSHIP_CKPT), dtype, (224, 224), device="cpu")
        reused, reused_info = load_model_for_eval(
            str(FLAGSHIP_CKPT), dtype, (224, 224), device="cpu",
            frozen=info["frozen"])
        assert reused_info["frozen_params"] == fresh_info["frozen_params"]
        want = fresh.state_dict()
        got = reused.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_evaluate_cli_on_the_trees(fixture):
    """``python -m isegprobe_torch.evaluate datasets=GrabCut,Berkeley,
    DAVIS,SBD,PascalVOC`` on the CPU, 3 clicks of the host protocol (each
    run, the CLI's default): the JAX fixture's IoUs of every object up to
    3 clicks or its stop (within 1e-3)."""
    from isegprobe_torch.evaluate import evaluate_all, parse_args

    args = [f"checkpoint={FLAGSHIP_CKPT}", "device=cpu", "n_clicks=3",
            "eval_mode=fixed448",
            "datasets=GrabCut,Berkeley,DAVIS,SBD,PascalVOC",
            *(f"{k}={v}" for k, v in dataset_paths().items())]
    results = evaluate_all(parse_args(args))
    assert [r["dataset"] for r in results] == [
        "GrabCut", "Berkeley", "DAVIS", "SBD", "PascalVOC"]
    for r in results:
        want = fixture[f"eval_{r['dataset']}_ious"]
        n = fixture[f"eval_{r['dataset']}_n"]
        assert len(r["all_ious"]) == len(n), r["dataset"]
        for got, want_i, k in zip(r["all_ious"], want, n):
            assert len(got) == 3
            k = min(3, int(k))
            np.testing.assert_allclose(got[:k], want_i[:k], rtol=0,
                                       atol=1e-3, err_msg=r["dataset"])
        assert r["dataset"] in r["table"]


if __name__ == "__main__":
    if "--export" not in sys.argv[1:]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_datasets.py"
                 " --export")
    t0 = time.time()
    write_trees()
    export_fixture()
    print(f"export: {time.time() - t0:.1f} s")
