"""What an evaluation of the port leaves behind, against the JAX package:
``inference/eval_utils.py`` (the prediction and feature dumps, the IoU
pickle, checkpoint discovery, the wandb summary) against the JAX
functions, the feature probe ``get_lowres_highres_feats`` of the model and
of the predictor against JAX's on small drawn probes (the flagship, with
the RITM transform too, LoftUp, JBU and LiFT; f32), and the evaluate CLI
with every output key against the root CLI's files, stored in the fixture
``isegprobe_torch/fixtures/eval_outputs.npz``.

The fixture holds, from the root ``evaluate.py`` on the CPU:

* ``cpu_*``: the run this file repeats (``CPU_ARGS`` on the GrabCut tree
  of ``fixtures/datasets``): its files (the feature folder's date as
  ``DATE``), the sha256 of each JPEG, JSON and pickle (empty for the
  rest), ``results.txt`` with the time columns blanked, and of each ``.npy`` its shape, largest
  magnitude and ``NPY_SAMPLE`` seeded entries;
* ``card_*``: the files and ``results.txt`` lines of ``CARD_ARGS`` (the
  GrabCut, Berkeley and DAVIS trees at 448², 20 clicks), which
  ``chip_smoke.py`` phase 11k repeats on the card;
* ``feats_<model>_<k>_<map>_*``: the first-click ``get_lowres_highres_feats``
  of JAX's predictor (448² ZoomIn) on object ``k`` of the first 2 of
  ``synthetic2026_50.npz`` for the trained flagship and LoftUp: each map's
  shape, largest magnitude, mean and standard deviation over the whole map
  and ``FEATS_SAMPLE`` seeded entries (a whole 32 x 32 x 384 LowRes is
  1.5 MB, so the maps are sampled to keep the fixture small).

Rewrite it with ``JAX_PLATFORMS=cpu python tests/test_torch_eval_outputs.py
--export`` (about 11 minutes on an 8-core CPU)."""

import hashlib
import json
import os
import pickle
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

FIXTURE = REPO / "isegprobe_torch" / "fixtures" / "eval_outputs.npz"
TREES = REPO / "isegprobe_torch" / "fixtures" / "datasets"
TRAINED = REPO / "assets" / "trained"
CKPTS = {"flagship": TRAINED / "synthetic_dinov2_noup_160ep.ckpt",
         "loftup": TRAINED / "synthetic_dinov2_loftup448_160ep.ckpt"}
OUTPUT_KEYS = ["vis_preds=true", "save_feats=true", "save_feats_for_n_imgs=2",
               "save_ious=true", "iou_analysis=true"]
CPU_ARGS = [f"checkpoint={CKPTS['flagship']}", "datasets=GrabCut",
            f"DATASETS.GRABCUT_PATH={TREES / 'grabcut'}", "eval_mode=fixed112",
            "n_clicks=3", *OUTPUT_KEYS]
CARD_ARGS = [f"checkpoint={CKPTS['flagship']}",
             "datasets=GrabCut,Berkeley,DAVIS",
             *(f"DATASETS.{k}_PATH={TREES / v}" for k, v in (
                 ("GRABCUT", "grabcut"), ("BERKELEY", "berkeley"),
                 ("DAVIS", "davis"))),
             "eval_mode=fixed448", "n_clicks=20", *OUTPUT_KEYS]
NPY_SAMPLE = 256
FEATS_SAMPLE = 4096
FEATS_OBJECTS = 2
SAMPLE_SEED = 0
FEAT_TOL = 1e-5     # a probe's maps, f32, of each map's scale
LOFTUP_TOL = 5e-3   # LoftUp's HighRes: its Fourier features (as in
                    # tests/test_torch_upsamplers.py)
NPY_TOL = 1e-4      # the CLI's dumps against the root's
TRAINED_TOL = 1e-4  # the trained probes' maps on the CPU against JAX's
TRAINED_LOFTUP_TOL = 1e-3  # LoftUp's HighRes (its Fourier features)


# -- files of a run ------------------------------------------------------------------

def run_files(logs: Path) -> list:
    """A run's files relative to ``logs``, the feature folder's date as
    ``DATE``."""
    return sorted(re.sub(r"_\d{4}-\d\d-\d\d_\d\d:\d\d", "_DATE",
                         str(p.relative_to(logs)))
                  for p in logs.rglob("*") if p.is_file())


def results_lines(logs: Path) -> list:
    """``results.txt`` with the SPC and time columns blanked."""
    out = []
    for line in (logs / "results.txt").read_text().splitlines():
        cells = line.split("|")
        if len(cells) > 9 and "NoBRS" in line:
            cells[8] = cells[9] = ""
        out.append("|".join(cells))
    return out


def _by_name(logs: Path) -> dict:
    return {re.sub(r"_\d{4}-\d\d-\d\d_\d\d:\d\d", "_DATE",
                   str(p.relative_to(logs))): p
            for p in logs.rglob("*") if p.is_file()}


def _sample(x: np.ndarray, n: int, seed: int = SAMPLE_SEED):
    x = np.asarray(x, np.float32).ravel()
    idx = np.sort(np.random.default_rng(seed).choice(x.size, min(n, x.size),
                                                     replace=False))
    return idx, x[idx]


def _root_evaluate():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "isegprobe_evaluate_cli_outputs", REPO / "evaluate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def root_cli(args, logs: Path) -> None:
    """The root ``evaluate.py`` with ``args`` (the port's key names) into
    ``logs``: the dataset paths through a main config of its own."""
    import yaml

    paths = {a.split("=", 1)[0].split(".", 1)[1]: a.split("=", 1)[1]
             for a in args if a.startswith("DATASETS.")}
    main_cfg = logs.parent / f"{logs.name}_main.yaml"
    main_cfg.write_text(yaml.safe_dump({"EXPS_PATH": str(logs.parent),
                                        "DATASETS": paths}))
    argv = [a for a in args if not a.startswith("DATASETS.")]
    old_argv, old_cwd = sys.argv, os.getcwd()
    os.chdir(REPO)
    sys.argv = ["evaluate.py", *argv, f"logs_path={logs}",
                f"main_cfg_path={main_cfg}"]
    try:
        _root_evaluate().main()
    finally:
        sys.argv = old_argv
        os.chdir(old_cwd)


def jax_first_click_feats(name: str) -> list:
    """JAX's predictor's first-click maps on the first FEATS_OBJECTS
    objects of the Synthetic scenes: [{"LowRes", "HighRes"}]."""
    from isegprobe_torch.data.scenes import SceneDataset
    from isegprobe_tpu.inference.brs import get_predictor
    from isegprobe_tpu.inference.clicker import Clicker

    root = _root_evaluate()
    model, params = root.load_model_for_eval(
        str(CKPTS[name]), {"dtype": "float32"}, target_size=(448, 448))
    pred = get_predictor(model, params, prob_thresh=0.5, with_flip=True,
                         zoom_in_params={"skip_clicks": -1,
                                         "target_size": (448, 448)},
                         predictor_params={"net_clicks_limit": 20})
    out = []
    ds = SceneDataset(objects=slice(0, FEATS_OBJECTS))
    for i in range(FEATS_OBJECTS):
        sample = ds.get_sample(i)
        gt = sample.gt_mask(sample.objects_ids[0])
        pred.set_input_image(sample.image)
        clicker = Clicker(gt_mask=gt)
        clicker.make_next_click(np.zeros(gt.shape, bool))
        _, feats = pred.get_lowres_highres_feats(clicker)
        out.append({k: np.asarray(v, np.float32) for k, v in feats.items()})
    return out


def export(path=FIXTURE) -> None:
    """Run the root CLI (both configurations) and JAX's feature probe and
    write the fixture."""
    import tempfile
    import time

    t0 = time.time()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, args in (("cpu", CPU_ARGS), ("card", CARD_ARGS)):
            logs = Path(tmp) / key
            root_cli(args, logs)
            files = _by_name(logs)
            out[f"{key}_files"] = np.asarray(sorted(files))
            out[f"{key}_results"] = np.asarray(results_lines(logs))
            if key != "cpu":
                continue
            digests, npy = [], []
            for rel in sorted(files):
                if rel == "results.txt":
                    digests.append("")  # its time columns vary
                elif rel.endswith(".npy"):
                    x = np.load(files[rel])
                    idx, vals = _sample(x, NPY_SAMPLE)
                    npy.append((rel, x.shape, float(np.abs(x).max()), idx,
                                vals))
                    digests.append("")
                else:
                    digests.append(hashlib.sha256(
                        files[rel].read_bytes()).hexdigest())
            out["cpu_digests"] = np.asarray(digests)
            out["cpu_npy_names"] = np.asarray([n[0] for n in npy])
            out["cpu_npy_shapes"] = np.asarray([n[1] for n in npy], np.int64)
            out["cpu_npy_scale"] = np.asarray([n[2] for n in npy])
            out["cpu_npy_idx"] = np.stack([n[3] for n in npy])
            out["cpu_npy_vals"] = np.stack([n[4] for n in npy])
        print(f"root CLI runs: {time.time() - t0:.0f} s")
    for name in CKPTS:
        for k, feats in enumerate(jax_first_click_feats(name)):
            for m, x in feats.items():
                if m == "coord_features":
                    continue
                pre = f"feats_{name}_{k}_{m}"
                idx, vals = _sample(x, FEATS_SAMPLE, SAMPLE_SEED + k)
                out[f"{pre}_shape"] = np.asarray(x.shape, np.int64)
                out[f"{pre}_stats"] = np.asarray(
                    [np.abs(x).max(), x.mean(dtype=np.float64),
                     x.std(dtype=np.float64)])
                out[f"{pre}_idx"] = idx
                out[f"{pre}_vals"] = vals
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes) in "
          f"{time.time() - t0:.0f} s")


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as data:
        return dict(data)


# -- eval_utils against the JAX functions --------------------------------------------

def _clicks(cls, spots):
    return [cls(p, c, i) for i, (p, c) in enumerate(spots)]


def _frame(seed=0, hw=(37, 51)):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    gt = np.zeros(hw, np.int32)
    gt[8:30, 10:40] = 1
    gt[0:2] = -1
    probs = np.zeros(hw, np.float32)
    probs[10:28, 12:45] = rng.uniform(0.3, 1.0, (18, 33))
    probs[15:20, 20:25] = 0.1  # a hole
    return image, gt, probs


def test_prediction_vis_callback_matches_jax(tmp_path):
    """The same files (``<id>[_obj<n>]_<click>.jpg``, ``_gt.jpg``,
    ``iou/*.json``) byte for byte, for two objects of one sample."""
    from isegprobe_torch.inference.clicker import Click
    from isegprobe_torch.inference.eval_utils import \
        get_prediction_vis_callback
    from isegprobe_tpu.inference.clicker import Click as JClick
    from isegprobe_tpu.inference.eval_utils import \
        get_prediction_vis_callback as jget

    spots = [(True, (12, 14)), (False, (0, 50)), (True, (36, 0))]
    for key, get, cls in (("port", get_prediction_vis_callback, Click),
                          ("jax", jget, JClick)):
        cb = get(tmp_path / key, "GrabCut", 0.5)
        for obj in range(2):
            image, gt, probs = _frame(obj)
            for k in range(3):
                cb(image, gt, probs * (0.8 + 0.1 * k), 4, k,
                   _clicks(cls, spots[:k + 1]))
    port, jax_ = _by_name(tmp_path / "port"), _by_name(tmp_path / "jax")
    assert sorted(port) == sorted(jax_)
    assert "predictions_vis/GrabCut/4_obj1_2.jpg" in port
    for rel in port:
        assert port[rel].read_bytes() == jax_[rel].read_bytes(), rel
    assert json.loads(port["predictions_vis/GrabCut/iou/4_1.json"].read_text(
        ))["iou"] > 0


def test_save_feats_callback_matches_jax(tmp_path):
    """The first click's maps of the first ``n`` samples (float32 ``.npy``,
    the port's from tensors) and the image with its clicks, as JAX's."""
    import torch

    from isegprobe_torch.inference.clicker import Click
    from isegprobe_torch.inference.eval_utils import get_save_feats_callback
    from isegprobe_tpu.inference.clicker import Click as JClick
    from isegprobe_tpu.inference.eval_utils import \
        get_save_feats_callback as jget

    rng = np.random.default_rng(1)
    feats = {"LowRes": rng.standard_normal((1, 3, 4, 8)).astype(np.float32),
             "HighRes": rng.standard_normal((1, 37, 51, 8)).astype(
                 np.float32)}
    spots = [(True, (12, 14)), (False, (30, 50))]
    for key, get, cls, conv in (
            ("port", get_save_feats_callback, Click, torch.from_numpy),
            ("jax", jget, JClick, np.asarray)):
        cb = get(tmp_path / key, "DAVIS", "features", exec_for_n_imgs=2)
        for sid in range(3):
            image, _, _ = _frame(sid)
            for k in range(2):
                cb(image, {n: conv(v) for n, v in feats.items()}, sid, k,
                   _clicks(cls, spots[:k + 1]))
    port, jax_ = _by_name(tmp_path / "port"), _by_name(tmp_path / "jax")
    assert sorted(port) == sorted(jax_) and len(port) == 6
    for rel in port:
        if rel.endswith(".npy"):
            a, b = np.load(port[rel]), np.load(jax_[rel])
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
        else:
            assert port[rel].read_bytes() == jax_[rel].read_bytes(), rel


def test_iou_pickle_and_checkpoint_discovery_match_jax(tmp_path):
    from isegprobe_torch.inference import eval_utils as t
    from isegprobe_tpu.inference import eval_utils as j
    from isegprobe_tpu.utils.config import EDict

    ious = [np.float32([0.5, 0.7, 0.95]), np.float32([0.2, 0.91])]
    t.save_iou_analysis_data(tmp_path / "p", "Berkeley", "m", ious, 20,
                             "f-BRS-B")
    j.save_iou_analysis_data(tmp_path / "j", "Berkeley", "m", ious, 20,
                             "f-BRS-B")
    (pp,), (jp,) = (tmp_path / "p").iterdir(), (tmp_path / "j").iterdir()
    assert pp.name == jp.name == "Berkeley_f-BRS-B_20_m.pickle"
    assert pp.read_bytes() == jp.read_bytes()

    exps = tmp_path / "exps"
    run = exps / "synthetic" / "dinov2_noup" / "003_run"
    (run / "checkpoints").mkdir(parents=True)
    for name in ("000", "002", "last_checkpoint"):
        (run / "checkpoints" / f"{name}.ckpt").write_bytes(b"x")
    for exp_path in ("synthetic/dinov2_noup/003", "synthetic/dinov2_noup/003"
                     ":00"):
        got = t.get_checkpoints_list({"exp_path": exp_path,
                                      "checkpoint": None}, exps)
        want = j.get_checkpoints_list(EDict.convert(
            {"exp_path": exp_path, "checkpoint": None}), exps)
        assert got == want and got
    assert t.get_checkpoints_list({"exp_path": "", "checkpoint": "c"},
                                  exps) == ["c"]
    for folder, name in (
            (exps / "synthetic", "002"), (exps / "synthetic", "dinov2_noup:last"),
            (run.parent, "003_run:000.ckpt"),
            (exps, str(run / "checkpoints" / "000.ckpt"))):
        assert t.find_checkpoint(folder, name) == j.find_checkpoint(folder,
                                                                    name)


def test_log_eval_to_wandb_as_jax(monkeypatch):
    """Off, or without ``wandb``: nothing. With a stub ``wandb``: the JAX
    package's calls (the run's config holds each package's own keys)."""
    from isegprobe_torch.evaluate import parse_args
    from isegprobe_torch.inference.eval_utils import log_eval_to_wandb
    from isegprobe_tpu.inference.eval_utils import log_eval_to_wandb as jlog
    from isegprobe_tpu.utils.config import EDict
    from tests.test_torch_run_logs import _Recorder

    args = ["checkpoint=c.ckpt", "wandb=true", "wandb_dir=/w"]
    cfg = parse_args(args)
    result = ("GrabCut", "m", [1.5, 2.0, 3.25], [0, 1, 2], [0.8, 0.9], 0.05,
              12.0)
    assert not log_eval_to_wandb(parse_args(["checkpoint=c.ckpt"]), *result)
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert not log_eval_to_wandb(cfg, *result)
    calls = {}
    jcfg = EDict.convert({"wandb": True, "wandb_project": "iSegProbe-Eval",
                          "wandb_name": None, "wandb_dir": "/w",
                          "mode": "NoBRS", "n_clicks": 20})
    for key, fn, c in (("port", log_eval_to_wandb, cfg), ("jax", jlog, jcfg)):
        stub = _Recorder()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        assert fn(c, *result)
        calls[key] = stub.calls
    for call in calls.values():
        init = call[0][1]
        assert init.pop("config")["dataset"] == "GrabCut"
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == ("init", {"project": "iSegProbe-Eval",
                                         "name": "m__GrabCut__NoBRS",
                                         "dir": "/w"})


# -- the feature probe ------------------------------------------------------------------

def _probe(request, kind: str):
    """(config, JAX model, params, size) of a small drawn probe."""
    if kind in ("flagship", "flagship_ritm"):
        from tests.test_torch_model import jax_model_and_params, tiny_config

        request.getfixturevalue("tiny_arch_model")
        size = 56
        cfg = tiny_config(size)
        if kind == "flagship_ritm":  # patch 7 after the stride-2 transform
            cfg = dict(cfg, use_rgb_conv=True, embed_coords_cfg=dict(
                type="patchEmbed", params=dict(
                    cfg["embed_coords_cfg"]["params"], patch_size=(7, 7))))
        jmodel, params = jax_model_and_params(cfg, size)
        return cfg, jmodel, params, size
    if kind == "lift":
        from tests.test_torch_families import _jax_probe, tiny_config

        request.getfixturevalue("tiny_archs")
        size = 56
        cfg = tiny_config("dinov2_lift", size)
        jmodel, params = _jax_probe(cfg, size)
        return cfg, jmodel, params, size
    from tests.test_torch_upsamplers import family_model_and_params

    request.getfixturevalue("tiny_arch")
    size = 56
    cfg, jmodel, params = family_model_and_params(kind, size)
    return cfg, jmodel, params, size


@pytest.fixture
def tiny_arch_model(monkeypatch):
    """``tests/test_torch_model.py``'s tiny DINOv2 in both packages."""
    import dataclasses

    from isegprobe_torch.models.featurizers import dinov2 as t_dinov2
    from isegprobe_tpu.models.featurizers import dinov2 as j_dinov2
    from tests.test_torch_model import TINY_ARCH

    for mod in (j_dinov2, t_dinov2):
        monkeypatch.setitem(mod.DINOV2_ARCHS, TINY_ARCH, dataclasses.replace(
            mod.DINOV2_ARCHS["dinov2_vits14"], embed_dim=128, depth=2,
            num_heads=2))
    return TINY_ARCH


from tests.test_torch_families import tiny_archs  # noqa: E402,F401
from tests.test_torch_upsamplers import tiny_arch  # noqa: E402,F401

PROBES = ["flagship", "flagship_ritm", "loftup", "jbu_featup", "lift"]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("kind", PROBES)
def test_model_feats_match_jax(request, kind):
    """``get_lowres_highres_feats``: the click maps after the RITM
    transform, LowRes and HighRes (identity and LiFT resized to the input)
    against JAX's, f32."""
    import jax
    import torch

    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel

    cfg, jmodel, params, size = _probe(request, kind)
    rng = np.random.default_rng(0)
    image = rng.random((2, size, size, 4)).astype(np.float32)
    points = np.full((2, 6, 3), -1.0, np.float32)
    points[:, 0] = (size * 0.4, size * 0.5, 0)
    points[0, 3] = (size * 0.8, size * 0.2, 1)
    jc, jf = jax.jit(lambda p, i, q: jmodel.apply(
        {"params": p}, i, q, method=jmodel.get_lowres_highres_feats))(
            params, image, points)
    model = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    with torch.no_grad():
        tc, tf = model.get_lowres_highres_feats(torch.from_numpy(image),
                                                torch.from_numpy(points))
    assert sorted(tf) == ["HighRes", "LowRes"] and list(tc) == [
        "coord_features"]
    _close(tc["coord_features"], jc["coord_features"], FEAT_TOL)
    _close(tf["LowRes"], jf["LowRes"], FEAT_TOL)
    if kind in ("flagship", "flagship_ritm", "lift"):
        assert tf["HighRes"].shape[1:3] == (size, size)
    _close(tf["HighRes"], jf["HighRes"],
           LOFTUP_TOL if kind == "loftup" else FEAT_TOL)
    if kind == "flagship_ritm":
        assert tc["coord_features"].shape[-1] == 64


@pytest.mark.parametrize("kind", ["flagship"])
def test_predictor_feats_match_jax(request, kind):
    """``Predictor.get_lowres_highres_feats`` against JAX's predictor
    through a click sequence whose ROI moves (each click's probe on the
    crop of the image and the previous prediction, before that click's
    prediction), with the same ROI state after it."""
    import torch

    from isegprobe_torch.inference.clicker import Click, Clicker
    from isegprobe_torch.inference.predictor import Predictor
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_tpu.inference.clicker import Click as JClick
    from isegprobe_tpu.inference.clicker import Clicker as JClicker
    from isegprobe_tpu.inference.predictor import TPUPredictor

    torch.set_num_threads(4)
    cfg, jmodel, params, size = _probe(request, kind)
    model = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    kw = dict(target_size=(size, size), net_clicks_limit=6, with_flip=True,
              min_crop_size=20, prob_thresh=0.5)
    tp = Predictor(model, device="cpu", **kw)
    jp = TPUPredictor(jmodel, params, **kw)
    rng = np.random.default_rng(2)
    image = (rng.random((60, 70, 3)) * 60).astype(np.uint8)
    image[20:40, 23:52] = (200, 180, 90)
    tp.set_input_image(image)
    jp.set_input_image(image)
    spots = [(True, (30, 40)), (False, (5, 5)), (True, (35, 45)),
             (False, (58, 68))]
    tcl, jcl = Clicker(), JClicker()
    for pos, coords in spots:
        tcl.add_click(Click(pos, coords))
        jcl.add_click(JClick(pos, coords))
        _, tf = tp.get_lowres_highres_feats(tcl)
        _, jf = jp.get_lowres_highres_feats(jcl)
        for m in ("LowRes", "HighRes"):
            _close(tf[m], jf[m], FEAT_TOL)
        assert tp._object_roi == jp._object_roi
        np.testing.assert_allclose(tp.get_prediction(tcl),
                                   jp.get_prediction(jcl), rtol=0, atol=1e-4)


# -- the evaluate CLI --------------------------------------------------------------------

def test_evaluate_cli_writes_the_root_clis_files(fx, tmp_path, capsys):
    """``python -m isegprobe_torch.evaluate`` with every output key on the
    GrabCut tree: the root CLI's file set, its JPEGs, JSONs and pickle
    byte for byte, its ``results.txt`` line, its feature dumps within
    ``NPY_TOL`` of their scale; the JSON IoUs are the pickle's × 100."""
    from isegprobe_torch.evaluate import main

    logs = tmp_path / "logs"
    assert main([*CPU_ARGS, "device=cpu", f"logs_path={logs}"]) == 0
    files = _by_name(logs)
    assert sorted(files) == list(fx["cpu_files"])
    for rel, digest in zip(fx["cpu_files"], fx["cpu_digests"]):
        if digest:
            assert hashlib.sha256(files[rel].read_bytes()).hexdigest() == \
                digest, rel
    assert results_lines(logs) == list(fx["cpu_results"])
    for k, rel in enumerate(fx["cpu_npy_names"]):
        x = np.load(files[rel])
        assert x.dtype == np.float32 and list(x.shape) == list(
            fx["cpu_npy_shapes"][k])
        np.testing.assert_allclose(
            x.ravel()[fx["cpu_npy_idx"][k]], fx["cpu_npy_vals"][k], rtol=0,
            atol=NPY_TOL * fx["cpu_npy_scale"][k])
    (pick,) = [p for r, p in files.items() if r.endswith(".pickle")]
    with open(pick, "rb") as f:
        ious = pickle.load(f)["all_ious"]
    for obj, traj in enumerate(ious):
        tag = str(obj)
        for k, v in enumerate(traj):
            got = json.loads(files[f"predictions_vis/GrabCut/iou/{tag}_{k}"
                                   ".json"].read_text())["iou"]
            assert abs(got - float(v) * 100) < 1e-4
    assert "falling back" not in capsys.readouterr().out


def test_evaluate_cli_keys(tiny_arch_model, tmp_path):
    """The output keys parse (the 1.01 rule takes ``iou_analysis`` too;
    ``logs_path`` defaults under ``EXPS_PATH``); ``device_mesh`` parses
    (ported); a non-empty ``profile_dir`` writes a trace of each dataset's
    evaluation (the tiny arch on the CPU, GrabCut's tree, one click); a run
    needs a checkpoint or an ``exp_path``."""
    from isegprobe_torch.evaluate import evaluate, parse_args
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.models.vit import init_params
    from tests.test_torch_model import tiny_config

    cfg = parse_args(["checkpoint=c.ckpt", "print_ious=false",
                      "iou_analysis=true", "EXPS_PATH=/e", "model_name=m",
                      "save_feats_for_n_imgs=3"])
    assert cfg["target_iou"] == 1.01 and cfg["iou_analysis"] is True
    assert cfg["logs_path"] == "/e/evaluation_logs" and cfg["model_name"] == "m"
    assert cfg["save_feats_for_n_imgs"] == 3 and cfg["wandb_name"] is None
    assert parse_args(["checkpoint=c", "print_ious=false"])["target_iou"] \
        == 0.9
    assert parse_args(["exp_path=a/b"])["exp_path"] == "a/b"
    assert parse_args(["checkpoint=c", "device_mesh=true"])["device_mesh"]
    assert parse_args(["checkpoint=c", "profile_dir="])["profile_dir"] == ""
    model = init_params(iSegProbeModel(**tiny_config(56), device="cpu"),
                        seed=0).eval()
    cfg = parse_args(["checkpoint=runs/m.ckpt", "datasets=GrabCut",
                      f"DATASETS.GRABCUT_PATH={TREES / 'grabcut'}",
                      "eval_mode=fixed56", "n_clicks=1", "device=cpu",
                      "print_ious=false", f"profile_dir={tmp_path}"])
    out = evaluate(cfg, model)
    trace = json.loads((tmp_path / "m_GrabCut.pt.trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert len(out["all_ious"]) > 0 and "aten::linear" in names
    spans = {e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "program_span"}
    assert {"click", "predict", "model.backbone"} <= spans
    assert parse_args([])["checkpoint"] == "/path/to/checkpoint"
    with pytest.raises(ValueError, match="checkpoint"):
        parse_args(["checkpoint="])


def _root_cli():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "isegprobe_evaluate_cli_root_keys", REPO / "evaluate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_evaluate_cli_root_keys(tmp_path):
    """The root CLI's other keys: ``cpu`` (``device=cpu``), ``trunk_cache``
    by the root's ``_normalize_trunk_cache`` rules, ``device_mesh=false``
    and an empty ``profile_dir`` parse, and ``main_cfg_path`` read as
    PyYAML reads ``configs/main_cfg.yaml``, its ``EXPS_PATH`` and
    ``DATASETS.*`` used unless given on the command line; a line outside
    the file's form raises naming it."""
    import yaml

    from isegprobe_torch.evaluate import parse_args
    from isegprobe_torch.utils.main_cfg import read_main_cfg

    root = _root_cli()
    cfg = parse_args(["checkpoint=c", "cpu=true", "device_mesh=false",
                      "profile_dir="])
    assert cfg["device"] == "cpu" and cfg["cpu"] is True
    assert cfg["device_mesh"] is False
    for value, want in (("on", "on"), ("AUTO", "auto"), ("off", "off"),
                        ("true", True), ("false", False)):
        assert parse_args(["checkpoint=c", f"trunk_cache={value}"])[
            "trunk_cache"] == root._normalize_trunk_cache(want)
    for bad in ("maybe", "1"):
        with pytest.raises(ValueError, match="trunk_cache"):
            root._normalize_trunk_cache(bad)
        with pytest.raises(ValueError, match="trunk_cache"):
            parse_args(["checkpoint=c", f"trunk_cache={bad}"])

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = "" if v is None else str(v)
        return out

    main_cfg = REPO / "configs" / "main_cfg.yaml"
    assert read_main_cfg(main_cfg) == flat(yaml.safe_load(
        main_cfg.read_text()))
    machine = tmp_path / "main_cfg.yaml"
    machine.write_text(
        "# machine paths\n"
        "EXPS_PATH: '/runs'   # where runs go\n"
        "DATASETS:\n"
        "  GRABCUT_PATH: \"/d/grab cut\"\n"
        "  DAVIS_PATH: /d/davis  # bare\n"
        "  nested:\n"
        "    deeper: x\n"
        "  SBD_PATH: /d/sbd\n"
        "EMPTY:\n")
    assert read_main_cfg(machine) == flat(yaml.safe_load(
        machine.read_text()))
    cfg = parse_args(["checkpoint=c", f"main_cfg_path={machine}",
                      "DATASETS.SBD_PATH=/mine"])
    assert cfg["EXPS_PATH"] == "/runs"
    assert cfg["logs_path"] == "/runs/evaluation_logs"
    assert cfg["DATASETS.GRABCUT_PATH"] == "/d/grab cut"
    assert cfg["DATASETS.DAVIS_PATH"] == "/d/davis"
    assert cfg["DATASETS.SBD_PATH"] == "/mine"
    assert cfg["DATASETS.BERKELEY_PATH"] == "/data/berkeley"
    for text, line in (("A: 1\n  B: 2\n", 2), ("A:\n  - x\n", 2),
                       ("A: {a: 1}\n", 1), ("\tA: 1\n", 1),
                       ("A: 'open\n", 1), ("just text\n", 1)):
        machine.write_text(text)
        with pytest.raises(ValueError, match=f"main_cfg.yaml:{line}:"):
            read_main_cfg(machine)


def test_evaluate_cli_runs_an_experiments_checkpoints(tmp_path):
    """``exp_path`` evaluates every checkpoint of a run (here two copies of
    the trained flagship), one table line each in ``results.txt``, the
    callbacks falling back from the device loop to the host protocol."""
    import shutil

    from isegprobe_torch.evaluate import evaluate_all, parse_args

    run = tmp_path / "exps" / "synthetic" / "dinov2_noup" / "000_a"
    (run / "checkpoints").mkdir(parents=True)
    for name in ("000", "001"):
        shutil.copy(CKPTS["flagship"], run / "checkpoints" / f"{name}.ckpt")
    cfg = parse_args([
        f"EXPS_PATH={tmp_path / 'exps'}", "exp_path=synthetic/dinov2_noup/000",
        "datasets=Berkeley", f"DATASETS.BERKELEY_PATH={TREES / 'berkeley'}",
        "eval_mode=fixed112", "n_clicks=2", "device=cpu", "vis_preds=true",
        "device_loop=true"])
    out = evaluate_all(cfg)
    assert [o["model_name"] for o in out] == ["000", "001"]
    assert all(o["protocol"] == "host" and "falling back" in o["note"]
               for o in out)
    lines = (tmp_path / "exps" / "evaluation_logs" / "results.txt"
             ).read_text().splitlines()
    assert sum("NoBRS" in line for line in lines) == 2
    assert sum("Eval results" in line for line in lines) == 1


@pytest.mark.parametrize("name", [
    "flagship", pytest.param("loftup", marks=pytest.mark.skipif(
        not os.environ.get("RUN_SLOW"),
        reason="LoftUp at 448² on the CPU (~40 s); set RUN_SLOW=1"))])
def test_trained_feats_against_the_fixture(fx, name):
    """The trained probes' first-click maps on the CPU (the predictor's
    448² ZoomIn) against JAX's, stored: the sampled entries within
    ``TRAINED_TOL`` of the map's scale (LoftUp's HighRes
    ``TRAINED_LOFTUP_TOL``), the scale, mean and spread; the flagship on
    the first object, LoftUp on both."""
    import torch

    from isegprobe_torch.data.scenes import SceneDataset
    from isegprobe_torch.evaluate import load_model_for_eval
    from isegprobe_torch.inference.clicker import Clicker
    from isegprobe_torch.inference.predictor import Predictor

    torch.set_num_threads(8)
    model, _ = load_model_for_eval(str(CKPTS[name]), device="cpu")
    pred = Predictor(model, target_size=(448, 448), prob_thresh=0.5,
                     device="cpu")
    ds = SceneDataset(objects=slice(0, FEATS_OBJECTS))
    for k in range(1 if name == "flagship" else FEATS_OBJECTS):
        sample = ds.get_sample(k)
        gt = sample.gt_mask(sample.objects_ids[0])
        pred.set_input_image(sample.image)
        clicker = Clicker(gt_mask=gt)
        clicker.make_next_click(np.zeros(gt.shape, bool))
        _, feats = pred.get_lowres_highres_feats(clicker)
        for m in ("LowRes", "HighRes"):
            pre = f"feats_{name}_{k}_{m}"
            x = feats[m].numpy()
            scale, mean, std = fx[f"{pre}_stats"]
            tol = TRAINED_LOFTUP_TOL if (name, m) == ("loftup", "HighRes") \
                else TRAINED_TOL
            assert list(x.shape) == list(fx[f"{pre}_shape"])
            np.testing.assert_allclose(x.ravel()[fx[f"{pre}_idx"]],
                                       fx[f"{pre}_vals"], rtol=0,
                                       atol=tol * scale)
            assert abs(np.abs(x).max() - scale) <= tol * scale
            assert abs(x.mean(dtype=np.float64) - mean) <= tol * scale
            assert abs(x.std(dtype=np.float64) - std) <= tol * scale


@pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                    reason="reruns the root CLI on the CPU (~20 s); "
                           "set RUN_SLOW=1")
def test_fixture_against_a_fresh_root_cli_run(fx, tmp_path):
    root_cli(CPU_ARGS, tmp_path / "cpu")
    files = _by_name(tmp_path / "cpu")
    assert sorted(files) == list(fx["cpu_files"])
    for rel, digest in zip(fx["cpu_files"], fx["cpu_digests"]):
        if digest:
            assert hashlib.sha256(files[rel].read_bytes()).hexdigest() == \
                digest
    assert results_lines(tmp_path / "cpu") == list(fx["cpu_results"])


if __name__ == "__main__" and "--export" in sys.argv:
    export()
