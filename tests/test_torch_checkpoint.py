"""The port's checkpoint evaluation path against the JAX package: the flax
msgpack reader (``utils/serialization.py``), the PRNGKey(0) init tree
(``models/init_tree.py``), ``load_upsampler_params``, the pre-interpolated
``load_model_for_eval`` and the results table (``evaluate.py``,
``inference/metrics.py``).

Tolerances: checkpoint leaves bitwise; init-tree leaves within
``ULP_BOUND`` ulp of each leaf's largest magnitude (XLA's ``log1p`` inside
``erf_inv`` is the only inexact step, ``tests/test_torch_jax_rng.py``);
logits within 1e-3 of their scale, the pre-interpolated pos-embed within
1e-6.
"""

import importlib.util
import json
import pickle
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from isegprobe_torch.models.init_tree import count_params, init_tree
from isegprobe_torch.utils import serialization
from tests.test_torch_model import tiny_arch, tiny_config  # noqa: F401

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TRAINED = REPO / "assets" / "trained"
CKPTS = sorted(p.name for p in TRAINED.glob("*.ckpt"))
FLAGSHIP = TRAINED / "synthetic_dinov2_noup_160ep.ckpt"
LOFTUP = TRAINED / "synthetic_dinov2_loftup448_160ep.ckpt"
ULP_BOUND = 2
LOGIT_TOL = 1e-3


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _evaluate_cli():
    spec = importlib.util.spec_from_file_location(
        "isegprobe_evaluate_cli_checkpoint", REPO / "evaluate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- the checkpoint reader ----------------------------------------------------

def test_four_checkpoints_are_committed():
    assert len(CKPTS) == 4


@pytest.mark.parametrize("name", CKPTS)
def test_load_checkpoint_equals_flax_reader(name):
    from isegprobe_tpu.utils.serialization import load_checkpoint

    want, want_cfg, want_extra = load_checkpoint(TRAINED / name)
    got, got_cfg, got_extra = serialization.load_checkpoint(TRAINED / name)
    assert got_cfg == want_cfg and got_extra == want_extra
    want_leaves, got_leaves = dict(_flat(want)), dict(_flat(got))
    assert list(got_leaves) == list(want_leaves)
    for path, w in want_leaves.items():
        g = got_leaves[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_msgpack_reader_covers_flax_ext_types():
    from flax import serialization as flax_serialization

    tree = {"a": np.arange(6, dtype=np.int64).reshape(2, 3),
            "b": {"s": np.float32(2.5), "c": 3 - 4j, "t": "text",
                  "n": [0, 127, -1, -33, 255, 70000, 2**40, -2**40, 1.5,
                        None, True, False, "x" * 40, b"\x00" * 300]}}
    data = flax_serialization.msgpack_serialize(tree)
    got = serialization.msgpack_restore(data)
    want = flax_serialization.msgpack_restore(data)
    np.testing.assert_array_equal(got["a"], want["a"])
    assert got["a"].dtype == want["a"].dtype
    assert type(got["b"]["s"]) is type(want["b"]["s"])
    assert got["b"]["s"] == want["b"]["s"]
    assert got["b"]["c"] == want["b"]["c"] and got["b"]["t"] == "text"
    assert got["b"]["n"] == want["b"]["n"]


def test_msgpack_reader_rejects_other_ext_types():
    # fixext 1 of ext type 5
    with pytest.raises(ValueError, match="ext type 5"):
        serialization.msgpack_restore(b"\xd4\x05\x00")
    with pytest.raises(ValueError, match="trailing"):
        serialization.msgpack_restore(b"\x01\x02")


def test_load_checkpoint_refuses_pickled_globals(tmp_path):
    path = tmp_path / "bad.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"config": Path("x"), "state_dict": b"\x80"}, f)
    with pytest.raises(pickle.UnpicklingError, match="pathlib"):
        serialization.load_checkpoint(path)


def test_build_model_maps_the_class_by_name():
    from isegprobe_torch.models.probe_model import iSegProbeModel

    _, config, _ = serialization.load_checkpoint(FLAGSHIP)
    model = serialization.build_model(config, device="cpu")
    assert type(model) is iSegProbeModel
    with pytest.raises(NotImplementedError, match="no counterpart"):
        serialization.build_model(dict(config, **{"class": "x.Other"}),
                                  device="cpu")


def test_merge_params_overlays_like_jax():
    from isegprobe_tpu.utils.serialization import merge_params

    full = {"a": {"b": 1, "c": 2}, "d": 3, "e": {"f": 4}}
    loaded = {"a": {"c": 20, "g": 5}, "e": 6}
    assert serialization.merge_params(full, loaded) == merge_params(full,
                                                                    loaded)


# -- the PRNGKey(0) init tree -------------------------------------------------

def _assert_tree_close(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path]
        assert g.dtype == np.float32 and g.shape == w.shape, path
        scale = np.abs(w).max()
        tol = ULP_BOUND * np.spacing(np.float32(scale)) if scale else 0.0
        assert np.abs(g - w).max() <= tol, path


@pytest.mark.parametrize("ckpt", [FLAGSHIP, LOFTUP], ids=["flagship",
                                                          "loftup448"])
def test_init_tree_matches_jax_init(ckpt):
    """Full width. The init image is 112² (param values do not depend on
    its size; the LoftUp checkpoint's ``remat_blocks`` and, at 448², its
    banded slabs under ``nn.remat`` pass keys through unchanged)."""
    from isegprobe_tpu.utils.serialization import build_model

    _, config, _ = serialization.load_checkpoint(ckpt)
    image = np.zeros((1, 112, 112, 4), np.float32)
    points = np.full((1, 40, 3), -1.0, np.float32)
    want = build_model(config).init(jax.random.PRNGKey(0), image,
                                    points)["params"]
    got = init_tree(config["params"])
    _assert_tree_close(got, want)
    assert count_params(got["backbone"]) == 22_056_192


@pytest.mark.parametrize("upsampler", ["identity", "jbu_featup"])
def test_init_tree_tiny_arch(tiny_arch, upsampler):  # noqa: F811
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel

    cfg = tiny_config(56)
    cfg["upsampler_cfg"] = dict(type=upsampler, params=dict())
    cfg["backbone_cfg"]["params"]["remat_blocks"] = True
    image = np.zeros((1, 56, 56, 4), np.float32)
    points = np.full((1, 8, 3), -1.0, np.float32)
    want = JModel(**cfg).init(jax.random.PRNGKey(3), image, points)["params"]
    _assert_tree_close(init_tree(cfg, seed=3), want)
    skipped = init_tree(cfg, seed=3, skip=("head", "embed_coords"))
    assert set(skipped) == set(want) - {"head", "embed_coords"}


# -- load_upsampler_params ----------------------------------------------------

def test_missing_upsampler_path_warns():
    from isegprobe_torch.models.convert import load_upsampler_params

    _, config, _ = serialization.load_checkpoint(LOFTUP)
    up_cfg = config["params"]["upsampler_cfg"]
    assert not Path(up_cfg["params"]["upsampler_path"]).exists()
    with pytest.warns(UserWarning, match="PRNGKey\\(0\\) init"):
        assert load_upsampler_params(up_cfg) is None


def test_upsampler_params_from_msgpack_and_torch(tmp_path):
    from flax import serialization as flax_serialization

    from isegprobe_torch.models.convert import load_upsampler_params

    tree = {"final_ln": {"weight": np.arange(4, dtype=np.float32)}}
    path = tmp_path / "loftup.msgpack"
    path.write_bytes(flax_serialization.msgpack_serialize(tree))
    got = load_upsampler_params({"type": "loftup",
                                 "params": {"upsampler_path": str(path)}})
    np.testing.assert_array_equal(got["final_ln"]["weight"],
                                  tree["final_ln"]["weight"])
    # a raw torch checkpoint of the reference is converted
    from isegprobe_torch.models.convert import convert_loftup_raw
    from isegprobe_torch.utils.drawn_weights import (
        draw_state_dict,
        loftup_raw_layout,
    )

    sd = draw_state_dict(loftup_raw_layout(32, 4, 2), 0)
    raw = tmp_path / "loftup.pth"
    torch.save(sd, raw)
    got = load_upsampler_params({"type": "loftup", "params": {
        "upsampler_path": str(raw), "num_layers": 2}})
    want = convert_loftup_raw(sd, 2)
    assert [p for p, _ in _flat(got)] == [p for p, _ in _flat(want)]
    for (_, a), (_, b) in zip(_flat(got), _flat(want)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["channelnorm"]["norm"]["scale"],
                                  sd["model.1.norm.weight"].numpy())
    assert load_upsampler_params({"type": "identity", "params": {}}) is None


# -- load_model_for_eval ------------------------------------------------------

@pytest.mark.parametrize("ckpt", [FLAGSHIP, LOFTUP], ids=["flagship",
                                                          "loftup448"])
def test_load_model_for_eval_matches_jax(ckpt):
    from isegprobe_torch.evaluate import load_model_for_eval

    size = 112
    jmodel, jparams = _evaluate_cli().load_model_for_eval(
        str(ckpt), {"dtype": "float32"}, target_size=(size, size))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # LoftUp's missing upsampler_path
        model, info = load_model_for_eval(str(ckpt), torch.float32,
                                          (size, size), device="cpu")
    frozen = 22_056_192 + (4_305_510 if ckpt == LOFTUP else 0)
    assert info["frozen_params"] == frozen
    assert (info["config"]["params"]["backbone_cfg"]["params"]
            ["pretrain_grid"] == (8, 8))
    np.testing.assert_allclose(
        model.backbone.model.pos_embed.detach().numpy(),
        np.asarray(jparams["backbone"]["model"]["pos_embed"]), rtol=0,
        atol=1e-6)
    rng = np.random.default_rng(0)
    image = rng.random((2, size, size, 4)).astype(np.float32)
    points = np.full((2, 4, 3), -1.0, np.float32)
    points[:, 0] = (50, 60, 0)
    points[:, 2] = (20, 30, 1)
    want = np.asarray(jmodel.apply({"params": jparams}, image,
                                   points)["instances"])
    with torch.no_grad():
        got = model(torch.from_numpy(image),
                    torch.from_numpy(points))["instances"].numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * scale)


def test_load_model_for_eval_bf16_casts_the_f32_model():
    from isegprobe_torch.evaluate import load_model_for_eval

    f32, _ = load_model_for_eval(str(FLAGSHIP), torch.float32, (112, 112),
                                 device="cpu")
    bf16, _ = load_model_for_eval(str(FLAGSHIP), torch.bfloat16, (112, 112),
                                  device="cpu")
    for (name, p32), (_, p16) in zip(f32.named_parameters(),
                                     bf16.named_parameters()):
        assert p16.dtype == torch.bfloat16, name
        torch.testing.assert_close(p16, p32.to(torch.bfloat16), rtol=0,
                                   atol=0)


# -- metrics and the command line ---------------------------------------------

def test_results_table_and_time_metrics_match_jax():
    from isegprobe_tpu.inference import metrics as jm
    from isegprobe_torch.inference import metrics as tm

    rng = np.random.default_rng(1)
    ious = [np.sort(rng.random(k)).astype(np.float32) for k in (1, 5, 20)]
    noc, _, over = tm.compute_noc_metric(ious, [0.8, 0.85, 0.9], 20)
    assert tm.get_time_metrics(ious, 12.5) == jm.get_time_metrics(ious, 12.5)
    for kw in (dict(model_name="m", print_header=True),
               dict(print_header=False), dict(n_clicks=10)):
        assert (tm.get_results_table(noc, over, "NoBRS", "Synthetic", 0.125,
                                     3725.0, **kw)
                == jm.get_results_table(noc, over, "NoBRS", "Synthetic",
                                        0.125, 3725.0, **kw))
    assert (tm.get_results_table(noc[:1], over[:1], "NoBRS", "S", 1.0, 1.0)
            == jm.get_results_table(noc[:1], over[:1], "NoBRS", "S", 1.0,
                                    1.0))


def test_evaluate_cli_arguments(tiny_arch, tmp_path):  # noqa: F811
    from isegprobe_torch.evaluate import parse_args

    cfg = parse_args(["checkpoint=x.ckpt", "eval_mode=fixed448,336",
                      "device_loop=true", "device_batch=8",
                      "target_iou=0.5", "print_ious=false"])
    assert cfg["target_size"] == (448, 336) and cfg["device_loop"]
    assert cfg["device_batch"] == 8 and cfg["target_iou"] == 0.8
    # the root evaluate.py's defaults print the IoUs: every click runs
    cfg = parse_args(["checkpoint=x.ckpt", "target_iou=0.5"])
    assert cfg["target_iou"] == 1.01 and cfg["print_ious"]
    assert (cfg["min_n_clicks"], cfg["thresh"], cfg["clicks_limit"]) == (
        1, 0.5, None)
    cfg = parse_args(["checkpoint=x.ckpt", "min_n_clicks=2",
                      "clicks_limit=5"])
    assert cfg["target_iou"] == 0.9 and cfg["clicks_limit"] == 5
    # iou_analysis joins print_ious in the root's 1.01 rule; a key not
    # ported yet raises naming its ROADMAP item
    cfg = parse_args(["checkpoint=x", "print_ious=false",
                      "iou_analysis=true"])
    assert cfg["iou_analysis"] and cfg["target_iou"] == 1.01
    # a non-empty profile_dir writes the evaluation's torch.profiler trace
    # (a CPU run of the tiny arch: one object, one click)
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.evaluate import evaluate
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.models.vit import init_params

    model = init_params(iSegProbeModel(**tiny_config(56), device="cpu"),
                        seed=0).eval()
    cfg = parse_args(["checkpoint=tiny.ckpt", "datasets=Synthetic",
                      "eval_mode=fixed56", "n_clicks=1", "device=cpu",
                      "print_ious=false", f"profile_dir={tmp_path / 'p'}"])
    evaluate(cfg, model, dataset=SceneDataset(SYNTHETIC_FIXTURE,
                                              objects=slice(0, 1)))
    trace = json.loads((tmp_path / "p" / "tiny_Synthetic.pt.trace.json"
                        ).read_text())
    assert any(e.get("ph") == "X" and e.get("name", "").startswith("aten::")
               for e in trace["traceEvents"])
    # the program's spans over the profiler's events, on the same clock
    clicks = [e for e in trace["traceEvents"]
              if e.get("cat") == "program_span" and e["name"] == "click"]
    assert len(clicks) == 1 and clicks[0]["ph"] == "X"
    inside = [e for e in trace["traceEvents"] if e.get("ph") == "X"
              and e.get("name", "").startswith("aten::")
              and clicks[0]["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= clicks[0]["ts"] + clicks[0]["dur"]]
    assert any(e["name"] == "aten::linear" for e in inside)
    # continuous batching and the cvpr mode are ported
    cfg = parse_args(["checkpoint=x", "device_refill=true", "device_batch=3"])
    assert cfg["device_refill"] and cfg["group_max_jobs"] == 0
    cfg = parse_args(["checkpoint=x", "eval_mode=cvpr"])
    assert cfg["zoomin"] == {"skip_clicks": -1, "target_size": (448, 448)}
    # int8 W8A8 serving is ported; an unknown dtype raises
    assert parse_args(["checkpoint=x", "dtype=int8"])["dtype"] == "int8"
    with pytest.raises(ValueError, match="dtype=float16"):
        parse_args(["checkpoint=x", "dtype=float16"])
    with pytest.raises(ValueError, match="unknown key"):
        parse_args(["checkpoint=x", "colour=red"])
    # configs/eval_cfg.yaml gives a checkpoint, as the root reads it
    assert parse_args([])["checkpoint"] == "/path/to/checkpoint"
    with pytest.raises(ValueError, match="required"):
        parse_args(["checkpoint="])


def test_evaluate_main_matches_jax(tmp_path, capsys):
    """The slice end to end at a 112² crop: the trained flagship from its
    checkpoint over three stored Synthetic objects, through the port's
    command line (host protocol and device loop), against the root
    evaluate.py's model and the JAX host protocol."""
    from isegprobe_tpu.inference.evaluation import evaluate_dataset
    from isegprobe_tpu.inference.predictor import TPUPredictor
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.evaluate import evaluate, main, parse_args

    with np.load(SYNTHETIC_FIXTURE) as fx:
        scenes = tmp_path / "scenes.npz"
        np.savez(scenes, images=fx["images"][:2], labels=fx["labels"][:2],
                 objects=fx["objects"][:3])
    # the early-stop protocol (target IoU 0.9) of the JAX run below
    args = [f"checkpoint={FLAGSHIP}", "datasets=Synthetic", f"scenes={scenes}",
            "eval_mode=fixed112",
            "n_clicks=3", "device=cpu", "print_ious=false"]
    jmodel, jparams = _evaluate_cli().load_model_for_eval(
        str(FLAGSHIP), {"dtype": "float32"}, target_size=(112, 112))
    want, _ = evaluate_dataset(
        SceneDataset(scenes),
        TPUPredictor(jmodel, jparams, target_size=(112, 112),
                     skip_clicks=-1, with_flip=True, net_clicks_limit=3),
        max_iou_thr=0.9, pred_thr=0.5, min_clicks=1, max_clicks=3)
    for extra in ([], ["device_loop=true", "device_batch=2"]):
        got = evaluate(parse_args(args + extra))
        assert [len(a) for a in got["all_ious"]] == [len(a) for a in want]
        for g, w in zip(got["all_ious"], want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
    assert main(args + ["device_loop=true", "device_batch=2",
                        "print_ious=true"]) == 0
    out = capsys.readouterr().out
    assert "Eval results for model: synthetic_dinov2_noup_160ep" in out
    assert "NoC@90%" in out and "mIoU@k:" in out


def test_device_loop_clicks_match_jax_host_protocol(tmp_path):
    """The clicks the port's device loop records (B=2, a padded tail
    chunk) are the JAX host protocol's, for the trained flagship at 112²."""
    from isegprobe_tpu.inference.evaluation import evaluate_sample
    from isegprobe_tpu.inference.predictor import TPUPredictor
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.evaluate import load_model_for_eval
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_device,
        make_device_evaluator,
    )

    with np.load(SYNTHETIC_FIXTURE) as fx:
        scenes = tmp_path / "scenes.npz"
        np.savez(scenes, images=fx["images"][:2], labels=fx["labels"][:2],
                 objects=fx["objects"][:3])
    data = SceneDataset(scenes)
    size, max_clicks = 112, 4
    jmodel, jparams = _evaluate_cli().load_model_for_eval(
        str(FLAGSHIP), {"dtype": "float32"}, target_size=(size, size))
    predictor = TPUPredictor(jmodel, jparams, target_size=(size, size),
                             skip_clicks=-1, with_flip=True,
                             net_clicks_limit=max_clicks)
    want = []
    for index in range(len(data)):
        sample = data.get_sample(index)
        for obj in sample.objects_ids:
            clicks, _, _ = evaluate_sample(
                sample.image, sample.gt_mask(obj), predictor,
                max_iou_thr=0.99, pred_thr=0.5, max_clicks=max_clicks)
            want.append([(*c.coords, int(c.is_positive)) for c in clicks])
    model, _ = load_model_for_eval(str(FLAGSHIP), torch.float32,
                                   (size, size), device="cpu")
    run = make_device_evaluator(model, target_size=(size, size),
                                max_clicks=max_clicks,
                                net_clicks_limit=max_clicks, pred_thr=0.5,
                                target_iou=0.99, batch_size=2,
                                record_clicks=True, device="cpu")
    got: list = []
    evaluate_dataset_device(run, data, clicks=got)
    assert [[tuple(int(v) for v in c) for c in obj] for obj in got] == want
    assert run.clicks.shape == (2, max_clicks, 3)
