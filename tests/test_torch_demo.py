"""The port's interactive demo (``isegprobe_torch/interactive_demo/``,
``isegprobe_torch/demo.py``) against the JAX package's on the same inputs.

- ``Viewport`` against JAX's: fitting, the coordinate maps, clicks, zoom
  with its clamps, panning, and ``render`` bitwise against JAX's (cv2) at
  scales below 4 (bilinear) and at 4 or more (nearest);
- a scripted session of the controller on a tiny flagship (two blocks,
  56², the weights carried across from the JAX params) beside the JAX
  controller, click for click: add, undo, ``set_mask`` (whose first click
  predicts twice), ``partially_finish_object`` and the undo right after
  it, ``finish_object``, a predictor rebuild mid-session and a switch to
  f-BRS-B. After each action the draft's probabilities agree within 1e-5,
  the label map and the drawing are equal except at pixels whose JAX
  probability lies within 1e-5 of the threshold (counted and printed), and
  the undo journals have the same length;
- ``write_png`` read back bitwise by the port's decoder and by cv2;
- ``demo.py``'s predictor builder without Tk: the option -> predictor
  mapping and its "omitted ZoomIn means the config's, None means off"
  rule;
- ``interactive_demo.app`` imports without a display.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_model import (
    jax_model_and_params,
    tiny_arch,  # noqa: F401  (fixture)
    tiny_config,
)

torch.set_num_threads(2)

HW = 56
PROB_TOL = 1e-5
REPO = Path(__file__).resolve().parents[1]


# -- the canvas ------------------------------------------------------------


def _viewports():
    from isegprobe_tpu.interactive_demo.canvas import Viewport as JView
    from isegprobe_torch.interactive_demo.canvas import Viewport as TView

    return JView, TView


def _same_view(a, b):
    assert (a.img_w, a.img_h, a.canvas_w, a.canvas_h) == (
        b.img_w, b.img_h, b.canvas_w, b.canvas_h)
    assert (a.scale, a.ox, a.oy) == (b.scale, b.ox, b.oy)


def test_viewport_geometry_matches_jax():
    JView, TView = _viewports()
    for args in ((400, 200, 200, 200), (100, 80, 200, 200),
                 (640, 480, 320, 240), (64, 64, 64, 64)):
        _same_view(TView.fit(*args), JView.fit(*args))
    j = JView.fit(100, 80, 200, 200).zoom_at(50, 50, 3.0).pan(17, -9)
    t = TView.fit(100, 80, 200, 200).zoom_at(50, 50, 3.0).pan(17, -9)
    _same_view(t, j)
    for c in ((123.0, 77.0), (0.0, 0.0), (199.5, 3.25), (1e4, 1e4)):
        assert t.to_image(*c) == j.to_image(*c)
        assert t.to_canvas(*c) == j.to_canvas(*c)
        assert t.image_click(*c) == j.image_click(*c)
    # the zoom clamps, both ways
    j, t = JView.fit(64, 64, 64, 64), TView.fit(64, 64, 64, 64)
    for factor, n in ((3.0, 40), (1 / 3.0, 80)):
        for _ in range(n):
            j, t = j.zoom_at(32, 32, factor), t.zoom_at(32, 32, factor)
            _same_view(t, j)
    assert t.scale == 0.05
    _same_view(t.resized(90, 70), j.resized(90, 70))


@pytest.mark.parametrize("zoom", [0.7, 1.0, 2.5, 4.0, 9.0])
def test_viewport_render_matches_jax(zoom):
    """Bilinear below a scale of 4, nearest from 4 up, bitwise."""
    JView, TView = _viewports()
    rng = np.random.default_rng(int(zoom * 10))
    image = rng.integers(0, 256, (61, 83, 3), dtype=np.uint8)
    j = JView.fit(83, 61, 120, 90).zoom_at(40, 30, zoom).pan(-7, 5)
    t = TView.fit(83, 61, 120, 90).zoom_at(40, 30, zoom).pan(-7, 5)
    got, want = t.render(image), j.render(image)
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], want[0])


# -- the controller ----------------------------------------------------------


def _scene():
    rng = np.random.default_rng(4)
    img = (rng.random((HW, HW, 3)) * 70).astype(np.uint8)
    gt = np.zeros((HW, HW), bool)
    gt[14:42, 12:44] = True
    img[gt] = [185, 165, 95]
    return img


def _app_zoomin(opts):
    """The app's option state -> ZoomIn (``InteractiveDemoApp.
    _build_predictor``)."""
    if not opts["use_zoom_in"]:
        return None
    return {"target_size": (opts["target_size"], opts["target_size"]),
            "skip_clicks": (-1 if opts["fixed_crop"]
                            else max(0, opts["skip_clicks"])),
            "expansion_ratio": opts["expansion_ratio"]}


@pytest.fixture
def controllers(tiny_arch):  # noqa: F811
    from isegprobe_tpu.inference.brs import get_predictor as j_get
    from isegprobe_tpu.interactive_demo.controller import (
        InteractiveController as JController,
    )
    from isegprobe_torch.demo import make_predictor_builder, parse_args
    from isegprobe_torch.interactive_demo.controller import (
        InteractiveController as TController,
    )
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel

    cfg = tiny_config(HW)
    jmodel, params = jax_model_and_params(cfg, HW)
    tmodel = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    opts = dict(brs_mode="NoBRS", prob_thresh=0.5, use_zoom_in=True,
                fixed_crop=True, skip_clicks=1, target_size=HW,
                expansion_ratio=1.4, net_clicks_limit=8, lbfgs_max_iters=3)
    builder = make_predictor_builder(
        parse_args(["checkpoint=unused", "device=cpu"]), model=tmodel)

    def t_build():
        return builder(brs_mode=opts["brs_mode"],
                       prob_thresh=opts["prob_thresh"],
                       zoomin_params=_app_zoomin(opts),
                       predictor_params={
                           "net_clicks_limit": opts["net_clicks_limit"]},
                       lbfgs_max_iters=opts["lbfgs_max_iters"])

    def j_build():  # the root demo.py's builder
        return j_get(jmodel, params, brs_mode=opts["brs_mode"],
                     prob_thresh=opts["prob_thresh"], with_flip=True,
                     zoom_in_params=_app_zoomin(opts),
                     predictor_params={
                         "net_clicks_limit": opts["net_clicks_limit"]},
                     lbfgs_params={"maxfun": opts["lbfgs_max_iters"]})

    updates = []
    t = TController(t_build, lambda **kw: updates.append(kw), 0.5)
    j = JController(j_build, prob_thresh=0.5)
    return t, j, opts, updates


def _compare(t, j, what, near_counts):
    assert len(t._journal) == len(j._journal), what
    assert t.is_incomplete_mask == j.is_incomplete_mask, what
    assert t.object_count == j.object_count, what
    jp, tp = j.current_object_prob, t.current_object_prob
    near = np.zeros(t.image.shape[:2], bool)
    if jp is not None:
        np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL,
                                   err_msg=what)
        near = np.abs(np.asarray(jp) - j.prob_thresh) <= PROB_TOL
    near_counts[what] = int(near.sum())
    np.testing.assert_array_equal(t.result_mask[~near],
                                  j.result_mask[~near], err_msg=what)
    tv = t.get_visualization(alpha_blend=0.5, click_radius=3)
    jv = j.get_visualization(alpha_blend=0.5, click_radius=3)
    if not near.any():
        np.testing.assert_array_equal(tv, jv, err_msg=what)


def test_controller_session_matches_jax(controllers):
    t, j, opts, updates = controllers
    near = {}

    def both(action, *args, what):
        getattr(t, action)(*args)
        getattr(j, action)(*args)
        _compare(t, j, what, near)

    both("set_image", _scene(), what="set_image")
    assert updates and updates[-1].get("reset_canvas")
    both("add_click", 28, 26, True, what="click 1")
    both("add_click", 40, 38, True, what="click 2")
    # the journal's snapshots hold the maps themselves, not copies
    draft2_live = t._live
    both("add_click", 4, 4, False, what="click 3")
    assert t._journal[-1].live is draft2_live
    draft3 = t.current_object_prob
    both("undo_click", what="undo")
    assert len(t.clicker) == 2
    both("add_click", 4, 4, False, what="click 3 again")
    np.testing.assert_array_equal(t.current_object_prob, draft3)
    both("partially_finish_object", what="partially_finish_object")
    both("add_click", 20, 35, True, what="click after partial finish")
    both("undo_click", what="undo after partial finish")
    both("undo_click", what="undo across partial finish")
    assert len(t.clicker) == len(j.clicker) == 2
    both("finish_object", what="finish_object")
    assert t.object_count == 1
    # an external mask: the first click after it predicts twice
    mask = np.zeros((HW, HW), bool)
    mask[20:40, 20:40] = True
    assert t.set_mask(mask) and j.set_mask(mask)
    _compare(t, j, "set_mask", near)
    both("add_click", 30, 30, True, what="click after set_mask")
    assert t.clicker.clicks_list[0].indx == 1
    # a ZoomIn option change rebuilds the predictor mid-session
    opts["fixed_crop"] = False
    both("reset_predictor", what="rebuild (adaptive ROI)")
    assert t.predictor.skip_clicks == 1
    both("add_click", 22, 40, True, what="click after rebuild")
    # the BRS switch: f-BRS-B on the rebuilt predictor
    opts["brs_mode"] = "f-BRS-B"
    both("reset_predictor", what="rebuild (f-BRS-B)")
    assert type(t.predictor).__name__ == type(j.predictor).__name__
    both("add_click", 45, 15, False, what="f-BRS-B click")
    both("undo_click", what="f-BRS-B undo")
    both("finish_object", what="finish second object")
    assert t.object_count == 2 and set(np.unique(t.result_mask)) <= {0, 1, 2}
    print("pixels within 1e-5 of the threshold:", near)


# -- the PNG writer ------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype", [((7, 13, 3), np.uint8),
                                         ((5, 9), np.uint8),
                                         ((6, 11, 1), np.uint8),
                                         ((4, 6), np.uint16)])
def test_write_png_round_trips(tmp_path, shape, dtype):
    import cv2

    from isegprobe_torch.data.image_io import decode_bgr, read_bgr, write_png

    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    path = tmp_path / "mask.png"
    write_png(path, img)
    flat = img[:, :, 0] if img.ndim == 3 and img.shape[2] == 1 else img
    np.testing.assert_array_equal(
        cv2.imread(str(path), cv2.IMREAD_UNCHANGED), flat)
    # the port's decoder gives cv2.imread's 8-bit BGR
    np.testing.assert_array_equal(read_bgr(path), cv2.imread(str(path)))
    if dtype == np.uint8:
        bgr = decode_bgr(path.read_bytes())
        want = flat if flat.ndim == 3 else np.repeat(flat[:, :, None], 3, 2)
        np.testing.assert_array_equal(bgr, want)
    with pytest.raises(ValueError, match="encode_png"):
        write_png(path, img.astype(np.float32))


# -- the demo CLI's builder ------------------------------------------------------


def test_demo_builder_maps_options_like_the_root(tiny_arch):  # noqa: F811
    from isegprobe_torch.demo import make_predictor_builder, parse_args
    from isegprobe_torch.inference.brs import (
        FeatureBRSPredictor,
        InputBRSPredictor,
    )
    from isegprobe_torch.inference.predictor import (
        Predictor,
        TransformChainPredictor,
    )
    from isegprobe_torch.models.probe_model import iSegProbeModel

    model = iSegProbeModel(**tiny_config(HW), device="cpu")
    cfg = parse_args(["checkpoint=unused", "device=cpu"])
    assert cfg["eval_mode"] == "fixed224"  # configs/eval_cfg.yaml's
    build = make_predictor_builder(cfg, model=model)
    assert build.model is model and build.default_zoomin == {
        "skip_clicks": -1, "target_size": (224, 224)}
    # an omitted ZoomIn is the eval config's
    p = build()
    assert isinstance(p, Predictor) and p.target_size == (224, 224)
    assert p.with_flip and p.skip_clicks == -1
    # None is the GUI's "Use ZoomIn" box off: no ROI
    assert build(zoomin_params=None).skip_clicks == 10**9
    p = build(zoomin_params={"target_size": (96, 96), "skip_clicks": 2,
                             "expansion_ratio": 1.2},
              predictor_params={"net_clicks_limit": 5})
    assert (p.target_size, p.skip_clicks, p.expansion_ratio,
            p.net_clicks_limit) == ((96, 96), 2, 1.2, 5)
    p = build(brs_mode="f-BRS-B", lbfgs_max_iters=7)
    assert isinstance(p, FeatureBRSPredictor)
    assert p.opt_functor.optimizer_params["maxfun"] == 7
    assert p.opt_functor.optimizer_params["maxiter"] == 14
    assert isinstance(build(brs_mode="RGB-BRS"), InputBRSPredictor)
    # eval_ritm cvpr: the adaptive scalar ZoomIn of the RITM protocol
    ritm = make_predictor_builder(
        parse_args(["checkpoint=unused", "device=cpu", "eval_ritm=true",
                    "eval_mode=cvpr"]), model=model)
    assert isinstance(ritm(), TransformChainPredictor)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_predictor_builder(parse_args(["checkpoint=unused"]),
                                   model=model)


def test_app_imports_without_a_display():
    env = {k: v for k, v in os.environ.items() if k != "DISPLAY"}
    out = subprocess.run(
        [sys.executable, "-c",
         "import isegprobe_torch.interactive_demo.app as a, "
         "isegprobe_torch.demo as d; print(a.BRS_MODES, callable(d.main))"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "f-BRS-B" in out.stdout and "True" in out.stdout
