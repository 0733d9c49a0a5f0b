"""The port's BRS (``inference/brs.py``) against the JAX package's.

At a tiny size (the 2-block, width-128 DINOv2 arch of
``tests/test_torch_model.py`` at 56², weights bridged from the JAX init):
the losses and the f-BRS scale activations, the objective's value and
gradient at fixed ``x`` for all five BRS modes (value within 1e-5
relative, gradient within 1e-4 of its largest magnitude: f32 on both
sides, summed in other orders), the early stops on crafted inputs,
3-click trajectories with ``maxfun`` 3 (probabilities within 1e-4,
evaluation counts equal), a NoBRS click before BRS in one process, the
factory and the evaluate CLI's ``mode=``.

At full width: the committed fixture ``isegprobe_torch/fixtures/
synthetic_brs.npz`` holds the JAX package's results on the trained
flagship at 448² for the card's phase 11i of ``chip_smoke.py``; the port
on the CPU is held against its f-BRS-B objective here. Rewrite it with
``JAX_PLATFORMS=cpu python tests/test_torch_brs.py --export``.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests.test_torch_model import (  # noqa: E402
    TINY_ARCH,
    jax_model_and_params,
    tiny_config,
)

torch.set_num_threads(2)

SIZE = 56
VALUE_TOL = 1e-5
GRAD_TOL = 1e-4
PROB_TOL = 1e-4
MODES = ("f-BRS-A", "f-BRS-B", "f-BRS-C", "DistMap-BRS", "RGB-BRS")
CKPT = REPO / "assets" / "trained" / "synthetic_dinov2_noup_160ep.ckpt"
CKPT_80 = REPO / "assets" / "trained" / "synthetic_dinov2_noup_80ep.ckpt"
BRS_FIXTURE = REPO / "isegprobe_torch" / "fixtures" / "synthetic_brs.npz"
# the fixture's protocol: the evaluate CLI's fixed448 crop, threshold 0.5,
# target IoU 0.9 (print_ious=false), and per mode the objects and clicks
FIXTURE_SIZE = 448
FIXTURE_THRESH = 0.5
FIXTURE_TARGET = 0.9
FIXTURE_RUNS = {"f-BRS-B": (8, 20), "DistMap-BRS": (2, 5), "RGB-BRS": (1, 3)}
FIXTURE_OBJECTIVE_MODES = ("f-BRS-B", "RGB-BRS", "DistMap-BRS")
ENSEMBLE_RUN = (8, 20)
# the objective's seeded point: x ~ N(0, X_SCALE) from this seed, the
# scale such that the regulariser (1e-3 |x|², ~600k entries for Input-BRS
# at 448²) stays near the click loss rather than swamp it
X_SEED = 17
X_SCALE = {"f-BRS": 0.1, "input": 0.003}
# gradient entries the fixture stores for the Input-BRS modes
GRAD_SAMPLES = 4096


@pytest.fixture(scope="module")
def probe():
    """The tiny probe in both packages: (JAX model, params, port model)."""
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.featurizers import dinov2 as t_dinov2
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_tpu.models.featurizers import dinov2 as j_dinov2

    mp = pytest.MonkeyPatch()
    for mod in (j_dinov2, t_dinov2):
        mp.setitem(mod.DINOV2_ARCHS, TINY_ARCH, dataclasses.replace(
            mod.DINOV2_ARCHS["dinov2_vits14"], embed_dim=128, depth=2,
            num_heads=2))
    cfg = tiny_config(SIZE)
    jmodel, params = jax_model_and_params(cfg, SIZE, gamma=0.5)
    tmodel = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    yield jmodel, params, tmodel, cfg
    mp.undo()


def _image():
    rng = np.random.default_rng(0)
    img = (rng.random((60, 70, 3)) * 60).astype(np.uint8)
    img[20:45, 25:55] = [200, 180, 90]
    return img


CLICKS = ((True, (30, 40)), (False, (5, 5)), (True, (35, 45)))


def _capture(monkeypatch, module):
    """Replace ``module.fmin_l_bfgs_b`` by one that records the objective
    it is given and returns ``x0`` unchanged."""
    captured = {}

    def fake(func, x0, **kw):
        captured["func"], captured["x0"] = func, x0
        return x0, 0.0, {}

    monkeypatch.setattr(module, "fmin_l_bfgs_b", fake)
    return captured


def _jax_vg(functor, x):
    (loss, _), grad = functor._value_and_grad(
        jnp.asarray(x, jnp.float32), *functor._click_args)
    return float(loss), np.asarray(grad, np.float64).ravel()


def _port_vg(functor, x):
    loss, grad, *_ = functor.value_and_grad(x)
    return float(loss), grad.double().cpu().numpy().ravel()


def seeded_x(mode: str, size: int) -> np.ndarray:
    scale = X_SCALE["f-BRS" if mode.startswith("f-BRS") else "input"]
    return np.random.default_rng(X_SEED).normal(0.0, scale, size)


def _grad_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the losses --------------------------------------------------------------

def test_brs_mask_loss_matches_jax():
    from isegprobe_torch.inference.brs import brs_mask_loss
    from isegprobe_tpu.inference.brs import brs_mask_loss as j_loss

    rng = np.random.default_rng(3)
    result = rng.random((2, 16, 20, 1)).astype(np.float32)
    pos = (rng.random(result.shape) > 0.9).astype(np.float32)
    neg = (rng.random(result.shape) > 0.95).astype(np.float32)
    want = [float(v) for v in j_loss(result, pos, neg)]
    got = [float(v) for v in brs_mask_loss(*map(torch.from_numpy,
                                                (result, pos, neg)))]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # no clicks at all: both terms vanish
    zero = np.zeros_like(pos)
    got = brs_mask_loss(*map(torch.from_numpy, (result, zero, zero)))
    assert [float(v) for v in got] == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("roi,flip", [(None, False), ((3, 30, 5, 40), False),
                                      ((3, 30, 5, 40), True)])
def test_oracle_mask_loss_matches_jax(roi, flip):
    from types import SimpleNamespace

    from isegprobe_torch.inference.brs import OracleMaskLoss
    from isegprobe_tpu.inference.brs import OracleMaskLoss as JOracle

    rng = np.random.default_rng(4)
    gt = (rng.random((48, 56)) > 0.5).astype(np.float32)
    result = rng.random((2 if flip else 1, 24, 28, 1)).astype(np.float32)
    values = []
    for cls in (JOracle, OracleMaskLoss):
        loss = cls()
        loss.predictor = SimpleNamespace(_object_roi=roi)
        loss.set_gt_mask(gt)
        arg = result if cls is JOracle else torch.from_numpy(result)
        values.append([float(v) for v in loss(arg, None, None)])
    np.testing.assert_allclose(values[1], values[0], rtol=1e-5)
    assert values[1][1:] == [1.0, 1.0]


@pytest.mark.parametrize("act", [None, "tanh", "sin"])
def test_scale_bias_unpacking_matches_jax(act):
    from isegprobe_torch.inference.brs import ScaleBiasOptimizer
    from isegprobe_tpu.inference.brs import ScaleBiasOptimizer as JOpt

    x = np.random.default_rng(5).normal(0, 0.7, 64).astype(np.float32)
    (js, jb), jreg = JOpt({}, scale_act=act).unpack_opt_params(
        jnp.asarray(x))
    (ts, tb), treg = ScaleBiasOptimizer({}, scale_act=act).unpack_opt_params(
        torch.from_numpy(x))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(float(treg), float(jreg), rtol=1e-6)


# -- the objective -----------------------------------------------------------

def _objectives(probe, monkeypatch, mode, n_clicks=2, **kw):
    """Both packages' objectives at the ``n_clicks``-th click of CLICKS on
    the tiny probe (the earlier clicks predicted for real)."""
    from isegprobe_torch.inference import brs as tbrs
    from isegprobe_torch.inference.clicker import Click, Clicker
    from isegprobe_tpu.inference import brs as jbrs
    from isegprobe_tpu.inference.clicker import Click as JClick
    from isegprobe_tpu.inference.clicker import Clicker as JClicker

    jmodel, params, tmodel, _ = probe
    zoom = {"target_size": (SIZE, SIZE), "skip_clicks": -1}
    out = []
    for pkg, make, clicker_cls, click_cls in (
            (jbrs, lambda: jbrs.get_predictor(jmodel, params, brs_mode=mode,
                                              zoom_in_params=zoom, **kw),
             JClicker, JClick),
            (tbrs, lambda: tbrs.get_predictor(tmodel, brs_mode=mode,
                                              zoom_in_params=zoom,
                                              device="cpu", **kw),
             Clicker, Click)):
        captured = _capture(monkeypatch, pkg)
        predictor = make()
        predictor.set_input_image(_image())
        clicker = clicker_cls()
        for pos, coords in CLICKS[:n_clicks]:
            clicker.add_click(click_cls(pos, coords))
            predictor.get_prediction(clicker)
        out.append(captured["func"])
    return out


@pytest.mark.parametrize("mode", MODES)
def test_objective_matches_jax(probe, monkeypatch, mode):
    """Value and gradient at x = 0 and at a seeded x, at the second click
    (the first optimized one): the same vector layout on both sides."""
    j_func, t_func = _objectives(probe, monkeypatch, mode)
    size = {"RGB-BRS": SIZE * SIZE * 3, "DistMap-BRS": SIZE * SIZE * 3}.get(
        mode, 2 * 128)
    for x in (np.zeros(size), seeded_x(mode, size)):
        want_v, want_g = _jax_vg(j_func, x)
        got_v, got_g = _port_vg(t_func, x)
        assert got_g.shape == want_g.shape == (size,)
        assert abs(got_v - want_v) <= VALUE_TOL * abs(want_v)
        assert _grad_err(got_g, want_g) <= GRAD_TOL


# -- the early stops -------------------------------------------------------------

def _crafted(base_logits, flip_average=False):
    """Both packages' InputOptimizers whose logits are ``base + x`` (with
    ``flip_average``, that batch and its width flip)."""
    from isegprobe_torch.inference.brs import InputOptimizer
    from isegprobe_tpu.inference.brs import InputOptimizer as JOpt

    shape = base_logits.shape
    pos = np.zeros(shape, np.float32)
    neg = np.zeros(shape, np.float32)
    pos[0, 2:4, 2:4] = 1
    neg[0, 10:12, 10:12] = 1
    kw = dict(with_flip=flip_average, flip_average=flip_average)
    if flip_average:
        pos, neg = (np.concatenate([m, m[:, :, ::-1]]) for m in (pos, neg))

    def j_logits(aux, off):
        out = aux + off
        return jnp.concatenate([out, out[:, :, ::-1]]) if flip_average \
            else out

    def t_logits(aux, off):
        out = aux + off
        return torch.cat([out, out.flip(2)]) if flip_average else out

    j = JOpt({}, **kw)
    j.init_click(j_logits, pos, neg, shape=shape,
                 aux=jnp.asarray(base_logits))
    t = InputOptimizer({}, **kw)
    t.init_click(t_logits, pos, neg, shape=shape,
                 aux=torch.from_numpy(base_logits), device="cpu")
    return j, t


def _same_calls(j, t, xs):
    stops = []
    for x in xs:
        jf, jg = j(x)
        tf, tg = t(x)
        assert abs(tf - jf) <= 1e-6 * max(1.0, abs(jf))
        assert (np.abs(jg).max() == 0) == (np.abs(tg).max() == 0)
        np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-9)
        stops.append(t.stop)
    return stops


def test_flip_average_matches_jax():
    """``flip_average`` averages a flip-doubled batch before the loss."""
    rng = np.random.default_rng(8)
    base = rng.normal(0, 2, (1, 16, 16, 1)).astype(np.float32)
    j, t = _crafted(base, flip_average=True)
    xs = [rng.normal(0, 1, base.size) for _ in range(2)]
    assert _same_calls(j, t, xs) == [None, None]


def test_early_stop_on_satisfied_clicks():
    base = np.full((1, 16, 16, 1), -4.0, np.float32)
    base[0, 2:4, 2:4] = 4.0
    j, t = _crafted(base)
    assert _same_calls(j, t, [np.zeros(base.size)]) == ["clicks"]
    # half the positive click's square below the threshold: no stop
    base[0, 2, 2:4] = -4.0
    j, t = _crafted(base)
    assert _same_calls(j, t, [np.zeros(base.size)]) == [None]


def test_early_stop_on_iou_plateau():
    rng = np.random.default_rng(6)
    base = rng.normal(0, 2, (1, 16, 16, 1)).astype(np.float32)
    base[0, 2:4, 2:4] = -4.0  # the positive click unsatisfied
    j, t = _crafted(base)
    x = np.zeros(base.size)
    nudge = x.copy()
    nudge[100] = 1e-3
    far = rng.normal(0, 5, base.size)
    # the same mask twice stops; a different one resets the reference
    assert _same_calls(j, t, [x, far, far + nudge]) == [None, None, "iou"]


def test_early_stop_on_oracle_plateau():
    from isegprobe_torch.inference.brs import OracleMaskLoss
    from isegprobe_tpu.inference.brs import OracleMaskLoss as JOracle

    base = np.random.default_rng(7).normal(0, 1, (1, 16, 16, 1)).astype(
        np.float32)
    gt = (base[0, :, :, 0] > 0.5).astype(np.float32)
    j, t = _crafted(base)
    j.loss_fn, t.loss_fn = JOracle(), OracleMaskLoss()
    j.loss_fn.set_gt_mask(gt)
    t.loss_fn.set_gt_mask(gt)
    # the JAX objective is built at init_click: build it again with the loss
    j._vg_key = None
    j.init_click(lambda aux, off: aux + off, *j._click_args[1:],
                 shape=base.shape, aux=j._click_args[0])
    j.min_iou_diff = t.min_iou_diff = 0  # no IoU plateau stop
    x = np.zeros(base.size)
    # the loss five calls back equal to this one's: the seventh call stops
    stops = _same_calls(j, t, [x + 0.1, x + 0.2] + [x] * 5)
    assert stops == [None] * 6 + ["oracle"]


# -- trajectories --------------------------------------------------------------

def _jax_counting(monkeypatch, counts):
    from isegprobe_tpu.inference import brs as jbrs

    real = jbrs.fmin_l_bfgs_b

    def counting(func, x0, **kw):
        n = [0]

        def counted(x):
            n[0] += 1
            return func(x)

        out = real(func=counted, x0=x0, **kw)
        counts[-1] = n[0]
        return out

    monkeypatch.setattr(jbrs, "fmin_l_bfgs_b", counting)


@pytest.mark.parametrize("mode", ["f-BRS-B", "DistMap-BRS"])
def test_trajectory_matches_jax(probe, monkeypatch, mode):
    """Three clicks with ``maxfun`` 3: probabilities within 1e-4, the
    same L-BFGS evaluation counts, ``opt_data`` within 1e-4 of its
    scale."""
    from isegprobe_torch.inference.brs import get_predictor
    from isegprobe_torch.inference.clicker import Click, Clicker
    from isegprobe_tpu.inference.brs import get_predictor as j_get
    from isegprobe_tpu.inference.clicker import Click as JClick
    from isegprobe_tpu.inference.clicker import Clicker as JClicker

    jmodel, params, tmodel, _ = probe
    zoom = {"target_size": (SIZE, SIZE), "skip_clicks": -1}
    j_counts: list = []
    _jax_counting(monkeypatch, j_counts)
    jp = j_get(jmodel, params, brs_mode=mode, zoom_in_params=zoom,
               lbfgs_params={"maxfun": 3})
    tp = get_predictor(tmodel, brs_mode=mode, zoom_in_params=zoom,
                       lbfgs_params={"maxfun": 3}, device="cpu")
    img = _image()
    jp.set_input_image(img)
    tp.set_input_image(img)
    jc, tc = JClicker(), Clicker()
    t_counts = []
    for pos, coords in CLICKS:
        jc.add_click(JClick(pos, coords))
        tc.add_click(Click(pos, coords))
        j_counts.append(0)
        want = jp.get_prediction(jc)
        got = tp.get_prediction(tc)
        t_counts.append(tp.opt_functor.n_evals)
        np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)
        scale = max(np.abs(jp.opt_data).max(), 1e-12)
        np.testing.assert_allclose(tp.opt_data, jp.opt_data, rtol=0,
                                   atol=1e-4 * scale)
    assert t_counts == j_counts
    assert t_counts[0] == 0 and all(n > 0 for n in t_counts[1:])


def test_nobrs_click_then_brs_click(probe):
    """A NoBRS click (under inference mode) and BRS clicks in one process
    on one model: the BRS run is the same before and after."""
    from isegprobe_torch.inference.brs import get_predictor
    from isegprobe_torch.inference.clicker import Click, Clicker

    _, _, tmodel, _ = probe
    zoom = {"target_size": (SIZE, SIZE), "skip_clicks": -1}

    def brs_run():
        p = get_predictor(tmodel, brs_mode="DistMap-BRS", zoom_in_params=zoom,
                          lbfgs_params={"maxfun": 2}, device="cpu")
        p.set_input_image(_image())
        c = Clicker()
        for pos, coords in CLICKS[:2]:
            c.add_click(Click(pos, coords))
            probs = p.get_prediction(c)
        assert p.opt_functor.n_evals > 0
        return probs

    before = brs_run()
    nobrs = get_predictor(tmodel, zoom_in_params=zoom, device="cpu")
    nobrs.set_input_image(_image())
    c = Clicker()
    c.add_click(Click(*CLICKS[0]))
    nobrs.get_prediction(c)
    after = brs_run()
    np.testing.assert_array_equal(after, before)
    assert all(p.grad is None for p in tmodel.parameters())


def test_get_predictor_modes(probe):
    from isegprobe_torch.inference import brs
    from isegprobe_torch.inference.predictor import (
        Predictor,
        TransformChainPredictor,
    )

    _, _, tmodel, _ = probe
    zoom = {"target_size": (SIZE, SIZE), "skip_clicks": -1}
    kinds = {"NoBRS": Predictor, "f-BRS-A": brs.FeatureBRSPredictor,
             "f-BRS-B": brs.FeatureBRSPredictor,
             "f-BRS-C": brs.FeatureBRSPredictor,
             "RGB-BRS": brs.InputBRSPredictor,
             "DistMap-BRS": brs.InputBRSPredictor}
    assert tuple(kinds) == brs.BRS_MODES
    for mode, kind in kinds.items():
        p = brs.get_predictor(tmodel, brs_mode=mode, zoom_in_params=zoom,
                          lbfgs_params={"maxfun": 7}, device="cpu")
        assert type(p) is kind
        if mode != "NoBRS":
            assert not p.with_flip and p.optimize_after_n_clicks == 1
            assert p.opt_functor.optimizer_params == {
                "m": 20, "factr": 0, "pgtol": 1e-8, "maxfun": 7,
                "maxiter": 14}
    assert brs.get_predictor(tmodel, "f-BRS-C", device="cpu"
                             ).opt_functor.scale_act == "sin"
    assert brs.get_predictor(tmodel, "RGB-BRS", device="cpu"
                             ).optimize_target == "rgb"
    chain = brs.get_predictor(tmodel, zoom_in_params={"target_size": 40,
                                                      "skip_clicks": 1},
                              device="cpu")
    assert type(chain) is TransformChainPredictor
    oracle = brs.OracleMaskLoss()
    p = brs.get_predictor(tmodel, "f-BRS-B", device="cpu",
                          brs_opt_func_params={"loss_fn": oracle})
    assert oracle.predictor is p
    with pytest.raises(ValueError, match="Unsupported BRS mode"):
        brs.get_predictor(tmodel, "g-BRS", device="cpu")
    with pytest.raises(ValueError, match="NoBRS"):
        brs.get_predictor((tmodel, [tmodel]), "f-BRS-B", device="cpu")
    with pytest.raises(ValueError, match="Unknown zoom_in_params"):
        brs.get_predictor(tmodel, "f-BRS-B", zoom_in_params={"size": 3},
                          device="cpu")


# -- the evaluate CLI --------------------------------------------------------------

@pytest.fixture
def tiny_checkpoint(probe, tmp_path):
    """The tiny probe written by the JAX package, with two stored scenes."""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE
    from isegprobe_tpu.utils.serialization import (
        model_config,
        save_checkpoint,
    )

    jmodel, params, _, _ = probe
    ckpt = tmp_path / "tiny.ckpt"
    save_checkpoint(params, model_config(jmodel), ckpt)
    with np.load(SYNTHETIC_FIXTURE) as fx:
        keep = fx["objects"][:, 0] < 2
        scenes = tmp_path / "scenes.npz"
        np.savez(scenes, images=fx["images"][:2], labels=fx["labels"][:2],
                 objects=fx["objects"][keep][:2])
    return ckpt, scenes


def test_evaluate_cli_brs_mode(tiny_checkpoint, monkeypatch, capsys):
    """``mode=f-BRS-B`` through the CLI equals the predictor driven
    directly; ``mode=DistMap-BRS device_loop=true`` runs the host protocol
    and says so; an unknown mode raises."""
    from isegprobe_torch import evaluate as ev
    from isegprobe_torch.data.scenes import SceneDataset
    from isegprobe_torch.inference import brs
    from isegprobe_torch.inference.evaluation import evaluate_dataset

    ckpt, scenes = tiny_checkpoint
    common = [f"checkpoint={ckpt}", "datasets=Synthetic", f"scenes={scenes}",
              "device=cpu",
              f"eval_mode=fixed{SIZE}", "n_clicks=3", "print_ious=false"]
    cfg = ev.parse_args(common + ["mode=f-BRS-B", "thresh=0.45"])
    assert cfg["mode"] == "f-BRS-B" and cfg["thresh"] == 0.45
    model, _ = ev.load_model_for_eval(str(ckpt), target_size=(SIZE, SIZE),
                                      device="cpu")
    out = ev.evaluate(cfg, model)
    assert out["protocol"] == "host" and out["note"] is None
    assert "f-BRS-B" in out["table"]
    direct = brs.get_predictor(
        model, "f-BRS-B", prob_thresh=0.45,
        zoom_in_params={"skip_clicks": -1, "target_size": (SIZE, SIZE)},
        predictor_params={"net_clicks_limit": 3}, device="cpu")
    want, _ = evaluate_dataset(SceneDataset(scenes), direct,
                               max_iou_thr=cfg["target_iou"], pred_thr=0.45,
                               max_clicks=3)
    assert len(out["all_ious"]) == len(want) == 2
    for got, ref in zip(out["all_ious"], want):
        np.testing.assert_array_equal(got, ref)

    assert ev.main(common + ["mode=DistMap-BRS", "device_loop=true",
                             "n_clicks=2"]) == 0
    printed = capsys.readouterr().out
    assert "the device loop runs NoBRS only" in printed
    assert "DistMap-BRS" in printed
    with pytest.raises(ValueError, match="not a predictor mode"):
        ev.parse_args(common + ["mode=h-BRS"])


# -- the full-width fixture ------------------------------------------------------

def _load_root_evaluate():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "isegprobe_evaluate_cli_brs_export", REPO / "evaluate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def objective_states(fx) -> tuple:
    """The stored predictor states (ROI, previous probabilities) and the
    two clicks at which the fixture's objectives are taken."""
    roi = tuple(int(v) for v in fx["b_roi"])
    return ({"object_roi": roi,
             "prev_prediction": fx["b_prev"].astype(np.float32)},
            [(bool(p), (int(y), int(x))) for y, x, p in fx["b_clicks"]])


def grad_record(grad: np.ndarray) -> dict:
    """What the fixture keeps of a gradient: its largest magnitude, its L2
    norm and, for a vector over GRAD_SAMPLES entries, the entries at
    seeded indices (the largest one among them)."""
    n = grad.size
    if n <= GRAD_SAMPLES:
        idx = np.arange(n)
    else:
        idx = np.random.default_rng(X_SEED).choice(n, GRAD_SAMPLES,
                                                   replace=False)
        idx[0] = int(np.abs(grad).argmax())
    return {"maxabs": float(np.abs(grad).max()),
            "l2": float(np.linalg.norm(grad)), "idx": idx,
            "sample": grad[idx]}


def objective_error(got_value, got_grad, fx, mode, k) -> dict:
    """The port's value and gradient at the fixture's ``k``-th point
    (0: x = 0, 1: the seeded x) against the stored JAX values."""
    want_v = float(fx[f"b_{mode}_value"][k])
    idx = fx[f"b_{mode}_grad_idx"]
    want_s = fx[f"b_{mode}_grad_sample"][k]
    maxabs = float(fx[f"b_{mode}_grad_maxabs"][k])
    return {"value": got_value, "jax_value": want_v,
            "value_rel_err": abs(got_value - want_v) / abs(want_v),
            "grad_err": float(np.abs(got_grad[idx] - want_s).max() / maxabs),
            "grad_maxabs_rel_err": abs(float(np.abs(got_grad).max())
                                       - maxabs) / maxabs,
            "grad_l2_rel_err": abs(float(np.linalg.norm(got_grad))
                                   - float(fx[f"b_{mode}_grad_l2"][k]))
            / float(fx[f"b_{mode}_grad_l2"][k])}


def _run_jax_protocol(predictor, data, n_obj, max_clicks, hook=None):
    """The JAX package's NoC loop on the first ``n_obj`` objects;
    ``hook(i, started)`` is called before and after each object."""
    from isegprobe_tpu.inference.evaluation import evaluate_sample

    ious = np.full((n_obj, max_clicks), np.nan, np.float32)
    clicks = np.full((n_obj, max_clicks, 3), -1, np.int64)
    n = np.zeros(n_obj, np.int64)
    for i in range(n_obj):
        sample = data.get_sample(i)
        if hook:
            hook(i, True)
        cl, obj_ious, _ = evaluate_sample(
            sample.image, sample.gt_mask(0), predictor,
            max_iou_thr=FIXTURE_TARGET, pred_thr=FIXTURE_THRESH,
            max_clicks=max_clicks)
        k = len(obj_ious)
        n[i] = k
        ious[i, :k] = obj_ious
        clicks[i, :k] = [(*c.coords, int(c.is_positive)) for c in cl]
        if hook:
            hook(i, False)
        print(f"  object {i}: {k} clicks, last IoU {obj_ious[-1]:.4f}",
              flush=True)
    return ious, n, clicks


def export():
    """Write the fixture from the JAX package on the CPU: the trained
    flagship at 448² (f32), on the stored Synthetic scenes."""
    import time

    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_tpu.inference import brs as jbrs
    from isegprobe_tpu.inference.clicker import Clicker as JClicker
    from isegprobe_tpu.inference.predictor import TPUPredictor

    t_start = time.time()
    ev = _load_root_evaluate()
    size = (FIXTURE_SIZE, FIXTURE_SIZE)
    jmodel, params = ev.load_model_for_eval(str(CKPT), {"dtype": "float32"},
                                            target_size=size)
    zoom = {"skip_clicks": -1, "target_size": size}
    data = SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, 8))
    out = {}

    def make(mode, **kw):
        return jbrs.get_predictor(jmodel, params, brs_mode=mode,
                                  prob_thresh=FIXTURE_THRESH, with_flip=True,
                                  zoom_in_params=zoom,
                                  predictor_params={"net_clicks_limit": 20},
                                  **kw)

    # (b) the objective at two points, at the first object's second click
    sample = data.get_sample(0)
    gt = sample.gt_mask(0)
    p = make("f-BRS-B")
    p.set_input_image(sample.image)
    clicker = JClicker(gt_mask=gt)
    clicker.make_next_click(np.zeros_like(gt, dtype=bool))
    probs = p.get_prediction(clicker)
    states = p.get_states()
    clicker.make_next_click(probs > FIXTURE_THRESH)
    out["b_roi"] = np.asarray(states["object_roi"], np.int64)
    out["b_prev"] = states["prev_prediction"].astype(np.float32)
    out["b_clicks"] = np.asarray(
        [(*c.coords, int(c.is_positive)) for c in clicker.get_clicks()],
        np.int64)
    real = jbrs.fmin_l_bfgs_b
    for mode in FIXTURE_OBJECTIVE_MODES:
        captured = {}

        def fake(func, x0, **kw):
            captured["func"], captured["x0"] = func, x0
            return x0, 0.0, {}

        jbrs.fmin_l_bfgs_b = fake
        p = make(mode)
        p.set_input_image(sample.image)
        p.set_states(states)
        p.get_prediction(clicker)
        jbrs.fmin_l_bfgs_b = real
        size_x = captured["x0"].size
        values, grads = [], []
        for x in (np.zeros(size_x), seeded_x(mode, size_x)):
            v, g = _jax_vg(captured["func"], x)
            values.append(v)
            grads.append(g)
        recs = [grad_record(g) for g in grads]
        idx = recs[0]["idx"]
        out[f"b_{mode}_value"] = np.asarray(values, np.float64)
        out[f"b_{mode}_grad_idx"] = idx
        out[f"b_{mode}_grad_sample"] = np.stack(
            [g[idx] for g in grads]).astype(np.float64)
        out[f"b_{mode}_grad_maxabs"] = np.asarray([r["maxabs"] for r in recs])
        out[f"b_{mode}_grad_l2"] = np.asarray([r["l2"] for r in recs])
        print(f"(b) {mode}: values {values}, {time.time() - t_start:.0f} s",
              flush=True)

    # (c) trajectories with L-BFGS evaluation counts, early stops and the
    # variables' norms after each click
    for mode, (n_obj, max_clicks) in FIXTURE_RUNS.items():
        counts, norms, stopped = [], [], []

        def counting(func, x0, **kw):
            n, last_zero = [0], [False]

            def counted(x):
                n[0] += 1
                f, g = func(x)
                last_zero[0] = not np.any(g)
                return f, g

            res = real(func=counted, x0=x0, **kw)
            counts[-1], stopped[-1] = n[0], last_zero[0]
            return res

        jbrs.fmin_l_bfgs_b = counting
        p = make(mode)
        real_get = p.get_prediction

        def get_prediction(clk, prev_mask=None, real_get=real_get, p=p):
            counts.append(0)
            stopped.append(False)
            res = real_get(clk, prev_mask)
            norms.append(float(np.linalg.norm(p.opt_data)))
            return res

        p.get_prediction = get_prediction
        evals = np.zeros((n_obj, max_clicks), np.int64)
        stops = np.zeros((n_obj, max_clicks), bool)
        opt_norm = np.full((n_obj, max_clicks), np.nan)

        def hook(i, started):
            if started:
                counts.clear()
                norms.clear()
                stopped.clear()
                return
            evals[i, :len(counts)] = counts
            stops[i, :len(stopped)] = stopped
            opt_norm[i, :len(norms)] = norms

        ious, n, clicks = _run_jax_protocol(p, data, n_obj, max_clicks, hook)
        jbrs.fmin_l_bfgs_b = real
        out[f"c_{mode}_ious"], out[f"c_{mode}_n"] = ious, n
        out[f"c_{mode}_clicks"], out[f"c_{mode}_evals"] = clicks, evals
        out[f"c_{mode}_stopped"], out[f"c_{mode}_opt_norm"] = stops, opt_norm
        print(f"(c) {mode}: clicks {n.tolist()}, evals {evals.sum()}, "
              f"{time.time() - t_start:.0f} s", flush=True)

    # (f) the two-member ensemble, 80 then 160 epochs
    _, params80 = ev.load_model_for_eval(str(CKPT_80), {"dtype": "float32"},
                                         target_size=size)
    ens = TPUPredictor(jmodel, params, target_size=size, skip_clicks=-1,
                       with_flip=True, net_clicks_limit=20,
                       click_models=[params80, params])
    n_obj, max_clicks = ENSEMBLE_RUN
    ious, n, clicks = _run_jax_protocol(ens, data, n_obj, max_clicks)
    out["f_ens_ious"], out["f_ens_n"], out["f_ens_clicks"] = ious, n, clicks
    print(f"(f) ensemble: clicks {n.tolist()}, {time.time() - t_start:.0f} s",
          flush=True)
    out["export_seconds"] = np.asarray(time.time() - t_start)
    np.savez_compressed(BRS_FIXTURE, **out)
    print(f"wrote {BRS_FIXTURE} ({BRS_FIXTURE.stat().st_size} bytes) in "
          f"{time.time() - t_start:.0f} s")


@pytest.fixture(scope="module")
def brs_fixture():
    with np.load(BRS_FIXTURE) as fx:
        return dict(fx)


def test_brs_fixture_is_consistent(brs_fixture):
    """Every run's IoUs present exactly up to its click count, clicks
    valid there, evaluations on optimized clicks only."""
    fx = brs_fixture
    for mode, (n_obj, max_clicks) in FIXTURE_RUNS.items():
        n = fx[f"c_{mode}_n"]
        assert n.shape == (n_obj,) and (n >= 1).all() and (
            n <= max_clicks).all()
        for i in range(n_obj):
            assert np.isfinite(fx[f"c_{mode}_ious"][i, :n[i]]).all()
            assert np.isnan(fx[f"c_{mode}_ious"][i, n[i]:]).all()
            assert (fx[f"c_{mode}_clicks"][i, :n[i], :2] >= 0).all()
            assert fx[f"c_{mode}_evals"][i, 0] == 0
            assert (fx[f"c_{mode}_evals"][i, 1:n[i]] >= 1).all()
            assert (fx[f"c_{mode}_evals"][i, n[i]:] == 0).all()
    assert fx["f_ens_n"].shape == (ENSEMBLE_RUN[0],)
    for mode in FIXTURE_OBJECTIVE_MODES:
        assert fx[f"b_{mode}_value"].shape == (2,)
        assert np.isfinite(fx[f"b_{mode}_grad_sample"]).all()


def test_flagship_fbrs_objective_matches_fixture(brs_fixture, monkeypatch):
    """The port on the CPU at full width (the trained flagship at 448²):
    the f-BRS-B objective's value and gradient at the fixture's two points
    and states against JAX's, with the card's tolerances."""
    from isegprobe_torch.evaluate import load_model_for_eval
    from isegprobe_torch.inference import brs
    from isegprobe_torch.inference.clicker import Click, Clicker

    fx = brs_fixture
    model, _ = load_model_for_eval(str(CKPT), device="cpu")
    states, clicks = objective_states(fx)
    captured = _capture(monkeypatch, brs)
    p = brs.get_predictor(
        model, "f-BRS-B", prob_thresh=FIXTURE_THRESH,
        zoom_in_params={"skip_clicks": -1,
                        "target_size": (FIXTURE_SIZE, FIXTURE_SIZE)},
        predictor_params={"net_clicks_limit": 20}, device="cpu")
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset

    sample = SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, 1)
                          ).get_sample(0)
    p.set_input_image(sample.image)
    p.set_states(states)
    clicker = Clicker()
    for pos, coords in clicks:
        clicker.add_click(Click(pos, coords))
    p.get_prediction(clicker)
    func = captured["func"]
    size = captured["x0"].size
    assert size == 768
    for k, x in enumerate((np.zeros(size), seeded_x("f-BRS-B", size))):
        v, g = _port_vg(func, x)
        err = objective_error(v, g, fx, "f-BRS-B", k)
        assert err["value_rel_err"] <= VALUE_TOL, err
        assert err["grad_err"] <= GRAD_TOL, err


if __name__ == "__main__":
    if "--export" in sys.argv:
        import os

        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        jax.config.update("jax_platforms", "cpu")
        export()
