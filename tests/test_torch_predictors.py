"""The port's other predictors and the full clicker against the JAX
package's: the ``Clicker`` API, ``get_offsets``, ``LimitLongestSide``,
``Crops``, ``CropsPredictor``, click-model ensembles with
``split_points_by_order``, ``prev_mask=``, the host trunk cache and the
demo's state protocol on every predictor.

The probe is the tiny one of ``tests/test_torch_model.py`` (2 blocks,
width 128) at 56², weights bridged from the JAX init; f32 on both sides,
probabilities within 1e-4 (summation order only)."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests.test_torch_families import (  # noqa: E402,F401
    _jax_probe,
    tiny_archs,
)
from tests.test_torch_families import tiny_config as family_config  # noqa: E402
from tests.test_torch_model import (  # noqa: E402
    TINY_ARCH,
    jax_model_and_params,
    tiny_config,
)

torch.set_num_threads(2)

SIZE = 56
PROB_TOL = 1e-4


@pytest.fixture(scope="module")
def probes():
    """Two tiny probes (PRNGKey(0) and PRNGKey(7) heads and click
    embeddings) in both packages: [(JAX params, port model)] and the JAX
    model."""
    import jax

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
    # a second member: the same frozen backbone, another click embedding
    # and head
    other = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(7), np.zeros((1, SIZE, SIZE, 4), np.float32),
        np.full((1, 8, 3), -1.0, np.float32))["params"])
    params_b = dict(params, head=other["head"],
                    embed_coords=other["embed_coords"])
    members = [(p, load_jax_params(iSegProbeModel(**cfg, device="cpu"), p))
               for p in (params, params_b)]
    yield jmodel, members
    mp.undo()


def _image(hw=(60, 70), seed=0):
    rng = np.random.default_rng(seed)
    img = (rng.random((*hw, 3)) * 60).astype(np.uint8)
    h, w = hw
    img[h // 3:2 * h // 3, w // 3:3 * w // 4] = [200, 180, 90]
    return img


def _drive(predictor, clicker, clicks, click_cls, prev_masks=None):
    out = []
    for k, (pos, coords) in enumerate(clicks):
        clicker.add_click(click_cls(pos, coords))
        prev = None if prev_masks is None else prev_masks[k]
        out.append(np.asarray(predictor.get_prediction(clicker, prev)).copy())
    return out


def _both(j_pred, t_pred, img, clicks, clicker_kw=None, prev_masks=None):
    from isegprobe_torch.inference.clicker import Click, Clicker
    from isegprobe_tpu.inference.clicker import Click as JClick
    from isegprobe_tpu.inference.clicker import Clicker as JClicker

    j_pred.set_input_image(img)
    t_pred.set_input_image(img)
    want = _drive(j_pred, JClicker(**(clicker_kw or {})), clicks, JClick,
                  prev_masks)
    got = _drive(t_pred, Clicker(**(clicker_kw or {})), clicks, Click,
                 prev_masks)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=PROB_TOL)
    return got


CLICKS = ((True, (30, 40)), (False, (5, 5)), (True, (35, 45)),
          (False, (50, 60)))


# -- the clicker ----------------------------------------------------------------

def test_clicker_api_matches_jax():
    from isegprobe_torch.inference.clicker import Click, Clicker
    from isegprobe_tpu.inference.clicker import Click as JClick
    from isegprobe_tpu.inference.clicker import Clicker as JClicker

    rng = np.random.default_rng(1)
    gt = np.zeros((40, 50), np.int32)
    gt[8:30, 10:40] = 1
    gt[0:3] = -1
    kw = dict(click_indx_offset=3)
    init = [(True, (20, 20)), (False, (2, 45))]
    j = JClicker(gt_mask=gt, init_clicks=[JClick(*c) for c in init], **kw)
    t = Clicker(gt_mask=gt, init_clicks=[Click(*c) for c in init], **kw)

    def same():
        assert [c.coords_and_indx for c in t.get_clicks()] == [
            c.coords_and_indx for c in j.get_clicks()]
        assert [c.is_positive for c in t.clicks_list] == [
            c.is_positive for c in j.clicks_list]
        assert (len(t), t.num_pos_clicks, t.num_neg_clicks) == (
            len(j), j.num_pos_clicks, j.num_neg_clicks)
        np.testing.assert_array_equal(t.not_clicked_map, j.not_clicked_map)

    same()
    for _ in range(4):
        pred = rng.random(gt.shape) > 0.6
        j.make_next_click(pred)
        t.make_next_click(pred)
        same()
    assert [c.indx for c in t.get_clicks()] == list(range(3, 9))
    assert t.get_clicks(2) == t.clicks_list[:2]
    state_t, state_j = t.get_state(), j.get_state()
    j._remove_last_click()
    t._remove_last_click()
    same()
    t.set_state(state_t)
    j.set_state(state_j)
    same()
    assert state_t is not t.clicks_list and state_t == t.clicks_list
    j.reset_clicks()
    t.reset_clicks()
    same()
    assert len(t) == 0 and t.not_clicked_map.all()
    c = Click(True, (1.5, 2.5), indx=4)
    moved = c.copy(coords=(3, 4))
    assert moved.coords_and_indx == (3, 4, 4) and c.coords == (1.5, 2.5)
    # without a ground truth the clicker only keeps clicks
    bare = Clicker()
    bare.add_click(Click(False, (7, 8)))
    assert bare.get_clicks()[0].indx == 0 and bare.num_neg_clicks == 1


# -- transforms ----------------------------------------------------------------

@pytest.mark.parametrize("length,crop,overlap", [
    (854, 480, 0.2), (480, 320, 0.2), (100, 40, 0.5), (100, 40, 0.2),
    (320, 320, 0.2), (1000, 333, 0.35)])
def test_get_offsets_matches_jax(length, crop, overlap):
    from isegprobe_torch.inference.transforms import get_offsets
    from isegprobe_tpu.inference.transforms import get_offsets as j_off

    assert get_offsets(length, crop, overlap) == j_off(length, crop, overlap)


def _clicks_lists(lists):
    return [[(c.is_positive, tuple(float(v) for v in c.coords), c.indx)
             for c in cl] for cl in lists]


@pytest.mark.parametrize("hw,max_size", [((60, 90), 40), ((30, 20), 40)])
def test_limit_longest_side_matches_jax(hw, max_size):
    from isegprobe_torch.inference.clicker import Click
    from isegprobe_torch.inference.transforms import LimitLongestSide
    from isegprobe_tpu.inference.clicker import Click as JClick
    from isegprobe_tpu.inference.transforms import (
        LimitLongestSide as JLimit,
    )

    rng = np.random.default_rng(2)
    x = rng.random((1, *hw, 4)).astype(np.float32)
    clicks = [(True, (10, 12)), (False, (25, 5))]
    j, t = JLimit(max_size), LimitLongestSide(max_size)
    jx, jl = j.transform(x, [[JClick(*c, indx=i)
                              for i, c in enumerate(clicks)]])
    tx, tl = t.transform(torch.from_numpy(x),
                         [[Click(*c, indx=i) for i, c in enumerate(clicks)]])
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    assert _clicks_lists(tl) == _clicks_lists(jl)
    assert t.image_changed == j.image_changed == (max(hw) > max_size)
    logits = rng.random(tx.shape[:3] + (1,)).astype(np.float32)
    want = np.asarray(j.inv_transform(logits))
    got = t.inv_transform(torch.from_numpy(logits)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)
    state = t.get_state()
    t.reset()
    t.set_state(state)
    assert t.get_state()[1] == j.get_state()[1]


@pytest.mark.parametrize("hw,overlap", [((100, 130), 0.2), ((100, 130), 0.5),
                                        ((30, 40), 0.2)])
def test_crops_matches_jax(hw, overlap):
    from isegprobe_torch.inference.clicker import Click
    from isegprobe_torch.inference.transforms import Crops
    from isegprobe_tpu.inference.clicker import Click as JClick
    from isegprobe_tpu.inference.transforms import Crops as JCrops

    rng = np.random.default_rng(3)
    x = rng.random((1, *hw, 4)).astype(np.float32)
    clicks = [(True, (50, 60)), (False, (90, 10))]
    j, t = JCrops((40, 56), overlap), Crops((40, 56), overlap)
    jx, jl = j.transform(x, [[JClick(*c, indx=i)
                              for i, c in enumerate(clicks)]])
    tx, tl = t.transform(torch.from_numpy(x),
                         [[Click(*c, indx=i) for i, c in enumerate(clicks)]])
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert _clicks_lists(tl) == _clicks_lists(jl)
    probs = rng.random(tx.shape[:3] + (1,)).astype(np.float32)
    want = np.asarray(j.inv_transform(probs))
    got = t.inv_transform(torch.from_numpy(probs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    xo, yo, counts = t.get_state()
    jxo, jyo, jcounts = j.get_state()
    assert (xo, yo) == (jxo, jyo)
    if jcounts is None:
        assert counts is None
    else:
        np.testing.assert_array_equal(counts.numpy(), jcounts)
    t.reset()
    assert t.get_state() == (None, None, None)
    t.set_state((xo, yo, counts))
    np.testing.assert_allclose(t.inv_transform(torch.from_numpy(probs)
                                               ).numpy(), want, rtol=1e-6)


def test_zoom_in_state_round_trip():
    from isegprobe_torch.inference.clicker import Click
    from isegprobe_torch.inference.transforms import ZoomIn

    z = ZoomIn(target_size=32, skip_clicks=-1)
    x = torch.rand(1, 50, 60, 4)
    clicks = [[Click(True, (20, 30), 0)]]
    z.transform(x, clicks)
    z.inv_transform(torch.rand(1, *z._roi_image.shape[1:3], 1))
    state = z.get_state()
    assert state[0] == (1, 50, 60, 4) and state[1] is not None
    z.reset()
    assert z.get_state() == (None, None, None, None, False)
    z.set_state(state)
    assert z.get_state()[1] == state[1]
    assert not z.check_possible_recalculation()  # an ROI is set


# -- CropsPredictor ----------------------------------------------------------------

@pytest.mark.parametrize("hw,overlap", [((42, 70), 0.2), ((100, 130), 0.2),
                                        ((100, 130), 0.5)])
def test_crops_predictor_matches_jax(probes, hw, overlap):
    """Tiles of the probe's size: untiled below it, two overlaps on one
    geometry (other offsets, the same tile count)."""
    from isegprobe_torch.inference.predictor import CropsPredictor
    from isegprobe_tpu.inference.predictor import CropsPredictor as JCrops

    jmodel, [(params, tmodel), _] = probes
    kw = dict(crop_size=(SIZE, SIZE), min_overlap=overlap,
              net_clicks_limit=4)
    j = JCrops(jmodel, params, **kw)
    t = CropsPredictor(tmodel, device="cpu", **kw)
    clicks = [(True, (hw[0] // 2, hw[1] // 2)), (False, (5, 5)),
              (True, (hw[0] - 10, hw[1] - 12))]
    _both(j, t, _image(hw), clicks)
    assert t._offsets == j._offsets
    if hw == (42, 70):
        assert t._offsets == [(0, 0)] and t._tile_hw == hw
    state = t.get_states()
    last = t.get_prediction(_clicker(clicks))
    t.set_states(state)
    np.testing.assert_array_equal(t.get_prediction(_clicker(clicks)), last)


def _clicker(clicks):
    from isegprobe_torch.inference.clicker import Click, Clicker

    c = Clicker()
    for pos, coords in clicks:
        c.add_click(Click(pos, coords))
    return c


def test_transform_chain_with_crops_and_limit_matches_jax(probes):
    """The host chain ``[LimitLongestSide, Crops, AddHorizontalFlip,
    SigmoidForPred]`` against the JAX chain, and its state protocol."""
    from isegprobe_torch.inference import transforms as tt
    from isegprobe_torch.inference.predictor import TransformChainPredictor
    from isegprobe_tpu.inference import transforms as jt
    from isegprobe_tpu.inference.predictor import (
        TransformChainPredictor as JChain,
    )

    jmodel, [(params, tmodel), _] = probes

    def chain(mod):
        return [mod.LimitLongestSide(100), mod.Crops((SIZE, SIZE), 0.3),
                mod.AddHorizontalFlip(), mod.SigmoidForPred()]

    j = JChain(jmodel, params, transforms=chain(jt), net_clicks_limit=4)
    t = TransformChainPredictor(tmodel, transforms=chain(tt),
                                net_clicks_limit=4, device="cpu")
    clicks = [(True, (60, 70)), (False, (10, 100)), (True, (80, 40))]
    got = _both(j, t, _image((90, 150)), clicks)
    states = t.get_states()
    assert len(states["transform_states"]) == 4
    again = t.get_prediction(_clicker(clicks))
    t.set_states(states)
    np.testing.assert_array_equal(t.get_prediction(_clicker(clicks)), again)
    assert got[-1].shape == (90, 150)


# -- ensembles, prev_mask and the state protocol ----------------------------------

def test_split_points_by_order_matches_jax():
    from isegprobe_torch.models.probe_model import split_points_by_order
    from isegprobe_tpu.models.probe_model import (
        split_points_by_order as j_split,
    )

    rng = np.random.default_rng(4)
    points = np.full((3, 10, 3), -1.0, np.float32)
    for b in range(3):
        idx = rng.permutation(7)
        for k, i in enumerate(idx[:4]):
            points[b, k] = (*rng.random(2) * 50, i)
        for k, i in enumerate(idx[4:]):
            points[b, 5 + k] = (*rng.random(2) * 50, i)
    for groups in ([1, 0], [2, 3, 0], [1, 1, 1, -1]):
        got = split_points_by_order(points, groups)
        want = j_split(points, groups)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("offset", [0, 1])
def test_ensemble_matches_jax(probes, offset):
    """Two members: click k served by member min(k, last), with the
    clicker's index offset."""
    from isegprobe_torch.inference.predictor import Predictor
    from isegprobe_tpu.inference.predictor import TPUPredictor

    jmodel, [(pa, ma), (pb, mb)] = probes
    kw = dict(target_size=(SIZE, SIZE), net_clicks_limit=4)
    j = TPUPredictor(jmodel, pa, click_models=[pa, pb], **kw)
    t = Predictor(ma, click_models=[ma, mb], device="cpu", **kw)
    got = _both(j, t, _image(), CLICKS[:3],
                clicker_kw={"click_indx_offset": offset})
    assert t._active_slot == j._active_slot == 1
    plain = Predictor(ma, device="cpu", **kw)
    plain.set_input_image(_image())
    first = plain.get_prediction(_clicker(CLICKS[:1]))
    if offset == 0:
        np.testing.assert_array_equal(got[0], first)
    else:  # the offset puts the first click on the second member
        assert not np.allclose(got[0], first, atol=1e-3)


def test_prev_mask_argument_matches_jax(probes):
    from isegprobe_torch.inference.predictor import Predictor
    from isegprobe_tpu.inference.predictor import TPUPredictor

    jmodel, [(pa, ma), _] = probes
    kw = dict(target_size=(SIZE, SIZE), net_clicks_limit=4)
    rng = np.random.default_rng(5)
    prevs = [None, rng.random((60, 70)).astype(np.float32), None]
    _both(TPUPredictor(jmodel, pa, **kw), Predictor(ma, device="cpu", **kw),
          _image(), CLICKS[:3], prev_masks=prevs)


@pytest.mark.parametrize("mode", ["NoBRS", "f-BRS-B", "DistMap-BRS"])
def test_state_protocol_matches_jax(probes, mode):
    """get_states after two clicks equals JAX's; restoring them after a
    third click and predicting it again gives that click's prediction."""
    from isegprobe_torch.inference.brs import get_predictor
    from isegprobe_torch.inference.clicker import Click, Clicker
    from isegprobe_tpu.inference.brs import get_predictor as j_get
    from isegprobe_tpu.inference.clicker import Click as JClick
    from isegprobe_tpu.inference.clicker import Clicker as JClicker

    jmodel, [(pa, ma), _] = probes
    zoom = {"target_size": (SIZE, SIZE), "skip_clicks": -1}
    kw = dict(brs_mode=mode, zoom_in_params=zoom,
              lbfgs_params={"maxfun": 2},
              predictor_params={"net_clicks_limit": 4})
    j = j_get(jmodel, pa, **kw)
    t = get_predictor(ma, device="cpu", **kw)
    img = _image()
    j.set_input_image(img)
    t.set_input_image(img)
    jc, tc = JClicker(), Clicker()
    for pos, coords in CLICKS[:2]:
        jc.add_click(JClick(pos, coords))
        tc.add_click(Click(pos, coords))
        j.get_prediction(jc)
        t.get_prediction(tc)
    js, ts = j.get_states(), t.get_states()
    assert sorted(ts) == sorted(js)
    assert ts["object_roi"] == js["object_roi"]
    np.testing.assert_allclose(ts["prev_prediction"], js["prev_prediction"],
                               atol=PROB_TOL)
    if mode != "NoBRS":
        np.testing.assert_allclose(ts["opt_data"], js["opt_data"],
                                   atol=1e-4 * max(
                                       np.abs(js["opt_data"]).max(), 1e-12))
    tc.add_click(Click(*CLICKS[2]))
    third = t.get_prediction(tc)
    t.set_states(ts)
    np.testing.assert_array_equal(t.get_prediction(tc), third)


# -- the host trunk cache ------------------------------------------------------------

def test_trunk_cache_equals_no_cache(tiny_archs):  # noqa: F811
    """A SimpleViT late-injection probe through the Predictor with its
    trunk cache (the trunk once per ROI) equals the same predictor with
    the cache off, and the JAX TPUPredictor's cached path."""
    from isegprobe_torch.inference.clicker import Click, Clicker
    from isegprobe_torch.inference.predictor import Predictor
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_tpu.inference.predictor import TPUPredictor

    size = 56
    cfg = family_config("dinov2_simplevit", size)
    jmodel, params = _jax_probe(cfg, size)
    model = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    kw = dict(target_size=(size, size), net_clicks_limit=4)
    cached = Predictor(model, device="cpu", **kw)
    assert cached.cache_backbone
    plain = Predictor(model, device="cpu", **kw)
    plain.cache_backbone = False
    trunks = []
    real = model.compute_backbone_trunk
    model.compute_backbone_trunk = lambda x: trunks.append(1) or real(x)
    j = TPUPredictor(jmodel, params, **kw)
    assert j.cache_backbone
    got = _both(j, cached, _image(), CLICKS)
    plain.set_input_image(_image())
    c = Clicker()
    for (pos, coords), want in zip(CLICKS, got):
        c.add_click(Click(pos, coords))
        np.testing.assert_allclose(plain.get_prediction(c), want, rtol=0,
                                   atol=1e-6)
    # the trunk ran once per ROI: fewer times than the clicks
    assert 1 <= len(trunks) < len(CLICKS)
