"""The port's device EDT, clicker rule and lane-batched ZoomIn sampling
against the JAX package on the same numpy inputs.

On the CPU the port's ``row_envelope`` computes its plain version (CUDA
kernel C runs only on a GPU: tests/test_torch_cuda.py holds it bitwise
against the plain version there); the JAX ``edt_l2sq_device`` takes its
scan path, the plain reference its Pallas kernel is identical to.

Tolerances: EDT values are exact integers in f32 and clicks are decisions,
so both are held to exact equality. The sampling ops are the same f32
arithmetic in another order (a gather and a lerp against the JAX package's
2-tap matmul), so 1e-6 on values in [0, 1].
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isegprobe_torch.ops import edt as t_edt

torch.set_num_threads(2)

SAMPLE_TOL = 1e-6
SHAPES = [(20, 31), (64, 64), (33, 129), (3, 2, 34, 70)]


def _masks(shape, seed, p=0.8):
    return np.random.default_rng(seed).random(shape) < p


def _zero_free_masks():
    """An all-ones mask, and one whose every column lacks a zero over a run
    of rows, with whole zero-free columns."""
    ones = np.ones((12, 17), bool)
    striped = np.ones((24, 40), bool)
    striped[3, ::3] = False
    striped[20, 1::3] = False
    return [ones, striped]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_column_and_row_pass_match_jax(shape):
    from isegprobe_tpu.ops.edt import _column_pass, _row_envelope

    zero = ~_masks(shape, seed=len(shape))
    g_want = np.asarray(_column_pass(jnp.asarray(zero)))
    g = t_edt._column_pass(torch.from_numpy(zero))
    np.testing.assert_array_equal(g.numpy(), g_want)
    before = t_edt.row_envelope.launches
    d2 = t_edt.row_envelope(g)
    assert t_edt.row_envelope.launches == before  # CPU: no kernel launch
    want = np.asarray(_row_envelope(jnp.asarray(g_want)))
    np.testing.assert_array_equal(d2.numpy(), want)
    np.testing.assert_array_equal(t_edt._row_envelope_plain(g, block=16),
                                  want)


@pytest.mark.parametrize("pad_border", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_edt_device_matches_jax(shape, pad_border):
    from isegprobe_tpu.ops.edt import edt_l2sq_device as j_edt

    mask = _masks(shape, seed=sum(shape))
    want = np.asarray(j_edt(jnp.asarray(mask), pad_border=pad_border))
    got = t_edt.edt_l2sq_device(torch.from_numpy(mask),
                                pad_border=pad_border).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", [0, 1], ids=["all_ones", "zero_free_cols"])
def test_zero_free_masks_match_jax_device_clamp(which):
    """No zero pixel, or columns without one: the port's host EDT and device
    EDT both return the JAX device values, float32(1e12) where nothing is
    in reach."""
    from isegprobe_tpu.ops.edt import edt_l2sq_device as j_edt

    mask = _zero_free_masks()[which]
    want = np.asarray(j_edt(jnp.asarray(mask)))
    np.testing.assert_array_equal(t_edt.edt_l2sq(mask), want)
    np.testing.assert_array_equal(
        t_edt.edt_l2sq_device(torch.from_numpy(mask)).numpy(), want)
    if which == 0:
        assert (want == np.float32(1e12)).all()


def _click_cases(n=20, shape=(40, 52), seed=0):
    """Lanes of (gt, pred, not_clicked, not_ignore): blob ground truths,
    noisy predictions, already-clicked holes, an ignore band; one lane with
    no error at all and one whose error region is a tie."""
    rng = np.random.default_rng(seed)
    h, w = shape
    gts, preds, ncs, nis = [], [], [], []
    for i in range(n):
        gt = np.zeros(shape, bool)
        for _ in range(2):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
            gt[y:y + rng.integers(4, 20), x:x + rng.integers(4, 25)] = True
        pred = gt ^ (rng.random(shape) < 0.1)
        if i % 3 == 0:
            pred[rng.integers(0, h):, :rng.integers(1, w)] = False
        nc = rng.random(shape) > 0.02
        ni = np.ones(shape, bool)
        if i % 2:
            ni[:, rng.integers(0, w):][:, :5] = False
        gts.append(gt), preds.append(pred), ncs.append(nc), nis.append(ni)
    preds[1] = gts[1].copy()  # no error: clicks (0, 0) as a negative
    gts[2] = np.zeros(shape, bool)  # two equal squares of false positive
    preds[2] = np.zeros(shape, bool)
    preds[2][5:10, 5:10] = preds[2][20:25, 30:35] = True
    ncs[2] = ncs[1] = np.ones(shape, bool)
    return [np.stack(a) for a in (gts, preds, ncs, nis)]


def test_next_click_matches_jax_lane_by_lane():
    from isegprobe_tpu.ops.edt import next_click_from_error as j_click

    gts, preds, ncs, nis = _click_cases()
    is_pos, y, x = t_edt.next_click_from_error(
        *(torch.from_numpy(a) for a in (gts, preds, ncs, nis)))
    assert is_pos.shape == y.shape == x.shape == (len(gts),)
    for lane in range(len(gts)):
        jp, jy, jx = j_click(*(jnp.asarray(a[lane])
                               for a in (gts, preds, ncs, nis)))
        assert (bool(is_pos[lane]), int(y[lane]), int(x[lane])) == (
            bool(jp), int(jy), int(jx)), lane
    assert (bool(is_pos[1]), int(y[1]), int(x[1])) == (False, 0, 0)
    # the tie goes to the first row-major maximum: the centre of the upper
    # square
    assert (bool(is_pos[2]), int(y[2]), int(x[2])) == (False, 7, 7)


ROIS = np.asarray([(0, 89, 0, 99), (13, 70, 21, 64), (40, 40, 5, 90),
                   (3, 88, 50, 50)], np.int32)


def test_crop_resize_per_lane_rois_match_jax_and_host_roi():
    from isegprobe_tpu.ops.sample import crop_resize as j_crop
    from isegprobe_torch.ops.sample import crop_resize

    img = np.random.default_rng(2).random((4, 96, 112, 4)).astype(np.float32)
    got = crop_resize(torch.from_numpy(img), torch.from_numpy(ROIS),
                      (56, 48)).numpy()
    assert got.shape == (4, 56, 48, 4)
    for lane, roi in enumerate(ROIS):
        want = np.asarray(j_crop(jnp.asarray(img[lane:lane + 1]),
                                 jnp.asarray(roi), (56, 48)))[0]
        np.testing.assert_allclose(got[lane], want, rtol=0, atol=SAMPLE_TOL)
        single = crop_resize(torch.from_numpy(img[lane:lane + 1]),
                             tuple(roi), (56, 48)).numpy()[0]
        np.testing.assert_array_equal(got[lane], single)


def test_crop_resize_reads_uint8_normalised():
    from isegprobe_torch.ops.sample import crop_resize

    img = np.random.default_rng(3).integers(0, 256, (4, 96, 112, 3),
                                            dtype=np.uint8)
    rois = torch.from_numpy(ROIS)
    got = crop_resize(torch.from_numpy(img), rois, (30, 30))
    want = crop_resize(torch.from_numpy(img).float() / 255.0, rois,
                       (30, 30))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_inverse_paste_per_lane_rois_match_jax_and_host_roi():
    from isegprobe_tpu.ops.sample import inverse_paste as j_paste
    from isegprobe_torch.ops.sample import inverse_paste

    probs = np.random.default_rng(4).random((4, 56, 48, 1)).astype(np.float32)
    got = inverse_paste(torch.from_numpy(probs), torch.from_numpy(ROIS),
                        (96, 112)).numpy()
    frame = np.zeros((1, 96, 112, 1), np.float32)
    for lane, roi in enumerate(ROIS):
        want = np.asarray(j_paste(jnp.asarray(probs[lane:lane + 1]),
                                  jnp.asarray(roi), jnp.asarray(frame)))[0]
        np.testing.assert_allclose(got[lane], want, rtol=0, atol=SAMPLE_TOL)
        single = inverse_paste(torch.from_numpy(probs[lane:lane + 1]),
                               tuple(roi), (96, 112)).numpy()[0]
        np.testing.assert_array_equal(got[lane], single)


def test_row_envelope_rejects_other_devices():
    with pytest.raises(ValueError):
        t_edt.row_envelope(torch.zeros(4, 8, device="meta"))


# ---------------------------------------------------------------------------
# The row pass over the rest of its domain: the yardstick of kernel C's GPU
# tests (the plain version) against the JAX package's row pass
# ---------------------------------------------------------------------------


def _edge_zero_masks():
    """Zero masks at the domain's edges, by name: columns taller than 4096
    (g above 4096, so fl(g²) and fl(g²) + d² round in f32), no zero at all
    (rows of sentinels only), W = 1, and one zero a column (at row 0, so g
    runs down every column and minima lie far away)."""
    rng = np.random.default_rng(9)
    tall = np.zeros((4200, 5), bool)  # column 4 has no zero
    tall[0, :4] = True
    tall[50, 2] = True
    one_zero = np.zeros((2, 70, 45), bool)
    one_zero[:, 0, :] = True
    return {"height_4200": tall,
            "sentinel_rows": np.zeros((3, 9, 40), bool),
            "w1": rng.random((2, 50, 1)) < 0.1,
            "one_zero_a_column": one_zero}


@pytest.mark.parametrize("name", ["height_4200", "sentinel_rows", "w1",
                                  "one_zero_a_column"])
def test_row_pass_and_edt_match_jax_at_the_domain_edges(name):
    from isegprobe_tpu.ops.edt import _column_pass, _row_envelope
    from isegprobe_tpu.ops.edt import edt_l2sq_device as j_edt

    zero = _edge_zero_masks()[name]
    g_want = np.asarray(_column_pass(jnp.asarray(zero)))
    g = t_edt._column_pass(torch.from_numpy(zero))
    np.testing.assert_array_equal(g.numpy(), g_want)
    want = np.asarray(_row_envelope(jnp.asarray(g_want)))
    np.testing.assert_array_equal(t_edt.row_envelope(g).numpy(), want)
    np.testing.assert_array_equal(
        t_edt.edt_l2sq_device(torch.from_numpy(~zero)).numpy(),
        np.asarray(j_edt(jnp.asarray(~zero))))
    if name == "height_4200":
        assert g.max() > 4096  # g² rounds in f32
        assert (want > 2**24).any() and (want < 1e12).all()
    if name == "sentinel_rows":
        assert (want == np.float32(1e12)).all()


@pytest.mark.parametrize("name", ["w4096_random", "w4096_adversarial",
                                  "w1_random", "w1_adversarial",
                                  "sentinel_rows", "single_source_rows",
                                  "tall_5000x7", "tall_40000x7"])
def test_domain_inputs_of_kernel_c_match_jax(name):
    """The inputs on which the GPU tests and chip_smoke.py hold kernel C
    bitwise to the plain version: the plain version equals the JAX row
    pass on each."""
    from isegprobe_tpu.ops.edt import _row_envelope

    from isegprobe_torch.scripts import bench_edt

    g = bench_edt.domain_inputs(torch.device("cpu"))[name]
    want = np.asarray(_row_envelope(jnp.asarray(g.numpy())))
    np.testing.assert_array_equal(t_edt._row_envelope_plain(g).numpy(),
                                  want)


def test_bench_edt_runs_on_cpu_at_a_tiny_size():
    from isegprobe_torch.scripts import bench_edt

    assert tuple(bench_edt.domain_inputs(torch.device("cpu"))) == \
        bench_edt.DOMAIN_NAMES
    before = t_edt.row_envelope.launches
    rec = bench_edt.main(device="cpu", label="tiny",
                         shapes=[(2, 2, 12, 20), (1, 2, 7, 33)])
    assert rec["label"] == "tiny" and rec["device"] == "cpu"
    assert [(c["shape"], c["kind"]) for c in rec["cases"]] == [
        (list(s), k) for s in [(2, 2, 12, 20), (1, 2, 7, 33)]
        for k in bench_edt.KINDS]
    assert all(c["bitwise_equal"] and c["ms"] is None
               for c in rec["cases"])  # CPU: the plain version, not timed
    assert t_edt.row_envelope.launches == before
    adv = rec["cases"][2]
    assert adv["kind"] == "adversarial" and adv["max_finite_g"] == 11.0
    assert rec["cases"][1]["zeros"] > 0.5  # the clicker's maps: background


def test_bench_edt_raises_without_a_gpu_unless_asked_for_the_cpu(
        monkeypatch):
    from isegprobe_torch.scripts import bench_edt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        bench_edt.main(shapes=[(1, 2, 4, 4)])
