"""int8 W8A8 serving in the port (``isegprobe_torch/ops/quant.py``,
``quant="int8"`` through the DINOv2, DINO and CLIP towers, the evaluate
CLI's ``dtype=int8``) against the JAX package's (``isegprobe_tpu/ops/
quant.py``, ``QuantDense``, ``evaluate.py``'s ``dtype=int8``), on the same
numpy inputs.

Kernels H and I run on the card only; here :func:`quantize_rows` and
:func:`int8_gemm` compute their plain versions, which ``chip_smoke.py``
holds the kernels against bit for bit. The serving path's cache of the
weights' int8 rows is held to a fresh quantization bit for bit: after
in-place updates, under autograd, and filled under inference mode before
a BRS objective. ``scripts/bench_int8.py`` runs here at a tiny size. The quantizer and the integer
product are exact, so the op-level tests are bitwise: XLA on the CPU
divides, rounds half to even and rescales as the port does (no entry
differs). Whole models are held at a share of the logit scale instead:
bf16 attention and LayerNorm sum in other orders in the two packages, and
a difference of one bf16 step in front of a quantizer can move a value
across a rounding boundary, which moves that entry by a whole quantum.

The fixture ``isegprobe_torch/fixtures/synthetic_int8.npz`` holds the JAX
package's int8 results for the trained 160-epoch flagship
(``synthetic_dinov2_noup_160ep.ckpt`` through ``evaluate.py:
load_model_for_eval(..., {"dtype": "int8"})``): its device evaluator at
``device_batch=8`` (fixed 448² ZoomIn, flip, 20 clicks, target IoU 0.9,
threshold 0.5) on the first 24 objects of ``synthetic2026_50.npz``
(``int8_ious``, ``int8_n``, ``int8_clicks`` as the flagship's there, and
``int8_noc``, ``int8_over_max``, ``int8_miou``), and the logits of one 448²
forward at batch 2 (``logits``): the first object's scene repeated 2× in
each axis (``logits_image``, uint8) and its horizontal flip, each with its
first click (``logits_points``), an empty previous mask. Write it with
``JAX_PLATFORMS=cpu python tests/test_torch_quant.py --export`` (517 s on
an 8-core CPU host, 509 s of it the loop; 1,529,913 bytes written).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # the --export entry
    sys.path.insert(0, str(REPO))
INT8_FIXTURE = REPO / "isegprobe_torch" / "fixtures" / "synthetic_int8.npz"
FLAGSHIP_CKPT = REPO / "assets" / "trained" / "synthetic_dinov2_noup_160ep.ckpt"
EXPORT_OBJECTS, N_CLICKS, EXPORT_BATCH = 24, 20, 8
LOGIT_SIZE = 448
# the port's int8 probe against JAX's, of the logit scale: 2^-6, the bf16
# probes' tolerance (tests/test_torch_bf16.py), which int8 keeps
LOGIT_TOL = 2.0**-6
# int8 against bf16 in probability, the JAX package's own bound
# (tests/test_quant.py:test_probe_model_int8_forward_close_to_bf16)
PROB_TOL = 0.08
# the CPU loop's IoUs against the fixture's, on the clicks that agree
LOOP_IOU_TOL = 5e-3
CPU_LOOP_OBJECTS, CPU_LOOP_CLICKS = 2, 4


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _to_bf16(tree):
    """``evaluate.py``'s cast of every f32 param to bf16."""
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16)
                        if x.dtype == np.float32 else x, tree)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def logits_input(fx):
    """The fixture's 448² batch-2 input: the scene and its flip, each with
    its first click, and an empty previous mask."""
    img = fx["logits_image"].astype(np.float32) / 255.0
    image = np.zeros((2, LOGIT_SIZE, LOGIT_SIZE, 4), np.float32)
    image[0, ..., :3] = img
    image[1, ..., :3] = img[:, ::-1]
    return image, fx["logits_points"].astype(np.float32)


def export(path=INT8_FIXTURE):
    """The JAX int8 device evaluator on the first EXPORT_OBJECTS objects,
    and the int8 logits of the first object's first click."""
    from isegprobe_tpu.inference.metrics import compute_noc_metric, miou_at_k
    from tests.test_torch_fixtures import (
        FIXTURE,
        TARGET,
        _evaluate_cli,
        _objects,
        jax_device_run,
    )

    t0 = time.time()
    with np.load(FIXTURE) as fx:
        images, labels, objects = fx["images"], fx["labels"], fx["objects"]
        first = fx["flagship_clicks"][0, 0]
    ious, n, clicks = jax_device_run(
        FLAGSHIP_CKPT, _objects(images, labels, objects,
                                slice(0, EXPORT_OBJECTS)),
        batch_size=EXPORT_BATCH, max_clicks=N_CLICKS, dtype="int8")
    per_object = [ious[i, :n[i]] for i in range(len(n))]
    noc, _, over_max = compute_noc_metric(per_object, [0.8, 0.85, 0.9],
                                          N_CLICKS)
    print(f"loop: {time.time() - t0:.0f} s; NoC@80/85/90 {noc}", flush=True)

    scene = int(objects[0, 0])
    image = np.repeat(np.repeat(images[scene], 2, 0), 2, 1)
    y, x, _ = (int(v) for v in first)
    points = np.full((2, 2, 3), -1, np.float32)
    points[0, 0] = (2 * y, 2 * x, 0)
    points[1, 0] = (2 * y, LOGIT_SIZE - 1 - 2 * x, 0)
    out = dict(int8_ious=ious, int8_n=n, int8_clicks=clicks,
               int8_objects=np.int16(len(n)), int8_noc=np.asarray(noc),
               int8_over_max=np.asarray(over_max),
               int8_miou=miou_at_k(per_object, N_CLICKS),
               logits_image=image, logits_points=points)
    model, params = _evaluate_cli().load_model_for_eval(
        str(FLAGSHIP_CKPT), {"dtype": "int8"}, target_size=TARGET)
    inp = logits_input(out)
    out["logits"] = np.asarray(jax.jit(model.apply)(
        {"params": params}, *inp)["instances"], np.float32)
    out["export_seconds"] = np.float32(time.time() - t0)
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes) in "
          f"{time.time() - t0:.0f} s")


# -- the ops -------------------------------------------------------------------

def _jax_quantize(x):
    """The first half of the JAX ``int8_dynamic_matmul``, as it rounds."""
    from isegprobe_tpu.ops.quant import _EPS

    xf = jnp.asarray(x).astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0,
                     _EPS)
    return np.asarray(jnp.round(xf / sx).astype(jnp.int8)), np.asarray(sx)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor in ``dtype``."""
    if dtype == "bfloat16":
        j = jnp.asarray(a).astype(jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _rows(seed: int, shape) -> np.ndarray:
    """Rows of spread magnitudes, an all-zero row and rows whose values sit
    on exact half quanta (scale 1 or 2: x / s = k + 0.5, a tie)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.exp(rng.uniform(-3, 3, (shape[0], 1))).astype(np.float32)
    x[1] = 0.0
    k = shape[1]
    for row, scale in ((2, 1.0), (3, 2.0)):
        ties = rng.integers(-126, 126, k).astype(np.float32) + 0.5
        x[row] = ties * scale
        x[row, 0] = 127.0 * scale  # the absmax sets s = scale exactly
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_matches_jax(dtype):
    """Bitwise, ties and the all-zero row included (its scale is 1e-8 and
    its values 0, no NaN)."""
    from isegprobe_torch.ops.quant import quantize_rows

    xj, xt = _pair(_rows(0, (64, 384)), dtype)
    want_q, want_s = _jax_quantize(xj)
    q, s = quantize_rows(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (64, 1)
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(s.numpy(), want_s)
    assert (q[1] == 0).all() and float(s[1]) == np.float32(1e-8)
    # the ties rounded half to even
    tie = xt[2].float() / s[2]
    assert (tie - tie.floor() == 0.5).float().mean() > 0.9
    assert (q[2].int() % 2 == 0)[tie - tie.floor() == 0.5].all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dynamic_matmul_matches_jax(dtype):
    """[64, 384] x [384, 1536]: bitwise (the JAX kernel is the transpose of
    the port's [N, K] weight); the all-zero row gives 0."""
    from isegprobe_torch.ops.quant import int8_dynamic_matmul
    from isegprobe_tpu.ops.quant import int8_dynamic_matmul as jax_mm

    xj, xt = _pair(_rows(1, (64, 384)), dtype)
    w = (np.random.default_rng(2).standard_normal((384, 1536))
         / 20).astype(np.float32)
    wj, wt = _pair(w, dtype)
    want = np.asarray(jax_mm(xj, wj))
    got = int8_dynamic_matmul(xt, wt.T.contiguous())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[1] == 0).all() and torch.isfinite(got).all()
    # three dimensions, as the blocks call it
    got3 = int8_dynamic_matmul(xt.reshape(4, 16, 384), wt.T.contiguous())
    np.testing.assert_array_equal(got3.reshape(64, 1536).numpy(), want)


@pytest.mark.parametrize("bias_after_cast", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_gemm_epilogue(out_dtype, bias_after_cast):
    """Kernel I's plain version: the JAX epilogue, ``(acc·sx)·sw + bias``
    in f32 then cast (``QuantDense``), or cast then ``+ bias`` in the
    output dtype (MaskCLIP's ``_qkv``), bitwise."""
    from isegprobe_torch.ops.quant import int8_gemm, quantize_rows
    from isegprobe_tpu.ops.quant import int8_dynamic_matmul as jax_mm

    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 256)).astype(np.float32)
    w = rng.standard_normal((96, 256)).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[
        out_dtype]
    y = jax_mm(jnp.asarray(x), jnp.asarray(w.T))
    if bias_after_cast:
        want = y.astype(jdt) + jnp.asarray(b).astype(jdt)
    else:
        want = (y + jnp.asarray(b)).astype(jdt)
    xq, sx = quantize_rows(torch.from_numpy(x))
    wq, sw = quantize_rows(torch.from_numpy(w))
    got = int8_gemm(xq, wq, sx, sw[:, 0], torch.from_numpy(b), out_dtype,
                    bias_after_cast)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_int8_gemm_wrapper_checks():
    """The kernel's wrapper refuses what kernel I does not take (K % 32,
    N % 8) before it loads the library."""
    from isegprobe_torch.ops.quant import _int8_gemm_cuda

    s = torch.ones(8)
    for k, n in ((48, 16), (64, 12)):
        with pytest.raises(ValueError, match="K % 32"):
            _int8_gemm_cuda(torch.zeros(8, k, dtype=torch.int8),
                            torch.zeros(n, k, dtype=torch.int8), s,
                            torch.ones(n), None, torch.float32, False)
    with pytest.raises(TypeError):
        _int8_gemm_cuda(torch.zeros(8, 64), torch.zeros(8, 64), s, s, None,
                        torch.float32, False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_linear_matches_quant_dense(dtype):
    """``QuantLinear`` against ``QuantDense`` on one tree, f32 params in
    either compute dtype and bf16 params (``evaluate.py``'s cast), on a
    [2, 7, 384] input; its parameters are ``nn.Linear``'s."""
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.dtype import set_compute_dtype
    from isegprobe_torch.ops.quant import QuantLinear
    from isegprobe_tpu.ops.quant import QuantDense

    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 384)).astype(np.float32)
    jmod = QuantDense(192, dtype=jdt)
    params = _np(jmod.init(jax.random.PRNGKey(0), x)["params"])
    params["bias"] = rng.standard_normal(192).astype(np.float32)
    layer = QuantLinear(384, 192)
    assert [n for n, _ in layer.named_parameters()] == ["weight", "bias"]
    for tree, cast in ((params, False), (_np(_to_bf16(params)), True)):
        want = np.asarray(jmod.apply({"params": tree}, x))
        mod = load_jax_params(QuantLinear(384, 192), params)
        if cast:
            mod.to(torch.bfloat16)
        set_compute_dtype(mod, tdt)
        with torch.no_grad():
            got = mod(torch.from_numpy(x))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))


def test_quant_linear_gradient_matches_jax():
    """Under autograd the input's gradient flows through its row scales
    only (``round`` and the int cast pass none), as ``jax.vjp`` of
    ``QuantDense`` gives it: Input-BRS through an int8 backbone."""
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.ops.quant import QuantLinear
    from isegprobe_tpu.ops.quant import QuantDense

    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 128)).astype(np.float32)
    g = rng.standard_normal((6, 64)).astype(np.float32)
    jmod = QuantDense(64, dtype=jnp.float32)
    params = _np(jmod.init(jax.random.PRNGKey(1), x)["params"])
    _, vjp = jax.vjp(lambda v: jmod.apply({"params": params}, v),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    mod = load_jax_params(QuantLinear(128, 64), params)
    xt = torch.from_numpy(x).requires_grad_(True)
    mod(xt).backward(torch.from_numpy(g))
    # one nonzero a row (the absmax), as in JAX
    assert ((xt.grad != 0).sum(dim=1) == 1).all()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_unknown_quant_mode_raises():
    from isegprobe_torch.models.featurizers.dinov2 import DINOv2Featurizer
    from isegprobe_torch.models.featurizers.maskclip import (
        CLIPVisionTransformer,
    )
    from isegprobe_torch.models.vit import dense

    for build in (lambda: DINOv2Featurizer(quant="int4"),
                  lambda: CLIPVisionTransformer(width=64, layers=2, heads=2,
                                                quant="fp8"),
                  lambda: dense("int4", 8, 8)):
        with pytest.raises(ValueError, match="Unknown quant mode"):
            build()


# -- the weight cache ------------------------------------------------------------

def _uncached(monkeypatch):
    """Quantize every weight afresh on every call, as the JAX package does
    (the serving path before its weights' rows were cached)."""
    from isegprobe_torch.ops import quant

    monkeypatch.setattr(quant, "_weight_rows",
                        lambda w, cache=True: quant.quantize_rows(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_weight_rows_equal_a_fresh_quantization(dtype):
    """A fixed weight's cached rows and scales are bitwise a fresh
    ``_quantize_rows_plain`` of it (ties and the all-zero row included),
    and a second call serves the same tensors."""
    from isegprobe_torch.ops import quant

    w = torch.from_numpy(_rows(6, (96, 256))).to(dtype)
    wq, sw = quant._weight_rows(w)
    want_q, want_s = quant._quantize_rows_plain(w)
    assert torch.equal(wq, want_q) and torch.equal(sw, want_s)
    again = quant._weight_rows(w)
    assert again[0] is wq and again[1] is sw


@pytest.mark.parametrize("update", ["copy_", "load_state_dict",
                                    "to_bfloat16", "to_bfloat16_and_back"])
def test_weight_cache_requantizes_after_an_update(update):
    """An in-place ``copy_``, ``load_state_dict``, ``.to(bfloat16)`` and
    ``.to(bfloat16).to(float32)`` with no forward between (the new float32
    storage cannot take the old one's address, which the cache holds) each
    make the next forward quantize the weight again: the rows it serves are
    those of the new weight, and the layer's output is the uncached plain
    version's, bit for bit."""
    from isegprobe_torch.ops import quant
    from isegprobe_torch.ops.quant import QuantLinear

    torch.manual_seed(0)
    layer = QuantLinear(128, 64)
    x = torch.randn(5, 128)
    with torch.no_grad():
        layer(x)
    stale = quant._weight_rows_cache[layer.weight][2][0]
    assert torch.equal(stale, quant._quantize_rows_plain(layer.weight)[0])
    new_w = torch.randn(64, 128)
    if update == "copy_":
        with torch.no_grad():
            layer.weight.copy_(new_w)
    elif update == "load_state_dict":
        layer.load_state_dict({"weight": new_w,
                               "bias": layer.bias.detach().clone()})
    elif update == "to_bfloat16":
        layer.to(torch.bfloat16)
        x = x.to(torch.bfloat16)
    else:
        layer.to(torch.bfloat16).to(torch.float32)
    with torch.no_grad():
        got = layer(x)
        want = quant._quant_linear_plain(x, layer.weight, layer.bias,
                                         got.dtype, False)
    wq, sw = quant._weight_rows_cache[layer.weight][2]
    assert wq is not stale
    want_q, want_s = quant._quantize_rows_plain(layer.weight)
    assert torch.equal(wq, want_q) and torch.equal(sw, want_s)
    assert torch.equal(got, want)


def test_a_weight_whose_gradient_is_taken_is_not_cached():
    """Under grad mode a weight that requires grad is quantized afresh and
    gets the plain version's gradient; the same weight's rows are cached
    once grad mode is off (an evaluation), and not served when its
    gradient is taken again."""
    from isegprobe_torch.ops import quant
    from isegprobe_torch.ops.quant import QuantLinear

    torch.manual_seed(1)
    layer = QuantLinear(128, 64)
    x = torch.randn(5, 128)
    layer(x).sum().backward()
    assert layer.weight not in quant._weight_rows_cache
    w = layer.weight.detach().clone().requires_grad_(True)
    quant._quant_linear_plain(x, w, layer.bias.detach(), torch.float32,
                              False).sum().backward()
    assert torch.equal(layer.weight.grad, w.grad) and bool(w.grad.any())
    with torch.no_grad():
        layer(x)
    assert layer.weight in quant._weight_rows_cache
    cached = quant._weight_rows_cache[layer.weight][2][0]
    layer.weight.grad = None
    layer(x).sum().backward()
    assert torch.equal(layer.weight.grad, w.grad)
    assert quant._weight_rows_cache[layer.weight][2][0] is cached


def test_tiny_probe_int8_logits_bitwise_with_and_without_the_cache(
        monkeypatch):
    """The tiny int8 probe (bf16 params and compute): its logits with the
    weights' rows cached, on the forward that fills the cache and on one it
    serves, are bitwise those of the uncached path."""
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.models.vit import init_params
    from isegprobe_torch.ops import quant
    from isegprobe_torch.ops.quant import QuantLinear

    model = init_params(iSegProbeModel(**_tiny_config(), quant="int8",
                                       device="cpu"), seed=0).eval()
    model.to(torch.bfloat16)
    weights = [m.weight for m in model.modules()
               if isinstance(m, QuantLinear)]
    assert len(weights) == 48
    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.random((2, 28, 28, 4)).astype(np.float32))
    pts = torch.from_numpy(np.array(
        [[[10, 12, 0], [20, 5, 1]], [[3, 4, 0], [-1, -1, -1]]], np.float32))
    with torch.inference_mode():
        first = model(img, pts)["instances"]
        served = model(img, pts)["instances"]
    assert all(w in quant._weight_rows_cache for w in weights)
    _uncached(monkeypatch)
    with torch.inference_mode():
        fresh = model(img, pts)["instances"]
    assert torch.equal(first, fresh) and torch.equal(served, fresh)


# -- the towers ----------------------------------------------------------------

TINY = "dinov2_tiny_quant_test"


def _tiny_config(**kw):
    """``tests/test_quant.py:_tiny_model``'s probe (full-width DINOv2 at a
    2x2 token grid, identity upsampler)."""
    return dict(
        backbone_cfg=dict(type="dinov2",
                          params=dict(feats_injection_mode="before_backbone")),
        embed_coords_cfg=dict(type="patchEmbed", params=dict(
            img_size=(28, 28), patch_size=(14, 14), embed_dim=384)),
        head_cfg=dict(type="convhead", params=dict(
            in_channels=384, num_layers=1, num_classes=1)),
        upsampler_cfg=dict(type="identity", params=dict()),
        save_cfg=dict(embed_coords=True, backbone=False, upsampler=False,
                      head=True),
        use_disks=True, norm_radius=5, with_prev_mask=True, **kw)


def _gamma_half(tree):
    """LayerScale gammas at 0.5, so that every block shapes the output."""
    return {k: (_gamma_half(v) if isinstance(v, dict) else
                np.full(v.shape, 0.5, np.float32) if k == "gamma" else v)
            for k, v in tree.items()}


@pytest.mark.parametrize("gamma", ["init", "half"])
def test_tiny_probe_int8_matches_jax(gamma):
    """The JAX package's tiny int8 probe (bf16 compute over f32 params): the
    port's logits within 2^-6 of the logit scale of JAX's (jitted, as it
    serves), and its probabilities within 0.08 of its own bf16 forward's,
    the JAX package's bound. With the gammas at 0.5 the port lies 0.0122
    of the scale from JAX's int8 logits, nearer than JAX's own eager int8
    forward lies from its jitted one (0.0177; in bf16 0.0066 and 0.0048):
    a quantizer turns a bf16 step into a quantum."""
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.ops.quant import QuantLinear
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel

    rng = np.random.default_rng(1)
    img = rng.random((2, 28, 28, 4)).astype(np.float32)
    pts = np.array([[[10, 12, 0]] + [[-1, -1, -1]] * 5] * 2, np.float32)
    pts[1, 3] = (20, 5, 1)
    bf16 = JModel(**_tiny_config(), attn_impl="jnp", dtype=jnp.bfloat16)
    params = _np(bf16.init(jax.random.PRNGKey(0), img, pts)["params"])
    if gamma == "half":
        params = _gamma_half(params)
    jint8 = JModel(**_tiny_config(), attn_impl="jnp", dtype=jnp.bfloat16,
                   quant="int8")
    want = np.asarray(jax.jit(jint8.apply)({"params": params}, img,
                                           pts)["instances"], np.float32)

    port = {q: load_jax_params(iSegProbeModel(
        **_tiny_config(), quant=q, dtype=torch.bfloat16, device="cpu"),
        params) for q in ("int8", None)}
    blocks = port["int8"].backbone.model.blocks
    assert all(isinstance(getattr(m, name), QuantLinear) for b in blocks
               for m, name in ((b.attn, "qkv"), (b.attn, "proj"),
                               (b.mlp, "fc1"), (b.mlp, "fc2")))
    assert not any(isinstance(m, QuantLinear)
                   for part in (port["int8"].embed_coords, port["int8"].head)
                   for m in part.modules())
    with torch.no_grad():
        got = {q: m(torch.from_numpy(img), torch.from_numpy(pts))[
            "instances"].float().numpy() for q, m in port.items()}
    _close(got["int8"], want, LOGIT_TOL)
    err = np.abs(1 / (1 + np.exp(-got["int8"]))
                 - 1 / (1 + np.exp(-got[None]))).max()
    assert err < PROB_TOL, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_tower_int8_matches_jax(dtype):
    """``CLIPVisionTransformer`` (width 64, 2 layers, heads of 32) in int8
    against JAX's, with its asymmetries: (a) the packed ``in_proj`` cast to
    the input's dtype before its bias, (b) ``out_proj``, ``c_fc`` and
    ``c_proj`` writing bf16 in an f32 tower, (c) the value path's
    ``in_proj`` slice in float. Within 2^-6 of the feature scale."""
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.dtype import set_compute_dtype
    from isegprobe_torch.models.featurizers.maskclip import (
        CLIPVisionTransformer,
    )
    from isegprobe_tpu.models.featurizers.maskclip import (
        CLIPVisionTransformer as J,
    )

    rng = np.random.default_rng(3)
    x = rng.random((2, 48, 32, 3)).astype(np.float32)
    kw = dict(patch_size=16, width=64, layers=2, heads=2, output_dim=32,
              pretrain_grid=2)
    params = _np(J(**kw, attn_impl="jnp").init(jax.random.PRNGKey(0),
                                               x)["params"])
    params["resblocks_0"]["attn"]["in_proj_bias"] = rng.standard_normal(
        192).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jmod = J(**kw, attn_impl="jnp", dtype=jdt, quant="int8")
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, x),
                      np.float32)
    # f32 params computing in ``dtype``, as the JAX tower's
    mod = set_compute_dtype(load_jax_params(
        CLIPVisionTransformer(**kw, quant="int8"), params),
        getattr(torch, dtype))
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).float().numpy()
        # (b): bf16 out of the W8A8 layers whatever the compute dtype
        blk = mod.resblocks[0]
        h = torch.from_numpy(rng.standard_normal((1, 3, 64)).astype(
            np.float32))
        assert blk.attn.out_proj(h).dtype == torch.bfloat16
        assert blk.c_fc(h).dtype == torch.bfloat16
        # (a): the packed in_proj writes the input's dtype
        assert blk.attn._qkv(h).dtype == torch.float32
    assert got.shape == want.shape == (2, 6, 32)
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("mode", ["no_injection", "before_backbone"])
def test_dino_key_probe_int8_matches_jax(mode, monkeypatch):
    """DINO's key probe reads the last block's quantized qkv, as JAX's
    does: bf16 compute, int8 dense layers, a 2-block 128-wide trunk on a
    4x4 grid read at 5x6; within 2^-6 of the key scale."""
    from isegprobe_torch.models import init_tree as t_init
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.dtype import set_compute_dtype
    from isegprobe_torch.models.featurizers import dino as t_dino
    from isegprobe_tpu.models.featurizers import dino as j_dino

    for mod in (j_dino, t_dino, t_init):
        monkeypatch.setattr(mod, "DINO_TRUNK", dataclasses.replace(
            mod.DINO_TRUNK, embed_dim=128, depth=2, num_heads=2,
            pretrain_grid=(4, 4)))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 80, 96, 3)).astype(np.float32)
    add = rng.standard_normal((2, 30, 128)).astype(np.float32)
    kw = dict(feat_type="key", feats_injection_mode=mode)
    params = _np(j_dino.DINOFeaturizer(**kw, attn_impl="jnp").init(
        jax.random.PRNGKey(2), x, add)["params"])
    jmod = j_dino.DINOFeaturizer(**kw, attn_impl="jnp", dtype=jnp.bfloat16,
                                 quant="int8")
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, x, add),
                      np.float32)
    mod = load_jax_params(t_dino.DINOFeaturizer(**kw, quant="int8"), params)
    set_compute_dtype(mod, torch.bfloat16)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(add)).float()
    assert got.shape == (2, 5, 6, 128)
    _close(got.numpy(), want, LOGIT_TOL)


def test_simple_vit_refuses_quant():
    """The SimpleViT click encoder stays float: asked for int8 it raises, as
    the JAX package's ``build_featurizer`` does; a probe with it in int8
    keeps it float."""
    from isegprobe_torch.models.probe_model import (
        build_simple_vit,
        iSegProbeModel,
        synthetic_config,
    )
    from isegprobe_torch.ops.quant import QuantLinear
    from isegprobe_tpu.models.probe_model import build_featurizer

    params = dict(img_size=(28, 28), patch_size=(14, 14), embed_dim=32,
                  depth=1, heads=2, mlp_dim=64)
    with pytest.raises(NotImplementedError, match="simple_vit"):
        build_featurizer("simple_vit", params, dtype=jnp.bfloat16,
                         attn_impl="jnp", quant="int8")
    with pytest.raises(NotImplementedError, match="simple_vit"):
        build_simple_vit(params, 2, quant="int8")
    model = iSegProbeModel(**synthetic_config("dinov2_simplevit", (56, 56)),
                           quant="int8", device="cpu")
    assert not any(isinstance(m, QuantLinear)
                   for m in model.embed_coords.modules())
    assert sum(isinstance(m, QuantLinear)
               for m in model.backbone.modules()) == 48


def test_int8_model_config_and_params_match_jax():
    """An int8 probe's saved config is the JAX package's ``model_config``
    of its int8 probe (which records ``quant``), and one numpy tree loads
    into the float and the int8 model alike (``QuantDense`` keeps
    ``nn.Dense``'s tree)."""
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.utils.serialization import model_config
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel
    from isegprobe_tpu.utils.serialization import (
        model_config as jax_model_config,
    )

    cfg = _tiny_config()
    jmodel = JModel(**cfg, quant="int8")
    img = np.zeros((1, 28, 28, 4), np.float32)
    pts = np.full((1, 4, 3), -1.0, np.float32)
    params = _np(jax.jit(jmodel.init)(jax.random.PRNGKey(0), img,
                                      pts)["params"])
    float_tree = _np(jax.jit(JModel(**cfg).init)(jax.random.PRNGKey(0), img,
                                                 pts)["params"])
    assert jax.tree.structure(params) == jax.tree.structure(float_tree)
    int8 = load_jax_params(iSegProbeModel(**cfg, quant="int8",
                                          device="cpu"), params)
    f32 = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    a, b = int8.state_dict(), f32.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert model_config(int8) == jax_model_config(jmodel)
    assert model_config(int8)["params"]["quant"] == "int8"


@pytest.fixture(scope="module")
def int8_brs_probe():
    """``tests/test_torch_brs.py``'s tiny probe (2 blocks, width 128, 56²)
    with ``quant="int8"`` over f32 compute, in both packages."""
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.featurizers import dinov2 as t_dinov2
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_tpu.models.featurizers import dinov2 as j_dinov2
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel
    from tests.test_torch_brs import SIZE
    from tests.test_torch_model import (
        TINY_ARCH,
        jax_model_and_params,
        tiny_config,
    )

    mp = pytest.MonkeyPatch()
    for mod in (j_dinov2, t_dinov2):
        mp.setitem(mod.DINOV2_ARCHS, TINY_ARCH, dataclasses.replace(
            mod.DINOV2_ARCHS["dinov2_vits14"], embed_dim=128, depth=2,
            num_heads=2))
    cfg = tiny_config(SIZE)
    _, params = jax_model_and_params(cfg, SIZE, gamma=0.5)
    jmodel = JModel(**cfg, attn_impl="jnp", quant="int8")
    tmodel = load_jax_params(iSegProbeModel(**cfg, quant="int8",
                                            device="cpu"), params)
    yield jmodel, params, tmodel, cfg
    mp.undo()


@pytest.mark.parametrize("mode", ["RGB-BRS", "DistMap-BRS", "f-BRS-B"])
def test_brs_objective_int8_matches_jax(int8_brs_probe, monkeypatch, mode):
    """BRS under int8, as the root CLI runs ``dtype=int8 mode=<BRS>``: the
    objective's value and gradient at x = 0 and at a seeded x, at the
    second click, within test_torch_brs.py's tolerances (value 1e-5
    relative, gradient 1e-4 of its scale; measured 1.9e-7 and 5e-7). The
    Input-BRS gradients cross every W8A8 layer of the backbone, through
    the row scales only, as JAX differentiates ``round`` and the int cast
    as zero."""
    from tests.test_torch_brs import (
        GRAD_TOL,
        SIZE,
        VALUE_TOL,
        _grad_err,
        _jax_vg,
        _objectives,
        _port_vg,
        seeded_x,
    )

    j_func, t_func = _objectives(int8_brs_probe, monkeypatch, mode)
    size = 2 * 128 if mode.startswith("f-BRS") else SIZE * SIZE * 3
    for x in (np.zeros(size), seeded_x(mode, size)):
        want_v, want_g = _jax_vg(j_func, x)
        got_v, got_g = _port_vg(t_func, x)
        assert got_g.shape == want_g.shape == (size,)
        assert abs(got_v - want_v) <= VALUE_TOL * abs(want_v)
        assert _grad_err(got_g, want_g) <= GRAD_TOL


@pytest.mark.parametrize("mode", ["RGB-BRS", "DistMap-BRS", "f-BRS-B"])
def test_weight_rows_cached_under_inference_mode_serve_brs(
        int8_brs_probe, monkeypatch, mode):
    """Rows cached by a forward under ``torch.inference_mode()`` serve a
    later BRS objective under autograd (frozen weights, as an evaluation
    holds them): its value and gradient equal those of the uncached path
    bit for bit, and JAX's within test_torch_brs.py's tolerances. Rows made
    as inference tensors could not be saved for Input-BRS's backward."""
    from isegprobe_torch.ops import quant
    from isegprobe_torch.ops.quant import QuantLinear
    from tests.test_torch_brs import (
        GRAD_TOL,
        SIZE,
        VALUE_TOL,
        _grad_err,
        _jax_vg,
        _objectives,
        _port_vg,
        seeded_x,
    )

    tmodel = int8_brs_probe[2]
    weights = [m.weight for m in tmodel.modules()
               if isinstance(m, QuantLinear)]
    trained = [p for p in tmodel.parameters() if p.requires_grad]
    for p in trained:
        p.requires_grad_(False)
    try:
        rng = np.random.default_rng(9)
        with torch.inference_mode():
            tmodel(torch.from_numpy(rng.random(
                (1, SIZE, SIZE, 4)).astype(np.float32)),
                torch.tensor([[[SIZE / 2, SIZE / 3, 0], [-1, -1, -1]]]))
        rows = {id(w): quant._weight_rows_cache[w][2][0] for w in weights}
        j_func, t_func = _objectives(int8_brs_probe, monkeypatch, mode)
        size = 2 * 128 if mode.startswith("f-BRS") else SIZE * SIZE * 3
        x = seeded_x(mode, size)
        got_v, got_g = _port_vg(t_func, x)
        assert all(quant._weight_rows_cache[w][2][0] is rows[id(w)]
                   for w in weights)
        _uncached(monkeypatch)
        fresh_v, fresh_g = _port_vg(t_func, x)
        assert got_v == fresh_v and np.array_equal(got_g, fresh_g)
        want_v, want_g = _jax_vg(j_func, x)
        assert abs(got_v - want_v) <= VALUE_TOL * abs(want_v)
        assert _grad_err(got_g, want_g) <= GRAD_TOL
    finally:
        for p in trained:
            p.requires_grad_(True)


# -- the trained flagship --------------------------------------------------------

@pytest.fixture(scope="module")
def int8_results():
    with np.load(INT8_FIXTURE) as data:
        return dict(data)


@pytest.fixture(scope="module")
def flagship_int8():
    from isegprobe_torch.evaluate import load_model_for_eval

    return load_model_for_eval(str(FLAGSHIP_CKPT), "int8",
                               (LOGIT_SIZE, LOGIT_SIZE), device="cpu")


def test_int8_fixture_is_consistent(int8_results):
    """The first 24 objects; NoC and mIoU@k recomputed from the stored
    IoUs; clicks present exactly up to each object's count, first clicks
    positive, inside the object and where the f32 fixture's are."""
    from isegprobe_tpu.inference.metrics import compute_noc_metric, miou_at_k
    from tests.test_torch_fixtures import FIXTURE

    fx = int8_results
    k = int(fx["int8_objects"])
    assert k == EXPORT_OBJECTS
    assert fx["int8_ious"].shape == (k, N_CLICKS)
    assert fx["logits"].shape == (2, LOGIT_SIZE, LOGIT_SIZE, 1)
    with np.load(FIXTURE) as scenes:
        objects, labels = scenes["objects"], scenes["labels"]
        f32_clicks = scenes["flagship_clicks"]
        images = scenes["images"]
    np.testing.assert_array_equal(
        fx["logits_image"],
        np.repeat(np.repeat(images[objects[0, 0]], 2, 0), 2, 1))
    per_object = []
    for i, n in enumerate(fx["int8_n"]):
        clicks = fx["int8_clicks"][i]
        assert (clicks[:n] >= 0).all() and (clicks[n:] == -1).all()
        scene, label = objects[i]
        y, x, pos = clicks[0]
        assert pos == 1 and labels[scene, y, x] == label
        np.testing.assert_array_equal(clicks[0], f32_clicks[i, 0])
        per_object.append(fx["int8_ious"][i, :n])
    noc, _, over_max = compute_noc_metric(per_object, [0.8, 0.85, 0.9],
                                          N_CLICKS)
    np.testing.assert_array_equal(fx["int8_noc"], noc)
    np.testing.assert_array_equal(fx["int8_over_max"], over_max)
    np.testing.assert_array_equal(fx["int8_miou"],
                                  miou_at_k(per_object, N_CLICKS))
    assert noc[2] < 10  # the int8 probe segments


def test_load_model_for_eval_int8(flagship_int8, int8_results):
    """``load_model_for_eval(dtype="int8")``: bf16 params, the backbone's
    48 dense layers in W8A8; its 448² logits within 2^-6 of the logit
    scale of JAX's int8 logits in the fixture."""
    from isegprobe_torch.ops.quant import QuantLinear

    model, info = flagship_int8
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert sum(isinstance(m, QuantLinear) for m in model.modules()) == 48
    assert info["config"]["params"]["backbone_cfg"]["params"][
        "pretrain_grid"] == (32, 32)
    image, points = logits_input(int8_results)
    with torch.no_grad():
        got = model(torch.from_numpy(image), torch.from_numpy(points))[
            "instances"].float().numpy()
    _close(got, int8_results["logits"], LOGIT_TOL)


def test_int8_loop_clicks_as_the_fixture(flagship_int8, int8_results):
    """The port's int8 device loop on the CPU (448², flip, the export's
    protocol) on the first 2 objects for 4 clicks: the JAX int8
    evaluator's clicks, IoUs within 5e-3."""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_device,
        make_device_evaluator,
    )

    fx = int8_results
    k = CPU_LOOP_CLICKS
    run = make_device_evaluator(flagship_int8[0], target_size=(448, 448),
                                max_clicks=k, net_clicks_limit=N_CLICKS,
                                pred_thr=0.5, target_iou=0.9,
                                batch_size=CPU_LOOP_OBJECTS,
                                record_clicks=True, device="cpu")
    clicks: list = []
    got = evaluate_dataset_device(
        run, SceneDataset(SYNTHETIC_FIXTURE,
                          objects=slice(0, CPU_LOOP_OBJECTS)),
        clicks=clicks)
    for i in range(CPU_LOOP_OBJECTS):
        n = min(k, int(fx["int8_n"][i]))
        assert len(got[i]) == n
        assert [tuple(int(v) for v in c) for c in clicks[i][:n]] == [
            tuple(int(v) for v in c) for c in fx["int8_clicks"][i, :n]]
        np.testing.assert_allclose(got[i], fx["int8_ious"][i, :n], rtol=0,
                                   atol=LOOP_IOU_TOL)


def test_evaluate_cli_int8_matches_jax(tmp_path, capsys):
    """``python -m isegprobe_torch.evaluate ... dtype=int8`` end to end at
    a 112² crop on three stored objects: the host protocol and the device
    loop against the root evaluate.py's int8 model under the JAX host
    protocol (IoUs within 5e-3), and a BRS mode (``RGB-BRS``, its gradient
    through the int8 backbone) through the command line."""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.evaluate import evaluate, main, parse_args
    from isegprobe_tpu.inference.evaluation import evaluate_dataset
    from isegprobe_tpu.inference.predictor import TPUPredictor
    from tests.test_torch_fixtures import _evaluate_cli

    with np.load(SYNTHETIC_FIXTURE) as fx:
        scenes = tmp_path / "scenes.npz"
        np.savez(scenes, images=fx["images"][:2], labels=fx["labels"][:2],
                 objects=fx["objects"][:3])
    args = [f"checkpoint={FLAGSHIP_CKPT}", "datasets=Synthetic",
            f"scenes={scenes}",
            "eval_mode=fixed112", "n_clicks=3", "device=cpu",
            "print_ious=false", "dtype=int8"]
    jmodel, jparams = _evaluate_cli().load_model_for_eval(
        str(FLAGSHIP_CKPT), {"dtype": "int8"}, target_size=(112, 112))
    assert jmodel.quant == "int8"
    want, _ = evaluate_dataset(
        SceneDataset(scenes),
        TPUPredictor(jmodel, jparams, target_size=(112, 112),
                     skip_clicks=-1, with_flip=True, net_clicks_limit=3),
        max_iou_thr=0.9, pred_thr=0.5, min_clicks=1, max_clicks=3)
    for extra in ([], ["device_loop=true", "device_batch=2"]):
        got = evaluate(parse_args(args + extra))
        assert [len(a) for a in got["all_ious"]] == [len(a) for a in want]
        for g, w in zip(got["all_ious"], want):
            np.testing.assert_allclose(g, w, rtol=0, atol=LOOP_IOU_TOL)
    assert main(args + ["mode=RGB-BRS", "n_clicks=2"]) == 0
    assert "NoC@90%" in capsys.readouterr().out


# -- bench_int8 ------------------------------------------------------------------

def test_bench_int8_runs_on_cpu_at_a_tiny_size():
    """``scripts/bench_int8.py`` on the CPU: the plain versions at a tiny
    size, each case bitwise, nothing timed, no launch counted; its default
    cases are the int8 phase's shapes."""
    from isegprobe_torch.ops import quant
    from isegprobe_torch.scripts import bench_int8

    assert [c[:3] for c in bench_int8.I_CASES[:4]] == [
        ("flagship qkv", 16400, 384), ("flagship proj", 16400, 384),
        ("flagship fc1", 16400, 384), ("flagship fc2", 16400, 1536)]
    assert bench_int8.I_CASES[8] == ("maskclip in_proj", 1570, 768, 2304,
                                     "bfloat16", True)
    before = (quant.quantize_rows.launches, quant.int8_gemm.launches)
    h_cases = [((40, 64), "bfloat16", "activations"),
               ((16, 96), "float32", "weight")]
    i_cases = [("a", 33, 64, 24, "bfloat16", False),
               ("b", 5, 96, 16, "float32", True)]
    rec = bench_int8.main(device="cpu", label="tiny", h_cases=h_cases,
                          i_cases=i_cases)
    assert rec["label"] == "tiny" and rec["device"] == "cpu"
    assert [c["kernel"] for c in rec["cases"]] == ["quantize_rows"] * 2 + [
        "int8_gemm"] * 2
    assert all(c["bitwise_equal"] and c["ms"] is None
               and c["bound_by"] in ("bytes", "operations")
               for c in rec["cases"])
    assert rec["cases"][3]["bias_after_cast"] and "host" not in rec
    assert (quant.quantize_rows.launches, quant.int8_gemm.launches) == before


def test_bench_int8_raises_without_a_gpu_unless_asked_for_the_cpu(
        monkeypatch):
    from isegprobe_torch.scripts import bench_int8

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        bench_int8.main(h_cases=[((8, 32), "float32", "weight")],
                        i_cases=[])


if __name__ == "__main__":
    if sys.argv[1:] != ["--export"]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_quant.py"
                 " --export")
    export()
