"""The port's converters of published torch checkpoints against the JAX
package's (``isegprobe_tpu/models/convert.py``), on state dicts drawn from
a seed in each checkpoint's published layout
(``isegprobe_torch/utils/drawn_weights.py``: the real key names and shapes,
fp16 for CLIP), at small depths and widths.

Tolerances: every converted tree bitwise equal to JAX's (the same float32
casts and transposes); a module built on a converted tree within 1e-5 of
the JAX module's output scale (the same f32 arithmetic in another order).

``JAX_PLATFORMS=cpu python tests/test_torch_convert.py --export`` writes
the fixture ``isegprobe_torch/fixtures/converted_weights.npz`` that
``chip_smoke.py`` phase 11j holds the card against: the seeds, keys and
shapes of each full-width drawn state dict (DINO-S/16, CLIP ViT-B/16 in
fp16, LiFT, raw LoftUp, a second DINOv2-S/14), 4096 sampled entries and
the norm of JAX's outputs on them (DINO key features, MaskCLIP dense
features and text embeddings, LiFT and LoftUp features), the tokenizer's
ids on a merges file, and the JAX trainer's first loss on the train-step
fixture's batch with that DINOv2 as ``PRETRAINED_MODELS.DINOV2_VITS14``.
"""

import hashlib
import pickle
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # the --export entry
    sys.path.insert(0, str(REPO))

from isegprobe_torch.models import convert as P  # noqa: E402
from isegprobe_torch.utils import drawn_weights as D  # noqa: E402
from tests.test_torch_families import (  # noqa: E402,F401  (fixture)
    TINY,
    WIDTH,
    tiny_archs,
)

torch.set_num_threads(2)

TOL = 1e-5
# the train step's loss against JAX's, relative: the largest error of
# the full-width steps held so far (tests/test_torch_family_training.py)
STEP_LOSS_RTOL = 5.9e-6
FIXTURE = REPO / "isegprobe_torch" / "fixtures" / "converted_weights.npz"
SAMPLES = 4096
# the fixture's strings for the CLIP text tower, and the words its merges
# file spells
TEXTS = ("a photo of a cat", "a dog on the grass", "an object")
MERGE_WORDS = ("photo", "of", "cat", "dog", "on", "the", "grass", "an",
               "object")


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def assert_same_tree(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32, path
    assert got.shape == want.shape and np.array_equal(got, want), path


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


# -- each converter bitwise against JAX's -------------------------------------

VIT = dict(depth=3, dim=24, patch=14, grid=4)


@pytest.mark.parametrize("chunks", [0, 2, 3], ids=["plain", "chunks2",
                                                   "chunks3"])
def test_convert_vit_dinov2_matches_jax(chunks):
    """DINOv2 with LayerScale, plain and in ``block_chunks`` layouts (the
    chunked one flattened by the regex), ``mask_token`` ignored."""
    from isegprobe_tpu.models import convert as J

    sd = D.draw_state_dict(D.vit_layout(**VIT, chunks=chunks), 1)
    if chunks:
        assert "blocks.1.2.norm1.weight" in sd or "blocks.2.2.norm1.weight" \
            in sd
    got = P.convert_vit(sd, 3, layerscale=True)
    assert_same_tree(got, J.convert_vit(sd, 3, layerscale=True))
    assert "ls1" in got["blocks_2"] and "mask_token" not in got
    # the chunked layout converts to the plain layout's tree
    plain = D.draw_state_dict(D.vit_layout(**VIT), 1)
    assert_same_tree(got, P.convert_vit(plain, 3, layerscale=True))


def test_convert_vit_dino_matches_jax():
    """DINO: no LayerScale, the classifier ``head.*`` ignored; numpy
    values are taken as torch tensors are."""
    from isegprobe_tpu.models import convert as J

    sd = D.draw_state_dict(D.vit_layout(**VIT, layerscale=False), 2)
    assert "head.weight" in sd
    got = P.convert_vit(sd, 3)
    assert_same_tree(got, J.convert_vit(sd, 3))
    assert_same_tree(P.convert_vit({k: v.numpy() for k, v in sd.items()}, 3),
                     got)


CLIP = dict(layers=2, width=32, grid=3, output_dim=16, text_layers=2,
            text_width=24, vocab=600, context=9)


@pytest.mark.parametrize("prefix", ["visual.", ""], ids=["full", "visual"])
def test_convert_clip_matches_jax(prefix):
    """CLIP in fp16 (widened to f32 exactly), from a full state dict or
    the visual tower's own keys; the text tower from the same file."""
    from isegprobe_tpu.models import convert as J

    sd = D.draw_state_dict(D.clip_layout(**CLIP), 3, torch.float16)
    assert sd["visual.proj"].dtype == torch.float16
    visual = {k.removeprefix("visual."): v for k, v in sd.items()
              if k.startswith("visual.")}
    got = P.convert_clip_visual(sd if prefix else visual, 2)
    assert_same_tree(got, J.convert_clip_visual(visual, 2))
    np.testing.assert_array_equal(got["proj"],
                                  sd["visual.proj"].float().numpy())
    assert_same_tree(P.convert_clip_text(sd, 2), J.convert_clip_text(sd, 2))


def test_convert_clip_visual_reads_only_the_visual_keys():
    """In a full CLIP state dict the text tower's ``transformer.*`` and
    ``positional_embedding`` take the visual tower's names once the
    ``visual.`` prefix is stripped. The JAX converter strips it from every
    key, so the tower that comes later in the file wins: in OpenAI's order
    (``visual`` registered before the text ``transformer``) its visual
    blocks are the text tower's. The port reads the ``visual.`` keys
    only."""
    from isegprobe_tpu.models import convert as J

    sd = D.draw_state_dict(D.clip_layout(**CLIP), 3, torch.float16)
    jax_tree = J.convert_clip_visual(sd, 2)
    text_ln = sd["transformer.resblocks.0.ln_1.weight"].float().numpy()
    np.testing.assert_array_equal(jax_tree["resblocks_0"]["ln_1"]["scale"],
                                  text_ln)
    got = P.convert_clip_visual(sd, 2)
    assert got["resblocks_0"]["ln_1"]["scale"].shape == (32,)
    np.testing.assert_array_equal(
        got["resblocks_0"]["ln_1"]["scale"],
        sd["visual.transformer.resblocks.0.ln_1.weight"].float().numpy())


def test_convert_lift_matches_jax():
    """LiFT saved from DataParallel (``module.``), ConvTranspose weights
    read as [in, out, kh, kw]; BatchNorm's ``num_batches_tracked``
    skipped."""
    from isegprobe_tpu.models import convert as J

    sd = D.draw_state_dict(D.lift_layout(48), 4)
    got = P.convert_lift(sd)
    assert_same_tree(got, J.convert_lift(sd))
    assert got["up_transpose"]["kernel"].shape == (2, 2, 80, 40)
    assert_same_tree(P.convert_lift({k.removeprefix("module."): v
                                     for k, v in sd.items()}), got)


def test_convert_loftup_raw_and_post_surgery_match_jax():
    from isegprobe_tpu.models import convert as J

    sd = D.draw_state_dict(D.loftup_raw_layout(32, 4, 2), 5)
    got = P.convert_loftup_raw(sd, 2)
    assert_same_tree(got, J.convert_loftup_raw(sd, 2))
    up = {k.removeprefix("upsampler."): v for k, v in sd.items()
          if k.startswith("upsampler.")}
    cn = {"norm.weight": sd["model.1.norm.weight"],
          "norm.bias": sd["model.1.norm.bias"]}
    assert_same_tree(P.convert_loftup(up, cn, 2),
                     J.convert_loftup(up, cn, 2))
    assert_same_tree(P.convert_loftup(up, cn, 2), got)


def test_model_1_prefix_is_matched_as_a_prefix():
    """The JAX converter selects the ChannelNorm by the substring
    ``model.1`` but strips the prefix ``model.1.``: keys such as
    ``model.10.*`` or ``upsampler.model.1.*`` land in its ChannelNorm dict
    unstripped. The port selects by the prefix, so they stay out. The
    converted trees agree (the ChannelNorm reads ``norm.*`` alone)."""
    from isegprobe_tpu.models import convert as J

    sd = D.draw_state_dict(D.loftup_raw_layout(32, 4, 2), 6)
    sd["model.10.norm.weight"] = torch.ones(7)
    sd["upsampler.model.1.extra"] = torch.ones(3)
    seen = {}

    def spy(conv):
        def wrapped(upsampler_sd, channelnorm_sd, num_layers=2):
            seen[conv.__module__] = sorted(channelnorm_sd)
            return conv(upsampler_sd, channelnorm_sd, num_layers)
        return wrapped

    orig_j, orig_p = J.convert_loftup, P.convert_loftup
    J.convert_loftup, P.convert_loftup = spy(orig_j), spy(orig_p)
    try:
        jax_tree = J.convert_loftup_raw(sd, 2)
        got = P.convert_loftup_raw(sd, 2)
    finally:
        J.convert_loftup, P.convert_loftup = orig_j, orig_p
    assert seen[orig_j.__module__] == ["model.10.norm.weight", "norm.bias",
                                       "norm.weight",
                                       "upsampler.model.1.extra"]
    assert seen[orig_p.__module__] == ["norm.bias", "norm.weight"]
    assert_same_tree(got, jax_tree)


def test_pad_loftup_params_matches_jax():
    """The padded layout bitwise: head-interleaved in-projection rows,
    ``out_proj`` rows scattered to match, BatchNorm variance padded with
    ones, everything else zero-padded."""
    from isegprobe_tpu.models import convert as J

    tree = P.convert_loftup_raw(D.draw_state_dict(
        D.loftup_raw_layout(32, 4, 2), 7), 2)
    got = P.pad_loftup_params(tree, n_dim=32, n_freqs=4, heads=4)
    assert_same_tree(got, J.pad_loftup_params(tree, n_dim=32, n_freqs=4,
                                              heads=4))
    var = got["first_conv1"]["bn"]["var"]
    assert var.shape == (128,) and np.all(var[52:] == 1)
    w = got["ca_transformer"]["ca_0"]["attention"]["in_proj_weight"]
    assert w.shape == (384, 128) and not w[13:32].any() and w[32:45].any()


def _reference(wrapped: bool):
    """The trained flagship checkpoint's modules in the reference layout."""
    from isegprobe_torch.utils.serialization import load_checkpoint

    params, config, _ = load_checkpoint(
        REPO / "assets" / "trained" / "synthetic_dinov2_noup_160ep.ckpt")
    return params, config, D.reference_checkpoint(params, config["params"],
                                                  wrapped)


@pytest.mark.parametrize("wrapped", [True, False], ids=["serialized",
                                                        "plain"])
def test_convert_reference_checkpoint_matches_jax(wrapped):
    """A reference checkpoint with its config in ``@serialize`` wrappers or
    plain: JAX's tree and config, the checkpoint's own params bitwise, and
    a config the port's ``build_model`` builds."""
    from isegprobe_tpu.models import convert as J
    from isegprobe_torch.utils.serialization import build_model

    params, config, ref = _reference(wrapped)
    got = P.convert_reference_checkpoint(ref)
    want = J.convert_reference_checkpoint(ref)
    assert_same_tree(got["params"], want["params"])
    assert_same_tree(got["params"], params)
    assert got["config"] == want["config"]
    assert got["config"]["class"] == config["class"]
    assert all(got["config"]["params"][k] == config["params"][k]
               for k in got["config"]["params"])
    model = build_model(got["config"], "cpu")
    assert model.embed_coords.proj.out_channels == 384
    assert P.convert_reference_checkpoint(
        {"state_dict": ref["state_dict"]})["config"] is None


# -- the converted trees on the port's modules --------------------------------

def test_restrict_to_module_drops_what_the_module_never_calls():
    from isegprobe_torch.models.featurizers.maskclip import (
        CLIPVisionTransformer,
    )

    tree = P.convert_clip_visual(D.draw_state_dict(
        D.clip_layout(**CLIP), 8, torch.float16), 2)
    module = CLIPVisionTransformer(patch_size=16, width=32, layers=2,
                                   heads=2, output_dim=16, pretrain_grid=3)
    with pytest.raises(KeyError, match="unexpected"):
        P.load_jax_params(module, tree)
    kept = P.restrict_to_module(tree, module)
    assert sorted(kept["resblocks_1"]) == ["attn", "ln_1"]
    assert kept["resblocks_0"] == tree["resblocks_0"]
    P.load_jax_params(module, kept)


@pytest.mark.parametrize("family", ["dino", "maskclip"])
def test_converted_backbones_match_jax(tiny_archs, family):
    """A drawn DINO or CLIP file at the tiny archs, converted, on the
    port's featurizer and on JAX's (the unused layers dropped by the port,
    ignored by flax)."""
    from isegprobe_torch.models.probe_model import BACKBONES
    from isegprobe_tpu.models.probe_model import build_featurizer

    if family == "dino":
        sd = D.draw_state_dict(D.vit_layout(depth=2, dim=WIDTH, patch=16,
                                            grid=4, layerscale=False), 9)
        tree = P.convert_vit(sd, 2)
        btype, params = "vit", dict(feat_type="key")
    else:
        sd = D.draw_state_dict(D.clip_layout(
            layers=3, width=WIDTH, grid=4, output_dim=64, text_layers=1,
            text_width=16, vocab=50, context=5), 9, torch.float16)
        tree = P.convert_clip_visual(sd, 3)
        btype, params = "mask_clip", dict(model_name=TINY)
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    jmod = build_featurizer(btype, params, dtype=jax.numpy.float32,
                            attn_impl="jnp", quant=None)
    want = np.asarray(jax.jit(jmod.apply)({"params": {"model": tree}}, x))
    module = BACKBONES[btype](**params)
    P.load_jax_params(module.model, P.restrict_to_module(tree, module.model))
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_raw_upsampler_checkpoints_load_as_in_jax(tmp_path):
    """``load_upsampler_params`` on raw torch files (``torch.load`` with
    ``weights_only``; a ``state_dict`` entry unwrapped) gives JAX's trees,
    and a file that needs a pickled global is refused."""
    from isegprobe_tpu.models import convert as J

    for utype, layout in (("loftup", D.loftup_raw_layout(32, 4, 2)),
                          ("lift", D.lift_layout(32))):
        sd = D.draw_state_dict(layout, 10)
        path = tmp_path / f"{utype}.pth"
        torch.save({"state_dict": sd} if utype == "lift" else sd, path)
        cfg = {"type": utype, "params": {"upsampler_path": str(path)}}
        assert_same_tree(P.load_upsampler_params(cfg),
                         J.load_upsampler_params(cfg))
    bad = tmp_path / "pickled.pth"
    with open(bad, "wb") as f:
        pickle.dump({"obj": Path("x")}, f)
    with pytest.raises(pickle.UnpicklingError):
        P.load_upsampler_params({"type": "loftup",
                                 "params": {"upsampler_path": str(bad)}})


def test_converted_upsamplers_match_jax(tmp_path):
    """Drawn raw LoftUp and LiFT files at width 32, through
    ``load_upsampler_params``, on the port's modules and JAX's."""
    from isegprobe_torch.models.upsamplers.lift import LiFTUpsampler
    from isegprobe_torch.models.upsamplers.loftup import LoftUpUpsampler
    from isegprobe_tpu.models.upsamplers.lift import LiFTUpsampler as JLiFT
    from isegprobe_tpu.models.upsamplers.loftup import \
        LoftUpUpsampler as JLoftUp

    rng = np.random.default_rng(2)
    src = rng.standard_normal((1, 4, 4, 32)).astype(np.float32)
    img = rng.random((1, 56, 56, 3)).astype(np.float32)
    for utype, layout, jmod, mod in (
            ("loftup", D.loftup_raw_layout(32), JLoftUp(
                n_dim=32, attn_impl="jnp"), LoftUpUpsampler(n_dim=32)),
            ("lift", D.lift_layout(32), JLiFT(n_dim=32),
             LiFTUpsampler(n_dim=32))):
        path = tmp_path / f"{utype}.pth"
        torch.save(D.draw_state_dict(layout, 11), path)
        tree = P.load_upsampler_params(
            {"type": utype, "params": {"upsampler_path": str(path)}})
        want = np.asarray(jax.jit(jmod.apply)({"params": tree}, src, img))
        P.load_jax_params(mod, tree)
        with torch.no_grad():
            got = mod(torch.from_numpy(src), torch.from_numpy(img)).numpy()
        _close(got, want)


# -- the command-line scripts -------------------------------------------------

@pytest.mark.parametrize("kind", ["dinov2", "dino", "clip", "clip_text",
                                  "lift", "loftup"])
def test_convert_weights_cli_matches_jax(tmp_path, kind):
    """``python -m isegprobe_torch.scripts.convert_weights`` writes the
    JAX converter's tree, read back by flax's ``msgpack_restore`` (a DINO
    file's ``model`` entry unwrapped, as the root script does)."""
    from flax import serialization as flax_serialization

    from isegprobe_torch.scripts import convert_weights
    from isegprobe_tpu.models import convert as J

    depth = 2
    if kind in ("dinov2", "dino"):
        sd = D.draw_state_dict(D.vit_layout(depth=depth, dim=24, grid=4,
                                            layerscale=kind == "dinov2",
                                            chunks=2 * (kind == "dinov2")),
                               12)
        want = J.convert_vit(sd, depth, layerscale=kind == "dinov2")
        saved = {"model": sd} if kind == "dino" else sd
    elif kind in ("clip", "clip_text"):
        sd = D.draw_state_dict(D.clip_layout(**CLIP), 12, torch.float16)
        visual = {k.removeprefix("visual."): v for k, v in sd.items()
                  if k.startswith("visual.")}
        want = (J.convert_clip_visual(visual, depth) if kind == "clip"
                else J.convert_clip_text(sd, depth))
        saved = sd
    else:
        sd = D.draw_state_dict(D.lift_layout(32) if kind == "lift"
                               else D.loftup_raw_layout(32), 12)
        want = (J.convert_lift(sd) if kind == "lift"
                else J.convert_loftup_raw(sd))
        saved = {"state_dict": sd}
    src, out = tmp_path / "in.pth", tmp_path / "out" / "w.msgpack"
    torch.save(saved, src)
    assert convert_weights.main(["--kind", kind, "--input", str(src),
                                 "--output", str(out),
                                 "--depth", str(depth)]) == 0
    assert_same_tree(_np_tree(flax_serialization.msgpack_restore(
        out.read_bytes())), want)


def test_convert_reference_checkpoint_cli_is_read_by_jax(tmp_path):
    """``python -m isegprobe_torch.scripts.convert_reference_checkpoint``:
    the JAX package's ``load_checkpoint`` reads the file and its
    ``build_model`` builds the config; params equal the trained
    checkpoint's."""
    from isegprobe_torch.scripts import convert_reference_checkpoint as cli
    from isegprobe_tpu.utils.serialization import build_model, load_checkpoint

    params, config, ref = _reference(True)
    src, out = tmp_path / "ref.pth", tmp_path / "converted.ckpt"
    torch.save(ref, src)
    assert cli.main(["--input", str(src), "--output", str(out)]) == 0
    got, got_config, _ = load_checkpoint(out)
    assert_same_tree(_np_tree(got), params)
    assert build_model(got_config).embed_coords_cfg == \
        config["params"]["embed_coords_cfg"]
    torch.save({"state_dict": ref["state_dict"]}, src)
    with pytest.raises(SystemExit, match="no serialized config"):
        cli.main(["--input", str(src), "--output", str(out)])


# -- the fixture --------------------------------------------------------------

def test_fixture_redraws_and_its_layouts_are_the_published_ones():
    """The committed fixture's state dicts are the published layouts at
    full width, and the card redraws them from their seeds: each drawn
    value's digest is the one the export recorded."""
    fx = np.load(FIXTURE)
    layouts = {"dino": D.vit_layout(patch=16, grid=14, layerscale=False),
               "clip": D.clip_layout(), "lift": D.lift_layout(),
               "loftup": D.loftup_raw_layout(), "dinov2": D.vit_layout()}
    for name, layout in layouts.items():
        assert [tuple(x) for x in fixture_layout(fx, name)] == \
            [(k, tuple(s)) for k, s in layout]
    # the smallest file, redrawn whole
    sd = D.draw_state_dict(layouts["lift"], int(fx["lift_seed"]))
    np.testing.assert_array_equal(_digests(sd), fx["lift_digest"])
    assert fx["text_ids"].shape == (len(TEXTS), 77)


def test_pretrained_step_matches_the_fixture(tmp_path):
    """The port's full-width flagship step on the CPU, its backbone the
    fixture's drawn DINOv2-S/14 converted by the port's script and named by
    ``PRETRAINED_MODELS.DINOV2_VITS14``: the first loss within
    ``STEP_LOSS_RTOL`` of JAX's (``chip_smoke.py`` phase 11j holds the card
    to the same)."""
    from isegprobe_torch.scripts import convert_weights
    from isegprobe_torch.train import build_trainer, parse_args
    from tests.test_torch_training import STEP_FIXTURE

    torch.set_num_threads(4)
    fx, step = np.load(FIXTURE), np.load(STEP_FIXTURE)
    src, weights = tmp_path / "hub.pth", tmp_path / "dinov2.msgpack"
    torch.save(D.draw_state_dict(D.vit_layout(), int(fx["dinov2_seed"])),
               src)
    convert_weights.main(["--kind", "dinov2", "--input", str(src),
                          "--output", str(weights)])
    trainer = build_trainer(parse_args([
        "model=synthetic_dinov2_noup", "device=cpu", "dataloader.workers=0",
        f"exp_path={tmp_path}", f"PRETRAINED_MODELS.DINOV2_VITS14={weights}"]))
    batch = trainer._upload({k: step[k] for k in ("images", "points",
                                                   "instances")})
    loss = float(trainer._step(batch, 0)[0])
    assert abs(loss / float(fx["dinov2_step_loss"]) - 1) <= STEP_LOSS_RTOL


def fixture_layout(fx, name):
    """(key, shape) of the fixture's layout ``name``."""
    dims = np.split(fx[f"{name}_shapes"], np.cumsum(fx[f"{name}_ndims"])[:-1])
    return [(str(k), tuple(int(d) for d in s))
            for k, s in zip(fx[f"{name}_keys"], dims)]


def _digests(sd) -> np.ndarray:
    """The SHA-256 of a state dict's keys and values' bytes, in order."""
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return np.asarray(h.hexdigest())


def _sample(out: np.ndarray, seed: int) -> dict:
    """``SAMPLES`` entries of ``out`` (flat indices from ``seed``), its
    shape and its L2 norm."""
    flat = out.reshape(-1)
    idx = np.sort(np.random.default_rng(seed).choice(
        flat.size, min(SAMPLES, flat.size), replace=False))
    return {"shape": np.asarray(out.shape), "idx": idx,
            "val": flat[idx].astype(np.float32),
            "norm": np.float64(np.linalg.norm(flat.astype(np.float64)))}


def export(path=FIXTURE):
    """Draw the full-width state dicts, convert them with the JAX package,
    run its modules on drawn inputs and its trainer's first step, and write
    the samples (see the module docstring)."""
    import tempfile

    import jax.numpy as jnp
    from flax import serialization as flax_serialization

    from isegprobe_torch.models.probe_model import synthetic_config
    from isegprobe_tpu.models import convert as J
    from isegprobe_tpu.models.featurizers.clip_tokenizer import ClipTokenizer
    from isegprobe_tpu.models.featurizers.maskclip import CLIPTextEncoder
    from isegprobe_tpu.models.probe_model import build_featurizer
    from isegprobe_tpu.models.upsamplers.lift import LiFTUpsampler
    from isegprobe_tpu.models.upsamplers.loftup import LoftUpUpsampler
    from tests import test_torch_training as tt

    out: dict = {}
    cases = {"dino": (D.vit_layout(patch=16, grid=14, layerscale=False), 101,
                      torch.float32),
             "clip": (D.clip_layout(), 102, torch.float16),
             "lift": (D.lift_layout(), 103, torch.float32),
             "loftup": (D.loftup_raw_layout(), 104, torch.float32),
             "dinov2": (D.vit_layout(), 105, torch.float32)}
    drawn = {}
    for name, (layout, seed, dtype) in cases.items():
        t0 = time.time()
        drawn[name] = D.draw_state_dict(layout, seed, dtype)
        out[f"{name}_seed"] = np.int64(seed)
        out[f"{name}_dtype"] = np.asarray(str(dtype).removeprefix("torch."))
        out[f"{name}_keys"] = np.asarray([k for k, _ in layout])
        out[f"{name}_ndims"] = np.asarray([len(s) for _, s in layout])
        out[f"{name}_shapes"] = np.asarray([d for _, s in layout for d in s],
                                           np.int64)
        out[f"{name}_digest"] = _digests(drawn[name])
        print(f"drew {name} in {time.time() - t0:.1f} s", flush=True)

    def record(name, value, seed):
        for k, v in _sample(np.asarray(value, np.float32), seed).items():
            out[f"{name}_out_{k}"] = v
        print(f"{name}: {np.asarray(value).shape}", flush=True)

    rng = np.random.default_rng(0)
    image = rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
    source = rng.standard_normal((1, 16, 16, 384)).astype(np.float32)
    guidance = rng.random((1, 224, 224, 3)).astype(np.float32)
    out["inputs_seed"] = np.int64(0)

    for name, btype, convert in (
            ("dino", "vit", lambda sd: J.convert_vit(sd, 12)),
            ("clip", "mask_clip", lambda sd: J.convert_clip_visual(
                {k.removeprefix("visual."): v for k, v in sd.items()
                 if k.startswith("visual.")}, 12))):
        script = "vit_noup" if name == "dino" else "maskclip_noup"
        params = synthetic_config(script)["backbone_cfg"]["params"]
        jmod = build_featurizer(btype, params, dtype=jnp.float32,
                                attn_impl="jnp", quant=None)
        tree = convert(drawn[name])
        record(name, jax.jit(jmod.apply)({"params": {"model": tree}},
                                         image), 1)
    for name, jmod in (("lift", LiFTUpsampler(n_dim=384)),
                       ("loftup", LoftUpUpsampler(n_dim=384,
                                                  attn_impl="jnp"))):
        tree = (J.convert_lift(drawn[name]) if name == "lift"
                else J.convert_loftup_raw(drawn[name]))
        record(name, jax.jit(jmod.apply)({"params": tree}, source,
                                         guidance), 2)

    with tempfile.TemporaryDirectory() as tmp:
        merges = D.write_merges(Path(tmp) / "merges.txt.gz", MERGE_WORDS)
        ids = ClipTokenizer(str(merges))(list(TEXTS))
    out["text_strings"] = np.asarray(TEXTS)
    out["merge_words"] = np.asarray(MERGE_WORDS)
    out["text_ids"] = ids
    text = CLIPTextEncoder()
    record("clip_text", jax.jit(text.apply)(
        {"params": J.convert_clip_text(drawn["clip"], 12)}, ids), 3)

    # the flagship's first train step on the train-step fixture's batch,
    # its backbone the drawn DINOv2 through PRETRAINED_MODELS
    step = np.load(tt.STEP_FIXTURE)
    with tempfile.TemporaryDirectory() as tmp:
        weights = Path(tmp) / "dinov2.msgpack"
        weights.write_bytes(flax_serialization.msgpack_serialize(
            J.convert_vit(drawn["dinov2"], 12, layerscale=True)))
        cfg = tt.jax_cfg()
        cfg.PRETRAINED_MODELS = type(cfg)(
            {"DINOV2_VITS14": str(weights)})
        trainset, valset = tt.jax_synthetic_datasets(cfg)
        trainer = tt.jax_flagship_trainer(cfg, trainset, valset)
    batch = {k: step[k] for k in ("images", "points", "instances")}
    t0 = time.time()
    (_, _, loss, _, _, _) = trainer._train_step(
        trainer.params, trainer.opt_state, trainer._prep_batch(batch),
        jax.random.PRNGKey(1), 0, 0.4, 0.025, click_trees=())
    out["dinov2_step_loss"] = np.float64(loss)
    print(f"JAX step with the drawn DINOv2 in {time.time() - t0:.1f} s: "
          f"loss {float(loss)}")
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    if "--export" not in sys.argv[1:]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_convert.py"
                 " --export")
    export()
