"""The JAX package's ``model.init(jax.random.PRNGKey(0), image, points)``
param tree, rebuilt in numpy.

Trained checkpoints hold only the trained parts of a probe (``save_cfg``
drops the frozen backbone and upsampler). ``evaluate.py:load_model_for_eval``
rebuilds the rest with ``model.init(PRNGKey(0), ...)`` at the eval size and
overlays the checkpoint. :func:`init_tree` returns that same tree, with the
flax names (nested dicts of float32 numpy arrays), for a checkpoint's
constructor config, so that ``models.convert.load_jax_params`` can take it.

Each param's key is flax's (``utils/jax_rng.flax_param_key``): the full
scope path from the model's root and the param's position among its
module's ``self.param`` calls, counted from 1 whatever the initializer. The
lifted ``nn.remat`` of the DINOv2 blocks (``remat_blocks``) and of LoftUp's
banded slabs passes the scopes' keys through unchanged, so neither the
config's remat flags nor the init image's size moves a key. Values lie
within two ulp of JAX's (``jax_rng``); paths, shapes and keys are exact
(``tests/test_torch_checkpoint.py``).

Covered: the configurations ``models.probe_model.iSegProbeModel`` builds —
the DINOv2, DINO ``vit`` and MaskCLIP backbones, the ``patchEmbed`` and
``simple_vit`` click encoders, the three heads, the identity, LiFT,
LoftUp and JBU-FeatUp upsamplers and the RITM maps transform of
``use_rgb_conv``. flax creates a param when its module is
first called, so a module that is declared but never called has none:
MaskCLIP's last block keeps only ``ln_1`` and ``attn`` (its dense features
take the block's value path).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Tuple

import numpy as np

from isegprobe_torch.models.featurizers.dino import DINO_TRUNK
from isegprobe_torch.models.featurizers.dinov2 import DINOV2_ARCHS
from isegprobe_torch.models.featurizers.maskclip import CLIP_ARCHS
from isegprobe_torch.models.vit import LAYERSCALE_INIT, MLP_RATIO, ViTConfig
from isegprobe_torch.utils import jax_rng

__all__ = ["init_tree", "count_params"]

_OTHER_FAMILIES = "ROADMAP Queue 1 item 7 (other model families)"


def _zeros(key, shape):
    return np.zeros(shape, np.float32)


def _ones(key, shape):
    return np.ones(shape, np.float32)


def _constant(value: float):
    def init(key, shape):
        return np.full(shape, value, np.float32)
    return init


class _Scope:
    """One flax scope: its key, its path below that key, its param counter
    and the subtree it fills."""

    def __init__(self, key: np.ndarray, path: Tuple[str, ...] = ()) -> None:
        self.key = key
        self.path = path
        self.counter = 0
        self.tree: Dict = {}

    def child(self, name: str) -> "_Scope":
        sub = _Scope(self.key, self.path + (name,))
        self.tree[name] = sub.tree
        return sub

    def param(self, name: str, init: Callable, shape) -> None:
        self.counter += 1
        key = jax_rng.flax_param_key(self.key, self.path, self.counter)
        self.tree[name] = np.asarray(init(key, tuple(shape)), np.float32)


def _dense(scope: _Scope, name: str, fan_in: int, features: int,
           bias: bool = True) -> None:
    s = scope.child(name)
    s.param("kernel", jax_rng.lecun_normal, (fan_in, features))
    if bias:
        s.param("bias", _zeros, (features,))


def _conv(scope: _Scope, name: str, k: int, cin: int, cout: int,
          bias: bool = True) -> None:
    s = scope.child(name)
    s.param("kernel", jax_rng.lecun_normal, (k, k, cin, cout))
    if bias:
        s.param("bias", _zeros, (cout,))


def _frozen_bn(scope: _Scope, name: str, dim: int) -> None:
    bn = scope.child(name)
    for leaf, init in (("scale", _ones), ("bias", _zeros),
                       ("mean", _zeros), ("var", _ones)):
        bn.param(leaf, init, (dim,))


def _layernorm(scope: _Scope, name: str, dim: int) -> None:
    s = scope.child(name)
    s.param("scale", _ones, (dim,))
    s.param("bias", _zeros, (dim,))


# -- the ViT trunks (isegprobe_tpu/models/vit.py; featurizers/dinov2.py and
# dino.py) ------------------------------------------------------------------

def _vit(scope: _Scope, cfg: ViTConfig) -> None:
    d = cfg.embed_dim
    vit = scope.child("model")
    _conv(vit.child("patch_embed"), "proj", cfg.patch_size, 3, d)
    vit.param("cls_token", _zeros, (1, 1, d))
    gh, gw = cfg.pretrain_grid
    vit.param("pos_embed", jax_rng.truncated_normal_init(0.02),
              (1, 1 + gh * gw, d))
    for i in range(cfg.depth):
        blk = vit.child(f"blocks_{i}")
        _layernorm(blk, "norm1", d)
        attn = blk.child("attn")
        _dense(attn, "qkv", d, 3 * d)
        _dense(attn, "proj", d, d)
        if cfg.layerscale:
            blk.child("ls1").param("gamma", _constant(LAYERSCALE_INIT), (d,))
        _layernorm(blk, "norm2", d)
        mlp = blk.child("mlp")
        _dense(mlp, "fc1", d, MLP_RATIO * d)
        _dense(mlp, "fc2", MLP_RATIO * d, d)
        if cfg.layerscale:
            blk.child("ls2").param("gamma", _constant(LAYERSCALE_INIT), (d,))
    _layernorm(vit, "norm", d)


def _dinov2_cfg(params: Dict) -> ViTConfig:
    arch = params.get("arch", "dinov2_vits14")
    if arch not in DINOV2_ARCHS:
        raise NotImplementedError(f"Unknown DINOv2 arch: {arch}")
    return DINOV2_ARCHS[arch]


def _dino_cfg(params: Dict) -> ViTConfig:
    return dataclasses.replace(DINO_TRUNK,
                               patch_size=int(params.get("patch_size", 16)))


# -- MaskCLIP's visual tower (isegprobe_tpu/models/featurizers/maskclip.py) --

def _clip_arch(params: Dict) -> Dict:
    name = params.get("model_name", "ViT-B/16")
    if name not in CLIP_ARCHS:
        raise ValueError(f"Currently unsupported model_name for MaskCLIP: "
                         f"{name}")
    return CLIP_ARCHS[name]


def _maskclip(scope: _Scope, arch: Dict) -> None:
    w, p, g0 = arch["width"], arch["patch_size"], arch["pretrain_grid"]
    tower = scope.child("model")
    _conv(tower, "conv1", p, 3, w, bias=False)
    # the tower's setup order: class_embedding, positional_embedding, proj
    tower.param("class_embedding", jax_rng.normal_init(w**-0.5), (w,))
    tower.param("positional_embedding", jax_rng.normal_init(w**-0.5),
                (g0 * g0 + 1, w))
    _layernorm(tower, "ln_pre", w)
    for i in range(arch["layers"]):
        blk = tower.child(f"resblocks_{i}")
        _layernorm(blk, "ln_1", w)
        attn = blk.child("attn")
        attn.param("in_proj_weight", jax_rng.xavier_uniform, (3 * w, w))
        attn.param("in_proj_bias", _zeros, (3 * w,))
        _dense(attn, "out_proj", w, w)
        if i < arch["layers"] - 1:  # the last block runs its value path
            _layernorm(blk, "ln_2", w)
            _dense(blk, "c_fc", w, 4 * w)
            _dense(blk, "c_proj", 4 * w, w)
    _layernorm(tower, "ln_post", w)
    tower.param("proj", jax_rng.normal_init(w**-0.5), (w, arch["output_dim"]))


# -- SimpleViT (isegprobe_tpu/models/featurizers/simple_vit.py) -------------

def _simple_vit(scope: _Scope, params: Dict, channels: int) -> None:
    p = params["patch_size"]
    ph, pw = tuple(p) if isinstance(p, (tuple, list)) else (p, p)
    dim, mlp = int(params["embed_dim"]), int(params["mlp_dim"])
    inner = int(params["heads"]) * int(params.get("dim_head", 64))
    patch_dim = int(ph) * int(pw) * channels
    _layernorm(scope, "patch_norm1", patch_dim)
    _dense(scope, "patch_proj", patch_dim, dim)
    _layernorm(scope, "patch_norm2", dim)
    for i in range(int(params["depth"])):
        attn = scope.child(f"attn_{i}")
        _layernorm(attn, "norm", dim)
        _dense(attn, "to_qkv", dim, 3 * inner, bias=False)
        _dense(attn, "to_out", inner, dim, bias=False)
        ff = scope.child(f"ff_{i}")
        _layernorm(ff, "norm", dim)
        _dense(ff, "fc1", dim, mlp)
        _dense(ff, "fc2", mlp, dim)
    _layernorm(scope, "final_norm", dim)


# -- LiFT (isegprobe_tpu/models/upsamplers/lift.py) -------------------------

def _lift(scope: _Scope, params: Dict) -> None:
    c = int(params.get("n_dim", 384))

    def conv_bn(parent: _Scope, name: str, cin: int, cout: int,
                bias: bool) -> None:
        cbr = parent.child(name)
        _conv(cbr, "conv", 3, cin, cout, bias=bias)
        _frozen_bn(cbr, "bn", cout)

    conv_bn(scope, "image_convs_1a", 3, 32, True)
    conv_bn(scope, "image_convs_1b", 32, 32, True)
    conv_bn(scope, "image_convs_2", 32, 32, True)
    # a 2x2 transposed conv: lecun_normal over its 2x2 receptive field
    _conv(scope, "up_transpose", 2, c + 32, (c + 32) // 2)
    double = scope.child("up_conv")
    conv_bn(double, "c1", (c + 32) // 2 + 32, c // 2, False)
    conv_bn(double, "c2", c // 2, c // 2, False)
    _conv(scope, "outc", 1, c // 2, c)


# -- LoftUp (isegprobe_tpu/models/upsamplers/loftup.py) ---------------------

def _loftup(scope: _Scope, params: Dict) -> None:
    if params.get("mxu_pad", False):
        raise NotImplementedError(
            "LoftUp's mxu_pad layout is not ported to isegprobe_torch yet: "
            f"{_OTHER_FAMILIES}")
    dim = int(params.get("n_dim", 384))
    n_freqs = int(params.get("n_freqs", 20))
    num_layers = int(params.get("num_layers", 2))
    cdim = dim + 2 * 5 * 2
    stem = 2 * n_freqs * 5 + 3
    _layernorm(scope.child("channelnorm"), "norm", dim)
    scope.child("lr_pe").param("biases", jax_rng.normal_init(1.0), (2, 2, 5))
    scope.child("fourier_feat").param("biases", jax_rng.normal_init(1.0),
                                  (2, 5, n_freqs))
    _layernorm(scope.child("first_norm"), "norm", stem)
    for name, cin in (("first_conv1", stem), ("first_conv2", cdim)):
        cbr = scope.child(name)
        _conv(cbr, "conv", 3, cin, cdim)
        _frozen_bn(cbr, "bn", cdim)
    cat = scope.child("ca_transformer")
    for i in range(num_layers):
        ca = cat.child(f"ca_{i}")
        _layernorm(ca, "norm_q", cdim)
        _layernorm(ca, "norm_kv", cdim)
        mha = ca.child("attention")
        mha.param("in_proj_weight", jax_rng.xavier_uniform, (3 * cdim, cdim))
        mha.param("in_proj_bias", _zeros, (3 * cdim,))
        _dense(mha, "out_proj", cdim, cdim)
        ff = cat.child(f"ff_{i}")
        _layernorm(ff, "norm", cdim)
        _dense(ff, "fc1", cdim, dim)
        _dense(ff, "fc2", dim, cdim)
    _layernorm(cat, "norm", cdim)
    _conv(scope, "final_conv", 1, cdim, dim)
    ln = scope.child("final_ln")
    ln.param("weight", _ones, (dim,))
    ln.param("bias", _zeros, (dim,))


# -- JBU-FeatUp (isegprobe_tpu/models/upsamplers/jbu.py) --------------------

def _jbu(scope: _Scope, params: Dict, feat_dim: int) -> None:
    key_dim = int(params.get("key_dim", 32))
    for i in range(1, 5):
        up = scope.child(f"up{i}")
        up.param("range_temp", _zeros, ())
        up.param("sigma_spatial", _ones, ())
        _conv(up, "range_proj1", 1, 3, key_dim)
        _conv(up, "range_proj2", 1, key_dim, key_dim)
    _conv(scope, "fixup_proj", 1, feat_dim, feat_dim)


# -- the probe model (isegprobe_tpu/models/probe_model.py) ------------------

def init_tree(config: Dict, seed: int = 0,
              skip: Iterable[str] = ()) -> Dict:
    """``iSegProbeModel(**config).init(PRNGKey(seed), image, points)
    ["params"]`` as nested dicts of float32 numpy arrays (at any image
    size: only the pos-embed's pretrain grid shapes a param).

    ``config`` is the model's constructor config (a checkpoint's
    ``config["params"]``). ``skip`` names top-level subtrees (``"head"``,
    ``"embed_coords"``, ...) to leave out, for a caller that overwrites them
    whole from a checkpoint; every other key is drawn as JAX draws it."""
    skip = set(skip)
    root = _Scope(jax_rng.prng_key(seed))
    backbone_cfg = config["backbone_cfg"]
    btype = backbone_cfg["type"].lower()
    bparams = dict(backbone_cfg.get("params") or {})
    if btype == "mask_clip":
        arch = _clip_arch(bparams)
        feat_dim = arch["output_dim"]
    elif btype in ("dinov2", "vit"):
        cfg = (_dinov2_cfg if btype == "dinov2" else _dino_cfg)(bparams)
        feat_dim = cfg.embed_dim
    else:
        raise ValueError(f"Unsupported backbone type: {btype}")
    if "backbone" not in skip:
        if btype == "mask_clip":
            _maskclip(root.child("backbone"), arch)
        else:
            _vit(root.child("backbone"), cfg)

    ucfg = config.get("upsampler_cfg")
    utype = ucfg["type"].lower() if ucfg else "bilinear"
    uparams = dict((ucfg or {}).get("params") or {})
    if "upsampler" not in skip:
        if utype == "loftup":
            _loftup(root.child("upsampler"), uparams)
        elif utype == "jbu_featup":
            _jbu(root.child("upsampler"), uparams, feat_dim)
        elif utype == "lift":
            _lift(root.child("upsampler"), uparams)
        elif utype not in ("identity", "nearest", "bilinear", "bicubic"):
            raise NotImplementedError(
                f"upsampler type {utype!r} is not ported to isegprobe_torch "
                f"yet: {_OTHER_FAMILIES}")

    head_cfg = config["head_cfg"]
    htype, hp = head_cfg["type"], head_cfg["params"]
    if htype not in ("linear", "simple_conv", "convhead"):
        raise ValueError(f"Unsupported head type: {htype}")
    if "head" not in skip:
        head = root.child("head")
        c = int(hp["in_channels"])
        k = 3 if htype == "convhead" else 1
        n_layers = 0 if htype == "linear" else int(hp["num_layers"])
        for i in range(n_layers):
            _conv(head, f"convs_{i}", k, c, c)
        _conv(head, "classifier", 1, c, int(hp.get("num_classes", 1)))

    cin = 3 if config.get("with_prev_mask", False) else 2
    if config.get("use_rgb_conv", False):
        # RITMMapsTransform: 1x1 conv to 16, stride-2 3x3 conv to 64, and a
        # ScaleLayer whose one param is the constant 0.05
        if "maps_transform" not in skip:
            mt = root.child("maps_transform")
            _conv(mt, "conv1", 1, cin, 16)
            _conv(mt, "conv2", 3, 16, 64)
            mt.child("scale").param("scale", _constant(0.05), (1,))
        cin = 64

    ec = config["embed_coords_cfg"]
    if ec["type"] not in ("patchEmbed", "simple_vit"):
        raise ValueError(f"Unknown embed_coords type: {ec['type']}")
    if "embed_coords" not in skip:
        if ec["type"] == "simple_vit":
            _simple_vit(root.child("embed_coords"), ec["params"], cin)
        else:
            p = ec["params"]["patch_size"]
            p = p[0] if isinstance(p, (tuple, list)) else p
            _conv(root.child("embed_coords"), "proj", int(p), cin,
                  int(ec["params"]["embed_dim"]))
    return root.tree


def count_params(tree: Dict) -> int:
    """The number of scalars in a param tree."""
    return sum(count_params(v) if isinstance(v, dict) else int(np.size(v))
               for v in tree.values())
