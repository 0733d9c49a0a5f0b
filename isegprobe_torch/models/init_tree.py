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

Covered: the DINOv2 backbone, the ``patchEmbed`` click encoder, the
``convhead`` head and the identity, LoftUp and JBU-FeatUp upsamplers, the
configurations ``models.probe_model.iSegProbeModel`` builds.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np

from isegprobe_torch.models.featurizers.dinov2 import DINOV2_ARCHS
from isegprobe_torch.models.vit import LAYERSCALE_INIT, MLP_RATIO
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


def _dense(scope: _Scope, name: str, fan_in: int, features: int) -> None:
    s = scope.child(name)
    s.param("kernel", jax_rng.lecun_normal, (fan_in, features))
    s.param("bias", _zeros, (features,))


def _conv(scope: _Scope, name: str, k: int, cin: int, cout: int) -> None:
    s = scope.child(name)
    s.param("kernel", jax_rng.lecun_normal, (k, k, cin, cout))
    s.param("bias", _zeros, (cout,))


def _layernorm(scope: _Scope, name: str, dim: int) -> None:
    s = scope.child(name)
    s.param("scale", _ones, (dim,))
    s.param("bias", _zeros, (dim,))


# -- DINOv2 (isegprobe_tpu/models/vit.py, featurizers/dinov2.py) ------------

def _dinov2(scope: _Scope, params: Dict) -> None:
    arch = params.get("arch", "dinov2_vits14")
    if arch not in DINOV2_ARCHS:
        raise NotImplementedError(f"Unknown DINOv2 arch: {arch}")
    cfg = DINOV2_ARCHS[arch]
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
        blk.child("ls1").param("gamma", _constant(LAYERSCALE_INIT), (d,))
        _layernorm(blk, "norm2", d)
        mlp = blk.child("mlp")
        _dense(mlp, "fc1", d, MLP_RATIO * d)
        _dense(mlp, "fc2", MLP_RATIO * d, d)
        blk.child("ls2").param("gamma", _constant(LAYERSCALE_INIT), (d,))
    _layernorm(vit, "norm", d)


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
        bn = cbr.child("bn")
        for leaf, init in (("scale", _ones), ("bias", _zeros),
                           ("mean", _zeros), ("var", _ones)):
            bn.param(leaf, init, (cdim,))
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
    if btype != "dinov2":
        raise NotImplementedError(
            f"backbone type {btype!r} is not ported to isegprobe_torch yet: "
            f"{_OTHER_FAMILIES}")
    bparams = dict(backbone_cfg.get("params") or {})
    feat_dim = DINOV2_ARCHS[bparams.get("arch", "dinov2_vits14")].embed_dim
    if "backbone" not in skip:
        _dinov2(root.child("backbone"), bparams)

    ucfg = config.get("upsampler_cfg")
    utype = ucfg["type"].lower() if ucfg else "bilinear"
    uparams = dict((ucfg or {}).get("params") or {})
    if "upsampler" not in skip:
        if utype == "loftup":
            _loftup(root.child("upsampler"), uparams)
        elif utype == "jbu_featup":
            _jbu(root.child("upsampler"), uparams, feat_dim)
        elif utype not in ("identity", "nearest", "bilinear", "bicubic"):
            raise NotImplementedError(
                f"upsampler type {utype!r} is not ported to isegprobe_torch "
                f"yet: {_OTHER_FAMILIES}")

    head_cfg = config["head_cfg"]
    if head_cfg["type"] != "convhead":
        raise NotImplementedError(
            f"head type {head_cfg['type']!r} is not ported to "
            f"isegprobe_torch yet: {_OTHER_FAMILIES}")
    if "head" not in skip:
        hp = head_cfg["params"]
        head = root.child("head")
        c = int(hp["in_channels"])
        for i in range(int(hp["num_layers"])):
            _conv(head, f"convs_{i}", 3, c, c)
        _conv(head, "classifier", 1, c, int(hp.get("num_classes", 1)))

    ec = config["embed_coords_cfg"]
    if ec["type"] != "patchEmbed":
        raise NotImplementedError(
            f"embed_coords type {ec['type']!r} is not ported to "
            f"isegprobe_torch yet: {_OTHER_FAMILIES}")
    if "embed_coords" not in skip:
        p = ec["params"]["patch_size"]
        p = p[0] if isinstance(p, (tuple, list)) else p
        cin = 3 if config.get("with_prev_mask", False) else 2
        _conv(root.child("embed_coords"), "proj", int(p), cin,
              int(ec["params"]["embed_dim"]))
    return root.tree


def count_params(tree: Dict) -> int:
    """The number of scalars in a param tree."""
    return sum(count_params(v) if isinstance(v, dict) else int(np.size(v))
               for v in tree.values())
