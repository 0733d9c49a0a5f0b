"""The reference's weights: the trained checkpoint read from its file, and
the frozen backbone and upsampler drawn again from ``PRNGKey(0)``.

The trained checkpoints hold only the click encoder and the head. The
frozen parts are the JAX package's ``model.init(jax.random.PRNGKey(0))``
values, which the checkpoint was trained on. This file draws them itself in
numpy: a frozen copy of JAX's threefry stream and flax's initializers (the
port keeps the same arithmetic in ``utils/jax_rng.py`` and
``models/init_tree.py``; nothing here imports it). Keys are flax's: the
param's scope path and its position among its module's params, so only the
subtrees this reference needs are drawn.

A checkpoint is a pickle of ``{"config", "state_dict"}`` whose state dict is
flax's msgpack; :func:`load_checkpoint` reads that format and nothing else
(no class is unpickled).
"""

from __future__ import annotations

import hashlib
import math
import pickle
import struct
from typing import Dict, Sequence, Tuple

import numpy as np

_F32 = np.float32
_SQRT2 = np.float32(np.sqrt(2))
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32 erf(+-2/sqrt(2)) as XLA computes them
_TRUNC2_ERF = (np.float32(-0.9544997), np.float32(0.9544997))
# XLA's float32 erf_inv polynomial (Giles), for w below and above 5
_ERFINV_LT5 = tuple(np.float32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_GE5 = tuple(np.float32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


# -- JAX's threefry stream ----------------------------------------------------

def _rotl(v, r):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def _threefry(key, x0, x1):
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    v0 = np.asarray(x0, np.uint32) + ks[0]
    v1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            v0 += v1
            v1 = _rotl(v1, r)
            v1 ^= v0
        v0 += ks[(i + 1) % 3]
        v1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return v0, v1


def _fold_in(key, data: int):
    y0, y1 = _threefry(key, np.zeros(1, np.uint32),
                       np.array([data], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def _bits(key, shape):
    i = np.arange(math.prod(shape), dtype=np.uint64)
    b0, b1 = _threefry(key, (i >> np.uint64(32)).astype(np.uint32),
                       (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (b0 ^ b1).reshape(shape)


def _uniform(key, shape, minval, maxval):
    lo, hi = _F32(minval), _F32(maxval)
    fbits = (_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = fbits.view(np.float32) - _F32(1.0)
    scaled = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, scaled.astype(np.float32))


def _erf_inv(x):
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    lt = w < _F32(5.0)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3.0)).astype(
        np.float64)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = (np.where(lt, c_lt, c_ge).astype(np.float64)
             + p.astype(np.float64) * w).astype(np.float32)
    out = p * x
    return np.where(np.abs(x) == _F32(1.0),
                    x * np.finfo(np.float32).max, out).astype(np.float32)


def _normal(key, shape):
    lo = np.nextafter(_F32(-1.0), _F32(0.0))
    return _SQRT2 * _erf_inv(_uniform(key, shape, lo, _F32(1.0)))


def _truncated_normal(key, shape):
    out = _SQRT2 * _erf_inv(_uniform(key, shape, *_TRUNC2_ERF))
    return np.clip(out, np.nextafter(_F32(-2.0), _F32(np.inf)),
                   np.nextafter(_F32(2.0), _F32(-np.inf)))


def _param_key(path: Sequence[str], counter: int):
    """The key flax hands the ``counter``-th param of the scope ``path``
    under ``PRNGKey(0)``."""
    m = hashlib.sha1()
    for part in (*path, counter):
        if isinstance(part, str):
            m.update(part.encode("utf-8"))
        else:
            m.update(int(part).to_bytes((int(part).bit_length() + 7) // 8,
                                        "big"))
    return _fold_in(np.array([0, 0], np.uint32),
                    int.from_bytes(m.digest()[:4], "big"))


def _fans(shape):
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def lecun_normal(key, shape):
    stddev = np.sqrt(_F32(1.0 / _fans(shape)[0])) / _F32(.87962566103423978)
    return _truncated_normal(key, shape) * stddev


def xavier_uniform(key, shape):
    fan_in, fan_out = _fans(shape)
    variance = _F32(1.0 / ((fan_in + fan_out) / 2))
    return _uniform(key, shape, -1.0, 1.0) * np.sqrt(_F32(3) * variance)


def trunc_normal(stddev):
    return lambda key, shape: _truncated_normal(key, shape) * _F32(stddev)


def normal(stddev):
    return lambda key, shape: _normal(key, shape) * _F32(stddev)


def const(value):
    return lambda key, shape: np.full(shape, value, np.float32)


# -- the frozen trees ---------------------------------------------------------

class _Scope:
    """A flax scope. ``draw=False`` fills the tree with zero-strided
    placeholders of the params' shapes (for counting, not computing)."""

    def __init__(self, path: Tuple[str, ...] = (), draw: bool = True
                 ) -> None:
        self.path, self.counter, self.tree = path, 0, {}
        self.draw = draw

    def child(self, name: str) -> "_Scope":
        sub = _Scope(self.path + (name,), self.draw)
        self.tree[name] = sub.tree
        return sub

    def param(self, name, init, shape) -> None:
        self.counter += 1
        if not self.draw:
            self.tree[name] = np.broadcast_to(np.float32(0), tuple(shape))
            return
        key = _param_key(self.path, self.counter)
        self.tree[name] = np.asarray(init(key, tuple(shape)), np.float32)


def _dense(s: _Scope, name, fan_in, features):
    d = s.child(name)
    d.param("kernel", lecun_normal, (fan_in, features))
    d.param("bias", const(0.0), (features,))


def _conv(s: _Scope, name, k, cin, cout):
    c = s.child(name)
    c.param("kernel", lecun_normal, (k, k, cin, cout))
    c.param("bias", const(0.0), (cout,))


def _ln(s: _Scope, name, dim):
    n = s.child(name)
    n.param("scale", const(1.0), (dim,))
    n.param("bias", const(0.0), (dim,))


def vit_tree(arch: Dict, draw: bool = True) -> Dict:
    """``params["backbone"]`` of a DINOv2 probe: the ViT under ``model``."""
    root = _Scope(draw=draw).child("backbone")
    vit = root.child("model")
    d, grid = arch["hidden_size"], arch["pretrain_grid"]
    _conv(vit.child("patch_embed"), "proj", arch["patch_size"], 3, d)
    vit.param("cls_token", const(0.0), (1, 1, d))
    vit.param("pos_embed", trunc_normal(0.02), (1, 1 + grid * grid, d))
    for i in range(arch["num_hidden_layers"]):
        blk = vit.child(f"blocks_{i}")
        _ln(blk, "norm1", d)
        attn = blk.child("attn")
        _dense(attn, "qkv", d, 3 * d)
        _dense(attn, "proj", d, d)
        blk.child("ls1").param("gamma", const(arch["layerscale_init"]), (d,))
        _ln(blk, "norm2", d)
        mlp = blk.child("mlp")
        _dense(mlp, "fc1", d, arch["intermediate_size"])
        _dense(mlp, "fc2", arch["intermediate_size"], d)
        blk.child("ls2").param("gamma", const(arch["layerscale_init"]), (d,))
    _ln(vit, "norm", d)
    return root.tree


def loftup_tree(up: Dict, draw: bool = True) -> Dict:
    """``params["upsampler"]`` of a LoftUp probe (its unpadded layout)."""
    s = _Scope(draw=draw).child("upsampler")
    dim, nf = up["n_dim"], up["n_freqs"]
    cdim = dim + 2 * 2 * up["lr_pe_freqs"]
    stem = 2 * nf * 5 + 3
    _ln(s.child("channelnorm"), "norm", dim)
    s.child("lr_pe").param("biases", normal(1.0), (2, 2, up["lr_pe_freqs"]))
    s.child("fourier_feat").param("biases", normal(1.0), (2, 5, nf))
    _ln(s.child("first_norm"), "norm", stem)
    for name, cin in (("first_conv1", stem), ("first_conv2", cdim)):
        cbr = s.child(name)
        _conv(cbr, "conv", 3, cin, cdim)
        bn = cbr.child("bn")
        for leaf, v in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0),
                        ("var", 1.0)):
            bn.param(leaf, const(v), (cdim,))
    cat = s.child("ca_transformer")
    for i in range(up["num_layers"]):
        ca = cat.child(f"ca_{i}")
        _ln(ca, "norm_q", cdim)
        _ln(ca, "norm_kv", cdim)
        mha = ca.child("attention")
        mha.param("in_proj_weight", xavier_uniform, (3 * cdim, cdim))
        mha.param("in_proj_bias", const(0.0), (3 * cdim,))
        _dense(mha, "out_proj", cdim, cdim)
        ff = cat.child(f"ff_{i}")
        _ln(ff, "norm", cdim)
        _dense(ff, "fc1", cdim, dim)
        _dense(ff, "fc2", dim, cdim)
    _ln(cat, "norm", cdim)
    _conv(s, "final_conv", 1, cdim, dim)
    ln = s.child("final_ln")
    ln.param("weight", const(1.0), (dim,))
    ln.param("bias", const(0.0), (dim,))
    return s.tree


# -- the checkpoint -----------------------------------------------------------

class _Msgpack:
    """A cursor over flax's msgpack: maps, lists, strings, numbers and the
    ndarray extension (code 1) and numpy scalars (code 3)."""

    def __init__(self, data: bytes) -> None:
        self.data, self.pos = memoryview(data), 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode()
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack(">" + "BHI"[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xD9, 0xDA, 0xDB):
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xD9]))
                         ).decode()
        if b in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack(">" + "HI"[
                b - 0xDC]))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">" + "HI"[b - 0xDE]))
        raise ValueError(f"msgpack type byte 0x{b:02x}")

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code, n):
        payload = bytes(self.take(n))
        if code not in (1, 3):
            raise ValueError(f"msgpack ext type {code}")
        shape, dtype, raw = _Msgpack(payload).obj()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        arr = np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy()
        return arr if code == 1 else arr[()]


class _NoClasses(pickle.Unpickler):
    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"{module}.{name} in a checkpoint")


def load_checkpoint(path) -> Tuple[Dict, Dict]:
    """(trained params, config) of a checkpoint file."""
    with open(path, "rb") as f:
        payload = _NoClasses(f).load()
    return _Msgpack(payload["state_dict"]).obj(), payload["config"]


def probe_params(cfg: Dict, checkpoint=None) -> Dict:
    """Every param of the configuration's probe: the checkpoint's trained
    subtrees over the frozen trees drawn from ``PRNGKey(0)``. Without a
    checkpoint, placeholders of every param's shape."""
    draw = checkpoint is not None
    params = {"backbone": vit_tree(cfg["backbone"], draw)}
    if cfg["upsampler"]["type"] == "loftup":
        params["upsampler"] = loftup_tree(cfg["upsampler"], draw)
    if draw:
        params.update(load_checkpoint(checkpoint)[0])
        return params
    d, p = cfg["backbone"]["hidden_size"], cfg["backbone"]["patch_size"]
    c, nh = cfg["head"]["in_channels"], cfg["head"]["num_layers"]
    z = np.float32(0)
    params["embed_coords"] = {"proj": {
        "kernel": np.broadcast_to(z, (p, p, 3, d)),
        "bias": np.broadcast_to(z, (d,))}}
    head = {f"convs_{i}": {"kernel": np.broadcast_to(z, (3, 3, c, c)),
                           "bias": np.broadcast_to(z, (c,))}
            for i in range(nh)}
    head["classifier"] = {"kernel": np.broadcast_to(z, (1, 1, c, 1)),
                          "bias": np.broadcast_to(z, (1,))}
    params["head"] = head
    return params
