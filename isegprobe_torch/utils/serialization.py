"""The JAX package's self-describing checkpoints, read and written without
flax.

Counterpart of ``isegprobe_tpu/utils/serialization.py``. A ``.ckpt`` is a
pickle of ``{"config": {"class", "params"}, "state_dict": <bytes>,
"extra": ...}`` whose ``state_dict`` is flax's msgpack encoding of the
filtered param tree (``flax.serialization.msgpack_serialize``). The GPU
machine has neither flax nor msgpack, so :func:`msgpack_restore` decodes
that encoding in Python: maps, arrays, strings, numbers and flax's ext
types 1 (ndarray: a msgpack ``(shape, dtype name, raw bytes)``), 2 (complex)
and 3 (numpy scalar). Anything else raises, naming what it met.

The pickle itself is read by an unpickler that resolves no global: a
checkpoint holds only dicts, lists, tuples, strings, numbers and bytes.

:func:`save_checkpoint` writes the same file: :func:`msgpack_serialize`
encodes the param tree as flax does (maps of str keys, arrays as ext type
1), so the JAX package's ``load_checkpoint`` reads it, and
:func:`model_config` gives the port's model the config the JAX package
writes for its counterpart.
"""

from __future__ import annotations

import pickle
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

__all__ = ["msgpack_restore", "msgpack_serialize", "load_checkpoint",
           "save_checkpoint", "merge_params", "model_config", "build_model"]

# the class the JAX package writes into a checkpoint's config: the port's
# iSegProbeModel is its counterpart (mapped by name: the port never imports
# the JAX package)
_JAX_MODEL_CLASS = "isegprobe_tpu.models.probe_model.iSegProbeModel"

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """A cursor over one msgpack buffer."""

    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
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
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack(">" + "BHI"[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):  # fixext 1..16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.str(self.unpack(">" + "BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):  # array 16/32
            n = self.unpack(">" + "HI"[b - 0xDC])
            return [self.obj() for _ in range(n)]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.unpack(">" + "HI"[b - 0xDE]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not valid")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, raw = _unpack_all(payload)
            arr = np.frombuffer(raw, dtype=_dtype(dtype)).reshape(shape).copy()
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = _unpack_all(payload)
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code} is not one of flax's "
                         "(1 ndarray, 2 complex, 3 numpy scalar)")


def _dtype(name) -> np.dtype:
    name = name.decode() if isinstance(name, bytes) else name
    try:
        return np.dtype(name)
    except TypeError:
        raise ValueError(f"array dtype {name!r} in a checkpoint is not a "
                         "numpy dtype") from None


def _unpack_all(data: bytes) -> Any:
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes "
                         "after a msgpack object")
    return out


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore`` for the param trees the JAX
    package writes: nested dicts of numpy arrays. Arrays that flax splits
    into chunks (over 2**30 bytes) raise."""
    out = _unpack_all(data)

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError("chunked msgpack arrays (over 2**30 bytes) "
                                 "are not read by isegprobe_torch")
            for v in node.values():
                check(v)

    check(out)
    return out


def _pack(obj, out: bytearray) -> None:
    """Append the msgpack encoding of ``obj`` to ``out``."""
    if obj is None:
        out += b"\xc0"
    elif obj is True or obj is False:
        out += b"\xc3" if obj else b"\xc2"
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            out += struct.pack(">BQ", 0xCF, obj)
        else:
            out += struct.pack(">Bq", 0xD3, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out += (bytes([0xA0 | len(data)]) if len(data) < 32
                else struct.pack(">BI", 0xDB, len(data)))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        out += struct.pack(">BI", 0xC6, len(obj)) + bytes(obj)
    elif isinstance(obj, (list, tuple)):
        out += struct.pack(">BI", 0xDD, len(obj))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out += struct.pack(">BI", 0xDF, len(obj))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack map keys must be str, got {k!r}")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.kind not in "biuf":
            raise TypeError(f"array of dtype {arr.dtype} in a param tree")
        payload = bytearray()
        _pack([list(arr.shape), arr.dtype.name,
               np.ascontiguousarray(arr).tobytes()], payload)
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        out += struct.pack(">BIb", 0xC9, len(payload), code) + payload
    else:
        raise TypeError(f"{type(obj).__name__} in a param tree")


def msgpack_serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize`` for a param tree of nested
    dicts of numpy arrays (arrays over 2**30 bytes, which flax splits into
    chunks, raise)."""
    out = bytearray()

    def check(node):
        if isinstance(node, dict):
            for v in node.values():
                check(v)
        elif isinstance(node, np.ndarray) and node.nbytes > 2**30:
            raise ValueError("arrays over 2**30 bytes are not written by "
                             "isegprobe_torch")

    check(tree)
    _pack(tree, out)
    return bytes(out)


class _NoGlobals(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        raise pickle.UnpicklingError(
            f"a checkpoint refers to {module}.{name}; only plain data is "
            "read")


def load_checkpoint(path: Union[str, Path]
                    ) -> Tuple[Dict, Dict, Optional[Dict]]:
    """(params, config, extra) of a JAX package checkpoint, as
    ``isegprobe_tpu.utils.serialization.load_checkpoint`` returns them."""
    with open(path, "rb") as f:
        payload = _NoGlobals(f).load()
    params = msgpack_restore(payload["state_dict"])
    return params, payload["config"], payload.get("extra")


def save_checkpoint(params: Dict, config: Dict, path: Union[str, Path],
                    extra: Optional[Dict] = None) -> None:
    """Write ``{"config", "state_dict", "extra"}`` as the JAX package's
    ``save_checkpoint`` does: ``params`` (nested dicts of numpy arrays)
    msgpack-encoded, the file pickled, written to a temporary name and
    moved into place."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"config": config, "state_dict": msgpack_serialize(params)}
    if extra:
        payload["extra"] = extra
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)


def model_config(model) -> Dict:
    """The config the JAX package writes for the counterpart of ``model``
    (an ``iSegProbeModel`` of the port): its class name and constructor
    fields, so that either package's ``build_model`` rebuilds it."""
    return {"class": _JAX_MODEL_CLASS, "params": dict(model.ctor_config)}


def merge_params(full_params: Dict, loaded: Dict) -> Dict:
    """Overlay a (possibly filtered) checkpoint onto a full param tree:
    subtrees merge key by key, a leaf of ``loaded`` replaces the one in
    ``full_params``."""
    merged = dict(full_params)
    for k, v in loaded.items():
        if isinstance(v, dict) and isinstance(merged.get(k), dict):
            merged[k] = merge_params(merged[k], v)
        else:
            merged[k] = v
    return merged


def build_model(config: Dict, device=None, dtype=None):
    """The port's model for a checkpoint's ``config``, with placeholder
    parameters, on ``device`` (CUDA unless ``device="cpu"``) and in
    ``dtype`` when given. ``config["class"]`` must name the JAX package's
    ``iSegProbeModel``, whose counterpart the port builds; any other class
    raises."""
    from isegprobe_torch.models.probe_model import iSegProbeModel

    if config["class"] != _JAX_MODEL_CLASS:
        raise NotImplementedError(f"model class {config['class']!r} has no "
                                  "counterpart in isegprobe_torch")
    model = iSegProbeModel(**config["params"], device=device)
    return model if dtype is None else model.to(dtype)
