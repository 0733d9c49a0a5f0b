"""Image files read without OpenCV or PIL, as ``cv2.imread`` reads them.

The JAX package reads every image with ``cv2.imread`` (``IMREAD_COLOR``:
8-bit BGR, EXIF orientation applied). The port's data layer reads the same
pixels:

* JPEG (baseline, extended sequential and progressive, Huffman-coded; 1
  or 3 components; any integral sampling; restart markers; the EXIF
  orientation tag) through ``csrc/host/jpeg.cpp``, libjpeg-turbo's
  decompression with OpenCV's settings (``utils/host_lib.py`` builds it
  with g++ at first use). A progressive file whose scans leave a
  component's coefficients 1-9 unrefined (libjpeg-turbo block-smooths
  such a file; a whole file from any standard encoder is not one), and an
  arithmetic-coded, lossless or 12-bit file raise ``ValueError`` naming
  the case.
* PNG with ``zlib`` and numpy (the row unfilter in the same library): the
  five filters, interlaced (Adam7) or not, gray, gray + alpha, RGB, RGBA
  and palette images at every bit depth, brought to 8-bit BGR as libpng's
  transforms under ``IMREAD_COLOR`` bring them (16-bit samples keep their
  high byte, 1/2/4-bit gray is scaled to 0-255, alpha and ``tRNS`` are
  dropped).
* BMP (``BI_RGB``): 8-bit palette and 24-bit images, bottom-up or
  top-down; other BMPs raise ``ValueError``.

:func:`read_bgr` is ``cv2.imread(p)``, :func:`read_unchanged` is
``cv2.imread(p, cv2.IMREAD_UNCHANGED)`` (:func:`decode_unchanged` its
``imdecode``), :func:`read_rgb` is
``cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)`` and :func:`read_gray` is
``cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2GRAY)`` (the 15-bit
fixed-point weights that this OpenCV build's conversion uses, bitwise on
all 2^24 colours).

:func:`encode_jpeg` writes the other way: the baseline JPEG that
``cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, q])`` writes
(libjpeg-turbo's compression with OpenCV's settings, in
``csrc/host/jpeg.cpp``), from RGB or gray pixels; :func:`write_jpeg` is
``cv2.imwrite``. :func:`encode_png` and :func:`write_png` write a PNG of
8-bit gray or BGR pixels (16-bit gray too) with ``zlib`` and filter 0 on
every row: the same pixels that ``cv2.imwrite(path, img)`` stores, in
other bytes.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from isegprobe_torch.utils import host_lib

__all__ = ["read_bgr", "read_rgb", "read_gray", "decode_bgr",
           "read_unchanged", "decode_unchanged",
           "bgr_to_gray", "encode_jpeg", "write_jpeg", "encode_png",
           "write_png"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def read_bgr(path) -> np.ndarray:
    """``cv2.imread(path)``: uint8 ``[H, W, 3]`` BGR."""
    return decode_bgr(Path(path).read_bytes(), str(path))


def read_rgb(path) -> np.ndarray:
    """``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``."""
    return np.ascontiguousarray(read_bgr(path)[:, :, ::-1])


def read_gray(path) -> np.ndarray:
    """``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2GRAY)``: uint8
    ``[H, W]``."""
    return bgr_to_gray(read_bgr(path))


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """``cv2.COLOR_BGR2GRAY`` on uint8: ``(3735 B + 19235 G + 9798 R +
    2^14) >> 15``."""
    b, g, r = (bgr[:, :, i].astype(np.int32) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(
        np.uint8)


def decode_bgr(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode a JPEG, PNG or BMP file's bytes to uint8 BGR, by signature."""
    if data[:3] == b"\xff\xd8\xff":
        rgb, _, orientation = _decode_jpeg(data, name)
        return _orient(rgb[:, :, ::-1], orientation)
    if data[:8] == _PNG_SIGNATURE:
        return _decode_png(data, name)
    if data[:2] == b"BM":
        return _decode_bmp(data, name)
    raise ValueError(f"{name}: not a JPEG, PNG or BMP file")


def read_unchanged(path) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``."""
    return decode_unchanged(Path(path).read_bytes(), str(path))


def decode_unchanged(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """``cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)``: gray comes back 2-D
    (a gray JPEG, a gray PNG at every bit depth, 1/2/4-bit scaled to
    0-255, a BMP whose palette is gray), colour BGR; a PNG with alpha
    (gray + alpha with the gray repeated, RGBA, or a ``tRNS`` chunk on an
    RGB or palette image) BGRA, ``tRNS`` on a gray PNG ignored; 16-bit PNG
    samples stay uint16. The EXIF orientation is not applied."""
    if data[:3] == b"\xff\xd8\xff":
        rgb, channels, _ = _decode_jpeg(data, name)
        if channels == 1:
            return np.ascontiguousarray(rgb[:, :, 0])
        return np.ascontiguousarray(rgb[:, :, ::-1])
    if data[:8] == _PNG_SIGNATURE:
        return _decode_png(data, name, unchanged=True)
    if data[:2] == b"BM":
        return _decode_bmp(data, name, unchanged=True)
    raise ValueError(f"{name}: not a JPEG, PNG or BMP file")


# -- JPEG -----------------------------------------------------------------


def _as_u8p(buf):
    return ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """The JPEG file of uint8 ``img``, ``[H, W, 3]`` RGB or ``[H, W]`` (or
    ``[H, W, 1]``) gray, at ``quality`` (1-100; OpenCV's default is 95):
    the bytes ``cv2.imencode`` writes for the same pixels in BGR."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    channels = 1 if img.ndim == 2 else img.shape[2]
    h, w = img.shape[:2]
    lib = host_lib.load()
    n = ctypes.c_size_t()
    cap = 4096 + 2 * img.size
    while True:
        out = np.empty(cap, np.uint8)
        code = lib.iseg_jpeg_encode(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
            channels, int(quality),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
            ctypes.byref(n))
        if code == 7 and n.value > cap:  # kSmallBuffer
            cap = n.value
            continue
        host_lib.check(code, f"JPEG encode of {img.shape}")
        return out[:n.value].tobytes()


def write_jpeg(path, img: np.ndarray, quality: int = 95) -> None:
    """``cv2.imwrite(path, img[..., ::-1], [IMWRITE_JPEG_QUALITY,
    quality])`` for RGB ``img`` (gray as it is)."""
    Path(path).write_bytes(encode_jpeg(img, quality))


def _decode_jpeg(data: bytes, name: str):
    """RGB pixels (gray repeated), the component count and the EXIF
    orientation."""
    lib = host_lib.load()
    src = ctypes.create_string_buffer(data, len(data))
    h, w, c, orient = (ctypes.c_int() for _ in range(4))
    host_lib.check(lib.iseg_jpeg_info(_as_u8p(src), len(data),
                                      ctypes.byref(h), ctypes.byref(w),
                                      ctypes.byref(c), ctypes.byref(orient)),
                   name)
    out = np.empty((h.value, w.value, 3), np.uint8)
    host_lib.check(lib.iseg_jpeg_decode_rgb(
        _as_u8p(src), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))), name)
    return out, c.value, orient.value


def _orient(img: np.ndarray, code: int) -> np.ndarray:
    """OpenCV's ``ApplyExifOrientation`` for EXIF orientations 1-8."""
    if code in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    axes = flip.get(code, ())
    if axes:
        img = np.flip(img, axis=axes)
    return np.ascontiguousarray(img)


# -- PNG ------------------------------------------------------------------


# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_rows(raw: bytes, pos: int, h: int, w: int, depth: int, ch: int,
              name: str):
    """One (sub)image's samples from the filtered rows at ``raw[pos:]``:
    ``[h, w, ch]`` uint16 for 16-bit samples, else uint8 (1/2/4-bit values
    unscaled), and the position after them."""
    bits = ch * depth
    rowbytes = (w * bits + 7) // 8
    size = h * (rowbytes + 1)
    if len(raw) < pos + size:
        raise ValueError(f"{name}: truncated PNG image data")
    lib = host_lib.load()
    src = ctypes.create_string_buffer(raw[pos:pos + size], size)
    rows = np.empty((h, rowbytes), np.uint8)
    host_lib.check(lib.iseg_png_unfilter(
        _as_u8p(src), rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, rowbytes, max(1, bits // 8)), name)
    if depth == 16:
        samples = rows.view(">u2")[:, :w * ch].astype(np.uint16)
    elif depth == 8:
        samples = rows[:, :w * ch]
    else:
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        samples = vals.reshape(h, rowbytes * per)[:, :w]
    return samples.reshape(h, w, ch), pos + size


def _decode_png(data: bytes, name: str, unchanged: bool = False
                ) -> np.ndarray:
    pos = 8
    ihdr = None
    palette = trns = None
    idat = []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace not in (0, 1):
        raise ValueError(f"{name}: PNG interlace method {interlace} is not "
                         "valid")
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{name}: PNG color type {ctype} at bit depth "
                         f"{depth} is not valid")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without PLTE")
    ch = _PNG_CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if not interlace:
        samples, _ = _png_rows(raw, 0, h, w, depth, ch, name)
    else:
        samples = np.zeros((h, w, ch), np.uint16 if depth == 16
                           else np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw > 0 and ph > 0:
                samples[y0::dy, x0::dx], at = _png_rows(
                    raw, at, ph, pw, depth, ch, name)
    if ctype == 3:
        idx = samples[:, :, 0]
        if idx.size and int(idx.max()) >= len(palette):
            raise ValueError(f"{name}: palette index out of range")
        bgr = palette[idx][:, :, ::-1]
        if unchanged and trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[:min(len(trns), 256)] = np.frombuffer(trns[:256], np.uint8)
            return np.ascontiguousarray(np.dstack([bgr, alpha[idx]]))
        return np.ascontiguousarray(bgr)
    if depth < 8 and ctype == 0:  # scaled to 8 bits
        samples = samples * np.uint8({1: 255, 2: 85, 4: 17}[depth])
    if not unchanged:
        if depth == 16:  # the high byte
            samples = (samples >> 8).astype(np.uint8)
        gray = ctype in (0, 4)
        bgr = np.repeat(samples[:, :, :1], 3, 2) if gray \
            else samples[:, :, 2::-1]
        return np.ascontiguousarray(bgr)
    if ctype == 0:
        return np.ascontiguousarray(samples[:, :, 0])
    if ctype == 4:
        return np.ascontiguousarray(samples[:, :, [0, 0, 0, 1]])
    bgr = samples[:, :, 2::-1]
    if ctype == 6:
        return np.ascontiguousarray(np.dstack([bgr, samples[:, :, 3:]]))
    if trns is not None and len(trns) >= 6:
        key = np.array(struct.unpack(">HHH", trns[:6]), np.uint32)
        if depth == 8:
            key &= 0xFF
        top = np.iinfo(samples.dtype).max
        alpha = np.where((samples == key).all(2), 0, top).astype(
            samples.dtype)
        return np.ascontiguousarray(np.dstack([bgr, alpha]))
    return np.ascontiguousarray(bgr)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """The PNG file of ``img``: uint8 ``[H, W, 3]`` BGR (stored as RGB, as
    ``cv2.imwrite`` stores it), uint8 or uint16 ``[H, W]`` (or ``[H, W,
    1]``) gray. Every row has filter 0 (none); the data is one ``zlib``
    stream at level 6."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        ctype, depth = 2, 8
        rows = img[:, :, ::-1].reshape(img.shape[0], -1)
    elif img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        ctype, depth = 0, img.dtype.itemsize * 8
        rows = img.astype(">u2") if depth == 16 else img
    else:
        raise ValueError(f"encode_png takes uint8 BGR [H, W, 3] or uint8 / "
                         f"uint16 gray [H, W]; got {img.dtype} "
                         f"{list(img.shape)}")
    h, w = img.shape[:2]
    raw = np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1)
    filtered = np.concatenate([np.zeros((h, 1), np.uint8), raw], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    """``cv2.imwrite(path, img)`` for a ``.png`` path (:func:`encode_png`)."""
    Path(path).write_bytes(encode_png(img))


# -- BMP ------------------------------------------------------------------


def _decode_bmp(data: bytes, name: str, unchanged: bool = False
                ) -> np.ndarray:
    offset = struct.unpack_from("<I", data, 10)[0]
    hsize = struct.unpack_from("<I", data, 14)[0]
    if hsize < 40:
        raise ValueError(f"{name}: BMP core headers are not supported")
    w, h, _, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
    n_colors = struct.unpack_from("<I", data, 46)[0]
    if comp != 0 or bpp not in (8, 24):
        raise ValueError(f"{name}: only uncompressed 8-bit palette and "
                         f"24-bit BMPs are supported (got {bpp}-bit, "
                         f"compression {comp})")
    top_down = h < 0
    h = abs(h)
    stride = ((w * bpp + 31) // 32) * 4
    rows = np.frombuffer(data, np.uint8, count=stride * h,
                         offset=offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp == 24:
        return np.ascontiguousarray(rows[:, :w * 3].reshape(h, w, 3))
    n_pal = n_colors or 256
    pal = np.frombuffer(data, np.uint8, count=4 * n_pal,
                        offset=14 + hsize).reshape(n_pal, 4)[:, :3]
    bgr = pal[np.minimum(rows[:, :w], n_pal - 1)]
    if unchanged and (pal == pal[:, :1]).all():  # a gray palette
        return np.ascontiguousarray(bgr[:, :, 0])
    return np.ascontiguousarray(bgr)
