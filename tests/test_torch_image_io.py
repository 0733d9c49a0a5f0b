"""The port's image decoding and affine warps without OpenCV against
OpenCV (present here, not on the GPU machine).

Bitwise, on every case:
- ``data/image_io.py``: JPEG files OpenCV writes (qualities 50/75/95,
  4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1 sampling, optimized Huffman
  tables, restart intervals, grayscale, sizes from 1×1 to 854×480), the
  EXIF orientations 1-8 (written with PIL), PNGs of every colour type and
  bit depth with all five row filters (written here by a small encoder),
  OpenCV's own PNGs, and BMPs (OpenCV's and PIL's); ``bgr_to_gray`` on all
  2^24 colours. Progressive JPEGs (OpenCV's and PIL's scan scripts,
  qualities 50/90/100, 4:2:0, 4:2:2, 4:4:4, gray, restart intervals) and
  interlaced (Adam7) PNGs of every type, in colour and with
  ``IMREAD_UNCHANGED``; ``read_unchanged`` on every PNG type with and
  without ``tRNS``, 16-bit, JPEG (the EXIF orientation not applied) and
  BMP. A progressive file cut after an early scan (which libjpeg-turbo
  block-smooths), a truncated JPEG or PNG and a file of another kind
  raise.
- ``data/raster.py``: ``rotation_matrix_2d`` against
  ``cv2.getRotationMatrix2D`` and ``warp_affine`` (linear on uint8 images,
  nearest on int32 masks) against ``cv2.warpAffine`` over
  ``ShiftScaleRotate``'s ranges and wide ones, at widths that are and are
  not multiples of 8 and 16.
"""

from __future__ import annotations

import struct
import zlib

import cv2
import numpy as np
import pytest

from isegprobe_torch.data import image_io, raster

JPEG_SIZES = [(1, 1), (1, 7), (2, 3), (5, 5), (9, 17), (16, 16), (17, 33),
              (100, 77), (375, 500), (500, 375), (321, 481), (480, 854)]
SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def smooth_image(rng, h, w, c=3):
    """A smooth image with noise: JPEG's usual content."""
    base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, c)).astype(
        np.float32)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_LINEAR)
    img = img.reshape(h, w, c) + rng.normal(0, 12, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


def assert_same_as_cv2(path):
    want = cv2.imread(str(path))
    got = image_io.read_bgr(path)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_jpeg_equals_opencv(tmp_path, quality, sampling):
    rng = np.random.default_rng(quality * 7 + len(sampling))
    path = tmp_path / "x.jpg"
    for h, w in JPEG_SIZES:
        for extra in ([], [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
                      [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]):
            cv2.imwrite(str(path), smooth_image(rng, h, w),
                        [cv2.IMWRITE_JPEG_QUALITY, quality,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                         SAMPLINGS[sampling], *extra])
            assert_same_as_cv2(path)


@pytest.mark.parametrize("quality", [50, 95])
def test_grayscale_jpeg_equals_opencv(tmp_path, quality):
    rng = np.random.default_rng(quality)
    path = tmp_path / "g.jpg"
    for h, w in JPEG_SIZES:
        cv2.imwrite(str(path), smooth_image(rng, h, w, 1)[:, :, 0],
                    [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert_same_as_cv2(path)
        assert image_io.read_rgb(path).shape == (h, w, 3)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_opencv(tmp_path, orientation):
    from PIL import Image

    rng = np.random.default_rng(orientation)
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = tmp_path / "o.jpg"
    Image.fromarray(smooth_image(rng, 37, 53)).save(path, quality=90,
                                                    exif=exif.tobytes())
    assert_same_as_cv2(path)


def test_progressive_jpeg_and_interlaced_png_raise(tmp_path):
    """What still raises: a progressive file whose scans leave
    coefficients 1-9 unrefined (libjpeg-turbo block-smooths it; cut after
    its first scan), an interlaced PNG whose passes are cut short, a
    truncated JPEG and a file of another kind."""
    rng = np.random.default_rng(0)
    img = smooth_image(rng, 40, 56)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    data = buf.tobytes()
    second_scan = data.index(b"\xff\xda", data.index(b"\xff\xda") + 2)
    (tmp_path / "p.jpg").write_bytes(data[:second_scan] + b"\xff\xd9")
    with pytest.raises(ValueError, match="p.jpg: progressive.*unrefined"):
        image_io.read_rgb(tmp_path / "p.jpg")
    png = png_adam7(rng.integers(0, 256, (9, 11, 3)), 8, 2)
    idat = png.index(b"IDAT")
    body = zlib.compress(zlib.decompress(png[idat + 4:png.index(
        b"IEND") - 8])[:-20])
    (tmp_path / "i.png").write_bytes(png[:idat - 4] + _chunk(b"IDAT", body)
                                     + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="truncated PNG"):
        image_io.read_rgb(tmp_path / "i.png")
    cv2.imwrite(str(tmp_path / "b.jpg"), img)
    data = (tmp_path / "b.jpg").read_bytes()
    (tmp_path / "cut.jpg").write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match="cut.jpg: truncated"):
        image_io.read_rgb(tmp_path / "cut.jpg")
    (tmp_path / "t.txt").write_bytes(b"not an image")
    with pytest.raises(ValueError, match="not a JPEG, PNG or BMP"):
        image_io.read_rgb(tmp_path / "t.txt")
    with pytest.raises(ValueError, match="not a JPEG, PNG or BMP"):
        image_io.read_unchanged(tmp_path / "t.txt")


# -- progressive JPEG ---------------------------------------------------------

@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("sampling", ["420", "422", "444"])
def test_progressive_jpeg_equals_opencv(quality, sampling):
    """Progressive files as OpenCV writes them (libjpeg-turbo's standard
    scan script: DC first and refine, AC first and refine scans with EOB
    runs), with and without restart intervals and optimized tables, in
    colour and unchanged; every size of ``JPEG_SIZES``."""
    rng = np.random.default_rng(quality + len(sampling))
    for h, w in JPEG_SIZES:
        for extra in ([], [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
                      [cv2.IMWRITE_JPEG_OPTIMIZE, 1]):
            ok, buf = cv2.imencode(".jpg", smooth_image(rng, h, w), [
                cv2.IMWRITE_JPEG_QUALITY, quality,
                cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling],
                *extra])
            data = buf.tobytes()
            assert b"\xff\xc2" in data
            np.testing.assert_array_equal(image_io.decode_bgr(data),
                                          cv2.imdecode(buf, cv2.IMREAD_COLOR))
            np.testing.assert_array_equal(
                image_io.decode_unchanged(data),
                cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))


def test_progressive_grayscale_jpeg_equals_opencv():
    rng = np.random.default_rng(3)
    for quality in (50, 95):
        for h, w in JPEG_SIZES:
            ok, buf = cv2.imencode(".jpg", smooth_image(rng, h, w, 1)[:, :, 0],
                                   [cv2.IMWRITE_JPEG_QUALITY, quality,
                                    cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                    cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
            got = image_io.decode_unchanged(buf.tobytes())
            want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
            assert got.shape == want.shape == (h, w)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(image_io.decode_bgr(buf.tobytes()),
                                          cv2.imdecode(buf, cv2.IMREAD_COLOR))


def _scans(data: bytes) -> list:
    """The offsets of a JPEG's SOS markers."""
    at, out = 2, []
    while True:
        at = data.find(b"\xff\xda", at)
        if at < 0:
            return out
        out.append(at)
        at += 2


@pytest.mark.parametrize("sampling", ["420", "444"])
def test_progressive_jpeg_cut_after_each_scan(sampling):
    """A file cut after any scan (EOI spliced in) either decodes to
    OpenCV's pixels or raises naming the block smoothing; with OpenCV's
    scan script every early cut leaves coefficients 1-9 unrefined, so only
    the whole file decodes."""
    rng = np.random.default_rng(len(sampling))
    ok, buf = cv2.imencode(".jpg", smooth_image(rng, 64, 80), [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]])
    data = buf.tobytes()
    cuts = _scans(data)[1:] + [len(data) - 2]
    decoded = 0
    for at in cuts:
        cut = data[:at] + b"\xff\xd9"
        want = cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR)
        try:
            got = image_io.decode_bgr(cut)
        except ValueError as e:
            assert "unrefined" in str(e)
            continue
        np.testing.assert_array_equal(got, want)
        decoded += 1
    assert decoded == 1 and len(cuts) == 10


def test_progressive_jpeg_of_other_scan_scripts():
    """Scan scripts other than OpenCV's (written by PIL's libjpeg):
    optimized progressive files at several qualities and subsamplings."""
    import io

    from PIL import Image

    rng = np.random.default_rng(5)
    for quality, subsampling in ((75, 0), (85, 1), (95, 2)):
        img = smooth_image(rng, 57, 83)
        out = io.BytesIO()
        Image.fromarray(img).save(out, "JPEG", quality=quality,
                                  progressive=True, optimize=True,
                                  subsampling=subsampling)
        data = out.getvalue()
        assert b"\xff\xc2" in data
        np.testing.assert_array_equal(
            image_io.decode_bgr(data),
            cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))


# -- PNG --------------------------------------------------------------------------

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_png(rows, w, h, depth, ctype, palette=None, trns=None) -> bytes:
    """A PNG whose row ``r`` uses filter ``r % 5``."""
    bpp = max(1, _CHANNELS[ctype] * depth // 8)
    out = bytearray()
    prev = bytearray(len(rows[0]))
    for r, row in enumerate(rows):
        kind = r % 5
        row = bytearray(row)
        filt = bytearray(len(row))
        for i in range(len(row)):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            x = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]
            filt[i] = (row[i] - x) & 255
        out += bytes([kind]) + filt
        prev = row
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if palette is not None:
        data += _chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    return data + _chunk(b"IDAT", zlib.compress(bytes(out))) + _chunk(
        b"IEND", b"")


@pytest.mark.parametrize("ctype,depth", [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
    (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
def test_png_equals_opencv(tmp_path, ctype, depth):
    rng = np.random.default_rng(ctype * 100 + depth)
    path = tmp_path / "x.png"
    for h, w in [(1, 1), (3, 5), (7, 13), (16, 9), (33, 17)]:
        ch = _CHANNELS[ctype]
        rowbytes = (w * ch * depth + 7) // 8
        palette = trns = None
        if ctype == 3:
            n = min(256, 1 << depth)
            palette = rng.integers(0, 256, (n, 3)).astype(np.uint8)
            trns = bytes(rng.integers(0, 256, n).astype(np.uint8))
            vals = rng.integers(0, n, (h, w))
        else:
            vals = rng.integers(0, 1 << depth, (h, w * ch))
        if depth < 8:
            per = 8 // depth
            v = np.zeros((h, rowbytes * per), np.int64)
            v[:, :vals.shape[1]] = vals
            shifts = np.arange(8 - depth, -1, -depth)
            rows = [bytes((v[r].reshape(rowbytes, per) << shifts).sum(-1)
                          .astype(np.uint8)) for r in range(h)]
        elif depth == 8:
            rows = [bytes(vals[r].astype(np.uint8)) for r in range(h)]
        else:
            rows = [vals[r].astype(">u2").tobytes() for r in range(h)]
        path.write_bytes(encode_png(rows, w, h, depth, ctype, palette, trns))
        assert_same_as_cv2(path)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_opencv_png_and_bmp(tmp_path, dtype):
    from PIL import Image

    rng = np.random.default_rng(int(np.dtype(dtype).itemsize))
    top = np.iinfo(dtype).max + 1
    for h, w in [(1, 1), (3, 5), (33, 17), (375, 500)]:
        for c in (1, 3, 4):
            img = rng.integers(0, top, (h, w, c)).astype(dtype)
            cv2.imwrite(str(tmp_path / "c.png"), img)
            assert_same_as_cv2(tmp_path / "c.png")
        if dtype == np.uint8:
            img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            cv2.imwrite(str(tmp_path / "c.bmp"), img)
            assert_same_as_cv2(tmp_path / "c.bmp")
            cv2.imwrite(str(tmp_path / "g.bmp"), img[:, :, 0])
            assert_same_as_cv2(tmp_path / "g.bmp")
            Image.fromarray(img).save(tmp_path / "p.bmp")
            assert_same_as_cv2(tmp_path / "p.bmp")
            Image.fromarray(img[:, :, 0]).convert("P").save(tmp_path / "q.bmp")
            assert_same_as_cv2(tmp_path / "q.bmp")


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _rows(samples: np.ndarray, depth: int) -> list:
    """The packed rows of ``samples`` ``[h, w, ch]`` at ``depth`` bits."""
    out = []
    for row in samples:
        if depth == 16:
            out.append(row.astype(">u2").tobytes())
        elif depth == 8:
            out.append(row.astype(np.uint8).tobytes())
        else:
            per = 8 // depth
            v = np.zeros(-(-row.shape[0] // per) * per, np.int64)
            v[:row.shape[0]] = row[:, 0]
            shifts = np.arange(8 - depth, -1, -depth)
            out.append(bytes((v.reshape(-1, per) << shifts).sum(-1)
                             .astype(np.uint8)))
    return out


def png_adam7(samples, depth, ctype, palette=None, trns=None) -> bytes:
    """An interlaced PNG of ``samples`` ``[h, w, ch]``: each pass's rows
    filtered as ``encode_png`` filters them (row ``r`` by ``r % 5``)."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    raw = b""
    for x0, y0, dx, dy in ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            one = encode_png(_rows(sub, depth), sub.shape[1], sub.shape[0],
                             depth, ctype)
            at = one.index(b"IDAT")
            raw += zlib.decompress(one[at + 4:one.index(b"IEND") - 8])
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, 1))
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    return data + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _png_case(rng, ctype, depth, h, w, with_trns):
    """Random samples of a PNG type (and its palette and ``tRNS``)."""
    ch = _CHANNELS[ctype]
    palette = trns = None
    if ctype == 3:
        n = 1 << depth
        palette = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        samples = rng.integers(0, n, (h, w, 1))
        if with_trns:
            trns = bytes(rng.integers(0, 256, max(1, n // 2)).astype(
                np.uint8))
    else:
        samples = rng.integers(0, 1 << depth, (h, w, ch))
        if with_trns and ctype == 0:
            trns = struct.pack(">H", int(samples[0, 0, 0]))
        elif with_trns and ctype == 2:
            trns = struct.pack(">HHH", *(int(v) for v in samples[0, 0]))
    return samples, palette, trns


PNG_TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("ctype,depth", PNG_TYPES)
def test_interlaced_png_equals_opencv(ctype, depth):
    """Adam7 at every colour type and bit depth, with and without
    ``tRNS``, sizes smaller than a pass and larger: ``IMREAD_COLOR`` and
    ``IMREAD_UNCHANGED``."""
    rng = np.random.default_rng(ctype * 31 + depth)
    for h, w in [(1, 1), (1, 9), (9, 1), (3, 5), (7, 13), (16, 9), (33, 17)]:
        for with_trns in ((False, True) if ctype in (0, 2, 3) else (False,)):
            samples, palette, trns = _png_case(rng, ctype, depth, h, w,
                                               with_trns)
            data = png_adam7(samples, depth, ctype, palette, trns)
            buf = np.frombuffer(data, np.uint8)
            for mode, fn in ((cv2.IMREAD_COLOR, image_io.decode_bgr),
                             (cv2.IMREAD_UNCHANGED,
                              image_io.decode_unchanged)):
                want = cv2.imdecode(buf, mode)
                got = fn(data)
                assert got.shape == want.shape and got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ctype,depth", PNG_TYPES)
def test_png_unchanged_equals_opencv(ctype, depth):
    """``read_unchanged`` on every PNG type (all five filters), with and
    without ``tRNS``: gray 2-D (16-bit kept, 1/2/4-bit scaled), colour
    BGR, alpha BGRA (gray + alpha repeated), palette and RGB with ``tRNS``
    BGRA."""
    rng = np.random.default_rng(ctype * 17 + depth)
    for h, w in [(1, 1), (3, 5), (7, 13), (33, 17)]:
        for with_trns in ((False, True) if ctype in (0, 2, 3) else (False,)):
            samples, palette, trns = _png_case(rng, ctype, depth, h, w,
                                               with_trns)
            data = encode_png(_rows(samples, depth), w, h, depth, ctype,
                              palette, trns)
            want = cv2.imdecode(np.frombuffer(data, np.uint8),
                                cv2.IMREAD_UNCHANGED)
            got = image_io.decode_unchanged(data)
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_unchanged_jpeg_and_bmp_equal_opencv(tmp_path):
    """``read_unchanged`` on JPEGs (colour, gray, an EXIF orientation that
    ``IMREAD_UNCHANGED`` does not apply) and BMPs (24-bit, gray and colour
    palettes), and on OpenCV's own 8- and 16-bit PNGs."""
    from PIL import Image

    rng = np.random.default_rng(9)
    img = smooth_image(rng, 37, 53)
    cv2.imwrite(str(tmp_path / "c.jpg"), img)
    cv2.imwrite(str(tmp_path / "g.jpg"), img[:, :, 0])
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(img).save(tmp_path / "o.jpg", quality=90,
                              exif=exif.tobytes())
    cv2.imwrite(str(tmp_path / "c.bmp"), img)
    cv2.imwrite(str(tmp_path / "g.bmp"), img[:, :, 0])
    Image.fromarray(img).quantize(16).save(tmp_path / "p.bmp")
    Image.fromarray(img[:, :, 0]).convert("P").save(tmp_path / "q.bmp")
    for c in (1, 3, 4):
        for dtype in (np.uint8, np.uint16):
            top = np.iinfo(dtype).max + 1
            cv2.imwrite(str(tmp_path / f"{c}_{dtype.__name__}.png"),
                        rng.integers(0, top, (19, 23, c)).astype(dtype))
    for path in sorted(tmp_path.iterdir()):
        want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        got = image_io.read_unchanged(path)
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want)


def test_bgr_to_gray_on_every_colour():
    v = np.arange(256, dtype=np.uint8)
    b, g, r = np.meshgrid(v, v, v, indexing="ij")
    bgr = np.stack([b, g, r], -1).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(image_io.bgr_to_gray(bgr),
                                  cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))


def test_voc_palette_png_as_gray(tmp_path):
    """A VOC label PNG read as gray: the border's palette index 255 becomes
    220, the ignore label of the VOC loader."""
    from PIL import Image

    from tests.test_torch_datasets import voc_palette

    rng = np.random.default_rng(0)
    labels = rng.integers(0, 4, (37, 41)).astype(np.uint8)
    labels[:2] = 255
    im = Image.fromarray(labels, "P")
    im.putpalette(voc_palette().reshape(-1).tolist())
    im.save(tmp_path / "v.png")
    want = cv2.cvtColor(cv2.imread(str(tmp_path / "v.png")),
                        cv2.COLOR_BGR2GRAY)
    got = image_io.read_gray(tmp_path / "v.png")
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 220


def test_host_library_name_hashes_the_source(tmp_path, monkeypatch):
    from isegprobe_torch.utils import host_lib

    before = host_lib.library_path()
    (tmp_path / "host").mkdir()
    for src in host_lib.sources():
        (tmp_path / "host" / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(host_lib, "CSRC", tmp_path)
    assert host_lib.library_path().name == before.name
    copy = tmp_path / "host" / "jpeg.cpp"
    copy.write_bytes(copy.read_bytes() + b"\n// edited\n")
    assert host_lib.library_path().name != before.name
    assert host_lib.library_path().parent == tmp_path / "build"


# -- affine warps -----------------------------------------------------------------

WARP_SHAPES = [(375, 500), (500, 375), (321, 481), (480, 854), (100, 77),
               (224, 250), (33, 16), (20, 8), (64, 7)]


def _warps(rng, n_narrow=24, n_wide=12):
    """(shape, matrix) pairs: ``ShiftScaleRotate``'s SBD ranges, its
    defaults, and wide rotations and scales."""
    out = []
    for k in range(n_narrow + n_wide):
        h, w = WARP_SHAPES[k % len(WARP_SHAPES)]
        if k < n_narrow // 2:
            angle, scale, shift = rng.uniform(-3, 3), 1.0, 0.03
        elif k < n_narrow:
            angle, scale, shift = (rng.uniform(-45, 45),
                                   1 + rng.uniform(-0.1, 0.1), 0.0625)
        else:
            angle, scale, shift = (rng.uniform(-180, 180),
                                   rng.uniform(0.5, 2), 0.3)
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, scale)
        m[0, 2] += rng.uniform(-shift, shift) * w
        m[1, 2] += rng.uniform(-shift, shift) * h
        out.append(((h, w), (angle, scale), m))
    return out


@pytest.mark.parametrize("channels", [3, 1])
def test_warp_affine_linear_equals_opencv(channels):
    rng = np.random.default_rng(channels)
    for (h, w), (angle, scale), m in _warps(rng):
        np.testing.assert_array_equal(
            raster.rotation_matrix_2d((w / 2, h / 2), angle, scale)[:, :2],
            cv2.getRotationMatrix2D((w / 2, h / 2), angle, scale)[:, :2])
        shape = (h, w, channels) if channels > 1 else (h, w)
        img = rng.integers(0, 256, shape).astype(np.uint8)
        want = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        got = raster.warp_affine(img, m, (w, h))
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_warp_affine_nearest_equals_opencv():
    rng = np.random.default_rng(7)
    for (h, w), (angle, scale), m in _warps(rng):
        np.testing.assert_array_equal(
            raster.rotation_matrix_2d((w / 2, h / 2), angle, scale),
            cv2.getRotationMatrix2D((w / 2, h / 2), angle, scale))
        mask = rng.integers(0, 5, (h, w, 1)).astype(np.int32)
        want = cv2.warpAffine(mask, m, (w, h), flags=cv2.INTER_NEAREST,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        got = raster.warp_affine(mask, m, (w, h), nearest=True)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        # CocoLvis's packed layers: uint8, two of them
        layers = rng.integers(0, 5, (h, w, 2)).astype(np.uint8)
        want = cv2.warpAffine(layers, m, (w, h), flags=cv2.INTER_NEAREST,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        got = raster.warp_affine(layers, m, (w, h), nearest=True)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError, match="int32 or uint8"):
        raster.warp_affine(mask.astype(np.float32), m, (w, h), nearest=True)
    with pytest.raises(TypeError, match="uint8"):
        raster.warp_affine(mask, m, (w, h))
