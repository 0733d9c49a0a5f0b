"""The native host EDT (``csrc/host/edt.cpp`` through ``ops/edt.py``)
against its plain scipy version and the JAX package's host ``edt_l2sq``,
bitwise; ``click_dist_maps_host`` against its numpy body and the JAX
package's; the host library's hash and rebuild on a copy of ``csrc/``."""

import threading

import numpy as np
import pytest

from isegprobe_torch.ops import edt


def _blobs(shape, seed, n=6):
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, np.uint8)
    for _ in range(n):
        y, x = rng.integers(0, shape[0]), rng.integers(0, shape[1])
        hh, ww = rng.integers(1, max(2, shape[0] // 3)), rng.integers(
            1, max(2, shape[1] // 3))
        m[y:y + hh, x:x + ww] = 1
    return m


def _random(shape, seed, p):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.uint8)


MASKS = {
    "random_sparse": lambda: _random((37, 53), 0, 0.1),
    "random_half": lambda: _random((64, 48), 1, 0.5),
    "random_dense": lambda: _random((50, 70), 2, 0.97),
    "blobs": lambda: _blobs((90, 120), 3),
    "one_zero": lambda: np.pad(np.ones((40, 60), np.uint8), 0) * (
        1 - np.eye(1, 40 * 60, 1234, dtype=np.uint8).reshape(40, 60)),
    "row_1xN": lambda: _random((1, 257), 4, 0.8),
    "col_Nx1": lambda: _random((311, 1), 5, 0.8),
    "all_zeros": lambda: np.zeros((20, 30), np.uint8),
    "davis_854x480": lambda: np.pad(_blobs((480, 854), 6, n=10), 1),
}


@pytest.mark.parametrize("name", list(MASKS))
def test_native_edt_matches_plain_and_jax(name):
    from isegprobe_tpu.ops.edt import edt_l2sq as j_edt

    mask = MASKS[name]()
    got = edt.edt_l2sq(mask)
    assert got.dtype == np.float32 and got.shape == mask.shape
    np.testing.assert_array_equal(got, edt.edt_l2sq_plain(mask))
    np.testing.assert_array_equal(got, j_edt(mask))
    np.testing.assert_array_equal(edt.edt_l2(mask), np.sqrt(got))


def test_native_edt_without_a_zero_pixel():
    """No zero pixel: float32(1e12) everywhere (the device path's clamp and
    the plain version's), where the JAX package's C++ returns its own
    larger sentinel."""
    from isegprobe_tpu.ops.edt import edt_l2sq as j_edt

    ones = np.ones((17, 23), np.uint8)
    got = edt.edt_l2sq(ones)
    np.testing.assert_array_equal(got, edt.edt_l2sq_plain(ones))
    assert (got == np.float32(edt.BIG2)).all()
    assert (j_edt(ones) >= got).all()
    np.testing.assert_array_equal(edt.edt_l2(ones), np.sqrt(got))
    # bool and other dtypes are read as non-zero = foreground
    mask = _random((20, 20), 7, 0.5)
    np.testing.assert_array_equal(edt.edt_l2sq(mask.astype(bool)),
                                  edt.edt_l2sq(mask * 7))
    with pytest.raises(ValueError, match="2-D"):
        edt.edt_l2sq(np.ones((2, 3, 4)))


def test_native_edt_in_threads():
    """ctypes releases the GIL: four threads give the serial results."""
    masks = [_blobs((200, 300), s) for s in range(8)]
    want = [edt.edt_l2sq(m) for m in masks]
    got = [None] * len(masks)

    def work(i):
        got[i] = edt.edt_l2sq(masks[i])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _points(seed, n=5, hw=(40, 50)):
    rng = np.random.default_rng(seed)
    pts = np.full((2 * n, 3), -1.0, np.float32)
    for i in range(2 * n):
        if rng.random() < 0.7:
            pts[i] = (rng.random() * hw[0], rng.random() * hw[1], i)
    pts[0, :2] = (2.5, 3.5)  # halves round to even
    pts[n, :2] = (-0.4, 7.0)  # max(y, x) >= 0: a valid click
    pts[n - 1, :2] = (-1.0, -2.0)  # invalid
    return pts


@pytest.mark.parametrize("seed,norm", [(0, 5.0), (1, 1.0), (2, 3.7)])
def test_click_dist_maps_host_matches_plain_and_jax(seed, norm):
    from isegprobe_tpu.ops.edt import click_dist_maps_host as j_maps

    pts = _points(seed)
    got = edt.click_dist_maps_host(pts, 40, 50, norm)
    assert got.shape == (2, 40, 50) and got.dtype == np.float32
    np.testing.assert_allclose(got, edt.click_dist_maps_plain(pts, 40, 50,
                                                              norm),
                               rtol=2e-6)
    np.testing.assert_allclose(got, j_maps(pts, 40, 50, norm), rtol=2e-6)
    # no valid click in a layer: 1e6 everywhere
    none = np.full((4, 3), -1.0, np.float32)
    assert (edt.click_dist_maps_host(none, 5, 6, norm) == 1e6).all()


def test_host_library_hash_and_rebuild(tmp_path, monkeypatch):
    """On a copy of ``csrc/host``: the library builds at first use under a
    name that hashes every source and the flags; an edited source builds a
    second library; a source g++ refuses raises with its output."""
    from isegprobe_torch.utils import host_lib

    (tmp_path / "host").mkdir()
    for src in host_lib.sources():
        (tmp_path / "host" / src.name).write_bytes(src.read_bytes())
    assert {s.name for s in host_lib.sources()} >= {"edt.cpp", "jpeg.cpp"}
    name = host_lib.library_path().name
    monkeypatch.setattr(host_lib, "CSRC", tmp_path)
    monkeypatch.setattr(host_lib, "_lib", [])
    assert host_lib.library_path() == tmp_path / "build" / name
    host_lib.load()
    assert (tmp_path / "build" / name).exists()
    mask = _blobs((30, 40), 8)
    np.testing.assert_array_equal(edt.edt_l2sq(mask),
                                  edt.edt_l2sq_plain(mask))

    cpp = tmp_path / "host" / "edt.cpp"
    cpp.write_text(cpp.read_text() + "\n// edited\n")
    edited = host_lib.library_path()
    assert edited.name != name
    monkeypatch.setattr(host_lib, "_lib", [])
    host_lib.load()
    assert sorted(p.name for p in (tmp_path / "build").glob("*.so")) == \
        sorted([name, edited.name])

    cpp.write_text(cpp.read_text() + "\nnot c++ at all\n")
    monkeypatch.setattr(host_lib, "_lib", [])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host_lib.load()
