"""Euclidean distance transforms for the simulated user: host and device.

Counterpart of ``isegprobe_tpu/ops/edt.py``.

* :func:`edt_l2sq` / :func:`edt_l2` — the host EDT on the native library
  (``csrc/host/edt.cpp``, the JAX package's exact Felzenszwalb–Huttenlocher
  source, built by ``utils/host_lib.py``). Squared distances are exact
  integers in float32, so depth comparisons and first-maximum argmax ties
  resolve exactly as in the JAX package. A mask with no zero pixel is
  "infinitely far" everywhere: ``float32(1e12)``, the device path's clamp
  (the JAX package's C++ returns 1e20 there; the padded callers, the
  clicker and the click sampler, never reach that case).
  :func:`edt_l2sq_plain` is its plain version on scipy: the squared
  distance as an exact integer from the nearest-zero indices that
  ``distance_transform_edt`` returns. Tests hold the two bitwise.
* :func:`click_dist_maps_host` — the two layers of minimum normalised
  squared distance to the rounded clicks, on the native library;
  :func:`click_dist_maps_plain` is its numpy body.
* :func:`edt_l2sq_device` — the exact squared EDT on tensors of any leading
  shape: a column pass (``torch.cummax``/``cummin``) and the row pass
  :func:`row_envelope`, the wrapper around the hand-written CUDA kernel C
  (``csrc/edt.cu``, replacing the Pallas TPU kernel
  ``_row_envelope_pallas``): an exact lower envelope of parabolas in
  integers, one warp a row, its minimum rounded once to float32, so the
  kernel is bitwise equal to its plain version and decisions match the host
  path bitwise.
* :func:`next_click_from_error` — the clicker's decision rule over a leading
  lane axis, for the on-device click loop.

On a CPU tensor :func:`row_envelope` computes its plain version; on a CUDA
tensor it launches kernel C or raises. ``row_envelope.launches`` counts the
launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from scipy.ndimage import distance_transform_edt

from isegprobe_torch.ops import cuda_lib
from isegprobe_torch.utils import host_lib

__all__ = ["edt_l2sq", "edt_l2", "edt_l2sq_plain", "click_dist_maps_host",
           "click_dist_maps_plain", "edt_l2sq_device",
           "next_click_from_error", "row_envelope"]

_BIG = 1.0e6  # "infinity" for column distances; squared stays finite in f32
# the clamp of every squared distance: float32(1e12) = 999999995904
BIG2 = float(np.float32(_BIG**2))
# widest row kernel C takes: its columns fit int16
MAX_ROW_WIDTH = 4096
# what iseg_edt_config reports, in its order
CONFIG_KEYS = ("rows_per_block", "threads", "segment", "smem_bytes",
               "blocks_per_sm", "registers", "local_bytes")
# plain row pass: elements of its [rows, W, block] candidate temporary
_PLAIN_TMP_ELEMS = 1 << 25
_lib = None


# ---------------------------------------------------------------------------
# Host path
# ---------------------------------------------------------------------------


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _native_edt(name: str, mask: np.ndarray) -> np.ndarray:
    mask_u8 = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    if mask_u8.ndim != 2:
        raise ValueError(f"EDT takes a 2-D mask, got shape {mask_u8.shape}")
    h, w = mask_u8.shape
    out = np.empty((h, w), np.float32)
    if mask_u8.size:
        getattr(host_lib.load(), name)(
            mask_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
            _f32p(out))
    return out


def edt_l2sq(mask: np.ndarray) -> np.ndarray:
    """Exact squared L2 EDT of a 2-D mask (float32) on the native host
    library: the squared distance from each non-zero pixel to the nearest
    zero pixel, 0 at zeros. Without any zero pixel every value is
    ``float32(1e12)``, as on the device."""
    return _native_edt("edt_l2sq", mask)


def edt_l2(mask: np.ndarray) -> np.ndarray:
    """Exact L2 EDT (float32), the square root of :func:`edt_l2sq`."""
    return _native_edt("edt_l2", mask)


def edt_l2sq_plain(mask: np.ndarray) -> np.ndarray:
    """:func:`edt_l2sq` on scipy, its plain version."""
    fg = np.asarray(mask) != 0
    if fg.all():
        return np.full(fg.shape, BIG2, np.float32)
    iy, ix = distance_transform_edt(fg, return_distances=False,
                                    return_indices=True)
    yy, xx = np.indices(fg.shape)
    d2 = (iy - yy).astype(np.int64) ** 2 + (ix - xx).astype(np.int64) ** 2
    return d2.astype(np.float32)


def click_dist_maps_host(points: np.ndarray, height: int, width: int,
                         norm_delimiter: float) -> np.ndarray:
    """``[2, H, W]`` float32 on the native host library: per layer
    (positive clicks, the first half of ``points`` ``[2N, 3]``; negative,
    the second half) the minimum over valid clicks (``max(y, x) >= 0``) of
    the squared distance to the click's coordinates rounded half to even,
    divided by ``norm_delimiter²``; 1e6 where a layer has no click."""
    pts = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 3)
    out = np.empty((2, height, width), np.float32)
    host_lib.load().click_dist_maps(_f32p(pts), pts.shape[0], height, width,
                                    float(norm_delimiter), _f32p(out))
    return out


def click_dist_maps_plain(points: np.ndarray, height: int, width: int,
                          norm_delimiter: float) -> np.ndarray:
    """:func:`click_dist_maps_host` in numpy (float64, cast once), its
    plain version."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    out = np.full((2, height, width), 1e6, dtype=np.float32)
    rr, cc = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    n = pts.shape[0]
    for p in range(n):
        y, x = pts[p, 0], pts[p, 1]
        if max(y, x) < 0:
            continue
        li = 1 if p >= n // 2 else 0
        d2 = (((rr - round(float(y))) / norm_delimiter) ** 2
              + ((cc - round(float(x))) / norm_delimiter) ** 2)
        out[li] = np.minimum(out[li], d2.astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# Device path
# ---------------------------------------------------------------------------


def _column_pass(zero: torch.Tensor) -> torch.Tensor:
    """Vertical distance to the nearest zero pixel per column.

    zero: ``[..., H, W]`` bool (True at background). Returns float32
    ``[..., H, W]``: ``min(i − lastzero_i, nextzero_i − i)``, from a running
    max of the zero rows above and a reversed running min below, with the
    JAX package's ``_BIG`` sentinels; ``_BIG`` where the column has no zero.
    All values are integers ≤ _BIG + H, exact in f32."""
    axis = zero.ndim - 2
    idx = torch.arange(zero.shape[axis], dtype=torch.float32,
                       device=zero.device).reshape(-1, 1)
    rows = idx.expand(zero.shape)
    lastz = torch.cummax(rows.masked_fill(~zero, -_BIG), dim=axis).values
    below = rows.masked_fill(~zero, 2 * _BIG).flip(axis)
    nextz = torch.cummin(below, dim=axis).values.flip(axis)
    return torch.minimum(idx - lastz, nextz - idx).clamp_max(_BIG)


def _row_envelope_plain(g: torch.Tensor, block: int = 128) -> torch.Tensor:
    """``d2[..., i, j] = min_j' g[..., i, j']² + (j − j')²``, clamped to
    ``float32(1e12)``: the JAX package's ``_row_envelope``, blocked over
    sources (and over rows, so that the ``[rows, W, block]`` candidate
    temporary stays under ``_PLAIN_TMP_ELEMS`` elements)."""
    w = g.shape[-1]
    g2 = torch.square(g.float()).reshape(-1, w)
    rows = g2.shape[0]
    cols = torch.arange(w, dtype=torch.float32, device=g.device)
    chunk = max(1, _PLAIN_TMP_ELEMS // (w * block))
    out = torch.full_like(g2, BIG2)
    for r0 in range(0, rows, chunk):
        acc = out[r0:r0 + chunk]
        for s0 in range(0, w, block):
            src = cols[s0:s0 + block]
            dist = torch.square(cols[:, None] - src[None, :])  # [W, C]
            cand = (g2[r0:r0 + chunk, None, s0:s0 + block] + dist).amin(-1)
            torch.minimum(acc, cand, out=acc)
    return out.reshape(g.shape)


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("edt")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.iseg_edt_row_envelope.argtypes = [vp, vp, ci, ci, vp]
        lib.iseg_edt_row_envelope.restype = ci
        lib.iseg_edt_config.argtypes = [ci, ctypes.POINTER(ci)]
        lib.iseg_edt_config.restype = ci
        _lib = lib
    return _lib


def kernel_config(w: int, device=None) -> dict:
    """Kernel C's layout at row width ``w`` as its library was compiled,
    and its resources as loaded on a CUDA ``device`` (default: the current
    one), from the library itself: ``CONFIG_KEYS``, among them the segment
    width of a lane, the resident blocks an SM from CUDA's occupancy
    calculator and the local (stack and spill) bytes a thread."""
    lib = _load()
    buf = (ctypes.c_int * len(CONFIG_KEYS))()
    with torch.cuda.device(device):
        err = lib.iseg_edt_config(w, buf)
    cuda_lib.check(lib, err, "EDT row kernel C's configuration")
    return dict(zip(CONFIG_KEYS, buf))


def _row_envelope_cuda(g: torch.Tensor) -> torch.Tensor:
    if g.dtype != torch.float32:
        raise TypeError(f"EDT row kernel takes float32, got {g.dtype}")
    if not g.is_contiguous():
        raise ValueError("EDT row kernel needs a contiguous tensor")
    w = g.shape[-1]
    rows = g.numel() // max(w, 1)
    if not 1 <= w <= MAX_ROW_WIDTH:
        raise ValueError(f"EDT row kernel takes 1 <= W <= {MAX_ROW_WIDTH}, "
                         f"got {w}")
    if rows >= 2**31:
        raise ValueError(f"EDT row kernel takes fewer than 2^31 rows, got "
                         f"{rows}")
    lib = _load()
    out = torch.empty_like(g)
    if rows == 0:
        return out
    with torch.cuda.device(g.device):
        err = lib.iseg_edt_row_envelope(g.data_ptr(), out.data_ptr(), rows, w,
                                        cuda_lib.current_stream(g))
    cuda_lib.check(lib, err, "EDT row kernel launch")
    return out


def row_envelope(g: torch.Tensor) -> torch.Tensor:
    """The EDT row pass over the last axis of ``g`` (float32 column
    distances, any leading shape): exact integers in f32, clamped to
    ``float32(1e12)``."""
    if g.device.type == "cpu":
        return _row_envelope_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"row_envelope runs on cpu or cuda, not {g.device}")
    out = _row_envelope_cuda(g)
    row_envelope.launches += 1
    return out


row_envelope.launches = 0


def edt_l2sq_device(mask: torch.Tensor, pad_border: bool = False
                    ) -> torch.Tensor:
    """Exact squared L2 EDT of ``mask`` ``[..., H, W]`` (bool or numeric;
    non-zero = foreground) on the mask's device: the squared distance from
    each non-zero pixel to the nearest zero pixel, 0 at zeros,
    ``float32(1e12)`` where there is no zero at all. ``pad_border=True``
    treats out-of-image pixels as zero (the clicker's padding convention)."""
    fg = mask.bool()
    if pad_border:
        padded = fg.new_zeros((*fg.shape[:-2], fg.shape[-2] + 2,
                               fg.shape[-1] + 2))
        padded[..., 1:-1, 1:-1] = fg
        fg = padded
    d2 = row_envelope(_column_pass(~fg)).masked_fill_(~fg, 0.0)
    if pad_border:
        d2 = d2[..., 1:-1, 1:-1]
    return d2


def next_click_from_error(gt_mask: torch.Tensor, pred_mask: torch.Tensor,
                          not_clicked: torch.Tensor,
                          not_ignore: torch.Tensor | None = None):
    """The clicker's decision rule over a leading lane axis: click at the
    deepest point of the larger error region (reference:
    core/inference/clicker.py:58-91).

    All arguments are ``[B, H, W]`` bool. Returns ``(is_positive [B] bool,
    y [B], x [B])`` int64 tensors on the masks' device, with no host sync.
    Decisions are exact: squared distances are exact integers in f32,
    ``is_positive`` is the strict ``fn_max > fp_max``, and the location is
    the first row-major maximum (``torch.argmax`` returns the first maximal
    index on the CPU and on CUDA), as ``np.argmax`` on the host. A lane with
    no error at all clicks (0, 0) as a negative."""
    if not_ignore is None:
        not_ignore = torch.ones_like(gt_mask, dtype=torch.bool)
    fn = gt_mask & ~pred_mask & not_ignore
    fp = ~gt_mask & pred_mask & not_ignore
    d2 = edt_l2sq_device(torch.stack([fn, fp], dim=1), pad_border=True)
    d2 = d2.masked_fill_(~not_clicked[:, None], 0.0)  # [B, 2, H, W]
    fn_d2, fp_d2 = d2[:, 0], d2[:, 1]
    is_positive = fn_d2.amax(dim=(1, 2)) > fp_d2.amax(dim=(1, 2))
    chosen = torch.where(is_positive[:, None, None], fn_d2, fp_d2)
    w = gt_mask.shape[-1]
    flat = torch.argmax(chosen.reshape(chosen.shape[0], -1), dim=1)
    return is_positive, flat // w, flat % w
