"""The click protocol in plain NumPy and PyTorch: the simulated user, the
fixed ZoomIn with flip, and the judge that holds a program's answers to it.

The protocol (the RITM clicker and ZoomIn, as the iSegProbe evaluation runs
them): a click goes to the deepest point of the larger error region,
positive when that is the missed object, depth being the Euclidean distance
to the region's edge with the frame's border counted as edge, a pixel never
clicked twice. The model sees the crop of the expanded bounding box of the
previous mask at ``roi_prob_thresh`` and the positive clicks, resized to the
target size with align-corners bilinear, and its width flip; the two logits
are averaged, the sigmoid pasted back into the frame, and the mask is the
probabilities above ``pred_thr``. The ROI is kept while it holds every
positive click and overlaps the new candidate by ``recompute_thresh_iou``.

:class:`ClickRun` walks one object click by click. The judge
(:func:`judge_object`) feeds it the program's own clicks: at every click it
asks where this user would have clicked on the reference's own previous
mask, then computes the reference's probabilities for the same clicks and
compares the program's IoUs, stops and probabilities.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence, Union

import numpy as np
import torch
from scipy import ndimage

from benchmark.reference import model as ref_model
from benchmark.reference import weights


def _depth(region: np.ndarray, usable: np.ndarray) -> np.ndarray:
    """Distance of every pixel of ``region`` to its edge (the frame's
    border counts as edge), zero where not ``usable``."""
    padded = np.pad(region, 1)
    return ndimage.distance_transform_edt(padded)[1:-1, 1:-1] * usable


def _bbox(mask: np.ndarray):
    rows, cols = np.any(mask, axis=1), np.any(mask, axis=0)
    r = np.flatnonzero(rows)
    c = np.flatnonzero(cols)
    return float(r[0]), float(r[-1]), float(c[0]), float(c[-1])


def _expand(bbox, ratio, min_size, h, w):
    f32 = np.float32
    rmin, rmax, cmin, cmax = (f32(v) for v in bbox)
    rc, cc = f32(0.5) * (rmin + rmax), f32(0.5) * (cmin + cmax)
    hh = max(f32(ratio) * (rmax - rmin + f32(1)), f32(min_size))
    ww = max(f32(ratio) * (cmax - cmin + f32(1)), f32(min_size))
    return (int(max(np.round(rc - f32(0.5) * hh), 0)),
            int(min(h - 1, np.round(rc + f32(0.5) * hh))),
            int(max(np.round(cc - f32(0.5) * ww), 0)),
            int(min(w - 1, np.round(cc + f32(0.5) * ww))))


def _overlap(a, b) -> float:
    def seg(a0, a1, b0, b1):
        inter = max(min(a1, b1) - max(a0, b0) + 1, 0)
        return inter / max(max(a1, b1) - min(a0, b0) + 1, 1e-6)
    return seg(a[0], a[1], b[0], b[1]) * seg(a[2], a[3], b[2], b[3])


def _lerp(x, coords, axis, lo, hi):
    """Linear interpolation of ``x`` along ``axis`` at float ``coords``,
    taps clamped to ``[lo, hi]``."""
    c0 = torch.clamp(torch.floor(coords), lo, hi)
    c1 = torch.clamp(c0 + 1, lo, hi)
    wgt = torch.clamp(coords - c0, 0.0, 1.0)
    shape = [1] * x.ndim
    shape[axis] = -1
    x0 = x.index_select(axis, c0.long())
    x1 = x.index_select(axis, c1.long())
    wgt = wgt.reshape(shape)
    return (1.0 - wgt) * x0 + wgt * x1


def _coords(lo: int, hi: int, n: int, device):
    """``lo + i (hi - lo)/(n - 1)`` in float32 as the JAX package's compiled
    crop rounds it: the step a float32 product with the reciprocal of
    ``n - 1``, then one rounding of ``i step + lo``. LoftUp's Fourier
    features multiply crop pixels by up to e^10, so a coordinate one ulp
    off moves them by ~1e-3."""
    step = np.float32(hi - lo) * np.float32(1.0 / (n - 1))
    i = torch.arange(n, dtype=torch.float64, device=device)
    return (i * float(step) + lo).float()


def crop_resize(img, roi, out_hw):
    """``img`` ``[H, W, C]`` cropped to the inclusive ``roi`` and resized
    to ``out_hw`` with align-corners bilinear."""
    rmin, rmax, cmin, cmax = roi
    out = _lerp(img, _coords(rmin, rmax, out_hw[0], img.device), 0, rmin,
                rmax)
    return _lerp(out, _coords(cmin, cmax, out_hw[1], img.device), 1, cmin,
                 cmax)


def paste(probs, roi, frame_hw):
    """``probs`` ``[oh, ow]`` resized to the ROI (align-corners bilinear)
    inside a zero frame."""
    oh, ow = probs.shape
    rmin, rmax, cmin, cmax = roi
    dev = probs.device
    y = torch.arange(frame_hw[0], dtype=torch.float32, device=dev)
    x = torch.arange(frame_hw[1], dtype=torch.float32, device=dev)
    rh, rw = rmax - rmin + 1, cmax - cmin + 1
    sy = (y - rmin) * (oh - 1) / max(rh - 1, 1) if rh > 1 else y * 0
    sx = (x - cmin) * (ow - 1) / max(rw - 1, 1) if rw > 1 else x * 0
    p = _lerp(_lerp(probs, sy, 0, 0, oh - 1), sx, 1, 0, ow - 1)
    inside = (((y >= rmin) & (y <= rmax))[:, None]
              & ((x >= cmin) & (x <= cmax))[None, :])
    return torch.where(inside, p, torch.zeros_like(p))


class ClickRun:
    """One object under the reference protocol. ``image`` ``[H, W, 3]``
    uint8, ``gt`` ``[H, W]`` (1 inside the object)."""

    def __init__(self, params, cfg: Dict, traffic: Dict, image, gt,
                 device) -> None:
        self.P, self.cfg, self.t = params, cfg, traffic
        self.device = device
        self.gt = np.asarray(gt) == 1
        self.h, self.w = self.gt.shape
        self.image = torch.as_tensor(image, device=device).float() / 255.0
        self.prev = torch.zeros((self.h, self.w), device=device)
        self.not_clicked = np.ones_like(self.gt)
        self.clicks: List[tuple] = []
        self.roi = None

    def mask(self) -> np.ndarray:
        return (self.prev > self.t["pred_thr"]).cpu().numpy()

    def depths(self, pred=None):
        """(missed-object depth, false-positive depth) of the current mask
        (or of ``pred``)."""
        pred = self.mask() if pred is None else pred
        return (_depth(self.gt & ~pred, self.not_clicked),
                _depth(~self.gt & pred, self.not_clicked))

    def next_click(self, pred=None):
        fn, fp = self.depths(pred)
        pos = fn.max() > fp.max()
        d = fn if pos else fp
        y, x = np.unravel_index(int(np.argmax(d)), d.shape)
        return int(y), int(x), bool(pos)

    def _update_roi(self) -> tuple:
        t = self.t
        full = (0, self.h - 1, 0, self.w - 1)
        mask = (self.prev > t["roi_prob_thresh"]).cpu().numpy()
        pos = [(y, x) for y, x, p in self.clicks if p]
        if mask.any():
            for y, x in pos:
                mask[y, x] = True
            cand = _expand(_bbox(mask), t["expansion_ratio"],
                           t["min_crop_size"], self.h, self.w)
        else:
            cand = full
        if self.roi is None:
            return cand
        r = self.roi
        inside = all(r[0] <= y < r[1] and r[2] <= x < r[3] for y, x in pos)
        if not inside or _overlap(cand, r) < t["recompute_thresh_iou"]:
            return cand
        return r

    @torch.no_grad()
    def step(self, y: int, x: int, positive: bool) -> torch.Tensor:
        """Take the click and return the full-frame probabilities."""
        self.clicks.append((y, x, positive))
        self.not_clicked[y, x] = False
        self.roi = self._update_roi()
        oh, ow = self.t["target_size"]
        rmin, rmax, cmin, cmax = self.roi
        crop = crop_resize(torch.cat([self.image, self.prev[..., None]], -1),
                           self.roi, (oh, ow))
        n = self.t["max_clicks"]
        pts = np.full((2, n, 3), -1.0, np.float32)
        count = [0, 0]
        for i, (cy, cx, p) in enumerate(self.clicks[:n]):
            side = 0 if p else 1
            pts[side, count[side]] = (
                np.float32(oh) * (np.float32(cy) - np.float32(rmin))
                / np.float32(rmax - rmin + 1),
                np.float32(ow) * (np.float32(cx) - np.float32(cmin))
                / np.float32(cmax - cmin + 1), i)
            count[side] += 1
        pts = pts.reshape(2 * n, 3)
        flipped = pts.copy()
        valid = pts[:, :2].max(axis=1) >= 0
        flipped[valid, 1] = np.float32(ow) - pts[valid, 1] - np.float32(1)
        points = torch.as_tensor(np.stack([pts, flipped]), device=self.device)
        images = torch.stack([crop, crop.flip(1)])
        logits = ref_model.forward(self.P, self.cfg, images[..., :3], points,
                                   images[..., 3])
        merged = 0.5 * (logits[0] + logits[1].flip(1))
        self.prev = paste(torch.sigmoid(merged), self.roi, (self.h, self.w))
        return self.prev

    def iou(self) -> float:
        pred = self.mask()
        union = (pred | self.gt).sum()
        return float((pred & self.gt).sum() / max(union, 1))


def play(params, cfg, traffic, image, gt, device) -> Dict:
    """The whole protocol on one object, the reference as the program:
    clicks, IoUs and the probabilities of every click."""
    s = ClickRun(params, cfg, traffic, image, gt, device)
    clicks, ious, probs = [], [], []
    for _ in range(traffic["max_clicks"]):
        c = s.next_click()
        probs.append(s.step(*c).cpu().numpy())
        clicks.append(c)
        ious.append(s.iou())
        if ious[-1] >= traffic["target_iou"]:
            break
    return dict(clicks=np.asarray(clicks, np.int64), ious=np.asarray(ious),
                probs=np.stack(probs))


@contextlib.contextmanager
def reference(cell, device):
    """The reference's parameters for ``cell`` on ``device``, with TF32 off
    while they are in use: the judge computes in float32."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield ref_model.to_device(
            weights.probe_params(cell.config, cell.checkpoint()), device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]


def iou_range(p: np.ndarray, gt: np.ndarray, thr: float, band: float):
    """The IoU of the mask ``p > thr`` with ``gt``, as the lowest and the
    highest it can be when pixels within ``band`` of the threshold may fall
    either way (both the same where ``band`` is 0)."""
    sure = p > thr + band
    maybe = (p > thr - band) & ~sure if band > 0 else np.zeros_like(sure)
    inter = float((sure & gt).sum())
    union = float((sure | gt).sum())
    return (inter / max(union + float((maybe & ~gt).sum()), 1.0),
            (inter + float((maybe & gt).sum())) / max(union, 1.0))


def _chose(run: ClickRun, click: tuple, band: float) -> bool:
    """Whether this user picks ``click`` on ``run``'s previous mask; within
    ``band`` of the threshold, pixels may fall either way (all in or all
    out)."""
    if run.next_click() == click:
        return True
    if band <= 0:
        return False
    p = run.prev.cpu().numpy()
    thr = run.t["pred_thr"]
    if not (np.abs(p - thr) < band).any():
        return False
    return any(run.next_click(p > v) == click for v in (thr - band,
                                                        thr + band))


def judge_object(params, cfg, traffic, image, gt, clicks: Sequence,
                 ious: Sequence[float],
                 probs: Union[Sequence[np.ndarray], Callable],
                 device, band: float = 0.0) -> Dict:
    """How far one object's answers (its clicks, the IoU reported after
    each and the probabilities behind it) lie from the reference.

    ``probs`` is the program's frame probabilities of each click, or a
    function ``(k, roi, frame_hw)`` that pastes the program's answer to
    click ``k`` through the reference's ROI. ``band``: how far from the
    threshold a pixel may lie and still fall either way between the
    program's paste and this one (0 where ``probs`` are the program's own).

    ``prob_gap`` / ``prob_mean_gap``: the largest and the mean absolute
    difference between the program's probabilities and the reference's,
    which follows the program's clicks. ``click_mismatch``: clicks that
    differ from this user's choice on the program's own previous mask
    (exact: an integer distance transform on the same mask).
    ``score_mismatch``: reported IoUs that are not the IoU of the program's
    own mask (beyond float32 rounding of the ratio), and a stop that the
    rule on those IoUs does not make. ``iou_gap``: the largest IoU
    difference from the reference's mask (not compared: a pixel moves it by
    1/area)."""
    s = ClickRun(params, cfg, traffic, image, gt, device)
    gt_b = s.gt
    thr, target = traffic["pred_thr"], traffic["target_iou"]
    out = dict(prob_gap=0.0, prob_mean_gap=0.0, click_mismatch=0,
               score_mismatch=0, iou_gap=0.0)
    n = len(clicks)
    mine = ClickRun(params, cfg, traffic, image, gt, device)
    mean_sum = 0.0
    stop_at = None
    for k, (y, x, pos) in enumerate(clicks):
        click = (int(y), int(x), bool(pos))
        # the user's choice on the program's own previous mask
        if not _chose(mine, click, band):
            out["click_mismatch"] += 1
        mine.clicks.append(click)
        mine.not_clicked[click[0], click[1]] = False
        ref = s.step(*click)
        got = (probs(k, s.roi, (s.h, s.w)) if callable(probs) else
               torch.as_tensor(probs[k], dtype=torch.float32).to(device))
        mine.prev = got
        lo, hi = iou_range(got.cpu().numpy(), gt_b, thr, band)
        if not lo - 1e-6 <= float(ious[k]) <= hi + 1e-6:
            out["score_mismatch"] += 1
        if stop_at is None and float(ious[k]) >= target:
            stop_at = k + 1
        diff = (got - ref).abs()
        out["prob_gap"] = max(out["prob_gap"], float(diff.max()))
        mean_sum += float(diff.mean())
        out["iou_gap"] = max(out["iou_gap"], abs(float(ious[k]) - s.iou()))
    if n != (stop_at or traffic["max_clicks"]):
        out["score_mismatch"] += 1
    out["prob_mean_gap"] = mean_sum / max(n, 1)
    return out
