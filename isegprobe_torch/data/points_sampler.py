"""Training-time click synthesis.

Counterpart of ``isegprobe_tpu/data/points_sampler.py``, drawing from
explicit generators instead of the global ``random`` and ``np.random``:
:meth:`MultiPointSampler.sample_object` and
:meth:`MultiPointSampler.sample_points` take a ``random.Random`` and a
``np.random.RandomState`` and make the same calls on them, in the same
order, as the JAX package makes on the globals, so that generators seeded
alike give the same clicks.

Redesigned around two explicit stages instead of the reference's mutable
method pipeline (reference behavior spec: core/data/points_sampler.py:35-380):

1. *Planning* — ``_plan_clicks`` inspects a ``DSample`` and produces a
   ``_ClickPlan``: the float target mask plus the **regions** future clicks may
   land in (positive object cores, required hierarchy negatives, and a weighted
   background mixture).
2. *Rendering* — ``_render_group`` turns a list of regions into the fixed-size
   padded ``(y, x, label)`` list the device consumes.

Regions are small objects with a uniform ``draw(count)`` method
(``_UniformRegion`` over one mask, ``_MixtureRegion`` over weighted masks), so
the rendering logic is isinstance-free.  Click-count distributions, erosion /
border-band construction, hierarchy descent, and the multi-object first-click
rules match the reference's sampling distribution; morphology uses
scipy.ndimage rank filters (cv2-free) and the centre-biased first click uses
the in-repo exact EDT (ops/edt.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
from scipy import ndimage

from isegprobe_torch.data.sample import DSample
from isegprobe_torch.ops.edt import edt_l2sq

Point = Tuple[int, int, int]
_PAD: Point = (-1, -1, -1)
# third click coordinate: 0 marks a centre-biased first click, 100 the rest
_LABEL_CENTERED = 0
_LABEL_FREE = 100


# ------------------------------------------------------------------ morphology
# cv2-free binary morphology.  An n-times iterated 3x3 erosion equals a single
# (2n+1)-square minimum filter; cv2's default border treats out-of-image pixels
# as foreground for erode (cval=1) and background for dilate (cval=0).


def _shrink(mask: np.ndarray, iters: int) -> np.ndarray:
    if iters <= 0:
        return mask.astype(bool)
    return ndimage.minimum_filter(
        mask.astype(np.uint8), size=2 * iters + 1, mode="constant", cval=1
    ).astype(bool)


def _ring(mask: np.ndarray, radius: int) -> np.ndarray:
    """Band of `radius` pixels hugging the outside of `mask`."""
    if radius <= 0:
        return np.zeros_like(mask, dtype=np.uint8)
    grown = ndimage.maximum_filter(
        mask.astype(np.uint8), size=2 * radius + 1, mode="constant", cval=0
    )
    grown[mask.astype(bool)] = 0
    return grown


def _centre_candidates(mask: np.ndarray, k: float, full_prob: float,
                       rng, np_rng) -> np.ndarray:
    """Coordinates of the EDT-inner region used for centre-biased first clicks.

    ``k > 0``: every pixel whose boundary distance exceeds max/k (compared in
    squared space: d² > d²max/k²).  ``k <= 0``: one pixel drawn with
    probability ∝ distance.  ``full_prob`` short-circuits to the whole mask.
    """
    if full_prob > 0 and rng.random() < full_prob:
        return np.argwhere(mask)

    d2 = edt_l2sq(np.pad(mask, 1).astype(np.uint8))[1:-1, 1:-1]
    if k > 0:
        return np.argwhere(d2 > d2.max() / (k * k))
    weights = np.sqrt(d2).ravel()
    weights /= max(weights.sum(), 1e-6)
    flat = np_rng.choice(weights.size, p=weights)
    return np.array([np.unravel_index(flat, d2.shape)])


# ------------------------------------------------------------------ regions


class _UniformRegion:
    """Clicks drawn uniformly from one boolean mask."""

    __slots__ = ("mask", "centre_k", "centre_full_prob")

    def __init__(self, mask, centre_k: float = 0.0, centre_full_prob: float = 0.0):
        self.mask = mask
        self.centre_k = centre_k
        self.centre_full_prob = centre_full_prob

    def draw(self, count: int, rng, np_rng,
             centred_first: bool = False) -> List[Point]:
        coords = np.argwhere(self.mask)
        out: List[Point] = []
        for j in range(count):
            if centred_first and j == 0:
                pool = _centre_candidates(
                    self.mask, self.centre_k, self.centre_full_prob, rng,
                    np_rng)
                label = _LABEL_CENTERED
            else:
                pool = coords
                label = _LABEL_FREE
            if len(pool):
                y, x = pool[np_rng.randint(len(pool))][:2]
                out.append((int(y), int(x), label))
        return out


class _MixtureRegion:
    """Each click first picks a member mask by weight, then a uniform pixel.

    Members are stored as MASKS; the argwhere coordinate list of a member is
    built lazily the first time it is drawn from. The background mixture's
    three full-frame strategy masks would otherwise cost O(H·W) scans each on
    every item, while the negative-count pmf draws zero background clicks a
    meaningful fraction of the time."""

    __slots__ = ("parts", "_pools")

    def __init__(self, parts: Sequence[Tuple[np.ndarray, float]]):
        self.parts = list(parts)
        total = sum(w for _, w in self.parts)
        assert math.isclose(total, 1.0), f"mixture weights sum to {total}"
        self._pools: List[Optional[np.ndarray]] = [None] * len(self.parts)

    def rescaled(self, factor: float) -> List[Tuple[np.ndarray, float]]:
        """Member (mask, weight*factor) pairs, for folding into a union."""
        return [(m, w * factor) for m, w in self.parts]

    def _pool(self, i: int) -> np.ndarray:
        if self._pools[i] is None:
            self._pools[i] = np.argwhere(self.parts[i][0])
        return self._pools[i]

    def draw(self, count: int, rng, np_rng,
             centred_first: bool = False) -> List[Point]:
        del rng, centred_first  # mixtures never host the centred first click
        weights = [w for _, w in self.parts]
        out: List[Point] = []
        for _ in range(count):
            pool = self._pool(np_rng.choice(len(self.parts), p=weights))
            if len(pool):
                y, x = pool[np_rng.randint(len(pool))][:2]
                out.append((int(y), int(x), _LABEL_FREE))
        return out


_Region = Union[_UniformRegion, _MixtureRegion]


def _union_mixture(regions: Sequence[_Region]) -> _MixtureRegion:
    """Equal-weight union of a region list (mixtures keep internal weights)."""
    parts: List[Tuple[np.ndarray, float]] = []
    share = 1.0 / len(regions)
    for r in regions:
        if isinstance(r, _MixtureRegion):
            parts.extend(r.rescaled(share))
        else:
            parts.append((r.mask, share))
    mix = _MixtureRegion.__new__(_MixtureRegion)
    mix.parts = parts
    mix._pools = [None] * len(parts)
    return mix


# ------------------------------------------------------------------ plan


@dataclass
class _ClickPlan:
    target: np.ndarray  # float [H, W] ground-truth mask
    positives: List[_UniformRegion] = field(default_factory=list)
    required_negatives: List[_UniformRegion] = field(default_factory=list)
    background: Optional[_MixtureRegion] = None


@lru_cache(maxsize=None)
def generate_probs(max_num_points: int, gamma: float) -> np.ndarray:
    """Geometric-decay pmf over click counts (ref points_sampler.py:349-360)."""
    pmf = gamma ** np.arange(max_num_points, dtype=np.float64)
    return pmf / pmf.sum()


class BasePointSampler:
    """Protocol: ``sample_object(sample)`` then ``sample_points()``;
    ``selected_mask`` exposes the [1, H, W] float target."""

    def __init__(self) -> None:
        self._target: Optional[np.ndarray] = None

    def sample_object(self, sample: DSample, rng, np_rng):
        raise NotImplementedError

    def sample_points(self, rng, np_rng):
        raise NotImplementedError

    @property
    def selected_mask(self) -> np.ndarray:
        assert self._target is not None
        return self._target

    @selected_mask.setter
    def selected_mask(self, mask: np.ndarray) -> None:
        self._target = mask[np.newaxis].astype(np.float32)


class MultiPointSampler(BasePointSampler):
    """Synthesizes realistic positive/negative training clicks.

    Same configuration surface and output distribution as the reference
    sampler (core/data/points_sampler.py:35-346): positive clicks land on the
    (usually eroded) object, negatives on background / other objects / a
    border band, with geometric-decay counts and optional multi-object
    merging, mask-hierarchy descent, and an EDT-centred first click.
    """

    def __init__(
        self,
        max_num_points: int,
        prob_gamma: float = 0.7,
        expand_ratio: float = 0.1,
        positive_erode_prob: float = 0.9,
        positive_erode_iters: int = 3,
        negative_bg_prob: float = 0.1,
        negative_other_prob: float = 0.4,
        negative_border_prob: float = 0.5,
        merge_objects_prob: float = 0.0,
        max_num_merged_objects: int = 2,
        use_hierarchy: bool = False,
        soft_targets: bool = False,
        first_click_center: bool = False,
        only_one_first_click: bool = False,
        sfc_inner_k: float = 1.7,
        sfc_full_inner_prob: float = 0.0,
    ) -> None:
        super().__init__()
        self.max_num_points = max_num_points
        self.expand_ratio = expand_ratio
        self.positive_erode_prob = positive_erode_prob
        self.positive_erode_iters = positive_erode_iters
        self.merge_objects_prob = merge_objects_prob
        self.use_hierarchy = use_hierarchy
        self.soft_targets = soft_targets
        self.first_click_center = first_click_center
        self.only_one_first_click = only_one_first_click
        self.sfc_inner_k = sfc_inner_k
        self.sfc_full_inner_prob = sfc_full_inner_prob
        self.max_num_merged_objects = (
            max_num_points if max_num_merged_objects == -1 else max_num_merged_objects
        )

        self._neg_weights = {
            "bg": negative_bg_prob,
            "other": negative_other_prob,
            "border": negative_border_prob,
        }
        assert math.isclose(sum(self._neg_weights.values()), 1.0)

        # count pmfs: positives draw 1 + Geom; negatives draw Geom (may be 0)
        self._pos_pmf = generate_probs(max_num_points, gamma=prob_gamma)
        self._neg_pmf = generate_probs(max_num_points + 1, gamma=prob_gamma)
        self._plan: Optional[_ClickPlan] = None

    # -- planning ----------------------------------------------------------

    def sample_object(self, sample: DSample, rng, np_rng) -> None:
        """Plan the clicks of one object of ``sample``, drawing from ``rng``
        (``random.Random``) and ``np_rng`` (``np.random.RandomState``)."""
        self._plan = self._plan_clicks(sample, rng, np_rng)
        self.selected_mask = self._plan.target

    def _plan_clicks(self, sample: DSample, rng, np_rng) -> _ClickPlan:
        if len(sample) == 0:
            bg = sample.get_background_mask()
            return _ClickPlan(
                target=np.zeros_like(bg, dtype=np.float32),
                background=_MixtureRegion(
                    [(bg, w) for w in self._neg_weights.values()]
                ),
            )

        target, pos_masks, req_neg_masks = self._choose_objects(sample, rng,
                                                                np_rng)
        hard_target = target > (0.5 if self.soft_targets else 0)

        outside = np.logical_not(hard_target)
        if len(sample) <= len(pos_masks):
            other_objects = outside
        else:
            other_objects = np.logical_and(
                np.logical_not(sample.get_background_mask()), outside
            )
        band_r = int(np.ceil(self.expand_ratio * np.sqrt(hard_target.sum())))
        strategies = {
            "bg": outside,
            "other": other_objects,
            "border": _ring(hard_target, band_r),
        }

        centre = dict(
            centre_k=self.sfc_inner_k, centre_full_prob=self.sfc_full_inner_prob
        )
        return _ClickPlan(
            target=target.astype(np.float32),
            positives=[_UniformRegion(m, **centre) for m in pos_masks],
            required_negatives=[_UniformRegion(m) for m in req_neg_masks],
            background=_MixtureRegion(
                [(strategies[k], w) for k, w in self._neg_weights.items()]
            ),
        )

    def _choose_objects(self, sample: DSample, rng, np_rng):
        """Pick one root object (or a random merged subset), returning the
        float target plus raw positive / required-negative segment masks."""
        roots = sample.root_objects
        if len(roots) > 1 and rng.random() < self.merge_objects_prob:
            n = np_rng.randint(2, min(len(roots), self.max_num_merged_objects) + 1)
            chosen = rng.sample(roots, n)
        else:
            chosen = [rng.choice(roots)]

        target: Optional[np.ndarray] = None
        pos_segments: List[np.ndarray] = []
        neg_segments: List[np.ndarray] = []
        for obj_id in chosen:
            obj_target, obj_pos, obj_neg = self._object_segments(
                sample, obj_id, rng, np_rng)
            target = obj_target if target is None else np.maximum(target, obj_target)
            pos_segments += obj_pos
            neg_segments += obj_neg

        def erode(m):
            return self._maybe_erode(m, rng)

        return target, [erode(m) for m in pos_segments], [erode(m) for m in neg_segments]

    def _object_segments(self, sample: DSample, obj_id, rng, np_rng):
        """Target/positive/required-negative masks for one object, optionally
        descending its mask hierarchy (ref points_sampler.py:148-205)."""
        if not self.use_hierarchy:
            mask = sample.get_object_mask(obj_id)
            target = sample.get_soft_object_mask(obj_id) if self.soft_targets else mask
            return target, [mask], []

        tree = sample.nodes
        # random walk down the hierarchy: at each node with children, stop
        # with probability 1/2, otherwise recurse into a random child
        node = obj_id
        while tree[node].children and rng.random() >= 0.5:
            node = rng.choice(tree[node].children)

        info = tree[node]
        mask = sample.get_object_mask(node)
        target = sample.get_soft_object_mask(node) if self.soft_targets else mask
        clickable = mask.copy()
        negatives: List[np.ndarray] = []

        parent = info.parent
        if parent is not None and parent in tree:
            parent_only = np.logical_and(
                sample.get_object_mask(parent), np.logical_not(mask)
            )
            negatives.append(parent_only)

        children = info.children
        # tiny children (<10% of the node) never host positive clicks
        for child in children:
            if tree[child].area / info.area < 0.10:
                clickable = np.logical_and(
                    clickable, np.logical_not(sample.get_object_mask(child))
                )

        # randomly carve out up to 3 children entirely (target + clicks)
        if children:
            k = np_rng.randint(0, min(len(children), 3) + 1)
            for child in rng.sample(children, k):
                child_mask = sample.get_object_mask(child)
                clickable = np.logical_and(clickable, np.logical_not(child_mask))
                if self.soft_targets:
                    target = np.minimum(
                        target, 1.0 - sample.get_soft_object_mask(child)
                    )
                else:
                    target = np.logical_and(target, np.logical_not(child_mask))
                negatives.append(child_mask)

        return target, [clickable], negatives

    def _maybe_erode(self, mask: np.ndarray, rng) -> np.ndarray:
        if rng.random() > self.positive_erode_prob:
            return mask
        core = _shrink(mask, self.positive_erode_iters)
        # refuse to erode away nearly the whole object
        return core if core.sum() > 10 else mask

    # -- rendering -----------------------------------------------------------

    def sample_points(self, rng, np_rng) -> List[Point]:
        """The planned object's clicks, drawing from ``rng`` and
        ``np_rng``."""
        assert self._plan is not None, "sample_object() must run first"
        plan = self._plan
        positives = self._render_group(
            plan.positives,
            count_for=lambda _r: self._draw_count(np_rng, negative=False),
            rng=rng, np_rng=np_rng, centred_first=self.first_click_center,
        )
        neg_regions: List[_Region] = list(plan.required_negatives)
        if plan.background is not None:
            neg_regions.append(plan.background)
        negatives = self._render_group(
            neg_regions,
            # required hierarchy negatives always get >=1 click; the
            # background mixture may get zero
            count_for=lambda r: self._draw_count(
                np_rng, negative=isinstance(r, _MixtureRegion)
            ),
            rng=rng, np_rng=np_rng,
        )
        return positives + negatives

    def _draw_count(self, np_rng, negative: bool) -> int:
        pmf = self._neg_pmf if negative else self._pos_pmf
        n = int(np_rng.choice(len(pmf), p=pmf))
        return n if negative else n + 1

    def _render_group(self, regions, count_for, rng, np_rng,
                      centred_first=False) -> List[Point]:
        regions = regions[: self.max_num_points]
        draws = [r.draw(count_for(r), rng, np_rng, centred_first)
                 for r in regions]
        draws = [d for d in draws if d]

        if len(draws) <= 1:
            points = draws[0] if draws else []
        else:
            if self.only_one_first_click:
                draws = draws[:1]
            # several objects: keep each object's first (possibly centred)
            # click, then top up from the equal-weight union of all regions
            points = [d[0] for d in draws]
            extra = _union_mixture(regions).draw(
                self._draw_count(np_rng, negative=True), rng, np_rng)
            room = self.max_num_points - len(points)
            points += extra if len(extra) <= room else rng.sample(extra, room)

        return points + [_PAD] * (self.max_num_points - len(points))
