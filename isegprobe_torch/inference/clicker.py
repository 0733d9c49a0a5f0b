"""Simulated user for NoC evaluation.

Counterpart of ``isegprobe_tpu/inference/clicker.py``, with the same
decision rule: click the deepest interior point (maximum EDT, image borders
counted as error boundary) of whichever error region — false negative or
false positive — is deeper, positive iff it is the false-negative region; a
pixel is never clicked twice; ties go to the first row-major maximum. The
squared EDT is exact in integers (``ops/edt.py``, the native host library),
so depth comparisons and argmax locations match the JAX package exactly.

Besides the rule, the clicker keeps the click list the predictors read:
``add_click`` numbers a click ``click_indx_offset + len``, ``get_clicks``
truncates to a limit, and ``get_state`` / ``set_state`` serve the demo's
undo.
"""

from __future__ import annotations

from copy import deepcopy
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np

from isegprobe_torch.ops.edt import edt_l2sq


@dataclass
class Click:
    is_positive: bool
    coords: Tuple[float, float]  # (y, x)
    indx: Optional[int] = None

    @property
    def coords_and_indx(self):
        return (*self.coords, self.indx)

    def copy(self, **kwargs) -> "Click":
        return replace(self, **kwargs)


def _interior_depth(error_mask: np.ndarray, usable: np.ndarray) -> np.ndarray:
    """Squared distance-to-boundary of an error region, zeroed at pixels that
    were already clicked; image borders count as boundary (the pad)."""
    padded = np.pad(error_mask, 1).astype(np.uint8)
    return edt_l2sq(padded)[1:-1, 1:-1] * usable


class Clicker:
    """Clicks on ``gt_mask`` (1 = object, ``ignore_label`` = ignored); with
    no ``gt_mask`` it only keeps the clicks it is given."""

    def __init__(self, gt_mask: Optional[np.ndarray] = None,
                 init_clicks: Optional[List[Click]] = None,
                 ignore_label: int = -1, click_indx_offset: int = 0) -> None:
        self.click_indx_offset = click_indx_offset
        self.gt_mask = None
        if gt_mask is not None:
            self.gt_mask = gt_mask == 1
            self.not_ignore_mask = gt_mask != ignore_label
        self.reset_clicks()
        for click in init_clicks or []:
            self.add_click(click)

    # -- the decision rule -------------------------------------------------

    def _get_next_click(self, pred_mask: np.ndarray) -> Click:
        # already-clicked pixels only lose their score; carving them out of
        # the region would distort the distance field around them
        fn_depth = _interior_depth(
            self.gt_mask & ~pred_mask & self.not_ignore_mask,
            self.not_clicked_map)
        fp_depth = _interior_depth(
            ~self.gt_mask & pred_mask & self.not_ignore_mask,
            self.not_clicked_map)
        take_positive = fn_depth.max() > fp_depth.max()
        depth = fn_depth if take_positive else fp_depth
        y, x = np.unravel_index(int(np.argmax(depth)), depth.shape)
        return Click(is_positive=bool(take_positive), coords=(int(y), int(x)))

    def make_next_click(self, pred_mask: np.ndarray) -> None:
        assert self.gt_mask is not None
        self.add_click(self._get_next_click(pred_mask))

    # -- click bookkeeping ---------------------------------------------------

    def add_click(self, click: Click) -> None:
        click.indx = self.click_indx_offset + len(self.clicks_list)
        self.clicks_list.append(click)
        if self.gt_mask is not None:
            self.not_clicked_map[int(click.coords[0]),
                                 int(click.coords[1])] = False

    def _remove_last_click(self) -> None:
        click = self.clicks_list.pop()
        if self.gt_mask is not None:
            self.not_clicked_map[int(click.coords[0]),
                                 int(click.coords[1])] = True

    def get_clicks(self, clicks_limit: Optional[int] = None) -> List[Click]:
        return self.clicks_list[:clicks_limit]

    @property
    def num_pos_clicks(self) -> int:
        return sum(c.is_positive for c in self.clicks_list)

    @property
    def num_neg_clicks(self) -> int:
        return len(self.clicks_list) - self.num_pos_clicks

    def reset_clicks(self) -> None:
        if self.gt_mask is not None:
            self.not_clicked_map = np.ones_like(self.gt_mask, dtype=bool)
        self.clicks_list: List[Click] = []

    # the undo state is the click list; restoring re-derives the
    # not-clicked map from the positions
    def get_state(self) -> List[Click]:
        return deepcopy(self.clicks_list)

    def set_state(self, state: List[Click]) -> None:
        self.reset_clicks()
        for click in state:
            self.add_click(click)

    def __len__(self) -> int:
        return len(self.clicks_list)
