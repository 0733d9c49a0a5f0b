"""Interactive multi-object annotation session with undo.

Counterpart of ``isegprobe_tpu/interactive_demo/controller.py``, framework
free (it drives the Tk demo and the tests): one undo journal of immutable
``_Snapshot``s and a list of committed object masks.

- the object being annotated ("draft") is ``max(base, live)``, where
  ``base`` accumulates partially finished probability maps and ``live`` is
  the latest prediction;
- every action that changes the draft pushes one ``_Snapshot`` (clicker
  and predictor state and both maps), so undo is a single pop;
- a finished object appends a boolean mask to ``_committed``; the uint16
  label map is composed on demand in ``result_mask``.

Snapshots hold references: the predictor's ``get_states`` (the port's
predictors keep their previous prediction as a host array) and the maps
are never copied, so a state that held device tensors would stay on the
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from isegprobe_torch.inference.clicker import Click, Clicker
from isegprobe_torch.utils.viz import draw_with_blend_and_clicks

__all__ = ["InteractiveController"]


@dataclass(frozen=True)
class _Snapshot:
    clicker: object
    predictor: object
    base: Optional[np.ndarray]
    live: Optional[np.ndarray]
    init_mask: Optional[np.ndarray]


class InteractiveController:
    def __init__(self, predictor_factory: Callable[[], object],
                 update_image_callback: Callable = lambda **kw: None,
                 prob_thresh: float = 0.5) -> None:
        self.prob_thresh = prob_thresh
        self.predictor_factory = predictor_factory
        self.update_image_callback = update_image_callback

        self.image: Optional[np.ndarray] = None
        self.clicker = Clicker()
        self.predictor = None
        self._journal: List[_Snapshot] = []
        self._committed: List[np.ndarray] = []
        self._base: Optional[np.ndarray] = None  # accumulated partial probs
        self._live: Optional[np.ndarray] = None  # latest prediction
        self._init_mask: Optional[np.ndarray] = None
        self.reset_predictor()

    # -- session lifecycle ---------------------------------------------------

    def set_image(self, image: np.ndarray) -> None:
        self.image = image
        self._committed = []
        self.reset_last_object(update_image=False)
        self.update_image_callback(reset_canvas=True)

    def set_mask(self, mask: np.ndarray) -> bool:
        """Seed the draft object from an external mask. The first click
        after it runs the prediction twice, so that the mask feeds the
        prev-mask channel (the reference's quirk, kept by the JAX
        controller)."""
        if self.image.shape[:2] != mask.shape[:2]:
            return False
        if self._draft_active:
            self.reset_last_object()
        self._init_mask = mask.astype(np.float32)
        self._base = np.zeros_like(self._init_mask)
        self._live = self._init_mask
        self.clicker.click_indx_offset = 1
        return True

    def reset_last_object(self, update_image: bool = True) -> None:
        self._journal = []
        self._base = None
        self._live = None
        self._init_mask = None
        self.clicker.reset_clicks()
        self.clicker.click_indx_offset = 0
        self.reset_predictor()
        if update_image:
            self.update_image_callback()

    def reset_predictor(self) -> None:
        self.predictor = self.predictor_factory()
        if self.image is not None:
            self.predictor.set_input_image(self.image)

    # -- annotation actions ----------------------------------------------------

    def add_click(self, x: int, y: int, is_positive: bool) -> None:
        self._journal.append(self._snapshot())
        self.clicker.add_click(Click(is_positive=is_positive, coords=(y, x)))
        pred = self.predictor.get_prediction(self.clicker,
                                             prev_mask=self._init_mask)
        if self._init_mask is not None and len(self.clicker) == 1:
            pred = self.predictor.get_prediction(self.clicker,
                                                 prev_mask=self._init_mask)
        if self._base is None:
            self._base = np.zeros_like(pred)
        self._live = pred
        self.update_image_callback()

    def undo_click(self) -> None:
        if not self._journal:
            return
        self._restore(self._journal.pop())
        if not self._draft_active:
            self._init_mask = None
            self.clicker.click_indx_offset = 0
        self.update_image_callback()

    def partially_finish_object(self) -> None:
        """Freeze the current draft into the base map and continue clicking
        the same object from a clean predictor."""
        draft = self.current_object_prob
        if draft is None:
            return
        # the undo target mirrors the reference's states.append(states[-1]):
        # the clicker and predictor roll back to before the previous click,
        # the maps keep their current (post-click) values, and a consumed
        # init mask stays consumed
        prev = self._journal[-1] if self._journal else self._snapshot()
        self._journal.append(_Snapshot(clicker=prev.clicker,
                                       predictor=prev.predictor,
                                       base=self._base, live=self._live,
                                       init_mask=None))
        self._base = draft
        self._live = np.zeros_like(draft)
        self._init_mask = None
        self.clicker.reset_clicks()
        self.clicker.click_indx_offset = 0
        self.reset_predictor()
        self.update_image_callback()

    def finish_object(self) -> None:
        draft = self.current_object_prob
        if draft is None:
            return
        self._committed.append(draft > self.prob_thresh)
        self.reset_last_object()

    # -- journal helpers -------------------------------------------------------

    def _snapshot(self) -> _Snapshot:
        return _Snapshot(clicker=self.clicker.get_state(),
                         predictor=self.predictor.get_states(),
                         base=self._base, live=self._live,
                         init_mask=self._init_mask)

    def _restore(self, snap: _Snapshot) -> None:
        self.clicker.set_state(snap.clicker)
        self.predictor.set_states(snap.predictor)
        self._base = snap.base
        self._live = snap.live
        self._init_mask = snap.init_mask

    # -- derived views ----------------------------------------------------------

    @property
    def _draft_active(self) -> bool:
        return self._live is not None

    @property
    def is_incomplete_mask(self) -> bool:
        return self._draft_active

    @property
    def object_count(self) -> int:
        return len(self._committed)

    @property
    def current_object_prob(self) -> Optional[np.ndarray]:
        if not self._draft_active:
            return None
        return np.maximum(self._base, self._live)

    @property
    def result_mask(self) -> np.ndarray:
        """uint16 label map: committed objects in commit order (later
        objects overwrite overlaps), the draft on top as label count+1."""
        assert self.image is not None
        labels = np.zeros(self.image.shape[:2], dtype=np.uint16)
        for i, mask in enumerate(self._committed):
            labels[mask] = i + 1
        if self._draft_active:
            labels[self.current_object_prob > self.prob_thresh] = (
                len(self._committed) + 1)
        return labels

    def get_visualization(self, alpha_blend: float, click_radius: int):
        if self.image is None:
            return None
        labels = self.result_mask
        vis = draw_with_blend_and_clicks(
            self.image, mask=labels, alpha=alpha_blend,
            clicks_list=self.clicker.clicks_list, radius=click_radius,
            use_color_mask=True)
        if self._draft_active:
            # double-blend the partially finished region so it reads stronger
            labels[self._base <= self.prob_thresh] = 0
            vis = draw_with_blend_and_clicks(vis, mask=labels,
                                             alpha=alpha_blend)
        return vis
