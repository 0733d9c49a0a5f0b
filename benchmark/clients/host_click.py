"""One user clicking through objects with the program's host protocol.

The traffic: the drawn scenes' objects (``lib/scenes.py``) in an order
drawn from ``--seed`` (the size groups interleaved in one fixed pattern,
each group's objects in the seed's order, so that any stretch of the
order holds the same frame sizes for every seed),
one at a time, in a closed loop (the next click goes out when the mask of
the last one is back). Each object runs ``evaluate_sample`` with the
``Predictor`` of ``get_predictor`` over ``load_model_for_eval``'s model:
the evaluate CLI's default path (``device_loop=false``). A click's time
runs from one ``callback`` of ``evaluate_sample`` to the next (the first
from the call's start); a proxy around the predictor times each
``get_prediction`` inside it.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.clients.device_loop import load_objects
from benchmark.lib.window import Window


class TimedPredictor:
    """Delegates to the program's predictor and records the seconds of
    every ``get_prediction``."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.spans: List[float] = []

    def get_prediction(self, clicker, prev_mask=None):
        t0 = time.perf_counter()
        out = self.inner.get_prediction(clicker, prev_mask)
        self.spans.append(time.perf_counter() - t0)
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def prepare(ctx) -> Dict:
    """The program loaded and warmed up on every shape of a click."""
    from isegprobe_torch.evaluate import load_model_for_eval
    from isegprobe_torch.inference.brs import get_predictor
    from isegprobe_torch.inference.evaluation import evaluate_sample

    t, device = ctx.traffic, ctx.device
    objs = load_objects(t)
    model, _ = load_model_for_eval(str(ctx.cell.checkpoint()),
                                   torch.float32, tuple(t["target_size"]),
                                   device)
    zoom = dict(skip_clicks=-1, target_size=tuple(t["target_size"]),
                expansion_ratio=t["expansion_ratio"],
                min_crop_size=t["min_crop_size"],
                recompute_thresh_iou=t["recompute_thresh_iou"])
    predictor = TimedPredictor(get_predictor(
        model, brs_mode="NoBRS", prob_thresh=t["roi_prob_thresh"],
        with_flip=True, zoom_in_params=zoom,
        predictor_params={"net_clicks_limit": t["max_clicks"]},
        device=device))
    rec = dict(click_s=[], probs=[])

    def one_object(i, keep, max_clicks=t["max_clicks"]):
        image, gt = objs[i]
        last = [time.perf_counter()]

        def callback(_image, _gt, pred_probs, *_rest):
            now = time.perf_counter()
            rec["click_s"].append(now - last[0])
            last[0] = now
            if keep:
                rec["probs"].append(pred_probs)

        clicks, ious, _ = evaluate_sample(
            image, gt, predictor, max_iou_thr=t["target_iou"],
            pred_thr=t["pred_thr"], max_clicks=max_clicks,
            callback=callback)
        return clicks, ious

    # warm-up: every shape of a click, on each frame size of the window
    seen = set()
    for i, (_image, gt) in enumerate(objs):
        if gt.shape not in seen:
            seen.add(gt.shape)
            one_object(i, False, 2)
    return dict(objs=objs, predictor=predictor, rec=rec,
                one_object=one_object)


def order(traffic: Dict, rng: np.random.Generator) -> List[int]:
    """One pass over the objects: slot ``j`` of a group of ``n`` objects
    at ``(j + 0.5) / n`` of the pass, the groups so interleaved the same
    for every seed, and each group's slots filled in the seed's order."""
    slots, lo = [], 0
    for g, group in enumerate(traffic["scenes"]["groups"]):
        n = group["objects"]
        slots += [((j + 0.5) / n, g, lo + int(i))
                  for j, i in enumerate(rng.permutation(n))]
        lo += n
    return [i for _, _, i in sorted(slots)]


def measure(st, ctx) -> Dict:
    """The window: objects in the seed's order until ``ctx.seconds``."""
    predictor, one_object = st["predictor"], st["one_object"]
    click_s, probs = [], []
    st["rec"].update(click_s=click_s, probs=probs)
    predictor.spans = []
    rng = np.random.default_rng(ctx.seed)
    done: List[Dict] = []

    def counters():
        return dict(clicks=len(click_s))

    win = Window(ctx.seconds, ctx.trace_seconds, counters,
                 ctx.device).start()
    over = False
    while not over:
        for i in order(ctx.traffic, rng):
            first = len(probs)
            clicks, ious = one_object(int(i), True)
            done.append(dict(
                object=int(i), ious=ious, probs=probs[first:],
                clicks=np.asarray([(*c.coords, int(c.is_positive))
                                   for c in clicks], np.int64)))
            if win.tick():
                over = True
                break
    window = win.finish()
    return dict(
        objects=done, all_objects=st["objs"], window=win,
        click_s=click_s, predict_s=predictor.spans,
        e2e={"click_ms_p90": 1e3 * float(np.percentile(click_s, 90))},
        totals=dict(clicks=len(click_s), window_s=window))


def sample_objects(objects, k: int, seed: int) -> list:
    """``k`` of the window's objects, drawn from the seed, always with the
    one that took the most clicks."""
    if not objects:
        return []
    rng = np.random.default_rng([seed, 1])
    longest = int(np.argmax([len(o["ious"]) for o in objects]))
    rest = [i for i in range(len(objects)) if i != longest]
    pick = rng.choice(rest, size=min(k - 1, len(rest)), replace=False)
    return [objects[longest]] + [objects[int(i)] for i in pick]


def judge(cell, result, seed: int, device) -> Dict:
    """A sample of the window's finished objects held to the reference:
    the program's own probabilities of each click, its clicks, IoUs and
    stops."""
    from benchmark.reference import protocol

    with protocol.reference(cell, device) as params:
        all_gaps, failed = {}, 0
        sample = sample_objects(result["objects"],
                                cell.traffic["judge_objects"], seed)
        for obj in sample:
            image, gt = result["all_objects"][obj["object"]]
            g = protocol.judge_object(params, cell.config, cell.traffic,
                                      image, gt, obj["clicks"], obj["ious"],
                                      obj["probs"], device)
            failed += any(g[k] > v for k, v in cell.limits.items())
            for k in g:
                all_gaps[k] = max(all_gaps.get(k, 0.0), g[k])
    return dict(gaps={k: all_gaps.get(k, 0.0) for k in cell.limits},
                failed=failed, judged=len(sample),
                clicks=sum(len(o["ious"]) for o in sample),
                all_gaps=all_gaps)
