"""A dataset NoC evaluation through the program's batched device loop.

The traffic: the drawn scenes' objects (``lib/scenes.py``), dealt once
into fixed batches of ``lanes`` objects of one frame size (each size
group shuffled by ``partition_seed``, the same for every run), run one
batch at a time in a closed loop. ``--seed`` orders the batches of each
round and the lanes of each batch, so every seed does the same work in
another order. Each batch goes through ``evaluate_dataset_device`` of a
``make_device_evaluator`` loop, the evaluate CLI's ``device_loop=true``
path with ``device_batch`` lanes.

For the judge, the model that the loop is given is wrapped: while a batch
is recorded, the logits of every call (``[lanes x 2 flips, oh, ow, 1]``)
are kept on the device. Each round records one batch drawn from the seed;
the judge takes the last round's and ``judge_batches - 1`` more drawn from
the earlier rounds (a reservoir over rounds), so its sample covers the
whole window.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import scenes
from benchmark.lib.window import Window


class Objects:
    """The dataset interface of the program's evaluation loops over a list
    of ``(image, gt)`` objects, one object a sample."""

    def __init__(self, objs) -> None:
        self.objs = objs

    def __len__(self) -> int:
        return len(self.objs)

    def get_sample(self, index: int):
        image, gt = self.objs[index]
        return SimpleNamespace(image=image, objects_ids=[0],
                               gt_mask=lambda _obj: gt)


def load_objects(traffic: Dict) -> List:
    """Every object of the traffic's scenes as ``(uint8 image, int32
    gt)``, with the groups' frame sizes."""
    return [(o["image"], o["gt"]) for o in scenes.objects(traffic["scenes"])]


def plan(traffic: Dict) -> List[np.ndarray]:
    """A round's fixed batches of object indices: each size group shuffled
    by ``partition_seed`` and dealt into batches of ``lanes`` (the last of
    a group takes the rest; the loop pads it with its last object, whose
    repeats it discards)."""
    rng = np.random.default_rng(traffic["partition_seed"])
    lanes, lo, out = traffic["lanes"], 0, []
    for group in traffic["scenes"]["groups"]:
        idx = lo + rng.permutation(group["objects"])
        out += [idx[i:i + lanes] for i in range(0, len(idx), lanes)]
        lo += group["objects"]
    return out


class Recording(torch.nn.Module):
    """The program's model, unchanged, with the logits of every call kept
    while ``on``."""

    def __init__(self, inner) -> None:
        super().__init__()
        self.inner = inner
        self.train(inner.training)
        self.on, self.logits = False, []

    def _keep(self, out):
        if self.on:
            self.logits.append(out["instances"].detach().clone())
        return out

    def forward(self, *args, **kwargs):
        return self._keep(self.inner(*args, **kwargs))

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["inner"], name)


def prepare(ctx) -> Dict:
    """The program loaded and warmed up on every shape of the window."""
    from isegprobe_torch.evaluate import load_model_for_eval
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_device, make_device_evaluator)

    t, device = ctx.traffic, ctx.device
    objs = load_objects(t)
    batches = plan(t)
    model, _ = load_model_for_eval(str(ctx.cell.checkpoint()),
                                   torch.float32, tuple(t["target_size"]),
                                   device)
    model = Recording(model)
    ev = make_device_evaluator(
        model, target_size=tuple(t["target_size"]),
        max_clicks=t["max_clicks"], net_clicks_limit=t["max_clicks"],
        pred_thr=t["pred_thr"], target_iou=t["target_iou"],
        min_clicks=1, with_flip=True,
        roi_prob_thresh=t["roi_prob_thresh"],
        expansion_ratio=t["expansion_ratio"],
        min_crop_size=t["min_crop_size"],
        recompute_thresh_iou=t["recompute_thresh_iou"],
        batch_size=t["lanes"], record_clicks=True, device=device)

    def one_batch(idx):
        clicks: list = []
        ious = evaluate_dataset_device(
            ev, Objects([objs[i] for i in idx]), clicks=clicks)
        return ious, clicks

    # warm-up: one batch of each frame shape the loop pads to (its
    # default bucket of 64 pixels)
    seen = set()
    for idx in batches:
        shape = tuple(-(-n // 64) * 64 for n in objs[idx[0]][1].shape)
        if shape not in seen:
            seen.add(shape)
            one_batch(idx)
    return dict(ev=ev, objs=objs, batches=batches, one_batch=one_batch,
                model=model)


def measure(st, ctx) -> Dict:
    """The window: whole rounds of the fixed batches, each round in the
    seed's order, until a round ends past ``ctx.seconds``. Each round
    records one batch drawn from the seed; the judge's sample is kept as
    set out in the module's docstring."""
    ev, batches, one_batch = st["ev"], st["batches"], st["one_batch"]
    model = st["model"]
    rng = np.random.default_rng(ctx.seed)
    keep_rng = np.random.default_rng([ctx.seed, 2])
    k = ctx.traffic["judge_batches"]
    done: List[Dict] = []
    tally = dict(clicks=0)
    pool: List[Dict] = []  # earlier rounds' records, a reservoir of k - 1
    latest, rounds = None, 0

    def counters():
        return dict(steps=ev.steps, clicks=tally["clicks"])

    win = Window(ctx.seconds, ctx.trace_seconds, counters,
                 ctx.device).start()
    steps0 = ev.steps
    while True:
        record = int(keep_rng.integers(len(batches)))
        current = None
        for b in rng.permutation(len(batches)):
            idx = rng.permutation(batches[b])
            model.on, model.logits = int(b) == record, []
            s0 = ev.steps
            ious, clicks = one_batch(idx)
            if model.on:
                current = dict(round=rounds, batch=int(b), objects=[],
                               logits=model.logits, steps=ev.steps - s0)
            model.on, model.logits = False, []
            for lane, (i, iu, c) in enumerate(zip(idx, ious, clicks)):
                obj = dict(object=int(i), ious=iu, clicks=c)
                if int(b) == record:
                    obj["lane"] = lane
                    current["objects"].append(obj)
                done.append(obj)
                tally["clicks"] += len(iu)
            win.tick()
        if latest is not None:
            if len(pool) < k - 1:
                pool.append(latest)
            else:
                j = int(keep_rng.integers(rounds))
                if j < k - 1:
                    pool[j] = latest
        latest, rounds = current, rounds + 1
        if win.elapsed >= ctx.seconds:
            break
    window = win.finish()
    return dict(
        objects=done, all_objects=st["objs"], window=win,
        judged=pool + [latest], rounds=rounds,
        e2e={"eval_clicks_per_s": tally["clicks"] / window},
        totals=dict(clicks=tally["clicks"], steps=ev.steps - steps0,
                    window_s=window))


def lane_probs(logits: List[torch.Tensor], lane: int):
    """The program's probabilities of one lane's click ``k`` pasted into
    the frame through a given ROI: the flip pair's mean logit, its
    sigmoid, pasted as the protocol pastes."""
    from benchmark.reference import protocol

    def at(k, roi, frame_hw):
        pair = logits[k][2 * lane:2 * lane + 2, ..., 0].float()
        merged = torch.sigmoid(0.5 * (pair[0] + pair[1].flip(1)))
        return protocol.paste(merged, roi, frame_hw)
    return at


def judge(cell, result, seed: int, device) -> Dict:
    """Every lane of the recorded batches the window kept, held to the
    reference: the probabilities behind each click rebuilt from the
    program's logits through the reference's ROI, and the clicks, IoUs and
    stops against the protocol. A batch whose calls do not match its loop
    steps counts as failed."""
    from benchmark.reference import protocol

    t = cell.traffic
    with protocol.reference(cell, device) as params:
        all_gaps, failed, judged, clicks = {}, 0, 0, 0
        for rec in result["judged"]:
            if rec is None:
                continue
            if len(rec["logits"]) != rec["steps"]:
                failed += 1
                continue
            for obj in rec["objects"]:
                image, gt = result["all_objects"][obj["object"]]
                g = protocol.judge_object(
                    params, cell.config, t, image, gt, obj["clicks"],
                    obj["ious"], lane_probs(rec["logits"], obj["lane"]),
                    device, band=t["threshold_band"])
                failed += any(g[k] > v for k, v in cell.limits.items())
                judged += 1
                clicks += len(obj["ious"])
                for k in g:
                    all_gaps[k] = max(all_gaps.get(k, 0.0), g[k])
    return dict(gaps={k: all_gaps.get(k, 0.0) for k in cell.limits},
                failed=failed, judged=judged, clicks=clicks,
                all_gaps=all_gaps)
