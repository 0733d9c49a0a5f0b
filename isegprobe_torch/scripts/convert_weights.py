"""Convert a published torch checkpoint (DINOv2, DINO or CLIP backbone,
LiFT or LoftUp upsampler) into a flax-msgpack param tree.

Counterpart of the root ``scripts/convert_weights.py``, with its flags; the
file it writes is the one that script writes (the trees are bitwise the
JAX package's converters'), read by ``PRETRAINED_MODELS.*`` of
``python -m isegprobe_torch.train`` and by an upsampler's
``upsampler_path``. The checkpoint is read with ``torch.load(...,
weights_only=True)``: a file that needs pickled globals is refused.

Usage:

    python -m isegprobe_torch.scripts.convert_weights --kind dinov2 \\
        --input dinov2_vits14_pretrain.pth --output dinov2_vits14.msgpack
    python -m isegprobe_torch.scripts.convert_weights --kind lift \\
        --input lift_dinov2.pth --output lift_dinov2.msgpack

``--kind``: ``dinov2`` (LayerScale), ``dino``, ``clip`` (the visual
tower), ``clip_text`` (the text tower of the same CLIP file), ``lift``
or ``loftup`` (a raw LoftUp checkpoint: the ChannelNorm under ``model.1.``,
the upsampler under ``upsampler.``); ``--depth``: the blocks (layers) to
convert, 12 by default.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

KINDS = ("dinov2", "dino", "clip", "clip_text", "lift", "loftup")


def convert(kind: str, sd, depth: int = 12) -> dict:
    """The flax-named tree of state dict ``sd`` of a ``kind`` checkpoint."""
    from isegprobe_torch.models import convert as cv

    if kind in ("dinov2", "dino"):
        return cv.convert_vit(sd, depth=depth, layerscale=kind == "dinov2")
    if kind == "clip":
        return cv.convert_clip_visual(sd, layers=depth)
    if kind == "clip_text":
        return cv.convert_clip_text(sd, layers=depth)
    if kind == "lift":
        return cv.convert_lift(sd)
    if kind == "loftup":
        return cv.convert_loftup_raw(sd)
    raise ValueError(f"--kind {kind!r}: takes one of {KINDS}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kind", required=True, choices=KINDS)
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--depth", type=int, default=12)
    args = parser.parse_args(argv)

    from isegprobe_torch.models.convert import load_torch_state_dict
    from isegprobe_torch.utils.serialization import msgpack_serialize

    sd = load_torch_state_dict(args.input, unwrap_model=True)
    params = convert(args.kind, sd, args.depth)
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(msgpack_serialize(params))
    print(f"Wrote {out} ({out.stat().st_size / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
