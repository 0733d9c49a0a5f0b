"""Convert a reference-trained iSegProbe ``.pth`` checkpoint into the
``.ckpt`` format that both ``python -m isegprobe_torch.evaluate`` and the
root ``evaluate.py`` read.

Counterpart of the root ``scripts/convert_reference_checkpoint.py``, with
its flags. The checkpoint is read with ``torch.load(..., weights_only=True)``
(a file that needs pickled globals is refused) and must carry the serialized
config.

Usage:

    python -m isegprobe_torch.scripts.convert_reference_checkpoint \\
        --input /path/to/last_checkpoint.pth --output converted.ckpt
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    import torch

    from isegprobe_torch.models.convert import convert_reference_checkpoint
    from isegprobe_torch.utils.serialization import save_checkpoint

    ckpt = torch.load(args.input, map_location="cpu", weights_only=True)
    out = convert_reference_checkpoint(ckpt)
    if out["config"] is None:
        raise SystemExit(
            "checkpoint has no serialized config; pass a reference checkpoint "
            "written by core/utils/misc.py:save_checkpoint")
    save_checkpoint(out["params"], out["config"], args.output)
    print(f"Wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
