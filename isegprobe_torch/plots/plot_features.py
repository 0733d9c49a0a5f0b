"""PCA figures of the feature dumps that ``evaluate ... save_feats=true``
writes (``inference/eval_utils.get_save_feats_callback``).

Counterpart of ``isegprobe_tpu/plots/plot_features.py``, with its flags
and output (``features_<date>.png``): for each image id, the image, the
LowRes map of ``--lr_feats_path`` and each HighRes map of
``--hr_feats_paths`` in the colours of a PCA fit jointly on the LowRes and
that HighRes map. Images are read with ``data/image_io.py``.

Usage (on the CPU):
    python -m isegprobe_torch.plots.plot_features \\
        --lr_feats_path /path/to/feats --hr_feats_paths /p1,/p2 \\
        --img_ids 0,1,2 --save_dir out/ [--feats_captions A,B] [--title T]
"""

from __future__ import annotations

import argparse
import random
from datetime import datetime
from pathlib import Path

import numpy as np

from isegprobe_torch.data.image_io import read_rgb
from isegprobe_torch.utils.pca import fit_joint_pca

__all__ = ["load_features", "feature_maps", "main"]


def load_features(img_ids, lr_path, hr_paths):
    """(images, LowRes maps, [HighRes maps a path]) of the first click of
    each image id, the batch axis dropped."""
    images, lr_list, hr_lists = [], [], []
    for img_id in img_ids:
        images.append(read_rgb(Path(lr_path) / "images"
                               / f"{img_id}_0_image.jpg"))
        lr_list.append(np.load(Path(lr_path) / f"{img_id}_0_LowRes.npy")[0])
        hr_lists.append([np.load(Path(p) / f"{img_id}_0_HighRes.npy")[0]
                         for p in hr_paths])
    return images, lr_list, hr_lists


def feature_maps(lr_list, hr_lists):
    """[[(LowRes RGB, HighRes RGB) a HighRes path] an image]: the panels'
    PCA colours."""
    return [[fit_joint_pca(lr, hr) for hr in hrs]
            for lr, hrs in zip(lr_list, hr_lists)]


def main(argv=None) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    parser = argparse.ArgumentParser()
    parser.add_argument("--lr_feats_path", required=True)
    parser.add_argument("--hr_feats_paths", required=True)
    parser.add_argument("--feats_captions", default="")
    parser.add_argument("--img_ids", default="0")
    parser.add_argument("--save_dir", default="./plots")
    parser.add_argument("--title", default="")
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)

    random.seed(args.seed)
    np.random.seed(args.seed)
    img_ids = [int(x) for x in args.img_ids.split(",")]
    hr_paths = args.hr_feats_paths.split(",")
    captions = args.feats_captions.split(",") if args.feats_captions else [
        f"HR {i}" for i in range(len(hr_paths))]

    images, lr_list, hr_lists = load_features(img_ids, args.lr_feats_path,
                                              hr_paths)
    maps = feature_maps(lr_list, hr_lists)
    n, m = len(images), len(hr_paths)
    fig, axes = plt.subplots(n, m + 2, figsize=(3 * (m + 2), 3 * n),
                             squeeze=False)
    for i in range(n):
        axes[i][0].imshow(images[i])
        axes[i][0].set_title("image")
        for j, (lr_rgb, hr_rgb) in enumerate(maps[i]):
            if j == 0:
                axes[i][1].imshow(lr_rgb)
                axes[i][1].set_title("LowRes")
            axes[i][j + 2].imshow(hr_rgb)
            axes[i][j + 2].set_title(captions[j])
        for ax in axes[i]:
            ax.axis("off")
    if args.title:
        fig.suptitle(args.title)
    fig.tight_layout()

    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M")
    out = save_dir / f"features_{stamp}.png"
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"Saved: {out}")
    return out


if __name__ == "__main__":
    main()
