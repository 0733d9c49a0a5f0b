"""The port's figures against the JAX package's: the joint PCA
(``utils/pca.py``) bitwise, the mIoU curves of ``plots/plot_iou_vs_clicks``
and the PCA panels of ``plots/plot_features`` from the same dumps, and the
figure files both write (``utils/viz.plot_feats`` too)."""

import pickle
import types

import numpy as np
import pytest

pytest.importorskip("matplotlib")


def _feats(seed, lr_hw=(6, 7), hr_hw=(24, 28), c=16):
    rng = np.random.default_rng(seed)
    lr = rng.standard_normal((*lr_hw, c)).astype(np.float32)
    hr = rng.standard_normal((*hr_hw, c)).astype(np.float32)
    return lr, hr


@pytest.mark.parametrize("seed", range(3))
def test_joint_pca_is_jaxs(seed):
    from isegprobe_torch.utils.pca import PCA, fit_joint_pca
    from isegprobe_tpu.utils import pca as jpca

    lr, hr = _feats(seed)
    for a, b in zip(fit_joint_pca(lr, hr), jpca.fit_joint_pca(lr, hr)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    x = np.concatenate([lr.reshape(-1, 16), hr.reshape(-1, 16)])
    got, want = PCA(2).fit(x), jpca.PCA(2).fit(x)
    assert np.array_equal(got.transform(x), want.transform(x))


def _pickles(tmp_path):
    from isegprobe_torch.inference.eval_utils import save_iou_analysis_data

    rng = np.random.default_rng(0)
    paths = []
    for k, name in enumerate(("a", "b")):
        ious = [np.sort(rng.random(int(rng.integers(2, 8)))).astype(
            np.float32) for _ in range(5)]
        paths.append(str(save_iou_analysis_data(tmp_path, "GrabCut", name,
                                                ious, n_clicks=7)))
    return paths


def test_plot_iou_vs_clicks_matches_jax(tmp_path, monkeypatch):
    """The curve of each pickle (shorter trajectories padded with their
    last IoU) equals the JAX script's, and both write their PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from isegprobe_torch.plots import plot_iou_vs_clicks as tplot
    from isegprobe_tpu.plots import plot_iou_vs_clicks as jplot

    paths = _pickles(tmp_path)
    axes = []
    real = plt.subplots

    def spy(*args, **kwargs):
        fig, ax = real(*args, **kwargs)
        axes.append(ax)
        return fig, ax

    monkeypatch.setattr(plt, "subplots", spy)
    lines = {}
    for key, mod in (("port", tplot), ("jax", jplot)):
        mod.plot_iou_vs_clicks(paths, ["A", "B"], str(tmp_path / key),
                               title="t")
        lines[key] = [(ln.get_label(), np.asarray(ln.get_xdata()),
                       np.asarray(ln.get_ydata()))
                      for ln in axes[-1].get_lines()]
        (png,) = (tmp_path / key).glob("iou_vs_clicks_*.png")
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    plt.close("all")
    assert len(lines["port"]) == len(lines["jax"]) == 2
    for (la, xa, ya), (lb, xb, yb) in zip(lines["port"], lines["jax"]):
        assert la == lb and np.array_equal(xa, xb) and np.array_equal(ya, yb)
    with open(paths[0], "rb") as f:
        data = pickle.load(f)
    assert np.array_equal(tplot.miou_curve(data["all_ious"]),
                          lines["port"][0][2])
    with pytest.raises(ValueError, match="legend"):
        tplot.plot_iou_vs_clicks(paths, ["A"], str(tmp_path))
    assert tplot.main(["--pickle_paths", paths[1], "--legend_names", "B",
                       "--output_folder", str(tmp_path / "cli")]).exists()


def _dumps(tmp_path):
    """Two feature dumps in the layout of ``get_save_feats_callback``: the
    LowRes and HighRes ``.npy`` of images 0 and 1, and the images."""
    from isegprobe_torch.data.image_io import write_jpeg

    roots = [tmp_path / "feats_a", tmp_path / "feats_b"]
    for k, root in enumerate(roots):
        (root / "images").mkdir(parents=True)
        for img_id in range(2):
            lr, hr = _feats(10 * k + img_id)
            np.save(root / f"{img_id}_0_LowRes.npy", lr[None])
            np.save(root / f"{img_id}_0_HighRes.npy", hr[None])
            write_jpeg(root / "images" / f"{img_id}_0_image.jpg",
                       np.random.default_rng(img_id).integers(
                           0, 256, (24, 28, 3), dtype=np.uint8))
    return roots


def test_plot_features_matches_jax(tmp_path):
    """The panels' PCA maps equal the JAX script's on the same dumps, the
    images read as PIL reads them, and both write their PNG."""
    pil = pytest.importorskip("PIL.Image")

    from isegprobe_torch.plots import plot_features as tplot
    from isegprobe_tpu.plots import plot_features as jplot
    from isegprobe_tpu.utils.pca import fit_joint_pca

    roots = _dumps(tmp_path)
    hr_paths = [str(r) for r in roots]
    images, lr_list, hr_lists = tplot.load_features([0, 1], roots[0],
                                                    hr_paths)
    jimages, jlr, jhr = jplot.load_features([0, 1], roots[0], hr_paths)
    for a, b in zip(images, jimages):
        assert np.array_equal(a, b)
    for i, maps in enumerate(tplot.feature_maps(lr_list, hr_lists)):
        for j, (lr_rgb, hr_rgb) in enumerate(maps):
            want = fit_joint_pca(jlr[i], jhr[i][j])
            assert np.array_equal(lr_rgb, want[0])
            assert np.array_equal(hr_rgb, want[1])
    args = ["--lr_feats_path", str(roots[0]), "--hr_feats_paths",
            ",".join(hr_paths), "--img_ids", "0,1", "--feats_captions",
            "A,B", "--title", "T"]
    out = tplot.main([*args, "--save_dir", str(tmp_path / "port")])
    assert out.exists() and out.name.startswith("features_")
    jplot.main(types.SimpleNamespace(
        lr_feats_path=str(roots[0]), hr_feats_paths=",".join(hr_paths),
        feats_captions="A,B", img_ids="0,1", save_dir=str(tmp_path / "jax"),
        title="T", seed=1))
    (jpng,) = (tmp_path / "jax").glob("features_*.png")
    assert pil.open(out).size == pil.open(jpng).size


def test_plot_feats_grid_matches_jax(tmp_path):
    from isegprobe_torch.utils.viz import plot_feats
    from isegprobe_tpu.utils.viz import plot_feats as jplot_feats

    lr, hr = _feats(5)
    img = np.zeros((24, 28, 3), np.uint8)
    fig = plot_feats([img, img], [lr, lr], [hr, hr], names=["x", "y"])
    jfig = jplot_feats([img, img], [lr, lr], [hr, hr], names=["x", "y"])
    for ax, jax_ in zip(fig.axes, jfig.axes):
        assert ax.get_title() == jax_.get_title()
        for im, jim in zip(ax.get_images(), jax_.get_images()):
            assert np.array_equal(np.asarray(im.get_array()),
                                  np.asarray(jim.get_array()))
    assert plot_feats([img], [lr], [hr], save_path=tmp_path / "g.png") \
        is None
    assert (tmp_path / "g.png").exists()
