"""What a training run of the port leaves behind, against the JAX
package: the TensorBoard event file (``utils/log.py``) against
tensorboardX through JAX's ``SummaryWriterAvg``, both read back with
TensorBoard's reader and the port's; the trainer's scalar tags and steps
and its image dumps against the JAX trainer's on the tiny probe of
``tests/test_torch_training.py``; prev-mask dropout at p = 1 against the
JAX step; the run directory against JAX's ``init_experiment``; and the
optional wandb run with a stub ``wandb`` module."""

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests.test_torch_training import (  # noqa: E402,F401
    BATCH,
    LR,
    SIZE,
    ListDataset,
    _items,
    _numpy_tree,
    tiny_arch,
    tiny_batch,
    tiny_config,
)

STREAM_SEED = 3


def _tensorboard_scalars(log_dir) -> dict:
    """TensorBoard's own reader (its accumulator, on its TensorFlow stub so
    that TensorFlow is not imported): tag -> [(step, value)]."""
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    acc = EventAccumulator(str(log_dir), size_guidance={"scalars": 0})
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def _stream():
    rng = np.random.default_rng(STREAM_SEED)
    values = rng.standard_normal(23) * 10.0 ** rng.integers(-6, 6, 23)
    return [("Losses/a", float(v), i) for i, v in enumerate(values)] + [
        ("States/lr", 5e-5 * 0.1 ** (i // 7), i) for i in range(23)]


def test_crc32c_and_record_framing(tmp_path):
    from isegprobe_torch.utils.log import EventFileWriter, crc32c, read_events

    assert crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert crc32c(b"") == 0
    w = EventFileWriter(tmp_path)
    w.add_scalar("x", 1.5, 7)
    w.close()
    data = bytearray(w.path.read_bytes())
    first = read_events(w.path)
    assert first[0]["file_version"] == "brain.Event:2"
    assert first[1]["values"] == [("x", 1.5)] and first[1]["step"] == 7
    data[-5] ^= 1
    w.path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_events(w.path)


@pytest.mark.parametrize("dump_period", [1, 5])
def test_event_writer_matches_tensorboardx(tmp_path, dump_period):
    """One scalar stream through the port's ``SummaryWriterAvg`` and the
    JAX package's (tensorboardX): the same tags and steps, the values
    equal as float32, read by TensorBoard and by the port's reader; the
    file names follow tensorboardX's."""
    pytest.importorskip("tensorboardX")
    from isegprobe_torch.utils.log import SummaryWriterAvg, read_scalars
    from isegprobe_tpu.utils.log import SummaryWriterAvg as JWriter

    port, jax_ = tmp_path / "port", tmp_path / "jax"
    writers = (SummaryWriterAvg(port, dump_period=dump_period),
               JWriter(jax_, dump_period=dump_period))
    for tag, value, step in _stream():
        for w in writers:
            w.add_scalar(tag, value, step, disable_avg=tag.startswith("S"))
    for w in writers:
        w.close()
    (pfile,), (jfile,) = port.iterdir(), jax_.iterdir()
    assert pfile.name.split(".")[:3] == jfile.name.split(".")[:3] == [
        "events", "out", "tfevents"]
    assert pfile.name.split(".", 4)[4] == jfile.name.split(".", 4)[4]
    got = {k: read_scalars(d) for k, d in (("port", port), ("jax", jax_))}
    tb = {k: _tensorboard_scalars(d) for k, d in (("port", port),
                                                  ("jax", jax_))}
    assert got["port"].keys() == got["jax"].keys() == {"Losses/a",
                                                       "States/lr"}
    for tag in got["port"]:
        for series in (got["jax"][tag], tb["port"][tag], tb["jax"][tag]):
            assert [s for s, _ in series] == [s for s, _ in
                                              got["port"][tag]]
            assert np.array_equal(
                np.float32([v for _, v in series]),
                np.float32([v for _, v in got["port"][tag]]))
    assert len(got["port"]["Losses/a"]) == 23 // dump_period


# -- the trainer --------------------------------------------------------------------

def _cfg(tmp_path, name):
    root = tmp_path / name
    return types.SimpleNamespace(
        dataloader=types.SimpleNamespace(batch_size=BATCH,
                                         val_batch_size=BATCH, workers=0),
        training=types.SimpleNamespace(start_epoch=0, weights=None),
        CHECKPOINTS_PATH=str(root / "ckpts"), LOGS_PATH=str(root / "logs"),
        VIS_PATH=str(root / "vis"))


def _trainers(tmp_path, items, **kw):
    """The JAX and the port trainer of the tiny probe on ``items``, from the
    same params, with logs and image dumps."""
    import jax
    import torch

    from isegprobe_torch.models.probe_model import iSegProbeModel as TModel
    from isegprobe_torch.training.losses import \
        NormalizedFocalLossSigmoid as TNFL
    from isegprobe_torch.training.metrics import AdaptiveIoU as TIoU
    from isegprobe_torch.training.trainer import iSegTrainer as TTrainer
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel
    from isegprobe_tpu.parallel.mesh import make_mesh
    from isegprobe_tpu.training.losses import \
        NormalizedFocalLossSigmoid as JNFL
    from isegprobe_tpu.training.metrics import AdaptiveIoU as JIoU
    from isegprobe_tpu.training.trainer import iSegTrainer as JTrainer

    torch.set_num_threads(4)
    opt = {"lr": LR, "betas": (0.9, 0.999), "eps": 1e-8}
    common = dict(optimizer="adam", seed=0, **kw)
    jtr = JTrainer(JModel(**tiny_config(), attn_impl="jnp"),
                   _cfg(tmp_path, "jax"),
                   {"instance_loss": JNFL(alpha=0.5, gamma=2),
                    "instance_loss_weight": 1.0},
                   ListDataset(items), ListDataset(items[:BATCH]),
                   optimizer_params=dict(opt), metrics=[JIoU()],
                   mesh=make_mesh(n_devices=1), **common)
    p = jax.device_get(jtr.params)
    params = _numpy_tree({**p["trainable"], **p["frozen"]})
    ttr = TTrainer(TModel(**tiny_config(), device="cpu"),
                   _cfg(tmp_path, "port"),
                   {"instance_loss": TNFL(alpha=0.5, gamma=2),
                    "instance_loss_weight": 1.0},
                   ListDataset(items), ListDataset(items[:BATCH]),
                   optimizer_params=dict(opt), metrics=[TIoU()],
                   params=params, device="cpu", **common)
    return jtr, ttr, params


def test_trainer_scalars_and_dumps_match_jax(tiny_arch, tmp_path,
                                             monkeypatch):
    """An epoch of 3 steps and its validation in both trainers: the same
    scalar tags at the same steps (``Losses/*``, ``States/learning_rate``,
    the metric's states every step, ``Metrics/<name>`` at the epoch,
    ``Val/*``), values within 1e-4 of each other where the step is the
    same computation, and the image dumps of steps 0 and 2 (interval 2):
    the same file names, the panels' image and GT parts equal and the
    prediction's colours within 1 level."""
    import cv2

    from isegprobe_torch.data import image_io
    from isegprobe_torch.utils.log import read_scalars

    items = _items(tiny_batch(0)) + _items(tiny_batch(1)) + _items(
        tiny_batch(2))
    jtr, ttr, _ = _trainers(tmp_path, items, image_dump_interval=2,
                            tb_dump_period=1, max_num_next_clicks=0,
                            max_interactive_points=4)
    panels = {"jax": {}, "port": {}}
    real_imwrite, real_write = cv2.imwrite, image_io.write_jpeg

    def jax_imwrite(path, img, params=()):
        panels["jax"][Path(path).name] = (np.asarray(img)[:, :, ::-1].copy(),
                                          list(params))
        return real_imwrite(path, img, params)

    def port_write(path, img, quality=95):
        panels["port"][Path(path).name] = (np.asarray(img).copy(),
                                           [cv2.IMWRITE_JPEG_QUALITY, quality])
        return real_write(path, img, quality)

    monkeypatch.setattr(cv2, "imwrite", jax_imwrite)
    monkeypatch.setattr(image_io, "write_jpeg", port_write)
    for tr in (jtr, ttr):
        tr.training(0)
        tr.validation(0)
    jtr.sw.close()
    ttr.shutdown()
    jax_s = read_scalars(Path(jtr.cfg.LOGS_PATH))
    port_s = read_scalars(Path(ttr.cfg.LOGS_PATH))
    assert sorted(port_s) == sorted(jax_s) == sorted([
        "Losses/instance_loss", "Losses/nfl_k", "Losses/nfl_m_max",
        "Losses/overall", "States/learning_rate",
        "Metrics/AdaptiveIoU_ema_iou", "Metrics/AdaptiveIoU_iou_thresh",
        "Metrics/AdaptiveIoU", "Val/loss", "Val/AdaptiveIoU"])
    for tag in jax_s:
        assert [s for s, _ in port_s[tag]] == [s for s, _ in jax_s[tag]], tag
        np.testing.assert_allclose([v for _, v in port_s[tag]],
                                   [v for _, v in jax_s[tag]], rtol=1e-4,
                                   atol=1e-6, err_msg=tag)
    assert [s for s, _ in port_s["Losses/overall"]] == [0, 1, 2]
    names = ["000000_instance_segmentation.jpg",
             "000002_instance_segmentation.jpg"]
    assert sorted(panels["port"]) == sorted(panels["jax"]) == names
    for name in names:
        (got, gq), (want, wq) = panels["port"][name], panels["jax"][name]
        assert gq == wq == [cv2.IMWRITE_JPEG_QUALITY, 85]
        assert got.shape == want.shape == (SIZE, 3 * SIZE, 3)
        assert np.array_equal(got[:, :2 * SIZE], want[:, :2 * SIZE])
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        on_disk = Path(ttr.cfg.VIS_PATH) / "train" / name
        assert on_disk.exists() and (Path(jtr.cfg.VIS_PATH) / "train"
                                     / name).exists()
        assert on_disk.read_bytes() == image_io.encode_jpeg(got, 85)


def test_prev_mask_dropout_matches_jax(tiny_arch, tmp_path):
    """p = 1 drops every sample's prev mask after a click ran: the loss of
    the port's step equals the JAX step's (the one click lands on each
    object's single deepest pixel, through a click model whose logits are
    -3 everywhere, so neither package draws), and differs from the step
    without dropout; with no click (num_iters = 0) nothing is dropped."""
    import torch

    items = _items(tiny_batch(0))
    for it in items:  # a 3x3 object: its centre is the one deepest pixel
        inst = np.zeros_like(it["instances"])
        y, x = (int(v) for v in it["points"][0, :2])
        y, x = min(max(y, 3), SIZE - 4), min(max(x, 3), SIZE - 4)
        inst[y - 1:y + 2, x - 1:x + 2] = 1
        it["instances"] = inst
        it["points"][0] = (y, x, 0)
    click_model = {"head": {"classifier": {
        "bias": np.full((1,), -3.0, np.float32),
        "kernel": np.zeros((1, 1, 96, 1), np.float32)}}}
    losses = {}
    for p in (1.0, 0.0):
        jtr, ttr, params = _trainers(
            tmp_path / str(p), items, max_num_next_clicks=1,
            prev_mask_drop_prob=p, click_models=[click_model])
        batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
        import jax

        from isegprobe_tpu.utils.serialization import merge_params

        trees = (jax.device_put(merge_params(dict(params), click_model)),)
        for n in (1, 0):
            _, _, jloss, _, _, _ = jtr._val_step(
                jtr.params, jtr.opt_state, jtr._prep_batch(batch),
                jax.random.PRNGKey(0), n, 0.4, 0.025, click_trees=trees)
            tloss, _, _ = ttr._step(ttr._upload(batch), n, training=False)
            np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
            losses[(p, n)] = float(tloss)
        ttr.shutdown()
    assert losses[(1.0, 1)] != losses[(0.0, 1)]
    assert losses[(1.0, 0)] == losses[(0.0, 0)]
    assert torch.isfinite(torch.tensor(list(losses.values()))).all()


# -- the run directory and the command line ------------------------------------------

def test_run_directory_matches_jax(tmp_path, monkeypatch):
    """The port's ``init_experiment`` for a model script against JAX's: the
    same run path under ``exp_path`` (the script's directories under
    ``models/``), ``checkpoints/``, ``vis/``, ``logs/train.log`` and the
    script's copy."""
    import logging

    from isegprobe_torch.utils.exp import init_experiment
    from isegprobe_tpu.utils.config import EDict
    from isegprobe_tpu.utils.exp import init_experiment as jinit

    monkeypatch.chdir(tmp_path)
    script = tmp_path / "models" / "sbd" / "dinov2" / "patch-embed_noup.py"
    script.parent.mkdir(parents=True)
    script.write_text("MODEL_NAME = 'x'\n")
    cfg = EDict.convert({"exp": {"model_path": str(script), "name": "run"},
                         "training": {"resume_exp": None, "weights": None},
                         "EXPS_PATH": str(tmp_path / "jax")})
    jax_logger = logging.getLogger("isegprobe_tpu")
    jax_handlers = list(jax_logger.handlers)
    try:
        jcfg = jinit(cfg)
    finally:
        for h in jax_logger.handlers[len(jax_handlers):]:
            jax_logger.removeHandler(h)
            h.close()
    run = init_experiment(tmp_path / "port", script, "run")
    rel = run["exp_path"].relative_to(tmp_path / "port")
    assert rel == Path(jcfg.EXP_PATH).relative_to(tmp_path / "jax") == Path(
        "sbd/dinov2/patch-embed_noup/000_run")
    for key, jkey in (("checkpoints_path", "CHECKPOINTS_PATH"),
                      ("vis_path", "VIS_PATH"), ("logs_path", "LOGS_PATH")):
        assert run[key].is_dir() and run[key].name == Path(jcfg[jkey]).name
    assert sorted(p.name for p in run["exp_path"].iterdir()) == sorted(
        p.name for p in Path(jcfg.EXP_PATH).iterdir())
    assert (run["exp_path"] / script.name).read_text() == script.read_text()
    logging.getLogger("isegprobe_torch").info("a line")
    text = (run["logs_path"] / "train.log").read_text()
    assert "Experiment dir" in text and "a line" in text
    again = init_experiment(tmp_path / "port", "elsewhere/model.py", "b")
    assert again["exp_path"] == tmp_path / "port" / "model" / "000_b"


def test_train_cli_writes_the_run(tmp_path):
    """``python -m isegprobe_torch.train`` (two epochs of two steps, windows
    of 2 scalars): the run under the JAX path with the model script's copy,
    ``train.log``, the events with the trainer's tags, and the dumps at the
    interval."""
    from isegprobe_torch import train
    from isegprobe_torch.utils.log import read_scalars

    out = tmp_path / "exp"
    assert train.main([
        "model=synthetic_dinov2_noup", "device=cpu",
        "training_params.crop_size=[56,56]", "dataloader.batch_size=2",
        "dataloader.val_batch_size=2", "epoch_len=4", "val_epoch_len=2",
        "dataloader.workers=0", "exp.name=run", f"exp_path={out}",
        "training_params.epochs=2", "image_dump_interval=3",
        "tb_dump_period=2", "prev_mask_drop_prob=0.5"]) == 0
    run = out / "synthetic" / "dinov2_noup" / "000_run"
    assert (run / "dinov2_noup.py").read_text() == (
        REPO / "models" / "synthetic" / "dinov2_noup.py").read_text()
    assert "Epoch 1: val loss" in (run / "logs" / "train.log").read_text()
    scalars = read_scalars(run / "logs")
    assert [s for s, _ in scalars["Losses/overall"]] == [1, 3]
    # every tag is averaged over its windows of 2, the epochs' too
    assert [s for s, _ in scalars["Val/loss"]] == [1]
    assert sorted(p.name for p in (run / "vis" / "train").iterdir()) == [
        "000000_instance_segmentation.jpg",
        "000003_instance_segmentation.jpg"]
    assert (run / "checkpoints" / "last_checkpoint.ckpt").exists()


def test_model_scripts_are_the_jax_scripts():
    """Every ``model=`` key names its JAX script (its ``MODEL_NAME``)."""
    import re

    from isegprobe_torch.train import MODEL_SCRIPTS, MODELS, MODELS_DIR

    assert sorted(MODEL_SCRIPTS) == sorted(MODELS)
    for key, rel in MODEL_SCRIPTS.items():
        text = (MODELS_DIR / rel).read_text()
        (name,) = re.findall(r'^MODEL_NAME = "([^"]+)"', text, re.M)
        assert name == MODELS[key], key


# -- wandb ------------------------------------------------------------------------------

class _Recorder(types.ModuleType):
    """A stand-in ``wandb`` module that records the calls it receives."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []
        rec = self

        class Table:
            def __init__(self, columns):
                self.columns, self.rows = columns, []
                rec.calls.append(("Table", tuple(columns)))

            def add_data(self, *row):
                self.rows.append(row)

        self.Table = Table
        self.tensorboard = types.SimpleNamespace(
            patch=lambda **kw: rec.calls.append(("tensorboard.patch", kw)))
        self.plot = types.SimpleNamespace(
            line=lambda table, x, y, title: (x, y, title, table.rows))

    def init(self, **kw):
        self.calls.append(("init", kw))

    def log(self, data):
        self.calls.append(("log", data))

    def finish(self):
        self.calls.append(("finish",))


def test_init_wandb_as_jax(tmp_path, monkeypatch, caplog):
    """Off: nothing. On without ``wandb``: a warning and nothing. On with
    it: the JAX package's calls."""
    from isegprobe_torch.train import parse_args
    from isegprobe_torch.utils.log import init_wandb
    from isegprobe_tpu.utils.config import EDict
    from isegprobe_tpu.utils.log import init_wandb as jinit

    cfg = parse_args(["model=synthetic_dinov2_noup", "wandb.log_wandb=true",
                      "wandb.name=n"])
    assert init_wandb(parse_args(["model=synthetic_dinov2_noup"]),
                      tmp_path) is False
    monkeypatch.setitem(sys.modules, "wandb", None)
    with caplog.at_level("WARNING", logger="isegprobe_torch"):
        assert init_wandb(cfg, tmp_path) is False
    assert "wandb requested but not installed" in caplog.text
    calls = {}
    for key, fn, c in (
            ("port", init_wandb, cfg),
            ("jax", None, EDict.convert({
                "wandb": {"log_wandb": True, "project": "iSegProbe-Train",
                          "name": "n", "dir": "/path/to/logs"},
                "LOGS_PATH": str(tmp_path)}))):
        stub = _Recorder()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        if fn is None:
            jinit(c)
        else:
            assert fn(c, tmp_path)
        calls[key] = stub.calls
    assert calls["port"] == calls["jax"] == [
        ("tensorboard.patch", {"root_logdir": str(tmp_path)}),
        ("init", {"project": "iSegProbe-Train", "name": "n",
                  "dir": "/path/to/logs", "sync_tensorboard": True})]
    json.dumps(calls["port"])
