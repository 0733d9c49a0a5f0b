"""The port's data and tensor parallelism (``isegprobe_torch/parallel/``),
its trainer under a mesh, and the multi-device evaluators, on the CPU.

- the launch gate against the JAX package's three cases, with
  ``init_process_group`` (and ``jax.distributed.initialize``) patched;
- the loader's rank striding against the JAX loader's index sets;
- ``vit_param_shardings`` against the JAX rule on the whole probe tree,
  and a rank's shard cut from the full state dict (by ``shard_state_dict``
  and by ``shard_vit_tp``) and put back, bitwise;
- one gloo group of two spawned ranks (a ``FileStore``; each spawn joined
  with a timeout) that runs: a data-parallel step of the tiny flagship at
  batch 2 a rank against the one-rank step on the 4-sample global batch
  (loss within 1e-6, leaves within 1e-5 of their scale as L2 norms:
  Adam's first step, g / (|g| + eps), moves single elements whose
  gradient nearly cancels by up to 2.4e-4 of the leaf's largest value
  for a sum-order change of the gradient), at ``num_iters`` 0 and 2 (the
  clicks drawn for the global batch); the tensor-parallel
  forward (one head a rank) within 1e-5 of the replicated one, a TP step
  within JAX's DP-vs-TP tolerances (``tests/test_tensor_parallel.py``),
  its gathered checkpoint (``full_state_dict``) read by the JAX reader,
  equal to the full tree bitwise, and a split ViT's last-block keys (the
  DINO key probe) and their gradient within 1e-5 of the unsplit ViT's;
- a process group of one (``HashStore``): the step is bitwise the plain
  step;
- the mesh evaluator and one job queue a device on ``["cpu", "cpu"]``,
  through the evaluate CLI's ``device_mesh``, against the one-device run.
"""

import copy
import dataclasses
import os
import time
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

HW = 56
TINY = "dinov2_tiny_test"
SPAWN_TIMEOUT = 180


def _register_tiny():
    from isegprobe_torch.models.featurizers import dinov2 as t_dinov2

    t_dinov2.DINOV2_ARCHS[TINY] = dataclasses.replace(
        t_dinov2.DINOV2_ARCHS["dinov2_vits14"], embed_dim=128, depth=2,
        num_heads=2)


def _tiny_config():
    return dict(
        backbone_cfg=dict(type="dinov2",
                          params=dict(arch=TINY,
                                      feats_injection_mode="before_backbone")),
        embed_coords_cfg=dict(type="patchEmbed",
                              params=dict(img_size=(HW, HW),
                                          patch_size=(14, 14),
                                          embed_dim=128)),
        head_cfg=dict(type="convhead",
                      params=dict(in_channels=128, num_layers=2,
                                  num_classes=1)),
        upsampler_cfg=dict(type="identity", params=dict()),
        use_disks=True, norm_radius=5, with_prev_mask=True)


def _global_batch(n=4):
    rng = np.random.default_rng(0)
    images = (rng.random((n, HW, HW, 3)) * 255).astype(np.uint8)
    inst = np.zeros((n, HW, HW, 1), np.float32)
    points = np.full((n, 6, 3), -1.0, np.float32)
    for i in range(n):
        y0, x0 = 8 + 4 * i, 6 + 3 * i
        inst[i, y0:y0 + 22, x0:x0 + 24] = 1
        images[i, y0:y0 + 22, x0:x0 + 24] = (200, 170, 90)
        points[i, 0] = [y0 + 11, x0 + 12, 0]
    return {"images": images, "points": points, "instances": inst}


class _Items:
    """Eight items of the global batch's kind (``get_item`` as the loader
    calls it)."""

    def __init__(self):
        gb = _global_batch(8)
        self.items = [{k: v[i] for k, v in gb.items()} for i in range(8)]

    def __len__(self):
        return 8

    def get_item(self, index, seed):
        return self.items[index]


def _trainer(tmp, mesh=None, batch=4, logs=None):
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.training.losses import NormalizedFocalLossSigmoid
    from isegprobe_torch.training.metrics import AdaptiveIoU
    from isegprobe_torch.training.trainer import iSegTrainer

    _register_tiny()
    cfg = types.SimpleNamespace(
        dataloader=types.SimpleNamespace(batch_size=batch,
                                         val_batch_size=batch, workers=0),
        training=types.SimpleNamespace(start_epoch=0, weights=None),
        CHECKPOINTS_PATH=str(tmp), LOGS_PATH=logs)
    return iSegTrainer(
        iSegProbeModel(**_tiny_config(), device="cpu"), cfg,
        {"instance_loss": NormalizedFocalLossSigmoid(alpha=0.5, gamma=2),
         "instance_loss_weight": 1.0}, _Items(), _Items(),
        optimizer="adam", optimizer_params={"lr": 1e-3},
        metrics=[AdaptiveIoU()], max_interactive_points=3,
        max_num_next_clicks=2, seed=5, device="cpu", mesh=mesh)


def _one_step(trainer, batch, num_iters):
    """One training step on a batch of tensors; (reported loss, the
    trainable leaves)."""
    loss, _, iou = trainer._step(batch, num_iters)
    names = [n for n, p in trainer.model.named_parameters()
             if p.requires_grad]
    state = dict(trainer.model.named_parameters())
    return (float(loss), {n: state[n].detach().clone() for n in names},
            [float(v) for v in iou[0]])


def _as_tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# -- the spawned group ----------------------------------------------------------


def _rank_main(rank, world, store_path, out_dir):
    """One rank of the gloo group: the DP and TP scenarios, results saved
    to ``out_dir/rank<k>.pt``."""
    import torch.distributed as dist

    from isegprobe_torch.parallel import tp
    from isegprobe_torch.parallel.mesh import (
        make_mesh,
        put_global_batch,
        reduce_loss_dict,
    )
    from isegprobe_torch.utils.serialization import save_checkpoint

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    out = {}
    try:
        gb = _global_batch()
        # data parallel: 2 x 1, batch 2 a rank
        dp = make_mesh()
        out["dp_shape"] = dict(dp.shape)
        rows = put_global_batch(gb, dp, multiprocess=False)
        out["rows_images"] = rows["images"].numpy()
        for iters in (0, 2):
            trainer = _trainer(out_dir / f"dp{rank}", dp, batch=2)
            assert len(trainer.train_data) == 8 // 2 // 2
            out[f"dp{iters}"] = _one_step(trainer, rows, iters)
        out["reduced"] = reduce_loss_dict({"x": float(rank)})
        # an epoch through the rank-strided loader (2 steps of 2 rows a
        # rank): the master alone writes the checkpoint and the scalars
        trainer = _trainer(out_dir / "epoch" / f"ckpt{rank}", dp, batch=2,
                           logs=str(out_dir / "epoch" / f"logs{rank}"))
        trainer.train_data.num_workers = 0
        trainer.training(0)
        trainer.shutdown()
        out["epoch_losses"] = trainer.epoch_losses
        out["epoch_leaves"] = {
            n: p.detach().clone() for n, p in
            trainer.model.named_parameters() if p.requires_grad}
        # tensor parallel: 1 x 2, the whole batch on both ranks
        mesh = make_mesh(model_parallel=2)
        out["tp_shape"] = dict(mesh.shape)
        trainer = _trainer(out_dir / f"tp{rank}", mesh)
        blocks = [m for m in trainer.model.modules()
                  if isinstance(m, tp.TPAttention)]
        out["tp_heads"] = [b.num_heads for b in blocks]
        out["tp_qkv"] = tuple(blocks[0].qkv.weight.shape)
        batch = _as_tensors(gb)
        with torch.no_grad():
            images = batch["images"].float() / 255.0
            net = torch.cat([images, torch.zeros_like(images[..., :1])], -1)
            out["tp_logits"] = trainer.model(net, batch["points"])[
                "instances"].numpy()
        full = trainer.full_params()
        if rank == 0:
            from isegprobe_torch.utils.serialization import model_config

            save_checkpoint(full, model_config(trainer.model),
                            out_dir / "tp_full.ckpt", {"epoch": 0})
        out["tp2"] = _one_step(trainer, batch, 2)
        out["keys"] = [_keys_and_grad(vit) for vit in
                       _vit_pair(lambda m: tp.shard_vit_tp(m, mesh))]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, out_dir / f"rank{rank}.pt")


def _vit_pair(split):
    """A small ViT with seeded weights, and a copy of it split by
    ``split``."""
    from isegprobe_torch.models.vit import ViT, ViTConfig

    vit = ViT(ViTConfig(embed_dim=128, depth=2, num_heads=2,
                        pretrain_grid=(4, 4)))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in vit.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return vit, split(copy.deepcopy(vit))


def _keys_and_grad(vit):
    """The last block's keys on seeded tokens (the DINO key probe's
    features) and the gradient of a weighted sum of them by the tokens."""
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randn(2, 16, 128, generator=gen).requires_grad_(True)
    keys = vit.forward_tokens(tokens, (4, 4), return_last_k=True)["last_k"]
    (keys * torch.linspace(-1, 1, keys.shape[-1])).sum().backward()
    return keys.detach().numpy(), tokens.grad.numpy()


def _spawn(fn, world, *args):
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.time() + SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                raise TimeoutError(f"the spawned group did not finish in "
                                   f"{SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def gloo_group(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("gloo")
    _spawn(_rank_main, 2, str(out_dir / "store"), out_dir)
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    ref = {}
    gb = _as_tensors(_global_batch())
    for iters in (0, 2):
        ref[iters] = _one_step(_trainer(out_dir / "ref"), gb, iters)
    trainer = _trainer(out_dir / "ref_model")
    with torch.no_grad():
        images = gb["images"].float() / 255.0
        net = torch.cat([images, torch.zeros_like(images[..., :1])], -1)
        ref["logits"] = trainer.model(net, gb["points"])["instances"].numpy()
    ref["full"] = trainer.full_params()
    return ranks, ref, out_dir


def _close_leaves(got, want, rel, what):
    """Each leaf's difference within ``rel`` of the leaf's scale, both as
    L2 norms."""
    assert got.keys() == want.keys()
    for k in want:
        scale = float(want[k].norm()) or 1.0
        err = float((got[k] - want[k]).norm())
        assert err <= rel * scale, f"{what} {k}: {err} > {rel} x {scale}"


@pytest.mark.parametrize("num_iters", [0, 2])
def test_data_parallel_step_matches_one_rank(gloo_group, num_iters):
    ranks, ref, _ = gloo_group
    want_loss, want_leaves, want_iou = ref[num_iters]
    for r, res in enumerate(ranks):
        assert res["dp_shape"] == {"data": 2, "model": 1}
        loss, leaves, iou = res[f"dp{num_iters}"]
        assert abs(loss - want_loss) <= 1e-6, (r, loss, want_loss)
        _close_leaves(leaves, want_leaves, 1e-5, f"rank {r}")
        np.testing.assert_allclose(iou, want_iou, rtol=0, atol=1e-6)
    # the replicas stay equal: one averaged gradient, one Adam update
    for k, v in ranks[0][f"dp{num_iters}"][1].items():
        assert torch.equal(v, ranks[1][f"dp{num_iters}"][1][k]), k


def test_ranks_hold_their_rows_and_reduce_the_losses(gloo_group):
    ranks, _, _ = gloo_group
    gb = _global_batch()
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["rows_images"],
                                      gb["images"][2 * r:2 * r + 2])
        assert res["reduced"] == {"x": 0.5}


def test_an_epoch_on_two_ranks_writes_on_the_master(gloo_group):
    """An epoch through the rank-strided loaders: both ranks log the same
    (reduced) losses and end with the same leaves; only rank 0 writes the
    checkpoint and the TensorBoard scalars."""
    ranks, _, out_dir = gloo_group
    assert len(ranks[0]["epoch_losses"]) == 1
    assert ranks[0]["epoch_losses"] == ranks[1]["epoch_losses"]
    for k, v in ranks[0]["epoch_leaves"].items():
        assert torch.equal(v, ranks[1]["epoch_leaves"][k]), k
    epoch = out_dir / "epoch"
    assert (epoch / "ckpt0" / "last_checkpoint.ckpt").exists()
    assert not (epoch / "ckpt1").exists() or not any(
        (epoch / "ckpt1").iterdir())
    assert any((epoch / "logs0").iterdir())
    assert not (epoch / "logs1").exists()


def test_tensor_parallel_forward_matches_replicated(gloo_group):
    ranks, ref, _ = gloo_group
    want = ref["logits"]
    scale = float(np.abs(want).max())
    for res in ranks:
        assert res["tp_shape"] == {"data": 1, "model": 2}
        # whole heads: 2 heads over 2 ranks, [q_r | k_r | v_r] of 64 each
        assert res["tp_heads"] == [1, 1] and res["tp_qkv"] == (192, 128)
        np.testing.assert_allclose(res["tp_logits"], want, rtol=0,
                                   atol=1e-5 * scale)


def test_tensor_parallel_step_within_jax_tolerances(gloo_group):
    """JAX's DP-vs-TP tolerances: loss rtol 1e-5, leaves rtol 1e-3 and
    atol 5e-5."""
    ranks, ref, _ = gloo_group
    want_loss, want_leaves, _ = ref[2]
    for res in ranks:
        loss, leaves, _ = res["tp2"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        for k in want_leaves:
            np.testing.assert_allclose(leaves[k].numpy(),
                                       want_leaves[k].numpy(), rtol=1e-3,
                                       atol=5e-5, err_msg=k)


def test_tensor_parallel_keys_match_replicated(gloo_group):
    """A split block's keys are gathered over the model group: the DINO key
    probe's last-block keys, and their gradient by the tokens, equal the
    unsplit ViT's within 1e-5 of their scale."""
    ranks, _, _ = gloo_group
    for res in ranks:
        (want_k, want_g), (got_k, got_g) = res["keys"]
        assert got_k.shape == want_k.shape == (2, 17, 128)
        for got, want in ((got_k, want_k), (got_g, want_g)):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * float(np.abs(want).max()))


def test_tensor_parallel_checkpoint_read_by_jax(gloo_group):
    """The master's checkpoint of a TP run is the full tree, gathered: the
    JAX reader loads it, and every leaf equals the unsplit tree's."""
    from isegprobe_tpu.utils.serialization import (
        build_model,
        load_checkpoint,
    )

    _, ref, out_dir = gloo_group
    params, config, extra = load_checkpoint(out_dir / "tp_full.ckpt")
    build_model(config)
    assert extra["epoch"] == 0

    def walk(a, b, path=""):
        assert a.keys() == b.keys(), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]),
                                              err_msg=f"{path}/{k}")

    walk(params, ref["full"])


# -- in one process ------------------------------------------------------------


def test_a_group_of_one_is_the_plain_step(tmp_path):
    """A gloo group of one (``HashStore``): the mesh's all-reduces run and
    leave the step bitwise the plain one."""
    import torch.distributed as dist

    from isegprobe_torch.parallel.mesh import make_mesh

    from isegprobe_torch import train as train_cli

    gb = _as_tensors(_global_batch())
    want = _one_step(_trainer(tmp_path / "a"), gb, 2)
    argv = ["model=synthetic_dinov2_noup", "device=cpu"]
    # the train CLI's mesh: none for one device without a group; more
    # devices than processes raise
    assert train_cli.make_run_mesh(train_cli.parse_args(argv)) is None
    with pytest.raises(ValueError, match="2 processes"):
        train_cli.make_run_mesh(train_cli.parse_args(
            [*argv, "training.n_devices=2"]))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh()
        assert mesh.distributed and mesh.shape == {"data": 1, "model": 1}
        assert train_cli.make_run_mesh(
            train_cli.parse_args(argv)).distributed
        got = _one_step(_trainer(tmp_path / "b", mesh), gb, 2)
    finally:
        dist.destroy_process_group()
    assert got[0] == want[0] and got[2] == want[2]
    for k, v in want[1].items():
        assert torch.equal(got[1][k], v), k


def _gate_env(monkeypatch, **env):
    for var in ("ISEG_COORDINATOR", "ISEG_NUM_PROCESSES", "ISEG_PROCESS_ID",
                "ISEG_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("case", ["none", "explicit", "auto"])
def test_init_gate_matches_jax(monkeypatch, case):
    import jax

    from isegprobe_tpu.parallel.mesh import (
        maybe_init_distributed as j_gate,
    )
    from isegprobe_torch.parallel import mesh as t_mesh

    env = {"none": {},
           "explicit": dict(ISEG_COORDINATOR="10.0.0.7:8476",
                            ISEG_NUM_PROCESSES="4", ISEG_PROCESS_ID="2"),
           "auto": dict(ISEG_DISTRIBUTED="auto")}[case]
    _gate_env(monkeypatch, **env)
    j_calls, t_calls = [], []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **k: j_calls.append(k))
    monkeypatch.setattr(t_mesh.dist, "init_process_group",
                        lambda **k: t_calls.append(k))
    assert t_mesh.maybe_init_distributed(backend="gloo") is j_gate()
    assert len(t_calls) == len(j_calls)
    if case == "explicit":
        j, = j_calls
        assert t_calls == [dict(backend="gloo",
                                init_method=f"tcp://{j['coordinator_address']}",
                                world_size=j["num_processes"],
                                rank=j["process_id"])]
    if case == "auto":
        assert t_calls == [dict(backend="gloo", init_method="env://")]


class _Counting:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"index": np.asarray([i], np.int64)}

    def get_item(self, i, seed):
        return self[i]


@pytest.mark.parametrize("world", [2, 3])
def test_loader_striding_matches_jax(world):
    from isegprobe_tpu.data.loader import DataLoader as JLoader
    from isegprobe_torch.data.loader import DataLoader as TLoader

    n, bs = 32, 4
    for rank in range(world):
        j = JLoader(_Counting(n), batch_size=bs, shuffle=True, num_workers=1,
                    seed=3, rank=rank, world=world)
        t = TLoader(_Counting(n), batch_size=bs, shuffle=True, num_workers=1,
                    seed=3, rank=rank, world=world)
        assert len(t) == len(j) == n // world // bs
        for epoch in (0, 1):
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            want = [b["index"].ravel().tolist() for b in j]
            got = [b["index"].ravel().tolist() for b in t]
            assert got == want, (rank, epoch)
        j.shutdown()
        t.shutdown()
    with pytest.raises(ValueError, match="world"):
        TLoader(_Counting(n), batch_size=bs, rank=world, world=world)


def test_vit_param_shardings_match_jax_and_shards_round_trip():
    from jax.sharding import PartitionSpec as P

    from isegprobe_tpu.parallel.mesh import make_mesh as j_mesh
    from isegprobe_tpu.parallel.tp import vit_param_shardings as j_rule
    from isegprobe_torch.models.init_tree import init_tree
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.parallel.tp import (
        shard_state_dict,
        shard_vit_tp,
        vit_param_shardings,
    )

    _register_tiny()
    tree = init_tree(_tiny_config(), 0)
    want = j_rule(tree, j_mesh(axis_names=("data", "model"),
                               model_parallel=2))
    got = vit_param_shardings(tree)

    def walk(g, w, path=""):
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k], f"{path}/{k}")
            else:
                assert w[k].spec == P(*g[k]), f"{path}/{k}"

    walk(got, want)
    blk = got["backbone"]["model"]["blocks_1"]
    assert blk["attn"]["qkv"]["kernel"] == (None, "model")
    assert blk["mlp"]["fc2"]["kernel"] == ("model", None)
    assert all(leaf == () for layer in got["head"].values()
               for sub in ([layer] if isinstance(layer, tuple)
                           else layer.values())
               for leaf in ([sub] if isinstance(sub, tuple)
                            else sub.values()))
    # a rank's shard, cut from the full state dict and put back, bitwise
    model = load_jax_params(iSegProbeModel(**_tiny_config(), device="cpu"),
                            tree)
    full = model.state_dict()
    shards = [shard_state_dict(full, r, 2, heads=2) for r in range(2)]
    qkv = "backbone.model.blocks.0.attn.qkv.weight"
    assert shards[0][qkv].shape == (192, 128)
    # rank 1 holds head 1 of q, k and v
    np.testing.assert_array_equal(shards[1][qkv][64:128].numpy(),
                                  full[qkv][192:256].numpy())
    # put back: each third of qkv and fc1's rows, proj and fc2's columns
    for k, v in full.items():
        parts = [s[k] for s in shards]
        if k.endswith(("attn.qkv.weight", "attn.qkv.bias")):
            back = torch.cat([torch.cat([p.chunk(3)[j] for p in parts])
                              for j in range(3)])
        elif k.endswith(("mlp.fc1.weight", "mlp.fc1.bias")):
            back = torch.cat(parts)
        elif k.endswith(("attn.proj.weight", "mlp.fc2.weight")):
            back = torch.cat(parts, dim=1)
        else:
            assert all(p is v for p in parts), k
            continue
        assert back.shape == v.shape and torch.equal(back, v), k
    # shard_vit_tp cuts each rank's model through shard_state_dict
    for r in range(2):
        mesh = types.SimpleNamespace(model=2, model_index=r,
                                     model_group=None)
        split = shard_vit_tp(copy.deepcopy(model), mesh).state_dict()
        assert split.keys() == shards[r].keys()
        for k, v in shards[r].items():
            assert torch.equal(split[k], v), (r, k)
    with pytest.raises(ValueError, match="heads"):
        shard_state_dict(full, 0, 3, heads=2)


def test_evaluate_cli_device_mesh_on_one_device(caplog, monkeypatch):
    """``device_mesh=true`` on the CPU (one device) warns once and runs as
    without it, lockstep and with the job queue; with two devices named
    (``visible_devices`` patched) the lockstep run splits the lanes and the
    job queue deals the jobs, with the same trajectories."""
    import logging

    from isegprobe_torch import evaluate as cli
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from tests.test_torch_predictor import _scene, _Scenes

    _register_tiny()
    model = iSegProbeModel(**_tiny_config(), device="cpu")
    data = _Scenes([_scene(s) for s in (0, 3, 5, 7)])
    base = ["checkpoint=tiny.ckpt", "device=cpu", "device_loop=true",
            "device_batch=2", f"eval_mode=fixed{HW}", "n_clicks=3",
            "print_ious=false", "target_iou=0.8"]

    def run(*extra):
        cfg = cli.parse_args([*base, *extra])
        return cli.evaluate(cfg, model, "Synthetic", dataset=data)

    for refill in ([], ["device_refill=true"]):
        want = run(*refill)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=cli.__name__):
            got = run("device_mesh=true", *refill)
        warned = [r for r in caplog.records if "device_mesh" in r.message]
        assert len(warned) == 1, [r.message for r in caplog.records]
        for a, b in zip(got["all_ious"], want["all_ious"]):
            np.testing.assert_array_equal(a, b)
        monkeypatch.setattr(cli, "visible_devices",
                            lambda d: [torch.device("cpu")] * 2)
        two = run("device_mesh=true", *refill)
        monkeypatch.undo()
        for a, b in zip(two["all_ious"], want["all_ious"]):
            np.testing.assert_array_equal(a, b)
        if refill:
            assert two["group_stats"]["devices"] == 2
    with pytest.raises(ValueError, match="divisible"):
        monkeypatch.setattr(cli, "visible_devices",
                            lambda d: [torch.device("cpu")] * 3)
        run("device_mesh=true")
