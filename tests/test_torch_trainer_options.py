"""The trainer's ``click_models`` ensembles and layer-wise learning-rate
decay against the JAX package.

Ports of ``tests/test_trainer.py:test_trainer_click_models_simulation``,
``test_layerwise_decay_optimizer_scales_backbone_updates``,
``test_trainer_layerwise_decay_flag_wires_and_noops_when_frozen`` and
``tests/test_optim_and_controller.py:test_layerwise_decay_scales_by_depth``,
held against optax's updates and the JAX trainer's simulated clicks.
Tolerances: parameters after the first update within 3e-7 of optax's
(a few f32 ulps at their scale of 1); the simulated points equal (the click is the single
deepest pixel of a 3×3 error, so neither package's draw has a choice);
the val step's loss after them within 1e-5 relative (f32).
"""

from __future__ import annotations

import logging

import numpy as np
import pytest

from tests.test_torch_training import (  # noqa: F401  (fixture)
    ListDataset,
    _ns_cfg,
    tiny_arch,
    tiny_config,
)

LOSS = {"alpha": 0.5, "gamma": 2}
SIZE, BATCH, N_POINTS = 56, 8, 4


def _trainers(tmp_path, items, click_models=None, jax_side=True, **kw):
    """A port trainer (and a JAX one) of the tiny probe from the JAX
    ``model.init(PRNGKey(0))`` params, with ``click_models``."""
    import jax
    import torch

    from isegprobe_torch.models.probe_model import iSegProbeModel as TModel
    from isegprobe_torch.training.losses import \
        NormalizedFocalLossSigmoid as TNFL
    from isegprobe_torch.training.trainer import iSegTrainer as TTrainer
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel
    from isegprobe_tpu.parallel.mesh import make_mesh
    from isegprobe_tpu.training.losses import \
        NormalizedFocalLossSigmoid as JNFL
    from isegprobe_tpu.training.trainer import iSegTrainer as JTrainer
    from tests.test_torch_training import _numpy_tree

    torch.set_num_threads(4)
    data = ListDataset(items)
    common = dict(optimizer="adam", optimizer_params={"lr": 1e-3},
                  max_num_next_clicks=kw.pop("max_num_next_clicks", 2),
                  seed=0, click_models=click_models, **kw)
    jtr = JTrainer(JModel(**tiny_config(), attn_impl="jnp"),
                   _ns_cfg(tmp_path),
                   {"instance_loss": JNFL(**LOSS),
                    "instance_loss_weight": 1.0}, data, data,
                   mesh=make_mesh(n_devices=1), **common)
    p = jax.device_get(jtr.params)
    params = _numpy_tree({**p["trainable"], **p["frozen"]})
    ttr = TTrainer(TModel(**tiny_config(), device="cpu"), _ns_cfg(tmp_path),
                   {"instance_loss": TNFL(**LOSS),
                    "instance_loss_weight": 1.0}, data, data,
                   params=params, device="cpu", **common)
    return (jtr if jax_side else None), ttr, params


def _square_batch(seed=0):
    """Random images, each with a 3×3 object (its one deepest pixel is its
    centre) and one positive click elsewhere on it."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    inst = np.zeros((BATCH, SIZE, SIZE, 1), np.int8)
    points = np.full((BATCH, 2 * N_POINTS, 3), -1.0, np.float32)
    for b in range(BATCH):
        y, x = rng.integers(4, SIZE - 8, 2)
        inst[b, y:y + 3, x:x + 3] = 1
        points[b, 0] = [y, x, 0]
    return {"images": images, "points": points, "instances": inst}


def _items(batch):
    return [{k: v[i] for k, v in batch.items()} for i in range(BATCH)]


def _head(params, classifier_bias=None):
    head = {k: dict(v) for k, v in params["head"].items()}
    if classifier_bias is not None:
        head["classifier"]["bias"] = np.full_like(
            head["classifier"]["bias"], classifier_bias)
    return {"head": head}


def test_click_models_simulated_points_equal_jax(tiny_arch, tmp_path):
    """Iteration 0 of the click simulation runs ``click_models[0]`` (a
    head answering every pixel with background), iteration 1 the live
    weights: the points after one simulated click equal the JAX
    trainer's, the click model's tree shares every frozen tensor with the
    model, and the val step's loss after the clicks equals JAX's."""
    import jax
    import jax.numpy as jnp
    import torch

    batch = _square_batch()
    from isegprobe_torch.models.init_tree import init_tree

    jtr, ttr, params = _trainers(tmp_path, _items(batch),
                                 max_num_next_clicks=1,
                                 click_models=[_head(init_tree(
                                     tiny_config(), 0), -50.0)])
    (state,) = ttr._click_states
    assert sorted({k.split(".")[0] for k in state}) == ["head"]
    own = dict(ttr.model.named_parameters())
    assert all(state[k].data_ptr() != own[k].data_ptr() for k in state)

    jbatch = jtr._prep_batch(batch)
    jb = dict(jbatch, images=jnp.asarray(jbatch["images"],
                                         jnp.float32) / 255.0,
              instances=jnp.asarray(jbatch["instances"], jnp.float32))
    full = {**jtr.params["trainable"], **jtr.params["frozen"]}
    _, jpoints, _ = jtr._simulate_clicks(full, jb, jax.random.PRNGKey(0), 1,
                                         jtr._click_trees)
    tb = ttr._upload(batch)
    with torch.no_grad():
        _, tpoints = ttr._simulate_clicks(tb["images"].float() / 255.0,
                                          tb["instances"].float(),
                                          tb["points"], 1)
    np.testing.assert_array_equal(tpoints.numpy(), np.asarray(jpoints))
    assert (tpoints.numpy() != batch["points"]).any()
    _, _, jloss, _, _, _ = jtr._val_step(
        jtr.params, jtr.opt_state, jbatch, jax.random.PRNGKey(0), 1, 0.4,
        click_trees=jtr._click_trees)
    tloss, _, _ = ttr._step(tb, 1, training=False)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_trainer_click_models_simulation(tiny_arch, tmp_path):
    """``tests/test_trainer.py:137`` on the port: a divergent eval model
    (the head of another seed's init) picks other corrective clicks, so
    the final forward (same weights) sees other point tensors."""
    import torch

    from isegprobe_torch.models.init_tree import init_tree
    from tests.test_torch_training import _items as items_of
    from tests.test_torch_training import tiny_batch

    batch = tiny_batch()
    other = init_tree(tiny_config(), 99)
    _, base, _ = _trainers(tmp_path, items_of(batch), jax_side=False)
    _, ens, _ = _trainers(tmp_path, items_of(batch), jax_side=False,
                          click_models=[_head(other)])
    assert len(ens._click_states) == 1
    seen = {}
    for name, trainer in (("base", base), ("ens", ens)):
        trainer.generator.manual_seed(0)
        forward = trainer._forward

        def spy(images, prev, points, name=name, forward=forward):
            seen[name] = points.clone()
            return forward(images, prev, points)

        trainer._forward = spy
        _, _, (stats, _) = trainer._step(trainer._upload(batch), 2,
                                         training=False)
        assert torch.isfinite(stats).all()
    assert not torch.equal(seen["base"], seen["ens"])


# -- layer-wise decay --------------------------------------------------------------

def _torch_updates(opt_name, tree, **kw):
    """One step of the port's layer-wise decay optimizer on unit gradients
    over ``tree``'s leaves (named as the model's parameters): the new
    leaves, as a dict by flax path."""
    import torch

    from isegprobe_torch.training.optim import make_layerwise_decay_optimizer

    named = []

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                torch_name = ".".join(
                    p.replace("blocks_", "blocks.") for p in path + (k,))
                named.append(("/".join(path + (k,)), torch_name, torch.nn.
                              Parameter(torch.from_numpy(np.array(v)))))

    walk(tree, ())
    opt = make_layerwise_decay_optimizer(
        opt_name, [(n, p) for _, n, p in named], kw.pop("lr"), **kw)
    for _, _, p in named:
        p.grad = torch.ones_like(p)
    opt.step()
    return {f: p.detach().numpy() for f, _, p in named}


def _optax_updates(opt_name, tree, **kw):
    import jax
    import jax.numpy as jnp
    import optax

    from isegprobe_tpu.training.optim import make_layerwise_decay_optimizer

    params = jax.tree.map(jnp.asarray, tree)
    tx = make_layerwise_decay_optimizer(opt_name, kw.pop("lr"), params, **kw)
    updates, _ = tx.update(jax.tree.map(jnp.ones_like, params),
                           tx.init(params), params)
    out = {}
    for tree_out in (updates, optax.apply_updates(params, updates)):
        for path, u in jax.tree_util.tree_flatten_with_path(tree_out)[0]:
            out.setdefault("/".join(str(getattr(k, "key", k))
                                    for k in path), []).append(np.asarray(u))
    return out


@pytest.mark.parametrize("opt_name,kw", [
    ("sgd", dict(lr=1.0, num_layers=2, layer_decay=0.5, momentum=0.0,
                 trainable_prefixes=("backbone", "head"))),
    ("sgd", dict(lr=1.0, num_layers=4, layer_decay=0.5)),
    ("adamw", dict(lr=1e-2, num_layers=4, layer_decay=0.75,
                   weight_decay=0.1)),
    ("adam", dict(lr=1e-2, num_layers=4)),
])
def test_layerwise_decay_matches_optax(opt_name, kw):
    """The layer-wise decay optimizer's first update of every leaf against
    optax's chain (``test_trainer.py:296`` with SGD and no momentum,
    ``test_optim_and_controller.py:9`` with its default momentum, AdamW's
    weight decay scaled with the rest): the BEiT layers of patch_embed,
    blocks_i and the rest of the backbone, 1 for the head."""
    rng = np.random.default_rng(0)

    def leaf(*shape):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)

    depth = kw["num_layers"]
    tree = {"backbone": {"patch_embed": {"proj": {"kernel": leaf(2, 2)}},
                         "blocks_0": {"attn": {"qkv": {"kernel": leaf(2, 2)}}},
                         "blocks_1": {"w": leaf(2)},
                         f"blocks_{depth - 1}": {"attn": {"qkv": {
                             "kernel": leaf(2, 2)}}},
                         "norm": {"scale": leaf(2)}},
            "head": {"classifier": {"kernel": leaf(2, 2)}}}
    got = _torch_updates(opt_name, tree, **dict(kw))
    want = _optax_updates(opt_name, tree, **dict(kw))
    assert got.keys() == want.keys()
    for key, (_, new) in want.items():
        np.testing.assert_allclose(got[key], new, rtol=0, atol=3e-7,
                                   err_msg=key)
    decay = kw.get("layer_decay", 0.75)
    want = {k: v[0] for k, v in want.items()}
    head = want["head/classifier/kernel"]
    if opt_name == "sgd":
        ratio = want["backbone/patch_embed/proj/kernel"] / head
        np.testing.assert_allclose(ratio, decay ** (depth + 1), rtol=1e-5)
        ratio = want["backbone/blocks_0/attn/qkv/kernel"] / head
        np.testing.assert_allclose(ratio, decay ** depth, rtol=1e-5)


def test_trainer_layerwise_decay_flag_wires_and_noops_when_frozen(
        tiny_arch, tmp_path, caplog):
    """``layerwise_decay=True`` builds the decay optimizer; with the frozen
    backbone it warns, every scale is 1, and an epoch trains the click
    encoder and head exactly as without it."""
    from tests.test_torch_training import _items as items_of
    from tests.test_torch_training import tiny_batch

    items = items_of(tiny_batch())
    _, plain, _ = _trainers(tmp_path, items, jax_side=False)
    with caplog.at_level(logging.WARNING, logger="isegprobe_torch"):
        _, decayed, _ = _trainers(tmp_path, items, jax_side=False,
                                  layerwise_decay=True)
    assert "layer-wise decay changes nothing" in caplog.text
    assert {g["lr_scale"] for g in decayed.optimizer.param_groups} == {1.0}
    held = {id(p) for g in decayed.optimizer.param_groups
            for p in g["params"]}
    tops = {n.split(".")[0] for n, p in decayed.model.named_parameters()
            if id(p) in held}
    assert tops == {"embed_coords", "head"}
    for trainer in (plain, decayed):
        trainer.run(num_epochs=1, validation=False)
    a = plain.full_params(("embed_coords", "head"))
    b = decayed.full_params(("embed_coords", "head"))
    import jax

    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.array_equal(x, y)
