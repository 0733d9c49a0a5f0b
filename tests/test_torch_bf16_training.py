"""Mixed-precision (bf16) training and backbone remat of the port against
the JAX package: kernels A, B, D and E's plain backwards in bf16, the dtype
of every module's output under flax's rules, the bf16 train step, remat,
the command line's dtype keys, and the bf16 train-step fixture.

Each test takes the same numpy inputs through the JAX function and its
counterpart in ``isegprobe_torch``. The JAX side is the model built with
``dtype=jnp.bfloat16`` over float32 params (``models/common.py`` under
``training_params.dtype=bfloat16``), not the all-bf16 serving tree of
``tests/test_torch_bf16.py``. Tolerances (measured on the CPU, beside):
- the plain bf16 VJPs against the JAX ``custom_vjp`` backwards on the
  same bf16 inputs: each gradient in its input's dtype, within ``2^-6``
  of its scale (bf16 rounds to 2^-9; the two sides round different
  intermediates; measured at most 2.3e-3 of the scale, D's q gradient);
- module outputs: the dtype of every module that both packages name is
  flax's (no value gate: the probes' logits are held below);
- the tiny flagship's bf16 step against JAX's: loss within ``2^-12``
  relative (measured 2.2e-6), each trainable leaf's gradient within
  relative L2 ``2^-5`` of JAX's (measured at most 0.020) and nearer JAX's
  bf16 gradient than JAX's bf16 gradient is to its f32 one (measured
  ratio at most 0.50), parameters after the Adam step within 2.01 lr;
- remat: gradients equal bitwise to those without remat (the same
  arithmetic, recomputed);
- the full-width steps against the fixture: the loss within ``2^-10``
  relative of JAX's bf16 loss (measured 5.2e-5), the digests as
  ``tests/test_torch_training.py``'s with 64 sign flips (measured 23).

The fixture ``isegprobe_torch/fixtures/synthetic_train_step_bf16.npz``
carries to the GPU machine (no JAX there) the JAX package's full-width
224² bf16 train step of the flagship and LoftUp (batch 8 each) from
``PRNGKey(0)`` at num_iters=0 on the items of ``synthetic_train_step.npz``:
two steps' losses and the trainable leaves' digests. JBU is not in it:
the JAX package's bf16 JBU filter (``jbu_filter_xla``, also the backward
of its fused kernel) raises on a bf16 input (its ``fori_loop`` writes bf16
similarities into a float32 carry), so the JAX package cannot train JBU
in bf16; the port's kernel E backward takes the VJP in float32, as
``_jbu_fused_bwd`` does on float32 inputs. Write it with
``JAX_PLATFORMS=cpu python tests/test_torch_bf16_training.py --export``.
"""

from __future__ import annotations

import re
import sys
import time
from pathlib import Path

import numpy as np
import pytest

if __name__ == "__main__":  # the export runs as a script from the root
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tests.test_torch_families import (  # noqa: E402,F401  (fixture)
    FAMILY_SIZE,
    WIDTH,
    _inputs,
    _jax_probe,
    tiny_archs,
    tiny_config,
)

REPO = Path(__file__).resolve().parents[1]
BF16_FIXTURE = (REPO / "isegprobe_torch" / "fixtures"
                / "synthetic_train_step_bf16.npz")
STEP_FIXTURE = (REPO / "isegprobe_torch" / "fixtures"
                / "synthetic_train_step.npz")
# the scripts the fixture holds, by probe_model.synthetic_config name, with
# the batch each step takes
FIXTURE_BATCHES = {"dinov2_noup": 8, "dinov2_loftup": 8}
VJP_TOL = 2.0**-6
STEP_LOSS_RTOL = 2.0**-12
GRAD_REL_L2 = 2.0**-5
LR = 5e-5
FIXTURE_LOSS_RTOL = 2.0**-10
# elements whose bf16 gradient is rounding noise may take Adam's update of
# the other sign (two steps: up to ~4.4 lr each); bf16's noise is 2^-8, so
# more of them than the f32 step's 10
BF16_FLIPS = 64


# -- the JAX side -------------------------------------------------------------

def export(path=BF16_FIXTURE):
    """JAX's full-width 224² bf16 train step of each script of
    ``FIXTURE_BATCHES`` from ``model.init(PRNGKey(0))`` on the first items
    of ``synthetic_train_step.npz``: two steps at num_iters=0, their losses
    and the trainable leaves' digests after them."""
    import jax

    from tests.test_torch_family_training import (
        jax_script_cfg,
        jax_script_trainer,
    )
    from tests.test_torch_training import digest, jax_synthetic_datasets

    cfg = jax_script_cfg(dtype="bfloat16")
    trainset, valset = jax_synthetic_datasets(cfg)
    out = dict(families=np.asarray(list(FIXTURE_BATCHES)))
    with np.load(STEP_FIXTURE) as fx:
        items = {k: fx[k] for k in ("images", "points", "instances")}
        out["seeds"], out["positions"] = fx["seeds"], fx["positions"]
    for name, batch_size in FIXTURE_BATCHES.items():
        batch = {k: v[:batch_size] for k, v in items.items()}
        t0 = time.time()
        trainer = jax_script_trainer(name, cfg, trainset, valset)
        rng = jax.random.PRNGKey(1)
        losses = []
        for _ in range(2):
            (trainer.params, trainer.opt_state, loss, _, _, _) = \
                trainer._train_step(trainer.params, trainer.opt_state,
                                    trainer._prep_batch(batch), rng, 0, 0.4,
                                    0.025, click_trees=())
            losses.append(float(loss))
        seconds = time.time() - t0
        print(f"{name}: two JAX bf16 steps at batch {batch_size} in "
              f"{seconds:.1f} s, losses {losses}", flush=True)
        dig = digest(jax.device_get(trainer.params["trainable"]))
        out[f"{name}/batch"] = np.int64(batch_size)
        out[f"{name}/losses"] = np.asarray(losses)
        out[f"{name}/digest_names"] = np.asarray(sorted(dig))
        out[f"{name}/digests"] = np.stack([dig[k] for k in sorted(dig)])
        out[f"{name}/export_seconds"] = np.float64(seconds)
        del trainer
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


def _rel_max(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


# -- kernels A, B, D and E: the plain bf16 VJPs -------------------------------

def _bf16(rng, shape, scale=1.0, shift=0.0):
    import torch

    a = rng.standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(torch.bfloat16)


def _jnp(t):
    """A torch tensor as a jnp array of its dtype (bf16 or f32)."""
    import jax.numpy as jnp

    return jnp.asarray(t.float().numpy(), str(t.dtype).removeprefix(
        "torch."))


def _port_vjp(fn, inputs, grad, *args):
    """The port's autograd through ``fn`` (a plain version) at ``grad``."""
    ts = [t.clone().requires_grad_(True) for t in inputs]
    fn(*ts, *args).backward(grad)
    return [t.grad for t in ts]


@pytest.mark.parametrize("kernel", ["mha_qkv", "layernorm", "mha",
                                    "jbu_filter"])
def test_plain_bf16_vjp_matches_jax_custom_vjp_backward(kernel):
    """The backward of each kernel's ``autograd.Function`` (the plain
    version's VJP) on bf16 inputs against the JAX ``custom_vjp`` backward
    on the same inputs: gradient dtypes equal the inputs', values within
    VJP_TOL of their scale. E: JAX's backward raises on bf16 inputs, so
    the port is held against it on the inputs cast to float32 (what the
    port's E backward computes), its hr and proj gradients cast back."""
    import jax.numpy as jnp
    import torch

    from isegprobe_torch.ops import attention, jbu, layernorm
    from isegprobe_tpu.ops import attention as jatt
    from isegprobe_tpu.ops import jbu_kernel as jjbu
    from isegprobe_tpu.ops import layernorm as jln

    rng = np.random.default_rng(11)
    if kernel == "mha_qkv":
        heads, dh = 3, 64
        inputs = [_bf16(rng, (2, 57, 3 * heads * dh))]
        grad = _bf16(rng, (2, 57, heads * dh))
        got = _port_vjp(attention._mha_qkv_plain, inputs, grad, heads,
                        dh**-0.5)
        want = jatt._mha_qkv_pallas_ad_bwd(heads, dh**-0.5, True,
                                           (_jnp(inputs[0]),), _jnp(grad))
    elif kernel == "layernorm":
        inputs = [_bf16(rng, (4, 33, 384), 2.0, 0.5),
                  torch.from_numpy(rng.standard_normal(384).astype(
                      np.float32) * 0.5 + 1),
                  torch.from_numpy(rng.standard_normal(384).astype(
                      np.float32))]
        grad = _bf16(rng, (4, 33, 384))
        got = _port_vjp(layernorm._ln_plain, inputs, grad, 1e-6)
        want = jln._ln_pallas_ad_bwd(1e-6, True, tuple(
            _jnp(t) for t in inputs), _jnp(grad))
    elif kernel == "mha":
        inputs = [_bf16(rng, (2, 150, 4, 101)), _bf16(rng, (2, 49, 4, 101)),
                  _bf16(rng, (2, 49, 4, 101))]
        grad = _bf16(rng, (2, 150, 4, 101))
        got = _port_vjp(attention._mha_plain, inputs, grad, 101**-0.5)
        want = jatt._mha_pallas_ad_bwd(101**-0.5, True, tuple(
            _jnp(t) for t in inputs), _jnp(grad))
    else:
        inputs = [_bf16(rng, (2, 24, 20, 12)), _bf16(rng, (2, 24, 20, 8),
                                                     0.5),
                  torch.tensor(0.5), torch.tensor(0.8)]
        grad = _bf16(rng, (2, 24, 20, 12))
        # the port's E backward: the plain float32 VJP at the f32 gradient
        got = _port_vjp(jbu._jbu_plain_f32, inputs, grad.float())
        residuals = tuple(_jnp(t) for t in inputs)
        with pytest.raises(TypeError):
            jjbu._jbu_fused_bwd(residuals, residuals[0])
        want = jjbu._jbu_fused_bwd(tuple(
            r.astype(jnp.float32) for r in residuals), _jnp(grad))
        want = [w.astype(r.dtype) for w, r in zip(want, residuals)]
    assert len(got) == len(want) == len(inputs)
    for g, w, t in zip(got, want, inputs):
        assert g.dtype == t.dtype
        assert str(w.dtype) == str(t.dtype).removeprefix("torch.")
        err = _rel_max(g.float().numpy(), np.asarray(w, np.float32))
        assert err <= VJP_TOL, (kernel, tuple(t.shape), err)


# -- module output dtypes ------------------------------------------------------

# the probes of the dtype check: synthetic_config name -> size
DTYPE_FAMILIES = {"dinov2_noup": 56, "dinov2_loftup": 56, "dinov2_jbu": 56,
                  "dinov2_lift": FAMILY_SIZE["dinov2_lift"],
                  "maskclip_noup": FAMILY_SIZE["maskclip_noup"],
                  "vit_noup": FAMILY_SIZE["vit_noup"],
                  "dinov2_simplevit": FAMILY_SIZE["dinov2_simplevit"]}
# modules named in both packages, at least (measured)
DTYPE_COMMON = {"dinov2_noup": 30, "dinov2_loftup": 63, "dinov2_jbu": 34,
                "dinov2_lift": 47, "maskclip_noup": 19, "vit_noup": 18,
                "dinov2_simplevit": 49}


def bf16_config(family: str, size: int) -> dict:
    """``tiny_config`` with LoftUp at the tiny width and banded at 56², and
    the JAX JBU filter through its Pallas kernel in interpret mode (its
    XLA form raises on bf16)."""
    cfg = tiny_config(family, size)
    up = cfg["upsampler_cfg"]["params"]
    if family == "dinov2_loftup":
        up.update(n_dim=WIDTH, query_chunk_rows=16, query_chunk_min_pixels=0)
    if family == "dinov2_jbu":
        up["impl"] = "pallas_interpret"
    return cfg


def _flax_dtypes(intermediates) -> dict:
    """Output dtype of every flax module's ``__call__``, by path."""
    import jax

    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(intermediates)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if len(keys) >= 2 and keys[-2] == "__call__":
            out[tuple(keys[:-2])] = str(v.dtype)
    return out


def _port_name(path: tuple, names: set) -> str | None:
    """The port's module name of a flax path: ``blocks_0`` is ``blocks.0``
    where the port holds a list, else the name as it is."""
    indexed = ".".join(re.sub(r"_(\d+)$", r".\1", p) for p in path)
    for name in (indexed, ".".join(path)):
        if name in names:
            return name
    return None


@pytest.mark.parametrize("family", list(DTYPE_FAMILIES))
def test_module_output_dtypes_match_flax_bf16_training(tiny_archs, family):
    """Every module's output dtype in the bf16 training model (f32 params,
    ``dtype=bfloat16``) equals flax's: LayerScale's and FrozenBatchNorm's
    raw f32 params promote, the heads compute in f32; the logits are
    float32 and within 2^-5 of JAX's bf16 logits' scale."""
    import jax
    import jax.numpy as jnp
    import torch

    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel

    size = DTYPE_FAMILIES[family]
    cfg = bf16_config(family, size)
    jmodel, params = _jax_probe(cfg, size, dtype=jnp.bfloat16)
    image, points = _inputs(size)
    out, state = jax.jit(lambda p: jmodel.apply(
        {"params": p}, image, points, capture_intermediates=True))(params)
    flax = _flax_dtypes(state["intermediates"])
    model = load_jax_params(iSegProbeModel(**cfg, device="cpu",
                                           dtype=torch.bfloat16), params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    port = {}

    def hook(name):
        def record(module, args, output):
            if torch.is_tensor(output):
                port[name] = str(output.dtype).removeprefix("torch.")
        return record

    handles = [m.register_forward_hook(hook(n))
               for n, m in model.named_modules() if n]
    with torch.no_grad():
        got = model(torch.from_numpy(image), torch.from_numpy(points))
    for h in handles:
        h.remove()
    pairs = {}
    for path, dtype in flax.items():
        name = _port_name(path, set(port))
        if name is not None:
            pairs[name] = (dtype, port[name])
    bad = {k: v for k, v in pairs.items() if v[0] != v[1]}
    assert not bad, bad
    assert len(pairs) >= DTYPE_COMMON[family], sorted(pairs)
    assert "bfloat16" in {v[0] for v in pairs.values()}
    want = np.asarray(out["instances"], np.float32)
    assert out["instances"].dtype == jnp.float32
    assert got["instances"].dtype == torch.float32
    assert _rel_max(got["instances"].numpy(), want) <= 2.0**-5


# -- the train step -----------------------------------------------------------

@pytest.fixture
def bf16_pair(tmp_path):
    """JAX bf16 and f32 trainers and a port bf16 trainer of the tiny
    flagship (``tests/test_torch_training.py``'s 2-block, 96-wide arch),
    from the same params."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch

    from isegprobe_torch.models.featurizers import dinov2 as t_dinov2
    from isegprobe_torch.models.probe_model import iSegProbeModel as TModel
    from isegprobe_torch.training.losses import \
        NormalizedFocalLossSigmoid as TNFL
    from isegprobe_torch.training.trainer import iSegTrainer as TTrainer
    from isegprobe_tpu.models.featurizers import dinov2 as j_dinov2
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel
    from isegprobe_tpu.parallel.mesh import make_mesh
    from isegprobe_tpu.training.losses import \
        NormalizedFocalLossSigmoid as JNFL
    from isegprobe_tpu.training.trainer import iSegTrainer as JTrainer
    from tests import test_torch_training as tt

    mp = pytest.MonkeyPatch()
    for mod in (j_dinov2, t_dinov2):
        mp.setitem(mod.DINOV2_ARCHS, tt.TINY, dataclasses.replace(
            mod.DINOV2_ARCHS["dinov2_vits14"], embed_dim=tt.WIDTH, depth=2,
            num_heads=2))
    torch.set_num_threads(4)
    items = tt._items(tt.tiny_batch())
    opt = {"lr": LR, "betas": (0.9, 0.999), "eps": 1e-8}

    def jax_trainer(**kw):
        return JTrainer(JModel(**tt.tiny_config(), attn_impl="jnp", **kw),
                        tt._ns_cfg(tmp_path),
                        {"instance_loss": JNFL(alpha=0.5, gamma=2),
                         "instance_loss_weight": 1.0},
                        tt.ListDataset(items), tt.ListDataset(items),
                        optimizer="adam", optimizer_params=dict(opt),
                        max_num_next_clicks=2, seed=0,
                        mesh=make_mesh(n_devices=1))

    jtr, jf32 = jax_trainer(dtype=jnp.bfloat16), jax_trainer()
    p = jax.device_get(jtr.params)
    params = tt._numpy_tree({**p["trainable"], **p["frozen"]})
    ttr = TTrainer(TModel(**tt.tiny_config(), device="cpu",
                          dtype=torch.bfloat16), tt._ns_cfg(tmp_path),
                   {"instance_loss": TNFL(alpha=0.5, gamma=2),
                    "instance_loss_weight": 1.0},
                   tt.ListDataset(items), tt.ListDataset(items),
                   optimizer="adam", optimizer_params=dict(opt),
                   max_num_next_clicks=2, seed=0, params=params,
                   device="cpu")
    yield jtr, jf32, ttr, params
    mp.undo()


def test_bf16_train_step_matches_jax(bf16_pair):
    """One bf16 step at num_iters=0: the loss and each trainable leaf's
    gradient against JAX's bf16 ``iSegTrainer`` (its jitted gradient and
    ``_train_step``), nearer JAX's bf16 gradient than JAX's f32 gradient
    is; the master weights, Adam's moments and the params after the step
    stay float32, the step moves them as JAX's does."""
    import jax
    import jax.numpy as jnp
    import torch

    from isegprobe_torch.models.convert import state_dict_to_jax_params
    from tests.test_torch_training import tiny_batch

    jtr, jf32, ttr, params = bf16_pair
    batch = tiny_batch()
    images = jnp.asarray(batch["images"], jnp.float32) / 255.0
    inst = jnp.asarray(batch["instances"], jnp.float32)
    prev = jnp.zeros((*images.shape[:3], 1), jnp.float32)
    frozen = jtr.params["frozen"]

    def grads_of(trainer):
        def loss_fn(trainable):
            out = trainer._forward({**trainable, **frozen}, images, prev,
                                   jnp.asarray(batch["points"]))
            return trainer._loss(out, {"instances": inst})[0]
        return jax.device_get(jax.jit(jax.grad(loss_fn))(
            jtr.params["trainable"]))

    jgrads, fgrads = grads_of(jtr), grads_of(jf32)
    (jtr.params, jtr.opt_state, jloss, _, _, _) = jtr._train_step(
        jtr.params, jtr.opt_state, jtr._prep_batch(batch),
        jax.random.PRNGKey(0), 0, 0.4, 0.025, click_trees=())
    tloss, _, _ = ttr._step(ttr._upload(batch), 0)
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=STEP_LOSS_RTOL)
    tgrads = {n: p.grad for n, p in ttr.model.named_parameters()
              if p.grad is not None}
    assert all(g.dtype == torch.float32 for g in tgrads.values())
    tops = ("embed_coords", "head")
    tg = state_dict_to_jax_params(tgrads, {k: params[k] for k in tops})
    for top in tops:
        for got, want, f32 in zip(jax.tree.leaves(tg[top]),
                                  jax.tree.leaves(jgrads[top]),
                                  jax.tree.leaves(fgrads[top])):
            err = _rel_l2(got, want)
            assert err <= GRAD_REL_L2, (top, err)
            assert err < _rel_l2(want, f32), (top, err, _rel_l2(want, f32))
    assert all(v.dtype == torch.float32 for s in ttr.optimizer.state.values()
               for v in s.values() if torch.is_tensor(v) and v.dim())
    got = ttr.full_params(tops)
    want = jax.device_get(jtr.params["trainable"])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=2.01 * LR)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_gradients_equal_those_without(tiny_archs, monkeypatch,
                                             dtype):
    """The ``dinov2`` and ``vit`` backbones with ``remat_blocks``: the
    click encoder's and head's gradients equal those without remat, every
    block runs again in the backward, and the forward is unchanged."""
    import torch

    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.models.vit import Block

    torch.manual_seed(0)
    for family in ("dinov2_noup", "vit_noup"):
        size = DTYPE_FAMILIES[family]
        cfg = tiny_config(family, size)
        _, params = _jax_probe(cfg, size)
        image, points = (torch.from_numpy(a) for a in _inputs(size))
        grads, calls = [], []
        for remat in (False, True):
            c = dict(cfg, backbone_cfg=dict(cfg["backbone_cfg"], params=dict(
                cfg["backbone_cfg"]["params"], remat_blocks=remat)))
            model = load_jax_params(iSegProbeModel(
                **c, device="cpu", dtype=getattr(torch, dtype)), params)
            for name, p in model.named_parameters():
                p.requires_grad_(not name.startswith("backbone"))
            n = [0]
            forward = Block.forward

            def counted(self, *args, **kwargs):
                n[0] += 1
                return forward(self, *args, **kwargs)

            monkeypatch.setattr(Block, "forward", counted)
            out = model(image, points)["instances"]
            forward_calls = n[0]
            out.square().mean().backward()
            calls.append((forward_calls, n[0]))
            monkeypatch.setattr(Block, "forward", forward)
            grads.append((out.detach(), {k: p.grad.clone() for k, p in
                                         model.named_parameters()
                                         if p.grad is not None}))
        (o0, g0), (o1, g1) = grads
        assert torch.equal(o0, o1)
        assert g0.keys() == g1.keys() and g0
        for k in g0:
            assert torch.equal(g0[k], g1[k]), (family, k)
        depth = 2 - (family == "vit_noup")  # the key probe stops before
        assert calls == [(depth, depth), (depth, 2 * depth)], calls


# -- the command line -------------------------------------------------------------

def test_train_cli_dtype_keys():
    import torch

    from isegprobe_torch.train import model_kwargs, parse_args, train_dtype

    for text, want in (("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16),
                       ("float32", None), ("f32", None)):
        cfg = parse_args(["model=synthetic_dinov2_noup",
                          f"training_params.dtype={text}"])
        assert train_dtype(cfg) == want
    for bad in ("float16", "fp16", "int8"):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            parse_args(["model=synthetic_dinov2_noup",
                        f"training_params.dtype={bad}"])
    for model, remat in (("synthetic_dinov2_noup", True),
                         ("synthetic_vit_noup", True),
                         ("synthetic_maskclip_noup", False)):
        cfg = parse_args([f"model={model}",
                          "training_params.remat_backbone=true"])
        params = model_kwargs(cfg)["backbone_cfg"]["params"]
        assert params.get("remat_blocks", False) is remat


def test_bf16_cli_writes_float32_checkpoints_jax_reads(tmp_path):
    """``python -m isegprobe_torch.train training_params.dtype=bfloat16
    training_params.remat_backbone=true device=cpu``: two steps; the
    checkpoint holds float32 leaves, no dtype in its config (the JAX
    package's config of the same script under remat), and the JAX
    package's ``load_checkpoint`` reads it bitwise."""
    import jax

    from isegprobe_torch import train
    from isegprobe_torch.utils.serialization import load_checkpoint
    from isegprobe_tpu.utils.serialization import \
        load_checkpoint as jax_load_checkpoint
    from isegprobe_tpu.utils.serialization import model_config
    from models.common import init_model_from_modules_cfg
    from tests.test_torch_training import _dinov2_noup, jax_cfg

    out = tmp_path / "exp"
    assert train.main(["model=synthetic_dinov2_noup", "device=cpu",
                       "training_params.crop_size=[56,56]",
                       "training_params.dtype=bfloat16",
                       "training_params.remat_backbone=true",
                       "dataloader.batch_size=2",
                       "dataloader.val_batch_size=2", "epoch_len=4",
                       "val_epoch_len=2", "training_params.epochs=1",
                       "dataloader.workers=0", f"exp_path={out}"]) == 0
    (ckpt,) = out.glob("*/*/000_*/checkpoints/last_checkpoint.ckpt")
    params, config, extra = load_checkpoint(ckpt)
    jparams, jconfig, _ = jax_load_checkpoint(ckpt)
    assert config == jconfig and "dtype" not in config["params"]
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(jparams)):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    jcfg = jax_cfg(crop_size=[56, 56], dtype="bfloat16", remat_backbone=True)
    jmodel = init_model_from_modules_cfg(
        _dinov2_noup().define_modules_cfg(jcfg), jcfg)
    assert config == model_config(jmodel)


# -- the fixture of the GPU check -------------------------------------------------

@pytest.fixture(scope="module")
def bf16_fixture():
    with np.load(BF16_FIXTURE) as data:
        return dict(data)


def test_bf16_fixture_is_consistent(bf16_fixture):
    """Size, keys, the items' seeds (``synthetic_train_step.npz``'s), and
    JAX's bf16 losses near its f32 ones on the same items."""
    fx = bf16_fixture
    assert BF16_FIXTURE.stat().st_size <= 2**20
    assert list(fx["families"]) == list(FIXTURE_BATCHES)
    with np.load(STEP_FIXTURE) as step:
        np.testing.assert_array_equal(fx["seeds"], step["seeds"])
        f32_losses = step["losses"]
    for name, batch in FIXTURE_BATCHES.items():
        assert int(fx[f"{name}/batch"]) == batch
        assert fx[f"{name}/losses"].shape == (2,)
        assert np.isfinite(fx[f"{name}/digests"][:, :2]).all()
    np.testing.assert_allclose(fx["dinov2_noup/losses"], f32_losses,
                               rtol=2.0**-6)


def step_against_bf16_fixture(fx, name: str, device="cpu"):
    """The port's full-width 224² bf16 step of ``name`` from
    ``init_tree(config, 0)`` on the fixture's items at num_iters=0, twice:
    (losses, digests by name). ``chip_smoke.py`` runs the same on
    the card."""
    import tempfile
    import warnings

    from isegprobe_torch.train import build_trainer, parse_args
    from tests.test_torch_training import digest

    batch = int(fx[f"{name}/batch"])
    with np.load(STEP_FIXTURE) as step, warnings.catch_warnings(), \
            tempfile.TemporaryDirectory() as tmp:  # the run directory
        warnings.simplefilter("ignore")  # LoftUp's missing upsampler_path
        items = {k: step[k][:batch] for k in ("images", "points",
                                              "instances")}
        trainer = build_trainer(parse_args([
            f"model=synthetic_{name}", f"device={device}",
            "dataloader.workers=0", "training_params.dtype=bfloat16",
            f"exp_path={tmp}"]))
    batch = trainer._upload(items)
    losses = [float(trainer._step(batch, 0)[0]) for _ in range(2)]
    return losses, digest(trainer.full_params(("embed_coords", "head")))


def check_against_bf16_fixture(fx, name: str, losses, dig) -> None:
    """The losses within FIXTURE_LOSS_RTOL of JAX's bf16 losses and every
    trainable leaf's digest within ``tests/test_torch_training.py``'s
    tolerances, with BF16_FLIPS elements that took Adam's update of the
    other sign (measured on the CPU, flagship: losses within 5.2e-5, sums
    and norms within 5.0e-3 of the 225,792-element patch kernel's sum, 23
    flips' worth, first values within 1.0e-4)."""
    from tests.test_torch_training import DIGEST_ATOL, DIGEST_RTOL

    np.testing.assert_allclose(losses, fx[f"{name}/losses"],
                               rtol=FIXTURE_LOSS_RTOL)
    assert sorted(dig) == list(fx[f"{name}/digest_names"])
    for key, want in zip(fx[f"{name}/digest_names"], fx[f"{name}/digests"]):
        got = dig[str(key)]
        np.testing.assert_allclose(
            got[:2], want[:2], rtol=0,
            atol=DIGEST_RTOL * want[1] + BF16_FLIPS * 4.4 * LR)
        np.testing.assert_allclose(got[2:], want[2:], rtol=0,
                                   atol=DIGEST_ATOL)


def test_cpu_bf16_flagship_step_matches_the_fixture(bf16_fixture):
    losses, dig = step_against_bf16_fixture(bf16_fixture, "dinov2_noup")
    check_against_bf16_fixture(bf16_fixture, "dinov2_noup", losses, dig)


@pytest.mark.skipif("not __import__('os').environ.get('RUN_SLOW')",
                    reason="the full-width CPU bf16 LoftUp step, ~3 min "
                    "(RUN_SLOW=1)")
def test_cpu_bf16_loftup_step_matches_the_fixture(bf16_fixture):
    losses, dig = step_against_bf16_fixture(bf16_fixture, "dinov2_loftup")
    check_against_bf16_fixture(bf16_fixture, "dinov2_loftup", losses, dig)


if __name__ == "__main__":
    if "--export" not in sys.argv[1:]:
        sys.exit("usage: JAX_PLATFORMS=cpu python "
                 "tests/test_torch_bf16_training.py --export")
    export()
