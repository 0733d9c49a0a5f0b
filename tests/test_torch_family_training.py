"""Training the other Synthetic probes with the port against the JAX
package: kernels D and E under autograd (their backward bodies against the
JAX ``custom_vjp`` backwards), LoftUp's checkpointed slabs, the LoftUp and
JBU train steps, every ``models/synthetic/`` script through the command
line, and the families' train-step fixture.

Each test takes the same numpy inputs through the JAX function and its
counterpart in ``isegprobe_torch``. Tolerances:
- the plain D and E backwards against ``_mha_pallas_ad_bwd`` and
  ``_jbu_fused_bwd``: 2e-5 absolute (times the gradient's scale where it
  exceeds 1) + 2e-5 relative (the two sides sum in other orders);
- LoftUp's checkpointed banded gradient against its monolithic one: 1e-5
  of the gradient's scale (the same arithmetic in slabs); against JAX's
  banded VJP (``nn.remat`` of the slab, jitted): 1e-4 of the scale (f32
  through two attention layers' backwards in other orders);
- the tiny LoftUp and JBU probes' train steps against the JAX trainer's
  jitted ``_train_step``: each step's loss within 1e-5 relative, the first
  step's trainable gradients (JAX's jitted ``grad``) within 1e-4 of each
  leaf's largest gradient, and after the first Adam step every parameter
  within 5e-7, except where JAX's gradient is below 1e-3 of the leaf's
  largest: Adam's first update is lr·sign(g) wherever |g| >> eps, so an
  element whose gradient is within its rounding noise of zero may step
  either way (measured: at most 3.9e-4 of the largest at such elements);
- the full-width steps against the fixture: ``tests/test_torch_training.py``'s
  ``STEP_LOSS_RTOL``, ``DIGEST_RTOL``, ``DIGEST_ATOL`` and ``STEP_FLIPS``
  (measured on the CPU: losses within 5.4e-6 relative, sums and norms
  within half their tolerance).

The fixture ``isegprobe_torch/fixtures/synthetic_train_step_families.npz``
carries to the GPU machine (no JAX there) the JAX package's full-width 224²
train step for ``models/synthetic/dinov2_loftup.py`` and
``dinov2_jbu.py`` from ``PRNGKey(0)``: two steps at num_iters=0 on the
batch of ``synthetic_train_step.npz`` (its seeds, not its images again),
each step's loss and, per trainable leaf, its sum, L2 norm and first 16
values. Write it with ``JAX_PLATFORMS=cpu python
tests/test_torch_family_training.py --export``.
"""

from __future__ import annotations

import functools
import importlib.util
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_upsamplers import tiny_arch  # noqa: F401  (fixture)

REPO = Path(__file__).resolve().parents[1]
FAMILY_FIXTURE = (REPO / "isegprobe_torch" / "fixtures"
                  / "synthetic_train_step_families.npz")
STEP_FIXTURE = (REPO / "isegprobe_torch" / "fixtures"
                / "synthetic_train_step.npz")
# the scripts of models/synthetic/ the fixture holds, by their
# probe_model.synthetic_config names
FIXTURE_FAMILIES = ("dinov2_loftup", "dinov2_jbu")
# items of the train-step fixture's batch the families' steps take
FIXTURE_BATCH = 8


def load_script(name: str):
    """``models/synthetic/<name>.py`` as a module."""
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location(
        f"isegprobe_models_synthetic_{name}",
        REPO / "models" / "synthetic" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_script_cfg(**training_params):
    """``tests/test_torch_training.py:jax_cfg`` with ``configs/
    main_cfg.yaml``'s upsampler paths, which the LoftUp and LiFT scripts
    read."""
    from tests.test_torch_training import jax_cfg

    from isegprobe_tpu.utils.config import EDict

    cfg = jax_cfg(**training_params)
    cfg["UPSAMPLERS"] = EDict(LOFTUP="/weights/loftup.pth",
                              LIFT="/weights/lift.pth")
    return cfg


def jax_script_trainer(name: str, cfg, trainset, valset):
    """The JAX trainer of ``models/synthetic/<name>.py`` as
    ``models/common.py:train`` builds it, on one device."""
    from models.common import init_model_from_modules_cfg
    from models.defaults import get_loss_cfg, get_optimizer_cfg

    from isegprobe_tpu.parallel.mesh import make_mesh
    from isegprobe_tpu.training.metrics import AdaptiveIoU
    from isegprobe_tpu.training.trainer import iSegTrainer

    model = init_model_from_modules_cfg(
        load_script(name).define_modules_cfg(cfg), cfg)
    opt_name, opt = get_optimizer_cfg(cfg)
    return iSegTrainer(
        model, cfg, get_loss_cfg(cfg), trainset, valset, optimizer=opt_name,
        optimizer_params=opt,
        lr_scheduler={"milestones": cfg.training_params.lr_milestones,
                      "gamma": 0.1},
        metrics=[AdaptiveIoU()], max_interactive_points=24,
        max_num_next_clicks=3, seed=0, mesh=make_mesh(n_devices=1))


def export(path=FAMILY_FIXTURE, batch_size=FIXTURE_BATCH):
    """JAX's full-width 224² train step of each of ``FIXTURE_FAMILIES``
    from ``model.init(PRNGKey(0))`` on the first ``batch_size`` items of
    ``synthetic_train_step.npz``: two steps at num_iters=0, their losses
    and the trainable leaves' digests after them."""
    import jax

    from tests.test_torch_training import digest, jax_synthetic_datasets

    with np.load(STEP_FIXTURE) as fx:
        batch = {k: fx[k][:batch_size] for k in ("images", "points",
                                                  "instances")}
        seeds, positions = fx["seeds"][:batch_size], fx["positions"][
            :batch_size]
    cfg = jax_script_cfg()
    trainset, valset = jax_synthetic_datasets(cfg)
    out = dict(seeds=seeds, positions=positions,
               families=np.asarray(FIXTURE_FAMILIES))
    for name in FIXTURE_FAMILIES:
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
        print(f"{name}: two JAX steps at batch {batch_size} in "
              f"{seconds:.1f} s, losses {losses}", flush=True)
        dig = digest(jax.device_get(trainer.params["trainable"]))
        out[f"{name}/losses"] = np.asarray(losses)
        out[f"{name}/digest_names"] = np.asarray(sorted(dig))
        out[f"{name}/digests"] = np.stack([dig[k] for k in sorted(dig)])
        out[f"{name}/export_seconds"] = np.float64(seconds)
        del trainer
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes)")



def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=BWD_TOL,
                               atol=BWD_TOL * max(1.0,
                                                  float(np.abs(want).max())))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


# -- kernels D and E: the backward bodies against the JAX backwards ----------

BWD_TOL = 2e-5


def _plain_d(q, k, v, scale, plan):
    from isegprobe_torch.ops import attention

    return attention._mha_plain(q, k, v, scale)


def _plain_e(hr, proj, temp, sigma):
    from isegprobe_torch.ops import jbu

    return jbu._jbu_plain(hr, proj, temp, sigma)


@pytest.mark.parametrize("b,nq,nk,heads,dh", [
    (2, 300, 77, 4, 101), (1, 129, 200, 2, 101), (2, 64, 1, 3, 13)])
def test_mha_backward_matches_jax(monkeypatch, b, nq, nk, heads, dh):
    """``MhaKernel`` (with the plain forward patched in for kernel D, so
    its backward runs as on the card) against ``_mha_pallas_ad_bwd``, the
    JAX custom VJP's backward, at LoftUp's dh = 101 and key counts that are
    no multiple of a tile."""
    import jax.numpy as jnp
    import torch

    from isegprobe_torch.ops import attention
    from isegprobe_tpu.ops.attention import _mha_pallas_ad_bwd

    monkeypatch.setattr(attention, "_mha_cuda", _plain_d)
    rng = np.random.default_rng(nq + nk)
    q, k, v = (rng.standard_normal((b, n, heads, dh), np.float32)
               for n in (nq, nk, nk))
    g = rng.standard_normal(q.shape, np.float32)
    scale = dh**-0.5
    want = _mha_pallas_ad_bwd(scale, False, tuple(map(jnp.asarray,
                                                      (q, k, v))),
                              jnp.asarray(g))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    attention.MhaKernel.apply(*ts, scale, None).backward(torch.from_numpy(g))
    for t, w in zip(ts, want):
        _close(t.grad, w)


@pytest.mark.parametrize("b,h,w,c,k", [(2, 9, 13, 8, 4), (1, 16, 20, 24, 32)])
def test_jbu_backward_matches_jax(monkeypatch, b, h, w, c, k):
    """``JbuKernel`` (the plain forward patched in for kernel E) against
    ``_jbu_fused_bwd``: all four gradients, ``d temp`` and ``d sigma``
    among them (the JAX VJP returns them: they are parameters)."""
    import jax.numpy as jnp
    import torch

    from isegprobe_torch.ops import jbu
    from isegprobe_tpu.ops.jbu_kernel import _jbu_fused_bwd

    monkeypatch.setattr(jbu, "_jbu_cuda", _plain_e)
    rng = np.random.default_rng(h * w)
    hr = rng.standard_normal((b, h, w, c), np.float32)
    proj = rng.standard_normal((b, h, w, k), np.float32) * 0.5
    temp, sigma = np.float32(0.5), np.float32(0.8)
    g = rng.standard_normal(hr.shape, np.float32)
    want = _jbu_fused_bwd(tuple(map(jnp.asarray, (hr, proj, temp, sigma))),
                          jnp.asarray(g))
    ts = [torch.from_numpy(np.asarray(x)).requires_grad_(True)
          for x in (hr, proj, temp, sigma)]
    jbu.JbuKernel.apply(*ts).backward(torch.from_numpy(g))
    for t, wnt in zip(ts, want):
        assert t.grad.shape == tuple(np.shape(wnt))
        _close(t.grad, wnt)


@pytest.mark.parametrize("kernel", ["D", "E"])
def test_kernel_function_plumbing(monkeypatch, kernel):
    """``MhaKernel`` and ``JbuKernel`` with the plain forward patched in for
    the kernel: the forward equals the no-grad output bitwise, the kernel
    runs with grad mode off, only the inputs that need a gradient get one
    (in the dtype the caller passed: k and v in bf16 beside an f32 q), and
    each equals autograd's through the plain version."""
    import torch

    from isegprobe_torch.ops import attention, jbu

    calls = []
    plain = _plain_d if kernel == "D" else _plain_e

    def fake(*args):
        calls.append(torch.is_grad_enabled())
        return plain(*args)

    rng = np.random.default_rng(7)
    if kernel == "D":
        monkeypatch.setattr(attention, "_mha_cuda", fake)
        q = torch.from_numpy(rng.standard_normal((2, 40, 2, 13), np.float32))
        kv = [torch.from_numpy(rng.standard_normal((2, 21, 2, 13),
                                                   np.float32)).bfloat16()
              for _ in range(2)]
        inputs, needs = [q, *kv], [(True, True, True), (False, True, False)]

        def apply(*ts):
            return attention.MhaKernel.apply(*ts, 13**-0.5, None)

        def reference(*ts):
            return attention._mha_plain(*ts, 13**-0.5)
    else:
        monkeypatch.setattr(jbu, "_jbu_cuda", fake)
        inputs = [torch.from_numpy(rng.standard_normal(s, np.float32))
                  for s in ((1, 8, 9, 6), (1, 8, 9, 3))]
        inputs += [torch.tensor(0.3), torch.tensor(0.9)]
        needs = [(True, False, False, False), (True, True, True, True)]

        def apply(*ts):
            return jbu.JbuKernel.apply(*ts)

        reference = jbu._jbu_plain
    with torch.no_grad():
        ref = reference(*inputs)
    for need in needs:
        ts = [x.clone().requires_grad_(n) for x, n in zip(inputs, need)]
        out = apply(*ts)
        assert torch.equal(out.detach(), ref)
        g = torch.from_numpy(rng.standard_normal(out.shape, np.float32))
        out.backward(g)
        rs = [x.clone().requires_grad_(n) for x, n in zip(inputs, need)]
        reference(*rs).backward(g)
        for t, r, n in zip(ts, rs, need):
            assert (t.grad is None) == (not n)
            if n:
                assert t.grad.dtype == t.dtype
                torch.testing.assert_close(t.grad, r.grad, rtol=1e-6,
                                           atol=1e-6)
    assert calls == [False] * len(needs)


def test_wrappers_route_cpu_tensors_to_the_plain_versions():
    """On a CPU tensor ``mha`` and ``jbu_filter`` compute the plain
    versions, autograd flows through them (to ``temp`` and ``sigma`` too)
    and no launch is counted."""
    import torch

    from isegprobe_torch.ops import attention, jbu

    before = (attention.mha.launches, jbu.jbu_filter.launches)
    q = torch.randn(1, 7, 2, 101, requires_grad=True)
    attention.mha(q, q.detach(), q.detach()).sum().backward()
    hr = torch.randn(1, 6, 6, 4, requires_grad=True)
    temp = torch.tensor(0.0, requires_grad=True)
    sigma = torch.tensor(1.0, requires_grad=True)
    jbu.jbu_filter(hr, torch.randn(1, 6, 6, 2), temp, sigma).square(
    ).sum().backward()
    assert q.grad is not None and hr.grad is not None
    assert temp.grad is not None and sigma.grad is not None
    assert (attention.mha.launches, jbu.jbu_filter.launches) == before


# -- LoftUp's checkpointed slabs ----------------------------------------------

def test_loftup_checkpointed_slabs_match_monolithic_and_jax():
    """Under autograd LoftUp's banded slabs (56 rows in 2 slabs of 28) are
    checkpointed: each slab body runs again in the backward, and the
    source's gradient equals the monolithic path's and JAX's
    banded VJP (``nn.remat`` of the slab body). Without grad the slabs run
    once."""
    import jax
    import jax.numpy as jnp
    import torch

    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.upsamplers.loftup import LoftUpUpsampler
    from isegprobe_tpu.models.upsamplers.loftup import LoftUpUpsampler as JL

    from tests.test_torch_upsamplers import _loftup_params

    src, img, params = _loftup_params(32, seed=2)
    banded_kw = dict(query_chunk_rows=28, query_chunk_min_pixels=0)
    g = np.random.default_rng(3).standard_normal(
        (2, 56, 56, 32)).astype(np.float32)
    jmodel = JL(n_dim=32, attn_impl="jnp", **banded_kw)
    _, vjp = jax.vjp(lambda s: jmodel.apply({"params": params}, s,
                                            jnp.asarray(img)),
                     jnp.asarray(src))
    want = np.asarray(jax.jit(vjp)(jnp.asarray(g))[0])
    banded = load_jax_params(LoftUpUpsampler(n_dim=32, **banded_kw), params)
    mono = load_jax_params(LoftUpUpsampler(n_dim=32, query_chunk_rows=0),
                           params)
    for p in (*banded.parameters(), *mono.parameters()):
        p.requires_grad_(False)
    calls = []
    body = banded._slab

    def counted(*args):
        calls.append(torch.is_grad_enabled())
        return body(*args)

    banded._slab = counted
    grads = []
    for model in (banded, mono):
        s = torch.from_numpy(src).requires_grad_(True)
        model(s, torch.from_numpy(img)).backward(torch.from_numpy(g))
        grads.append(s.grad.numpy())
    # the forward, then the backward's recompute of each slab
    assert calls == [True] * 4
    scale = float(np.abs(grads[1]).max())
    np.testing.assert_allclose(grads[0], grads[1], rtol=0, atol=1e-5 * scale)
    assert _rel(grads[0], want) <= 1e-4
    calls.clear()
    with torch.no_grad():
        banded(torch.from_numpy(src), torch.from_numpy(img))
    assert calls == [False] * 2


# -- the tiny probes' train steps against the JAX trainer ---------------------

TINY_SIZE = 56
# the first step's gradients, of each leaf's largest: the flagship step's
# 1e-4 (tests/test_torch_training.py), and 5e-4 through the four JBU
# stages, whose forward test_torch_upsamplers.py holds to 1e-4 (measured:
# 1.4e-4)
STEP_GRAD_TOL = {"loftup": 1e-4, "jbu_featup": 5e-4}
PARAM_ATOL = 5e-7
NOISE_GRAD = 1e-3


def family_train_config(family):
    """The tiny probe of ``family`` (test_torch_upsamplers.py's; LoftUp
    monolithic, as the full-width step at 224² runs it: the banded slabs
    have their own test) with the scripts' save config."""
    from tests.test_torch_upsamplers import family_config

    cfg = family_config(family, TINY_SIZE)
    if family == "loftup":
        cfg["upsampler_cfg"] = dict(cfg["upsampler_cfg"], params=dict(
            cfg["upsampler_cfg"]["params"], query_chunk_rows=0))
    return dict(cfg, save_cfg=dict(embed_coords=True, backbone=False,
                                   upsampler=False, head=True))


@pytest.fixture
def family_pair(tiny_arch, tmp_path, request):
    """A JAX trainer and a port trainer of the tiny (128-wide, 2-block)
    probe of ``request.param`` at 56²,
    from the same params (JAX's ``model.init(PRNGKey(0))``) and loss."""
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

    from tests.test_torch_training import (
        LR,
        ListDataset,
        _items,
        _ns_cfg,
        _numpy_tree,
        tiny_batch,
    )

    class JitInitModel(JModel):
        """The JAX probe with ``init`` compiled as one program (its eager
        init compiles each op alone: ~20 s of the LoftUp probe's setup);
        both trainers start from whatever params it gives."""

        def init(self, *args):
            return jax.jit(functools.partial(JModel.init, self))(*args)

    torch.set_num_threads(4)
    cfg = family_train_config(request.param)
    items = _items(tiny_batch())
    opt = {"lr": LR, "betas": (0.9, 0.999), "eps": 1e-8}
    jtr = JTrainer(JitInitModel(**cfg, attn_impl="jnp"), _ns_cfg(tmp_path),
                   {"instance_loss": JNFL(alpha=0.5, gamma=2),
                    "instance_loss_weight": 1.0},
                   ListDataset(items), ListDataset(items), optimizer="adam",
                   optimizer_params=dict(opt), max_num_next_clicks=2, seed=0,
                   mesh=make_mesh(n_devices=1))
    p = jax.device_get(jtr.params)
    params = _numpy_tree({**p["trainable"], **p["frozen"]})
    ttr = TTrainer(TModel(**cfg, device="cpu"), _ns_cfg(tmp_path),
                   {"instance_loss": TNFL(alpha=0.5, gamma=2),
                    "instance_loss_weight": 1.0},
                   ListDataset(items), ListDataset(items), optimizer="adam",
                   optimizer_params=dict(opt), max_num_next_clicks=2, seed=0,
                   params=params, device="cpu")
    return jtr, ttr, params, request.param


@pytest.mark.parametrize("family_pair", ["loftup", "jbu_featup"],
                         indirect=True)
def test_family_train_step_matches_jax(family_pair):
    """Two steps at num_iters=0 through the tiny LoftUp and JBU probes: the
    losses, the first step's trainable gradients (through the frozen
    upsampler and backbone, the click encoder's non-zero) and the params
    after the first Adam step against the JAX trainer's; the frozen params
    stay bitwise."""
    import jax
    import jax.numpy as jnp
    import torch

    from isegprobe_torch.models.convert import state_dict_to_jax_params

    from tests.test_torch_training import tiny_batch

    jtr, ttr, params, family = family_pair
    batch = tiny_batch()
    jbatch = jtr._prep_batch(batch)
    tbatch = ttr._upload(batch)
    frozen0 = {k: v.clone() for k, v in ttr.model.state_dict().items()
               if k.startswith(("backbone", "upsampler"))}
    images = jnp.asarray(batch["images"], jnp.float32) / 255.0
    inst = jnp.asarray(batch["instances"], jnp.float32)
    prev = jnp.zeros((*images.shape[:3], 1), jnp.float32)
    frozen = jtr.params["frozen"]

    def loss_fn(trainable):
        out = jtr._forward({**trainable, **frozen}, images, prev,
                           jnp.asarray(batch["points"]))
        return jtr._loss(out, {"instances": inst})[0]

    # jitted, as the train step is: XLA fuses LoftUp's Fourier phases into
    # one multiply-add, which the eager ops do not
    jgrads = jax.device_get(jax.jit(jax.grad(loss_fn))(
        jtr.params["trainable"]))
    rng = jax.random.PRNGKey(0)
    for step in range(2):
        (jtr.params, jtr.opt_state, jloss, _, _, _) = jtr._train_step(
            jtr.params, jtr.opt_state, jbatch, rng, 0, 0.4, 0.025,
            click_trees=())
        tloss, _, _ = ttr._step(tbatch, 0)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        if step:
            continue
        tgrads = {n: p.grad for n, p in ttr.model.named_parameters()
                  if p.grad is not None}
        assert sorted({n.split(".")[0] for n in tgrads}) == [
            "embed_coords", "head"]
        assert float(tgrads["embed_coords.proj.weight"].norm()) > 0
        tg = state_dict_to_jax_params(tgrads, {
            k: params[k] for k in ("embed_coords", "head")})
        got = ttr.full_params(("embed_coords", "head"))
        want = jax.device_get(jtr.params["trainable"])
        for a, b, pa, pb in zip(jax.tree.leaves(tg), jax.tree.leaves(jgrads),
                                jax.tree.leaves(got),
                                jax.tree.leaves(want)):
            assert _rel(a, b) <= STEP_GRAD_TOL[family]
            noise = np.abs(b) < NOISE_GRAD * np.abs(b).max()
            assert (np.abs(pa - pb)[~noise] <= PARAM_ATOL).all()
    for k, v in ttr.model.state_dict().items():
        if k in frozen0:
            assert torch.equal(v, frozen0[k]), k


@pytest.mark.parametrize("upsampler", ["identity", "loftup", "jbu_featup",
                                       "lift"])
def test_click_encoder_gradient_passes_each_upsampler(tiny_arch, upsampler):
    """The gradient of a loss on the logits reaches the click encoder
    through the frozen upsampler and backbone: non-zero, and none for a
    frozen parameter."""
    import torch

    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.models.vit import init_params
    from isegprobe_torch.training.trainer import split_params

    from tests.test_torch_training import tiny_batch
    from tests.test_torch_upsamplers import FAMILIES, WIDTH

    cfg = family_train_config("loftup")
    cfg["upsampler_cfg"] = FAMILIES.get(upsampler, dict(
        type=upsampler, params=dict(n_dim=WIDTH, patch=14)
        if upsampler == "lift" else dict()))
    model = init_params(iSegProbeModel(**cfg, device="cpu"), seed=1)
    split_params(model)
    batch = tiny_batch(2)
    image = torch.from_numpy(batch["images"][:2]).float() / 255
    image = torch.cat([image, torch.zeros_like(image[..., :1])], -1)
    out = model(image, torch.from_numpy(batch["points"][:2]))
    out["instances"].square().mean().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert float(grads["embed_coords.proj.weight"].norm()) > 0
    assert all(g is None for n, g in grads.items()
               if n.startswith(("backbone", "upsampler")))


# -- every models/synthetic/ script through the command line ------------------

# the crop of each script's two CLI steps: whole patches of 14 or 16
CLI_MODELS = {"synthetic_dinov2_loftup": 56, "synthetic_dinov2_jbu": 56,
              "synthetic_dinov2_lift": 56, "synthetic_dinov2_simplevit": 56,
              "synthetic_vit_noup": 64, "synthetic_maskclip_noup": 64}


@pytest.fixture
def shallow_archs(monkeypatch):
    """The port's DINOv2-S/14, DINO ViT-S/16 and CLIP ViT-B/16 entries at
    their full widths with 1, 1 and 2 blocks: the command line builds each
    script's model by these names, and ``init_tree`` then draws a fraction
    of the parameters."""
    import dataclasses

    from isegprobe_torch.models import init_tree
    from isegprobe_torch.models.featurizers import dino, dinov2, maskclip

    monkeypatch.setitem(dinov2.DINOV2_ARCHS, "dinov2_vits14",
                        dataclasses.replace(
                            dinov2.DINOV2_ARCHS["dinov2_vits14"], depth=1))
    for mod in (dino, init_tree):
        monkeypatch.setattr(mod, "DINO_TRUNK", dataclasses.replace(
            mod.DINO_TRUNK, depth=1))
    monkeypatch.setitem(maskclip.CLIP_ARCHS, "ViT-B/16", dict(
        maskclip.CLIP_ARCHS["ViT-B/16"], layers=2))


@pytest.mark.parametrize("model", sorted(CLI_MODELS))
def test_train_cli_trains_each_script_and_both_readers_read_it(
        shallow_archs, tmp_path, model):
    """``python -m isegprobe_torch.train model=<script> device=cpu``: two
    steps at batch 2 and a validation step write a checkpoint of the
    script's saved modules (click encoder and head, moved by Adam) under
    the JAX package's model config for the same script; the JAX reader and
    the port's read it alike, its leaves have the JAX model's names, shapes
    and dtypes (MaskCLIP's 768-wide patch embedding and 512-wide head, the
    SimpleViT click encoder), and ``load_model_for_eval`` builds the model
    with those modules and runs it."""
    import contextlib
    import warnings

    import jax
    import torch

    from isegprobe_torch import train
    from isegprobe_torch.evaluate import load_model_for_eval
    from isegprobe_torch.models.convert import state_dict_to_jax_params
    from isegprobe_torch.models.init_tree import init_tree
    from isegprobe_torch.utils.serialization import load_checkpoint
    from isegprobe_tpu.utils.serialization import \
        load_checkpoint as jax_load_checkpoint
    from isegprobe_tpu.utils.serialization import model_config

    from models.common import init_model_from_modules_cfg

    crop = CLI_MODELS[model]
    out = tmp_path / "exp"
    warns = (pytest.warns(UserWarning, match="upsampler_path")
             if model == "synthetic_dinov2_loftup"
             else contextlib.nullcontext())
    with warns:
        assert train.main([
            f"model={model}", "device=cpu",
            f"training_params.crop_size=[{crop},{crop}]",
            "dataloader.batch_size=2", "dataloader.val_batch_size=2",
            "epoch_len=4", "val_epoch_len=2", "training_params.epochs=1",
            "dataloader.workers=0", f"exp_path={out}"]) == 0
    (ckpt,) = out.glob("*/*/000_*/checkpoints/last_checkpoint.ckpt")
    params, config, extra = load_checkpoint(ckpt)
    jparams, jconfig, jextra = jax_load_checkpoint(ckpt)
    assert sorted(params) == sorted(jparams) == ["embed_coords", "head"]
    assert extra == jextra == {"epoch": 0} and config == jconfig
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(jparams)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jcfg = jax_script_cfg(crop_size=[crop, crop])
    name = model.removeprefix("synthetic_")
    jmodel = init_model_from_modules_cfg(
        load_script(name).define_modules_cfg(jcfg), jcfg)
    assert config == model_config(jmodel)
    # the JAX model takes the saved modules' leaves as they are
    jshapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                             np.zeros((1, crop, crop, 4), np.float32),
                             np.zeros((1, 48, 3), np.float32))["params"]
    assert jax.tree.structure(params) == jax.tree.structure(
        {k: jshapes[k] for k in params})
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(
            {k: jshapes[k] for k in params})):
        assert a.shape == b.shape and a.dtype == b.dtype
    init = init_tree(config["params"], 0)
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(params), jax.tree.leaves(
            {k: init[k] for k in params}))]
    assert any(moved)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # LoftUp's missing upsampler_path
        loaded, _ = load_model_for_eval(str(ckpt), torch.float32,
                                        (crop, crop), device="cpu")
    state = state_dict_to_jax_params(
        loaded.state_dict(), {k: init[k] for k in params})
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(params)):
        assert np.array_equal(a, b)
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.random((1, crop, crop, 4), np.float32))
    points = torch.full((1, 48, 3), -1.0)
    points[0, 0] = torch.tensor([crop / 2, crop / 3, 0.0])
    with torch.no_grad():
        logits = loaded(image, points)["instances"]
    assert logits.shape == (1, crop, crop, 1) and torch.isfinite(
        logits).all()


# -- the families' train-step fixture -----------------------------------------

@pytest.fixture(scope="module")
def family_fixture():
    with np.load(FAMILY_FIXTURE) as data:
        return dict(data)


def test_family_fixture_is_consistent(family_fixture):
    """The fixture's batch is the first FIXTURE_BATCH items of the
    train-step fixture (its seeds and positions), each family holds two
    finite losses and the digests of the flagship fixture's trainable
    leaves (the same click encoder and head)."""
    fx = family_fixture
    assert FAMILY_FIXTURE.stat().st_size <= 64 * 2**10
    with np.load(STEP_FIXTURE) as step:
        np.testing.assert_array_equal(fx["seeds"],
                                      step["seeds"][:FIXTURE_BATCH])
        np.testing.assert_array_equal(fx["positions"],
                                      step["positions"][:FIXTURE_BATCH])
        names = list(step["digest_names"])
    assert tuple(fx["families"]) == FIXTURE_FAMILIES
    for name in FIXTURE_FAMILIES:
        losses = fx[f"{name}/losses"]
        assert losses.shape == (2,) and np.isfinite(losses).all()
        assert list(fx[f"{name}/digest_names"]) == names
        assert fx[f"{name}/digests"].shape == (len(names), 18)


def step_against_family_fixture(name, device="cpu", batch_size=FIXTURE_BATCH):
    """The port's full-width 224² step of ``models/synthetic/<name>.py``
    from ``init_tree(config, 0)`` on the fixture's batch at num_iters=0,
    twice: (losses, digests by name). ``chip_smoke.py`` runs the same on
    the card."""
    import tempfile
    import warnings

    from isegprobe_torch.train import build_trainer, parse_args

    from tests.test_torch_training import digest

    with warnings.catch_warnings(), tempfile.TemporaryDirectory() as tmp:
        warnings.simplefilter("ignore")  # LoftUp's missing upsampler_path
        trainer = build_trainer(parse_args([f"model=synthetic_{name}",
                                            f"device={device}",
                                            "dataloader.workers=0",
                                            f"exp_path={tmp}"]))
    with np.load(STEP_FIXTURE) as step:
        batch = trainer._upload({k: step[k][:batch_size] for k in (
            "images", "points", "instances")})
    losses = [float(trainer._step(batch, 0)[0]) for _ in range(2)]
    trainer.shutdown()
    return losses, digest(trainer.full_params(("embed_coords", "head")))


@pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                    reason="full-width CPU steps, ~11 min (RUN_SLOW=1)")
@pytest.mark.parametrize("name", FIXTURE_FAMILIES)
def test_cpu_family_step_matches_the_fixture(family_fixture, name):
    from tests.test_torch_training import (
        DIGEST_ATOL,
        DIGEST_RTOL,
        LR,
        STEP_FLIPS,
        STEP_LOSS_RTOL,
    )

    fx = family_fixture
    losses, dig = step_against_family_fixture(name)
    np.testing.assert_allclose(losses, fx[f"{name}/losses"],
                               rtol=STEP_LOSS_RTOL)
    for key, want in zip(fx[f"{name}/digest_names"], fx[f"{name}/digests"]):
        got = dig[str(key)]
        np.testing.assert_allclose(
            got[:2], want[:2], rtol=0,
            atol=DIGEST_RTOL * want[1] + STEP_FLIPS * 4.4 * LR)
        np.testing.assert_allclose(got[2:], want[2:], rtol=0,
                                   atol=DIGEST_ATOL)


@pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                    reason="JAX export on the CPU, ~3 min, 22 GB (RUN_SLOW=1)")
def test_family_fixture_against_a_fresh_jax_export(family_fixture,
                                                   tmp_path):
    path = tmp_path / "families.npz"
    export(path)
    with np.load(path) as fresh:
        for key in family_fixture:
            if key.endswith("export_seconds"):
                continue
            np.testing.assert_array_equal(fresh[key], family_fixture[key])


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    if "--export" not in sys.argv[1:]:
        sys.exit("usage: JAX_PLATFORMS=cpu python "
                 "tests/test_torch_family_training.py --export")
    export()
