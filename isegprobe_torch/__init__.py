"""iSegProbe on PyTorch and CUDA: the probe models and the NoC click protocol
for an NVIDIA Hopper GPU, beside the JAX package ``isegprobe_tpu`` that stays
the numerical reference.

Layout mirrors the JAX package so each module's counterpart is easy to find:
    ops/        resize and per-lane resizes (dynamic_resize.py), click
                encoding, ZoomIn sampling at fixed and per-lane extents,
                host and device EDT with the device clicker rule, the plain
                masked attention of the adaptive canvas, adaptive pooling
                (pool.py),
                coordinate grids (grid.py), and the wrappers of the
                hand-written CUDA kernels with their plain PyTorch versions:
                A packed-qkv attention and D cross-attention (attention.py),
                B LayerNorm (layernorm.py), C EDT row envelope (edt.py), E
                JBU filter (jbu.py), F and G the sweep's attention variants
                nodiv and merged (attn_variants.py); A, B, D and E also
                under autograd (kernel forward, plain-version backward)
    csrc/       CUDA C++ sources of kernels A-G, built with nvcc at first use
    models/     ViT core, featurizers (DINOv2, DINO key probing, MaskCLIP,
                the SimpleViT click encoder), upsamplers (identity, LiFT,
                LoftUp, JBU-FeatUp), heads, probe model, the compute dtype
                by flax's rules (dtype.py), the weight bridge from the JAX
                package's param trees, and their PRNGKey(0) init rebuilt in
                numpy (init_tree)
    inference/  clicker, predictors (fixed ZoomIn; the transform chain of
                transforms.py), NoC evaluation and metrics, the batched
                on-device NoC loop and its job queue (device_eval) and the
                RITM adaptive loop (adaptive_eval)
    data/       the stored evaluation scenes (scenes), over fixtures/, and
                the training data without OpenCV: OpenCV's fills and
                resizes in numpy (raster), augmentations, click sampler,
                samples, the Synthetic dataset and the threaded loader
    training/   losses, metrics, optimizers (layer-wise decay) and the
                trainer with on-card click simulation (bf16 mixed
                precision, click_models, resuming)
    evaluate.py the trained checkpoints by NoC (python -m
                isegprobe_torch.evaluate checkpoint=...)
    train.py    training the Synthetic probes, one for each script of
                models/synthetic/ (python -m isegprobe_torch.train
                model=synthetic_dinov2_loftup, ...)
    scripts/    command-line entry points: the attention-variant sweep
                (python -m isegprobe_torch.scripts.bench_attn_variants)
    utils/      bbox and label helpers, the checkpoint reader and writer
                (serialization), run directories (exp) and JAX's threefry
                PRNG in numpy (jax_rng)

Entry points run on CUDA unless the caller passes ``device="cpu"``; without a
GPU and without that request they raise (see :func:`resolve_device`).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Counterpart of isegprobe_tpu/__init__.py (jax_default_matmul_precision =
# float32): f32 parity with the reference needs full-f32 products. cuBLAS
# keeps f32 by default, but cuDNN convolutions (patch embeddings, 3x3 head)
# use TF32 unless told otherwise. bf16 modules are unaffected.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise. Raises when no GPU is visible and the caller did not ask for
    the CPU explicitly — there is no silent CPU fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "isegprobe_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
