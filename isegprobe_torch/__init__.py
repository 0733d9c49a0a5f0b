"""iSegProbe on PyTorch and CUDA: the probe models and the NoC click protocol
for an NVIDIA Hopper GPU, beside the JAX package ``isegprobe_tpu`` that stays
the numerical reference.

Layout mirrors the JAX package so each module's counterpart is easy to find:
    ops/        resize, click encoding, ZoomIn sampling, host and device EDT
                with the device clicker rule, adaptive pooling (pool.py),
                coordinate grids (grid.py), and the wrappers of the
                hand-written CUDA kernels with their plain PyTorch versions:
                A packed-qkv attention and D cross-attention (attention.py),
                B LayerNorm (layernorm.py), C EDT row envelope (edt.py), E
                JBU filter (jbu.py), F and G the sweep's attention variants
                nodiv and merged (attn_variants.py)
    csrc/       CUDA C++ sources of kernels A-G, built with nvcc at first use
    models/     ViT core, DINOv2 featurizer, upsamplers (identity, LoftUp,
                JBU-FeatUp), heads, probe model, the weight bridge from
                the JAX package's param trees, and their PRNGKey(0) init
                rebuilt in numpy (init_tree)
    inference/  clicker, predictor, NoC evaluation and metrics, and the
                batched on-device NoC loop (device_eval)
    data/       the stored evaluation scenes (scenes), over fixtures/
    evaluate.py the trained checkpoints by NoC (python -m
                isegprobe_torch.evaluate checkpoint=...)
    scripts/    command-line entry points: the attention-variant sweep
                (python -m isegprobe_torch.scripts.bench_attn_variants)
    utils/      bbox helpers, the checkpoint reader (serialization) and
                JAX's threefry PRNG in numpy (jax_rng)

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
