"""Upsamplers: the non-learnable ones, LoftUp and the JBU-FeatUp stack.

Counterpart of ``isegprobe_tpu/models/upsamplers/__init__.py``; the learned
families are registered beside the basic ones (LiFT waits for ROADMAP
Queue 1 item 7)."""

from isegprobe_torch.models.upsamplers.basic import BASIC_UPSAMPLERS
from isegprobe_torch.models.upsamplers.jbu import JBUFeatUpUpsampler
from isegprobe_torch.models.upsamplers.loftup import LoftUpUpsampler

UPSAMPLER_REGISTRY = {**BASIC_UPSAMPLERS, "loftup": LoftUpUpsampler,
                      "jbu_featup": JBUFeatUpUpsampler}

__all__ = ["UPSAMPLER_REGISTRY"]
