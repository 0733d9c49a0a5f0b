"""The composite interactive-segmentation probe model.

Counterpart of ``isegprobe_tpu/models/probe_model.py:iSegProbeModel``: image
normalization, click disk-map encoding, click patch embedding, the backbone
with injected click tokens, upsampler, head and the final align-corners
resize. It takes the JAX package's constructor config (so a checkpoint's
``config["params"]`` builds it) and so far covers a DINOv2 backbone, a
``patchEmbed`` click encoder, the ``convhead`` head and the upsamplers of
``models.upsamplers``: the non-learnable ones (the flagship's identity),
LoftUp and the JBU-FeatUp stack. Other configurations raise
``NotImplementedError`` naming the ROADMAP item that brings them.

Call as ``model(image, points)`` with image ``[B, H, W, 3]`` in [0, 1] (plus a
prev-mask channel when ``with_prev_mask``) and points ``[B, 2N, 3]`` rows of
(y, x, index), −1-padded, positives first. Returns
``{'instances': [B, H, W, 1] float32 logits, 'instances_aux': None}``.
"""

from __future__ import annotations

import inspect
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from isegprobe_torch import resolve_device
from isegprobe_torch.models.featurizers.dinov2 import DINOv2Featurizer
from isegprobe_torch.models.heads import HEAD_REGISTRY
from isegprobe_torch.models.upsamplers import UPSAMPLER_REGISTRY
from isegprobe_torch.models.vit import PatchEmbed
from isegprobe_torch.ops.dist_maps import encode_clicks
from isegprobe_torch.ops.resize import resize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_OTHER_FAMILIES = "ROADMAP Queue 1 item 7 (other model families)"


def _unsupported(what: str, item: str = _OTHER_FAMILIES):
    return NotImplementedError(
        f"{what} is not ported to isegprobe_torch yet: {item}")


def build_upsampler(utype: str, params: Optional[Dict],
                    feat_dim: int) -> nn.Module:
    """The upsampler of ``upsampler_cfg``, built with its ``params``
    (counterpart of the JAX package's ``build_upsampler``). Raises on a
    type or a parameter the port does not take, rather than building a
    different module. ``feat_dim`` (the backbone's width) goes to the
    upsamplers that need it at construction."""
    if utype not in UPSAMPLER_REGISTRY:
        raise _unsupported(f"upsampler type {utype!r}")
    cls = UPSAMPLER_REGISTRY[utype]
    kwargs = dict(params or {})
    takes = set(inspect.signature(cls).parameters)
    unknown = sorted(set(kwargs) - (takes - {"feat_dim"}))
    if unknown:
        raise TypeError(f"upsampler {utype!r} of isegprobe_torch does not "
                        f"take {unknown}")
    if "feat_dim" in takes:
        kwargs["feat_dim"] = feat_dim
    return cls(**kwargs)


class iSegProbeModel(nn.Module):
    """backbone (+ injected click tokens) -> upsampler -> head.

    Modules compute in the dtype of their parameters. ``model.to(
    torch.bfloat16)`` is the bf16 serving path, the counterpart of
    evaluate.py's cast of every f32 param to bf16: the backbone and the
    click encoder then compute in bf16, the head in f32 from the
    bf16-rounded weights, as in the JAX package. ``attn_impl`` and
    ``cpu_dist_maps`` are accepted for config compatibility: the port always
    uses its own kernels on a GPU. ``quant`` must be None and
    ``fuse_hr_head`` False (not ported yet). The model is built on ``device`` (CUDA
    unless the caller passes ``device="cpu"``) with placeholder parameters;
    load weights with ``models.convert.load_jax_params`` or draw them with
    ``models.vit.init_params``.
    """

    def __init__(self, backbone_cfg: Dict, head_cfg: Dict,
                 embed_coords_cfg: Dict, neck_cfg: Optional[Dict] = None,
                 upsampler_cfg: Optional[Dict] = None,
                 save_cfg: Optional[Dict] = None,
                 architecture: str = "backbone_upsampler_head",
                 with_aux_output: bool = False, norm_radius: float = 5.0,
                 use_disks: bool = False, cpu_dist_maps: bool = False,
                 use_rgb_conv: bool = False, use_leaky_relu: bool = False,
                 with_prev_mask: bool = False,
                 norm_mean_std: Tuple = (IMAGENET_MEAN, IMAGENET_STD),
                 attn_impl: str = "auto", quant=None,
                 fuse_hr_head: bool = False, device=None) -> None:
        super().__init__()
        if architecture != "backbone_upsampler_head":
            raise NotImplementedError(
                f"architecture {architecture!r}: necks are unimplemented in "
                "the reference too")
        if use_rgb_conv:
            raise _unsupported("the RITM maps transform (use_rgb_conv)",
                               "ROADMAP Queue 1 item 8 (adaptive RITM "
                               "protocol)")
        if quant is not None:
            raise _unsupported(f"quant={quant!r} (int8 W8A8 serving)",
                               "ROADMAP Queue 1 item 9 (ops/quant.py)")
        if fuse_hr_head:
            raise _unsupported("the head fused into LoftUp's slab loop "
                               "(fuse_hr_head)", "ROADMAP Queue 1 item 7 "
                               "(LoftUp's mxu_pad layout and fused head)")
        self.norm_radius = norm_radius
        self.use_disks = use_disks
        self.with_prev_mask = with_prev_mask
        self.norm_mean_std = norm_mean_std
        self._norm_cache: Dict = {}

        btype = backbone_cfg["type"].lower()
        if btype != "dinov2":
            raise _unsupported(f"backbone type {btype!r}")
        self.backbone = DINOv2Featurizer(**(backbone_cfg.get("params") or {}))

        self.upsampler_type = (upsampler_cfg["type"].lower() if upsampler_cfg
                               else "bilinear")
        self.upsampler = build_upsampler(
            self.upsampler_type,
            upsampler_cfg.get("params") if upsampler_cfg else None,
            self.backbone.embed_dim)

        if head_cfg["type"] not in HEAD_REGISTRY:
            raise _unsupported(f"head type {head_cfg['type']!r}")
        self.head = HEAD_REGISTRY[head_cfg["type"]](**head_cfg["params"])

        if embed_coords_cfg["type"] != "patchEmbed":
            raise _unsupported(
                f"embed_coords type {embed_coords_cfg['type']!r}")
        ec = embed_coords_cfg["params"]
        p = ec["patch_size"]
        p = p[0] if isinstance(p, (tuple, list)) else p
        self.embed_coords = PatchEmbed(3 if with_prev_mask else 2, p,
                                       ec["embed_dim"])

        self.to(resolve_device(device))

    # -- input preparation ------------------------------------------------

    def _norm_consts(self, dtype, device):
        """Mean and std as tensors, made once per (dtype, device): a host
        copy per forward would be a sync inside the on-device click loop."""
        key = (dtype, device)
        if key not in self._norm_cache:
            self._norm_cache[key] = tuple(
                torch.tensor(v, dtype=dtype, device=device)
                for v in self.norm_mean_std)
        return self._norm_cache[key]

    def prepare_input(self, image: torch.Tensor):
        prev_mask = None
        if self.with_prev_mask:
            prev_mask = image[..., 3:]
            image = image[..., :3]
        mean, std = self._norm_consts(image.dtype, image.device)
        return (image - mean) / std, prev_mask

    def get_coord_features(self, image, prev_mask, points) -> torch.Tensor:
        h, w = image.shape[1], image.shape[2]
        coords = encode_clicks(points, h, w, norm_radius=self.norm_radius,
                               use_disks=self.use_disks, dtype=image.dtype)
        if prev_mask is not None:
            coords = torch.cat([prev_mask.to(coords.dtype), coords], dim=-1)
        return coords

    # -- forward ----------------------------------------------------------

    def _upsample_and_head(self, feats, image) -> torch.Tensor:
        h, w = image.shape[1], image.shape[2]
        feats = self.upsampler(feats, image)
        if self.upsampler_type != "identity" and feats.shape[1:3] != (h, w):
            feats = resize(feats, (h, w), "bilinear", align_corners=True)
        return self.head(feats)

    def backbone_forward(self, image, coord_features) -> Dict:
        coord_tokens = self.embed_coords(coord_features)
        feats = self.backbone(image, coord_tokens)
        return {"instances": self._upsample_and_head(feats, image),
                "instances_aux": None}

    def forward(self, image: torch.Tensor, points: torch.Tensor) -> Dict:
        image, prev_mask = self.prepare_input(image)
        coord_features = self.get_coord_features(image, prev_mask, points)
        outputs = self.backbone_forward(image, coord_features)
        h, w = image.shape[1], image.shape[2]
        outputs["instances"] = resize(outputs["instances"], (h, w),
                                      "bilinear", align_corners=True)
        return outputs

    # -- late-injection caching seams ---------------------------------------
    # With 'after_backbone' injection the frozen trunk depends only on the
    # image crop, so the click loop can cache it and rerun just the click
    # embedding, the add, the upsampler and the head.

    def compute_backbone_trunk(self, image: torch.Tensor) -> torch.Tensor:
        """Trunk features ``[B, gh, gw, C]`` of the (un-normalised, possibly
        prev-mask-extended) crop, with no click injection."""
        image, _ = self.prepare_input(image)
        return self.backbone(image, None)

    def forward_with_cached_trunk(self, image: torch.Tensor,
                                  points: torch.Tensor,
                                  trunk_feats: torch.Tensor) -> Dict:
        """The late-injection forward from cached trunk features: equal to
        ``forward`` for an ``after_backbone`` model."""
        image, prev_mask = self.prepare_input(image)
        coord_features = self.get_coord_features(image, prev_mask, points)
        coord_tokens = self.embed_coords(coord_features)
        b, gh, gw, c = trunk_feats.shape
        # the add the featurizer performs for 'after_backbone'
        feats = trunk_feats.float() + coord_tokens.reshape(b, gh, gw,
                                                           c).float()
        out = self._upsample_and_head(feats, image)
        h, w = image.shape[1], image.shape[2]
        out = resize(out, (h, w), "bilinear", align_corners=True)
        return {"instances": out, "instances_aux": None}


def flagship_config(img_size=(448, 448)) -> Dict:
    """Constructor config of the flagship probe: DINOv2-S/14 with clicks
    patch-embedded and added before the backbone, identity upsampler, 2-layer
    3x3 convhead (the JAX package's ``__graft_entry__._flagship_model``)."""
    return dict(
        backbone_cfg=dict(type="dinov2",
                          params=dict(feats_injection_mode="before_backbone")),
        embed_coords_cfg=dict(
            type="patchEmbed",
            params=dict(img_size=img_size, patch_size=(14, 14),
                        embed_dim=384)),
        head_cfg=dict(type="convhead",
                      params=dict(in_channels=384, num_layers=2,
                                  num_classes=1)),
        upsampler_cfg=dict(type="identity", params=dict()),
        use_disks=True,
        norm_radius=5,
        with_prev_mask=True,
    )
