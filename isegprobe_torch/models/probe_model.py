"""The composite interactive-segmentation probe model.

Counterpart of ``isegprobe_tpu/models/probe_model.py:iSegProbeModel``: image
normalization, click disk-map encoding, click patch embedding, the backbone
with injected click tokens, upsampler, head and the final align-corners
resize. It takes the JAX package's constructor config (so a checkpoint's
``config["params"]`` builds it): the ``dinov2``, ``vit`` (DINO key or token
probing) and ``mask_clip`` backbones, the ``patchEmbed`` and ``simple_vit``
click encoders, the heads of ``models.heads`` and the upsamplers of
``models.upsamplers`` (the non-learnable ones, LiFT, LoftUp and the
JBU-FeatUp stack), and the RITM maps transform of ``use_rgb_conv``. Other
options raise ``NotImplementedError`` naming the ROADMAP item that brings
them. ``forward_masked`` is the forward on the adaptive ZoomIn's canvas.

Call as ``model(image, points)`` with image ``[B, H, W, 3]`` in [0, 1] (plus a
prev-mask channel when ``with_prev_mask``) and points ``[B, 2N, 3]`` rows of
(y, x, index), −1-padded, positives first. Returns
``{'instances': [B, H, W, 1] float32 logits, 'instances_aux': None}``.
"""

from __future__ import annotations

import inspect
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from isegprobe_torch import resolve_device
from isegprobe_torch.models.dtype import Conv2d, set_compute_dtype
from isegprobe_torch.models.featurizers.dino import DINOFeaturizer
from isegprobe_torch.models.featurizers.dinov2 import DINOv2Featurizer
from isegprobe_torch.models.featurizers.maskclip import MaskCLIPFeaturizer
from isegprobe_torch.models.featurizers.simple_vit import SimpleViTFeaturizer
from isegprobe_torch.models.heads import HEAD_REGISTRY
from isegprobe_torch.models.upsamplers import UPSAMPLER_REGISTRY
from isegprobe_torch.models.vit import PatchEmbed
from isegprobe_torch.ops.dist_maps import encode_clicks
from isegprobe_torch.ops.dynamic_resize import dyn_resize_2d_batched
from isegprobe_torch.ops.resize import resize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

BACKBONES = {"dinov2": DINOv2Featurizer, "vit": DINOFeaturizer,
             "mask_clip": MaskCLIPFeaturizer}


def _unsupported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to isegprobe_torch yet: {item}")


def build_simple_vit(params: Dict, channels: int) -> SimpleViTFeaturizer:
    """The ``simple_vit`` click encoder of ``embed_coords_cfg["params"]``,
    with the config's key names (the JAX package's ``build_featurizer``),
    for inputs of ``channels`` channels."""
    return SimpleViTFeaturizer(
        image_size=params["img_size"], patch_size=params["patch_size"],
        dim=params["embed_dim"], depth=params["depth"],
        heads=params["heads"], mlp_dim=params["mlp_dim"],
        channels=channels, dim_head=params.get("dim_head", 64))


def build_upsampler(utype: str, params: Optional[Dict],
                    feat_dim: int) -> nn.Module:
    """The upsampler of ``upsampler_cfg``, built with its ``params``
    (counterpart of the JAX package's ``build_upsampler``). Raises on a
    type or a parameter the port does not take, rather than building a
    different module. ``feat_dim`` (the backbone's width) goes to the
    upsamplers that need it at construction."""
    if utype not in UPSAMPLER_REGISTRY:
        raise ValueError(f"Unsupported upsampler type: {utype}")
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


class ScaleLayer(nn.Module):
    """A learned ``|scale|`` multiplier (the JAX package's ``ScaleLayer``,
    ``lr_mult`` 1): one parameter, ``weight`` ``[1]`` (flax's ``scale``),
    raw as flax's (a float32 scale promotes a bfloat16 input)."""

    def __init__(self, init_value: float = 1.0) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight.abs()


class RITMMapsTransform(nn.Module):
    """The RITM click-map transform of ``use_rgb_conv``: a 1x1 conv to 16
    channels, ReLU (or LeakyReLU 0.2), a stride-2 3x3 conv to 64 channels,
    a :class:`ScaleLayer` (init 0.05). NHWC in and out, the convolutions in
    the compute dtype; the output has half the size (rounded up)."""

    def __init__(self, in_chans: int, use_leaky_relu: bool = False) -> None:
        super().__init__()
        self.use_leaky_relu = use_leaky_relu
        self.conv1 = Conv2d(in_chans, 16, 1)
        self.conv2 = Conv2d(16, 64, 3, stride=2, padding=1)
        self.scale = ScaleLayer(0.05)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.permute(0, 3, 1, 2))
        x = F.leaky_relu(x, 0.2) if self.use_leaky_relu else torch.relu(x)
        return self.scale(self.conv2(x)).permute(0, 2, 3, 1)


def _rect_mask(hw: Tuple[int, int], valid_hw: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 1]`` bool: each lane's top-left ``valid_hw`` rect."""
    dev = valid_hw.device
    rows = torch.arange(hw[0], device=dev)[None, :, None]
    cols = torch.arange(hw[1], device=dev)[None, None, :]
    return ((rows < valid_hw[:, 0, None, None])
            & (cols < valid_hw[:, 1, None, None]))[..., None]


def split_points_by_order(points, groups) -> list:
    """Distribute padded clicks ``[B, 2N, 3]`` (a host array) into one
    padded array a group by click index, for click-wise ensembles: group
    ``g`` of size ``groups[g]`` (``<= 0``: N) takes the clicks of index
    ``g``, the last group every later click and every negative click of
    index 0. Returns float32 ``[B, 2 * size, 3]`` arrays, positives
    first, −1-padded."""
    points = np.asarray(points)
    num_groups = len(groups)
    bs = points.shape[0]
    num_points = points.shape[1] // 2
    groups = [x if x > 0 else num_points for x in groups]
    group_points = [np.full((bs, 2 * x, 3), -1, dtype=np.float32)
                    for x in groups]
    last_point_indx_group = np.zeros((bs, num_groups, 2), dtype=np.int64)
    for group_indx, group_size in enumerate(groups):
        last_point_indx_group[:, group_indx, 1] = group_size
    for bindx in range(bs):
        for pindx in range(2 * num_points):
            point = points[bindx, pindx, :]
            group_id = int(point[2])
            if group_id < 0:
                continue
            is_negative = int(pindx >= num_points)
            if group_id >= num_groups or (group_id == 0 and is_negative):
                group_id = num_groups - 1
            new_point_indx = last_point_indx_group[bindx, group_id,
                                                   is_negative]
            last_point_indx_group[bindx, group_id, is_negative] += 1
            group_points[group_id][bindx, new_point_indx, :] = point
    return group_points


class iSegProbeModel(nn.Module):
    """backbone (+ injected click tokens) -> upsampler -> head.

    ``dtype`` is the JAX model's compute dtype: with ``torch.bfloat16``
    over float32 parameters (mixed-precision training, f32 master weights)
    the backbone, upsampler, click encoder and RITM transform compute by
    flax's dtype rules (``models/dtype.py``), the head in f32. By default
    modules compute in the dtype of their parameters, and ``model.to(
    torch.bfloat16)`` is the bf16 serving path, the counterpart of
    evaluate.py's cast of every f32 param to bf16: the backbone and the
    click encoder then compute in bf16, the head in f32 from the
    bf16-rounded weights, as in the JAX package. ``dtype`` is not part of
    the saved config (the JAX package does not record it either). ``attn_impl`` and
    ``cpu_dist_maps`` are accepted for config compatibility: the port always
    uses its own kernels on a GPU. ``quant`` must be None (int8 is not
    ported yet). ``fuse_hr_head`` runs the head inside LoftUp's slab loop
    (the head's ``banded`` contract), so the ``[B, H, W, C]`` feature map
    never exists whole: the same logits (serving; the fused slabs are not
    checkpointed under autograd); other upsamplers ignore it. The model
    is built on ``device`` (CUDA
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
                 fuse_hr_head: bool = False, device=None,
                 dtype=None) -> None:
        super().__init__()
        if architecture != "backbone_upsampler_head":
            raise NotImplementedError(
                f"architecture {architecture!r}: necks are unimplemented in "
                "the reference too")
        if quant is not None:
            raise _unsupported(f"quant={quant!r} (int8 W8A8 serving)",
                               "ROADMAP Queue 1 item 9 (ops/quant.py)")
        # the constructor config, with the JAX package's field names and
        # order (``utils.serialization.model_config`` writes it)
        self.ctor_config = dict(
            backbone_cfg=backbone_cfg, head_cfg=head_cfg,
            embed_coords_cfg=embed_coords_cfg, neck_cfg=neck_cfg,
            upsampler_cfg=upsampler_cfg, save_cfg=save_cfg,
            architecture=architecture, with_aux_output=with_aux_output,
            norm_radius=norm_radius, use_disks=use_disks,
            cpu_dist_maps=cpu_dist_maps, use_rgb_conv=use_rgb_conv,
            use_leaky_relu=use_leaky_relu, with_prev_mask=with_prev_mask,
            norm_mean_std=norm_mean_std, attn_impl=attn_impl, quant=quant,
            fuse_hr_head=fuse_hr_head)
        self.save_cfg = save_cfg
        self.fuse_hr_head = fuse_hr_head
        self.norm_radius = norm_radius
        self.use_disks = use_disks
        self.with_prev_mask = with_prev_mask
        self.norm_mean_std = norm_mean_std
        self._norm_cache: Dict = {}

        btype = backbone_cfg["type"].lower()
        if btype not in BACKBONES:
            raise ValueError(f"Unsupported backbone type: {btype}")
        self.backbone = BACKBONES[btype](**(backbone_cfg.get("params") or {}))

        self.upsampler_type = (upsampler_cfg["type"].lower() if upsampler_cfg
                               else "bilinear")
        self.upsampler = build_upsampler(
            self.upsampler_type,
            upsampler_cfg.get("params") if upsampler_cfg else None,
            self.backbone.embed_dim)

        if head_cfg["type"] not in HEAD_REGISTRY:
            raise ValueError(f"Unsupported head type: {head_cfg['type']}")
        self.head = HEAD_REGISTRY[head_cfg["type"]](**head_cfg["params"])

        ec_type, ec = embed_coords_cfg["type"], embed_coords_cfg["params"]
        in_chans = 3 if with_prev_mask else 2
        self.maps_transform = None
        if use_rgb_conv:
            self.maps_transform = RITMMapsTransform(in_chans, use_leaky_relu)
            in_chans = 64
        if ec_type == "patchEmbed":
            p = ec["patch_size"]
            p = p[0] if isinstance(p, (tuple, list)) else p
            self.embed_coords = PatchEmbed(in_chans, p, ec["embed_dim"])
        elif ec_type == "simple_vit":
            self.embed_coords = build_simple_vit(ec, in_chans)
        else:
            raise ValueError(f"Unknown embed_coords type: {ec_type}")

        self.to(resolve_device(device))
        if dtype is not None:
            self.set_compute_dtype(dtype)

    def set_compute_dtype(self, dtype) -> "iSegProbeModel":
        """The compute dtype of every module but the head, which computes
        in f32 as the JAX package builds it (None: each module's parameter
        dtype)."""
        for part in (self.backbone, self.upsampler, self.embed_coords,
                     self.maps_transform):
            if part is not None:
                set_compute_dtype(part, dtype)
        return self

    # -- input preparation ------------------------------------------------

    def _norm_consts(self, dtype, device):
        """Mean and std as tensors, made once per (dtype, device): a host
        copy per forward would be a sync inside the on-device click loop."""
        key = (dtype, device)
        if key not in self._norm_cache:
            # normal tensors even when first made under inference mode, so
            # that a later training forward can use them
            with torch.inference_mode(False):
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

    def _fused_head(self) -> bool:
        """The head runs inside the upsampler's slab loop: ``fuse_hr_head``
        on LoftUp with a head of the banded contract."""
        return (self.fuse_hr_head and self.upsampler_type == "loftup"
                and hasattr(self.head, "banded"))

    def _upsample_and_head(self, feats, image) -> torch.Tensor:
        """upsampler -> (resize) -> head, the head fused into LoftUp's slab
        loop when :meth:`_fused_head` (LoftUp's output is guidance-sized,
        so the fused path needs no resize)."""
        if self._fused_head():
            return self.upsampler(feats, image, tail=self.head.banded,
                                  tail_halo=self.head.tail_halo)
        h, w = image.shape[1], image.shape[2]
        feats = self.upsampler(feats, image)
        if self.upsampler_type != "identity" and feats.shape[1:3] != (h, w):
            feats = resize(feats, (h, w), "bilinear", align_corners=True)
        return self.head(feats)

    def _embed_coords(self, coord_features: torch.Tensor) -> torch.Tensor:
        if self.maps_transform is not None:
            coord_features = self.maps_transform(coord_features)
        return self.embed_coords(coord_features)

    def backbone_forward(self, image, coord_features) -> Dict:
        coord_tokens = self._embed_coords(coord_features)
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
        coord_tokens = self._embed_coords(coord_features)
        b, gh, gw, c = trunk_feats.shape
        # the add the featurizer performs for 'after_backbone'
        feats = trunk_feats.float() + coord_tokens.reshape(b, gh, gw,
                                                           c).float()
        out = self._upsample_and_head(feats, image)
        h, w = image.shape[1], image.shape[2]
        out = resize(out, (h, w), "bilinear", align_corners=True)
        return {"instances": out, "instances_aux": None}

    # -- the adaptive canvas's forward -------------------------------------

    def forward_masked(self, image: torch.Tensor, points: torch.Tensor,
                       valid_hw: torch.Tensor) -> Dict:
        """The forward on a canvas ``image`` ``[B, Hc, Wc, C]`` whose
        top-left ``valid_hw`` ``[B, 2]`` rect is valid per lane (the
        adaptive ZoomIn's data-dependent crop sizes on one shape). Returns
        canvas logits whose valid rect equals :meth:`forward` on the
        true-size input: the click maps are zeroed outside the rect (and the
        RITM transform's output outside its half-size rect) as a true-size
        input's zero padding would be, the backbone runs
        ``masked_forward`` on the valid token grid ``valid_hw // patch``,
        and the head and the final resize follow each lane's rect. Takes
        the identity and bilinear upsamplers."""
        if self.upsampler_type not in ("identity", "bilinear"):
            raise NotImplementedError(
                f"adaptive-canvas eval supports identity/bilinear "
                f"upsamplers; got {self.upsampler_type!r}")
        hc, wc = image.shape[1], image.shape[2]
        image, prev_mask = self.prepare_input(image)
        coords = self.get_coord_features(image, prev_mask, points)
        vhw = valid_hw.long()
        coords = coords * _rect_mask((hc, wc), vhw).to(coords.dtype)
        if self.maps_transform is not None:
            coords = self.maps_transform(coords)
            half = torch.div(vhw + 1, 2, rounding_mode="floor")
            coords = coords * _rect_mask(coords.shape[1:3], half).to(
                coords.dtype)
        coord_tokens = self.embed_coords(coords)
        vg = torch.div(vhw, self.backbone.patch_size, rounding_mode="floor")
        feats = self.backbone.masked_forward(image, coord_tokens, vg)
        if self.upsampler_type == "bilinear":
            feats = dyn_resize_2d_batched(feats, vg, vhw, (hc, wc),
                                          "bilinear", align_corners=True)
            return {"instances": self.head.masked(feats, vhw),
                    "instances_aux": None}
        out = self.head.masked(feats, vg)
        out = dyn_resize_2d_batched(out, vg, vhw, (hc, wc), "bilinear",
                                    align_corners=True)
        return {"instances": out, "instances_aux": None}


def filter_state_dict(params: Dict, save_cfg: Optional[Dict]) -> Dict:
    """Filter a param tree by a ``save_cfg`` include/exclude tree (the JAX
    package's ``filter_state_dict``): its keys are top-level modules mapped
    to True/False or ``{'save': bool, 'exclude': [names]}``."""
    if not save_cfg:
        return params

    def included(path: Tuple[str, ...]) -> bool:
        cfg = save_cfg
        for part in path:
            if isinstance(cfg, dict):
                if "exclude" in cfg and part in cfg["exclude"]:
                    return False
                cfg = cfg.get(part, None)
                if cfg is False:
                    return False
                if cfg is None:
                    return True
                if isinstance(cfg, dict) and "save" in cfg \
                        and not cfg["save"]:
                    return False
        return cfg is not False

    def walk(tree: Dict, path: Tuple[str, ...]) -> Dict:
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            if isinstance(v, dict):
                sub = walk(v, p)
                if sub:
                    out[k] = sub
            elif included(p):
                out[k] = v
        return out

    return walk(params, ())


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


def synthetic_config(name: str, img_size=(448, 448)) -> Dict:
    """Constructor config of the model of ``models/synthetic/<name>.py``
    (as the JAX package's ``init_model_from_modules_cfg`` builds it, with
    ``img_size`` as the crop): ``dinov2_noup`` (the flagship, with its
    save config), ``dinov2_loftup`` and ``dinov2_jbu`` (the flagship
    through LoftUp, with the configured ``upsampler_path`` of
    ``configs/main_cfg.yaml``, or through the JBU-FeatUp stack), and the
    other families the paper probes:
    ``maskclip_noup`` (MaskCLIP ViT-B/16, clicks patch-embedded at its
    width and added before the tower, convhead on its 512-wide features),
    ``vit_noup`` (the DINO ViT-S/16 key probe, clicks added before),
    ``dinov2_simplevit`` (DINOv2-S/14 with the SimpleViT click encoder
    added after the trunk) and ``dinov2_lift`` (the flagship through the
    LiFT upsampler, with the configured ``lift_path`` of
    ``configs/main_cfg.yaml``), and ``dinov2_bilinear`` (the flagship
    through the bilinear upsampler, a script of ``models/sbd/`` only). The
    ``models/sbd/`` scripts define the same modules as their Synthetic
    namesakes."""
    size = list(img_size)
    patch_embed = dict(type="patchEmbed",
                       params=dict(img_size=size, patch_size=(14, 14),
                                   embed_dim=384))
    convhead = dict(type="convhead", params=dict(in_channels=384,
                                                 num_layers=2, num_classes=1))
    identity = dict(type="identity", params=dict())
    early = dict(type="dinov2",
                 params=dict(feats_injection_mode="before_backbone"))
    modules = {
        "dinov2_noup": (early, patch_embed, convhead, identity),
        "dinov2_loftup": (
            early, patch_embed, convhead,
            dict(type="loftup", params=dict(
                upsampler_path="/weights/loftup.pth", n_dim=384))),
        "dinov2_bilinear": (
            early, patch_embed, convhead,
            dict(type="bilinear", params=dict())),
        "dinov2_jbu": (
            early, patch_embed, convhead,
            dict(type="jbu_featup", params=dict(backbone_type="dinov2",
                                                use_norm=True))),
        "maskclip_noup": (
            dict(type="mask_clip",
                 params=dict(model_name="ViT-B/16",
                             feats_injection_mode="before_backbone")),
            dict(type="patchEmbed", params=dict(
                img_size=size, patch_size=(16, 16), embed_dim=768)),
            dict(type="convhead", params=dict(in_channels=512, num_layers=2,
                                              num_classes=1)),
            identity),
        "vit_noup": (
            dict(type="vit", params=dict(
                arch="vit_small_patch16_224", patch_size=16, feat_type="key",
                feats_injection_mode="before_backbone")),
            dict(type="patchEmbed", params=dict(
                img_size=size, patch_size=(16, 16), embed_dim=384)),
            convhead, identity),
        "dinov2_simplevit": (
            dict(type="dinov2",
                 params=dict(feats_injection_mode="after_backbone")),
            dict(type="simple_vit", params=dict(
                img_size=size, patch_size=(14, 14), embed_dim=384, depth=6,
                heads=8, mlp_dim=2048, channels=3, dim_head=64)),
            convhead, identity),
        "dinov2_lift": (
            early, patch_embed, convhead,
            dict(type="lift", params=dict(lift_path="/weights/lift.pth",
                                          n_dim=384, patch=14))),
    }
    if name not in modules:
        raise ValueError(f"no synthetic config {name!r}; takes "
                         f"{sorted(modules)}")
    backbone, embed_coords, head, upsampler = modules[name]
    return dict(backbone_cfg=backbone, head_cfg=head,
                embed_coords_cfg=embed_coords, neck_cfg=None,
                upsampler_cfg=upsampler,
                save_cfg=dict(embed_coords=True, backbone=False,
                              upsampler=False, head=True),
                architecture="backbone_upsampler_head", use_disks=True,
                norm_radius=5, with_prev_mask=True)
