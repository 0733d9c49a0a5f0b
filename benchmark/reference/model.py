"""The probe's forward in plain PyTorch: the benchmark's reference.

One function of a configuration file (``configs/*.json``) and a param tree
(``weights.probe_params``): image normalisation, the click disk maps with
the previous mask, the click patch embedding added to the image's patch
tokens before the DINOv2 ViT (cls token, pos-embed resized bicubically to
the crop's grid, pre-norm blocks with LayerScale, exact GELU), then the
identity or LoftUp upsampler and the 2-layer 3x3 convhead; identity logits
are resized to the crop with align-corners bilinear. Every product is
float32 with TF32 off unless the caller turns it on (the control).

It follows the published modules, with the JAX package's arithmetic where
that is part of the trained function: LoftUp's Fourier phases are rounded
once from their exact product and sum, on a grid computed as XLA computes
``jnp.linspace``. Attention is an explicit softmax over query blocks. No
kernel, cache or batching of the program is used.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
QUERY_BLOCK = 8192


def to_device(tree: Dict, device) -> Dict:
    """The numpy param tree as float32 tensors on ``device``."""
    return {k: to_device(v, device) if isinstance(v, dict) else
            torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in tree.items()}


def _dense(p, x):
    return x @ p["kernel"] + p["bias"]


def _conv(p, x, stride=1, padding=0):
    """NHWC in and out; flax kernel ``[kh, kw, cin, cout]``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["kernel"].permute(3, 2, 0, 1),
                 p["bias"], stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _ln(p, x, eps):
    w = p["scale"] if "scale" in p else p["weight"]
    return F.layer_norm(x, x.shape[-1:], w, p["bias"], eps)


def _attention(q, k, v, scale):
    """softmax(q k^T scale) v over ``[B, N, heads, dh]``, in query blocks."""
    out = []
    for lo in range(0, q.shape[1], QUERY_BLOCK):
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, lo:lo + QUERY_BLOCK], k)
        out.append(torch.einsum("bhqk,bkhd->bqhd",
                                torch.softmax(s * scale, dim=-1), v))
    return torch.cat(out, dim=1)


def click_maps(points, prev, h, w, radius):
    """``[B, H, W, 3]``: the previous probabilities, then disks of
    ``radius`` around the positive and the negative clicks. ``points``
    ``[B, 2N, 3]`` (y, x, index), positives first, -1 rows unused."""
    b, p, _ = points.shape
    pts = points.reshape(b, 2, p // 2, 3)
    rows = torch.arange(h, dtype=torch.float32, device=points.device)
    cols = torch.arange(w, dtype=torch.float32, device=points.device)
    dy = rows[None, None, None, :] - pts[..., 0, None]
    dx = cols[None, None, None, :] - pts[..., 1, None]
    d2 = dy[..., :, None] ** 2 + dx[..., None, :] ** 2
    valid = torch.maximum(pts[..., 0], pts[..., 1]) >= 0
    disk = (d2 <= radius * radius) & valid[..., None, None]
    disks = disk.any(dim=2).float().permute(0, 2, 3, 1)
    return torch.cat([prev[..., None], disks], dim=-1)


def vit(P, cfg, image, clicks):
    arch = cfg["backbone"]
    d, heads = arch["hidden_size"], arch["num_attention_heads"]
    dh, eps = d // heads, arch["layer_norm_eps"]
    patch = arch["patch_size"]
    b, h, w, _ = image.shape
    gh, gw = h // patch, w // patch
    m = P["backbone"]["model"]
    tokens = _conv(m["patch_embed"]["proj"], image, stride=patch)
    tokens = tokens + _conv(P["embed_coords"]["proj"], clicks, stride=patch)
    tokens = tokens.reshape(b, gh * gw, d)
    pe = m["pos_embed"]
    g0 = arch["pretrain_grid"]
    grid = pe[:, 1:].reshape(1, g0, g0, d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bicubic",
                         align_corners=False)
    pe = torch.cat([pe[:, :1], grid.permute(0, 2, 3, 1).reshape(1, -1, d)],
                   dim=1)
    x = torch.cat([m["cls_token"].expand(b, 1, d), tokens], dim=1) + pe
    for i in range(arch["num_hidden_layers"]):
        blk = m[f"blocks_{i}"]
        qkv = _dense(blk["attn"]["qkv"], _ln(blk["norm1"], x, eps))
        q, k, v = qkv.reshape(b, -1, 3, heads, dh).unbind(2)
        a = _attention(q, k, v, dh ** -0.5).reshape(b, -1, d)
        x = x + blk["ls1"]["gamma"] * _dense(blk["attn"]["proj"], a)
        y = F.gelu(_dense(blk["mlp"]["fc1"], _ln(blk["norm2"], x, eps)))
        x = x + blk["ls2"]["gamma"] * _dense(blk["mlp"]["fc2"], y)
    x = _ln(m["norm"], x, eps)
    return x[:, 1:].reshape(b, gh, gw, d)


def _linspace(start, stop, num, device):
    """``jnp.linspace`` as a jitted XLA forward computes it in float32."""
    div = num - 1
    recip = np.float32(1.0) / np.float32(div)
    i = np.arange(div, dtype=np.float32)
    out = (np.float32(start) * (np.float32(1.0) - i * recip)
           + i * (np.float32(stop) * recip)).astype(np.float32)
    return torch.as_tensor(np.append(out, np.float32(stop)), device=device)


def _fourier(biases, x, nf, color):
    """LoftUp's implicit featurizer: sin and cos of the grid (and colour)
    times ``exp(linspace(-2, 10, nf))`` plus learned biases, whose
    ``[2, dm, nf]`` storage is read as ``[nf, dm]``."""
    b, h, w, _ = x.shape
    dev = x.device
    grid = torch.stack(torch.meshgrid(_linspace(-1, 1, h, dev),
                                      _linspace(-1, 1, w, dev),
                                      indexing="ij"), dim=-1)
    feats = grid[None].expand(b, h, w, 2)
    if color:
        feats = torch.cat([feats, x], dim=-1)
    dm = feats.shape[-1]
    freqs = torch.exp(_linspace(-2, 10, nf, dev))
    f = feats.double()[..., None, :] * freqs.double()[:, None]
    phases = [(f + bias.double().reshape(nf, dm)).float().reshape(
        b, h, w, nf * dm) for bias in biases]
    parts = [torch.sin(phases[0]), torch.cos(phases[1])]
    return torch.cat(parts + ([x] if color else []), dim=-1)


def _conv_bn_relu(p, x):
    y = _conv(p["conv"], x, padding=1)
    bn = p["bn"]
    y = (y - bn["mean"]) * torch.rsqrt(bn["var"] + 1e-5) * bn["scale"] \
        + bn["bias"]
    return torch.relu(y)


def loftup(P, cfg, feats, image):
    """``[B, h, w, D]`` features and the normalised ``[B, H, W, 3]`` image
    -> ``[B, H, W, D]``."""
    up, U = cfg["upsampler"], P["upsampler"]
    b, h, w, _ = image.shape
    src = _ln(U["channelnorm"]["norm"], feats, 1e-5)
    kv = torch.cat([src, _fourier(U["lr_pe"]["biases"], src,
                                  up["lr_pe_freqs"], False)], dim=-1)
    cdim = kv.shape[-1]
    kv = kv.reshape(b, -1, cdim)
    mn = image.amin(dim=(1, 2), keepdim=True)
    mx = image.amax(dim=(1, 2), keepdim=True)
    scaled = (image - mn) / torch.clamp(mx - mn, min=1e-4) - 0.5
    q = _ln(U["first_norm"]["norm"],
            _fourier(U["fourier_feat"]["biases"], scaled, up["n_freqs"],
                     True), 1e-5)
    q = _conv_bn_relu(U["first_conv2"], _conv_bn_relu(U["first_conv1"], q))
    q = q.reshape(b, h * w, cdim)
    heads = up["num_heads"]
    dh = cdim // heads
    T = U["ca_transformer"]
    for i in range(up["num_layers"]):
        ca, ff = T[f"ca_{i}"], T[f"ff_{i}"]
        att = ca["attention"]
        qn = _ln(ca["norm_q"], q, 1e-5)
        kn = _ln(ca["norm_kv"], kv, 1e-5)
        wi, bi = att["in_proj_weight"], att["in_proj_bias"]
        qq = F.linear(qn, wi[:cdim], bi[:cdim]).reshape(b, -1, heads, dh)
        kk = F.linear(kn, wi[cdim:2 * cdim], bi[cdim:2 * cdim]).reshape(
            b, -1, heads, dh)
        vv = F.linear(kn, wi[2 * cdim:], bi[2 * cdim:]).reshape(
            b, -1, heads, dh)
        a = _attention(qq, kk, vv, dh ** -0.5).reshape(b, -1, cdim)
        q = _dense(att["out_proj"], a) + q
        y = F.gelu(_dense(ff["fc1"], _ln(ff["norm"], q, 1e-5)))
        q = _dense(ff["fc2"], y) + q
    q = _ln(T["norm"], q, 1e-5).reshape(b, h, w, cdim)
    out = _conv(U["final_conv"], q)
    u = out.mean(dim=-1, keepdim=True)
    s = (out - u).square().mean(dim=-1, keepdim=True)
    out = (out - u) / torch.sqrt(s + 1e-6)
    return U["final_ln"]["weight"] * out + U["final_ln"]["bias"]


def head(P, cfg, x):
    H = P["head"]
    for i in range(cfg["head"]["num_layers"]):
        x = torch.relu(_conv(H[f"convs_{i}"], x, padding=1))
    return _conv(H["classifier"], x)[..., 0]


def forward(P, cfg, image, points, prev):
    """Logits ``[B, H, W]`` of crops ``image`` ``[B, H, W, 3]`` in [0, 1]
    with clicks ``points`` in crop coordinates and the previous
    probabilities ``prev`` ``[B, H, W]``."""
    enc = cfg["click_encoder"]
    if not (enc["use_disks"] and enc["with_prev_mask"]
            and cfg["backbone"]["injection"] == "before_backbone"):
        raise NotImplementedError("the reference draws disk clicks with the "
                                  "previous mask, added before the backbone")
    h, w = image.shape[1], image.shape[2]
    mean = torch.tensor(MEAN, device=image.device)
    std = torch.tensor(STD, device=image.device)
    norm = (image - mean) / std
    clicks = click_maps(points, prev, h, w, enc["radius"])
    feats = vit(P, cfg, norm, clicks)
    if cfg["upsampler"]["type"] == "loftup":
        return head(P, cfg, loftup(P, cfg, feats, norm))
    logits = head(P, cfg, feats)
    return F.interpolate(logits[:, None], size=(h, w), mode="bilinear",
                         align_corners=True)[:, 0]
