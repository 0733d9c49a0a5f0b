"""LoftUp, the coordinate-based cross-attention upsampler ('sine' LR-PE
variant, wrapped in a ChannelNorm on the input features).

Counterpart of ``isegprobe_tpu/models/upsamplers/loftup.py``:
  image -> per-sample min-max scale -> Fourier ``ImplicitFeaturizer``
  (n_freqs=20, learned biases) -> LayerNorm -> two 3x3 conv+BN+ReLU ->
  per-pixel queries; ChannelNorm-ed low-res features (+ sine PE, n_freqs=5)
  -> keys/values; a 2-layer cross-attention transformer; 1x1 conv +
  ConvNeXt LayerNorm.

The cross-attention has ~H·W queries against h·w keys and goes through
``ops.attention.mha`` (kernel D on a GPU); every flax LayerNorm goes through
``ops.layernorm`` (kernel B). Above ``query_chunk_min_pixels`` output pixels
the query side runs in horizontal slabs of ``query_chunk_rows`` rows with a
2-row stem halo, exactly as the JAX package bands it (at 448² that is 7
slabs of 64 rows, so 14 kernel-D launches per forward). Under autograd each
slab is checkpointed, as the JAX package's ``nn.remat`` of the slab body
does: the backward recomputes one slab at a time instead of keeping every
slab's activations, so a slab's B and D launches run again in the
backward. Module and parameter names follow the JAX param tree (``ca.i``
for ``ca_i``). Every layer computes in the compute dtype
(``models/dtype.py``) as the JAX module's ``dtype``: its LayerNorms take
their input as it comes and cast their output (flax's ``nn.LayerNorm``),
the ConvNeXt LayerNorm casts its parameters, the Fourier phases stay
float32, and the FrozenBatchNorm parameters are raw.

``mxu_pad=True`` is the zero-padded layout of the same function: the stem
widths pad from 203 to 256, cdim from 404 to 512 and the head dim from 101
to 128, the weights padded once (``models.convert.pad_loftup_params``), the
LayerNorm statistics taken over the real channels only (kernel B's
``real``), and the softmax scale kept at the real head's ``101**-0.5``.
``forward(..., tail=head.banded, tail_halo=head.tail_halo)`` runs a head
inside the slab loop (``fuse_hr_head``), so the ``[B, H, W, n_dim]``
feature map never exists whole; the fused slabs are not checkpointed, as
in the JAX package (serving only).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from isegprobe_torch.models.dtype import Conv2d, Linear, compute_dtype
from isegprobe_torch.models.upsamplers.lift import FrozenBatchNorm, conv1x1
from isegprobe_torch.models.vit import LayerNorm
from isegprobe_torch.ops.attention import mha
from isegprobe_torch.ops.grid import linspace

LN_EPS = 1e-5


def _align(n: int) -> int:
    """``n`` rounded up to a multiple of 128 (the padded layout's widths)."""
    return -(-n // 128) * 128


def _pad_ch(x: torch.Tensor, to: int) -> torch.Tensor:
    """Zero-pad the channel axis to ``to`` (a no-op at that width)."""
    return x if x.shape[-1] == to else F.pad(x, (0, to - x.shape[-1]))


class ChannelNorm(nn.Module):
    """LayerNorm over the channel axis (flax's, eps 1e-5); ``real``: the
    statistics cover the first ``real`` channels (the padded layout)."""

    def __init__(self, dim: int, real: int = 0) -> None:
        super().__init__()
        self.norm = LayerNorm(dim, LN_EPS, real=real)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class ConvNeXtLayerNorm(nn.Module):
    """Channel LayerNorm with two-pass variance and eps inside the sqrt,
    statistics in float32, output in the compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        u = xf.mean(dim=-1, keepdim=True)
        s = (xf - u).square().mean(dim=-1, keepdim=True)
        dt = compute_dtype(self, self.weight)
        x = ((xf - u) / torch.sqrt(s + self.eps)).to(dt)
        return self.weight.to(dt) * x + self.bias.to(dt)


def min_max_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-sample per-channel spatial min-max of ``[B, H, W, C]`` to
    [-0.5, 0.5]. Per sample, not per batch, so device-loop lanes stay
    independent (the JAX package's reasoning, ``loftup.py:min_max_scale``)."""
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    return (x - mn) / torch.clamp(mx - mn, min=1e-4) - 0.5


class ImplicitFeaturizer(nn.Module):
    """Fourier features of the pixel grid (+ the color channels) with
    learned biases (LoftUp builds both of its featurizers with them), and
    the reference's quirk: ``biases`` is stored ``[2, dim_mult, n_freqs]``
    but reinterpreted as ``[n_freqs, dim_mult]`` when added. Phases are
    float32 whatever the dtype, each rounded once from its exact
    multiply-add (as XLA's fused multiply-add rounds it); only the bounded
    sin/cos outputs take the compute dtype."""

    def __init__(self, color_feats: bool = True, n_freqs: int = 10) -> None:
        super().__init__()
        self.color_feats = color_feats
        self.n_freqs = n_freqs
        self.dim_mult = 2 + (3 if color_feats else 0)
        self.biases = nn.Parameter(torch.zeros(2, self.dim_mult, n_freqs))

    def forward(self, x: torch.Tensor,
                row_coords: torch.Tensor | None = None) -> torch.Tensor:
        """``row_coords`` overrides the row grid: the banded query path
        evaluates a slab at its global coordinates."""
        b, h, w, _ = x.shape
        nf, dm = self.n_freqs, self.dim_mult
        gh = (row_coords if row_coords is not None
              else linspace(-1.0, 1.0, h, device=x.device))
        gw = linspace(-1.0, 1.0, w, device=x.device)
        grid = torch.stack(torch.meshgrid(gh, gw, indexing="ij"), dim=-1)
        feats = grid[None].expand(b, h, w, 2)
        if self.color_feats:
            feats = torch.cat([feats, x.float()], dim=-1)
        freqs = torch.exp(linspace(-2.0, 10.0, nf, device=x.device))
        # f: [B, H, W, nf, dm]. XLA compiles each phase's multiply and add
        # into one fused multiply-add, which rounds once: the float32
        # product is exact in float64, and at phases up to ~2e4 a second
        # rounding moves sin by up to 2e-3
        f = feats.double()[..., None, :] * freqs.double()[:, None]
        biases = self.biases.double()
        sin_f = (f + biases[0].reshape(nf, dm)).float().reshape(
            b, h, w, nf * dm)
        cos_f = (f + biases[1].reshape(nf, dm)).float().reshape(
            b, h, w, nf * dm)
        dtype = compute_dtype(self, self.biases)
        parts = [torch.sin(sin_f).to(dtype), torch.cos(cos_f).to(dtype)]
        if self.color_feats:
            parts.append(x.to(dtype))
        return torch.cat(parts, dim=-1)


class TorchMHA(nn.Module):
    """``torch.nn.MultiheadAttention``-style cross-attention: packed
    ``in_proj_weight [3d, d]``, head dim ``d // heads``, attention through
    ``ops.attention.mha``. ``real_dim``: the padded layout's real width,
    whose head dim gives the softmax scale (the padded head's zero tail
    adds nothing to the logits)."""

    def __init__(self, dim: int, heads: int, real_dim: int = 0) -> None:
        super().__init__()
        self.dim, self.heads = dim, heads
        self.scale = ((real_dim or dim) // heads) ** -0.5
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)

    def forward(self, q_in: torch.Tensor,
                kv_in: torch.Tensor) -> torch.Tensor:
        d, heads = self.dim, self.heads
        dh = d // heads
        dt = compute_dtype(self, self.in_proj_weight)
        w, bias = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        q_in, kv_in = q_in.to(dt), kv_in.to(dt)
        q = F.linear(q_in, w[:d], bias[:d])
        k = F.linear(kv_in, w[d:2 * d], bias[d:2 * d])
        v = F.linear(kv_in, w[2 * d:], bias[2 * d:])
        b, nq, nk = q.shape[0], q.shape[1], k.shape[1]
        out = mha(q.reshape(b, nq, heads, dh), k.reshape(b, nk, heads, dh),
                  v.reshape(b, nk, heads, dh), scale=self.scale)
        return self.out_proj(out.reshape(b, nq, d))


class CrossAttentionLayer(nn.Module):
    def __init__(self, dim: int, heads: int, real_dim: int = 0) -> None:
        super().__init__()
        self.norm_q = LayerNorm(dim, LN_EPS, real=real_dim)
        self.norm_kv = LayerNorm(dim, LN_EPS, real=real_dim)
        self.attention = TorchMHA(dim, heads, real_dim)

    def forward(self, query: torch.Tensor,
                key_value: torch.Tensor) -> torch.Tensor:
        return self.attention(self.norm_q(query), self.norm_kv(key_value))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, real_dim: int = 0) -> None:
        super().__init__()
        self.norm = LayerNorm(dim, LN_EPS, real=real_dim)
        self.fc1 = Linear(dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.norm(x)), approximate="none"))


class CATransformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int,
                 mlp_dim: int, real_dim: int = 0) -> None:
        super().__init__()
        self.ca = nn.ModuleList(CrossAttentionLayer(dim, heads, real_dim)
                                for _ in range(depth))
        self.ff = nn.ModuleList(FeedForward(dim, mlp_dim, real_dim)
                                for _ in range(depth))
        self.norm = LayerNorm(dim, LN_EPS, real=real_dim)

    def forward(self, query: torch.Tensor,
                key_value: torch.Tensor) -> torch.Tensor:
        dtype = compute_dtype(self, self.norm.weight)
        query, key_value = query.to(dtype), key_value.to(dtype)
        for ca, ff in zip(self.ca, self.ff):
            query = ca(query, key_value) + query
            query = ff(query) + query
        return self.norm(query)


class ConvBNRelu(nn.Module):
    """3x3 conv (zero padding 1) + FrozenBatchNorm + ReLU on NHWC."""

    def __init__(self, in_features: int, features: int) -> None:
        super().__init__()
        self.conv = Conv2d(in_features, features, 3, padding=1)
        self.bn = FrozenBatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return torch.relu(self.bn(x)).to(compute_dtype(self,
                                                        self.conv.weight))


class LoftUpUpsampler(nn.Module):
    """``forward(source [B, h, w, n_dim], guidance [B, H, W, 3])`` ->
    ``[B, H, W, n_dim]``.

    ``upsampler_path`` (the frozen weights' file) and ``attn_impl`` are
    accepted for config compatibility and not read: weights come through
    the bridge (``models.convert.load_jax_params``, which raises if the
    upsampler's subtree is missing), and the port picks its attention path
    by device. With ``mxu_pad`` the module takes the padded tree of
    ``models.convert.pad_loftup_params``.
    """

    def __init__(self, n_dim: int = 384, n_freqs: int = 20,
                 num_heads: int = 4, num_layers: int = 2,
                 upsampler_path: str | None = None, attn_impl: str = "auto",
                 query_chunk_rows: int = 64,
                 query_chunk_min_pixels: int = 120_000,
                 mxu_pad: bool = False) -> None:
        super().__init__()
        self.n_dim = n_dim
        self.mxu_pad = mxu_pad
        self.query_chunk_rows = query_chunk_rows
        self.query_chunk_min_pixels = query_chunk_min_pixels
        creal = n_dim + 2 * 5 * 2  # + sine PE (no color, n_freqs=5)
        stem_real = 2 * n_freqs * 5 + 3
        self.cdim = _align(creal) if mxu_pad else creal
        self.stem = _align(stem_real) if mxu_pad else stem_real
        self.channelnorm = ChannelNorm(n_dim)
        self.lr_pe = ImplicitFeaturizer(False, 5)
        self.fourier_feat = ImplicitFeaturizer(True, n_freqs)
        self.first_norm = ChannelNorm(self.stem,
                                      real=stem_real if mxu_pad else 0)
        self.first_conv1 = ConvBNRelu(self.stem, self.cdim)
        self.first_conv2 = ConvBNRelu(self.cdim, self.cdim)
        self.ca_transformer = CATransformer(self.cdim, num_layers, num_heads,
                                            n_dim,
                                            creal if mxu_pad else 0)
        self.final_conv = Conv2d(self.cdim, n_dim, 1)
        self.final_ln = ConvNeXtLayerNorm(n_dim)

    def _head(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """Cross-attention and output head of a stem output [b, r, w, cdim]."""
        b, rows, w, _ = x.shape
        out = self.ca_transformer(x.reshape(b, rows * w, self.cdim), kv)
        out = out.reshape(b, rows, w, self.cdim)
        return self.final_ln(conv1x1(self.final_conv, out))

    def _stem(self, x: torch.Tensor, row_coords=None) -> torch.Tensor:
        """Fourier features (zero-padded to the stem width) and their
        norm."""
        return self.first_norm(_pad_ch(
            self.fourier_feat(x, row_coords=row_coords), self.stem))

    def _slab(self, x_rows, kv, row_coords, in_frame):
        """Query tower of one horizontal slab with its 2-row halo: Fourier
        stem -> convs (out-of-frame rows re-zeroed after the norm and the
        first conv, as the monolithic convs' zero padding would) ->
        cross-attention -> head."""
        frame = in_frame[None, :, None, None]
        xb = self._stem(x_rows, row_coords)
        xb = self.first_conv1(xb * frame)[:, 1:-1] * frame[:, 1:-1]
        xb = self.first_conv2(xb)[:, 1:-1]  # [b, chunk, w, cdim], exact
        return self._head(xb, kv)

    def forward(self, source: torch.Tensor, guidance: torch.Tensor,
                tail=None, tail_halo: int = 0) -> torch.Tensor:
        """``tail(x, in_frame)``: a head's ``banded`` contract, applied to
        the output rows with ``tail_halo`` more rows each side (zeroed
        where ``in_frame`` is 0, outside the frame), inside the slab loop
        (or once, on the whole frame, below the banding threshold)."""
        source = self.channelnorm(source)
        b = source.shape[0]
        # keys/values: low-res features + sine positional features
        kv = torch.cat([source, self.lr_pe(source).to(source.dtype)], dim=-1)
        kv = _pad_ch(kv, self.cdim).reshape(b, -1, self.cdim)

        h, w = guidance.shape[1], guidance.shape[2]
        x_scaled = min_max_scale(guidance)  # full frame, per sample
        chunk = self.query_chunk_rows
        if chunk > 0:  # largest divisor of h not above the requested rows
            while h % chunk:
                chunk -= 1
        th = tail_halo if tail is not None else 0
        if not (0 < chunk < h and h * w > self.query_chunk_min_pixels):
            x = self.first_conv2(self.first_conv1(self._stem(x_scaled)))
            out = self._head(x, kv)
            if tail is None:
                return out
            # the monolithic head's zero padding, as zero halo rows
            out = F.pad(out, (0, 0, 0, 0, th, th))
            return tail(out, F.pad(out.new_ones(h, dtype=torch.float32),
                                   (th, th)))

        rows = linspace(-1.0, 1.0, h, device=guidance.device)
        slab = self._slab
        if tail is None and torch.is_grad_enabled():
            slab = functools.partial(checkpoint, self._slab,
                                     use_reentrant=False,
                                     preserve_rng_state=False)
        outs = []
        for r0 in range(0, h, chunk):
            # the slab, its 2-row stem halo and the tail's halo rows
            band = torch.arange(r0 - 2 - th, r0 + chunk + 2 + th,
                                device=guidance.device)
            idx = band.clamp(0, h - 1)
            in_frame = ((band >= 0) & (band < h)).to(x_scaled.dtype)
            hr = slab(x_scaled[:, idx], kv, rows[idx], in_frame)
            # the stem took its 2-row halo: in_frame[2:-2] marks the rest
            outs.append(hr if tail is None else tail(hr, in_frame[2:-2]))
        return torch.cat(outs, dim=1)
