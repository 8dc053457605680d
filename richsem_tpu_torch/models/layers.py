"""Shared layers (counterpart of ``richsem_tpu/models/layers.py``).

Precision follows the flax modules cast for cast: a layer built with
``dtype=compute_dtype`` casts its input and weights to that dtype and returns
it; a layer with ``dtype=None`` promotes input and (f32) weights, so it
computes in float32. Normalizations take their statistics in float32 from the
mean and the mean of squares (flax's fast variance) and return float32.

Each module fills its parameters from an explicit ``torch.Generator`` in
``init_weights``, following the flax initializers (normal draws where flax
uses truncated ones).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from richsem_tpu_torch.ops.ms_deform_attn import (
    compute_sampling_locations,
    ms_deform_attn,
    tiled_supported,
)
from richsem_tpu_torch.ops.ms_deform_attn_sep import ms_deform_attn_sep


# ---------------------------------------------------------------------------
# initializers (explicit generator; tensors filled in place)
# ---------------------------------------------------------------------------
def _fans(w: torch.Tensor) -> Tuple[int, int]:
    receptive = math.prod(w.shape[2:]) if w.dim() > 2 else 1
    return w.shape[1] * receptive, w.shape[0] * receptive  # (fan_in, fan_out)


@torch.no_grad()
def normal_(w: torch.Tensor, g: torch.Generator, std: float) -> None:
    w.copy_(torch.randn(w.shape, generator=g, device=w.device, dtype=w.dtype) * std)


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    normal_(w, g, 1.0 / math.sqrt(_fans(w)[0]))


@torch.no_grad()
def xavier_uniform_(w: torch.Tensor, g: torch.Generator) -> None:
    fan_in, fan_out = _fans(w)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(w.shape, generator=g, device=w.device, dtype=w.dtype)
    w.copy_((2.0 * u - 1.0) * limit)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``nn.Dropout(rate)``: each element kept with probability ``1 - rate`` and
    scaled by its inverse, the mask drawn from ``generator`` on ``x``'s device
    (a uniform below ``1 - rate`` keeps); ``generator`` None (inference, or
    deterministic) or ``rate`` 0 returns ``x``."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: the same values as ``clamp``, and the same gradient, which
    is 1/2 at a value equal to a bound (``clamp`` gives 1 there)."""
    def bound(v):  # filled on the device: no host-to-device copy
        return torch.full((), v, dtype=x.dtype, device=x.device)

    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


# ---------------------------------------------------------------------------
# flax-semantics building blocks
# ---------------------------------------------------------------------------
class Dense(nn.Linear):
    """``nn.Dense``: ``dtype`` casts input, weight and bias; None promotes."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        y = x.to(dt) @ self.weight.to(dt).t()
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y

    def init_weights(self, g: torch.Generator) -> None:
        lecun_normal_(self.weight, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class LayerNorm(nn.Module):
    """``nn.LayerNorm`` over the last axis; f32 statistics and output."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias

    def init_weights(self, g: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class GroupNorm(LayerNorm):
    """``nn.GroupNorm`` on channel-last ``[B, H, W, C]``; f32 statistics and output."""

    def __init__(self, dim: int, num_groups: int = 32, eps: float = 1e-5, device=None):
        super().__init__(dim, eps, device)
        self.num_groups = num_groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        xg = x.float().reshape(b, h * w, self.num_groups, c // self.num_groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = ((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp(min=0.0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, h, w, c)
        return y * self.weight + self.bias


def same_pads(size: Sequence[int], kernel: Sequence[int], stride: Sequence[int]):
    """flax's ``padding="SAME"`` (``lax.padtype_to_pads``) as ``F.pad``'s
    ``(left, right, top, bottom)``: ``ceil(n / s)`` outputs along each side, the
    padding split with its smaller half first."""
    pads = []
    for n, k, s in zip(size, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    return (left, right, top, bottom)


class Conv(nn.Conv2d):
    """``nn.Conv`` with channel-last ``[B, H, W, C]`` in and out (NCHW inside).

    ``padding`` is a number of pixels on every side, or ``"same"`` for flax's
    default ``"SAME"``; ``groups`` is flax's ``feature_group_count`` (``groups``
    equal to the channels is a depthwise convolution)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: Union[int, str] = 0, bias: bool = True, groups: int = 1,
                 dtype: Optional[torch.dtype] = None, device=None):
        same = padding == "same"
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0 if same else padding,
                         bias=bias, groups=groups, device=device)
        self.same = same
        self.compute_dtype = dtype

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        x = x.to(dt)
        if self.same:
            x = F.pad(x, same_pads(x.shape[2:], self.kernel_size, self.stride))
        y = F.conv2d(x, self.weight.to(dt), None, self.stride, self.padding,
                     groups=self.groups)
        if self.bias is None:
            return y
        # flax adds the bias to the rounded product (F.conv2d would add it before
        # rounding a bf16 result)
        return y + self.bias.to(dt)[:, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def init_weights(self, g: torch.Generator) -> None:
        lecun_normal_(self.weight, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class MLP(nn.Module):
    """n-layer perceptron ``layer0..layer{n-1}``; relu between layers, none after the last."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int,
                 device=None):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            self.add_module(f"layer{i}", Dense(dims[i], dims[i + 1], device=device))

    def layers(self):
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *hidden, last = self.layers()
        for layer in hidden:
            x = torch.relu(layer(x))
        return last(x)

    def init_weights(self, g: torch.Generator) -> None:
        for layer in self.layers():
            layer.init_weights(g)


# ---------------------------------------------------------------------------
# model layers
# ---------------------------------------------------------------------------
def _directional_offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Ring init: head m points along angle 2*pi*m/M, point p at radius p+1."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for p in range(n_points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention: value/offset/attention/output heads + K1.

    The offset clamp is the JAX package's rule copied exactly
    (``richsem_tpu/models/layers.py:144-172``): offsets are bounded to
    ``+-(margin - 0.5)`` iff ``impl`` is a windowed one (tiled / pallas /
    pallas2), the queries are the value tokens (``q == s``), the pyramid
    admits the tile plan, and ``clamp_offsets`` is set. It never depends on
    the device. The sampler is routed as JAX routes it
    (``layers.py:201-220``): ``impl="sep_pallas"`` goes to the separable
    sampler (K3, with the TPU kernel's bf16 rounding), every other ``impl`` to
    the exact gather (K1), which computes what the other JAX samplers compute
    once the clamp rule is applied.
    """

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, compute_dtype: torch.dtype = torch.float32,
                 impl: str = "gather", tiled_margin: int = 8,
                 tiled_tile: Tuple[int, int] = (16, 16), clamp_offsets: bool = True,
                 device=None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError("d_model must divide n_heads")
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.impl = impl
        self.tiled_margin = tiled_margin
        self.tiled_tile = tuple(tiled_tile)
        self.clamp_offsets = clamp_offsets
        mlp = n_heads * n_levels * n_points
        self.value_proj = Dense(d_model, d_model, dtype=compute_dtype, device=device)
        self.sampling_offsets = Dense(d_model, mlp * 2, device=device)
        self.attention_weights = Dense(d_model, mlp, device=device)
        self.output_proj = Dense(d_model, d_model, dtype=compute_dtype, device=device)

    def windowed(self, q: int, s: int, spatial_shapes) -> bool:
        """Whether JAX would route this call to a windowed kernel (``use_tiled``)."""
        return (self.impl in ("tiled", "pallas", "pallas2") and q == s
                and tiled_supported(spatial_shapes, self.tiled_tile))

    def clamps(self, q: int, s: int, spatial_shapes) -> bool:
        return self.windowed(q, s, spatial_shapes) and self.clamp_offsets

    def forward(
        self,
        query: torch.Tensor,  # [B, Q, C]
        reference_points: torch.Tensor,  # [B, Q, L, 2|4], sigmoid space
        value_src: torch.Tensor,  # [B, S, C]
        spatial_shapes: Sequence[Tuple[int, int]],
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] True=pad
        monitor: Optional[list] = None,
    ) -> torch.Tensor:
        """With a ``monitor`` list, a windowed call appends the fraction of
        offsets at or beyond ``margin - 0.5`` (``layers.py:157-169``)."""
        b, q, _ = query.shape
        s = value_src.shape[1]
        m, l, p = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value_src)
        if key_padding_mask is not None:
            value = value.masked_fill(key_padding_mask[..., None], 0.0)
        value = value.reshape(b, s, m, self.d_model // m)
        query = query.float()
        offsets = self.sampling_offsets(query).reshape(b, q, m, l, p, 2)
        attn = self.attention_weights(query).reshape(b, q, m, l * p)
        attn = torch.softmax(attn, dim=-1).reshape(b, q, m, l, p)
        bound = float(self.tiled_margin) - 0.5
        if monitor is not None and self.windowed(q, s, spatial_shapes):
            beyond = offsets.detach().abs().amax(-1) >= bound
            monitor.append(beyond.float().mean())
        if self.clamps(q, s, spatial_shapes):
            offsets = clip(offsets, -bound, bound)
        loc = compute_sampling_locations(
            reference_points.float(), offsets, spatial_shapes, p
        )
        sampler = ms_deform_attn_sep if self.impl == "sep_pallas" else ms_deform_attn
        out = sampler(value, spatial_shapes, loc, attn)
        return self.output_proj(out)

    def init_weights(self, g: torch.Generator) -> None:
        xavier_uniform_(self.value_proj.weight, g)
        nn.init.zeros_(self.value_proj.bias)
        nn.init.zeros_(self.sampling_offsets.weight)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(torch.from_numpy(
                _directional_offset_bias(self.n_heads, self.n_levels, self.n_points)
            ))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        xavier_uniform_(self.output_proj.weight, g)
        nn.init.zeros_(self.output_proj.bias)


class MultiHeadAttention(nn.Module):
    """``nn.MultiHeadDotProductAttention`` with ``dtype``: q/k/v/out projections and
    the attention in ``dtype``, q scaled by 1/sqrt(head_dim) before the product;
    ``mask`` True means attend. With a ``generator`` the attention weights take
    dropout at ``dropout_rate`` (flax's ``dropout_rate``, in training)."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype, device=None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Dense(dim, dim, dtype=dtype, device=device))

    def forward(self, inputs_q, inputs_k, inputs_v, mask=None, generator=None):
        b, lq, d = inputs_q.shape
        h = self.num_heads
        q = self.query(inputs_q).reshape(b, lq, h, d // h)
        k = self.key(inputs_k).reshape(b, inputs_k.shape[1], h, d // h)
        v = self.value(inputs_v).reshape(b, inputs_v.shape[1], h, d // h)
        q = q / math.sqrt(d // h)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
        w = dropout(torch.softmax(w, dim=-1), self.dropout_rate, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, lq, d)
        return self.out(out)

    def init_weights(self, g: torch.Generator) -> None:
        for name in ("query", "key", "value", "out"):
            getattr(self, name).init_weights(g)


class InputProj(nn.Module):
    """1x1 conv (or 3x3 stride-2 conv for the extra level) + GroupNorm(32); NHWC."""

    def __init__(self, in_ch: int, hidden_dim: int = 256, extra_level: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if extra_level:
            self.conv = Conv(in_ch, hidden_dim, 3, stride=2, padding=1, dtype=dtype,
                             device=device)
        else:
            self.conv = Conv(in_ch, hidden_dim, 1, dtype=dtype, device=device)
        self.norm = GroupNorm(hidden_dim, 32, 1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))

    def init_weights(self, g: torch.Generator) -> None:
        xavier_uniform_(self.conv.weight, g)
        nn.init.zeros_(self.conv.bias)
        self.norm.init_weights(g)


class FFN(nn.Module):
    """Feed-forward block with residual + LayerNorm (linear1/linear2 in
    ``compute_dtype``): relu or flax's ``nn.gelu`` (the tanh form, one pass),
    and with a ``generator`` dropout after the activation and after linear2."""

    def __init__(self, d_model: int, d_ffn: int, activation: str = "relu",
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.act = {"relu": torch.relu,
                    "gelu": lambda t: F.gelu(t, approximate="tanh")}[activation]
        self.linear1 = Dense(d_model, d_ffn, dtype=compute_dtype, device=device)
        self.linear2 = Dense(d_ffn, d_model, dtype=compute_dtype, device=device)
        self.norm = LayerNorm(d_model, 1e-5, device=device)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = dropout(self.act(self.linear1(x)), self.dropout_rate, generator)
        h = dropout(self.linear2(h), self.dropout_rate, generator)
        return self.norm(x + h)

    def init_weights(self, g: torch.Generator) -> None:
        self.linear1.init_weights(g)
        self.linear2.init_weights(g)
        self.norm.init_weights(g)
