"""Transformer view fusion of the P5 tokens.

Port of `mulit_view_object_detection_tpu/models/transformer.py`
(model_transformer.py:102-364), with the flax layer names: the multi-view
P5 tokens, lifted to world xyz by `ops/projection.py::unproject_rays`,
get a 3-axis sinusoidal positional encoding, run through a post-LN
encoder, and a Linear over the TOKEN axis projects the V*fh*fw tokens to
target_size^2, reshaped to a [T, T] map.

Attention is plain matmul and softmax (no Pallas kernel stands behind it
in the JAX package). The dtype policy is flax's: the Dense layers compute
in the compute dtype, LayerNorm normalises in float32 and returns float32,
and the softmax runs in float32. Dropout follows flax's nn.Dropout (keep
with probability 1 - rate, scale by 1 / (1 - rate)), its masks drawn from
an explicit torch.Generator; without one the stack is deterministic.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import DenseGeneral, Linear


def positional_encoding_3d(positions, d_model):
    """positions [B, N, 3] world xyz -> [B, N, d_model]. Per axis, with
    npf = d_model / 3: angle(pos, i) = pos / 10000^(2*(i//2)/npf), emitted
    as [sin(a_0), cos(a_1), sin(a_2), cos(a_3), ...]."""
    npf = d_model // 3
    if d_model % 3 or npf % 2:
        raise ValueError(f"d_model {d_model}: needs d_model / 3 even")
    i = np.arange(npf)
    rates = torch.from_numpy((1.0 / np.power(
        10000.0, (2.0 * (i // 2)) / npf)).astype(np.float32)).to(
            positions.device)
    parts = []
    for ax in range(3):
        a = positions[..., ax:ax + 1] * rates            # [B, N, npf]
        pe = torch.stack([torch.sin(a[..., 0::2]), torch.cos(a[..., 1::2])],
                         dim=-1)
        parts.append(pe.reshape(a.shape[:-1] + (npf,)))
    return torch.cat(parts, dim=-1)


def dropout(x, rate, generator):
    """flax nn.Dropout with masks from `generator` (on any device);
    identity when generator is None or rate is 0."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator,
                      device=generator.device) < keep_prob
    return torch.where(keep.to(x.device), x / keep_prob, 0.0)


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm(epsilon=1e-6) with float32 parameters: normalises
    in float32 and returns float32."""

    def __init__(self, d_model):
        super().__init__(d_model, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class MultiHeadAttention(nn.Module):
    """flax nn.MultiHeadDotProductAttention as EncoderLayer calls it:
    self-attention, qkv and output features d_model, no mask, no attention
    dropout. query/key/value project [B, N, d] -> [B, N, heads, d/heads],
    out merges the heads back."""

    def __init__(self, d_model, num_heads):
        super().__init__()
        dh = d_model // num_heads
        self.head_dim = dh
        self.query = DenseGeneral((d_model,), (num_heads, dh))
        self.key = DenseGeneral((d_model,), (num_heads, dh))
        self.value = DenseGeneral((d_model,), (num_heads, dh))
        self.out = DenseGeneral((num_heads, dh), (d_model,))

    def forward(self, x):
        q = self.query(x)
        q = q / math.sqrt(self.head_dim)
        w = torch.einsum("bqhd,bkhd->bhqk", q, self.key(x))
        w = torch.softmax(w.float(), dim=-1).to(q.dtype)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, self.value(x)))


class EncoderLayer(nn.Module):
    """Post-LN encoder layer: x + attention, LayerNorm, x + FFN,
    LayerNorm; dropout after the attention and after the FFN."""

    def __init__(self, d_model, num_heads, dff, rate=0.1):
        super().__init__()
        self.rate = rate
        self.mha = MultiHeadAttention(d_model, num_heads)
        self.ln1 = LayerNorm(d_model)
        self.ffn1 = Linear(d_model, dff)
        self.ffn2 = Linear(dff, d_model)
        self.ln2 = LayerNorm(d_model)

    def forward(self, x, generator=None):
        attn = dropout(self.mha(x), self.rate, generator)
        out1 = self.ln1(x + attn)
        ffn = self.ffn2(F.relu(self.ffn1(out1)))
        ffn = dropout(ffn, self.rate, generator)
        return self.ln2(out1 + ffn)


class ViewFusionTransformer(nn.Module):
    """tokens [B, N, d_model] and positions [B, N, 3] -> fused
    [B, T, T, d_model], T = target_size. `num_tokens` is N (the token
    projection's input width). `faithful_output` transposes the output
    map, as the reference's unflattening does (model_transformer.py:
    362-364)."""

    def __init__(self, num_layers, d_model, num_heads, dff, target_size,
                 num_tokens, rate=0.1, faithful_output=False):
        super().__init__()
        self.d_model = d_model
        self.target_size = target_size
        self.rate = rate
        self.faithful_output = faithful_output
        self.num_layers = num_layers
        for li in range(num_layers):
            self.add_module(f"layer{li}",
                            EncoderLayer(d_model, num_heads, dff, rate))
        self.token_proj = Linear(num_tokens, target_size ** 2)

    def forward(self, tokens, positions, generator=None):
        b, n, d = tokens.shape
        if d != self.d_model or n != self.token_proj.in_features:
            raise ValueError(f"tokens {tuple(tokens.shape)}: expected "
                             f"[B, {self.token_proj.in_features}, "
                             f"{self.d_model}]")
        x = tokens * tokens.new_tensor(float(d)).sqrt()
        x = x + positional_encoding_3d(positions, d)
        x = dropout(x, self.rate, generator)
        for li in range(self.num_layers):
            x = getattr(self, f"layer{li}")(x, generator)
        x = self.token_proj(x.transpose(1, 2))            # [B, d, T^2]
        t = self.target_size
        x = x.transpose(1, 2).reshape(b, t, t, d)
        if self.faithful_output:
            x = x.transpose(1, 2)
        return x
