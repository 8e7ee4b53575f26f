"""Flax's layers as the JAX package's models compute them, in PyTorch.

The JAX models are Flax modules; their layers differ from torch's
defaults in ways that move the last digits or more:

- ``BatchNorm``: ``(x - mean) * (scale * rsqrt(var + eps)) + bias`` with
  Flax's epsilon 1e-5, over the channel axis 1 of (B, C) rows or (B, C,
  H, W) maps.  In train mode the statistics are the batch's, in f32 even
  under bf16 activations, with Flax's fast variance ``max(0, mean(x^2) -
  mean(x)^2)``, and the running ones move as ``0.99 * running + 0.01 *
  batch`` with the biased variance (torch's own train mode folds Bessel's
  correction into ``running_var``).
- ``dropout``: Flax's ``nn.Dropout``, kept values divided by the keep
  probability, the mask drawn from an explicit ``torch.Generator`` (or a
  ``BatchMasks``: a mesh step's row blocks sharing the whole batch's
  draws).
- ``clip``: ``jnp.clip``, whose gradient is halved where a value sits on
  a bound (JAX's ``maximum``/``minimum`` split a tie; ``torch.clamp``
  passes it whole).
- ``LayerNorm``: epsilon 1e-6 (torch's is 1e-5) and Flax's fast variance
  ``max(0, mean(x^2) - mean(x)^2)``, then ``(x - mean) * (rsqrt(var +
  eps) * scale) + bias``.
- ``MultiHeadDotProductAttention``: the query scaled by ``1/sqrt(hd)``
  before the dot, the softmax in f32, then the ``out`` DenseGeneral over
  (heads, hd).  Its four projections are ``HeadsLinear`` (a
  ``Linear(dim, dim)``), which ``models/bridge`` maps to Flax's
  (dim, heads, hd) and (heads, hd, dim) kernels.
- ``conv2d_same``: Flax's default ``'SAME'`` padding, which at stride > 1
  puts the odd pad on the high side (a 3x3 stride-2 conv of an even side
  pads (0, 1), not torch's (1, 1)).

``no_tf32`` keeps cuDNN's convolutions and cuBLAS's matmuls in full f32
for a block: cuDNN computes f32 convolutions in TF32 by default (three
decimal digits), and the JAX models compute in f32.  Every f32 forward of
the port's models runs under it, looked up on this module at each call.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def no_tf32():
    """cuDNN's f32 convolutions and cuBLAS's f32 matmuls in full f32 for
    the block; the caller's settings are restored after it."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``torch.clamp``'s values; where x needs a
    gradient, JAX's (``maximum`` then ``minimum``, half the gradient to a
    value on a bound)."""
    if not x.requires_grad:
        return torch.clamp(x, lo, hi)
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


class BatchMasks:
    """The dropout draws of one global batch, shared by its row blocks.  A
    mesh step runs its positions' blocks one after another; ``block(rows)``
    starts a position, whose k-th dropout call reads rows ``rows`` of the
    batch's k-th draw: uniforms of the whole batch's shape from
    ``generator`` on its device, drawn by the first block to reach that
    call.  The blocks therefore see the masks that one call on the whole
    batch draws."""

    def __init__(self, generator: torch.Generator, batch: int):
        self.generator, self.batch = generator, batch
        self._draws: list = []
        self._rows, self._next = slice(None), 0

    def block(self, rows: slice) -> "BatchMasks":
        self._rows, self._next = rows, 0
        return self

    def uniform(self, shape, device: torch.device) -> torch.Tensor:
        if self._next == len(self._draws):
            self._draws.append(torch.rand(
                (self.batch,) + tuple(shape[1:]), generator=self.generator,
                device=self.generator.device))
        u = self._draws[self._next][self._rows]
        self._next += 1
        return u.to(device)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator=None) -> torch.Tensor:
    """Flax's ``nn.Dropout(rate)``: in train mode each value is kept with
    probability ``1 - rate`` (the mask drawn from ``generator``, which
    lies on x's device, or read from a ``BatchMasks``; torch's default
    generator where None) and divided by it; the identity otherwise."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    if isinstance(generator, BatchMasks):
        u = generator.uniform(x.shape, x.device)
    else:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over axis 1 of (B, C) or (B, C, H, W) with Flax's
    defaults and arithmetic.  ``momentum`` keeps torch's meaning, the
    weight of the batch statistic (0.01: Flax's momentum 0.99)."""

    def __init__(self, n: int):
        super().__init__(n, eps=1e-5, momentum=0.01)

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"expected (B, C) or (B, C, H, W), got {x.dim()}-D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        view = (-1,) + (1,) * (x.dim() - 2)
        x32 = x.float()
        if self.training:
            dims = (0,) + tuple(range(2, x.dim()))
            mean = x32.mean(dims)
            var = torch.maximum(x32.square().mean(dims) - mean.square(),
                                mean.new_zeros(()))
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1.0 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var
                                       + m * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = (torch.rsqrt(var + self.eps) * self.weight).view(view)
        y = (x32 - mean.view(view)) * mul + self.bias.view(view)
        return y.to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm`` over the last axis (epsilon 1e-6, the fast
    variance, Flax's order of the affine step)."""

    def __init__(self, n: int):
        super().__init__(n, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class HeadsLinear(nn.Linear):
    """A Flax ``DenseGeneral`` of attention as a ``Linear(dim, dim)``:
    ``split="out"`` is a query, key or value projection (Flax kernel
    (dim, heads, hd), bias (heads, hd)), ``split="in"`` the output
    projection (kernel (heads, hd, dim), bias (dim,)).  Output feature
    ``h * hd + d`` is head h's d-th, torch's order of the heads."""

    def __init__(self, dim: int, heads: int, split: str):
        super().__init__(dim, dim)
        if split not in ("in", "out"):
            raise ValueError(f"split must be 'in' or 'out', not {split!r}")
        self.heads, self.split = heads, split


class MultiHeadDotProductAttention(nn.Module):
    """Flax's self-attention over (B, L, dim) tokens (no mask, no
    dropout)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        self.heads = heads
        for name in ("query", "key", "value"):
            self.add_module(name, HeadsLinear(dim, heads, "out"))
        self.out = HeadsLinear(dim, heads, "in")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, dim = x.shape
        hd = dim // self.heads

        def split(t):  # (B, L, dim) -> (B, heads, L, hd)
            return t.reshape(B, L, self.heads, hd).transpose(1, 2)

        q = split(self.query(x)) / math.sqrt(hd)
        k, v = split(self.key(x)), split(self.value(x))
        w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float(), -1)
        y = torch.matmul(w.to(v.dtype), v).transpose(1, 2).reshape(B, L, dim)
        return self.out(y)


def same_pads(n: int, k: int, s: int):
    """XLA's SAME padding of one side: (low, high), the odd one high."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias, stride: int = 1,
                groups: int = 1) -> torch.Tensor:
    """NCHW convolution with Flax's default ``'SAME'`` padding: padded
    explicitly (zeros), then convolved with none."""
    kh, kw = weight.shape[-2:]
    top, bottom = same_pads(x.shape[-2], kh, stride)
    left, right = same_pads(x.shape[-1], kw, stride)
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, stride, (top, left), groups=groups)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias,
                    stride, groups=groups)
