"""Flax's layers as the JAX package's models compute them, in PyTorch.

The JAX models are Flax modules; their layers differ from torch's
defaults in ways that move the last digits or more:

- ``BatchNorm``: ``(x - mean) * (scale * rsqrt(var + eps)) + bias`` with
  Flax's epsilon 1e-5, over the channel axis 1 of (B, C) rows or (B, C,
  H, W) maps.  In train mode the statistics are the batch's, in f32 even
  under bf16 activations (x promoted to at least f32, as Flax promotes
  it: f64 stays f64), with Flax's fast variance ``max(0, mean(x^2) -
  mean(x)^2)``, and the running ones move as ``0.99 * running + 0.01 *
  batch`` with the biased variance (torch's own train mode folds Bessel's
  correction into ``running_var``).  Inside ``MeshThreads.run`` the
  statistics are those of the whole batch over the mesh's positions, as
  in JAX's sharded step (``MeshStats``).
- ``dropout``: Flax's ``nn.Dropout``, kept values divided by the keep
  probability, the mask drawn from an explicit ``torch.Generator`` (or a
  ``BatchMasks`` block: a mesh step's row blocks sharing the whole batch's
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
import itertools
import math
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, List, Optional

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
    """The dropout draws of one global batch, shared by its row blocks.
    ``block(rows)`` is a position's view, whose k-th dropout call reads
    rows ``rows`` of the batch's k-th draw: uniforms of the whole batch's
    shape from ``generator`` on its device, drawn by the first block to
    reach that call (under a lock, as the positions run on threads of
    their own, so the k-th draw is the generator's k-th).  The blocks
    therefore see the masks that one call on the whole batch draws."""

    def __init__(self, generator: torch.Generator, batch: int):
        self.generator, self.batch = generator, batch
        self._draws: list = []
        self._lock = threading.Lock()

    def block(self, rows: slice) -> "MaskRows":
        return MaskRows(self, rows)

    def draw(self, k: int, shape) -> torch.Tensor:
        """The batch's k-th draw (drawn now if no block has reached it)."""
        with self._lock:
            if k == len(self._draws):
                self._draws.append(torch.rand(
                    (self.batch,) + tuple(shape[1:]), generator=self.generator,
                    device=self.generator.device))
            return self._draws[k]


class MaskRows:
    """One position's rows of a ``BatchMasks``' draws, call after call."""

    def __init__(self, masks: BatchMasks, rows: slice):
        self.masks, self.rows = masks, rows
        self._calls = itertools.count()

    def uniform(self, shape, device: torch.device) -> torch.Tensor:
        return self.masks.draw(next(self._calls), shape)[self.rows].to(device)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator=None) -> torch.Tensor:
    """Flax's ``nn.Dropout(rate)``: in train mode each value is kept with
    probability ``1 - rate`` (the mask drawn from ``generator``, which
    lies on x's device, or read from a ``BatchMasks`` block; torch's default
    generator where None) and divided by it; the identity otherwise."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    if isinstance(generator, MaskRows):
        u = generator.uniform(x.shape, x.device)
    else:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


_position = threading.local()  # .at: (MeshStats, index, call counter)


class MeshStats:
    """BatchNorm's statistics over the positions of one mesh step.

    ``MeshThreads.run(works)`` calls ``works[k]()`` on position k's thread
    with a new ``MeshStats``.  There the k-th BatchNorm call in train mode
    puts the position's per-channel f32 sums of x and x^2 and its row
    count in the call's slot, waits at a barrier until every position has,
    and takes the statistics of the whole batch (``combine``: the sums
    added in mesh order, ``parallel/spatial._psum``'s order, and the
    counts).  They stay
    functions of every position's sums, so a backward through them
    reaches every position's rows.  The positions thus move in lockstep,
    each computing only its own rows.  A position that raises breaks the
    barrier, so the others stop at their next call."""

    def __init__(self, positions: int):
        self.positions = positions
        self._barrier = threading.Barrier(positions)
        self._slots: dict = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def position(self, index: int):
        """This thread runs position ``index``."""
        _position.at = (self, index, itertools.count())
        try:
            yield
        finally:
            _position.at = None

    def statistics(self, index: int, call: int, x32: torch.Tensor, dims):
        """(sums (2, C) of x and x^2, count) of the whole batch at this
        call, on position ``index``'s device."""
        with self._lock:
            slot = self._slots.setdefault(call, [None] * self.positions)
        slot[index] = (torch.stack([x32.sum(dims), x32.square().sum(dims)]),
                       x32.numel() // x32.shape[1])
        self._barrier.wait()
        s, n = self.combine(index, slot)
        return s.to(x32.device), n

    @staticmethod
    def combine(index: int, slot: list):
        """The positions' (sums, count) of one call added in mesh order:
        ((s0 + s1) + s2) + ... on the first position's device, the same
        for every asking position ``index``."""
        del index
        s, n = slot[0]
        for s_k, n_k in slot[1:]:
            s, n = s + s_k.to(s.device), n + n_k
        return s, n


class MeshThreads:
    """A thread for each mesh position, kept from step to step: PyTorch
    keeps cuDNN's execution plans a thread, so a new thread each step
    would build them again (four to six times a step's forward on the
    card).  ``close()`` ends the threads; so does dropping the object."""

    def __init__(self, positions: int):
        self._pools = [ThreadPoolExecutor(
            1, thread_name_prefix=f"mesh-position-{k}")
            for k in range(positions)]

    def run(self, works: List[Callable[[], object]]) -> list:
        """Each position's ``works[k]()`` on its thread inside a new
        ``MeshStats``' ``position(k)``, under the calling thread's grad
        mode; the results in mesh order.  A position that raises breaks
        the barrier; the first position's own error is raised once every
        position has ended."""
        stats = MeshStats(len(works))
        grad = torch.is_grad_enabled()

        def position(k):
            try:
                with torch.set_grad_enabled(grad), stats.position(k):
                    return works[k]()
            except BaseException:
                stats._barrier.abort()
                raise

        futures = [pool.submit(position, k)
                   for k, pool in enumerate(self._pools)]
        wait(futures)
        errors = [(isinstance(f.exception(), threading.BrokenBarrierError), k)
                  for k, f in enumerate(futures) if f.exception() is not None]
        if errors:
            raise futures[min(errors)[1]].exception()
        return [f.result() for f in futures]

    def close(self) -> None:
        for pool in self._pools:
            pool.shutdown(wait=True)


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over axis 1 of (B, C) or (B, C, H, W) with Flax's
    defaults and arithmetic.  ``momentum`` keeps torch's meaning, the
    weight of the batch statistic (0.01: Flax's momentum 0.99).  In train
    mode on a thread of ``MeshThreads.run`` the statistics are the whole
    batch's (sum / count, the same fast variance) and only the first
    position moves the running ones; eval mode uses the running ones
    everywhere."""

    def __init__(self, n: int):
        super().__init__(n, eps=1e-5, momentum=0.01)

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"expected (B, C) or (B, C, H, W), got {x.dim()}-D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        view = (-1,) + (1,) * (x.dim() - 2)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            dims = (0,) + tuple(range(2, x.dim()))
            at = getattr(_position, "at", None)
            if at is None:
                mean = x32.mean(dims)
                mean_sq = x32.square().mean(dims)
            else:
                stats, index, calls = at
                s, n = stats.statistics(index, next(calls), x32, dims)
                mean, mean_sq = s[0] / n, s[1] / n
            var = torch.maximum(mean_sq - mean.square(), mean.new_zeros(()))
            if at is None or at[1] == 0:
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
