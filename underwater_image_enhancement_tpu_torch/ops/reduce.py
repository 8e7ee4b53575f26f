"""Sums and means in the association XLA:CPU gives the JAX program.

A jitted ``jnp.sum``/``jnp.mean`` over the trailing axes of an f32 array
compiles on XLA:CPU to a tree of windowed reductions: while a reduced axis
is longer than 32, each reduced axis is zero-padded to a multiple of 32
(half the padding in front) and every 32 (x 32) window is summed in
row-major order; the window sums are reduced the same way, and the last
reduction (every axis at most 32 long) runs in row-major order.  The mean
multiplies that sum by the f32 reciprocal of the element count (XLA's
rewrite of a division by a constant).  Where such a mean is later
quantised (gray-world's channel means feed CLAHE's u8 planes), its last
bit moves pixels across u8 levels, so the port repeats the order.

A sum over at most 32 values is the plain sequential x0 + x1 + ...
(``seq_sum``).  This module owns both orders; ``ops/airlight`` and
``features/basic`` use them too.

On a tensor the first level runs on its device as one elementwise add a
window position (1023 launches for a 2-D window of two long axes; a
position that is padding in every window adds zero and is skipped); the
few window sums left go to the host once and finish in numpy, so the CPU
path and the card give the same bits.  A numpy array is summed on the
host throughout.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

WINDOW = 32  # XLA:CPU's tree-reduction window


def _unbind(v: torch.Tensor, depth: int):
    """Nested lists of the views of v's first ``depth`` axes."""
    return v if depth == 0 else [_unbind(u, depth - 1) for u in v.unbind(0)]


def _window_sums(x, nd: int):
    """One level of the tree: (N, *dims) -> (N, *ceil(dims / 32)) window
    sums, each window summed in row-major order; x a tensor or a numpy
    array.  A window position that is padding in every window adds zero
    and is skipped."""
    dims = x.shape[1:]
    lo = [(-n % WINDOW) // 2 for n in dims]
    hi = [-n % WINDOW - a for n, a in zip(dims, lo)]
    real = [sorted({(i + a) % WINDOW for i in range(n)})
            for n, a in zip(dims, lo)]
    tiled = [x.shape[0]]
    for n, a, b in zip(dims, lo, hi):
        tiled += [(n + a + b) // WINDOW, WINDOW]
    # the window axes first: a term is one view of the tiled array
    order = ([2 * k + 2 for k in range(nd)] + [0]
             + [2 * k + 1 for k in range(nd)])
    if isinstance(x, torch.Tensor):
        spec = [v for a, b in zip(reversed(lo), reversed(hi)) for v in (a, b)]
        views = _unbind(F.pad(x, spec).reshape(tiled).permute(order), nd)

        def take(pos):
            v = views
            for p in pos:
                v = v[p]
            return v
    else:
        view = (np.pad(x, [(0, 0)] + list(zip(lo, hi)))
                .reshape(tiled).transpose(order))

        def take(pos):
            return view[pos]
    positions = itertools.product(*real)
    first = take(next(positions))
    acc = first.clone() if isinstance(first, torch.Tensor) else first.copy()
    for pos in positions:
        acc += take(pos)
    return acc


def seq_sum(x, axis: int):
    """Sum along ``axis`` in order, x0 + x1 + ... (XLA:CPU's reductions of
    at most 32 values); a tensor or a numpy array."""
    index = [slice(None)] * x.ndim

    def take(k):
        index[axis] = k
        return x[tuple(index)]

    acc = take(0)
    for k in range(1, x.shape[axis]):
        acc = acc + take(k)
    return acc


def xla_sum(x, nd: int = 2):
    """f32 sum over the trailing ``nd`` axes of ``x`` in XLA:CPU's order ->
    the leading shape: a tensor on ``x``'s device, or a numpy array."""
    lead, dims = x.shape[:-nd], tuple(x.shape[-nd:])
    if isinstance(x, torch.Tensor):
        flat = x.reshape((-1,) + dims).to(torch.float32)
        if max(dims) > WINDOW:
            flat = _window_sums(flat, nd)
        host = flat.cpu().numpy()
    else:
        host = np.asarray(x, np.float32).reshape((-1,) + dims)
    while max(host.shape[1:]) > WINDOW:
        host = _window_sums(host, nd)
    acc = seq_sum(host.reshape(host.shape[0], -1), 1).reshape(lead)
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(acc, device=x.device)
    return acc


def xla_mean(x: torch.Tensor, nd: int = 2) -> torch.Tensor:
    """``jnp.mean`` over the trailing ``nd`` axes as jitted XLA:CPU
    computes it: the ordered sum times the f32 reciprocal of the count."""
    n = int(np.prod(x.shape[-nd:]))
    return xla_sum(x, nd) * float(np.float32(1.0) / np.float32(n))
