"""2-D orthonormal DCT-II (cv2.dct) as two f32 matrix products.

Counterpart of the JAX package's ``ops/dct.py``, which leaves the products
to XLA outside any Pallas kernel; here they are ``torch.matmul``.  The
products must be full f32: on a card that needs
``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default (TF32
keeps about three decimal digits).  The JAX exact tier asks for
"highest" precision and its fast tier for "default"; on the CPU, JAX
computes both in f32, and so does the port in both tiers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2.0 * n))
    m[0] *= np.sqrt(1.0 / n)
    m[1:] *= np.sqrt(2.0 / n)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int, device: torch.device) -> torch.Tensor:
    """(n, n) f32 DCT-II basis on ``device`` (built once per size and
    device; read-only)."""
    return torch.as_tensor(_dct_matrix(n), device=device)


def dct2(x: torch.Tensor) -> torch.Tensor:
    """(H, W) f32 -> its orthonormal 2-D DCT-II, D_H @ x @ D_W^T."""
    H, W = x.shape
    return torch.matmul(torch.matmul(dct_matrix(H, x.device), x),
                        dct_matrix(W, x.device).T)
