"""The lightweight 18-value feature vector, zero-padded to 79.

Counterpart of the JAX package's ``features/basic.py`` (vgg_16_UIE.py:
435-466, the standalone twin of ImprovedEnhancementDataset.
extract_basic_features at :361-387): per channel mean, std, min, max and
median (15), then the whole image's mean, std and second moment (3).  The
means and the population standard deviations (``jnp.std``: divide by n)
repeat the jitted JAX program's sums (``reduce.xla_mean``); the median is
``stretch.percentiles_radix``.
"""

from __future__ import annotations

import torch

from underwater_image_enhancement_tpu_torch.ops import stretch
from underwater_image_enhancement_tpu_torch.ops.reduce import xla_mean

FEATURE_DIM = 79


def _mean_std(x: torch.Tensor):
    """``jnp.mean`` and ``jnp.std`` of ``x.reshape(-1)`` as jitted XLA:CPU
    computes them: it reduces the mean over x's own axes (the reshape moves
    into the reduction), the centred squares over the flat vector."""
    m = xla_mean(x, x.ndim)
    d = (x - m).reshape(-1)
    return m, torch.sqrt(xla_mean(d * d, 1))


def extract_basic_features(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) f32 in [0, 1] -> (79,) f32: 18 values, then zeros."""
    feats = []
    for c in range(3):
        ch = img[..., c]
        m, s = _mean_std(ch)
        feats += [m, s, ch.min(), ch.max(),
                  stretch.percentiles_radix(ch, (50.0,))[0]]
    m, s = _mean_std(img)
    flat = img.reshape(-1)
    feats += [m, s, xla_mean(flat * flat, 1)]
    v = torch.stack(feats).to(torch.float32)
    return torch.cat([v, v.new_zeros(FEATURE_DIM - 18)])


def extract_basic_batch(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, 79), ``extract_basic_features`` of each image."""
    return torch.stack([extract_basic_features(im) for im in imgs])
