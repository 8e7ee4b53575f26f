"""Colour-cast detection and correction (six_stadigy.py:292-323).

The reference's branches become tensor selects, so no host read is needed.
Type codes: 0 = normal, 1 = greenish, 2 = bluish.
"""

from __future__ import annotations

import torch

CAST_NORMAL, CAST_GREENISH, CAST_BLUISH = 0, 1, 2
CAST_NAMES = ("normal", "greenish", "bluish")


def detect_cast(img: torch.Tensor) -> torch.Tensor:
    """Image type from the mean RGB of an (H, W, 3) image -> int32 0-d
    tensor.  greenish: g is the strict max and g - r > 0.05; bluish: b is
    the strict max and b - r > 0.05 (checked in that order)."""
    r, g, b = img.mean(dim=(0, 1)).unbind()
    greenish = (g > r) & (g > b) & ((g - r) > 0.05)
    bluish = (b > r) & (b > g) & ((b - r) > 0.05)
    code = torch.where(greenish, CAST_GREENISH,
                       torch.where(bluish, CAST_BLUISH, CAST_NORMAL))
    return code.to(torch.int32)


def correct_cast(img: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Scale the offending channel by 0.85, then clip to [0, 1]."""
    one = torch.ones((), dtype=img.dtype, device=img.device)
    k = torch.full((), 0.85, dtype=img.dtype, device=img.device)
    scale = torch.stack([one,
                         torch.where(code == CAST_GREENISH, k, one),
                         torch.where(code == CAST_BLUISH, k, one)])
    return torch.clamp(img * scale, 0.0, 1.0)


def detect_and_correct(img: torch.Tensor):
    """(corrected image, cast code)."""
    code = detect_cast(img)
    return correct_cast(img, code), code
