"""Public entry points of the ported ``six`` program.

``six_strategy_tuple(img, device="cuda")``: cast detect/correct, then the
six recipes of ``pipeline/six.py`` (six_stadigy.py:392-447 per-image body),
with one airlight estimate shared by the three dehaze recipes (they all
descend on the same corrected frame, so the outputs equal the reference's
per-recipe recomputation).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.ops.airlight import (
    quadtree_airlight_exact_planes,
)
from underwater_image_enhancement_tpu_torch.ops.layout import split_planes
from underwater_image_enhancement_tpu_torch.pipeline import cast as cast_mod
from underwater_image_enhancement_tpu_torch.pipeline.six import (
    SIX_STRATEGIES,
    run_strategy,
)

SIX_ORDER = tuple(SIX_STRATEGIES)  # strong, medium, light, clahe, wb, hist_eq


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The requested device; a CUDA device without a usable card raises
    (nothing moves to the CPU unasked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def six_strategy_tuple(img, device: Union[str, torch.device] = "cuda"):
    """One (H, W, 3) float image in [0, 1] (numpy array or tensor) ->
    (tuple of six (H, W, 3) float32 tensors on ``device``, int32 cast code
    tensor).  The exact tier; the reference's ``fast`` tier is not ported."""
    dev = resolve_device(device)
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    img = img.to(device=dev, dtype=torch.float32)
    corrected, code = cast_mod.detect_and_correct(img)
    A = quadtree_airlight_exact_planes(split_planes(corrected))
    outs = tuple(run_strategy(name, corrected, A) for name in SIX_ORDER)
    return outs, code


def six_strategy_single(img, device: Union[str, torch.device] = "cuda"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image -> ((6, H, W, 3) stack of the six outputs, cast code)."""
    outs, code = six_strategy_tuple(img, device=device)
    return torch.stack(outs), code
