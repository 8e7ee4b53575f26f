"""Public entry points of the ported pipelines.

- ``six_strategy_tuple(img, fast=False, device="cuda")``: cast
  detect/correct, then the six recipes of ``pipeline/six.py``
  (six_stadigy.py:392-447 per-image body), with one airlight estimate
  shared by the three dehaze recipes (they all descend on the same
  corrected frame, so the outputs equal the reference's per-recipe
  recomputation).  ``fast=True`` is the histogram-percentile tier.
- ``enhance(img, params)`` / ``enhance_batch``: the fixed-parameter
  enhance of use_trained_model.py:83-111 (``models.diff_enhance``).
- ``enhance_batch_dp``: ``enhance_batch`` over a data mesh
  (``parallel/mesh``), one call a position.
- ``auto_enhance_batch(imgs)``: main.py's Phase-1 per-image logic: the
  five config-flavour strategies (``pipeline/strategies.py``, exact tier),
  each scored with the 6-weight quality total, and the best one kept.
  The argmax runs on the device (the first index wins ties, as
  ``jnp.argmax``), so a frame is read back once, by the caller.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.metrics.quality import (
    comprehensive_planes,
)
from underwater_image_enhancement_tpu_torch.models import diff_enhance
from underwater_image_enhancement_tpu_torch.ops.layout import (
    split_planes,
    stack_planes,
)
from underwater_image_enhancement_tpu_torch.pipeline import cast as cast_mod
from underwater_image_enhancement_tpu_torch.pipeline.six import (
    SIX_STRATEGIES,
    airlight,
    run_strategy,
)
from underwater_image_enhancement_tpu_torch.pipeline.strategies import (  # noqa: F401 - STRATEGY_FNS: the JAX module's name
    LABEL_ORDER,
    STRATEGY_FNS,
    strategy_planes,
)
from underwater_image_enhancement_tpu_torch.utils.config import (
    DEFAULT_QUALITY_WEIGHTS,
)

SIX_ORDER = tuple(SIX_STRATEGIES)  # strong, medium, light, clahe, wb, hist_eq
CONFIG_ORDER = LABEL_ORDER  # strong, medium, clahe, light, histogram_eq

# the predictor's safety-clamp defaults (use_trained_model.py:69-79)
DEFAULT_PARAMS = {
    "omega": 0.6,
    "gamma": 1.2,
    "L_low": 10.0,
    "L_high": 90.0,
    "use_gamma": 1.0,
}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The requested device; a CUDA device without a usable card raises
    (nothing moves to the CPU unasked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def _on_device(img, dev: torch.device) -> torch.Tensor:
    """A numpy array or tensor -> float32 tensor on ``dev``."""
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    return img.to(device=dev, dtype=torch.float32)


def six_strategy_tuple(img, fast: bool = False,
                       device: Union[str, torch.device] = "cuda"):
    """One (H, W, 3) float image in [0, 1] (numpy array or tensor) ->
    (tuple of six (H, W, 3) float32 tensors on ``device``, int32 cast code
    tensor).  ``fast`` selects the JAX package's ``hist-fast`` tier."""
    img = _on_device(img, resolve_device(device))
    corrected, code = cast_mod.detect_and_correct(img)
    A = airlight(split_planes(corrected), fast)
    outs = tuple(run_strategy(name, corrected, A, fast) for name in SIX_ORDER)
    return outs, code


def six_strategy_single(img, fast: bool = False,
                        device: Union[str, torch.device] = "cuda"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image -> ((6, H, W, 3) stack of the six outputs, cast code)."""
    outs, code = six_strategy_tuple(img, fast=fast, device=device)
    return torch.stack(outs), code


def enhance_batch(imgs, l_low, l_high, omega, gamma, stretch_mode: str = "hist",
                  device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> enhanced, vgg_16_UIE.py:32-55 semantics;
    each parameter a number or (B,).  stretch_mode "index" takes the
    sorted-index percentiles from a sort, "hist" the same percentiles from
    an exact 256-bin histogram (equal on the u8 grid of decoded images)."""
    imgs = _on_device(imgs, resolve_device(device))
    params = {"L_low": l_low, "L_high": l_high, "omega": omega,
              "gamma": gamma}
    mode = "index-u8" if stretch_mode == "hist" else stretch_mode
    return diff_enhance.enhance_vgg(imgs, params, stretch_mode=mode)


def _input_device(x) -> torch.device:
    """A tensor's device; a numpy batch goes to the default ``cuda``."""
    if isinstance(x, torch.Tensor):
        return x.device
    return resolve_device("cuda")


def _param_shards(v, n_images: int, n: int) -> list:
    """A parameter of enhance_batch for each of n shards: a number as it
    is, a (B,) parameter split with the batch."""
    if not isinstance(v, (list, tuple)) and getattr(v, "ndim", 0) == 0:
        return [v] * n
    if len(v) != n_images:
        raise ValueError(f"a per-image parameter of length {len(v)} for "
                         f"a batch of {n_images}")
    k = n_images // n
    return [v[i * k:(i + 1) * k] for i in range(n)]


def enhance_batch_dp(imgs, l_low, l_high, omega, gamma, mesh,
                     stretch_mode: str = "hist") -> torch.Tensor:
    """``enhance_batch`` with the batch split over a data mesh
    (``parallel/mesh``): each position enhances its rows on its device (a
    number parameter goes to every position, a (B,) one is split with the
    batch) and the result is gathered on ``mesh.devices[0]``.  The batch
    must divide over the mesh (ValueError).  Each image's percentiles are
    its own, so the result equals the single call.  Without a mesh: the
    single call on the input's device."""
    from underwater_image_enhancement_tpu_torch.parallel.mesh import (
        gather_shards,
        shard_batch,
    )

    if mesh is None:
        return enhance_batch(imgs, l_low, l_high, omega, gamma,
                             stretch_mode=stretch_mode,
                             device=_input_device(imgs))
    shards = shard_batch(imgs, mesh)
    b = len(imgs)
    params = [_param_shards(v, b, mesh.size)
              for v in (l_low, l_high, omega, gamma)]
    return gather_shards([
        enhance_batch(x, *(p[i] for p in params), stretch_mode=stretch_mode,
                      device=x.device)
        for i, x in enumerate(shards)], mesh)


def enhance(img, params: Optional[Dict[str, float]] = None,
            stretch_mode: str = "index",
            device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Single-image enhance() (use_trained_model.py:83-111): params holds
    scalars among omega/gamma/L_low/L_high (defaults DEFAULT_PARAMS)."""
    p = dict(DEFAULT_PARAMS)
    p.update(params or {})
    img = _on_device(img, resolve_device(device))
    return enhance_batch(img[None], p["L_low"], p["L_high"], p["omega"],
                         p["gamma"], stretch_mode=stretch_mode,
                         device=device)[0]


def score_strategies(img: torch.Tensor, weights: Dict[str, float],
                     fast: bool = False):
    """The five strategies of one (H, W, 3) image on its device and their
    weighted quality totals -> (list of five (r, g, b) plane tuples in
    CONFIG_ORDER, (5,) f32 scores)."""
    outs = strategy_planes(img, fast)
    return outs, torch.stack([comprehensive_planes(o, weights, fast)
                              for o in outs])


def select_planes(outs, best: torch.Tensor) -> torch.Tensor:
    """The (H, W, 3) output of strategy ``best`` (a 0-dim index tensor on
    the device), picked with an elementwise where-chain: no host read."""
    picked = []
    for c in range(3):
        acc = outs[0][c]
        for k in range(1, len(outs)):
            acc = torch.where(best == k, outs[k][c], acc)
        picked.append(acc)
    return stack_planes(picked)


def auto_enhance_batch(imgs, device: Union[str, torch.device] = "cuda"):
    """(B, H, W, 3) images in [0, 1] (numpy array or tensor) -> (best
    images (B, H, W, 3), best index (B,) int64, scores (B, 5)), tensors on
    ``device``; indices follow CONFIG_ORDER."""
    imgs = _on_device(imgs, resolve_device(device))
    best_imgs, best_idx, all_scores = [], [], []
    for img in imgs:
        outs, scores = score_strategies(img, DEFAULT_QUALITY_WEIGHTS)
        best = torch.argmax(scores)
        best_imgs.append(select_planes(outs, best))
        best_idx.append(best)
        all_scores.append(scores)
    return torch.stack(best_imgs), torch.stack(best_idx), torch.stack(all_scores)


def six_strategy_batch(imgs, device: Union[str, torch.device] = "cuda"):
    """(B, H, W, 3) -> ((B, 6, H, W, 3) outputs, (B,) int32 cast codes),
    ``six_strategy_single`` of each image (exact tier)."""
    outs = [six_strategy_single(im, device=device) for im in imgs]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([torch.as_tensor(c) for _, c in outs]))
