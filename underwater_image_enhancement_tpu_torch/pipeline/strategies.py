"""The five "config flavour" strategies (enhancement_strategies.py:349-508,
parameters config.py:28-75), the Phase-1 labels.

Counterpart of the JAX package's ``pipeline/strategies.py``, returning
(r, g, b) f32 planes of one (H, W, 3) image:

- strong / medium / light dehazing: the quadtree airlight, the
  transmission, the recovery, the percentile stretch (eps 1e-10) and, for
  the first two, ``img ** (1/1.2)`` clipped;
- CLAHE (2.0, 8x8 tiles, the LAB-L leg) then the stretch 20-85;
- histogram equalization per channel, then the stretch 10-95.

Unlike ``six``, the strategies run on the raw frame (no cast correction).
Two tiers:

- exact (``fast=False``, the JAX ``method="radix"``): the per-block-Canny
  airlight descent, the guided filter at each strategy's radius, exact
  percentiles, the exact forward LAB (K1);
- fast (the JAX ``"hist-fast"``): the banded-SAT airlight with 4
  hysteresis rounds, ONE fast guided filter (radius 15, every 4th row) of
  the dark channel shared by the three dehaze strategies, the hist-fast
  percentiles, and the approximate forward LAB (K8 ``_approx``, as the TPU
  program; JAX on the CPU converts exactly).

``strategy_planes`` runs all five in label order with one airlight (and, in
the fast tier, one refined dark channel) per frame: the same function of
the same frame gives the same A, so each output equals the strategy run
alone (``STRATEGY_FNS_PLANES``).  ``strong_dehazing`` ...
``histogram_equalization`` (``STRATEGY_FNS``, the fast tier
``STRATEGY_FNS_FAST``, the planes ``STRATEGY_FNS_PLANES`` and
``STRATEGY_FNS_FAST_PLANES``) and ``apply_strategy`` are the JAX package's
forms on an (H, W, 3) image or a batch, with the reference's parameter
overrides.
"""

from __future__ import annotations

import functools

import torch

from underwater_image_enhancement_tpu_torch.ops import dehaze, histeq, stretch
from underwater_image_enhancement_tpu_torch.ops.airlight import (
    quadtree_airlight_exact_planes,
    quadtree_airlight_planes,
)
from underwater_image_enhancement_tpu_torch.ops.layout import split_planes
from underwater_image_enhancement_tpu_torch.utils.config import (
    DEFAULT_STRATEGIES,
)

# label order (the JAX STRATEGY_FNS keys)
LABEL_ORDER = ("strong_dehazing", "medium_dehazing", "clahe_enhancement",
               "light_enhancement", "histogram_equalization")
DEHAZE = ("strong_dehazing", "medium_dehazing", "light_enhancement")
# display names, as in CSVs and dataset labels
STRATEGY_DISPLAY = {k: v["name"] for k, v in DEFAULT_STRATEGIES.items()}

_FAST_RADIUS = 15     # the fast tier's one guided-filter radius
_GUIDED_EPS = 0.001


def _method(fast: bool) -> str:
    return "hist-fast" if fast else "radix"


def airlight(planes, fast: bool = False) -> torch.Tensor:
    """The tier's airlight A (3,) of the raw frame's planes."""
    if fast:
        return quadtree_airlight_planes(planes, edge_iters=4)
    return quadtree_airlight_exact_planes(planes)


def _dehaze(planes, name: str, A: torch.Tensor, fast: bool,
            dark_refined=None):
    """Transmission, recovery, stretch and the optional inverse gamma of
    one dehaze strategy.  ``dark_refined``: the fast tier's shared
    refinement (computed here when not given)."""
    p = DEFAULT_STRATEGIES[name]
    if fast:
        if dark_refined is None:
            dark_refined = dehaze.shared_refined_dark(
                planes, A, _FAST_RADIUS, _GUIDED_EPS, 4)
        t = dehaze.transmission_from_refined_dark(dark_refined, p["omega"])
    else:
        t = dehaze.estimate_transmission_planes(
            planes, A, p["omega"], p["guided_radius"], _GUIDED_EPS)
    out = stretch.color_enhancement_planes(
        dehaze.recover_planes(planes, t, A), float(p["L_low"]),
        float(p["L_high"]), method=_method(fast))
    if p["apply_gamma"]:
        out = tuple(stretch.gamma_correction_inv(c, p.get("gamma", 1.2))
                    for c in out)
    return out


def _clahe(planes, fast: bool):
    c = histeq.clahe_enhancement_planes(planes, 2.0, 8, 8, lab_fast=fast)
    return stretch.color_enhancement_planes(c, 20.0, 85.0, method=_method(fast))


def _histogram_equalization(planes, fast: bool):
    e = histeq.histogram_equalization_planes(planes)
    return stretch.color_enhancement_planes(e, 10.0, 95.0, method=_method(fast))


def _apply(name: str, planes, fast: bool, A=None, dark_refined=None):
    if name in DEHAZE:
        return _dehaze(planes, name, A, fast, dark_refined)
    if name == "clahe_enhancement":
        return _clahe(planes, fast)
    if name == "histogram_equalization":
        return _histogram_equalization(planes, fast)
    raise ValueError(f"unknown strategy: {name}")


def run_strategy(name: str, img: torch.Tensor, fast: bool = False):
    """One strategy on one (H, W, 3) image -> (r, g, b) planes."""
    planes = split_planes(img)
    A = airlight(planes, fast) if name in DEHAZE else None
    return _apply(name, planes, fast, A)


def strategy_planes(img: torch.Tensor, fast: bool = False):
    """All five strategies of one (H, W, 3) image in LABEL_ORDER, sharing
    the airlight (and the fast tier's refined dark channel) -> list of
    (r, g, b) plane tuples."""
    planes = split_planes(img)
    A = airlight(planes, fast)
    dark_refined = (dehaze.shared_refined_dark(planes, A, _FAST_RADIUS,
                                               _GUIDED_EPS, 4)
                    if fast else None)
    return [_apply(name, planes, fast, A, dark_refined)
            for name in LABEL_ORDER]


def _per_image(fn, img: torch.Tensor) -> torch.Tensor:
    """fn of an (H, W, 3) image, on one image or each of a (B, H, W, 3)
    batch."""
    if img.ndim == 3:
        return fn(img)
    return torch.stack([fn(im) for im in img])


def _strategy_fn(name: str):
    def fn(img: torch.Tensor, *, method: str = "radix") -> torch.Tensor:
        if method not in ("radix", "hist-fast"):
            raise ValueError(f"{name}: method must be 'radix' or "
                             f"'hist-fast', got {method!r}")
        fast = method == "hist-fast"
        return _per_image(
            lambda im: torch.stack(run_strategy(name, im, fast), dim=-1), img)
    fn.__name__ = name
    fn.__doc__ = (f"``{name}`` of an (H, W, 3) image or a (B, H, W, 3) batch "
                  "-> the same shape; ``method`` \"radix\" is the exact tier, "
                  "\"hist-fast\" the throughput tier.")
    return fn


def _planes_fn(name: str, fast: bool):
    def fn(img: torch.Tensor):
        if img.ndim == 3:
            return tuple(run_strategy(name, img, fast))
        outs = [run_strategy(name, im, fast) for im in img]
        return tuple(torch.stack([o[c] for o in outs]) for c in range(3))
    fn.__name__ = name
    fn.__doc__ = (f"``{name}`` ({'fast' if fast else 'exact'} tier) of an "
                  "(H, W, 3) image -> (r, g, b) planes, or of a (B, H, W, 3) "
                  "batch -> three (B, H, W) planes.")
    return fn


strong_dehazing = _strategy_fn("strong_dehazing")
medium_dehazing = _strategy_fn("medium_dehazing")
light_enhancement = _strategy_fn("light_enhancement")
clahe_enhancement = _strategy_fn("clahe_enhancement")
histogram_equalization = _strategy_fn("histogram_equalization")
# the JAX tables, keyed alike: the exact tier, the throughput tier
# (``method="hist-fast"``), and each one's plane-returning twin
STRATEGY_FNS = {name: globals()[name] for name in LABEL_ORDER}
STRATEGY_FNS_FAST = {name: functools.partial(fn, method="hist-fast")
                     for name, fn in STRATEGY_FNS.items()}
STRATEGY_FNS_PLANES = {name: _planes_fn(name, False) for name in LABEL_ORDER}
STRATEGY_FNS_FAST_PLANES = {name: _planes_fn(name, True)
                            for name in LABEL_ORDER}

# the defaults of apply_strategy's parameter overrides (the JAX
# _apply_custom's: apply_gamma is off unless the parameters say so)
_CUSTOM_DEHAZE = {
    "strong_dehazing": (0.5, 15, 10.0, 95.0, False, 1.2),
    "medium_dehazing": (0.6, 20, 15.0, 92.0, False, 1.2),
    "light_enhancement": (0.4, 10, 15.0, 95.0, False, 1.2),
}


def _apply_custom(img: torch.Tensor, name: str, p: dict) -> torch.Tensor:
    """One strategy with overridden parameters (the reference's
    params.get(...) paths), exact tier."""
    def one(im):
        planes = split_planes(im)
        if name in DEHAZE:
            d = _CUSTOM_DEHAZE[name]
            A = airlight(planes)
            t = dehaze.estimate_transmission_planes(
                planes, A, p.get("omega", d[0]),
                int(p.get("guided_radius", d[1])), _GUIDED_EPS)
            out = stretch.color_enhancement_planes(
                dehaze.recover_planes(planes, t, A),
                float(p.get("L_low", d[2])), float(p.get("L_high", d[3])),
                method="radix")
            gamma_on, gamma = bool(p.get("apply_gamma", d[4])), d[5]
        else:
            if name == "clahe_enhancement":
                src = histeq.clahe_enhancement_planes(
                    planes, float(p.get("clip_limit", 2.0)),
                    *p.get("tile_grid_size", (8, 8)))
                lo, hi = 20.0, 85.0
            else:
                src = histeq.histogram_equalization_planes(planes)
                lo, hi = 10.0, 95.0
            out = stretch.color_enhancement_planes(
                src, float(p.get("L_low", lo)), float(p.get("L_high", hi)),
                method="radix")
            gamma_on = bool(p.get("apply_gamma", False))
        if gamma_on:
            g = float(p.get("gamma", 1.2))
            out = tuple(stretch.gamma_correction_inv(c, g) for c in out)
        return torch.stack(out, dim=-1)

    return _per_image(one, img)


def apply_strategy(img: torch.Tensor, strategy_name: str,
                   params: dict | None = None) -> torch.Tensor:
    """Dispatch by name (enhancement_strategies.py:477-508): an unknown
    strategy raises, failures propagate (the reference's silent fallback
    to the input is not reproduced, as in the JAX package)."""
    if strategy_name not in STRATEGY_FNS:
        raise ValueError(f"unknown strategy: {strategy_name}")
    if params:
        return _apply_custom(img, strategy_name, dict(params))
    return STRATEGY_FNS[strategy_name](img)
