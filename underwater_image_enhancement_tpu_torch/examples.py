"""Runnable examples: the example_usage.py:20-296 surface, on the port.

    python -m underwater_image_enhancement_tpu_torch.examples [n|all] [--device cpu]

1  single strategy            2  all strategies
3  quality assessment         4  feature extraction
5  strategy comparison        6  real image from a folder
7  config validation

Each runs on ``device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
path).
"""

from __future__ import annotations

import argparse
from typing import Union

import numpy as np
import torch

Device = Union[str, torch.device]


def _test_image(h=128, w=160, seed=0):
    """Synthetic hazy underwater image (example_usage.py:112 analog)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [0.18 + 0.08 * np.sin(xx / 19), 0.42 + 0.18 * (yy / h),
         0.52 + 0.18 * (xx / w)], -1)
    img = np.clip(base + rng.normal(0, 0.04, (h, w, 3)), 0, 1).astype(np.float32)
    return (np.floor(img * 255) / 255).astype(np.float32)


def _on(img: np.ndarray, device: Device) -> torch.Tensor:
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        resolve_device,
    )

    return torch.from_numpy(img).to(resolve_device(device))


def example_1_single_strategy(device: Device = "cuda"):
    from underwater_image_enhancement_tpu_torch.pipeline.strategies import (
        apply_strategy,
    )

    img = _test_image()
    out = apply_strategy(_on(img, device), "medium_dehazing").cpu().numpy()
    print(f"medium_dehazing: in mean {img.mean():.3f} -> out mean {out.mean():.3f}")


def example_2_all_strategies(device: Device = "cuda"):
    from underwater_image_enhancement_tpu_torch.pipeline.strategies import (
        STRATEGY_FNS,
    )

    img = _on(_test_image(), device)
    for name, fn in STRATEGY_FNS.items():
        out = fn(img).cpu().numpy()
        print(f"{name:<26} out range [{out.min():.3f}, {out.max():.3f}]")


def example_3_quality_assessment(device: Device = "cuda"):
    from underwater_image_enhancement_tpu_torch.metrics.quality import (
        comprehensive_assessment,
    )

    for label, img in [("hazy", _test_image()),
                       ("flat", np.full((128, 160, 3), 0.5, np.float32))]:
        total, scores = comprehensive_assessment(_on(img, device))
        detail = ", ".join(f"{k} {float(v):.1f}" for k, v in scores.items())
        print(f"{label}: total {float(total):.2f}  ({detail})")


def example_4_features(device: Device = "cuda"):
    from underwater_image_enhancement_tpu_torch.features.full import (
        extract_all_features,
    )

    v = extract_all_features(_on(_test_image(), device)).cpu().numpy()
    print(f"feature dim {v.shape[0]}, range [{v.min():.3f}, {v.max():.3f}], "
          f"finite: {np.isfinite(v).all()}")


def example_5_strategy_comparison(device: Device = "cuda"):
    from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
        CONFIG_ORDER,
        auto_enhance_batch,
    )

    _, best, scores = auto_enhance_batch(_test_image()[None], device=device)
    ranked = sorted(zip(CONFIG_ORDER, scores[0].tolist()), key=lambda kv: -kv[1])
    for name, s in ranked:
        marker = " <- best" if name == CONFIG_ORDER[int(best[0])] else ""
        print(f"{name:<26} {s:6.2f}{marker}")


def example_6_real_image(device: Device = "cuda"):
    import tempfile

    from underwater_image_enhancement_tpu_torch.utils import io as uio

    with tempfile.TemporaryDirectory() as d:
        uio.imwrite_unit(f"{d}/demo.png", _test_image())
        img = _on(uio.imread_unit(f"{d}/demo.png"), device)
        print(f"roundtrip ok: {tuple(img.shape)}, dtype {img.dtype}, "
              f"on {img.device}")


def example_7_config_validation(device: Device = "cuda"):
    from underwater_image_enhancement_tpu_torch.parallel.mesh import (
        default_mesh,
    )
    from underwater_image_enhancement_tpu_torch.utils.config import (
        Config,
        DEFAULT_QUALITY_WEIGHTS,
    )

    cfg = Config()
    print(f"strategies: {list(cfg.strategies)}")
    s = sum(DEFAULT_QUALITY_WEIGHTS.values())
    print(f"quality weights sum: {s:.2f} (reference config sums to 1.0)")
    print(f"input folder exists: {cfg.validate()}")
    print(f"Phase-1 data mesh on {device}: "
          f"{default_mesh(cfg.n_devices, device=device)}")


EXAMPLES = [
    example_1_single_strategy, example_2_all_strategies,
    example_3_quality_assessment, example_4_features,
    example_5_strategy_comparison, example_6_real_image,
    example_7_config_validation,
]


def main(arg: str = "all", device: Device = "cuda") -> None:
    picks = EXAMPLES if arg == "all" else [EXAMPLES[int(arg) - 1]]
    for fn in picks:
        print(f"--- {fn.__name__} ---")
        fn(device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="underwater_image_enhancement_tpu_torch"
                                 ".examples")
    ap.add_argument("which", nargs="?", default="all", help="1-7 or all")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.which, a.device)
