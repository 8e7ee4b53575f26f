"""Pretrained-weight artifact discovery (the JAX package's
``utils/weights.py``; both packages read the same artifacts).

The reference fetches ImageNet weights online at construction time
(vgg_16_UIE.py:149 ``vgg16(pretrained=True)``, model_architectures.py:13
``resnet18(pretrained=...)``).  Here pretrained trunks are explicit on-disk
artifacts: ``cli convert-vgg`` (or ``tools/fetch_vgg16_npz.py``) turns a
torch checkpoint into ``vgg16.npz`` once, and consumers find it through the
search path below.

Search order for ``<name>.npz``:
1. ``$UIE_TPU_WEIGHTS/<name>.npz`` (explicit override directory)
2. ``~/.cache/uie_tpu/<name>.npz`` (the fetch tool's default output)
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

_ENV = "UIE_TPU_WEIGHTS"


def weights_dir() -> Path:
    """The directory new artifacts should be written to."""
    env = os.environ.get(_ENV)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "uie_tpu"


def find_weights(name: str) -> Optional[str]:
    """The path of ``<name>.npz`` if a conventional copy exists."""
    env = os.environ.get(_ENV)
    candidates = [Path(env) / f"{name}.npz"] if env else []
    candidates.append(Path.home() / ".cache" / "uie_tpu" / f"{name}.npz")
    for c in candidates:
        if c.is_file():
            return str(c)
    return None


def find_vgg16_npz() -> Optional[str]:
    """The converted torchvision vgg16 artifact (models.vgg loaders)."""
    return find_weights("vgg16")


def find_resnet18_npz() -> Optional[str]:
    """The converted torchvision resnet18 artifact (the zoo's loader)."""
    return find_weights("resnet18")


def zoo_artifact_name(model_type: str, variant: str = "b0") -> str:
    """The artifact stem of a zoo backbone (``resnet18.npz``,
    ``efficientnet_{b0,b3}.npz``, ``vit_b_16.npz``)."""
    if model_type == "resnet":
        return "resnet18"
    if model_type == "efficientnet":
        return f"efficientnet_{variant}"
    if model_type == "vit":
        return "vit_b_16"
    raise ValueError(f"no pretrained artifact convention for: {model_type}")


def find_zoo_npz(model_type: str, variant: str = "b0") -> Optional[str]:
    """The artifact path of a zoo backbone, or None."""
    return find_weights(zoo_artifact_name(model_type, variant))
