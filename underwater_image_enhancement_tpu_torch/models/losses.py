"""Loss functions of the parameter-predictor trainers (the JAX package's
``models/losses.py``).

- ``reference_loss``: 0.5*L1 + 0.5*L2 (ReferenceLoss,
  deep_learning_parameters.py:170-192).
- ``combined_loss``: 0.3*L1 + 0.5*L2 + 0.2*perceptual (CombinedLoss,
  vgg_16_UIE.py:272-299); perceptual = MSE of frozen VGG16 relu3_3
  features (PerceptualLoss, :257-269).

The perceptual trunk is a ``models/vgg.VGGFeatures(depth=7)``, passed in
as ``vgg_params`` (JAX passes its variable tree): its parameters take no
gradient (``requires_grad`` False), while the gradient flows through it
to the images.  Its bf16 twin is the same module called with
``dtype=torch.bfloat16``; the feature MSE reduces in f32 either way.

All return (total, components) like the reference.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from underwater_image_enhancement_tpu_torch.models import bridge
from underwater_image_enhancement_tpu_torch.models.vgg import VGGFeatures


def init_perceptual_params(rng: Union[int, torch.Generator],
                           image_shape=(1, 224, 224, 3)) -> VGGFeatures:
    """A seeded, frozen perceptual trunk: ``VGGFeatures(depth=7)`` with
    Flax's default initialisers (``bridge.flax_default_init``) drawn from
    ``rng`` (a generator or a seed).  Its numbers are not Flax's: equality
    with JAX comes through ``bridge.load_flax``.  ``image_shape`` is
    JAX's init shape, which a torch module does not need."""
    del image_shape
    gen = rng if isinstance(rng, torch.Generator) else \
        torch.Generator().manual_seed(int(rng))
    trunk = VGGFeatures(depth=7)
    bridge.flax_default_init(trunk, gen)
    return trunk.requires_grad_(False)


def reference_loss(enhanced: torch.Tensor, reference: torch.Tensor,
                   l1_weight: float = 0.5, l2_weight: float = 0.5
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    d = enhanced - reference
    l1 = d.abs().mean()
    l2 = d.square().mean()
    return l1_weight * l1 + l2_weight * l2, {"l1": l1, "l2": l2}


def _is_bf16(dtype) -> bool:
    """VGGTrainer's string convention or a torch dtype."""
    return dtype in (torch.bfloat16, "bfloat16")


def perceptual_loss(vgg_params: VGGFeatures, pred: torch.Tensor,
                    target: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """MSE of the trunk's relu3_3 features of pred and target, the trunk
    in ``dtype`` (f32, or bf16 as ``torch.bfloat16`` or "bfloat16"), the
    mean in f32."""
    compute = torch.bfloat16 if _is_bf16(dtype) else torch.float32
    fp = vgg_params(pred, dtype=compute)
    ft = vgg_params(target, dtype=compute)
    return (fp.float() - ft.float()).square().mean()


def combined_loss(vgg_params: VGGFeatures, enhanced: torch.Tensor,
                  reference: torch.Tensor, l1_weight: float = 0.3,
                  l2_weight: float = 0.5, perceptual_weight: float = 0.2,
                  dtype=torch.float32
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    d = enhanced - reference
    l1 = d.abs().mean()
    l2 = d.square().mean()
    perc = perceptual_loss(vgg_params, enhanced, reference, dtype=dtype)
    total = l1_weight * l1 + l2_weight * l2 + perceptual_weight * perc
    return total, {"l1": l1, "l2": l2, "perceptual": perc}
