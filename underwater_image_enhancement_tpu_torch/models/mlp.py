"""Feature-MLP parameter predictor (the JAX package's ``models/mlp.py``).

ParameterPredictor (deep_learning_parameters.py:97-163): 79-dim input
(LayerNorm-normalised first, Flax's ``input_norm``) -> projection -> 3
residual blocks -> half-width projection -> 4 sigmoid-ranged heads:

  gamma     in [1.0, 1.5]   (:158)
  L_low     in [5, 20]      (:159)
  L_high    in [85, 98]     (:160)
  use_gamma in [0, 1]       (:161)

Dropout is the reference's 0.3, in train mode only (``layers.dropout``,
its masks drawn from the ``generator`` the caller passes, as Flax's from
its ``dropout`` rng).  Submodules carry the Flax names (``input_norm``,
``Dense_0``, ``ResidualBlock_0``, ``Dense_1``, ``head_gamma``), so
``models/bridge`` maps a JAX tree onto them; the LayerNorm computes as
Flax's (``layers.LayerNorm``).  ``train/trainer.MLPTrainer`` trains it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from underwater_image_enhancement_tpu_torch.models import layers

PARAM_RANGES = {
    "gamma": (1.0, 1.5),
    "L_low": (5.0, 20.0),
    "L_high": (85.0, 98.0),
    "use_gamma": (0.0, 1.0),
}


class ResidualBlock(nn.Module):
    """deep_learning_parameters.py:97-111: relu(dropout(block(x) + x))."""

    def __init__(self, dim: int, dropout: float = 0.3):
        super().__init__()
        self.dim, self.dropout = dim, dropout
        self.Dense_0 = nn.Linear(dim, dim)
        self.Dense_1 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.relu(self.Dense_0(x))
        h = layers.dropout(h, self.dropout, self.training, generator)
        h = layers.dropout(self.Dense_1(h) + x, self.dropout, self.training,
                           generator)
        return F.relu(h)


class ParameterPredictor(nn.Module):
    """(B, feature_dim) features -> {gamma, L_low, L_high, use_gamma},
    each (B, 1) in its ``PARAM_RANGES`` interval.  ``normalize_inputs``
    False feeds the raw features, as the reference does."""

    def __init__(self, feature_dim: int = 79, hidden_dim: int = 256,
                 num_blocks: int = 3, normalize_inputs: bool = True):
        super().__init__()
        self.feature_dim, self.hidden_dim = feature_dim, hidden_dim
        self.num_blocks, self.normalize_inputs = num_blocks, normalize_inputs
        if normalize_inputs:
            self.input_norm = layers.LayerNorm(feature_dim)
        self.Dense_0 = nn.Linear(feature_dim, hidden_dim)
        for i in range(num_blocks):
            self.add_module(f"ResidualBlock_{i}", ResidualBlock(hidden_dim))
        self.Dense_1 = nn.Linear(hidden_dim, hidden_dim // 2)
        for name in PARAM_RANGES:
            self.add_module(f"head_{name}", nn.Linear(hidden_dim // 2, 1))

    def forward(self, feats: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        if self.normalize_inputs:
            feats = self.input_norm(feats)
        x = layers.dropout(F.relu(self.Dense_0(feats)), 0.3, self.training,
                           generator)
        for i in range(self.num_blocks):
            x = getattr(self, f"ResidualBlock_{i}")(x, generator)
        x = F.relu(self.Dense_1(x))
        return {name: torch.sigmoid(getattr(self, f"head_{name}")(x))
                * (hi - lo) + lo for name, (lo, hi) in PARAM_RANGES.items()}
