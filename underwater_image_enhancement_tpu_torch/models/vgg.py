"""VGG16-backbone parameter predictor (the JAX package's ``models/vgg.py``).

Reproduces ImprovedVGGParameterNet (vgg_16_UIE.py:135-250):

- VGG16 features up to conv4_3 (torchvision ``features[:23]``: conv blocks
  1-3 complete + conv4_1..conv4_3, three 2x2 maxpools).
- "Dual pooling": the reference declares avg+max pooling but instantiates
  BOTH as AdaptiveAvgPool2d (:157-158); reproduced, as in JAX
  (``vgg.py:90``): two identical global average pools concatenated.
- Optional 79-dim feature concat -> fusion MLP with BatchNorm+Dropout
  (:164-174) -> sigmoid attention gate (:177-181) -> 4 sigmoid-ranged heads
  (:193-198), resolved in f32.

Images are NHWC at the public boundary, as in JAX; the convs run NCHW
inside.  Submodules carry the Flax modules' names (``vgg.conv0``,
``Dense_0``, ``BatchNorm_0``, ``head_omega_0``), so ``models/bridge`` maps
a JAX variable tree onto them.  BatchNorm is Flax's (``layers.BatchNorm``,
its statistics in f32 under bf16 activations), dropout Flax's from the
``generator`` the caller passes (``layers.dropout``).  Under
``dtype=torch.bfloat16`` the parameters stay f32 and each layer casts
them, as Flax's ``dtype`` does; the heads resolve in f32.

The convs are ``torch.nn.functional.conv2d`` (cuDNN on the card; JAX
leaves them to ``lax.conv``, outside any Pallas kernel).  cuDNN computes
f32 convs in TF32 by default, three decimal digits; JAX's predictor
computes in f32.  So ``VGGFeatures`` runs its forward under
``layers.no_tf32`` (the caller's settings are restored after it).

The ``.npz`` of ``convert_torch_vgg_to_npz`` holds torchvision's OIHW
conv weights, which are the port's layout: the loaders copy them as they
are into a module (where JAX transposes them to HWIO into a Flax tree).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from underwater_image_enhancement_tpu_torch.models import layers

# torchvision vgg16.features[:23] conv channel plan; 'M' = 2x2 maxpool
VGG_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512)

# ImageNet statistics the VGG backbone input is normalized with
# (use_trained_model.py:34-46)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# jitted JAX divides by IMAGENET_STD as a multiply by its f32 reciprocal
# (found by comparing candidates with the jitted predictor preprocess;
# tests/test_torch_predictor.py holds it bit-equal): the predictors and
# the trainers normalise with it
IMAGENET_INV_STD = (np.float32(1.0) / IMAGENET_STD).astype(np.float32)

PARAM_RANGES = {
    "omega": (0.3, 0.9),
    "gamma": (1.0, 1.5),
    "L_low": (2.0, 15.0),
    "L_high": (60.0, 95.0),
}

# torchvision vgg16 ``features`` module indices of the conv layers
TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)


class VGGFeatures(nn.Module):
    """VGG16 conv stack, NHWC in and out.  depth = number of conv layers:
    depth=10 -> conv4_3 (torchvision features[:23]);
    depth=7  -> relu3_3 (features[:16], the perceptual-loss trunk).

    dtype: compute dtype (parameters stay float32)."""

    def __init__(self, depth: int = 10, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        self.dtype = dtype
        in_ch, i = 3, 0
        for item in VGG_PLAN:
            if i >= depth:
                break
            if item != "M":
                self.add_module(f"conv{i}", nn.Conv2d(in_ch, item, 3,
                                                      padding=1))
                in_ch, i = item, i + 1

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """dtype: the compute dtype of this call (default ``self.dtype``),
        so one set of parameters has an f32 and a bf16 twin, as the
        perceptual loss's trunk has (``models/losses``)."""
        dtype = self.dtype if dtype is None else dtype
        x = x.permute(0, 3, 1, 2).to(dtype)
        i = 0
        with layers.no_tf32():
            for item in VGG_PLAN:
                if i >= self.depth:
                    break
                if item == "M":
                    x = F.max_pool2d(x, 2)
                    continue
                conv = getattr(self, f"conv{i}")
                x = F.relu(F.conv2d(x, conv.weight.to(dtype),
                                    conv.bias.to(dtype), padding=1))
                i += 1
        return x.permute(0, 2, 3, 1)


class ImprovedVGGParameterNet(nn.Module):
    """vgg_16_UIE.py:135-250: (B, H, W, 3) ImageNet-normalised images and
    (B, 79) features -> {omega, gamma, L_low, L_high}, each (B, 1) f32 in
    its ``PARAM_RANGES`` interval."""

    def __init__(self, hidden_dim: int = 256, use_features: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.use_features = use_features
        self.dtype = dtype
        h, h2 = hidden_dim, hidden_dim * 2
        self.vgg = VGGFeatures(depth=10, dtype=dtype)
        n_in = 2 * 512 + (79 if use_features else 0)  # the 79 features
        self.Dense_0 = nn.Linear(n_in, h2)
        self.BatchNorm_0 = layers.BatchNorm(h2)
        self.Dense_1 = nn.Linear(h2, h)
        self.BatchNorm_1 = layers.BatchNorm(h)
        self.Dense_2 = nn.Linear(h, h // 4)
        self.Dense_3 = nn.Linear(h // 4, h)
        for name in PARAM_RANGES:
            self.add_module(f"head_{name}_0", nn.Linear(h, h // 2))
            self.add_module(f"head_{name}_1", nn.Linear(h // 2, 1))

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name)
        return F.linear(x, layer.weight.to(self.dtype),
                        layer.bias.to(self.dtype))

    def forward(self, img: torch.Tensor,
                feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        v = self.vgg(img)
        avg_feat = v.mean(dim=(1, 2))
        max_feat = v.mean(dim=(1, 2))  # reference bug reproduced (:158)
        x = torch.cat([avg_feat, max_feat], dim=1)
        if self.use_features and feats is not None:
            x = torch.cat([x, feats.to(x.dtype)], dim=1)
        drop = self.training
        x = F.relu(self.BatchNorm_0(self._dense("Dense_0", x)))
        x = layers.dropout(x, 0.4, drop, generator)
        x = F.relu(self.BatchNorm_1(self._dense("Dense_1", x)))
        x = layers.dropout(x, 0.3, drop, generator)
        att = F.relu(self._dense("Dense_2", x))
        x = x * torch.sigmoid(self._dense("Dense_3", att))
        params = {}
        for name, (lo, hi) in PARAM_RANGES.items():
            hd = F.relu(self._dense(f"head_{name}_0", x))
            hd = layers.dropout(hd, 0.2, drop, generator)
            raw = self._dense(f"head_{name}_1", hd)
            # heads resolve in f32 (bf16's ~3 digits would quantize them)
            params[name] = torch.sigmoid(raw.float()) * (hi - lo) + lo
        return params


def load_torch_vgg_features(flax_params: nn.Module, torch_state: dict,
                            prefix: str = "vgg", depth: int = 10) -> nn.Module:
    """Copy torchvision vgg16 ``features`` weights into a module's VGG
    trunk, in place, and return the module.

    ``flax_params``: the module (named as the JAX argument, whose Flax
    tree the port's module stands for); ``prefix`` names its trunk
    submodule ("" for a ``VGGFeatures`` itself).  torch_state keys:
    '0.weight', '0.bias', '2.weight', ... (conv layer indices in
    features[:23]), arrays or tensors in OIHW, copied as they are.
    depth=10 fills the conv4_3 trunk, depth=7 the relu3_3 perceptual
    trunk.  A missing key or a wrong shape raises."""
    trunk = flax_params.get_submodule(prefix) if prefix else flax_params
    with torch.no_grad():
        for i, ti in enumerate(TORCH_CONV_IDX[:depth]):
            conv = getattr(trunk, f"conv{i}")
            for attr in ("weight", "bias"):
                v = torch.as_tensor(np.asarray(torch_state[f"{ti}.{attr}"]))
                dst = getattr(conv, attr)
                if tuple(v.shape) != tuple(dst.shape):
                    raise ValueError(f"{ti}.{attr}: shape {tuple(v.shape)}, "
                                     f"conv{i} takes {tuple(dst.shape)}")
                dst.copy_(v)
    return flax_params


def convert_torch_vgg_to_npz(torch_ckpt_path: str, npz_path: str) -> int:
    """Offline conversion: a torch checkpoint holding torchvision vgg16
    weights -> a plain .npz keyed like ``features``'s state_dict.

    Accepts either a ``features``-only state_dict ('0.weight', ...) or a
    full vgg16 state_dict ('features.0.weight', ...).  Returns the number
    of conv layers exported.  This replaces the reference's on-line
    torchvision download (vgg_16_UIE.py:149)."""
    state = torch.load(torch_ckpt_path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    flat = {}
    for k, v in state.items():
        k = k[len("features."):] if k.startswith("features.") else k
        flat[k] = np.asarray(v.detach().cpu().numpy()
                             if hasattr(v, "detach") else v)
    keep = {}
    for ti in TORCH_CONV_IDX:
        keep[f"{ti}.weight"] = flat[f"{ti}.weight"]
        keep[f"{ti}.bias"] = flat[f"{ti}.bias"]
    np.savez(npz_path, **keep)
    return len(TORCH_CONV_IDX)


def load_perceptual_npz(npz_path: str) -> VGGFeatures:
    """A ``VGGFeatures(depth=7)`` (the relu3_3 perceptual trunk,
    vgg_16_UIE.py:257-269) filled from a converted vgg16 .npz."""
    with np.load(npz_path) as z:
        state = {k: z[k] for k in z.files}
    return load_torch_vgg_features(VGGFeatures(depth=7), state, prefix="",
                                   depth=7)


def load_backbone_npz(flax_params: nn.Module, npz_path: str) -> nn.Module:
    """Fill an ``ImprovedVGGParameterNet``'s 'vgg' trunk (depth 10,
    conv4_3) from a converted vgg16 .npz (vgg_16_UIE.py:149-154)."""
    with np.load(npz_path) as z:
        state = {k: z[k] for k in z.files}
    return load_torch_vgg_features(flax_params, state, prefix="vgg",
                                   depth=10)
