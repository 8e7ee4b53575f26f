"""Alternative parameter-predictor backbones (the JAX package's
``models/zoo.py``).

model_architectures.py's surface: the ResNet18 predictor
(CNNParameterPredictor, :11-68), EfficientNet b0/b3
(EfficientNetParameterPredictor, :71-125) and ViT-B/16
(ViTParameterPredictor, :128-181), each with the same six heads:

  omega [0.3,0.7], gamma [1,1.5], L_low [5,20], L_high [85,98],
  guided_radius [10,25], use_gamma [0,1]   (:61-66)

and the ``create_model`` factory (:188-227, its 'mlp' import fixed to
``models/mlp``).  Images are NHWC at the public boundary, as in JAX; the
convs run NCHW inside (cuDNN on the card; JAX leaves them to ``lax.conv``
and its attention to ``dot_general``, outside any Pallas kernel).  Every
forward runs in full f32 (``layers.no_tf32``).

Submodules carry the Flax modules' auto-names (``Conv_0``,
``BatchNorm_0``, ``ResNetBlock_3``, ``MBConv_12``, ``LayerNorm_{2i}``,
``MultiHeadDotProductAttention_i``, ``Dense_{2*depth}``, ``head_omega``),
so ``models/bridge`` maps a JAX variable tree onto them leaf by leaf.
Flax infers input widths when it first sees an input; a torch module is
built with them, so the blocks take ``in_features`` and the ViT the
``image_size`` its position table is made for.  Dropout is the identity
in eval mode; in train mode its masks come from the ``generator`` the
caller passes (``layers.dropout``), and BatchNorm takes the batch's
statistics and moves its running ones as Flax's does.

The torchvision loaders copy a torchvision state_dict into a module, in
place (the port's layouts are torchvision's: OIHW convs, (out, in)
Linears, attention rows per head), and return it; where JAX takes and
returns a variable tree, the port takes the module that holds it.  A
missing key or a wrong shape raises.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from underwater_image_enhancement_tpu_torch.models import layers

SIX_PARAM_RANGES = {
    "omega": (0.3, 0.7),
    "gamma": (1.0, 1.5),
    "L_low": (5.0, 20.0),
    "L_high": (85.0, 98.0),
    "guided_radius": (10.0, 25.0),
    "use_gamma": (0.0, 1.0),
}


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _nchw(img: torch.Tensor) -> torch.Tensor:
    return img.permute(0, 3, 1, 2)


def _add_heads(m: nn.Module, in_dim: int, first_dense: int) -> None:
    """The shared MLP (``Dense_{first_dense}`` in_dim -> 256,
    ``Dense_{first_dense + 1}`` -> 128) and the six heads on ``m``."""
    m._mlp = (f"Dense_{first_dense}", f"Dense_{first_dense + 1}")
    m.add_module(m._mlp[0], nn.Linear(in_dim, 256))
    m.add_module(m._mlp[1], nn.Linear(256, 128))
    for name in SIX_PARAM_RANGES:
        m.add_module(f"head_{name}", nn.Linear(128, 1))


def _shared_mlp(m: nn.Module, x: torch.Tensor, train: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """model_architectures.py:29-35 / :93-101: 256 -> 128 with dropout."""
    x = F.relu(getattr(m, m._mlp[0])(x))
    x = layers.dropout(x, 0.3, train, generator)
    return F.relu(getattr(m, m._mlp[1])(x))


def _param_heads(m: nn.Module, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {name: torch.sigmoid(getattr(m, f"head_{name}")(x)) * (hi - lo)
            + lo for name, (lo, hi) in SIX_PARAM_RANGES.items()}


class ResNetBlock(nn.Module):
    """A ResNet basic block on NCHW maps; the 1x1 projection of the
    residual where the block changes the shape (stride or width)."""

    def __init__(self, filters: int, strides: int = 1, *, in_features: int):
        super().__init__()
        self.filters, self.strides = filters, strides
        self.Conv_0 = nn.Conv2d(in_features, filters, 3, strides, 1,
                                bias=False)
        self.BatchNorm_0 = layers.BatchNorm(filters)
        self.Conv_1 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.BatchNorm_1 = layers.BatchNorm(filters)
        self.project = strides != 1 or in_features != filters
        if self.project:
            self.Conv_2 = nn.Conv2d(in_features, filters, 1, strides,
                                    bias=False)
            self.BatchNorm_2 = layers.BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.BatchNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(y + residual)


_RESNET_PLAN = ((64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                (512, 2), (512, 1))


class CNNParameterPredictor(nn.Module):
    """ResNet18-scale image predictor (model_architectures.py:11-68):
    (B, H, W, 3) -> the six heads, each (B, 1)."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.BatchNorm_0 = layers.BatchNorm(64)
        in_ch = 64
        for i, (filters, strides) in enumerate(_RESNET_PLAN):
            self.add_module(f"ResNetBlock_{i}", ResNetBlock(
                filters, strides, in_features=in_ch))
            in_ch = filters
        _add_heads(self, 512, 0)

    def forward(self, img: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        with layers.no_tf32():
            x = F.relu(self.BatchNorm_0(self.Conv_0(_nchw(img))))
            x = F.max_pool2d(x, 3, 2, 1)  # pads with -inf, as Flax
            for i in range(len(_RESNET_PLAN)):
                x = getattr(self, f"ResNetBlock_{i}")(x)
            x = _shared_mlp(self, x.mean(dim=(2, 3)), self.training,
                            generator)
            return _param_heads(self, x)


def _make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision._make_divisible channel rounding (min_value=divisor)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# EfficientNet-B0 base stages: (expand, kernel, stride, out_channels,
# repeats) — torchvision.models.efficientnet._efficientnet_conf; b3 scales
# these with (width_mult, depth_mult) = (1.2, 1.4)
_EFFNET_STAGES = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)
_EFFNET_MULTS = {"b0": (1.0, 1.0), "b3": (1.2, 1.4)}


class MBConv(nn.Module):
    """torchvision MBConv: expand 1x1 (skipped at expand=1) -> depthwise ->
    squeeze-excitation (squeeze = max(1, in//4), on the EXPANDED maps) ->
    project 1x1, residual when stride 1 and in == out (stochastic depth is
    the identity in eval).  The convs are named in Flax's order of
    creation: ``Conv_0`` the expansion (absent at expand=1), then the
    depthwise conv, the SE's two (with bias) and the projection."""

    def __init__(self, filters: int, expand: int = 6, kernel: int = 3,
                 strides: int = 1, *, in_features: int):
        super().__init__()
        self.filters, self.expand = filters, expand
        self.kernel, self.strides = kernel, strides
        self.residual = strides == 1 and in_features == filters
        exp = in_features * expand
        convs = []
        if expand != 1:
            convs.append(nn.Conv2d(in_features, exp, 1, bias=False))
        convs += [nn.Conv2d(exp, exp, kernel, strides, kernel // 2,
                            groups=exp, bias=False),
                  nn.Conv2d(exp, max(1, in_features // 4), 1),
                  nn.Conv2d(max(1, in_features // 4), exp, 1),
                  nn.Conv2d(exp, filters, 1, bias=False)]
        bn_widths = ([exp] if expand != 1 else []) + [exp, filters]
        for i, conv in enumerate(convs):
            self.add_module(f"Conv_{i}", conv)
        for i, ch in enumerate(bn_widths):
            self.add_module(f"BatchNorm_{i}", layers.BatchNorm(ch))
        self._convs = [f"Conv_{i}" for i in range(len(convs))]
        self._bns = [f"BatchNorm_{i}" for i in range(len(bn_widths))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = [getattr(self, n) for n in self._convs]
        bns = [getattr(self, n) for n in self._bns]
        h = x
        if self.expand != 1:
            h = _swish(bns.pop(0)(convs.pop(0)(h)))
        dw, fc1, fc2, proj = convs
        h = _swish(bns[0](dw(h)))
        s = fc2(_swish(fc1(h.mean(dim=(2, 3), keepdim=True))))
        h = bns[1](proj(h * torch.sigmoid(s)))
        return h + x if self.residual else h


def _effnet_blocks(variant: str):
    """(stem_ch, [(expand, kernel, stride, out_ch) per block], head_ch) for
    a variant, with torchvision's channel/depth rounding."""
    width, depth = _EFFNET_MULTS[variant]
    stem = _make_divisible(32 * width)
    blocks = []
    for expand, kernel, stride, out, repeats in _EFFNET_STAGES:
        out_ch = _make_divisible(out * width)
        for b in range(int(math.ceil(repeats * depth))):
            blocks.append((expand, kernel, stride if b == 0 else 1, out_ch))
    return stem, blocks, 4 * blocks[-1][-1]


class EfficientNetParameterPredictor(nn.Module):
    """EfficientNet-b0/b3 predictor (model_architectures.py:71-125), the
    torchvision graph (SE blocks, the per-stage schedule, the width and
    depth multipliers), so ImageNet checkpoints import through
    :func:`load_torch_efficientnet`."""

    def __init__(self, variant: str = "b0"):
        super().__init__()
        self.variant = variant
        stem, blocks, head = _effnet_blocks(variant)
        self.Conv_0 = nn.Conv2d(3, stem, 3, 2, 1, bias=False)
        self.BatchNorm_0 = layers.BatchNorm(stem)
        in_ch = stem
        for i, (expand, kernel, stride, out_ch) in enumerate(blocks):
            self.add_module(f"MBConv_{i}", MBConv(
                out_ch, expand, kernel, stride, in_features=in_ch))
            in_ch = out_ch
        self.n_blocks = len(blocks)
        self.Conv_1 = nn.Conv2d(in_ch, head, 1, bias=False)
        self.BatchNorm_1 = layers.BatchNorm(head)
        _add_heads(self, head, 0)

    def forward(self, img: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        with layers.no_tf32():
            x = _swish(self.BatchNorm_0(self.Conv_0(_nchw(img))))
            for i in range(self.n_blocks):
                x = getattr(self, f"MBConv_{i}")(x)
            x = _swish(self.BatchNorm_1(self.Conv_1(x)))
            x = _shared_mlp(self, x.mean(dim=(2, 3)), self.training,
                            generator)
            return _param_heads(self, x)


class ViTParameterPredictor(nn.Module):
    """ViT-B/16-scale predictor (model_architectures.py:128-181) for
    ``image_size``-square inputs: the patch conv with Flax's SAME padding
    (``ceil(image_size / patch)^2`` patches), a class token, a learned
    position table, ``depth`` pre-norm blocks of Flax attention and an
    exact-GELU MLP, the class token's final LayerNorm, the heads."""

    def __init__(self, patch: int = 16, dim: int = 768, depth: int = 12,
                 heads: int = 12, image_size: int = 224):
        super().__init__()
        self.patch, self.dim, self.depth = patch, dim, depth
        self.heads, self.image_size = heads, image_size
        self.Conv_0 = nn.Conv2d(3, dim, patch, patch)
        n = (-(-image_size // patch)) ** 2
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos = nn.Parameter(torch.zeros(1, 1 + n, dim))
        for i in range(depth):
            self.add_module(f"LayerNorm_{2 * i}", layers.LayerNorm(dim))
            self.add_module(f"MultiHeadDotProductAttention_{i}",
                            layers.MultiHeadDotProductAttention(dim, heads))
            self.add_module(f"LayerNorm_{2 * i + 1}", layers.LayerNorm(dim))
            self.add_module(f"Dense_{2 * i}", nn.Linear(dim, 4 * dim))
            self.add_module(f"Dense_{2 * i + 1}", nn.Linear(4 * dim, dim))
        self.add_module(f"LayerNorm_{2 * depth}", layers.LayerNorm(dim))
        _add_heads(self, dim, 2 * depth)

    def forward(self, img: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        B = img.shape[0]
        with layers.no_tf32():
            x = layers.conv2d_same(_nchw(img), self.Conv_0.weight,
                                   self.Conv_0.bias, self.patch)
            x = x.flatten(2).transpose(1, 2)  # (B, patches, dim), row-major
            if x.shape[1] + 1 != self.pos.shape[1]:
                raise ValueError(
                    f"{tuple(img.shape[1:3])} images give {x.shape[1]} "
                    f"patches; the position table was made for "
                    f"{self.pos.shape[1] - 1} (image_size {self.image_size})")
            x = torch.cat([self.cls.expand(B, -1, -1), x], dim=1) + self.pos
            for i in range(self.depth):
                y = getattr(self, f"LayerNorm_{2 * i}")(x)
                x = x + getattr(self, f"MultiHeadDotProductAttention_{i}")(y)
                y = getattr(self, f"LayerNorm_{2 * i + 1}")(x)
                # exact (erf) GELU, as torchvision's MLPBlock
                y = F.gelu(getattr(self, f"Dense_{2 * i}")(y))
                x = x + getattr(self, f"Dense_{2 * i + 1}")(y)
            x = getattr(self, f"LayerNorm_{2 * self.depth}")(x)[:, 0]
            x = _shared_mlp(self, x, self.training, generator)
            return _param_heads(self, x)


# ---- the torchvision loaders ----------------------------------------------

def _numpy_state(torch_state) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v)) for k, v in torch_state.items()}


def _copy(dst: torch.Tensor, state: Dict[str, np.ndarray], key: str) -> None:
    v = state[key]
    if tuple(v.shape) != tuple(dst.shape):
        raise ValueError(f"{key}: shape {tuple(v.shape)}, the module takes "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.asarray(v, np.float32)))


def _conv_from_torch(conv: nn.Conv2d, state, key: str, bias: bool = False):
    _copy(conv.weight, state, f"{key}.weight")
    if bias:
        _copy(conv.bias, state, f"{key}.bias")


def _bn_from_torch(bn: nn.Module, state, key: str) -> None:
    for attr in ("weight", "bias", "running_mean", "running_var"):
        _copy(getattr(bn, attr), state, f"{key}.{attr}")


def load_torch_resnet18(variables: nn.Module,
                        torch_state: Dict[str, Any]) -> nn.Module:
    """Fill a CNNParameterPredictor's backbone from a torchvision resnet18
    state_dict (model_architectures.py:13; the reference drops ``fc`` for
    its own MLP and heads, which stay as they are), in place; returns the
    module.  Keys: ``conv1.weight``, ``bn1.*``, ``layer{1-4}.{0,1}.*``
    (tensors or numpy arrays)."""
    state = _numpy_state(torch_state)
    m = variables
    with torch.no_grad():
        _conv_from_torch(m.Conv_0, state, "conv1")
        _bn_from_torch(m.BatchNorm_0, state, "bn1")
        for layer in range(1, 5):
            for block in range(2):
                b = getattr(m, f"ResNetBlock_{(layer - 1) * 2 + block}")
                t = f"layer{layer}.{block}"
                _conv_from_torch(b.Conv_0, state, f"{t}.conv1")
                _bn_from_torch(b.BatchNorm_0, state, f"{t}.bn1")
                _conv_from_torch(b.Conv_1, state, f"{t}.conv2")
                _bn_from_torch(b.BatchNorm_1, state, f"{t}.bn2")
                if f"{t}.downsample.0.weight" in state:
                    _conv_from_torch(b.Conv_2, state, f"{t}.downsample.0")
                    _bn_from_torch(b.BatchNorm_2, state, f"{t}.downsample.1")
    return m


def _load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_resnet18_npz(variables: nn.Module, npz_path: str) -> nn.Module:
    """load_torch_resnet18 from a ``.npz`` of the state_dict's arrays under
    their state_dict keys."""
    return load_torch_resnet18(variables, _load_npz(npz_path))


def load_torch_efficientnet(variables: nn.Module,
                            torch_state: Dict[str, Any],
                            variant: str = "b0") -> nn.Module:
    """Fill an EfficientNetParameterPredictor's backbone from a
    torchvision efficientnet_b0/b3 state_dict (model_architectures.py:
    80-86; ``classifier`` is dropped), in place; returns the module.
    Per block ``features.{s}.{b}.block``: the expansion ConvBNAct (absent
    at expand=1), the depthwise ConvBNAct, SqueezeExcitation (fc1/fc2 1x1
    convs with bias), the projection ConvBN; depthwise weights (E, 1, k, k)
    are the port's layout for ``groups=E``."""
    state = _numpy_state(torch_state)
    m = variables
    _, depth_mult = _EFFNET_MULTS[variant]
    with torch.no_grad():
        _conv_from_torch(m.Conv_0, state, "features.0.0")
        _bn_from_torch(m.BatchNorm_0, state, "features.0.1")
        i = 0
        for si, (expand, _k, _s, _out, repeats) in enumerate(_EFFNET_STAGES,
                                                            1):
            for b in range(int(math.ceil(repeats * depth_mult))):
                t = f"features.{si}.{b}.block"
                blk = getattr(m, f"MBConv_{i}")
                convs = [getattr(blk, n) for n in blk._convs]
                bns = [getattr(blk, n) for n in blk._bns]
                j = 0
                if expand != 1:
                    _conv_from_torch(convs.pop(0), state, f"{t}.0.0")
                    _bn_from_torch(bns.pop(0), state, f"{t}.0.1")
                    j = 1
                dw, fc1, fc2, proj = convs
                _conv_from_torch(dw, state, f"{t}.{j}.0")
                _bn_from_torch(bns[0], state, f"{t}.{j}.1")
                _conv_from_torch(fc1, state, f"{t}.{j + 1}.fc1", bias=True)
                _conv_from_torch(fc2, state, f"{t}.{j + 1}.fc2", bias=True)
                _conv_from_torch(proj, state, f"{t}.{j + 2}.0")
                _bn_from_torch(bns[1], state, f"{t}.{j + 2}.1")
                i += 1
        last = len(_EFFNET_STAGES) + 1
        _conv_from_torch(m.Conv_1, state, f"features.{last}.0")
        _bn_from_torch(m.BatchNorm_1, state, f"features.{last}.1")
    return m


def load_efficientnet_npz(variables: nn.Module, npz_path: str,
                          variant: str = "b0") -> nn.Module:
    """load_torch_efficientnet from a ``.npz`` of the state_dict's
    arrays."""
    return load_torch_efficientnet(variables, _load_npz(npz_path), variant)


def load_torch_vit(variables: nn.Module,
                   torch_state: Dict[str, Any]) -> nn.Module:
    """Fill a ViTParameterPredictor's backbone from a torchvision
    vit_b_16-format state_dict (model_architectures.py:131; ``heads`` is
    dropped), in place; returns the module.  The depth is read from the
    state dict.  Key map (torchvision names):
      conv_proj.{weight,bias}            -> Conv_0
      class_token                        -> cls
      encoder.pos_embedding              -> pos
      encoder.layers.encoder_layer_i.ln_1          -> LayerNorm_{2i}
      ...self_attention.{in_proj_*,out_proj.*}     -> MultiHeadDotProductAttention_{i}
      ...ln_2                                      -> LayerNorm_{2i+1}
      ...mlp.{0,3} (new) / mlp.linear_{1,2} (old)  -> Dense_{2i}, Dense_{2i+1}
      encoder.ln                         -> LayerNorm_{2*depth}
    The packed in_proj rows split into query, key and value, whose
    (out, in) weights are the port's layout."""
    state = _numpy_state(torch_state)
    m = variables
    pos = state["encoder.pos_embedding"]
    if tuple(m.pos.shape) != tuple(pos.shape):
        raise ValueError(
            f"pos embedding {tuple(pos.shape)} does not match the model's "
            f"{tuple(m.pos.shape)} — build the ViT at the artifact's "
            f"image size (vit_b_16: 224)")
    dim = state["conv_proj.weight"].shape[0]
    depth = 0
    while f"encoder.layers.encoder_layer_{depth}.ln_1.weight" in state:
        depth += 1

    def linear(layer, key):
        _copy(layer.weight, state, f"{key}.weight")
        _copy(layer.bias, state, f"{key}.bias")

    with torch.no_grad():
        linear(m.Conv_0, "conv_proj")
        _copy(m.cls, state, "class_token")
        _copy(m.pos, state, "encoder.pos_embedding")
        for i in range(depth):
            t = f"encoder.layers.encoder_layer_{i}"
            linear(getattr(m, f"LayerNorm_{2 * i}"), f"{t}.ln_1")
            linear(getattr(m, f"LayerNorm_{2 * i + 1}"), f"{t}.ln_2")
            attn = getattr(m, f"MultiHeadDotProductAttention_{i}")
            ipw = state[f"{t}.self_attention.in_proj_weight"]  # (3*dim, dim)
            ipb = state[f"{t}.self_attention.in_proj_bias"]
            for j, part in enumerate(("query", "key", "value")):
                rows = {"w": ipw[j * dim:(j + 1) * dim],
                        "b": ipb[j * dim:(j + 1) * dim]}
                _copy(getattr(attn, part).weight, rows, "w")
                _copy(getattr(attn, part).bias, rows, "b")
            linear(attn.out, f"{t}.self_attention.out_proj")
            # torchvision >= 0.12 names the MLP Sequential 0/3; older
            # linear_1/2
            new = f"{t}.mlp.0.weight" in state
            linear(getattr(m, f"Dense_{2 * i}"),
                   f"{t}.mlp.0" if new else f"{t}.mlp.linear_1")
            linear(getattr(m, f"Dense_{2 * i + 1}"),
                   f"{t}.mlp.3" if new else f"{t}.mlp.linear_2")
        linear(getattr(m, f"LayerNorm_{2 * depth}"), "encoder.ln")
    return m


def load_vit_npz(variables: nn.Module, npz_path: str) -> nn.Module:
    """load_torch_vit from a ``.npz`` of the state_dict's arrays."""
    return load_torch_vit(variables, _load_npz(npz_path))


def create_model(model_type: str = "mlp", **kwargs) -> nn.Module:
    """model_architectures.py:188-227 factory (its 'mlp' import fixed)."""
    if model_type == "mlp":
        from underwater_image_enhancement_tpu_torch.models.mlp import (
            ParameterPredictor,
        )

        return ParameterPredictor(feature_dim=79, **kwargs)
    if model_type == "resnet":
        return CNNParameterPredictor(**kwargs)
    if model_type == "efficientnet":
        return EfficientNetParameterPredictor(**kwargs)
    if model_type == "vit":
        return ViTParameterPredictor(**kwargs)
    if model_type == "vgg":
        from underwater_image_enhancement_tpu_torch.models.vgg import (
            ImprovedVGGParameterNet,
        )

        return ImprovedVGGParameterNet(**kwargs)
    raise ValueError(f"unknown model type: {model_type}")
