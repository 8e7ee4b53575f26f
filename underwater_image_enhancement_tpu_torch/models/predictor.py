"""Inference engines: EnhancementPredictor (use_trained_model.py:13-164)
and ZooPredictor, the JAX package's ``models/predictor.py``.

Per image: the 79 features and the 224^2 ImageNet-normalised input ->
ImprovedVGGParameterNet -> the parameter dict with its defaults
(guided_radius=15, use_gamma=1, omega=0.6) and safety clamps (:69-79) ->
the full-resolution enhance (``enhance_batch(..., stretch_mode="index")``)
-> NaN scrub (:107-109).  ZooPredictor does the same with a zoo backbone
(``models/zoo``: resnet, efficientnet b0/b3, vit) and its six parameters
through ``diff_enhance.enhance_zoo``, without the features.  Parameters
are predicted at 224x224 (the zoo's ``input_size``) and applied at full
resolution.  Everything runs on the predictor's device (``cuda``
unless asked otherwise); the host reads the four parameters once a frame.

Checkpoints are the port's ``.npz`` (``models/bridge``): a JAX (orbax)
checkpoint is converted once with ``tools/jax_ckpt_to_npz.py``.  Random
initialisation draws from ``torch.Generator().manual_seed(seed)``; it
cannot equal Flax's, so equality with a JAX predictor comes only through a
checkpoint.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.features.full import (
    extract_all_features,
)
from underwater_image_enhancement_tpu_torch.models import bridge, zoo
from underwater_image_enhancement_tpu_torch.models.diff_enhance import (
    enhance_zoo,
)
from underwater_image_enhancement_tpu_torch.models.vgg import (
    IMAGENET_INV_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    ImprovedVGGParameterNet,
    load_backbone_npz,
)
from underwater_image_enhancement_tpu_torch.ops.resize import resize_u8
from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
    _on_device,
    enhance_batch,
    resolve_device,
)
from underwater_image_enhancement_tpu_torch.utils import io as uio

CLAMPS = {  # use_trained_model.py:74-79
    "omega": (0.1, 0.9),
    "gamma": (0.5, 3.0),
    "L_low": (1.0, 30.0),
    "L_high": (65.0, 99.0),
    "guided_radius": (1.0, 50.0),
    "use_gamma": (0.0, 1.0),
}

# the jitted JAX preprocess divides by 255 and by IMAGENET_STD as
# multiplies by their f32 reciprocals (IMAGENET_STD is re-exported as the
# JAX module's name; the preprocess multiplies by IMAGENET_INV_STD) (found by comparing candidates with
# the jitted function; tests/test_torch_predictor.py holds it bit-equal)
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def _resize_unit(img: torch.Tensor, size: int) -> torch.Tensor:
    """use_trained_model.py:39-46: u8 (truncated) resize to size^2, then
    /255 as the jitted JAX function computes it."""
    u8 = torch.clamp(img * 255.0, 0, 255).to(torch.int32)
    return torch.stack([resize_u8(u8[..., c], size, size) for c in range(3)],
                       dim=-1).to(torch.float32) * _INV_255


def _scrub(out: torch.Tensor) -> np.ndarray:
    """NaN scrub (use_trained_model.py:107-109) of a frame, on the host."""
    out = out.cpu().numpy()
    if not np.isfinite(out).all():
        out = np.nan_to_num(out, nan=0.0, posinf=1.0, neginf=0.0)
    return np.clip(out, 0.0, 1.0)


class _FramePredictor:
    """What both predictors do with files: read, predict, enhance,
    write ``{stem}_enhanced.png``."""

    def process_single_image(self, input_path: str,
                             output_path: Optional[str] = None,
                             log=print) -> Dict[str, float]:
        img = uio.imread_unit(input_path)
        if img is None:
            raise ValueError(f"unreadable image: {input_path}")
        x = _on_device(img, self.device)
        params = self.predict_parameters(x)
        out = self.enhance_image(x, params)
        inp = Path(input_path)
        if output_path is None:
            output_path = str(inp.parent / f"{inp.stem}_enhanced.png")
        else:
            op = Path(output_path)
            if op.suffix == "":
                output_path = str(op / f"{inp.stem}_enhanced.png")
        uio.imwrite_unit(output_path, out)
        log(f"saved: {output_path}")
        return params

    def process_folder(self, input_folder: str, output_folder: str,
                       log=print) -> int:
        files = uio.collect_images(input_folder)
        done = 0
        for p in files:
            try:
                out = str(Path(output_folder) / f"{p.stem}_enhanced.png")
                self.process_single_image(str(p), out, log=lambda *_: None)
                done += 1
            except RuntimeError:
                # a failed kernel launch or device fault ends the run
                raise
            except Exception as e:  # per-item fault tolerance (:163-164)
                log(f"failed {p.name}: {e}")
        return done


class EnhancementPredictor(_FramePredictor):
    def __init__(self, checkpoint_path: Optional[str] = None,
                 hidden_dim: int = 256, input_size: int = 224, seed: int = 0,
                 pretrained_vgg: Optional[str] = "auto",
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.input_size = input_size
        self.model = ImprovedVGGParameterNet(hidden_dim=hidden_dim)
        bridge.flax_default_init(self.model,
                                 torch.Generator().manual_seed(seed))
        if pretrained_vgg == "auto":
            # conventional artifact path; a loaded checkpoint below
            # overrides the trunk anyway
            from underwater_image_enhancement_tpu_torch.utils.weights import (
                find_vgg16_npz,
            )

            pretrained_vgg = find_vgg16_npz()
        if pretrained_vgg is not None:
            load_backbone_npz(self.model, pretrained_vgg)
        self.model.to(self.device).eval()
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._inv_std = torch.from_numpy(IMAGENET_INV_STD).to(self.device)
        if checkpoint_path is not None:
            self.load(checkpoint_path)

    def load(self, checkpoint_path: str) -> None:
        """The port's ``.npz`` checkpoint ({params, batch_stats}, keyed by
        ``/``-joined paths; ``models/bridge``).  An orbax directory (the
        JAX trainers' format) raises, naming the converter."""
        bridge.load_flax(self.model, bridge.load_checkpoint(checkpoint_path, "vgg"))

    def _preprocess(self, img: torch.Tensor) -> torch.Tensor:
        """use_trained_model.py:39-46: u8 (truncated) resize to
        input_size, then /255 and the ImageNet normalisation, each
        division as the jitted JAX function computes it."""
        small = _resize_unit(img, self.input_size)
        return (small - self._mean) * self._inv_std

    @torch.no_grad()
    def predict_parameters(self, img) -> Dict[str, float]:
        """(H, W, 3) [0,1] -> clamped scalar param dict (:53-81)."""
        img = _on_device(img, self.device)
        feats = extract_all_features(img)[None]
        raw = self.model(self._preprocess(img)[None], feats)
        names = list(raw)
        vals = torch.cat([raw[k].reshape(-1)[:1] for k in names]).cpu()
        params = {k: float(v) for k, v in zip(names, vals.tolist())}
        params.setdefault("guided_radius", 15.0)
        params.setdefault("use_gamma", 1.0)
        params.setdefault("omega", 0.6)
        for k, (lo, hi) in CLAMPS.items():
            params[k] = float(np.clip(params.get(k, (lo + hi) / 2), lo, hi))
        return params

    def enhance_image(self, img, params: Optional[Dict[str, float]] = None
                      ) -> np.ndarray:
        """Full-resolution enhancement + NaN scrub (:83-111) -> (H, W, 3)
        float32 numpy in [0, 1]."""
        img = _on_device(img, self.device)
        if params is None:
            params = self.predict_parameters(img)
        return _scrub(enhance_batch(
            img[None], params["L_low"], params["L_high"], params["omega"],
            params["gamma"], stretch_mode="index", device=self.device)[0])


class ZooPredictor(_FramePredictor):
    """EnhancementPredictor-style inference for the model_architectures.py
    backbones (resnet, efficientnet b0/b3, vit): the six parameters
    predicted at ``input_size``^2 and applied at full resolution through
    ``diff_enhance.enhance_zoo``.  The reference ships these backbones
    with no inference entry point; this one reads the zoo trainers'
    checkpoints once converted to the port's ``.npz``."""

    def __init__(self, checkpoint_path: Optional[str] = None,
                 model_type: str = "resnet", variant: str = "b0",
                 input_size: int = 224, seed: int = 0,
                 imagenet_normalize: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.model_type = model_type
        self.input_size = input_size
        self.imagenet_normalize = imagenet_normalize
        kwargs = ({"variant": variant} if model_type == "efficientnet" else
                  {"image_size": input_size} if model_type == "vit" else {})
        self.model = zoo.create_model(model_type, **kwargs)
        if checkpoint_path is None:
            bridge.flax_default_init(self.model,
                                     torch.Generator().manual_seed(seed))
        else:  # a checkpoint replaces every leaf (no load is partial)
            self.load(checkpoint_path)
        self.model.to(self.device).eval()
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._inv_std = torch.from_numpy(IMAGENET_INV_STD).to(self.device)

    def load(self, checkpoint_path: str) -> None:
        """The port's ``.npz`` checkpoint ({params, batch_stats}); an
        orbax directory (a raw or a ZooTrainer checkpoint of the JAX
        package) raises, naming the converter."""
        bridge.load_flax(self.model, bridge.load_checkpoint(
            checkpoint_path, self.model_type))

    def _preprocess(self, img: torch.Tensor) -> torch.Tensor:
        """u8 resize to input_size, /255, the ImageNet normalisation
        unless ``imagenet_normalize`` is False (ZooTrainer._backbone_input
        plus the predictor's resize), as the jitted JAX function
        computes them."""
        small = _resize_unit(img, self.input_size)
        if not self.imagenet_normalize:
            return small
        return (small - self._mean) * self._inv_std

    @torch.no_grad()
    def predict_parameters(self, img) -> Dict[str, float]:
        """(H, W, 3) [0,1] -> clamped scalar six-parameter dict."""
        img = _on_device(img, self.device)
        raw = self.model(self._preprocess(img)[None])
        names = list(raw)
        vals = torch.cat([raw[k].reshape(-1)[:1] for k in names]).cpu()
        params = {k: float(v) for k, v in zip(names, vals.tolist())}
        for k, (lo, hi) in CLAMPS.items():
            params[k] = float(np.clip(params.get(k, (lo + hi) / 2), lo, hi))
        return params

    def enhance_image(self, img, params: Optional[Dict[str, float]] = None
                      ) -> np.ndarray:
        """Full-resolution zoo-composite enhancement + NaN scrub ->
        (H, W, 3) float32 numpy in [0, 1]."""
        img = _on_device(img, self.device)
        if params is None:
            params = self.predict_parameters(img)
        return _scrub(enhance_zoo(img[None], params, stretch_mode="index")[0])
