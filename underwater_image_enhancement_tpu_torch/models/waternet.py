"""Water-Net gated-fusion CNN enhancer and a small UNet (the JAX
package's ``models/waternet.py``).

* :class:`WaterNet`, the gated-fusion network of Li et al., "An Underwater
  Image Enhancement Benchmark Dataset and Beyond" (UIEB, TIP 2019): the
  raw frame and three classically preprocessed views (white-balanced,
  histogram-equalised, gamma-corrected) are each refined by a Feature
  Transformation Unit, and a confidence branch over the stacked views
  predicts per-pixel softmax weights that fuse the refinements.
* :class:`UNetEnhancer`, a 3-level encoder/decoder with skip connections
  that emits a residual correction.

Images are NHWC at the public boundary, as in JAX; the convs run NCHW
inside (cuDNN on the card; JAX leaves them to ``lax.conv``, outside any
Pallas kernel).  Flax's convs here are ``'SAME'``-padded
(``layers.conv2d_same``): symmetric for the stride-1 7x7, 5x5 and 3x3,
(0, 1) on an even side for the UNet's two stride-2 3x3.  In f32 the convs
run in full f32 (``layers.no_tf32``), as JAX pins ``Precision.HIGHEST``.
``dtype=torch.bfloat16`` is the deployment dtype: activations and conv
weights in bf16, parameters kept f32, the confidence softmax and the
fusion in f32.

Submodules carry the Flax names (``Conv_0`` ... ``Conv_6``,
``ftu_wb``/``ftu_he``/``ftu_gc`` with ``Conv_0`` ... ``Conv_2``), so
``models/bridge`` maps a JAX variable tree onto them.  Where JAX passes a
variable tree with a model, the port passes the module that holds the
parameters (``variables``) and, optionally, a module of the same layout
whose configuration runs them (``model``, e.g. the bf16 one).
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from underwater_image_enhancement_tpu_torch.models import bridge, layers
from underwater_image_enhancement_tpu_torch.ops import histeq, stretch
from underwater_image_enhancement_tpu_torch.ops.layout import div
from underwater_image_enhancement_tpu_torch.pipeline.enhance import _on_device


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
          stride: int = 1) -> torch.Tensor:
    """A Flax ``nn.Conv(dtype=dtype)``: input, kernel and bias in
    ``dtype``, SAME padding."""
    return layers.conv2d_same(x.to(dtype), conv.weight.to(dtype),
                              conv.bias.to(dtype), stride)


def _nchw(*imgs: torch.Tensor) -> torch.Tensor:
    return torch.cat([im.permute(0, 3, 1, 2) for im in imgs], dim=1)


class FTU(nn.Module):
    """Feature Transformation Unit: refines one preprocessed view, seen
    beside the raw frame (6 input channels), into 3 channels."""

    def __init__(self, features: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features, self.dtype = features, dtype
        self.Conv_0 = nn.Conv2d(6, features, 7)
        self.Conv_1 = nn.Conv2d(features, features, 5)
        self.Conv_2 = nn.Conv2d(features, 3, 3)

    def forward(self, raw: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
        """NCHW (B, 3, H, W) each -> (B, 3, H, W) in ``dtype``."""
        x = torch.cat([raw, view], dim=1)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = F.relu(_conv(conv, x, self.dtype))
        return x


class WaterNet(nn.Module):
    """Gated-fusion enhancer over (raw, wb, he, gc) NHWC views in [0, 1].

    The confidence branch is the UIEB paper's 8-conv trunk (7x7/5x5/3x3
    at ``features``, three 3x3 at ``features // 2``, a 3-channel head)
    with a per-pixel softmax; output = sum_i conf_i * FTU_i(raw, view_i),
    clipped to [0, 1]."""

    def __init__(self, features: int = 128, ftu_features: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features, self.ftu_features, self.dtype = (
            features, ftu_features, dtype)
        f, h = features, features // 2
        for i, (cin, cout, k) in enumerate(((12, f, 7), (f, f, 5), (f, f, 3),
                                            (f, h, 3), (h, h, 3), (h, h, 3),
                                            (h, 3, 3))):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, cout, k))
        for name in ("ftu_wb", "ftu_he", "ftu_gc"):
            self.add_module(name, FTU(ftu_features, dtype))

    def forward(self, raw, wb, he, gc) -> torch.Tensor:
        with layers.no_tf32():
            t = _nchw(raw, wb, he, gc)
            for i in range(6):
                t = F.relu(_conv(getattr(self, f"Conv_{i}"), t, self.dtype))
            conf = torch.softmax(
                _conv(self.Conv_6, t, self.dtype).float(), dim=1)
            r, views = _nchw(raw), (_nchw(wb), _nchw(he), _nchw(gc))
            out = sum(conf[:, i:i + 1] * getattr(self, name)(r, v).float()
                      for i, (name, v) in enumerate(
                          zip(("ftu_wb", "ftu_he", "ftu_gc"), views)))
            return torch.clamp(out, 0.0, 1.0).permute(0, 2, 3, 1)


class UNetEnhancer(nn.Module):
    """3-level UNet emitting a residual over the raw frame: encoder
    features (F, 2F, 4F) with stride-2 downsampling convs, nearest 2x
    upsampling and skip concatenation back, a 3-channel head added to the
    input.  H and W must be multiples of 4; :func:`unet_enhance` pads and
    crops."""

    def __init__(self, features: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features, self.dtype = features, dtype
        f = features
        for i, (cin, cout) in enumerate(((3, f), (f, f), (f, 2 * f),
                                         (2 * f, 2 * f), (2 * f, 4 * f),
                                         (4 * f, 4 * f), (6 * f, 2 * f),
                                         (3 * f, f), (f, 3))):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, cout, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def conv(i, t, stride=1):
            return _conv(getattr(self, f"Conv_{i}"), t, self.dtype, stride)

        with layers.no_tf32():
            raw = x.permute(0, 3, 1, 2)
            e0 = F.relu(conv(1, F.relu(conv(0, raw))))
            e1 = F.relu(conv(3, F.relu(conv(2, e0, 2))))
            b = F.relu(conv(5, F.relu(conv(4, e1, 2))))
            u1 = F.relu(conv(6, torch.cat([_upsample2(b), e1], dim=1)))
            u0 = F.relu(conv(7, torch.cat([_upsample2(u1), e0], dim=1)))
            res = conv(8, u0).float()
            return torch.clamp(raw + res, 0.0, 1.0).permute(0, 2, 3, 1)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of NCHW maps (each value repeated in
    a 2x2 block)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


# ---------------------------------------------------------------------------
# the preprocessing views and the CNN on a batch
# ---------------------------------------------------------------------------

def preprocess_views(img: torch.Tensor, gamma: float = 0.7
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three classical views Water-Net fuses, from the port's ops.

    img: (..., H, W, 3) float in [0, 1].  Returns (wb, he, gc): gray-world
    white balance (per image), cv2's per-channel histogram equalisation
    (once per image), and the brightening gamma clip(img ** gamma)."""
    wb = stretch.gray_world_white_balance(img)
    if img.dim() == 3:
        he = histeq.histogram_equalization(img)
    else:
        flat = img.reshape((-1,) + tuple(img.shape[-3:]))
        he = torch.stack([histeq.histogram_equalization(im) for im in flat])
        he = he.reshape(img.shape)
    gc = torch.clamp(stretch.gamma_correction_pow(img, gamma), 0.0, 1.0)
    return wb, he, gc


def init_waternet(rng: torch.Generator, image_size: int = 64,
                  model: Optional[WaterNet] = None) -> WaterNet:
    """``model`` (default ``WaterNet()``) with Flax's default
    initialisers drawn from ``rng`` (``bridge.flax_default_init``), in
    eval mode; returns it.  ``image_size`` is JAX's dummy input size: the
    convs take any H, W, so the port's modules need none."""
    model = model if model is not None else WaterNet()
    bridge.flax_default_init(model, rng)
    return model.eval()


def _run(variables: nn.Module, model: Optional[nn.Module], *args):
    """``model`` (default ``variables``) run with the parameters of
    ``variables``, as Flax's ``model.apply(variables, ...)``."""
    if model is None or model is variables:
        return variables(*args)
    state = {**dict(variables.named_parameters()),
             **dict(variables.named_buffers())}
    return torch.func.functional_call(model, state, args)


def _batch(variables: nn.Module, imgs) -> Tuple[torch.Tensor, bool]:
    """imgs (H, W, 3) or (N, H, W, 3) -> (N, H, W, 3) f32, and whether it
    was one image.  A tensor stays on its device; a numpy array goes to
    the device of ``variables``' parameters."""
    dev = (imgs.device if isinstance(imgs, torch.Tensor)
           else next(variables.parameters()).device)
    imgs = _on_device(imgs, dev)
    single = imgs.dim() == 3
    return (imgs[None] if single else imgs), single


@torch.no_grad()
def waternet_enhance(variables: nn.Module, imgs,
                     model: Optional[WaterNet] = None) -> torch.Tensor:
    """The WB / HE / gamma views and the gated fusion net on a batch.

    variables: the WaterNet whose parameters run; model: a WaterNet of the
    same layout whose configuration (dtype) runs them (default
    ``variables`` itself).  imgs: (N, H, W, 3) or (H, W, 3) in [0, 1], a
    tensor on the parameters' device or a numpy array.  Returns the
    enhanced frames, f32, same shape, on that device."""
    x, single = _batch(variables, imgs)
    wb, he, gc = preprocess_views(x)
    out = _run(variables, model, x, wb, he, gc)
    return out[0] if single else out


@torch.no_grad()
def unet_enhance(variables: nn.Module, imgs,
                 model: Optional[UNetEnhancer] = None) -> torch.Tensor:
    """The UNet enhancer on frames edge-padded to multiples of 4 (bottom
    and right), cropped back."""
    x, single = _batch(variables, imgs)
    h, w = x.shape[1:3]
    x = F.pad(x.permute(0, 3, 1, 2), (0, (-w) % 4, 0, (-h) % 4),
              mode="replicate").permute(0, 2, 3, 1)
    out = _run(variables, model, x)[:, :h, :w, :]
    return out[0] if single else out


# ---------------------------------------------------------------------------
# over a mesh: the batch, or one large frame's rows
# ---------------------------------------------------------------------------

# rows of context a WaterNet output row reads: the trunk's 7x7, 5x5 and
# five 3x3 convs (3 + 2 + 1 + 1 + 1 + 1 + 1); the FTUs' (3 + 2 + 1) fewer
_ROW_HALO = 10


def _replicas(variables: nn.Module, devices) -> dict:
    """``variables`` once a distinct device (itself where it lives)."""
    home = next(variables.parameters()).device
    return {d: variables if d == home else copy.deepcopy(variables).to(d)
            for d in dict.fromkeys(devices)}


def _views_sharded(blocks, exts):
    """The (wb, he, gc) views of each position's extended block from the
    whole frame's statistics: the gray-world channel means (each block's
    true rows summed in XLA:CPU's order, the sums added in mesh order) and
    cv2's equalisation histograms (summed exactly).  blocks: (N, Hl, W, 3)
    a position; exts: the same blocks with their halo rows."""
    from underwater_image_enhancement_tpu_torch.ops import colorspace as cs
    from underwater_image_enhancement_tpu_torch.parallel.spatial import (
        _psum,
        _psum_mean,
    )

    N, _, W, _ = blocks[0].shape
    H = sum(b.shape[1] for b in blocks)
    means = _psum_mean([b.permute(3, 0, 1, 2).reshape(3 * N, b.shape[1], W)
                        for b in blocks], H * W).reshape(3, N)
    target = (means[0] + means[1] + means[2]) * np.float32(
        np.float32(1.0) / np.float32(3.0))
    hists = _psum([histeq.histogram256(cs.quantize_u8(b).permute(0, 3, 1, 2)
                                       .reshape(3 * N, -1)) for b in blocks])
    out = []
    for ext, hist in zip(exts, hists):
        dev = ext.device
        # per image and channel: target / max(mean, 1e-6), IEEE
        gain = div(torch.as_tensor(target, device=dev)[None, :],
                           torch.clamp(torch.as_tensor(means, device=dev),
                                       min=1e-6)).T      # (N, 3)
        wb = torch.clamp(ext * gain[:, None, None, :], 0.0, 1.0)
        u8 = cs.quantize_u8(ext)
        he = torch.empty_like(ext)
        for k in range(3 * N):
            lut, flat = histeq._equalize_lut(hist[k], H * W)
            c = u8[k // 3, ..., k % 3]
            he[k // 3, ..., k % 3] = cs.u8_to_unit(
                torch.where(flat, c, lut[c.long()]))
        gc = torch.clamp(stretch.gamma_correction_pow(ext, 0.7), 0.0, 1.0)
        out.append((wb, he, gc))
    return out


@torch.no_grad()
def enhance_sharded(variables: nn.Module, imgs, mesh,
                    model: Optional[WaterNet] = None,
                    shard_rows: bool = False) -> torch.Tensor:
    """WaterNet over a mesh (the 4K-frame path), the result on
    ``mesh.devices[0]``.

    By default the batch is split over the mesh's positions (data
    parallel), one replica of the net a distinct device.
    ``shard_rows=True`` splits each image's rows over the positions
    instead, for a frame too large for one device: the views come from the
    whole frame's statistics (the gray-world sums and the equalisation
    histograms summed over the positions), the net runs on each block with
    ``_ROW_HALO`` rows of its neighbours a side, and the halo is cropped
    away; SAME's zero padding then falls only at the frame's true edges,
    so the kept rows are the whole frame's.  Rows per block must be at
    least 8."""
    from underwater_image_enhancement_tpu_torch.parallel.mesh import _tensor
    from underwater_image_enhancement_tpu_torch.parallel.spatial import (
        _exchange_halo,
        _gather,
    )

    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    imgs = _tensor(imgs).to(torch.float32)
    single = imgs.dim() == 3
    batch = imgs.shape[0] if imgs.dim() == 4 else 1
    if shard_rows:
        rows = imgs.shape[-3]
        if rows % n_dev != 0:
            raise ValueError(
                f"shard_rows: image rows ({rows}) must divide the mesh "
                f"'{axis}' axis size ({n_dev})")
        if rows // n_dev < 8:
            raise ValueError(
                f"shard_rows: {rows // n_dev} rows/shard is below the "
                f"7-pixel conv halo; use more rows or fewer devices")
    elif batch % n_dev != 0:
        raise ValueError(
            f"batch size ({batch}) must divide the mesh '{axis}' axis "
            f"size ({n_dev}); pad the batch or use shard_rows=True")
    x = imgs[None] if single else imgs
    nets = _replicas(variables, mesh.devices)
    if not shard_rows:
        k = batch // n_dev
        out = _gather([waternet_enhance(nets[d], x[i * k:(i + 1) * k].to(d),
                                        model)
                       for i, d in enumerate(mesh.devices)])
        return out[0] if single else out
    hl = x.shape[1] // n_dev
    blocks = [x[:, i * hl:(i + 1) * hl].to(d)
              for i, d in enumerate(mesh.devices)]
    exts = [e.permute(1, 0, 2, 3) for e in _exchange_halo(
        [b.permute(1, 0, 2, 3) for b in blocks], _ROW_HALO, edge="edge")]
    H = hl * n_dev
    # keep only true rows: a block's halo stops at the frame's edges
    cut = [(max(_ROW_HALO - i * hl, 0),
            max((i + 1) * hl + _ROW_HALO - H, 0)) for i in range(n_dev)]
    exts = [e[:, top:e.shape[1] - bottom] for e, (top, bottom)
            in zip(exts, cut)]
    outs = []
    for i, (d, ext, views) in enumerate(zip(mesh.devices, exts,
                                            _views_sharded(blocks, exts))):
        y = _run(nets[d], model, ext, *views)
        top = _ROW_HALO - cut[i][0]
        outs.append(y[:, top:top + hl])
    out = _gather(outs, dim=1)
    return out[0] if single else out
