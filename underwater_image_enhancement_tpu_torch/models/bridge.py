"""Parameters between the JAX package's Flax trees and the port's modules.

A Flax variable tree is nested dicts of arrays, one collection a key
(``params``, and ``batch_stats`` where the model has BatchNorm).  The
port's modules name their submodules as the Flax modules are named
(``vgg.conv0``, ``Dense_0``, ``BatchNorm_0``, ``head_omega_0``), so a
module's dotted path is the tree's ``/``-joined one.  Each layer maps its
leaves:

- ``nn.Linear``: Flax ``Dense.kernel`` (in, out) is ``weight`` (out, in)
  transposed; ``bias`` is ``bias``.
- ``nn.Conv2d``: Flax ``Conv.kernel`` HWIO is ``weight`` OIHW.
- ``nn.BatchNorm1d``/``2d`` (and ``layers.BatchNorm``): ``params``
  ``scale``/``bias`` are ``weight``/``bias``; ``batch_stats``
  ``mean``/``var`` are ``running_mean``/``running_var``.
- ``nn.LayerNorm`` (and ``layers.LayerNorm``): ``scale``/``bias`` are
  ``weight``/``bias``.
- ``layers.HeadsLinear``, an attention projection as a ``Linear(dim,
  dim)``: a query, key or value ``kernel`` (dim, heads, hd) is ``weight``
  transposed and split by head, its ``bias`` (heads, hd) is ``bias``
  split; the ``out`` ``kernel`` (heads, hd, dim) is ``weight`` transposed
  with its input split, its ``bias`` (dim,) is ``bias``.
- A parameter held by a module itself, not by one of these layers (the
  ViT's ``cls`` and ``pos``), is the Flax leaf of its name, as it is.

``load_flax`` raises on any missing, extra or wrongly shaped leaf, so no
load is partial.  ``to_flax`` goes the other way, to numpy arrays.

The port's checkpoint is one ``.npz`` of such a tree keyed by the leaves'
``/``-joined paths (``params/vgg/conv0/kernel``,
``batch_stats/BatchNorm_0/mean``): ``save_npz`` and ``load_npz`` (with
``load_checkpoint``, which refuses a JAX checkpoint directory) are its
only writer and readers.  ``tools/jax_ckpt_to_npz.py`` writes it from a JAX
(orbax) checkpoint.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from underwater_image_enhancement_tpu_torch.models.layers import HeadsLinear


def _same(a):
    return a


def _heads_leaves(sub: HeadsLinear):
    """HeadsLinear's two leaves, split by its ``heads``."""
    dim, h = sub.in_features, sub.heads
    split = (h, dim // h)
    if sub.split == "out":
        return (("params", "kernel", "weight",
                 lambda w: w.T.reshape((dim,) + split),
                 lambda k: k.reshape(dim, dim).T),
                ("params", "bias", "bias", lambda b: b.reshape(split),
                 lambda b: b.reshape(dim)))
    return (("params", "kernel", "weight",
             lambda w: w.T.reshape(split + (dim,)),
             lambda k: k.reshape(dim, dim).T),
            ("params", "bias", "bias", _same, _same))


# per layer type: (collection, Flax leaf, torch attribute, torch -> Flax
# layout, Flax -> torch layout); HeadsLinear before the Linear it is
_LEAVES = {
    HeadsLinear: _heads_leaves,
    nn.Linear: (("params", "kernel", "weight", np.transpose, np.transpose),
                ("params", "bias", "bias", _same, _same)),
    nn.Conv2d: (("params", "kernel", "weight",
                 lambda w: w.transpose(2, 3, 1, 0),
                 lambda k: k.transpose(3, 2, 0, 1)),
                ("params", "bias", "bias", _same, _same)),
    nn.modules.batchnorm._BatchNorm: (
        ("params", "scale", "weight", _same, _same),
        ("params", "bias", "bias", _same, _same),
        ("batch_stats", "mean", "running_mean", _same, _same),
        ("batch_stats", "var", "running_var", _same, _same)),
    nn.LayerNorm: (("params", "scale", "weight", _same, _same),
                   ("params", "bias", "bias", _same, _same)),
}


def _leaves(module: nn.Module):
    """(Flax key, torch tensor, torch -> Flax, Flax -> torch) of each
    parameter and running statistic of ``module``'s layers, and of each
    parameter a module holds itself."""
    for name, sub in module.named_modules():
        specs = next((v for k, v in _LEAVES.items() if isinstance(sub, k)),
                     None)
        if specs is None:
            specs = tuple(("params", p, p, _same, _same)
                          for p in sub._parameters)
        elif callable(specs):
            specs = specs(sub)
        for coll, leaf, attr, fwd, inv in specs:
            t = getattr(sub, attr)
            if t is not None:
                key = "/".join(p for p in (coll, name.replace(".", "/"), leaf)
                               if p)
                yield key, t, fwd, inv


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    """{"a/b/c": leaf} -> nested dicts."""
    out: dict = {}
    for path, v in flat.items():
        *heads, leaf = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return out


def expected_shapes(module: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """The Flax leaves ``module`` takes, by ``/``-joined path, with their
    shapes."""
    return {key: fwd(np.empty(tuple(t.shape), np.uint8)).shape
            for key, t, fwd, _ in _leaves(module)}


def load_flax(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy a Flax variable tree (nested dicts of arrays) into ``module``
    in place and return it.  Raises ValueError on any missing, extra or
    wrongly shaped leaf before anything is copied."""
    given = {k: np.asarray(v) for k, v in flatten(variables).items()}
    want = expected_shapes(module)
    missing = sorted(set(want) - set(given))
    extra = sorted(set(given) - set(want))
    bad = sorted(f"{k}: {given[k].shape} for {want[k]}" for k in want
                 if k in given and tuple(given[k].shape) != want[k])
    if missing or extra or bad:
        raise ValueError(f"Flax tree does not fit {type(module).__name__}: "
                         f"missing {missing}, extra {extra}, wrong shape {bad}")
    with torch.no_grad():
        for key, t, _, inv in _leaves(module):
            t.copy_(torch.from_numpy(np.array(inv(given[key]), np.float32)))
    return module


def to_flax(module: nn.Module) -> dict:
    """``module``'s parameters as a Flax variable tree of numpy f32
    arrays (``params``, and ``batch_stats`` where it has BatchNorm)."""
    return unflatten({
        key: np.ascontiguousarray(fwd(t.detach().to("cpu", torch.float32)
                                      .numpy()))
        for key, t, fwd, _ in _leaves(module)})


# the initialisers of the parameters a Flax module holds itself
# (zoo.py:203-206): the ViT's class token zeros, its position table
# normal(0.02)
_BARE_INIT = {"cls": lambda t, g: nn.init.zeros_(t),
              "pos": lambda t, g: nn.init.normal_(t, 0.0, 0.02, generator=g)}


def flax_default_init(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initialisers, drawn from ``generator``: every Linear
    (attention projections too) and Conv2d weight LeCun-normal (a normal
    of variance 1/fan_in truncated at two standard deviations, as
    ``nn.initializers.lecun_normal``), biases 0 where the layer has one,
    BatchNorm scale 1, bias 0, mean 0, variance 1, LayerNorm scale 1,
    bias 0, and the ``_BARE_INIT`` parameters.  The numbers are not
    Flax's: equality with JAX comes through ``models/bridge``."""
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, (nn.Linear, nn.Conv2d)):
                fan_in = sub.weight[0].numel()
                std = float(np.sqrt(1.0 / fan_in) / 0.87962566103423978)
                nn.init.trunc_normal_(sub.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if sub.bias is not None:
                    nn.init.zeros_(sub.bias)
            elif isinstance(sub, (nn.modules.batchnorm._BatchNorm,
                                  nn.LayerNorm)):
                sub.reset_parameters()
            else:
                for name, t in sub._parameters.items():
                    _BARE_INIT[name](t, generator)


def save_npz(path: str, variables: Mapping) -> None:
    """Write a Flax variable tree as the port's checkpoint: one ``.npz``
    keyed by the leaves' ``/``-joined paths."""
    flat = {k: np.asarray(v, np.float32) for k, v in flatten(variables).items()}
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_npz(path: str) -> dict:
    """Read the port's checkpoint back into a nested Flax variable tree."""
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def load_checkpoint(path: str, arch: str) -> dict:
    """``load_npz`` of a model's checkpoint; a directory (a JAX/orbax
    checkpoint, which the port cannot read) raises ValueError naming the
    converter for ``arch``."""
    if Path(path).is_dir():
        raise ValueError(
            f"{path} is a directory (a JAX/orbax checkpoint); convert it "
            f"first: python tools/jax_ckpt_to_npz.py --arch {arch} "
            f"--ckpt {path} --out {arch}.npz")
    return load_npz(path)
