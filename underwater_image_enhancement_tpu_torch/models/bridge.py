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
``load_checkpoint``, which refuses a JAX checkpoint directory and reads a
model's collections only) are its only writer and readers.  A trainer's
checkpoint adds ``opt_state`` and its loss histories
(``train/trainer.save_checkpoint``).  ``tools/jax_ckpt_to_npz.py`` writes
it from a JAX (orbax) checkpoint.

An optimiser's state maps the same way: optax's ``ScaleByAdamState``
(``mu`` and ``nu``, trees shaped as ``params``, and ``count``) and the
learning rate ``inject_hyperparams`` keeps are a torch ``Adam``/``AdamW``
state's ``exp_avg``, ``exp_avg_sq`` and ``step`` of each parameter it
holds, and its groups' ``lr`` (``optax_adam_state`` and
``load_optax_adam``).  A parameter the optimiser does not hold (a frozen
one) has no leaf, as ``optax.masked`` gives it none.
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


def _stored(v) -> np.ndarray:
    """A leaf as the checkpoint keeps it: f64 (a loss history) and integer
    (a step count) arrays as they are, anything else as f32."""
    a = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    if a.dtype == np.float64 or np.issubdtype(a.dtype, np.integer):
        return a
    return a.astype(np.float32)


def save_npz(path: str, variables: Mapping) -> None:
    """Write a Flax variable tree as the port's checkpoint: one ``.npz``
    keyed by the leaves' ``/``-joined paths."""
    flat = {k: _stored(v) for k, v in flatten(variables).items()}
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_npz(path: str) -> dict:
    """Read the port's checkpoint back into a nested Flax variable tree."""
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def load_checkpoint(path: str, arch: str) -> dict:
    """A model's collections (``params``, and ``batch_stats`` where
    there) of the port's checkpoint; a trainer's optimiser state and loss
    histories stay behind.  A directory (a JAX/orbax checkpoint, which the
    port cannot read) raises ValueError naming the converter for
    ``arch``."""
    if Path(path).is_dir():
        raise ValueError(
            f"{path} is a directory (a JAX/orbax checkpoint); convert it "
            f"first: python tools/jax_ckpt_to_npz.py --arch {arch} "
            f"--ckpt {path} --out {arch}.npz")
    tree = load_npz(path)
    return {k: v for k, v in tree.items() if k in ("params", "batch_stats")}


def _held(module: nn.Module, optimizer: torch.optim.Optimizer):
    """(leaf path within ``params``, tensor, torch -> Flax, Flax -> torch)
    of each parameter of ``module`` that ``optimizer`` holds."""
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    for key, t, fwd, inv in _leaves(module):
        coll, _, leaf = key.partition("/")
        if coll == "params" and id(t) in held:
            yield leaf, t, fwd, inv


def optax_adam_state(module: nn.Module,
                     optimizer: torch.optim.Optimizer) -> dict:
    """A torch Adam/AdamW's state over ``module`` as optax's: ``{"mu":
    tree, "nu": tree, "count": int32, "learning_rate": f32}``, the trees
    shaped as ``params`` (numpy f32, zeros before the first step) over the
    parameters the optimiser holds."""
    mu, nu, count = {}, {}, 0
    for leaf, t, fwd, _ in _held(module, optimizer):
        st = optimizer.state.get(t) or {}
        for out, name in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            v = st.get(name, torch.zeros_like(t))
            out[leaf] = np.ascontiguousarray(fwd(v.detach().to(
                "cpu", torch.float32).numpy()))
        if st:
            count = max(count, int(st["step"]))
    return {"mu": unflatten(mu), "nu": unflatten(nu),
            "count": np.int32(count),
            "learning_rate": np.float32(optimizer.param_groups[0]["lr"])}


def load_optax_adam(module: nn.Module, optimizer: torch.optim.Optimizer,
                    state: Mapping) -> None:
    """Set a torch Adam/AdamW's state over ``module`` from optax's (the
    form ``optax_adam_state`` returns; ``learning_rate`` optional): each
    held parameter's moments and step, and every group's lr (a group's
    own lr kept where it rounds to the state's f32 value).  Raises
    ValueError on a missing, extra or wrongly shaped leaf before anything
    is set."""
    count = int(np.asarray(state["count"]))
    want = {leaf: (t, inv) for leaf, t, _, inv in _held(module, optimizer)}
    moments = {}
    for name in ("mu", "nu"):
        given = {k: np.asarray(v) for k, v in flatten(state[name]).items()}
        missing = sorted(set(want) - set(given))
        extra = sorted(set(given) - set(want))
        bad = sorted(k for k in want if k in given and tuple(
            want[k][1](given[k]).shape) != tuple(want[k][0].shape))
        if missing or extra or bad:
            raise ValueError(f"optimiser {name} does not fit "
                             f"{type(module).__name__}: missing {missing}, "
                             f"extra {extra}, wrong shape {bad}")
        moments[name] = given
    with torch.no_grad():
        for leaf, (t, inv) in want.items():
            if count == 0:
                optimizer.state.pop(t, None)
                continue
            optimizer.state[t] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                **{name: torch.from_numpy(np.array(
                    inv(moments[src][leaf]), np.float32)).to(t.device)
                   for name, src in (("exp_avg", "mu"),
                                     ("exp_avg_sq", "nu"))}}
    if "learning_rate" in state:
        # the state keeps it in f32 (optax's): a group whose rate rounds to
        # the same f32 (a trainer's own lr=1e-4) keeps its exact value
        lr = np.float32(state["learning_rate"])
        for g in optimizer.param_groups:
            if np.float32(g["lr"]) != lr:
                g["lr"] = float(lr)
