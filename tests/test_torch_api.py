"""The port's public API against the JAX package's.

For every module of the JAX package that the port has, each public
function and class of the JAX module (defined there, or a jitted alias)
and each public UPPER-CASE constant (defined there or imported) exists in
the port, and a callable's ``inspect.signature`` parameter names lead the
port's in the same order (the port may add parameters after them, such as
``device`` on its entry points).  What the port leaves out on purpose is
listed below with the reason; each entry is an item of ROADMAP's Queue 1
or a JAX-only knob.  The JAX modules and CLI subcommands the port does not
have yet are listed too, so a later slice cannot drop a name unnoticed.
"""

import argparse
import importlib
import inspect
import pkgutil
import re

import pytest

import underwater_image_enhancement_tpu as jpkg
import underwater_image_enhancement_tpu_torch as tpkg
from underwater_image_enhancement_tpu import cli as jcli
from underwater_image_enhancement_tpu_torch import cli as tcli

# (module, name) or (module, "name.parameter") -> why the port leaves it out
LEFT_OUT = {
    ("utils.config", "Config.use_deep_features"):
        "declared but never read in JAX either",
    ("utils.config", "Config.deep_feature_model"):
        "declared but never read in JAX either",
    ("utils.config", "Config.show_progress"):
        "declared but never read in JAX either",
    ("utils.config", "Config.log_level"):
        "declared but never read in JAX either",
    ("utils.config", "Config.dtype"): "declared but never read in JAX either",
    ("ops.dct", "dct2.precision"):
        "the TPU MXU's matmul precision; the port's f32 products run in "
        "full f32 (no TF32)",
}
# the Flax modules the port has as torch modules: their dataclass fields
# ``parent`` and ``name`` place a Flax module in its tree, which a torch
# nn.Module does not have
FLAX_MODULES = {
    "models.vgg": ("VGGFeatures", "ImprovedVGGParameterNet"),
    "models.zoo": ("ResNetBlock", "CNNParameterPredictor", "MBConv",
                   "EfficientNetParameterPredictor", "ViTParameterPredictor"),
    "models.mlp": ("ResidualBlock", "ParameterPredictor"),
    "models.waternet": ("FTU", "WaterNet", "UNetEnhancer"),
}
for _module, _classes in FLAX_MODULES.items():
    for _cls in _classes:
        for _field in ("parent", "name"):
            LEFT_OUT[(_module, f"{_cls}.{_field}")] = (
                "Flax's module-tree field; a torch nn.Module has none")

# JAX modules the port does not have yet -> the Queue 1 item that brings it
MODULES_TO_PORT = {
    # never: the Pallas kernels have CUDA counterparts (ops/kernels.py and
    # csrc/), and the oracles stay with the JAX suite (utils/oracles.py
    # copies what validate needs)
    "ops.pallas_kernels": None, "testing": None, "testing.golden": None,
    "testing.golden_cnn": None, "testing.golden_features": None,
    "testing.golden_fusion": None, "testing.golden_metrics": None,
    "testing.underwater": None,
}

# JAX CLI subcommands the port does not have yet -> Queue 1 item
SUBCOMMANDS_TO_PORT = {}


def _modules(pkg):
    return {m.name[len(pkg.__name__) + 1:]: m.name
            for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}


J_MODULES, T_MODULES = _modules(jpkg), _modules(tpkg)
SHARED = sorted(set(J_MODULES) & set(T_MODULES))


def _public(mod):
    """Public names of ``mod``: callables defined there, or jitted
    partials (whose ``__module__`` is functools) bound to a public name,
    and UPPER-CASE constants (tables, orders, axis names), defined there
    or imported, as ``pipeline.enhance``'s ``STRATEGY_FNS``."""
    names = []
    for name, v in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(v):
            continue
        if not callable(v):
            if re.fullmatch(r"[A-Z][A-Z0-9_]*", name):
                names.append(name)
            continue
        owner = getattr(v, "__module__", None)
        if owner == mod.__name__ or (owner == "functools"
                                     and type(v).__name__ == "PjitFunction"):
            names.append(name)
    return names


def _params(fn):
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


def test_module_sets():
    """The port has every JAX module but those still to port."""
    assert set(J_MODULES) - set(T_MODULES) == set(MODULES_TO_PORT)
    assert not set(MODULES_TO_PORT) & set(T_MODULES)


@pytest.mark.parametrize("module", SHARED)
def test_public_names_and_parameters(module):
    jmod = importlib.import_module(J_MODULES[module])
    tmod = importlib.import_module(T_MODULES[module])
    problems = []
    for name in _public(jmod):
        if (module, name) in LEFT_OUT:
            assert not hasattr(tmod, name), f"{module}.{name} is ported now"
            continue
        if not hasattr(tmod, name):
            problems.append(f"missing {name}")
            continue
        jp, tp = _params(getattr(jmod, name)), _params(getattr(tmod, name))
        if jp is None:
            continue
        want = [p for p in jp if (module, f"{name}.{p}") not in LEFT_OUT]
        for p in jp:
            if (module, f"{name}.{p}") in LEFT_OUT:
                assert p not in tp, f"{module}.{name}({p}=) is ported now"
        if tp[:len(want)] != want:
            problems.append(f"{name}: JAX {want}, port {tp}")
    assert not problems, f"{module}: {problems}"


def test_left_out_names_exist_in_jax():
    """Every entry of LEFT_OUT names something the JAX package has."""
    for module, what in LEFT_OUT:
        name, _, param = what.partition(".")
        fn = getattr(importlib.import_module(J_MODULES[module]), name)
        assert not param or param in inspect.signature(fn).parameters


def _subcommands(cli):
    sub = next(a for a in cli.build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    return set(sub.choices)


def test_cli_subcommands():
    """The port's CLI has every JAX subcommand but those still to port
    (``fusion``, Phase 2's, ``waternet``, the trainers and ``validate``
    among those it has)."""
    jax_cmds, port_cmds = _subcommands(jcli), _subcommands(tcli)
    assert {"fusion", "train-selector", "run", "predict",
            "convert-vgg", "waternet", "train-mlp", "train-vgg",
            "train-zoo", "validate"} <= port_cmds
    assert jax_cmds - port_cmds == set(SUBCOMMANDS_TO_PORT)
    assert port_cmds <= jax_cmds
