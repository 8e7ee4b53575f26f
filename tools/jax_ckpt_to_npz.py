"""Convert a JAX predictor, WaterNet or trainer checkpoint into the
PyTorch port's.

    python tools/jax_ckpt_to_npz.py --ckpt CKPT_DIR --out predictor.npz \
        [--arch vgg|resnet|efficientnet|vit|waternet] [--hidden-dim 256] \
        [--variant b0|b3] [--input-size 224]
    python tools/jax_ckpt_to_npz.py --ckpt CKPT_DIR --out resume.npz \
        --trainer mlp|vgg|zoo [--arch resnet|efficientnet|vit] \
        [--hidden-dim N] [--num-blocks N] [--variant b0|b3] \
        [--input-size N] [--lr LR]

The JAX package saves its models with orbax (``train/trainer.py``
``save_checkpoint``), which the port cannot read without JAX.  This tool
imports both packages.

Without ``--trainer`` it converts the parameters, which the port's
``enhance --model X --arch A`` and ``waternet --checkpoint X`` read.  The
JAX side restores the checkpoint in each dialect it accepts: ``--arch
vgg`` (the default) through ``EnhancementPredictor`` (raw ``{params,
batch_stats}`` or a ``VGGTrainer`` checkpoint), ``--arch
resnet|efficientnet|vit`` through ``ZooPredictor`` (raw, or a
``ZooTrainer`` checkpoint; ``--variant`` and ``--input-size`` as that
predictor takes them), ``--arch waternet`` as the JAX CLI's ``waternet
--checkpoint`` does (the default ``WaterNet``'s variables).  The port's
``models/bridge`` checks the tree against the port's module and writes it
as one ``.npz`` keyed by ``/``-joined paths (``params/Conv_0/kernel``,
``batch_stats/BatchNorm_0/mean``).

With ``--trainer`` it converts a JAX trainer's whole checkpoint
(``MLPTrainer``, ``VGGTrainer`` or ``ZooTrainer`` with ``--arch``) into the
one the port's trainer of the same construction writes, which the port's
``train-mlp|train-vgg|train-zoo --resume`` read: ``params``,
``batch_stats``, the Adam state as ``opt_state/{mu,nu,count,
learning_rate}``, ``train_losses`` and ``val_losses``.  The flags that
shape the tree (``--hidden-dim``, ``--num-blocks``, ``--arch``,
``--variant``, ``--input-size``) build the JAX trainer, with no
pretrained weights, and its own ``load`` restores the checkpoint.  The
Adam state is ``opt_state[1][0]`` of the MLP's and the zoo's
``chain(clip, adam)``, which holds no learning rate: ``--lr`` gives it
(default the trainer's own).  The VGG's is the ``ScaleByAdamState``
inside its masked ``inject_hyperparams(adamw)``, whose injected learning
rate it takes (``--lr`` is refused), and whose frozen convs'
``MaskedNode`` leaves it leaves out (the port's optimiser holds no state
for them); the injection's count must equal Adam's.  The port's
checkpoint holds no weight decay and no schedule length, which its
``VGGTrainer`` takes from its constructor: the tool prints the JAX run's
injected weight decay, and the port's trainer must be built with it and
with the JAX run's ``epochs``.  Before anything is written, the tree is
loaded into a port trainer of the same construction
(``bridge.load_flax``, ``bridge.load_optax_adam``), which raises naming
every leaf that does not fit.  The VGG's resumed per-epoch schedule
starts at ``len(train_losses)``, in both packages.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ARCHS = ("vgg", "resnet", "efficientnet", "vit", "waternet")


def _restore(ckpt: str, arch: str, hidden_dim: int, variant: str,
             input_size: int):
    """The JAX variable tree of ``ckpt`` and the port's module it must
    fit."""
    import jax

    if arch == "vgg":
        from underwater_image_enhancement_tpu.models.predictor import (
            EnhancementPredictor as JaxPredictor,
        )
        from underwater_image_enhancement_tpu_torch.models.vgg import (
            ImprovedVGGParameterNet,
        )

        pred = JaxPredictor(checkpoint_path=ckpt, hidden_dim=hidden_dim,
                            pretrained_vgg=None)
        return pred.variables, ImprovedVGGParameterNet(hidden_dim=hidden_dim)
    if arch == "waternet":
        import orbax.checkpoint as ocp

        from underwater_image_enhancement_tpu.models import waternet as jwn
        from underwater_image_enhancement_tpu_torch.models import (
            waternet as twn,
        )

        target = jax.eval_shape(
            lambda: jwn.init_waternet(jax.random.PRNGKey(0), 64))
        tree = ocp.StandardCheckpointer().restore(
            str(Path(ckpt).resolve()), target)
        return tree, twn.WaterNet()
    from underwater_image_enhancement_tpu.models.predictor import (
        ZooPredictor as JaxZoo,
    )
    from underwater_image_enhancement_tpu_torch.models import zoo

    pred = JaxZoo(checkpoint_path=ckpt, model_type=arch, variant=variant,
                  input_size=input_size)
    kwargs = ({"variant": variant} if arch == "efficientnet" else
              {"image_size": input_size} if arch == "vit" else {})
    return pred.variables, zoo.create_model(arch, **kwargs)


def convert(ckpt: str, out: str, hidden_dim: int = 256, arch: str = "vgg",
            variant: str = "b0", input_size: int = 224) -> int:
    """Restore ``ckpt`` with the JAX package, write ``out``; returns the
    number of leaves written."""
    import jax

    from underwater_image_enhancement_tpu_torch.models import bridge

    if arch not in ARCHS:
        raise ValueError(f"arch {arch!r}: one of {ARCHS}")
    variables, module = _restore(ckpt, arch, hidden_dim, variant, input_size)
    tree = jax.tree_util.tree_map(np.asarray, dict(variables))
    # refuses a tree that does not fit the port's network
    bridge.load_flax(module, tree)
    bridge.save_npz(out, tree)
    return len(bridge.flatten(tree))


TRAINERS = ("mlp", "vgg", "zoo")


def _tree(x):
    """A JAX tree as nested dicts of numpy arrays, optax.masked's
    ``MaskedNode`` leaves (frozen parameters) left out."""
    import optax

    if hasattr(x, "items"):
        out = {k: _tree(v) for k, v in x.items()}
        return {k: v for k, v in out.items() if v is not None}
    if isinstance(x, optax.MaskedNode):
        return None
    return np.asarray(x)


def _trainers(trainer: str, arch: str, hidden_dim: int, num_blocks: int,
              variant: str, input_size: int, lr):
    """The JAX trainer and the port's trainer (on the CPU) of one
    construction, with no pretrained weights (the VGG's optimiser
    settings, which shape no leaf, its defaults)."""
    import warnings

    from underwater_image_enhancement_tpu.train import trainer as jtr
    from underwater_image_enhancement_tpu_torch.train import trainer as ttr

    if trainer == "mlp":
        kw = {"hidden_dim": hidden_dim, "num_blocks": num_blocks,
              "lr": 1e-4 if lr is None else lr}
        return jtr.MLPTrainer(**kw), ttr.MLPTrainer(**kw, device="cpu")
    if trainer == "zoo":
        kw = {"model_type": arch, "lr": 1e-4 if lr is None else lr,
              "image_size": input_size, "variant": variant,
              "pretrained": None}
        return jtr.ZooTrainer(**kw), ttr.ZooTrainer(**kw, device="cpu")
    kw = {"hidden_dim": hidden_dim, "image_size": input_size,
          "compute_dtype": "float32",
          "pretrained_vgg": None}
    with warnings.catch_warnings():  # the perceptual trunk is not saved
        warnings.filterwarnings("ignore", "VGGTrainer: perceptual loss")
        return jtr.VGGTrainer(**kw), ttr.VGGTrainer(**kw, device="cpu")


def _dotted(tree) -> dict:
    """{orbax's dotted leaf name (``opt_state.1.0.mu.params.Dense_0.bias``):
    shape} of a JAX tree."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in path)
        out[name] = tuple(np.shape(leaf))
    return out


def _check_stored(ckpt: str, jt) -> None:
    """Raise ValueError naming every leaf of the checkpoint that is
    missing, extra or shaped otherwise than the JAX trainer's own tree
    (orbax's restore would refuse a shape without naming the leaf)."""
    import jax
    import orbax.checkpoint as ocp

    meta = ocp.StandardCheckpointer().metadata(str(Path(ckpt).resolve()))
    meta = getattr(meta, "item_metadata", meta)
    stored = {m.name: tuple(m.shape)
              for m in jax.tree_util.tree_leaves(meta)}
    like = {"params": jt.params, "opt_state": jt.opt_state}
    if hasattr(jt, "batch_stats"):
        like["batch_stats"] = jt.batch_stats
    want = _dotted(like)
    stored = {k: v for k, v in stored.items()
              if k not in ("train_losses", "val_losses")}
    missing = sorted(set(want) - set(stored))
    extra = sorted(set(stored) - set(want))
    bad = sorted(f"{k} {stored[k]} (the trainer's {want[k]})"
                 for k in set(want) & set(stored) if want[k] != stored[k])
    if missing or extra or bad:
        raise ValueError(f"{ckpt} does not fit {type(jt).__name__} of these "
                         f"flags: missing {missing}, extra {extra}, wrong "
                         f"shape {bad}")


def _adam(trainer: str, jt, lr: float):
    """The JAX trainer's Adam state in the port's form (``lr``: the
    trainer's learning rate, which the MLP's and the zoo's state lacks),
    and the VGG's injected weight decay (None for the others)."""
    weight_decay = None
    if trainer == "vgg":
        inj = jt.opt_state[2].inner_state
        adam = inj.inner_state[0]
        if int(inj.count) != int(adam.count):
            raise ValueError(f"the injected schedule's count {int(inj.count)}"
                             f" is not Adam's {int(adam.count)}")
        lr = inj.hyperparams["learning_rate"]
        weight_decay = float(inj.hyperparams["weight_decay"])
    else:
        adam = jt.opt_state[1][0]
    mu, nu = _tree(adam.mu), _tree(adam.nu)
    if trainer == "mlp":  # the MLP's tree is its variables, {"params": ...}
        mu, nu = mu["params"], nu["params"]
    return {"mu": mu, "nu": nu, "count": np.int32(adam.count),
            "learning_rate": np.float32(lr)}, weight_decay


def convert_trainer(ckpt: str, out: str, trainer: str, arch: str = "resnet",
                    hidden_dim: int = 256, num_blocks: int = 3,
                    variant: str = "b0", input_size: int = 224, lr=None):
    """Restore a JAX trainer's checkpoint ``ckpt`` with that trainer's
    ``load``, check it against the port's trainer of the same
    construction, write the port's resume checkpoint ``out``; returns the
    number of arrays written and the VGG's injected weight decay (None
    for the MLP and the zoo)."""
    from underwater_image_enhancement_tpu_torch.models import bridge
    from underwater_image_enhancement_tpu_torch.train.trainer import (
        restore_checkpoint,
    )

    if trainer not in TRAINERS:
        raise ValueError(f"trainer {trainer!r}: one of {TRAINERS}")
    if trainer == "zoo" and arch not in ARCHS[1:4]:
        raise ValueError(f"the zoo trainer's arch {arch!r}: one of "
                         f"{ARCHS[1:4]}")
    if trainer == "vgg" and lr is not None:
        raise ValueError("--lr: the VGG's learning rate is the one its "
                         "checkpoint injected")
    jt, tt = _trainers(trainer, arch, hidden_dim, num_blocks, variant,
                       input_size, lr)
    _check_stored(ckpt, jt)
    jt.load(str(Path(ckpt).resolve()))
    params = _tree(jt.params)
    variables = {"params": params["params"] if trainer == "mlp" else params}
    stats = _tree(getattr(jt, "batch_stats", {}))
    if stats:
        variables["batch_stats"] = stats
    # each raises naming the leaves that do not fit, before any write
    bridge.load_flax(tt.model, variables)
    adam, weight_decay = _adam(trainer, jt,
                               tt.optimizer.param_groups[0]["lr"])
    bridge.load_optax_adam(tt.model, tt.optimizer, adam)
    tt.train_losses = [float(v) for v in jt.train_losses]
    tt.val_losses = [float(v) for v in jt.val_losses]
    tt.save(out)
    return len(bridge.flatten(restore_checkpoint(out))), weight_decay


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True,
                    help="orbax checkpoint directory of the JAX model")
    ap.add_argument("--out", required=True, help="the port's .npz")
    ap.add_argument("--trainer", default=None, choices=TRAINERS,
                    help="convert a JAX trainer's whole checkpoint (for the "
                         "port's --resume) rather than a predictor's "
                         "parameters")
    ap.add_argument("--arch", default=None, choices=ARCHS,
                    help="the predictor (default vgg), or the zoo trainer's "
                         "net (default resnet)")
    ap.add_argument("--hidden-dim", type=int, default=256,
                    help="the VGG predictor's or the MLP's width")
    ap.add_argument("--num-blocks", type=int, default=3,
                    help="the MLP trainer's residual blocks")
    ap.add_argument("--lr", type=float, default=None,
                    help="the MLP's or the zoo trainer's learning rate, "
                         "which their checkpoint lacks (default the "
                         "trainer's own)")
    ap.add_argument("--variant", default="b0", choices=("b0", "b3"),
                    help="efficientnet scale (--arch efficientnet)")
    ap.add_argument("--input-size", type=int, default=224,
                    help="the zoo predictor's resolution (sets the ViT's "
                         "position table)")
    args = ap.parse_args(argv)
    if args.trainer:
        n, weight_decay = convert_trainer(
            args.ckpt, args.out, args.trainer, args.arch or "resnet",
            args.hidden_dim, args.num_blocks, args.variant, args.input_size,
            args.lr)
        if weight_decay is not None:
            print(f"the JAX run's AdamW weight decay: {weight_decay!r} (the "
                  f"port's VGGTrainer(weight_decay=...) to resume with)")
    else:
        n = convert(args.ckpt, args.out, args.hidden_dim,
                    args.arch or "vgg", args.variant, args.input_size)
    print(f"wrote {n} arrays -> {args.out}")


if __name__ == "__main__":
    main()
