"""Convert a JAX predictor or WaterNet checkpoint into the PyTorch port's.

    python tools/jax_ckpt_to_npz.py --ckpt CKPT_DIR --out predictor.npz \
        [--arch vgg|resnet|efficientnet|vit|waternet] [--hidden-dim 256] \
        [--variant b0|b3] [--input-size 224]

The JAX package saves its models with orbax (``train/trainer.py``
``save_checkpoint``), which the port cannot read without JAX.  This tool
imports both packages.  The JAX side restores the checkpoint in each
dialect it accepts: ``--arch vgg`` (the default) through
``EnhancementPredictor`` (raw ``{params, batch_stats}`` or a
``VGGTrainer`` checkpoint), ``--arch resnet|efficientnet|vit`` through
``ZooPredictor`` (raw, or a ``ZooTrainer`` checkpoint; ``--variant`` and
``--input-size`` as that predictor takes them), ``--arch waternet`` as
the JAX CLI's ``waternet --checkpoint`` does (the default ``WaterNet``'s
variables).  The port's ``models/bridge`` checks the tree against the
port's module and writes it as one ``.npz`` keyed by ``/``-joined paths
(``params/Conv_0/kernel``, ``batch_stats/BatchNorm_0/mean``), which the
port's ``enhance --model X --arch A`` and ``waternet --checkpoint X``
read.
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True,
                    help="orbax checkpoint directory of the JAX model")
    ap.add_argument("--out", required=True, help="the port's .npz")
    ap.add_argument("--arch", default="vgg", choices=ARCHS)
    ap.add_argument("--hidden-dim", type=int, default=256,
                    help="the VGG predictor's width (--arch vgg)")
    ap.add_argument("--variant", default="b0", choices=("b0", "b3"),
                    help="efficientnet scale (--arch efficientnet)")
    ap.add_argument("--input-size", type=int, default=224,
                    help="the zoo predictor's resolution (sets the ViT's "
                         "position table)")
    args = ap.parse_args(argv)
    n = convert(args.ckpt, args.out, args.hidden_dim, args.arch,
                args.variant, args.input_size)
    print(f"wrote {n} arrays -> {args.out}")


if __name__ == "__main__":
    main()
