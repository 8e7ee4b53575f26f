"""Convert a JAX EnhancementPredictor checkpoint into the PyTorch port's.

    python tools/jax_ckpt_to_npz.py --ckpt CKPT_DIR --out predictor.npz \
        [--hidden-dim 256]

The JAX package saves its predictor with orbax (``train/trainer.py``
``save_checkpoint``), which the port cannot read without JAX.  This tool
imports both packages: the JAX ``EnhancementPredictor`` restores the
checkpoint in either dialect it accepts (raw ``{params, batch_stats}`` or a
``VGGTrainer`` checkpoint), and the port's ``models/bridge`` checks the
tree against the port's ``ImprovedVGGParameterNet`` and writes it as one
``.npz`` keyed by ``/``-joined paths (``params/vgg/conv0/kernel``,
``batch_stats/BatchNorm_0/mean``).  ``enhance --model predictor.npz`` of
the port's CLI reads it.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def convert(ckpt: str, out: str, hidden_dim: int = 256) -> int:
    """Restore ``ckpt`` with the JAX predictor, write ``out``; returns the
    number of leaves written."""
    import jax

    from underwater_image_enhancement_tpu.models.predictor import (
        EnhancementPredictor as JaxPredictor,
    )
    from underwater_image_enhancement_tpu_torch.models import bridge
    from underwater_image_enhancement_tpu_torch.models.vgg import (
        ImprovedVGGParameterNet,
    )

    pred = JaxPredictor(checkpoint_path=ckpt, hidden_dim=hidden_dim,
                        pretrained_vgg=None)
    tree = jax.tree_util.tree_map(np.asarray, pred.variables)
    # refuses a tree that does not fit the port's network
    bridge.load_flax(ImprovedVGGParameterNet(hidden_dim=hidden_dim), tree)
    bridge.save_npz(out, tree)
    return len(bridge.flatten(tree))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True,
                    help="orbax checkpoint directory of the JAX predictor")
    ap.add_argument("--out", required=True, help="the port's .npz")
    ap.add_argument("--hidden-dim", type=int, default=256)
    args = ap.parse_args(argv)
    n = convert(args.ckpt, args.out, args.hidden_dim)
    print(f"wrote {n} arrays -> {args.out}")


if __name__ == "__main__":
    main()
