"""Resuming a JAX trainer's checkpoint in the port: a JAX trainer takes
two steps and saves with orbax, ``tools/jax_ckpt_to_npz.py --trainer``
converts the checkpoint, and then JAX's ``load`` and the port's ``load``
each take step 3 on the same batch, held to
``tests/test_torch_train_steps.py``'s gates (its ``_hold``, with dropout
off on both sides).  The resumed ``count``, learning rate and loss
histories are equal; ``cli train-mlp --resume`` on a converted checkpoint
continues from the JAX history's length; a checkpoint of another width is
refused, naming its leaves.

Sizes are ``tests/test_torch_train_steps.py``'s: the MLP at hidden 32 with
one block, ResNet18 at 32^2, the f32 VGG predictor at hidden 16 at 32^2.
"""

import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_train_steps import (  # noqa: F401  (a fixture)
    _hold,
    _np,
    mlp_case,
    no_dropout,
    vgg_case,
    zoo_case,
)
from underwater_image_enhancement_tpu.train import trainer as jtrainer
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.models import bridge
from underwater_image_enhancement_tpu_torch.utils import io as tio

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import jax_ckpt_to_npz as tool  # noqa: E402


def _two_jax_steps(case, batches, ckpt: Path) -> None:
    """JAX's trainer takes steps 1 and 2 (its loss and optimiser, jitted
    as ``_hold`` runs them) and saves with orbax, with a loss history of
    two epochs."""
    jt = case["jax"]
    p, st, s = case["params"], case["stats"], case["opt_state"]
    hist = []
    for step, batch in enumerate(batches, 1):
        loss, g, st = case["grad"](p, st, batch)
        p, s = case["apply"](g, s, p, step)
        hist.append(float(loss))
    jt.params, jt.opt_state = p, s
    if case["stats"]:
        jt.batch_stats = st
    jt.train_losses, jt.val_losses = hist, [1.5 * v for v in hist]
    jt.save(str(ckpt))


def _resume(name, case, batches, fresh, tmp_path, **flags):
    """Steps 1-2 in JAX, the conversion, the checks of the resumed state,
    then step 3 of JAX's ``load`` against the port's ``load``."""
    _two_jax_steps(case, batches, tmp_path / "jax")
    out = tmp_path / "port.npz"
    _, weight_decay = tool.convert_trainer(str(tmp_path / "jax"), str(out),
                                           **flags)
    jt = fresh()
    jt.load(str(tmp_path / "jax"))
    tt = case["port"]
    tt.load(str(out))
    if name == "vgg":  # the injected weight decay, which the .npz lacks
        inj = jt.opt_state[2].inner_state.hyperparams["weight_decay"]
        assert weight_decay == float(inj) == float(np.float32(
            tt.optimizer.param_groups[0]["weight_decay"]))
        assert jt._epoch_count == tt._epoch_count == 2
    else:
        assert weight_decay is None
    adam, lr = case["adam"](jt.opt_state)
    got = bridge.optax_adam_state(tt.model, tt.optimizer)
    assert int(got["count"]) == int(adam.count) == 2
    assert float(got["learning_rate"]) == float(np.float32(lr))
    assert tt.train_losses == [float(v) for v in jt.train_losses]
    assert tt.val_losses == [float(v) for v in jt.val_losses]
    assert len(tt.train_losses) == tt.start_epoch == 2
    want = bridge.flatten(case["inner"](_np(jt.params)))
    have = bridge.flatten(bridge.to_flax(tt.model)["params"])
    assert all(np.array_equal(have[k], want[k]) for k in want)
    _hold(name, {**case, "params": jt.params, "opt_state": jt.opt_state,
                 "stats": getattr(jt, "batch_stats", {}),
                 "load": lambda: tt.load(str(out))},
          batches[1:], first=3)
    return jt, tt


def test_mlp_trainer_resumes_from_a_jax_checkpoint(no_dropout, tmp_path):
    case, batches = mlp_case()
    _resume("mlp", case, batches,
            lambda: jtrainer.MLPTrainer(hidden_dim=32, num_blocks=1),
            tmp_path, trainer="mlp", hidden_dim=32, num_blocks=1)


def test_zoo_trainer_resumes_from_a_jax_checkpoint(no_dropout, monkeypatch,
                                                   tmp_path):
    case, batches = zoo_case(monkeypatch, "resnet")
    _resume("resnet", case, batches,
            lambda: jtrainer.ZooTrainer("resnet", image_size=32,
                                        pretrained=None),
            tmp_path, trainer="zoo", arch="resnet", input_size=32)


def test_vgg_trainer_resumes_from_a_jax_checkpoint(no_dropout, tmp_path):
    """The VGG's frozen convs hold ``MaskedNode`` in optax's moments and
    nothing in the port's optimiser; the injected learning rate and both
    packages' per-epoch schedule resume at epoch 2, and the tool reports
    the injected weight decay.  Its learning rate is the checkpoint's, so
    ``--lr`` is refused."""
    case, batches = vgg_case()
    with pytest.raises(ValueError, match="--lr"):
        tool.convert_trainer(str(tmp_path / "none"), str(tmp_path / "x.npz"),
                             trainer="vgg", lr=1e-3)

    def fresh():
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "VGGTrainer: perceptual loss")
            return jtrainer.VGGTrainer(hidden_dim=16, image_size=32,
                                       epochs=40, compute_dtype="float32",
                                       pretrained_vgg=None)

    _resume("vgg", case, batches, fresh, tmp_path, trainer="vgg",
            hidden_dim=16, input_size=32)


def test_cli_train_mlp_resumes_a_converted_checkpoint(tmp_path, capsys):
    """``train-mlp --resume`` on a JAX ``MLPTrainer``'s converted
    checkpoint (the CLI's default width) trains epoch 3 of 3 only and keeps
    the JAX history; converting it as another width is refused, naming
    the leaves that differ, and nothing is written."""
    jt = jtrainer.MLPTrainer()
    jt.train_losses, jt.val_losses = [0.5, 0.25], [0.75, 0.375]
    jt.save(str(tmp_path / "jax"))
    npz = tmp_path / "resume.npz"
    with pytest.raises(ValueError, match=r"params\.params\.Dense_0\.kernel "
                       r"\(79, 256\) \(the trainer's \(79, 64\)\)"):
        tool.main(["--ckpt", str(tmp_path / "jax"), "--out", str(npz),
                   "--trainer", "mlp", "--hidden-dim", "64"])
    assert not npz.exists()
    tool.main(["--ckpt", str(tmp_path / "jax"), "--out", str(npz),
               "--trainer", "mlp"])
    raw, ref = tmp_path / "raw", tmp_path / "ref"
    raw.mkdir()
    ref.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        clean = np.clip(rng.random((24, 24, 3)) * 0.9 + 0.05, 0, 1)
        for folder, img in ((ref, clean), (raw, clean ** 1.4)):
            (folder / f"img{i}.png").write_bytes(
                tio.encode_png((img * 255).astype(np.uint8)))
    out = tmp_path / "out"
    tcli.main(["train-mlp", "--input", str(raw), "--reference", str(ref),
               "--output", str(out), "--epochs", "3", "--batch-size", "2",
               "--resume", str(npz), "--device", "cpu"])
    hist = json.loads((out / "training_history.json").read_text())
    assert hist["train_loss"][:2] == [0.5, 0.25]
    assert hist["val_loss"][:2] == [0.75, 0.375]
    assert len(hist["train_loss"]) == 3
    text = capsys.readouterr().out
    assert "epoch 3/3" in text and "epoch 1/3" not in text
