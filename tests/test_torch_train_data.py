"""The port's training data path, its trainers' behaviours and the
``train-*`` commands, on the CPU.

- ``train/data``: ``PairedImageDataset``'s pairs and batches bit-equal to
  the JAX package's (which reads and resizes with cv2) on the same files
  (PNGs, a baseline JPEG, a missing reference), split, shuffle seed and
  flips; the multi-host sharding case of ``tests/test_train.py``; and
  ``prefetch_to_device``.
- The JAX suite's trainer behaviours (``tests/test_train.py``), on the
  port: the loss falls over 8 epochs; the feature cache is read on every
  batch and equals direct extraction; ``load`` resumes at epoch 2 with
  equal parameters; the VGG trainer's frozen convs stay, conv9 moves,
  bf16 is the default with f32 parameters, the learning-rate schedule
  reaches the step, and its checkpoint is what ``EnhancementPredictor``
  reads.
- ``cli train-mlp``, ``train-vgg`` and ``train-zoo --model resnet`` with
  ``--device cpu --epochs 2`` on a tiny folder (the VGG's images cut to
  32^2 by patching the dataset's size), then ``--resume``, then ``enhance
  --model`` on their checkpoints.
"""

import json

import cv2
import numpy as np
import pytest
import torch

from underwater_image_enhancement_tpu.train import data as jdata
from underwater_image_enhancement_tpu_torch import cli as tcli
from underwater_image_enhancement_tpu_torch.features import full as tfull
from underwater_image_enhancement_tpu_torch.models import bridge
from underwater_image_enhancement_tpu_torch.models.predictor import (
    EnhancementPredictor,
)
from underwater_image_enhancement_tpu_torch.train import data as tdata
from underwater_image_enhancement_tpu_torch.train import trainer as ttrainer
from underwater_image_enhancement_tpu_torch.utils import io as tio

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """8 pairs, raw a gamma-darkened reference (tests/test_train.py's
    recipe, its own generator), 48x48 PNGs written by the port's codec;
    one raw a 40x56 baseline JPEG written by cv2, one reference
    missing."""
    root = tmp_path_factory.mktemp("pairs")
    raw, ref = root / "raw", root / "ref"
    rng = np.random.default_rng(0)
    for i in range(8):
        clean = np.clip(rng.random((48, 48, 3)) * 0.9 + 0.05, 0, 1)
        hazy = clean ** 1.4
        if i == 3:
            raw.mkdir(parents=True, exist_ok=True)
            bgr = (hazy[:40, :, ::-1].repeat(2, 1)[:, :56] * 255).astype(
                np.uint8)
            cv2.imwrite(str(raw / f"img{i}.jpg"), bgr)
        else:
            tio.imwrite_unit(str(raw / f"img{i}.png"), hazy.astype(np.float32))
        if i != 5:
            tio.imwrite_unit(str(ref / f"img{i}.png"), clean.astype(np.float32))
    return str(raw), str(ref)


@pytest.mark.parametrize("augment", [False, True])
def test_batches_bit_equal_to_jax(folders, augment):
    kw = {"target_size": 32, "augment": augment, "seed": 4}
    jd, td = jdata.PairedImageDataset(*folders, **kw), \
        tdata.PairedImageDataset(*folders, **kw)
    assert [p.name for p in td.image_paths] == [p.name for p in jd.image_paths]
    tr_j, va_j = jd.split(0.75)
    tr_t, va_t = td.split(0.75)
    assert np.array_equal(tr_j, tr_t) and np.array_equal(va_j, va_t)
    n = 0
    for epoch in range(2):
        for bj, bt in zip(jd.batches(tr_j, 2, seed=epoch, with_indices=True,
                                     process_index=0, process_count=1),
                          td.batches(tr_t, 2, seed=epoch, with_indices=True)):
            for a, b in zip(bj, bt):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            n += 1
    assert n == 6
    for bj, bt in zip(jd.batches(va_j, 2, shuffle=False, process_index=0,
                                 process_count=1),
                      td.batches(va_t, 2, shuffle=False)):
        assert all(np.array_equal(a, b) for a, b in zip(bj, bt))


def test_batches_multihost_sharding(folders):
    """Per-process batch streams are disjoint, equal-length, and together
    cover the single-process epoch (tests/test_train.py:41)."""
    ds = tdata.PairedImageDataset(*folders, target_size=32, augment=False)
    idx = np.arange(len(ds))
    single = list(ds.batches(idx, 2, seed=7, process_index=0,
                             process_count=1))
    shards = [list(ds.batches(idx, 2, seed=7, process_index=p,
                              process_count=2)) for p in range(2)]
    assert len(shards[0]) == len(shards[1]) == len(single) // 2
    got = sorted(b[0].tobytes() for s in shards for b in s)
    assert got == sorted(b[0].tobytes() for b in single)
    # None resolves to one process until data parallelism is ported
    assert len(list(ds.batches(idx, 2, seed=7))) == len(single)


def test_prefetch_to_device_yields_tensors_in_order(folders):
    ds = tdata.PairedImageDataset(*folders, target_size=32, augment=False)
    idx = np.arange(len(ds))
    want = list(ds.batches(idx, 2, shuffle=False, with_indices=True))
    got = list(tdata.prefetch_to_device(
        ds.batches(idx, 2, shuffle=False, with_indices=True), device="cpu"))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert all(torch.equal(x, torch.from_numpy(y)) for x, y in zip(a, b))

    def broken():
        yield want[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(tdata.prefetch_to_device(broken(), device="cpu"))


def _ds(folders, **kw):
    return tdata.PairedImageDataset(*folders, target_size=32,
                                    augment=False, **kw)


def test_mlp_trainer_loss_decreases(folders, tmp_path):
    ds = _ds(folders)
    tr, va = ds.split(0.75)
    t = ttrainer.MLPTrainer(hidden_dim=32, num_blocks=1, lr=1e-2,
                            device="cpu")
    before = t.run_epoch(ds.batches(va, 2, shuffle=False), train=False)
    hist = t.fit(lambda: ds.batches(tr, 2, seed=0),
                 lambda: ds.batches(va, 2, shuffle=False), epochs=8,
                 output_folder=str(tmp_path), log=lambda *_: None)
    after = t.run_epoch(ds.batches(va, 2, shuffle=False), train=False)
    print(f"mlp val loss {before:.6f} -> {after:.6f}")
    assert len(hist["train_loss"]) == 8 and np.isfinite(hist["train_loss"]).all()
    assert after < before
    assert (tmp_path / "best_model.npz").exists()
    saved = json.loads((tmp_path / "training_history.json").read_text())
    assert saved == hist


def test_mlp_feature_cache(folders, monkeypatch):
    ds = _ds(folders)
    tr, _ = ds.split(0.75)
    t = ttrainer.MLPTrainer(hidden_dim=32, num_blocks=1, lr=1e-2,
                            device="cpu")
    t.cache_features(ds, batch_size=3, log=lambda *_: None)
    for i in range(len(ds)):
        img = torch.from_numpy(ds.load_pair(i)[0])
        direct = tfull.extract_all_features(img)
        assert torch.equal(t._feature_cache[i], direct), i
    calls = {"n": 0}
    real = tfull.extract_batch

    def counting(x):
        calls["n"] += 1
        return real(x)

    monkeypatch.setattr(tfull, "extract_batch", counting)
    loss = t.run_epoch(ds.batches(tr, 2, with_indices=True, seed=0),
                       train=True)
    assert np.isfinite(loss) and calls["n"] == 0


def test_mlp_checkpoint_resume(folders, tmp_path):
    ds = _ds(folders)
    tr, va = ds.split(0.75)
    t1 = ttrainer.MLPTrainer(hidden_dim=32, num_blocks=1, device="cpu")
    t1.fit(lambda: ds.batches(tr, 2), lambda: ds.batches(va, 2, shuffle=False),
           epochs=2, output_folder=str(tmp_path), log=lambda *_: None)
    t2 = ttrainer.MLPTrainer(hidden_dim=32, num_blocks=1, seed=9,
                             device="cpu")
    t2.load(str(tmp_path / "final_model"))
    assert t2.start_epoch == 2
    a, b = bridge.to_flax(t1.model), bridge.to_flax(t2.model)
    assert all(np.array_equal(x, y) for x, y in zip(
        bridge.flatten(a).values(), bridge.flatten(b).values()))
    s1 = bridge.optax_adam_state(t1.model, t1.optimizer)
    s2 = bridge.optax_adam_state(t2.model, t2.optimizer)
    assert int(s1["count"]) == int(s2["count"]) == 6
    assert all(np.array_equal(x, y) for x, y in zip(
        bridge.flatten(s1["nu"]).values(), bridge.flatten(s2["nu"]).values()))


@pytest.fixture(scope="module")
def vgg_fit(folders, tmp_path_factory):
    """A VGG trainer (hidden 16, 32^2, f32) fitted 2 epochs, its folder."""
    out = tmp_path_factory.mktemp("vgg")
    ds = _ds(folders)
    tr, va = ds.split(0.75)
    with pytest.warns(UserWarning, match="RANDOM-init"):
        t = ttrainer.VGGTrainer(hidden_dim=16, image_size=32, lr=1e-3,
                                epochs=4, compute_dtype="float32",
                                pretrained_vgg=None, device="cpu")
    before = bridge.flatten(bridge.to_flax(t.model)["params"])
    t.fit(lambda: ds.batches(tr, 2, seed=0),
          lambda: ds.batches(va, 2, shuffle=False), epochs=2,
          output_folder=str(out), log=lambda *_: None)
    return t, {k: v.copy() for k, v in before.items()}, out


def test_vgg_trainer_freezes_the_first_convs(vgg_fit):
    t, before, _ = vgg_fit
    after = bridge.flatten(bridge.to_flax(t.model)["params"])
    for i in range(10):
        same = np.array_equal(after[f"vgg/conv{i}/kernel"],
                              before[f"vgg/conv{i}/kernel"])
        assert same == (i < 8), i
    assert np.isfinite(t.train_losses).all()


def test_vgg_checkpoint_reads_back_through_the_predictor(vgg_fit):
    """final_model.npz -> EnhancementPredictor: the same leaves, and its
    heads equal the trainer's on the same preprocessed input."""
    t, _, out = vgg_fit
    pred = EnhancementPredictor(str(out / "final_model.npz"), hidden_dim=16,
                                input_size=32, pretrained_vgg=None,
                                device="cpu")
    a = bridge.flatten(bridge.to_flax(pred.model))
    b = bridge.flatten(bridge.to_flax(t.model))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (32, 32, 3)).astype(np.float32) / 255.0
    x = torch.from_numpy(img)
    prep = pred._preprocess(x)
    assert torch.allclose(prep, t._backbone_input(x), atol=1e-6)
    feats = tfull.extract_all_features(x)[None]
    with torch.no_grad():
        raw = pred.model(prep[None], feats)
    mine = t.predict_params(x[None], feats)
    d = max(float((raw[k] - mine[k]).abs().max()) for k in raw)
    print(f"predictor heads vs trainer: max |d| {d:.3g}")
    assert d <= 1e-6


def test_vgg_trainer_bf16_default(folders):
    ds = _ds(folders)
    tr, _ = ds.split(0.75)
    with pytest.warns(UserWarning):
        t = ttrainer.VGGTrainer(hidden_dim=16, image_size=32, lr=1e-3,
                                epochs=4, pretrained_vgg=None, device="cpu")
    assert t.compute_dtype == torch.bfloat16
    assert t.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in t.model.parameters())
    assert np.isfinite(t.run_epoch(ds.batches(tr, 2), train=True))
    assert all(p.dtype == torch.float32 for p in t.model.parameters())


def test_vgg_lr_schedule_reaches_the_step():
    """The first update at epoch 9 shrinks against epoch 0 by the
    schedule's ratio (tests/test_train.py's test_vgg_lr_schedule_anneals):
    Adam's first update is about lr * sign(g)."""
    with pytest.warns(UserWarning):
        t = ttrainer.VGGTrainer(hidden_dim=16, image_size=32, lr=1e-3,
                                epochs=40, compute_dtype="float32",
                                pretrained_vgg=None, device="cpu")
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.random((2, 32, 32, 3)).astype(np.float32))
    refs = torch.clamp(imgs ** 0.8, 0, 1)
    start = bridge.to_flax(t.model)

    def first_step_delta(epoch):
        bridge.load_flax(t.model, start)
        t.optimizer.state.clear()
        t._epoch_count = epoch
        t._step(None, imgs, refs)
        after = bridge.flatten(bridge.to_flax(t.model)["params"])
        return float(np.sqrt(sum(((after[k] - v) ** 2).sum() for k, v in
                                 bridge.flatten(start["params"]).items())))

    expected = t.schedule(9) / t.schedule(0)
    ratio = first_step_delta(9) / first_step_delta(0)
    print(f"update ratio {ratio:.4f}, schedule ratio {expected:.4f}")
    assert expected < 0.05 and abs(ratio - expected) / expected < 0.1


def _cli(argv):
    tcli.main(argv + ["--device", "cpu"])


def test_cli_train_commands_resume_and_enhance(folders, tmp_path,
                                               monkeypatch, capsys):
    raw, ref = folders
    real = tdata.PairedImageDataset

    def small(*a, target_size=224, **k):
        return real(*a, target_size=32 if target_size == 224 else
                    target_size, **k)

    common = ["--input", raw, "--reference", ref, "--batch-size", "2"]
    for cmd, extra in (("train-mlp", []),
                       ("train-vgg", ["--pretrained-vgg", "none", "--fp32"]),
                       ("train-zoo", ["--model", "resnet", "--image-size",
                                      "32", "--pretrained", "none"])):
        out = tmp_path / cmd
        with monkeypatch.context() as m:
            if cmd == "train-vgg":
                m.setattr(tdata, "PairedImageDataset", small)
            _cli([cmd, "--output", str(out), "--epochs", "2"] + common + extra)
            assert {"best_model.npz", "final_model.npz",
                    "training_history.json"} <= {p.name for p in out.iterdir()}
            _cli([cmd, "--output", str(out), "--epochs", "3", "--resume",
                  str(out / "final_model.npz")] + common + extra)
        hist = json.loads((out / "training_history.json").read_text())
        assert len(hist["train_loss"]) == 3, cmd
        text = capsys.readouterr().out
        assert "epoch 3/3" in text and text.count("epoch 1/2") == 1, cmd

    enh = tmp_path / "enh_zoo"
    _cli(["enhance", "--input", raw, "--output", str(enh), "--model",
          str(tmp_path / "train-zoo" / "final_model.npz"), "--arch",
          "resnet", "--input-size", "32"])
    assert sorted(p.name for p in enh.iterdir()) == [
        f"img{i}_enhanced.png" for i in range(8)]
    one = tmp_path / "one.png"
    _cli(["enhance", "--input", raw + "/img0.png", "--output", str(one),
          "--model",
          str(tmp_path / "train-vgg" / "final_model.npz")])
    assert tio.imread_u8(str(one)).shape == (48, 48, 3)
