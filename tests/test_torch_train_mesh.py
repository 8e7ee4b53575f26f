"""The trainers' ``mesh=`` (``MLPTrainer`` and the ViT ``ZooTrainer``) on
the CPU: the batch cut into row blocks over mesh positions, each block's
loss sums and gradients added in mesh order.

- One position is bit-equal to mesh None (it runs as mesh None).
- 2, 4 and 8 positions against the port's mesh None, dropout on (the
  masks drawn for the whole batch, ``layers.BatchMasks``): the step-1 loss
  and gradients, and the parameters after ``STEPS`` steps, within the
  gates below.  Each gate is failed by a control step that drops the last
  position's sums and gradients.
- 8 positions against JAX's sharded trainer on the suite's 8 CPU devices,
  dropout the identity on both sides (as in
  ``tests/test_torch_train_steps.py``), at JAX's own tolerances
  (``tests/test_parallel.py``): the loss within 1e-5, each gradient leaf
  within 1e-3 of its largest (1e-3 at the least).
- A batch the positions do not divide raises in both packages.
- The BatchNorm nets against JAX's sharded step, dropout the identity on
  both sides: the VGG predictor (hidden 16, 32^2, f32, its perceptual
  trunk JAX's) and ResNet18 (32^2) on 8 positions, EfficientNet b0 (64^2,
  from a seeded tree, a batch of 4) on 2, batches cut from
  ``tests/torch_frames.py``'s frame, at JAX's own gates
  (``tests/test_parallel.py``): the loss within 1e-4 relative, each
  gradient leaf within 1e-3 of its largest with a 5e-6 floor; BatchNorm's
  running statistics after the step within 1e-6 of the largest
  (``tests/test_torch_train_steps.py``'s gate).
  ``tests/test_torch_train_mesh_bn.py`` holds them against mesh None.

Sizes: the MLP at hidden 32 with one block on given features, the ViT at
dim 64, depth 2, 4 heads at 32^2, a batch of 8.  CPU readings (``-s``
prints them): the loss within 9.9e-8 relative at 2, 4 and 8 positions
(controls 0.12-0.50), the gradients within 3.8e-6 of the largest
(controls 0.23-0.67), after 3 steps at most 1.8e-4 of the parameters over
1e-6 (controls 43-96 %); against JAX's sharded step the loss within
1.8e-7 and the gradients within 4.5e-5 of each leaf's largest; the
BatchNorm nets' loss within 6.9e-7 relative, their gradients within
9.8e-5 of each leaf's largest and their statistics within 8.5e-7.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import seeded_tree
from tests import torch_frames
from underwater_image_enhancement_tpu.features.basic import (
    extract_basic_batch,
)
from underwater_image_enhancement_tpu.models import zoo as jzoo
from underwater_image_enhancement_tpu.train import trainer as jtrainer
from underwater_image_enhancement_tpu_torch.models import bridge, layers
from underwater_image_enhancement_tpu_torch.models import zoo as tzoo
from underwater_image_enhancement_tpu_torch.models.vgg import VGGFeatures
from underwater_image_enhancement_tpu_torch.parallel.mesh import Mesh
from underwater_image_enhancement_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

B = 8
SIZE = 32
STEPS = 3
VIT = {"dim": 64, "depth": 2, "heads": 4}
LR = 1e-4
# the gates against mesh None, and JAX's
LOSS_REL = 1e-6
GRAD_REL = 1e-4          # of the largest gradient
PARAM_ABS = 1e-6         # after STEPS steps, but for FLIP_SHARE of them
FLIP_SHARE = 1e-3        # each within 2 lr a step (Adam's first steps)
JAX_LOSS_ABS = 1e-5
JAX_GRAD_REL = 1e-3      # of each leaf's largest, 1e-3 at the least
# the BatchNorm nets: JAX's gates (tests/test_parallel.py), the statistics'
BN_LOSS_REL = 1e-4
BN_GRAD_REL, BN_GRAD_FLOOR = 1e-3, 5e-6
BN_STATS_REL = 1e-6
# (JAX's trainer, its mesh, image size, batch) of each BatchNorm net
BN_NETS = {"vgg": (8, 32, 8), "resnet": (8, 32, 8), "efficientnet": (2, 64, 4)}


def _batch():
    """(idx, imgs, refs, feats) on the u8 grid, refs a brighter version of
    imgs; feats the MLP's 79 features, seeded."""
    rng = np.random.default_rng(11)
    imgs = np.floor(rng.random((B, SIZE, SIZE, 3)) * 200.0 + 20) / 255.0
    refs = np.floor(np.clip(imgs ** 0.7 + rng.normal(0, 0.02, imgs.shape),
                            0, 1) * 255.0) / 255.0
    feats = np.random.default_rng(5).random((B, 79)).astype(np.float32)
    return (np.arange(B), torch.from_numpy(imgs.astype(np.float32)),
            torch.from_numpy(refs.astype(np.float32)), feats)


@pytest.fixture(scope="module", autouse=True)
def small_vit():
    """``create_model("vit")`` at VIT's widths in both packages."""
    tcreate, jcreate = tzoo.create_model, jzoo.create_model

    def port(model_type="mlp", **k):
        if model_type == "vit":
            return tzoo.ViTParameterPredictor(**VIT, **k)
        return tcreate(model_type, **k)

    def jax_(model_type="mlp", **k):
        if model_type == "vit":
            return jzoo.ViTParameterPredictor(**VIT)
        return jcreate(model_type, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tzoo, "create_model", port)
        mp.setattr(jzoo, "create_model", jax_)
        yield


def _trainer(net: str, mesh):
    if net == "mlp":
        t = ttrainer.MLPTrainer(hidden_dim=32, num_blocks=1, mesh=mesh,
                                device="cpu")
        t._feature_cache = torch.from_numpy(_batch()[3])
        return t
    return ttrainer.ZooTrainer("vit", image_size=SIZE, pretrained=None,
                               mesh=mesh, device="cpu")


def _loss_and_grads(t, batch):
    """The training loss of one batch and the gradients it leaves, by
    name, without the update."""
    idx, imgs, refs, _ = batch
    with layers.no_tf32():
        t.optimizer.zero_grad(set_to_none=True)
        if t.sharded:
            loss = t._mesh_loss(idx, imgs, refs, True)
        else:
            t.model.train()
            loss = t._loss_fn(idx, imgs, refs, True)
            loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in
                                  t.model.named_parameters()
                                  if p.grad is not None}


def _steps(t, batch):
    idx, imgs, refs, _ = batch
    losses = [float(t._step(idx, imgs, refs)) for _ in range(STEPS)]
    return losses, bridge.flatten(bridge.to_flax(t.model)["params"])


def _run(net, mesh, control=False, monkeypatch=None):
    """(step-1 loss, its gradients, the losses of STEPS steps, the
    parameters after them); ``control`` drops the last position's sums
    and gradients."""
    if control:
        add = ttrainer._mesh_sum
        monkeypatch.setattr(ttrainer, "_mesh_sum",
                            lambda parts: add(list(parts)[:-1]))
    batch = _batch()
    loss, grads = _loss_and_grads(_trainer(net, mesh), batch)
    losses, params = _steps(_trainer(net, mesh), batch)
    if control:
        monkeypatch.undo()
    return loss, grads, losses, params


def _readings(got, want) -> dict:
    loss, grads, _, params = got
    loss0, grads0, _, params0 = want
    gmax = max(float(g.abs().max()) for g in grads0.values())
    dp = np.concatenate([np.abs(params[k] - params0[k]).ravel()
                         for k in params0])
    return {"loss_rel": abs(loss / loss0 - 1),
            "grad_rel": max(float((grads[k] - grads0[k]).abs().max())
                            for k in grads0) / gmax,
            "param_max": float(dp.max()),
            "flip_share": float((dp > PARAM_ABS).mean())}


def _within(r) -> dict:
    return {"loss": r["loss_rel"] <= LOSS_REL,
            "grad": r["grad_rel"] <= GRAD_REL,
            "params": (r["flip_share"] <= FLIP_SHARE
                       and r["param_max"] <= 2.001 * LR * STEPS)}


@pytest.fixture(scope="module")
def unsharded():
    return {net: _run(net, None) for net in ("mlp", "vit")}


@pytest.mark.parametrize("net", ["mlp", "vit"])
def test_one_position_is_bit_equal_to_none(net, unsharded):
    loss, grads, losses, params = _run(net, 1)
    loss0, grads0, losses0, params0 = unsharded[net]
    assert loss == loss0 and losses == losses0
    assert grads.keys() == grads0.keys()
    assert all(torch.equal(grads[k], grads0[k]) for k in grads0)
    assert all(np.array_equal(params[k], params0[k]) for k in params0)


@pytest.mark.parametrize("positions", [2, 4, 8])
@pytest.mark.parametrize("net", ["mlp", "vit"])
def test_positions_within_gates_of_none(net, positions, unsharded,
                                        monkeypatch):
    got = _readings(_run(net, positions), unsharded[net])
    ctl = _readings(_run(net, positions, True, monkeypatch), unsharded[net])
    print(f"{net} on {positions} positions: {got}; control {ctl}")
    assert all(_within(got).values()), got
    assert not any(_within(ctl).values()), ctl


def test_replica_on_another_device_equals_one_device():
    """Mesh(cpu, cpu:0): the second position's device is another torch
    device, so it runs on a replica, copied from the model after each
    step; the steps equal those of Mesh(cpu, cpu)."""
    batch = _batch()
    t = _trainer("vit", Mesh(("cpu", "cpu:0")))
    losses, params = _steps(t, batch)
    assert list(t._replicas) == [torch.device("cpu", 0)]
    replica = t._replicas[torch.device("cpu", 0)]
    assert all(torch.equal(a, b) for a, b in
               zip(replica.parameters(), t.model.parameters()))
    losses0, params0 = _steps(_trainer("vit", Mesh(("cpu", "cpu"))), batch)
    assert losses == losses0
    assert all(np.array_equal(params[k], params0[k]) for k in params0)


@pytest.mark.parametrize("net", ["mlp", "vit"])
def test_eval_epoch_over_the_mesh(net, unsharded):
    idx, imgs, refs, _ = _batch()
    got = _trainer(net, 4).run_epoch([(idx, imgs, refs)], train=False)
    want = _trainer(net, None).run_epoch([(idx, imgs, refs)], train=False)
    assert abs(got / want - 1) <= LOSS_REL


@pytest.fixture()
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    monkeypatch.setattr(layers, "dropout", lambda x, *a, **k: x)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("net", ["mlp", "vit"])
def test_eight_positions_match_jax_sharded_step(net, no_dropout):
    idx, imgs, refs, feats = _batch()
    key = jax.random.PRNGKey(0)
    if net == "mlp":
        jt = jtrainer.MLPTrainer(hidden_dim=32, num_blocks=1, mesh=8)
        grad = jax.jit(lambda p, i, r, f: jax.value_and_grad(jt._loss_fn)(
            p, i, r, f, key, True, "quantile"))
        loss_j, g_j = grad(jt.params, jt._shard(jnp.asarray(imgs.numpy())),
                           jt._shard(jnp.asarray(refs.numpy())),
                           jt._shard(jnp.asarray(feats)))
        tree, g_j = _np(jt.params), _np(g_j)["params"]
    else:
        jt = jtrainer.ZooTrainer("vit", image_size=SIZE, pretrained=None,
                                 mesh=8)
        grad = jax.jit(lambda p, st, i, r: jax.value_and_grad(
            jt._loss_fn, has_aux=True)(p, st, i, r, key, True))
        (loss_j, _), g_j = grad(jt.params, jt.batch_stats,
                                jt._shard(jnp.asarray(imgs.numpy())),
                                jt._shard(jnp.asarray(refs.numpy())))
        tree, g_j = {"params": _np(jt.params)}, _np(g_j)
    t = _trainer(net, 8)
    bridge.load_flax(t.model, tree)
    loss_t, _ = _loss_and_grads(t, (idx, imgs, refs, feats))
    g_t = {key[len("params/"):]: fwd(p.grad.numpy())
           for key, p, fwd, _ in bridge._leaves(t.model)
           if key.startswith("params/") and p.grad is not None}
    g_j = bridge.flatten(g_j)
    assert set(g_t) <= set(g_j)
    assert not any(g_j[k].any() for k in set(g_j) - set(g_t))
    worst = max(float(np.abs(g_t[k] - g_j[k]).max())
                / max(float(np.abs(g_j[k]).max()), 1e-3) for k in g_t)
    print(f"{net} on 8 positions against JAX's sharded step: loss "
          f"{abs(loss_t - float(loss_j)):.3g}, gradient {worst:.3g} of the "
          "leaf's largest")
    assert abs(loss_t - float(loss_j)) <= JAX_LOSS_ABS
    assert worst <= JAX_GRAD_REL


def test_undivided_batch_raises_in_both():
    idx, imgs, refs, feats = _batch()
    batch = [(idx[:4], imgs[:4].numpy(), refs[:4].numpy())]
    jt = jtrainer.MLPTrainer(hidden_dim=32, num_blocks=1, mesh=8)
    jt._feature_cache = jnp.asarray(feats)
    with pytest.raises(ValueError):
        jt.run_epoch(batch, train=True)
    for net in ("mlp", "vit"):
        with pytest.raises(ValueError, match="does not divide"):
            _trainer(net, 8).run_epoch(batch, train=True)


def test_first_position_must_be_the_trainers_device():
    with pytest.raises(ValueError, match="first position"):
        _trainer("mlp", Mesh(("cpu:0", "cpu")))


def _bn_trainers(net: str, mesh: int, size: int):
    """JAX's trainer of a BatchNorm net and the port's, JAX's variables
    (and the VGG's perceptual trunk) carried across."""
    if net == "vgg":
        with pytest.warns(UserWarning, match="RANDOM-init"):
            jt = jtrainer.VGGTrainer(hidden_dim=16, image_size=size,
                                     epochs=40, compute_dtype="float32",
                                     pretrained_vgg=None, mesh=mesh)
        trunk = bridge.load_flax(VGGFeatures(depth=7),
                                 _np(jt.vgg_loss_params))
        t = ttrainer.VGGTrainer(hidden_dim=16, image_size=size, epochs=40,
                                compute_dtype="float32", pretrained_vgg=None,
                                vgg_loss_params=trunk, mesh=mesh,
                                device="cpu")
    else:
        t = ttrainer.ZooTrainer(net, image_size=size, pretrained=None,
                                mesh=mesh, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            if net == "efficientnet":
                # a Flax init of EfficientNet takes tens of seconds on the
                # CPU: JAX's trainer starts from a seeded tree
                tree = seeded_tree(bridge, t.model, 5)
                mp.setattr(jzoo.EfficientNetParameterPredictor, "init",
                           lambda self, rng, x: jax.tree_util.tree_map(
                               jnp.asarray, tree))
            jt = jtrainer.ZooTrainer(net, image_size=size, pretrained=None,
                                     mesh=mesh)
    bridge.load_flax(t.model, {"params": _np(jt.params),
                               "batch_stats": _np(jt.batch_stats)})
    return jt, t


@pytest.mark.parametrize("net", sorted(BN_NETS))
def test_batchnorm_nets_match_jax_sharded_step(net, no_dropout):
    mesh, size, n = BN_NETS[net]
    jt, t = _bn_trainers(net, mesh, size)
    imgs, refs = torch_frames.train_batch(size, n)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def grad(p, st, imgs, refs):
        if net == "vgg":
            (loss, (_, new)), g = jax.value_and_grad(
                jt._forward, has_aux=True)(p, st, imgs,
                                           extract_basic_batch(imgs), refs,
                                           key, True)
        else:
            (loss, new), g = jax.value_and_grad(jt._loss_fn, has_aux=True)(
                p, st, imgs, refs, key, True)
        return loss, g, new

    loss_j, g_j, stats_j = grad(jt.params, jt.batch_stats,
                                jt._shard(jnp.asarray(imgs)),
                                jt._shard(jnp.asarray(refs)))
    loss_t, _ = _loss_and_grads(t, (None, torch.from_numpy(imgs),
                                    torch.from_numpy(refs), None))
    g_t = {key[len("params/"):]: fwd(p.grad.numpy())
           for key, p, fwd, _ in bridge._leaves(t.model)
           if key.startswith("params/") and p.grad is not None}
    g_j = bridge.flatten(_np(g_j))
    frozen = ({f"vgg/conv{i}/{leaf}" for i in range(8)
               for leaf in ("kernel", "bias")} if net == "vgg" else set())
    held = set(g_j) - frozen
    assert set(g_t) <= held
    assert not any(g_j[k].any() for k in held - set(g_t))
    worst = max(float(np.abs(g_t[k] - g_j[k]).max())
                / max(float(np.abs(g_j[k]).max()), BN_GRAD_FLOOR / BN_GRAD_REL)
                for k in g_t)
    stats_t = bridge.flatten(bridge.to_flax(t.model)["batch_stats"])
    stats_j = bridge.flatten(_np(stats_j))
    assert stats_t.keys() == stats_j.keys()
    ds = (max(float(np.abs(stats_t[k] - stats_j[k]).max()) for k in stats_j)
          / max(float(np.abs(v).max()) for v in stats_j.values()))
    dl = abs(loss_t / float(loss_j) - 1)
    print(f"{net} on {mesh} positions against JAX's sharded step: loss rel "
          f"{dl:.3g}, gradient {worst:.3g} of the leaf's largest, running "
          f"statistics {ds:.3g} of the largest")
    assert dl <= BN_LOSS_REL
    assert worst <= BN_GRAD_REL
    assert ds <= BN_STATS_REL
