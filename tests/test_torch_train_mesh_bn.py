"""The BatchNorm trainers' ``mesh=`` (``VGGTrainer`` and the ResNet18 and
EfficientNet ``ZooTrainer``) on the CPU against the port's own mesh None:
each position runs its row block on a thread of its own, and BatchNorm in
train mode takes the whole batch's statistics, every position's sums
added in mesh order (``layers.MeshStats``).  JAX's sharded step holds
them in ``tests/test_torch_train_mesh.py``, and
``tests/test_torch_train_mesh_f64.py`` shows the f32 gaps below closing
in f64.

- 2, 4 and 8 positions, dropout on (the masks drawn for the whole batch):
  the step-1 loss, its gradients and the running statistics after it, and
  the parameters after ``STEPS`` steps, within the gates below.  Two
  controls must fail the loss and gradient gates: one drops the last
  position's sums and gradients (``trainer._mesh_sum``), the other takes
  each position's statistics from its own rows (``MeshStats.combine``).
- One position is bit-equal to mesh None; the bf16 VGG on 2 positions is
  finite and within ``BF16_LOSS_REL`` of its mesh None; each position's
  BatchNorm calls see its B/P rows; a position that raises makes the step
  raise and leaves no thread; an eval epoch over the mesh equals mesh
  None's.

Sizes: the VGG at hidden 16 in f32 (its perceptual trunk seeded),
ResNet18 and EfficientNet b0, all at 32^2, a batch of 8 cut from
``tests/torch_frames.py``'s frame.  CPU readings (``-s`` prints them): the
loss within 6.6e-7 relative, the gradients within 6.7e-5 of the largest,
the statistics within 1.2e-6 of the largest; after 3 steps the VGG has
7.9e-6 of its parameters over 1e-6, ResNet18 and EfficientNet up to 33 %
and 93 %, each within 3.4e-4 (``DRIFTING``); the bf16 VGG's loss equal to
mesh None's; the controls' loss 1.2e-3 to 0.49 and gradients 0.024 to
2.6e5 of the largest off.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tests import torch_frames
from underwater_image_enhancement_tpu_torch.models import bridge, layers
from underwater_image_enhancement_tpu_torch.models.vgg import VGGFeatures
from underwater_image_enhancement_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

B = 8
STEPS = 3
NETS = {"vgg": 32, "resnet": 32, "efficientnet": 32}
# the gates against mesh None: 9c-1's, and for the running statistics
# 1e-5 of the largest (the fast variance's cancellation: EfficientNet on 2
# positions reads 1.1e-6)
LOSS_REL = 1e-6
GRAD_REL = 1e-4          # of the largest gradient
STATS_REL = 1e-5         # of the largest running statistic
PARAM_ABS = 1e-6         # after STEPS steps, but for FLIP_SHARE of them
FLIP_SHARE = 1e-3        # each within 2 lr a step (Adam's first steps)
# ResNet18 and EfficientNet at 32^2 drift apart over the steps whatever the
# mesh: mesh None on the same batch with two pairs of rows swapped (dropout
# off) differs from mesh None after 3 steps in 1.9 % (ResNet18) and 13.5 %
# (EfficientNet) of the parameters, as 2 positions do (1.9 %, 13.6 %).
# Their parameters are held to Adam's bound of 2 lr a step only.
DRIFTING = ("resnet", "efficientnet")
BF16_LOSS_REL = 1e-3


def _batch(size: int, n: int = B):
    """``torch_frames.train_batch`` as tensors."""
    return tuple(map(torch.from_numpy, torch_frames.train_batch(size, n)))


def _trainer(net: str, mesh, size: int = 32, dtype: str = "float32",
             trunk=None):
    if net == "vgg":
        return ttrainer.VGGTrainer(hidden_dim=16, image_size=size, epochs=40,
                                   compute_dtype=dtype, pretrained_vgg=None,
                                   vgg_loss_params=trunk or _TRUNK, mesh=mesh,
                                   device="cpu")
    return ttrainer.ZooTrainer(net, image_size=size, pretrained=None,
                               mesh=mesh, device="cpu")


# one seeded perceptual trunk for every port VGG trainer (the warning of a
# random trunk is the trainer's, not the test's)
_TRUNK = VGGFeatures(depth=7)
bridge.flax_default_init(_TRUNK, torch.Generator().manual_seed(1))
_TRUNK.requires_grad_(False)


def _loss_and_grads(t, imgs, refs):
    """The training loss of one batch, the gradients it leaves (by name)
    and the running statistics after it, without the update."""
    with layers.no_tf32():
        t.optimizer.zero_grad(set_to_none=True)
        if t.sharded:
            loss = t._mesh_loss(None, imgs, refs, True)
        else:
            t.model.train()
            loss = t._loss_fn(None, imgs, refs, True)
            loss.backward()
    return (float(loss.detach()),
            {k: p.grad.clone() for k, p in t.model.named_parameters()
             if p.grad is not None},
            {k: v.copy() for k, v in
             bridge.flatten(bridge.to_flax(t.model)["batch_stats"]).items()})


def _control(control: str, monkeypatch) -> None:
    """"drop": the last position's sums and gradients dropped; "local":
    each position's statistics from its own rows."""
    if control == "drop":
        add = ttrainer._mesh_sum
        monkeypatch.setattr(ttrainer, "_mesh_sum",
                            lambda parts: add(list(parts)[:-1]))
    else:
        monkeypatch.setattr(layers.MeshStats, "combine",
                            staticmethod(lambda index, slot: slot[index]))


def _run(net, mesh, control=None, monkeypatch=None, steps=STEPS):
    """(step-1 loss, its gradients, the running statistics after it, the
    parameters after ``steps`` more steps, their lr) of one trainer (the
    first forward moves no parameter); ``control`` "drop" drops the last
    position's sums and gradients, "local" takes each position's
    statistics from its own rows."""
    if control:
        _control(control, monkeypatch)
    imgs, refs = _batch(NETS[net])
    t = _trainer(net, mesh)
    loss, grads, stats = _loss_and_grads(t, imgs, refs)
    for _ in range(steps):
        t._step(None, imgs, refs)
    if control:
        monkeypatch.undo()
    return (loss, grads, stats,
            bridge.flatten(bridge.to_flax(t.model)["params"]),
            t.optimizer.param_groups[0]["lr"])


def _readings(got, want) -> dict:
    loss, grads, stats, params, _ = got
    loss0, grads0, stats0, params0, _ = want
    gmax = max(float(g.abs().max()) for g in grads0.values())
    smax = max(float(np.abs(v).max()) for v in stats0.values())
    dp = np.concatenate([np.abs(params[k] - params0[k]).ravel()
                         for k in params0])
    return {"loss_rel": abs(loss / loss0 - 1),
            "grad_rel": max(float((grads[k] - grads0[k]).abs().max())
                            for k in grads0) / gmax,
            "stats_rel": max(float(np.abs(stats[k] - stats0[k]).max())
                             for k in stats0) / smax,
            "param_max": float(dp.max()),
            "flip_share": float((dp > PARAM_ABS).mean())}


def _within(r, lr, net) -> dict:
    return {"loss": r["loss_rel"] <= LOSS_REL,
            "grad": r["grad_rel"] <= GRAD_REL,
            "stats": r["stats_rel"] <= STATS_REL,
            "params": ((r["flip_share"] <= FLIP_SHARE or net in DRIFTING)
                       and r["param_max"] <= 2.001 * lr * STEPS)}


@pytest.fixture(scope="module")
def unsharded():
    return {net: _run(net, None) for net in NETS}


@pytest.mark.parametrize("net", sorted(NETS))
def test_one_position_is_bit_equal_to_none(net, unsharded):
    loss, grads, stats, params, _ = _run(net, 1)
    loss0, grads0, stats0, params0, _ = unsharded[net]
    assert loss == loss0
    assert grads.keys() == grads0.keys()
    assert all(torch.equal(grads[k], grads0[k]) for k in grads0)
    assert all(np.array_equal(stats[k], stats0[k]) for k in stats0)
    assert all(np.array_equal(params[k], params0[k]) for k in params0)


@pytest.mark.parametrize("positions", [2, 4, 8])
@pytest.mark.parametrize("net", sorted(NETS))
def test_positions_within_gates_of_none(net, positions, unsharded,
                                        monkeypatch):
    lr = unsharded[net][4]
    got = _readings(_run(net, positions), unsharded[net])
    controls = {c: _readings(_run(net, positions, c, monkeypatch, steps=0),
                             unsharded[net]) for c in ("drop", "local")}
    print(f"{net} on {positions} positions: {got}; controls {controls}")
    assert all(_within(got, lr, net).values()), got
    for name, ctl in controls.items():
        held = _within(ctl, lr, net)
        assert not held["loss"] and not held["grad"], (name, ctl)


def test_bf16_vgg_on_two_positions():
    imgs, refs = _batch(32)
    losses = [_loss_and_grads(_trainer("vgg", mesh, dtype="bfloat16"),
                              imgs, refs)[0] for mesh in (None, 2)]
    rel = abs(losses[1] / losses[0] - 1)
    print(f"bf16 VGG on 2 positions: loss {losses[1]:.9g}, mesh None "
          f"{losses[0]:.9g}, rel {rel:.3g}")
    assert np.isfinite(losses[1]) and rel <= BF16_LOSS_REL


@pytest.mark.parametrize("net", sorted(NETS))
def test_each_position_sees_its_rows(net, monkeypatch):
    """Every BatchNorm call of a 4-position step goes through the mesh's
    statistics, each position's with B/4 rows, every BatchNorm of the
    net once a position."""
    seen, statistics = [], layers.MeshStats.statistics

    def record(self, index, call, x32, dims):
        seen.append((index, call, x32.shape[0]))
        return statistics(self, index, call, x32, dims)

    monkeypatch.setattr(layers.MeshStats, "statistics", record)
    t = _trainer(net, 4)
    imgs, refs = _batch(NETS[net])
    t._step(None, imgs, refs)
    bns = sum(isinstance(m, layers.BatchNorm) for m in t.model.modules())
    assert bns and {rows for _, _, rows in seen} == {B // 4}
    for k in range(4):
        assert sorted(c for i, c, _ in seen if i == k) == list(range(bns))


@pytest.mark.parametrize("call", [0, 2])
def test_a_failing_position_raises_and_leaves_no_thread(call, monkeypatch):
    """Position 3 of 4 raises at its ``call``-th BatchNorm call: the step
    raises that error within 60 s, every position's thread is idle after
    it (the next step runs), and ``close`` ends them."""
    statistics = layers.MeshStats.statistics

    def fail(self, index, c, x32, dims):
        if index == 3 and c == call:
            raise RuntimeError("position 3 fails")
        return statistics(self, index, c, x32, dims)

    monkeypatch.setattr(layers.MeshStats, "statistics", fail)
    t = _trainer("resnet", 4)
    imgs, refs = _batch(32)
    raised = []

    def step():
        try:
            t._step(None, imgs, refs)
        except BaseException as e:  # noqa: BLE001 - read below
            raised.append(e)

    runner = threading.Thread(target=step, daemon=True)
    start = time.monotonic()
    runner.start()
    runner.join(timeout=60)
    assert not runner.is_alive(), "the step hangs"
    print(f"failing position at call {call}: raised after "
          f"{time.monotonic() - start:.2f} s")
    assert len(raised) == 1 and isinstance(raised[0], RuntimeError)
    assert str(raised[0]) == "position 3 fails"
    monkeypatch.undo()
    assert np.isfinite(float(t._step(None, imgs, refs)))
    threads = [th for pool in t._threads._pools for th in pool._threads]
    assert len(threads) == 4
    t._threads.close()
    assert not any(th.is_alive() for th in threads)


@pytest.mark.parametrize("net", sorted(NETS))
def test_eval_epoch_over_the_mesh(net):
    imgs, refs = _batch(NETS[net])
    got = _trainer(net, 4).run_epoch([(imgs, refs)], train=False)
    want = _trainer(net, None).run_epoch([(imgs, refs)], train=False)
    assert abs(got / want - 1) <= LOSS_REL
