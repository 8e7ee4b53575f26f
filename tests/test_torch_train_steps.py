"""The training steps of the port's trainers against the JAX package's,
on the CPU: from JAX's parameters carried across by the bridge, on an
equal batch, with dropout off on both sides (a test-level monkeypatch
makes ``flax.linen.Dropout`` and the port's ``layers.dropout`` the
identity: their masks come from different generators).  Then JAX's
parameters *and* optimiser state after its step 1 are carried across
(``bridge.load_optax_adam``), and the second step is held the same way.

Each step is held in three parts:

- the loss and its gradient (the port's autograd against the jitted
  ``jax.value_and_grad`` of the trainer's loss; for the zoo nets also
  both against the port's own gradient in f64: at ResNet18's second step
  JAX's f32 gradient lies 2e-2 of the largest from it, the port's 6.9e-5,
  and there the port is held to the f64 gradient), and BatchNorm's
  running statistics after the forward;
- the optimiser: JAX's gradients given to the port's clip and
  Adam/AdamW, the updated parameters against optax's update of the same
  gradients;
- the whole step: the port's ``_step`` against JAX's jitted gradient
  and update (the two parts above, composed).  Adam's first update is about ``lr * sign(g)`` for every element, so an
  element whose gradient lies within the two gradients' disagreement
  (the BatchNorm nets at a batch of 4: up to 2.3e-4 of the largest
  gradient) may step the other way; the count of such elements is
  printed and bounded.

Sizes: the MLP at hidden 32 with one block (its 79 features JAX's, given
to both), ResNet18 at 32^2, the ViT at dim 64, depth 2, 4 heads at 32^2,
EfficientNet b0 at 64^2 (from a seeded tree: a Flax init of it takes tens
of seconds), the VGG predictor at hidden 16 at 32^2 in f32 (its
perceptual trunk JAX's), batches of 4 on the u8 grid.

Gates (printed with ``-s``): the loss within 1e-4 relative (XLA:CPU sums
a loss of this size in one sequential f32 pass, up to 6.7e-5 off its f64
value: tests/test_torch_train_models.py); the gradients within
``GRAD_REL`` of the largest gradient (or, where JAX's is farther than
that from the f64 gradient, the port's within ``GRAD_REL`` of it and no
farther from JAX's than JAX's is from it, plus ``GRAD_REL``); BatchNorm's running statistics
within 1e-6 relative; the parameters updated from equal gradients within
1e-6 absolute and the optimiser's moments within 1e-4 of the largest
(``nu`` of the VGG's clipped step: 1.3e-5; ``mu`` 2.2e-7);
the whole step's parameters within 1e-6 absolute but for at most
``FLIP_SHARE`` of the elements, each within ``2 * lr``; for the VGG the
frozen convs bit for bit unchanged and the learning rate equal to
optax's injected one at each step.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import seeded_tree
from underwater_image_enhancement_tpu.features.basic import (
    extract_basic_batch,
)
from underwater_image_enhancement_tpu.features.full import extract_batch
from underwater_image_enhancement_tpu.models import zoo as jzoo
from underwater_image_enhancement_tpu.train import trainer as jtrainer
from underwater_image_enhancement_tpu_torch.models import bridge, layers
from underwater_image_enhancement_tpu_torch.models import zoo as tzoo
from underwater_image_enhancement_tpu_torch.models.vgg import VGGFeatures
from underwater_image_enhancement_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

B = 4
VIT = {"dim": 64, "depth": 2, "heads": 4}
LOSS_REL = 1e-4
GRAD_REL = 1e-3
STATS_REL = 1e-6
PARAM_ABS = 1e-6
MOMENT_REL = 1e-4
FLIP_SHARE = 1e-3


def _batches(size: int, seed: int):
    """Two (imgs, refs) batches on the u8 grid: refs a brighter, less
    hazy version of imgs, as the paired datasets hold."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        imgs = np.floor(rng.random((B, size, size, 3)) * 200.0 + 20) / 255.0
        refs = np.floor(np.clip(imgs ** 0.7 + rng.normal(0, 0.02, imgs.shape),
                                0, 1) * 255.0) / 255.0
        out.append((imgs.astype(np.float32), refs.astype(np.float32)))
    return out


def _np(tree):
    """A JAX tree as nested dicts of numpy arrays, optax.masked's
    MaskedNode leaves (frozen parameters) left out."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {k: _np(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if v is not None}
    if isinstance(tree, optax.MaskedNode):
        return None
    return np.asarray(tree)


def _diff(a: dict, b: dict):
    """(max |a - b|, the largest |b|, elements over PARAM_ABS, elements)
    over the common leaves of two flat trees."""
    d = {k: np.abs(a[k].astype(np.float64) - b[k]) for k in b if k in a}
    return (max(float(v.max()) for v in d.values()),
            max(float(np.abs(b[k]).max()) for k in d),
            sum(int((v > PARAM_ABS).sum()) for v in d.values()),
            sum(v.size for v in d.values()))


def _rel(a: dict, b: dict) -> float:
    """The largest leaf-wise |a - b| over the largest |b|."""
    dmax, bmax, _, _ = _diff(bridge.flatten(a), bridge.flatten(b))
    return dmax / max(bmax, 1e-30)


def _port_grads(tt) -> dict:
    """The gradients the port holds, as a flat Flax ``params`` tree."""
    return {key[len("params/"):]: fwd(t.grad.numpy())
            for key, t, fwd, _ in bridge._leaves(tt.model)
            if key.startswith("params/") and t.grad is not None}


def _set_grads(tt, flat: dict) -> None:
    """The optimiser's parameters' gradients set from a flat Flax tree."""
    held = {id(p) for p in tt.trainable}
    for key, t, _, inv in bridge._leaves(tt.model):
        if key.startswith("params/") and id(t) in held:
            t.grad = torch.from_numpy(np.array(inv(flat[key[7:]]),
                                               np.float32))


@pytest.fixture()
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    monkeypatch.setattr(layers, "dropout", lambda x, *a, **k: x)


def _hold(name: str, case: dict, batches) -> None:
    """Steps 1 and 2 of the port against JAX's, each from JAX's state
    before it (module docstring); ``case`` holds the two trainers and the
    JAX functions of one trainer."""
    jt, tt = case["jax"], case["port"]
    p, st, s = case["params"], case["stats"], case["opt_state"]
    for step, batch in enumerate(batches, 1):
        loss_j, g_j, st_j = case["grad"](p, st, batch)
        p_j, s_j = case["apply"](g_j, s, p, step)
        adam, lr = case["adam"](s)
        state = {"mu": case["inner"](_np(adam.mu)),
                 "nu": case["inner"](_np(adam.nu)),
                 "count": np.asarray(adam.count)}

        def load():
            bridge.load_flax(tt.model, {"params": case["inner"](_np(p)),
                                        **({"batch_stats": _np(st)}
                                           if st else {})})
            bridge.load_optax_adam(tt.model, tt.optimizer, state)

        # the loss, its gradient, BatchNorm's statistics
        load()
        idx, imgs, refs = case["batch"](batch)
        with layers.no_tf32():
            tt.model.train()
            tt.optimizer.zero_grad(set_to_none=True)
            loss_t = tt._loss_fn(idx, imgs, refs, True)
            loss_t.backward()
        g_t = _port_grads(tt)
        ds = (_rel(bridge.to_flax(tt.model)["batch_stats"], _np(st_j))
              if st else 0.0)
        g_j = bridge.flatten(case["inner"](_np(g_j)))
        g_64 = case["oracle"](idx, imgs, refs) if "oracle" in case else None
        load()
        # the port has no gradient where JAX's is zero by construction
        # (the zoo's guided_radius head, which no composite reads)
        held = set(g_j) - case.get("frozen", set())
        assert set(g_t) <= held
        assert not any(g_j[k].any() for k in held - set(g_t))
        gd, gmax, _, _ = _diff(g_t, g_j)
        if g_64 is not None:  # each f32 gradient against the f64 one
            gd_t = _diff(g_t, g_64)[0] / gmax
            gd_j = _diff({k: g_j[k] for k in g_64}, g_64)[0] / gmax
        dl = abs(float(loss_t) / float(loss_j) - 1)
        # the optimiser on JAX's gradients
        _set_grads(tt, g_j)
        case["set_lr"](step)
        tt._apply_gradients()
        want = bridge.flatten(case["inner"](_np(p_j)))
        dp, _, _, _ = _diff(bridge.flatten(bridge.to_flax(tt.model)["params"]),
                            want)
        adam_j, lr_j = case["adam"](s_j)
        got = bridge.optax_adam_state(tt.model, tt.optimizer)
        dm = max(_rel(got[k], case["inner"](_np(getattr(adam_j, k))))
                 for k in ("mu", "nu"))
        # the whole step
        load()
        case["set_epoch"](step)
        loss_s = tt._step(idx, imgs, refs)
        after = bridge.to_flax(tt.model)
        dw, _, over, n = _diff(bridge.flatten(after["params"]), want)
        dsw = _rel(after["batch_stats"], _np(st_j)) if st else 0.0
        lr_t = tt.optimizer.param_groups[0]["lr"]
        print(f"{name} step {step}: loss rel {dl:.3g}, grad {gd / gmax:.3g} "
              f"of the largest"
              + ("" if g_64 is None else f" (to the f64 gradient: port "
                 f"{gd_t:.3g}, JAX {gd_j:.3g})")
              + f", batch_stats rel {ds:.3g}; from JAX's "
              f"gradients params max |d| {dp:.3g}, moments rel {dm:.3g}; "
              f"whole step params max |d| {dw:.3g}, {over} of {n} over "
              f"{PARAM_ABS}, batch_stats rel {dsw:.3g}, lr {lr_t:.9g}")
        assert dl <= LOSS_REL and float(loss_s) == float(loss_t)
        if g_64 is None or gd <= GRAD_REL * gmax:
            assert gd <= GRAD_REL * gmax
        else:  # JAX's own gradient is the one off the f64 gradient
            assert gd_t <= GRAD_REL and gd / gmax <= gd_j + GRAD_REL
        assert ds <= STATS_REL and dsw <= STATS_REL
        assert dp <= PARAM_ABS and dm <= MOMENT_REL
        assert over <= FLIP_SHARE * n and dw <= 2.001 * lr_t
        assert lr_t == float(lr_j)
        if "frozen" in case:
            flat = bridge.flatten(after["params"])
            before = bridge.flatten(case["inner"](_np(p)))
            assert all(np.array_equal(flat[k], before[k])
                       for k in case["frozen"])
        p, st, s = p_j, st_j, s_j


def test_mlp_trainer_steps_match_jax(no_dropout):
    jt = jtrainer.MLPTrainer(hidden_dim=32, num_blocks=1)
    tt = ttrainer.MLPTrainer(hidden_dim=32, num_blocks=1, device="cpu")
    key = jax.random.PRNGKey(0)
    lr = tt.optimizer.param_groups[0]["lr"]

    @jax.jit
    def grad(p, imgs, refs, feats):
        return jax.value_and_grad(jt._loss_fn)(p, imgs, refs, feats, key,
                                               True, "quantile")

    @jax.jit
    def apply(g, s, p):
        upd, s = jt.tx.update(g, s, p)
        return optax.apply_updates(p, upd), s

    def feats(imgs):
        return np.asarray(extract_batch(jnp.asarray(imgs)))

    def batch(b):
        tt._feature_cache = torch.from_numpy(feats(b[0]))
        return np.arange(B), torch.from_numpy(b[0]), torch.from_numpy(b[1])

    _hold("mlp", {
        "jax": jt, "port": tt, "params": jt.params, "stats": {},
        "opt_state": jt.opt_state,
        "grad": lambda p, st, b: grad(p, b[0], b[1], feats(b[0])) + ({},),
        "apply": lambda g, s, p, step: apply(g, s, p),
        "adam": lambda s: (s[1][0], lr),
        "inner": lambda t: t["params"],
        "batch": batch, "set_lr": lambda step: None,
        "set_epoch": lambda step: None}, _batches(32, 1))


def _small_vit(make):
    def create_model(model_type="mlp", **kwargs):
        if model_type == "vit":
            return make(**kwargs)
        return create_model.real(model_type, **kwargs)
    return create_model


ZOO = {"resnet": ("resnet", 32), "vit": ("vit", 32),
       "efficientnet_b0": ("efficientnet", 64)}


@pytest.mark.parametrize("net", sorted(ZOO))
def test_zoo_trainer_steps_match_jax(no_dropout, monkeypatch, net):
    model_type, size = ZOO[net]
    jcreate, tcreate = (_small_vit(lambda **k: jzoo.ViTParameterPredictor(
        **VIT)), _small_vit(lambda **k: tzoo.ViTParameterPredictor(**VIT, **k)))
    jcreate.real, tcreate.real = jzoo.create_model, tzoo.create_model
    monkeypatch.setattr(jzoo, "create_model", jcreate)
    monkeypatch.setattr(tzoo, "create_model", tcreate)
    tt = ttrainer.ZooTrainer(model_type, image_size=size, pretrained=None,
                             device="cpu")
    if model_type == "efficientnet":
        # a Flax init of EfficientNet takes tens of seconds on the CPU:
        # JAX's trainer starts from a seeded tree (its shapes JAX's)
        tree = seeded_tree(bridge, tt.model, 5)
        monkeypatch.setattr(jzoo.EfficientNetParameterPredictor, "init",
                            lambda self, rng, x: jax.tree_util.tree_map(
                                jnp.asarray, tree))
    jt = jtrainer.ZooTrainer(model_type, image_size=size, pretrained=None)
    key = jax.random.PRNGKey(0)
    lr = tt.optimizer.param_groups[0]["lr"]

    @jax.jit
    def grad(p, st, imgs, refs):
        (loss, new), g = jax.value_and_grad(jt._loss_fn, has_aux=True)(
            p, st, imgs, refs, key, True)
        return loss, g, new

    @jax.jit
    def apply(g, s, p):
        upd, s = jt.tx.update(g, s, p)
        return optax.apply_updates(p, upd), s

    def oracle(idx, imgs, refs):
        """The port's gradient in f64 (the trainer's model and constants
        cast; the composite and the loss follow the images' dtype)."""
        m = tt.model.double().train()
        mean, inv = tt._mean, tt._inv_std
        tt._mean, tt._inv_std = mean.double(), inv.double()
        try:
            m.zero_grad(set_to_none=True)
            tt._loss_fn(idx, imgs.double(), refs.double(), True).backward()
            return {k: v.astype(np.float64) for k, v in _port_grads(tt).items()}
        finally:
            m.float()
            tt._mean, tt._inv_std = mean, inv

    _hold(net, {
        "jax": jt, "port": tt, "params": jt.params, "stats": jt.batch_stats,
        "oracle": oracle,
        "opt_state": jt.opt_state,
        "grad": lambda p, st, b: grad(p, st, b[0], b[1]),
        "apply": lambda g, s, p, step: apply(g, s, p),
        "adam": lambda s: (s[1][0], lr),
        "inner": lambda t: t,
        "batch": lambda b: (None, torch.from_numpy(b[0]),
                            torch.from_numpy(b[1])),
        "set_lr": lambda step: None, "set_epoch": lambda step: None},
        _batches(size, 2))


def test_vgg_trainer_steps_match_jax(no_dropout):
    with pytest.warns(UserWarning, match="RANDOM-init"):
        jt = jtrainer.VGGTrainer(hidden_dim=16, image_size=32, epochs=40,
                                 compute_dtype="float32",
                                 pretrained_vgg=None)
    trunk = bridge.load_flax(VGGFeatures(depth=7), _np(jt.vgg_loss_params))
    tt = ttrainer.VGGTrainer(hidden_dim=16, image_size=32, epochs=40,
                             compute_dtype="float32", pretrained_vgg=None,
                             vgg_loss_params=trunk, device="cpu")
    key = jax.random.PRNGKey(0)

    @jax.jit
    def grad(p, st, imgs, refs):
        feats = extract_basic_batch(imgs)
        (loss, (_, new)), g = jax.value_and_grad(jt._forward, has_aux=True)(
            p, st, imgs, feats, refs, key, True)
        return loss, g, new

    @jax.jit
    def apply(g, s, p, epoch):
        s = jt._set_lr(s, jt.schedule(epoch))
        upd, s = jt.tx.update(g, s, p)
        return optax.apply_updates(p, upd), s

    def set_lr(step):
        for g in tt.optimizer.param_groups:
            g["lr"] = tt.schedule(step - 1)

    frozen = {f"vgg/conv{i}/{leaf}" for i in range(8)
              for leaf in ("kernel", "bias")}
    _hold("vgg", {
        "jax": jt, "port": tt, "params": jt.params, "stats": jt.batch_stats,
        "opt_state": jt.opt_state, "frozen": frozen,
        "grad": lambda p, st, b: grad(p, st, b[0], b[1]),
        "apply": lambda g, s, p, step: apply(g, s, p, jnp.int32(step - 1)),
        "adam": lambda s: (s[2].inner_state.inner_state[0],
                           s[2].inner_state.hyperparams["learning_rate"]),
        "inner": lambda t: t,
        "batch": lambda b: (None, torch.from_numpy(b[0]),
                            torch.from_numpy(b[1])),
        "set_lr": set_lr,
        "set_epoch": lambda step: setattr(tt, "_epoch_count", step - 1)},
        _batches(32, 3))
