"""What the port's trainers compute with, on the CPU, against the JAX
package: the losses (``models/losses``), the differentiable composites
(``diff_enhance.enhance_mlp``, and ``enhance_vgg``/``enhance_zoo`` in the
``quantile`` mode) forward and under autograd, Flax's BatchNorm in train
mode (``models/layers.BatchNorm``), the dropout, the optimiser-state
bridge and the learning-rate schedule.

Gates (each reading printed with ``-s``): ``reference_loss`` and
``combined_loss`` (the JAX perceptual trunk carried across) within 1e-6
relative of their f64 value and within 1e-4 of jitted JAX's (XLA:CPU
sums a loss of 12288 values or fewer in one sequential f32 pass: 6.7e-5
relative off the f64 value on this u8-grid batch; the port's
``torch.mean`` is within 1e-7 of it; the mean's gradient, 1/n, is the
same in both); the composites within 1e-6 of the jitted JAX functions
and their gradients with respect to every parameter within 5e-5
relative of ``jax.grad`` (of a sum weighted by positive weights; each
per-image gradient is a sum of H*W*C terms, which XLA:CPU adds in one
sequential f32 pass: JAX's lie up to 1.5e-5 and the port's up to 1.8e-5
from the f64 gradient, printed beside; the ``index`` mode gives L_low
and L_high none in either); the perceptual
loss's gradient with respect to the image within 1e-4 relative (seven
convs' backward, each summed in another order); BatchNorm's output and
running statistics within 1e-6 of ``flax.linen.BatchNorm`` on (B, C)
rows and NCHW maps; the schedule within 1e-7 relative of jitted optax at
every epoch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from underwater_image_enhancement_tpu.models import diff_enhance as jde
from underwater_image_enhancement_tpu.models import losses as jlosses
from underwater_image_enhancement_tpu.models import mlp as jmlp
from underwater_image_enhancement_tpu.train import trainer as jtrainer
from underwater_image_enhancement_tpu_torch.models import bridge
from underwater_image_enhancement_tpu_torch.models import diff_enhance as tde
from underwater_image_enhancement_tpu_torch.models import layers
from underwater_image_enhancement_tpu_torch.models import losses as tlosses
from underwater_image_enhancement_tpu_torch.models import mlp as tmlp
from underwater_image_enhancement_tpu_torch.models.vgg import VGGFeatures
from underwater_image_enhancement_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

B, S = 4, 32


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def batch():
    """(imgs, refs) on the u8 grid, as the datasets give them."""
    rng = np.random.default_rng(7)
    imgs = np.floor(rng.random((B, S, S, 3)) * 255.0) / 255.0
    refs = np.floor(np.clip(imgs ** 0.8 + rng.normal(0, 0.02, imgs.shape),
                            0, 1) * 255.0) / 255.0
    return imgs.astype(np.float32), refs.astype(np.float32)


@pytest.fixture(scope="module")
def perceptual():
    """JAX's seeded perceptual trunk and the port's with it carried
    across."""
    jparams = jlosses.init_perceptual_params(jax.random.PRNGKey(3),
                                             (1, S, S, 3))
    trunk = bridge.load_flax(VGGFeatures(depth=7),
                             jax.tree_util.tree_map(np.asarray, jparams))
    return jparams, trunk.requires_grad_(False)


def _f64_parts(imgs, refs):
    d = imgs.astype(np.float64) - refs
    return np.abs(d).mean(), (d * d).mean()


def test_reference_loss_matches_f64_and_jax(batch):
    imgs, refs = batch
    jt, jc = jax.jit(jlosses.reference_loss)(imgs, refs)
    tt, tc = tlosses.reference_loss(torch.from_numpy(imgs),
                                    torch.from_numpy(refs))
    l1, l2 = _f64_parts(imgs, refs)
    d64 = max(_rel(tc["l1"], l1), _rel(tc["l2"], l2),
              _rel(tt, 0.5 * l1 + 0.5 * l2))
    d = max(_rel(tt, jt), _rel(tc["l1"], jc["l1"]), _rel(tc["l2"], jc["l2"]))
    print(f"reference_loss rel to f64 {d64:.3g}, to jitted JAX {d:.3g} "
          f"(JAX's to f64 {_rel(jc['l1'], l1):.3g})")
    assert d64 <= 1e-6 and d <= 1e-4


def test_combined_loss_matches_jax(batch, perceptual):
    imgs, refs = batch
    jparams, trunk = perceptual
    jt, jc = jax.jit(jlosses.combined_loss)(jparams, imgs, refs)
    tt, tc = tlosses.combined_loss(trunk, torch.from_numpy(imgs),
                                   torch.from_numpy(refs))
    l1, l2 = _f64_parts(imgs, refs)
    d64 = max(_rel(tc["l1"], l1), _rel(tc["l2"], l2))
    d = max(_rel(tt, jt), *(_rel(tc[k], jc[k]) for k in jc))
    dp = _rel(tc["perceptual"], jc["perceptual"])
    # bf16 trunk: held to the port's own f32 loss within a measured bound
    bt, _ = tlosses.combined_loss(trunk, torch.from_numpy(imgs),
                                  torch.from_numpy(refs), dtype="bfloat16")
    jbt, _ = jlosses.combined_loss(jparams, imgs, refs, dtype=jnp.bfloat16)
    d16 = _rel(bt, tt)
    print(f"combined_loss rel to jitted JAX {d:.3g} (perceptual {dp:.3g}), "
          f"L1/L2 to f64 {d64:.3g}; bf16 vs f32 rel {d16:.3g} "
          f"(JAX's {_rel(jbt, jt):.3g})")
    assert d64 <= 1e-6 and dp <= 1e-6 and d <= 1e-4 and d16 <= 2e-2
    assert not any(p.requires_grad for p in trunk.parameters())


def test_perceptual_loss_gradient_reaches_the_image(batch, perceptual):
    imgs, refs = batch
    jparams, trunk = perceptual
    gj = jax.grad(lambda x: jlosses.perceptual_loss(jparams, x, refs))(imgs)
    x = torch.from_numpy(imgs).requires_grad_(True)
    tlosses.perceptual_loss(trunk, x, torch.from_numpy(refs)).backward()
    d = _rel(x.grad, gj)
    print(f"perceptual_loss d/dimage rel {d:.3g}")
    assert d <= 1e-4


def _params(kind: str, rng):
    """A batch of predicted parameters inside the predictors' ranges."""
    p = {"L_low": rng.uniform(2, 20, (B, 1)), "L_high": rng.uniform(60, 98, (B, 1)),
         "gamma": rng.uniform(1.0, 1.5, (B, 1))}
    if kind in ("vgg", "zoo"):
        p["omega"] = rng.uniform(0.3, 0.9, (B, 1))
    if kind in ("mlp", "zoo"):
        p["use_gamma"] = rng.uniform(0.1, 0.9, (B, 1))
    return {k: v.astype(np.float32) for k, v in p.items()}


COMPOSITES = {"mlp": (jde.enhance_mlp, tde.enhance_mlp),
              "vgg": (jde.enhance_vgg, tde.enhance_vgg),
              "zoo": (jde.enhance_zoo, tde.enhance_zoo)}


@pytest.mark.parametrize("mode", ["quantile", "index"])
@pytest.mark.parametrize("kind", sorted(COMPOSITES))
def test_composite_and_its_gradients_match_jax(batch, kind, mode):
    imgs, _ = batch
    jfn, tfn = COMPOSITES[kind]
    rng = np.random.default_rng(11)
    params = _params(kind, rng)
    w = rng.uniform(0.5, 1.5, imgs.shape).astype(np.float32)

    want = np.asarray(jfn(jnp.asarray(imgs), params, stretch_mode=mode))
    grads = jax.grad(lambda p: jnp.sum(jfn(jnp.asarray(imgs), p,
                                           stretch_mode=mode) * w))(params)
    def port(dtype):
        tp = {k: torch.from_numpy(v).to(dtype).requires_grad_(True)
              for k, v in params.items()}
        out = tfn(torch.from_numpy(imgs).to(dtype), tp, stretch_mode=mode)
        (out * torch.from_numpy(w).to(dtype)).sum().backward()
        return out.detach(), {k: t.grad for k, t in tp.items()}

    got, tgrads = port(torch.float32)
    _, oracle = port(torch.float64)
    d = float(np.abs(got.numpy() - want).max())
    rels, to64 = {}, {}
    for k, g in grads.items():
        g = np.asarray(g)
        tg = tgrads[k]
        if mode == "index" and k in ("L_low", "L_high"):
            # the order statistic's index is an integer: no gradient
            assert not g.any() and (tg is None or not tg.any()), k
            continue
        rels[k] = _rel(tg, g)
        to64[k] = (_rel(g, oracle[k]), _rel(tg, oracle[k]))
    print(f"{kind} {mode}: forward max |d| {d:.3g}; grad rel to JAX "
          + ", ".join(f"{k} {v:.3g}" for k, v in rels.items())
          + "; to the f64 gradient (JAX, port) "
          + ", ".join(f"{k} {a:.2g},{b:.2g}" for k, (a, b) in to64.items()))
    assert d <= 1e-6
    assert rels and max(rels.values()) <= 5e-5


def test_host_parameters_keep_the_host_path(batch):
    """Numbers and host arrays take the host path, bit-equal to tensors
    of the same values in the index modes."""
    imgs = torch.from_numpy(batch[0])
    params = _params("zoo", np.random.default_rng(2))
    for mode in ("index", "index-u8"):
        host = tde.enhance_zoo(imgs, params, stretch_mode=mode)
        dev = tde.enhance_zoo(imgs, {k: torch.from_numpy(v)
                                     for k, v in params.items()},
                              stretch_mode=mode)
        assert torch.equal(host, dev), mode


@pytest.mark.parametrize("maps", [False, True], ids=["rows", "nchw"])
def test_batch_norm_train_mode_matches_flax(maps):
    rng = np.random.default_rng(5)
    C = 6
    shape = (8, 5, 7, C) if maps else (8, C)
    x = (rng.normal(0.3, 2.0, shape)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.1, C).astype(np.float32)
    mean0 = rng.normal(0, 0.1, C).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    y, upd = bn.apply(variables, x, mutable=["batch_stats"])
    tbn = layers.BatchNorm(C)
    bridge.load_flax(tbn, variables)
    tbn.train()
    tx = torch.from_numpy(x)
    if maps:
        tx = tx.permute(0, 3, 1, 2)
    ty = tbn(tx)
    if maps:
        ty = ty.permute(0, 2, 3, 1)
    d = float(np.abs(ty.detach().numpy() - np.asarray(y)).max())
    dm = _rel(tbn.running_mean, upd["batch_stats"]["mean"])
    dv = _rel(tbn.running_var, upd["batch_stats"]["var"])
    print(f"BatchNorm train {'maps' if maps else 'rows'}: out {d:.3g}, "
          f"running mean rel {dm:.3g}, var rel {dv:.3g}")
    assert d <= 1e-6 and dm <= 1e-6 and dv <= 1e-6
    # under bf16 activations the statistics and the arithmetic stay f32
    yb = tbn(tx.to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16


def test_dropout_keeps_and_scales_from_its_generator():
    x = torch.ones(20000)
    a = layers.dropout(x, 0.3, True, torch.Generator().manual_seed(1))
    b = layers.dropout(x, 0.3, True, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    assert torch.equal(a[kept], torch.full_like(a[kept], 1.0 / 0.7))
    assert layers.dropout(x, 0.3, False) is x


def test_optax_adam_state_round_trips_through_the_bridge():
    """One optax Adam step's state into a torch Adam and back, leaf for
    leaf; the next steps of both then agree."""
    jm = jmlp.ParameterPredictor(79, 32, 1)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 79)))
    tx = optax.adam(1e-3)
    state = tx.init(params)
    rng = np.random.default_rng(0)
    g = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(0, 1, p.shape), jnp.float32), params)
    upd, state = tx.update(g, state, params)
    params = optax.apply_updates(params, upd)
    adam = state[0]

    tm = bridge.load_flax(tmlp.ParameterPredictor(79, 32, 1),
                          jax.tree_util.tree_map(np.asarray, params))
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    given = {"mu": jax.tree_util.tree_map(np.asarray, adam.mu["params"]),
             "nu": jax.tree_util.tree_map(np.asarray, adam.nu["params"]),
             "count": np.asarray(adam.count)}
    bridge.load_optax_adam(tm, opt, given)
    back = bridge.optax_adam_state(tm, opt)
    assert int(back["count"]) == 1
    assert back["learning_rate"] == np.float32(1e-3)
    for name in ("mu", "nu"):
        a, b = bridge.flatten(back[name]), bridge.flatten(given[name])
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a), name
    with pytest.raises(ValueError, match="missing"):
        bridge.load_optax_adam(tm, opt, {**given, "mu": {}})


def test_cosine_warm_restarts_matches_jitted_optax():
    for base, epochs in ((1e-5, 100), (1e-3, 40)):
        want = jax.jit(jtrainer.cosine_warm_restarts(base, 10, 2, epochs))
        got = ttrainer.cosine_warm_restarts(base, 10, 2, epochs)
        d = max(abs(got(e) / float(want(jnp.int32(e))) - 1)
                for e in range(epochs) if float(want(jnp.int32(e))) > 0)
        print(f"cosine_warm_restarts base {base}: rel {d:.3g}")
        assert d <= 1e-7
