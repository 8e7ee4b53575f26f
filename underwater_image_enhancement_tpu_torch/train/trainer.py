"""Training loops (the JAX package's ``train/trainer.py``).

- ``MLPTrainer`` == EndToEndTrainer (deep_learning_parameters.py:253-459):
  ParameterPredictor on the 79 features -> enhance_mlp -> ReferenceLoss,
  Adam 1e-4, grad-clip 1.0, 80/20 split, best-model checkpointing,
  training_history.json.
- ``ZooTrainer``: the ResNet18, EfficientNet b0/b3 and ViT-B/16
  predictors -> enhance_zoo -> ReferenceLoss, Adam 1e-4, grad-clip 1.0.
- ``VGGTrainer`` == ImprovedTrainer (vgg_16_UIE.py:481-615):
  ImprovedVGGParameterNet (bf16 compute by default) -> enhance_vgg ->
  CombinedLoss, AdamW 1e-5 / wd 1e-5 over the trainable parameters (the
  first 8 VGG convs frozen: no gradient, not in the optimiser, not in the
  clip's norm), cosine warm restarts (T_0=10 epochs, T_mult=2, stepped
  per epoch), grad-clip 1.0, best + every-10-epoch checkpoints, early
  stop patience 15, resume.

Each step is eager PyTorch on the trainer's device (``cuda`` unless asked
otherwise; without a card it raises, and nothing moves to the CPU).  The
trainers take JAX's ``mesh=`` (None, a count or a ``parallel/mesh.Mesh``
whose first position is the trainer's device; positions may repeat a
device).  On more than one position a step cuts the batch into equal row
blocks in mesh order (a batch that does not divide raises, as JAX's
sharded ``device_put`` does) and runs each block's forward on its
position's device, on a thread a position (``layers.MeshThreads``):
BatchNorm in train mode takes the statistics of the whole batch, every
position's sums added in mesh order at each call, as Flax's BatchNorm does
under JAX's sharded step, and the first position moves the running ones.
Each position gives its loss as sums (``_sums``: for ``reference_loss``
``|d|`` and ``d^2``, for ``combined_loss`` also the perceptual features'
squared difference); the sums are added in mesh order on the first
position (``_mesh_sum``, ``parallel/spatial._psum``'s order) and divided
by the batch's counts (``_loss_of``), then one backward, each distinct
replica's gradients added onto the model's in mesh order, one clip and
one optimiser step.  A device other than the first holds a replica of the
model (and of the VGG's perceptual trunk), copied from the first after
each step.  Dropout draws the whole batch's masks from the trainer's
generator and gives each block its rows (``layers.BatchMasks``).
Arithmetic follows the jitted JAX step where it moves the numbers:
Flax's BatchNorm and dropout (``models/layers``), optax's
``clip_by_global_norm`` (the gradients divided by their global norm where
it is at least 1; jitted XLA keeps the division), Adam/AdamW with optax's
hyperparameters, the learning rate of ``cosine_warm_restarts`` in f32 as
jitted optax computes it.  f32 steps run under ``layers.no_tf32`` (the
backward too).  The random initialisation is Flax's distributions drawn
from ``torch.Generator().manual_seed(seed)``, not Flax's numbers; dropout
masks come from a generator on the device seeded the same way.

Checkpoints are the port's ``.npz`` (``models/bridge``): ``params``,
``batch_stats``, ``opt_state`` (optax's Adam state, ``bridge.
optax_adam_state``) and the loss histories.  ``final_model.npz`` is what
``EnhancementPredictor`` and ``ZooPredictor`` (``cli enhance --model``)
read.
"""

from __future__ import annotations

import copy
import json
import math
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.features.basic import (
    extract_basic_batch,
)
from underwater_image_enhancement_tpu_torch.models import (
    bridge,
    diff_enhance,
    layers,
    losses,
)
from underwater_image_enhancement_tpu_torch.models.mlp import (
    ParameterPredictor,
)
from underwater_image_enhancement_tpu_torch.models.vgg import (
    IMAGENET_INV_STD,
    IMAGENET_MEAN,
    ImprovedVGGParameterNet,
)
from underwater_image_enhancement_tpu_torch.parallel import mesh as pmesh
from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
    resolve_device,
)


def cosine_warm_restarts(base_lr: float, t0: int, t_mult: int,
                         max_epochs: int) -> Callable[[int], float]:
    """CosineAnnealingWarmRestarts(T_0, T_mult), one step per EPOCH: an
    epoch -> learning rate function, optax's ``join_schedules`` of
    ``cosine_decay_schedule``s computed in f32 as the jitted JAX step
    computes it (``cos(c * f32(pi / t))``, XLA's folded argument)."""
    periods = []  # (first epoch, length)
    t, total = t0, 0
    while total < max_epochs:
        periods.append((total, t))
        total += t
        t *= t_mult

    def schedule(epoch: int) -> float:
        start, t = periods[0]
        for first, length in periods[1:]:
            if int(epoch) >= first:
                start, t = first, length
        c = np.float32(min(int(epoch) - start, t))
        x = np.float32(c * np.float32(math.pi / t))
        decay = np.float32(0.5) * (np.float32(1.0)
                                   + np.float32(math.cos(float(x))))
        return float(np.float32(base_lr) * decay)

    return schedule


def _npz(path: Union[str, Path]) -> Path:
    p = Path(path)
    return p if p.suffix == ".npz" else p.with_name(p.name + ".npz")


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write a trainer's payload (nested dicts of arrays) as the port's
    ``.npz`` (``bridge.save_npz``); ``.npz`` is added to a path without
    it."""
    p = _npz(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    bridge.save_npz(str(p), payload)


def restore_checkpoint(path: str, like: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    """Read a checkpoint of ``save_checkpoint`` (``.npz`` added where the
    path lacks it) as nested dicts of numpy arrays.  ``like``: a payload
    of the kind it should hold; a top-level key of it that the file lacks
    raises ValueError (an empty collection has nothing to lack)."""
    tree = bridge.load_npz(str(_npz(path)))
    if like is not None:
        missing = sorted(k for k, v in like.items()
                         if k not in tree and not (isinstance(v, dict)
                                                   and not v))
        if missing:
            raise ValueError(f"{path}: the checkpoint lacks {missing}")
    return tree


def clip_by_global_norm(params, max_norm: float = 1.0) -> None:
    """optax's ``clip_by_global_norm`` on the gradients of ``params``, in
    place and on their device: ``g / norm`` where the global norm is at
    least ``max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def _tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device, non_blocking=True)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _mesh_sum(parts):
    """((p0 + p1) + p2) + ... on the first part's device: the positions'
    partials in mesh order (``parallel/spatial._psum``'s order).  None
    where every part is None (a parameter no position's loss reaches)."""
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    return acc


class _BaseTrainer:
    """Shared epoch/checkpoint/early-stop machinery."""

    def __init__(self):
        self.train_losses: list = []
        self.val_losses: list = []
        self.mesh = None
        self._replicas: Dict[torch.device, torch.nn.Module] = {}

    def _setup(self, model: torch.nn.Module, seed: int,
               device: Union[str, torch.device]) -> None:
        """Flax's initialisers from ``seed``, the model on the device, and
        the dropout generator there."""
        self.device = resolve_device(device)
        bridge.flax_default_init(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._inv_std = torch.from_numpy(IMAGENET_INV_STD).to(self.device)

    def _set_mesh(self, mesh) -> None:
        """``maybe_mesh(mesh)`` on the trainer's device kind (a count is
        that many positions); its first position must be the trainer's
        device."""
        self.mesh = pmesh.maybe_mesh(mesh, self.device)
        if self.mesh is None:
            return
        home = pmesh._indexed(self.device)
        if self.mesh.devices[0] != home:
            raise ValueError(f"the mesh's first position {self.mesh.devices[0]}"
                             f" is not the trainer's device {home}")
        if self.sharded:
            self._threads = layers.MeshThreads(self.mesh.size)

    @property
    def sharded(self) -> bool:
        """A mesh of more than one position (one runs as mesh None)."""
        return self.mesh is not None and self.mesh.size > 1

    def _replica(self, dev: torch.device) -> torch.nn.Module:
        """The model on a position's device: the model itself on the
        trainer's device, else a copy kept there."""
        if dev == pmesh._indexed(self.device):
            return self.model
        if dev not in self._replicas:
            r = copy.deepcopy(self.model).to(dev)
            for p in r.parameters():
                p.grad = None
            self._replicas[dev] = r
        return self._replicas[dev]

    def _sync_replicas(self) -> None:
        """Each replica's parameters and buffers copied from the model."""
        with torch.no_grad():
            for r in self._replicas.values():
                for a, b in zip(r.parameters(), self.model.parameters()):
                    a.copy_(b)
                for a, b in zip(r.buffers(), self.model.buffers()):
                    a.copy_(b)

    LOSS_WEIGHTS = (0.5, 0.5)  # reference_loss: L1 and L2

    def _sums(self, model, idx, imgs, refs, generator):
        """A block's loss as sums and the element counts they divide by:
        ``reference_loss``'s sums of ``|d|`` and ``d^2``."""
        d = self._enhance(model, idx, imgs, generator) - refs
        return torch.stack([d.abs().sum(), d.square().sum()]), (d.numel(),) * 2

    def _loss_of(self, sums: torch.Tensor, counts) -> torch.Tensor:
        """The loss from the batch's sums: each mean weighted, added left
        to right as the loss function adds its terms."""
        return sum(w * (sums[i] / n) for i, (w, n) in
                   enumerate(zip(self.LOSS_WEIGHTS, counts)))

    def _mesh_loss(self, idx, imgs, refs, train: bool) -> torch.Tensor:
        """The loss of a batch over the mesh (module docstring); with
        ``train`` its gradient is left in the model's ``.grad`` of the
        parameters that take one."""
        place = pmesh.data_parallel_sharding(self.mesh)(imgs)
        if isinstance(idx, (list, tuple)):
            idx = np.asarray(idx)
        masks = layers.BatchMasks(self._gen, imgs.shape[0]) if train else None
        models = [self._replica(dev) for dev, _ in place]
        for m in {id(m): m for m in models}.values():
            m.train(train)

        def work(k):
            (dev, rows), model = place[k], models[k]
            return lambda: self._sums(
                model, None if idx is None else idx[rows], imgs[rows].to(dev),
                refs[rows].to(dev), masks and masks.block(rows))

        parts = self._threads.run([work(k) for k in range(len(place))])
        counts = [sum(c) for c in zip(*(c for _, c in parts))]
        loss = self._loss_of(_mesh_sum([s for s, _ in parts]), counts)
        if train:
            loss.backward()
            replicas = [self._replicas[d] for d in dict.fromkeys(
                dev for dev, _ in place) if d in self._replicas]
            if replicas:
                held = [[p for p in m.parameters() if p.requires_grad]
                        for m in [self.model] + replicas]
                for ps in zip(*held):
                    ps[0].grad = _mesh_sum([p.grad for p in ps])
                for r in replicas:
                    r.zero_grad(set_to_none=True)
        return loss.detach()

    @property
    def trainable(self) -> list:
        return [p for p in self.model.parameters() if p.requires_grad]

    def _update(self, loss: torch.Tensor) -> torch.Tensor:
        """Backward, then ``_apply_gradients``; the loss detached."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self._apply_gradients()
        return loss.detach()

    def _apply_gradients(self) -> None:
        """The clip, then the optimiser's step, on the gradients held."""
        clip_by_global_norm(self.trainable, 1.0)
        self.optimizer.step()

    def fit(self, train_batches_fn, val_batches_fn, epochs: int,
            output_folder: str, patience: int = 15,
            checkpoint_every: int = 10, log=print) -> Dict[str, list]:
        """Reference loop shape (vgg_16_UIE.py:728-772): per epoch train +
        validate, lr schedule per epoch, best/periodic ckpt, early stop."""
        out = Path(output_folder)
        out.mkdir(parents=True, exist_ok=True)
        best = float("inf")
        bad_epochs = 0
        try:
            for epoch in range(self.start_epoch, epochs):
                tr = self.run_epoch(train_batches_fn(), train=True)
                va = self.run_epoch(val_batches_fn(), train=False)
                self.train_losses.append(tr)
                self.val_losses.append(va)
                self.epoch_hook(epoch)
                log(f"epoch {epoch + 1}/{epochs}: train {tr:.6f} val {va:.6f}")
                if va < best:
                    best = va
                    bad_epochs = 0
                    self.save(str(out / "best_model"))
                else:
                    bad_epochs += 1
                if (epoch + 1) % checkpoint_every == 0:
                    self.save(str(out / f"checkpoint_epoch_{epoch + 1}"))
                if bad_epochs >= patience:
                    log(f"early stopping at epoch {epoch + 1}")
                    break
        except KeyboardInterrupt:
            # interrupt checkpoint (vgg_16_UIE.py:796-799)
            log("interrupted — saving checkpoint")
            self.save(str(out / "interrupted_checkpoint"))
            raise
        except Exception as e:  # OOM advice (vgg_16_UIE.py:778-786)
            if "out of memory" in str(e).lower():
                log("out of device memory — reduce batch size or image "
                    "resolution; saving checkpoint")
                self.save(str(out / "oom_checkpoint"))
            raise
        self.save(str(out / "final_model"))
        history = {"train_loss": self.train_losses, "val_loss": self.val_losses}
        with open(out / "training_history.json", "w") as f:
            json.dump(history, f, indent=2)
        return history

    def epoch_hook(self, epoch: int) -> None:
        pass

    @property
    def start_epoch(self) -> int:
        return len(self.train_losses)

    def run_epoch(self, batches: Iterable, train: bool) -> float:
        """The mean loss of the epoch's batches; with ``train`` a step on
        each.  A batch is (imgs, refs) or (dataset indices, imgs, refs),
        numpy arrays or tensors."""
        found = []
        for item in batches:
            idx, imgs, refs = item if len(item) == 3 else (None,) + tuple(item)
            imgs, refs = _tensor(imgs, self.device), _tensor(refs, self.device)
            if train:
                found.append(self._step(idx, imgs, refs))
            else:
                found.append(self._eval(idx, imgs, refs))
        losses_ = torch.stack(found).tolist() if found else []
        return sum(losses_) / max(len(losses_), 1)

    def _step(self, idx, imgs, refs) -> torch.Tensor:
        with layers.no_tf32():
            if not self.sharded:
                self.model.train()
                return self._update(self._loss_fn(idx, imgs, refs, True))
            self.optimizer.zero_grad(set_to_none=True)
            loss = self._mesh_loss(idx, imgs, refs, True)
            self._apply_gradients()
            self._sync_replicas()
            return loss

    def _eval(self, idx, imgs, refs) -> torch.Tensor:
        with torch.no_grad(), layers.no_tf32():
            if self.sharded:
                return self._mesh_loss(idx, imgs, refs, False)
            self.model.eval()
            return self._loss_fn(idx, imgs, refs, False)

    def _backbone_input(self, imgs: torch.Tensor) -> torch.Tensor:
        """ImageNet-normalise the backbone branch (the predictors'
        preprocess); raw [0, 1] when opted out.  The enhancement and the
        loss consume the raw images."""
        if not self.imagenet_normalize:
            return imgs
        return ((imgs - self._mean.to(imgs.device))
                * self._inv_std.to(imgs.device))

    def _payload(self) -> Dict[str, Any]:
        return {**bridge.to_flax(self.model),
                "opt_state": bridge.optax_adam_state(self.model,
                                                     self.optimizer),
                "train_losses": np.asarray(self.train_losses, np.float64),
                "val_losses": np.asarray(self.val_losses, np.float64)}

    def save(self, path: str) -> None:
        save_checkpoint(path, self._payload())

    def load(self, path: str) -> None:
        restored = restore_checkpoint(path, self._payload())
        bridge.load_flax(self.model, {k: restored[k] for k in
                                      ("params", "batch_stats")
                                      if k in restored})
        bridge.load_optax_adam(self.model, self.optimizer,
                               restored["opt_state"])
        self.train_losses = [float(v) for v in restored["train_losses"]]
        self.val_losses = [float(v) for v in restored["val_losses"]]
        self._sync_replicas()


class MLPTrainer(_BaseTrainer):
    """EndToEndTrainer equivalent (deep_learning_parameters.py:253-349)."""

    def __init__(self, feature_dim: int = 79, hidden_dim: int = 256,
                 num_blocks: int = 3, lr: float = 1e-4, seed: int = 0,
                 mesh=None, stretch_mode: str = "quantile",
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self._setup(ParameterPredictor(feature_dim, hidden_dim, num_blocks),
                    seed, device)
        self._set_mesh(mesh)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr)
        self.stretch_mode = stretch_mode
        self._feature_cache = None  # set by cache_features()

    def _loss_fn(self, idx, imgs, refs, train: bool,
                 feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The loss of a batch: the features from the cache where the
        batch carries dataset indices, else extracted (or given)."""
        enhanced = self._enhance(self.model, idx, imgs,
                                 self._gen if train else None, feats)
        return losses.reference_loss(enhanced, refs)[0]

    def _enhance(self, model, idx, imgs, generator,
                 feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``model``'s enhancement of a batch on its device, the features
        gathered from the cache by the batch's indices where it has them."""
        if feats is None:
            if idx is not None and self._feature_cache is not None:
                feats = self._feature_cache[_tensor(idx, self.device)].to(
                    imgs.device)
            else:
                feats = self._features(imgs)
        pred = model(feats, generator=generator)
        return diff_enhance.enhance_mlp(imgs, pred,
                                        stretch_mode=self.stretch_mode)

    def _features(self, imgs: torch.Tensor) -> torch.Tensor:
        from underwater_image_enhancement_tpu_torch.features.full import (
            extract_batch,
        )

        return extract_batch(imgs)

    def cache_features(self, dataset, batch_size: int = 32,
                       log=print) -> None:
        """One 79-feature extraction pass over the whole dataset on the
        device, cached per index (the reference re-extracts per item per
        epoch, deep_learning_parameters.py:234).  Features are of the
        un-augmented images; run_epoch reads them for batches that carry
        dataset indices (``PairedImageDataset.batches(with_indices=True)``).
        """
        was_aug = getattr(dataset, "augment", False)
        dataset.augment = False
        try:
            chunks = []
            n = len(dataset)
            for s in range(0, n, batch_size):
                imgs = np.stack([dataset.load_pair(i)[0]
                                 for i in range(s, min(s + batch_size, n))])
                chunks.append(self._features(_tensor(imgs, self.device)))
            self._feature_cache = torch.cat(chunks)
            log(f"cached features for {n} images")
        finally:
            dataset.augment = was_aug

    def predict_params(self, feats) -> Dict[str, torch.Tensor]:
        with torch.no_grad(), layers.no_tf32():
            self.model.eval()
            return self.model(_tensor(feats, self.device))


class ZooTrainer(_BaseTrainer):
    """End-to-end trainer for the model_architectures.py backbones
    (resnet, efficientnet b0/b3, vit): image -> the six parameters ->
    ``enhance_zoo`` -> ReferenceLoss against the reference image.
    ``pretrained`` loads a converted torchvision ``.npz`` backbone
    (``models/zoo.load_{resnet18,efficientnet,vit}_npz``); "auto" finds the
    conventional artifact (``utils/weights.find_zoo_npz``) and else starts
    from the seeded init.  The backbone input is ImageNet-normalised
    unless ``imagenet_normalize`` is False.  On a mesh, BatchNorm
    (ResNet18, EfficientNet) trains on the whole batch's statistics."""

    def __init__(self, model_type: str = "resnet", lr: float = 1e-4,
                 seed: int = 0, mesh=None, image_size: int = 224,
                 stretch_mode: str = "quantile",
                 pretrained: Optional[str] = "auto", variant: str = "b0",
                 imagenet_normalize: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        from underwater_image_enhancement_tpu_torch.models import zoo

        self.model_type = model_type
        self.variant = variant
        self.imagenet_normalize = imagenet_normalize
        kwargs = ({"variant": variant} if model_type == "efficientnet" else
                  {"image_size": image_size} if model_type == "vit" else {})
        model = zoo.create_model(model_type, **kwargs)
        if pretrained == "auto":
            from underwater_image_enhancement_tpu_torch.utils.weights import (
                find_zoo_npz,
            )

            pretrained = (find_zoo_npz(model_type, variant)
                          if model_type in ("resnet", "efficientnet", "vit")
                          else None)
        self._setup(model, seed, device)
        self._set_mesh(mesh)
        if pretrained is not None:
            if model_type == "resnet":
                zoo.load_resnet18_npz(self.model, pretrained)
            elif model_type == "efficientnet":
                zoo.load_efficientnet_npz(self.model, pretrained, variant)
            elif model_type == "vit":
                zoo.load_vit_npz(self.model, pretrained)
            else:
                raise ValueError(
                    "pretrained import exists for the resnet18/efficientnet/"
                    "vit backbones (model_architectures.py:13,83,131)")
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr)
        self.stretch_mode = stretch_mode

    def _loss_fn(self, idx, imgs, refs, train: bool) -> torch.Tensor:
        enhanced = self._enhance(self.model, idx, imgs,
                                 self._gen if train else None)
        return losses.reference_loss(enhanced, refs)[0]

    def _enhance(self, model, idx, imgs, generator) -> torch.Tensor:
        """``model``'s enhancement of a batch on its device."""
        del idx
        pred = model(self._backbone_input(imgs), generator=generator)
        return diff_enhance.enhance_zoo(imgs, pred,
                                        stretch_mode=self.stretch_mode)

    def predict_params(self, imgs) -> Dict[str, torch.Tensor]:
        with torch.no_grad(), layers.no_tf32():
            self.model.eval()
            return self.model(self._backbone_input(_tensor(imgs,
                                                           self.device)))


class VGGTrainer(_BaseTrainer):
    """ImprovedTrainer equivalent (vgg_16_UIE.py:481-615)."""

    FROZEN_CONVS = 8  # first 16 conv param tensors = 8 (kernel, bias) pairs

    def __init__(self, hidden_dim: int = 256, lr: float = 1e-5,
                 weight_decay: float = 1e-5, epochs: int = 100,
                 image_size: int = 224, seed: int = 0, mesh=None,
                 compute_dtype: str = "bfloat16",
                 stretch_mode: str = "quantile",
                 vgg_loss_params=None, pretrained_vgg: Optional[str] = "auto",
                 imagenet_normalize: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        # the backbone input is ImageNet-normalised, as the predictor's
        # (use_trained_model.py:39-46); the reference trains on raw [0, 1]
        # images (vgg_16_UIE.py:327-330 is dead code), which
        # imagenet_normalize=False reproduces
        self.imagenet_normalize = imagenet_normalize
        # bf16 compute by default (the reference's AMP autocast,
        # vgg_16_UIE.py:504); parameters, the heads, the enhancement and
        # the loss's reductions stay f32
        self.compute_dtype = (torch.bfloat16 if compute_dtype == "bfloat16"
                              else torch.float32)
        self._setup(ImprovedVGGParameterNet(hidden_dim=hidden_dim,
                                            dtype=self.compute_dtype),
                    seed, device)
        self._set_mesh(mesh)
        if pretrained_vgg == "auto":
            from underwater_image_enhancement_tpu_torch.utils.weights import (
                find_vgg16_npz,
            )

            pretrained_vgg = find_vgg16_npz()
        if pretrained_vgg is not None:
            # ImageNet VGG16 for the backbone trunk (vgg_16_UIE.py:149-154)
            # and the perceptual loss (:257-269), from convert-vgg's .npz
            from underwater_image_enhancement_tpu_torch.models.vgg import (
                load_backbone_npz,
                load_perceptual_npz,
            )

            load_backbone_npz(self.model, pretrained_vgg)
            if vgg_loss_params is None:
                vgg_loss_params = load_perceptual_npz(pretrained_vgg)
        if vgg_loss_params is None:
            warnings.warn(
                "VGGTrainer: perceptual loss uses a RANDOM-init VGG trunk; "
                "pass vgg_loss_params=load_perceptual_npz(path) for the "
                "reference's pretrained-VGG16 perceptual loss",
                stacklevel=2,
            )
            vgg_loss_params = losses.init_perceptual_params(
                seed + 1, (1, image_size, image_size, 3))
        self.vgg_loss_params = vgg_loss_params.requires_grad_(False).to(
            self.device)
        self._trunks: Dict[torch.device, torch.nn.Module] = {}
        self.schedule = cosine_warm_restarts(lr, 10, 2, epochs)
        self._epoch_count = 0
        # frozen convs take no gradient, so the clip's norm and AdamW see
        # the trainable parameters only (vgg_16_UIE.py:492-534)
        for i in range(self.FROZEN_CONVS):
            getattr(self.model.vgg, f"conv{i}").requires_grad_(False)
        self.optimizer = torch.optim.AdamW(self.trainable, lr=lr,
                                           weight_decay=weight_decay)
        self.stretch_mode = stretch_mode

    LOSS_WEIGHTS = (0.3, 0.5, 0.2)  # combined_loss: L1, L2, perceptual

    def _loss_fn(self, idx, imgs, refs, train: bool,
                 feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        enhanced = self._enhance(self.model, idx, imgs,
                                 self._gen if train else None, feats)
        return losses.combined_loss(self.vgg_loss_params, enhanced, refs,
                                    dtype=self.compute_dtype)[0]

    def _enhance(self, model, idx, imgs, generator,
                 feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``model``'s enhancement of a batch on its device, the basic
        features extracted from the batch unless given."""
        del idx
        if feats is None:
            feats = extract_basic_batch(imgs)
        x = self._backbone_input(imgs).to(self.compute_dtype)
        pred = model(x, feats, generator=generator)
        pred = {k: v.float() for k, v in pred.items()}
        return diff_enhance.enhance_vgg(imgs, pred,
                                        stretch_mode=self.stretch_mode)

    def _replica(self, dev: torch.device) -> torch.nn.Module:
        """The model on a position's device, and the perceptual trunk
        there too (a copy kept off the trainer's device, made here, before
        the positions' threads start; it takes no gradient)."""
        if (dev != pmesh._indexed(self.device)
                and dev not in self._trunks):
            self._trunks[dev] = copy.deepcopy(self.vgg_loss_params).to(dev)
        return super()._replica(dev)

    def _sums(self, model, idx, imgs, refs, generator):
        """``combined_loss`` as sums: ``|d|`` and ``d^2`` over the image
        elements, the squared difference of the trunk's relu3_3 features
        (``losses.perceptual_loss``'s) over theirs."""
        enhanced = self._enhance(model, idx, imgs, generator)
        d = enhanced - refs
        trunk = self._trunks.get(imgs.device, self.vgg_loss_params)
        dtype = self.compute_dtype
        f = (trunk(enhanced, dtype=dtype).float()
             - trunk(refs, dtype=dtype).float()).square()
        return (torch.stack([d.abs().sum(), d.square().sum(), f.sum()]),
                (d.numel(), d.numel(), f.numel()))

    def _step(self, idx, imgs, refs) -> torch.Tensor:
        # the epoch's learning rate (scheduler.step() per epoch,
        # vgg_16_UIE.py:499-501,749)
        lr = self.schedule(self._epoch_count)
        for g in self.optimizer.param_groups:
            g["lr"] = lr
        return super()._step(idx, imgs, refs)

    def epoch_hook(self, epoch: int) -> None:
        self._epoch_count = epoch + 1  # scheduler.step() per epoch

    def predict_params(self, imgs, feats=None) -> Dict[str, torch.Tensor]:
        """The heads on a [0, 1] batch (the features ``extract_basic_batch``
        of it unless given), as the training step sees them."""
        imgs = _tensor(imgs, self.device)
        if feats is None:
            feats = extract_basic_batch(imgs)
        with torch.no_grad(), layers.no_tf32():
            self.model.eval()
            x = self._backbone_input(imgs).to(self.compute_dtype)
            return {k: v.float() for k, v in
                    self.model(x, _tensor(feats, self.device)).items()}

    def load(self, path: str) -> None:
        super().load(path)
        # resume the per-epoch LR schedule where it left off (vgg:713-717)
        self._epoch_count = len(self.train_losses)
