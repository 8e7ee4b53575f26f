"""MLP strategy classifier on the device, the JAX package's
``select/mlp_classifier.py`` (``FlaxMLPClassifier``) in PyTorch.

The sklearn-like surface (fit / predict / predict_proba / classes_) lets
``SelfSupervisedSystem`` pickle and serve it beside the RF/GB/SVM
classifiers.  The network is Dense(h), ReLU, Dense(h), ReLU, Dense(C),
trained with full-batch ``torch.optim.Adam(lr)`` for ``epochs`` steps on
the mean softmax cross-entropy, as the JAX class trains with optax.

Its parameters live as a Flax-layout tree of numpy arrays (``_params``:
``{"params": {"Dense_0": {"kernel", "bias"}, ...}}``), so it pickles as
plain arrays, and a pickle of the JAX class whose ``_params`` is such a
tree maps onto this one (``select.system.load_model``).  ``models/bridge``
carries the tree into the torch network at each call.  The class keeps
the JAX name, which the port's API test requires.

The initial parameters are Flax's default distributions drawn from
``torch.Generator().manual_seed(seed)``; they cannot equal Flax's own, so
a test sets them from a Flax init through ``_init_params``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from underwater_image_enhancement_tpu_torch.models import bridge
from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
    resolve_device,
)


class _Net(nn.Module):
    def __init__(self, n_in: int, hidden: int, n_classes: int):
        super().__init__()
        self.Dense_0 = nn.Linear(n_in, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class FlaxMLPClassifier:
    def __init__(self, hidden_dim: int = 128, epochs: int = 200,
                 lr: float = 1e-3, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.hidden_dim = hidden_dim
        self.epochs = epochs
        self.lr = lr
        self.seed = seed
        self.device = str(device)
        self.classes_: np.ndarray = np.array([])
        self._params = None
        # a Flax variable tree to start fit from instead of a fresh draw
        self._init_params: Optional[dict] = None

    def __setstate__(self, state: dict) -> None:
        """A pickle of the JAX class has no device and no seam: they take
        their defaults (``select.system.load_model`` sets the device)."""
        self.__dict__.update({"device": "cuda", "_init_params": None,
                              **state})

    def _net(self, n_in: int, params: Optional[dict] = None) -> _Net:
        """The network on the classifier's device, from ``params`` (a Flax
        tree) or, without one, drawn from the seed."""
        net = _Net(n_in, self.hidden_dim, len(self.classes_))
        if params is None:
            bridge.flax_default_init(net,
                                     torch.Generator().manual_seed(self.seed))
        else:
            bridge.load_flax(net, params)
        return net.to(resolve_device(self.device))

    def _input(self, X) -> torch.Tensor:
        return torch.as_tensor(np.asarray(X, np.float32)).to(
            resolve_device(self.device))

    def fit(self, X: np.ndarray, y: np.ndarray) -> "FlaxMLPClassifier":
        self.classes_ = np.array(sorted(set(y)))
        idx = {c: i for i, c in enumerate(self.classes_)}
        x = self._input(X)
        labels = torch.as_tensor(np.array([idx[c] for c in y], np.int64),
                                 device=x.device)
        net = self._net(x.shape[1], self._init_params)
        opt = torch.optim.Adam(net.parameters(), lr=self.lr)
        for _ in range(self.epochs):
            opt.zero_grad()
            F.cross_entropy(net(x), labels).backward()
            opt.step()
        self._params = bridge.to_flax(net)  # numpy arrays: picklable
        return self

    @torch.no_grad()
    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        x = self._input(X)
        net = self._net(x.shape[1], self._params)
        return torch.softmax(net(x), dim=-1).cpu().numpy()

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]
