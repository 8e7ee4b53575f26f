"""The self-supervised strategy selector (main.py:28-456), the JAX
package's ``select/system.py``.

Phase 1 (build_dataset, main.py:63-218) labels every image of a folder
with the strategy whose output scores best: for each frame, the five
strategies (``pipeline/strategies.py``), their weighted quality totals
(``metrics/quality.py``), the 79 features (``features/full.py``) and the
argmax, all on the device; the host reads each batch back once (features,
scores and labels in one transfer, the winning images quantized to u8 in
another), writes the winners' PNGs, the CSV and ``dataset.pkl``.
``dataset.pkl`` holds the same pickled list of dicts as the JAX package's
(numpy features), so either package's Phase 2 reads either's file.  A
batch's rows spread over the system's data mesh (``_mesh``: every visible
card, or ``config.n_devices`` positions; ``parallel/mesh``), and
``label_batch_dp`` labels over a given mesh; both give the single call's
result.

Phase 2 (train_classifier, main.py:225-335) is host-side sklearn, as in
JAX: a stratified 80/20 split, StandardScaler, RandomForest,
GradientBoosting and SVC with config.py:100-119's settings, 5-fold CV, the
best by test accuracy pickled to ``trained_model.pkl``;
``include_mlp=True`` adds the MLP classifier on the system's device
(``select/mlp_classifier.py``).  sklearn and matplotlib are imported
inside the functions, so the module imports without them.  ``predict``
(main.py:398-434) takes the features on the system's device, then scales
and classifies on the host.  ``load_model`` reads pickles of either
package; of the JAX package's classes it maps only the MLP classifier
with a plain numpy parameter tree, and refuses any other with a clear
error.
"""

from __future__ import annotations

import csv
import pickle
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.features.full import (
    FEATURE_DIM,
    extract_all_features,
)
from underwater_image_enhancement_tpu_torch.ops.layout import stack_planes
from underwater_image_enhancement_tpu_torch.pipeline.enhance import (
    _input_device,
    _on_device,
    resolve_device,
    score_strategies,
    select_planes,
)
from underwater_image_enhancement_tpu_torch.pipeline.strategies import (  # noqa: F401 - the JAX module's names
    LABEL_ORDER,
    STRATEGY_DISPLAY,
    STRATEGY_FNS,
    STRATEGY_FNS_FAST_PLANES,
    STRATEGY_FNS_PLANES,
)
from underwater_image_enhancement_tpu_torch.select.mlp_classifier import (
    FlaxMLPClassifier,
)
from underwater_image_enhancement_tpu_torch.utils import io as uio
from underwater_image_enhancement_tpu_torch.utils.config import Config


def label_batch(imgs: torch.Tensor, weights, return_all: bool = False,
                fast: bool = False):
    """Phase-1 labeling of a same-shape (B, H, W, 3) batch on its device
    (main.py:116-146; the JAX ``_label_batch``) -> (features (B, 79),
    scores (B, 5), best (B,) int64, winners (B, H, W, 3)), or with
    ``return_all`` the (B, 5, H, W, 3) stack of every strategy's output
    in place of the winners.  ``weights``: a dict or (name, weight) pairs.
    ``fast`` labels with the throughput tier."""
    w = dict(weights)
    feats, scores, best, images = [], [], [], []
    for img in imgs:
        outs, s = score_strategies(img, w, fast)
        b = torch.argmax(s)
        feats.append(extract_all_features(img, fast))
        scores.append(s)
        best.append(b)
        images.append(torch.stack([stack_planes(o) for o in outs])
                      if return_all else select_planes(outs, b))
    return (torch.stack(feats), torch.stack(scores), torch.stack(best),
            torch.stack(images))


def label_batch_dp(imgs, weights, mesh, return_all: bool = False,
                   fast: bool = False):
    """``label_batch`` with the batch split over a data mesh
    (``parallel/mesh``): each position labels its rows on its device, and
    the four outputs are gathered on ``mesh.devices[0]``.  The batch must
    divide over the mesh (ValueError).  Every reduction of the program is
    per-image, so the result equals the single call.  Without a mesh: the
    single call on the input's device (a numpy batch: ``cuda``)."""
    from underwater_image_enhancement_tpu_torch.parallel.mesh import (
        gather_shards,
        shard_batch,
    )

    if mesh is None:
        return label_batch(_on_device(imgs, _input_device(imgs)), weights,
                           return_all, fast)
    if not isinstance(imgs, torch.Tensor):  # f32 on the host, then shards
        imgs = _on_device(imgs, torch.device("cpu"))
    return gather_shards([label_batch(x, weights, return_all, fast)
                          for x in shard_batch(imgs, mesh)], mesh)


@dataclass
class DatasetItem:
    filename: str
    features: np.ndarray
    best_strategy: str
    best_score: float
    all_scores: Dict[str, float]


@dataclass
class SelfSupervisedSystem:
    config: Config = field(default_factory=Config)
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        self.dataset: List[DatasetItem] = []
        self.classifier = None
        self.scaler = None
        self.classes_: List[str] = []
        self.results: Dict[str, Dict[str, float]] = {}

    def _mesh(self):
        """The Phase-1 data mesh on the system's device type: every visible
        card, or config.n_devices positions; None (one plain call) for one
        position or with config.data_parallel off."""
        from underwater_image_enhancement_tpu_torch.parallel.mesh import (
            default_mesh,
        )

        if not self.config.data_parallel:
            return None
        return default_mesh(self.config.n_devices, device=self.device)

    def _run_data_parallel(self, fn, imgs):
        """``fn`` (per-image, running on its input's device) of a
        (B, H, W, 3) host batch on the system's device, its rows spread
        over the data mesh: any mesh gives the same result."""
        from underwater_image_enhancement_tpu_torch.parallel.mesh import (
            run_data_parallel,
        )

        dev = resolve_device(self.device)
        mesh = self._mesh()
        # the host batch goes to the device whole, or a shard a position
        x = _on_device(imgs, dev if mesh is None else torch.device("cpu"))
        return run_data_parallel(fn, x, mesh)

    def _label_batch_np(self, imgs: np.ndarray, return_all: bool = False,
                        u8: bool = False):
        """``label_batch`` of a (B, H, W, 3) host batch over the system's
        data mesh -> numpy (features, scores, best, images); ``u8``
        quantizes the images on the device as the reference's imwrite does
        ((clip * 255) truncated), a quarter of the transfer."""
        weights = self.config.quality_weights
        fast = bool(self.config.fast_label)

        def shard(x):
            feats, scores, best, images = label_batch(x, weights, return_all,
                                                      fast)
            if u8:
                images = (torch.clamp(images, 0, 1) * 255).to(torch.uint8)
            return feats, scores, best, images

        feats, scores, best, images = self._run_data_parallel(shard, imgs)
        # one read for the numbers (best is exact in f32), one for images
        head = torch.cat([feats, scores, best[:, None].to(torch.float32)],
                         1).cpu().numpy()
        return (np.ascontiguousarray(head[:, :FEATURE_DIM]),
                head[:, FEATURE_DIM:-1],
                head[:, -1].astype(np.int64), images.cpu().numpy())

    def label_image(self, img: np.ndarray) -> Tuple[np.ndarray, DatasetItem]:
        """All strategies and scores for one image (main.py:116-164) ->
        (the winning (H, W, 3) f32 image, its DatasetItem)."""
        feats, scores, best, winners = self._label_batch_np(
            np.asarray(img)[None])
        names = [STRATEGY_DISPLAY[k] for k in LABEL_ORDER]
        k = int(best[0])
        item = DatasetItem(
            filename="", features=feats[0], best_strategy=names[k],
            best_score=float(scores[0, k]),
            all_scores={nm: float(s) for nm, s in zip(names, scores[0])})
        return winners[0], item

    def build_dataset(self, log=print,
                      batch_size: Optional[int] = None) -> List[Dict]:
        """Phase 1 over config.image_folder -> the CSV rows (main.py:63-196).
        Frames decode streaming, grouped by shape into batches of
        ``batch_size`` (default config.batch_size); frames under 10 pixels
        on a side are skipped.  Rows and the dataset follow folder order."""
        self.config.create_folders()
        files = uio.collect_images(self.config.image_folder)
        names = [STRATEGY_DISPLAY[k] for k in LABEL_ORDER]
        rows_by_path: Dict[Path, Dict] = {}
        items_by_path: Dict[Path, DatasetItem] = {}
        order: List[Path] = []
        pending: Dict[tuple, List[Tuple[Path, np.ndarray]]] = {}
        return_all = bool(self.config.save_all_enhanced)

        def flush(chunk):
            out = self._label_batch_np(np.stack([im for _, im in chunk]),
                                       return_all, u8=True)
            self._emit_chunk(chunk, *out, names, return_all, rows_by_path,
                             items_by_path)

        bs = max(1, batch_size or self.config.batch_size)
        self._writer = uio.AsyncWriter()
        try:
            for path, img in uio.decode_iter(files, log=log, min_size=10):
                order.append(path)
                buf = pending.setdefault(img.shape, [])
                buf.append((path, img))
                if len(buf) == bs:
                    flush(buf)
                    buf.clear()
            for buf in pending.values():
                if buf:
                    flush(buf)
        finally:
            errors = self._writer.close()
        for wpath, err in errors:
            log(f"warning: write failed {Path(wpath).name}: {err}")

        csv_rows: List[Dict] = []
        for path in order:
            if path in rows_by_path:
                csv_rows.append(rows_by_path[path])
                self.dataset.append(items_by_path[path])
        if csv_rows:
            self._write_csv(csv_rows)
            self._save_dataset()
        return csv_rows

    def _emit_chunk(self, chunk, feats, scores, best, images, names,
                    return_all, rows_by_path, items_by_path):
        folder = Path(self.config.strategy_folder)
        for j, (path, _) in enumerate(chunk):
            k = int(best[j])
            item = DatasetItem(
                filename=path.name, features=feats[j],
                best_strategy=names[k], best_score=float(scores[j, k]),
                all_scores={nm: float(s) for nm, s in zip(names, scores[j])})
            items_by_path[path] = item
            winner = images[j, k] if return_all else images[j]
            self._writer.write(str(folder / f"{path.stem}_{item.best_strategy}.png"),
                               winner)
            if return_all:  # config.py:123 SAVE_ALL_ENHANCED
                for m, nm in enumerate(names):
                    if m != k:
                        self._writer.write(str(folder / f"{path.stem}_{nm}.png"),
                                           images[j, m])
            row = {"filename": path.name, "best_strategy": item.best_strategy,
                   "best_score": item.best_score}
            row.update(item.all_scores)
            rows_by_path[path] = row

    def _write_csv(self, rows: List[Dict]) -> None:
        path = Path(self.config.report_folder) / "dataset_building.csv"
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)

    def _save_dataset(self) -> None:
        path = Path(self.config.model_folder) / "dataset.pkl"
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump([item.__dict__ for item in self.dataset], f)

    def dataset_report(self) -> Dict[str, Dict[str, float]]:
        """Label distribution and mean scores (main.py:198-218)."""
        out: Dict[str, Dict[str, float]] = {}
        labels = [d.best_strategy for d in self.dataset]
        for s in sorted(set(labels)):
            scores = [d.best_score for d in self.dataset if d.best_strategy == s]
            out[s] = {
                "count": labels.count(s),
                "fraction": labels.count(s) / len(labels),
                "mean_score": float(np.mean(scores)),
                "std_score": float(np.std(scores)),
            }
        return out

    # ---------------- Phase 2 ----------------

    def _split(self):
        """The held-out split of main.py:233-245 (stratified where every
        class has >= 2 members, as sklearn requires)."""
        from sklearn.model_selection import train_test_split

        X = np.stack([d.features for d in self.dataset])
        y = np.array([d.best_strategy for d in self.dataset])
        counts = {c: int((y == c).sum()) for c in set(y)}
        strat = y if min(counts.values()) >= 2 else None
        return train_test_split(X, y, test_size=self.config.test_size,
                                random_state=self.config.random_seed,
                                stratify=strat)

    def train_classifier(self, log=print, include_mlp: bool = False
                         ) -> Dict[str, Dict[str, float]]:
        """main.py:225-335: scale, fit RF/GB/SVC, 5-fold CV, pick best.
        include_mlp adds the MLP classifier on the system's device to the
        candidates (not in the reference)."""
        from sklearn.ensemble import (
            GradientBoostingClassifier,
            RandomForestClassifier,
        )
        from sklearn.metrics import accuracy_score
        from sklearn.model_selection import cross_val_score
        from sklearn.preprocessing import StandardScaler
        from sklearn.svm import SVC

        if not self.dataset:
            raise RuntimeError("dataset empty; run build_dataset() first")
        y = np.array([d.best_strategy for d in self.dataset])
        X_tr, X_te, y_tr, y_te = self._split()
        self.scaler = StandardScaler().fit(X_tr)
        X_trs = self.scaler.transform(X_tr)
        X_tes = self.scaler.transform(X_te)

        zoo = {
            "random_forest": RandomForestClassifier(
                **self.config.classifiers["random_forest"]),
            "gradient_boosting": GradientBoostingClassifier(
                **self.config.classifiers["gradient_boosting"]),
            "svm": SVC(probability=True, **self.config.classifiers["svm"]),
        }
        if include_mlp:
            zoo["mlp"] = FlaxMLPClassifier(device=self.device)
        if len(set(y)) < 2:
            log("warning: every image got the same best strategy — "
                "classifiers that require >=2 classes will be skipped")
        best_name, best_acc = None, -1.0
        for name, clf in zoo.items():
            try:
                clf.fit(X_trs, y_tr)
            except ValueError as e:  # e.g. single-class GB/SVC
                log(f"{name}: skipped ({e})")
                self.results[name] = {"test_accuracy": float("nan"),
                                      "cv_mean": float("nan"),
                                      "cv_std": float("nan")}
                continue
            acc = accuracy_score(y_te, clf.predict(X_tes))
            # folds bounded by the train split's smallest class
            tr_counts = {c: int((y_tr == c).sum()) for c in set(y_tr)}
            cv_folds = min(self.config.cv_folds, min(tr_counts.values()),
                           len(X_tr))
            if cv_folds >= 2 and len(set(y_tr)) >= 2 and name != "mlp":
                cv = cross_val_score(clf, X_trs, y_tr, cv=cv_folds)
                cv_mean, cv_std = float(cv.mean()), float(cv.std())
            else:
                cv_mean = cv_std = float("nan")
            self.results[name] = {"test_accuracy": float(acc),
                                  "cv_mean": cv_mean, "cv_std": cv_std}
            log(f"{name}: test acc {acc:.3f}")
            if acc > best_acc:
                best_name, best_acc = name, acc
                self.classifier = clf
        if self.classifier is None:
            raise RuntimeError("no classifier could be trained on this dataset")
        self.classes_ = sorted(set(y))
        self._save_model(best_name)
        return self.results

    def _save_model(self, best_name: str) -> None:
        path = Path(self.config.model_folder) / "trained_model.pkl"
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({
                "classifier": self.classifier,
                "scaler": self.scaler,
                "results": self.results,
                "classes": self.classes_,
                "best_name": best_name,
            }, f)

    def load_model(self, path: Optional[str] = None) -> None:
        """A ``trained_model.pkl`` of either package.  The MLP classifier
        runs on the system's device."""
        p = path or str(Path(self.config.model_folder) / "trained_model.pkl")
        with open(p, "rb") as f:
            blob = _PortUnpickler(f, p).load()
        self.classifier = blob["classifier"]
        self.scaler = blob["scaler"]
        self.results = blob.get("results", {})
        self.classes_ = blob.get("classes", [])
        clf = self.classifier
        if isinstance(clf, FlaxMLPClassifier):
            _check_plain_tree(clf._params, p)
            clf.device = str(self.device)
            # the bridge refuses a tree that does not fit the network
            n_in = clf._params["params"]["Dense_0"]["kernel"].shape[0]
            clf._net(n_in, clf._params)

    def predict(self, image_path: str) -> Tuple[str, Dict[str, float]]:
        """main.py:398-434: label + per-class probabilities for one image;
        the features on the system's device."""
        if self.classifier is None:
            raise RuntimeError("no classifier; train or load one first")
        img = uio.imread_unit(image_path)
        if img is None:
            raise ValueError(f"unreadable image: {image_path}")
        x = _on_device(img, resolve_device(self.device))
        feats = extract_all_features(x).cpu().numpy()[None]
        scaled = self.scaler.transform(feats)
        label = str(self.classifier.predict(scaled)[0])
        probs = {}
        if hasattr(self.classifier, "predict_proba"):
            pr = self.classifier.predict_proba(scaled)[0]
            probs = {str(c): float(q)
                     for c, q in zip(self.classifier.classes_, pr)}
        return label, probs

    # ---------------- Reports (main.py:337-396) ----------------

    def classification_report(self) -> str:
        """Text report + confusion matrix on the held-out split
        (main.py:337-374)."""
        from sklearn.metrics import classification_report as cr
        from sklearn.metrics import confusion_matrix

        _, X_te, _, y_te = self._split()
        pred = self.classifier.predict(self.scaler.transform(X_te))
        rep = cr(y_te, pred, zero_division=0)
        cm = confusion_matrix(y_te, pred, labels=self.classes_)
        lines = [rep, "", "confusion matrix (rows=true, cols=pred):",
                 "  " + " ".join(f"{c[:10]:>12}" for c in self.classes_)]
        for c, row in zip(self.classes_, cm):
            lines.append(f"{c[:12]:>12} " + " ".join(f"{v:>12}" for v in row))
        text = "\n".join(lines)
        path = Path(self.config.report_folder) / "classification_report.txt"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        self._confusion_png(cm)
        return text

    def _confusion_png(self, cm: np.ndarray) -> None:
        """Confusion-matrix heatmap PNG (main.py:376-396, matplotlib in
        place of seaborn); skipped where matplotlib is missing."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, ax = plt.subplots(figsize=(6, 5))
        im = ax.imshow(cm, cmap="Blues")
        ax.set_xticks(range(len(self.classes_)))
        ax.set_yticks(range(len(self.classes_)))
        ax.set_xticklabels(self.classes_, rotation=45, ha="right", fontsize=7)
        ax.set_yticklabels(self.classes_, fontsize=7)
        for i in range(cm.shape[0]):
            for j in range(cm.shape[1]):
                ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                        fontsize=8)
        ax.set_xlabel("predicted")
        ax.set_ylabel("true")
        fig.colorbar(im)
        fig.tight_layout()
        fig.savefig(Path(self.config.report_folder) / "confusion_matrix.png",
                    dpi=150)
        plt.close(fig)


_JAX_PACKAGE = "underwater_image_enhancement_tpu"
_JAX_MLP = (_JAX_PACKAGE + ".select.mlp_classifier", "FlaxMLPClassifier")


class _PortUnpickler(pickle.Unpickler):
    """Unpickles a ``trained_model.pkl`` without JAX: the JAX package's
    MLP classifier becomes the port's (its parameters are carried over by
    ``load_model``); any other class of the JAX package, or of JAX, Flax
    or Optax, raises."""

    def __init__(self, f, path: str):
        super().__init__(f)
        self.path = path

    def find_class(self, module: str, name: str):
        if (module, name) == _JAX_MLP:
            return FlaxMLPClassifier
        top = module.split(".")[0]
        if top in (_JAX_PACKAGE, "jax", "jaxlib", "flax", "optax", "orbax"):
            raise pickle.UnpicklingError(
                f"{self.path} holds {module}.{name}, which the PyTorch port "
                "cannot load: it reads sklearn classifiers and the MLP "
                "classifier with a numpy parameter tree; retrain with the "
                "port's train-selector")
        return super().find_class(module, name)


def _check_plain_tree(tree, path: str) -> None:
    """Raise unless ``tree`` is nested plain dicts of numpy arrays."""
    if isinstance(tree, np.ndarray):
        return
    if type(tree) is not dict or not tree:
        raise pickle.UnpicklingError(
            f"{path}: the MLP classifier's parameters are a "
            f"{type(tree).__name__}, not a tree of numpy arrays; retrain "
            "with the port's train-selector")
    for v in tree.values():
        _check_plain_tree(v, path)
