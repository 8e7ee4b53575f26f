"""Phase 1 of the self-supervised strategy selector (main.py:63-218):
label every image of a folder with the strategy whose output scores best.

Counterpart of the JAX package's ``select/system.py``, Phase 1 only: for
each frame, the five strategies (``pipeline/strategies.py``), their
weighted quality totals (``metrics/quality.py``), the 79 features
(``features/full.py``) and the argmax, all on the device; the host reads
each batch back once (features, scores and labels in one transfer, the
winning images quantized to u8 in another), writes the winners' PNGs, the
CSV and ``dataset.pkl``.  ``dataset.pkl`` holds the same pickled list of
dicts as the JAX package's (numpy features), so its ``train-selector``
reads the port's file.  Phase 2 (the sklearn classifiers, ``predict``, the
reports) is not ported.
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
    _on_device,
    resolve_device,
    score_strategies,
    select_planes,
)
from underwater_image_enhancement_tpu_torch.pipeline.strategies import (
    LABEL_ORDER,
    STRATEGY_DISPLAY,
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

    def _label_batch_np(self, imgs: np.ndarray, return_all: bool = False,
                        u8: bool = False):
        """``label_batch`` of a (B, H, W, 3) host batch on the system's
        device -> numpy (features, scores, best, images); ``u8`` quantizes
        the images on the device as the reference's imwrite does ((clip *
        255) truncated), a quarter of the transfer."""
        x = _on_device(imgs, resolve_device(self.device))
        feats, scores, best, images = label_batch(
            x, self.config.quality_weights, return_all,
            bool(self.config.fast_label))
        if u8:
            images = (torch.clamp(images, 0, 1) * 255).to(torch.uint8)
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
