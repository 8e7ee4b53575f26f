"""Host-side input pipeline: paired image folders -> device batches (the
JAX package's ``train/data.py``).

Reproduces the reference datasets' semantics:

- ImprovedEnhancementDataset (vgg_16_UIE.py:306-421): paired raw/reference
  images matched by filename, resized to target_size, paired random H/V
  flips.
- EnhancementDataset (deep_learning_parameters.py:199-246): 256 resize.

Decoding is the port's (``utils/io``: PNG, baseline JPEG and BMP, as
``cv2.imread`` reads them), the resize ``ops/resize.resize_u8`` (bit-equal
to ``cv2.resize(INTER_LINEAR)``), then ``/255`` in numpy as JAX's loader
does; shuffles, splits and flips come from the same numpy generators, so a
batch equals the JAX package's bit for bit.  ``prefetch_to_device`` copies
batches to the card on a thread, from pinned memory.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from underwater_image_enhancement_tpu_torch.ops.resize import resize_u8
from underwater_image_enhancement_tpu_torch.utils import io as uio

IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    """cv2.resize(img, (size, size), INTER_LINEAR) of a u8 RGB image."""
    t = torch.from_numpy(np.ascontiguousarray(img))
    return torch.stack([resize_u8(t[..., c], size, size) for c in range(3)],
                       dim=-1).to(torch.uint8).numpy()


class PairedImageDataset:
    """Paired raw/reference folders matched by filename.

    Missing references fall back to the raw image (vgg_16_UIE.py:396-400)."""

    def __init__(self, image_folder: str, reference_folder: str,
                 target_size: int = 224, augment: bool = True,
                 seed: int = 0):
        self.image_paths: List[Path] = sorted(
            p for p in Path(image_folder).iterdir()
            if p.suffix.lower() in IMAGE_EXTS
        )
        if not self.image_paths:
            raise ValueError(f"No images found in {image_folder}")
        self.reference_folder = Path(reference_folder)
        self.target_size = target_size
        self.augment = augment
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.image_paths)

    def load_pair(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        p = self.image_paths[idx]
        img = uio.imread_u8(str(p))
        if img is None:
            raise ValueError(f"Failed to load image: {p}")
        img = _resize(img, self.target_size).astype(np.float32) / 255.0
        ref_path = self.reference_folder / p.name
        ref = uio.imread_u8(str(ref_path)) if ref_path.exists() else None
        if ref is None:
            ref = (img * 255).astype(np.uint8)
        ref = _resize(ref, self.target_size).astype(np.float32) / 255.0
        if self.augment:
            if self.rng.random() > 0.5:
                img, ref = img[:, ::-1].copy(), ref[:, ::-1].copy()
            if self.rng.random() > 0.5:
                img, ref = img[::-1].copy(), ref[::-1].copy()
        return img, ref

    def split(self, train_frac: float, seed: int = 42
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic index split (reference: random_split seeded 42)."""
        n = len(self)
        perm = np.random.default_rng(seed).permutation(n)
        k = int(train_frac * n)
        return perm[:k], perm[k:]

    def batches(self, indices: np.ndarray, batch_size: int,
                shuffle: bool = True, drop_remainder: bool = True,
                seed: int = 0, process_index: Optional[int] = None,
                process_count: Optional[int] = None,
                with_indices: bool = False,
                ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield (imgs, refs) batches of `batch_size` — or
        (indices, imgs, refs) with ``with_indices=True`` (the dataset-index
        form consumed by MLPTrainer's per-index feature cache).

        Multi-host sharding: every process runs the SAME seeded shuffle,
        then takes every `process_count`-th batch starting at
        `process_index` (each yields floor(n_batches / process_count)
        batches).  None resolves to one process (0 of 1): the port runs
        in one process, and a trainer's ``mesh=`` cuts each batch over that
        process's mesh positions (``parallel/mesh``).
        """
        if process_index is None or process_count is None:
            process_index, process_count = 0, 1
        order = np.array(indices)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        stop = len(order) - (len(order) % batch_size) if drop_remainder else len(order)
        if process_count > 1:
            # multi-host: always exclude the short remainder batch, so
            # every process yields batches of one shape
            stop = len(order) - (len(order) % batch_size)
        starts = list(range(0, stop, batch_size))
        if process_count > 1:
            # equal batch counts per process keep processes in step
            per = len(starts) // process_count
            starts = starts[process_index::process_count][:per]
        for i in starts:
            chunk = order[i:i + batch_size]
            if len(chunk) < batch_size and drop_remainder:
                break
            pairs = [self.load_pair(int(j)) for j in chunk]
            imgs = np.stack([p[0] for p in pairs])
            refs = np.stack([p[1] for p in pairs])
            if with_indices:
                yield chunk.astype(np.int64), imgs, refs
            else:
                yield imgs, refs


def prefetch_to_device(iterator, size: int = 2,
                       device: Union[str, torch.device] = "cuda"):
    """Host -> device double buffering: a thread keeps `size` batches in
    flight, each array copied into pinned memory (on a CUDA device) and
    sent with a non-blocking copy, so the decode and the copy overlap the
    step.  Yields the items as tuples of tensors on ``device``; an error
    in the producer is raised here."""
    dev = torch.device(device)
    pin = dev.type == "cuda"
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    done = object()

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return (t.pin_memory() if pin else t).to(dev, non_blocking=pin)

    def producer():
        try:
            for item in iterator:
                q.put(tuple(put(a) for a in item))
        except BaseException as e:  # handed to the consumer
            q.put(e)
        finally:
            q.put(done)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
