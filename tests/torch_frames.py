"""Frames for the port's tests, drawn from generators of their own.

``tests/conftest.py`` draws ``underwater_img`` and ``rgb_u8`` from the
session-scoped ``rng`` that every test of an xdist worker shares, so a test
that requests them moves the random data of the JAX tests that run after
it on the same worker.  These functions repeat the two recipes with a fresh
``np.random.default_rng(42)``, which gives what the fixtures hold when they
are the first draw of a session; the port's test modules use them through
module-scoped fixtures of the same names.
"""

import numpy as np


def underwater_img() -> np.ndarray:
    """conftest.underwater_img: 120x160 blue-green cast, haze, gradients,
    on the u8 grid."""
    rng = np.random.default_rng(42)
    h, w = 120, 160
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [
            0.15 + 0.1 * np.sin(xx / 17.0) + 0.05 * (yy / h),
            0.45 + 0.2 * np.cos(yy / 23.0) + 0.1 * (xx / w),
            0.55 + 0.15 * np.sin((xx + yy) / 31.0),
        ],
        axis=-1,
    )
    noise = rng.normal(0, 0.03, (h, w, 3)).astype(np.float32)
    img = np.clip(base + noise, 0.0, 1.0).astype(np.float32)
    return (np.floor(img * 255.0) / 255.0).astype(np.float32)


def img_unit() -> np.ndarray:
    """conftest.img_unit: random 96x128 RGB in [0, 1] on the u8 grid."""
    rgb_u8 = np.random.default_rng(42).integers(0, 256, (96, 128, 3),
                                                 dtype=np.uint8)
    return (rgb_u8.astype(np.float32) / 255.0).astype(np.float32)


def train_batch(size: int, n: int):
    """(imgs, refs), each (n, size, size, 3) f32 on the u8 grid: crops of
    ``underwater_img`` along its diagonals, each reference a brighter
    version of its crop (the paired datasets' recipe)."""
    frame = underwater_img()
    ys = np.linspace(0, frame.shape[0] - size, n).astype(int)
    xs = np.linspace(0, frame.shape[1] - size, n).astype(int)[::-1]
    imgs = np.stack([frame[y:y + size, x:x + size] for y, x in zip(ys, xs)])
    refs = np.floor(np.clip(imgs ** 0.7, 0, 1) * 255.0) / 255.0
    return imgs.astype(np.float32), refs.astype(np.float32)
