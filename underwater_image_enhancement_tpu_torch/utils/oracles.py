"""Float64 oracles of the reference's strategies, for ``validate``.

The port's own copy of the JAX package's ``testing/golden.py`` functions
that ``strategy_config`` and ``strategy_six`` reach: numpy and cv2 in
float64, as the reference computes (enhancement_strategies.py:16-345,
six_stadigy.py:48-285).  cv2 is imported inside the functions, so the
module imports where cv2 is missing; ``validate`` runs them on the host of
a machine that has it.  ``tests/test_torch_validate.py`` holds them
bit-equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np


def gf(guide: np.ndarray, src: np.ndarray, r: int, eps: float) -> np.ndarray:
    """Guided filter, enhancement_strategies.py:16-46 semantics (float64)."""
    import cv2

    guide = guide.astype(np.float64)
    src = src.astype(np.float64)
    mean_i = cv2.boxFilter(guide, cv2.CV_64F, (r, r))
    mean_p = cv2.boxFilter(src, cv2.CV_64F, (r, r))
    corr_ip = cv2.boxFilter(guide * src, cv2.CV_64F, (r, r))
    corr_ii = cv2.boxFilter(guide * guide, cv2.CV_64F, (r, r))
    cov = corr_ip - mean_i * mean_p
    var = corr_ii - mean_i * mean_i
    a = cov / (var + eps)
    b = mean_p - a * mean_i
    return cv2.boxFilter(a, cv2.CV_64F, (r, r)) * guide + cv2.boxFilter(
        b, cv2.CV_64F, (r, r)
    )


def gray_unit(img: np.ndarray) -> np.ndarray:
    """cvtColor((img*255).u8, RGB2GRAY)/255 — the reference's gray recipe."""
    import cv2

    u8 = (img * 255).astype(np.uint8)
    return cv2.cvtColor(u8, cv2.COLOR_RGB2GRAY).astype(np.float64) / 255.0


def transmission(img: np.ndarray, A, omega=0.95, r=15, eps=0.001) -> np.ndarray:
    """enhancement_strategies.py:208-234 (single final clip)."""
    dark = np.min(img / (np.asarray(A) + 1e-10), axis=2)
    t0 = 1.0 - omega * dark
    t = gf(gray_unit(img), t0, r, eps)
    return np.clip(t, 0.1, 1.0)


def transmission_six(img: np.ndarray, A, omega, r, eps) -> np.ndarray:
    """six_stadigy.py:167-180 (clip before and after refinement)."""
    dark = np.min(img / (np.asarray(A).reshape(1, 1, 3) + 1e-6), axis=2)
    t0 = np.clip(1.0 - omega * dark, 0.1, 1.0)
    t = gf(gray_unit(img), t0, r, eps)
    return np.clip(t, 0.1, 1.0)


def recover(img: np.ndarray, t: np.ndarray, A) -> np.ndarray:
    """enhancement_strategies.py:236-249 / six_stadigy.py:182-188."""
    return np.clip((img - A) / t[..., None] + A, 0.0, 1.0)


def stretch(img: np.ndarray, l_low, l_high, eps=1e-10) -> np.ndarray:
    """Per-channel percentile stretch, enhancement_strategies.py:251-273.

    eps=1e-6 gives the six_stadigy.enhance_contrast twin (190-199)."""
    out = np.zeros_like(img)
    for c in range(img.shape[2]):
        ch = img[:, :, c]
        lo = np.percentile(ch, l_low)
        hi = np.percentile(ch, l_high)
        out[:, :, c] = np.clip((ch - lo) / (hi - lo + eps), 0.0, 1.0)
    return out


def white_balance(img: np.ndarray, percentile=5) -> np.ndarray:
    """six_stadigy.py:210-219."""
    return stretch(img, percentile, 100 - percentile, eps=1e-6)


def gamma_inv(img: np.ndarray, gamma=1.2) -> np.ndarray:
    """img**(1/gamma) clipped — enhancement_strategies.py:276-285."""
    return np.clip(np.power(img, 1.0 / gamma), 0.0, 1.0)


def gamma_pow(img: np.ndarray, gamma=1.2) -> np.ndarray:
    """img**gamma, no clip — six_stadigy.py:221-224."""
    return np.power(img, gamma)


def clahe(img: np.ndarray, clip_limit=2.0, grid=(8, 8)) -> np.ndarray:
    """LAB-L CLAHE roundtrip — enhancement_strategies.py:287-307.

    Returns float64 /255 like the reference; six_stadigy.apply_clahe
    (201-208) is the same with float32 output."""
    import cv2

    u8 = (img * 255).astype(np.uint8)
    lab = cv2.cvtColor(u8, cv2.COLOR_RGB2LAB)
    c = cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=grid)
    lab[:, :, 0] = c.apply(lab[:, :, 0])
    return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB).astype(np.float64) / 255.0


def hist_eq(img: np.ndarray) -> np.ndarray:
    """Per-channel equalizeHist — enhancement_strategies.py:330-345."""
    import cv2

    u8 = (img * 255).astype(np.uint8)
    out = np.zeros_like(u8)
    for c in range(3):
        out[:, :, c] = cv2.equalizeHist(u8[:, :, c])
    return out.astype(np.float64) / 255.0


def compute_q(block: np.ndarray) -> float:
    """Region score — enhancement_strategies.py:146-188."""
    import cv2

    n = block.shape[0] * block.shape[1]
    r, g, b = block[:, :, 0], block[:, :, 1], block[:, :, 2]
    term1 = (r.sum() + g.sum() + b.sum()) / (3 * n)
    term2 = (b.sum() + g.sum() - 2 * r.sum()) / n
    term3 = (r.var() + g.var() + b.var()) / 3
    edges = cv2.Canny(cv2.cvtColor((block * 255).astype(np.uint8),
                                   cv2.COLOR_RGB2GRAY), 50, 150)
    term4 = (edges > 0).sum() / n
    return float(term1 + term2 - term3 - term4)


def quadtree_airlight(img: np.ndarray, min_size: int = 1) -> np.ndarray:
    """Quadtree atmospheric light search, six_stadigy.py:48-113 — returns (3,).

    (enhancement_strategies.py:75-144 is the same search but tiles the result
    to H x W x 3.)  Descends into the best-Q quadrant until <= min_size, then
    returns the brightest pixel of the winning block."""
    h, w = img.shape[:2]
    r0, c0 = 0, 0
    while h > min_size and w > min_size:
        mh, mw = h // 2, w // 2
        blocks = [
            (r0, c0, mh, mw),
            (r0, c0 + mw, mh, w - mw),
            (r0 + mh, c0, h - mh, mw),
            (r0 + mh, c0 + mw, h - mh, w - mw),
        ]
        qs = [compute_q(img[rr:rr + hh, cc:cc + ww]) for rr, cc, hh, ww in blocks]
        r0, c0, h, w = blocks[int(np.argmax(qs))]
    block = img[r0:r0 + h, c0:c0 + w]
    s = block.sum(axis=2)
    i, j = np.unravel_index(np.argmax(s), s.shape)
    return block[i, j].copy()


# ---------------------------------------------------------------------------
# Full strategy compositions (CPU oracle for pipeline/)
# ---------------------------------------------------------------------------

def strategy_config(img: np.ndarray, name: str) -> np.ndarray:
    """The 5 "config flavor" strategies with config.py:28-75 parameters
    (enhancement_strategies.py:349-508 composed exactly as main.py runs them)."""
    img = img.astype(np.float64)
    if name in ("strong_dehazing", "medium_dehazing", "light_enhancement"):
        omega, r, lo, hi, ag = {
            "strong_dehazing": (0.5, 15, 10, 95, True),
            "medium_dehazing": (0.6, 20, 15, 92, True),
            "light_enhancement": (0.4, 10, 15, 95, False),
        }[name]
        A = quadtree_airlight(img)  # per-block Canny, the true reference descent
        t = transmission(img, A, omega, r, 0.001)
        out = stretch(recover(img, t, A), lo, hi)
        if ag:
            out = gamma_inv(out, 1.2)
        return out
    if name == "clahe_enhancement":
        return stretch(clahe(img, 2.0), 20, 85)
    if name == "histogram_equalization":
        return stretch(hist_eq(img), 10, 95)
    raise ValueError(name)


def strategy_six(img: np.ndarray, name: str) -> np.ndarray:
    """The 6 six_stadigy strategies (six_stadigy.py:230-285)."""
    img = img.astype(np.float64)

    def restore_(im, omega, r, eps):
        A = quadtree_airlight(im)  # per-block Canny, the true reference descent
        t = transmission_six(im, A, omega, r, eps)
        return recover(im, t, A)

    st = lambda im, lo, hi: stretch(im, lo, hi, eps=1e-6)
    if name == "strong_dehazing":
        e = st(restore_(img, 0.3, 20, 5e-1), 5, 98)
        return gamma_pow(clahe(e, 3.0), 1.5)
    if name == "medium_dehazing":
        return clahe(st(restore_(img, 0.5, 15, 5e-1), 15, 95), 2.0)
    if name == "light_dehazing":
        return white_balance(st(restore_(img, 0.7, 10, 1e-1), 20, 85), 2)
    if name == "clahe_enhancement":
        e = white_balance(st(clahe(img, 4.0), 10, 95), 3)
        return gamma_pow(e, 1.3)
    if name == "white_balance":
        e = clahe(st(white_balance(img, 2), 15, 90), 1.5)
        return gamma_pow(e, 1.2)
    if name == "histogram_eq":
        return gamma_pow(clahe(st(img, 5, 98), 3.5), 1.4)
    raise ValueError(name)
