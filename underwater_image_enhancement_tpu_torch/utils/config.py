"""Configuration constants the ported paths need (no dataclass config yet).

Values mirror the reference's config.py and six_stadigy.py; the JAX
package's ``utils/config.py`` carries the same numbers."""

from __future__ import annotations

from typing import List

SUPPORTED_FORMATS: List[str] = [".jpg", ".jpeg", ".png", ".tif", ".tiff", ".bmp"]

# The six-strategy recipes (six_stadigy.py:226-285), one entry per strategy
# in reference order.  dehaze: (omega, guided radius, guided eps); stretch:
# (L_low, L_high); clahe: clip limit; gamma: out**gamma exponent; wb:
# white-balance percentile.
SIX_PARAMS = {
    "strong_dehazing": {"dehaze": (0.3, 20, 5e-1), "stretch": (5.0, 98.0),
                        "clahe": 3.0, "gamma": 1.5},
    "medium_dehazing": {"dehaze": (0.5, 15, 5e-1), "stretch": (15.0, 95.0),
                        "clahe": 2.0},
    "light_dehazing": {"dehaze": (0.7, 10, 1e-1), "stretch": (20.0, 85.0),
                       "wb": 2.0},
    "clahe_enhancement": {"clahe": 4.0, "stretch": (10.0, 95.0), "wb": 3.0,
                          "gamma": 1.3},
    "white_balance": {"wb": 2.0, "stretch": (15.0, 90.0), "clahe": 1.5,
                      "gamma": 1.2},
    "histogram_eq": {"stretch": (5.0, 98.0), "clahe": 3.5, "gamma": 1.4},
}
