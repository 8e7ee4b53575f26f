"""Configuration of the ported paths: constants and the run configuration
of the selector's two phases.

Values mirror the reference's config.py and six_stadigy.py; the JAX
package's ``utils/config.py`` carries the same numbers (the port keeps its
own copy; ``tests/test_torch_tables.py`` holds them equal)."""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any, Dict, List, Optional

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

# The five "config flavour" strategies (config.py:28-75), the Phase-1
# labels.  Dehaze: omega, guided-filter radius, stretch L_low/L_high and an
# optional img**(1/gamma); CLAHE and histogram equalization take their
# stretch bounds from pipeline/strategies.py.
DEFAULT_STRATEGIES: Dict[str, Dict[str, Any]] = {
    "strong_dehazing": {
        "name": "StrongDehazing", "omega": 0.5, "guided_radius": 15,
        "L_low": 10, "L_high": 95, "gamma": 1.2, "apply_gamma": True,
    },
    "medium_dehazing": {
        "name": "MediumDehazing", "omega": 0.6, "guided_radius": 20,
        "L_low": 15, "L_high": 92, "apply_gamma": True,
    },
    "light_enhancement": {
        "name": "LightEnhancement", "omega": 0.4, "guided_radius": 10,
        "L_low": 15, "L_high": 95, "apply_gamma": False,
    },
    "clahe_enhancement": {
        "name": "CLAHEEnhancement", "clip_limit": 2.0,
        "tile_grid_size": (8, 8), "apply_gamma": False,
    },
    "histogram_equalization": {
        "name": "HistogramEqualization", "L_low": 10, "L_high": 95,
    },
}

# Quality weights of config.py:78-85: six of the eight metrics; colorfulness
# and naturalness get 0 through weights.get(key, 0)
# (quality_assessment.py:284).
DEFAULT_QUALITY_WEIGHTS: Dict[str, float] = {
    "contrast": 0.25, "sharpness": 0.20, "entropy": 0.15,
    "saturation": 0.15, "brightness": 0.15, "edge_density": 0.10,
}

# The eight-metric defaults used when no weights are passed
# (quality_assessment.py:229-238).
FULL_QUALITY_WEIGHTS: Dict[str, float] = {
    "contrast": 0.20, "sharpness": 0.20, "entropy": 0.15,
    "saturation": 0.15, "brightness": 0.10, "edge_density": 0.10,
    "colorfulness": 0.05, "naturalness": 0.05,
}

# Phase-2 classifier hyperparameters (config.py:100-119).
DEFAULT_CLASSIFIERS: Dict[str, Dict[str, Any]] = {
    "random_forest": {"n_estimators": 200, "max_depth": 20,
                      "min_samples_split": 5, "random_state": 42},
    "gradient_boosting": {"n_estimators": 100, "learning_rate": 0.1,
                          "max_depth": 5, "random_state": 42},
    "svm": {"kernel": "rbf", "C": 1.0, "gamma": "scale", "random_state": 42},
}


@dataclasses.dataclass
class Config:
    """Run configuration of both phases (config.py's paths, switches and
    Phase-2 settings) and of Phase 1's data mesh."""

    image_folder: str = "./data/raw"
    output_folder: str = "./results/self_supervised_v1"
    test_size: float = 0.2          # config.py:95
    random_seed: int = 42           # config.py:96
    cv_folds: int = 5               # config.py:97
    save_all_enhanced: bool = False  # config.py:123
    # config.py:28-75's strategy table (the examples print it; the
    # strategies themselves read DEFAULT_STRATEGIES)
    strategies: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=lambda: {k: dict(v)
                                 for k, v in DEFAULT_STRATEGIES.items()})
    quality_weights: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_QUALITY_WEIGHTS))
    classifiers: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=lambda: {k: dict(v)
                                 for k, v in DEFAULT_CLASSIFIERS.items()})
    batch_size: int = 8
    # Phase 1 over a data mesh (parallel/mesh.default_mesh): every visible
    # card, or n_devices positions; False or one position: one plain call
    data_parallel: bool = True
    n_devices: Optional[int] = None
    # label with the throughput tier (banded airlight, fast guided filter,
    # histogram percentiles, arithmetic LAB): near-tie winners may flip
    fast_label: bool = False

    @property
    def feature_folder(self) -> str:
        return os.path.join(self.output_folder, "features")

    @property
    def strategy_folder(self) -> str:
        return os.path.join(self.output_folder, "strategy_results")

    @property
    def model_folder(self) -> str:
        return os.path.join(self.output_folder, "trained_models")

    @property
    def report_folder(self) -> str:
        return os.path.join(self.output_folder, "reports")

    def create_folders(self) -> None:
        """config.py:131-147."""
        for folder in (self.output_folder, self.feature_folder,
                       self.strategy_folder, self.model_folder,
                       self.report_folder):
            Path(folder).mkdir(parents=True, exist_ok=True)

    def validate(self) -> bool:
        """config.py:149-168: the input folder exists and holds images."""
        if not os.path.exists(self.image_folder):
            return False
        return any(any(Path(self.image_folder).glob(f"*{fmt}"))
                   for fmt in SUPPORTED_FORMATS)
