"""Build the package's CUDA kernels into one PyTorch extension.

``torch.utils.cpp_extension.load`` compiles every ``csrc/*.cu`` (the
kernels and their launchers, which include no PyTorch header) and
``csrc/bindings.cpp`` (the typed entry points, the only source that
includes ``torch/extension.h``) with ninja, one compiler process per
source, all started together, into ``build/torch_ext/`` under the
repository root.  ninja rebuilds only what changed, so only the first call
in a fresh checkout pays for the build.  Nothing here runs at import time.
"""

from __future__ import annotations

from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_ext"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-O3",
    # no --use_fast_math: it breaks IEEE division and rintf; no FMA
    # contraction: the CLAHE blend must round each mul and add
    "-fmad=false",
]

_EXT = None


def extension():
    """The loaded extension module, compiled on first use.  A failed
    build raises with the compiler's output."""
    global _EXT
    if _EXT is None:
        from torch.utils import cpp_extension

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        sources = [CSRC_DIR / "bindings.cpp", *sorted(CSRC_DIR.glob("*.cu"))]
        _EXT = cpp_extension.load(
            name="uie_torch_kernels", sources=[str(s) for s in sources],
            extra_cflags=["-O3"], extra_cuda_cflags=NVCC_FLAGS,
            build_directory=str(BUILD_DIR), verbose=False)
    return _EXT
