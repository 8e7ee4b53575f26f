"""PyTorch/CUDA port of ``underwater_image_enhancement_tpu`` for one NVIDIA H100.

The JAX package beside this one stays the reference; this package imports
neither it nor JAX.  Entry points run on the CUDA device unless the caller
asks for the CPU (``device="cpu"``); functions that take tensors run on the
tensors' device.  The hand-written CUDA kernels live in ``csrc/`` and are
wrapped by ``ops/kernels.py``.

``cli`` has every subcommand of the JAX package's CLI; ``parallel.mesh``
spreads a batch over a mesh of devices in one process.  ROADMAP.md lists
what is not ported yet.
"""

from underwater_image_enhancement_tpu_torch.version import __version__  # noqa: F401
