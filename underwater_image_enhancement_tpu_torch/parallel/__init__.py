"""Data parallelism over a mesh of devices (``parallel/mesh.py``)."""
