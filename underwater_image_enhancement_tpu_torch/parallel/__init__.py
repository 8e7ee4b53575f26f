"""Parallelism over a mesh of devices: batches (``parallel/mesh.py``) and
one frame's rows (``parallel/spatial.py``, ``six_spatial.py``,
``fusion_spatial.py``)."""
