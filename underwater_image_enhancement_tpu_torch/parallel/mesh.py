"""A 1-D data mesh and batch parallelism in one process: the JAX package's
``parallel/mesh.py``.

A ``Mesh`` is an ordered tuple of indexed torch devices on the one axis
``"data"``.  Positions may repeat a device: ``Mesh((cpu,) * 8)`` stands in
for the JAX suite's 8 virtual CPU devices, and ``Mesh((cuda:0,) * 3)``
rehearses three positions on one card.  Every program the mesh carries is
per-image (percentiles, scores, features, argmax), so a shard's images
come out as they do in the whole batch and nothing crosses positions.

Where JAX runs one sharded program, the port calls the program once per
position, in mesh order, on that position's rows moved to its device, and
gathers each output leaf along dim 0 onto ``mesh.devices[0]``.  The calls
are issued one after another from one host thread (no threads, no
``torch.distributed``), so cards overlap only as far as their queues run
ahead of the host.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

DATA_AXIS = "data"

Device = Union[str, torch.device]


def _indexed(dev: Device) -> torch.device:
    """``dev`` with its index: an unindexed ``cuda`` is the current card,
    so each position's tensors name the card they live on."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Positions of a 1-D data mesh: ``devices`` (indexed torch devices, a
    device may repeat), ``size``, ``axis_names`` (``("data",)``) and
    ``shape`` (``{"data": size}``)."""

    def __init__(self, devices: Sequence[Device]):
        self.devices = tuple(_indexed(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one position")
        self.axis_names = (DATA_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size}

    def __repr__(self) -> str:
        return f"Mesh({', '.join(map(str, self.devices))})"


def make_mesh(n_devices: Optional[int] = None,
              device: Device = "cuda") -> Mesh:
    """A mesh over the first ``n_devices`` cards (default: every visible
    one); more than ``torch.cuda.device_count()`` raises (JAX's
    ``devices()[:n]`` takes fewer).  ``device="cpu"``: ``n_devices`` CPU
    positions (default 1)."""
    kind = torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"make_mesh: {n} positions asked")
        return Mesh((torch.device("cpu"),) * n)
    if kind != "cuda":
        raise ValueError(f"make_mesh: device {device!r} is neither cuda nor "
                         "cpu")
    visible = torch.cuda.device_count()
    n = visible if n_devices is None else int(n_devices)
    if not 1 <= n <= visible:
        raise ValueError(f"{n} CUDA devices asked, {visible} visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def maybe_mesh(mesh, device: Device = "cuda") -> Optional[Mesh]:
    """None or a Mesh as given; an int is a device count for
    ``make_mesh``."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    return make_mesh(int(mesh), device)


def data_parallel_sharding(mesh: Optional[Mesh]):
    """fn(x) -> the placement of x's leading (batch) dim over the mesh:
    ``((device, rows), ...)`` one entry a position, rows a ``slice``
    (None without a mesh).  A batch that does not divide raises, as a
    ``NamedSharding`` placement does."""
    def fn(x):
        if mesh is None:
            return None
        b = int(x.shape[0])
        if b % mesh.size:
            raise ValueError(f"a batch of {b} does not divide over "
                             f"{mesh.size} mesh positions")
        k = b // mesh.size
        return tuple((dev, slice(i * k, (i + 1) * k))
                     for i, dev in enumerate(mesh.devices))

    return fn


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def _tree_map(fn, *trees):
    """fn over the leaves of equally shaped trees of tuples, lists and
    dicts."""
    t = trees[0]
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    return fn(*trees)


def shard_batch(batch, mesh: Optional[Mesh]):
    """Every leaf of a batch tree (tensors or numpy arrays) split along its
    leading dim over the mesh -> one tree a position, its leaves on the
    position's device (the batch as given without a mesh)."""
    if mesh is None:
        return batch
    place = data_parallel_sharding(mesh)
    _tree_map(place, batch)  # a leaf that does not divide raises first
    return [_tree_map(lambda x: _tensor(x)[place(x)[i][1]].to(dev), batch)
            for i, dev in enumerate(mesh.devices)]


def replicate(tree, mesh: Optional[Mesh]):
    """A tree placed whole on each position's device -> one tree a
    position (the tree as given without a mesh)."""
    if mesh is None:
        return tree
    return [_tree_map(lambda x: _tensor(x).to(dev), tree)
            for dev in mesh.devices]


def gather_shards(outs, mesh: Mesh):
    """Per-position output trees -> one tree, each leaf the positions'
    leaves concatenated along dim 0 on ``mesh.devices[0]``."""
    home = mesh.devices[0]
    return _tree_map(lambda *xs: torch.cat([x.to(home) for x in xs]), *outs)


def default_mesh(n_devices: Optional[int] = None,
                 device: Device = "cuda") -> Optional[Mesh]:
    """The mesh the CLI runs on: every visible card (``n_devices`` pins a
    count; on the CPU, ``n_devices`` positions), or None for one position,
    which means a plain call on one device."""
    if n_devices is None:
        n = (torch.cuda.device_count()
             if torch.device(device).type == "cuda" else 1)
    else:
        n = int(n_devices)
    if n <= 1:
        return None
    return make_mesh(n, device)


def run_data_parallel(fn, batch, mesh: Optional[Mesh], *args, **kwargs):
    """``fn(batch, *args, **kwargs)`` with the batch's rows spread over the
    mesh.  ``fn`` must run on its input's device and map each image alone.

    Without a mesh, on a one-position mesh, or for a batch smaller than the
    mesh this is one plain call (on ``mesh.devices[0]`` where there is a
    mesh): sharding a small batch would pad more than it spreads.
    Otherwise the batch is padded to a multiple of the mesh size with
    repeats of its last frame, ``fn`` is called once per position on that
    position's rows (JAX calls it once, on the padded global batch), and
    every output leaf is gathered on ``mesh.devices[0]`` and cropped back
    to the batch's length."""
    batch = _tensor(batch)
    if mesh is None or mesh.size <= 1 or batch.shape[0] < mesh.size:
        if mesh is not None:
            batch = batch.to(mesh.devices[0])
        return fn(batch, *args, **kwargs)
    b = batch.shape[0]
    pad = (-b) % mesh.size
    if pad:
        batch = torch.cat([batch, batch[-1:].expand(pad, *batch.shape[1:])])
    out = gather_shards([fn(x, *args, **kwargs)
                         for x in shard_batch(batch, mesh)], mesh)
    if pad:
        out = _tree_map(lambda x: x[:b], out)
    return out
