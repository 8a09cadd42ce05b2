"""The device mesh and the node-axis layout of the sharded routes
(kube_batch_tpu/parallel/mesh.py).

When [N, R] node state or the [S, N] signature mask outgrows one device,
the session shards over the ``nodes`` axis of a 1-D mesh: shard s owns
the contiguous node rows [s * N/K, (s + 1) * N/K) of every node-major
leaf (and those columns of the [S, N] leaves), and everything else is
replicated.  One process drives every shard, as the reference's
``jax.jit`` + ``shard_map`` drives all its devices from one controller:
no ``torch.distributed``.

A ``Mesh`` is an ordered tuple of ``torch.device``s.  A device may appear
more than once, and its shards then share it: the tests run 8 or 2 shards
on the CPU (the reference forces 8 virtual CPU devices), and chip_smoke.py
runs 4 shards on one card.  ``default_mesh()`` is the mesh ``use_mesh``
installed, and otherwise None: the routes never shard on their own.  The
reference's default is a mesh over every device when there are several,
but K1's shard mode has been measured only with its shards sharing one
H100, where it is slower than single-device K1 at every size measured
(PERF.md), and the reference's gate of 16,384 nodes is far below the
state one card holds; until a cell on several cards shows that the gate pays there, a
deployment that wants the mesh installs it.

PyTorch has no sharded tensor, so a sharded leaf is a ``ShardedTensor``:
its blocks, block s on the mesh's device s, behind the few tensor
attributes the routing reads (shape, dtype, device).  Replicated leaves
are plain tensors on the mesh's first device; ``shard_view`` copies them
to another shard's device where that differs (a cost only on meshes over
several cards).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch

NODE_AXIS = "nodes"

# SolverInputs leaves with a leading node axis, and the [S, N] leaves
# (trailing node axis): the sharded layout splits these and replicates
# the rest (the reference's solver_input_shardings).
NODE_FIELDS = frozenset({
    "node_idle", "node_releasing", "node_used", "node_alloc",
    "node_count", "node_max_tasks", "node_exists", "node_ports",
    "node_selcnt", "node_coords"})
SIG_FIELDS = frozenset({"sig_mask", "sig_bonus"})


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """The shards' devices in shard order, on the one axis NODE_AXIS."""

    __slots__ = ("devices",)

    def __init__(self, devices):
        self.devices = tuple(_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {NODE_AXIS: self.size}

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({', '.join(str(d) for d in self.devices)})"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards over ``devices`` (default: every
    CUDA card, or the CPU where there is none), dealt round robin, so
    ``make_mesh(8)`` on the CPU is 8 CPU shards and ``make_mesh(4,
    ["cuda:0"])`` 4 shards on one card.  ``n_devices`` None: one shard
    per device."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = ([torch.device("cuda", i) for i in range(count)]
                   or [torch.device("cpu")])
    devices = list(devices)
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    n = len(devices) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh([devices[i % len(devices)] for i in range(n)])


_lock = threading.Lock()
_installed: Optional[Mesh] = None   # guarded-by: _lock


def default_mesh() -> Optional[Mesh]:
    """The mesh the routing gates shard over: the one ``use_mesh``
    installed, else None (see the module's docstring)."""
    with _lock:
        return _installed


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Install ``mesh`` (None: no mesh) as ``default_mesh()`` for the
    block, process-wide: the tests' CPU meshes and chip_smoke.py's shards
    on one card.  The previous choice is restored on exit."""
    global _installed
    with _lock:
        before, _installed = _installed, mesh
    try:
        yield mesh
    finally:
        with _lock:
            _installed = before


class ShardedTensor:
    """A tensor split on ``axis`` into ``mesh.size`` contiguous blocks of
    equal length, block s on ``mesh.devices[s]``.  ``shape``, ``dtype``
    and ``device`` (the first shard's) describe the whole, so shape-only
    readers (the routing gates, the compile-cache keys) need no change;
    ``full()`` gathers it onto one device."""

    __slots__ = ("parts", "axis", "mesh")

    def __init__(self, parts, axis: int, mesh: Mesh):
        self.parts = tuple(parts)
        self.axis = axis
        self.mesh = mesh

    @property
    def shape(self) -> torch.Size:
        shape = list(self.parts[0].shape)
        shape[self.axis] = sum(p.shape[self.axis] for p in self.parts)
        return torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def is_cuda(self) -> bool:
        return self.parts[0].is_cuda

    def clone(self) -> "ShardedTensor":
        return ShardedTensor([p.clone() for p in self.parts], self.axis,
                             self.mesh)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default the first shard's)."""
        dev = self.device if device is None else torch.device(device)
        return torch.cat([p.to(dev) for p in self.parts], dim=self.axis)

    def __array__(self, dtype=None, copy=None):
        out = self.full("cpu").numpy()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype},"
                f" axis={self.axis}, {self.mesh!r})")


def split(x, mesh: Mesh, axis: int) -> ShardedTensor:
    """``x`` (a tensor or numpy array whose ``axis`` divides by the mesh)
    as a ShardedTensor, each block a contiguous tensor on its device."""
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) \
        else x
    n = t.shape[axis]
    if n % mesh.size:
        raise ValueError(f"axis {axis} of length {n} does not divide into "
                         f"{mesh.size} shards")
    step = n // mesh.size
    return ShardedTensor(
        [t.narrow(axis, s * step, step).to(dev).contiguous()
         for s, dev in enumerate(mesh.devices)], axis, mesh)


def shard_solver_inputs(inp, mesh: Mesh):
    """SolverInputs (numpy or tensor leaves) in the mesh layout: the
    node-major leaves split into row blocks, ``sig_mask`` and
    ``sig_bonus`` on their second axis, every other leaf replicated on
    the mesh's first device."""
    first = mesh.devices[0]
    out = {}
    for name, leaf in zip(inp._fields, inp):
        if name in NODE_FIELDS:
            out[name] = split(leaf, mesh, 0)
        elif name in SIG_FIELDS:
            out[name] = split(leaf, mesh, 1)
        else:
            out[name] = torch.as_tensor(np.asarray(leaf)).to(first) \
                if not isinstance(leaf, torch.Tensor) else leaf.to(first)
    return type(inp)(**out)


def shard_mesh(inp) -> Optional[Mesh]:
    """The mesh of ``inp``'s sharded leaves, or None."""
    leaf = inp.node_idle
    return leaf.mesh if isinstance(leaf, ShardedTensor) else None


def shard_view(inp, s: int):
    """Shard ``s``'s inputs: its block of every sharded leaf, and the
    replicated leaves on its device."""
    mesh = shard_mesh(inp)
    dev = mesh.devices[s]
    return type(inp)(*(
        leaf.parts[s] if isinstance(leaf, ShardedTensor) else leaf.to(dev)
        for leaf in inp))


def gathered(inp):
    """``inp`` with every sharded leaf gathered onto the first shard's
    device (the single-device programs' layout); itself when nothing is
    sharded."""
    if not any(isinstance(leaf, ShardedTensor) for leaf in inp):
        return inp
    return type(inp)(*(leaf.full() if isinstance(leaf, ShardedTensor)
                       else leaf for leaf in inp))
