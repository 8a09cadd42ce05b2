"""Host->device shipping of SolverInputs against a device-resident buffer.

Counterpart of kube_batch_tpu/models/shipping.py.
``_pack_host`` flattens every leaf into one host byte image, in the leaf
order of SolverInputs and with the final device dtypes applied.  The
``DeviceResidentShipper`` keeps that image resident on the device as one
flat uint8 tensor viewed as [blocks, 512], and each session ships only the
512-byte blocks whose bytes changed, written in place with
``index_copy_``.  A layout change (bucket, dtype, leaf spec) or a solver
config change falls back to a full ship.  The returned leaves are dtype
views of the resident tensor (a copy only where a leaf's byte offset is
not aligned to its width), so a delta-shipped image is bit-identical to a
full ship of the same staging by construction.

Consumers must not write into the returned leaves: the resident tensor is
the delta baseline.  The solve builds fresh buffers from them
(ops/cuda_solver.build_buffers).  A later delta ship rewrites the aligned
leaves in place, ordered after earlier work on the same stream.

A shipper works on the current stream.  The scheduler runs every session
over a tenancy shard view inside ``torch.cuda.stream(<the view's
stream>)`` (tenancy/view.py), so a view's resident image is only ever
shipped, read and rewritten on that one stream, and two shards' ships,
kernels and readbacks never queue behind each other.  Tensors a
discarded dispatch still reads are freed to the caching allocator under
their allocation stream, which reuses them only for later work on that
same stream: no ``record_stream`` is needed.

When ``ops.solver.choose_solver_mesh`` routes the solve to the
node-sharded mesh (parallel/), the shipper keeps the sharded resident
layout instead: each shard's own flat buffer, on its shard's device,
holds its contiguous node rows of every node-major leaf, each leaf padded
to a 512-byte block boundary, with the [S, N] signature leaves stored
node-major ([n_local, S]) so one dirty node touches O(1) blocks; the
replicated leaves (tasks, jobs, queues, cluster) live in one more buffer
on the mesh's first device.  Dirty blocks are found and written per
shard: a churn cycle ships bytes only to the shards whose node rows
changed, and a clean shard's buffer is not touched.  The returned node
leaves are ``parallel.mesh.ShardedTensor``s whose blocks are views of the
shards' buffers, in the layout the sharded solve reads, so the solve
never moves a node row between shards.  The generation contract (a
clean ship keeps it) is the same in both layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import knobs
from ..device import check_float_dtype, resolve_device
from ..metrics import memledger, metrics
from ..ops.solver import SolverInputs
from ..parallel.mesh import NODE_FIELDS, SIG_FIELDS, ShardedTensor
from ..trace import spans as trace

# Dirty-detection granularity: 64 int64 words per block.
_BLOCK = 512
# Beyond this dirty fraction a full ship moves fewer bytes than the blocks
# plus their index.
_DELTA_MAX_FRACTION = 0.5


def _kind_of(dtype: np.dtype) -> str:
    if dtype == np.bool_:
        return "b"
    if dtype.kind in "iu":
        return "i"
    return "f"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _np_float(float_dtype: torch.dtype):
    return np.float32 if float_dtype == torch.float32 else np.float64


def _pack_host(inp, float_dtype, pad_to: int = 1, out=None):
    """Flatten every leaf into one host byte buffer with final device
    dtypes applied (ints -> int32, floats -> float_dtype, bools -> one
    byte); returns (spec, flat_u8).  ``pad_to`` zero-pads the tail to a
    multiple.  ``out``: a retired host buffer to pack into when its
    length matches, so the steady cycle does not allocate a fresh flat
    buffer per ship."""
    float_dtype = np.dtype(float_dtype)
    fwidth = float_dtype.itemsize
    spec = []
    bufs = []
    byte_off = 0
    for leaf in inp:
        arr = _host(leaf)
        shape = arr.shape
        kind = _kind_of(arr.dtype)
        if kind == "f":
            arr = arr.astype(float_dtype, copy=False)
            width = fwidth
        elif kind == "i":
            arr = arr.astype(np.int32, copy=False)
            width = 4
        else:
            arr = arr.astype(np.uint8, copy=False)
            width = 1
        flat = np.ravel(arr)
        spec.append((kind, byte_off, flat.size, shape))
        bufs.append(flat.view(np.uint8))
        byte_off += flat.size * width
    if not bufs:
        bufs.append(np.zeros(1, np.uint8))
        byte_off = 1
    total = byte_off
    if pad_to > 1 and byte_off % pad_to:
        pad = pad_to - byte_off % pad_to
        bufs.append(np.zeros(pad, np.uint8))
        total += pad
    if out is not None and out.nbytes == total:
        off = 0
        for b in bufs:
            out[off:off + b.size] = b
            off += b.size
        return tuple(spec), out
    return tuple(spec), np.concatenate(bufs)


def _leaf_view(flat: torch.Tensor, kind: str, off: int, size: int, shape,
               float_dtype: torch.dtype) -> torch.Tensor:
    """One leaf as a dtype view of its byte range of the 1-D ``flat`` (a
    copy when the range is not aligned to the leaf's element width)."""
    if kind == "b":
        return flat[off:off + size].view(torch.bool).view(shape)
    dtype = torch.int32 if kind == "i" else float_dtype
    width = dtype.itemsize
    seg = flat[off:off + size * width]
    if (seg.data_ptr() % width) != 0:
        seg = seg.clone()
    return seg.view(dtype).view(shape)


def _unpack_leaves(spec, float_dtype: torch.dtype, flat: torch.Tensor):
    flat = flat.reshape(-1)
    return [_leaf_view(flat, kind, off, size, shape, float_dtype)
            for kind, off, size, shape in spec]


def _unpack(spec, float_dtype: torch.dtype,
            flat: torch.Tensor) -> SolverInputs:
    """Each leaf as a dtype view of its byte range of ``flat`` (a copy
    when the range is not aligned to the leaf's element width)."""
    return SolverInputs(*_unpack_leaves(spec, float_dtype, flat))


def _typed(leaf, np_float):
    """(host array in its device dtype, kind, element width)."""
    arr = _host(leaf)
    kind = _kind_of(arr.dtype)
    if kind == "f":
        return arr.astype(np_float, copy=False), kind, np.dtype(
            np_float).itemsize
    if kind == "i":
        return arr.astype(np.int32, copy=False), kind, 4
    return arr.astype(np.uint8, copy=False), kind, 1


def _pack_host_sharded(inp, np_float, n_dev: int):
    """Stage ``inp`` for the sharded resident layout.  Returns (spec_rep,
    spec_shard, rep_pos, node_pos, rep_flat, shard_flat): ``rep_flat`` is
    the replicated leaves' bytes, packed as ``_pack_host`` packs them and
    block-padded; ``shard_flat`` is [n_dev, shard_bytes], row s shard s's
    node rows of every node-major leaf, each leaf zero-padded to a block
    boundary so the offsets are the same in every shard.  ``spec_shard``
    rows are (kind, local byte offset, local size, local packed shape,
    is_sig); ``rep_pos`` / ``node_pos`` are each region's leaves' places
    in SolverInputs."""
    n_total = int(_host(inp.node_idle).shape[0])
    n_local = n_total // n_dev
    rep_spec, rep_bufs, rep_off = [], [], 0
    shard_spec = []
    shard_parts = [[] for _ in range(n_dev)]
    local_off = 0
    rep_pos, node_pos = [], []
    for i, (name, leaf) in enumerate(zip(SolverInputs._fields, inp)):
        arr, kind, width = _typed(leaf, np_float)
        if name in NODE_FIELDS or name in SIG_FIELDS:
            node_pos.append(i)
            sig = name in SIG_FIELDS
            lshape = ((n_local, arr.shape[0]) if sig
                      else (n_local,) + arr.shape[1:])
            lsize = int(np.prod(lshape, dtype=np.int64))
            shard_spec.append((kind, local_off, lsize, tuple(lshape), sig))
            seg = lsize * width
            pad = (-seg) % _BLOCK
            for sh in range(n_dev):
                rows = slice(sh * n_local, (sh + 1) * n_local)
                piece = arr[:, rows].T if sig else arr[rows]
                flat = np.ascontiguousarray(piece).reshape(-1).view(np.uint8)
                if pad:
                    flat = np.concatenate([flat, np.zeros(pad, np.uint8)])
                shard_parts[sh].append(flat)
            local_off += seg + pad
        else:
            rep_pos.append(i)
            flat = np.ravel(arr)
            rep_spec.append((kind, rep_off, flat.size, arr.shape))
            rep_bufs.append(flat.view(np.uint8))
            rep_off += flat.size * width
    if rep_off % _BLOCK:
        rep_bufs.append(np.zeros(_BLOCK - rep_off % _BLOCK, np.uint8))
    rep_flat = np.concatenate(rep_bufs)
    shard_flat = np.stack([np.concatenate(parts) for parts in shard_parts])
    return (tuple(rep_spec), tuple(shard_spec), tuple(rep_pos),
            tuple(node_pos), rep_flat, shard_flat)


def _unpack_sharded(st: "_ShardShipState") -> SolverInputs:
    """SolverInputs over the two resident regions, no byte moved: the
    replicated leaves are views of the replicated buffer, and each node
    leaf is a ShardedTensor of views of the shards' own buffers (the
    [S, N] leaves transposed back from their node-major packing)."""
    leaves = [None] * len(SolverInputs._fields)
    for pos, leaf in zip(st.rep_pos, _unpack_leaves(
            st.spec_rep, st.float_dtype, st.rep_flat)):
        leaves[pos] = leaf
    flats = [buf.reshape(-1) for buf in st.shard_arrays]
    for pos, (kind, off, size, lshape, sig) in zip(st.node_pos,
                                                   st.spec_shard):
        parts = []
        for flat in flats:
            part = _leaf_view(flat, kind, off, size, lshape, st.float_dtype)
            parts.append(part.T if sig else part)
        leaves[pos] = ShardedTensor(parts, 1 if sig else 0, st.mesh)
    return SolverInputs(*leaves)


def _scatter_shard(shard_blk: torch.Tensor, idx: torch.Tensor,
                   blocks: torch.Tensor) -> torch.Tensor:
    """Overwrite the dirty blocks of ONE shard's resident buffer in place
    (the reference's donated scatter), ordered on the current stream
    after earlier readers.  Runs for dirty shards only: a clean shard's
    buffer is never touched."""
    return shard_blk.index_copy_(0, idx, blocks)


def _float_dtype_of(inp) -> torch.dtype:
    """The float key dtype the staging carries (its job_ts leaf)."""
    leaf = inp.job_ts
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.float32 if np.asarray(leaf).dtype == np.float32 \
        else torch.float64


class _ShipState:
    """The device-resident image of the last shipped layout."""
    __slots__ = ("layout", "spec", "float_dtype", "host_flat", "device_flat",
                 "inputs")


class _ShardShipState:
    """The sharded resident image: each shard's own node buffer on its
    device (written one by one, so clean shards are never touched), the
    replicated buffer on the mesh's first device, and the exact host
    bytes last shipped of each region."""
    __slots__ = ("layout", "spec_rep", "spec_shard", "rep_pos", "node_pos",
                 "float_dtype", "mesh", "host_rep", "host_shard", "rep_flat",
                 "shard_arrays", "inputs")


def _buf_nbytes(buf) -> int:
    if buf is None:
        return 0
    if isinstance(buf, torch.Tensor):
        return buf.numel() * buf.element_size()
    return int(buf.nbytes)


def _resident_nbytes(sh: "DeviceResidentShipper") -> int:
    """Host + device bytes pinned by the resident image plus the
    recycled host pack scratch.  Reads sizes only: no device call."""
    n = _buf_nbytes(sh._scratch)
    st = sh._state
    if isinstance(st, _ShipState):
        n += _buf_nbytes(st.host_flat) + _buf_nbytes(st.device_flat)
    elif isinstance(st, _ShardShipState):
        n += (_buf_nbytes(st.host_rep) + _buf_nbytes(st.host_shard)
              + _buf_nbytes(st.rep_flat)
              + sum(_buf_nbytes(b) for b in st.shard_arrays))
    return n


class DeviceResidentShipper:
    """Delta shipping against a device-resident SolverInputs buffer.

    Full re-ship triggers: first session, any layout change (padded
    bucket, leaf spec, float dtype, a flip between the single-device and
    the sharded layout or a new mesh), any solver-config change, a dirty
    fraction above _DELTA_MAX_FRACTION, or KUBE_BATCH_TPU_DELTA_SHIP=0.
    The returned leaves are bit-identical to a full ship of the same
    staging in every mode.

    Memory accounting (metrics/memledger.py):
    # mem-ledger: resident

    Every ship counts ``kube_batch_tpu_ship_total{mode}`` and its bytes,
    and tags the enclosing trace span with mode and bytes."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._state: _ShipState | None = None
        # Retired host-only pack buffer, reused by the next pack.
        self._scratch = None
        self.last_mode: str = ""   # "full" | "delta" | "clean"
        self.last_bytes: int = 0   # bytes the last ship moved to the device
        # Byte-generation of the resident image: moves whenever the
        # shipped bytes change (full or delta ship, or an invalidation)
        # and stays put on a clean ship.
        self.generation: int = 0
        # Owning cache identity (resident_shipper's aliasing guard).
        self._owner_id = None
        self._mem_key = memledger.ledger("resident").track(
            self, sizer=_resident_nbytes)

    def _mem_refresh(self) -> None:
        """Re-price the resident ledger (every ship() return and
        invalidate(): where the image or the pack scratch is rebound)."""
        memledger.ledger("resident").set(self._mem_key,
                                         _resident_nbytes(self))

    def invalidate(self) -> None:
        """Drop the resident image so the next ship is a full one.  Every
        degradation path calls this after a device failure: a delta ship
        that died midway has already rewritten part of the resident
        tensor in place, so it must never serve as the next baseline.
        Bumps the generation, so nothing keyed to the dropped image is
        reused.  It only drops references and launches nothing, so it is
        safe after a sticky CUDA error."""
        self._state = None
        self.generation += 1
        self._mem_refresh()

    def _to_device(self, flat: np.ndarray) -> torch.Tensor:
        # copy=True: the resident tensor never aliases a host buffer that
        # a later pack may overwrite.
        return torch.from_numpy(flat.reshape(-1, _BLOCK)).to(self.device,
                                                             copy=True)

    def ship(self, inp: SolverInputs, cfg=None,
             float_dtype=None) -> SolverInputs:
        """Ship ``inp`` (numpy or tensor leaves) and return its leaves on
        the device.  ``float_dtype`` is the float key dtype, by default
        the dtype of the staging's float leaves."""
        out = self._ship(inp, cfg, float_dtype)
        self._mem_refresh()
        metrics.note_ship(self.last_mode, self.last_bytes)
        trace.note_ship(self.last_mode, self.last_bytes)
        return out

    def _ship(self, inp: SolverInputs, cfg, float_dtype) -> SolverInputs:
        float_dtype = check_float_dtype(
            float_dtype if float_dtype is not None else _float_dtype_of(inp))
        np_float = _np_float(float_dtype)
        if not knobs.DELTA_SHIP.enabled():
            self._state = None  # clean A/B: no stale image survives
            self.generation += 1
            spec, flat = _pack_host(inp, np_float, pad_to=_BLOCK)
            self.last_mode = "full"
            self.last_bytes = flat.nbytes
            return _unpack(spec, float_dtype, self._to_device(flat))

        # One routing chokepoint (ops/solver.py): when the solve will run
        # sharded over the mesh, the resident image is kept in the mesh
        # layout, by the same gate.
        from ..ops.solver import choose_solver_mesh
        route, mesh = choose_solver_mesh(inp)
        if route == "sharded":
            return self._ship_sharded(inp, cfg, float_dtype, np_float, mesh)

        recycle = knobs.WIRE_FAST.enabled()
        scratch = None
        if recycle:
            scratch, self._scratch = self._scratch, None
        spec, flat = _pack_host(inp, np_float, pad_to=_BLOCK, out=scratch)
        layout = (spec, np.dtype(np_float).str, cfg)
        st = self._state
        if isinstance(st, _ShipState) and st.layout == layout:
            idx = self._dirty_blocks(st.host_flat, flat)
            if idx.size == 0:
                self.last_mode = "clean"
                self.last_bytes = 0
                if recycle:
                    self._scratch = flat
                return st.inputs
            if idx.size * _BLOCK <= _DELTA_MAX_FRACTION * flat.nbytes:
                return self._ship_delta(st, flat, idx, recycle)
        return self._ship_full(layout, spec, float_dtype, flat)

    @staticmethod
    def _dirty_blocks(old: np.ndarray, new: np.ndarray) -> np.ndarray:
        diff = (old.view(np.int64) != new.view(np.int64))
        return np.nonzero(diff.reshape(-1, _BLOCK // 8).any(axis=1))[0]

    @staticmethod
    def _dirty_shard_blocks(old: np.ndarray, new: np.ndarray):
        """Per-shard dirty block indices of the [n_dev, shard_bytes]
        images."""
        diff = (old.view(np.int64) != new.view(np.int64)).reshape(
            old.shape[0], -1, _BLOCK // 8).any(axis=2)
        return [np.nonzero(diff[s])[0] for s in range(old.shape[0])]

    # -- the sharded resident layout ---------------------------------------

    def _ship_sharded(self, inp, cfg, float_dtype, np_float,
                      mesh) -> SolverInputs:
        (spec_rep, spec_shard, rep_pos, node_pos, rep_flat,
         shard_flat) = _pack_host_sharded(inp, np_float, mesh.size)
        layout = ("sharded", spec_rep, spec_shard, np.dtype(np_float).str,
                  cfg, mesh)
        st = self._state
        if isinstance(st, _ShardShipState) and st.layout == layout:
            rep_idx = self._dirty_blocks(st.host_rep, rep_flat)
            shard_idx = self._dirty_shard_blocks(st.host_shard, shard_flat)
            dirty = int(rep_idx.size) + sum(int(ix.size) for ix in shard_idx)
            if dirty == 0:
                self.last_mode = "clean"
                self.last_bytes = 0
                return st.inputs
            total = rep_flat.nbytes + shard_flat.nbytes
            if dirty * _BLOCK <= _DELTA_MAX_FRACTION * total:
                return self._ship_sharded_delta(st, rep_flat, shard_flat,
                                                rep_idx, shard_idx)
        st = _ShardShipState()
        st.layout = layout
        st.spec_rep = spec_rep
        st.spec_shard = spec_shard
        st.rep_pos = rep_pos
        st.node_pos = node_pos
        st.float_dtype = float_dtype
        st.mesh = mesh
        # The shipped images, never written after the ship (the delta
        # baselines).
        st.host_rep = rep_flat       # frozen-after: ship
        st.host_shard = shard_flat   # frozen-after: ship
        st.rep_flat = torch.from_numpy(rep_flat.reshape(-1, _BLOCK)).to(
            mesh.devices[0], copy=True)
        blocks = shard_flat.reshape(mesh.size, -1, _BLOCK)
        st.shard_arrays = [torch.from_numpy(blocks[s]).to(dev, copy=True)
                           for s, dev in enumerate(mesh.devices)]
        for s in range(mesh.size):
            metrics.note_ship_shard(s, blocks.shape[1] * _BLOCK)
        st.inputs = _unpack_sharded(st)
        self._state = st
        self.generation += 1
        self.last_mode = "full"
        self.last_bytes = rep_flat.nbytes + shard_flat.nbytes
        return st.inputs

    @staticmethod
    def _update(new2d: np.ndarray, idx: np.ndarray, device):
        """One region's dirty blocks and their indices on ``device``."""
        upd = torch.from_numpy(new2d[idx]).to(device)
        index = torch.from_numpy(idx.astype(np.int64)).to(device)
        return index, upd

    def _ship_sharded_delta(self, st: _ShardShipState, rep_flat: np.ndarray,
                            shard_flat: np.ndarray, rep_idx: np.ndarray,
                            shard_idx) -> SolverInputs:
        nbytes = 0
        if rep_idx.size:
            index, upd = self._update(rep_flat.reshape(-1, _BLOCK), rep_idx,
                                      st.mesh.devices[0])
            st.rep_flat.index_copy_(0, index, upd)
            nbytes += upd.nbytes + index.nbytes
        blocks = shard_flat.reshape(st.mesh.size, -1, _BLOCK)
        for s, dev in enumerate(st.mesh.devices):
            if shard_idx[s].size == 0:
                continue  # a clean shard: untouched, nothing shipped
            index, upd = self._update(blocks[s], shard_idx[s], dev)
            _scatter_shard(st.shard_arrays[s], index, upd)
            metrics.note_ship_shard(s, upd.nbytes + index.nbytes)
            nbytes += upd.nbytes + index.nbytes
        st.host_rep = rep_flat
        st.host_shard = shard_flat
        # Re-unpack: refreshes the copies of unaligned replicated leaves.
        st.inputs = _unpack_sharded(st)
        self.generation += 1
        self.last_mode = "delta"
        self.last_bytes = nbytes
        return st.inputs

    def _ship_full(self, layout, spec, float_dtype,
                   flat: np.ndarray) -> SolverInputs:
        st = _ShipState()
        st.layout = layout
        st.spec = spec
        st.float_dtype = float_dtype
        # The shipped image: dirty-block detection compares against these
        # exact bytes, so it is never written after the ship.
        st.host_flat = flat         # frozen-after: ship
        st.device_flat = self._to_device(flat)
        st.inputs = _unpack(spec, float_dtype, st.device_flat)
        self._state = st
        self.generation += 1
        self.last_mode = "full"
        self.last_bytes = flat.nbytes
        return st.inputs

    def _ship_delta(self, st: _ShipState, flat: np.ndarray, idx: np.ndarray,
                    recycle: bool) -> SolverInputs:
        upd = torch.from_numpy(flat.reshape(-1, _BLOCK)[idx]).to(self.device)
        index = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        st.device_flat.index_copy_(0, index, upd)
        # The replaced baseline never reached the device: recycle it.
        if recycle:
            self._scratch = st.host_flat
        st.host_flat = flat
        # Re-unpack: refreshes the copies of unaligned leaves.
        st.inputs = _unpack(st.spec, st.float_dtype, st.device_flat)
        self.generation += 1
        self.last_mode = "delta"
        self.last_bytes = upd.nbytes + index.nbytes
        return st.inputs


def dirty_shard_probe(inp: SolverInputs, cfg=None, device=None) -> dict:
    """The per-shard O(dirty blocks) proof: full-ship ``inp`` through a
    throwaway resident shipper, dirty ONE node row (row 0, shard 0's),
    delta-ship, and report the bytes each shard received.  On the
    sharded route shard 0 receives one update and every other shard
    none."""
    from ..metrics.metrics import ship_shard_counts
    from ..ops.solver import choose_solver_mesh
    staged = SolverInputs(*(_host(leaf) for leaf in inp))
    route, mesh = choose_solver_mesh(staged)
    probe = {"route": route, "mesh_devices": mesh.size if mesh else 1}
    if route != "sharded":
        return probe
    if not knobs.DELTA_SHIP.enabled():
        # Residency disabled: there is no resident image to delta against.
        probe["mode"] = "disabled"
        return probe
    shipper = DeviceResidentShipper(device or mesh.devices[0])
    shipper.ship(staged, cfg)
    probe["full_bytes"] = int(shipper._state.host_rep.nbytes
                              + shipper._state.host_shard.nbytes)
    dirty = staged._replace(node_used=staged.node_used.copy())
    dirty.node_used[0, 0] += 1  # one row, owned by shard 0
    before = ship_shard_counts()
    shipper.ship(dirty, cfg)
    after = ship_shard_counts()
    probe["mode"] = shipper.last_mode
    probe["per_shard_delta_bytes"] = {
        k: after.get(k, 0) - before.get(k, 0) for k in after}
    return probe


def resident_shipper(owner, device=None) -> DeviceResidentShipper:
    """The owner's persistent shipper, created on first use on ``device``;
    a throwaway instance (always a full ship) for owners that refuse
    attributes.  An owner asked for another device than its shipper's
    gets a new shipper there (the old resident image is dropped).  A
    shipper seen under two owners means two caches share one delta
    baseline, which would silently break bit parity: raise."""
    sh = getattr(owner, "_ship_cache", None)
    if (sh is not None and device is not None
            and sh.device != resolve_device(device)):
        sh = None
    if sh is None:
        sh = DeviceResidentShipper(device)
        try:
            owner._ship_cache = sh
        except AttributeError:
            pass
        else:
            sh._owner_id = id(owner)
    elif sh._owner_id is not None and sh._owner_id != id(owner):
        raise RuntimeError(
            "DeviceResidentShipper aliased across caches: each owner must "
            "have its own resident image (a shared delta baseline would "
            "silently corrupt bit parity)")
    return sh
