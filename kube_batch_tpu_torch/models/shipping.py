"""Host->device shipping of SolverInputs against a device-resident buffer.

Counterpart of the single-device half of kube_batch_tpu/models/shipping.py.
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
"""

from __future__ import annotations

import numpy as np
import torch

from .. import knobs
from ..device import check_float_dtype, resolve_device
from ..metrics import memledger, metrics
from ..ops.solver import SolverInputs
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


def _unpack(spec, float_dtype: torch.dtype, flat: torch.Tensor) -> SolverInputs:
    """Each leaf as a dtype view of its byte range of ``flat`` (a copy
    when the range is not aligned to the leaf's element width)."""
    flat = flat.reshape(-1)
    leaves = []
    for kind, off, size, shape in spec:
        if kind == "b":
            leaves.append(flat[off:off + size].view(torch.bool).view(shape))
            continue
        dtype = torch.int32 if kind == "i" else float_dtype
        width = dtype.itemsize
        seg = flat[off:off + size * width]
        if (seg.data_ptr() % width) != 0:
            seg = seg.clone()
        leaves.append(seg.view(dtype).view(shape))
    return SolverInputs(*leaves)


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
    if st is not None:
        n += _buf_nbytes(st.host_flat) + _buf_nbytes(st.device_flat)
    return n


class DeviceResidentShipper:
    """Delta shipping against a device-resident SolverInputs buffer.

    Full re-ship triggers: first session, any layout change (padded
    bucket, leaf spec, float dtype), any solver-config change, a dirty
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

        recycle = knobs.WIRE_FAST.enabled()
        scratch = None
        if recycle:
            scratch, self._scratch = self._scratch, None
        spec, flat = _pack_host(inp, np_float, pad_to=_BLOCK, out=scratch)
        layout = (spec, np.dtype(np_float).str, cfg)
        st = self._state
        if st is not None and st.layout == layout:
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
