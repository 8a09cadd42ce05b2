"""Wire codec: the framework's API objects <-> JSON.

The reference rides Kubernetes' generated JSON marshalling; this standalone
framework encodes its dataclass object model reflectively.  Every wire
document carries a ``__kind__`` tag (module-qualified for the CRD versions,
whose class names collide across v1alpha1/v1alpha2); decoding rebuilds the
dataclass tree from type hints.  Tuples flatten to JSON lists — all
consumers unpack positionally, so round-tripping preserves semantics.
"""

from __future__ import annotations

import dataclasses
import functools
import typing
from typing import Any, Dict

from ..api import objects as _objects
from ..apis.scheduling import v1alpha1, v1alpha2
# The wire-fast gate lives with the other incremental-control knobs
# (models/incremental.py): =0 restores the sequential control — every
# watch frame fully materializes a fresh dataclass tree, no field reuse,
# no raw-doc caching.  The CI wire A/B (`make bench-wire`) pins
# binds+events bit-identical across the flag at every churn level.
from ..models.incremental import (WIRE_FAST_ENV,  # noqa: F401
                                  wire_fast_enabled)


def _kind_of(cls) -> str:
    module = cls.__module__.rsplit(".", 1)[-1]
    if module in ("v1alpha1", "v1alpha2"):
        return f"{module}.{cls.__name__}"
    return cls.__name__


_TOP_LEVEL = [
    _objects.Pod, _objects.Node, _objects.PriorityClass,
    _objects.PodDisruptionBudget, _objects.PersistentVolumeClaim,
    _objects.Event, _objects.PodCondition,
    v1alpha1.PodGroup, v1alpha1.Queue,
    v1alpha2.PodGroup, v1alpha2.Queue,
]
_BY_KIND = {_kind_of(cls): cls for cls in _TOP_LEVEL}


@functools.lru_cache(maxsize=None)
def _field_names(cls) -> tuple:
    return tuple(f.name for f in dataclasses.fields(cls))


def _encode_value(v):
    """dataclasses.asdict semantics minus the per-leaf deepcopy: the
    result feeds json.dumps immediately, so sharing leaf references is
    safe and ~10x cheaper (the codec was the watch/LIST bottleneck)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {name: _encode_value(getattr(v, name))
                for name in _field_names(type(v))}
    if isinstance(v, (list, tuple)):
        return [_encode_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _encode_value(x) for k, x in v.items()}
    return v


def encode(obj) -> Dict[str, Any]:
    doc = _encode_value(obj)
    doc["__kind__"] = _kind_of(type(obj))
    return doc


def _decoder_for(typ):
    """Callable(value) -> decoded, or None (identity) — computed ONCE
    per field type by _decode_plan; the old path re-resolved
    typing.get_type_hints and get_origin per OBJECT, which dominated
    watch-echo and LIST ingest."""
    origin = typing.get_origin(typ)
    if origin is typing.Union:  # Optional[T]
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        if not args:
            return None
        inner = _decoder_for(args[0])
        if inner is None:
            return None
        return lambda v, _i=inner: None if v is None else _i(v)
    if origin in (list, tuple) or typ is list:
        args = typing.get_args(typ)
        inner = _decoder_for(args[0]) if args else None
        if inner is None:
            # Copy unconditionally and pass None through: returning the
            # wire doc's own list would alias the decoded object to it,
            # and list(None) would raise where a null element inside a
            # nested List[List[T]] used to decode to None.
            return lambda v: None if v is None else list(v)
        return (lambda v, _i=inner:
                None if v is None else [_i(x) for x in v])
    if origin is dict or typ is dict:
        return lambda v: None if v is None else dict(v)
    if dataclasses.is_dataclass(typ):
        return (lambda v, _c=typ: _decode_dataclass(_c, v)
                if isinstance(v, dict) else v)
    return None


@functools.lru_cache(maxsize=None)
def _decode_plan(cls) -> tuple:
    """((field_name, decoder-or-None), ...) resolved once per class."""
    hints = typing.get_type_hints(cls)
    return tuple((f.name, _decoder_for(hints.get(f.name, Any)))
                 for f in dataclasses.fields(cls))


def _decode_dataclass(cls, data: Dict[str, Any]):
    kwargs = {}
    for name, dec in _decode_plan(cls):
        if name in data:
            v = data[name]
            kwargs[name] = v if dec is None or v is None else dec(v)
    return cls(**kwargs)


def decode(doc: Dict[str, Any]):
    kind = doc.get("__kind__")
    cls = _BY_KIND.get(kind)
    if cls is None:
        raise ValueError(f"unknown wire kind {kind!r}")
    data = {k: v for k, v in doc.items() if k != "__kind__"}
    return _decode_dataclass(cls, data)


# ---------------------------------------------------------------------------
# Columnar delta decode (the wire-to-tensor fast path, doc/INCREMENTAL.md):
# a watch frame for an ALREADY-KNOWN object re-decodes only its changed
# fields.  The previous decode cached its raw wire doc on the object
# (``_wire_doc``); the delta plan walks the columnar ``_decode_plan`` and
# compares RAW JSON values field by field — a C-level dict/list compare,
# ~10x cheaper than re-decoding — reusing the previously-decoded subtree
# for every unchanged field.  Reuse preserves sub-object IDENTITY, which
# is what keeps the tensorizer's per-pod signature cache
# (models/tensor_snapshot._pod_static, keyed on ``pod.spec`` identity)
# warm across the watch echo of a bind: the echo changes status/metadata,
# the spec bytes are identical, so the spec object itself is reused and
# no signature re-derivation runs.  A reused subtree is a pure function
# of its raw bytes (decode has no hidden inputs), so the delta result
# equals the full decode bit for bit (tests/test_wire_fast.py fuzzes
# this); sharing is safe under the object model's immutability contract
# (api/objects.PodSpec docstring — update paths replace, never mutate).
# ---------------------------------------------------------------------------

_WIRE_DOC_ATTR = "_wire_doc"


@functools.lru_cache(maxsize=None)
def _delta_plan(cls) -> tuple:
    """((field_name, decoder-or-None, dataclass-cls-or-None), ...): the
    columnar decode plan with the recursion target exposed, resolved
    once per class like ``_decode_plan``."""
    hints = typing.get_type_hints(cls)
    out = []
    for f in dataclasses.fields(cls):
        typ = hints.get(f.name, Any)
        sub = None
        if dataclasses.is_dataclass(typ):
            sub = typ
        elif typing.get_origin(typ) is typing.Union:  # Optional[T]
            args = [a for a in typing.get_args(typ) if a is not type(None)]
            if len(args) == 1 and dataclasses.is_dataclass(args[0]):
                sub = args[0]
        out.append((f.name, _decoder_for(typ), sub))
    return tuple(out)


def _decode_dataclass_delta(cls, data: Dict[str, Any], prev,
                            prev_data: Dict[str, Any]):
    kwargs = {}
    for name, dec, sub in _delta_plan(cls):
        if name not in data:
            # Absent on the wire -> class default, exactly like the full
            # decode (whatever prev carried is irrelevant: the full path
            # would not see it either).
            continue
        v = data[name]
        if name in prev_data and v == prev_data[name]:
            # Raw bytes identical: the decoded subtree is a pure
            # function of them — reuse it (identity-preserving).
            kwargs[name] = getattr(prev, name)
            continue
        if (sub is not None and isinstance(v, dict)
                and isinstance(prev_data.get(name), dict)):
            pv = getattr(prev, name, None)
            if dataclasses.is_dataclass(pv) and not isinstance(pv, type):
                kwargs[name] = _decode_dataclass_delta(
                    sub, v, pv, prev_data[name])
                continue
        kwargs[name] = v if dec is None or v is None else dec(v)
    return cls(**kwargs)


def remember_wire_doc(obj, doc: Dict[str, Any]) -> None:
    """Stamp the raw wire doc the object was decoded from — the delta
    baseline for the NEXT frame of the same key.  Instance attribute:
    dataclass ``__eq__`` ignores it, encode never re-emits it.  Objects
    that refuse attributes simply never serve as a delta baseline."""
    try:
        obj._wire_doc = doc
    except AttributeError:  # lint: allow-swallow(slotted/foreign object: the next frame falls back to a full decode, which is always correct)
        pass


def wire_baseline(prev) -> Dict[str, Any]:
    """The retained raw-doc delta baseline for ``prev``: the hot
    ``_wire_doc`` dict, or transparently decompressed from the budget
    store's cold form (``_wire_zdoc``, edge/baseline.py).  Raises
    LookupError("evicted") when the baseline budget evicted it (the
    client counts the full-decode fallback under that reason) and
    LookupError("baseline") when nothing was ever retained."""
    data = getattr(prev, _WIRE_DOC_ATTR, None)
    if isinstance(data, dict):
        return data
    z = getattr(prev, "_wire_zdoc", None)
    if z is not None:
        import json
        import zlib
        return json.loads(zlib.decompress(z))
    raise LookupError(
        "evicted" if getattr(prev, "_wire_evicted", False)
        else "baseline")


def decode_delta(doc: Dict[str, Any], prev):
    """Decode a native-wire doc against the previously decoded ``prev``,
    re-decoding only changed fields.  Raises ValueError on anything the
    full decode would reject; any OTHER trouble (missing baseline, type
    flip) must be handled by the caller falling back to ``decode`` —
    edge/client counts those falls via
    ``kube_batch_wire_fast_fallback_total``."""
    kind = doc.get("__kind__")
    cls = _BY_KIND.get(kind)
    if cls is None:
        raise ValueError(f"unknown wire kind {kind!r}")
    if type(prev) is not cls:
        raise LookupError("no delta baseline")
    prev_data = wire_baseline(prev)
    if not isinstance(prev_data, dict):
        raise LookupError("no delta baseline")
    data = {k: v for k, v in doc.items() if k != "__kind__"}
    obj = _decode_dataclass_delta(cls, data, prev, prev_data)
    remember_wire_doc(obj, data)
    _carry_tensor_static(prev, obj)
    return obj


def _carry_tensor_static(prev, obj) -> None:
    """Carry the tensorizer's per-pod static-signature cache across a
    delta decode that reused the spec OBJECT (the cache is keyed on spec
    identity — models/tensor_snapshot._pod_static; validity is exactly
    ``cached[0] is spec``, so the carry holds the same contract the
    cache's own probe enforces).  This is the wire→tensor handoff: a
    status-only watch echo re-derives NOTHING for the signature path."""
    cached = getattr(prev, "_tensor_static", None)
    if cached is not None and cached[0] is getattr(obj, "spec", None):
        try:
            obj._tensor_static = cached
        except AttributeError:  # lint: allow-swallow(slotted object: the signature simply re-derives, which is the full-decode behavior)
            pass
