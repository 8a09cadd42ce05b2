"""Bounded `_wire_doc` baseline store (doc/INGEST.md).

The wire fast path retains each mirror object's raw wire doc as its
delta baseline — roughly one raw dict per pod, the largest remaining
O(cluster) memory term at 1M pods.  ``KUBE_BATCH_TPU_BASELINE_BUDGET``
caps the retained bytes per kind; over budget the reflector compresses
the COLDEST baselines (zlib of the canonical JSON, ``_wire_zdoc``)
and, still over, evicts them outright (``_wire_evicted``).  A later
frame for a compressed baseline decompresses transparently
(codec.wire_baseline); a frame for an evicted one takes the counted
full-decode fallback (``kube_batch_wire_fast_fallback_total
{reason="evicted"}``) and re-retains hot.  The per-kind ledger
(`RemoteCluster._baseline_bytes` -> ``kube_batch_wire_baseline_bytes``)
tracks the compressed/evicted sizes, so the gauge only goes DOWN at a
fixed workload once a budget binds.

Budget grammar (bytes, case-insensitive k/M/G suffixes):

    KUBE_BATCH_TPU_BASELINE_BUDGET=32M            # every kind
    KUBE_BATCH_TPU_BASELINE_BUDGET=pods=32M,podgroups=512k

Unset or empty = unbounded (the pre-budget behavior).
"""

from __future__ import annotations

import json
import zlib
from typing import Dict, Optional

from .. import knobs

BASELINE_BUDGET_ENV = knobs.BASELINE_BUDGET.env

_SUFFIX = {"k": 1024, "m": 1024 ** 2, "g": 1024 ** 3}


def _parse_size(text: str) -> int:
    text = text.strip()
    mult = 1
    if text and text[-1].lower() in _SUFFIX:
        mult = _SUFFIX[text[-1].lower()]
        text = text[:-1]
    value = int(float(text) * mult)
    if value < 0:
        raise ValueError(f"negative baseline budget {text!r}")
    return value


def parse_budgets(spec: Optional[str] = None) -> Dict[str, int]:
    """{kind: byte budget} from the env grammar above; {} = unbounded.
    A bare number applies to every kind under the ``*`` key (the client
    resolves per-kind lookups through it).  Malformed specs raise
    ValueError at construction — a budget typo must fail loudly at
    boot, not silently disable the cap."""
    if spec is None:
        spec = knobs.BASELINE_BUDGET.raw() or ""
    spec = spec.strip()
    if not spec:
        return {}
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            kind, _, size = part.partition("=")
            out[kind.strip()] = _parse_size(size)
        else:
            out["*"] = _parse_size(part)
    return out


def budget_for(budgets: Dict[str, int], kind: str) -> Optional[int]:
    """The byte cap for one kind, or None when unbounded."""
    if kind in budgets:
        return budgets[kind]
    return budgets.get("*")


def compress(obj) -> Optional[int]:
    """Compress a mirror object's hot baseline (``_wire_doc`` ->
    ``_wire_zdoc``); returns the new retained byte size, or None when
    there is nothing hot to compress (already cold, already evicted, or
    never retained).  Key order is preserved by json, so a later
    decompress round-trips the exact doc the delta compare needs."""
    doc = getattr(obj, "_wire_doc", None)
    if not isinstance(doc, dict):
        return None
    z = zlib.compress(
        json.dumps(doc, separators=(",", ":")).encode(), 6)
    try:
        obj._wire_zdoc = z
        del obj._wire_doc
    except AttributeError:  # lint: allow-swallow(slotted/frozen object: leave it hot rather than half-converted)
        return None
    return len(z)


def evict(obj) -> bool:
    """Drop a mirror object's baseline entirely (over budget even after
    compression).  The next frame for this key takes the counted
    full-decode fallback and re-retains the fresh doc hot.  Returns
    False when the object is slotted/frozen and could not be marked."""
    try:
        if hasattr(obj, "_wire_doc"):
            del obj._wire_doc
        if hasattr(obj, "_wire_zdoc"):
            del obj._wire_zdoc
        obj._wire_evicted = True
    except AttributeError:  # lint: allow-swallow(slotted/frozen object: nothing was retained on it to begin with)
        return False
    return True
