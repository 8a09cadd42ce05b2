"""Kubernetes LIST/WATCH selector semantics (labelSelector/fieldSelector).

Real tooling filters server-side: ``kubectl get pods -l app=web`` sends
``?labelSelector=app%3Dweb`` and client-go reflectors routinely watch with
field selectors (e.g. the reference's pod informer could use
``spec.schedulerName``).  This implements the apimachinery selector
grammar the edge needs:

- labelSelector: equality (``k=v``, ``k==v``, ``k!=v``), set-based
  (``k in (a,b)``, ``k notin (a,b)``) and existence (``k``, ``!k``)
  requirements, comma-separated (AND).  Per upstream semantics, ``!=``
  and ``notin`` also select objects *without* the key.
- fieldSelector: ``path=value`` / ``path!=value`` pairs over the small
  fixed set of fields real apiservers index (metadata.name,
  metadata.namespace, and for pods spec.nodeName / status.phase /
  spec.schedulerName).  Unsupported paths raise ValueError, mirroring
  the apiserver's "field label not supported" 400.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional

_SET_RE = re.compile(r"^(?P<key>[^\s!=,]+)\s+(?P<op>in|notin)\s*"
                     r"\((?P<vals>[^)]*)\)$")
_KEY_RE = re.compile(r"^[A-Za-z0-9._/-]+$")   # qualified label key subset
_VAL_RE = re.compile(r"^[A-Za-z0-9._-]*$")    # label value charset


def _key_val(req: str, key: str, val: str):
    key, val = key.strip(), val.strip()
    if not _KEY_RE.match(key) or not _VAL_RE.match(val):
        raise ValueError(f"bad selector requirement {req!r}")
    return key, val


def _split_top(spec: str) -> list:
    """Split on commas that are not inside a ``(...)`` value set."""
    parts, depth, cur = [], 0, []
    for ch in spec:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def parse_label_selector(spec: str) -> Callable[[Dict[str, str]], bool]:
    """Compile a labelSelector string into a predicate over a labels
    dict.  Raises ValueError on a malformed selector."""
    checks = []
    for req in _split_top(spec):
        m = _SET_RE.match(req)
        if m:
            key = m.group("key")
            vals = {v.strip() for v in m.group("vals").split(",")
                    if v.strip()}
            if not _KEY_RE.match(key) or not vals \
                    or not all(_VAL_RE.match(v) for v in vals):
                raise ValueError(f"bad selector requirement {req!r}")
            if m.group("op") == "in":
                checks.append(lambda ls, k=key, vs=vals:
                              k in ls and ls[k] in vs)
            else:  # notin: objects without the key also match
                checks.append(lambda ls, k=key, vs=vals:
                              ls.get(k) not in vs or k not in ls)
            continue
        if "!=" in req:
            key, val = _key_val(req, *req.split("!=", 1))
            # != selects objects without the key too (k8s docs).
            checks.append(lambda ls, k=key, v=val: ls.get(k) != v)
            continue
        if "=" in req:
            key, val = _key_val(
                req, *req.split("==" if "==" in req else "=", 1))
            checks.append(lambda ls, k=key, v=val: ls.get(k) == v)
            continue
        if req.startswith("!"):
            key = req[1:].strip()
            if not _KEY_RE.match(key):
                raise ValueError(f"bad selector requirement {req!r}")
            checks.append(lambda ls, k=key: k not in ls)
            continue
        # Bare existence requirement: must be a well-formed key — a
        # typo like `a!b` must answer 400, not silently never-match.
        if not _KEY_RE.match(req):
            raise ValueError(f"bad selector requirement {req!r}")
        checks.append(lambda ls, k=req: k in ls)
    return lambda labels: all(c(labels) for c in checks)


# The fixed per-resource field index real apiservers expose.
_COMMON_FIELDS = ("metadata.name", "metadata.namespace")
_FIELD_PATHS = {
    "pods": _COMMON_FIELDS + ("spec.nodeName", "spec.schedulerName",
                              "status.phase"),
    # Queue is the tenancy shard key: a chain of ``spec.queue!=<q>``
    # requirements is how a shard-scoped reflector excludes foreign
    # queues' podgroups server-side (doc/INGEST.md).
    "podgroups": _COMMON_FIELDS + ("spec.queue",),
}


def _field_value(resource: str, obj, path: str) -> str:
    md = obj.metadata if hasattr(obj, "metadata") else None
    if md is not None:
        if path == "metadata.name":
            return md.name
        if path == "metadata.namespace":
            return md.namespace
    if resource == "pods":
        if path == "spec.nodeName":
            # Coerce a null nodeName to "": `spec.nodeName=` (empty
            # value) must select every unassigned pod regardless of how
            # the doc spelled "no node" (doc/INGEST.md stream split).
            return obj.spec.node_name or ""
        if path == "spec.schedulerName":
            return obj.spec.scheduler_name
        if path == "status.phase":
            return obj.status.phase
    if resource == "podgroups" and path == "spec.queue":
        # Both PodGroup API versions carry spec.queue; an unset queue
        # reads as "" so `spec.queue!=<name>` keeps default-queue groups
        # (over-approximation: the client attributes those itself).
        return getattr(obj.spec, "queue", "") or ""
    raise ValueError(f"field label not supported: {path}")


def parse_field_selector(resource: str,
                         spec: str) -> Callable[[object], bool]:
    """Compile a fieldSelector string into a predicate over an object.
    Unsupported field paths raise ValueError HERE, at compile time, so
    a watch with a bad selector answers 400 before the stream opens
    (matching the LIST path) rather than silently filtering
    everything."""
    supported = _FIELD_PATHS.get(resource, _COMMON_FIELDS)
    pairs = []  # (path, value, negate)
    for req in _split_top(spec):
        if "!=" in req:
            path, _, val = req.partition("!=")
            pairs.append((path.strip(), val.strip(), True))
        elif "=" in req:
            path, _, val = req.partition("==" if "==" in req else "=")
            pairs.append((path.strip(), val.strip(), False))
        else:
            raise ValueError(f"bad field selector requirement {req!r}")
    for path, _, _ in pairs:
        if path not in supported:
            raise ValueError(f"field label not supported: {path}")

    def match(obj) -> bool:
        for path, val, neg in pairs:
            got = _field_value(resource, obj, path)
            if (got == val) == neg:
                return False
        return True

    return match


def compile_query(resource: str,
                  query: Dict[str, list]) -> Optional[Callable]:
    """Build the combined selector predicate for a parsed query string,
    or None when the query carries no selectors.  Raises ValueError on
    malformed selectors (callers answer 400)."""
    preds = []
    if query.get("labelSelector"):
        label_match = parse_label_selector(query["labelSelector"][0])
        preds.append(lambda o: label_match(
            getattr(o.metadata, "labels", None) or {}))
    if query.get("fieldSelector"):
        preds.append(parse_field_selector(resource,
                                          query["fieldSelector"][0]))
    if not preds:
        return None
    return lambda o: all(p(o) for p in preds)
