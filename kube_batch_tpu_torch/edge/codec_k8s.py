"""Kubernetes-convention wire codec: API objects <-> k8s-shaped JSON.

The edge's native codec (edge/codec.py) is a reflective ``__kind__``
format; this module speaks the Kubernetes API conventions instead —
``apiVersion``/``kind`` tags, camelCase fields, and the real structural
shapes (``spec.containers[].resources.requests``, nodeAffinity
``nodeSelectorTerms``/``matchExpressions``, ``persistentVolumeClaim``
volumes, RFC3339 timestamps) — so a manifest written for the reference
scheduler (kubectl-shaped Pod, PodGroup of group
``scheduling.incubator.k8s.io``/``scheduling.sigs.dev``, Queue,
PriorityClass) submits to the edge unchanged, and listings read back the
same way (SURVEY.md §2.2 comm backend: the API-compatibility contract at
the wire level, not just the CRD manifests).

Scope: the scheduling-relevant subset the object model carries.  Reading
a field this model does not represent raises ValueError rather than
silently dropping semantics the reference would honor (e.g. a
matchExpressions operator other than In with one value).
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, List, Optional

from ..api import objects as O
from ..apis.scheduling import v1alpha1, v1alpha2

PODGROUP_GROUPS = {v1alpha1.GROUP: v1alpha1, v1alpha2.GROUP: v1alpha2}


# -- scalar helpers ----------------------------------------------------------

def _ts_out(ts: Optional[float]):
    if not ts:
        return None
    try:
        return datetime.datetime.fromtimestamp(
            ts, tz=datetime.timezone.utc).isoformat().replace("+00:00", "Z")
    except (OverflowError, OSError, ValueError):
        return None


def _ts_in(value) -> float:
    if value in (None, ""):
        return 0.0
    if isinstance(value, (int, float)):
        return float(value)
    return datetime.datetime.fromisoformat(
        str(value).replace("Z", "+00:00")).timestamp()


def _clean(doc: dict) -> dict:
    return {k: v for k, v in doc.items()
            if v not in (None, {}, []) or k in ("spec", "status", "metadata")}


# -- metadata ----------------------------------------------------------------

def _meta_out(md: O.ObjectMeta) -> dict:
    out: Dict[str, Any] = {"name": md.name, "namespace": md.namespace,
                           "uid": md.uid}
    if md.labels:
        out["labels"] = dict(md.labels)
    if md.annotations:
        out["annotations"] = dict(md.annotations)
    ts = _ts_out(md.creation_timestamp)
    if ts:
        out["creationTimestamp"] = ts
    ts = _ts_out(md.deletion_timestamp)
    if ts:
        out["deletionTimestamp"] = ts
    if md.owner_uid:
        out["ownerReferences"] = [{"uid": md.owner_uid}]
    return out


def _meta_in(doc: Optional[dict]) -> O.ObjectMeta:
    doc = doc or {}
    owners = doc.get("ownerReferences") or []
    return O.ObjectMeta(
        name=doc.get("name", ""),
        namespace=doc.get("namespace", "default"),
        uid=doc.get("uid", ""),
        labels=dict(doc.get("labels") or {}),
        annotations=dict(doc.get("annotations") or {}),
        creation_timestamp=_ts_in(doc.get("creationTimestamp")),
        deletion_timestamp=(_ts_in(doc["deletionTimestamp"])
                            if doc.get("deletionTimestamp") else None),
        owner_uid=owners[0].get("uid", "") if owners else "")


# -- label terms / selectors -------------------------------------------------

def _term_out(term: Dict[str, str]) -> dict:
    return {"matchExpressions": [{"key": k, "operator": "In", "values": [v]}
                                 for k, v in sorted(term.items())]}


def _term_in(doc: dict) -> Dict[str, str]:
    term = dict(doc.get("matchLabels") or {})
    for expr in doc.get("matchExpressions") or []:
        op = expr.get("operator", "In")
        values = expr.get("values") or []
        if op != "In" or len(values) != 1:
            raise ValueError(
                f"unsupported selector expression {expr!r} (only In with "
                f"one value maps onto the scheduling model)")
        term[expr["key"]] = values[0]
    return term


def _selector_out(sel: Dict[str, str]) -> dict:
    return {"matchLabels": dict(sel)}


# -- affinity ----------------------------------------------------------------

def _affinity_out(aff: Optional[O.Affinity]) -> Optional[dict]:
    if aff is None:
        return None
    out: Dict[str, Any] = {}
    node: Dict[str, Any] = {}
    if aff.required_node_terms:
        node["requiredDuringSchedulingIgnoredDuringExecution"] = {
            "nodeSelectorTerms": [_term_out(t)
                                  for t in aff.required_node_terms]}
    if aff.preferred_node_terms:
        node["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": w, "preference": _term_out(t)}
            for w, t in aff.preferred_node_terms]
    if node:
        out["nodeAffinity"] = node

    def pod_terms(required, preferred):
        block: Dict[str, Any] = {}
        if required:
            block["requiredDuringSchedulingIgnoredDuringExecution"] = [
                {"labelSelector": _selector_out(sel),
                 "topologyKey": aff.topology_key} for sel in required]
        if preferred:
            block["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {"weight": w,
                 "podAffinityTerm": {"labelSelector": _selector_out(sel),
                                     "topologyKey": aff.topology_key}}
                for w, sel in preferred]
        return block

    pa = pod_terms(aff.required_pod_affinity, aff.preferred_pod_affinity)
    if pa:
        out["podAffinity"] = pa
    panti = pod_terms(aff.required_pod_anti_affinity,
                      aff.preferred_pod_anti_affinity)
    if panti:
        out["podAntiAffinity"] = panti
    return out or None


def _affinity_in(doc: Optional[dict]) -> Optional[O.Affinity]:
    if not doc:
        return None
    aff = O.Affinity()
    node = doc.get("nodeAffinity") or {}
    req = node.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    aff.required_node_terms = [_term_in(t)
                               for t in req.get("nodeSelectorTerms") or []]
    aff.preferred_node_terms = [
        (p.get("weight", 1), _term_in(p.get("preference") or {}))
        for p in node.get(
            "preferredDuringSchedulingIgnoredDuringExecution") or []]

    def read_pod(block):
        block = block or {}
        required, preferred, topo = [], [], None
        for t in block.get(
                "requiredDuringSchedulingIgnoredDuringExecution") or []:
            required.append(_term_in(t.get("labelSelector") or {}))
            topo = topo or t.get("topologyKey")
        for p in block.get(
                "preferredDuringSchedulingIgnoredDuringExecution") or []:
            term = p.get("podAffinityTerm") or {}
            preferred.append((p.get("weight", 1),
                              _term_in(term.get("labelSelector") or {})))
            topo = topo or term.get("topologyKey")
        return required, preferred, topo

    aff.required_pod_affinity, aff.preferred_pod_affinity, topo1 = \
        read_pod(doc.get("podAffinity"))
    aff.required_pod_anti_affinity, aff.preferred_pod_anti_affinity, topo2 = \
        read_pod(doc.get("podAntiAffinity"))
    topo = topo1 or topo2
    if topo and topo != aff.topology_key:
        # The scheduling model evaluates pod affinity per hostname only
        # (plugins/predicates.pod_affinity_ok); other topology domains
        # would silently change semantics.
        raise ValueError(f"unsupported topologyKey {topo!r} "
                         f"(only kubernetes.io/hostname)")
    if not any((aff.required_node_terms, aff.preferred_node_terms,
                aff.required_pod_affinity, aff.preferred_pod_affinity,
                aff.required_pod_anti_affinity,
                aff.preferred_pod_anti_affinity)):
        return None
    return aff


# -- pod ---------------------------------------------------------------------

def _container_out(c: O.Container) -> dict:
    out: Dict[str, Any] = {"name": c.name}
    if c.requests:
        out["resources"] = {"requests": dict(c.requests)}
    if c.ports:
        out["ports"] = [_clean({"hostPort": p.host_port,
                                "protocol": p.protocol,
                                "hostIP": p.host_ip or None})
                        for p in c.ports]
    return out


def _container_in(doc: dict) -> O.Container:
    resources = doc.get("resources") or {}
    return O.Container(
        name=doc.get("name", "main"),
        requests=dict(resources.get("requests") or {}),
        ports=[O.ContainerPort(host_port=p.get("hostPort", 0),
                               protocol=p.get("protocol", "TCP"),
                               host_ip=p.get("hostIP", ""))
               for p in doc.get("ports") or []])


def _pod_out(pod: O.Pod) -> dict:
    spec = pod.spec
    spec_doc: Dict[str, Any] = {
        "schedulerName": spec.scheduler_name,
        "containers": [_container_out(c) for c in spec.containers],
    }
    if spec.node_name:
        spec_doc["nodeName"] = spec.node_name
    if spec.node_selector:
        spec_doc["nodeSelector"] = dict(spec.node_selector)
    if spec.priority is not None:
        spec_doc["priority"] = spec.priority
    if spec.priority_class_name:
        spec_doc["priorityClassName"] = spec.priority_class_name
    if spec.init_containers:
        spec_doc["initContainers"] = [_container_out(c)
                                      for c in spec.init_containers]
    if spec.tolerations:
        spec_doc["tolerations"] = [
            _clean({"key": t.key or None, "operator": t.operator,
                    "value": t.value or None, "effect": t.effect or None})
            for t in spec.tolerations]
    affinity = _affinity_out(spec.affinity)
    if affinity:
        spec_doc["affinity"] = affinity
    if spec.volumes:
        spec_doc["volumes"] = [
            {"name": f"vol-{i}",
             "persistentVolumeClaim": {"claimName": claim}}
            for i, claim in enumerate(spec.volumes)]
    status_doc: Dict[str, Any] = {"phase": pod.status.phase}
    if pod.status.conditions:
        status_doc["conditions"] = [
            _clean({"type": c.type, "status": c.status,
                    "reason": c.reason or None, "message": c.message or None})
            for c in pod.status.conditions]
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": _meta_out(pod.metadata),
            "spec": spec_doc, "status": status_doc}


def _pod_spec_in(spec: Optional[dict]) -> O.PodSpec:
    spec = spec or {}
    volumes = []
    for v in spec.get("volumes") or []:
        pvc = v.get("persistentVolumeClaim")
        if pvc and pvc.get("claimName"):
            volumes.append(pvc["claimName"])
    return O.PodSpec(
        node_name=spec.get("nodeName", ""),
        node_selector=dict(spec.get("nodeSelector") or {}),
        priority=spec.get("priority"),
        priority_class_name=spec.get("priorityClassName", ""),
        scheduler_name=spec.get("schedulerName", "kube-batch"),
        containers=[_container_in(c)
                    for c in spec.get("containers") or []],
        init_containers=[_container_in(c)
                         for c in spec.get("initContainers") or []],
        tolerations=[O.Toleration(key=t.get("key", ""),
                                  operator=t.get("operator", "Equal"),
                                  value=t.get("value", ""),
                                  effect=t.get("effect", ""))
                     for t in spec.get("tolerations") or []],
        affinity=_affinity_in(spec.get("affinity")),
        volumes=volumes)


def _pod_status_in(status: Optional[dict]) -> O.PodStatus:
    status = status or {}
    return O.PodStatus(
        phase=status.get("phase", "Pending"),
        conditions=[O.PodCondition(type=c.get("type", ""),
                                   status=c.get("status", ""),
                                   reason=c.get("reason", ""),
                                   message=c.get("message", ""))
                    for c in status.get("conditions") or []])


def _pod_in(doc: dict) -> O.Pod:
    return O.Pod(
        metadata=_meta_in(doc.get("metadata")),
        spec=_pod_spec_in(doc.get("spec")),
        status=_pod_status_in(doc.get("status")))


# -- node --------------------------------------------------------------------

def _node_out(node: O.Node) -> dict:
    spec: Dict[str, Any] = {}
    if node.spec.taints:
        spec["taints"] = [_clean({"key": t.key, "value": t.value or None,
                                  "effect": t.effect})
                          for t in node.spec.taints]
    if node.spec.unschedulable:
        spec["unschedulable"] = True
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": _meta_out(node.metadata),
            "spec": spec,
            "status": {
                "allocatable": dict(node.status.allocatable),
                "capacity": dict(node.status.capacity),
                "conditions": [{"type": k, "status": v} for k, v in
                               sorted(node.status.conditions.items())]}}


def _node_spec_in(spec: Optional[dict]) -> O.NodeSpec:
    spec = spec or {}
    return O.NodeSpec(
        taints=[O.Taint(key=t.get("key", ""), value=t.get("value", ""),
                        effect=t.get("effect", "NoSchedule"))
                for t in spec.get("taints") or []],
        unschedulable=bool(spec.get("unschedulable", False)))


def _node_status_in(status: Optional[dict]) -> O.NodeStatus:
    status = status or {}
    return O.NodeStatus(
        allocatable=dict(status.get("allocatable") or {}),
        capacity=dict(status.get("capacity") or {}),
        conditions={c["type"]: c.get("status", "")
                    for c in status.get("conditions") or []})


def _node_in(doc: dict) -> O.Node:
    return O.Node(
        metadata=_meta_in(doc.get("metadata")),
        spec=_node_spec_in(doc.get("spec")),
        status=_node_status_in(doc.get("status")))


# -- CRDs + the rest ---------------------------------------------------------

def _pod_group_out(pg, module) -> dict:
    status = {"phase": pg.status.phase, "running": pg.status.running,
              "succeeded": pg.status.succeeded, "failed": pg.status.failed}
    if pg.status.conditions:
        status["conditions"] = [
            _clean({"type": c.type, "status": c.status,
                    "transitionID": c.transition_id or None,
                    "lastTransitionTime": _ts_out(c.last_transition_time),
                    "reason": c.reason or None,
                    "message": c.message or None})
            for c in pg.status.conditions]
    return {"apiVersion": f"{module.GROUP}/{module.VERSION}",
            "kind": "PodGroup",
            "metadata": _meta_out(pg.metadata),
            "spec": _clean({
                "minMember": pg.spec.min_member,
                "queue": pg.spec.queue,
                "priorityClassName": pg.spec.priority_class_name or None}),
            "status": status}


def _pod_group_in(doc: dict, module):
    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    return module.PodGroup(
        metadata=_meta_in(doc.get("metadata")),
        spec=module.PodGroupSpec(
            min_member=spec.get("minMember", 0),
            queue=spec.get("queue", "default"),
            priority_class_name=spec.get("priorityClassName", "")),
        status=module.PodGroupStatus(
            phase=status.get("phase", "Pending"),
            conditions=[module.PodGroupCondition(
                type=c.get("type", ""), status=c.get("status", "True"),
                transition_id=c.get("transitionID", ""),
                last_transition_time=_ts_in(c.get("lastTransitionTime")),
                reason=c.get("reason", ""), message=c.get("message", ""))
                for c in status.get("conditions") or []],
            running=status.get("running", 0),
            succeeded=status.get("succeeded", 0),
            failed=status.get("failed", 0)))


def _queue_out(queue, module) -> dict:
    return {"apiVersion": f"{module.GROUP}/{module.VERSION}",
            "kind": "Queue",
            "metadata": _meta_out(queue.metadata),
            "spec": _clean({"weight": queue.spec.weight,
                            "capability": dict(queue.spec.capability)
                            or None}),
            "status": {"pending": queue.status.pending,
                       "running": queue.status.running,
                       "unknown": queue.status.unknown}}


def _queue_in(doc: dict, module):
    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    return module.Queue(
        metadata=_meta_in(doc.get("metadata")),
        spec=module.QueueSpec(weight=spec.get("weight", 1),
                              capability=dict(spec.get("capability") or {})),
        status=module.QueueStatus(pending=status.get("pending", 0),
                                  running=status.get("running", 0),
                                  unknown=status.get("unknown", 0)))


def _simple_out(obj) -> dict:
    if isinstance(obj, O.PriorityClass):
        return {"apiVersion": "scheduling.k8s.io/v1", "kind": "PriorityClass",
                "metadata": _meta_out(obj.metadata), "value": obj.value,
                "globalDefault": obj.global_default}
    if isinstance(obj, O.PodDisruptionBudget):
        return {"apiVersion": "policy/v1beta1",
                "kind": "PodDisruptionBudget",
                "metadata": _meta_out(obj.metadata),
                "spec": {"minAvailable": obj.min_available}}
    if isinstance(obj, O.PersistentVolumeClaim):
        return {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
                "metadata": _meta_out(obj.metadata),
                "spec": _clean({"storageClassName": obj.storage_class,
                                "volumeName": obj.volume_name or None}),
                "status": {"phase": obj.phase}}
    if isinstance(obj, O.Event):
        ns, _, name = obj.involved_object.partition("/")
        involved = ({"namespace": ns, "name": name} if name
                    else {"name": obj.involved_object})
        return _clean({"apiVersion": "v1", "kind": "Event",
                       "metadata": _meta_out(obj.metadata),
                       "involvedObject": involved,
                       "reason": obj.reason, "message": obj.message,
                       "type": obj.type,
                       "firstTimestamp": _ts_out(obj.timestamp)})
    raise ValueError(f"no k8s encoding for {type(obj).__name__}")


def to_k8s(obj) -> Dict[str, Any]:
    """Encode one API object as a Kubernetes-convention JSON document."""
    if isinstance(obj, O.Pod):
        return _pod_out(obj)
    if isinstance(obj, O.Node):
        return _node_out(obj)
    if isinstance(obj, (v1alpha1.PodGroup, v1alpha2.PodGroup)):
        module = (v1alpha2 if isinstance(obj, v1alpha2.PodGroup)
                  else v1alpha1)
        return _pod_group_out(obj, module)
    if isinstance(obj, (v1alpha1.Queue, v1alpha2.Queue)):
        module = v1alpha2 if isinstance(obj, v1alpha2.Queue) else v1alpha1
        return _queue_out(obj, module)
    return _simple_out(obj)


def from_k8s(doc: Dict[str, Any]):
    """Decode a Kubernetes-convention JSON document into an API object."""
    kind = doc.get("kind")
    api_version = doc.get("apiVersion", "")
    group = api_version.split("/")[0] if "/" in api_version else ""
    if kind == "Pod":
        return _pod_in(doc)
    if kind == "Node":
        return _node_in(doc)
    if kind == "PodGroup":
        module = PODGROUP_GROUPS.get(group)
        if module is None:
            raise ValueError(f"unknown PodGroup group {group!r}")
        return _pod_group_in(doc, module)
    if kind == "Queue":
        module = PODGROUP_GROUPS.get(group, v1alpha1)
        return _queue_in(doc, module)
    if kind == "PriorityClass":
        return O.PriorityClass(metadata=_meta_in(doc.get("metadata")),
                               value=doc.get("value", 0),
                               global_default=doc.get("globalDefault",
                                                      False))
    if kind == "PodDisruptionBudget":
        spec = doc.get("spec") or {}
        return O.PodDisruptionBudget(
            metadata=_meta_in(doc.get("metadata")),
            min_available=spec.get("minAvailable", 0))
    if kind == "PersistentVolumeClaim":
        spec = doc.get("spec") or {}
        status = doc.get("status") or {}
        return O.PersistentVolumeClaim(
            metadata=_meta_in(doc.get("metadata")),
            storage_class=spec.get("storageClassName", "standard"),
            phase=status.get("phase", "Pending"),
            volume_name=spec.get("volumeName", ""))
    if kind == "Event":
        involved = doc.get("involvedObject") or {}
        key = (f"{involved.get('namespace')}/{involved.get('name')}"
               if involved.get("namespace") else involved.get("name", ""))
        return O.Event(metadata=_meta_in(doc.get("metadata")),
                       involved_object=key,
                       reason=doc.get("reason", ""),
                       message=doc.get("message", ""),
                       type=doc.get("type", "Normal"),
                       timestamp=_ts_in(doc.get("firstTimestamp")))
    raise ValueError(f"unknown k8s kind {kind!r}")


def decode_any(doc: Dict[str, Any]):
    """Decode either wire format: the native ``__kind__`` documents or
    Kubernetes-convention ``kind``/``apiVersion`` documents."""
    from . import codec
    if "__kind__" in doc:
        return codec.decode(doc)
    if "kind" in doc:
        return from_k8s(doc)
    raise ValueError("document carries neither __kind__ nor kind")


# ---------------------------------------------------------------------------
# Columnar delta decode for the k8s wire (mirror of edge/codec.decode_delta
# and the same contract: raw-section compare against the cached previous
# wire doc, re-decoding only changed sections through the EXACT section
# decoders the full path uses — so a delta result equals the full decode
# bit for bit, and an unchanged ``spec`` section reuses the previous
# PodSpec OBJECT, keeping models/tensor_snapshot._pod_static's identity-
# keyed signature cache warm across watch echoes).  Scope: Pods and Nodes,
# the churn-heavy kinds the fast path exists for; every other kind raises
# LookupError and the client falls back to a counted full decode.
# ---------------------------------------------------------------------------

_DELTA_SECTIONS = {
    # kind -> ((doc_key, field_name, section_decoder), ...)
    "Pod": (("metadata", "metadata", _meta_in),
            ("spec", "spec", _pod_spec_in),
            ("status", "status", _pod_status_in)),
    "Node": (("metadata", "metadata", _meta_in),
             ("spec", "spec", _node_spec_in),
             ("status", "status", _node_status_in)),
}

_DELTA_CLASSES = {"Pod": O.Pod, "Node": O.Node}


def from_k8s_delta(doc: Dict[str, Any], prev):
    """Decode a k8s-convention doc against the previously decoded
    ``prev`` (whose raw doc edge/client stamped as ``_wire_doc``).
    Raises ValueError exactly where ``from_k8s`` would; LookupError when
    no delta is possible (unknown kind, missing/mismatched baseline) —
    the caller falls back to the full decode."""
    from .codec import _carry_tensor_static, remember_wire_doc

    kind = doc.get("kind")
    # Mirror from_k8s's group parse for effect: a frame whose apiVersion
    # is not a string must raise the SAME TypeError here that the full
    # decode raises, or the fast arm silently applies a frame the
    # control arm relists on (divergence; pinned by the fuzz suite).
    api_version = doc.get("apiVersion", "")
    "/" in api_version  # noqa: B015 — type check by evaluation
    try:
        sections = _DELTA_SECTIONS.get(kind)
        cls = _DELTA_CLASSES.get(kind)
    except TypeError:
        # Unhashable kind (malformed frame): the FULL decode owns the
        # error shape (its == dispatch raises ValueError) — refuse the
        # delta so the fallback reproduces it exactly.
        raise LookupError("baseline") from None
    if sections is None:
        # Resource kind outside the delta plans (PodGroups, Queues, …):
        # counted under its own fallback reason so operators can tell
        # "unsupported kind" from "missing baseline".
        raise LookupError("kind")
    if type(prev) is not cls:
        raise LookupError("baseline")
    from .codec import wire_baseline
    prev_data = wire_baseline(prev)  # LookupError: baseline | evicted
    if not isinstance(prev_data, dict):
        raise LookupError("baseline")
    kwargs = {}
    for doc_key, field, section_in in sections:
        v = doc.get(doc_key)
        if doc_key in prev_data and v == prev_data[doc_key]:
            kwargs[field] = getattr(prev, field)
        else:
            kwargs[field] = section_in(v)
    obj = cls(**kwargs)
    remember_wire_doc(obj, doc)
    _carry_tensor_static(prev, obj)
    return obj


def decode_any_delta(doc: Dict[str, Any], prev):
    """Delta-decode either wire format against ``prev``; LookupError
    means "fall back to the full decode", ValueError means the doc is
    malformed for the full path too."""
    from . import codec
    if "__kind__" in doc:
        return codec.decode_delta(doc, prev)
    if "kind" in doc:
        return from_k8s_delta(doc, prev)
    raise ValueError("document carries neither __kind__ nor kind")
