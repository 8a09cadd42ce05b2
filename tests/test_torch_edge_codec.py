"""The port's wire codecs (kube_batch_tpu_torch/edge/codec.py,
codec_k8s.py, selectors.py, baseline.py) held against the JAX package's,
on the CPU.

Seeded numpy draws one cluster's objects: pods with node selectors,
tolerations, node and pod affinity, host ports, volumes and conditions;
nodes with taints and conditions; v1alpha1 and v1alpha2 pod groups and
queues; priority classes, PDBs, PVCs, events and a pod condition.  Each
package builds its own objects from the same draw.  Tolerance: exact —
the documents of both packages must be the same JSON (``==`` on the
parsed documents), a reference document must decode in the port and
encode back to itself, full and delta decodes must agree, and the
selector and budget functions must give the same answers (or raise the
same exception type).
"""

import copy
import json
from types import SimpleNamespace

import numpy as np
import pytest

import kube_batch_tpu.api.objects as ref_objects
import kube_batch_tpu.apis.scheduling.v1alpha1 as ref_v1alpha1
import kube_batch_tpu.apis.scheduling.v1alpha2 as ref_v1alpha2
import kube_batch_tpu.edge.baseline as ref_baseline
import kube_batch_tpu.edge.codec as ref_codec
import kube_batch_tpu.edge.codec_k8s as ref_k8s
import kube_batch_tpu.edge.selectors as ref_selectors
import kube_batch_tpu.models.tensor_snapshot as ref_tensorize
import kube_batch_tpu_torch.api.objects as torch_objects
import kube_batch_tpu_torch.apis.scheduling.v1alpha1 as torch_v1alpha1
import kube_batch_tpu_torch.apis.scheduling.v1alpha2 as torch_v1alpha2
import kube_batch_tpu_torch.edge.baseline as torch_baseline
import kube_batch_tpu_torch.edge.codec as torch_codec
import kube_batch_tpu_torch.edge.codec_k8s as torch_k8s
import kube_batch_tpu_torch.edge.selectors as torch_selectors
import kube_batch_tpu_torch.models.tensor_snapshot as torch_tensorize
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

REF = SimpleNamespace(o=ref_objects, v1=ref_v1alpha1, v2=ref_v1alpha2,
                      codec=ref_codec, k8s=ref_k8s, sel=ref_selectors,
                      baseline=ref_baseline, tensorize=ref_tensorize)
PORT = SimpleNamespace(o=torch_objects, v1=torch_v1alpha1, v2=torch_v1alpha2,
                       codec=torch_codec, k8s=torch_k8s, sel=torch_selectors,
                       baseline=torch_baseline, tensorize=torch_tensorize)
SEEDS = range(4)


def _labels(rng, n):
    return {f"k{int(rng.integers(0, 6))}": f"v{int(rng.integers(0, 4))}"
            for _ in range(n)}


def _meta(m, rng, name, ns="ns", **kw):
    return m.o.ObjectMeta(
        name=name, namespace=ns, uid=f"uid-{name}",
        labels=_labels(rng, int(rng.integers(0, 3))),
        annotations={"a": str(int(rng.integers(0, 9)))},
        creation_timestamp=float(rng.integers(1_600_000_000, 1_700_000_000)),
        **kw)


def _pod(m, rng, i):
    o = m.o
    aff = None
    if rng.random() < 0.6:
        aff = o.Affinity(
            required_node_terms=[{"zone": f"z{int(rng.integers(0, 3))}"}],
            preferred_node_terms=[[int(rng.integers(1, 100)),
                                   {"disk": "ssd"}]],
            required_pod_affinity=([{"app": "db"}] if rng.random() < 0.5
                                   else []),
            required_pod_anti_affinity=([{"app": "web"}]
                                        if rng.random() < 0.5 else []),
            preferred_pod_affinity=[[int(rng.integers(1, 100)),
                                     {"tier": "cache"}]],
            preferred_pod_anti_affinity=[])
    ports = ([o.ContainerPort(host_port=int(rng.integers(1000, 9000)),
                              protocol=str(rng.choice(["TCP", "UDP"])))]
             if rng.random() < 0.5 else [])
    spec = o.PodSpec(
        node_name=f"n{int(rng.integers(0, 4))}" if rng.random() < 0.5
        else "",
        node_selector=_labels(rng, int(rng.integers(0, 2))),
        priority=int(rng.integers(0, 1000)) if rng.random() < 0.5 else None,
        priority_class_name=str(rng.choice(["", "high"])),
        containers=[o.Container(
            name="main",
            requests={"cpu": f"{int(rng.integers(1, 8))}",
                      "memory": f"{int(rng.integers(1, 16))}Gi"},
            ports=ports)],
        tolerations=([o.Toleration(key="gpu", operator="Exists",
                                   effect="NoSchedule")]
                     if rng.random() < 0.5 else []),
        affinity=aff,
        volumes=[f"pvc-{i}"] if rng.random() < 0.3 else [])
    status = o.PodStatus(
        phase=str(rng.choice(["Pending", "Running"])),
        conditions=([o.PodCondition(type="PodScheduled", status="False",
                                    reason="Unschedulable", message="m")]
                    if rng.random() < 0.5 else []))
    meta = _meta(m, rng, f"p{i}")
    meta.annotations[m.v1.GroupNameAnnotationKey] = f"pg{i % 3}"
    return o.Pod(metadata=meta, spec=spec, status=status)


def _node(m, rng, i):
    o = m.o
    alloc = {"cpu": str(int(rng.integers(4, 64))),
             "memory": f"{int(rng.integers(8, 256))}Gi", "pods": 110}
    return o.Node(
        metadata=_meta(m, rng, f"n{i}", ns=""),
        spec=o.NodeSpec(
            taints=([o.Taint(key="gpu", value="yes", effect="NoSchedule")]
                    if rng.random() < 0.5 else []),
            unschedulable=bool(rng.random() < 0.2)),
        status=o.NodeStatus(allocatable=alloc, capacity=dict(alloc),
                            conditions={"Ready": "True"}))


def _pod_group(m, rng, i, version):
    v = m.v1 if version == 1 else m.v2
    cond = ([m.v1.PodGroupCondition(
        type="Unschedulable", status="True", transition_id="t",
        last_transition_time=float(rng.integers(1, 10 ** 6)),
        reason="NotEnoughResources", message="m")]
        if rng.random() < 0.5 else [])
    return v.PodGroup(
        metadata=_meta(m, rng, f"pg{i}-v{version}"),
        spec=v.PodGroupSpec(min_member=int(rng.integers(1, 10)),
                            queue=f"q{int(rng.integers(0, 3))}",
                            priority_class_name=str(rng.choice(["", "high"]))),
        status=v.PodGroupStatus(phase=str(rng.choice(["Pending", "Running"])),
                                conditions=cond,
                                running=int(rng.integers(0, 5))))


def _queue(m, rng, i, version):
    v = m.v1 if version == 1 else m.v2
    return v.Queue(
        metadata=_meta(m, rng, f"q{i}-v{version}", ns=""),
        spec=v.QueueSpec(weight=int(rng.integers(1, 10)),
                         capability=({"cpu": "100"} if rng.random() < 0.5
                                     else {})),
        status=v.QueueStatus(pending=int(rng.integers(0, 5))))


def cluster_objects(m, seed, *, k8s=False):
    """One seeded draw of every kind, built by package ``m``.  The k8s
    wire has no document for a bare PodCondition, so ``k8s`` leaves it
    out."""
    rng = np.random.default_rng(seed)
    o = m.o
    out = [_pod(m, rng, i) for i in range(6)]
    out += [_node(m, rng, i) for i in range(3)]
    out += [_pod_group(m, rng, i, ver) for i in range(2) for ver in (1, 2)]
    out += [_queue(m, rng, i, ver) for i in range(2) for ver in (1, 2)]
    out.append(o.PriorityClass(metadata=_meta(m, rng, "high", ns=""),
                               value=int(rng.integers(0, 10 ** 6)),
                               global_default=bool(rng.random() < 0.5)))
    out.append(o.PodDisruptionBudget(metadata=_meta(m, rng, "pdb"),
                                     min_available=int(rng.integers(1, 5))))
    out.append(o.PersistentVolumeClaim(metadata=_meta(m, rng, "pvc-0"),
                                       storage_class="fast", phase="Bound",
                                       volume_name="vol-0"))
    out.append(o.Event(metadata=_meta(m, rng, "ev"),
                       involved_object="ns/p0", reason="FailedScheduling",
                       message="0/3 nodes", type="Warning",
                       timestamp=float(rng.integers(1, 10 ** 9))))
    if not k8s:
        out.append(o.PodCondition(type="Ready", status="True"))
    return out


def _json(doc):
    return json.loads(json.dumps(doc))


def _native(m, objs):
    return [_json(m.codec.encode(x)) for x in objs]


def _k8s(m, objs):
    return [_json(m.k8s.to_k8s(x)) for x in objs]


@pytest.mark.parametrize("seed", SEEDS)
def test_native_documents_equal_the_reference(seed):
    ref = _native(REF, cluster_objects(REF, seed))
    port = _native(PORT, cluster_objects(PORT, seed))
    assert len(port) == len(ref) == 22
    for a, b in zip(port, ref):
        assert a == b
    # Kind tags are module-qualified by their last component only.
    kinds = {d["__kind__"] for d in port}
    assert {"v1alpha1.PodGroup", "v1alpha2.PodGroup", "Pod",
            "PodCondition"} <= kinds


@pytest.mark.parametrize("seed", SEEDS)
def test_k8s_documents_equal_the_reference(seed):
    ref = _k8s(REF, cluster_objects(REF, seed, k8s=True))
    port = _k8s(PORT, cluster_objects(PORT, seed, k8s=True))
    assert len(port) == len(ref) == 21
    for a, b in zip(port, ref):
        assert a == b
    assert all("kind" in d and "apiVersion" in d for d in port)


@pytest.mark.parametrize("wire", ["native", "k8s"])
def test_reference_documents_round_trip_through_the_port(wire):
    k8s = wire == "k8s"
    objs = cluster_objects(REF, 11, k8s=k8s)
    docs = _k8s(REF, objs) if k8s else _native(REF, objs)
    for doc in docs:
        obj = PORT.k8s.decode_any(copy.deepcopy(doc))
        assert type(obj).__module__.startswith("kube_batch_tpu_torch.")
        again = (_json(PORT.k8s.to_k8s(obj)) if k8s
                 else _json(PORT.codec.encode(obj)))
        assert again == doc
        # The reference decodes the same document to an equal encoding.
        ref_obj = REF.k8s.decode_any(copy.deepcopy(doc))
        ref_again = (_json(REF.k8s.to_k8s(ref_obj)) if k8s
                     else _json(REF.codec.encode(ref_obj)))
        assert ref_again == again


def _mutations(doc, wire):
    """A status-only edit (the watch echo of a bind) and a spec edit of
    the same document."""
    status_only = copy.deepcopy(doc)
    spec_edit = copy.deepcopy(doc)
    if wire == "native":
        status_only["status"]["phase"] = "Succeeded"
        spec_edit["spec"]["node_selector"] = {"edited": "yes"}
    else:
        status_only.setdefault("status", {})["phase"] = "Succeeded"
        spec_edit["spec"]["nodeSelector"] = {"edited": "yes"}
    return status_only, spec_edit


@pytest.mark.parametrize("wire", ["native", "k8s"])
def test_delta_decode_equals_full_decode_and_the_reference(wire):
    k8s = wire == "k8s"
    enc = {"ref": (lambda x: _json(REF.k8s.to_k8s(x))) if k8s
           else (lambda x: _json(REF.codec.encode(x))),
           "port": (lambda x: _json(PORT.k8s.to_k8s(x))) if k8s
           else (lambda x: _json(PORT.codec.encode(x)))}
    pods = [o for o in cluster_objects(REF, 5, k8s=k8s)
            if isinstance(o, REF.o.Pod)]
    for pod in pods:
        base = enc["ref"](pod)
        for nxt in _mutations(base, wire):
            out = {}
            for name, m in (("ref", REF), ("port", PORT)):
                prev = m.k8s.decode_any(copy.deepcopy(base))
                m.codec.remember_wire_doc(
                    prev, base if k8s else {k: v for k, v in base.items()
                                            if k != "__kind__"})
                delta = m.k8s.decode_any_delta(copy.deepcopy(nxt), prev)
                full = m.k8s.decode_any(copy.deepcopy(nxt))
                assert delta == full
                assert (delta.spec is prev.spec) == (
                    nxt.get("spec") == base.get("spec"))
                out[name] = enc[name](delta)
            assert out["port"] == out["ref"] == nxt


@pytest.mark.parametrize("wire", ["native", "k8s"])
def test_carry_tensor_static_exactly_when_the_spec_is_reused(wire):
    k8s = wire == "k8s"
    seen = {}
    for name, m in (("ref", REF), ("port", PORT)):
        pod = next(o for o in cluster_objects(m, 7, k8s=k8s)
                   if isinstance(o, m.o.Pod) and o.spec.affinity is not None)
        doc = (_json(m.k8s.to_k8s(pod)) if k8s
               else _json(m.codec.encode(pod)))
        prev = m.k8s.decode_any(copy.deepcopy(doc))
        m.codec.remember_wire_doc(
            prev, doc if k8s else {k: v for k, v in doc.items()
                                   if k != "__kind__"})
        static = m.tensorize._pod_static(prev)
        status_only, spec_edit = _mutations(doc, wire)
        echo = m.k8s.decode_any_delta(copy.deepcopy(status_only), prev)
        edited = m.k8s.decode_any_delta(copy.deepcopy(spec_edit), prev)
        assert echo.spec is prev.spec
        assert echo._tensor_static is static
        assert edited.spec is not prev.spec
        assert getattr(edited, "_tensor_static", None) is None
        # The carried entry is what the tensorizer would derive anew.
        assert m.tensorize._pod_static(echo) is static
        seen[name] = (static[1:], m.tensorize._pod_static(edited)[1:])
    assert seen["port"] == seen["ref"]


LABEL_SELECTORS = [
    "", "k0=v1", "k0==v1", "k1!=v2", "k2", "!k3", "k0 in (v0, v1)",
    "k1 notin (v3)", "k0=v0,k1!=v1", "k0 in (v0,v2),!k5,k4",
    "k0 in ()", "a!b", "=v", "k0 in (v0", "k0 in (v 0)", "!", "k 0=v",
    "k0=v0,,k1", "k0=v=1",
]
FIELD_SELECTORS = [
    ("pods", "spec.nodeName="), ("pods", "spec.nodeName!=n1"),
    ("pods", "status.phase=Running,metadata.namespace=ns"),
    ("pods", "metadata.name==p3"), ("pods", "spec.schedulerName=x"),
    ("podgroups", "spec.queue!=q1,spec.queue!=q2"),
    ("podgroups", "spec.queue=q0"), ("nodes", "metadata.name=n1"),
    ("nodes", "spec.unschedulable=true"), ("pods", "spec.queue=q0"),
    ("pods", "bogus"), ("podgroups", "metadata.namespace"),
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # lint: allow-swallow(the exception's type is the answer compared between the packages)
        return ("raise", type(exc).__name__)


def test_selectors_give_the_reference_truth_table():
    rng = np.random.default_rng(3)
    label_sets = [_labels(rng, int(rng.integers(0, 5))) for _ in range(40)]
    for spec in LABEL_SELECTORS:
        ref = _outcome(REF.sel.parse_label_selector, spec)
        port = _outcome(PORT.sel.parse_label_selector, spec)
        assert (port[0], port[1] if port[0] == "raise" else None) == (
            ref[0], ref[1] if ref[0] == "raise" else None), spec
        if ref[0] == "ok":
            assert ([port[1](ls) for ls in label_sets]
                    == [ref[1](ls) for ls in label_sets]), spec
    objs = {name: [o for o in cluster_objects(m, 9)
                   if not isinstance(o, m.o.PodCondition)]
            for name, m in (("ref", REF), ("port", PORT))}
    for resource, spec in FIELD_SELECTORS:
        ref = _outcome(REF.sel.parse_field_selector, resource, spec)
        port = _outcome(PORT.sel.parse_field_selector, resource, spec)
        assert port[0] == ref[0], spec
        if ref[0] == "raise":
            assert port[1] == ref[1], spec
            continue
        kinds = {"pods": "Pod", "podgroups": "PodGroup", "nodes": "Node"}
        pick = {n: [o for o in objs[n]
                    if type(o).__name__ == kinds[resource]]
                for n in objs}
        assert ([_outcome(port[1], o) for o in pick["port"]]
                == [_outcome(ref[1], o) for o in pick["ref"]]), spec
    for query in ({}, {"labelSelector": ["k0=v0"]},
                  {"fieldSelector": ["spec.nodeName="],
                   "labelSelector": ["!k1"]},
                  {"fieldSelector": ["nope=1"]}):
        ref = _outcome(REF.sel.compile_query, "pods", query)
        port = _outcome(PORT.sel.compile_query, "pods", query)
        assert port[0] == ref[0]
        if ref[0] == "raise" or ref[1] is None:
            assert port[1] == ref[1]
            continue
        pick = {n: [o for o in objs[n] if type(o).__name__ == "Pod"]
                for n in objs}
        assert ([port[1](o) for o in pick["port"]]
                == [ref[1](o) for o in pick["ref"]])


BUDGETS = ["", "  ", "32M", "pods=32M,podgroups=512k", "1g,nodes=10",
           "pods=1.5k", "pods=-1", "pods=abc", "pods=", "7,,pods=2m",
           "*=5"]


def test_baseline_budgets_parse_as_the_reference():
    for spec in BUDGETS:
        ref = _outcome(REF.baseline.parse_budgets, spec)
        port = _outcome(PORT.baseline.parse_budgets, spec)
        assert port == ref, spec
        if ref[0] == "ok":
            for kind in ("pods", "podgroups", "nodes", "queues"):
                assert (PORT.baseline.budget_for(port[1], kind)
                        == REF.baseline.budget_for(ref[1], kind))


def test_baseline_compress_and_evict_give_the_reference_sizes():
    sizes = {}
    for name, m in (("ref", REF), ("port", PORT)):
        out = []
        for obj in cluster_objects(m, 2):
            doc = {k: v for k, v in _json(m.codec.encode(obj)).items()
                   if k != "__kind__"}
            m.codec.remember_wire_doc(obj, doc)
            size = m.baseline.compress(obj)
            assert m.baseline.compress(obj) is None  # already cold
            assert m.codec.wire_baseline(obj) == doc  # round-trips
            assert m.baseline.evict(obj)
            with pytest.raises(LookupError, match="evicted"):
                m.codec.wire_baseline(obj)
            out.append(size)
        sizes[name] = out
    assert sizes["port"] == sizes["ref"]
    assert all(s and s > 0 for s in sizes["port"])
