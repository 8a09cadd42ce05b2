"""Wire-to-tensor fast path (doc/INCREMENTAL.md "Wire fast path").

The invariant everything stands on: with ``KUBE_BATCH_TPU_WIRE_FAST``
on, every layer — the columnar watch-delta decode (edge/codec,
edge/codec_k8s), the persistent candidate-row staging buffers
(models/tensor_snapshot), the vectorized drf/job-valid/gang-close walks
(models/incremental) and the recycled pack buffers (models/shipping) —
is BIT-IDENTICAL to the =0 sequential control.  On top of that: the
delta decode degrades to a counted full decode on anything surprising
(fuzzed here — a malformed frame must never introduce a failure mode the
full decode does not have), and the lineage ingest stamp rides the
frame-receipt time on both paths.

Twin of tests/test_wire_fast.py, its 23 wire cases: the native and k8s
delta decodes, the fuzz, the fallback counter, the ingest stamp and the
reflector mirror over a live edge (the 9 session cases are in
tests/test_torch_wire_fast_session.py), over the port's package
(kube_batch_tpu_torch/edge/, client/, cli/) on the CPU: schedulers and
runtimes are built with ``device="cpu"``.
"""

import copy
import dataclasses as dc
import json
import random
import time

import numpy as np
import pytest

from kube_batch_tpu_torch.api import (Affinity, Container, Node, NodeSpec,
                                      NodeStatus, ObjectMeta, Pod, PodSpec,
                                      PodStatus, Toleration)
from kube_batch_tpu_torch.api import objects as O
from kube_batch_tpu_torch.apis.scheduling import v1alpha1, v1alpha2
from kube_batch_tpu_torch.edge import codec, codec_k8s
from kube_batch_tpu_torch.metrics import metrics
from kube_batch_tpu_torch.models.incremental import WIRE_FAST_ENV


def _featured_pod(name="p1", ns="ns"):
    return Pod(
        metadata=ObjectMeta(name=name, namespace=ns, uid=name,
                            labels={"team": "a"},
                            annotations={"k": "v"},
                            creation_timestamp=12.5),
        spec=PodSpec(
            containers=[Container(requests={"cpu": "1",
                                            "memory": "1Gi"})],
            node_selector={"pool": "x"},
            tolerations=[Toleration("t", "Equal", "v", "NoSchedule")],
            affinity=Affinity(required_node_terms=[{"zone": "z1"}],
                              preferred_node_terms=[(2, {"zone": "z2"})]),
            priority=5),
        status=PodStatus(phase="Pending"))


def _node(name="n1"):
    return Node(
        metadata=ObjectMeta(name=name, uid=name, labels={"pool": "x"}),
        spec=NodeSpec(taints=[O.Taint("t", "v", "NoSchedule")]),
        status=NodeStatus(allocatable={"cpu": "4", "memory": "8Gi"},
                          capacity={"cpu": "4", "memory": "8Gi"},
                          conditions={"Ready": "True"}))


def _jsonify(doc):
    return json.loads(json.dumps(doc))


def _native_baseline(obj, doc):
    data = {k: v for k, v in doc.items() if k != "__kind__"}
    codec.remember_wire_doc(obj, data)
    return obj


# ---------------------------------------------------------------------------
# 1. Columnar delta decode: parity + identity reuse
# ---------------------------------------------------------------------------

class TestNativeDelta:

    def test_delta_equals_full_and_reuses_unchanged_subtrees(self):
        pod = _featured_pod()
        doc = _jsonify(codec.encode(pod))
        prev = _native_baseline(codec.decode(doc), doc)
        doc2 = copy.deepcopy(doc)
        doc2["status"]["phase"] = "Running"
        doc2["spec"]["node_name"] = "node-7"
        out = codec.decode_delta(doc2, prev)
        assert out == codec.decode(doc2)
        # Unchanged subtrees come back by IDENTITY — what keeps the
        # tensorizer's spec-keyed signature cache warm.
        assert out.metadata is prev.metadata
        assert out.spec is not prev.spec          # node_name changed
        assert out.spec.containers is prev.spec.containers
        assert out.spec.affinity is prev.spec.affinity

    def test_status_only_echo_reuses_whole_spec(self):
        pod = _featured_pod()
        doc = _jsonify(codec.encode(pod))
        prev = _native_baseline(codec.decode(doc), doc)
        # Prime the signature cache on the previous object's spec.
        from kube_batch_tpu_torch.models.tensor_snapshot import _pod_static
        sig_before = _pod_static(prev)
        doc2 = copy.deepcopy(doc)
        doc2["status"]["phase"] = "Running"
        out = codec.decode_delta(doc2, prev)
        assert out.spec is prev.spec
        # The identity-keyed cache survives the echo: same tuple object.
        assert _pod_static(out) is sig_before

    def test_field_removal_matches_full_decode_default(self):
        pod = _featured_pod()
        doc = _jsonify(codec.encode(pod))
        prev = _native_baseline(codec.decode(doc), doc)
        doc2 = copy.deepcopy(doc)
        del doc2["spec"]["node_selector"]
        out = codec.decode_delta(doc2, prev)
        assert out == codec.decode(doc2)
        assert out.spec.node_selector == {}

    def test_unknown_kind_raises_value_error(self):
        with pytest.raises(ValueError):
            codec.decode_delta({"__kind__": "Gizmo"}, object())

    def test_missing_baseline_raises_lookup_error(self):
        doc = _jsonify(codec.encode(_featured_pod()))
        with pytest.raises(LookupError):
            codec.decode_delta(doc, codec.decode(doc))  # no _wire_doc

    def test_all_top_level_kinds_round_trip_delta(self):
        objs = [
            _featured_pod(), _node(),
            O.PriorityClass(metadata=ObjectMeta(name="pc"), value=7),
            O.PodDisruptionBudget(metadata=ObjectMeta(name="pdb",
                                                      namespace="ns"),
                                  min_available=2),
            v1alpha1.PodGroup(
                metadata=ObjectMeta(name="pg", namespace="ns"),
                spec=v1alpha1.PodGroupSpec(min_member=3, queue="q")),
            v1alpha2.Queue(metadata=ObjectMeta(name="q"),
                           spec=v1alpha2.QueueSpec(weight=4)),
        ]
        for obj in objs:
            doc = _jsonify(codec.encode(obj))
            prev = _native_baseline(codec.decode(doc), doc)
            doc2 = copy.deepcopy(doc)
            doc2["metadata"]["labels"] = {"x": "y"}
            assert codec.decode_delta(doc2, prev) == codec.decode(doc2)


class TestK8sDelta:

    def test_pod_delta_equals_full_and_reuses_sections(self):
        pod = _featured_pod()
        doc = _jsonify(codec_k8s.to_k8s(pod))
        prev = codec_k8s.from_k8s(doc)
        codec.remember_wire_doc(prev, doc)
        doc2 = copy.deepcopy(doc)
        doc2["status"]["phase"] = "Running"
        out = codec_k8s.from_k8s_delta(doc2, prev)
        assert out == codec_k8s.from_k8s(doc2)
        assert out.spec is prev.spec
        assert out.metadata is prev.metadata

    def test_node_delta_equals_full(self):
        node = _node()
        doc = _jsonify(codec_k8s.to_k8s(node))
        prev = codec_k8s.from_k8s(doc)
        codec.remember_wire_doc(prev, doc)
        doc2 = copy.deepcopy(doc)
        doc2["status"]["allocatable"]["cpu"] = "8"
        out = codec_k8s.from_k8s_delta(doc2, prev)
        assert out == codec_k8s.from_k8s(doc2)
        assert out.spec is prev.spec

    def test_non_delta_kind_raises_lookup_error(self):
        pg = v1alpha1.PodGroup(
            metadata=ObjectMeta(name="pg", namespace="ns"),
            spec=v1alpha1.PodGroupSpec(min_member=1, queue="q"))
        doc = _jsonify(codec_k8s.to_k8s(pg))
        prev = codec_k8s.from_k8s(doc)
        codec.remember_wire_doc(prev, doc)
        with pytest.raises(LookupError):
            codec_k8s.from_k8s_delta(doc, prev)


# ---------------------------------------------------------------------------
# 2. Codec robustness fuzz: malformed/truncated/unknown-field docs
# ---------------------------------------------------------------------------

def _mutate_doc(doc, rng):
    """One random structural mutation: alter/delete a (possibly nested)
    field, inject an unknown field, type-flip a subtree, or truncate a
    list — the shapes a broken producer or chaos-truncated frame
    yields."""
    doc = copy.deepcopy(doc)
    paths = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in node:
                paths.append(path + (k,))
                walk(node[k], path + (k,))
        elif isinstance(node, list):
            for i in range(len(node)):
                walk(node[i], path + (i,))

    walk(doc, ())
    if not paths:
        return doc
    path = paths[rng.randrange(len(paths))]
    parent = doc
    for step in path[:-1]:
        parent = parent[step]
    key = path[-1]
    op = rng.randrange(5)
    if op == 0:
        del parent[key]
    elif op == 1:
        parent[key] = rng.choice([None, 0, 1.5, "junk", [], {},
                                  ["x", 1], {"zz": 1}])
    elif op == 2 and isinstance(parent, dict):
        parent[f"unknown_{rng.randrange(100)}"] = "extra"
    elif op == 3 and isinstance(parent.get(key) if isinstance(parent, dict)
                                else None, list):
        parent[key] = parent[key][: len(parent[key]) // 2]
    else:
        parent[key] = {"surprise": [1, 2, 3]}
    return doc


def _eq_mod_auto_uid(a, b):
    """Equality with both sides' metadata.uid blanked — the one impure
    decode output (ObjectMeta mints an auto-uid when the doc carries
    none)."""
    try:
        am = copy.copy(a.metadata)
        bm = copy.copy(b.metadata)
        am.uid = bm.uid = ""
        a2, b2 = copy.copy(a), copy.copy(b)
        a2.metadata, b2.metadata = am, bm
        return a2 == b2
    except (AttributeError, TypeError):
        return False


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_delta_never_diverges_or_invents_failures(seed):
    """For ANY mutated doc: if the full decode succeeds, the delta path
    (with fallback, as edge/client runs it) produces an EQUAL object; if
    the full decode raises, the delta+fallback path raises the same
    exception class.  The fast path can refuse (LookupError -> counted
    fallback) but can never diverge or die differently."""
    rng = random.Random(seed)
    templates = []
    for maker, enc in ((lambda: _featured_pod(f"p{seed}"), codec.encode),
                       (_node, codec.encode),
                       (lambda: _featured_pod(f"k{seed}"),
                        codec_k8s.to_k8s),
                       (_node, codec_k8s.to_k8s)):
        obj = maker()
        templates.append(_jsonify(enc(obj)))
    for doc in templates:
        prev = codec_k8s.decode_any(doc)
        codec.remember_wire_doc(prev, doc if "kind" in doc else
                                {k: v for k, v in doc.items()
                                 if k != "__kind__"})
        for _ in range(40):
            mutated = _mutate_doc(doc, rng)
            full_exc = full = None
            try:
                full = codec_k8s.decode_any(mutated)
            except Exception as exc:  # noqa: BLE001 — classifying
                # lint: allow-swallow(classifying, not ignoring: the captured exception is asserted against the delta path's below)
                full_exc = exc
            delta_exc = out = None
            try:
                try:
                    out = codec_k8s.decode_any_delta(mutated, prev)
                except LookupError:
                    out = codec_k8s.decode_any(mutated)  # the fallback
            except Exception as exc:  # noqa: BLE001 — classifying
                # lint: allow-swallow(classifying, not ignoring: both paths' exceptions are compared — fuzz parity is the assertion)
                delta_exc = exc
            if full_exc is None:
                assert delta_exc is None, (mutated, delta_exc)
                if out != full and not _eq_mod_auto_uid(out, full):
                    # Decode is pure EXCEPT ObjectMeta's auto-uid
                    # counter (a doc whose metadata lost its uid mints a
                    # fresh one per decode) — compare modulo that.
                    raise AssertionError((mutated, out, full))
            else:
                assert delta_exc is not None, (mutated, full_exc)
                assert type(delta_exc) is type(full_exc), (
                    mutated, delta_exc, full_exc)


def test_raw_key_malformed_docs_stay_in_the_routed_exception_set():
    """Review-pass regression: the reflector routes _raw_key failures to
    the full decode via (KeyError, TypeError, AttributeError) — a
    malformed frame raising anything ELSE would kill the reflector
    thread.  Fuzz the doc shapes (falsy/non-dict metadata included; the
    full k8s decode tolerates metadata: null, so the fast path must
    too)."""
    from kube_batch_tpu_torch.edge.client import _raw_key
    rng = random.Random(99)
    docs = [{"metadata": bad, "kind": "Pod"}
            for bad in (None, [], "", 0, 1.5, {"namespace": "x"},
                        {"name": None}, ["oops"])]
    base = _jsonify(codec_k8s.to_k8s(_featured_pod()))
    docs += [_mutate_doc(base, rng) for _ in range(60)]
    for resource in ("pods", "nodes", "podgroups", "queues"):
        for doc in docs:
            try:
                _raw_key(resource, doc)
            except (KeyError, TypeError, AttributeError):
                pass  # routed to the full decode by the reflector
    # {"metadata": None} specifically: the full k8s decode accepts it.
    assert codec_k8s.from_k8s({"kind": "Pod", "apiVersion": "v1",
                               "metadata": None}) is not None


def test_fallback_counter_moves_and_reflector_contract_holds():
    """Through the CLIENT chokepoint: a delta failure degrades to the
    counted full decode; a doc the full decode rejects still raises
    ValueError (the reflector's malformed-frame relist path)."""
    from kube_batch_tpu_torch.edge.client import RemoteCluster
    rc = RemoteCluster("http://127.0.0.1:1")  # never started
    pod = _featured_pod()
    doc = _jsonify(codec.encode(pod))
    before = metrics.wire_fast_counts()
    # prev without a baseline -> fallback("baseline") + full decode.
    out = rc._decode(doc, prev=codec.decode(doc))
    after = metrics.wire_fast_counts()
    assert out == codec.decode(doc)
    assert after.get("fallback_baseline", 0) == \
        before.get("fallback_baseline", 0) + 1
    # Malformed doc: ValueError propagates (full-path contract).
    with pytest.raises(ValueError):
        rc._decode({"__kind__": "Gizmo"}, prev=None)


def test_ingest_ts_stamped_at_frame_receipt_on_both_paths():
    """Satellite: lineage's ingest stamp must not shift when the fast
    path skips materialization — both paths stamp the FRAME-RECEIPT
    time the reflector passes down."""
    from kube_batch_tpu_torch.edge.client import RemoteCluster
    rc = RemoteCluster("http://127.0.0.1:1")
    pod = _featured_pod()
    doc = _jsonify(codec.encode(pod))
    full = rc._decode(doc, ingest_ts=123.5)
    assert full._ingest_ts == 123.5
    prev = rc._decode(doc, ingest_ts=1.0)  # stamps the delta baseline
    delta = rc._decode(doc, prev=prev, ingest_ts=456.25)
    assert delta._ingest_ts == 456.25
    # Without a frame stamp (egress reads) the old behavior holds.
    t0 = time.monotonic()
    solo = rc._decode(doc)
    assert t0 <= solo._ingest_ts <= time.monotonic()


def test_wire_fast_off_never_delta_decodes(monkeypatch):
    from kube_batch_tpu_torch.edge.client import RemoteCluster
    monkeypatch.setenv(WIRE_FAST_ENV, "0")
    rc = RemoteCluster("http://127.0.0.1:1")
    doc = _jsonify(codec.encode(_featured_pod()))
    prev = codec.decode(doc)
    codec.remember_wire_doc(prev,
                            {k: v for k, v in doc.items()
                             if k != "__kind__"})
    before = metrics.wire_fast_counts()
    out = rc._decode(doc, prev=prev)
    after = metrics.wire_fast_counts()
    assert out == prev
    assert after.get("decode_delta", 0) == before.get("decode_delta", 0)
    # The control arm must not even stamp baselines (no hidden state).
    assert not hasattr(out, "_wire_doc")


# ---------------------------------------------------------------------------
# 3. Session-level parity: staging + drf/job_valid/gang vs the control
# ---------------------------------------------------------------------------

def _assert_leaves_equal(a, b):
    for field in a._fields:
        x = np.asarray(getattr(a, field))
        y = np.asarray(getattr(b, field))
        assert x.dtype == y.dtype, field
        assert np.array_equal(x, y), field


# ---------------------------------------------------------------------------
# 5. Client over a live edge: fast mirror == control mirror
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["native", "k8s"])
def test_reflector_mirror_parity_over_live_edge(wire, monkeypatch):
    from kube_batch_tpu_torch.cache import Cluster
    from kube_batch_tpu_torch.edge import ApiServer, RemoteCluster

    def drive(fast: bool):
        monkeypatch.setenv(WIRE_FAST_ENV, "1" if fast else "0")
        cluster = Cluster()
        cluster.create_queue(v1alpha1.Queue(
            metadata=ObjectMeta(name="default"),
            spec=v1alpha1.QueueSpec(weight=1)))
        cluster.create_node(_node("n-1"))
        for i in range(6):
            cluster.create_pod(_featured_pod(f"p-{i}", ns="bench"))
        server = ApiServer(cluster).start()
        try:
            remote = RemoteCluster(server.url, wire=wire).start(
                timeout=30)
            try:
                before = metrics.wire_fast_counts()
                # Updates for known pods: the delta path's bread and
                # butter (status echo + a bind).
                for i in range(6):
                    old = cluster.get_pod("bench", f"p-{i}")
                    new = dc.replace(
                        old, spec=dc.replace(old.spec,
                                             node_name="n-1"),
                        status=PodStatus(phase="Running"))
                    cluster.update_pod(new)
                deadline = time.time() + 20
                while time.time() < deadline:
                    with remote.lock:
                        done = all(
                            p.spec.node_name == "n-1"
                            for p in remote.pods.values()) and \
                            len(remote.pods) == 6
                    if done:
                        break
                    time.sleep(0.02)
                after = metrics.wire_fast_counts()
                with remote.lock:
                    mirror = {k: remote.pods[k]
                              for k in sorted(remote.pods)}
                return mirror, {
                    k: after.get(k, 0) - before.get(k, 0)
                    for k in after}
            finally:
                remote.stop()
        finally:
            server.stop()

    control, ccounts = drive(False)
    fast, fcounts = drive(True)
    assert list(control) == list(fast)
    for key in control:
        assert control[key] == fast[key], key
    assert fcounts.get("decode_delta", 0) >= 6, fcounts
    assert ccounts.get("decode_delta", 0) == 0, ccounts
