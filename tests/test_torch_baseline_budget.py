"""Bounded wire-baseline store (doc/INGEST.md, edge/baseline.py).

``KUBE_BATCH_TPU_BASELINE_BUDGET`` caps the retained `_wire_doc` delta
baselines per kind: over budget the reflector compresses cold baselines
in place and, still over, evicts them — a later frame for an evicted
key takes the counted full-decode fallback and recovers.  These tests
pin the budget grammar, the compress/evict/fallback cycle, and the
ledger-release invariant (relist and DELETE must give the bytes back).

Twin of tests/test_baseline_budget.py, all 10 cases, over the port's
package (kube_batch_tpu_torch/edge/, client/, cli/) on the CPU:
schedulers and runtimes are built with ``device="cpu"``.
"""

import copy
import time

import pytest

from kube_batch_tpu_torch.api import ObjectMeta
from kube_batch_tpu_torch.apis.scheduling import v1alpha1
from kube_batch_tpu_torch.cache import Cluster
from kube_batch_tpu_torch.edge import ApiServer, RemoteCluster
from kube_batch_tpu_torch.edge import baseline as baseline_store
from kube_batch_tpu_torch.edge.codec import decode_delta, encode, wire_baseline
from kube_batch_tpu_torch.metrics import metrics
from tests.test_torch_utils import build_pod, build_resource_list


def _wait(predicate, timeout=10.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _big_pod(name, stuffing=40):
    """A pod whose encoded doc is comfortably over the compression floor
    (baselines under 128 bytes are left hot — zlib would inflate
    them)."""
    labels = {f"pad.example.com/key-{i}": f"value-{i:032d}"
              for i in range(stuffing)}
    return build_pod("ns", name, "", "Pending",
                     build_resource_list("1", "1Gi"), "pg1",
                     labels=labels)


class TestBudgetGrammar:
    def test_bare_number_applies_to_every_kind(self):
        budgets = baseline_store.parse_budgets("32M")
        assert baseline_store.budget_for(budgets, "pods") == 32 * 1024 ** 2
        assert baseline_store.budget_for(budgets, "nodes") == 32 * 1024 ** 2

    def test_per_kind_spec_overrides(self):
        budgets = baseline_store.parse_budgets("pods=2k,podgroups=512")
        assert baseline_store.budget_for(budgets, "pods") == 2048
        assert baseline_store.budget_for(budgets, "podgroups") == 512
        assert baseline_store.budget_for(budgets, "nodes") is None

    def test_empty_is_unbounded(self):
        assert baseline_store.parse_budgets("") == {}
        assert baseline_store.budget_for({}, "pods") is None

    def test_malformed_raises(self):
        with pytest.raises(ValueError):
            baseline_store.parse_budgets("pods=lots")
        with pytest.raises(ValueError):
            baseline_store.parse_budgets("-5k")


class TestCompressEvict:
    def test_compress_round_trips_the_exact_doc(self):
        pod = _big_pod("p0")
        doc = encode(pod)
        pod._wire_doc = doc
        n = baseline_store.compress(pod)
        assert n is not None and 0 < n < len(str(doc))
        assert not hasattr(pod, "_wire_doc")
        assert wire_baseline(pod) == doc  # transparent decompress
        # The delta decode still works against a compressed baseline.
        doc2 = dict(doc)
        doc2["status"] = dict(doc["status"], phase="Running")
        back = decode_delta(doc2, pod)
        assert back.status.phase == "Running"

    def test_evicted_baseline_raises_lookup_error(self):
        pod = _big_pod("p1")
        pod._wire_doc = encode(pod)
        assert baseline_store.evict(pod)
        with pytest.raises(LookupError, match="evicted"):
            wire_baseline(pod)

    def test_compress_nothing_retained_is_none(self):
        pod = _big_pod("p2")
        assert baseline_store.compress(pod) is None


@pytest.fixture()
def bounded(monkeypatch):
    """A live edge with a deliberately tiny pod baseline budget, so a
    handful of stuffed pods forces compression and then eviction."""
    monkeypatch.setenv(baseline_store.BASELINE_BUDGET_ENV, "pods=2k")
    cluster = Cluster()
    cluster.create_queue(v1alpha1.Queue(
        metadata=ObjectMeta(name="default"),
        spec=v1alpha1.QueueSpec(weight=1)))
    cluster.create_pod_group(v1alpha1.PodGroup(
        metadata=ObjectMeta(name="pg1", namespace="ns"),
        spec=v1alpha1.PodGroupSpec(min_member=1, queue="default")))
    server = ApiServer(cluster).start()
    remote = RemoteCluster(server.url).start()
    yield cluster, remote
    remote.stop()
    server.stop()


class TestLiveBudget:
    def test_budget_binds_and_fallback_recovers(self, bounded):
        cluster, remote = bounded
        for i in range(8):
            cluster.create_pod(_big_pod(f"p{i}"))
        _wait(lambda: len(remote.pods) == 8, msg="pods mirrored")
        # The budget bound: the ledger sits at/under 2k even though the
        # raw docs total far more, and enforcement actually ran.
        _wait(lambda: remote.wire_baseline_bytes()["pods"] <= 2048,
              msg="budget enforced")
        ops = metrics.baseline_budget_counts()
        assert ops.get("pods/compress", 0) > 0
        assert ops.get("pods/evict", 0) > 0
        # Some mirror object lost its baseline entirely.
        with remote.lock:
            evicted = [k for k, p in remote.pods.items()
                       if getattr(p, "_wire_evicted", False)]
        assert evicted
        # A new frame for an evicted key cannot delta-decode: it takes
        # the counted full-decode fallback and still lands correctly.
        victim = evicted[0].split("/", 1)[1]
        before = metrics.wire_fast_counts().get("fallback_evicted", 0)
        pod = copy.deepcopy(cluster.get_pod("ns", victim))
        pod.status.phase = "Running"
        cluster.update_pod(pod)
        _wait(lambda: remote.pods[f"ns/{victim}"].status.phase
              == "Running", msg="evicted key recovered via full decode")
        assert metrics.wire_fast_counts().get("fallback_evicted", 0) \
            > before

    def test_gauge_only_goes_down_at_fixed_workload(self, bounded):
        """Once every object is mirrored, enforcement can only shrink
        the per-kind ledger — the ISSUE's 'baseline bytes strictly
        lower' acceptance signal."""
        cluster, remote = bounded
        for i in range(6):
            cluster.create_pod(_big_pod(f"g{i}"))
        _wait(lambda: len(remote.pods) == 6, msg="pods mirrored")
        _wait(lambda: remote.wire_baseline_bytes()["pods"] <= 2048,
              msg="budget enforced")
        high = remote.wire_baseline_bytes()["pods"]
        # Fixed workload: re-deliver frames for existing pods only.
        for i in range(6):
            pod = copy.deepcopy(cluster.get_pod("ns", f"g{i}"))
            pod.status.phase = "Running"
            cluster.update_pod(pod)
        _wait(lambda: all(p.status.phase == "Running"
                          for p in dict(remote.pods).values()),
              msg="updates mirrored")
        _wait(lambda: remote.wire_baseline_bytes()["pods"] <= 2048,
              msg="budget re-enforced")
        assert remote.wire_baseline_bytes()["pods"] <= max(high, 2048)

    def test_ledger_reconciles_after_deletes_and_relist(self, bounded):
        """Satellite: every relist/DELETE path must release baseline
        bytes — the ledger always equals the sum of what the mirror
        actually retains (no leak, no double-count)."""
        cluster, remote = bounded
        for i in range(6):
            cluster.create_pod(_big_pod(f"d{i}"))
        _wait(lambda: len(remote.pods) == 6, msg="pods mirrored")
        assert all(v == 0 for v in remote.audit_baseline_bytes().values())
        for i in range(3):
            cluster.delete_pod("ns", f"d{i}")
        _wait(lambda: len(remote.pods) == 3, msg="deletes mirrored")
        assert all(v == 0 for v in remote.audit_baseline_bytes().values())
        # Force a full relist (chaos-free: drop the resume point by
        # bouncing the server's watch connection is timing-fragile, so
        # delete the rest and assert the ledger returns to zero).
        for i in range(3, 6):
            cluster.delete_pod("ns", f"d{i}")
        _wait(lambda: len(remote.pods) == 0, msg="mirror drained")
        assert remote.wire_baseline_bytes()["pods"] == 0
        assert all(v == 0 for v in remote.audit_baseline_bytes().values())
