"""Kubernetes-convention wire compatibility (SURVEY.md §2.2: the comm
backend's API contract).  A kubectl-shaped manifest submits to the edge
unchanged, listings read back in k8s shape, and the native codec keeps
working side by side.

Twin of tests/test_k8s_wire.py, its last 12 cases: merge and strategic-
merge patch, status subresources, the k8s wire end to end and the review
findings (the first 13 are in tests/test_torch_k8s_wire.py), over the
port's package (kube_batch_tpu_torch/edge/, client/, cli/) on the CPU:
schedulers and runtimes are built with ``device="cpu"``.
"""

import gc
import json
import time
import urllib.request

import pytest

from kube_batch_tpu_torch.api import ObjectMeta
from kube_batch_tpu_torch.api.objects import PodStatus
from kube_batch_tpu_torch.apis.scheduling import v1alpha1
from kube_batch_tpu_torch.cache import Cluster, new_scheduler_cache
from kube_batch_tpu_torch.edge import ApiServer, RemoteCluster
from kube_batch_tpu_torch.edge.codec_k8s import to_k8s
from kube_batch_tpu_torch.scheduler import Scheduler
from tests.test_torch_utils import build_node, build_pod, build_resource_list


@pytest.fixture(autouse=True)
def _unfreeze():
    """Scheduler.run() freezes the collector's view of the synced cache;
    undo it after each case."""
    yield
    gc.unfreeze()



def _http(method, url, payload=None,
          content_type="application/json"):
    body = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=body, method=method,
                                 headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:  # 4xx/5xx still carry JSON
        return err.code, json.loads(err.read())


class TestPatchAndStatus:
    @pytest.fixture()
    def api(self):
        cluster = Cluster()
        server = ApiServer(cluster).start()
        yield cluster, server
        server.stop()

    def test_merge_patch_pod_labels(self, api):
        cluster, server = api
        cluster.create_pod(build_pod(
            "ns", "p0", "", "Pending", build_resource_list("1", "1Gi"),
            labels={"app": "web", "legacy": "1"}))
        status, _ = _http(
            "PATCH", f"{server.url}/api/v1/namespaces/ns/pods/p0",
            {"metadata": {"labels": {"tier": "fe", "legacy": None}}},
            content_type="application/merge-patch+json")
        assert status == 200
        pod = cluster.get_pod("ns", "p0")
        # RFC 7386: merge adds tier, null deletes legacy, app survives.
        assert pod.metadata.labels == {"app": "web", "tier": "fe"}

    def test_merge_patch_pod_status_subresource(self, api):
        cluster, server = api
        cluster.create_pod(build_pod(
            "ns", "p0", "", "Pending", build_resource_list("1", "1Gi")))
        status, _ = _http(
            "PATCH", f"{server.url}/api/v1/namespaces/ns/pods/p0/status",
            {"status": {"phase": "Failed"}},
            content_type="application/merge-patch+json")
        assert status == 200
        assert cluster.get_pod("ns", "p0").status.phase == "Failed"

    def test_merge_patch_pod_group_status(self, api):
        cluster, server = api
        cluster.create_pod_group(v1alpha1.PodGroup(
            metadata=ObjectMeta(name="pg", namespace="ns"),
            spec=v1alpha1.PodGroupSpec(min_member=2)))
        status, _ = _http(
            "PATCH", f"{server.url}/apis/{v1alpha1.GROUP}/v1alpha1/"
                     f"namespaces/ns/podgroups/pg/status",
            {"status": {"phase": "Running", "running": 2}},
            content_type="application/merge-patch+json")
        assert status == 200
        pg = cluster.pod_groups["ns/pg"]
        assert pg.status.phase == "Running" and pg.status.running == 2

    def test_patch_missing_object_404(self, api):
        _, server = api
        status, _ = _http(
            "PATCH", f"{server.url}/api/v1/namespaces/ns/pods/ghost",
            {"metadata": {"labels": {"a": "b"}}},
            content_type="application/merge-patch+json")
        assert status == 404

    def test_put_status_full_pod_applies_phase(self, api):
        """ADVICE r3 #4: a PUT of a full Pod on the status subresource
        must apply the phase, not just conditions."""
        cluster, server = api
        cluster.create_pod(build_pod(
            "ns", "p0", "", "Pending", build_resource_list("1", "1Gi")))
        body = to_k8s(cluster.get_pod("ns", "p0"))
        body["status"] = {"phase": "Running", "conditions": [
            {"type": "PodScheduled", "status": "True"}]}
        status, _ = _http(
            "PUT", f"{server.url}/api/v1/namespaces/ns/pods/p0/status",
            body)
        assert status == 200
        pod = cluster.get_pod("ns", "p0")
        assert pod.status.phase == "Running"
        assert pod.status.conditions[0].type == "PodScheduled"


class TestK8sWireEndToEnd:
    """VERDICT r3 next #6: the full e2e scenarios run over the
    Kubernetes-convention wire (wire="k8s"), not only the native /v1
    codec — ingest via /api + /apis watches with camelCase bodies,
    binds via the Binding subresource, stuck-pod conditions via
    merge-patch, PodGroup status via the status subresource."""

    @pytest.fixture()
    def api(self):
        cluster = Cluster()
        server = ApiServer(cluster).start()
        yield cluster, server
        server.stop()

    def test_gang_schedules_over_k8s_wire(self, api):
        cluster, server = api
        remote = RemoteCluster(server.url, wire="k8s").start()
        try:
            remote.create_node(build_node("n0", build_resource_list(
                "8", "16Gi", pods=110)))
            remote.create_queue(v1alpha1.Queue(
                metadata=ObjectMeta(name="default"),
                spec=v1alpha1.QueueSpec(weight=1)))
            remote.create_pod_group(v1alpha1.PodGroup(
                metadata=ObjectMeta(name="gang", namespace="ns"),
                spec=v1alpha1.PodGroupSpec(min_member=2, queue="default")))
            for i in range(2):
                remote.create_pod(build_pod(
                    "ns", f"g{i}", "", "Pending",
                    build_resource_list("1", "1Gi"), "gang"))
            cache = new_scheduler_cache(remote)
            sched = Scheduler(cache, device="cpu", schedule_period=0.05)
            sched.run()
            try:
                deadline = time.time() + 30
                bound = []
                while time.time() < deadline:
                    with cluster.lock:
                        bound = [p for p in cluster.pods.values()
                                 if p.spec.node_name]
                    if len(bound) == 2:
                        break
                    time.sleep(0.05)
            finally:
                sched.stop()
            assert len(bound) == 2  # bound via the Binding subresource
            # PodGroup status written back through /apis .../status.
            deadline = time.time() + 10
            while time.time() < deadline:
                with cluster.lock:
                    pg = cluster.pod_groups["ns/gang"]
                if pg.status.phase == "Running":
                    break
                time.sleep(0.05)
            assert pg.status.phase == "Running"
        finally:
            remote.stop()

    def test_stuck_pod_condition_via_merge_patch(self, api):
        cluster, server = api
        remote = RemoteCluster(server.url, wire="k8s").start()
        try:
            remote.create_node(build_node("n0", build_resource_list(
                "2", "4Gi", pods=110)))
            remote.create_queue(v1alpha1.Queue(
                metadata=ObjectMeta(name="default"),
                spec=v1alpha1.QueueSpec(weight=1)))
            remote.create_pod_group(v1alpha1.PodGroup(
                metadata=ObjectMeta(name="stuck", namespace="ns"),
                spec=v1alpha1.PodGroupSpec(min_member=3, queue="default")))
            cache = new_scheduler_cache(remote)
            sched = Scheduler(cache, device="cpu", schedule_period=0.05)
            sched.run()
            try:
                for i in range(3):
                    remote.create_pod(build_pod(
                        "ns", f"p{i}", "", "Pending",
                        build_resource_list("2", "4Gi"), "stuck"))
                deadline = time.time() + 30
                conds, events = [], []
                while time.time() < deadline:
                    with cluster.lock:
                        pod = cluster.pods.get("ns/p0")
                        conds = list(pod.status.conditions) if pod else []
                        events = cluster.events.values()
                    if conds and any(e.reason == "FailedScheduling"
                                     for e in events):
                        break
                    time.sleep(0.1)
            finally:
                sched.stop()
            # Condition arrived through PATCH application/merge-patch+json.
            assert any(c.type == "PodScheduled" and c.status == "False"
                       and c.reason == "Unschedulable"
                       for c in conds), conds
            assert any(e.reason == "FailedScheduling" for e in events)
        finally:
            remote.stop()


class TestReviewFindings:
    """Round-4 review: watch-selector validation, resume transitions,
    strategic-merge conditions."""

    @pytest.fixture()
    def api(self):
        cluster = Cluster()
        server = ApiServer(cluster).start()
        yield cluster, server
        server.stop()

    def test_watch_bad_field_selector_answers_400(self, api):
        _, server = api
        status, out = _http(
            "GET", f"{server.url}/api/v1/pods"
                   f"?watch=1&fieldSelector=spec.hostNetwork%3Dtrue")
        assert status == 400
        assert "field label not supported" in out["error"]

    def test_resume_replay_applies_selector_transitions(self, api):
        """An object that LEFT the selector while a filtered watcher was
        disconnected must replay as DELETED, not vanish."""
        import dataclasses as dc
        cluster, server = api
        cluster.create_pod(build_pod(
            "ns", "p0", "", "Pending", build_resource_list("1", "1Gi")))
        url = (f"{server.url}/api/v1/pods"
               f"?watch=1&fieldSelector=status.phase%3DPending")
        with urllib.request.urlopen(url, timeout=10) as resp:
            lines = iter(resp)
            assert json.loads(next(lines))["type"] == "ADDED"
            sync = json.loads(next(lines))
            assert sync["type"] == "SYNC"
            rv = sync["rv"]
        # While disconnected: p0 leaves Pending.
        old = cluster.get_pod("ns", "p0")
        cluster.update_pod(dc.replace(old,
                                      status=PodStatus(phase="Running")))
        with urllib.request.urlopen(f"{url}&resourceVersion={rv}",
                                    timeout=10) as resp:
            lines = iter(resp)
            assert json.loads(next(lines))["type"] == "RESUMED"
            ev = json.loads(next(lines))
        assert ev["type"] == "DELETED"
        assert ev["object"]["metadata"]["name"] == "p0"

    def test_strategic_merge_preserves_other_conditions(self, api):
        """PATCHing one condition by type must not clobber conditions a
        concurrent writer added (patchMergeKey semantics)."""
        from kube_batch_tpu_torch.api import PodCondition
        cluster, server = api
        cluster.create_pod(build_pod(
            "ns", "p0", "", "Pending", build_resource_list("1", "1Gi")))
        # Another writer (kubelet-analog) sets Ready first.
        cluster.update_pod_condition("ns", "p0", PodCondition(
            type="Ready", status="True"))
        status, _ = _http(
            "PATCH", f"{server.url}/api/v1/namespaces/ns/pods/p0/status",
            {"status": {"conditions": [
                {"type": "PodScheduled", "status": "False",
                 "reason": "Unschedulable"}]}},
            content_type="application/strategic-merge-patch+json")
        assert status == 200
        conds = {c.type: c for c in
                 cluster.get_pod("ns", "p0").status.conditions}
        assert conds["Ready"].status == "True"  # survived the patch
        assert conds["PodScheduled"].reason == "Unschedulable"

    def test_malformed_label_selectors_rejected(self, api):
        """Typos must answer 400, not silently never-match."""
        from kube_batch_tpu_torch.edge.selectors import parse_label_selector
        for bad in ("a!b", "!a b", "(bad in (a)", "env in ()", "!"):
            with pytest.raises(ValueError):
                parse_label_selector(bad)
        _, server = api
        status, _ = _http(
            "GET", f"{server.url}/api/v1/pods?labelSelector=a%21b")
        assert status == 400

    def test_patch_pod_named_status(self, api):
        """A pod literally named "status" patches as an object, like PUT."""
        cluster, server = api
        cluster.create_pod(build_pod(
            "ns", "status", "", "Pending", build_resource_list("1", "1Gi")))
        status, _ = _http(
            "PATCH", f"{server.url}/api/v1/namespaces/ns/pods/status",
            {"metadata": {"labels": {"odd": "name"}}},
            content_type="application/merge-patch+json")
        assert status == 200
        assert cluster.get_pod("ns", "status").metadata.labels == {
            "odd": "name"}
