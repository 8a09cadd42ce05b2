"""Kubernetes-convention wire compatibility (SURVEY.md §2.2: the comm
backend's API contract).  A kubectl-shaped manifest submits to the edge
unchanged, listings read back in k8s shape, and the native codec keeps
working side by side.

Twin of tests/test_k8s_wire.py, its first 13 cases: the k8s codec, the
kubectl-shaped paths and the selectors (the other 12 are in
tests/test_torch_k8s_wire_patch.py; the reference file has 25, more than
a file here may hold), over the port's package
(kube_batch_tpu_torch/edge/, client/, cli/) on the CPU: schedulers and
runtimes are built with ``device="cpu"``.
"""

import gc
import json
import time
import urllib.request

import pytest

from kube_batch_tpu_torch.api import ObjectMeta
from kube_batch_tpu_torch.api.objects import (Affinity, Container, ContainerPort,
                                              Pod, PodSpec, PodStatus, Toleration)
from kube_batch_tpu_torch.apis.scheduling import v1alpha1, v1alpha2
from kube_batch_tpu_torch.cache import Cluster, new_scheduler_cache
from kube_batch_tpu_torch.edge import ApiServer, RemoteCluster
from kube_batch_tpu_torch.edge.codec_k8s import decode_any, from_k8s, to_k8s
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


class TestCodecK8s:
    def test_pod_round_trip_preserves_scheduling_fields(self):
        pod = Pod(
            metadata=ObjectMeta(name="p0", namespace="ns", uid="u0",
                                labels={"app": "web"},
                                annotations={"scheduling.k8s.io/group-name":
                                             "pg1"},
                                creation_timestamp=1700000000.0),
            spec=PodSpec(
                node_selector={"zone": "z1"},
                priority=7, priority_class_name="high",
                tolerations=[Toleration(key="dedicated", operator="Equal",
                                        value="t1", effect="NoSchedule")],
                affinity=Affinity(
                    required_node_terms=[{"pool": "a"}],
                    preferred_node_terms=[(5, {"zone": "z1"})],
                    required_pod_anti_affinity=[{"app": "web"}],
                    preferred_pod_affinity=[(10, {"tier": "db"})]),
                containers=[Container(requests={"cpu": "2",
                                                "memory": "4Gi"},
                                      ports=[ContainerPort(host_port=80)])],
                volumes=["claim-a"]),
            status=PodStatus(phase="Pending"))
        doc = to_k8s(pod)
        # k8s conventions on the wire.
        assert doc["kind"] == "Pod" and doc["apiVersion"] == "v1"
        assert doc["spec"]["nodeSelector"] == {"zone": "z1"}
        assert doc["spec"]["priorityClassName"] == "high"
        assert (doc["spec"]["containers"][0]["resources"]["requests"]
                == {"cpu": "2", "memory": "4Gi"})
        assert doc["spec"]["containers"][0]["ports"][0]["hostPort"] == 80
        na = doc["spec"]["affinity"]["nodeAffinity"]
        assert na["requiredDuringSchedulingIgnoredDuringExecution"][
            "nodeSelectorTerms"][0]["matchExpressions"][0] == {
                "key": "pool", "operator": "In", "values": ["a"]}
        assert doc["spec"]["volumes"][0]["persistentVolumeClaim"][
            "claimName"] == "claim-a"
        assert doc["metadata"]["creationTimestamp"].endswith("Z")

        back = from_k8s(doc)
        assert back.metadata.name == "p0"
        assert back.metadata.annotations == pod.metadata.annotations
        assert back.spec.node_selector == {"zone": "z1"}
        assert back.spec.priority == 7
        assert back.spec.tolerations == pod.spec.tolerations
        assert back.spec.affinity == pod.spec.affinity
        assert back.spec.containers[0].requests == {"cpu": "2",
                                                    "memory": "4Gi"}
        assert back.spec.containers[0].ports[0].host_port == 80
        assert back.spec.volumes == ["claim-a"]
        assert back.metadata.creation_timestamp == 1700000000.0

    def test_pod_group_versions_round_trip(self):
        for module in (v1alpha1, v1alpha2):
            pg = module.PodGroup(
                metadata=ObjectMeta(name="pg", namespace="ns"),
                spec=module.PodGroupSpec(min_member=3, queue="q1",
                                         priority_class_name="high"))
            doc = to_k8s(pg)
            assert doc["apiVersion"] == f"{module.GROUP}/{module.VERSION}"
            assert doc["spec"]["minMember"] == 3
            back = from_k8s(doc)
            assert isinstance(back, module.PodGroup)
            assert back.spec.min_member == 3
            assert back.spec.queue == "q1"

    def test_decode_any_handles_both_formats(self):
        from kube_batch_tpu_torch.edge.codec import encode
        pod = build_pod("ns", "p", "", "Pending",
                        build_resource_list("1", "1Gi"), "pg")
        assert decode_any(encode(pod)).metadata.name == "p"
        assert decode_any(to_k8s(pod)).metadata.name == "p"
        with pytest.raises(ValueError):
            decode_any({"neither": True})

    def test_unsupported_expressions_rejected_not_dropped(self):
        doc = to_k8s(Pod(metadata=ObjectMeta(name="p", namespace="ns"),
                         spec=PodSpec(affinity=Affinity(
                             required_node_terms=[{"a": "b"}]))))
        terms = doc["spec"]["affinity"]["nodeAffinity"][
            "requiredDuringSchedulingIgnoredDuringExecution"][
            "nodeSelectorTerms"]
        terms[0]["matchExpressions"][0]["operator"] = "NotIn"
        with pytest.raises(ValueError):
            from_k8s(doc)


class TestK8sPathsOverHttp:
    @pytest.fixture()
    def api(self):
        cluster = Cluster()
        server = ApiServer(cluster).start()
        yield cluster, server
        server.stop()

    def test_kubectl_shaped_manifests_schedule(self, api):
        cluster, server = api
        cluster.create_node(build_node("n0", build_resource_list(
            "8", "16Gi", pods=110)))
        cluster.create_queue(v1alpha1.Queue(
            metadata=ObjectMeta(name="default"),
            spec=v1alpha1.QueueSpec(weight=1)))
        base = server.url
        # A PodGroup manifest exactly as the reference's users write them.
        status, _ = _http("POST", f"{base}/apis/{v1alpha1.GROUP}/v1alpha1/"
                                  f"namespaces/demo/podgroups",
                          {"apiVersion": f"{v1alpha1.GROUP}/v1alpha1",
                           "kind": "PodGroup",
                           "metadata": {"name": "qj-1", "namespace": "demo"},
                           "spec": {"minMember": 2}})
        assert status == 201
        for i in range(2):
            status, _ = _http(
                "POST", f"{base}/api/v1/namespaces/demo/pods",
                {"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": f"qj-1-{i}", "namespace": "demo",
                              "annotations": {
                                  "scheduling.k8s.io/group-name": "qj-1"}},
                 "spec": {"schedulerName": "kube-batch",
                          "containers": [{"name": "main", "resources": {
                              "requests": {"cpu": "1",
                                           "memory": "1Gi"}}}]}})
            assert status == 201

        remote = RemoteCluster(server.url).start()
        cache = new_scheduler_cache(remote)
        sched = Scheduler(cache, device="cpu", schedule_period=0.05)
        sched.run()
        try:
            deadline = time.time() + 30
            while time.time() < deadline:
                with cluster.lock:
                    bound = [p for p in cluster.pods.values()
                             if p.spec.node_name]
                if len(bound) == 2:
                    break
                time.sleep(0.05)
        finally:
            sched.stop()
            remote.stop()
        assert len(bound) == 2

        # Listing back in k8s shape, namespace-scoped.
        status, listing = _http("GET", f"{base}/api/v1/namespaces/demo/pods")
        assert status == 200 and listing["kind"] == "List"
        assert {d["metadata"]["name"] for d in listing["items"]} == {
            "qj-1-0", "qj-1-1"}
        assert all(d["spec"]["nodeName"] == "n0" for d in listing["items"])
        # Single-object GET + k8s binding subresource already exercised by
        # the scheduler path; spot-check the object shape.
        status, doc = _http("GET",
                            f"{base}/api/v1/namespaces/demo/pods/qj-1-0")
        assert status == 200 and doc["kind"] == "Pod"
        assert doc["status"]["phase"] == "Running"

    def test_k8s_binding_subresource(self, api):
        cluster, server = api
        cluster.create_node(build_node("n0", build_resource_list(
            "4", "8Gi", pods=110)))
        cluster.create_pod(build_pod("ns", "p0", "", "Pending",
                                     build_resource_list("1", "1Gi"), "pg"))
        status, _ = _http(
            "POST", f"{server.url}/api/v1/namespaces/ns/pods/p0/binding",
            {"apiVersion": "v1", "kind": "Binding",
             "metadata": {"name": "p0"}, "target": {"name": "n0"}})
        assert status == 200
        assert cluster.get_pod("ns", "p0").spec.node_name == "n0"

    def test_path_namespace_defaults_into_manifest(self, api):
        cluster, server = api
        status, _ = _http(
            "POST", f"{server.url}/api/v1/namespaces/prod/pods",
            {"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": "no-ns"},  # kubectl supplies ns via path
             "spec": {"containers": [{"name": "m", "resources": {
                 "requests": {"cpu": "1"}}}]}})
        assert status == 201
        assert cluster.get_pod("prod", "no-ns") is not None
        # Namespaced LIST and WATCH agree about scoping.
        status, listing = _http("GET",
                                f"{server.url}/api/v1/namespaces/prod/pods")
        assert [d["metadata"]["name"] for d in listing["items"]] == ["no-ns"]
        status, other = _http("GET",
                              f"{server.url}/api/v1/namespaces/qa/pods")
        assert other["items"] == []
        import urllib.request as _rq
        with _rq.urlopen(f"{server.url}/api/v1/namespaces/qa/pods?watch=1",
                         timeout=5) as resp:
            first = json.loads(next(iter(resp)))
        assert first["type"] == "SYNC"  # no foreign-namespace ADDED replay


class TestSelectors:
    """apimachinery selector grammar (edge/selectors.py)."""

    def test_label_selector_grammar(self):
        from kube_batch_tpu_torch.edge.selectors import parse_label_selector
        m = parse_label_selector("app=web")
        assert m({"app": "web"}) and not m({"app": "db"}) and not m({})
        m = parse_label_selector("app==web")
        assert m({"app": "web"}) and not m({})
        # != and notin select objects WITHOUT the key too (k8s docs).
        m = parse_label_selector("env!=prod")
        assert m({"env": "dev"}) and m({}) and not m({"env": "prod"})
        m = parse_label_selector("env in (dev, qa)")
        assert m({"env": "qa"}) and not m({"env": "prod"}) and not m({})
        m = parse_label_selector("env notin (prod)")
        assert m({"env": "dev"}) and m({}) and not m({"env": "prod"})
        m = parse_label_selector("app")
        assert m({"app": "anything"}) and not m({})
        m = parse_label_selector("!app")
        assert m({}) and not m({"app": "x"})
        # Comma = AND; commas inside value sets don't split requirements.
        m = parse_label_selector("app=web,env in (dev, qa),!legacy")
        assert m({"app": "web", "env": "dev"})
        assert not m({"app": "web", "env": "prod"})
        assert not m({"app": "web", "env": "dev", "legacy": "1"})
        with pytest.raises(ValueError):
            parse_label_selector("a=b=c")
        with pytest.raises(ValueError):
            parse_label_selector("bad key")

    def test_field_selector_paths(self):
        from kube_batch_tpu_torch.edge.selectors import parse_field_selector
        pod = build_pod("ns", "p0", "n1", "Running",
                        build_resource_list("1", "1Gi"))
        assert parse_field_selector("pods", "spec.nodeName=n1")(pod)
        assert not parse_field_selector("pods", "spec.nodeName!=n1")(pod)
        assert parse_field_selector("pods", "status.phase=Running")(pod)
        assert parse_field_selector(
            "pods", "metadata.namespace=ns,metadata.name=p0")(pod)
        assert parse_field_selector(
            "pods", "spec.schedulerName=kube-batch")(pod)
        with pytest.raises(ValueError):
            parse_field_selector("pods", "spec.hostNetwork=true")(pod)


class TestSelectorsOverHttp:
    @pytest.fixture()
    def api(self):
        cluster = Cluster()
        server = ApiServer(cluster).start()
        yield cluster, server
        server.stop()

    def _seed(self, cluster):
        cluster.create_node(build_node("n0", build_resource_list(
            "8", "16Gi", pods=110)))
        cluster.create_pod(build_pod(
            "ns", "web-0", "n0", "Running",
            build_resource_list("1", "1Gi"), labels={"app": "web"}))
        cluster.create_pod(build_pod(
            "ns", "db-0", "", "Pending",
            build_resource_list("1", "1Gi"), labels={"app": "db"}))

    def test_list_label_selector_both_codecs(self, api):
        cluster, server = api
        self._seed(cluster)
        status, out = _http(
            "GET", f"{server.url}/api/v1/namespaces/ns/pods"
                   f"?labelSelector=app%3Dweb")
        assert status == 200
        assert [d["metadata"]["name"] for d in out["items"]] == ["web-0"]
        status, out = _http(
            "GET", f"{server.url}/v1/pods?labelSelector=app%3Ddb")
        assert status == 200
        assert [d["metadata"]["name"] for d in out["items"]] == ["db-0"]

    def test_list_field_selector(self, api):
        cluster, server = api
        self._seed(cluster)
        status, out = _http(
            "GET", f"{server.url}/api/v1/pods"
                   f"?fieldSelector=status.phase%3DPending")
        assert status == 200
        assert [d["metadata"]["name"] for d in out["items"]] == ["db-0"]
        # kubectl's classic "pods on node n0".
        status, out = _http(
            "GET", f"{server.url}/api/v1/pods"
                   f"?fieldSelector=spec.nodeName%3Dn0")
        assert [d["metadata"]["name"] for d in out["items"]] == ["web-0"]

    def test_bad_selectors_answer_400(self, api):
        cluster, server = api
        self._seed(cluster)
        status, out = _http(
            "GET", f"{server.url}/api/v1/pods?labelSelector=a%3Db%3Dc")
        assert status == 400
        status, out = _http(
            "GET", f"{server.url}/api/v1/pods"
                   f"?fieldSelector=spec.hostNetwork%3Dtrue")
        assert status == 400
        assert "field label not supported" in out["error"]

    def test_watch_selector_boundary_transitions(self, api):
        """A filtered watch emits ADDED/DELETED when a MODIFIED object
        crosses the selector boundary (real apiserver behavior)."""
        import dataclasses as dc
        cluster, server = api
        self._seed(cluster)
        url = (f"{server.url}/api/v1/pods"
               f"?watch=1&fieldSelector=status.phase%3DPending")
        resp = urllib.request.urlopen(url, timeout=10)
        lines = iter(resp)
        first = json.loads(next(lines))
        assert first["type"] == "ADDED"
        assert first["object"]["metadata"]["name"] == "db-0"
        assert json.loads(next(lines))["type"] == "SYNC"
        # db-0 leaves Pending -> DELETED on this filtered stream.
        old = cluster.get_pod("ns", "db-0")
        new = dc.replace(old, status=PodStatus(phase="Running"))
        cluster.update_pod(new)
        ev = json.loads(next(lines))
        assert ev["type"] == "DELETED"
        assert ev["object"]["metadata"]["name"] == "db-0"
        # ...and back to Pending -> ADDED.
        cluster.update_pod(dc.replace(new,
                                      status=PodStatus(phase="Pending")))
        ev = json.loads(next(lines))
        assert ev["type"] == "ADDED"
        resp.close()
