"""Typed clientset / informer-factory tests (reference pkg/client/).

Twin of tests/test_client.py, all 4 cases, over the port's package
(kube_batch_tpu_torch/edge/, client/, cli/) on the CPU: schedulers and
runtimes are built with ``device="cpu"``.
"""

import pytest

from kube_batch_tpu_torch.api import ObjectMeta
from kube_batch_tpu_torch.apis.scheduling import v1alpha1, v1alpha2
from kube_batch_tpu_torch.cache import Cluster
from kube_batch_tpu_torch.client import Clientset, SharedInformerFactory


def pg(version_mod, name, ns="default", min_member=1):
    return version_mod.PodGroup(
        metadata=ObjectMeta(name=name, namespace=ns),
        spec=version_mod.PodGroupSpec(min_member=min_member))


class TestClientset:
    def test_pod_group_crud(self):
        cs = Clientset(Cluster())
        client = cs.scheduling_v1alpha1.pod_groups("ns")
        client.create(pg(v1alpha1, "a", "ns", 3))
        got = client.get("a")
        assert got.spec.min_member == 3
        got.spec.min_member = 5
        client.update(got)
        assert client.get("a").spec.min_member == 5
        assert len(client.list()) == 1
        client.delete("a")
        with pytest.raises(KeyError):
            client.get("a")

    def test_version_isolation(self):
        cluster = Cluster()
        cs = Clientset(cluster)
        cs.scheduling_v1alpha1.pod_groups("ns").create(pg(v1alpha1, "a", "ns"))
        cs.scheduling_v1alpha2.pod_groups("ns").create(pg(v1alpha2, "b", "ns"))
        assert [p.metadata.name for p in
                cs.scheduling_v1alpha1.pod_groups("ns").list()] == ["a"]
        assert [p.metadata.name for p in
                cs.scheduling_v1alpha2.pod_groups("ns").list()] == ["b"]
        with pytest.raises(TypeError):
            cs.scheduling_v1alpha1.pod_groups("ns").create(pg(v1alpha2, "c"))

    def test_queue_crud(self):
        cs = Clientset(Cluster())
        qc = cs.scheduling_v1alpha1.queues()
        qc.create(v1alpha1.Queue(metadata=ObjectMeta(name="q1"),
                                 spec=v1alpha1.QueueSpec(weight=4)))
        assert qc.get("q1").spec.weight == 4
        qc.delete("q1")
        with pytest.raises(KeyError):
            qc.get("q1")


class TestInformerFactory:
    def test_pod_group_events_and_lister(self):
        cluster = Cluster()
        factory = SharedInformerFactory(cluster)
        events = []
        factory.pod_groups(v1alpha1).add_event_handler(
            on_add=lambda obj: events.append(("add", obj.metadata.name)))
        cs = Clientset(cluster)
        cs.scheduling_v1alpha1.pod_groups("ns").create(pg(v1alpha1, "x", "ns"))
        cs.scheduling_v1alpha2.pod_groups("ns").create(pg(v1alpha2, "y", "ns"))
        # v1alpha2 object filtered out of the v1alpha1 informer stream.
        assert events == [("add", "x")]
        lister = factory.pod_group_lister(v1alpha1)
        assert [p.metadata.name for p in lister.list("ns")] == ["x"]
