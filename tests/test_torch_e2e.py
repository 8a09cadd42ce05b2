"""End-to-end scenarios against the cluster simulator, the JAX package
against the port, on the CPU.

Twins of every case of tests/test_e2e.py: the reference's ``Harness``
(tests/test_e2e.py:63-117) built on each package's ``Cluster``,
``new_scheduler_cache`` and ``Scheduler`` — the port's on the CPU with
float64 keys — and each case's body run once per package
(tests/test_torch_utils.loop_twin).  Both packages must bind the same
pods to the same nodes, write the same pod-group phases and leave the
same pods in the cluster, and the port must pass the reference test's
own assertions.
"""

import pathlib

import pytest

from tests.test_torch_utils import loop_twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

CONF_ALL_ACTIONS = """
actions: "allocate, preempt, reclaim, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

CONF_TPU = """
actions: "tpu-allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

SHIPPED_CONF = (pathlib.Path(__file__).parent.parent / "config"
                / "kube-batch-conf.yaml")


def mk_pod(lp, name, group, ns="test", cpu="1", mem="1Gi", prio=None,
           tolerations=(), ports=(), affinity=None, phase="Pending",
           node=""):
    o, v1 = lp.objects, lp.v1alpha1
    requests = {"cpu": cpu, "memory": mem} if cpu else {}
    return o.Pod(
        metadata=o.ObjectMeta(
            name=name, namespace=ns,
            annotations={v1.GroupNameAnnotationKey: group}),
        spec=o.PodSpec(node_name=node, priority=prio,
                       tolerations=list(tolerations), affinity=affinity,
                       containers=[o.Container(requests=requests,
                                               ports=list(ports))]),
        status=o.PodStatus(phase=phase))


class Harness:
    """tests/test_e2e.Harness on one package: namespace, queues q1/q2,
    two priority classes."""

    def __init__(self, lp, conf=CONF_ALL_ACTIONS, queues=("q1", "q2"),
                 weights=(1, 1)):
        self.lp = lp
        o = lp.objects
        self.cluster = lp.cache.Cluster()
        lp.queue(self.cluster, "default")
        for name, w in zip(queues, weights):
            lp.queue(self.cluster, name, weight=w)
        self.cluster.create_priority_class(o.PriorityClass(
            metadata=o.ObjectMeta(name="high-priority"), value=1000))
        self.cluster.create_priority_class(o.PriorityClass(
            metadata=o.ObjectMeta(name="low-priority"), value=1))
        self.cache = lp.cache.new_scheduler_cache(self.cluster)
        self.scheduler = lp.scheduler(self.cache, scheduler_conf=conf,
                                      schedule_period=3600)

    def node(self, name, cpu="4", mem="8Gi", labels=None, taints=()):
        node = self.lp.node(name, labels, cpu=cpu, mem=mem)
        node.spec.taints = list(taints)
        return node

    def add_nodes(self, count, cpu="4", mem="8Gi", labels=None, taints=()):
        for i in range(count):
            self.cluster.create_node(self.node(f"node-{i}", cpu, mem,
                                               labels, taints))

    def create_job(self, name, replicas, min_member, queue="q1", ns="test",
                   cpu="1", mem="1Gi", prio_class="", **pod_kw):
        self.cluster.create_pod_group(self.lp.pod_group(
            name, ns, min_member, queue, priority_class_name=prio_class))
        prio = {"high-priority": 1000, "low-priority": 1}.get(prio_class)
        for i in range(replicas):
            self.cluster.create_pod(mk_pod(self.lp, f"{name}-{i}", name,
                                           ns=ns, cpu=cpu, mem=mem,
                                           prio=prio, **pod_kw))

    def create_group(self, name, min_member=1, queue="q1", ns="test"):
        self.cluster.create_pod_group(self.lp.pod_group(name, ns,
                                                        min_member, queue))

    def cycle(self, n=1):
        for _ in range(n):
            self.scheduler.run_once()

    def bound(self, prefix="", ns="test"):
        return {k: p.spec.node_name for k, p in self.cluster.pods.items()
                if p.spec.node_name and k.startswith(f"{ns}/{prefix}")}

    def pods(self, prefix, ns="test"):
        return sorted(k for k in self.cluster.pods
                      if k.startswith(f"{ns}/{prefix}"))

    def pod_group_phase(self, name, ns="test"):
        return self.cluster.pod_groups[f"{ns}/{name}"].status.phase

    def outcome(self):
        """What the twins compare: every bind, every pod left, every
        pod-group phase."""
        return (self.bound(), sorted(self.cluster.pods),
                {k: pg.status.phase
                 for k, pg in self.cluster.pod_groups.items()})


class TestGangScheduling:
    def test_gang_ready_when_fits(self):
        def body(lp):
            h = Harness(lp)
            h.add_nodes(2)
            h.create_job("qj-1", 3, 3)
            h.cycle()
            assert len(h.bound("qj-1")) == 3
            assert h.pod_group_phase("qj-1") == "Running"
            return h.outcome()

        loop_twin(body)

    def test_gang_unschedulable_when_cluster_full(self):
        def body(lp):
            h = Harness(lp)
            h.add_nodes(1, cpu="4")
            h.create_job("occupier", 4, 4)
            h.cycle()
            h.create_job("waiter", 4, 4)
            h.cycle()
            assert len(h.bound("occupier")) == 4
            assert h.bound("waiter") == {}
            assert h.pod_group_phase("waiter") == "Pending"
            pg = h.cluster.pod_groups["test/waiter"]
            conds = [(c.type, c.status, c.reason)
                     for c in pg.status.conditions]
            assert any(c[0] == "Unschedulable" for c in conds)
            return h.outcome(), conds

        loop_twin(body)

    def test_gang_schedules_after_release(self):
        def body(lp):
            h = Harness(lp)
            h.add_nodes(1, cpu="4")
            h.create_job("occupier", 4, 4)
            h.cycle()
            h.create_job("waiter", 4, 4)
            h.cycle()
            assert h.bound("waiter") == {}
            for i in range(4):
                h.cluster.delete_pod("test", f"occupier-{i}")
            h.cycle()
            assert len(h.bound("waiter")) == 4
            return h.outcome()

        loop_twin(body)

    def test_multi_job_on_tpu_action(self):
        def body(lp):
            h = Harness(lp, conf=CONF_TPU)
            h.add_nodes(3)
            h.create_job("a", 3, 3)
            h.create_job("b", 3, 3, queue="q2")
            h.cycle()
            assert len(h.bound("a")) == 3
            assert len(h.bound("b")) == 3
            return h.outcome()

        loop_twin(body)


class TestPreemptionReclaim:
    def test_preempt_between_jobs(self):
        def body(lp):
            h = Harness(lp)
            h.add_nodes(1, cpu="4")
            h.create_job("low", 4, 1, prio_class="low-priority")
            h.cycle()
            assert len(h.bound("low")) == 4
            h.create_job("high", 2, 2, prio_class="high-priority")
            h.cycle(3)
            assert len(h.bound("high")) == 2
            assert len(h.pods("low")) < 4
            return h.outcome()

        loop_twin(body)

    def test_reclaim_between_queues(self):
        def body(lp):
            h = Harness(lp, weights=(1, 1))
            h.add_nodes(1, cpu="4")
            h.create_job("greedy", 4, 1, queue="q1")
            h.cycle()
            assert len(h.bound("greedy")) == 4
            h.create_job("starved", 2, 1, queue="q2")
            h.cycle(3)
            assert len(h.bound("starved")) >= 1
            assert len(h.pods("greedy")) < 4
            return h.outcome()

        loop_twin(body)


class TestPredicates:
    def test_hostport_conflict(self):
        def body(lp):
            h = Harness(lp)
            h.add_nodes(2)
            h.create_group("hp")
            for i in range(2):
                h.cluster.create_pod(mk_pod(
                    lp, f"hp-{i}", "hp",
                    ports=[lp.objects.ContainerPort(host_port=8080)]))
            h.cycle()
            binds = h.bound("hp")
            assert len(binds) == 2
            assert binds["test/hp-0"] != binds["test/hp-1"]
            return h.outcome()

        loop_twin(body)

    def test_taints_and_tolerations(self):
        def body(lp):
            o = lp.objects
            h = Harness(lp)
            taint = o.Taint(key="dedicated", value="batch",
                            effect="NoSchedule")
            h.add_nodes(1, taints=[taint])
            h.create_job("plain", 1, 1)
            h.cycle()
            assert h.bound("plain") == {}
            h.create_job("tolerant", 1, 1, tolerations=[
                o.Toleration(key="dedicated", operator="Equal",
                             value="batch", effect="NoSchedule")])
            h.cycle()
            assert len(h.bound("tolerant")) == 1
            return h.outcome()

        loop_twin(body)


class TestNodeOrder:
    def test_required_node_affinity(self):
        def body(lp):
            h = Harness(lp)
            h.cluster.create_node(h.node("node-a", labels={"zone": "a"}))
            h.cluster.create_node(h.node("node-b", labels={"zone": "b"}))
            h.create_group("aff")
            h.cluster.create_pod(mk_pod(
                lp, "aff-0", "aff", affinity=lp.objects.Affinity(
                    required_node_terms=[{"zone": "b"}])))
            h.cycle()
            assert h.bound("aff") == {"test/aff-0": "node-b"}
            return h.outcome()

        loop_twin(body)

    def test_preferred_node_affinity_scoring(self):
        def body(lp):
            h = Harness(lp)
            h.cluster.create_node(h.node("node-a", labels={"disk": "hdd"}))
            h.cluster.create_node(h.node("node-b", labels={"disk": "ssd"}))
            h.create_group("pref")
            h.cluster.create_pod(mk_pod(
                lp, "pref-0", "pref", affinity=lp.objects.Affinity(
                    preferred_node_terms=[(50, {"disk": "ssd"})])))
            h.cycle()
            assert h.bound("pref") == {"test/pref-0": "node-b"}
            return h.outcome()

        loop_twin(body)


class TestVersionedAPIs:
    def test_v1alpha2_pod_group_round_trip(self):
        def body(lp):
            o, v2 = lp.objects, lp.v1alpha2
            h = Harness(lp)
            h.add_nodes(1)
            h.cluster.create_pod_group(v2.PodGroup(
                metadata=o.ObjectMeta(name="v2job", namespace="test"),
                spec=v2.PodGroupSpec(min_member=1, queue="q1")))
            h.cluster.create_pod(mk_pod(lp, "v2job-0", "v2job"))
            h.cycle()
            assert len(h.bound("v2job")) == 1
            pg = h.cluster.pod_groups["test/v2job"]
            assert isinstance(pg, v2.PodGroup)
            assert pg.status.phase == "Running"
            return h.outcome(), type(pg).__name__

        loop_twin(body)

    def test_shadow_pod_group_for_bare_pod(self):
        def body(lp):
            o = lp.objects
            h = Harness(lp)
            h.add_nodes(1)
            h.cluster.create_pod(o.Pod(
                metadata=o.ObjectMeta(name="bare", namespace="test",
                                      owner_uid="rs-1"),
                spec=o.PodSpec(containers=[
                    o.Container(requests={"cpu": "1", "memory": "1Gi"})]),
                status=o.PodStatus(phase="Pending")))
            h.cycle()
            assert h.cluster.pods["test/bare"].spec.node_name == "node-0"
            return h.outcome()

        loop_twin(body)


class TestTpuActionPipeline:
    def test_tpu_allocate_then_preempt(self):
        conf = """
actions: "tpu-allocate, preempt, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

        def body(lp):
            h = Harness(lp, conf=conf)
            h.add_nodes(1, cpu="4")
            h.create_job("low", 4, 1, prio_class="low-priority")
            h.cycle()
            assert len(h.bound("low")) == 4
            h.create_job("high", 2, 2, prio_class="high-priority")
            h.cycle(3)
            assert len(h.bound("high")) == 2
            assert len(h.pods("low")) < 4
            return h.outcome()

        loop_twin(body)


class TestShippedPipeline:
    def test_conf_file_mirrors_reference(self):
        def body(lp):
            Harness(lp)  # registers the package's actions
            actions, tiers = lp.sched_mod.load_scheduler_conf(
                SHIPPED_CONF.read_text())
            names = [a.name() for a in actions]
            assert names == ["reclaim", "allocate", "backfill", "preempt"]
            plugins = [p.name for p in tiers[0].plugins]
            assert "conformance" in plugins
            return names, plugins

        loop_twin(body)

    def test_four_actions_one_scenario(self):
        def body(lp):
            h = Harness(lp, conf=SHIPPED_CONF.read_text())
            h.add_nodes(1, cpu="4")
            h.create_job("low", 3, 1, queue="q1", prio_class="low-priority")
            crit = mk_pod(lp, "low-crit", "low", cpu="1", prio=1)
            crit.spec.priority_class_name = "system-cluster-critical"
            h.cluster.create_pod(crit)
            h.cycle(2)
            assert len(h.bound("low")) == 4
            h.create_job("claim", 2, 2, queue="q2")
            h.cycle(5)
            assert len(h.bound("claim")) == 2, \
                "reclaim did not free capacity"
            assert h.pods("low") == ["test/low-crit"]
            h.create_job("mid", 1, 1, queue="q1", prio_class="low-priority")
            h.cycle(2)
            assert len(h.bound("mid")) == 1
            h.create_job("high", 1, 1, queue="q1",
                         prio_class="high-priority")
            h.cycle(3)
            assert len(h.bound("high")) == 1, \
                "preempt did not free capacity"
            assert "test/mid-0" not in h.cluster.pods
            assert len(h.bound("claim")) == 2
            h.cluster.create_pod(mk_pod(lp, "effortless", "", cpu=""))
            h.cycle(1)
            assert h.bound("effortless"), \
                "backfill did not place BestEffort"
            assert h.cluster.pods["test/low-crit"].spec.node_name
            return h.outcome()

        loop_twin(body)


class TestPodInformerFilter:
    def _harness_with_node(self, lp):
        h = Harness(lp)
        h.add_nodes(1, cpu="8")
        return h

    def _mk(self, lp, name, phase, scheduler, node=""):
        pod = mk_pod(lp, name, "", phase=phase, node=node)
        pod.spec.scheduler_name = scheduler
        return pod

    @staticmethod
    def _task_names(h):
        return sorted(t.name for j in h.cache.jobs.values()
                      for t in j.tasks.values())

    def test_our_pending_pod_ingested(self):
        def body(lp):
            h = self._harness_with_node(lp)
            h.cluster.create_pod(self._mk(lp, "ours", "Pending",
                                          "kube-batch"))
            names = self._task_names(h)
            assert "ours" in names
            return names

        loop_twin(body)

    def test_other_scheduler_pending_pod_dropped_even_with_node(self):
        def body(lp):
            h = self._harness_with_node(lp)
            h.cluster.create_pod(self._mk(lp, "other-pending", "Pending",
                                          "default-scheduler",
                                          node="node-0"))
            names = self._task_names(h)
            assert "other-pending" not in names
            node_tasks = sorted(getattr(h.cache.nodes.get("node-0"),
                                        "tasks", {}))
            assert "node-0/other-pending" not in node_tasks
            return names, node_tasks

        loop_twin(body)

    def test_other_scheduler_running_pod_accounted(self):
        def body(lp):
            h = self._harness_with_node(lp)
            h.cluster.create_pod(self._mk(lp, "other-running", "Running",
                                          "default-scheduler",
                                          node="node-0"))
            node_tasks = sorted(h.cache.nodes["node-0"].tasks)
            assert "test/other-running" in node_tasks
            return node_tasks

        loop_twin(body)

    def test_other_scheduler_failed_unbound_pod_mirrored(self):
        def body(lp):
            h = self._harness_with_node(lp)
            pod = mk_pod(lp, "other-failed", "g1", phase="Failed")
            pod.spec.scheduler_name = "default-scheduler"
            h.cluster.create_pod(pod)
            names = self._task_names(h)
            assert "other-failed" in names
            return names

        loop_twin(body)


@pytest.mark.parametrize("tenancy", ["0", "2"])
def test_harness_under_tenancy_engine(monkeypatch, tenancy):
    """The same gang scenario through the tenancy engine's pipelined
    shard sessions (two queues, two shards) binds what the global engine
    binds, in both packages."""
    monkeypatch.setenv("KUBE_BATCH_TPU_TENANCY", tenancy)
    monkeypatch.setenv("KUBE_BATCH_TPU_SHARD_MAP", "q1:0|q2:1|default:0")
    monkeypatch.setenv("KUBE_BATCH_TPU_CONCURRENT_SHARDS", "1")

    def body(lp):
        h = Harness(lp, conf=CONF_TPU)
        h.add_nodes(3)
        h.create_job("a", 3, 3)
        h.create_job("b", 3, 3, queue="q2")
        h.cycle(2)
        assert len(h.bound("a")) == 3 and len(h.bound("b")) == 3
        return h.outcome()

    loop_twin(body)
