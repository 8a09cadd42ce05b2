"""One tpu-allocate session, the JAX package against the port, on the CPU.

Each case builds the same spec through both packages and runs
``open_session -> tpu-allocate -> close_session``: the JAX package's
action against the port's ``TpuAllocateAction(device="cpu")``.  The binds
(in bind order), the pod-group status writes, the pod conditions, the
cache events and the tensorized SolverInputs (leaf by leaf) and
SolverConfig (field by field) must be exactly equal, in both float modes:
JAX with x64 on against float64 keys, and under ``jax.enable_x64(False)``
against float32.  Cases: tests/test_tpu_parity.py's TestParitySimple and
four seeds of its randomized snapshots, a three-cycle run with pods added
and binds echoed between cycles (against the JAX defaults and against its
FUSED=0 INCREMENTAL=0 NO_NATIVE=1 control arms), a session that takes the
tensorizer's host fallback, and the BATCH_COMMIT=0 apply arm.
"""

import random

import pytest
import torch

from tests.test_torch_utils import (assert_session_parity, build_cache,
                                    run_session, synthetic_cache)
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

MODES = {"x64": True, "f32": False}


def _spec(queues, pod_groups, pods, nodes, **extra):
    return dict(queues=queues, pod_groups=pod_groups, pods=pods,
                nodes=nodes, **extra)


def _prioritize(cache, m):
    """tests/test_tpu_parity.py test_priority_order_within_job."""
    for t in cache.jobs["ns/pg1"].tasks.values():
        t.priority = 100 if t.name == "hi" else 1


SIMPLE = {
    "single_gang_job": (_spec(
        [("q1", 1)], [("pg1", "ns", 3, "q1")],
        [("ns", f"p{i}", "", "Pending", "1", "1Gi", "pg1") for i in range(3)],
        [("n1", "2", "4Gi"), ("n2", "2", "4Gi")]), None),
    "gang_blocked": (_spec(
        [("q1", 1)], [("pg1", "ns", 4, "q1")],
        [("ns", f"p{i}", "", "Pending", "1", "1Gi", "pg1") for i in range(4)],
        [("n1", "2", "4Gi")]), None),
    "two_queues": (_spec(
        [("q1", 1), ("q2", 1)], [("pg1", "a", 1, "q1"), ("pg2", "b", 1, "q2")],
        [("a", f"p{i}", "", "Pending", "1", "1G", "pg1") for i in range(3)]
        + [("b", f"p{i}", "", "Pending", "1", "1G", "pg2") for i in range(3)],
        [("n1", "4", "8G")]), None),
    "weighted_queues": (_spec(
        [("q1", 3), ("q2", 1)], [("pg1", "a", 1, "q1"), ("pg2", "b", 1, "q2")],
        [("a", f"p{i}", "", "Pending", "1", "1G", "pg1") for i in range(6)]
        + [("b", f"p{i}", "", "Pending", "1", "1G", "pg2") for i in range(6)],
        [("n1", "8", "32G")]), None),
    "running_pods_counted": (_spec(
        [("q1", 1)], [("pg1", "ns", 1, "q1"), ("pg2", "ns", 2, "q1")],
        [("ns", "r1", "n1", "Running", "2", "2G", "pg1"),
         ("ns", "w1", "", "Pending", "1", "1G", "pg2"),
         ("ns", "w2", "", "Pending", "1", "1G", "pg2")],
        [("n1", "4", "8G"), ("n2", "2", "2G")]), None),
    "multi_node_spreading": (_spec(
        [("q1", 1)], [("pg1", "ns", 1, "q1")],
        [("ns", f"p{i}", "", "Pending", "1", "1Gi", "pg1") for i in range(6)],
        [(f"n{i}", "4", "8Gi") for i in range(4)]), None),
    "priority_order_within_job": (_spec(
        [("q1", 1)], [("pg1", "ns", 1, "q1")],
        [("ns", "lo", "", "Pending", "2", "2Gi", "pg1"),
         ("ns", "hi", "", "Pending", "2", "2Gi", "pg1")],
        [("n1", "3", "8Gi")]), _prioritize),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(SIMPLE))
def test_simple_session_equals_jax(case, mode):
    spec, mutate = SIMPLE[case]
    jax_out, _ = assert_session_parity(spec, x64=MODES[mode], mutate=mutate)
    if case == "gang_blocked":
        assert jax_out["binds"] == []
    if case == "weighted_queues":
        by_ns = {}
        for key, _host in jax_out["binds"]:
            by_ns[key.split("/")[0]] = by_ns.get(key.split("/")[0], 0) + 1
        assert by_ns == {"a": 6, "b": 2}
    if case == "priority_order_within_job":
        assert [k for k, _ in jax_out["binds"]] == ["ns/hi"]


def random_spec(seed):
    """tests/test_tpu_parity.py TestParityRandomized.test_random_snapshot."""
    rng = random.Random(seed)
    n_queues = rng.randint(1, 4)
    queues = [(f"q{i}", rng.randint(1, 4)) for i in range(n_queues)]
    n_jobs = rng.randint(2, 8)
    pod_groups, pods = [], []
    for j in range(n_jobs):
        queue = f"q{rng.randrange(n_queues)}"
        size = rng.randint(1, 6)
        minm = rng.randint(1, size)
        pod_groups.append((f"pg{j}", "ns", minm, queue))
        for i in range(size):
            cpu = str(rng.choice([1, 2, 3]))
            mem = f"{rng.choice([1, 2, 4])}Gi"
            pods.append(("ns", f"j{j}-p{i}", "", "Pending", cpu, mem,
                         f"pg{j}"))
    nodes = [(f"n{i}", str(rng.choice([4, 8, 16])),
              f"{rng.choice([8, 16, 32])}Gi")
             for i in range(rng.randint(2, 6))]
    return _spec(queues, pod_groups, pods, nodes)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_session_equals_jax(seed, mode):
    assert_session_parity(random_spec(seed), x64=MODES[mode])


def _cycle_spec():
    spec = random_spec(7)
    spec["nodes"] = [(f"n{i}", "8", "16Gi") for i in range(4)]
    return spec


def _added_pods(cycle):
    """Two more jobs' pods before each later cycle; their pod groups are
    in the spec from the start (pg-c1, pg-c2)."""
    rng = random.Random(100 + cycle)
    return [("ns", f"c{cycle}-p{i}", "", "Pending",
             str(rng.choice([1, 2])), f"{rng.choice([1, 2])}Gi", f"pgc{cycle}")
            for i in range(rng.randint(2, 5))]


CONTROL_ARMS = {"KUBE_BATCH_TPU_FUSED": "0",
                "KUBE_BATCH_TPU_INCREMENTAL": "0",
                "KUBE_BATCH_TPU_NO_NATIVE": "1"}


@pytest.mark.parametrize("jax_arm", ["defaults", "control"])
def test_three_cycles_with_adds_and_echoes_equal_jax(jax_arm):
    """Cumulative binds over three sessions on one cache, pods added and
    binds echoed back between them; the JAX side at its defaults (fused,
    incremental, native) and at the control arms the port runs."""
    spec = _cycle_spec()
    spec["pod_groups"] += [("pgc1", "ns", 1, "q0"), ("pgc2", "ns", 2, "q0")]
    jax_out, torch_out = assert_session_parity(
        spec, x64=True, cycles=3, add_pods=_added_pods, echo=True,
        jax_env=CONTROL_ARMS if jax_arm == "control" else {})
    assert len(jax_out["snaps"]) == 3
    placed = [k for k, _ in jax_out["binds"]]
    assert any(k.startswith("ns/c1-") for k in placed)
    assert any(k.startswith("ns/c2-") for k in placed)


def test_tensorize_gap_takes_the_host_fallback_on_both_sides():
    """A node whose memory overflows int32 quanta: both tensorizers set
    needs_fallback and both actions run the host allocate."""
    spec = _spec([("q1", 1)], [("pg1", "ns", 1, "q1")],
                 [("ns", f"p{i}", "", "Pending", "1", "1Gi", "pg1")
                  for i in range(3)],
                 [("n1", "8", "3000Ti"), ("n2", "4", "8Gi")])
    jax_out, torch_out = assert_session_parity(spec)
    assert jax_out["snaps"][0].needs_fallback
    assert "overflows int32" in torch_out["snaps"][0].fallback_reason
    assert len(jax_out["binds"]) == 3
    assert torch_out["action"].last is None  # nothing shipped or solved


@pytest.mark.parametrize("mode", sorted(MODES))
def test_batch_commit_off_arm_equals_jax(mode):
    """KUBE_BATCH_TPU_BATCH_COMMIT=0: the pre-columnar apply on both
    sides."""
    out = assert_session_parity(random_spec(5), x64=MODES[mode],
                                env={"KUBE_BATCH_TPU_BATCH_COMMIT": "0"})
    assert out[0]["binds"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_synthetic_cache_session_equals_jax(mode):
    """The slice as chip_smoke.py drives it, at a small size: each
    package's make_synthetic_cache, then one tpu-allocate session."""
    jax_out, torch_out = assert_session_parity(
        None, x64=MODES[mode], build=synthetic_cache((600, 60, 24, 3)))
    assert len(jax_out["binds"]) == 600
    assert torch_out["action"].last.route == "torch"


def test_port_session_records_its_route_and_stages():
    spec = random_spec(2)
    out = run_session(spec, "torch", x64=False, tensorize=False)
    last = out["action"].last
    assert last.route == "torch"
    assert last.inputs.job_ts.dtype == torch.float32
    assert set(last.stages) == {"tensorize", "ship", "prefilter",
                                "dispatch_fetch", "apply"}
    assert [k for k, _ in out["binds"]] == [
        f"{last.snap.tasks[t].pod.metadata.namespace}/"
        f"{last.snap.tasks[t].pod.metadata.name}"
        for t in last.ordered if last.kind[t] == 1]


def test_registries_stay_per_package():
    """Both packages register their defaults in one process; neither
    registry holds the other's classes."""
    import kube_batch_tpu.framework.registry as jax_registry
    import kube_batch_tpu_torch.framework.registry as torch_registry
    from kube_batch_tpu.actions.factory import \
        register_default_actions as jax_actions
    from kube_batch_tpu.plugins.factory import \
        register_default_plugins as jax_plugins
    from kube_batch_tpu_torch.actions.factory import register_default_actions
    from kube_batch_tpu_torch.plugins.factory import register_default_plugins

    jax_actions()
    jax_plugins()
    register_default_actions(device="cpu")
    register_default_plugins()
    for registry, root in ((jax_registry, "kube_batch_tpu."),
                           (torch_registry, "kube_batch_tpu_torch.")):
        actions = registry.list_actions()
        assert {"allocate", "tpu-allocate"} <= set(actions)
        for action in actions.values():
            assert type(action).__module__.startswith(root)
        for name in ("gang", "drf", "proportion", "nodeorder"):
            builder = registry.get_plugin_builder(name)
            assert builder.__module__.startswith(root), name
    assert set(torch_registry.list_actions()) == {
        "allocate", "tpu-allocate", "backfill", "preempt", "reclaim",
        "topo-allocate"}


def test_default_conf_names_backfill_which_waits_for_the_eviction_slice():
    """The default conf names backfill; since the eviction slice landed it
    loads whole (it raised KeyError on backfill before), and an unknown
    action still raises."""
    from kube_batch_tpu_torch.actions.factory import register_default_actions
    from kube_batch_tpu_torch.scheduler import (DEFAULT_SCHEDULER_CONF,
                                                load_scheduler_conf,
                                                parse_scheduler_conf)
    register_default_actions(device="cpu")
    assert [p.name for tier in parse_scheduler_conf(
        DEFAULT_SCHEDULER_CONF).tiers for p in tier.plugins] == [
        "priority", "gang", "conformance", "drf", "predicates",
        "proportion", "nodeorder"]
    actions, _ = load_scheduler_conf(DEFAULT_SCHEDULER_CONF)
    assert [a.name() for a in actions] == ["tpu-allocate", "backfill"]
    with pytest.raises(KeyError, match="nope"):
        load_scheduler_conf(DEFAULT_SCHEDULER_CONF.replace(
            '"tpu-allocate, backfill"', '"tpu-allocate, nope"'))
    actions, _ = load_scheduler_conf(
        DEFAULT_SCHEDULER_CONF.replace('"tpu-allocate, backfill"',
                                       '"tpu-allocate"'))
    assert [a.name() for a in actions] == ["tpu-allocate"]


def test_build_cache_twin_matches_the_reference_builder():
    """The port's build_cache ingests the same jobs, tasks and nodes as
    tests/test_tpu_parity.py's."""
    from tests.test_tpu_parity import build_cache as jax_build_cache
    spec = random_spec(3)
    jcache, _ = jax_build_cache(spec)
    tcache, _, _ = build_cache(spec)
    assert sorted(jcache.jobs) == sorted(tcache.jobs)
    assert sorted(jcache.nodes) == sorted(tcache.nodes)
    for uid in jcache.jobs:
        assert sorted(jcache.jobs[uid].tasks) == sorted(tcache.jobs[uid].tasks)
