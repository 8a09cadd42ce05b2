"""Incremental micro-sessions of the port, against its own control arm and
against the JAX package, on the CPU.

Twins of tests/test_incremental_sessions.py and of the snapshot-map and
close cases of tests/test_cycle_floors.py.  Each case drives one
schedule of churn through ``Arm``s (tests/test_torch_utils.py): the port
and the JAX package each build their own ``make_synthetic_cache`` from
the same arguments and take the same mutations.  The port's micro build
must equal its from-scratch build (``KUBE_BATCH_TPU_INCREMENTAL=0``,
every persistent cache detached) and the JAX package's build leaf for
leaf; snapshots, closes, plugin opens, binds and events must equal the
port's control arm and the JAX package's, with a tolerance of 0, in
float64 (x64) and float32.
"""

import dataclasses

import jax
import pytest

from tests.test_torch_utils import Arm, assert_same_inputs, environ
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

MODES = {"x64": True, "f32": False}
MUTATIONS = ["none", "bind_echo", "evict", "pipeline", "job_add",
             "job_update", "job_delete", "node_update", "node_add",
             "node_delete"]


def _mutate(arm, mutation):
    """tests/test_incremental_sessions.py's mutation paths, on one arm."""
    api = arm.m.api
    cache = arm.cache
    if mutation == "bind_echo":
        arm.add_churn_job("be")
        arm.cycle()
    elif mutation == "evict":
        cache.evict(arm.running_task(), "preempted")
    elif mutation == "pipeline":
        arm.add_churn_job("pipe", n_pods=1, cpu="100m", mem="256Mi")
        ssn = arm.open()
        victim = next(
            t for u in sorted(ssn.jobs) if "churn-pipe" not in u
            for t in ssn.jobs[u].tasks.values() if t.node_name)
        ssn.evict(victim, "preempted")
        job_uid = next(u for u in ssn.jobs if "churn-pipe" in u)
        task = next(iter(ssn.jobs[job_uid].tasks.values()))
        ssn.pipeline(task, victim.node_name)
        arm.close(ssn)
    elif mutation == "job_add":
        arm.add_churn_job("add")
    elif mutation == "job_update":
        t = arm.running_task()
        new = dataclasses.replace(t.pod, spec=dataclasses.replace(
            t.pod.spec, containers=[api.Container(
                requests={"cpu": "250m", "memory": "512Mi"})]))
        cache.update_pod(t.pod, new)
    elif mutation == "job_delete":
        uid = sorted(cache.jobs)[0]
        for t in list(cache.jobs[uid].tasks.values()):
            cache.delete_pod(t.pod)
    elif mutation == "node_update":
        arm.update_node_alloc(sorted(cache.nodes)[0])
    elif mutation == "node_add":
        arm.add_node("nzz-new", {"cpu": "16", "memory": "64Gi",
                                 "pods": 110})
    elif mutation == "node_delete":
        cache.delete_node(cache.nodes[sorted(cache.nodes)[-1]].node)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("signatures", [1, 4])
@pytest.mark.parametrize("mutation", MUTATIONS)
def test_incremental_tensors_bit_identical(mutation, signatures, mode):
    """After every mutation path the port's incremental build equals its
    from-scratch build and the JAX package's build, leaf for leaf."""
    arms = [Arm(pkg, (60, 16, 10, 2), n_signatures=signatures,
                x64=MODES[mode]) for pkg in ("torch", "jax")]
    for arm in arms:
        for _ in range(3):
            arm.cycle()
        _mutate(arm, mutation)
    ours, ref = arms
    for round_ in range(2):
        ctx = f"mutation={mutation} sigs={signatures} round={round_}"
        ssn = ours.open()
        snap = ours.tensorize(ssn)
        oracle = ours.oracle_snapshot(ssn)
        ours.close(ssn)
        jssn = ref.open()
        jsnap = ref.tensorize(jssn)
        ref.close(jssn)
        assert_same_inputs(snap, oracle, ctx)
        assert_same_inputs(snap, jsnap, ctx)
        assert (ours.state().last_kind, ours.state().last_reason) == \
            (ref.state().last_kind, ref.state().last_reason), ctx


def test_micro_path_actually_engages():
    """The steady state classifies micro in both packages."""
    kinds = {}
    for pkg in ("torch", "jax"):
        arm = Arm(pkg, (60, 16, 10, 2), n_signatures=4)
        for _ in range(3):
            arm.cycle()
        ssn = arm.open()
        arm.tensorize(ssn)
        arm.close(ssn)
        st = arm.state()
        assert st.last_kind == "micro", (pkg, st.last_kind, st.last_reason)
        assert st.stats["micro"] >= 1 and st.generation >= 3
        kinds[pkg] = (dict(st.stats), st.generation)
    assert kinds["torch"] == kinds["jax"]


def test_periodic_full_floor_and_request_full():
    for pkg in ("torch", "jax"):
        arm = Arm(pkg, (60, 16, 10, 2))
        arm.cycle()
        arm.cycle()
        arm.incremental.request_full(arm.cache)
        ssn = arm.open()
        arm.tensorize(ssn)
        arm.close(ssn)
        st = arm.state()
        assert (st.last_kind, st.last_reason) == \
            ("full", "periodic full-session floor"), pkg
        # The floor is one-shot: the next session is micro again.
        ssn = arm.open()
        arm.tensorize(ssn)
        arm.close(ssn)
        assert st.last_kind == "micro", pkg


def _open_attrs(pkg, flag, x64):
    """drf job shares and proportion queue attributes of the second
    cached open (the first fills the caches)."""
    with environ({"KUBE_BATCH_TPU_INCREMENTAL": flag}):
        arm = Arm(pkg, (80, 16, 12, 3), x64=x64)
        arm.cycle()
        arm.cycle()
        ssn = arm.open()
        drf = ssn.plugins["drf"]
        prop = ssn.plugins["proportion"]
        out = ({uid: (a.share, a.allocated.milli_cpu, a.allocated.memory)
                for uid, a in drf.job_attrs.items()},
               {qid: (a.share, a.deserved.milli_cpu, a.deserved.memory,
                      a.allocated.milli_cpu, a.allocated.memory,
                      a.request.milli_cpu, a.request.memory)
                for qid, a in prop.queue_attrs.items()})
        arm.close(ssn)
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plugin_open_caches_are_exact(mode):
    """drf/proportion opens with the aggregate caches equal the uncached
    control and the JAX package's cached opens exactly."""
    cached = _open_attrs("torch", "1", MODES[mode])
    assert cached == _open_attrs("torch", "0", MODES[mode])
    assert cached == _open_attrs("jax", "1", MODES[mode])


def _fractional_cluster(arm):
    """One node, a fractional job first in walk order, then an integer
    job whose subtotal the proportion cache would collapse."""
    api = arm.m.api
    cache = arm.cache
    cache.delete_pod_group(arm.pod_group("pg0"))
    arm.add_node("n0", {"cpu": "64", "memory": "256Gi", "pods": 110})
    for name, cpus in (("frac", ["843.653m"]),
                       ("intjob", ["41640m", "11614m", "36095m"])):
        cache.add_pod_group(arm.pod_group(name, ns="ns"))
        for i, cpu in enumerate(cpus):
            cache.add_pod(api.Pod(
                metadata=api.ObjectMeta(
                    name=f"{name}-{i}", namespace="ns", uid=f"{name}-{i}",
                    annotations={
                        arm.m.v1alpha1.GroupNameAnnotationKey: name},
                    creation_timestamp=float(i)),
                spec=api.PodSpec(containers=[api.Container(
                    requests={"cpu": cpu, "memory": "1Gi"})]),
                status=api.PodStatus(phase="Pending")))


def test_fractional_queue_accumulator_blocks_collapsed_adds():
    """A fractional job earlier in the walk poisons the queue
    accumulator: the rolling exactness gate must block the collapsed
    add, keeping the cached arm equal to the control and to JAX."""
    def arm_attrs(pkg, flag):
        with environ({"KUBE_BATCH_TPU_INCREMENTAL": flag}):
            arm = Arm(pkg, (0, 0, 1, 1))
            _fractional_cluster(arm)
            for _ in range(2):
                ssn = arm.open()
                prop = ssn.plugins["proportion"]
                attrs = {qid: (a.request.milli_cpu, a.request.memory,
                               a.allocated.milli_cpu)
                         for qid, a in prop.queue_attrs.items()}
                arm.close(ssn)
        return attrs

    ours = arm_attrs("torch", "1")
    assert ours == arm_attrs("torch", "0")
    assert ours == arm_attrs("jax", "1")


def test_fractional_resources_never_enter_the_proportion_cache():
    from kube_batch_tpu.models import incremental as jax_incremental
    from kube_batch_tpu_torch.models import incremental
    cases = [(500.0, 1024.0, True), (100.5, 1024.0, False),
             (500.0, float(2 ** 53), False)]
    for cpu, mem, exact in cases:
        res = type("R", (), {"milli_cpu": cpu, "memory": mem,
                             "scalar_resources": {}})()
        assert incremental.resource_exact(res) is exact
        assert jax_incremental.resource_exact(res) is exact


def test_solve_result_reused_on_clean_generation():
    """An unschedulable-but-valid pending job keeps the inputs
    byte-identical across cycles: the ship comes back clean and the
    solve is served from the generation-keyed cache, with no launch."""
    from kube_batch_tpu_torch.metrics import metrics
    arm = Arm("torch", (20, 8, 4, 2))
    arm.add_churn_job("hog", n_pods=1, cpu="4000")
    arm.cycle()
    arm.cycle()
    before = metrics.generation_reuse_counts()
    arm.cycle(echo=False)
    arm.cycle(echo=False)
    after = metrics.generation_reuse_counts()
    assert not arm.binder.binds
    assert arm.action.last.reused
    assert after.get("hit", 0) - before.get("hit", 0) >= 1, (before, after)


def _churn_run(pkg, flag, x64):
    """tests/test_incremental_sessions.py's multi-round churn schedule."""
    with environ({"KUBE_BATCH_TPU_INCREMENTAL": flag}):
        arm = Arm(pkg, (80, 16, 12, 3), x64=x64)
        fingerprints = []
        mark = len(arm.cache.events)
        for rnd in range(5):
            arm.add_churn_job(f"r{rnd}", n_pods=4)
            if rnd >= 2:
                job = arm.cache.jobs.get(f"bench/churn-r{rnd - 2}")
                for t in list(job.tasks.values() if job else []):
                    arm.cache.delete_pod(t.pod)
            fingerprints.append(arm.cycle())
        kinds = arm.state().stats if flag == "1" else None
    return fingerprints, list(arm.cache.events)[mark:], kinds


@pytest.mark.parametrize("mode", sorted(MODES))
def test_e2e_churn_parity_incremental_vs_control(mode):
    """Multi-round churn: the port's binds and events equal its own
    INCREMENTAL=0 arm and the JAX package's default arm."""
    x64 = MODES[mode]
    inc_fp, inc_events, kinds = _churn_run("torch", "1", x64)
    ctl_fp, ctl_events, _ = _churn_run("torch", "0", x64)
    ref_fp, ref_events, ref_kinds = _churn_run("jax", "1", x64)
    assert inc_fp == ctl_fp == ref_fp
    assert inc_events == ctl_events == ref_events
    assert kinds == ref_kinds and kinds["micro"] >= 1, kinds
    assert any(binds for binds in inc_fp), "no round bound anything"


# ---------------------------------------------------------------------------
# The snapshot map and the incremental close (tests/test_cycle_floors.py)
# ---------------------------------------------------------------------------

def _control_snapshot(arm):
    """A fresh full walk of the same cache with the map detached."""
    cache = arm.cache
    saved = cache._snap_state
    cache._snap_state = None
    mark = len(cache.events)
    try:
        with environ({"KUBE_BATCH_TPU_INCREMENTAL": "0"}):
            info = cache.snapshot()
    finally:
        cache._snap_state = saved
    return info, list(cache.events)[mark:]


def _snapshot_matches_control(arm, ctx=""):
    """The map's snapshot equals a fresh full walk, content and order
    (the same clone objects), events included; returns what the tests
    compare across packages: the key orders and the events."""
    cache = arm.cache
    mark = len(cache.events)
    inc = cache.snapshot()
    inc_events = list(cache.events)[mark:]
    ctl, ctl_events = _control_snapshot(arm)
    assert list(inc.nodes) == list(ctl.nodes), ctx
    assert list(inc.jobs) == list(ctl.jobs), ctx
    assert list(inc.queues) == list(ctl.queues), ctx
    for name in ctl.nodes:
        assert inc.nodes[name] is ctl.nodes[name], (ctx, name)
    for uid in ctl.jobs:
        assert inc.jobs[uid] is ctl.jobs[uid], (ctx, uid)
        assert inc.jobs[uid].priority == ctl.jobs[uid].priority
    assert inc_events == ctl_events, ctx
    return list(inc.nodes), list(inc.jobs), inc_events


def _walk_snapshot_churn(arm):
    seen = []
    arm.cycle()
    arm.cycle()
    seen.append(_snapshot_matches_control(arm, "settled"))
    arm.add_churn_job("a")
    arm.update_node_alloc(sorted(arm.cache.nodes)[0])
    seen.append(_snapshot_matches_control(arm, "churned"))
    # delete + re-add a node: the truth dict moves it to the end
    vnode = arm.cache.nodes[sorted(arm.cache.nodes)[2]].node
    arm.cache.delete_node(vnode)
    seen.append(_snapshot_matches_control(arm, "node deleted"))
    arm.cache.add_node(vnode)
    seen.append(_snapshot_matches_control(arm, "node re-added"))
    # delete + re-add a job (same uid)
    uid = sorted(arm.cache.jobs)[0]
    pods = [t.pod for t in arm.cache.jobs[uid].tasks.values()]
    pg_name = uid.split("/", 1)[1]
    for p in pods:
        arm.cache.delete_pod(p)
    arm.cache.delete_pod_group(arm.pod_group(pg_name))
    seen.append(_snapshot_matches_control(arm, "job deleted"))
    arm.cache.add_pod_group(arm.pod_group(pg_name))
    for p in pods:
        arm.cache.add_pod(dataclasses.replace(
            p, spec=dataclasses.replace(p.spec, node_name=""),
            status=arm.m.api.PodStatus(phase="Pending")))
    seen.append(_snapshot_matches_control(arm, "job re-added"))
    return seen


def test_incremental_snapshot_matches_full_walk():
    ours = _walk_snapshot_churn(Arm("torch", (60, 16, 10, 2)))
    assert ours == _walk_snapshot_churn(Arm("jax", (60, 16, 10, 2)))


def _walked_reused():
    from kube_batch_tpu_torch.metrics import metrics
    return (int(metrics.snapshot_objects.value("walked")),
            int(metrics.snapshot_objects.value("reused")))


def test_incremental_snapshot_o_dirty():
    """A micro cycle's snapshot walks the dirty objects, not the
    cluster."""
    arm = Arm("torch", (120, 32, 12, 2))
    for _ in range(3):
        arm.cycle()
    total = len(arm.cache.nodes) + len(arm.cache.jobs)
    arm.add_churn_job("tiny", n_pods=1)
    arm.cache.snapshot()
    walked, reused = _walked_reused()
    assert 0 < walked < total / 4, (walked, reused)
    assert reused > total / 2, (walked, reused)


def test_priority_class_change_forces_full_walk():
    """A PriorityClass change bumps no job epoch: the map must fall back
    to the full walk so clean clones' priorities re-resolve."""
    prios = {}
    for pkg in ("torch", "jax"):
        arm = Arm(pkg, (60, 16, 10, 2))

        class PC:
            def __init__(self, name, value, default=False):
                self.metadata = arm.m.api.ObjectMeta(name=name)
                self.value = value
                self.global_default = default

        arm.cycle()
        arm.cache.snapshot()
        arm.cache.add_priority_class(PC("gold", 77, default=True))
        info = arm.cache.snapshot()
        if pkg == "torch":
            walked, _ = _walked_reused()
            assert walked == len(arm.cache.nodes) + len(arm.cache.jobs)
        prios[pkg] = {uid: j.priority for uid, j in info.jobs.items()}
        assert set(prios[pkg].values()) == {77}
        _snapshot_matches_control(arm, "after pc change")
    assert prios["torch"] == prios["jax"]


def test_no_spec_job_events_replayed():
    """A job without PodGroup emits one FailedScheduling event per
    snapshot in the control; the incremental walk must replay it."""
    seen = {}
    for pkg in ("torch", "jax"):
        arm = Arm(pkg, (60, 16, 10, 2))
        api = arm.m.api
        arm.cycle()
        arm.cache.add_pod(api.Pod(
            metadata=api.ObjectMeta(
                name="orphan", namespace="bench", uid="orphan",
                annotations={
                    arm.m.v1alpha1.GroupNameAnnotationKey: "missing-pg"},
                creation_timestamp=5e6),
            spec=api.PodSpec(containers=[api.Container(
                requests={"cpu": "100m", "memory": "128Mi"})]),
            status=api.PodStatus(phase="Pending")))
        out = [_snapshot_matches_control(arm, "orphan added"),
               _snapshot_matches_control(arm, "orphan steady")]
        mark = len(arm.cache.events)
        arm.cache.snapshot()
        replays = [e for e in list(arm.cache.events)[mark:]
                   if e[0] == "FailedScheduling" and "PodGroup" in e[2]]
        assert replays, f"{pkg}: no-spec event not replayed"
        seen[pkg] = (out, replays)
    assert seen["torch"] == seen["jax"]


def _sticky_run(pkg, flag):
    with environ({"KUBE_BATCH_TPU_INCREMENTAL": flag}):
        arm = Arm(pkg, (60, 16, 10, 2))
        arm.cycle()
        arm.cycle()
        # a gang that can never place: absurd request
        arm.add_churn_job("hog", n_pods=2, cpu="4000", mem="4000Gi",
                          min_member=2)
        mark = len(arm.cache.events)
        conds = len(arm.cache.status_updater.pod_conditions)
        for _ in range(3):
            arm.cycle()
        return (list(arm.cache.events)[mark:],
                arm.cache.status_updater.pod_conditions[conds:])


def test_close_parity_with_sticky_pending_job():
    """A gang job that cannot place keeps emitting Unschedulable events
    every close; the quiet-skip must keep re-processing it while
    skipping settled jobs — event streams equal to the control and to
    JAX."""
    ours = _sticky_run("torch", "1")
    assert ours == _sticky_run("torch", "0")
    assert ours == _sticky_run("jax", "1")
    assert any(e[0] == "Unschedulable" for e in ours[0])


def test_close_walk_is_o_touched():
    from kube_batch_tpu_torch.metrics import metrics
    arm = Arm("torch", (120, 16, 12, 2))
    for _ in range(3):
        arm.cycle()
    arm.add_churn_job("one", n_pods=1)
    arm.cycle()
    walked = int(metrics.close_objects_walked.value())
    assert 0 < walked < len(arm.cache.jobs) / 2, walked


def test_full_floor_revalidates_snapshot_and_close():
    """request_full must force the next snapshot AND close back to the
    full walk."""
    from kube_batch_tpu_torch.metrics import metrics
    arm = Arm("torch", (40, 8, 6, 2))
    arm.cycle()
    arm.cycle()
    arm.incremental.request_full(arm.cache)
    arm.cycle()
    walked, _ = _walked_reused()
    assert walked == len(arm.cache.nodes) + len(arm.cache.jobs)
    assert int(metrics.close_objects_walked.value()) >= len(arm.cache.jobs)


def _churn_nodes(arm):
    arm.cycle()
    arm.cycle()
    arm.update_node_alloc(sorted(arm.cache.nodes)[1])
    arm.cache.delete_node(arm.cache.nodes[sorted(arm.cache.nodes)[2]].node)
    arm.add_churn_job("agg", n_pods=2)
    arm.cycle()


def test_node_open_aggregates_match_control():
    """The snapshot map's node-open aggregates equal a fresh control walk
    after node update/delete churn, and the JAX package's."""
    from kube_batch_tpu_torch.api.resource import Resource
    from kube_batch_tpu_torch.plugins.nodeorder import GridUsage

    seen = {}
    for pkg in ("torch", "jax"):
        arm = Arm(pkg, (60, 16, 10, 2))
        _churn_nodes(arm)
        ssn = arm.open()
        try:
            total, cap, used, shift = arm.cache.node_open_aggregates()
            seen[pkg] = (total.milli_cpu, total.memory,
                         dict(total.scalar_resources), cap, used, shift)
            if pkg == "torch":
                with environ({"KUBE_BATCH_TPU_INCREMENTAL": "0"}):
                    ctl = GridUsage(ssn)  # the accessor is gated off
                walk = Resource.empty()
                for n in ssn.nodes.values():
                    walk.add(n.allocatable)
                assert seen[pkg] == (walk.milli_cpu, walk.memory,
                                     dict(walk.scalar_resources), ctl.cap,
                                     ctl.used, ctl.shift)
        finally:
            arm.close(ssn)
    assert seen["torch"] == seen["jax"]


def test_chaos_stale_generation_degrades_to_full_rebuild():
    """The incremental.stale_generation site forces a generation
    mismatch: a full rebuild with identical tensors, the solve cache
    invalidated, micro again on the next cycle."""
    from kube_batch_tpu_torch.chaos import plan as chaos_plan
    from kube_batch_tpu_torch.chaos.plan import FaultPlan

    arm = Arm("torch", (60, 16, 10, 2))
    arm.cycle()
    arm.cycle()
    st = arm.state()
    st.solve_gen = 123  # pretend a cached solve exists
    plan = FaultPlan(seed=1, rate=1.0,
                     sites=("incremental.stale_generation",), budget=1)
    chaos_plan.install(plan)
    try:
        ssn = arm.open()
        snap = arm.tensorize(ssn)
        assert_same_inputs(snap, arm.oracle_snapshot(ssn), "chaos")
        arm.close(ssn)
    finally:
        chaos_plan.disable()
    assert plan.total_injected() == 1
    assert st.last_kind == "fallback" and "stale generation" in \
        st.last_reason
    assert st.solve_gen == -1
    ssn = arm.open()
    arm.tensorize(ssn)
    arm.close(ssn)
    assert st.last_kind == "micro"


def test_jax_mode_is_left_as_found():
    """The arms restore the process's x64 mode after every call."""
    before = jax.config.jax_enable_x64
    arm = Arm("jax", (60, 16, 10, 2), x64=not before)
    arm.cycle()
    assert jax.config.jax_enable_x64 == before


def test_conf_change_on_live_cache_falls_back():
    """A session opened with other tiers on the same cache must not be
    served tensors persisted under the old conf; micro resumes after."""
    for pkg in ("torch", "jax"):
        arm = Arm(pkg, (60, 16, 10, 2), n_signatures=4)
        for _ in range(3):
            arm.cycle()
        conf = arm.m.scheduler.DEFAULT_SCHEDULER_CONF
        other = conf.replace("  - name: nodeorder\n", "")
        assert other != conf
        tiers = arm.tiers_of(other)
        ssn = arm.open(tiers)
        snap = arm.tensorize(ssn)
        if pkg == "torch":
            assert_same_inputs(snap, arm.oracle_snapshot(ssn), "conf")
        arm.close(ssn)
        st = arm.state()
        assert (st.last_kind, st.last_reason) == \
            ("fallback", "plugin/tier structure changed"), pkg
        ssn = arm.open(tiers)
        arm.tensorize(ssn)
        arm.close(ssn)
        assert st.last_kind == "micro", (pkg, st.last_kind, st.last_reason)


def test_aborted_build_drops_persisted_mask():
    """A tensorize that returns a fallback reason after the plan and the
    pack refresh must not leave the persisted mask serveable."""
    arm = Arm("torch", (60, 16, 10, 2), n_signatures=4)
    api = arm.m.api
    # A standing pending featured hog keeps the signature set non-empty.
    pg = "churn-hog"
    arm.cache.add_pod_group(arm.pod_group(pg))
    arm.cache.add_pod(api.Pod(
        metadata=api.ObjectMeta(
            name=f"{pg}-0", namespace="bench", uid=f"{pg}-0",
            annotations={arm.m.v1alpha1.GroupNameAnnotationKey: pg},
            creation_timestamp=3e6),
        spec=api.PodSpec(containers=[api.Container(
            requests={"cpu": "4000", "memory": "1Ti"})],
            node_selector={"pool": "pool0"}),
        status=api.PodStatus(phase="Pending")))
    for _ in range(3):
        arm.cycle()
    st = arm.state()
    assert st.sig_mask is not None
    # 65 distinct host-port keys: the tensorizer gives up after the plan
    # and the pack refresh ran.
    pg = "churn-ports"
    arm.cache.add_pod_group(arm.pod_group(pg))
    port_pods = []
    for i in range(65):
        pod = api.Pod(
            metadata=api.ObjectMeta(
                name=f"{pg}-{i}", namespace="bench", uid=f"{pg}-{i}",
                annotations={arm.m.v1alpha1.GroupNameAnnotationKey: pg},
                creation_timestamp=2e6 + i),
            spec=api.PodSpec(containers=[api.Container(
                requests={"cpu": "100m", "memory": "128Mi"},
                ports=[api.ContainerPort(host_port=20000 + i)])]),
            status=api.PodStatus(phase="Pending"))
        arm.cache.add_pod(pod)
        port_pods.append(pod)
    ssn = arm.open()
    snap = arm.tensorize(ssn)
    arm.close(ssn)
    assert snap.needs_fallback and "host-port keys" in snap.fallback_reason
    assert st.build_open  # finish never ran
    for pod in port_pods:
        arm.cache.delete_pod(pod)
    ssn = arm.open()
    snap = arm.tensorize(ssn)
    assert_same_inputs(snap, arm.oracle_snapshot(ssn), "post-abort")
    arm.close(ssn)
    assert not st.build_open


def test_cleanup_pop_feeds_snapshot_map():
    """process_cleanup_jobs removing a job from truth is a mutation the
    snapshot map must see."""
    seen = {}
    for pkg in ("torch", "jax"):
        arm = Arm(pkg, (60, 16, 10, 2))
        api = arm.m.api
        cache = arm.cache
        arm.cycle()
        arm.cycle()
        uid = sorted(cache.jobs)[0]
        pg_name = uid.split("/", 1)[1]
        pods = [t.pod for t in cache.jobs[uid].tasks.values()]
        cache.delete_pod_group(arm.pod_group(pg_name))
        assert cache.deleted_jobs
        for p in pods:
            cache.delete_pod(p)
        cache.add_pod_group(arm.pod_group(pg_name))
        for p in pods:
            cache.add_pod(dataclasses.replace(
                p, spec=dataclasses.replace(p.spec, node_name=""),
                status=api.PodStatus(phase="Pending")))
        out = [_snapshot_matches_control(arm, "recreated")]
        cache.process_cleanup_jobs()
        assert uid not in cache.jobs
        out.append(_snapshot_matches_control(arm, "after cleanup pop"))
        seen[pkg] = out
    assert seen["torch"] == seen["jax"]


def test_occupancy_in_place_equals_rebuilt():
    """With host-port pods resident, the persistent occupancy matrices
    patched in place equal a fresh rebuild, and the session's leaves do
    not alias them."""
    from kube_batch_tpu_torch.metrics import metrics
    arm = Arm("torch", (40, 8, 6, 2))
    arm.add_churn_job("p0", n_pods=1, cpu="100m", mem="128Mi", ports=[7777])
    arm.cycle()
    arm.cycle()
    arm.add_churn_job("p1", n_pods=1, cpu="4000", mem="4000Gi",
                      ports=[7777])
    arm.cycle()
    arm.add_churn_job("plain", n_pods=2)
    ssn = arm.open()
    try:
        snap = arm.tensorize(ssn)
        rebuilt = int(metrics.occupancy_rows_rebuilt.value())
        assert 0 <= rebuilt < len(arm.cache.nodes), rebuilt
        oracle = arm.oracle_snapshot(ssn)
        assert not snap.needs_fallback
        assert_same_inputs(snap, oracle, "occupancy")
        tc = arm.cache._tensor_cache
        assert snap.inputs.node_ports is not tc.occ_ports
        assert snap.inputs.node_selcnt is not tc.occ_selcnt
    finally:
        arm.close(ssn)


def test_occupancy_gauge_inactive_without_features():
    from kube_batch_tpu_torch.metrics import metrics
    arm = Arm("torch", (20, 8, 4, 2))
    arm.cycle()
    assert int(metrics.occupancy_rows_rebuilt.value()) == -1


def test_fractional_allocatable_disables_total_only():
    """A node with a fractional allocatable dimension voids the cached
    total but keeps serving the integer grid entries."""
    arm = Arm("torch", (20, 6, 4, 2))
    arm.cycle()
    arm.add_node("frac-node", {"cpu": "1", "memory": "0.5", "pods": 10})
    ssn = arm.open()
    try:
        assert arm.incremental.cluster_total_allocatable(ssn) is None
        agg = arm.cache.node_open_aggregates()
        assert agg is not None and agg[0] is None
        assert "frac-node" in agg[1]
    finally:
        arm.close(ssn)


def test_cycle_floor_metrics_populate():
    from kube_batch_tpu_torch.metrics import metrics
    arm = Arm("torch", (30, 8, 5, 2))
    arm.cycle()
    floors = metrics.cycle_floor_values()
    for key in ("solve_wait", "snapshot", "close", "occupancy", "stage",
                "plugin_close"):
        assert key in floors, floors
    onwork = metrics.onwork_values()
    for key in ("snapshot_walked", "snapshot_reused", "close_walked",
                "occupancy_rebuilt", "candidate_rows", "stage_rows"):
        assert key in onwork, onwork


def test_incremental_meta_lands_in_flight_recorder():
    from kube_batch_tpu_torch.trace import flight_recorder
    from kube_batch_tpu_torch.trace import spans as tspans
    arm = Arm("torch", (40, 8, 6, 2))
    arm.cycle()
    sid = tspans.begin_session(test="incremental")
    try:
        arm.cycle(echo=False)
    finally:
        tspans.end_session()
    tr = flight_recorder.get(sid)
    assert tr is not None
    assert tr.meta.get("incremental") in ("micro", "full", "fallback")
    assert "dirty_nodes" in tr.meta and "dirty_jobs" in tr.meta
    summary = next(s for s in flight_recorder.summaries()
                   if s["session"] == sid)
    assert summary["meta"].get("incremental") == tr.meta["incremental"]
