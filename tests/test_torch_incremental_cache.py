"""The clone pool and the per-job tensor blocks, the JAX package against
the port, on the CPU.

Twin of tests/test_incremental.py.  The equivalence fuzz is
tools/fuzz_incremental.py's protocol written once for either package: a
long-lived cache fed only deltas and a cache rebuilt from scratch run the
same sessions (one of three confs per cycle, the default conf's
``tpu-allocate, backfill`` and ``allocate, preempt, backfill`` among them)
and must bind and evict alike; the port's effects must also equal the JAX
package's, cycle by cycle.  The unit cases pin clone reuse and
invalidation, the eviction of a session-mutated clone, the epoch bumps of
``cache.evict`` and the reuse of per-job tensor blocks, in both packages.
"""

import copy
import dataclasses as dc
import random

import pytest

from tests.test_torch_utils import twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

CONFS = ("tpu-allocate, backfill", "allocate, backfill",
         "allocate, preempt, backfill")


def make_state(p, rng):
    api = p.m.api
    state = {"pods": {}, "nodes": {}, "pgs": {}, "queues": {}, "pcs": {},
             "next_pod": 0, "next_pg": 0}
    for q in range(rng.randint(1, 3)):
        state["queues"][f"q{q}"] = p.queue(f"q{q}", rng.randint(1, 4),
                                           ts=float(q))
    for i in range(rng.randint(3, 8)):
        name = f"n{i:03d}"
        alloc = {"cpu": str(rng.choice([4, 8, 16])),
                 "memory": f"{rng.choice([8, 16, 32])}Gi", "pods": 110}
        state["nodes"][name] = api.Node(
            metadata=api.ObjectMeta(
                name=name, uid=name,
                labels={"kubernetes.io/hostname": name, "zone": f"z{i % 3}"}),
            spec=api.NodeSpec(),
            status=api.NodeStatus(allocatable=dict(alloc),
                                  capacity=dict(alloc)))
    return state


def add_job(p, state, rng, size=None):
    api, v1 = p.m.api, p.m.v1alpha1
    size = size or rng.randint(1, 5)
    jid = state["next_pg"]
    state["next_pg"] += 1
    pg_name = f"pg{jid}"
    queue = rng.choice(sorted(state["queues"]))
    state["pgs"][f"ns/{pg_name}"] = v1.PodGroup(
        metadata=api.ObjectMeta(name=pg_name, namespace="ns",
                                creation_timestamp=float(jid)),
        spec=v1.PodGroupSpec(min_member=rng.randint(1, size), queue=queue))
    sig = rng.randrange(6)
    priority = rng.choice([None, None, 1, 5, 10])
    for _ in range(size):
        pid = state["next_pod"]
        state["next_pod"] += 1
        name = f"p{pid:05d}"
        selector = {"zone": f"z{sig % 3}"} if sig == 0 else {}
        tolerations = ([api.Toleration(key="dedicated", operator="Equal",
                                       value=f"t{sig % 2}", effect="")]
                       if sig in (1, 2) else [])
        affinity = (api.Affinity(preferred_node_terms=[(sig, {"zone": "z1"})])
                    if sig in (3, 4) else None)
        state["pods"][f"ns/{name}"] = api.Pod(
            metadata=api.ObjectMeta(
                name=name, namespace="ns", uid=name, labels={"grp": pg_name},
                annotations={v1.GroupNameAnnotationKey: pg_name},
                creation_timestamp=float(pid)),
            spec=api.PodSpec(containers=[api.Container(
                requests={"cpu": str(rng.choice([1, 2, 3])),
                          "memory": f"{rng.choice([1, 2, 4])}Gi"})],
                node_selector=selector, tolerations=tolerations,
                affinity=affinity, priority=priority),
            status=api.PodStatus(phase="Pending"))


def churn(p, state, cache, rng):
    api = p.m.api
    for _ in range(rng.randint(1, 4)):
        op = rng.random()
        if op < 0.40:
            before = dict(state["pods"])
            add_job(p, state, rng)
            for key, pod in state["pods"].items():
                if key not in before:
                    cache.add_pod(pod)
            for k in state["pgs"]:
                if k.split("/")[1] == f"pg{state['next_pg'] - 1}":
                    cache.add_pod_group(state["pgs"][k])
        elif op < 0.65:
            if state["pods"]:
                key = rng.choice(sorted(state["pods"]))
                cache.delete_pod(state["pods"].pop(key))
        elif op < 0.75:
            if state["pgs"]:
                pg = state["pgs"].pop(rng.choice(sorted(state["pgs"])))
                doomed = [k for k, pod in state["pods"].items()
                          if pod.metadata.labels.get("grp")
                          == pg.metadata.name]
                for k in doomed:
                    cache.delete_pod(state["pods"].pop(k))
                cache.delete_pod_group(pg)
        elif op < 0.90:
            if state["nodes"]:
                name = rng.choice(sorted(state["nodes"]))
                old = state["nodes"][name]
                labels = dict(old.metadata.labels)
                labels["zone"] = f"z{rng.randrange(3)}"
                taints = ([api.Taint(key="dedicated",
                                     value=f"t{rng.randrange(2)}",
                                     effect="NoSchedule")]
                          if rng.random() < 0.3 else [])
                new = dc.replace(
                    old, metadata=dc.replace(old.metadata, labels=labels),
                    spec=dc.replace(old.spec, taints=taints))
                state["nodes"][name] = new
                cache.update_node(old, new)
        else:
            pc = api.PriorityClass(metadata=api.ObjectMeta(name="hot"),
                                   value=rng.randint(1, 100),
                                   global_default=False)
            state["pcs"]["hot"] = pc
            cache.add_priority_class(pc)


def fresh_cache(p, state):
    cache, binder, _ = p.empty_cache()
    for key in ("queues", "pcs", "nodes", "pgs", "pods"):
        add = {"queues": cache.add_queue, "pcs": cache.add_priority_class,
               "nodes": cache.add_node, "pgs": cache.add_pod_group,
               "pods": cache.add_pod}[key]
        for obj in state[key].values():
            add(copy.deepcopy(obj))
    return cache, binder


def session(p, cache, binder, conf_actions):
    default = p.m.scheduler.DEFAULT_SCHEDULER_CONF
    conf = default.replace('"tpu-allocate, backfill"', f'"{conf_actions}"')
    assert f'"{conf_actions}"' in conf
    actions, tiers = p.load(conf)
    ssn = p.m.framework.open_session(cache, tiers)
    try:
        for action in actions:
            action.execute(ssn)
    finally:
        p.m.framework.close_session(ssn)
    binds = dict(binder.binds)
    binder.binds.clear()
    evicts = list(cache.evictor.evicts)
    cache.evictor.evicts.clear()
    return binds, evicts


def echo(p, state, cache, binds):
    for key, node in sorted(binds.items()):
        old = state["pods"].get(key)
        if old is None:
            continue
        new = dc.replace(old, spec=dc.replace(old.spec, node_name=node),
                         status=p.m.api.PodStatus(phase="Running"))
        state["pods"][key] = new
        cache.update_pod(old, new)
    updater = cache.status_updater
    for pg in updater.pod_groups:
        if f"{pg.metadata.namespace}/{pg.metadata.name}" in state["pgs"]:
            cache.add_pod_group(pg)
    updater.pod_groups.clear()


def run_seed(p, seed, cycles):
    rng = random.Random(seed)
    state = make_state(p, rng)
    for _ in range(rng.randint(2, 5)):
        add_job(p, state, rng)
    cache_a, binder_a = fresh_cache(p, state)
    record = []
    for cycle in range(cycles):
        churn(p, state, cache_a, rng)
        cache_b, binder_b = fresh_cache(p, state)
        conf_actions = rng.choice(CONFS)
        got = session(p, cache_a, binder_a, conf_actions)
        want = session(p, cache_b, binder_b, conf_actions)
        assert got == want, (seed, cycle, conf_actions)
        record.append((conf_actions, got))
        echo(p, state, cache_a, got[0])
    return record


@pytest.mark.parametrize("seed", [7001, 7007, 7013, 7021])
def test_incremental_equivalence_fuzz(seed):
    twin(lambda p: run_seed(p, seed, cycles=6))


def _echo_binds(p, cache, binder):
    podmap = {p.m.api.pod_key(t.pod): t.pod for job in cache.jobs.values()
              for t in job.tasks.values()}
    for key, node in sorted(binder.binds.items()):
        old = podmap.get(key)
        if old is None:
            continue
        cache.update_pod(old, dc.replace(
            old, spec=dc.replace(old.spec, node_name=node),
            status=p.m.api.PodStatus(phase="Running")))
    binder.binds.clear()


def _echo_status_writes(cache):
    updater = cache.status_updater
    for pg in updater.pod_groups:
        cache.add_pod_group(pg)
    updater.pod_groups.clear()


def _synthetic(p, *shape):
    return p.mod.models_synthetic.make_synthetic_cache(*shape)


def _allocate_once(p, cache):
    ssn = p.m.framework.open_session(cache, p.tiers())
    p.action("tpu_allocate").execute(ssn)
    p.m.framework.close_session(ssn)


def _tensorize(p, ssn):
    ts = p.mod.models_tensor_snapshot
    if p.pkg == "torch":
        return ts.tensorize_session(ssn, p.dtype)
    return ts.tensorize_session(ssn)


def test_clone_pool_reuses_untouched_and_invalidates_on_delta():
    def body(p):
        cache, binder = _synthetic(p, 40, 4, 8, 2)
        _allocate_once(p, cache)
        _echo_binds(p, cache, binder)
        _echo_status_writes(cache)
        p.m.framework.close_session(
            p.m.framework.open_session(cache, p.tiers()))
        _echo_status_writes(cache)

        ssn = p.m.framework.open_session(cache, p.tiers())
        assert not _tensorize(p, ssn).needs_fallback
        node_clone = ssn.nodes["n00000"]
        job_uid = sorted(ssn.jobs)[0]
        job_clone = ssn.jobs[job_uid]
        p.m.framework.close_session(ssn)
        assert job_uid not in ssn.mutated_jobs

        task = next(iter(cache.jobs[job_uid].tasks.values()))
        touched = task.node_name
        untouched = [n for n in sorted(cache.nodes) if n != touched][0]
        ssn2 = p.m.framework.open_session(cache, p.tiers())
        assert ssn2.nodes["n00000"] is node_clone
        assert ssn2.jobs[job_uid] is job_clone
        touched_clone = ssn2.nodes[touched]
        other_clone = ssn2.nodes[untouched]
        p.m.framework.close_session(ssn2)

        cache.update_pod(task.pod, dc.replace(
            task.pod, status=p.m.api.PodStatus(phase="Succeeded")))
        ssn3 = p.m.framework.open_session(cache, p.tiers())
        assert ssn3.jobs[job_uid] is not job_clone
        assert ssn3.nodes[touched] is not touched_clone
        assert ssn3.nodes[untouched] is other_clone
        p.m.framework.close_session(ssn3)
        return job_uid, touched, untouched
    twin(body)


def test_session_mutation_evicts_pooled_clone():
    def body(p):
        cache, binder = _synthetic(p, 40, 4, 8, 2)
        ssn = p.m.framework.open_session(cache, p.tiers())
        p.action("tpu_allocate").execute(ssn)
        assert binder.binds
        placed = sorted(ssn.mutated_jobs)
        assert placed
        mutated_clone = ssn.jobs[placed[0]]
        p.m.framework.close_session(ssn)
        ssn2 = p.m.framework.open_session(cache, p.tiers())
        assert ssn2.jobs[placed[0]] is not mutated_clone
        p.m.framework.close_session(ssn2)
        return placed, dict(binder.binds)
    twin(body)


def test_cache_evict_bumps_epochs():
    def body(p):
        cache, binder = _synthetic(p, 40, 4, 8, 2)
        _allocate_once(p, cache)
        _echo_binds(p, cache, binder)
        job = cache.jobs[sorted(cache.jobs)[0]]
        task = next(iter(job.tasks.values()))
        assert task.node_name
        node = cache.nodes[task.node_name]
        job_epoch, node_epoch = job.mod_epoch, node.mod_epoch
        cache.evict(task, "preempted")
        assert job.mod_epoch > job_epoch
        assert node.mod_epoch > node_epoch
        return task.uid, job.tasks[task.uid].status.name
    assert twin(body)[1] == "Releasing"


def test_tensor_blocks_reused_across_sessions():
    def body(p):
        cache, _ = _synthetic(p, 60, 6, 10, 2)
        ssn = p.m.framework.open_session(cache, p.tiers())
        assert not _tensorize(p, ssn).needs_fallback
        p.m.framework.close_session(ssn)
        tc = cache._tensor_cache
        ids = {uid: id(b) for uid, b in tc.jobs.items()}
        assert ids
        ssn2 = p.m.framework.open_session(cache, p.tiers())
        _tensorize(p, ssn2)
        p.m.framework.close_session(ssn2)
        assert {uid: id(b) for uid, b in tc.jobs.items()} == ids
        job_uid = sorted(cache.jobs)[0]
        cache.delete_pod(next(iter(cache.jobs[job_uid].tasks.values())).pod)
        ssn3 = p.m.framework.open_session(cache, p.tiers())
        _tensorize(p, ssn3)
        p.m.framework.close_session(ssn3)
        ids3 = {uid: id(b) for uid, b in tc.jobs.items()}
        assert ids3[job_uid] != ids[job_uid]
        assert all(ids3[uid] == ids[uid] for uid in ids3 if uid != job_uid)
        return sorted(ids3)
    twin(body)
