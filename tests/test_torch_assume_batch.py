"""The cache's batched assume mirror against the per-pod algorithm it
replaces.

``SchedulerCache.bind_batch`` and ``bind`` mirror every landed bind into
cache truth ahead of its watch echo through ``_assume_bound_many``: one
mutex acquisition, no re-parse of the pods, the job and node vectors moved
once by their sums.  The oracle here is the per-pod algorithm, kept as a
plain function over the cache's ``_delete_task``, ``_task_info`` and
``_add_task`` (the informer handlers' own steps): under one lock per pod,
a node-stamped ``dataclasses.replace`` of the pod is re-parsed and
re-added.  Each case builds two identical caches, binds the same tasks on
both, one through the oracle, and compares the whole truth exactly: every
job's tasks, status buckets and vectors, every node's tasks and vectors,
dict orders and insertion stamps included, the events and the resync
queue.
"""

import dataclasses
import random
import sys
import threading

import pytest

from kube_batch_tpu_torch import api, native
from kube_batch_tpu_torch.api.queue_info import Queue
from kube_batch_tpu_torch.apis.scheduling import v1alpha1
from kube_batch_tpu_torch.cache import (Cluster, SchedulerCache,
                                        new_scheduler_cache)
from kube_batch_tpu_torch.cache import assume
from kube_batch_tpu_torch.cache import cache as cache_mod
from kube_batch_tpu_torch.cache.interface import Binder
from kube_batch_tpu_torch.metrics import metrics

GROUP = v1alpha1.GroupNameAnnotationKey


class _Binder(Binder):
    """Lands every bind but those of the pods named in ``fail``."""

    def __init__(self, fail=()):
        self.fail = set(fail)

    def bind(self, pod, hostname):
        if pod.metadata.name in self.fail:
            raise ValueError(f"rejected {pod.metadata.name}")


def _pod(name, group="", cpu="1", mem="1Gi", init=None, deleting=False,
         phase="Pending", gpu=None, ns="ns"):
    req = {"cpu": cpu, "memory": mem}
    if gpu is not None:
        req["nvidia.com/gpu"] = gpu
    return api.Pod(
        metadata=api.ObjectMeta(
            name=name, namespace=ns, uid=f"{ns}-{name}",
            annotations={GROUP: group} if group else {},
            deletion_timestamp=1.0 if deleting else None),
        spec=api.PodSpec(
            containers=[api.Container(requests=req)],
            init_containers=[api.Container(requests=init)] if init else []),
        status=api.PodStatus(phase=phase))


def _node(name, cpu="16", mem="64Gi", gpu=None):
    alloc = {"cpu": cpu, "memory": mem, "pods": 110}
    if gpu is not None:
        alloc["nvidia.com/gpu"] = gpu
    return api.Node(metadata=api.ObjectMeta(name=name, uid=name),
                    status=api.NodeStatus(allocatable=alloc,
                                          capacity=dict(alloc)))


def _group(name, ns="ns"):
    return v1alpha1.PodGroup(
        metadata=api.ObjectMeta(name=name, namespace=ns, uid=f"{ns}-{name}"),
        spec=v1alpha1.PodGroupSpec(min_member=1, queue="default"))


def _cache(nodes, groups, pods, fail=()):
    cache = SchedulerCache(binder=_Binder(fail))
    cache.add_queue(Queue(metadata=api.ObjectMeta(name="default"), weight=1))
    for n in nodes:
        cache.add_node(n)
    for g in groups:
        cache.add_pod_group(g)
    for p in pods:
        cache.add_pod(p)
    return cache


def _bound(cache, placements):
    """Session-like clones of the cached tasks, bound as ``placements``
    [(pod name, node)] say, in that order."""
    by_name = {t.name: t for j in cache.jobs.values()
               for t in j.tasks.values()}
    out = []
    for name, host in placements:
        t = by_name[name].clone_lite()
        t.node_name = host
        t.status = api.TaskStatus.Binding
        out.append(t)
    return out


def oracle_assume(cache, task, hostname):
    """The per-pod mirror of one landed bind."""
    with cache.mutex:
        job = cache.jobs.get(task.job)
        cached = job.tasks.get(task.uid) if job is not None else None
        if cached is None or cached.node_name:
            return
        cache.epoch += 1
        pod = dataclasses.replace(
            cached.pod, spec=dataclasses.replace(cached.pod.spec,
                                                 node_name=hostname))
        cache._delete_task(cached)
        ti = cache._task_info(pod)
        if ti is not None:
            cache._add_task(ti)


def oracle_bind_batch(cache, tasks):
    """``bind_batch`` with the per-pod mirror: the failed binds queue a
    resync, the landed ones are mirrored in order, then their events."""
    fail = cache.binder.fail
    landed = []
    for t in tasks:
        if t.name in fail:
            cache._resync_task(t)
        else:
            landed.append(t)
    for t in landed:
        oracle_assume(cache, t, t.node_name)
    cache.events.extend(("Scheduled", api.pod_key(t.pod), t.node_name)
                        for t in landed)


def _res(r):
    return (r.milli_cpu, r.memory, list(r.scalar_resources.items()),
            r.max_task_num)


def _task(t):
    return (t.uid, t.job, t.name, t.namespace, t.node_name, t.status,
            t.priority, t.volume_ready, _res(t.resreq), _res(t.init_resreq),
            t.pod, t.pod.spec.node_name)


def truth(cache):
    """Everything the mirror may touch, in dict order, exactly."""
    jobs = [(key, j.uid, getattr(j, "_ins_seq", None), j.pod_group,
             [(k, _task(t)) for k, t in j.tasks.items()],
             [(s, list(d)) for s, d in j.task_status_index.items()],
             _res(j.allocated), _res(j.total_request), j.ready_task_num())
            for key, j in cache.jobs.items()]
    nodes = [(key, n.name, getattr(n, "_ins_seq", None), n.node,
              [(k, _task(t)) for k, t in n.tasks.items()],
              _res(n.idle), _res(n.used), _res(n.releasing))
             for key, n in cache.nodes.items()]
    return (jobs, nodes, list(cache.events),
            [t.uid for t in cache.err_tasks])


def _pair(build):
    """Two identical caches from ``build()``."""
    return build(), build()


def _mirrored():
    return {p: metrics.assume_mirrored.value(p)
            for p in ("batched", "per_task", "skipped")}


def _delta(before):
    after = _mirrored()
    return {p: after[p] - before[p] for p in after}


def _stamps(cache):
    return ({k: (id(j), j.mod_epoch) for k, j in cache.jobs.items()},
            {k: (id(n), n.mod_epoch) for k, n in cache.nodes.items()})


def _touched(cache, stamps):
    """The jobs and nodes whose epoch stamp moved (or that are new)
    since ``stamps``: what the next snapshot re-clones."""
    jobs, nodes = stamps
    return ({k for k, j in cache.jobs.items()
             if jobs.get(k) != (id(j), j.mod_epoch)},
            {k for k, n in cache.nodes.items()
             if nodes.get(k) != (id(n), n.mod_epoch)})


def _check(build, placements, *, paths=None, bind=None):
    """Bind ``placements`` on two caches, through ``bind_batch`` and the
    oracle; their truths must be equal, the epoch must grow, the same
    jobs and nodes must be stamped, and the counter move by ``paths``
    when given.  ``bind(cache, placements)`` makes the tasks."""
    bind = bind or _bound
    ours, theirs = _pair(build)
    # Reading the truth memoizes each job's ready count: the mirror must
    # reset it.
    assert truth(ours) == truth(theirs)
    epoch = ours.epoch
    stamps = _stamps(ours), _stamps(theirs)
    before = _mirrored()
    ours.bind_batch(bind(ours, placements))
    moved = _delta(before)
    oracle_bind_batch(theirs, bind(theirs, placements))
    assert truth(ours) == truth(theirs)
    assert ours.epoch >= epoch
    assert _touched(ours, stamps[0]) == _touched(theirs, stamps[1])
    if paths is not None:
        assert moved == paths
    return ours


def _random_build(seed, *, n_nodes=6, n_groups=5, per_group=6,
                  roomy=False):
    """A cluster drawn from ``seed``: integer quantities, init
    containers, Releasing pods, GPUs and, unless ``roomy``, tight
    nodes."""
    rng = random.Random(seed)
    nodes = [_node(f"n{i}", cpu="256", mem="1Ti", gpu="64") if roomy else
             _node(f"n{i}", cpu=rng.choice(["4", "8", "16"]),
                   mem=rng.choice(["8Gi", "16Gi"]),
                   gpu=rng.choice([None, "2"])) for i in range(n_nodes)]
    groups = [_group(f"g{g}") for g in range(n_groups)]
    pods = []
    for g in range(n_groups):
        for k in range(per_group):
            pods.append(_pod(
                f"p{g}-{k}", f"g{g}", cpu=rng.choice(["250m", "1", "2"]),
                mem=rng.choice(["512Mi", "1Gi", "3Gi"]),
                init=({"cpu": "3", "memory": "1Gi"}
                      if rng.random() < 0.2 else None),
                deleting=rng.random() < 0.15,
                gpu="1" if rng.random() < 0.1 else None))
    rng.shuffle(pods)
    order = [p.metadata.name for p in pods]
    rng.shuffle(order)
    placements = [(name, f"n{rng.randrange(n_nodes)}") for name in order]

    def build():
        cache = _cache(nodes, groups, [dataclasses.replace(p) for p in pods])
        # A task parsed anew is not volume-ready: the mirror resets it.
        for job in cache.jobs.values():
            for t in job.tasks.values():
                t.volume_ready = t.name.endswith("-0")
        return cache
    return build, placements


@pytest.mark.parametrize("walk", ["c", "python"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_batches_match_per_pod(seed, walk, monkeypatch):
    """Through the C walk (``native/fastpath.c``), which every other
    case runs too, and through its Python twin."""
    if walk == "c":
        assert assume.assume_walk is native.assume_walk is not None
        assert assume.insert_clones is native.assume_insert is not None
    else:
        monkeypatch.setattr(cache_mod, "assume_walk", assume.assume_walk_py)
        monkeypatch.setattr(cache_mod, "insert_clones",
                            assume.insert_clones_py)
        monkeypatch.setattr(assume, "_native_assume_group", None)
    build, placements = _random_build(seed)
    _check(build, placements)


def _plain(n_nodes=3, n_pods=6, fail=(), **pod_kw):
    nodes = [_node(f"n{i}") for i in range(n_nodes)]
    groups = [_group("g")]
    pods = [_pod(f"p{i}", "g", **pod_kw) for i in range(n_pods)]

    def build():
        return _cache(nodes, groups, [dataclasses.replace(p) for p in pods],
                      fail=fail)
    placements = [(f"p{i}", f"n{i % n_nodes}") for i in range(n_pods)]
    return build, placements


def test_all_landed_take_the_batched_path():
    build, placements = _plain()
    ours = _check(build, placements,
                  paths={"batched": 6, "per_task": 0, "skipped": 0})
    job = next(iter(ours.jobs.values()))
    assert set(job.task_status_index) == {api.TaskStatus.Bound}
    assert ours.nodes["n0"].used.milli_cpu == 2000.0


def test_partial_failures_resync():
    build, placements = _plain(fail=("p1", "p4"))
    ours = _check(build, placements,
                  paths={"batched": 4, "per_task": 0, "skipped": 0})
    assert [t.name for t in ours.err_tasks] == ["p1", "p4"]
    job = next(iter(ours.jobs.values()))
    assert job.tasks["ns-p1"].status == api.TaskStatus.Pending


def test_echo_landed_first_is_skipped():
    """The in-process cluster's echo is synchronous: every task is
    skipped and the mirror leaves the echo's truth alone."""
    def build():
        cluster = Cluster()
        for i in range(2):
            cluster.create_node(_node(f"n{i}"))
        cluster.create_queue(v1alpha1.Queue(
            metadata=api.ObjectMeta(name="default"),
            spec=v1alpha1.QueueSpec(weight=1)))
        cluster.create_pod_group(_group("g"))
        cache = new_scheduler_cache(cluster)
        for i in range(4):
            cluster.create_pod(_pod(f"p{i}", "g"))
        return cache
    cache = build()
    tasks = _bound(cache, [(f"p{i}", f"n{i % 2}") for i in range(4)])
    around = []
    mirror = cache._assume_bound_many

    def spy(tasks, hostname=None):
        around.append(truth(cache)[:2])
        mirror(tasks, hostname)
        around.append(truth(cache)[:2])
    cache._assume_bound_many = spy
    before = _mirrored()
    cache.bind_batch(tasks)
    assert _delta(before) == {"batched": 0, "per_task": 0, "skipped": 4}
    assert around[0] == around[1]
    assert all(t.node_name for j in cache.jobs.values()
               for t in j.tasks.values())


def test_task_gone_and_duplicates_are_skipped():
    build, _ = _plain()
    ours, theirs = _pair(build)
    for cache in (ours, theirs):
        cache.delete_pod(_pod("p2", "g"))
    placements = [("p0", "n0"), ("p1", "n1"), ("p0", "n0")]
    tasks = _bound(ours, placements)
    gone = _bound(build(), [("p2", "n2")])
    before = _mirrored()
    ours.bind_batch(tasks + gone)
    assert _delta(before) == {"batched": 2, "per_task": 0, "skipped": 2}
    oracle_bind_batch(theirs, _bound(theirs, placements) + gone)
    assert truth(ours) == truth(theirs)


def test_init_containers_keep_their_launch_request():
    build, placements = _plain(init={"cpu": "4", "memory": "2Gi"})
    ours = _check(build, placements,
                  paths={"batched": 6, "per_task": 0, "skipped": 0})
    task = next(iter(ours.nodes["n0"].tasks.values()))
    assert task.init_resreq.milli_cpu == 4000.0
    assert task.resreq.milli_cpu == 1000.0


def test_deletion_timestamp_binds_releasing():
    build, placements = _plain(deleting=True)
    ours = _check(build, placements,
                  paths={"batched": 6, "per_task": 0, "skipped": 0})
    job = next(iter(ours.jobs.values()))
    assert set(job.task_status_index) == {api.TaskStatus.Releasing}
    assert ours.nodes["n1"].releasing.milli_cpu == 2000.0
    assert job.allocated.milli_cpu == 0.0


def test_overdrawn_nodes_fail_task_by_task_in_order():
    """Two nodes the batch overdraws, their tasks interleaved: the
    per-task steps run in batch order, the FailedAddTask events too."""
    nodes = [_node("n0", cpu="3"), _node("n1", cpu="3"), _node("n2")]
    groups = [_group("g")]
    pods = [_pod(f"p{i}", "g", cpu="2") for i in range(7)]

    def build():
        return _cache(nodes, groups, [dataclasses.replace(p) for p in pods])
    placements = [("p0", "n0"), ("p1", "n1"), ("p2", "n0"), ("p3", "n2"),
                  ("p4", "n1"), ("p5", "n2"), ("p6", "n0")]
    ours = _check(build, placements,
                  paths={"batched": 2, "per_task": 5, "skipped": 0})
    failed = [e[1] for e in ours.events if e[0] == "FailedAddTask"]
    assert failed == ["ns/p2", "ns/p4", "ns/p6"]


@pytest.mark.parametrize("requests", [
    [{"cpu": "100m", "mem": "1.5"}],                # bytes not whole
    [{"cpu": "1", "mem": "1Gi", "gpu": "0.005"}],   # a scalar under 10m
    # Milli-CPU not whole, though each pair's sum is: taken once, the
    # sum would leave idle 1995.0 where the steps leave 1995.0000000000002.
    [{"cpu": "0.1932"}, {"cpu": "0.8118"}],
])
def test_inexact_quantities_take_the_per_task_steps(requests):
    nodes = [_node("n0", cpu="3"), _node("n1", cpu="3")]
    groups = [_group("g")]
    pods = [_pod(f"p{i}", "g", **requests[i % len(requests)])
            for i in range(4)]

    def build():
        return _cache(nodes, groups, [dataclasses.replace(p) for p in pods])
    _check(build, [("p0", "n0"), ("p1", "n0"), ("p2", "n1"), ("p3", "n1")],
           paths={"batched": 0, "per_task": 4, "skipped": 0})


def test_gpu_requests_sum_per_node():
    nodes = [_node("n0", gpu="4"), _node("n1")]
    groups = [_group("g")]
    pods = [_pod(f"p{i}", "g", gpu="1") for i in range(4)]

    def build():
        return _cache(nodes, groups, [dataclasses.replace(p) for p in pods])
    # n1 has no GPUs: its task fails its fit check step by step.
    ours = _check(build, [("p0", "n0"), ("p1", "n1"), ("p2", "n0"),
                          ("p3", "n0")],
                  paths={"batched": 3, "per_task": 1, "skipped": 0})
    assert ours.nodes["n0"].used.scalar_resources == {"nvidia.com/gpu":
                                                      3000.0}


def test_jobs_without_gang_source_and_odd_statuses_step():
    """A pod whose group is not in the cache (its job may be dropped and
    made anew), a shadow pod, a pod already Running without a node (its
    request already allocated), a node the cache has not seen, and a
    Succeeded pod (no node holds it)."""
    nodes = [_node("n0"), _node("n1")]
    groups = [_group("g")]
    pods = [_pod("orphan", "nogroup"), _pod("shadow"),
            _pod("running", "g", phase="Running"), _pod("a", "g"),
            _pod("b", "g"), _pod("done", "g", phase="Succeeded")]

    def build():
        return _cache(nodes, groups, [dataclasses.replace(p) for p in pods])
    placements = [("a", "n0"), ("orphan", "n0"), ("shadow", "n1"),
                  ("running", "n1"), ("b", "ghost"), ("done", "n0")]
    ours = _check(build, placements,
                  paths={"batched": 3, "per_task": 3, "skipped": 0})
    assert "ghost" in ours.nodes and ours.nodes["ghost"].node is None
    assert "ns/done" not in ours.nodes["n0"].tasks


def test_one_pod_key_twice_on_a_node():
    """Two pods of one namespace and name (two uids, two jobs) bound to
    one node: the second add fails, as task by task."""
    nodes = [_node("n0"), _node("n1")]
    groups = [_group("g"), _group("h")]
    first = _pod("x", "g")
    second = _pod("x", "h")
    second.metadata.uid = "ns-x-2"
    pods = [first, second, _pod("y", "h")]

    def build():
        return _cache(nodes, groups, [dataclasses.replace(p) for p in pods])

    def by_uid(cache, placements):
        tasks = {t.uid: t for j in cache.jobs.values()
                 for t in j.tasks.values()}
        out = []
        for uid, host in placements:
            t = tasks[uid].clone_lite()
            t.node_name = host
            out.append(t)
        return out
    ours = _check(build, [("ns-x", "n0"), ("ns-y", "n1"), ("ns-x-2", "n0")],
                  paths={"batched": 1, "per_task": 2, "skipped": 0},
                  bind=by_uid)
    assert [e[0] for e in ours.events].count("FailedAddTask") == 1


def test_single_bind():
    build, _ = _plain()
    ours, theirs = _pair(build)
    before = _mirrored()
    (task,) = _bound(ours, [("p3", "n2")])
    ours.bind(task, "n2")
    assert _delta(before) == {"batched": 1, "per_task": 0, "skipped": 0}
    (task,) = _bound(theirs, [("p3", "n2")])
    oracle_assume(theirs, task, "n2")
    theirs.events.append(("Scheduled", api.pod_key(task.pod), "n2"))
    assert truth(ours) == truth(theirs)


def test_later_echo_leaves_truth_unchanged():
    build, placements = _plain()
    cache = build()
    pending = {t.name: t.pod for j in cache.jobs.values()
               for t in j.tasks.values()}
    cache.bind_batch(_bound(cache, placements))
    epoch = cache.epoch
    mirrored = truth(cache)
    for name, host in placements:
        old = pending[name]
        cache.update_pod(old, dataclasses.replace(
            old, spec=dataclasses.replace(old.spec, node_name=host)))
    assert truth(cache) == mirrored
    assert cache.epoch > epoch


def test_counter_labels_in_one_batch():
    nodes = [_node("n0"), _node("n1")]
    groups = [_group("g"), _group("h")]
    pods = [_pod("a", "g"), _pod("b", "g"), _pod("c", "h", mem="0.5"),
            _pod("d", "g")]

    def build():
        return _cache(nodes, groups, [dataclasses.replace(p) for p in pods])
    ours, theirs = _pair(build)
    for cache in (ours, theirs):
        cache.delete_pod(_pod("d", "g"))
    gone = _bound(build(), [("d", "n0")])
    placements = [("a", "n0"), ("c", "n1"), ("b", "n0")]
    before = _mirrored()
    ours.bind_batch(_bound(ours, placements) + gone)
    assert _delta(before) == {"batched": 2, "per_task": 1, "skipped": 1}
    oracle_bind_batch(theirs, _bound(theirs, placements) + gone)
    assert truth(ours) == truth(theirs)


def test_node_stamped_pod_is_replace_without_caches():
    """The stamped pod is ``dataclasses.replace``'s, shares its fields,
    has a spec of its own, and of the cached attributes keeps only
    ``_pod_key``: from ``_node_stamped`` and from the C walk."""
    pod = _pod("p", "g")
    api.pod_key(pod)
    pod._tensor_static = (pod.spec,)
    pod._ingest_ts = 1.0
    cache = _cache([_node("n0")], [_group("g")], [])
    cache.add_pod(pod)
    cache.bind_batch(_bound(cache, [("p", "n0")]))
    walked = cache.jobs["ns/g"].tasks["ns-p"].pod
    assert cache.nodes["n0"].tasks["ns/p"].pod is walked
    want = dataclasses.replace(pod, spec=dataclasses.replace(
        pod.spec, node_name="n0"))
    for new in (assume.node_stamped(pod, "n0"), walked):
        assert new == want and vars(new.spec) == vars(want.spec)
        assert new.spec is not pod.spec and pod.spec.node_name == ""
        assert new.metadata is pod.metadata and new.status is pod.status
        assert new.spec.containers is pod.spec.containers
        assert set(vars(new)) == set(vars(want)) | {"_pod_key"}
        assert new._pod_key == "ns/p"


def test_echoes_racing_the_mirror_end_as_sequential():
    """A reflector thread delivers every bound pod's echo while the
    mirror runs.  Whichever lands first, the truth ends as the per-pod
    mirror followed by every echo in order leaves it.  The nodes are
    roomy: where a node is overdrawn, which task fails depends on the
    order the mirror and the echoes reach it in."""
    build, placements = _random_build(7, n_nodes=8, n_groups=8,
                                      per_group=25, roomy=True)

    def echoes(cache):
        pending = {t.name: t.pod for j in cache.jobs.values()
                   for t in j.tasks.values()}
        return [(pending[name], dataclasses.replace(
            pending[name], spec=dataclasses.replace(
                pending[name].spec, node_name=host)))
            for name, host in placements]

    theirs = build()
    delivered = echoes(theirs)
    oracle_bind_batch(theirs, _bound(theirs, placements))
    for old, new in delivered:
        theirs.update_pod(old, new)
    want = truth(theirs)[:2]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for trial in range(4):
            ours = build()
            delivered = echoes(ours)
            tasks = _bound(ours, placements)
            start = threading.Barrier(2, timeout=30)

            def reflector():
                start.wait()
                for old, new in delivered[trial * 40:]:
                    ours.update_pod(old, new)
            thread = threading.Thread(target=reflector)
            for old, new in delivered[:trial * 40]:
                ours.update_pod(old, new)
            thread.start()
            start.wait()
            ours.bind_batch(tasks)
            thread.join(timeout=30)
            assert not thread.is_alive()
            assert truth(ours)[:2] == want
    finally:
        sys.setswitchinterval(interval)
