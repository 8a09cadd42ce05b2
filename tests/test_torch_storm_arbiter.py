"""The arbiter of the storm benchmark's reference: on one small cluster
full of Running residents, the JAX package's sessions of the shipped
four-action conf, the port's, and portbench/reference/evict.py (plain
NumPy, written from kube-batch's rules) evict the same victims, in the
same order, by the same actions, and bind the same pods to the same
nodes, session after session, with each session's victims deleted before
the next.  The cluster has more nodes than the eviction scanner's
threshold (64), as the benchmark's cell has."""

import pytest

from portbench import cell, generator, storm_check
from portbench.reference import evict
from tests.test_torch_utils import Pkg, reference_gc_guard  # noqa: F401

SESSIONS = 6


def _small(nodes, wave):
    _bench, _entry, config, traffic = cell.load("churn50k.storm")
    config["nodes"] = nodes
    config["residents"]["pods"] = 4 * nodes
    traffic["wave_pods"] = wave
    return config, traffic


def _scenario(config, traffic, seed):
    cluster = generator.make_cluster(config, seed)
    residents = storm_check.make_residents(config, cluster)
    wave = storm_check.make_wave(config, traffic, cluster, seed, 0)
    return cluster, residents, wave


def _build(p, config, traffic, cluster, residents, wave):
    """The scenario in package ``p``'s own objects: (cache, binder,
    resident pods by key)."""
    m = p.m
    api, v1 = m.api, m.v1alpha1
    cache, binder, _evictor = p.empty_cache()
    for name, value in config["priority_classes"].items():
        cache.add_priority_class(m.objects.PriorityClass(
            metadata=api.ObjectMeta(name=name), value=int(value)))
    for name, weight, ts in zip(cluster.queue_names, cluster.queue_weights,
                                cluster.queue_ts):
        cache.add_queue(p.queue(name, weight=int(weight), ts=float(ts)))
    alloc = config["node_allocatable"]
    for name in cluster.node_names:
        cache.add_node(p.node(name, dict(alloc)))

    def groups(names, queues, mins, stamps, ns, pc):
        for name, q, least, ts in zip(names, queues, mins, stamps):
            cache.add_pod_group(v1.PodGroup(
                metadata=api.ObjectMeta(name=name, namespace=ns,
                                        uid=f"{ns}-{name}",
                                        creation_timestamp=float(ts)),
                spec=v1.PodGroupSpec(min_member=int(least),
                                     queue=cluster.queue_names[int(q)],
                                     priority_class_name=pc)))

    req = {"cpu": residents.cpu, "memory": residents.memory}
    groups(residents.job_names, residents.job_queue, residents.job_min,
           residents.job_ts, residents.namespace, residents.priority_class)
    pods = {}
    for name, j, n, ts in zip(residents.names, residents.job,
                              residents.node, residents.ts):
        pod = p.pod(residents.namespace, name, cluster.node_names[int(n)],
                    "Running", dict(req),
                    groupname=residents.job_names[int(j)],
                    priority=residents.priority, ts=float(ts),
                    priority_class_name=residents.priority_class)
        pods[f"{residents.namespace}/{name}"] = pod
        cache.add_pod(pod)
    pc = traffic["priority_class"]
    groups(wave.group_names, wave.group_queue, wave.group_min, wave.group_ts,
           wave.namespace, pc)
    wreq = {"cpu": traffic["cpu"][0], "memory": traffic["memory"][0]}
    for name, g, ts in zip(wave.pod_names, wave.pod_group, wave.pod_ts):
        cache.add_pod(p.pod(wave.namespace, name, "", "Pending", dict(wreq),
                            groupname=wave.group_names[int(g)],
                            ts=float(ts), priority_class_name=pc))
    return cache, binder, pods


def _package_cycle(pkg, config, traffic, scenario):
    """[(victims with their actions, in order; binds)] per session."""
    p = Pkg(pkg, x64=False)
    with p.ctx():
        cache, binder, pods = _build(p, config, traffic, *scenario)
        kw = {} if pkg == "jax" else {"device": "cpu", "dtype": p.dtype}
        sched = p.m.scheduler.Scheduler(
            cache, scheduler_conf=config["scheduler_conf"], **kw)
        out, seen = [], {}
        for _ in range(SESSIONS):
            cache.events.clear()
            sched.run_once()
            victims = [(key, why) for kind, key, why in list(cache.events)
                       if kind == "Evict"]
            binds = {k: v for k, v in binder.binds.items() if k not in seen}
            seen.update(binds)
            out.append((victims, binds))
            for key, _why in victims:
                cache.delete_pod(pods[key])
            if not victims and not binds:
                break
    return out


def _reference_cycle(scenario):
    cluster, residents, wave = scenario
    out = []
    for d in evict.run_cycle(cluster, residents, wave,
                             max_sessions=SESSIONS):
        out.append((
            [(f"{residents.namespace}/{residents.names[r]}", a)
             for r, a in d.victims],
            {f"{wave.namespace}/{wave.pod_names[i]}": cluster.node_names[n]
             for i, n in enumerate(d.node) if n >= 0}))
    return out


@pytest.mark.parametrize("nodes,wave,seed", [(80, 80, 3), (100, 160, 7)])
def test_the_jax_package_the_port_and_the_reference_agree(nodes, wave,
                                                          seed):
    config, traffic = _small(nodes, wave)
    scenario = _scenario(config, traffic, seed)
    jax_out = _package_cycle("jax", config, traffic, scenario)
    torch_out = _package_cycle("torch", config, traffic, scenario)
    ref_out = _reference_cycle(scenario)
    # The storm does its work: both actions evict and preemptors bind.
    actions = {a for victims, _b in jax_out for _k, a in victims}
    assert actions == {"reclaim", "preempt"}
    assert sum(len(b) for _v, b in jax_out) > 0
    assert jax_out == ref_out
    assert torch_out == ref_out
