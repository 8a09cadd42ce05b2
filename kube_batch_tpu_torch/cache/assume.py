"""The cache's assume mirror, apart from the cache's own state: the
node-stamped pod, the exact sums, and the per-task walk with its C twin.

``SchedulerCache._assume_bound_many`` mirrors a batch of landed binds into
cache truth in one pass.  It may take a sum once where the per-task
delete and re-add took each request in turn only where the two give the
same bits: integer-valued floats up to 2**52 in magnitude add and
subtract exactly while every partial result stays within 2**53, so then
a sum taken once equals the steps in any order (``exact``,
``exact_sum``).  The walk over the batch and each node's sums and
inserts run in C (``native/fastpath.c`` ``assume_walk``,
``assume_group``, ``assume_insert``) where the extension loads; the
Python forms here are their twins and run where it does not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..api import (MIN_MILLI_SCALAR, Pod, PodSpec, Resource, TaskStatus,
                   allocated_status, get_task_status, pod_key)
from ..api.types import ALLOCATED_STATUSES
from ..native import assume_group as _native_assume_group
from ..native import assume_insert as _native_assume_insert
from ..native import assume_setup as _native_assume_setup
from ..native import assume_walk as _native_assume_walk

_POD_FIELDS = tuple(f.name for f in dataclasses.fields(Pod))
_SPEC_FIELDS = tuple(f.name for f in dataclasses.fields(PodSpec))


def node_stamped(pod: Pod, hostname: str) -> Pod:
    """``dataclasses.replace(pod, spec=dataclasses.replace(pod.spec,
    node_name=hostname))`` without its per-call field walk: a new Pod
    and a new PodSpec sharing every other field, as replace shares them.
    The spec must be a new object: ``_pod_static`` (models/tensor_snapshot)
    caches on the pod, keyed by spec identity.  Of the pod's cached
    attributes only ``_pod_key`` is carried, a function of its namespace
    and name.  Field by field, not through ``__dict__``: that would give
    each spec, old and new, a dict of its own for the collector to walk
    (``native/fastpath.c`` ``stamp_pod`` does the same in C)."""
    spec = pod.spec
    if type(pod) is not Pod or type(spec) is not PodSpec:
        return dataclasses.replace(
            pod, spec=dataclasses.replace(spec, node_name=hostname))
    new_spec = object.__new__(PodSpec)
    for name in _SPEC_FIELDS:
        setattr(new_spec, name, getattr(spec, name))
    new_spec.node_name = hostname
    new = object.__new__(Pod)
    for name in _POD_FIELDS:
        setattr(new, name, getattr(pod, name))
    new.spec = new_spec
    key = getattr(pod, "_pod_key", None)
    if key is not None:
        new._pod_key = key
    return new


# The largest magnitude ``exact`` admits (the module docstring says why).
_EXACT_MAX = float(2 ** 52)


def exact(res: Resource) -> bool:
    """Whether every component of ``res`` is an integer-valued float of
    magnitude at most 2**52."""
    c = res.milli_cpu
    m = res.memory
    if not (-_EXACT_MAX <= c <= _EXACT_MAX and -_EXACT_MAX <= m <= _EXACT_MAX
            and c % 1.0 == 0.0 and m % 1.0 == 0.0):
        return False
    for q in res.scalar_resources.values():
        if not (-_EXACT_MAX <= q <= _EXACT_MAX and q % 1.0 == 0.0):
            return False
    return True


def exact_sum(tasks) -> Optional[Resource]:
    """The sum of the tasks' requests, or None unless every component is
    a non-negative integer-valued float, every scalar is above
    ``MIN_MILLI_SCALAR`` (``less_equal`` skips smaller ones task by task,
    so a sum would not check what the steps check), and the sum is
    ``exact``.  Non-negative parts keep every partial sum below the
    whole."""
    cpu = mem = 0.0
    scalars = None
    for t in tasks:
        r = t.resreq
        c = r.milli_cpu
        m = r.memory
        if not (c >= 0.0 and m >= 0.0 and c % 1.0 == 0.0 and m % 1.0 == 0.0):
            return None
        cpu += c
        mem += m
        if r.scalar_resources:
            if scalars is None:
                scalars = {}
            for name, q in r.scalar_resources.items():
                if not (q > MIN_MILLI_SCALAR and q % 1.0 == 0.0):
                    return None
                scalars[name] = scalars.get(name, 0.0) + q
    total = Resource(cpu, mem, scalars)
    return total if exact(total) else None


def assume_walk_py(jobs, nodes, tasks, hostname, moved, groups, on_nodes,
                   step_job, placeholder):
    """Pass 1 of the assume mirror, the twin of ``native/fastpath.c``'s
    ``assume_walk``.  Per task, in order: skip it when its echo landed or
    it is gone; else make its bound copy and move it in its job, fused
    (appended to ``moved[job]`` for the vectors) or through
    ``step_job(job, cached, bound)``; then queue it on its node in
    ``groups`` and ``on_nodes``, ``placeholder(name)`` making a node the
    cache has not seen.  Returns (mirrored, skipped)."""
    mirrored = skipped = 0
    for t in tasks:
        job = jobs.get(t.job)
        cached = job.tasks.get(t.uid) if job is not None else None
        if cached is None or cached.node_name:
            skipped += 1
            continue
        mirrored += 1
        host = t.node_name if hostname is None else hostname
        pod = node_stamped(cached.pod, host)
        bound = cached.clone_lite()
        bound.pod = pod
        bound.node_name = host
        bound.status = status = get_task_status(pod)
        priority = pod.spec.priority
        bound.priority = priority if priority is not None else 1
        bound.volume_ready = False
        if ((job.pod_group is None and job.pdb is None)
                or allocated_status(cached.status)):
            step_job(job, cached, bound)
        else:
            uid = cached.uid
            index = job.task_status_index
            bucket = index.get(cached.status)
            if bucket is not None:
                bucket.pop(uid, None)
                if not bucket:
                    del index[cached.status]
            job_tasks = job.tasks
            del job_tasks[uid]
            job_tasks[uid] = bound
            index[status][uid] = bound
            fused = moved.get(job)
            if fused is None:
                moved[job] = fused = []
            fused.append(bound)
        if not host or status in _NO_NODE:
            continue  # terminated pods hold no node resources
        group = groups.get(host)
        if group is None:
            groups[host] = group = []
            if host not in nodes:
                placeholder(host)
        group.append(bound)
        on_nodes.append(bound)
    return mirrored, skipped


def group_sums_py(tasks, group):
    """(the sum of ``group``'s requests, the sum of its Releasing ones or
    None) for one node's new tasks in the assume mirror, or None where a
    pod key is already in ``tasks`` or twice in the group, or
    ``exact_sum`` refuses a request."""
    keys = [pod_key(t.pod) for t in group]
    if len(set(keys)) < len(keys) or any(key in tasks for key in keys):
        return None
    total = exact_sum(group)
    if total is None:
        return None
    releasing = [t for t in group if t.status == TaskStatus.Releasing]
    if not releasing:
        return total, None
    return total, (total if len(releasing) == len(group)
                   else exact_sum(releasing))


def group_sums(tasks, group):
    """``group_sums_py``, its common case (no scalar resources) in C."""
    if _native_assume_group is not None:
        got = _native_assume_group(tasks, group, TaskStatus.Releasing)
        if got is False:
            return None
        if got is not None:
            cpu, mem, rel_cpu, rel_mem, n_rel = got
            return (Resource(cpu, mem),
                    Resource(rel_cpu, rel_mem) if n_rel else None)
    return group_sums_py(tasks, group)


def insert_clones_py(tasks, group):
    for t in group:
        tasks[pod_key(t.pod)] = t.clone_lite()


_NO_NODE = (TaskStatus.Succeeded, TaskStatus.Failed)
assume_walk = assume_walk_py
insert_clones = _native_assume_insert or insert_clones_py
if _native_assume_walk is not None and _native_assume_setup is not None:
    _native_assume_setup(Pod, PodSpec, _POD_FIELDS, _SPEC_FIELDS,
                         get_task_status, node_stamped,
                         int(ALLOCATED_STATUSES), _NO_NODE)
    assume_walk = _native_assume_walk
