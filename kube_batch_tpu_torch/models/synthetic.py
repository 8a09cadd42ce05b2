"""Synthetic session inputs (kube_batch_tpu/models/synthetic.py).

Builds SolverInputs directly as tensors, bypassing the object model, for
benchmarks, scale runs and tests.  ``make_synthetic_inputs`` draws the
same numbers from the same seed as the reference, so both packages see
the same cluster; the device and the float key dtype are explicit.
``make_synthetic_cache`` builds the same kind of cluster as objects,
through a SchedulerCache's normal ingestion, for whole sessions;
``make_churn_cache`` builds the eviction storm the four-action pipeline
(reclaim, tpu-allocate, backfill, preempt) runs on.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import check_float_dtype, resolve_device
from ..ops.compile_cache import bucket
from ..ops.resources import (SCORE_GRID_K, eps_vector, scalar_dims_mask,
                             score_shift_for)
from ..ops.scoring import ScoreWeights
from ..ops.solver import SolverConfig, SolverInputs


def _as_inputs(arrays: dict, dtype: torch.dtype,
               device: torch.device) -> SolverInputs:
    """numpy arrays -> SolverInputs on ``device``; float64 leaves become
    the float key dtype."""
    def conv(x):
        t = torch.as_tensor(x)
        if t.dtype == torch.float64:
            t = t.to(dtype)
        return t.to(device)
    return SolverInputs(**{k: conv(v) for k, v in arrays.items()})


def make_synthetic_inputs(n_tasks: int = 1000, n_nodes: int = 100,
                          n_jobs: int = 50, n_queues: int = 4,
                          gang_fraction: float = 0.8, seed: int = 0, *,
                          dtype: torch.dtype, device=None):
    """Random-but-plausible cluster: uniform node shapes, task requests in
    {0.25..4} cpu / {0.25..8}Gi, jobs striped over queues, minAvailable
    set for a fraction of jobs (gangs).  Returns (inputs, config)."""
    dtype = check_float_dtype(dtype)
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    r = 2
    f = np.float64

    p_pad, n_pad = bucket(n_tasks), bucket(n_nodes)
    j_pad, q_pad = bucket(n_jobs), bucket(max(n_queues, 1))

    # nodes: 16 cpu / 64Gi each (quantized units: milli-cpu, MiB)
    node_alloc = np.zeros((n_pad, r), np.int32)
    node_alloc[:n_nodes, 0] = 16000
    node_alloc[:n_nodes, 1] = 64 * 1024
    node_idle = node_alloc.copy()
    node_exists = np.zeros((n_pad,), bool)
    node_exists[:n_nodes] = True

    # tasks -> jobs in contiguous blocks
    job_of_task = np.sort(rng.integers(0, n_jobs, size=n_tasks))
    task_req = np.zeros((p_pad, r), np.int32)
    task_req[:n_tasks, 0] = rng.choice([250, 500, 1000, 2000, 4000],
                                       size=n_tasks)
    task_req[:n_tasks, 1] = (rng.choice([0.25, 0.5, 1, 2, 4, 8],
                                        size=n_tasks) * 1024).astype(np.int32)

    job_start = np.zeros((j_pad,), np.int32)
    job_count = np.zeros((j_pad,), np.int32)
    for j in range(n_jobs):
        members = np.nonzero(job_of_task == j)[0]
        job_start[j] = members[0] if members.size else 0
        job_count[j] = members.size

    job_queue = np.zeros((j_pad,), np.int32)
    job_queue[:n_jobs] = rng.integers(0, n_queues, size=n_jobs)
    job_minavail = np.full((j_pad,), -1, np.int32)
    is_gang = rng.random(n_jobs) < gang_fraction
    job_minavail[:n_jobs] = np.where(
        is_gang, np.maximum((job_count[:n_jobs] * 0.8).astype(np.int32), 1), 1)

    queue_weight = np.zeros((q_pad,), f)
    queue_weight[:n_queues] = rng.integers(1, 5, size=n_queues).astype(f)
    queue_exists = np.zeros((q_pad,), bool)
    queue_exists[:n_queues] = True

    total = node_alloc[:n_nodes].sum(axis=0, dtype=np.int64)

    request = np.zeros((q_pad, r), f)
    for j in range(n_jobs):
        request[job_queue[j]] += task_req[job_start[j]:job_start[j]
                                          + job_count[j]].sum(axis=0)
    deserved_f = _waterfill(total.astype(f), queue_weight, request,
                            queue_exists)
    deserved = np.clip(np.rint(deserved_f), 0,
                       np.iinfo(np.int32).max).astype(np.int32)

    arrays = dict(
        task_req=task_req, task_res=task_req.copy(),
        task_sig=np.zeros((p_pad,), np.int32),
        task_sorted=np.arange(p_pad, dtype=np.int32),
        task_ports=np.zeros((p_pad, 8), bool),
        task_aff_req=np.zeros((p_pad, 8), bool),
        task_anti=np.zeros((p_pad, 8), bool),
        task_match=np.zeros((p_pad, 8), bool),
        task_paff_w=np.zeros((p_pad, 8), np.int32),
        task_panti_w=np.zeros((p_pad, 8), np.int32),
        job_start=job_start, job_count=job_count, job_queue=job_queue,
        job_minavail=job_minavail,
        job_prio=np.zeros((j_pad,), f),
        job_ts=np.arange(j_pad, dtype=f),
        job_uid_rank=np.arange(j_pad, dtype=f),
        job_init_ready=np.zeros((j_pad,), np.int32),
        job_init_alloc=np.zeros((j_pad, r), np.int32),
        queue_deserved=deserved, queue_deserved_f=deserved_f,
        queue_init_alloc=np.zeros((q_pad, r), np.int32),
        queue_ts=np.arange(q_pad, dtype=f),
        queue_uid_rank=np.arange(q_pad, dtype=f),
        queue_exists=queue_exists,
        node_idle=node_idle,
        node_releasing=np.zeros((n_pad, r), np.int32),
        node_used=np.zeros((n_pad, r), np.int32),
        node_alloc=node_alloc,
        node_count=np.zeros((n_pad,), np.int32),
        node_max_tasks=np.full((n_pad,), 1 << 30, np.int32),
        node_exists=node_exists,
        node_ports=np.zeros((n_pad, 8), bool),
        node_selcnt=np.zeros((n_pad, 8), np.int32),
        sig_mask=np.ones((1, n_pad), bool) & node_exists[None, :],
        sig_bonus=np.zeros((1, n_pad), np.int32),
        total_res=total.astype(np.float64),
        eps=eps_vector(r, device="cpu").numpy(),
        scalar_dims=scalar_dims_mask(r, device="cpu").numpy(),
        score_shift=np.asarray(
            [score_shift_for(int(node_alloc[:, d].max())) for d in range(2)],
            np.int32),
        node_coords=np.full((n_pad, 8), -1, np.int32))
    return _as_inputs(arrays, dtype, device), SolverConfig()


def _waterfill(total, weight, request, active):
    """Host water-fill (proportion.go:101-154) for synthetic inputs."""
    q, r = request.shape
    deserved = np.zeros_like(request)
    remaining = total.astype(np.float64).copy()
    met = np.zeros((q,), bool)
    for _ in range(64):
        live = active & ~met
        tw = weight[live].sum()
        if tw == 0:
            break
        inc = np.zeros((r,))
        for i in np.nonzero(live)[0]:
            old = deserved[i].copy()
            deserved[i] = deserved[i] + remaining * (weight[i] / tw)
            if np.all(request[i] < deserved[i]):
                deserved[i] = np.minimum(deserved[i], request[i])
                met[i] = True
            inc += deserved[i] - old
        remaining = remaining - inc
        if np.all(remaining < 10.0):  # eps = 10 quanta on every dim
            break
    return deserved


def make_feature_inputs(seed: int = 0, *, n_nodes: int = 24,
                        dtype: torch.dtype, device=None):
    """A small session that drives every branch of the solve: host ports,
    required pod (anti-)affinity, preferred pod-affinity scoring,
    releasing capacity (pipelined placements), several signatures with a
    static score bonus, a third (scalar) resource dim, allocation and
    task counts at session open, varied priorities and tight pod caps.
    ``n_nodes`` widens the cluster (the port's kernel spreads wide ones
    over a thread-block cluster).  Returns (inputs, config) with every
    feature switched on."""
    dtype = check_float_dtype(dtype)
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    r, n_sig, width = 3, 3, 8
    n_tasks, n_jobs, n_queues = 120, 12, 3
    p_pad, n_pad = bucket(n_tasks), bucket(n_nodes)
    j_pad, q_pad = bucket(n_jobs), bucket(n_queues)
    f = np.float64

    node_alloc = np.zeros((n_pad, r), np.int32)
    node_alloc[:n_nodes, 0] = rng.choice([4000, 8000, 16000], size=n_nodes)
    node_alloc[:n_nodes, 1] = rng.choice([8192, 16384, 32768], size=n_nodes)
    node_alloc[:n_nodes, 2] = rng.choice([0, 2000, 4000], size=n_nodes)
    node_used = (node_alloc * rng.uniform(0.0, 0.6, (n_pad, 1))).astype(
        np.int32)
    node_releasing = np.zeros((n_pad, r), np.int32)
    releasing = rng.random(n_pad) < 0.4
    node_releasing[releasing] = (node_used[releasing] * 0.8).astype(np.int32)
    node_idle = node_alloc - node_used
    node_idle[releasing] = (node_idle[releasing] * 0.2).astype(np.int32)
    node_exists = np.zeros((n_pad,), bool)
    node_exists[:n_nodes] = True
    node_count = rng.integers(0, 3, size=n_pad).astype(np.int32)
    node_max_tasks = (node_count + rng.integers(1, 8, size=n_pad)).astype(
        np.int32)
    node_ports = np.zeros((n_pad, width), bool)
    node_ports[:n_nodes, :2] = rng.random((n_nodes, 2)) < 0.3
    node_selcnt = np.zeros((n_pad, width), np.int32)
    node_selcnt[:n_nodes, :3] = rng.integers(0, 2, size=(n_nodes, 3)) \
        * rng.integers(1, 3, size=(n_nodes, 3))

    job_of_task = np.sort(rng.integers(0, n_jobs, size=n_tasks))
    task_req = np.zeros((p_pad, r), np.int32)
    task_req[:n_tasks, 0] = rng.choice([250, 500, 1000, 2000], size=n_tasks)
    task_req[:n_tasks, 1] = rng.choice([256, 1024, 2048, 4096], size=n_tasks)
    task_req[:n_tasks, 2] = rng.choice([0, 0, 5, 1000], size=n_tasks)
    task_res = task_req.copy()
    task_res[:n_tasks, 0] += rng.choice([0, 0, 100], size=n_tasks)
    task_sig = np.zeros((p_pad,), np.int32)
    task_sig[:n_tasks] = rng.integers(0, n_sig, size=n_tasks)
    task_ports = np.zeros((p_pad, width), bool)
    task_ports[:n_tasks, :2] = rng.random((n_tasks, 2)) < 0.25
    task_aff_req = np.zeros((p_pad, width), bool)
    task_aff_req[:n_tasks, 0] = rng.random(n_tasks) < 0.2
    task_anti = np.zeros((p_pad, width), bool)
    task_anti[:n_tasks, 1] = rng.random(n_tasks) < 0.2
    task_match = np.zeros((p_pad, width), bool)
    task_match[:n_tasks, :3] = rng.random((n_tasks, 3)) < 0.4
    task_paff_w = np.zeros((p_pad, width), np.int32)
    task_paff_w[:n_tasks, 2] = rng.integers(0, 4, size=n_tasks)
    task_panti_w = np.zeros((p_pad, width), np.int32)
    task_panti_w[:n_tasks, 0] = rng.integers(0, 3, size=n_tasks)

    job_start = np.zeros((j_pad,), np.int32)
    job_count = np.zeros((j_pad,), np.int32)
    for j in range(n_jobs):
        members = np.nonzero(job_of_task == j)[0]
        job_start[j] = members[0] if members.size else 0
        job_count[j] = members.size
    job_queue = np.zeros((j_pad,), np.int32)
    job_queue[:n_jobs] = rng.integers(0, n_queues, size=n_jobs)
    job_minavail = np.full((j_pad,), -1, np.int32)
    job_minavail[:n_jobs] = np.maximum(
        (job_count[:n_jobs] * rng.uniform(0.2, 1.0, n_jobs)).astype(np.int32),
        1)
    job_prio = np.zeros((j_pad,), f)
    job_prio[:n_jobs] = rng.choice([0.0, 10.0, 100.0], size=n_jobs)
    job_init_ready = np.zeros((j_pad,), np.int32)
    job_init_ready[:n_jobs] = rng.integers(0, 2, size=n_jobs)
    job_init_alloc = np.zeros((j_pad, r), np.int32)
    job_init_alloc[:n_jobs] = rng.integers(0, 2, size=(n_jobs, 1)) \
        * np.asarray([1000, 2048, 0], np.int32)
    queue_init_alloc = np.zeros((q_pad, r), np.int32)
    for j in range(n_jobs):
        queue_init_alloc[job_queue[j]] += job_init_alloc[j]

    queue_weight = np.zeros((q_pad,), f)
    queue_weight[:n_queues] = rng.integers(1, 5, size=n_queues).astype(f)
    queue_exists = np.zeros((q_pad,), bool)
    queue_exists[:n_queues] = True
    total = node_alloc[:n_nodes].sum(axis=0, dtype=np.int64)
    request = np.zeros((q_pad, r), f)
    for j in range(n_jobs):
        request[job_queue[j]] += task_req[job_start[j]:job_start[j]
                                          + job_count[j]].sum(axis=0)
    deserved_f = _waterfill(total.astype(f), queue_weight, request,
                            queue_exists)
    deserved = np.clip(np.rint(deserved_f), 0,
                       np.iinfo(np.int32).max).astype(np.int32)

    sig_mask = (rng.random((n_sig, n_pad)) < 0.85) & node_exists[None, :]
    sig_bonus = np.zeros((n_sig, n_pad), np.int32)
    sig_bonus[:, :n_nodes] = rng.integers(0, 3, size=(n_sig, n_nodes)) \
        * (SCORE_GRID_K * 2)

    arrays = dict(
        task_req=task_req, task_res=task_res, task_sig=task_sig,
        task_sorted=np.arange(p_pad, dtype=np.int32),
        task_ports=task_ports, task_aff_req=task_aff_req,
        task_anti=task_anti, task_match=task_match,
        task_paff_w=task_paff_w, task_panti_w=task_panti_w,
        job_start=job_start, job_count=job_count, job_queue=job_queue,
        job_minavail=job_minavail, job_prio=job_prio,
        job_ts=rng.permutation(j_pad).astype(f),
        job_uid_rank=np.arange(j_pad, dtype=f),
        job_init_ready=job_init_ready, job_init_alloc=job_init_alloc,
        queue_deserved=deserved, queue_deserved_f=deserved_f,
        queue_init_alloc=queue_init_alloc,
        queue_ts=np.arange(q_pad, dtype=f),
        queue_uid_rank=np.arange(q_pad, dtype=f),
        queue_exists=queue_exists,
        node_idle=node_idle, node_releasing=node_releasing,
        node_used=node_used, node_alloc=node_alloc, node_count=node_count,
        node_max_tasks=node_max_tasks, node_exists=node_exists,
        node_ports=node_ports, node_selcnt=node_selcnt,
        sig_mask=sig_mask, sig_bonus=sig_bonus,
        total_res=total.astype(np.float64),
        eps=eps_vector(r, device="cpu").numpy(),
        scalar_dims=scalar_dims_mask(r, device="cpu").numpy(),
        score_shift=np.asarray(
            [score_shift_for(int(node_alloc[:, d].max())) for d in range(2)],
            np.int32),
        node_coords=np.full((n_pad, 8), -1, np.int32))
    config = SolverConfig(
        has_ports=True, has_pod_affinity=True, has_pod_affinity_score=True,
        weights=ScoreWeights(least_requested=1, most_requested=1,
                             balanced_resource=2))
    return _as_inputs(arrays, dtype, device), config


def make_synthetic_cache(n_tasks, n_nodes, n_jobs, n_queues,
                         n_signatures: int = 1):
    """SchedulerCache at kubemark scale, fed through the normal ingestion
    path — the object-model analog of make_synthetic_inputs, used by the
    end-to-end session runs (chip_smoke.py).  Returns (cache, binder).

    ``n_signatures > 1`` makes the snapshot heterogeneous: jobs carry one
    of S distinct (node-selector, tolerations, preferred-node-affinity)
    combos and every node carries a UNIQUE ``kubernetes.io/hostname``
    label plus pool/zone labels — the realistic worst case for the static
    [S, N] predicate mask."""
    from ..api import (Affinity, Container, Node, NodeSpec, NodeStatus,
                       ObjectMeta, Pod, PodSpec, PodStatus, Toleration)
    from ..api.queue_info import Queue
    from ..apis.scheduling import v1alpha1
    from ..cache import (FakeBinder, FakeEvictor, FakeStatusUpdater,
                         FakeVolumeBinder, SchedulerCache)
    from ..apis.scheduling.v1alpha1 import GroupNameAnnotationKey

    binder = FakeBinder()
    cache = SchedulerCache(binder=binder, evictor=FakeEvictor(),
                           status_updater=FakeStatusUpdater(),
                           volume_binder=FakeVolumeBinder())
    for q in range(n_queues):
        cache.add_queue(Queue(metadata=ObjectMeta(name=f"q{q}",
                                                  creation_timestamp=float(q)),
                              weight=1 + q % 4))
    alloc = {"cpu": "16", "memory": "64Gi", "pods": 110}
    hetero = n_signatures > 1
    for i in range(n_nodes):
        name = f"n{i:05d}"
        labels = ({"kubernetes.io/hostname": name, "pool": f"pool{i % 4}",
                   "zone": f"z{i % 8}"} if hetero else {})
        cache.add_node(Node(metadata=ObjectMeta(name=name, uid=f"n{i}",
                                                labels=labels),
                            spec=NodeSpec(),
                            status=NodeStatus(allocatable=dict(alloc),
                                              capacity=dict(alloc))))
    per_job = max(1, n_tasks // n_jobs)
    cpus = ["250m", "500m", "1", "2"]
    mems = ["512Mi", "1Gi", "2Gi", "4Gi"]
    for j in range(n_jobs):
        cache.add_pod_group(v1alpha1.PodGroup(
            metadata=ObjectMeta(name=f"pg{j}", namespace="bench"),
            spec=v1alpha1.PodGroupSpec(min_member=max(1, per_job * 4 // 5),
                                       queue=f"q{j % n_queues}")))

    def sig_features(s: int):
        """One of S distinct static-predicate signatures.  Selector keeps
        3/4 of pods unconstrained (placements stay dense); tolerations
        split signatures without affecting untainted nodes; preferred
        node affinity exercises the static bonus."""
        selector = {"pool": f"pool{(s // 4) % 4}"} if s % 4 == 0 else {}
        tolerations = [Toleration(key=f"grp{s}", operator="Exists")]
        affinity = Affinity(
            preferred_node_terms=[(1 + s % 10, {"zone": f"z{s % 8}"})])
        return selector, tolerations, affinity

    for i in range(n_tasks):
        j = min(i // per_job, n_jobs - 1)
        if hetero:
            selector, tolerations, affinity = sig_features(j % n_signatures)
        else:
            selector, tolerations, affinity = {}, [], None
        cache.add_pod(Pod(
            metadata=ObjectMeta(
                name=f"p{i:06d}", namespace="bench", uid=f"p{i}",
                annotations={GroupNameAnnotationKey: f"pg{j}"},
                creation_timestamp=float(i)),
            spec=PodSpec(containers=[Container(
                requests={"cpu": cpus[i % 4], "memory": mems[(i // 2) % 4]})],
                node_selector=selector, tolerations=tolerations,
                affinity=affinity),
            status=PodStatus(phase="Pending")))
    return cache, binder


def make_churn_cache(n_tasks=50_000, n_nodes=10_000, n_jobs=2_000,
                     n_queues=4, running_fraction=0.8):
    """SchedulerCache for the shipped 4-action pipeline at kubemark scale
    (kube_batch_tpu/models/synthetic.py, line for line; kube-batch's
    cross-queue e2e scenario is test/e2e/queue.go:26-70 and the preempt
    loop preempt.go:44-254):

    - every node is FULL of low-priority ("p10") Running pods, so
      allocate alone cannot place anything;
    - a high-priority ("p1000") Pending wave arrives, split between the
      occupied queues (the intra-queue preempt path) and a starved
      queue that owns no running pods (the cross-queue reclaim path,
      gated by proportion's Overused).

    Nodes are sized so running pods exactly fill CPU:
    per-node capacity = (running tasks / n_nodes) * 2 cpu.
    """
    from ..api import (Container, Node, NodeSpec, NodeStatus, ObjectMeta,
                       Pod, PodSpec, PodStatus)
    from ..api.objects import PriorityClass
    from ..api.queue_info import Queue
    from ..apis.scheduling import v1alpha1
    from ..apis.scheduling.v1alpha1 import GroupNameAnnotationKey
    from ..cache import (FakeBinder, FakeEvictor, FakeStatusUpdater,
                         FakeVolumeBinder, SchedulerCache)

    binder = FakeBinder()
    cache = SchedulerCache(binder=binder, evictor=FakeEvictor(),
                           status_updater=FakeStatusUpdater(),
                           volume_binder=FakeVolumeBinder())
    cache.add_priority_class(PriorityClass(
        metadata=ObjectMeta(name="p10"), value=10))
    cache.add_priority_class(PriorityClass(
        metadata=ObjectMeta(name="p1000"), value=1000))
    for q in range(n_queues):
        cache.add_queue(Queue(
            metadata=ObjectMeta(name=f"q{q}", creation_timestamp=float(q)),
            weight=1))

    n_running = int(n_tasks * running_fraction)
    n_pending = n_tasks - n_running
    per_node = max(1, n_running // n_nodes)
    cpu = per_node * 2          # 2 cpu per running pod fills the node
    alloc = {"cpu": str(cpu), "memory": f"{per_node * 4}Gi", "pods": 110}
    for i in range(n_nodes):
        cache.add_node(Node(
            metadata=ObjectMeta(name=f"n{i:05d}", uid=f"n{i}"),
            spec=NodeSpec(),
            status=NodeStatus(allocatable=dict(alloc),
                              capacity=dict(alloc))))

    # Low-priority running jobs live in queues q0..q{n-2}; the last
    # queue is the starved reclaimer.
    run_queues = max(1, n_queues - 1)
    per_job = max(1, n_tasks // n_jobs)
    n_run_jobs = max(1, n_running // per_job)
    for j in range(n_run_jobs):
        cache.add_pod_group(v1alpha1.PodGroup(
            metadata=ObjectMeta(name=f"low{j}", namespace="churn"),
            spec=v1alpha1.PodGroupSpec(
                min_member=1, queue=f"q{j % run_queues}",
                priority_class_name="p10")))
    for i in range(n_running):
        j = min(i // per_job, n_run_jobs - 1)
        cache.add_pod(Pod(
            metadata=ObjectMeta(
                name=f"low{i:06d}", namespace="churn", uid=f"low{i}",
                annotations={GroupNameAnnotationKey: f"low{j}"},
                creation_timestamp=float(i)),
            spec=PodSpec(
                node_name=f"n{i % n_nodes:05d}", priority=10,
                priority_class_name="p10",
                containers=[Container(requests={"cpu": "2",
                                                "memory": "2Gi"})]),
            status=PodStatus(phase="Running")))

    # High-priority pending wave: half into the occupied queues
    # (preempt), half into the starved last queue (reclaim).
    n_pend_jobs = max(2, n_pending // per_job)
    for j in range(n_pend_jobs):
        queue = (f"q{n_queues - 1}" if j % 2 == 0
                 else f"q{j % run_queues}")
        cache.add_pod_group(v1alpha1.PodGroup(
            metadata=ObjectMeta(name=f"high{j}", namespace="churn"),
            spec=v1alpha1.PodGroupSpec(
                min_member=max(1, per_job * 4 // 5), queue=queue,
                priority_class_name="p1000")))
    for i in range(n_pending):
        j = min(i // per_job, n_pend_jobs - 1)
        cache.add_pod(Pod(
            metadata=ObjectMeta(
                name=f"high{i:06d}", namespace="churn", uid=f"high{i}",
                annotations={GroupNameAnnotationKey: f"high{j}"},
                creation_timestamp=float(n_running + i)),
            spec=PodSpec(
                priority=1000, priority_class_name="p1000",
                containers=[Container(requests={"cpu": "2",
                                                "memory": "2Gi"})]),
            status=PodStatus(phase="Pending")))
    return cache, binder


class SteadyChurn:
    """The steady-state churn protocol of the reference's
    ``measure_steady_session`` (bench.py), on a cache from
    ``make_synthetic_cache``: each round ``inject`` adds ``churn`` x
    n_tasks new pending pods in fresh pod groups of ``per_group`` (min
    member 4/5 of the group, round-robin over the queues, 500m CPU and
    1 GiB each) and retires the pods and groups of two rounds before;
    ``echo`` then plays the informer, bringing every bind back as a
    Running pod on its node and every pod-group status the fake updater
    recorded back into the cache."""

    def __init__(self, cache, binder, n_tasks: int, n_queues: int,
                 churn: float = 0.01, per_group: int = 25):
        from ..api import pod_key
        self.cache = cache
        self.binder = binder
        self.n_queues = n_queues
        self.per_group = per_group
        self.k = max(1, int(n_tasks * churn))
        self.next_uid = n_tasks
        self.podmap = {pod_key(t.pod): t.pod for job in cache.jobs.values()
                       for t in job.tasks.values()}
        self.retire = []

    def inject(self, rnd: int) -> None:
        """Round ``rnd``'s new pods, then the retirement of the pods the
        round two before added (with their pod groups)."""
        from ..api import (Container, ObjectMeta, Pod, PodSpec, PodStatus,
                           pod_key)
        from ..apis.scheduling import v1alpha1
        from ..apis.scheduling.v1alpha1 import GroupNameAnnotationKey
        cache = self.cache
        new_keys, pgs = [], []
        remaining, g = self.k, 0
        while remaining > 0:
            size = min(self.per_group, remaining)
            pg_name = f"churn-{rnd}-{g}"
            pgs.append(pg_name)
            cache.add_pod_group(v1alpha1.PodGroup(
                metadata=ObjectMeta(name=pg_name, namespace="bench"),
                spec=v1alpha1.PodGroupSpec(
                    min_member=max(1, size * 4 // 5),
                    queue=f"q{g % self.n_queues}")))
            for _ in range(size):
                uid = self.next_uid
                self.next_uid += 1
                pod = Pod(
                    metadata=ObjectMeta(
                        name=f"c{uid}", namespace="bench", uid=f"c{uid}",
                        annotations={GroupNameAnnotationKey: pg_name},
                        creation_timestamp=float(uid)),
                    spec=PodSpec(containers=[Container(
                        requests={"cpu": "500m", "memory": "1Gi"})]),
                    status=PodStatus(phase="Pending"))
                self.podmap[pod_key(pod)] = pod
                new_keys.append(pod_key(pod))
                cache.add_pod(pod)
            remaining -= size
            g += 1
        if len(self.retire) >= 2:
            old_pgs, old_keys = self.retire.pop(0)
            for key in old_keys:
                pod = self.podmap.pop(key, None)
                if pod is not None:
                    cache.delete_pod(pod)
            for pg_name in old_pgs:
                cache.delete_pod_group(v1alpha1.PodGroup(
                    metadata=ObjectMeta(name=pg_name, namespace="bench"),
                    spec=v1alpha1.PodGroupSpec(min_member=1)))
        self.retire.append((pgs, new_keys))

    def echo(self) -> int:
        """Every bind back as a Running pod on its node, and every
        recorded pod-group status back into the cache; returns the binds
        echoed."""
        import dataclasses as dc

        from ..api import PodStatus
        binds = dict(self.binder.binds)
        self.binder.binds.clear()
        for key, node in binds.items():
            old = self.podmap.get(key)
            if old is None:
                continue
            new = dc.replace(old, spec=dc.replace(old.spec, node_name=node),
                             status=PodStatus(phase="Running"))
            self.podmap[key] = new
            self.cache.update_pod(old, new)
        updater = self.cache.status_updater
        if getattr(updater, "pod_groups", None):
            for pg in updater.pod_groups:
                self.cache.add_pod_group(pg)
            updater.pod_groups.clear()
        return len(binds)


def with_scalar_dims(built, r: int, seed: int = 0):
    """``built`` = (inputs, config) widened to ``r`` resource dims: the
    dims past the inputs' own are scalar resources (GPUs, hugepages,
    devices) that some nodes carry and some tasks request, drawn from
    ``seed``.  The new dims hold no allocation at session open; the
    queues' deserved shares of them split the cluster total evenly.
    Returns (inputs, config) on the inputs' device."""
    inp, cfg = built
    r0 = inp.task_req.shape[1]
    if r <= r0:
        raise ValueError(f"with_scalar_dims widens to more than {r0} dims, "
                         f"got {r}")
    rng = np.random.default_rng(seed)
    extra = r - r0
    dev = inp.node_idle.device
    fdt = inp.job_ts.dtype
    p, n = inp.task_req.shape[0], inp.node_idle.shape[0]
    j, q = inp.job_start.shape[0], inp.queue_deserved.shape[0]
    exists = inp.node_exists.cpu().numpy()
    alloc = rng.choice([0, 2000, 8000], size=(n, extra)).astype(np.int32)
    alloc[~exists] = 0
    req = rng.choice([0, 0, 0, 5, 1000, 2000], size=(p, extra)).astype(
        np.int32)
    total = alloc.sum(axis=0, dtype=np.int64)
    live = inp.queue_exists.cpu().numpy()
    des_f = np.zeros((q, extra), np.float64)
    des_f[live] = total / max(int(live.sum()), 1)
    des = np.clip(np.rint(des_f), 0, np.iinfo(np.int32).max).astype(np.int32)

    def cat(leaf, cols):
        cols = torch.as_tensor(cols).to(leaf.dtype)
        return torch.cat([leaf, cols.to(dev)], dim=1)

    zeros = np.zeros
    return inp._replace(
        task_req=cat(inp.task_req, req), task_res=cat(inp.task_res, req),
        job_init_alloc=cat(inp.job_init_alloc, zeros((j, extra), np.int32)),
        queue_deserved=cat(inp.queue_deserved, des),
        queue_deserved_f=cat(inp.queue_deserved_f, des_f),
        queue_init_alloc=cat(inp.queue_init_alloc,
                             zeros((q, extra), np.int32)),
        node_idle=cat(inp.node_idle, alloc),
        node_releasing=cat(inp.node_releasing, zeros((n, extra), np.int32)),
        node_used=cat(inp.node_used, zeros((n, extra), np.int32)),
        node_alloc=cat(inp.node_alloc, alloc),
        total_res=torch.cat([inp.total_res,
                             torch.as_tensor(total, dtype=fdt).to(dev)]),
        eps=eps_vector(r, device=dev).to(inp.eps.dtype),
        scalar_dims=scalar_dims_mask(r, device=dev)), cfg
