"""The plain storm: what the scheduling sessions of one storm cycle must
decide, written from kube-batch's stated rules with NumPy alone.

The cluster is full of Running residents; a wave of pending gangs of a
higher priority arrives; sessions of the shipped four-action conf

    actions: reclaim, tpu-allocate, backfill, preempt
    tiers:   priority, gang, conformance | drf, predicates, proportion,
             nodeorder

run one after another, and between two sessions the pods a session
evicted are deleted (their completion).  A session:

- *reclaim* (reclaim.go): queues in proportion order (share, then
  creation time, then name), each popped queue skipped while it is
  overused (deserved within 10 quanta of, or below, allocated on every
  dimension); one job per pop, in job order, and one pending task of it;
  nodes in name order, those whose pod count is below the cap and that
  hold a Running task of another queue; the victims are those tasks, in
  the node's task order, kept by ``Reclaimable``: the first tier with a
  reclaimable plugin decides (gang keeps a victim whose job stays at or
  above minMember, or whose minMember is 1; conformance keeps every pod
  outside kube-system of no system-critical class); a node whose victims
  do not cover the request is passed; else they are evicted in order
  until the request is covered and the task is pipelined there.  The
  queue goes back only when a task was pipelined;
- *tpu-allocate*, as the session's device program decides it: queues by
  their float32 proportion share, jobs by priority, then not-ready first,
  then float32 DRF share, then creation time and name; a job places its
  pending tasks (priority, creation time, name) on the feasible node of
  highest nodeorder score (the integer grid, K = 4096), first by name
  among equals, until it is ready, then one per turn; feasible: the
  request fits the idle room (within 10 quanta) and the node is below its
  pod cap; a job's allocations bind once it is ready; a task that finds
  no node ends its job's turn for the session;
- *backfill*: only BestEffort tasks, of which a storm has none
  (``OutOfScope`` if it had);
- *preempt* (preempt.go): for each queue in the order its first job
  appears, jobs with pending tasks in job order (priority, not-ready
  first, DRF share in float64, creation time, name), each under a
  statement: its tasks are popped one by one and each preempts on the
  nodes in nodeorder score order (name among equals) that hold a Running
  task of its queue and of another job; ``Preemptable``'s first tier
  decides (priority: a victim of strictly lower priority; gang and
  conformance as above); the victims are evicted lowest priority first,
  then latest created, until the request is covered, and the task is
  pipelined; the walk stops once the job is pipelined (ready plus
  pipelined tasks at least minMember).  A pipelined job's statement is
  committed, and the job goes back to its queue if a task was
  pipelined; any other statement is discarded, its evictions and
  pipelines undone in reverse.  After each queue, every job that had
  pending tasks pops one more task and preempts within its own job,
  which a storm's preemptors, holding no Running task, cannot;
- pipelined reservations end with the session; a job's allocations that
  never made it ready are dropped.

Node scores, on the integer grid, are taken as the session's programs
take them on a cluster of 64 nodes or more: tpu-allocate's on each
node's own usage (every task on it: releasing victims and pipelined
tasks counted); preempt's on the usage the eviction scanner re-derives
from the nodes when preempt attaches it, then moved by the session's
events (less each eviction, plus each pipeline, both undone by a
discard), as nodeorder's event handlers move theirs.  Proportion's and
DRF's allocations move with the same events.

It returns, per session: every victim in eviction order with its
deciding action (reclaim's, then preempt's in commit order), every bind,
each node's cpu, memory and pod count after the session (releasing
victims still counted), and each pod group's status
(phase, running, failed, succeeded) as the session derives it.

Scope: residents that are Running and of one priority below the wave's,
a wave of one priority with no Running task, no BestEffort task.
Outside it, ``OutOfScope``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .allocate import (CAP_LIMIT, EPS_QUANTA, GRID_K, MIB, make_share,
                       score_shift, water_fill)


class OutOfScope(ValueError):
    """The cycle needs semantics this reference does not model."""


@dataclass
class SessionDecision:
    victims: List[Tuple[int, str]]  # (resident index, action) in order
    node: np.ndarray                # [P] node each wave pod bound to here
    node_used: np.ndarray           # [N, 2] quanta after the session
    node_pods: np.ndarray           # [N] pods on each node after it
    groups: Dict[str, tuple] = field(default_factory=dict)


# Task statuses within a session.
PENDING, PIPELINED, ALLOCATED, BOUND, RUNNING, RELEASING, GONE = range(7)
# Statuses that hold resources as kube-batch counts them (allocated /
# ready): Running, Bound and Allocated; a releasing or pipelined task is
# not.
HOLDS = (ALLOCATED, BOUND, RUNNING)
UNITS = np.asarray([1.0, float(MIB)])   # quanta -> milli-CPU, bytes


def _le(a, b) -> bool:
    """kube-batch's Resource.LessEqual in quanta: every dimension below,
    or within 10 quanta of, the other's."""
    a = np.asarray(a)
    b = np.asarray(b)
    return bool(np.all((a < b) | (np.abs(b - a) < EPS_QUANTA)))


def _share64(alloc, total) -> float:
    """max over dimensions of alloc / total (x/0 -> 1, 0/0 -> 0), float64."""
    best = 0.0
    for a, t in zip(alloc, total):
        s = (0.0 if a == 0 else 1.0) if t == 0 else a / t
        best = max(best, s)
    return best


class _Cycle:
    """The cluster's truth across the sessions of one cycle."""

    def __init__(self, cluster, residents, wave, weights, share_dtype):
        self.c = cluster
        self.res = residents
        self.wave = wave
        self.weights = weights
        self.share32 = make_share(share_dtype)
        n = len(cluster.node_names)
        r = len(residents.names)
        p = len(wave.pod_names)
        self.n, self.r, self.p = n, r, p
        self.alloc = cluster.node_alloc.astype(np.int64)
        self.cap = cluster.node_pods.astype(np.int64)
        self.shift = np.asarray([score_shift(self.alloc[:, d].max())
                                 for d in range(2)], np.int64)
        self.cs = self.alloc >> self.shift
        if np.any(self.cs >= CAP_LIMIT):
            raise OutOfScope("a capacity past the score grid")
        q = len(cluster.queue_names)
        self.q = q
        # Tasks: residents first, then the wave's pods.
        jr = len(residents.job_names)
        self.t_job = np.concatenate([residents.job, jr + wave.pod_group])
        self.t_req = np.concatenate([residents.req, wave.pod_req]).astype(
            np.int64)
        if np.any(self.t_req.sum(axis=1) == 0):
            raise OutOfScope("a BestEffort task")
        self.t_ts = np.concatenate([residents.ts, wave.pod_ts])
        self.t_prio = np.concatenate([np.full(r, residents.priority),
                                      np.full(p, wave_priority(wave))])
        self.t_name = ([f"{residents.namespace}/{x}" for x in residents.names]
                       + [f"{wave.namespace}/{x}" for x in wave.pod_names])
        self.j_queue = np.concatenate([residents.job_queue, wave.group_queue])
        self.j_min = np.concatenate([residents.job_min, wave.group_min])
        self.j_ts = np.concatenate([residents.job_ts, wave.group_ts])
        self.j_name = ([f"{residents.namespace}/{x}"
                        for x in residents.job_names]
                       + [f"{wave.namespace}/{x}" for x in wave.group_names])
        self.j_prio = np.concatenate([
            np.full(jr, residents.priority, np.int64),
            np.full(len(wave.group_names), wave_priority(wave), np.int64)])
        if not residents.priority < wave_priority(wave):
            raise OutOfScope("residents not below the wave's priority")
        self.j_rank = np.argsort(np.argsort(np.asarray(self.j_name)))
        self.t_rank = np.argsort(np.argsort(np.asarray(self.t_name)))
        # Truth: where each task is, and whether it is still there.
        self.t_node = np.concatenate([residents.node,
                                      np.full(p, -1, np.int64)])
        self.alive = np.ones(r + p, bool)
        self.bound = np.zeros(r + p, bool)
        self.bound[:r] = True
        # Each node's tasks in the cache's order: residents first, in their
        # first order, then the pods bound to it, in bind order.
        self.on_node = [list(x) for x in residents.on_node]
        self.total_q = self.alloc.sum(axis=0)
        # Each job's tasks in task order (one priority a job: creation
        # time, then name).
        order = np.lexsort((self.t_rank, self.t_ts, self.t_job))
        counts = np.bincount(self.t_job, minlength=len(self.j_min))
        self.tasks_of = [a.tolist() for a in
                         np.split(order, np.cumsum(counts)[:-1])]
        if p and np.any(wave.pod_req != wave.pod_req[0]):
            raise OutOfScope("a wave of more than one request shape")
        self.shape = (wave.pod_req[0] if p else np.zeros(2)).astype(np.int64)

    def truth_state(self):
        live = self.alive & (self.t_node >= 0)
        used = np.zeros((self.n, 2), np.int64)
        np.add.at(used, self.t_node[live], self.t_req[live])
        pods = np.bincount(self.t_node[live], minlength=self.n)
        return used, pods.astype(np.int64)


def wave_priority(wave) -> int:
    """The wave's priority: storm_check.make_wave sets it."""
    return int(wave.priority)


class _Session:
    """One session's view: statuses, node accounting, plugin state."""

    def __init__(self, cy: _Cycle):
        self.cy = cy
        self.shape = cy.shape
        self.stmt: List[Tuple[str, int]] = []
        r, p = cy.r, cy.p
        self.status = np.full(r + p, GONE, np.int8)
        res_alive = cy.alive[:r]
        self.status[:r][res_alive] = RUNNING
        wave_alive = cy.alive[r:]
        self.status[r:][wave_alive & cy.bound[r:]] = BOUND
        self.status[r:][wave_alive & ~cy.bound[r:]] = PENDING
        self.node = cy.t_node.copy()
        self.node[self.status == GONE] = -1
        self.node[self.status == PENDING] = -1
        n = cy.n
        live = self.node >= 0
        # NodeInfo: used (every task), idle-used (every task but the
        # pipelined ones), releasing (releasing less pipelined), tasks.
        self.used = np.zeros((n, 2), np.int64)
        np.add.at(self.used, self.node[live], cy.t_req[live])
        self.idle_used = self.used.copy()
        self.releasing = np.zeros((n, 2), np.int64)
        self.ntasks = np.bincount(self.node[live], minlength=n).astype(
            np.int64)
        # nodeorder's usage, moved by the session's events.
        self.grid = self.used.copy()
        # Running residents per node and queue.
        self.run_q = np.zeros((n, cy.q), np.int64)
        run = self.status == RUNNING
        np.add.at(self.run_q, (self.node[run], cy.j_queue[cy.t_job[run]]), 1)
        # Jobs: held (Running/Bound/Allocated), pipelined, allocation.
        nj = len(cy.j_min)
        self.held = np.zeros(nj, np.int64)
        hold = np.isin(self.status, HOLDS)
        np.add.at(self.held, cy.t_job[hold], 1)
        self.piped = np.zeros(nj, np.int64)
        self.j_alloc = np.zeros((nj, 2), np.int64)
        np.add.at(self.j_alloc, cy.t_job[hold], cy.t_req[hold])
        # Proportion: allocated and requested per queue, deserved.
        self.q_alloc = np.zeros((cy.q, 2), np.int64)
        np.add.at(self.q_alloc, cy.j_queue, self.j_alloc)
        q_req = self.q_alloc.copy()
        pend = self.status == PENDING
        np.add.at(q_req, cy.j_queue[cy.t_job[pend]], cy.t_req[pend])
        self.deserved = water_fill(
            cy.total_q * UNITS, cy.c.queue_weights.astype(np.float64),
            q_req * UNITS)
        self.q_rank = np.argsort(np.argsort(np.asarray(cy.c.queue_names)))
        self.victims: List[Tuple[int, str]] = []
        self.dispatched: List[int] = []
        # Scores of the wave's shape: preempt's on nodeorder's usage,
        # tpu-allocate's on the nodes' own (NodeInfo.used: releasing
        # victims and pipelined tasks counted).
        self.score = self._scores(np.arange(n))
        self.alloc_score = self._scores(np.arange(n), self.used)

    # -- nodeorder ------------------------------------------------------
    def _scores(self, idx, usage=None):
        """Scores of the wave's request shape on nodes ``idx`` (one shape:
        the storm's pods all ask the same)."""
        cy = self.cy
        req = self.shape
        usage = self.grid if usage is None else usage
        xs = np.minimum((usage[idx] + req) >> cy.shift, cy.cs[idx])
        g = np.where(cy.cs[idx] == 0, GRID_K,
                     (xs * GRID_K) // np.maximum(cy.cs[idx], 1))
        gc, gm = g[:, 0], g[:, 1]
        wl, wm, wb = cy.weights
        return (5 * wl * (2 * GRID_K - gc - gm) + 5 * wm * (gc + gm)
                + wb * (10 * GRID_K - 10 * np.abs(gc - gm)))

    def _rescore(self, n: int) -> None:
        idx = np.asarray([n])
        self.score[n] = self._scores(idx)[0]
        self.alloc_score[n] = self._scores(idx, self.used)[0]

    # -- events -----------------------------------------------------------
    def _on_alloc(self, t: int, sign: int) -> None:
        cy = self.cy
        j = cy.t_job[t]
        self.j_alloc[j] += sign * cy.t_req[t]
        self.q_alloc[cy.j_queue[j]] += sign * cy.t_req[t]
        n = self.node[t]
        self.grid[n] += sign * cy.t_req[t]
        self._rescore(n)

    def evict(self, t: int) -> None:
        cy = self.cy
        if self.status[t] != RUNNING:
            raise OutOfScope("a victim that is not Running")
        n = self.node[t]
        self.status[t] = RELEASING
        self.releasing[n] += cy.t_req[t]
        self.run_q[n, cy.j_queue[cy.t_job[t]]] -= 1
        self.held[cy.t_job[t]] -= 1
        self._on_alloc(t, -1)

    def unevict(self, t: int) -> None:
        cy = self.cy
        n = self.node[t]
        self.status[t] = RUNNING
        self.releasing[n] -= cy.t_req[t]
        self.run_q[n, cy.j_queue[cy.t_job[t]]] += 1
        self.held[cy.t_job[t]] += 1
        self._on_alloc(t, +1)

    def pipeline(self, t: int, n: int) -> None:
        cy = self.cy
        self.status[t] = PIPELINED
        self.node[t] = n
        self.used[n] += cy.t_req[t]
        self.releasing[n] -= cy.t_req[t]
        self.ntasks[n] += 1
        self.piped[cy.t_job[t]] += 1
        self._on_alloc(t, +1)

    def unpipeline(self, t: int) -> None:
        cy = self.cy
        n = self.node[t]
        self.used[n] -= cy.t_req[t]
        self.releasing[n] += cy.t_req[t]
        self.ntasks[n] -= 1
        self.piped[cy.t_job[t]] -= 1
        self._on_alloc(t, -1)
        self.status[t] = PENDING
        self.node[t] = -1

    def allocate(self, t: int, n: int) -> None:
        cy = self.cy
        self.status[t] = ALLOCATED
        self.node[t] = n
        self.used[n] += cy.t_req[t]
        self.idle_used[n] += cy.t_req[t]
        self.ntasks[n] += 1
        j = cy.t_job[t]
        self.held[j] += 1
        self._on_alloc(t, +1)
        if self.held[j] >= cy.j_min[j]:
            for m in cy.tasks_of[j]:
                if self.status[m] == ALLOCATED:
                    self.status[m] = BOUND
                    self.dispatched.append(m)

    # -- plugins ----------------------------------------------------------
    def overused(self, q: int) -> bool:
        d = self.deserved[q]
        a = self.q_alloc[q] * UNITS
        eps = EPS_QUANTA * UNITS
        return bool(np.all((d < a) | (np.abs(a - d) < eps)))

    def q_share64(self, q: int) -> float:
        return _share64(self.q_alloc[q] * UNITS, self.deserved[q])

    def drf64(self, j: int) -> float:
        return _share64(self.j_alloc[j] * UNITS, self.cy.total_q * UNITS)

    def job_key64(self, j: int):
        cy = self.cy
        return (-int(cy.j_prio[j]), bool(self.held[j] >= cy.j_min[j]),
                self.drf64(j), float(cy.j_ts[j]), int(cy.j_rank[j]))

    def pipelined(self, j: int) -> bool:
        return self.held[j] + self.piped[j] >= self.cy.j_min[j]

    def keeps(self, t: int) -> bool:
        """gang's preemptable / reclaimable filter for one victim."""
        cy = self.cy
        j = cy.t_job[t]
        return bool(cy.j_min[j] <= self.held[j] - 1 or cy.j_min[j] == 1)

    def pending_tasks(self, j: int) -> List[int]:
        status = self.status
        return [t for t in self.cy.tasks_of[j] if status[t] == PENDING]

    def present(self) -> np.ndarray:
        """The jobs the session holds: those with a task in the cache."""
        cy = self.cy
        return np.bincount(cy.t_job[self.status != GONE],
                           minlength=len(cy.j_min)) > 0


def _reclaim(s: _Session) -> None:
    cy = s.cy
    jobs_q: Dict[int, List[int]] = {}
    tasks: Dict[int, List[int]] = {}
    for j in range(len(cy.j_min)):
        pend = s.pending_tasks(j)
        if pend:
            jobs_q.setdefault(int(cy.j_queue[j]), []).append(j)
            tasks[j] = pend
    live = sorted(set(cy.j_queue[s.present()].tolist()))
    while live:
        q = min(live, key=lambda x: (s.q_share64(x), float(cy.c.queue_ts[x]),
                                     int(s.q_rank[x])))
        live.remove(q)
        if s.overused(q):
            continue
        jobs = jobs_q.get(q)
        if not jobs:
            continue
        j = min(jobs, key=s.job_key64)
        jobs.remove(j)
        pend = tasks.get(j)
        if not pend:
            continue
        t = pend.pop(0)
        req = cy.t_req[t]
        other = s.run_q.sum(axis=1) - s.run_q[:, q]
        ok = (other > 0) & (s.ntasks < cy.cap)
        assigned = False
        for n in np.nonzero(ok)[0]:
            n = int(n)
            cands = [v for v in cy.on_node[n] if s.status[v] == RUNNING
                     and cy.j_queue[cy.t_job[v]] != q]
            victims = [v for v in cands if s.keeps(v)]
            if not victims:
                continue
            if not _le(req, cy.t_req[victims].sum(axis=0)):
                continue
            got = np.zeros(2, np.int64)
            for v in victims:
                s.evict(v)
                s.victims.append((v, "reclaim"))
                got += cy.t_req[v]
                if _le(req, got):
                    break
            if _le(req, got):
                s.pipeline(t, n)
                assigned = True
                break
        if assigned:
            live.append(q)


def _allocate(s: _Session) -> None:
    cy = s.cy
    share = cy.share32
    des_f = s.deserved / UNITS
    des_i = np.rint(des_f).astype(np.int64)
    total = cy.total_q
    if np.any(s.releasing != 0):
        raise OutOfScope("releasing room left for the allocation")
    jobs_q: Dict[int, List[int]] = {}
    for j in range(len(cy.j_min)):
        if s.pending_tasks(j):
            jobs_q.setdefault(int(cy.j_queue[j]), []).append(j)
    tasks: Dict[int, List[int]] = {}
    live = sorted(jobs_q)
    qts = cy.c.queue_ts.astype(np.float32)
    while live:
        qs = np.asarray(live)
        qshare = share(s.q_alloc[qs], des_f[qs]).max(axis=1)
        q = int(qs[np.lexsort((s.q_rank[qs], qts[qs], qshare))[0]])
        over = bool(np.all((des_i[q] < s.q_alloc[q])
                           | (np.abs(des_i[q] - s.q_alloc[q]) < EPS_QUANTA)))
        jobs = jobs_q[q]
        if over or not jobs:
            live.remove(q)
            continue
        js = np.asarray(jobs)
        drf = share(s.j_alloc[js], total).max(axis=1)
        ready = (s.held[js] >= cy.j_min[js]).astype(np.float32)
        j = int(js[np.lexsort((cy.j_rank[js], cy.j_ts[js].astype(np.float32),
                               drf, ready, -cy.j_prio[js]))[0]])
        if j not in tasks:
            tasks[j] = s.pending_tasks(j)
        pend = tasks[j]
        keep = False
        while pend:
            t = pend.pop(0)
            req = cy.t_req[t]
            idle = cy.alloc - s.idle_used
            fits = np.all((req < idle) | (np.abs(req - idle) < EPS_QUANTA),
                          axis=1) & (s.ntasks < cy.cap)
            if not fits.any():
                break
            row = np.where(fits, s.alloc_score, np.iinfo(np.int64).min)
            n = int(np.argmax(row))
            s.allocate(t, n)
            if s.held[j] >= cy.j_min[j] and pend:
                keep = True
                break
        if not keep:
            jobs.remove(j)


def _preempt_one(s: _Session, t: int, q: int) -> bool:
    cy = s.cy
    req = cy.t_req[t]
    job = cy.t_job[t]
    ok = (s.run_q[:, q] > 0) & (s.ntasks < cy.cap)
    floor = np.iinfo(np.int64).min
    while ok.any():
        n = int(np.argmax(np.where(ok, s.score, floor)))
        ok[n] = False
        cands = [v for v in cy.on_node[n] if s.status[v] == RUNNING
                 and cy.j_queue[cy.t_job[v]] == q and cy.t_job[v] != job]
        victims = [v for v in cands
                   if cy.j_prio[cy.t_job[v]] < cy.j_prio[job] and s.keeps(v)]
        if not victims or not _le(req, cy.t_req[victims].sum(axis=0)):
            continue
        # The reversed task order: lowest priority, then latest created.
        victims.sort(key=lambda v: (cy.t_prio[v], -cy.t_ts[v],
                                    -cy.t_rank[v]))
        got = np.zeros(2, np.int64)
        for v in victims:
            s.evict(v)
            s.stmt.append(("evict", v))
            got += cy.t_req[v]
            if _le(req, got):
                break
        if _le(req, got):
            s.pipeline(t, n)
            s.stmt.append(("pipeline", t))
            return True
    return False


def _preempt(s: _Session) -> None:
    cy = s.cy
    # The eviction scanner attaches here and re-derives every node the
    # session touched from the node itself: from now on preempt scores
    # on NodeInfo's usage (releasing victims and pipelined tasks
    # counted), moved by the session's events.
    s.grid = s.used.copy()
    s.score = s._scores(np.arange(cy.n))
    order = []
    for j in np.nonzero(s.present())[0]:
        q = int(cy.j_queue[j])
        if q not in order:
            order.append(q)
    jobs_q: Dict[int, List[int]] = {}
    tasks: Dict[int, List[int]] = {}
    under = []
    for j in range(len(cy.j_min)):
        pend = s.pending_tasks(j)
        if pend:
            jobs_q.setdefault(int(cy.j_queue[j]), []).append(j)
            tasks[j] = pend
            under.append(j)
    for q in order:
        jobs = jobs_q.get(q, [])
        while jobs:
            j = min(jobs, key=s.job_key64)
            jobs.remove(j)
            s.stmt = []
            assigned = False
            while tasks[j]:
                t = tasks[j].pop(0)
                if not np.any(s.run_q[:, q] > 0):
                    continue
                if _preempt_one(s, t, q):
                    assigned = True
                if s.pipelined(j):
                    break
            if s.pipelined(j):
                s.victims.extend((v, "preempt") for op, v in s.stmt
                                 if op == "evict")
                if assigned:
                    jobs.append(j)
            else:
                for op, v in reversed(s.stmt):
                    if op == "evict":
                        s.unevict(v)
                    else:
                        s.unpipeline(v)
            s.stmt = []
        # Within each job: one more task popped, and no Running task of
        # its own job to preempt.
        for j in under:
            if tasks[j]:
                if any(s.status[t] == RUNNING for t in cy.tasks_of[j]):
                    raise OutOfScope("a preemptor job with Running tasks")
                tasks[j].pop(0)


def _groups(s: _Session) -> Dict[str, tuple]:
    cy = s.cy
    out = {}
    running = np.bincount(cy.t_job[s.status == RUNNING],
                          minlength=len(cy.j_min))
    for j in np.nonzero(s.present())[0]:
        j = int(j)
        # gang marks a job that is not ready unschedulable at close.
        ready = s.held[j] >= cy.j_min[j]
        if running[j] and not ready:
            phase = "Unknown"
        else:
            phase = "Running" if ready else "Pending"
        out[cy.j_name[j]] = (phase, int(running[j]), 0, 0)
    return out


def run_session(cy: _Cycle) -> SessionDecision:
    s = _Session(cy)
    _reclaim(s)
    _allocate(s)
    _preempt(s)
    groups = _groups(s)
    node = np.full(cy.p, -1, np.int64)
    for t in s.dispatched:
        node[t - cy.r] = s.node[t]
        cy.bound[t] = True
        cy.t_node[t] = s.node[t]
        cy.on_node[s.node[t]].append(t)
    used, pods = cy.truth_state()
    return SessionDecision(victims=list(s.victims), node=node,
                           node_used=used, node_pods=pods, groups=groups)


def run_cycle(cluster, residents, wave, *, weights=(1, 0, 1),
              share_dtype: str = "float32",
              max_sessions: int = 8) -> List[SessionDecision]:
    """Every session of one storm cycle on the full ``cluster``
    (generator.Cluster) with ``residents`` (storm_check.Residents) and
    ``wave`` (generator.Wave), until a session evicts nothing and binds
    nothing, or ``max_sessions``.  Between two sessions the victims are
    deleted."""
    cy = _Cycle(cluster, residents, wave, weights, share_dtype)
    out = []
    for _ in range(max_sessions):
        d = run_session(cy)
        out.append(d)
        for v, _a in d.victims:
            cy.alive[v] = False
        if not d.victims and not np.any(d.node >= 0):
            break
    return out
