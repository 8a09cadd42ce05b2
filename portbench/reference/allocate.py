"""The plain allocate session: what one scheduling session must decide for
a wave of pending gangs on a cluster, written from the scheduler's stated
semantics with NumPy alone.

It follows kube-batch's allocate action under the conf

    tiers: priority, gang, conformance | drf, predicates, proportion, nodeorder

as the configuration's ``guarantees`` state it:

- queues are taken in order of their proportion share (the largest over
  cpu and memory of allocated / deserved, a float32 division), then by
  creation time, then by name; a queue retires once it is overused
  (allocated within 10 quanta of, or past, deserved on every dimension);
- in the queue, jobs are taken by priority, then those below minMember
  first, then by DRF share (allocated / cluster total, float32), then by
  creation time, then by name;
- a job places its pending tasks (by priority, creation time, name) one
  after another until it reaches minMember, then goes back to its queue
  and places one task per turn;
- a task goes to the feasible node of highest nodeorder score, the first
  by name among equals.  Feasible: the request fits the idle capacity
  (within 10 quanta) and the node holds fewer pods than its cap.  The
  score is the integer grid form of least-requested and balanced-resource
  (K = 4096, each capacity shifted below 2**10);
- the deserved shares are kube-batch's proportion water-fill over the
  queues' requests, in float64 resource units.

Scope: a cluster with nothing releasing and every gang able to reach
minMember.  A wave outside it raises ``OutOfScope``: the check then fails
loudly rather than judging by semantics this file does not model.

``share_dtype`` is the precision of the shares; the benchmark's control
runs the same session with bfloat16 shares.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

GRID_K = 1 << 12
CAP_LIMIT = 1 << 10
EPS_QUANTA = 10
NEG = -(2 ** 31) + 1
MIB = 1 << 20


class OutOfScope(ValueError):
    """The wave needs semantics this reference does not model."""


@dataclass
class Decision:
    node: np.ndarray        # [P] int64 node index per pod, -1 unbound
    node_used: np.ndarray   # [N, 2] int64 quanta after the session
    node_pods: np.ndarray   # [N] int64 pods on each node after the session
    group_bound: np.ndarray  # [G] int64 pods bound per group


def round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 (ties to even), kept as float32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def make_share(share_dtype: str):
    """share(alloc, total) per element: x/0 -> 1, 0/0 -> 0, the division
    in ``share_dtype`` ("float32" or "bfloat16")."""
    if share_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown share precision {share_dtype!r}")
    low = share_dtype == "bfloat16"

    def share(alloc, total):
        a = np.asarray(alloc, np.float32)
        t = np.asarray(total, np.float32)
        if low:
            a, t = round_bf16(a), round_bf16(t)
        with np.errstate(divide="ignore", invalid="ignore"):
            q = np.where(t == 0, np.where(a == 0, 0.0, 1.0),
                         a / np.where(t == 0, 1, t)).astype(np.float32)
        return round_bf16(q) if low else q
    return share


def water_fill(total: np.ndarray, weights: np.ndarray,
               request: np.ndarray) -> np.ndarray:
    """kube-batch proportion.go's deserved shares, in float64 units:
    rounds of remaining * weight / total weight to every queue not yet
    met; a queue whose request is below its deserved on every dimension
    is met at its request; until nothing remains (below 10 milli-CPU and
    10 MiB) or every queue is met."""
    q = len(weights)
    deserved = np.zeros((q, 2), np.float64)
    remaining = total.astype(np.float64).copy()
    met = np.zeros(q, bool)
    while True:
        live = ~met
        total_weight = float(weights[live].sum())
        if total_weight == 0:
            break
        increased = np.zeros(2)
        decreased = np.zeros(2)
        for i in np.nonzero(live)[0]:
            old = deserved[i].copy()
            deserved[i] = deserved[i] + remaining * (weights[i] / total_weight)
            if np.all(request[i] < deserved[i]):
                deserved[i] = np.minimum(deserved[i], request[i])
                met[i] = True
            diff = deserved[i] - old
            increased += np.where(diff > 0, diff, 0)
            decreased += np.where(diff > 0, 0, -diff)
        remaining = remaining - increased + decreased
        if remaining[0] < 10 and remaining[1] < 10 * MIB:
            break
    return deserved


def score_shift(cap_max: int) -> int:
    s = 0
    while (int(cap_max) >> s) >= CAP_LIMIT:
        s += 1
    return s


class _Nodes:
    """Node state and, per distinct request shape, every node's score with
    infeasible nodes at NEG.  A placement changes one node, so only that
    node's column is computed again."""

    def __init__(self, alloc, pods_cap, shapes, weights):
        self.alloc = alloc.astype(np.int64)
        self.used = np.zeros_like(self.alloc)
        self.count = np.zeros(len(alloc), np.int64)
        self.cap = pods_cap.astype(np.int64)
        self.shift = np.asarray([score_shift(alloc[:, d].max())
                                 for d in range(2)], np.int64)
        self.cs = self.alloc >> self.shift
        self.shapes = shapes.astype(np.int64)
        self.w_least, self.w_most, self.w_bal = weights
        self.score = self._scores(np.arange(len(alloc)))

    def _scores(self, idx):
        """[S, len(idx)] scores of every shape on nodes ``idx``."""
        return self._score(self.shapes[:, None, :], self.alloc[idx][None],
                           self.used[idx][None], self.cs[idx][None],
                           (self.count[idx] < self.cap[idx])[None])

    def _score(self, req, alloc, used, cs, room):
        """Scores of requests ``req`` on nodes of ``alloc``, ``used`` and
        capacity grid ``cs`` (broadcast together over the last axis of 2
        dims); ``room``: the node holds fewer pods than its cap."""
        idle = alloc - used
        fits = np.all((req < idle) | (np.abs(req - idle) < EPS_QUANTA),
                      axis=-1) & room
        xs = np.minimum((used + req) >> self.shift, cs)
        g = np.where(cs == 0, GRID_K, (xs * GRID_K) // np.maximum(cs, 1))
        gc, gm = g[..., 0], g[..., 1]
        score = (5 * self.w_least * (2 * GRID_K - gc - gm)
                 + 5 * self.w_most * (gc + gm)
                 + self.w_bal * (10 * GRID_K - 10 * np.abs(gc - gm)))
        return np.where(fits, score, NEG)

    def best(self, shape: int) -> int:
        """The feasible node of highest score, first by name; -1 if none."""
        row = self.score[shape]
        n = int(np.argmax(row))
        return -1 if row[n] == NEG else n

    def place(self, n: int, shape: int) -> None:
        self.used[n] += self.shapes[shape]
        self.count[n] += 1
        self.score[:, n] = self._score(self.shapes, self.alloc[n],
                                       self.used[n], self.cs[n],
                                       self.count[n] < self.cap[n])


def solve(cluster, wave, *, weights=(1, 0, 1),
          share_dtype: str = "float32") -> Decision:
    """The session's decision for ``wave`` (generator.Wave) on an empty
    ``cluster`` (generator.Cluster).  ``weights`` are nodeorder's
    (least-requested, most-requested, balanced-resource)."""
    share = make_share(share_dtype)
    req = wave.pod_req.astype(np.int64)
    shapes, pod_shape = np.unique(req, axis=0, return_inverse=True)
    pod_shape = pod_shape.reshape(-1)
    nodes = _Nodes(cluster.node_alloc, cluster.node_pods, shapes, weights)
    total_q = cluster.node_alloc.sum(axis=0)

    g_count = len(wave.group_names)
    q_count = len(cluster.queue_names)
    # Task order in each job: priority (all equal), creation time, name.
    order = np.lexsort((np.asarray(wave.pod_names), wave.pod_ts,
                        wave.pod_group))
    tasks_of = np.split(order, np.cumsum(np.bincount(
        wave.pod_group, minlength=g_count))[:-1])

    # Deserved shares: request per queue in units (milli-CPU, bytes).
    units = np.asarray([1, MIB], np.float64)
    job_req = np.zeros((g_count, 2), np.int64)
    np.add.at(job_req, wave.pod_group, req)
    q_req = np.zeros((q_count, 2), np.int64)
    np.add.at(q_req, wave.group_queue, job_req)
    deserved = water_fill(total_q * units, cluster.queue_weights.astype(
        np.float64), q_req * units)
    des_f = deserved / units                       # float quanta
    des_i = np.rint(des_f).astype(np.int64)

    q_rank = np.argsort(np.argsort(np.asarray(cluster.queue_names)))
    q_ts = cluster.queue_ts.astype(np.float32)
    j_rank = np.argsort(np.argsort(np.asarray(
        [f"{wave.namespace}/{g}" for g in wave.group_names])))
    j_ts = wave.group_ts.astype(np.float32)
    j_min = wave.group_min.astype(np.int64)
    j_count = np.bincount(wave.pod_group, minlength=g_count)

    q_alloc = np.zeros((q_count, 2), np.int64)
    q_active = np.ones(q_count, bool)
    j_alloc = np.zeros((g_count, 2), np.int64)
    j_ptr = np.zeros(g_count, np.int64)
    j_ready = np.zeros(g_count, np.int64)
    j_active = np.ones(g_count, bool)
    jobs_of_q = [np.nonzero(wave.group_queue == q)[0] for q in range(q_count)]
    node_of = np.full(len(req), -1, np.int64)

    while q_active.any():
        qshare = share(q_alloc, des_f).max(axis=1)
        live = np.nonzero(q_active)[0]
        q = int(live[np.lexsort((q_rank[live], q_ts[live], qshare[live]))[0]])
        overused = bool(np.all((des_i[q] < q_alloc[q])
                               | (np.abs(des_i[q] - q_alloc[q]) < EPS_QUANTA)))
        jobs = jobs_of_q[q]
        jobs = jobs[j_active[jobs]]
        if overused or jobs.size == 0:
            q_active[q] = False
            continue
        drf = share(j_alloc[jobs], total_q).max(axis=1)
        ready_key = (j_ready[jobs] >= j_min[jobs]).astype(np.float32)
        j = int(jobs[np.lexsort((j_rank[jobs], j_ts[jobs], drf,
                                 ready_key))[0]])

        placed = np.zeros(2, np.int64)
        survive = False
        while True:
            if j_ptr[j] >= j_count[j]:
                break
            t = int(tasks_of[j][j_ptr[j]])
            n = nodes.best(int(pod_shape[t]))
            if n < 0:
                raise OutOfScope(f"task {wave.pod_names[t]} fits no node")
            nodes.place(n, int(pod_shape[t]))
            node_of[t] = n
            placed += req[t]
            j_ptr[j] += 1
            j_ready[j] += 1
            remaining = j_ptr[j] < j_count[j]
            if j_ready[j] >= j_min[j] or not remaining:
                survive = j_ready[j] >= j_min[j] and remaining
                break
        j_alloc[j] += placed
        q_alloc[q] += placed
        j_active[j] = survive

    bound = np.bincount(wave.pod_group[node_of >= 0], minlength=g_count)
    if np.any((bound > 0) & (bound < j_min)):
        raise OutOfScope("a gang stopped below minMember")
    return Decision(node=node_of, node_used=nodes.used,
                    node_pods=nodes.count, group_bound=bound)
