"""Per-node Running-resident index for the eviction actions
(kube_batch_tpu/models/victim_index.py, whole; numpy only).

The reference's preempt/reclaim loops walk every candidate node per
pending task and collect victim candidates by filtering the node's
residents (preempt.go:190-211, reclaim.go:115-138).  On a cluster where
a queue owns nothing (the permanently starved queue the reclaim e2e
scenario models, test/e2e/queue.go:26-70), that walk is O(tasks x nodes
x residents) of guaranteed-empty work.  This index — one pass over the
session's residents — answers "can node X possibly yield a candidate
for filter F?" so the actions skip nodes (and whole walks) that cannot
produce victims.  It is a SUPERSET filter: statement evicts during the
action only remove Running residents, so a node the index rejects has
no candidates under the action's filter, while a node it admits is
still filtered exactly as before — behavior is unchanged, only
provably-empty work is skipped (discard/restore re-adds candidates the
index still counts, keeping the superset property).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api import TaskStatus


def _rank_victim_columns(node_names: List[str], prio: List[float],
                         ts: List[float], uids: List[str],
                         node_index: Dict[str, int]
                         ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Exact int32 victim-order ranks for the batched eviction dispatch:
    reversed task order — priority ascending, creation-time descending,
    uid descending (preempt.go:213-218 via Session.victims_queue) — via
    one vectorized host lexsort over exact f64/str columns, so device
    float width can never reorder a tie; the device then only groups by
    node (ops/evict_solver.evict_batch_solve)."""
    keep = [i for i, name in enumerate(node_names) if name in node_index]
    m = len(keep)
    if m == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), [], keep
    if m != len(node_names):
        prio = [prio[i] for i in keep]
        ts = [ts[i] for i in keep]
        uids = [uids[i] for i in keep]
        node_names = [node_names[i] for i in keep]
    node_ix = np.asarray([node_index[n] for n in node_names], np.int32)
    prio_a = np.asarray(prio, np.float64)
    ts_a = np.asarray(ts, np.float64)
    order = np.lexsort((-ts_a, prio_a))
    # uid ranks (an O(M log M) string sort) are the tie-break of last
    # resort; compute them only inside actual (priority, ts) tie runs —
    # rare outside adversarial fixtures, so the common storm pays two
    # float lexsort keys and nothing else.
    op, ot = prio_a[order], ts_a[order]
    tie = (op[1:] == op[:-1]) & (ot[1:] == ot[:-1])
    if tie.any():
        order = order.tolist()
        i = 0
        while i < m - 1:
            if not tie[i]:
                i += 1
                continue
            j = i + 1
            while j < m - 1 and tie[j]:
                j += 1
            run = order[i:j + 1]
            run.sort(key=lambda k: uids[k], reverse=True)  # uid descending
            order[i:j + 1] = run
            i = j + 1
        order = np.asarray(order)
    rank = np.empty(m, np.int32)
    rank[order] = np.arange(m, dtype=np.int32)
    return node_ix, rank, uids, keep


class VictimIndex:
    """Counts of Running residents per node, by queue and by job.

    Thread discipline: a VictimIndex belongs to ONE session and is
    mutated only by that session's action thread.  The vectorized
    admissibility matrix is nevertheless ``# guarded-by: _mutex`` so the
    contract is machine-checked (graftlint rule 1, doc/LINT.md): any new
    code path touching the matrix off the documented mutation sites —
    e.g. a /debug reader or a background repair walking live sessions —
    fails ``make lint`` instead of racing silently."""

    @classmethod
    def for_session(cls, ssn):
        """The session's shared index, built on first use.  Sharing is
        exact: within one session only the eviction actions change the
        Running resident set, and every evict/restore path updates the
        index (reclaim.py on_evict; preempt.py on_evict/on_restore) —
        allocate/backfill add Pipelined/Binding residents, which the
        index deliberately does not count.  Reclaim and preempt each
        paid the full O(residents) rebuild per cycle before this."""
        idx = getattr(ssn, "_victim_index", None)
        if idx is None:
            idx = cls(ssn)
            ssn._victim_index = idx
        return idx

    def __init__(self, ssn):
        self.node_queue: Dict[str, Dict[str, int]] = {}
        self.node_job: Dict[str, Dict[str, int]] = {}
        self.node_total: Dict[str, int] = {}
        self.queue_total: Dict[str, int] = {}
        self.job_total: Dict[str, int] = {}
        self.total = 0
        # Vectorized admissibility (attach_nodes): [N, Q] count matrix
        # in the scanner's node order, so a preemptor's whole node walk
        # filters as one numpy mask instead of a per-node lambda.
        self._names = None
        self._row: Dict[str, int] = {}
        self._qcol: Dict[str, int] = {}
        self._mutex = threading.Lock()
        self._mat: Optional[np.ndarray] = None   # guarded-by: _mutex
        self._tot: Optional[np.ndarray] = None   # guarded-by: _mutex
        # Observability (tests + /metrics): how often the matrix was
        # (re)built and how many live evict/restore updates it absorbed.
        self.rebuilds = 0
        self.invalidations = 0
        self.restores = 0
        # Victim-candidate columns for the batched eviction dispatch,
        # collected in the SAME resident walk (a second O(residents)
        # pass cost more than the per-preemptor sorts it replaced).
        # Only under the engine: the sequential control pays nothing.
        from .scanner import batch_evict_enabled
        collect = batch_evict_enabled()
        self._vic_node: List[str] = []
        self._vic_prio: List[float] = []
        self._vic_ts: List[float] = []
        self._vic_uid: List[str] = []
        # Post-eviction leg detail (ops/fused_solver storm half): the
        # victim's steady resreq plus its queue/job uids, collected in
        # the same walk so the slot order is identical by construction.
        self._vic_res: List = []
        self._vic_queue: List[str] = []
        self._vic_job: List[str] = []
        jobs_get = ssn.jobs.get
        running = TaskStatus.Running
        for name, node in ssn.nodes.items():
            nq: Dict[str, int] = {}
            nj: Dict[str, int] = {}
            for t in node.tasks.values():
                if t.status is not running:
                    continue
                j = jobs_get(t.job)
                if j is None:
                    continue
                nq[j.queue] = nq.get(j.queue, 0) + 1
                nj[t.job] = nj.get(t.job, 0) + 1
                if collect:
                    self._vic_node.append(name)
                    self._vic_prio.append(t.priority)
                    self._vic_ts.append(t.pod.metadata.creation_timestamp)
                    self._vic_uid.append(t.uid)
                    self._vic_res.append(t.resreq)
                    self._vic_queue.append(j.queue)
                    self._vic_job.append(t.job)
            if nq:
                self.node_queue[name] = nq
                self.node_job[name] = nj
                n = sum(nq.values())
                self.node_total[name] = n
                self.total += n
                for q, c in nq.items():
                    self.queue_total[q] = self.queue_total.get(q, 0) + c
                for ju, c in nj.items():
                    self.job_total[ju] = self.job_total.get(ju, 0) + c

    def victim_tensors(self, node_index: Dict[str, int]
                       ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        """[M] (node row, victim-order rank, uid) of every job-backed
        Running resident, in the scanner's node order — the victim side
        of the batched eviction dispatch (residents without a session
        job can never be chosen by any victim filter, so omitting them
        is exact).  Cached per node_index identity (one ranking per
        session; the ranking is open-state by design — live evictions
        only shrink the candidate set, never reorder it)."""
        cached = getattr(self, "_vic_cache", None)
        if cached is not None and cached[0] is node_index:
            return cached[1]
        node_ix, rank, uids, keep = _rank_victim_columns(
            self._vic_node, self._vic_prio, self._vic_ts, self._vic_uid,
            node_index)
        out = (node_ix, rank, uids)
        self._vic_cache = (node_index, out, keep)
        return out

    def victim_detail(self, node_index: Dict[str, int], axis: List[str],
                      queue_index: Dict[str, int], job_index: Dict[str, int]
                      ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]]:
        """Post-eviction staging columns for the fused storm leg
        (ops/fused_solver), slot-aligned with victim_tensors(node_index):
        quantized [M, R] resreq rows plus snapshot queue/job indices
        (-1 when the snapshot axis does not carry that uid — the device
        scatter drops those updates, matching the host, whose absent
        rows cannot be in the solve universe).  None when a victim's
        quanta overflow int32 (the tensorize path falls back there too,
        so the storm leg must not be served)."""
        self.victim_tensors(node_index)
        keep = self._vic_cache[2]
        m = len(keep)
        r = max(2, len(axis))
        res = np.zeros((m, r), np.float64)
        if m:
            res[:, 0] = [self._vic_res[i].milli_cpu for i in keep]
            res[:, 1] = [self._vic_res[i].memory for i in keep]
            for d in range(2, len(axis)):
                name = axis[d]
                res[:, d] = [self._vic_res[i].scalar_resources.get(name, 0.0)
                             for i in keep]
        from ..ops.resources import quantize_columns
        res_q = quantize_columns(res)
        if res_q.size and int(res_q.max()) > np.iinfo(np.int32).max:
            return None
        qix = np.asarray([queue_index.get(self._vic_queue[i], -1)
                          for i in keep], np.int32).reshape(m)
        jix = np.asarray([job_index.get(self._vic_job[i], -1)
                          for i in keep], np.int32).reshape(m)
        return np.ascontiguousarray(res_q, dtype=np.int32), qix, jix

    # -- per-node admissibility ---------------------------------------------

    def node_for_queue(self, name: str, queue: str, exclude_job: str) -> bool:
        """Node has a Running resident in ``queue`` from another job
        (the inter-job preempt filter, preempt.go:190-199)."""
        nq = self.node_queue.get(name)
        if not nq:
            return False
        count = nq.get(queue, 0)
        if not count:
            return False
        return count > self.node_job.get(name, {}).get(exclude_job, 0)

    def node_for_job(self, name: str, job: str) -> bool:
        """Node has a Running resident of ``job`` (intra-job preempt,
        preempt.go:136-165)."""
        return self.node_job.get(name, {}).get(job, 0) > 0

    def node_for_other_queues(self, name: str, queue: str) -> bool:
        """Node has a Running resident outside ``queue`` (reclaim,
        reclaim.go:126-138)."""
        total = self.node_total.get(name, 0)
        if not total:
            return False
        return total > self.node_queue.get(name, {}).get(queue, 0)

    # -- vectorized admissibility -------------------------------------------

    def attach_nodes(self, node_names) -> None:
        """Build the [N, Q] count matrix in ``node_names`` order (the
        scanner's), enabling whole-walk masks."""
        if self._names is node_names:
            return
        self._names = node_names
        self._row = {n: i for i, n in enumerate(node_names)}
        queues = sorted(self.queue_total)
        self._qcol = {q: i for i, q in enumerate(queues)}
        mat = np.zeros((len(node_names), max(1, len(queues))), np.int32)
        tot = np.zeros((len(node_names),), np.int32)
        for name, nq in self.node_queue.items():
            r = self._row.get(name)
            if r is None:
                continue
            for q, c in nq.items():
                mat[r, self._qcol[q]] = c
            tot[r] = self.node_total.get(name, 0)
        with self._mutex:
            self._mat = mat
            self._tot = tot
        self.rebuilds += 1
        from ..metrics import metrics
        metrics.note_victim_index("rebuild")

    def queue_mask(self, queue: str, exclude_job: str):
        """bool[N] admissibility for inter-job preempt, or None when the
        vectorized form doesn't apply (no matrix, unknown queue, or the
        preemptor's own job has Running residents — then the caller
        falls back to the exact per-node check)."""
        if self._mat is None:
            return None
        col = self._qcol.get(queue)
        if col is None or self.job_total.get(exclude_job, 0):
            return None
        with self._mutex:
            return self._mat[:, col] > 0

    def other_queues_mask(self, queue: str):
        """bool[N] of nodes with a Running resident outside ``queue``
        (reclaim), or None when no matrix is attached."""
        if self._mat is None:
            return None
        col = self._qcol.get(queue)
        with self._mutex:
            mine = self._mat[:, col] if col is not None else 0
            return self._tot > mine

    # -- live updates (keep the index exact as the actions evict) -----------

    def on_evict(self, node: str, queue: str, job: str) -> None:
        """A Running resident of ``job``/``queue`` on ``node`` was
        evicted (Running -> Releasing): without this, every drained node
        keeps getting admitted and the walk degenerates back to the
        O(tasks x nodes) empty scan."""
        nq = self.node_queue.get(node)
        if nq is not None and nq.get(queue, 0) > 0:
            nq[queue] -= 1
            self.node_job[node][job] = self.node_job[node].get(job, 1) - 1
            self.node_total[node] -= 1
            self.total -= 1
            self.queue_total[queue] = self.queue_total.get(queue, 1) - 1
            self.job_total[job] = self.job_total.get(job, 1) - 1
            self.invalidations += 1
            from ..metrics import metrics
            metrics.note_victim_index("evict")
            with self._mutex:
                self._mat_delta(node, queue, -1)

    def on_restore(self, node: str, queue: str, job: str) -> None:
        """Inverse of on_evict (Statement.discard rolled the evict back)."""
        nq = self.node_queue.setdefault(node, {})
        nq[queue] = nq.get(queue, 0) + 1
        nj = self.node_job.setdefault(node, {})
        nj[job] = nj.get(job, 0) + 1
        self.node_total[node] = self.node_total.get(node, 0) + 1
        self.total += 1
        self.queue_total[queue] = self.queue_total.get(queue, 0) + 1
        self.job_total[job] = self.job_total.get(job, 0) + 1
        self.restores += 1
        from ..metrics import metrics
        metrics.note_victim_index("restore")
        with self._mutex:
            self._mat_delta(node, queue, +1)

    def _mat_delta(self, node: str, queue: str, sign: int) -> None:  # holds-lock: _mutex
        if self._mat is None:
            return
        r = self._row.get(node)
        c = self._qcol.get(queue)
        if r is None or c is None:
            return
        self._mat[r, c] += sign
        self._tot[r] += sign

    # -- whole-walk admissibility -------------------------------------------

    def any_for_queue(self, queue: str, exclude_job: str) -> bool:
        count = self.queue_total.get(queue, 0)
        return count > self.job_total.get(exclude_job, 0) if count else False

    def any_for_job(self, job: str) -> bool:
        return self.job_total.get(job, 0) > 0

    def any_for_other_queues(self, queue: str) -> bool:
        return self.total > self.queue_total.get(queue, 0)
