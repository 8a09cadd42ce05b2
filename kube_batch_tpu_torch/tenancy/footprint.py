"""Bounded begin-half read fences for eviction- and topology-led confs.

The shard pipeline's conflict fence (tenancy/pipeline.py) only lets a
micro-session stay optimistic when its retire-phase node READS are
provably disjoint from every predecessor's mutations.  tpu-allocate
publishes its own fence from its begin half (the sig-union argument:
infeasible columns are masked to -inf and can never be the argmax), but
confs led by an eviction action or the topology action had no begin
half at all — ``ssn._pipeline_fence`` stayed None, the stage defaulted
to ``reads_all``, and EVERY predecessor commit forced the sequential
rerun.  This module publishes the same kind of bound for them:

* **Eviction-led confs** (reclaim / preempt / backfill first): build
  the shared scanner NOW — the begin half runs nothing before the
  leading action, so the build is byte-identical to the one that action
  would do at attach (and under the fused session engine the build IS
  the session's one device dispatch, moved into the async window).
  Every eviction/backfill decision walks candidate nodes of some
  pending profile, and candidate sets are sig-bounded exactly like the
  allocate solve — so the fence is the sig-union over ALL candidate
  profiles (snap.tasks + the BestEffort extras), reads-all when the
  candidate enumeration can't be proved complete.

* **Topology-led confs**: the box scan's decision inputs are exactly
  the valid-coordinate nodes (membership, adjacency and boundary terms
  all require ``view.valid`` on both sides; unlabeled nodes never
  enter a box or its boundary), so the fence is the sig-union (for the
  flat actions later in the conf) OR'd with the valid-coordinate mask.

Anything unprovable degrades to reads-all — the stage then behaves
exactly as before this module existed: correct, just never optimistic
under predecessor mutations (counted via ``begin_footprint``
swallows).

Counterpart of kube_batch_tpu/tenancy/footprint.py.  The eviction-led
build and the topology tensorize run inside the session's begin half,
so on the card they run on the shard view's stream."""

from __future__ import annotations

import numpy as np
import torch

from ..metrics import metrics

# Actions whose leading position this module can bound.  The leading
# action decides the derivation; the fence must cover the WHOLE conf's
# reads, which is why every branch folds in the full candidate
# sig-union (the later flat actions' bound).
_EVICT_LEADS = frozenset({"reclaim", "preempt", "backfill"})


def publish_begin_footprint(ssn, names, device=None,
                            dtype: torch.dtype = torch.float32) -> None:
    """Publish ``ssn._pipeline_fence`` for a pipelined session whose
    leading action has no begin half.  No-op outside the shard pipeline
    and when the leading action already decided (tpu-allocate's own
    publication wins).  ``device`` and ``dtype`` are the conf's actions'
    (the scheduler registers its actions with them), so the begin-half
    build is the one the leading action would make."""
    if not getattr(ssn, "_pipeline_active", False):
        return
    if ssn._pipeline_reads_all or ssn._pipeline_fence is not None:
        return
    if not names:
        return
    first = names[0]
    try:
        if first in _EVICT_LEADS:
            _publish_evict_fence(ssn, device, dtype)
        elif first == "topo-allocate":
            _publish_topo_fence(ssn, dtype)
        else:
            ssn._pipeline_reads_all = True
    except Exception:  # lint: allow-swallow(fence derivation is an optimization gate: an unknown footprint degrades to reads-all, which only forces a sequential rerun — counted, never wrong)
        metrics.note_swallowed("begin_footprint")
        ssn._pipeline_reads_all = True


def _sig_union_fence(ssn, snap) -> bool:
    """Publish the candidate sig-union fence from a tensorized snapshot
    (tasks + BestEffort extras), or mark reads-all.  Returns True when a
    bounded fence was published.  Mirrors tpu-allocate's derivation with
    the extras folded in; the completeness proof is the tensorizer's own
    job enumeration (every live job staged => every possible candidate
    profile is represented)."""
    if len(snap.job_uids) != len(ssn.jobs):
        ssn._pipeline_reads_all = True
        return False
    tasks = list(snap.tasks) + list(snap.tasks_extra)
    if any(t.pod.spec.volumes for t in tasks):
        # Volume binds read/write global binder state outside any node
        # mask.
        ssn._pipeline_reads_all = True
        return False
    if not tasks:
        ssn._pipeline_fence = ((), None)
        return True
    sigs = np.unique(np.asarray(snap.inputs.task_sig)[:len(tasks)])
    mask = np.logical_or.reduce(
        np.asarray(snap.inputs.sig_mask)[sigs], axis=0)
    mask = mask & np.asarray(snap.inputs.node_exists)
    n = len(snap.node_names)
    ssn._pipeline_fence = (snap.node_names, mask[:n])
    return True


def _publish_evict_fence(ssn, device, dtype) -> None:
    from ..models.scanner import batch_evict_enabled, maybe_shared_scanner
    if not batch_evict_enabled():
        # The per-action scanner path re-tensorizes at each attach; a
        # begin-half build would change the control's work profile.
        ssn._pipeline_reads_all = True
        return
    scanner = maybe_shared_scanner(ssn, device, dtype)
    if scanner is None:
        ssn._pipeline_reads_all = True
        return
    _sig_union_fence(ssn, scanner.snap)


def _publish_topo_fence(ssn, dtype) -> None:
    from ..models.tensor_snapshot import tensorize_session
    from ..models.topology import (POD_LABEL, build_view, job_slice_shape,
                                   topology_enabled)
    snap = tensorize_session(ssn, dtype)
    if snap.needs_fallback:
        ssn._pipeline_reads_all = True
        return
    if not _sig_union_fence(ssn, snap):
        return
    if not topology_enabled():
        return
    slice_jobs = any(job_slice_shape(job) is not None
                     and job.queue in ssn.queues
                     for job in ssn.jobs.values())
    labeled = any(n.node is not None
                  and POD_LABEL in n.node.metadata.labels
                  for n in ssn.nodes.values())
    if not (slice_jobs and labeled):
        # The topo walk probes and exits without reading node state
        # beyond the probe; the sig-union fence already published
        # covers the rest of the conf.
        return
    names, mask = ssn._pipeline_fence
    if mask is None:
        mask = np.zeros((len(names),), bool)
    else:
        mask = mask.copy()
    view = build_view(ssn.nodes)
    index = {name: i for i, name in enumerate(names)}
    for vi, vname in enumerate(view.node_names):
        if view.valid[vi]:
            i = index.get(vname)
            if i is not None:
                mask[i] = True
    ssn._pipeline_fence = (names, mask)
