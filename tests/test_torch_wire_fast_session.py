"""Wire-to-tensor fast path (doc/INCREMENTAL.md "Wire fast path").

The invariant everything stands on: with ``KUBE_BATCH_TPU_WIRE_FAST``
on, every layer — the columnar watch-delta decode (edge/codec,
edge/codec_k8s), the persistent candidate-row staging buffers
(models/tensor_snapshot), the vectorized drf/job-valid/gang-close walks
(models/incremental) and the recycled pack buffers (models/shipping) —
is BIT-IDENTICAL to the =0 sequential control.  On top of that: the
delta decode degrades to a counted full decode on anything surprising
(fuzzed here — a malformed frame must never introduce a failure mode the
full decode does not have), and the lineage ingest stamp rides the
frame-receipt time on both paths.

Twin of tests/test_wire_fast.py, its 9 session cases: the staging, drf
and gang walks and the recycled pack buffers under WIRE_FAST (the wire
cases are in tests/test_torch_wire_fast.py); the reference's stateless
``ship_inputs`` is a fresh shipper's full ship here, over the port's
package (kube_batch_tpu_torch/edge/, client/, cli/) on the CPU:
schedulers and runtimes are built with ``device="cpu"``.
"""

import dataclasses as dc

import numpy as np
import torch

from kube_batch_tpu_torch.actions.factory import register_default_actions
from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction
from kube_batch_tpu_torch.api import (Container, ObjectMeta, Pod, PodSpec,
                                      PodStatus, pod_key)
from kube_batch_tpu_torch.apis.scheduling import v1alpha1
from kube_batch_tpu_torch.apis.scheduling.v1alpha1 import GroupNameAnnotationKey
from kube_batch_tpu_torch.framework import close_session, open_session
from kube_batch_tpu_torch.metrics import metrics
from kube_batch_tpu_torch.models import incremental
from kube_batch_tpu_torch.models.incremental import WIRE_FAST_ENV
from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache
from kube_batch_tpu_torch.plugins.factory import register_default_plugins
from kube_batch_tpu_torch.scheduler import (DEFAULT_SCHEDULER_CONF,
                                            load_scheduler_conf)

register_default_actions(device="cpu")
register_default_plugins()


def _tiers():
    return load_scheduler_conf(DEFAULT_SCHEDULER_CONF)[1]


def _echo(cache, binder):
    podmap = {}
    for job in cache.jobs.values():
        for t in job.tasks.values():
            podmap[pod_key(t.pod)] = t.pod
    for key, node in sorted(binder.binds.items()):
        old = podmap.get(key)
        if old is None:
            continue
        new = dc.replace(old, spec=dc.replace(old.spec, node_name=node),
                         status=PodStatus(phase="Running"))
        cache.update_pod(old, new)
    binder.binds.clear()
    updater = cache.status_updater
    for pg in updater.pod_groups:
        cache.add_pod_group(pg)
    updater.pod_groups.clear()


def _add_churn_job(cache, tag, n_pods=3, min_member=1):
    pg = f"churn-{tag}"
    cache.add_pod_group(v1alpha1.PodGroup(
        metadata=ObjectMeta(name=pg, namespace="bench"),
        spec=v1alpha1.PodGroupSpec(min_member=min_member, queue="q0")))
    for i in range(n_pods):
        cache.add_pod(Pod(
            metadata=ObjectMeta(
                name=f"{pg}-{i}", namespace="bench", uid=f"{pg}-{i}",
                annotations={GroupNameAnnotationKey: pg},
                creation_timestamp=1e6 + i),
            spec=PodSpec(containers=[Container(
                requests={"cpu": "500m", "memory": "1Gi"})]),
            status=PodStatus(phase="Pending")))


def _drive_arm(fast: bool, monkeypatch, cycles=4):
    """Deterministic churn drive; returns the observable record: binds
    per cycle, events, drf shares at each open, gang conditions."""
    monkeypatch.setenv(WIRE_FAST_ENV, "1" if fast else "0")
    cache, binder = make_synthetic_cache(120, 16, 10, 2)
    action = TpuAllocateAction(device="cpu")
    record = {"binds": [], "events": None, "shares": [], "conds": []}
    for c in range(cycles):
        if c == 1:
            # A gang that can never be ready plus fresh work: exercises
            # the job_valid gate AND the gang close walk.
            _add_churn_job(cache, f"stuck-{c}", n_pods=1, min_member=99)
            _add_churn_job(cache, f"ok-{c}", n_pods=3)
        elif c > 1:
            _add_churn_job(cache, f"ok-{c}", n_pods=2)
        ssn = open_session(cache, _tiers())
        try:
            drf = ssn.plugins.get("drf")
            if drf is not None:
                record["shares"].append(
                    sorted((uid, attr.share)
                           for uid, attr in drf.job_attrs.items()))
            action.execute(ssn)
        finally:
            close_session(ssn)
        conds = []
        for uid in sorted(cache.jobs):
            job = cache.jobs[uid]
            if job.pod_group is not None:
                conds.extend(
                    (uid, cc.type, cc.status, cc.reason, cc.message)
                    for cc in job.pod_group.status.conditions)
        record["conds"].append(conds)
        record["binds"].append(tuple(sorted(binder.binds.items())))
        _echo(cache, binder)
    record["events"] = list(cache.events)
    return record


def test_session_parity_fast_vs_control(monkeypatch):
    a = _drive_arm(False, monkeypatch)
    b = _drive_arm(True, monkeypatch)
    assert a["binds"] == b["binds"]
    assert a["events"] == b["events"]
    assert a["shares"] == b["shares"]
    assert a["conds"] == b["conds"]


def test_stage_rows_scale_with_churn(monkeypatch):
    """The staging fast path must actually patch, not silently re-stage
    the world (the check_churn_ab discipline, pinned as a unit test)."""
    monkeypatch.setenv(WIRE_FAST_ENV, "1")
    cache, binder = make_synthetic_cache(200, 16, 20, 2)
    action = TpuAllocateAction(device="cpu")

    def cycle():
        ssn = open_session(cache, _tiers())
        try:
            action.execute(ssn)
        finally:
            close_session(ssn)
        _echo(cache, binder)

    cycle()           # cold: full restage
    cycle()           # settle the mass echo
    cycle()           # steady: no new work
    onwork = metrics.onwork_values()
    assert onwork["stage_rows"] >= 0, "fast staging inactive"
    assert onwork["stage_rows"] <= 200 / 2, onwork
    floors = metrics.cycle_floor_values()
    for key in ("stage", "decode", "plugin_close"):
        assert key in floors, floors


def test_control_arm_reports_stage_inactive(monkeypatch):
    monkeypatch.setenv(WIRE_FAST_ENV, "0")
    cache, binder = make_synthetic_cache(40, 8, 5, 2)
    ssn = open_session(cache, _tiers())
    try:
        TpuAllocateAction(device="cpu").execute(ssn)
    finally:
        close_session(ssn)
    assert metrics.onwork_values()["stage_rows"] == -1


def test_drf_lazy_allocated_matches_eager(monkeypatch):
    """The lazy _DrfAttr materialization equals the control arm's eager
    clone, and mutations through the event handlers stay private."""
    monkeypatch.setenv(WIRE_FAST_ENV, "1")
    cache, _binder = make_synthetic_cache(60, 8, 6, 2)
    ssn = open_session(cache, _tiers())
    try:
        drf = ssn.plugins["drf"]
        for uid, job in ssn.jobs.items():
            attr = drf.job_attrs[uid]
            expect = incremental._drf_alloc_of(job)
            assert attr.allocated == expect
            # Mutating the materialized Resource must not corrupt the
            # per-clone cache the next session will clone from.
            attr.allocated.add(attr.allocated.clone())
            assert incremental._drf_alloc_of(job) == expect
    finally:
        close_session(ssn)


def test_job_aggregates_track_session_mutations(monkeypatch):
    """A pipeline (session-only mutation) must re-dirty the row so the
    NEXT session re-reads the fresh clone instead of serving the
    close-state counts."""
    monkeypatch.setenv(WIRE_FAST_ENV, "1")
    cache, binder = make_synthetic_cache(30, 8, 3, 1)
    ssn = open_session(cache, _tiers())
    try:
        TpuAllocateAction(device="cpu").execute(ssn)
        agg = incremental.job_aggregates_close(ssn)
        assert agg is not None
        for uid in ssn.mutated_jobs:
            i = agg.index[uid]
            assert agg.epochs[i] == -1  # always-dirty stamp
            job = ssn.jobs[uid]
            assert agg.ready[i] == job.ready_task_num()
            assert agg.valid[i] == job.valid_task_num()
    finally:
        close_session(ssn)
    _echo(cache, binder)
    ssn2 = open_session(cache, _tiers())
    try:
        agg2 = incremental.job_aggregates_open(ssn2)
        for uid, job in ssn2.jobs.items():
            i = agg2.index[uid]
            assert agg2.ready[i] == job.ready_task_num(), uid
            assert agg2.valid[i] == job.valid_task_num(), uid
            assert agg2.min_avail[i] == job.min_available, uid
    finally:
        close_session(ssn2)


def test_drf_share_vector_bit_parity_on_awkward_floats(monkeypatch):
    """The vectorized f32 share must equal api.resource.share exactly,
    including the r==0 branches and non-representable f32 operands."""
    from kube_batch_tpu_torch.api import Resource, share
    monkeypatch.setenv(WIRE_FAST_ENV, "1")
    cache, _b = make_synthetic_cache(20, 4, 2, 1)
    ssn = open_session(cache, _tiers())
    try:
        drf = ssn.plugins["drf"]
        total = drf.total_resource
        for uid, attr in drf.job_attrs.items():
            alloc = incremental._drf_alloc_of(ssn.jobs[uid])
            expect = 0.0
            for rn in total.resource_names():
                s = share(alloc.get(rn), total.get(rn))
                if s > expect:
                    expect = s
            assert attr.share == expect, uid
    finally:
        close_session(ssn)
    # Direct engine check with zero totals and awkward mantissas.
    st = incremental.state_for(cache)
    st.job_agg = None

    class _FakeJob:
        def __init__(self, uid, vec):
            self.uid = uid
            self.vec = vec
            self.min_available = 1
            self.snap_epoch = None

        def ready_task_num(self):
            return 0

        def valid_task_num(self):
            return 1

    class _FakeSsn:
        pass

    fssn = _FakeSsn()
    fssn.uid = "fake-ssn"
    fssn.cache = cache
    fssn.mutated_jobs = set()
    vals = [0.1, 1 / 3, 2.0 ** -60, 7e18, 0.0]
    fssn.jobs = {}
    for i, v in enumerate(vals):
        job = _FakeJob(f"j{i}", v)
        res = Resource.empty()
        res.milli_cpu = v
        res.memory = float(i)
        job._drf_open_alloc = res
        fssn.jobs[job.uid] = job
    total = Resource.empty()
    total.milli_cpu = 0.3
    total.memory = 0.0  # exercises the x/0 -> 1 and 0/0 -> 0 branches
    agg = incremental.drf_open_shares(fssn, total)
    for i, v in enumerate(vals):
        expect = max(0.0, share(v, 0.3), share(float(i), 0.0))
        got = float(agg.shares[agg.index[f"j{i}"]])
        assert got == expect, (v, got, expect)


def test_staged_tasks_follow_fresh_clones_after_session_only_mutation(
        monkeypatch):
    """Review-pass regression: a session-only mutation (here a condition
    write routed through _dirty_job) discards the pooled clone WITHOUT
    moving truth's mod_epoch, so the next session reuses the tensor
    block at the same snap_epoch while ssn.jobs holds a FRESH clone —
    the staged TaskInfo list must follow the clone, or the apply path
    mutates objects disconnected from the session's job."""
    from kube_batch_tpu_torch.api.pod_group_info import (PodGroupCondition,
                                                         PodGroupUnschedulableType)
    from kube_batch_tpu_torch.models.tensor_snapshot import tensorize_session
    monkeypatch.setenv(WIRE_FAST_ENV, "1")
    cache, _binder = make_synthetic_cache(60, 8, 6, 2)
    ssn = open_session(cache, _tiers())
    try:
        snap = tensorize_session(ssn, torch.float64)
        assert snap.tasks
        uid = snap.tasks[0].job
        job = ssn.jobs[uid]
        assert job.pod_group is not None
        ssn.update_job_condition(job, PodGroupCondition(
            type=PodGroupUnschedulableType, status="True",
            transition_id=ssn.uid, last_transition_time=1.0,
            reason="test", message="session-only dirty"))
        assert uid in ssn.mutated_jobs
    finally:
        close_session(ssn)
    ssn2 = open_session(cache, _tiers())
    try:
        snap2 = tensorize_session(ssn2, torch.float64)
        for t in snap2.tasks:
            assert t is ssn2.jobs[t.job].tasks[t.uid], (
                f"staged TaskInfo for {t.uid} is a stale clone's object")
    finally:
        close_session(ssn2)


def test_drf_open_alloc_seeded_after_session_only_mutation_without_gang(
        monkeypatch):
    """Review-pass regression: with drf but WITHOUT gang (no close-walk
    stamping), a session-only mutation must still dirty the aggregate
    row (clone identity) so the fresh clone's _drf_open_alloc is seeded
    at OPEN — a lazy materialization walking task_status_index at EVENT
    time would double-count the just-allocated task."""
    from kube_batch_tpu_torch.api.pod_group_info import (PodGroupCondition,
                                                         PodGroupUnschedulableType)
    from kube_batch_tpu_torch.scheduler import load_scheduler_conf
    conf = DEFAULT_SCHEDULER_CONF.replace("  - name: gang\n", "")
    tiers = load_scheduler_conf(conf)[1]
    assert "gang" not in {o.name for t in tiers for o in t.plugins}
    monkeypatch.setenv(WIRE_FAST_ENV, "1")
    cache, _binder = make_synthetic_cache(60, 8, 6, 2)
    ssn = open_session(cache, tiers)
    try:
        uid = next(iter(ssn.jobs))
        job = ssn.jobs[uid]
        if job.pod_group is not None:
            ssn.update_job_condition(job, PodGroupCondition(
                type=PodGroupUnschedulableType, status="True",
                transition_id=ssn.uid, last_transition_time=1.0,
                reason="test", message="session-only dirty"))
        else:
            ssn._dirty_job(uid)
    finally:
        close_session(ssn)
    ssn2 = open_session(cache, tiers)
    try:
        drf = ssn2.plugins["drf"]
        job2 = ssn2.jobs[uid]
        # The open must have seeded the fresh clone's cache...
        assert getattr(job2, "_drf_open_alloc", None) is not None
        # ...and the lazy attr materializes the OPEN-time value even
        # after an allocate-status move (no event-time walk).
        attr = drf.job_attrs[uid]
        expect = job2._drf_open_alloc.clone()
        assert attr.allocated == expect
    finally:
        close_session(ssn2)


# ---------------------------------------------------------------------------
# 4. Shipper pack-buffer recycling
# ---------------------------------------------------------------------------

def test_pack_scratch_recycling_keeps_bit_parity(monkeypatch):
    """The reference compares with its stateless ``ship_inputs``; the
    port's stateless ship is a fresh shipper's full ship."""
    monkeypatch.setenv(WIRE_FAST_ENV, "1")
    from kube_batch_tpu_torch.models.shipping import DeviceResidentShipper
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
    inp, cfg = make_synthetic_inputs(64, 16, 8, 2, dtype=torch.float64,
                                     device="cpu")
    staged = inp._replace(**{f: np.asarray(getattr(inp, f))
                             for f in inp._fields})

    def ship_inputs(x):
        return DeviceResidentShipper(device="cpu").ship(x, cfg)

    sh = DeviceResidentShipper(device="cpu")
    sh.ship(staged, cfg)                      # full: quarantined buffer
    assert sh._scratch is None                # full ships never recycle
    dirty = staged._replace(node_used=staged.node_used.copy())
    dirty.node_used[0, 0] += 1
    out = sh.ship(dirty, cfg)                 # delta
    assert sh.last_mode == "delta"
    _assert_leaves_equal(out, ship_inputs(dirty))
    out2 = sh.ship(dirty, cfg)                # clean: flat recycled
    _assert_leaves_equal(out2, ship_inputs(dirty))
    assert sh._scratch is not None
    assert sh._scratch is not sh._state.host_flat
    dirty2 = staged._replace(node_used=staged.node_used.copy())
    dirty2.node_used[1, 0] += 2
    out3 = sh.ship(dirty2, cfg)               # delta packed into scratch
    _assert_leaves_equal(out3, ship_inputs(dirty2))
    assert sh._scratch is not sh._state.host_flat


def _assert_leaves_equal(a, b):
    for field in a._fields:
        x = np.asarray(getattr(a, field))
        y = np.asarray(getattr(b, field))
        assert x.dtype == y.dtype, field
        assert np.array_equal(x, y), field
