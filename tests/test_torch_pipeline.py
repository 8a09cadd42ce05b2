"""The pipelined and the sequential tpu-allocate, the JAX package against
the port, on the CPU.

Twin of tests/test_pipeline.py::TestPipelinedActionParity.
``KUBE_BATCH_TPU_PIPELINE=1`` dispatches the solve, builds the apply
scaffold while it runs and fetches afterwards; ``=0`` runs the sequential
solve (one launch, one blocking readback, no host-overlap window and no
candidate prefilter).  Both arms must bind, set statuses, record fit
deltas and account nodes exactly alike, and exactly as the JAX package
does in the same arm; only the pipelined arm may observe the
host-overlap split.  The scaffolded aggregates equal the unscaffolded
ones, the sequential readback equals the pipelined one, and tpu-allocate
answers backfill's BestEffort discovery in either arm.
"""

import dataclasses as dc

import numpy as np
import pytest

from tests.test_torch_utils import twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

MODES = {"x64": True, "f32": False}


class Churner:
    """tests/test_pipeline.py's _Churner for either package: churn pods
    in, echo binds back as Running pods."""

    def __init__(self, p, cache, binder):
        self.p, self.cache, self.binder = p, cache, binder
        self.podmap = {p.m.api.pod_key(t.pod): t.pod
                       for job in cache.jobs.values()
                       for t in job.tasks.values()}

    def echo(self):
        api = self.p.m.api
        binds = dict(self.binder.binds)
        self.binder.binds.clear()
        for key, node in binds.items():
            old = self.podmap.get(key)
            if old is None:
                continue
            new = dc.replace(old, spec=dc.replace(old.spec, node_name=node),
                             status=api.PodStatus(phase="Running"))
            self.podmap[key] = new
            self.cache.update_pod(old, new)
        updater = self.cache.status_updater
        for pg in updater.pod_groups:
            self.cache.add_pod_group(pg)
        updater.pod_groups.clear()
        return len(binds)

    def churn(self, rnd, k, requests=None):
        api, v1 = self.p.m.api, self.p.m.v1alpha1
        pg = f"churn-{rnd}"
        self.cache.add_pod_group(self.p.pod_group(pg, "t", 1, "q0"))
        for i in range(k):
            uid = 100000 + rnd * 1000 + i
            pod = api.Pod(
                metadata=api.ObjectMeta(
                    name=f"c{uid}", namespace="t", uid=f"c{uid}",
                    annotations={v1.GroupNameAnnotationKey: pg},
                    creation_timestamp=float(uid)),
                spec=api.PodSpec(containers=[api.Container(
                    requests=({"cpu": "500m", "memory": "1Gi"}
                              if requests is None else requests))]),
                status=api.PodStatus(phase="Pending"))
            self.podmap[api.pod_key(pod)] = pod
            self.cache.add_pod(pod)


def run_action_cycles(p, monkeypatch, pipeline, rounds=3):
    monkeypatch.setenv("KUBE_BATCH_TPU_PIPELINE", pipeline)
    tiers = p.tiers()
    cache, binder = p.mod.models_synthetic.make_synthetic_cache(
        300, 32, 20, 2, n_signatures=4)
    churner = Churner(p, cache, binder)
    action = p.action("tpu_allocate")
    record, events = [], []
    for rnd in range(rounds):
        if rnd:
            churner.churn(rnd, k=8)
        ssn = p.m.framework.open_session(cache, tiers)
        ssn.add_event_handler(p.mod.framework_events.EventHandler(
            allocate_func=lambda e: events.append(e.task.uid)))
        action.execute(ssn)
        statuses = {t.uid: t.status.name for job in ssn.jobs.values()
                    for t in job.tasks.values()}
        fit = {uid: {n: (r.milli_cpu, r.memory)
                     for n, r in j.nodes_fit_delta.items()}
               for uid, j in ssn.jobs.items() if j.nodes_fit_delta}
        nodes = {n.name: (round(n.idle.milli_cpu, 6),
                          round(n.idle.memory, 2),
                          round(n.used.milli_cpu, 6))
                 for n in ssn.nodes.values()}
        p.m.framework.close_session(ssn)
        record.append((dict(binder.binds), statuses, fit, nodes))
        churner.echo()
    return record, events


def test_pipeline_env_is_exported():
    from kube_batch_tpu.actions.tpu_allocate import PIPELINE_ENV as JAX_ENV
    from kube_batch_tpu_torch.actions.tpu_allocate import PIPELINE_ENV
    assert PIPELINE_ENV == JAX_ENV == "KUBE_BATCH_TPU_PIPELINE"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_same_placements_events_and_accounting(monkeypatch, mode):
    def body(p):
        totals = p.mod.metrics_metrics.overlap_split_totals
        n0 = totals()[2]
        pipelined, ev_p = run_action_cycles(p, monkeypatch, "1")
        n1 = totals()[2]
        sequential, ev_s = run_action_cycles(p, monkeypatch, "0")
        n2 = totals()[2]
        assert pipelined == sequential
        assert ev_p == ev_s
        assert n1 - n0 >= 3   # the overlap split, once per pipelined cycle
        assert n2 == n1       # ...and never on the sequential path
        return pipelined, ev_p, n1 - n0
    twin(body, x64=MODES[mode])


def test_sequential_arm_runs_no_prefilter(monkeypatch):
    """With the knob off the port's micro sessions solve the whole node
    axis: no candidate set, as the reference's ``pipelined and ...``
    guard; with it on, the micro round takes the candidate route."""
    from tests.test_torch_utils import Pkg
    p = Pkg("torch")
    seen = {}
    for arm in ("1", "0"):
        monkeypatch.setenv("KUBE_BATCH_TPU_PIPELINE", arm)
        cache, binder = p.mod.models_synthetic.make_synthetic_cache(
            300, 32, 20, 2)
        churner = Churner(p, cache, binder)
        action = p.action("tpu_allocate")
        kinds = []
        for rnd in range(4):
            if rnd:
                churner.churn(rnd, k=8)
            ssn = p.m.framework.open_session(cache, p.tiers())
            action.execute(ssn)
            p.m.framework.close_session(ssn)
            kinds.append(action.last.candidates is not None)
            churner.echo()
        seen[arm] = kinds
    assert any(seen["1"]) and not any(seen["0"])


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_scaffold_aggregates_match_unscaffolded(monkeypatch, pipeline):
    """build_apply_aggregates with the overlap-built scaffold equals the
    from-scratch build; the placement permutation computed with the
    result equals the host's stable argsort; and the sequential readback
    (best_solve_allocate -> fetch_result) equals the dispatched one."""
    monkeypatch.setenv("KUBE_BATCH_TPU_PIPELINE", pipeline)

    def body(p):
        ts = p.mod.models_tensor_snapshot
        solver, shipping = p.mod.ops_solver, p.mod.models_shipping
        cache, _ = p.mod.models_synthetic.make_synthetic_cache(
            200, 24, 10, 2)
        ssn = p.m.framework.open_session(cache, p.tiers())
        try:
            if p.pkg == "torch":
                snap = ts.tensorize_session(ssn, p.dtype)
                owner = type("Owner", (), {})()
                inputs = shipping.resident_shipper(owner, "cpu").ship(
                    snap.inputs, snap.config, p.dtype)
            else:
                snap = ts.tensorize_session(ssn)
                inputs = shipping.ship_inputs(snap.inputs)
            assert not snap.needs_fallback
            assignment, kind, order, ordered = solver.fetch_solve(
                solver.dispatch_solve(inputs, snap.config))
            placed = np.nonzero(kind > 0)[0]
            host_ordered = placed[np.argsort(order[placed], kind="stable")]
            assert np.array_equal(ordered, host_ordered)
            seq = solver.fetch_result(solver.best_solve_allocate(
                inputs, snap.config))
            for a, b in zip(seq, (assignment, kind, order)):
                assert np.array_equal(a, b)
            a = ts.build_apply_aggregates(
                snap, assignment, kind, ordered,
                scaffold=ts.prepare_apply_scaffold(snap))
            b = ts.build_apply_aggregates(snap, assignment, kind, ordered)
            assert a.node_quanta == b.node_quanta
            assert set(a.node_alloc) == set(b.node_alloc)
            assert set(a.job_sums) == set(b.job_sums)
            for name in a.node_alloc:
                assert a.node_alloc[name].milli_cpu \
                    == b.node_alloc[name].milli_cpu
            return (assignment.tolist(), kind.tolist(), ordered.tolist(),
                    sorted(a.node_quanta.items()))
        finally:
            p.m.framework.close_session(ssn)
    twin(body)


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_backfill_prescan(monkeypatch, pipeline):
    """tpu-allocate answers backfill's BestEffort discovery; backfill
    still places the BestEffort task; a steady cycle without one answers
    False."""
    monkeypatch.setenv("KUBE_BATCH_TPU_PIPELINE", pipeline)

    def body(p):
        tiers = p.tiers()
        cache, binder = p.mod.models_synthetic.make_synthetic_cache(
            100, 16, 5, 2)
        churner = Churner(p, cache, binder)
        churner.churn(0, k=1, requests={})
        action = p.action("tpu_allocate")
        ssn = p.m.framework.open_session(cache, tiers)
        action.execute(ssn)
        first = ssn.prescan.get("has_best_effort")
        p.action("backfill").execute(ssn)
        placed = sorted((t.uid, t.node_name) for job in ssn.jobs.values()
                        for t in job.tasks.values()
                        if t.uid.startswith("c") and t.node_name)
        p.m.framework.close_session(ssn)
        churner.echo()
        ssn = p.m.framework.open_session(cache, tiers)
        action.execute(ssn)
        second = ssn.prescan.get("has_best_effort")
        p.m.framework.close_session(ssn)
        return first, placed, second, dict(binder.binds)
    first, placed, second, _ = twin(body)
    assert first is True and second is False
    assert placed, "BestEffort task was not backfilled"
