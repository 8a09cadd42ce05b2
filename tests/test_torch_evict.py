"""The batched eviction engine and the batched commit, the JAX package
against the port, on the CPU.

Twins of tests/test_evict_batch.py (TestParity, TestEngineMachinery,
TestEvictionCounters) and tests/test_batch_commit.py (TestStormParity,
TestDiscardAfterPartialAccumulate, TestFlushDegradation, TestEvictMany).
Each case runs the reference test's body once per package
(tests/test_torch_utils.twin): the port's actions and scanner on the CPU.
The two packages must return the same victims in the same order, the same
binds, bind order, cache events and session end states, the same engine
counters — in both ``KUBE_BATCH_TPU_BATCH_EVICT`` and
``KUBE_BATCH_TPU_BATCH_COMMIT`` arms — and the port's results must also
pass the reference test's own assertions.  Where tpu-allocate runs in the
session, both float modes: JAX with x64 against float64 keys, and under
``jax.enable_x64(False)`` against float32.  TestBenchAB (it imports
bench.py) has no twin here; TestEdgeWire is twinned in
tests/test_torch_edge_wire.py.
"""

import os

import numpy as np
import pytest

from tests.test_torch_utils import Pkg, session_state, twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"x64": True, "f32": False}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")
    yield
    for pkg in ("jax", "torch"):
        Pkg(pkg).mod.chaos_plan.disable()


def storm_cache(p, n_nodes=3, lows_per_node=2, highs=2, high_min=2,
                starved_queue=False):
    """tests/test_evict_batch.py's _storm_cache (and, with
    ``starved_queue``, tests/test_batch_commit.py's): full nodes of
    low-priority Running pods and a high-priority Pending gang, plus a
    starved second queue for reclaim's cross-queue path."""
    cache, binder, evictor = p.empty_cache()
    cache.add_queue(p.queue("q1"))
    if starved_queue:
        cache.add_queue(p.queue("q2"))
    for i in range(n_nodes):
        cache.add_node(p.node(f"n{i}", {
            "cpu": str(2 * lows_per_node),
            "memory": f"{4 * lows_per_node}Gi", "pods": 110}))
    cache.add_pod_group(p.pod_group("low", "ns", 1, "q1"))
    cache.add_pod_group(p.pod_group("high", "ns", high_min, "q1"))
    if starved_queue:
        cache.add_pod_group(p.pod_group("starved", "ns", 1, "q2"))
    k = 0
    for i in range(n_nodes):
        for _ in range(lows_per_node):
            cache.add_pod(p.pod("ns", f"lo{k}", f"n{i}", "Running",
                                {"cpu": "2", "memory": "4Gi"}, "low",
                                priority=1, ts=float(k)))
            k += 1
    for i in range(highs):
        cache.add_pod(p.pod("ns", f"hi{i}", "", "Pending",
                            {"cpu": "2", "memory": "4Gi"}, "high",
                            priority=100, ts=float(100 + i)))
    if starved_queue:
        cache.add_pod(p.pod("ns", "starved0", "", "Pending",
                            {"cpu": "2", "memory": "4Gi"}, "starved",
                            priority=50, ts=200.0))
    for job in cache.jobs.values():
        for t in job.tasks.values():
            t.priority = (100 if t.name.startswith("hi")
                          else 50 if t.name.startswith("starved") else 1)
    if "ns/high" in cache.jobs:
        cache.jobs["ns/high"].priority = 100
    if "ns/starved" in cache.jobs:
        cache.jobs["ns/starved"].priority = 50
    cache.jobs["ns/low"].priority = 1
    return cache, binder, evictor


def run_actions(p, cache, names, trace_session=False, conf=None):
    """open_session -> the named actions -> close_session; returns the end
    state, the shared scanner's stats and the traced session's id."""
    spans = p.mod.trace_spans
    sid = spans.begin_session(test="evict-batch") if trace_session else None
    ssn = p.m.framework.open_session(cache, p.tiers(conf))
    try:
        for name in names:
            p.action(name).execute(ssn)
        state = session_state(ssn)
        scanner = getattr(ssn, "_shared_scanner", None)
        stats = dict(scanner.stats) if scanner is not None else None
    finally:
        p.m.framework.close_session(ssn)
        if trace_session:
            spans.end_session()
    return state, stats, sid


def shipped_conf():
    with open(os.path.join(REPO, "config", "kube-batch-conf.yaml")) as fh:
        return fh.read().replace('"reclaim, allocate, backfill, preempt"',
                                 '"reclaim, tpu-allocate, backfill, '
                                 'preempt"')


class TestParity:
    @staticmethod
    def _arms(monkeypatch, make, names):
        def body(p):
            res = {}
            for arm in ("0", "1"):
                monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", arm)
                cache, binder, evictor = make(p)
                state, stats, _ = run_actions(p, cache, names)
                res[arm] = (state, list(evictor.evicts), dict(binder.binds),
                            stats)
            return res
        return twin(body)

    def test_preempt_storm_parity_and_dirty_recompute(self, monkeypatch):
        res = self._arms(monkeypatch, storm_cache, ["reclaim", "preempt"])
        (state0, ev0, binds0, _), (state1, ev1, binds1, stats) = \
            res["0"], res["1"]
        assert ev1, "storm must evict"
        assert (ev1, binds1, state1) == (ev0, binds0, state0)
        assert stats["batch_dispatches"] == 1
        assert stats["dirty_rows_patched"] > 0

    def test_discard_restore_parity(self, monkeypatch):
        res = self._arms(
            monkeypatch, lambda p: storm_cache(p, high_min=3, highs=2),
            ["preempt"])
        (state0, ev0, binds0, _), (state1, ev1, binds1, _) = \
            res["0"], res["1"]
        assert ev1 == ev0 == []
        assert state1 == state0
        assert len([s for s in state1 if s[1] == "Running"]) == 6

    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_churn_pipeline_parity(self, monkeypatch, mode):
        """The shipped four-action conf on make_churn_cache."""
        def body(p):
            actions, tiers = p.load(shipped_conf())
            res = {}
            for arm in ("0", "1"):
                monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", arm)
                make = p.mod.models_synthetic.make_churn_cache
                cache, binder = make(600, 100, 30, 4)
                ssn = p.m.framework.open_session(cache, tiers)
                try:
                    for a in actions:
                        a.execute(ssn)
                    state = session_state(ssn)
                finally:
                    p.m.framework.close_session(ssn)
                res[arm] = (state, list(cache.evictor.evicts),
                            dict(binder.binds), list(cache.events))
            return res
        res = twin(body, x64=MODES[mode])
        assert res["1"][1], "churn storm must evict"
        assert res["1"] == res["0"]


class TestEngineMachinery:
    def test_one_batch_dispatch_per_session(self, monkeypatch):
        monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", "1")

        def body(p):
            cache, _, _ = storm_cache(p)
            _, stats, sid = run_actions(
                p, cache, ["reclaim", "backfill", "preempt"],
                trace_session=True)
            tr = p.mod.trace.flight_recorder.get(sid)
            names = [s.name for s in tr.spans]
            return stats, names.count("evict.batch_solve"), \
                names.count("evict.recompute")
        stats, batch_spans, rec = twin(body)
        assert stats["batch_dispatches"] == 1
        assert batch_spans == 1
        assert (rec == 0) == (stats["refresh_rows"] == 0)
        assert rec <= stats["refreshes"]

    def test_seeded_rows_equal_numpy_engine(self, monkeypatch):
        monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", "1")
        # The JAX package's fused program parks the seeded rows until the
        # first consumer; its FUSED=0 arm (the port's, ROADMAP queue 1
        # item 4) seeds them at build, so both packages have rows to
        # compare.
        monkeypatch.setenv("KUBE_BATCH_TPU_FUSED", "0")

        def body(p):
            cache, _, _ = storm_cache(p, n_nodes=4, lows_per_node=3,
                                      highs=3)
            ssn = p.m.framework.open_session(cache, p.tiers())
            try:
                scanner = p.scanner(ssn, shared=True)
                assert scanner is not None and scanner._batched
                rows = []
                n = len(scanner.snap.tasks) + len(scanner.snap.tasks_extra)
                for key, (row, _pos) in list(scanner._score_cache.items()):
                    ti = next(i for i in range(n)
                              if scanner._profile_key(i) == key)
                    assert np.array_equal(row, scanner._scores_numpy(ti))
                    rows.append(row.tolist())
                return scanner.stats["seeded_profiles"], rows
            finally:
                p.m.framework.close_session(ssn)
        seeded, rows = twin(body)
        assert seeded >= 1 and rows

    def test_scalar_patch_scorer_matches_numpy(self, monkeypatch):
        monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", "1")

        def body(p):
            cache, _, _ = storm_cache(p, n_nodes=5, lows_per_node=2,
                                      highs=2)
            ssn = p.m.framework.open_session(cache, p.tiers())
            try:
                scanner = p.scanner(ssn, shared=True)
                rng = np.random.RandomState(7)
                n = len(scanner.snap.node_names)
                r = scanner.r
                scanner.dyn[:n, :r] = rng.randint(0, 50_000, size=(n, r))
                scanner.dyn[:n, r] = rng.randint(0, 5, size=n)
                out = []
                for ti in range(len(scanner.snap.tasks)):
                    expect = scanner._scores_numpy(ti)
                    got = scanner._score_rows_py(ti, list(range(n)))
                    assert np.array_equal(np.asarray(got), expect[:n])
                    out.append(got)
                return out
            finally:
                p.m.framework.close_session(ssn)
        assert twin(body)

    def test_victim_rank_matches_queue_order_with_ties(self, monkeypatch):
        monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", "1")
        specs = [("a", 1, 0.0), ("b", 1, 0.0), ("c", 1, 0.0),
                 ("d", 5, 0.0), ("e", 1, 2.0)]

        def body(p):
            cache, _, _ = p.empty_cache()
            cache.add_queue(p.queue("q1"))
            cache.add_node(p.node("n0", {"cpu": "16", "memory": "32Gi",
                                         "pods": 110}))
            cache.add_pod_group(p.pod_group("low", "ns", 1, "q1"))
            cache.add_pod_group(p.pod_group("high", "ns", 1, "q1"))
            for name, prio, ts in specs:
                cache.add_pod(p.pod("ns", name, "n0", "Running",
                                    {"cpu": "1", "memory": "1Gi"}, "low",
                                    priority=prio, ts=ts))
            cache.add_pod(p.pod("ns", "hi", "", "Pending",
                                {"cpu": "1", "memory": "1Gi"}, "high",
                                priority=100, ts=9.0))
            prios = {n: pr for n, pr, _ in specs}
            for job in cache.jobs.values():
                for t in job.tasks.values():
                    t.priority = 100 if t.name == "hi" else \
                        prios.get(t.name, 1)
            ssn = p.m.framework.open_session(cache, p.tiers())
            try:
                scanner = p.scanner(ssn, shared=True)
                assert scanner.victim_rank
                victims = [t for t in ssn.jobs["ns/low"].tasks.values()
                           if t.status is p.m.api.TaskStatus.Running]
                queue = ssn.victims_queue(list(victims))
                want = []
                while not queue.empty():
                    want.append(queue.pop().uid)
                got = [t.uid for t in sorted(
                    victims, key=lambda t: scanner.victim_rank[t.uid])]
                return got, want, dict(scanner.victim_rank)
            finally:
                p.m.framework.close_session(ssn)
        got, want, _ = twin(body)
        assert got == want

    def test_victim_rank_gated_on_task_order_ENABLEMENT(self, monkeypatch):
        def body(p):
            conf = p.m.scheduler.DEFAULT_SCHEDULER_CONF.replace(
                "- name: priority",
                "- name: priority\n    enableTaskOrder: false")
            assert "enableTaskOrder" in conf
            res = {}
            for arm in ("0", "1"):
                monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", arm)
                cache, binder, evictor = storm_cache(p)
                ssn = p.m.framework.open_session(cache, p.tiers(conf))
                try:
                    if arm == "1":
                        scanner = p.scanner(ssn, shared=True)
                        assert scanner is not None
                        assert scanner.victim_rank is None
                    p.action("preempt").execute(ssn)
                    state = session_state(ssn)
                finally:
                    p.m.framework.close_session(ssn)
                res[arm] = (state, list(evictor.evicts), dict(binder.binds))
            return res
        res = twin(body)
        assert res["1"][1], "storm must still evict"
        assert res["1"] == res["0"]

    def test_refresh_equals_fresh_tensorize(self, monkeypatch):
        def body(p):
            monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", "1")
            cache, _, evictor = storm_cache(p)
            cache.add_pod_group(p.pod_group("whale", "ns", 1, "q1"))
            cache.add_pod(p.pod("ns", "whale0", "", "Pending",
                                {"cpu": "999", "memory": "999Gi"}, "whale",
                                priority=1, ts=50.0))
            ssn = p.m.framework.open_session(cache, p.tiers())
            try:
                shared = p.scanner(ssn, shared=True)
                p.action("preempt").execute(ssn)
                assert evictor.evicts
                assert p.scanner(ssn, shared=True) is shared
                monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", "0")
                fresh = p.scanner(ssn)
                assert fresh is not None and fresh is not shared
                n, r = len(shared.snap.node_names), shared.r
                assert np.array_equal(shared.dyn[:n, :r + 1],
                                      fresh.dyn[:n, :r + 1])
                return shared.dyn[:n].tolist(), list(evictor.evicts)
            finally:
                p.m.framework.close_session(ssn)
        twin(body)


class TestEvictionCounters:
    def test_per_action_counters_and_debug_summary(self, monkeypatch):
        monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", "1")

        def body(p):
            metrics = p.mod.metrics_metrics
            before = metrics.evictions_by_action()
            cache, _, evictor = storm_cache(p)
            _, _, sid = run_actions(p, cache, ["reclaim", "preempt"],
                                    trace_session=True)
            after = metrics.evictions_by_action()
            # The counters are process-wide: an action label that an
            # earlier test in this process counted shows up with a zero
            # delta, so only the labels this session moved are compared.
            delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
            delta = {k: v for k, v in delta.items() if v}
            summary = next(s for s in p.mod.trace.flight_recorder.summaries()
                           if s["session"] == sid)
            return delta, len(evictor.evicts), summary["evictions"]
        delta, n_evicts, summarized = twin(body)
        assert sum(delta.values()) == n_evicts > 0
        assert delta.get("preempt", 0) > 0
        assert summarized == delta

    def test_victim_index_counters(self, monkeypatch):
        monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", "1")

        def body(p):
            cache, _, evictor = storm_cache(p)
            ssn = p.m.framework.open_session(cache, p.tiers())
            try:
                p.action("preempt").execute(ssn)
                vindex = p.mod.models_victim_index.VictimIndex.for_session(
                    ssn)
                return (list(evictor.evicts), vindex.invalidations,
                        vindex.rebuilds, vindex.restores)
            finally:
                p.m.framework.close_session(ssn)
        evicts, invalidations, rebuilds, _ = twin(body)
        assert evicts and invalidations >= len(evicts) and rebuilds >= 1


# --- tests/test_batch_commit.py ---------------------------------------------

STORM_ACTIONS = ["reclaim", "tpu_allocate", "backfill", "preempt"]


def run_storm(p, cache, cycles=2):
    tiers = p.tiers()
    actions = [p.action(name) for name in STORM_ACTIONS]
    states = []
    for _ in range(cycles):
        ssn = p.m.framework.open_session(cache, tiers)
        try:
            for a in actions:
                a.execute(ssn)
            states.append(session_state(ssn))
        finally:
            p.m.framework.close_session(ssn)
    return states


def lineage_evicted(p):
    out = {}
    for rec in p.mod.trace_lineage.lineage.dump().get("pods") or []:
        evs = [(s["stage"], s.get("detail"))
               for s in rec["stages"] if s["stage"] == "evicted"]
        if evs:
            out[rec["pod"]] = evs
    return out


def commit_env(p):
    return p.mod.framework_commit.BATCH_COMMIT_ENV


class TestStormParity:
    @staticmethod
    def _arms(monkeypatch, x64=True, cycles=2, lineage=False):
        def body(p):
            res = {}
            for arm in ("0", "1"):
                monkeypatch.setenv(commit_env(p), arm)
                if lineage:
                    monkeypatch.setenv("KUBE_BATCH_TPU_LINEAGE", "1")
                    p.mod.trace_lineage.lineage.refresh()
                cache, binder, evictor = storm_cache(p, starved_queue=True)
                states = run_storm(p, cache, cycles=cycles)
                res[arm] = dict(
                    states=states, victims=list(evictor.evicts),
                    binds=dict(binder.binds), bind_order=list(binder.channel),
                    events=list(cache.events),
                    lineage=lineage_evicted(p) if lineage else None)
            return res
        return twin(body, x64=x64)

    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_multi_cycle_storm_bit_parity(self, monkeypatch, mode):
        res = self._arms(monkeypatch, x64=MODES[mode])
        assert res["1"] == res["0"]
        assert res["0"]["victims"], "storm evicted nothing (vacuous)"

    def test_lineage_samples_identical(self, monkeypatch):
        res = self._arms(monkeypatch, cycles=1, lineage=True)
        assert res["1"]["lineage"] == res["0"]["lineage"]
        assert res["1"]["victims"] == res["0"]["victims"]

    def test_batched_arm_actually_flushed(self, monkeypatch):
        def body(p):
            monkeypatch.setenv(commit_env(p), "1")
            counts = p.mod.metrics_metrics.commit_flush_counts
            before = counts()
            cache, _, evictor = storm_cache(p, starved_queue=True)
            run_storm(p, cache, cycles=1)
            after = counts()
            delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
            return list(evictor.evicts), sum(
                v for k, v in delta.items() if k.endswith("/batched"))
        evicts, batched = twin(body)
        assert evicts and batched >= 1

    def test_sessions_meta_surfaces_flushes(self, monkeypatch):
        def body(p):
            monkeypatch.setenv(commit_env(p), "1")
            cache, _, evictor = storm_cache(p, starved_queue=True)
            spans = p.mod.trace_spans
            sid = spans.begin_session(test="batch-commit")
            ssn = p.m.framework.open_session(cache, p.tiers())
            try:
                for name in STORM_ACTIONS:
                    p.action(name).execute(ssn)
            finally:
                p.m.framework.close_session(ssn)
                spans.end_session()
            summary = next(s for s in p.mod.trace.flight_recorder.summaries()
                           if s["session"] == sid)
            return (len(evictor.evicts), summary["evictions"],
                    summary["commit_flushes"])
        n_evicts, evictions, flushes = twin(body)
        assert sum(evictions.values()) == n_evicts
        assert sum(flushes.values()) == n_evicts


class TestDiscardAfterPartialAccumulate:
    def test_statement_discard_restores_exactly(self, monkeypatch):
        def body(p):
            monkeypatch.setenv(commit_env(p), "1")
            cache, _, evictor = storm_cache(p, starved_queue=True)
            ssn = p.m.framework.open_session(cache, p.tiers())
            try:
                baseline = session_state(ssn)
                with p.mod.framework_commit.action_commit(
                        ssn, "preempt") as sink:
                    stmt = ssn.statement()
                    victims = [t for job in ssn.jobs.values()
                               for t in job.tasks.values()
                               if t.status == p.m.api.TaskStatus.Running][:3]
                    assert len(victims) == 3
                    for v in victims:
                        stmt.evict(v, "preempt")
                    mid = session_state(ssn)
                    stmt.discard()
                    assert session_state(ssn) == baseline != mid
                    assert sink.evicts == []
            finally:
                p.m.framework.close_session(ssn)
            assert evictor.evicts == []
            assert not any(e[0] == "Evict" for e in cache.events)
            return mid, list(cache.events)
        twin(body)

    def test_commit_then_discard_flushes_only_committed(self, monkeypatch):
        def body(p):
            monkeypatch.setenv(commit_env(p), "1")
            cache, _, evictor = storm_cache(p, starved_queue=True)
            ssn = p.m.framework.open_session(cache, p.tiers())
            try:
                running = [t for job in ssn.jobs.values()
                           for t in job.tasks.values()
                           if t.status == p.m.api.TaskStatus.Running]
                with p.mod.framework_commit.action_commit(ssn, "preempt"):
                    stmt = ssn.statement()
                    stmt.evict(running[0], "preempt")
                    stmt.evict(running[1], "preempt")
                    stmt.commit()
                    stmt2 = ssn.statement()
                    stmt2.evict(running[2], "preempt")
                    stmt2.discard()
                    assert evictor.evicts == []
            finally:
                p.m.framework.close_session(ssn)
            key = p.m.api.pod_key
            assert evictor.evicts == [key(running[0].pod),
                                      key(running[1].pod)]
            return list(evictor.evicts), list(cache.events)
        twin(body)


class TestFlushDegradation:
    """The ``commit.flush_error`` chaos site: a mid-batch bulk-egress
    abort degrades the remainder to the per-task path, with no effect
    dropped or double-applied.  No breaker is fed on this path."""

    @staticmethod
    def _chaos(p, sites, rate=1.0, budget=None):
        plan = p.mod.chaos_plan
        plan.install(plan.FaultPlan(seed=7, rate=rate, sites=sites,
                                    budget=budget))

    def test_flush_error_degrades_without_drop_or_dup(self, monkeypatch):
        def body(p):
            monkeypatch.setenv(commit_env(p), "1")
            counts = p.mod.metrics_metrics.commit_flush_counts
            before = counts()
            self._chaos(p, ("commit.flush_error",), budget=1)
            cache, _, evictor = storm_cache(p, starved_queue=True)
            states = run_storm(p, cache, cycles=1)
            p.mod.chaos_plan.disable()
            monkeypatch.setenv(commit_env(p), "0")
            cache2, _, evictor2 = storm_cache(p, starved_queue=True)
            states2 = run_storm(p, cache2, cycles=1)
            assert list(evictor.evicts) == list(evictor2.evicts)
            assert states == states2
            evict_events = [e for e in cache.events if e[0] == "Evict"]
            assert len(evict_events) == len(evictor.evicts)
            after = counts()
            delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
            degraded = sum(v for k, v in delta.items()
                           if k.endswith("/degraded"))
            return list(evictor.evicts), states, list(cache.events), degraded
        assert twin(body)[3] >= 1

    def test_evict_error_on_retry_restores_session(self, monkeypatch):
        def body(p):
            monkeypatch.setenv(commit_env(p), "1")
            cache, _, evictor = storm_cache(p, starved_queue=True)
            ssn = p.m.framework.open_session(cache, p.tiers())
            try:
                baseline = session_state(ssn)
                victim = next(t for job in ssn.jobs.values()
                              for t in job.tasks.values()
                              if t.status == p.m.api.TaskStatus.Running)
                self._chaos(p, ("commit.flush_error", "evict.error"))
                with p.mod.framework_commit.action_commit(ssn, "preempt"):
                    stmt = ssn.statement()
                    stmt.evict(victim, "preempt")
                    stmt.commit()
                p.mod.chaos_plan.disable()
                assert session_state(ssn) == baseline
                assert evictor.evicts == []
                with cache.mutex:
                    assert len(cache.err_tasks) == 1
                return baseline, [t.uid for t in cache.err_tasks]
            finally:
                p.m.framework.close_session(ssn)
        twin(body)


class TestEvictMany:
    def test_bulk_evict_mirrors_truth_in_order(self):
        def body(p):
            cache, _, evictor = storm_cache(p, starved_queue=True)
            ssn = p.m.framework.open_session(cache, p.tiers())
            try:
                victims = [t for job in ssn.jobs.values()
                           for t in job.tasks.values()
                           if t.status == p.m.api.TaskStatus.Running][:4]
                epoch0 = cache.epoch
                assert cache.evict_many(
                    [(v, "preempt") for v in victims]) == []
                key = p.m.api.pod_key
                assert evictor.evicts == [key(v.pod) for v in victims]
                evict_events = [e for e in cache.events if e[0] == "Evict"]
                assert [e[1] for e in evict_events] == list(evictor.evicts)
                assert cache.epoch > epoch0
                releasing = p.m.api.TaskStatus.Releasing
                with cache.mutex:
                    for v in victims:
                        assert cache.jobs[v.job].tasks[v.uid].status \
                            == releasing
                        node = cache.nodes[v.node_name]
                        assert node.tasks[key(v.pod)].status == releasing
                return list(evictor.evicts), list(cache.events)
            finally:
                p.m.framework.close_session(ssn)
        twin(body)

    def test_truth_dict_order_matches_sequential(self):
        def body(p):
            orders = {}
            for arm in ("seq", "bulk"):
                cache, _, _ = storm_cache(p, starved_queue=True)
                ssn = p.m.framework.open_session(cache, p.tiers())
                try:
                    victims = [t for job in ssn.jobs.values()
                               for t in job.tasks.values()
                               if t.status == p.m.api.TaskStatus.Running][1:3]
                    if arm == "seq":
                        for v in victims:
                            cache.evict(v, "preempt")
                    else:
                        assert cache.evict_many(
                            [(v, "preempt") for v in victims]) == []
                    with cache.mutex:
                        orders[arm] = (
                            {uid: list(job.tasks)
                             for uid, job in cache.jobs.items()},
                            {name: list(node.tasks)
                             for name, node in cache.nodes.items()},
                            {uid: {st.name: list(b) for st, b in
                                   job.task_status_index.items()}
                             for uid, job in cache.jobs.items()})
                finally:
                    p.m.framework.close_session(ssn)
            assert orders["bulk"] == orders["seq"]
            return orders["bulk"]
        twin(body)


class TestSharedScannerStatics:
    """KUBE_BATCH_TPU_EVICT_SHIP=1 takes the card's route on the CPU: the
    shared scanner's statics come from the resident shipper's buffer,
    which tpu-allocate's later delta ship in the same session rewrites in
    place."""

    def test_statics_survive_a_later_delta_ship(self, monkeypatch):
        monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", "1")
        monkeypatch.setenv("KUBE_BATCH_TPU_EVICT_SHIP", "1")
        p = Pkg("torch")
        cache, _, _ = storm_cache(p, starved_queue=True)
        ssn = p.m.framework.open_session(cache, p.tiers())
        try:
            scanner = p.scanner(ssn, shared=True)
            assert scanner._resident is not None
            before = [t.clone() for t in scanner.statics]
            inp = scanner.snap.inputs
            flipped = inp._replace(
                sig_mask=~np.asarray(inp.sig_mask),
                sig_bonus=np.asarray(inp.sig_bonus) + 7,
                node_max_tasks=np.asarray(inp.node_max_tasks) + 1)
            shipper = p.mod.models_shipping.resident_shipper(cache, "cpu")
            shipped = shipper.ship(flipped, scanner.snap.config, p.dtype)
            assert shipper.last_mode == "delta"
            # The resident leaves changed in place; the statics did not.
            assert bool(scanner._resident.sig_bonus[0, 0]
                        == shipped.sig_bonus[0, 0])
            for name, old, now in zip(scanner.statics._fields, before,
                                      scanner.statics):
                assert bool((old == now).all()), name
        finally:
            p.m.framework.close_session(ssn)

    @pytest.mark.parametrize("ship", ["0", "1"])
    def test_reclaim_then_preempt_on_shared_scanner(self, monkeypatch, ship):
        """Reclaim pipelines the starved queue's task (a signature of its
        own) before tpu-allocate stages the session again; preempt then
        runs on the shared scanner.  Same victims, binds, events and end
        state as the JAX package, the resident route on and off."""
        monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", "1")
        monkeypatch.setenv("KUBE_BATCH_TPU_EVICT_SHIP", ship)

        def body(p):
            cache, binder, evictor = storm_cache(p, n_nodes=4,
                                                 starved_queue=True)
            for node in cache.nodes.values():
                node.node.metadata.labels["zone"] = "a"
            for t in cache.jobs["ns/starved"].tasks.values():
                t.pod.spec.node_selector = {"zone": "a"}
            state, stats, _ = run_actions(p, cache, STORM_ACTIONS)
            return (state, list(evictor.evicts), dict(binder.binds),
                    list(cache.events), stats)
        state, evicts, _, _, stats = twin(body)
        assert evicts and stats["batch_dispatches"] == 1
        assert stats["refreshes"] >= 1
        assert any(s[0] == "ns-starved0" and s[1] == "Pipelined"
                   for s in state)


class TestDeviceBreaker:
    """The device breaker (tests/test_chaos.py TestCircuitBreaker's state
    machine) and the scanner's two breaker branches: an open breaker
    sends the eviction actions to their host walk, and the batched
    dispatch closes a half-open one.  Nothing in the port feeds the
    breaker until ROADMAP queue 1 item 11, so these cases open it by
    hand, in both packages alike."""

    SCRIPTS = {
        # (threshold, ops): an op is a method of the breaker, or
        # ("clock", t) to move its clock.
        "trip-probe-recover": (3, [
            "allow", "failure", "failure", "state", "failure", "allow",
            ("clock", 9.9), "allow", ("clock", 10.0), "allow", "failure",
            "allow", ("clock", 20.0), "allow", "success", "allow"]),
        "success-resets-count": (2, [
            "failure", "success", "failure", "state"]),
        "reset-force-closes": (1, [
            "failure", "allow", "reset", "allow", "failure", "failure",
            ("clock", 5.0), "failure", ("clock", 14.0), "allow",
            ("clock", 15.0), "allow"]),
    }

    @pytest.mark.parametrize("script", sorted(SCRIPTS))
    def test_state_machine(self, script):
        threshold, ops = self.SCRIPTS[script]

        def body(p):
            clk = [0.0]
            br = p.mod.chaos_breaker.CircuitBreaker(
                "t", threshold=threshold, cooldown=10.0,
                clock=lambda: clk[0])
            seen = []
            for op in ops:
                if isinstance(op, tuple):
                    clk[0] = op[1]
                    continue
                seen.append((op, getattr(br, op)(), br.state()))
            return seen
        seen = twin(body)
        if script == "trip-probe-recover":
            states = [s for _op, _out, s in seen]
            assert states[4] == "open" and seen[5][1] is False
            assert seen[-1] == ("allow", True, "closed")
        if script == "success-resets-count":
            assert seen[-1][2] == "closed"

    @staticmethod
    def _open(p, monkeypatch, clk):
        mod = p.mod.chaos_breaker
        br = mod.CircuitBreaker("device_solve", threshold=1, cooldown=30.0,
                                clock=lambda: clk[0])
        br.failure()
        assert br.state() == "open"
        monkeypatch.setattr(mod, "_device_breaker", br)
        return br

    @pytest.mark.parametrize("arm", ["0", "1"])
    def test_open_breaker_runs_the_host_walk(self, monkeypatch, arm):
        """An open breaker: no scanner, a degraded note on the flight
        recorder, and the same victims, binds and end state as with the
        breaker closed (the scanner only accelerates)."""
        monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", arm)

        def body(p):
            res = {}
            for open_ in (False, True):
                br = self._open(p, monkeypatch, [0.0]) if open_ else None
                if not open_:
                    monkeypatch.setattr(p.mod.chaos_breaker,
                                        "_device_breaker", None)
                cache, binder, evictor = storm_cache(p, starved_queue=True)
                state, stats, sid = run_actions(
                    p, cache, ["reclaim", "preempt"], trace_session=True)
                meta = p.mod.trace.flight_recorder.get(sid).meta
                res[open_] = (state, list(evictor.evicts),
                              dict(binder.binds), stats is None,
                              any("breaker open" in note
                                  for note in meta.get("degraded", [])),
                              br.state() if br else None)
            return res
        res = twin(body)
        assert res[True][1], "the host walk must evict"
        assert res[True][:3] == res[False][:3]
        assert res[True][3:] == (True, True, "open")
        assert res[False][4] is False
        if arm == "1":
            assert res[False][3] is False

    def test_batched_dispatch_closes_a_half_open_breaker(self, monkeypatch):
        """After the cooldown the scanner's allow() admits the probe, and
        the session's one batched dispatch closes the breaker."""
        monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", "1")

        def body(p):
            clk = [0.0]
            br = self._open(p, monkeypatch, clk)
            clk[0] = 31.0
            cache, binder, evictor = storm_cache(p)
            state, stats, _ = run_actions(p, cache, ["preempt"])
            return (state, list(evictor.evicts), dict(binder.binds),
                    stats["batch_dispatches"], br.state())
        _state, evicts, _binds, dispatches, state = twin(body)
        assert evicts and dispatches == 1 and state == "closed"
