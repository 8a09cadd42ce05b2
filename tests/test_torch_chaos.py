"""The chaos engine and the host-side fault paths, the JAX package
against the port, on the CPU.

Twins of ``tests/test_chaos.py``: the fault plan's determinism and
grammar (``TestFaultPlanDeterminism``), a cycle with chaos off entering
no fault site (``TestChaosOffIsInert``), the bind egress under ambiguous
and transient faults (``TestBindFaults``), the Scheduler's crash-loop
back-off and the session snapshot site (``TestSchedulerBackoff``) and
the time-to-bind samples under ambiguous binds
(``TestLineageUnderChaos``), over ``tests/test_torch_e2e.Harness``.
Each case runs its body once per package (loop_twin) and both must
return the same.  The breaker cases are in tests/test_torch_breaker.py.

Not twinned here: ``TestWatchFaults``, the watch-storm case of
``TestLineageUnderChaos`` and ``TestSoakSmoke`` need the HTTP edge
(``edge.ApiServer``, ``RemoteCluster``) and ``tools/chaos_soak``, which
come with the wire (ROADMAP queue 1 item 9).
"""

import importlib

import pytest

from tests.test_torch_e2e import CONF_TPU, Harness
from tests.test_torch_utils import loop_twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

ROOTS = ("kube_batch_tpu", "kube_batch_tpu_torch")


def _mod(lp, name):
    root = "kube_batch_tpu_torch" if lp.pkg == "torch" else "kube_batch_tpu"
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def _clean_chaos():
    def clean():
        for root in ROOTS:
            importlib.import_module(f"{root}.chaos.plan").disable()
            importlib.import_module(
                f"{root}.chaos.breaker").device_breaker().reset()
    clean()
    yield
    clean()


# ----------------------------------------------------------------------
# fault-plan determinism


class TestFaultPlanDeterminism:
    def test_same_seed_byte_identical_schedule(self):
        def body(lp):
            cp = lp.chaos_plan
            a = cp.FaultPlan(seed=42, rate=0.3)
            b = cp.FaultPlan(seed=42, rate=0.3)
            out = []
            for site in ("watch.disconnect:pods", "bind.ambiguous",
                         "solve.device_error"):
                assert a.preview(site, 512) == b.preview(site, 512)
                out.append(a.preview(site, 512))
            return out

        loop_twin(body)

    def test_live_fire_sequence_matches_preview(self):
        def body(lp):
            cp = lp.chaos_plan
            plan = cp.FaultPlan(seed=7, rate=0.5)
            preview = cp.FaultPlan(seed=7, rate=0.5).preview("s", 64)
            fired = [plan.fire("s") is not None for _ in range(64)]
            assert fired == [bool(preview[i * 5]) for i in range(64)]
            assert any(fired) and not all(fired)
            return fired

        loop_twin(body)

    def test_different_seeds_differ(self):
        def body(lp):
            cp = lp.chaos_plan
            a = cp.FaultPlan(seed=1, rate=0.5).preview("s", 256)
            b = cp.FaultPlan(seed=2, rate=0.5).preview("s", 256)
            assert a != b
            return a, b

        loop_twin(body)

    def test_sites_consume_independent_streams(self):
        def body(lp):
            cp = lp.chaos_plan
            interleaved = cp.FaultPlan(seed=9, rate=0.5)
            alone = cp.FaultPlan(seed=9, rate=0.5)
            got, want = [], []
            for i in range(64):
                got.append(interleaved.fire("a") is not None)
                interleaved.fire(f"noise:{i % 7}")
                want.append(alone.fire("a") is not None)
            assert got == want
            return got

        loop_twin(body)

    def test_budget_drains_schedule(self):
        def body(lp):
            plan = lp.chaos_plan.FaultPlan(seed=3, rate=1.0, budget=3)
            fired = [plan.fire("x") is not None for _ in range(10)]
            return fired, plan.drained(), plan.total_injected()

        assert loop_twin(body) == ([True] * 3 + [False] * 7, True, 3)

    def test_site_filter_and_rate_overrides(self):
        def body(lp):
            plan = lp.chaos_plan.FaultPlan(
                seed=1, rate=1.0, sites=("watch.*", "bind.timeout"),
                rates=(("bind.*", 0.0),))
            return (plan.fire("watch.disconnect:pods") is not None,
                    plan.fire("solve.device_error") is None,
                    plan.fire("bind.timeout") is None)

        assert loop_twin(body) == (True, True, True)

    def test_spec_grammar_round_trip(self, monkeypatch):
        def body(lp):
            cp = lp.chaos_plan
            monkeypatch.setenv(
                cp.CHAOS_ENV,
                "seed=5, rate=0.4, sites=watch.*|bind.*, "
                "rates=bind.*:0.9|watch.truncate:0.1, budget=7")
            plan = cp.reload_from_env()
            out = ((plan.seed, plan.rate, plan.budget), plan.sites,
                   plan._rate_for("bind.timeout"),
                   plan._rate_for("watch.truncate:pods"),
                   plan._rate_for("watch.disconnect"))
            monkeypatch.delenv(cp.CHAOS_ENV)
            return out, cp.reload_from_env()

        assert loop_twin(body) == (
            ((5, 0.4, 7), ("watch.*", "bind.*"), 0.9, 0.1, 0.4), None)

    def test_spec_rejects_malformed(self):
        def body(lp):
            cp = lp.chaos_plan
            for spec in ("seed=1,bogus=2", "seed=1,rate=1.5",
                         "just-a-word"):
                with pytest.raises(ValueError):
                    cp.plan_from_spec(spec)
            return cp.plan_from_spec(""), cp.plan_from_spec("off")

        assert loop_twin(body) == (None, None)


class TestChaosOffIsInert:
    def test_unset_means_zero_site_activations(self, monkeypatch):
        """With no plan installed, a full scheduling cycle never enters
        the decision path."""
        def body(lp):
            cp = lp.chaos_plan
            assert cp.PLAN is None
            calls = []
            orig = cp.FaultPlan.fire
            monkeypatch.setattr(
                cp.FaultPlan, "fire",
                lambda self, site: (calls.append(site), orig(self, site))[1])
            h = Harness(lp, conf=CONF_TPU)
            h.add_nodes(2)
            h.create_job("j", 2, 2)
            h.cycle()
            monkeypatch.undo()
            return len(h.bound("j")), calls

        assert loop_twin(body) == (2, [])

    def test_new_collectors_expose(self):
        def body(lp):
            text = lp.metrics.registry.expose()
            return [name in text for name in (
                "kube_batch_chaos_injected_total",
                "kube_batch_degraded_mode", "kube_batch_breaker_state",
                "kube_batch_cycle_failures_total",
                "kube_batch_bind_ambiguous_total",
                "kube_batch_watch_reconnects_total")]

        assert loop_twin(body) == [True] * 6


# ----------------------------------------------------------------------
# bind egress: ambiguity + backoff


class TestBindFaults:
    def test_ambiguous_bind_lands_counts_and_resyncs(self):
        def body(lp):
            cp = lp.chaos_plan
            cp.install(cp.FaultPlan(seed=3, rate=1.0,
                                    sites=("bind.ambiguous",)))
            before = lp.metrics.bind_ambiguous.value("unproven")
            h = Harness(lp, conf=CONF_TPU)
            h.add_nodes(2)
            h.create_job("j", 2, 2)
            h.cycle()
            seen = [len(h.bound("j")),
                    lp.metrics.bind_ambiguous.value("unproven") - before,
                    len(h.cache.err_tasks)]
            h.cache.process_resync_tasks(h.cache.binder.cluster)
            seen.append(len(h.cache.err_tasks))
            cp.disable()
            binds_before = len(h.cluster.pods)
            h.cycle()
            seen += [len(h.bound("j")), len(h.cluster.pods) - binds_before]
            return seen, h.outcome()

        seen, _ = loop_twin(body)
        assert seen == [2, 2.0, 2, 0, 2, 0]

    def test_transient_bind_failure_retries_with_backoff(self):
        def body(lp):
            cp = lp.chaos_plan
            cp.install(cp.FaultPlan(seed=4, rate=1.0,
                                    sites=("bind.timeout",), budget=1))
            before = lp.metrics.bind_retries.value()
            h = Harness(lp, conf=CONF_TPU)
            h.add_nodes(2)
            h.create_job("j", 2, 2)
            h.cycle()
            return (len(h.bound("j")),
                    lp.metrics.bind_retries.value() > before, h.outcome())

        assert loop_twin(body)[:2] == (2, True)

    def test_truth_store_rejects_rebind(self):
        def body(lp):
            h = Harness(lp, conf=CONF_TPU)
            h.add_nodes(2)
            h.create_job("j", 2, 2)
            h.cycle()
            (key, node), *_ = h.bound("j").items()
            ns, name = key.split("/", 1)
            with pytest.raises(ValueError, match="already assigned"):
                h.cluster.bind_pod(ns, name, node)
            return key, node

        loop_twin(body)

    def test_ambiguous_error_is_not_retried(self):
        """A delivered-but-unproven outcome must never be re-POSTed."""
        def body(lp):
            err = _mod(lp, "cache.interface").AmbiguousOutcomeError
            calls = []

            class OneShotBinder:
                def bind(self, pod, hostname):
                    calls.append(pod.metadata.name)
                    raise err("delivered, unproven")

            cache = _mod(lp, "cache.cache").SchedulerCache(
                binder=OneShotBinder())
            pod = type("P", (), {})()
            pod.metadata = type("M", (), {})()
            pod.metadata.name = "p0"
            pod.metadata.namespace = "ns"
            pod.metadata.uid = "u0"
            with pytest.raises(err):
                cache._bind_with_backoff(pod, "n0")
            return calls

        assert loop_twin(body) == ["p0"]


# ----------------------------------------------------------------------
# scheduler crash-loop backoff + session fault sites


class TestSchedulerBackoff:
    def test_consecutive_failures_double_delay_capped_reset(self,
                                                            monkeypatch):
        def body(lp):
            h = Harness(lp, conf=CONF_TPU)
            sched = h.scheduler
            sched.schedule_period = 0.1
            sched._max_backoff = 0.8
            before = lp.metrics.cycle_failures.value("cycle")
            boom = [True]
            orig_run_once = sched.run_once

            def run_once_maybe():
                if boom[0]:
                    raise RuntimeError("boom")
                orig_run_once()

            monkeypatch.setattr(sched, "run_once", run_once_maybe)
            delays, ok = [], []
            for _ in range(4):
                ok.append(sched.cycle())
                delays.append(round(sched._cycle_delay(0.0), 3))
            seen = [ok, delays,
                    lp.metrics.cycle_failures.value("cycle") - before,
                    lp.metrics.degraded_mode.value("cycle_backoff")]
            boom[0] = False
            seen += [sched.cycle(), round(sched._cycle_delay(0.0), 3),
                     lp.metrics.degraded_mode.value("cycle_backoff")]
            monkeypatch.undo()
            return seen

        assert loop_twin(body) == [[False] * 4, [0.2, 0.4, 0.8, 0.8], 4.0,
                                   1.0, True, 0.1, 0.0]

    def test_backoff_never_overflows_after_long_outages(self):
        def body(lp):
            sched = Harness(lp, conf=CONF_TPU).scheduler
            sched.schedule_period = 0.1
            sched._max_backoff = 30.0
            sched._consecutive_failures = 100_000
            return sched._cycle_delay(0.0)

        assert loop_twin(body) == 30.0

    def test_permanent_bind_rejections_are_not_retried(self):
        def body(lp):
            retryable = _mod(lp, "cache.cache")._retryable_bind_error
            err = _mod(lp, "cache.interface").AmbiguousOutcomeError
            err_409 = KeyError("POST /bind: 409 conflict")
            err_409.status = 409
            err_503 = KeyError("POST /bind: 503 unavailable")
            err_503.status = 503
            return [retryable(e) for e in (
                ValueError("already assigned"), err_409, err("delivered"),
                err_503, TimeoutError("timed out"), OSError("conn reset"))]

        assert loop_twin(body) == [False, False, False, True, True, True]

    def test_snapshot_fault_fails_cycle_but_loop_survives(self):
        def body(lp):
            cp = lp.chaos_plan
            cp.install(cp.FaultPlan(seed=5, rate=1.0,
                                    sites=("session.snapshot",), budget=2))
            h = Harness(lp, conf=CONF_TPU)
            h.add_nodes(2)
            h.create_job("j", 2, 2)
            ok = [h.scheduler.cycle() for _ in range(3)]
            return ok, len(h.bound("j")), h.outcome()

        assert loop_twin(body)[:2] == ([False, False, True], 2)


# ----------------------------------------------------------------------
# pod lineage under chaos: ambiguous binds must not corrupt the
# time-to-bind SLO


def _slo_samples(metrics):
    with metrics.slo_time_to_bind._lock:
        per = {labels[0]: n for labels, n
               in metrics.slo_time_to_bind._totals.items() if labels}
    return per, sum(per.values())


class TestLineageUnderChaos:
    def test_ambiguous_bind_single_counts_time_to_bind(self):
        """The bind lands server-side but the cache only sees a dead
        connection; the resync proves it.  Exactly one sample per pod,
        never negative."""
        def body(lp):
            cp, m = lp.chaos_plan, lp.metrics
            lp.lineage.refresh()
            try:
                cp.install(cp.FaultPlan(seed=3, rate=1.0,
                                        sites=("bind.ambiguous",)))
                neg0 = m.slo_samples_dropped.value("negative")
                _, total0 = _slo_samples(m)
                h = Harness(lp, conf=CONF_TPU)
                h.add_nodes(2)
                h.create_job("j", 2, 2)
                h.cycle()
                seen = [len(h.bound("j")), len(h.cache.err_tasks)]
                h.cache.process_resync_tasks(h.cache.binder.cluster)
                cp.disable()
                h.cycle()
                _, total1 = _slo_samples(m)
                seen += [total1 - total0,
                         m.slo_samples_dropped.value("negative") - neg0]
                for name in ("j-0", "j-1"):
                    lin = lp.lineage.lineage(f"test/{name}")
                    seen.append((lin["bound"], lin["time_to_bind_s"] >= 0,
                                 len([s for s in lin["stages"]
                                      if s["stage"] == "bound"])))
                return seen
            finally:
                lp.lineage.refresh()

        assert loop_twin(body) == [2, 2, 2, 0, (True, True, 1),
                                   (True, True, 1)]
