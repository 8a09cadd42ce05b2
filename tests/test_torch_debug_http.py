"""The port's HTTP surfaces (kube_batch_tpu_torch/cli/server.py: /metrics,
/healthz, /debug and its eight endpoints) against the reference's, on
the CPU.

Twins of the HTTP cases that need no cluster edge:
tests/test_trace.py::test_debug_endpoints_http,
tests/test_lineage.py::test_gauges_on_metrics_text and
::test_index_lineage_and_tenants,
tests/test_evict_batch.py::test_per_action_counters_and_debug_summary
and tests/test_incremental_sessions.py::
test_incremental_meta_lands_in_flight_recorder.  Each case runs once per
package, each package's own server over its own recorders, and both
must answer the same.
"""

import gc
import importlib
import json
import urllib.error
import urllib.request

import pytest

from tests.test_torch_e2e import CONF_TPU, Harness
from tests.test_torch_evict import storm_cache
from tests.test_torch_utils import loop_twin, twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

ROOTS = ("kube_batch_tpu", "kube_batch_tpu_torch")


def _mod(pkg, name):
    root = "kube_batch_tpu_torch" if pkg == "torch" else "kube_batch_tpu"
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Tracing on; empty session rings, lineage and tenant tables in
    both packages, before and after each case."""
    monkeypatch.delenv("KUBE_BATCH_TPU_TRACE", raising=False)

    def clean():
        for root in ROOTS:
            trace = importlib.import_module(f"{root}.trace")
            while trace.spans.current_trace() is not None:
                trace.spans.end_session()
            trace.flight_recorder.clear()
            trace.pod_lineage.refresh()
            importlib.import_module(f"{root}.metrics.tenants") \
                .tenant_table.clear()
    clean()
    yield
    clean()
    gc.unfreeze()


class Server:
    """One package's metrics server on a free port, for a with-block."""

    def __init__(self, pkg):
        self.server_mod = _mod(pkg, "cli.server")

    def __enter__(self):
        self.server = self.server_mod.start_metrics_server("127.0.0.1:0")
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        return self

    def __exit__(self, *exc):
        self.server_mod.stop_metrics_server(self.server)

    def get(self, path):
        """(status, JSON body) of GET ``path``."""
        try:
            with urllib.request.urlopen(self.base + path, timeout=10) as r:
                return r.status, json.loads(r.read().decode())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read().decode() or "null")

    def text(self, path):
        with urllib.request.urlopen(self.base + path, timeout=10) as r:
            return r.status, r.read().decode()


def test_debug_endpoints_http():
    """A traced cycle with an unschedulable gang: /debug/sessions lists
    it, /debug/trace exports it (also as ``latest``), /debug/why names
    the gating reason, and bad queries answer 400 or 404."""
    def body(lp):
        o, v1 = lp.objects, lp.v1alpha1
        cache, _ = lp.synthetic.make_synthetic_cache(200, 32, 10, 2)
        cache.add_pod_group(v1.PodGroup(
            metadata=o.ObjectMeta(name="stuck-gang", namespace="t"),
            spec=v1.PodGroupSpec(min_member=10_000, queue="q0")))
        lp.scheduler(cache).run_once()
        sid = _mod(lp.pkg, "trace").flight_recorder.latest().sid
        with Server(lp.pkg) as srv:
            status, sessions = srv.get("/debug/sessions")
            listed = any(s["session"] == sid for s in sessions["sessions"])
            t_status, doc = srv.get(f"/debug/trace?session={sid}")
            spans = {ev["name"] for ev in doc["traceEvents"]
                     if ev["ph"] == "X"}
            latest = srv.get("/debug/trace?session=latest")[0]
            w_status, why = srv.get("/debug/why?job=stuck-gang")
            bad = [srv.get(path)[0] for path in (
                "/debug/trace?session=99999999", "/debug/trace",
                "/debug/why?job=definitely-not-a-job")]
            nope = None
            try:
                urllib.request.urlopen(srv.base + "/debug/nope", timeout=10)
            except urllib.error.HTTPError as exc:
                nope = exc.code
        return (status, sessions["tracing_enabled"], listed, t_status,
                {"open_session", "device_wait"} <= spans, latest, w_status,
                why["job"], bool(why["reason"]), bad, nope)

    assert loop_twin(body) == (200, True, True, 200, True, 200, 200,
                               "t/stuck-gang", True, [404, 404, 404], 404)


def test_gauges_on_metrics_text():
    """The tenant gauges of a cycle are on /metrics, and /healthz
    answers ``ok``."""
    def body(lp):
        h = Harness(lp, conf=CONF_TPU)
        h.add_nodes(2)
        h.create_job("j", 2, 2)
        h.cycle()
        with Server(lp.pkg) as srv:
            status, text = srv.text("/metrics")
            health = srv.text("/healthz")
        return (status, health,
                'kube_batch_tenant_share{queue="q1"}' in text,
                'kube_batch_tenant_deserved_share{queue="q1"}' in text,
                "kube_batch_tenant_starvation_seconds" in text)

    assert loop_twin(body) == (200, (200, "ok"), True, True, True)


def test_index_lineage_and_tenants():
    """The /debug index lists every endpoint with a description, and
    the lineage and tenants endpoints answer from a bound cycle."""
    def body(lp):
        h = Harness(lp, conf=CONF_TPU)
        h.add_nodes(2)
        h.create_job("j", 2, 2)
        h.cycle()
        with Server(lp.pkg) as srv:
            status, index = srv.get("/debug")
            l_status, lin = srv.get("/debug/lineage?pod=j-0")
            t_status, tenants = srv.get("/debug/tenants")
            shards = srv.get("/debug/shards")[0]
            topo = srv.get("/debug/topology")[0]
            memory = srv.get("/debug/memory")[0]
            missing = srv.get("/debug/lineage")[0]
            ghost = srv.get("/debug/lineage?pod=ghost")[0]
        return (status, sorted(index["endpoints"]),
                all(index["endpoints"].values()),
                index["lineage"]["tracked_pods"] >= 2, l_status,
                bool(lin["bound"]), lin["stages"][0]["stage"], t_status,
                "q1" in tenants["queues"], shards, topo, memory, missing,
                ghost)

    out = loop_twin(body)
    assert len(out[1]) == 8
    assert out[:1] + out[2:] == (200, True, True, 200, True, "ingest", 200,
                                 True, 200, 200, 200, 400, 404)


def test_per_action_counters_and_debug_summary(monkeypatch):
    """A storm session's evictions by action: the counter's delta equals
    the evictor's count, and /debug/sessions serves the same split in
    the session's summary and in ``evictions_total``."""
    monkeypatch.setenv("KUBE_BATCH_TPU_BATCH_EVICT", "1")

    def body(p):
        metrics = p.mod.metrics_metrics
        before = metrics.evictions_by_action()
        cache, _, evictor = storm_cache(p)
        spans = p.mod.trace_spans
        sid = spans.begin_session(test="evict-batch")
        ssn = p.m.framework.open_session(cache, p.tiers())
        try:
            for name in ("reclaim", "preempt"):
                p.action(name).execute(ssn)
        finally:
            p.m.framework.close_session(ssn)
            spans.end_session()
        after = metrics.evictions_by_action()
        delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        with Server(p.pkg) as srv:
            status, doc = srv.get("/debug/sessions")
        summary = next(s for s in doc["sessions"] if s["session"] == sid)
        assert sum(delta.values()) == len(evictor.evicts) > 0
        assert delta.get("preempt", 0) > 0
        assert summary["evictions"] == {k: v for k, v in delta.items() if v}
        assert doc["evictions_total"] == after
        return status, summary["evictions"], len(evictor.evicts)

    twin(body)


def test_incremental_meta_lands_in_flight_recorder():
    """A tpu-allocate session's incremental meta (kind, dirty counts) is
    on its trace and on /debug/sessions' summary."""
    def body(p):
        synthetic = p.mod.models_synthetic
        cache, binder = synthetic.make_synthetic_cache(40, 8, 6, 2)
        spans = p.mod.trace_spans
        for _ in range(2):
            sid = spans.begin_session(test="incremental")
            ssn = p.m.framework.open_session(cache, p.tiers())
            try:
                p.action("tpu_allocate").execute(ssn)
            finally:
                p.m.framework.close_session(ssn)
                spans.end_session()
        tr = p.mod.trace.flight_recorder.get(sid)
        with Server(p.pkg) as srv:
            status, doc = srv.get("/debug/sessions")
        summary = next(s for s in doc["sessions"] if s["session"] == sid)
        return (status, tr.meta.get("incremental"),
                "dirty_nodes" in tr.meta and "dirty_jobs" in tr.meta,
                summary["meta"].get("incremental"), len(binder.binds))

    status, kind, dirty, served, binds = twin(body)
    assert status == 200 and kind in ("micro", "full", "fallback")
    assert dirty and served == kind and binds > 0
