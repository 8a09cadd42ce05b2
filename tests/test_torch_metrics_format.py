"""The port's Prometheus text exposition against the JAX package's: the
twin of tests/test_metrics_format.py.  Both registries must parse under
the same strict grammar (tests/test_metrics_format.parse_exposition), with
adversarial label values round-tripping, and the label-cardinality bound
must hold the same way.  Each body runs once per package (``twin``)."""

import logging

from tests.test_metrics_format import ADVERSARIAL, parse_exposition
from tests.test_torch_utils import twin


def fam_record(fam):
    return fam["type"], fam["help"], sorted(
        (n, sorted(labels.items()), v) for n, labels, v in fam["samples"])


def test_global_registry_parses_strictly():
    def body(p):
        parsed = parse_exposition(p.mod.metrics_metrics.registry.expose())
        return (parsed["kube_batch_schedule_attempts_total"]["type"],
                parsed["kube_batch_unschedule_job_count"]["type"],
                "kube_batch_e2e_scheduling_latency_milliseconds" in parsed)
    assert twin(body) == ("counter", "gauge", True)


def test_global_registry_with_adversarial_job_name():
    def body(p):
        metrics = p.mod.metrics_metrics
        metrics.update_unschedule_task_count(ADVERSARIAL, 7)
        metrics.register_job_retries(ADVERSARIAL)
        parsed = parse_exposition(metrics.registry.expose())
        samples = parsed["kube_batch_unschedule_task_count"]["samples"]
        return {labels["job"]: v for _n, labels, v in samples
                if "job" in labels}[ADVERSARIAL]
    assert twin(body) == 7.0


def test_histogram_label_escaping_roundtrip():
    def body(p):
        m = p.mod.metrics_metrics
        reg = m.Registry()
        h = reg.register(m.Histogram("t_hist", "adversarial histogram",
                                     [1.0, 2.0, 4.0], ("job",)))
        h.observe(0.5, ADVERSARIAL)
        h.observe(3.0, ADVERSARIAL)
        h.observe(9.0, "plain")
        return fam_record(parse_exposition(reg.expose())["t_hist"])
    kind, _help, samples = twin(body)
    assert kind == "histogram"
    assert {dict(labels)["job"] for _n, labels, _v in samples} == \
        {ADVERSARIAL, "plain"}
    inf = [v for n, labels, v in samples if n == "t_hist_bucket"
           and dict(labels) == {"job": ADVERSARIAL, "le": "+Inf"}]
    cnt = [v for n, labels, v in samples if n == "t_hist_count"
           and dict(labels) == {"job": ADVERSARIAL}]
    assert inf == cnt == [2.0]


def test_gauge_type_line_survives_counter_in_help():
    def body(p):
        m = p.mod.metrics_metrics
        reg = m.Registry()
        g = reg.register(m.Gauge(
            "t_gauge",
            "A gauge whose help mentions the word counter twice: counter",
            ("site",)))
        g.set(3.0, 'a"b\\c\nd')
        return fam_record(parse_exposition(reg.expose())["t_gauge"])
    kind, help_text, samples = twin(body)
    assert kind == "gauge"
    assert help_text == ("A gauge whose help mentions the word counter "
                         "twice: counter")
    assert samples == [("t_gauge", [("site", 'a"b\\c\nd')], 3.0)]


def test_counter_help_escaping():
    def body(p):
        m = p.mod.metrics_metrics
        reg = m.Registry()
        c = reg.register(m.Counter("t_counter", "line one\nline two \\ end"))
        c.inc(2.0)
        text = reg.expose()
        return "\n# TYPE" in text, fam_record(
            parse_exposition(text)["t_counter"])
    split_ok, (kind, help_text, samples) = twin(body)
    assert split_ok and kind == "counter"
    assert help_text == "line one\nline two \\ end"
    assert samples == [("t_counter", [], 2.0)]


def test_empty_counter_exposes_zero_sample():
    def body(p):
        m = p.mod.metrics_metrics
        reg = m.Registry()
        reg.register(m.Counter("t_zero", "never incremented"))
        return fam_record(parse_exposition(reg.expose())["t_zero"])
    assert twin(body)[2] == [("t_zero", [], 0.0)]


def test_namespace_storm_is_cardinality_bounded(monkeypatch):
    def body(p):
        metrics = p.mod.metrics_metrics
        monkeypatch.setenv(metrics.SERIES_CAP_ENV, "8")
        metrics.refresh_series_cap()
        try:
            dropped0 = metrics.series_dropped.value("slo")
            storm = 1000
            for i in range(storm):
                metrics.observe_time_to_bind(f"storm-q{i}", 0.25)
            with metrics.slo_time_to_bind._lock:
                storm_series = {labels[0] for labels
                                in metrics.slo_time_to_bind._counts
                                if labels and labels[0].startswith("storm-q")}
                other = metrics.slo_time_to_bind._totals.get(
                    (metrics.OTHER_LABEL,), 0)
            dropped = metrics.series_dropped.value("slo") - dropped0
            parsed = parse_exposition(metrics.registry.expose())
            fam = parsed["kube_batch_slo_time_to_bind_seconds"]
            series = {labels["queue"] for _n, labels, _v in fam["samples"]}
            return (len(storm_series) <= 8, other >= storm - 8,
                    dropped >= storm - 8,
                    len([q for q in series if q.startswith("storm-q")]) <= 8,
                    metrics.OTHER_LABEL in series)
        finally:
            monkeypatch.delenv(metrics.SERIES_CAP_ENV)
            metrics.refresh_series_cap()
    assert twin(body) == (True,) * 5


def test_tenant_gauges_share_one_cardinality_budget(monkeypatch):
    def body(p):
        metrics = p.mod.metrics_metrics
        monkeypatch.setenv(metrics.SERIES_CAP_ENV, "4")
        metrics.refresh_series_cap()
        try:
            dropped0 = metrics.series_dropped.value("tenant")
            for i in range(50):
                metrics.set_tenant_stats(f"storm-t{i}", 1.0, 0.5, 0.5, 1,
                                         2.0, False)
            with metrics.tenant_share._lock:
                tenant_series = [lab for lab in metrics.tenant_share._values
                                 if lab and lab[0].startswith("storm-t")]
            parse_exposition(metrics.registry.expose())
            return (len(tenant_series) <= 4,
                    metrics.series_dropped.value("tenant") - dropped0 >= 46)
        finally:
            monkeypatch.delenv(metrics.SERIES_CAP_ENV)
            metrics.refresh_series_cap()
    assert twin(body) == (True, True)


def test_adversarial_queue_name_via_slo_path():
    def body(p):
        metrics = p.mod.metrics_metrics
        metrics.refresh_series_cap()
        try:
            metrics.observe_time_to_bind(ADVERSARIAL, 0.5)
            parsed = parse_exposition(metrics.registry.expose())
            fam = parsed["kube_batch_slo_time_to_bind_seconds"]
            return any(labels["queue"] == ADVERSARIAL
                       for _n, labels, _v in fam["samples"])
        finally:
            metrics.refresh_series_cap()
    assert twin(body) is True


def test_malformed_series_cap_env_warns_and_pins_default(monkeypatch,
                                                          caplog):
    def body(p):
        metrics = p.mod.metrics_metrics
        monkeypatch.setenv(metrics.SERIES_CAP_ENV, "lots")
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=metrics.__name__):
            cap = metrics.refresh_series_cap()
        warned = any("lots" in r.message for r in caplog.records)
        monkeypatch.delenv(metrics.SERIES_CAP_ENV)
        metrics.refresh_series_cap()
        return cap == metrics.DEFAULT_SERIES_CAP, warned
    assert twin(body) == (True, True)


def test_handler_and_collector_seconds_on_the_exposition():
    """The port's own counters, fed by the clock readings its trace takes
    (no twin in the reference): seconds in each cache handler and in the
    collector's passes by generation, parsed under the strict grammar
    and growing with the work."""
    import gc

    from kube_batch_tpu_torch.api import ObjectMeta
    from kube_batch_tpu_torch.apis.scheduling import v1alpha1
    from kube_batch_tpu_torch.cache import SchedulerCache
    from kube_batch_tpu_torch.metrics import metrics
    from kube_batch_tpu_torch.trace import spans

    def read():
        parsed = parse_exposition(metrics.registry.expose())
        handlers = {labels["handler"]: v for _n, labels, v in
                    parsed["kube_batch_cache_handler_seconds_total"]
                    ["samples"] if "handler" in labels}
        pauses = {labels["generation"]: v for _n, labels, v in
                  parsed["kube_batch_gc_pause_seconds_total"]["samples"]}
        return (parsed["kube_batch_cache_handler_seconds_total"]["type"],
                handlers, pauses)

    class Holder:
        pass

    holder = Holder()
    spans.hold_gc_hook(holder)
    try:
        kind, handlers0, pauses0 = read()
        cache = SchedulerCache()
        queue = v1alpha1.Queue(metadata=ObjectMeta(name="q"),
                               spec=v1alpha1.QueueSpec(weight=1))
        for _ in range(20):
            cache.add_queue(queue)
        # A run's seconds reach the counter when the cache's next run
        # opens: a delete is another kind of run.
        cache.delete_queue(queue)
        gc.collect()
        _kind, handlers1, pauses1 = read()
    finally:
        spans.release_gc_hook(id(holder))
        spans.handoff.clear()
    assert kind == "counter"
    assert set(pauses1) == {"0", "1", "2"}
    assert handlers1["add_queue"] > handlers0.get("add_queue", 0.0)
    assert pauses1["2"] > pauses0["2"]
    assert all(handlers1[h] >= v for h, v in handlers0.items())
