"""Session flight recorder: span tracing, why-pending explainability,
Chrome trace-event export (doc/OBSERVABILITY.md).

``spans``   — thread-local span stack + session lifecycle (the hot-path
              API; no-op under ``KUBE_BATCH_TPU_TRACE=0``).
``recorder``— lock-guarded ring buffer of the last N session traces.
``export``  — Perfetto-loadable trace-event JSON + phase summaries.
``lineage`` — per-POD cross-session SLO timelines (ingest -> considered
              -> placed -> bind -> echo; no-op under
              ``KUBE_BATCH_TPU_LINEAGE=0``).
"""

from . import export, lineage, recorder, spans
from .lineage import LineageRecorder
from .recorder import FlightRecorder

# The process-wide recorder instance, exported under a name that does NOT
# shadow the ``recorder`` submodule (kube_batch_tpu.trace.recorder stays
# the module; patch ITS ``recorder`` attribute to redirect end_session).
flight_recorder = recorder.recorder
# Likewise for the pod-lineage recorder (the submodule keeps its name).
pod_lineage = lineage.lineage

__all__ = ["spans", "export", "recorder", "lineage", "flight_recorder",
           "pod_lineage", "FlightRecorder", "LineageRecorder"]
