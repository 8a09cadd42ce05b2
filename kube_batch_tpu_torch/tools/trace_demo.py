"""Record a small live session of the port and write its Chrome trace
(the repo's tools/trace_demo.py, driving kube_batch_tpu_torch).

Runs two scheduler cycles on a synthetic in-process cluster (cold and
steady, so the delta-ship path and a realistic span tree both appear),
plus one gang that can never be ready so the flight recorder has a
why-pending verdict to show, then writes the newest session's
trace-event JSON — open it in any Chrome-trace viewer (Perfetto's UI,
chrome://tracing) to browse the span tree.

CLI::

    python -m kube_batch_tpu_torch.tools.trace_demo [OUT.json]
        [--device cuda|cpu]

OUT.json defaults to build/trace_demo.json in the checkout.  The device
is the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

import torch

from kube_batch_tpu_torch import knobs
from kube_batch_tpu_torch.tools import add_device_flag, cli_device

DEFAULT_OUT = (pathlib.Path(__file__).resolve().parents[2] / "build"
               / "trace_demo.json")


def record(device, dtype: torch.dtype = torch.float32):
    """Two cycles of the port's Scheduler on ``device``: returns (the
    newest session trace, its why-pending verdict for the stuck gang)."""
    from kube_batch_tpu_torch.api import ObjectMeta
    from kube_batch_tpu_torch.apis.scheduling import v1alpha1
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.trace import flight_recorder as recorder

    cache, _binder = make_synthetic_cache(400, 64, 16, 4)
    # A gang that can never be ready: its why-pending verdict lands in
    # the recorder (GET /debug/why?job=demo-stuck on a live daemon).
    cache.add_pod_group(v1alpha1.PodGroup(
        metadata=ObjectMeta(name="demo-stuck", namespace="demo"),
        spec=v1alpha1.PodGroupSpec(min_member=10_000, queue="q0")))
    sched = Scheduler(cache, device=device, dtype=dtype)
    sched.run_once()   # cold: full ship, the kernel's first launch
    sched.run_once()   # steady: a delta or clean ship
    return recorder.latest(), recorder.why("demo-stuck")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("out", nargs="?", default=str(DEFAULT_OUT),
                    help="where to write the trace (default: %(default)s)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = cli_device(args, "trace_demo")
    if device is None:
        return 1
    os.environ[knobs.TRACE.env] = "1"
    from kube_batch_tpu_torch.trace import export
    trace, why = record(device)
    if trace is None:
        print(f"trace_demo: no trace recorded (is {knobs.TRACE.env}=0 "
              "leaking in?)", file=sys.stderr)
        return 1
    doc = export.to_chrome_trace(trace)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=1))
    print(f"wrote {out}: session {trace.sid}, {len(trace.spans)} spans, "
          f"{len(doc['traceEvents'])} events, {trace.duration_ms:.1f} ms "
          f"on {device}")
    print("phases:", json.dumps(export.summarize_phases(trace)))
    print("why demo-stuck:", json.dumps(why))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
