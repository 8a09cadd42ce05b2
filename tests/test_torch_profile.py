"""``KUBE_BATCH_TPU_PROFILE``: a ``torch.profiler`` capture of each
tpu-allocate session (the port's counterpart of the reference's
``jax.profiler`` hook, kube_batch_tpu/actions/tpu_allocate.py
``_maybe_profile``), on the CPU.

Set, one session writes one parseable Chrome trace, named by the session
uid, that holds the session's flight-recorder spans (the device half's
``solver.dispatch`` and ``solver.fetch`` among them), placed on the
profile's clock by a marker.
A shard session of the concurrent pipeline writes one trace for each
half (``-begin``, ``-retire``).  Unset, no profiler is built and nothing
is written.  A profiler that
cannot start raises with its own message instead of profiling less.
"""

import json
import os

import pytest
import torch

from tests.test_torch_e2e import CONF_TPU, Harness
from tests.test_torch_utils import Loop

PROFILE_ENV = "KUBE_BATCH_TPU_PROFILE"


def _cycle():
    h = Harness(Loop("torch"), conf=CONF_TPU)
    h.add_nodes(2)
    h.create_job("j", 2, 2)
    h.cycle()
    return h


def test_profile_writes_a_chrome_trace_with_the_session_spans(
        monkeypatch, tmp_path):
    monkeypatch.setenv(PROFILE_ENV, str(tmp_path / "prof"))
    h = _cycle()
    assert len(h.bound("j")) == 2
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].startswith("session-")
    with open(tmp_path / "prof" / files[0]) as fh:
        doc = json.load(fh)
    names = {ev.get("name") for ev in doc["traceEvents"]}
    assert {"tensorize", "ship", "dispatch", "solver.dispatch",
            "host_overlap", "device_wait", "solver.fetch",
            "apply"} <= names
    # The spans are written into the file from the flight recorder on
    # the profile's clock; no span is mirrored into the profiler.
    from kube_batch_tpu_torch.trace import spans
    assert not hasattr(spans, "set_profiler_range")


def test_unset_builds_no_profiler_and_writes_nothing(monkeypatch,
                                                     tmp_path):
    monkeypatch.delenv(PROFILE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)

    def refuse(*_a, **_k):
        raise AssertionError("a profiler was built with the knob unset")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    h = _cycle()
    assert len(h.bound("j")) == 2
    assert os.listdir(tmp_path) == []


def test_a_profiler_that_cannot_start_raises(monkeypatch, tmp_path):
    monkeypatch.setenv(PROFILE_ENV, str(tmp_path))

    class Refused:
        def __init__(self, *_a, **_k):
            pass

        def __enter__(self):
            raise RuntimeError("CUPTI_ERROR_INSUFFICIENT_PRIVILEGES")

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Refused)
    from kube_batch_tpu_torch.actions.tpu_allocate import TpuAllocateAction
    from kube_batch_tpu_torch.framework import close_session, open_session
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache
    from kube_batch_tpu_torch.scheduler import (DEFAULT_SCHEDULER_CONF,
                                                load_scheduler_conf)
    cache, _binder = make_synthetic_cache(40, 8, 4, 2)
    _actions, tiers = load_scheduler_conf(DEFAULT_SCHEDULER_CONF)
    ssn = open_session(cache, tiers)
    try:
        with pytest.raises(RuntimeError, match="CUPTI"):
            TpuAllocateAction(device="cpu").execute(ssn)
    finally:
        close_session(ssn)
    assert os.listdir(tmp_path) == []


def test_pipelined_shard_sessions_write_a_trace_per_half(monkeypatch,
                                                         tmp_path):
    """The concurrent shard pipeline runs a session's halves apart, with
    other shards' halves between them: each half of each shard session
    writes its own trace, the begin half's with the dispatch span and
    the retire half's with the fetch span."""
    from tests.test_torch_concurrent_shards import _build_cluster
    from tests.test_torch_utils import bind_map
    from kube_batch_tpu_torch.actions import tpu_allocate
    monkeypatch.setenv(PROFILE_ENV, str(tmp_path))
    monkeypatch.setenv("KUBE_BATCH_TPU_TENANCY", "2")
    monkeypatch.setenv("KUBE_BATCH_TPU_SHARD_MAP", "q0:0|q1:1")
    monkeypatch.setenv("KUBE_BATCH_TPU_CONCURRENT_SHARDS", "1")
    lp = Loop("torch")
    cluster = _build_cluster(lp, tenants=2, seed=1)
    scheduler = lp.scheduler(lp.cache.new_scheduler_cache(cluster),
                             schedule_period=3600)
    assert scheduler.cycle()
    assert len({k.split("-")[1] for k in bind_map(cluster)}) == 2
    files = sorted(os.listdir(tmp_path))
    halves = {}
    for name in files:
        uid, half = name[len("session-"):-len(".json")].rsplit("-", 1)
        halves.setdefault(uid, set()).add(half)
    assert len(halves) == 2
    assert all(h == {"begin", "retire"} for h in halves.values())
    for name in files:
        with open(tmp_path / name) as fh:
            names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
        span = ("solver.dispatch" if name.endswith("-begin.json")
                else "solver.fetch")
        assert span in names, name
    assert tpu_allocate._profile_open == [False]
