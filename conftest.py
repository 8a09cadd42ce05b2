"""Rules for every test case run from this checkout, above each suite's
own conftest.

* **A time limit per case.**  A case may take CASE_LIMIT_S over its whole
  protocol: its setup (the wider-scoped fixtures it builds included),
  its call and its teardown.  Past it, faulthandler writes every
  thread's stack to the process's stderr and ends the process, whatever
  the case waits on, a lock in C included.  Under xdist the controller
  reports the case as failed (``worker 'gwN' crashed while running
  '<case>'``), starts a new worker and goes on with the rest of the run;
  a case that ended a worker is not run again.  A run without xdist ends
  at that case.
* **The collector held off around the JAX package's stores**
  (tests/collector.py), for the JAX package's test modules whose cases
  build them.  The port's test modules take
  tests/test_torch_utils.reference_gc_guard instead.
* **The x64 switch under its old name.**  JAX 0.9 removed
  ``jax.experimental.disable_x64``, which the JAX package's
  tests/test_parity_f32.py imports; it is ``jax.enable_x64(False)``.
"""

import contextlib
import faulthandler
import os
import pathlib
import shutil
import sys
import tempfile

import pytest

from tests.collector import collector_held_off

# About three times the slowest case of the tier-1 suite under six xdist
# workers on 8 cores (54.4 s, setup and teardown included).
CASE_LIMIT_S = 180.0

TESTS = pathlib.Path(__file__).resolve().parent / "tests"
# The JAX package's test modules whose cases track a store in its memory
# ledger (kube_batch_tpu/metrics/memledger.py), the module-scoped
# fixtures of test_topology.py and test_trace.py included.
REFERENCE_STORE_MODULES = frozenset((
    "test_actions", "test_aux", "test_backfill_scan", "test_baseline_budget",
    "test_batch_commit", "test_chaos", "test_cli", "test_concurrent_shards",
    "test_cycle_floors", "test_e2e", "test_edge", "test_evict_batch",
    "test_fit_deltas", "test_framework", "test_fused", "test_incremental",
    "test_incremental_sessions", "test_ingest_shard", "test_k8s_wire",
    "test_knobs", "test_lazy_mirror", "test_leader_election_store",
    "test_lineage", "test_memledger", "test_parity_f32", "test_pipeline",
    "test_replica_federation", "test_session_combinators", "test_shard_ship",
    "test_sharded_solver", "test_stress", "test_tenancy",
    "test_tensorize_hetero", "test_topology", "test_tpu_parity",
    "test_trace", "test_wire_fast"))

_STDERR = pytest.StashKey[int]()
_RUNNING_DIR = pytest.StashKey[str]()


def pytest_configure(config):
    # The process's own stderr, kept while no case's output is captured:
    # the dump at the limit must reach the run's log.
    config.stash[_STDERR] = os.dup(sys.__stderr__.fileno())
    # tests/conftest.py has imported and configured jax by now.
    if "jax" in sys.modules:
        import jax
        import jax.experimental
        if not hasattr(jax.experimental, "disable_x64"):
            jax.experimental.disable_x64 = lambda: jax.enable_x64(False)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR])
    if _RUNNING_DIR in config.stash:
        shutil.rmtree(config.stash[_RUNNING_DIR], ignore_errors=True)


@pytest.hookimpl(optionalhook=True)
def pytest_configure_node(node):
    """The xdist controller's directory in which each worker names the
    case it is running."""
    if _RUNNING_DIR not in node.config.stash:
        node.config.stash[_RUNNING_DIR] = tempfile.mkdtemp(
            prefix="pytest-running-")
    node.workerinput["running_dir"] = node.config.stash[_RUNNING_DIR]


def _running_file(config):
    workerinput = getattr(config, "workerinput", {})
    if "running_dir" not in workerinput:
        return None
    return os.path.join(workerinput["running_dir"], workerinput["workerid"])


@pytest.hookimpl(specname="pytest_runtest_protocol", tryfirst=True)
def pytest_runtest_protocol_not_again(item, nextitem):
    """xdist hands the test file of a worker that ended mid-case, that
    case included, to another worker: a case that another worker's
    running file names was running when that worker ended, and is not
    run again (the controller has reported it failed)."""
    mine = _running_file(item.config)
    if mine is None:
        return None
    folder = os.path.dirname(mine)
    for name in os.listdir(folder):
        path = os.path.join(folder, name)
        if path != mine:
            with open(path) as f:
                if f.read() == item.nodeid:
                    return True
    return None


# Innermost, so that pytest's own faulthandler_timeout, if set, does not
# replace the limit.
@pytest.hookimpl(specname="pytest_runtest_protocol", wrapper=True,
                 trylast=True)
def pytest_runtest_protocol_within_limit(item, nextitem):
    mine = _running_file(item.config)
    if mine is not None:
        with open(mine, "w") as f:
            f.write(item.nodeid)
    guard = (collector_held_off() if item.path.parent == TESTS
             and item.path.stem in REFERENCE_STORE_MODULES
             else contextlib.nullcontext())
    faulthandler.dump_traceback_later(CASE_LIMIT_S, exit=True,
                                      file=item.config.stash[_STDERR])
    try:
        with guard:
            return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        if mine is not None:
            open(mine, "w").close()
