"""The port's memory ledger under a collection that runs inside one of
its locked sections.

A ``weakref.finalize`` callback runs wherever the owner dies: at any
allocation that starts a cyclic collection, or where its last reference
drops, also with the ledger's mutex held by the same thread.  The port's
finalizer only queues the key, and the next locked section drops the
bytes; a finalizer that took the mutex would wait on itself forever (the
JAX package's ledger does, which tests/test_torch_utils.reference_gc_guard
keeps out of the twins).  CPU only.
"""

import threading

import pytest

from kube_batch_tpu_torch.metrics.memledger import Ledger


class _Owner:
    pass


def _die_under_the_lock(led, holder):
    """Drop the last reference to ``holder[0]`` with ``led``'s mutex held,
    on another thread; True if that thread got through on its own."""
    def run():
        with led._lock:
            holder.clear()      # the owner's finalizer runs here
    worker = threading.Thread(target=run)
    worker.start()
    worker.join(10)
    stuck = worker.is_alive()
    if stuck:
        # A finalizer waits on the mutex its own thread holds: release it
        # from here, so the failure does not hang the run.
        led._lock.release()
        worker.join()
    return not stuck


@pytest.mark.parametrize("sizer", [None, lambda owner: 0])
def test_finalizer_inside_a_locked_section_does_not_deadlock(sizer):
    led = Ledger("test_finalizer")
    holder = [_Owner()]
    keep = _Owner()
    ka = led.track(holder[0], "a", sizer)
    kb = led.track(keep, "b", sizer)
    led.set(ka, 100)
    led.set(kb, 7)
    assert led.total() == 107
    assert _die_under_the_lock(led, holder)
    # The next locked section drops the dead owner's bytes and auditor.
    assert led.total() == 7
    assert led.component_count() == 1
    if sizer is not None:
        assert led.audit() == (7, 0)
    led.add(kb, 5)
    assert led.total() == 12


def test_drop_then_death_and_id_reuse_stay_exact():
    """An explicit drop, then the owner's death, leaves nothing behind; a
    new owner tracked after a death starts from zero even if it reuses
    the dead owner's id (the queue drains before registration)."""
    led = Ledger("test_reuse")
    owner = _Owner()
    key = led.track(owner, "x")
    led.set(key, 40)
    led.drop(key)
    assert led.total() == 0
    del owner
    assert led.total() == 0 and led.component_count() == 0
    for _ in range(50):
        o = _Owner()
        k = led.track(o, "x")
        led.add(k, 3)
        del o
    assert led.total() == 0 and led.component_count() == 0
