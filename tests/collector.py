"""The collector held off while the JAX package's stores are built.

The JAX package's memory ledger drops a dead store's bytes from a
``weakref.finalize`` callback that takes the ledger's own mutex
(kube_batch_tpu/metrics/memledger.py ``Ledger.track`` or ``set`` ->
``drop``): a cyclic collection that starts at an allocation inside them
runs that callback with the mutex held, and the process waits on itself
forever.  The tests build many stores in one process, which makes the
collision likely, so what builds them runs with the collector off, and a
full collection before and after it runs the finalizers outside every
ledger lock.  The port's ledger queues drops without a lock
(tests/test_torch_memledger.py).

Imports neither torch nor the port: the JAX package's own tests use it
through the repo's root conftest.py, the port's through
tests/test_torch_utils.reference_gc_guard.
"""

import contextlib
import gc


@contextlib.contextmanager
def collector_held_off():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()
