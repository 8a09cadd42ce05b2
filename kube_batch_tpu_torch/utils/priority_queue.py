"""Priority queue over a less-than function, with live re-evaluation.

Counterpart of kube-batch pkg/scheduler/util/priority_queue.go:26-94,
with one deliberate semantic strengthening: kube-batch's heap stores items
whose ordering keys (DRF/proportion shares) mutate *while queued*, so Go's
container/heap can pop stale, non-minimal items depending on sift history.
That behavior is accidental and unreproducible on an accelerator.  This queue
re-evaluates the less-fn at pop time and returns the true current minimum —
the semantics the plugins declare — and the device solver's lexicographic
argmin (ops/solver.py) matches it exactly.  Pop is O(n); the session-level
queues hold queues/jobs (small), and per-job task keys are immutable, so this
is never the bottleneck (the [tasks x nodes] work lives on the TPU).

Ties (less(a,b) and less(b,a) both false) pop in insertion order; the
session order functions end with creation-time/UID fallbacks making the
order total, so ties only occur for duplicate pushes of the same object.
"""

from __future__ import annotations

import bisect
from collections import deque
from typing import Callable


class PriorityQueue:

    def __init__(self, less_fn: Callable[[object, object], bool]):
        self._less = less_fn
        self._items: deque = deque()

    def push(self, value) -> None:
        self._items.append(value)

    def pop(self):
        if not self._items:
            return None
        best_i = 0
        best = self._items[0]
        for i in range(1, len(self._items)):
            if self._less(self._items[i], best):
                best = self._items[i]
                best_i = i
        del self._items[best_i]
        return best

    def empty(self) -> bool:
        return not self._items

    def __len__(self) -> int:
        return len(self._items)


class SortedDrainQueue:
    """PriorityQueue specialization for IMMUTABLE sort keys: one C-speed
    sort at build, O(1) pops.  Equal to PriorityQueue's live re-evaluation
    exactly when ``key`` is a total order that cannot change while queued
    (Session.task_sort_key: per-session task keys are immutable; the
    uid fallback makes the order total, so tie handling never differs).
    Late pushes keep correctness via bisect insertion."""

    def __init__(self, key: Callable, items=(), reverse: bool = False):
        self._key = key
        self._reverse = reverse
        self._items = sorted(items, key=key, reverse=reverse)
        self._lo = 0  # drain pointer; avoids O(n) pop(0) shifting

    def push(self, value) -> None:
        # Rare path (task queues are build-then-drain); insert after
        # equal keys so a same-key duplicate pops after the earlier one,
        # matching PriorityQueue's insertion-order ties.
        k = self._key(value)
        if self._reverse:
            i = self._lo
            n = len(self._items)
            while i < n and not (self._key(self._items[i]) < k):
                i += 1
        else:
            keys = [self._key(x) for x in self._items[self._lo:]]
            i = bisect.bisect_right(keys, k) + self._lo
        self._items.insert(i, value)

    def pop(self):
        if self._lo >= len(self._items):
            return None
        value = self._items[self._lo]
        self._items[self._lo] = None  # release the reference
        self._lo += 1
        return value

    def empty(self) -> bool:
        return self._lo >= len(self._items)

    def __len__(self) -> int:
        return len(self._items) - self._lo
