"""evict_commit_ms: the eviction actions' commits per session, from the
port's spans: the ``commit.flush`` of each action's evictions (one bulk
egress and cache update, framework/commit.py) plus preempt's
``statement.commit`` and ``statement.discard`` (framework/statement.py),
mean over the sessions that record any of them."""

from ._spans import mean_span_ms


def read(window):
    return mean_span_ms(window, ("commit.flush", "statement.commit",
                                 "statement.discard"))
