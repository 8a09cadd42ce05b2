"""The port's tiered victim combinators against the JAX package's: the
twin of tests/test_session_combinators.py.  The victim ``init`` flag
persists across tiers (session_plugins.go:80-162): an empty result from the
first decisive tier means no victims, whatever later tiers say.  Each body
runs once per package (``twin``) and returns the victims' uids."""

from tests.test_torch_utils import reference_gc_guard  # noqa: F401
from tests.test_torch_utils import twin


def mk_session(p, tier_plugins):
    cache, _binder, _evictor = p.empty_cache()
    ssn = p.m.framework.Session(cache)
    conf = p.mod.conf
    tiers = []
    for names in tier_plugins:
        tier = conf.Tier()
        for name in names:
            option = conf.PluginOption(name=name)
            conf.apply_plugin_conf_defaults(option)
            tier.plugins.append(option)
        tiers.append(tier)
    ssn.tiers = tiers
    return ssn


def tasks(p):
    return [p.m.api.TaskInfo(p.pod("ns", name, "n1", "Running",
                                   {"cpu": "1", "memory": "1Gi"},
                                   groupname="pg"))
            for name in ("t1", "t2", "t3")]


def uids(victims):
    return [v.uid for v in victims]


def test_single_plugin_decides():
    def body(p):
        t1, t2, t3 = tasks(p)
        ssn = mk_session(p, [["a"]])
        ssn.add_preemptable_fn("a", lambda _p, _c: [t1, t2])
        return uids(ssn.preemptable(t3, [t1, t2]))
    assert twin(body) == ["ns-t1", "ns-t2"]


def test_intersection_within_tier():
    def body(p):
        t1, t2, t3 = tasks(p)
        ssn = mk_session(p, [["a", "b"]])
        ssn.add_preemptable_fn("a", lambda _p, _c: [t1, t2])
        ssn.add_preemptable_fn("b", lambda _p, _c: [t2, t3])
        return uids(ssn.preemptable(t3, [t1, t2, t3]))
    assert twin(body) == ["ns-t2"]


def test_empty_first_tier_blocks_later_tiers():
    def body(p):
        t1, _t2, t3 = tasks(p)
        ssn = mk_session(p, [["a"], ["b"]])
        ssn.add_preemptable_fn("a", lambda _p, _c: [])
        ssn.add_preemptable_fn("b", lambda _p, _c: [t1])
        return uids(ssn.preemptable(t3, [t1]))
    assert twin(body) == []


def test_tier_without_fns_defers():
    def body(p):
        t1, _t2, t3 = tasks(p)
        ssn = mk_session(p, [["a"], ["b"]])
        ssn.add_preemptable_fn("b", lambda _p, _c: [t1])
        return uids(ssn.preemptable(t3, [t1]))
    assert twin(body) == ["ns-t1"]


def test_disabled_plugin_skipped():
    def body(p):
        t1, _t2, t3 = tasks(p)
        ssn = mk_session(p, [["a"], ["b"]])
        ssn.tiers[0].plugins[0].enabled_preemptable = False
        ssn.add_preemptable_fn("a", lambda _p, _c: [])
        ssn.add_reclaimable_fn("a", lambda _p, _c: [])
        ssn.add_preemptable_fn("b", lambda _p, _c: [t1])
        return uids(ssn.preemptable(t3, [t1]))
    assert twin(body) == ["ns-t1"]


def test_reclaimable_same_semantics():
    def body(p):
        t1, t2, t3 = tasks(p)
        ssn = mk_session(p, [["a", "b"]])
        ssn.add_reclaimable_fn("a", lambda _p, _c: [t1, t3])
        ssn.add_reclaimable_fn("b", lambda _p, _c: [t3])
        return uids(ssn.reclaimable(t2, [t1, t3]))
    assert twin(body) == ["ns-t3"]
