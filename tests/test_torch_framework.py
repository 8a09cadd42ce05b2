"""Framework-layer twins: arguments, conf parsing, the priority queues and
the session's task-order queues, the JAX package against the port.

Twin of tests/test_framework.py.  Each case runs the reference test's
body once per package (tests/test_torch_utils.twin) and compares what the
two return; the port's must also pass the reference's assertions.  The
conf case loads ``allocate, backfill``, which the port registers with the
eviction engine.
"""

import random

import pytest

from tests.test_torch_utils import build_pod, twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401


def _args(p, data):
    return p.m.framework.Arguments(data)


# --- TestArguments -----------------------------------------------------------

def test_arguments_get_int():
    def body(p):
        args = _args(p, {"a": "5", "b": "x", "c": ""})
        return [args.get_int("a"), args.get_int("b", 7), args.get_int("c", 3),
                args.get_int("missing")]
    assert twin(body) == [5, 7, 3, None]


def test_arguments_get_bool():
    def body(p):
        args = _args(p, {"t": "true", "f": "false", "y": "1"})
        return [args.get_bool("t"), args.get_bool("f"), args.get_bool("y"),
                args.get_bool("missing", True)]
    assert twin(body) == [True, False, True, True]


def test_arguments_get_float():
    assert twin(lambda p: _args(p, {"w": "2.5"}).get_float("w")) == 2.5


# --- TestConf ----------------------------------------------------------------

def test_conf_defaults_applied():
    def body(p):
        conf = p.mod.conf.configuration_from_dict({
            "actions": "allocate",
            "tiers": [{"plugins": [{"name": "gang",
                                    "enableJobOrder": False}]}]})
        option = conf.tiers[0].plugins[0]
        p.mod.conf.apply_plugin_conf_defaults(option)
        return (option.enabled_job_order, option.enabled_job_ready,
                option.enabled_predicate)
    assert twin(body) == (False, True, True)


def test_load_scheduler_conf():
    conf = """
actions: "allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

    def body(p):
        actions, tiers = p.load(conf)
        return ([a.name() for a in actions], len(tiers),
                [x.name for x in tiers[0].plugins],
                tiers[1].plugins[0].enabled_job_order)
    assert twin(body) == (["allocate", "backfill"], 2, ["priority", "gang"],
                          True)


def test_unknown_action_raises():
    def body(p):
        with pytest.raises(KeyError):
            p.load('actions: "nope"\n')
        return True
    twin(body)


def test_mini_yaml_rejects_rich_conf():
    rich = """
actions: "allocate"
tiers:
- plugins:
  - name: nodeorder
    arguments:
      leastrequested.weight: "2"
"""
    flagged = """
actions: "allocate"
tiers:
- plugins:
  - name: gang
    enableJobOrder: false
"""

    def body(p):
        for text in (rich, flagged):
            with pytest.raises(ValueError):
                p.m.scheduler._mini_yaml(text)
        return True
    twin(body)


def test_mini_yaml_parses_default_shape():
    def body(p):
        data = p.m.scheduler._mini_yaml(p.m.scheduler.DEFAULT_SCHEDULER_CONF)
        return data["actions"], [x["name"] for t in data["tiers"]
                                 for x in t["plugins"]]
    assert twin(body) == ("tpu-allocate, backfill", [
        "priority", "gang", "conformance",
        "drf", "predicates", "proportion", "nodeorder"])


# --- TestPriorityQueue -------------------------------------------------------

def _pq(p, less):
    return p.mod.utils_priority_queue.PriorityQueue(less)


def test_priority_queue_order():
    def body(p):
        pq = _pq(p, lambda a, b: a < b)
        for v in [5, 1, 3, 2, 4]:
            pq.push(v)
        return [pq.pop() for _ in range(5)]
    assert twin(body) == [1, 2, 3, 4, 5]


def test_priority_queue_stable_for_equal():
    def body(p):
        pq = _pq(p, lambda a, b: False)
        for v in ["a", "b", "c"]:
            pq.push(v)
        return [pq.pop() for _ in range(3)]
    assert twin(body) == ["a", "b", "c"]


def test_priority_queue_empty_pop():
    def body(p):
        pq = _pq(p, lambda a, b: a < b)
        return pq.pop(), pq.empty()
    assert twin(body) == (None, True)


# --- TestSortedDrainQueue ----------------------------------------------------

def test_sorted_drain_matches_comparator_queue():
    def body(p):
        rng = random.Random(7)
        items = [(rng.randint(0, 5), i) for i in range(200)]
        sdq = p.mod.utils_priority_queue.SortedDrainQueue(lambda x: x, items)
        pq = _pq(p, lambda a, b: a < b)
        for it in items:
            pq.push(it)
        got = [sdq.pop() for _ in range(len(items))]
        assert got == [pq.pop() for _ in range(len(items))]
        assert sdq.pop() is None and sdq.empty()
        return got
    twin(body)


def test_sorted_drain_late_push_both_directions():
    def body(p):
        sdq_cls = p.mod.utils_priority_queue.SortedDrainQueue
        sdq = sdq_cls(lambda x: x, [1, 3, 5])
        out = [sdq.pop()]
        sdq.push(2)
        sdq.push(4)
        out += [sdq.pop() for _ in range(4)]
        rev = sdq_cls(lambda x: x, [5, 3, 1], reverse=True)
        out.append(rev.pop())
        rev.push(4)
        rev.push(0)
        out += [rev.pop() for _ in range(4)]
        return out, len(rev)
    assert twin(body) == ([1, 2, 3, 4, 5, 5, 4, 3, 1, 0], 0)


def mk_session(p, tier_plugins):
    """tests/test_session_combinators.py's mk_session for either package."""
    cache, _, _ = p.empty_cache()
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


def test_session_task_queue_equivalence():
    def body(p):
        ssn = mk_session(p, [["priority"]])
        p.mod.plugins_priority.new(_args(p, {})).on_session_open(ssn)
        rng = random.Random(3)
        task_info = p.mod.api_job_info.TaskInfo
        tasks = [task_info(build_pod(
            "ns", f"t{i}", "", "Pending", {"cpu": "1", "memory": "1Gi"},
            "pg", priority=rng.randint(0, 3), ts=float(rng.randint(0, 2)),
            pkg=p.pkg)) for i in range(60)]
        rng.shuffle(tasks)
        fast = ssn.task_queue(tasks)
        assert isinstance(fast, p.mod.utils_priority_queue.SortedDrainQueue)
        slow = _pq(p, ssn.task_order_fn)
        for t in tasks:
            slow.push(t)
        drained = [fast.pop().uid for _ in range(len(tasks))]
        assert drained == [slow.pop().uid for _ in range(len(tasks))]
        rev = ssn.victims_queue(tasks)
        slow_rev = _pq(p, lambda a, b: not ssn.task_order_fn(a, b))
        for t in tasks:
            slow_rev.push(t)
        victims = [rev.pop().uid for _ in range(len(tasks))]
        assert victims == [slow_rev.pop().uid for _ in range(len(tasks))]
        return drained, victims
    twin(body)


def test_session_falls_back_without_key_form():
    def body(p):
        ssn = mk_session(p, [["priority"]])
        ssn.add_task_order_fn("priority", lambda a, b: 0)
        assert ssn.task_sort_key() is None
        return type(ssn.task_queue([])).__name__
    assert twin(body) == "PriorityQueue"
