"""The port's NodeInfo accounting against the JAX package's: the twin of
tests/test_node_info.py.  Each body runs once per package (``twin``); the
results must be equal.  The clone runs through the C ``clone_task_map``
and, with it removed (what ``KUBE_BATCH_TPU_NO_NATIVE=1`` leaves), through
the Python loop, in both packages."""

import pytest

import kube_batch_tpu.native as jax_native
import kube_batch_tpu_torch.native as torch_native
from tests.test_torch_utils import twin


def mk_node(p, cpu="8", mem="8Gi"):
    return p.m.api.NodeInfo(p.node("n1", {"cpu": cpu, "memory": mem,
                                          "pods": 110}))


def mk_task(p, name, phase="Running", node="n1", cpu="1", mem="1Gi"):
    return p.m.api.TaskInfo(p.pod("ns", name, node, phase,
                                  {"cpu": cpu, "memory": mem}))


def acct(ni):
    return (ni.idle.milli_cpu, ni.used.milli_cpu, ni.releasing.milli_cpu,
            len(ni.tasks))


def raises(fn, exc):
    try:
        fn()
    except exc as e:
        return type(e).__name__
    return None


class TestNodeInfo:
    def test_add_task_accounting(self):
        def body(p):
            ni = mk_node(p)
            ni.add_task(mk_task(p, "p1"))
            ni.add_task(mk_task(p, "p2", cpu="2"))
            return acct(ni)
        assert twin(body) == (5000.0, 3000.0, 0.0, 2)

    def test_add_duplicate_raises(self):
        def body(p):
            ni = mk_node(p)
            ni.add_task(mk_task(p, "p1"))
            return raises(lambda: ni.add_task(mk_task(p, "p1")), ValueError)
        assert twin(body) == "ValueError"

    def test_add_wrong_node_raises(self):
        assert twin(lambda p: raises(lambda: mk_node(p).add_task(
            mk_task(p, "p1", node="other")), ValueError)) == "ValueError"

    def test_releasing_accounting(self):
        def body(p):
            ni = mk_node(p)
            t = mk_task(p, "p1")
            t.status = p.m.api.TaskStatus.Releasing
            ni.add_task(t)
            held = acct(ni)
            ni.remove_task(t)
            return held, acct(ni)
        assert twin(body) == ((7000.0, 1000.0, 1000.0, 1),
                              (8000.0, 0.0, 0.0, 0))

    def test_pipelined_consumes_releasing(self):
        def body(p):
            st = p.m.api.TaskStatus
            ni = mk_node(p)
            rel = mk_task(p, "p1")
            rel.status = st.Releasing
            ni.add_task(rel)
            pip = mk_task(p, "p2")
            pip.status = st.Pipelined
            ni.add_task(pip)
            return acct(ni)
        assert twin(body) == (7000.0, 2000.0, 0.0, 2)

    def test_remove_task(self):
        def body(p):
            ni = mk_node(p)
            t = mk_task(p, "p1")
            ni.add_task(t)
            ni.remove_task(t)
            return acct(ni), raises(lambda: ni.remove_task(t), KeyError)
        assert twin(body) == ((8000.0, 0.0, 0.0, 0), "KeyError")

    def test_overcommit_raises(self):
        assert twin(lambda p: raises(lambda: mk_node(p, cpu="1").add_task(
            mk_task(p, "big", cpu="4")), ValueError)) == "ValueError"

    def test_status_snapshot_on_node(self):
        def body(p):
            ni = mk_node(p)
            t = mk_task(p, "p1")
            ni.add_task(t)
            t.status = p.m.api.TaskStatus.Releasing
            return list(ni.tasks.values())[0].status.name
        assert twin(body) == "Running"

    def test_set_node_rebuilds(self):
        def body(p):
            ni = mk_node(p)
            ni.add_task(mk_task(p, "p1"))
            ni.set_node(p.node("n1", {"cpu": "16", "memory": "16Gi",
                                      "pods": 110}))
            return acct(ni)
        assert twin(body)[:2] == (15000.0, 1000.0)

    def test_out_of_sync_detection(self):
        def body(p):
            ni = mk_node(p)
            ni.add_task(mk_task(p, "p1", cpu="6"))
            ni.set_node(p.node("n1", {"cpu": "2", "memory": "2Gi",
                                      "pods": 110}))
            return ni.ready(), ni.state.reason
        assert twin(body) == (False, "OutOfSync")


@pytest.fixture(params=[True, False], ids=["c-clone", "python-clone"])
def native_clone(request, monkeypatch):
    """The C clone_task_map in both packages, or neither (the Python
    loop that KUBE_BATCH_TPU_NO_NATIVE=1 leaves)."""
    assert torch_native.clone_task_map is not None
    assert jax_native.clone_task_map is not None
    if not request.param:
        monkeypatch.setattr(torch_native, "clone_task_map", None)
        monkeypatch.setattr(jax_native, "clone_task_map", None)
    return request.param


@pytest.mark.parametrize("lazy", ["0", "1"], ids=["eager", "lazy"])
def test_clone(native_clone, lazy, monkeypatch):
    """A clone has the node's accounting and its own copies of the tasks,
    with the lazy task maps on and off."""
    monkeypatch.setenv("KUBE_BATCH_TPU_LAZY_TASKS", lazy)

    def body(p):
        ni = mk_node(p)
        for i in range(3):
            ni.add_task(mk_task(p, f"p{i}"))
        c = ni.clone()
        tasks = sorted((k, t.uid, t.status.name, t.node_name)
                       for k, t in c.tasks.items())
        copied = all(c.tasks[k] is not ni.tasks[k] for k in ni.tasks)
        return acct(c) == acct(ni), tasks, copied
    same, tasks, copied = twin(body)
    assert same and copied and len(tasks) == 3
