"""The port's JobInfo/TaskInfo against the JAX package's: the twin of
tests/test_job_info.py.  Each body runs once per package (``twin``); the
results must be equal.  The clone runs through the C ``clone_task_map``
and, with it removed (what ``KUBE_BATCH_TPU_NO_NATIVE=1`` leaves), through
the Python loop, in both packages."""

import pytest

import kube_batch_tpu.native as jax_native
import kube_batch_tpu_torch.native as torch_native
from tests.test_torch_utils import twin


def task(p, ns, name, node, phase, cpu="1", mem="1Gi", group="group1"):
    return p.m.api.TaskInfo(p.pod(ns, name, node, phase,
                                  {"cpu": cpu, "memory": mem},
                                  groupname=group))


def index(job):
    return {st.name: sorted(b) for st, b in job.task_status_index.items()}


def raises(fn, exc):
    try:
        fn()
    except exc as e:
        return type(e).__name__
    return None


class TestTaskInfo:
    def test_from_pod(self):
        def body(p):
            t = task(p, "ns", "p1", "n1", "Running")
            return t.job, t.status.name, t.resreq.milli_cpu, t.priority
        assert twin(body) == ("ns/group1", "Running", 1000.0, 1)

    def test_no_group_annotation(self):
        assert twin(lambda p: p.m.api.get_job_id(p.pod(
            "ns", "p1", "", "Pending", {"cpu": "1", "memory": "1Gi"}))) == ""

    def test_status_mapping(self):
        cases = (("a", "", "Pending"), ("b", "n1", "Pending"),
                 ("c", "n1", "Running"), ("d", "n1", "Succeeded"),
                 ("e", "n1", "Failed"), ("f", "n1", "Unknown"))
        got = twin(lambda p: [task(p, "n", name, node, phase).status.name
                              for name, node, phase in cases])
        assert got == ["Pending", "Bound", "Running", "Succeeded", "Failed",
                       "Unknown"]

    def test_releasing_on_deletion(self):
        def body(p):
            pod = p.pod("n", "g", "n1", "Running",
                        {"cpu": "1", "memory": "1Gi"})
            pod.metadata.deletion_timestamp = 1.0
            return p.m.api.TaskInfo(pod).status.name
        assert twin(body) == "Releasing"


class TestJobInfo:
    def test_add_task(self):
        def body(p):
            job = p.m.api.JobInfo("uid", task(p, "ns", "p1", "n1", "Running"),
                                  task(p, "ns", "p2", "n1", "Running"))
            return (len(job.tasks), job.total_request.milli_cpu,
                    job.allocated.milli_cpu, index(job))
        got = twin(body)
        assert got[:3] == (2, 2000.0, 2000.0)
        assert len(got[3]["Running"]) == 2

    def test_pending_not_allocated(self):
        def body(p):
            job = p.m.api.JobInfo("uid", task(p, "ns", "p1", "", "Pending"))
            return job.allocated.milli_cpu, job.total_request.milli_cpu
        assert twin(body) == (0.0, 1000.0)

    def test_delete_task(self):
        def body(p):
            t1 = task(p, "ns", "p1", "n1", "Running")
            t2 = task(p, "ns", "p2", "n1", "Running")
            job = p.m.api.JobInfo("uid", t1, t2)
            job.delete_task_info(t1)
            mid = (len(job.tasks), job.allocated.milli_cpu, index(job))
            job.delete_task_info(t2)
            return mid, index(job)
        (n, alloc, mid), end = twin(body)
        assert (n, alloc) == (1, 1000.0) and "Running" in mid
        assert "Running" not in end

    def test_delete_missing_raises(self):
        assert twin(lambda p: raises(
            lambda: p.m.api.JobInfo("uid").delete_task_info(
                task(p, "ns", "nope", "n1", "Running")),
            KeyError)) == "KeyError"

    def test_update_status_moves_index(self):
        def body(p):
            t = task(p, "ns", "p1", "", "Pending")
            job = p.m.api.JobInfo("uid", t)
            job.update_task_status(t, p.m.api.TaskStatus.Allocated)
            return index(job), job.allocated.milli_cpu
        idx, alloc = twin(body)
        assert "Pending" not in idx and len(idx["Allocated"]) == 1
        assert alloc == 1000.0

    def test_gang_counters(self):
        def body(p):
            st = p.m.api.TaskStatus
            tasks = [task(p, "ns", f"p{i}", "", "Pending") for i in range(3)]
            job = p.m.api.JobInfo("uid", *tasks)
            job.min_available = 2
            seen = [(job.ready_task_num(), job.valid_task_num(), job.ready())]
            job.update_task_status(tasks[0], st.Allocated)
            job.update_task_status(tasks[1], st.Pipelined)
            seen.append((job.ready_task_num(), job.waiting_task_num(),
                         job.ready(), job.pipelined()))
            job.update_task_status(tasks[1], st.Allocated)
            seen.append(job.ready())
            return seen
        assert twin(body) == [(0, 3, False), (1, 1, False, True), True]


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


def test_clone(native_clone):
    def body(p):
        t = task(p, "ns", "p1", "n1", "Running")
        job = p.m.api.JobInfo("uid", t)
        job.min_available = 1
        c = job.clone()
        c.tasks[t.uid].resreq.add(p.m.api.Resource(1000))
        return (job.tasks[t.uid].resreq.milli_cpu, c.min_available,
                c.tasks[t.uid] is not job.tasks[t.uid])
    assert twin(body) == (1000.0, 1, True)


def test_clone_keeps_every_status_bucket(native_clone):
    def body(p):
        st = p.m.api.TaskStatus
        tasks = [task(p, "ns", f"p{i}", "", "Pending") for i in range(4)]
        job = p.m.api.JobInfo("uid", *tasks)
        job.update_task_status(tasks[0], st.Allocated)
        job.update_task_status(tasks[1], st.Pipelined)
        c = job.clone()
        moved = all(c.task_status_index[t.status][uid] is t
                    for uid, t in c.tasks.items())
        return (index(c) == index(job), moved,
                sorted((u, t.status.name) for u, t in c.tasks.items()),
                c.allocated.milli_cpu, c.total_request.milli_cpu)
    got = twin(body)
    assert got[0] and got[1] and got[3:] == (1000.0, 4000.0)
