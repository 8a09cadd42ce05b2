"""The port's tensorizer and session against the JAX package's, on the CPU:
the feature-heavy specs of tests/test_tpu_parity.py.

Each case builds the same spec through both packages, mutates both caches
the same way (releasing pods, host ports, required and preferred pod
(anti-)affinity, scalar resources), and holds the port's tensorized
SolverInputs (leaf by leaf), SolverConfig, binds in order, pod-group
statuses, pod conditions and events exactly equal to the JAX package's,
in both float modes.
"""

import random

import pytest

from tests.test_torch_utils import assert_session_parity
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

MODES = {"x64": True, "f32": False}
SEEDS = {"releasing": [20, 21, 22, 23], "ports_affinity": [30, 31, 32, 33],
         "soft_affinity": [40, 41, 42, 43]}


def releasing_case(seed):
    """TestParityReleasing.test_random_with_releasing."""
    rng = random.Random(seed)
    queues = [("q0", 1), ("q1", 2)]
    pod_groups, pods = [], []
    nodes = [(f"n{i}", "8", "16Gi") for i in range(3)]
    for j in range(6):
        queue = f"q{rng.randrange(2)}"
        size = rng.randint(1, 4)
        pod_groups.append((f"pg{j}", "ns", rng.randint(1, size), queue))
        for i in range(size):
            if rng.random() < 0.25:
                pods.append(("ns", f"j{j}-p{i}", f"n{rng.randrange(3)}",
                             "Running", str(rng.choice([1, 2])),
                             f"{rng.choice([1, 2])}Gi", f"pg{j}"))
            else:
                pods.append(("ns", f"j{j}-p{i}", "", "Pending",
                             str(rng.choice([1, 2])),
                             f"{rng.choice([1, 2])}Gi", f"pg{j}"))

    def mutate(cache, m):
        # Mark ~40% of running pods terminating (Releasing).
        rng2 = random.Random(seed + 1000)
        for job in cache.jobs.values():
            for task in list(job.tasks.values()):
                if task.pod.spec.node_name and rng2.random() < 0.4:
                    task.pod.metadata.deletion_timestamp = 1.0
                    cache.update_pod(task.pod, task.pod)

    return dict(queues=queues, pod_groups=pod_groups, pods=pods,
                nodes=nodes), mutate


def _feature_spec(rng, n_jobs):
    spec = dict(queues=[("q0", 1), ("q1", 2)], pod_groups=[], pods=[],
                nodes=[(f"n{i}", "8", "16Gi") for i in range(4)])
    for j in range(n_jobs):
        size = rng.randint(1, 4)
        spec["pod_groups"].append(
            (f"pg{j}", "ns", rng.randint(1, size), f"q{j % 2}"))
        for i in range(size):
            spec["pods"].append(("ns", f"j{j}-p{i}", "", "Pending",
                                 str(rng.choice([1, 2])),
                                 f"{rng.choice([1, 2])}Gi", f"pg{j}"))
    return spec


def ports_affinity_case(seed):
    """TestDynamicPredicatesOnDevice.test_random_with_ports_and_affinity."""
    spec = _feature_spec(random.Random(seed), 6)

    def mutate(cache, m):
        rng2 = random.Random(seed + 500)
        for job in cache.jobs.values():
            for t in job.tasks.values():
                roll = rng2.random()
                t.pod.metadata.labels["grp"] = t.job.split("/")[-1]
                if roll < 0.3:
                    t.pod.spec.containers[0].ports = [
                        m.objects.ContainerPort(
                            host_port=rng2.choice([80, 443]))]
                elif roll < 0.5:
                    t.pod.spec.affinity = m.objects.Affinity(
                        required_pod_anti_affinity=[
                            {"grp": t.job.split("/")[-1]}])

    return spec, mutate


def soft_affinity_case(seed):
    """TestInterPodAffinityPriority.test_random_with_soft_affinity."""
    spec = _feature_spec(random.Random(seed), 5)

    def mutate(cache, m):
        rng2 = random.Random(seed + 900)
        for job in list(cache.jobs.values()):
            for t in list(job.tasks.values()):
                t.pod.metadata.labels["grp"] = t.job.split("/")[-1]
                roll = rng2.random()
                if roll < 0.4:
                    t.pod.spec.affinity = m.objects.Affinity(
                        preferred_pod_anti_affinity=[
                            (rng2.choice([10, 50]),
                             {"grp": t.job.split("/")[-1]})])
                elif roll < 0.6:
                    t.pod.spec.affinity = m.objects.Affinity(
                        preferred_pod_affinity=[
                            (rng2.choice([10, 50]),
                             {"grp": f"pg{rng2.randrange(5)}"})])

    return spec, mutate


BUILDERS = {"releasing": releasing_case,
            "ports_affinity": ports_affinity_case,
            "soft_affinity": soft_affinity_case}
CASES = [(kind, seed) for kind in sorted(SEEDS) for seed in SEEDS[kind]]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind,seed", CASES)
def test_feature_session_equals_jax(kind, seed, mode):
    spec, mutate = BUILDERS[kind](seed)
    jax_out, _ = assert_session_parity(spec, x64=MODES[mode], mutate=mutate)
    snap = jax_out["snaps"][0]
    assert not snap.needs_fallback, snap.fallback_reason
    if kind == "ports_affinity":
        assert snap.config.has_ports or snap.config.has_pod_affinity
    if kind == "soft_affinity":
        assert snap.config.has_pod_affinity_score


@pytest.mark.parametrize("mode", sorted(MODES))
def test_scalar_resources_tensorize_equal_jax(mode):
    """Extended resources widen the resource axis (cpu, memory, then the
    scalar names in order): GPUs and hugepages on some nodes, requested
    by some pods."""
    rng = random.Random(50)
    spec = _feature_spec(rng, 5)
    scalars = {}
    for name, _cpu, _mem in spec["nodes"]:
        if rng.random() < 0.6:
            scalars[name] = {"nvidia.com/gpu": str(rng.choice([1, 2, 4])),
                             "hugepages-2Mi": f"{rng.choice([1, 2])}Gi"}
    for _ns, name, *_rest in spec["pods"]:
        if rng.random() < 0.4:
            scalars[name] = {"nvidia.com/gpu": "1"}
    spec["scalars"] = scalars
    jax_out, torch_out = assert_session_parity(spec, x64=MODES[mode])
    snap = torch_out["snaps"][0]
    assert snap.resource_names[:2] == ["cpu", "memory"]
    assert "nvidia.com/gpu" in snap.resource_names
    assert jax_out["binds"]
