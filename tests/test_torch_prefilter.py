"""The candidate-row solve of the port against the JAX package, on the CPU.

Twins of the candidate cases of tests/test_cycle_floors.py.  The port's
``derive_candidates`` must give the same candidate set as the
reference's on the same staged inputs; its gather plus the plain version
of the session kernel (what the torch route runs, and what the card's
kernel is held against) must place exactly as the JAX two-level
``solve_allocate`` and the ``solve_allocate_stepwise`` oracle; and whole
churn schedules must bind identically with the prefilter on, with the
port's ``KUBE_BATCH_TPU_INCREMENTAL=0`` control, and in the JAX package.
Float64 (x64) and float32, tolerance 0.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kube_batch_tpu.ops import prefilter as jax_prefilter
from kube_batch_tpu.ops import solver as jax_solver
from kube_batch_tpu_torch.metrics import metrics
from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
from kube_batch_tpu_torch.ops import cuda_solver, prefilter, resources
from kube_batch_tpu_torch.ops import scoring, solver
from tests.test_torch_solver import jax_cfg, to_jax
from tests.test_torch_utils import Arm, environ

torch.set_num_threads(1)

MODES = {"x64": (torch.float64, True), "f32": (torch.float32, False)}


class _Snap:
    """What derive_candidates reads of a TensorSnapshot."""

    def __init__(self, inputs, config, p_real):
        self.inputs = inputs
        self.config = config
        self.tasks = [None] * p_real


def _staged(inp):
    """The host staging of port inputs (numpy leaves), as the tensorizer
    hands it to the prefilter."""
    return solver.SolverInputs(*[t.numpy() for t in inp])


def _result(assignment, kind, order):
    a, k, o = (np.asarray(x) for x in (assignment, kind, order))
    return np.where(k > 0, a, -1).tolist(), k.tolist(), o.tolist()


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_candidate_solve_matches_full_and_stepwise(seed, mode):
    """Gather + plain solve on the candidate rows == the JAX full
    two-level solve == the stepwise oracle; the candidate set equals the
    reference's."""
    dtype, x64 = MODES[mode]
    inp, cfg = make_synthetic_inputs(40, 300, 6, 2, seed=seed, dtype=dtype,
                                     device="cpu")
    p_real = int(inp.job_count.sum())
    cand = prefilter.derive_candidates(_Snap(_staged(inp), cfg, p_real),
                                       "torch")
    assert cand is not None and cand.count < inp.node_idle.shape[0]
    with jax.enable_x64(x64):
        jinp = to_jax(inp)
        ref_cand = jax_prefilter.derive_candidates(
            _Snap(jax.tree.map(np.asarray, jinp), jax_cfg(cfg), p_real),
            "xla", None)
        full = jax_solver.solve_allocate(jinp, jax_cfg(cfg))
        step = jax_solver.solve_allocate_stepwise(jinp, jax_cfg(cfg))
        want = _result(full.assignment, full.kind, full.order)
        assert _result(step.assignment, step.kind, step.order) == want
    assert cand.count == ref_cand.count
    for field in ("idx", "valid", "remap"):
        assert np.array_equal(getattr(cand, field),
                              getattr(ref_cand, field)), field
    pending = solver.dispatch_solve(inp, cfg, candidates=cand)
    assert np.array_equal(pending.remap, cand.remap)
    a, k, o, ordered = solver.fetch_solve(pending)
    assert _result(a, k, o) == want
    placed = k > 0
    assert placed.any()
    assert int(a[placed].max()) < inp.node_idle.shape[0]
    assert np.array_equal(ordered, np.asarray(
        np.nonzero(placed)[0])[np.argsort(o[placed], kind="stable")])


def test_gathered_leaves_are_copies():
    """A later in-place delta ship of the resident inputs must not move a
    gathered solve's inputs."""
    inp, cfg = make_synthetic_inputs(40, 300, 6, 2, seed=0,
                                     dtype=torch.float32, device="cpu")
    cand = prefilter.derive_candidates(
        _Snap(_staged(inp), cfg, int(inp.job_count.sum())), "torch")
    idx = torch.from_numpy(cand.idx).long()
    sub = solver._gather_candidate_inputs(inp, idx,
                                          torch.from_numpy(cand.valid))
    before = {f: getattr(sub, f).clone() for f in sub._fields}
    for leaf in inp:
        if leaf.dtype == torch.bool:
            leaf.logical_not_()
        else:
            leaf.add_(1)
    for f in ("node_idle", "node_used", "node_exists", "sig_mask",
              "sig_bonus", "node_count"):
        assert torch.equal(getattr(sub, f), before[f]), f
    assert sub.node_idle.shape[0] == cand.idx.shape[0]
    assert sub.sig_mask.shape == (inp.sig_mask.shape[0], cand.idx.shape[0])
    # node_coords stays [N, 8]: the solve never reads it
    assert sub.node_coords.shape == inp.node_coords.shape


def test_candidate_result_outside_gathered_rows_raises():
    """A placement outside the gathered program's rows is a malformed
    result: fetch_solve raises instead of clipping."""
    remap = np.arange(8, dtype=np.int32) * 3
    packed = torch.tensor([[0, 9, -1], [1, 1, 0], [0, 1, -1], [0, 1, 2]],
                          dtype=torch.int32)
    with pytest.raises(RuntimeError, match="gathered rows"):
        solver.fetch_solve(solver.PendingSolve(packed, None, remap))
    ok = torch.tensor([[0, 7, -1], [1, 1, 0], [0, 1, -1], [0, 1, 2]],
                      dtype=torch.int32)
    a, k, _o, ordered = solver.fetch_solve(
        solver.PendingSolve(ok, None, remap))
    assert a.tolist() == [0, 21, -1] and ordered.tolist() == [0, 1]


def test_sharded_route_raises():
    inp, cfg = make_synthetic_inputs(40, 300, 6, 2, seed=0,
                                     dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError):
        prefilter.derive_candidates(
            _Snap(_staged(inp), cfg, int(inp.job_count.sum())), "sharded")


CHURN = ["bind_echo", "evict", "job_update", "node_update"]


def _e2e_run(pkg, mutation, signatures, inc, x64):
    with environ({"KUBE_BATCH_TPU_INCREMENTAL": "1" if inc else "0"}):
        arm = Arm(pkg, (60, 64, 10, 2), n_signatures=signatures, x64=x64)
        mark = len(arm.cache.events)
        fingerprints = [arm.cycle(), arm.cycle()]
        if mutation == "bind_echo":
            arm.add_churn_job("be")
        elif mutation == "evict":
            arm.cache.evict(arm.running_task(), "preempted")
        elif mutation == "job_update":
            t = arm.running_task()
            new = dataclasses.replace(t.pod, spec=dataclasses.replace(
                t.pod.spec, containers=[arm.m.api.Container(
                    requests={"cpu": "250m", "memory": "512Mi"})]))
            arm.cache.update_pod(t.pod, new)
        elif mutation == "node_update":
            arm.update_node_alloc(sorted(arm.cache.nodes)[0])
        routes = []
        for _ in range(3):
            arm.add_churn_job(f"r{len(fingerprints)}", n_pods=2)
            fingerprints.append(arm.cycle())
            last = getattr(arm.action, "last", None)
            if pkg == "torch" and last is not None:
                routes.append((last.route, last.candidates is not None))
    return fingerprints, list(arm.cache.events)[mark:], routes


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("signatures", [1, 4])
@pytest.mark.parametrize("mutation", CHURN)
def test_candidate_e2e_binds_identical(mutation, signatures, mode):
    """One churn schedule with the prefilter on, with the port's control
    arm and in the JAX package: binds and events equal, and the port's
    incremental arm took the candidate route."""
    x64 = MODES[mode][1]
    fired = metrics.candidate_solve_counts().get("fired", 0)
    ours = _e2e_run("torch", mutation, signatures, True, x64)
    assert metrics.candidate_solve_counts().get("fired", 0) > fired
    assert ("torch", True) in ours[2]
    ctl = _e2e_run("torch", mutation, signatures, False, x64)
    assert all(not gathered for _route, gathered in ctl[2])
    ref = _e2e_run("jax", mutation, signatures, True, x64)
    assert ours[:2] == ctl[:2] == ref[:2]


def test_prefilter_host_mirrors_equal_device_math():
    """The prefilter's host fit and score mirrors equal the port's
    torch fit and grid score and the JAX package's, on adversarial
    inputs (epsilon band, zero capacity)."""
    import jax.numpy as jnp
    from kube_batch_tpu.ops.scoring import grid_score as jax_grid_score
    from kube_batch_tpu.ops.scoring import shifted_caps as jax_shifted_caps
    from kube_batch_tpu.ops.solver import _unrolled_le

    rng = np.random.default_rng(5)
    n, r = 64, 3
    mat = rng.integers(0, 40, size=(n, r)).astype(np.int32)
    eps = resources.eps_vector(r, device="cpu")
    for req in ([0, 0, 0], [9, 10, 11], [39, 40, 41],
                [5, 0, resources.EPS_QUANTA]):
        req = np.asarray(req, np.int64)
        host = prefilter._fit_rows(req, mat)
        ours = resources.less_equal_vec(
            torch.tensor(req, dtype=torch.int32)[None, :],
            torch.from_numpy(mat), eps,
            resources.scalar_dims_mask(r, device="cpu")).numpy()
        ref = np.asarray(_unrolled_le(jnp.asarray(req, jnp.int32),
                                      jnp.asarray(mat), r))
        assert np.array_equal(host, ours), req
        assert np.array_equal(host, ref), req
    used = rng.integers(0, 1 << 20, size=(n, 2)).astype(np.int32)
    alloc = rng.integers(1, 1 << 21, size=(n, 2)).astype(np.int32)
    alloc[0] = 0  # zero-cap branch
    shift = np.asarray([3, 7], np.int32)
    for w in ((1, 0, 1), (1, 2, 3), (0, 1, 0)):
        res = rng.integers(0, 1 << 10, size=(2,)).astype(np.int64)
        host = prefilter._grid_score_rows(res, used, alloc, shift,
                                          scoring.ScoreWeights(*w))
        ours = scoring.score_nodes(
            torch.tensor(res, dtype=torch.int32), torch.from_numpy(used),
            torch.from_numpy(alloc), torch.from_numpy(shift),
            scoring.ScoreWeights(*w)).numpy()
        cs, den = jax_shifted_caps(jnp.asarray(alloc), jnp.asarray(shift))
        ref = np.asarray(jax_grid_score(
            jnp.asarray(res, jnp.int32), jnp.asarray(used),
            jnp.asarray(shift), cs, den, jax_cfg(solver.SolverConfig(
                weights=scoring.ScoreWeights(*w))).weights))
        assert np.array_equal(host, ours.astype(np.int64)), w
        assert np.array_equal(host, ref.astype(np.int64)), w


def test_candidate_env_gate_disables():
    inp, cfg = make_synthetic_inputs(20, 200, seed=0, dtype=torch.float64,
                                     device="cpu")
    with environ({prefilter.CANDIDATE_SOLVE_ENV: "0"}):
        assert prefilter.derive_candidates(
            _Snap(_staged(inp), cfg, 20), "torch") is None
        assert jax_prefilter.derive_candidates(
            _Snap(_staged(inp), jax_cfg(cfg), 20), "xla", None) is None


def test_candidate_stands_down_on_dynamic_predicates():
    """Host ports and pod (anti-)affinity make untouched-node scores
    occupancy-dependent: neither package ranks under them."""
    inp, cfg = make_synthetic_inputs(20, 200, seed=0, dtype=torch.float64,
                                     device="cpu")
    assert prefilter.derive_candidates(_Snap(_staged(inp), cfg, 20),
                                       "torch") is not None
    for flag in ("has_ports", "has_pod_affinity", "has_pod_affinity_score"):
        flagged = cfg._replace(**{flag: True})
        assert prefilter.derive_candidates(
            _Snap(_staged(inp), flagged, 20), "torch") is None
        assert jax_prefilter.derive_candidates(
            _Snap(_staged(inp), jax_cfg(flagged), 20), "xla", None) is None


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("rows", [8, 512, 1280])
def test_gathered_small_node_axes_plain_equals_two_level(rows, mode):
    """The gathered shapes the steady state gives the kernel (C = 8, 512
    and 1,280 rows of a larger resident axis): the plain version equals
    the JAX two-level solve on them, and the plan takes one CTA or a
    small cluster."""
    dtype, x64 = MODES[mode]
    inp, cfg = make_synthetic_inputs(3 * rows, 4 * rows, 6, 2, seed=rows,
                                     dtype=dtype, device="cpu")
    rng = np.random.default_rng(rows)
    idx = np.sort(rng.choice(4 * rows, size=rows, replace=False))
    valid = np.ones(rows, bool)
    valid[-1] = rows == 8  # a padding row at the larger sizes
    sub = solver._gather_candidate_inputs(inp, torch.from_numpy(idx).long(),
                                          torch.from_numpy(valid))
    ours, _ = cuda_solver.solve_allocate_plain(sub, cfg)
    with jax.enable_x64(x64):
        ref = jax_solver.solve_allocate(to_jax(sub), jax_cfg(cfg))
        ref = {f: np.asarray(getattr(ref, f)) for f in ref._fields}
    assert np.array_equal(ours.assignment.numpy(), ref["assignment"])
    assert np.array_equal(ours.order.numpy(), ref["order"])
    assert int(ours.step) > 0
    plan = cuda_solver.plan_of(sub, cfg)
    assert plan.cluster == (1 if rows <= cuda_solver.SLICE_NODES else 2)
    assert plan.smem_rows == plan.rows
