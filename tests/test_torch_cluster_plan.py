"""The session kernel's cluster plan, on the CPU.

``cluster_plan`` decides how one launch spreads a session over a
thread-block cluster: how many CTAs, which node slice each owns, which
rows live in shared memory and how many bytes that takes.  The kernel
itself runs only on the card (chip_smoke.py holds it against the plain
version there); these tests hold the plan to what the kernel needs, and
chip_smoke.py's cluster cases to the coverage they claim.
"""

import sys
from pathlib import Path

import pytest
import torch

from kube_batch_tpu_torch.models.synthetic import make_feature_inputs
from kube_batch_tpu_torch.ops import cuda_solver
from kube_batch_tpu_torch.ops.cuda_solver import (CLUSTER_SIZES,
                                                  SMEM_PER_CTA, cluster_plan)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

DTYPES = {"f32": torch.float32, "f64": torch.float64}
# (N, R, NP, NS, J, Q) as the wrapper passes them: the north-star buffers
# (50k pods x 10k nodes x 2k jobs x 4 queues, padded), the same with every
# feature row on, and the feature case's three resource dims.
NORTH_STAR = (10_240, 2, 0, 0, 2_048, 8)
FEATURES = (10_240, 3, 8, 8, 2_048, 8)


def _plan(shape, dtype):
    n, r, np_use, ns_use, jdim, qdim = shape
    return cluster_plan(n, r, np_use, ns_use, dtype, jdim, qdim)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [1, 40, 1_000, 1_280, 2_560, 5_120, 10_240,
                               20_480, 114_688])
def test_slices_cover_nodes_once(n, dtype):
    plan = _plan((n, 2, 0, 0, 2_048, 8), DTYPES[dtype])
    covered = [i for lo, hi in plan.slices(n) for i in range(lo, hi)]
    assert covered == list(range(n))
    assert len(plan.slices(n)) == plan.cluster in CLUSTER_SIZES
    assert plan.slice * plan.cluster >= n


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rows", [8, 512, 1_280])
def test_gathered_candidate_rows_plan_small_clusters(rows, dtype):
    """A steady session's candidate-row launch gathers C rows (about one
    per pending task, 512 at 1% churn of the north star; 8 and 1,280
    bracket it) with the north star's job and queue axes: one CTA while
    the slice fits SLICE_NODES, two beyond, and every row on chip."""
    plan = _plan((rows, 2, 0, 0, 2_048, 8), DTYPES[dtype])
    assert plan.cluster == (1 if rows <= cuda_solver.SLICE_NODES else 2)
    assert plan.slice * plan.cluster >= rows
    assert plan.smem_rows == plan.rows
    assert plan.jsta_smem and plan.jwork_smem and plan.queue_smem
    assert plan.smem_bytes <= SMEM_PER_CTA


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [NORTH_STAR, FEATURES],
                         ids=["north-star", "features"])
def test_north_star_state_fits_on_chip(shape, dtype):
    plan = _plan(shape, DTYPES[dtype])
    assert plan.smem_bytes <= SMEM_PER_CTA == 232_448
    assert plan.cluster > 1
    assert plan.smem_rows == plan.rows  # every node row on chip
    assert plan.jwork_smem
    if shape == NORTH_STAR:
        assert plan.jsta_smem


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rows_beyond_capacity_stay_in_global_memory(dtype):
    n, jdim = 200_000, 8_192
    plan = _plan((n, 2, 8, 8, jdim, 8), DTYPES[dtype])
    assert plan.cluster == CLUSTER_SIZES[-1]
    assert 0 < plan.smem_rows < plan.rows
    assert plan.smem_bytes <= SMEM_PER_CTA
    # the scratch holds the mirror of every node row and each CTA's job
    # and queue pieces
    assert plan.scratch_ints >= plan.rows * n + plan.cluster * jdim


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_queue_state_beyond_capacity_raises(dtype):
    """Once a plan refused more queues than a CTA's shared memory holds;
    now the queue piece moves to global memory and the plan fits."""
    small = _plan((10_240, 2, 0, 0, 2_048, 1_024), DTYPES[dtype])
    assert small.queue_smem
    plan = _plan((10_240, 2, 0, 0, 2_048, 4_096), DTYPES[dtype])
    assert not plan.queue_smem
    assert plan.smem_bytes <= SMEM_PER_CTA
    lay = cuda_solver.layout(2, 0, 0)
    qpiece = (lay.qact + 2 + cuda_solver.THREADS // 32) * 4_096
    jpiece = (lay.jact + 2) * 2_048
    # every CTA's queue copy, job cache and shares live in the scratch
    assert plan.scratch_ints == (plan.rows * 10_240 + plan.cluster * jpiece
                                 + plan.cluster * qpiece)
    assert small.scratch_ints == small.rows * 10_240 + small.cluster * jpiece


@pytest.mark.parametrize("bound", [8, 4])
@pytest.mark.parametrize("n", [1_000, 10_240, 114_688])
def test_plan_honours_a_cluster_bound(n, bound):
    """A card that hosts at most ``bound`` CTAs gets a plan of at most
    that many, every node covered once; the rows that no longer fit stay
    in global memory."""
    full = _plan((n, 2, 0, 0, 2_048, 8), torch.float32)
    plan = cluster_plan(n, 2, 0, 0, torch.float32, 2_048, 8,
                        max_cluster=bound)
    assert plan.cluster <= bound and plan.cluster in CLUSTER_SIZES
    assert plan.cluster == min(full.cluster, bound)
    covered = [i for lo, hi in plan.slices(n) for i in range(lo, hi)]
    assert covered == list(range(n))
    assert plan.smem_bytes <= SMEM_PER_CTA
    if full.cluster > bound:
        assert plan.smem_rows <= full.smem_rows


def test_north_star_plan_is_unchanged():
    """The north-star launch keeps its plan: 16 CTAs of 640 nodes, every
    row on chip, 142,480 B of shared memory per CTA."""
    plan = _plan(NORTH_STAR, torch.float32)
    assert (plan.cluster, plan.slice, plan.smem_rows, plan.rows,
            plan.smem_bytes) == (16, 640, 12, 12, 142_480)
    assert plan.jsta_smem and plan.jwork_smem and plan.queue_smem


@pytest.mark.parametrize("r", [10, 20])
def test_plans_for_many_resource_dims_count_their_rows(r):
    """3R + 6 node rows (plus ports and selectors); where they do not fit
    a CTA, the prefix that does stays on chip."""
    for n, np_use, ns_use in ((1_280, 0, 0), (10_240, 8, 8),
                              (114_688, 0, 0)):
        plan = cluster_plan(n, r, np_use, ns_use, torch.float64, 2_048, 8)
        assert plan.rows == 3 * r + 6 + np_use + ns_use
        assert plan.smem_bytes <= SMEM_PER_CTA
        assert plan.scratch_ints >= plan.rows * n
        if plan.smem_rows < plan.rows:
            assert plan.cluster == CLUSTER_SIZES[-1]
    big = cluster_plan(114_688, r, 0, 0, torch.float64, 2_048, 8)
    assert 0 < big.smem_rows < big.rows


def test_smoke_repaired_cases_reach_each_repair():
    """chip_smoke.py's repaired-fault cases: a queue piece in global
    memory (float64), and 10 and 20 resource dims."""
    got = {}
    for dtype in (torch.float32, torch.float64):
        for name, (inp, cfg) in chip_smoke.repaired_cases(dtype,
                                                          device="cpu"):
            got[(name, dtype)] = chip_smoke.plan_fields(cuda_solver, inp,
                                                        cfg)
    assert got[("queues-2500-in-global", torch.float64)]["queue_piece"] \
        == "global"
    assert {f["r"] for f in got.values()} >= {2, 10, 20}
    for dtype in (torch.float32, torch.float64):
        on, rows = got[("synthetic-r20-rows-in-global", dtype)][
            "rows_on_chip"].split("/")
        assert 0 < int(on) < int(rows) == 66


@pytest.mark.parametrize("mode", ["f64", "f32"])
def test_plain_equals_pallas_interpret_at_ten_dims(mode):
    """The large-R semantics pinned before the card sees them: at R = 10
    the plain version equals the JAX Pallas kernel in interpret mode."""
    import jax
    import numpy as np

    from kube_batch_tpu.ops import pallas_solver as jax_pallas
    from kube_batch_tpu_torch.models.synthetic import with_scalar_dims
    from tests.test_torch_solver import jax_cfg, to_jax

    dtype, x64 = {"f64": (torch.float64, True),
                  "f32": (torch.float32, False)}[mode]
    inp, cfg = with_scalar_dims(make_feature_inputs(3, dtype=dtype,
                                                    device="cpu"), 10, seed=3)
    ours, _ = cuda_solver.solve_allocate_plain(inp, cfg)
    with jax.enable_x64(x64):
        ref = jax_pallas.solve_allocate_pallas(to_jax(inp), jax_cfg(cfg),
                                               interpret=True)
        ref = {f: np.asarray(getattr(ref, f)) for f in ref._fields}
    for f in ("assignment", "kind", "order", "step"):
        assert np.array_equal(getattr(ours, f).numpy(), ref[f]), f
    placed = ours.kind > 0
    assert 0 < int(placed.sum()) < int((inp.job_count).sum())


def test_plan_prefers_small_slices():
    """The smallest cluster whose slice is at most SLICE_NODES."""
    for n in (64, 1_024, 1_280, 2_560, 10_240):
        plan = _plan((n, 2, 0, 0, 64, 8), torch.float32)
        assert plan.slice <= cuda_solver.SLICE_NODES
        smaller = [c for c in CLUSTER_SIZES if c < plan.cluster]
        assert all(-(-n // c) > cuda_solver.SLICE_NODES for c in smaller)


def test_plan_of_reads_the_conf():
    """Port and selector rows count only when the conf reads them."""
    inp, cfg = make_feature_inputs(0, n_nodes=3_000, dtype=torch.float32,
                                   device="cpu")
    assert cuda_solver.plan_of(inp, cfg).rows == 3 * 3 + 6 + 8 + 8
    off = cfg._replace(has_ports=False, has_pod_affinity=False,
                       has_pod_affinity_score=False)
    assert cuda_solver.plan_of(inp, off).rows == 3 * 3 + 6


def test_plan_fields_are_launch_arguments():
    """The plan's fields up to smem_bytes are the C struct's plan fields,
    in order, right after the shapes."""
    fields = [name for name, _ in cuda_solver.SolveArgs._fields_]
    plan_fields = list(cuda_solver._PLAN_FIELDS)
    start = fields.index("cluster")
    assert fields[start:start + len(plan_fields)] == plan_fields
    assert fields[start - 1] == "n_sig"
    assert "scratch_ints" not in fields


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_smoke_cluster_cases_cover_every_cluster_size(dtype):
    """chip_smoke.py's cluster cases reach every cluster size the plan can
    return, with N not a multiple of C x 1024, and one case keeps rows in
    global memory."""
    seen, partial = set(), False
    for name, (inp, cfg) in chip_smoke.cluster_cases(DTYPES[dtype],
                                                     device="cpu"):
        got = chip_smoke.plan_fields(cuda_solver, inp, cfg)
        seen.add(got["cluster"])
        if got["cluster"] > 1 and name.startswith("cluster-1000"):
            assert got["n"] % (got["cluster"] * 1024), name
        on_chip, rows = got["rows_on_chip"].split("/")
        partial |= on_chip != rows
    assert seen | {1} == set(CLUSTER_SIZES)
    assert partial


def test_last_cta_case_places_into_the_last_slice():
    cases = dict(chip_smoke.cluster_cases(torch.float32, device="cpu"))
    inp, cfg = cases["cluster-last-cta-wins"]
    plan = cuda_solver.plan_of(inp, cfg)
    lo = plan.slices(inp.node_idle.shape[0])[-1][0]
    result, _ = cuda_solver.solve_allocate_plain(inp, cfg)
    placed = result.kind > 0
    first = result.assignment[placed][result.order[placed].argmin()]
    assert plan.cluster > 1 and int(first) >= lo


def test_feature_inputs_widen_without_changing_the_default():
    base, _ = make_feature_inputs(0, dtype=torch.float64, device="cpu")
    same, _ = make_feature_inputs(0, n_nodes=24, dtype=torch.float64,
                                  device="cpu")
    wide, _ = make_feature_inputs(0, n_nodes=3_000, dtype=torch.float64,
                                  device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(base, same))
    assert base.node_idle.shape[0] == 32
    assert wide.node_idle.shape[0] == 3_072
    assert int(wide.node_exists.sum()) == 3_000
