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
    """The queue piece always lives on chip; the plan names the limit."""
    _plan((10_240, 2, 0, 0, 2_048, 1_024), DTYPES[dtype])
    with pytest.raises(ValueError, match="queues need"):
        _plan((10_240, 2, 0, 0, 2_048, 4_096), DTYPES[dtype])


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
