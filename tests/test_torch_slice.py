"""The port's slice end to end on the CPU, against the JAX package.

``make_synthetic_inputs`` must give the JAX arrays; ship -> dispatch ->
fetch must give JAX's (assignment, kind, order, ordered); entry points
refuse to run without CUDA unless asked for the CPU; the kernel wrapper
refuses CPU tensors.
"""

import jax
import numpy as np
import pytest
import torch

from kube_batch_tpu.models import shipping as jax_shipping
from kube_batch_tpu.models.synthetic import \
    make_synthetic_inputs as jax_make_synthetic_inputs
from kube_batch_tpu.ops import solver as jax_solver
from kube_batch_tpu_torch import resolve_device
from kube_batch_tpu_torch.models import shipping
from kube_batch_tpu_torch.models.synthetic import (make_feature_inputs,
                                                   make_synthetic_inputs)
from kube_batch_tpu_torch.ops import cuda_solver, resources, solver
from test_torch_solver import jax_cfg
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

torch.set_num_threads(1)

MODES = {"f64": (torch.float64, True), "f32": (torch.float32, False)}
SHAPES = [(200, 40, 20, 3, 0.8, 0), (1500, 300, 90, 5, 0.5, 3)]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_make_synthetic_inputs_equals_jax(shape, mode):
    dtype, x64 = MODES[mode]
    *sizes, gang, seed = shape
    ours, cfg = make_synthetic_inputs(*sizes, gang_fraction=gang, seed=seed,
                                      dtype=dtype, device="cpu")
    with jax.enable_x64(x64):
        ref, ref_cfg = jax_make_synthetic_inputs(*sizes, gang_fraction=gang,
                                                 seed=seed)
        ref = [np.asarray(a) for a in ref]
    assert jax_cfg(cfg) == ref_cfg
    for name, a, b in zip(solver.SolverInputs._fields, ours, ref):
        assert a.numpy().dtype == b.dtype, name
        assert np.array_equal(a.numpy(), b), name


def _jax_session(inp, cfg):
    """JAX's ship -> dispatch -> fetch on a numpy staging of ``inp``."""
    staging = jax_solver.SolverInputs(*[t.numpy() for t in inp])
    shipped = jax_shipping.DeviceResidentShipper().ship(staging, cfg)
    return jax_solver.fetch_solve(jax_solver.dispatch_solve(shipped, cfg))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", ["synthetic", "features"])
def test_cpu_path_equals_jax(case, mode):
    dtype, x64 = MODES[mode]
    if case == "synthetic":
        inp, cfg = make_synthetic_inputs(400, 50, 30, 4, seed=11, dtype=dtype,
                                         device="cpu")
    else:
        inp, cfg = make_feature_inputs(2, dtype=dtype, device="cpu")
    staging = solver.SolverInputs(*[t.numpy() for t in inp])
    shipper = shipping.resident_shipper(type("Owner", (), {})(),
                                        device="cpu")
    before = solver.solver_inflight()
    pending = solver.dispatch_solve(shipper.ship(staging, cfg), cfg)
    assert solver.solver_inflight() == before + 1
    ours = solver.fetch_solve(pending)
    assert solver.solver_inflight() == before
    with jax.enable_x64(x64):
        ref = _jax_session(inp, jax_cfg(cfg))
    assert ours[3].size > 0
    for name, a, b in zip(("assignment", "kind", "order", "ordered"), ours,
                          ref):
        assert a.dtype == np.int32, name
        assert np.array_equal(a, np.asarray(b)), name


def test_cpu_route_and_discard():
    inp, cfg = make_synthetic_inputs(100, 20, 10, 2, seed=1,
                                     dtype=torch.float64, device="cpu")
    assert solver.choose_solver_mesh(inp) == ("torch", None)
    before = solver.solver_inflight()
    pending = solver.dispatch_solve(inp, cfg)
    assert pending.ready is None
    solver.discard_solve(pending)
    assert solver.solver_inflight() == before
    result = solver.best_solve_allocate(inp, cfg)
    assert torch.equal(result.assignment, pending.packed[0])


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_synthetic_inputs(100, 20, 10, 2, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_feature_inputs(0, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shipping.DeviceResidentShipper()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shipping.resident_shipper(type("Owner", (), {})())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resources.eps_vector(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="float32 or torch.float64"):
        make_synthetic_inputs(100, 20, 10, 2, dtype=torch.float16,
                              device="cpu")


def test_solve_allocate_cuda_raises_on_cpu_tensors():
    inp, cfg = make_synthetic_inputs(100, 20, 10, 2, seed=1,
                                     dtype=torch.float32, device="cpu")
    launches = cuda_solver.solve_allocate_cuda.launches
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        cuda_solver.solve_allocate_cuda(inp, cfg)
    assert cuda_solver.solve_allocate_cuda.launches == launches


def test_weights_that_overflow_int32_are_refused():
    inp, cfg = make_synthetic_inputs(100, 20, 10, 2, seed=1,
                                     dtype=torch.float32, device="cpu")
    cfg = cfg._replace(weights=cfg.weights._replace(least_requested=2 ** 30))
    with pytest.raises(ValueError, match="overflow int32"):
        cuda_solver.solve_allocate_plain(inp, cfg)
