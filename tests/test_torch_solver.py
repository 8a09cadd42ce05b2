"""The port's session solve against the JAX package's, on the CPU.

``build_buffers`` must equal ``_build_buffers``; ``solve_allocate_plain``
(the plain version of the CUDA kernel, which the CPU route runs) must
equal ``solve_allocate_pallas(..., interpret=True)`` exactly on
assignment, kind, order and step, and the two-level XLA
``solve_allocate`` on assignment and order.  Cases: the seeds of
tests/test_pallas_solver.py, one with other key orders, flags and
weights, and sessions that drive every feature branch, each in float64
(x64 on) and float32 (x64 off).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.ops import pallas_solver as jax_pallas
from kube_batch_tpu.ops import solver as jax_solver
from kube_batch_tpu.ops.scoring import ScoreWeights as JaxScoreWeights
from kube_batch_tpu_torch.models.synthetic import (make_feature_inputs,
                                                   make_synthetic_inputs)
from kube_batch_tpu_torch.ops import cuda_solver
from kube_batch_tpu_torch.ops.solver import SolverInputs

torch.set_num_threads(1)


def _other_conf(built):
    """Other key orders, flags and weights on the same kind of session."""
    inp, cfg = built
    return inp, cfg._replace(job_key_order=("drf", "priority"),
                             queue_key_order=(), has_gang=False,
                             has_proportion=False,
                             weights=cfg.weights._replace(most_requested=2))


# name -> builder(dtype) of port inputs on the CPU
CASES = {
    "seed0": lambda dt: make_synthetic_inputs(200, 40, 20, 3, seed=0,
                                              dtype=dt, device="cpu"),
    "seed1": lambda dt: make_synthetic_inputs(200, 40, 20, 3, seed=1,
                                              dtype=dt, device="cpu"),
    "seed2": lambda dt: make_synthetic_inputs(200, 40, 20, 3, seed=2,
                                              dtype=dt, device="cpu"),
    "seed7-gang0.5": lambda dt: make_synthetic_inputs(
        300, 60, 25, 4, gang_fraction=0.5, seed=7, dtype=dt, device="cpu"),
    "seed3-other-conf": lambda dt: _other_conf(make_synthetic_inputs(
        200, 40, 20, 3, seed=3, dtype=dt, device="cpu")),
    "features": lambda dt: make_feature_inputs(0, dtype=dt, device="cpu"),
    "features-seed1": lambda dt: make_feature_inputs(1, dtype=dt,
                                                     device="cpu"),
    "features-seed2": lambda dt: make_feature_inputs(2, dtype=dt,
                                                     device="cpu"),
}
# (port float dtype, JAX x64 flag)
FLOAT_MODES = {"f64": (torch.float64, True), "f32": (torch.float32, False)}


def to_jax(inp: SolverInputs) -> jax_solver.SolverInputs:
    """The same arrays as JAX SolverInputs (call under the x64 mode)."""
    return jax_solver.SolverInputs(*[jnp.asarray(t.numpy()) for t in inp])


def jax_cfg(cfg) -> jax_solver.SolverConfig:
    return jax_solver.SolverConfig(**{**cfg._asdict(),
                                      "weights": JaxScoreWeights(*cfg.weights)})


def build_case(case, mode):
    dtype, x64 = FLOAT_MODES[mode]
    inp, cfg = CASES[case](dtype)
    return inp, cfg, x64


@pytest.mark.parametrize("mode", sorted(FLOAT_MODES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_build_buffers_equal_jax(case, mode):
    inp, _cfg, x64 = build_case(case, mode)
    ours = cuda_solver.build_buffers(inp)
    with jax.enable_x64(x64):
        ref = jax_pallas._build_buffers(to_jax(inp))
        ref = [np.asarray(a) for a in ref]
    assert len(ours) == len(ref)
    for name, a, b in zip(cuda_solver.Buffers._fields, ours, ref):
        assert a.numpy().dtype == b.dtype, name
        assert np.array_equal(a.numpy(), b), name


@pytest.mark.parametrize("mode", sorted(FLOAT_MODES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_pallas_interpret(case, mode):
    inp, cfg, x64 = build_case(case, mode)
    ours, _ = cuda_solver.solve_allocate_plain(inp, cfg)
    with jax.enable_x64(x64):
        ref = jax_pallas.solve_allocate_pallas(to_jax(inp), jax_cfg(cfg),
                                               interpret=True)
        ref = {f: np.asarray(getattr(ref, f)) for f in ref._fields}
    for f in ("assignment", "kind", "order", "step"):
        assert np.array_equal(getattr(ours, f).numpy(), ref[f]), f
    assert int(ours.step) > 0


@pytest.mark.parametrize("mode", sorted(FLOAT_MODES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_two_level(case, mode):
    inp, cfg, x64 = build_case(case, mode)
    ours, _ = cuda_solver.solve_allocate_plain(inp, cfg)
    with jax.enable_x64(x64):
        ref = jax_solver.solve_allocate(to_jax(inp), jax_cfg(cfg))
        ref = {f: np.asarray(getattr(ref, f)) for f in ref._fields}
    assert np.array_equal(ours.assignment.numpy(), ref["assignment"])
    assert np.array_equal(ours.order.numpy(), ref["order"])


def _solve(inp, cfg):
    return cuda_solver.solve_allocate_plain(inp, cfg)[0]


def test_feature_case_fires_every_branch():
    """Each feature of the feature case changes the outcome when switched
    off, and the case pipelines onto releasing capacity."""
    inp, cfg = make_feature_inputs(0, dtype=torch.float64, device="cpu")
    base = _solve(inp, cfg)
    kinds = np.bincount(base.kind.numpy(), minlength=3)
    assert kinds[1] > 0 and kinds[2] > 0, kinds  # allocated and pipelined
    assert kinds[0] > 0, kinds                   # and some left pending
    assert inp.job_init_alloc.abs().sum() > 0
    assert inp.node_used.abs().sum() > 0

    def differs(inp2, cfg2):
        other = _solve(inp2, cfg2)
        return not (torch.equal(other.assignment, base.assignment)
                    and torch.equal(other.order, base.order))

    variants = {
        "ports": (inp, cfg._replace(has_ports=False)),
        "pod_affinity": (inp, cfg._replace(has_pod_affinity=False)),
        "affinity_score": (inp, cfg._replace(has_pod_affinity_score=False)),
        "sig_bonus": (inp._replace(sig_bonus=torch.zeros_like(inp.sig_bonus)),
                      cfg),
        "sig_mask": (inp._replace(sig_mask=torch.ones_like(inp.sig_mask)
                                  & inp.node_exists[None, :]), cfg),
        "pod_cap": (inp._replace(
            node_max_tasks=torch.full_like(inp.node_max_tasks, 1 << 30)),
            cfg),
        "releasing": (inp._replace(
            node_releasing=torch.zeros_like(inp.node_releasing)), cfg),
        "priority": (inp._replace(job_prio=torch.zeros_like(inp.job_prio)),
                     cfg),
        "init_alloc": (inp._replace(
            job_init_alloc=torch.zeros_like(inp.job_init_alloc),
            queue_init_alloc=torch.zeros_like(inp.queue_init_alloc)), cfg),
        "scalar_dim": (inp._replace(task_req=inp.task_req.clone().index_fill_(
            1, torch.tensor([2]), 0)), cfg),
    }
    quiet = [name for name, (i2, c2) in variants.items() if not differs(i2, c2)]
    assert not quiet, f"switching these off changed nothing: {quiet}"


def _c_struct_fields(src: str):
    body = re.search(r"struct SolveArgs \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        type_and_first, *rest = decl.split(",")
        names.append(re.split(r"[\s*]+", type_and_first.strip())[-1])
        names += [n.strip() for n in rest]
    return names


def test_layout_table_matches_kernel_struct():
    """The launch arguments and the C struct list the same fields in the
    same order, so the one Python layout table reaches the kernel."""
    src = (Path(cuda_solver.__file__).resolve().parents[1] / "csrc"
           / "solve_session.cu").read_text()
    py = [name for name, _ in cuda_solver.SolveArgs._fields_]
    assert _c_struct_fields(src) == py
    assert py[-len(cuda_solver.Layout._fields):] == \
        list(cuda_solver.Layout._fields)
    lay = cuda_solver.layout(2, 8, 8)
    assert (lay.ni_rows, lay.task_width, lay.jdyn_rows, lay.qsta_rows,
            lay.qdyn_rows) == (16, 52, 8, 8, 8)


def test_key_codes_keep_tier_order_and_drop_unknown():
    codes = cuda_solver._key_codes(("gang", "bogus", "priority", "gang"),
                                   cuda_solver._JOB_KEYS, 3)
    assert codes == [2, 1, 0]
    assert cuda_solver._key_codes((), cuda_solver._QUEUE_KEYS, 1) == [0]
