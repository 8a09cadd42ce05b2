"""The mesh cases of the reference's other suites, the port on a CPU mesh
of 8 shards against the JAX package on its 8 virtual devices.

Twins of:
- tests/test_cycle_floors.py::test_candidate_solve_matches_on_mesh;
- tests/test_concurrent_shards.py::test_concurrent_parity_on_force_shard_mesh;
- tests/test_fused.py::TestFusedParity::test_mesh_leg_parity and
  ::test_storm_served_parity_vs_storm_off[1];
- tests/test_chaos.py::TestCircuitBreaker::
  test_mesh_route_device_error_trips_breaker_and_invalidates_shards;
- tests/test_topology.py::TestBoxScanParity::
  test_sharded_leg_equals_single_chip.

Each runs the reference's body once per package (``twin`` /
``loop_twin``) with KUBE_BATCH_TPU_FORCE_SHARD=1, the port's mesh
installed with ``parallel.mesh.use_mesh``; the two packages must give
the same placements, victims in order, binds, end state and breaker
states, and each must match its own single-device arm where the
reference compares one.
"""

import contextlib
import importlib

import jax
import numpy as np
import pytest
import torch

from kube_batch_tpu_torch.ops import solver as torch_solver
from kube_batch_tpu_torch.parallel import make_mesh, use_mesh
from tests.test_torch_utils import (drive_stamped, environ, fused_deltas,
                                    loop_twin, reference_gc_guard,
                                    storm_conf_text, twin)

__all__ = ["reference_gc_guard"]

torch.set_num_threads(1)

ROOTS = {"jax": "kube_batch_tpu", "torch": "kube_batch_tpu_torch"}
FORCE = torch_solver.FORCE_SHARD_ENV


def _solver(pkg):
    return importlib.import_module(f"{ROOTS[pkg]}.ops.solver")


def _mesh(pkg):
    """The package's 8-shard mesh: installed for the port, always there
    for the reference (its conftest forces 8 host devices)."""
    return use_mesh(make_mesh(8)) if pkg == "torch" \
        else contextlib.nullcontext()


def _force(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(FORCE, raising=False)
    else:
        monkeypatch.setenv(FORCE, value)
    for pkg in ROOTS:
        _solver(pkg).refresh_shard_knobs()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No shard pin, fault plan or open breaker leaks in or out."""
    def clean():
        for root in ROOTS.values():
            importlib.import_module(f"{root}.chaos.plan").disable()
            importlib.import_module(
                f"{root}.chaos.breaker").device_breaker().reset()
    monkeypatch.setenv("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")
    _force(monkeypatch, None)
    clean()
    yield
    clean()
    monkeypatch.delenv(FORCE, raising=False)
    for pkg in ROOTS:
        _solver(pkg)._SHARD_KNOBS = None


class _Snap:
    def __init__(self, inputs, config, p_real):
        self.inputs = inputs
        self.config = config
        self.tasks = [None] * p_real


def _result_tuple(a, k, o):
    a, k, o = (np.asarray(x) for x in (a, k, o))
    return np.where(k > 0, a, -1).tolist(), k.tolist(), o.tolist()


def test_candidate_solve_matches_on_mesh(monkeypatch):
    """test_cycle_floors.py:160: the per-shard gather through the
    sharded resident layout gives the full single-device solve's
    placements, in both packages, from per-shard plans that agree."""
    from test_torch_solver import jax_cfg
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
    _force(monkeypatch, "1")
    inp, cfg = make_synthetic_inputs(20, 400, 4, 2, seed=3,
                                     dtype=torch.float64, device="cpu")
    staged = torch_solver.SolverInputs(*(t.numpy() for t in inp))
    p_real = int(staged.job_count.sum())
    out = {}
    for pkg in ROOTS:
        m = _solver(pkg)
        prefilter = importlib.import_module(f"{ROOTS[pkg]}.ops.prefilter")
        shipping = importlib.import_module(f"{ROOTS[pkg]}.models.shipping")
        pcfg = jax_cfg(cfg) if pkg == "jax" else cfg
        staged = m.SolverInputs(*staged)
        with _mesh(pkg), jax.enable_x64(True):
            route, mesh = m.choose_solver_mesh(staged)
            assert route == "sharded"
            cand = prefilter.derive_candidates(_Snap(staged, pcfg, p_real),
                                               route, mesh)
            assert cand is not None and cand.sharded
            shipper = (shipping.DeviceResidentShipper("cpu")
                       if pkg == "torch" else
                       shipping.DeviceResidentShipper())
            resident = shipper.ship(staged, pcfg)
            a, k, o, _ = m.fetch_solve(m.dispatch_solve(resident, pcfg,
                                                        candidates=cand))
        out[pkg] = (_result_tuple(a, k, o), cand.local_idx.tolist(),
                    cand.local_valid.tolist(), cand.remap.tolist())
    assert out["torch"] == out["jax"]
    from kube_batch_tpu_torch.ops.cuda_solver import solve_allocate_plain
    full = solve_allocate_plain(inp, cfg)[0]
    assert out["torch"][0] == _result_tuple(full.assignment, full.kind,
                                            full.order)


def test_concurrent_parity_on_force_shard_mesh(monkeypatch):
    """test_concurrent_shards.py:157: the pipelined tenancy cycles on
    the FORCE_SHARD mesh give the sequential control's binds, events and
    lineage samples, in both packages."""
    from tests.test_torch_concurrent_shards import _drive

    def body(lp):
        _force(monkeypatch, "1")
        before = lp.metrics.route_counts().get("allocate/sharded", 0)
        with _mesh(lp.pkg):
            sb, se, sl, _ = _drive(lp, monkeypatch, False, seed=1)
            cb, ce, cl, _ = _drive(lp, monkeypatch, True, seed=1)
        sharded = lp.metrics.route_counts().get("allocate/sharded", 0)
        assert sb and (cb, ce, cl) == (sb, se, sl)
        assert sharded > before
        return cb, ce, cl

    loop_twin(body)


def _storm_session(p, make, env):
    with environ(env):
        actions, tiers = p.load(storm_conf_text())
        cache, binder = make(p.mod.models_synthetic)
        state, disp, legs, routes = fused_deltas(
            p, lambda: drive_stamped(p, cache, actions, tiers))
        # The resident image's layout: the sharded one when the legs
        # took their mesh routes.
        layout = type(cache._ship_cache._state).__name__
        return (state, list(cache.evictor.evicts), dict(binder.binds), legs,
                layout)


def test_mesh_leg_parity(monkeypatch):
    """test_fused.py:204: under FORCE_SHARD the fused program's legs take
    their sharded routes and reproduce the single-device footprint."""
    def body(p):
        out = {}
        for name, force in (("chip", None), ("mesh", "1")):
            _force(monkeypatch, force)
            with _mesh(p.pkg):
                out[name] = _storm_session(
                    p, lambda s: s.make_churn_cache(420, 64, 20, 3),
                    {"KUBE_BATCH_TPU_FUSED": "1"})
        _force(monkeypatch, None)
        assert out["mesh"][1], "storm must evict"
        assert out["mesh"][:3] == out["chip"][:3]
        assert (out["chip"][4], out["mesh"][4]) == ("_ShipState",
                                                    "_ShardShipState")
        return out["mesh"]

    twin(body)


def test_storm_served_parity_vs_storm_off_on_the_mesh(monkeypatch):
    """test_fused.py:151[1]: on the crafted served-storm cycle under
    FORCE_SHARD the postevict leg serves, and victims, their order,
    binds and end state equal the FUSED_STORM=0 arm's."""
    def body(p):
        _force(monkeypatch, "1")
        out = {}
        with _mesh(p.pkg):
            for name, storm in (("storm", "1"), ("control", "0")):
                out[name] = _storm_session(
                    p, lambda s: s.make_storm_served_cache(),
                    {"KUBE_BATCH_TPU_FUSED": "1",
                     "KUBE_BATCH_TPU_FUSED_STORM": storm})
        _force(monkeypatch, None)
        assert out["storm"][3].get("postevict/served", 0) >= 1
        assert out["storm"][1] and out["storm"][2]
        assert out["storm"][:3] == out["control"][:3]
        assert out["storm"][4] == "_ShardShipState"
        return out["storm"]

    twin(body)


def test_mesh_route_device_error_trips_breaker_and_invalidates_shards(
        monkeypatch):
    """test_chaos.py:224: an injected solve.device_error on the sharded
    route feeds the shared breaker, degrades the cycle to the host
    oracle (which still schedules) and drops the sharded resident image;
    the healed probe reships in full and solves sharded again."""
    from tests.test_torch_e2e import CONF_TPU, Harness

    def body(lp):
        _force(monkeypatch, "1")
        brk = importlib.import_module(f"{ROOTS[lp.pkg]}.chaos.breaker")
        trace = importlib.import_module(f"{ROOTS[lp.pkg]}.trace")
        clk = [0.0]
        br = brk.CircuitBreaker("device_solve", threshold=2, cooldown=30.0,
                                clock=lambda: clk[0])
        monkeypatch.setattr(brk, "_device_breaker", br)
        seen = []
        with _mesh(lp.pkg):
            plan = lp.chaos_plan.install(lp.chaos_plan.FaultPlan(
                seed=11, rate=1.0, sites=("solve.device_error",)))
            h = Harness(lp, conf=CONF_TPU)
            h.add_nodes(2, cpu="4")
            h.create_job("fit", 2, 2)
            h.create_job("hog", 1, 1, cpu="64")
            shipper = (lp.shipping.resident_shipper(h.cache, "cpu")
                       if lp.pkg == "torch"
                       else lp.shipping.resident_shipper(h.cache))
            h.cycle()
            seen += [plan.injected().get("solve.device_error", 0) >= 1,
                     len(h.bound("fit")), shipper._state is None,
                     br.state()]
            gen = shipper.generation
            h.cycle()
            tr = trace.flight_recorder.latest()
            seen += [br.state(), shipper.generation > gen,
                     tr.meta.get("solver_route"),
                     any("host allocate fallback" in n
                         for n in tr.meta.get("degraded", []))]
            lp.chaos_plan.disable()
            clk[0] = 31.0
            h.cycle()
            seen += [br.state(), shipper.last_mode,
                     shipper._state is not None]
        _force(monkeypatch, None)
        return seen

    assert loop_twin(body) == [True, 2, True, "closed", "open", True,
                               "sharded", True, "closed", "full", True]


def test_sharded_leg_equals_single_chip():
    """test_topology.py:286: the origin-sharded box scan on 8 shards
    equals the single-device scan, and the reference's sharded scan on
    its 8 devices."""
    from kube_batch_tpu.parallel.mesh import default_mesh as jax_mesh
    from tests.test_torch_topology import _torus, mods
    rng = np.random.default_rng(7)
    out = {}
    for pkg in ROOTS:
        m = mods(pkg)
        view = m.topology.build_view(_torus(m, pkg, 4, 4, 2))
        n = len(view.node_names)
        n_pad = ((n + 7) // 8) * 8
        coords = np.full((n_pad, m.topology.COORD_WIDTH), -1, np.int32)
        coords[:n] = view.coords[:n]
        if pkg == "jax":
            free = rng.random(n) < 0.5
            evictable = ~free & (rng.random(n) < 0.5)
            vic_cnt = rng.integers(0, 4, n).astype(np.int32)
            vic_cost = rng.integers(0, 100, n).astype(np.int32)

        def pad(a):
            b = np.zeros((n_pad,), a.dtype)
            b[:n] = a
            return b

        inp = m.topo_solver.BoxInputs(coords, pad(free), pad(evictable),
                                      pad(vic_cnt), pad(vic_cost))
        if pkg == "jax":
            with jax.enable_x64(True):
                staged = m.topo_solver.BoxInputs(
                    *(jax.numpy.asarray(a) for a in inp))
                single = np.asarray(m.topo_solver.box_scan(staged, 2, 2, 2))
                sharded = np.asarray(m.topo_solver.box_scan_sharded(
                    staged, 2, 2, 2, jax_mesh()))
        else:
            single = m.topo_solver.box_scan(
                m.topo_solver.stage_box_inputs(inp, "cpu"), 2, 2, 2).numpy()
            sharded = m.topo_solver.box_scan_sharded(
                inp, 2, 2, 2, make_mesh(8)).numpy()
        np.testing.assert_array_equal(sharded, single)
        out[pkg] = sharded
    np.testing.assert_array_equal(out["torch"], out["jax"])
