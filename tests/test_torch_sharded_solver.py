"""The port's node-sharded solve and scan on a CPU mesh, against the JAX
package's on its 8 virtual CPU devices.

Twins of tests/test_sharded_solver.py, function for function (seeds
parametrised): the sharded solve against the single-device solve and
against the reference's ``solve_allocate_sharded``, on 8 and 2 shards;
``TestProductionRouting`` (the FORCE_SHARD branch of
``best_solve_allocate``, the bytes gate, one tpu-allocate session under
FORCE_SHARD against the reference's); the unforced node gate; and
``TestShardedScan`` (the sharded preempt/reclaim scan, the scan gate,
every feature branch).  The port's mesh is installed with
``parallel.mesh.use_mesh`` (the reference's conftest forces 8 host
devices).  Assignment, kind, order, step and scores are compared
exactly.  Beside the twins: the warmup's hit and miss sequence on the
mesh equals the reference's, every mesh gate routes ``sharded`` under
the reference's conditions, the shards' reduction picks the global
first index on a tie, and the K1 shard-mode wrapper refuses CPU
shards.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.ops import scan as jax_scan
from kube_batch_tpu.ops import solver as jax_solver
from kube_batch_tpu.parallel import make_mesh as jax_make_mesh
from kube_batch_tpu.parallel import sharded_scan as jax_sharded_scan
from kube_batch_tpu.parallel.sharded_solver import \
    solve_allocate_sharded as jax_solve_allocate_sharded
from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
from kube_batch_tpu_torch.ops import cuda_solver, solver
from kube_batch_tpu_torch.ops.scan import ScanStatics, best_scan_nodes, \
    scan_nodes
from kube_batch_tpu_torch.ops.scoring import SCORE_NEG_INF
from kube_batch_tpu_torch.parallel import (ShardedTensor, make_mesh,
                                           shard_solver_inputs, use_mesh)
from kube_batch_tpu_torch.parallel.sharded_scan import scan_nodes_sharded
from kube_batch_tpu_torch.parallel.sharded_solver import (
    solve_allocate_sharded, solve_allocate_sharded_plain)
from test_torch_solver import jax_cfg, to_jax
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

torch.set_num_threads(1)

SHARD_ENVS = (solver.FORCE_SHARD_ENV, solver.SHARD_NODES_ENV,
              solver.SHARD_BYTES_ENV)


@pytest.fixture(autouse=True)
def _unpin(monkeypatch):
    """The port's knobs are pinned like the reference's: each case
    starts and ends with no shard env and a fresh pin (the reference's
    conftest drops its own pin after each test)."""
    for var in SHARD_ENVS:
        monkeypatch.delenv(var, raising=False)
    solver.refresh_shard_knobs()
    yield
    for var in SHARD_ENVS:
        os.environ.pop(var, None)
    solver._SHARD_KNOBS = None


def _inputs(n_tasks, n_nodes, n_jobs, n_queues, seed):
    return make_synthetic_inputs(n_tasks, n_nodes, n_jobs, n_queues,
                                 seed=seed, dtype=torch.float64,
                                 device="cpu")


def _triple(res):
    return tuple(np.asarray(x).tolist() for x in
                 (res.assignment, res.kind, res.order)) + (int(res.step),)


@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_matches_single_chip(seed):
    """test_sharded_matches_single_chip: 8 shards = one device = the
    reference's sharded solve on its 8 devices."""
    inp, cfg = _inputs(200, 64, 20, 3, seed)
    sharded = solve_allocate_sharded(inp, cfg, make_mesh(8))
    single = cuda_solver.solve_allocate_plain(inp, cfg)[0]
    assert _triple(sharded) == _triple(single)
    with jax.enable_x64(True):
        ref = jax_solve_allocate_sharded(to_jax(inp), jax_cfg(cfg),
                                         jax_make_mesh(8))
        assert _triple(sharded) == _triple(ref)


def test_sharded_runs_on_two_devices():
    """test_sharded_runs_on_two_devices, held against the reference."""
    inp, cfg = _inputs(128, 32, 10, 2, 5)
    result = solve_allocate_sharded(inp, cfg, make_mesh(2))
    assert (result.assignment >= 0).sum() > 0
    with jax.enable_x64(True):
        ref = jax_solve_allocate_sharded(to_jax(inp), jax_cfg(cfg),
                                         jax_make_mesh(2))
        assert _triple(result) == _triple(ref)


class TestProductionRouting:
    """best_solve_allocate routes oversized node buckets to the mesh."""

    def test_force_shard_branch(self, monkeypatch):
        inp, cfg = _inputs(128, 64, 16, 4, 3)
        monkeypatch.setenv(solver.FORCE_SHARD_ENV, "1")
        solver.refresh_shard_knobs()
        assert solver.choose_solver(inp) == "torch"  # no mesh: one device
        with use_mesh(make_mesh(8)):
            assert solver.choose_solver(inp) == "sharded"
            sharded = solver.best_solve_allocate(inp, cfg)
        single = cuda_solver.solve_allocate_plain(inp, cfg)[0]
        assert _triple(sharded) == _triple(single)

    def test_size_gate_threshold(self, monkeypatch):
        inp, _ = _inputs(64, 64, 8, 2, 0)
        with use_mesh(make_mesh(8)):
            monkeypatch.setenv(solver.SHARD_BYTES_ENV, str(1 << 40))
            solver.refresh_shard_knobs()
            assert solver.choose_solver(inp) == "torch"
            monkeypatch.setenv(solver.SHARD_BYTES_ENV,
                               str(solver._node_state_bytes(inp) - 1))
            solver.refresh_shard_knobs()
            assert solver.choose_solver(inp) == "sharded"
        with jax.enable_x64(True):
            assert jax_solver._node_state_bytes(to_jax(inp)) == \
                solver._node_state_bytes(inp)

    def test_action_path_with_forced_shard(self, monkeypatch):
        """One tpu-allocate session under FORCE_SHARD on the 8-shard
        mesh: binds, statuses and events equal the reference's on its
        8 devices, and the port's solve went through the sharded
        route."""
        from kube_batch_tpu_torch.metrics.metrics import route_counts
        from tests.test_torch_utils import assert_session_parity
        monkeypatch.setenv(solver.FORCE_SHARD_ENV, "1")
        solver.refresh_shard_knobs()
        jax_solver.refresh_shard_knobs()
        probe, _ = _inputs(16, 8, 4, 2, 0)
        spec = dict(
            queues=[("q1", 1), ("q2", 2)],
            pod_groups=[(f"pg{j}", "ns", 2, f"q{1 + j % 2}")
                        for j in range(4)],
            pods=[("ns", f"j{j}-p{i}", "", "Pending", "1", "1Gi", f"pg{j}")
                  for j in range(4) for i in range(3)],
            nodes=[(f"n{i}", "4", "8Gi") for i in range(8)])
        with use_mesh(make_mesh(8)):
            assert solver.choose_solver(probe) == "sharded"
            before = route_counts().get("allocate/sharded", 0)
            jax_out, torch_out = assert_session_parity(spec)
            assert route_counts().get("allocate/sharded", 0) > before
        assert len(torch_out["binds"]) == 12


def test_gate_routes_sharded_unforced():
    """test_gate_routes_sharded_unforced: at the node gate the route is
    sharded with no FORCE_SHARD."""
    small, _ = _inputs(64, 512, 8, 2, 0)
    big, _ = _inputs(64, solver.DEFAULT_SHARD_NODES + 1024, 8, 2, 0)
    with use_mesh(make_mesh(8)):
        assert solver.choose_solver(small) != "sharded"
        assert solver.choose_solver(big) == "sharded"
    assert solver.choose_solver(big) == "torch"  # no mesh on one device
    assert solver.DEFAULT_SHARD_NODES == jax_solver.DEFAULT_SHARD_NODES
    assert solver.DEFAULT_SHARD_BYTES == jax_solver.DEFAULT_SHARD_BYTES


def test_shards_tie_to_the_global_first_index():
    """Every node scores the same, so every shard's local first max ties
    the global max: the pmin of the word must pick the first node of the
    first shard, as one device does, placement by placement."""
    inp, cfg = _inputs(40, 16, 4, 2, 0)
    same = inp._replace(
        node_used=torch.zeros_like(inp.node_used),
        node_idle=inp.node_alloc.clone(),
        node_count=torch.zeros_like(inp.node_count),
        sig_bonus=torch.zeros_like(inp.sig_bonus),
        sig_mask=torch.ones_like(inp.sig_mask))
    got = solve_allocate_sharded_plain(same, cfg, make_mesh(4))[0]
    want = cuda_solver.solve_allocate_plain(same, cfg)[0]
    assert _triple(got) == _triple(want)
    first_task = int((got.order == 0).nonzero()[0, 0])
    assert int(got.assignment[first_task]) == 0


def test_shard_mode_takes_cuda_shards_only():
    inp, cfg = _inputs(40, 16, 4, 2, 0)
    sharded = shard_solver_inputs(inp, make_mesh(4))
    assert isinstance(sharded.node_idle, ShardedTensor)
    with pytest.raises(ValueError, match="CUDA shards"):
        cuda_solver.solve_allocate_cuda_sharded(sharded, cfg)
    with pytest.raises(ValueError, match="mesh layout"):
        cuda_solver.solve_allocate_cuda_sharded(inp, cfg)


def test_a_shard_that_gave_up_poisons_the_result():
    """K1's shard mode writes step -1 on a shard that gave up on the
    exchange.  One such shard poisons the solve even where shard 0 ran
    to its end, and the fetch's check raises DeviceFailure."""
    from kube_batch_tpu_torch.chaos.breaker import DeviceFailure
    inp, cfg = _inputs(40, 16, 4, 2, 0)
    res, final = solve_allocate_sharded_plain(inp, cfg, make_mesh(4))
    whole = cuda_solver.poisoned_by_any_shard([(res, final)] * 4)
    assert _triple(whole) == _triple(res) and int(whole.step) == int(res.step)
    solver._check_not_aborted(whole.kind.numpy())
    quit_ = res._replace(step=torch.tensor(-1, dtype=torch.int32))
    got = cuda_solver.poisoned_by_any_shard(
        [(res, final), (res, final), (quit_, final), (res, final)])
    assert bool((got.kind == -1).all()) and int(got.step) == -1
    assert torch.equal(got.assignment, res.assignment)
    with pytest.raises(DeviceFailure, match="gave up"):
        solver._check_not_aborted(got.kind.numpy())


class TestShardedScan:
    """Node-sharded preempt/reclaim scan (parallel/sharded_scan.py)
    against the single-device scan and the reference's sharded scan."""

    @staticmethod
    def _statics_dyn(inputs, n_sigs_min=64):
        sig_mask = inputs.sig_mask.numpy()
        sig_bonus = inputs.sig_bonus.numpy()
        if sig_mask.shape[0] < n_sigs_min:
            reps = -(-n_sigs_min // sig_mask.shape[0])
            sig_mask = np.tile(sig_mask, (reps, 1))[:n_sigs_min].copy()
            sig_bonus = np.tile(sig_bonus, (reps, 1))[:n_sigs_min].copy()
            for s in range(sig_mask.shape[0]):
                sig_mask[s, s % sig_mask.shape[1]] ^= True
        statics = ScanStatics(
            sig_mask=torch.as_tensor(sig_mask),
            sig_bonus=torch.as_tensor(sig_bonus),
            node_alloc=inputs.node_alloc, node_max_tasks=inputs.node_max_tasks,
            node_exists=inputs.node_exists, score_shift=inputs.score_shift)
        r = inputs.task_req.shape[1]
        dyn = np.concatenate(
            [inputs.node_used.numpy(), inputs.node_count.numpy()[:, None],
             inputs.node_ports.numpy().astype(np.int32),
             inputs.node_selcnt.numpy()], axis=1).astype(np.int32)
        return statics, dyn, r

    @staticmethod
    def _jax(statics):
        return jax_scan.ScanStatics(*(jnp.asarray(np.asarray(x))
                                      for x in statics))

    @staticmethod
    def _trow(inputs, ti, sig):
        return np.concatenate(
            [np.asarray([sig], np.int32), inputs.task_res.numpy()[ti],
             inputs.task_ports.numpy()[ti].astype(np.int32),
             inputs.task_aff_req.numpy()[ti].astype(np.int32),
             inputs.task_anti.numpy()[ti].astype(np.int32),
             inputs.task_paff_w.numpy()[ti],
             inputs.task_panti_w.numpy()[ti]]).astype(np.int32)

    @pytest.mark.parametrize("seed", [0, 2])
    def test_scan_matches_single_chip(self, seed):
        inputs, config = _inputs(96, 64, 12, 3, seed)
        statics, dyn, r = self._statics_dyn(inputs)
        np_pad = inputs.task_ports.shape[1]
        ns_pad = inputs.task_aff_req.shape[1]
        rng = np.random.RandomState(seed)
        for ti in rng.choice(96, size=4, replace=False):
            sig = int(inputs.task_sig[ti]) % statics.sig_mask.shape[0]
            trow = self._trow(inputs, ti, sig)
            sharded = scan_nodes_sharded(config, r, np_pad, ns_pad, statics,
                                         dyn, trow, make_mesh(8)).numpy()
            single = scan_nodes(config, r, np_pad, ns_pad, statics,
                                torch.as_tensor(dyn),
                                torch.as_tensor(trow)).numpy()
            assert np.array_equal(sharded, single)
            with jax.enable_x64(True):
                ref = np.asarray(jax_sharded_scan.scan_nodes_sharded(
                    jax_cfg(config), r, np_pad, ns_pad, self._jax(statics),
                    jnp.asarray(dyn), jnp.asarray(trow), jax_make_mesh(8)))
            assert np.array_equal(sharded, ref)

    def test_best_scan_routes_sharded(self, monkeypatch):
        from kube_batch_tpu_torch.metrics.metrics import route_counts
        inputs, config = _inputs(64, 64, 8, 2, 1)
        statics, dyn, r = self._statics_dyn(inputs)
        np_pad = inputs.task_ports.shape[1]
        ns_pad = inputs.task_aff_req.shape[1]
        trow = self._trow(inputs, 0, 0)
        monkeypatch.setenv(solver.FORCE_SHARD_ENV, "1")
        solver.refresh_shard_knobs()
        before = route_counts().get("scan/sharded", 0)
        with use_mesh(make_mesh(8)):
            routed = best_scan_nodes(config, r, np_pad, ns_pad, statics, dyn,
                                     trow).numpy()
        assert route_counts().get("scan/sharded", 0) == before + 1
        single = scan_nodes(config, r, np_pad, ns_pad, statics,
                            torch.as_tensor(dyn),
                            torch.as_tensor(trow)).numpy()
        assert np.array_equal(routed, single)

    def test_scan_parity_with_ports_and_affinity(self):
        """Every feature branch on, each provably firing, shard-local."""
        inputs, config = _inputs(64, 64, 8, 2, 4)
        config = config._replace(has_ports=True, has_pod_affinity=True,
                                 has_pod_affinity_score=True)
        statics, dyn, r = self._statics_dyn(inputs)
        np_pad = inputs.task_ports.shape[1]
        ns_pad = inputs.task_aff_req.shape[1]
        n = dyn.shape[0]
        idx = np.arange(n)
        dyn = dyn.copy()
        dyn[:, r + 1:r + 1 + np_pad] = 0
        dyn[:, r + 1] = (idx % 4 == 0).astype(np.int32)
        dyn[:, r + 1 + np_pad:r + 1 + np_pad + ns_pad] = 0
        dyn[:, r + 1 + np_pad] = (idx % 3 == 0).astype(np.int32)
        if ns_pad > 1:
            dyn[:, r + 1 + np_pad + 1] = (idx % 5 == 0).astype(np.int32)

        def run(cfg, trow):
            return scan_nodes(cfg, r, np_pad, ns_pad, statics,
                              torch.as_tensor(dyn),
                              torch.as_tensor(trow)).numpy()

        t_ports = np.zeros(np_pad, np.int32)
        t_ports[0] = 1
        t_aff = np.zeros(ns_pad, np.int32)
        t_aff[0] = 1
        t_anti = np.zeros(ns_pad, np.int32)
        if ns_pad > 1:
            t_anti[1] = 1
        t_paffw = np.zeros(ns_pad, np.int32)
        t_paffw[0] = 2
        trow = np.concatenate(
            [np.asarray([0], np.int32), inputs.task_res.numpy()[0],
             t_ports, t_aff, t_anti, t_paffw,
             np.zeros(ns_pad, np.int32)]).astype(np.int32)
        sharded = scan_nodes_sharded(config, r, np_pad, ns_pad, statics,
                                     dyn, trow, make_mesh(8)).numpy()
        single = run(config, trow)
        assert np.array_equal(sharded, single)
        with jax.enable_x64(True):
            ref = np.asarray(jax_sharded_scan.scan_nodes_sharded(
                jax_cfg(config), r, np_pad, ns_pad, self._jax(statics),
                jnp.asarray(dyn), jnp.asarray(trow), jax_make_mesh(8)))
        assert np.array_equal(sharded, ref)
        feas = single != SCORE_NEG_INF
        assert feas.any(), "degenerate scenario: nothing feasible"
        off = config._replace(has_ports=False, has_pod_affinity=False,
                              has_pod_affinity_score=False)
        bare = run(off, trow)
        ports_only = run(off._replace(has_ports=True), trow)
        assert ((ports_only == SCORE_NEG_INF) & (bare != SCORE_NEG_INF)).any()
        aff_only = run(off._replace(has_pod_affinity=True), trow)
        assert ((aff_only == SCORE_NEG_INF) & (bare != SCORE_NEG_INF)).any()
        noscore = run(config._replace(has_pod_affinity_score=False), trow)
        assert (noscore[feas] != single[feas]).any()


def test_every_mesh_gate_shards_under_force(monkeypatch):
    """choose_solver_mesh, the scan gate, choose_topo_route and
    choose_evict_route return ``sharded`` with a mesh under the
    reference's conditions, and the single-device routes without one."""
    from kube_batch_tpu_torch.models.shipping import DeviceResidentShipper
    from kube_batch_tpu_torch.ops.evict_solver import choose_evict_route
    from kube_batch_tpu_torch.ops.scan import choose_scan_mesh
    from kube_batch_tpu_torch.ops.topo_solver import choose_topo_route
    inp, cfg = _inputs(64, 64, 8, 2, 0)
    assert choose_topo_route(64) == ("torch", None)
    assert choose_scan_mesh(64) == ("torch", None)
    monkeypatch.setenv(solver.FORCE_SHARD_ENV, "1")
    solver.refresh_shard_knobs()
    mesh = make_mesh(8)
    with use_mesh(mesh):
        assert solver.choose_solver_mesh(inp) == ("sharded", mesh)
        assert choose_scan_mesh(64) == ("sharded", mesh)
        assert choose_topo_route(64) == ("sharded", mesh)
        assert choose_topo_route(60) == ("torch", None)  # not divisible
        resident = DeviceResidentShipper("cpu").ship(inp, cfg)
        assert choose_evict_route(resident) == ("sharded", mesh)
    assert choose_evict_route(inp) == ("torch", None)


def test_warmup_hits_and_misses_on_the_mesh(monkeypatch):
    """tests/test_torch_compile_cache.py's hit/miss sequence under
    FORCE_SHARD, the port on its 8-shard CPU mesh and the reference on
    its 8 devices: the warmup's members run on the mesh (the sharded
    solve, the per-shard candidate gather, the sharded eviction scan,
    the fused legs) without error, and a live sharded solve at the warmed
    bucket is a hit, one at another bucket a miss, then a hit, in both
    packages alike."""
    import kube_batch_tpu.metrics.metrics as ref_metrics
    import kube_batch_tpu.ops.compile_cache as ref_cc
    import kube_batch_tpu_torch.metrics.metrics as metrics
    import kube_batch_tpu_torch.ops.compile_cache as cc
    from kube_batch_tpu.models.synthetic import \
        make_synthetic_inputs as ref_inputs
    from tests.test_torch_compile_cache import SPEC, _deltas, _synthetic

    monkeypatch.setenv(solver.FORCE_SHARD_ENV, "1")
    solver.refresh_shard_knobs()
    jax_solver.refresh_shard_knobs()
    other = cc.BucketSpec(30, 24, 4, 2)
    with jax.enable_x64(False):
        r_spec = ref_inputs(SPEC.tasks, SPEC.nodes, SPEC.jobs, SPEC.queues)
        r_other = ref_inputs(*other)
        ref = _deltas(ref_cc, ref_metrics, [
            lambda: ref_cc.warm_bucket(ref_cc.BucketSpec(*SPEC)),
            lambda: jax_solver.best_solve_allocate(*r_spec),
            lambda: jax_solver.best_solve_allocate(*r_other),
            lambda: jax_solver.best_solve_allocate(*r_other)])
    p_spec, p_other = _synthetic(), _synthetic(other)
    records = []
    with use_mesh(make_mesh(8)):
        assert solver.choose_solver(p_spec[0]) == "sharded"
        port = _deltas(cc, metrics, [
            lambda: records.extend(cc.warm_bucket(SPEC, device="cpu")),
            lambda: solver.best_solve_allocate(*p_spec),
            lambda: solver.best_solve_allocate(*p_other),
            lambda: solver.best_solve_allocate(*p_other)])
    jax_solver._SHARD_KNOBS = None
    assert [r.error for r in records] == [None] * len(records)
    assert {r.solver for r in records} >= {"sharded", "candidate",
                                           "evict_batch", "fused"}
    assert records[0].key[0] == "sharded"
    assert port == ref
    assert port[1:] == [(1, 0), (0, 1), (1, 0)]
