"""The sharded resident ship and the mesh-routed eviction engine, the
port on a CPU mesh of 8 shards against the JAX package on its 8 virtual
devices.

Twins of tests/test_shard_ship.py, case for case: a delta ship equals a
full ship leaf for leaf across churn, and both equal the reference's
sharded ship of the same staging, with the node leaves in the mesh
layout; a churn cycle ships bytes only to the shards owning dirty node
rows (a clean shard's buffer is the same object after the ship); the
fallbacks to a full ship (layout change, over half dirty, a flip back to
the single-device layout, invalidate); a clean ship keeps the generation
and the solve is reused through the action under FORCE_SHARD; the
sharded batch eviction solve equals the single-device one; the routing
knobs are pinned until refreshed and a malformed one warns once.
``TestDonationSafetyPin``: the reference registers its per-shard
donated scatter with graftlint's donation rule; the port's in-place
``_scatter_shard`` is seen at the reference's path by the lint twin, and
its shipped images carry the ``frozen-after: ship`` contract.
"""

import logging
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from kube_batch_tpu.models import shipping as jax_shipping
from kube_batch_tpu.ops import solver as jax_solver
from kube_batch_tpu_torch.metrics.metrics import ship_shard_counts
from kube_batch_tpu_torch.models.shipping import DeviceResidentShipper
from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
from kube_batch_tpu_torch.ops import solver
from kube_batch_tpu_torch.parallel import (NODE_AXIS, ShardedTensor,
                                           make_mesh, use_mesh)
from test_torch_solver import jax_cfg
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(1)

MESH = make_mesh(8)


def _set_force(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(solver.FORCE_SHARD_ENV, raising=False)
    else:
        monkeypatch.setenv(solver.FORCE_SHARD_ENV, value)
    solver.refresh_shard_knobs()
    jax_solver.refresh_shard_knobs()


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    monkeypatch.delenv("KUBE_BATCH_TPU_DELTA_SHIP", raising=False)
    _set_force(monkeypatch, None)
    yield
    monkeypatch.delenv(solver.FORCE_SHARD_ENV, raising=False)
    solver._SHARD_KNOBS = None


@pytest.fixture
def forced_shard(monkeypatch):
    _set_force(monkeypatch, "1")
    with use_mesh(MESH):
        yield


def _staged(seed=0, n_tasks=200, n_nodes=64, n_jobs=20, n_queues=3):
    inp, cfg = make_synthetic_inputs(n_tasks, n_nodes, n_jobs, n_queues,
                                     seed=seed, dtype=torch.float64,
                                     device="cpu")
    return solver.SolverInputs(*(t.numpy() for t in inp)), cfg


def _copy(inp):
    return solver.SolverInputs(*(np.copy(a) for a in inp))


def _assert_leaves_equal(got, want):
    """Every shipped leaf equals the staging's bytes (a full ship's) and
    the reference's sharded ship of the same staging."""
    with jax.enable_x64(True):
        ref = jax_shipping.DeviceResidentShipper().ship(want)
        ref = [np.asarray(a) for a in ref]
    for name, a, b, r in zip(got._fields, got, want, ref):
        a = np.asarray(a)
        assert np.array_equal(a, b), f"leaf {name} diverged from the staging"
        assert np.array_equal(a, r), f"leaf {name} diverged from the reference"


def _shard_byte_deltas(before, after):
    return {int(k): after.get(k, 0) - before.get(k, 0) for k in after}


class TestShardedShipParity:
    def test_full_ship_parity_and_shardings(self, forced_shard):
        inp, cfg = _staged()
        sh = DeviceResidentShipper("cpu")
        out = sh.ship(inp, cfg)
        assert sh.last_mode == "full"
        _assert_leaves_equal(out, inp)
        # Node leaves split over the node axis, sig leaves over their
        # trailing axis, the rest replicated: the layout the sharded
        # solve reads, so it never moves a node row.
        for leaf, axis in ((out.node_idle, 0), (out.node_count, 0),
                           (out.sig_mask, 1), (out.sig_bonus, 1)):
            assert isinstance(leaf, ShardedTensor)
            assert leaf.axis == axis and leaf.mesh == MESH
            assert len(leaf.parts) == 8
            assert MESH.shape == {NODE_AXIS: 8}
        assert isinstance(out.task_req, torch.Tensor)

    def test_delta_ship_parity_across_churn(self, forced_shard):
        inp, cfg = _staged(seed=1)
        sh = DeviceResidentShipper("cpu")
        sh.ship(inp, cfg)
        rng = np.random.RandomState(7)
        cur = inp
        for cycle in range(4):
            nxt = _copy(cur)
            for _ in range(3):
                row = int(rng.randint(0, 64))
                nxt.node_used[row, 0] += 100
                nxt.node_count[row] += 1
            nxt.task_res[int(rng.randint(0, 200))] += 1
            nxt.queue_init_alloc[0, 0] += 1
            out = sh.ship(nxt, cfg)
            assert sh.last_mode == "delta", f"cycle {cycle}"
            _assert_leaves_equal(out, nxt)
            cur = nxt

    def test_clean_ship_keeps_generation_and_buffer(self, forced_shard):
        inp, cfg = _staged(seed=2)
        sh = DeviceResidentShipper("cpu")
        out1 = sh.ship(inp, cfg)
        gen = sh.generation
        out2 = sh.ship(_copy(inp), cfg)
        assert sh.last_mode == "clean"
        assert sh.generation == gen
        assert out2 is out1

    def test_dirty_shard_isolation(self, forced_shard):
        inp, cfg = _staged(seed=3)
        sh = DeviceResidentShipper("cpu")
        sh.ship(inp, cfg)
        shards_before = list(sh._state.shard_arrays)
        n_local = 64 // 8
        target = 5
        nxt = _copy(inp)
        nxt.node_used[target * n_local + 2, 1] += 64
        before = ship_shard_counts()
        out = sh.ship(nxt, cfg)
        after = ship_shard_counts()
        assert sh.last_mode == "delta"
        deltas = _shard_byte_deltas(before, after)
        assert deltas[target] > 0
        assert all(v == 0 for s, v in deltas.items() if s != target), deltas
        for s, buf in enumerate(sh._state.shard_arrays):
            if s != target:
                assert buf is shards_before[s], f"clean shard {s} touched"
        _assert_leaves_equal(out, nxt)

    def test_layout_change_falls_back_to_full(self, forced_shard):
        inp, cfg = _staged(seed=4, n_nodes=64)
        sh = DeviceResidentShipper("cpu")
        sh.ship(inp, cfg)
        bigger, _ = _staged(seed=4, n_nodes=128)
        out = sh.ship(bigger, cfg)
        assert sh.last_mode == "full"
        _assert_leaves_equal(out, bigger)

    def test_over_half_dirty_falls_back_to_full(self, forced_shard):
        inp, cfg = _staged(seed=5)
        sh = DeviceResidentShipper("cpu")
        sh.ship(inp, cfg)
        nxt = solver.SolverInputs(*(
            a + 1 if np.issubdtype(a.dtype, np.integer) else np.copy(a)
            for a in inp))
        out = sh.ship(nxt, cfg)
        assert sh.last_mode == "full"
        _assert_leaves_equal(out, nxt)

    def test_route_flip_falls_back_to_single_chip_layout(self, monkeypatch):
        inp, cfg = _staged(seed=6)
        with use_mesh(MESH):
            _set_force(monkeypatch, "1")
            sh = DeviceResidentShipper("cpu")
            first = sh.ship(inp, cfg)
            assert isinstance(first.node_idle, ShardedTensor)
            _set_force(monkeypatch, None)
            out = sh.ship(inp, cfg)  # same bytes, the other layout
        assert sh.last_mode == "full"
        assert isinstance(out.node_idle, torch.Tensor)
        _assert_leaves_equal(out, inp)

    def test_invalidate_drops_sharded_image(self, forced_shard):
        inp, cfg = _staged(seed=7)
        sh = DeviceResidentShipper("cpu")
        sh.ship(inp, cfg)
        gen = sh.generation
        sh.invalidate()
        assert sh.generation == gen + 1
        sh.ship(inp, cfg)
        assert sh.last_mode == "full"


class TestGenerationReuseOnMesh:
    def test_solve_reuse_on_clean_ship_through_the_action(
            self, monkeypatch):
        """The generation-keyed solve reuse on the mesh: a no-progress
        cycle under FORCE_SHARD ships clean at an unchanged generation
        and reuses the previous sharded solve, in both packages."""
        from tests.test_torch_utils import Arm

        def run(pkg):
            metrics = (__import__("kube_batch_tpu_torch.metrics.metrics",
                                  fromlist=["x"]) if pkg == "torch" else
                       __import__("kube_batch_tpu.metrics.metrics",
                                  fromlist=["x"]))
            routes_before = metrics.route_counts()
            arm = Arm(pkg, (20, 8, 4, 2))
            arm.add_churn_job("hog", n_pods=1, cpu="4000")
            arm.cycle()
            arm.cycle()
            before = metrics.generation_reuse_counts()
            arm.cycle(echo=False)
            arm.cycle(echo=False)
            after = metrics.generation_reuse_counts()
            assert after.get("hit", 0) - before.get("hit", 0) >= 1
            assert metrics.route_counts().get("allocate/sharded", 0) > \
                routes_before.get("allocate/sharded", 0)
            return sorted(arm.cache.events) if hasattr(arm.cache, "events") \
                else None

        _set_force(monkeypatch, "1")
        with use_mesh(MESH):
            port = run("torch")
        ref = run("jax")
        assert port == ref


class TestMeshEvictSolve:
    def test_sharded_evict_solve_matches_single_chip(self, forced_shard):
        from kube_batch_tpu_torch.ops import evict_solver
        from kube_batch_tpu_torch.ops.scan import ScanStatics

        inp, cfg = _staged(seed=8, n_tasks=96, n_nodes=64, n_jobs=12)
        resident = DeviceResidentShipper("cpu").ship(inp, cfg)
        r = inp.task_req.shape[1]
        np_pad = inp.task_ports.shape[1]
        ns_pad = inp.task_aff_req.shape[1]
        statics = ScanStatics(
            sig_mask=resident.sig_mask.clone(),
            sig_bonus=resident.sig_bonus.clone(),
            node_alloc=resident.node_alloc.clone(),
            node_max_tasks=resident.node_max_tasks.clone(),
            node_exists=resident.node_exists.clone(),
            score_shift=resident.score_shift.clone())
        route, mesh = evict_solver.choose_evict_route(resident)
        assert route == "sharded" and mesh == MESH
        k = 8
        trows = np.zeros((k, 1 + r + np_pad + 4 * ns_pad), np.int32)
        for i in range(k):
            trows[i, 0] = int(inp.task_sig[i])
            trows[i, 1:1 + r] = inp.task_res[i]
        m = 16
        rng = np.random.RandomState(0)
        vic_node = rng.randint(0, 64, m).astype(np.int32)
        vic_rank = rng.permutation(m).astype(np.int32)
        scores_sh, perm_sh = evict_solver.dispatch_evict_batch_solve(
            cfg, r, np_pad, ns_pad, statics, None, torch.as_tensor(trows),
            torch.as_tensor(vic_node), torch.as_tensor(vic_rank),
            resident=resident)
        statics1 = ScanStatics(*(torch.as_tensor(getattr(inp, f))
                                 for f in ScanStatics._fields))
        dyn = np.concatenate(
            [inp.node_used, inp.node_count[:, None],
             inp.node_ports.astype(np.int32), inp.node_selcnt],
            axis=1).astype(np.int32)
        scores_1, perm_1 = evict_solver.evict_batch_solve(
            cfg, r, np_pad, ns_pad, statics1, torch.as_tensor(dyn),
            torch.as_tensor(trows), torch.as_tensor(vic_node),
            torch.as_tensor(vic_rank))
        assert np.array_equal(scores_sh.numpy(), scores_1.numpy())
        assert np.array_equal(perm_sh.numpy(), perm_1.numpy())
        from kube_batch_tpu.ops import evict_solver as jax_evict
        from kube_batch_tpu.ops.scan import ScanStatics as JaxStatics
        with jax.enable_x64(True):
            ref_scores, ref_perm = jax_evict.evict_batch_solve(
                jax_cfg(cfg), r, np_pad, ns_pad,
                JaxStatics(*(np.asarray(getattr(inp, f))
                             for f in JaxStatics._fields)),
                dyn, trows, vic_node, vic_rank)
            assert np.array_equal(scores_sh.numpy(), np.asarray(ref_scores))
            assert np.array_equal(perm_sh.numpy(), np.asarray(ref_perm))

    def test_choose_evict_route_without_resident_is_single_chip(
            self, forced_shard):
        from kube_batch_tpu.ops.evict_solver import \
            choose_evict_route as jax_route
        from kube_batch_tpu_torch.ops.evict_solver import choose_evict_route
        assert choose_evict_route(None) == ("torch", None)
        assert jax_route(None) == ("xla", None)


class TestShardKnobs:
    def test_knobs_pinned_until_refresh(self, monkeypatch):
        monkeypatch.delenv(solver.FORCE_SHARD_ENV, raising=False)
        solver.refresh_shard_knobs()
        assert solver.shard_knobs().force is False
        monkeypatch.setenv(solver.FORCE_SHARD_ENV, "1")
        assert solver.shard_knobs().force is False  # pinned
        assert solver.refresh_shard_knobs().force is True

    def test_malformed_knob_warns_loudly_once_and_pins_default(
            self, monkeypatch, caplog):
        from kube_batch_tpu_torch import knobs
        knobs.reset_warnings()
        monkeypatch.setenv(solver.SHARD_NODES_ENV, "not-a-number")
        with caplog.at_level(logging.WARNING,
                             logger="kube_batch_tpu_torch.ops.solver"):
            pinned = solver.refresh_shard_knobs()
        assert pinned.nodes == solver.DEFAULT_SHARD_NODES
        warned = [r for r in caplog.records
                  if "not-a-number" in r.getMessage()]
        assert len(warned) == 1
        assert warned[0].name == "kube_batch_tpu_torch.ops.solver"
        caplog.clear()
        with caplog.at_level(logging.WARNING,
                             logger="kube_batch_tpu_torch.ops.solver"):
            solver.shard_knobs()  # pinned: no re-parse, no re-warn
        assert not caplog.records


class TestDonationSafetyPin:
    def test_per_shard_scatter_registered_with_graftlint(self):
        """The reference registers ``_scatter_shard`` and
        ``_scatter_blocks`` as donating jitted programs.  The port writes
        in place instead: the lint twin sees its shipping.py at the
        reference's path, with ``_scatter_shard`` defined there, no
        finding against it, and the frozen-after contract on both
        sharded images (and the single-device one) that the in-place
        scatters must never break."""
        from tests.test_torch_lint_clean import AS_REFERENCE, PORT
        from tools.graftlint.core import SourceFile, run_files
        path = ROOT / "kube_batch_tpu_torch" / "models" / "shipping.py"
        sf = SourceFile(AS_REFERENCE + str(path)[len(PORT):],
                        path.read_text(encoding="utf-8"))
        assert sf.path.endswith("kube_batch_tpu/models/shipping.py")
        findings, markers = run_files([sf], root=str(ROOT))
        assert not findings, [str(f) for f in findings]
        assert "def _scatter_shard(" in path.read_text(encoding="utf-8")
        frozen = [m for m in markers if m.kind == "frozen-after"
                  and m.detail == "ship"]
        assert len(frozen) >= 3, frozen
