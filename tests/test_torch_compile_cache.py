"""The port's compile-ahead subsystem (kube_batch_tpu_torch/ops/
compile_cache.py) against the reference's, on the CPU.

Twin of tests/test_compile_cache.py: the bucket ladder and the flag's
grammar are the reference's exactly; the warmup inputs are leaf for leaf
the staging of a live session; the warmup's key is the live route's; the
hit and miss counters move as the reference's do over the same warmup
and session sequence; the warmup thread is idempotent and stoppable; a
padded bucket solves as the exact shape; the warmup's conf is the
reference's.  The build directory and the manifest (the reference's
``TestPersistentCache``) are in tests/test_torch_kernel_cache.py.
"""

import numpy as np
import pytest
import torch

import kube_batch_tpu.ops.compile_cache as ref_cc
from kube_batch_tpu_torch.ops.compile_cache import (BucketSpec, SolverWarmup,
                                                    bucket, bucket_shapes,
                                                    make_bucket_inputs,
                                                    parse_warmup_buckets,
                                                    solve_key, warm_bucket)
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

# One tiny bucket shared by the tests that run the family.
SPEC = BucketSpec(60, 16, 8, 4)  # pads to (64, 16, 8, 8)


def _synthetic(spec=SPEC, dtype=torch.float32):
    from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
    return make_synthetic_inputs(n_tasks=spec.tasks, n_nodes=spec.nodes,
                                 n_jobs=spec.jobs, n_queues=spec.queues,
                                 dtype=dtype, device="cpu")


class TestBucketLadder:
    def test_powers_of_two_below_1024(self):
        assert bucket(1) == 8 and bucket(8) == 8
        assert bucket(9) == 16
        assert bucket(600) == 1024
        assert bucket(1024) == 1024

    def test_quarter_octaves_above_1024(self):
        assert bucket(1025) == 1280
        assert bucket(1281) == 1536
        assert bucket(1537) == 1792
        assert bucket(1793) == 2048
        assert bucket(10000) == 10240

    def test_ladder_is_the_reference_ladder(self):
        prev = 0
        for n in range(1, 70000, 997):
            b = bucket(n)
            assert b == ref_cc.bucket(n)
            assert b >= n and b >= prev
            if b > 1024:
                assert b % 256 == 0
            prev = b

    def test_bucket_shapes(self):
        assert bucket_shapes(50_000, 10_000, 2_000, 4) == \
            BucketSpec(57344, 10240, 2048, 8)
        assert tuple(bucket_shapes(50_000, 10_000, 2_000, 4)) == \
            tuple(ref_cc.bucket_shapes(50_000, 10_000, 2_000, 4))
        assert SPEC.padded() == BucketSpec(64, 16, 8, 8)


class TestParseWarmupBuckets:
    def test_full_and_defaulted_specs(self):
        specs = parse_warmup_buckets("50000x10000x2000x4; 1000x100")
        assert specs[0] == BucketSpec(50000, 10000, 2000, 4)
        assert specs[1] == BucketSpec(1000, 100, 40, 4)  # jobs=tasks/25
        assert [tuple(s) for s in specs] == [
            tuple(s) for s in ref_cc.parse_warmup_buckets(
                "50000x10000x2000x4; 1000x100")]

    def test_empty_entries_skipped(self):
        assert parse_warmup_buckets(" , 64x16x8x4,") == \
            [BucketSpec(64, 16, 8, 4)]

    @pytest.mark.parametrize("bad", ["64", "64x0", "axb", "1x2x3x4x5"])
    def test_malformed_fails_at_config_time(self, bad):
        with pytest.raises(ValueError) as port:
            parse_warmup_buckets(bad)
        with pytest.raises(ValueError) as ref:
            ref_cc.parse_warmup_buckets(bad)
        assert str(port.value) == str(ref.value)


class TestWarmupInputs:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_leaves_match_a_live_staging(self, dtype):
        """The zero-valued warmup inputs, shipped, are leaf for leaf a
        live session's inputs of the same bucket in shape and dtype."""
        from kube_batch_tpu_torch.models.shipping import DeviceResidentShipper
        warm = DeviceResidentShipper("cpu").ship(
            make_bucket_inputs(SPEC, dtype=dtype), None, dtype)
        live, _cfg = _synthetic(dtype=dtype)
        for name, w, l in zip(warm._fields, warm, live):
            assert tuple(w.shape) == tuple(l.shape), name
            assert w.dtype == l.dtype, name

    def test_solve_key_matches_live_route(self):
        """The warmup's key equals the key a live tpu-allocate session of
        the same sizes notes (its tensorized staging, its conf)."""
        from kube_batch_tpu_torch.models.synthetic import make_synthetic_cache
        from kube_batch_tpu_torch.ops.solver import choose_solver_mesh
        from tests.test_torch_utils import Pkg

        p = Pkg("torch", x64=False)
        cache, _binder = make_synthetic_cache(60, 16, 8, 4)
        ssn = p.m.framework.open_session(cache, p.tiers())
        try:
            snap = p.m.tensorize.tensorize_session(ssn, torch.float32)
        finally:
            p.m.framework.close_session(ssn)
        choice = choose_solver_mesh(_synthetic()[0])[0]
        spec = BucketSpec(60, 16, 8, 4)
        assert solve_key(choice, make_bucket_inputs(spec), snap.config) == \
            solve_key(choice, snap.inputs, snap.config)


def _deltas(cc, metrics, steps):
    """Hit/miss deltas of each step, from a forgotten seen-set."""
    cc.reset_seen()
    out = []
    for step in steps:
        h0, m0 = metrics.compile_cache_counts()
        step()
        h1, m1 = metrics.compile_cache_counts()
        out.append((h1 - h0, m1 - m0))
    return out


class TestWarmupAndHits:
    def test_hit_and_miss_deltas_equal_the_reference(self):
        """The same sequence in both packages: warm SPEC, a live solve at
        SPEC (a hit), a live solve at an unwarmed bucket (a miss), the
        same again (a hit).  Every step moves the counters as in the
        reference (the box-scan warm probes the ledger in both)."""
        import jax

        import kube_batch_tpu.metrics.metrics as ref_metrics
        import kube_batch_tpu_torch.metrics.metrics as metrics
        import kube_batch_tpu_torch.ops.compile_cache as cc
        from kube_batch_tpu.models.synthetic import \
            make_synthetic_inputs as ref_inputs
        from kube_batch_tpu.ops.solver import \
            best_solve_allocate as ref_solve
        from kube_batch_tpu_torch.ops.solver import best_solve_allocate

        other = BucketSpec(30, 24, 4, 2)
        with jax.enable_x64(False):
            r_spec = ref_inputs(SPEC.tasks, SPEC.nodes, SPEC.jobs,
                                SPEC.queues)
            r_other = ref_inputs(*other)
            ref = _deltas(ref_cc, ref_metrics, [
                lambda: ref_cc.warm_bucket(ref_cc.BucketSpec(*SPEC)),
                lambda: ref_solve(*r_spec),
                lambda: ref_solve(*r_other),
                lambda: ref_solve(*r_other)])
        p_spec, p_other = _synthetic(), _synthetic(other)
        port = _deltas(cc, metrics, [
            lambda: warm_bucket(SPEC, device="cpu"),
            lambda: best_solve_allocate(*p_spec),
            lambda: best_solve_allocate(*p_other),
            lambda: best_solve_allocate(*p_other)])
        assert port == ref
        assert port[1:] == [(1, 0), (0, 1), (1, 0)]

    def test_unwarmed_bucket_counts_a_miss(self):
        from kube_batch_tpu_torch.metrics.metrics import compile_cache_counts
        from kube_batch_tpu_torch.ops.compile_cache import (note_solve,
                                                            reset_seen)
        from kube_batch_tpu_torch.ops.solver import SolverConfig

        inp = make_bucket_inputs(BucketSpec(7, 7, 7, 7))
        cfg = SolverConfig()
        reset_seen()
        h0, m0 = compile_cache_counts()
        assert note_solve("torch", inp, cfg) is False
        assert note_solve("torch", inp, cfg) is True
        h1, m1 = compile_cache_counts()
        assert (h1 - h0, m1 - m0) == (1, 1)

    def test_warmup_thread_idempotent_and_shutdown(self):
        w = SolverWarmup([SPEC], device="cpu")
        assert w.start() is w
        assert w.start() is w  # second start: same thread, no second run
        w.join(120)
        assert w.done
        # One bucket x (the routed allocate solve + the batched eviction
        # scan + the candidate-row solve + the box scan + the fused
        # session program).
        assert len(w.records) == 5
        assert {r.solver for r in w.records} == {
            "torch", "evict_batch", "candidate", "topo_box", "fused"}
        assert w.errors == []
        w.stop()  # after completion: no-op, returns immediately

    def test_stop_before_heavy_work_skips_buckets(self):
        w = SolverWarmup([SPEC] * 4, device="cpu")
        w._stop.set()  # signal before start: every bucket is skipped
        w.start()
        w.join(30)
        assert w.done and w.records == []


def _repad(inp, spec):
    """Re-stage SolverInputs at a LARGER padded bucket with the exact
    padding semantics of tensorize_session: zero rows, exists=False,
    minavail=-1 for padding jobs, task_sorted=arange, coordinates -1."""
    from kube_batch_tpu_torch.ops.solver import SolverInputs

    p2, n2, j2, q2 = spec.padded()
    a = {name: v.numpy() for name, v in zip(inp._fields, inp)}

    def grow(arr, axis, new):
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (0, new - arr.shape[axis])
        return np.pad(arr, pad)

    out = dict(a)
    for f in ("task_req", "task_res", "task_sig", "task_ports",
              "task_aff_req", "task_anti", "task_match", "task_paff_w",
              "task_panti_w"):
        out[f] = grow(a[f], 0, p2)
    out["task_sorted"] = np.arange(p2, dtype=np.int32)
    for f in ("job_start", "job_count", "job_queue", "job_prio", "job_ts",
              "job_uid_rank", "job_init_ready", "job_init_alloc"):
        out[f] = grow(a[f], 0, j2)
    j = a["job_minavail"].shape[0]
    out["job_minavail"] = np.concatenate(
        [a["job_minavail"], np.full((j2 - j,), -1, np.int32)])
    for f in ("queue_deserved", "queue_deserved_f", "queue_init_alloc",
              "queue_ts", "queue_uid_rank", "queue_exists"):
        out[f] = grow(a[f], 0, q2)
    for f in ("node_idle", "node_releasing", "node_used", "node_alloc",
              "node_count", "node_max_tasks", "node_exists", "node_ports",
              "node_selcnt"):
        out[f] = grow(a[f], 0, n2)
    n = a["node_coords"].shape[0]
    out["node_coords"] = np.concatenate(
        [a["node_coords"],
         np.full((n2 - n, a["node_coords"].shape[1]), -1, np.int32)])
    for f in ("sig_mask", "sig_bonus"):
        out[f] = grow(a[f], 1, n2)
    return SolverInputs(**{k: torch.as_tensor(v) for k, v in out.items()})


class TestPaddedBucketParity:
    def test_padded_solve_equals_exact_shape_solve(self):
        """Bucket drift is free: the same session padded one rung up
        solves to identical assignment / kind / order on the real rows,
        with every padding row untouched."""
        from kube_batch_tpu_torch.ops.cuda_solver import solve_allocate_plain

        inputs, config = _synthetic()
        grown = _repad(inputs, BucketSpec(128, 32, 16, 16))
        base = solve_allocate_plain(inputs, config)[0]
        big = solve_allocate_plain(grown, config)[0]
        p = inputs.task_req.shape[0]
        assert torch.equal(base.assignment, big.assignment[:p])
        assert bool((big.assignment[p:] == -1).all())
        assert torch.equal(base.kind, big.kind[:p])
        assert bool((big.kind[p:] == 0).all())
        assert torch.equal(base.order, big.order[:p])
        assert int(base.step) == int(big.step)
        assert int((base.assignment >= 0).sum()) > 0  # non-vacuous


def _both_cfgs(conf):
    """solver_config_from_tiers of ``conf`` in each package, as tuples."""
    from kube_batch_tpu.actions.factory import \
        register_default_actions as ref_actions
    from kube_batch_tpu.models.tensor_snapshot import \
        solver_config_from_tiers as ref_cfg
    from kube_batch_tpu.plugins.factory import \
        register_default_plugins as ref_plugins
    from kube_batch_tpu.scheduler import load_scheduler_conf as ref_load
    from kube_batch_tpu_torch.actions.factory import register_default_actions
    from kube_batch_tpu_torch.models.tensor_snapshot import \
        solver_config_from_tiers
    from kube_batch_tpu_torch.plugins.factory import register_default_plugins
    from kube_batch_tpu_torch.scheduler import load_scheduler_conf

    ref_actions()
    ref_plugins()
    register_default_actions(device="cpu")
    register_default_plugins()
    return (solver_config_from_tiers(load_scheduler_conf(conf)[1]),
            ref_cfg(ref_load(conf)[1]))


class TestWarmupConfig:
    def test_default_conf_cfg_matches_live_sessions(self):
        """The boot warmup keys the SAME conf the loaded conf's sessions
        key on, and it is the reference's."""
        from kube_batch_tpu_torch.ops.solver import SolverConfig
        from kube_batch_tpu_torch.scheduler import DEFAULT_SCHEDULER_CONF

        port, ref = _both_cfgs(DEFAULT_SCHEDULER_CONF)
        assert port == SolverConfig()
        assert tuple(port) == tuple(ref)

    def test_non_default_conf_changes_cfg(self):
        conf = ("actions: \"tpu-allocate\"\n"
                "tiers:\n"
                "- plugins:\n"
                "  - name: priority\n"
                "  - name: drf\n")
        port, ref = _both_cfgs(conf)
        assert port is not None
        assert port.has_gang is False
        assert port.has_proportion is False
        assert port.job_key_order == ("priority", "drf")
        assert port.queue_key_order == ()
        assert tuple(port) == tuple(ref)

    def test_unsupported_conf_skips_warmup(self):
        from kube_batch_tpu.conf import PluginOption as RefOption
        from kube_batch_tpu.conf import Tier as RefTier
        from kube_batch_tpu.models.tensor_snapshot import \
            solver_config_from_tiers as ref_cfg
        from kube_batch_tpu_torch.conf import PluginOption, Tier
        from kube_batch_tpu_torch.models.tensor_snapshot import (
            solver_config_from_tiers)

        tiers = [Tier(plugins=[PluginOption(name="mystery-plugin")])]
        assert solver_config_from_tiers(tiers) is None
        assert ref_cfg([RefTier(plugins=[RefOption(
            name="mystery-plugin")])]) is None


class TestMetricsSurface:
    def test_counters_and_gauges_exposed(self):
        from kube_batch_tpu_torch.metrics.metrics import (
            registry, set_bucket_pad_waste)
        set_bucket_pad_waste("tasks", 0.25)
        text = registry.expose()
        assert "kube_batch_compile_cache_hits_total" in text
        assert "kube_batch_compile_cache_misses_total" in text
        assert "kube_batch_compile_cache_inflight" in text
        assert 'kube_batch_bucket_pad_waste_ratio{axis="tasks"} 0.25' in text
