"""Topology-aware slice placement in the port against the JAX package: the
twin of tests/test_topology.py's classes that need only ported modules.

* the label and slice-shape grammar, view build, duplicate and declared-
  dims rules, fragmentation accounting (``TestGrammar``, ``TestViewBuild``);
* the port's batched ``box_scan`` (PyTorch tensor code) exactly equal to
  the jitted reference and to ``box_scan_seq`` on tori with wrap-around,
  dims of 1, several pods and invalid rows (``TestBoxScanParity``; the mesh
  case is in tests/test_torch_mesh_twins.py);
* the chaos site ``topology.bad_coords`` (``TestBadCoordsChaos``);
* the reference's ``bench._run_topo_arm`` protocol on ``make_topo_cache``
  at 4x4x2 in its three arms — binds, evictions in order, fragmentation
  stats and pod-group conditions equal to the JAX package's (the
  scenario-generator and replay classes, ``TestScenarioDeterminism``,
  ``TestE2ESlicePlacement`` and ``TestReplayRoundTrip``, are twinned
  over the port's tools in tests/test_torch_scenarios.py and
  tests/test_torch_replay.py);
* the tensorizer's coordinate leaf and the folded fragmentation bonus,
  in a full build and in a micro build after a node's labels change.
"""

import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch

from kube_batch_tpu_torch.ops.compile_cache import bucket
from tests.test_torch_utils import reference_gc_guard  # noqa: F401
from tests.test_torch_utils import (Pkg, _status_record, build_node,
                                    environ, session_state, twin)

TOPO_CONF = """
actions: "topo-allocate, tpu-allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: topology
"""

ROOTS = {"jax": "kube_batch_tpu", "torch": "kube_batch_tpu_torch"}


def mods(pkg):
    """One package's topology modules by attribute."""
    root = ROOTS[pkg]
    return types.SimpleNamespace(**{
        name.split(".")[-1]: importlib.import_module(f"{root}.{name}")
        for name in ("models.topology", "ops.topo_solver", "chaos.plan",
                     "chaos.breaker", "metrics.metrics", "ops.resources",
                     "models.synthetic", "framework", "api",
                     "models.incremental", "trace.spans")})


@pytest.fixture(autouse=True)
def _clean_chaos():
    for pkg in ROOTS:
        m = mods(pkg)
        m.plan.disable()
        m.breaker.device_breaker().reset()
    yield
    for pkg in ROOTS:
        m = mods(pkg)
        m.plan.disable()
        m.breaker.device_breaker().reset()


def both(body):
    """``body(m, pkg)`` for the JAX package and the port: the results must
    be equal; returns the port's."""
    out = {pkg: body(mods(pkg), pkg) for pkg in ROOTS}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _ninfo(name, labels, pkg):
    return types.SimpleNamespace(node=build_node(
        name, {"cpu": "8", "memory": "16Gi", "pods": "110"},
        labels=dict(labels), pkg=pkg))


def _labels(topo, pod, x, y, z):
    return {topo.POD_LABEL: pod, topo.RACK_LABEL: str(x // 2),
            topo.AXIS_LABELS[0]: str(x), topo.AXIS_LABELS[1]: str(y),
            topo.AXIS_LABELS[2]: str(z)}


def _torus(m, pkg, dx, dy, dz, pod="pod-a", prefix="t"):
    """{name: node-info} for a fully coordinate-labeled dx*dy*dz torus."""
    return {f"{prefix}-{x}-{y}-{z}": _ninfo(
        f"{prefix}-{x}-{y}-{z}", _labels(m.topology, pod, x, y, z), pkg)
        for x in range(dx) for y in range(dy) for z in range(dz)}


def view_record(view):
    return (list(view.node_names), view.coords.tolist(),
            view.valid.tolist(), view.n_valid, list(view.pools),
            sorted(view.pool_of.items()))


# ----------------------------------------------------------------------
# grammar


class TestGrammar:
    def test_coord_labels_good_and_rack_default(self):
        def body(m, _pkg):
            t = m.topology
            labels = {t.POD_LABEL: "p", t.AXIS_LABELS[0]: "1",
                      t.AXIS_LABELS[1]: "2", t.AXIS_LABELS[2]: "0"}
            first = t.parse_coord_labels(labels)
            labels[t.RACK_LABEL] = "r7"
            return first, t.parse_coord_labels(labels)
        assert both(body) == (("p", "0", 1, 2, 0), ("p", "r7", 1, 2, 0))

    @pytest.mark.parametrize("mutate", [
        lambda t, d: d.pop(t.POD_LABEL),
        lambda t, d: d.pop(t.AXIS_LABELS[2]),
        lambda t, d: d.update({t.AXIS_LABELS[0]: "one"}),
        lambda t, d: d.update({t.AXIS_LABELS[1]: "-1"}),
        lambda t, d: d.update({t.POD_LABEL: ""}),
    ])
    def test_coord_labels_malformed_is_none(self, mutate):
        def body(m, _pkg):
            t = m.topology
            labels = {t.POD_LABEL: "p", t.AXIS_LABELS[0]: "1",
                      t.AXIS_LABELS[1]: "2", t.AXIS_LABELS[2]: "0"}
            mutate(t, labels)
            return t.parse_coord_labels(labels)
        assert both(body) is None

    def test_slice_shape_grammar(self):
        cases = ("2x2x4", "4", "2x3", "2X2", None, "", "0x2", "axb",
                 "1x2x3x4", "2x-1", "2.5")
        got = both(lambda m, _p: [m.topology.parse_slice_shape(c)
                                  for c in cases])
        assert got == [(2, 2, 4), (4, 1, 1), (2, 3, 1), (2, 2, 1)] \
            + [None] * 7

    def test_dim_labels(self):
        def body(m, _pkg):
            t = m.topology
            return (t.parse_dim_labels({t.DIM_LABELS[0]: "oops"}),
                    t.parse_dim_labels({t.DIM_LABELS[0]: "0"}),
                    t.parse_dim_labels({t.DIM_LABELS[1]: "4"}))
        assert both(body) == (None, None, (0, 4, 0))


# ----------------------------------------------------------------------
# view build + fragmentation accounting


class TestViewBuild:
    def test_coords_dims_and_pools(self):
        def body(m, pkg):
            view = m.topology.build_view(_torus(m, pkg, 4, 2, 2))
            row = view.node_names.index("t-3-1-0")
            return view_record(view), list(view.coords[row])
        _rec, row = both(body)
        assert row == [0, 1, 3, 1, 0, 4, 2, 2]

    def test_malformed_and_unlabeled_degrade_single_node(self):
        def body(m, pkg):
            t = m.topology
            nodes = _torus(m, pkg, 2, 2, 1)
            nodes["t-0-0-0"].node.metadata.labels[t.AXIS_LABELS[0]] = "oops"
            nodes["flat-1"] = _ninfo("flat-1", {}, pkg)
            return view_record(t.build_view(nodes))
        assert both(body)[3] == 3

    @pytest.mark.parametrize("claimants", [1, 2])
    def test_duplicate_coordinates_degrade_every_claimant(self, claimants):
        def body(m, pkg):
            t = m.topology
            nodes = _torus(m, pkg, 2, 2, 1)
            labels = nodes["t-1-1-0"].node.metadata.labels
            for i in range(claimants):
                nodes[f"t-dup-{i}"] = _ninfo(f"t-dup-{i}", labels, pkg)
            before = m.metrics.topo_bad_coords.value()
            view = t.build_view(nodes)
            return (view_record(view),
                    m.metrics.topo_bad_coords.value() - before)
        rec, counted = both(body)
        assert rec[3] == 3 and counted == claimants

    def test_declared_dims_prevent_partial_axis_wrap(self):
        def body(m, pkg):
            t = m.topology
            out = []
            for declare in (False, True):
                nodes = {}
                for x in range(3):
                    labels = {t.POD_LABEL: "p", t.AXIS_LABELS[0]: str(x),
                              t.AXIS_LABELS[1]: "0", t.AXIS_LABELS[2]: "0"}
                    if declare:
                        labels[t.DIM_LABELS[0]] = "8"
                    nodes[f"t-{x}-0-0"] = _ninfo(f"t-{x}-0-0", labels, pkg)
                view = t.build_view(nodes)
                out.append((view_record(view),
                            [sorted(n) for n in view.neighbors()]))
            return out
        (inferred, nbrs_inf), (declared, nbrs_decl) = both(body)
        assert nbrs_inf[0] == [1, 2]           # the false wrap
        assert nbrs_decl[0] == [1] and declared[1][0][5] == 8

    def test_coords_leaf_matches_session_view(self):
        def body(m, pkg):
            t = m.topology
            nodes = _torus(m, pkg, 2, 2, 2)
            nodes["t-dup"] = _ninfo(
                "t-dup", nodes["t-0-0-0"].node.metadata.labels, pkg)
            nodes["t-1-1-1"].node.metadata.labels[t.DIM_LABELS[2]] = "4"
            names = sorted(nodes)
            view = t.build_view(nodes)
            parsed = [t.parse_coord_labels(nodes[n].node.metadata.labels)
                      for n in names]
            declared = [t.parse_dim_labels(nodes[n].node.metadata.labels)
                        if parsed[i] is not None else None
                        for i, n in enumerate(names)]
            leaf = t.coords_leaf(t.view_from_parsed(
                names, parsed, declared, count_bad=False), 16)
            np.testing.assert_array_equal(leaf[:len(names)],
                                          view.coords[:len(names)])
            assert leaf[len(names):].min() == -1 == leaf[len(names):].max()
            return leaf.tolist()
        both(body)

    def test_frag_stats(self):
        def body(m, pkg):
            view = m.topology.build_view(_torus(m, pkg, 4, 2, 2))
            full = view.frag_stats(np.ones((16,), bool))
            free = np.asarray([sum(int(v) for v in n.split("-")[1:]) % 2 == 0
                               for n in view.node_names])
            empty = m.topology.build_view(_torus(m, pkg, 2, 2, 1)) \
                .frag_stats(np.zeros((4,), bool))
            return full, view.frag_stats(free), empty
        full, checker, empty = both(body)
        assert full["pod-a"] == {"free": 16, "largest_block": 16,
                                 "frag_ratio": 0.0}
        assert checker["pod-a"] == {"free": 8, "largest_block": 1,
                                    "frag_ratio": 0.875}
        assert empty["pod-a"] == {"free": 0, "largest_block": 0,
                                  "frag_ratio": 0.0}

    def test_frag_bonus_exact_grid_integers(self):
        def body(m, pkg):
            view = m.topology.build_view(_torus(m, pkg, 4, 2, 2))
            occupied = np.zeros((16,), bool)
            occupied[view.node_names.index("t-1-0-0")] = True
            bonus = view.frag_bonus(occupied, 2)
            assert bonus.dtype == np.int32
            holed = _torus(m, pkg, 4, 2, 2)
            del holed["t-1-0-0"]
            hview = m.topology.build_view(holed)
            return (bonus.tolist(), view.frag_bonus(occupied, 0).tolist(),
                    hview.frag_bonus(np.zeros((15,), bool), 1).tolist(),
                    view.node_names.index("t-0-0-0"),
                    hview.node_names.index("t-0-0-0"))
        bonus, zero, holed, row, hrow = both(body)
        k = mods("torch").resources.SCORE_GRID_K
        assert bonus[row] == 2 * k and all(b % (2 * k) == 0 for b in bonus)
        assert not any(zero)
        assert holed[hrow] == k    # a hole counts as an occupied neighbor


# ----------------------------------------------------------------------
# batched box scan == jitted reference == sequential oracle

# (tori as (pod, dims), degrade these nodes, add this many flat nodes)
CLUSTERS = {
    "4x4x2-degraded": ([("pod-a", (4, 4, 2))], ["t0-0-1-0"], 1),
    "3x1x2+2x2x1": ([("pod-a", (3, 1, 2)), ("pod-b", (2, 2, 1))], [], 2),
    "5x3x1": ([("pod-a", (5, 3, 1))], ["t0-4-2-0"], 0),
    "2x2x2+1x1x3": ([("pod-a", (2, 2, 2)), ("pod-b", (1, 1, 3))], [], 0),
}
CASES = [("4x4x2-degraded", s) for s in ((2, 2, 2), (1, 2, 4), (4, 1, 1),
                                         (3, 2, 1))] \
    + [("3x1x2+2x2x1", (2, 1, 2)), ("3x1x2+2x2x1", (3, 1, 1)),
       ("3x1x2+2x2x1", (2, 2, 1)), ("5x3x1", (2, 2, 1)),
       ("5x3x1", (5, 3, 1)), ("2x2x2+1x1x3", (1, 1, 3)),
       ("2x2x2+1x1x3", (2, 2, 2))]


def cluster(m, pkg, name):
    tori, degrade, n_flat = CLUSTERS[name]
    nodes = {}
    for i, (pod, dims) in enumerate(tori):
        nodes.update(_torus(m, pkg, *dims, pod=pod, prefix=f"t{i}"))
    for name_ in degrade:
        nodes[name_].node.metadata.labels.pop(m.topology.POD_LABEL)
    for i in range(n_flat):
        nodes[f"flat-{i}"] = _ninfo(f"flat-{i}", {}, pkg)
    return m.topology.build_view(nodes)


def random_masks(seed, n):
    rng = np.random.default_rng(seed)
    free = rng.random(n) < 0.4
    evictable = ~free & (rng.random(n) < 0.5)
    vic_cnt = np.where(evictable, rng.integers(1, 4, n), 0).astype(np.int32)
    vic_cost = (vic_cnt * rng.integers(1, 100, n)).astype(np.int32)
    return free, evictable, vic_cnt, vic_cost


def padded(view, masks):
    n = len(view.node_names)
    n_pad = bucket(n)
    coords = np.full((n_pad, 8), -1, np.int32)
    coords[:n] = view.coords[:n]

    def pad(a):
        out = np.zeros((n_pad,), a.dtype)
        out[:n] = a
        return out

    return (coords,) + tuple(pad(a) for a in masks)


class TestBoxScanParity:
    @pytest.mark.parametrize("case,shape", CASES,
                             ids=[f"{c}-{'x'.join(map(str, s))}"
                                  for c, s in CASES])
    def test_batched_equals_jitted_reference_and_oracle(self, case, shape):
        seed = sum(map(ord, case)) + 7 * sum(shape)
        out = {}
        for pkg in ROOTS:
            m = mods(pkg)
            view = cluster(m, pkg, case)
            n = len(view.node_names)
            masks = random_masks(seed, n)
            oracle = m.topo_solver.box_scan_seq(view, *masks, shape)
            arrays = padded(view, masks)
            if pkg == "torch":
                inp = m.topo_solver.BoxInputs(
                    *(torch.from_numpy(a) for a in arrays))
                batched = m.topo_solver.box_scan(inp, *shape).numpy()
                assert batched.dtype == np.int32
            else:
                batched = np.asarray(m.topo_solver.box_scan(
                    m.topo_solver.BoxInputs(*arrays), *shape))
            np.testing.assert_array_equal(batched[:n], oracle)
            assert (batched[n:] == 0).all()   # padding rows are no origin
            out[pkg] = batched.tolist(), oracle.tolist()
        assert out["torch"] == out["jax"]
        assert any(any(row) for row in out["torch"][1]), "all-zero stats"

    def test_dispatch_counts_the_route_and_equals_the_oracle(self):
        m = mods("torch")
        view = m.topology.build_view(_torus(m, "torch", 2, 2, 2))
        n = len(view.node_names)
        free = np.zeros((n,), bool)
        free[:4] = True
        zeros = np.zeros((n,), np.int32)
        before = m.metrics.route_counts().get("topo/torch", 0)
        out = m.topo_solver.dispatch_box_scan(
            m.topo_solver.BoxInputs(view.coords[:n].copy(), free,
                                    np.zeros((n,), bool), zeros,
                                    zeros.copy()), (2, 2, 1), "cpu")
        np.testing.assert_array_equal(out, m.topo_solver.box_scan_seq(
            view, free, np.zeros((n,), bool), zeros, zeros, (2, 2, 1)))
        assert m.metrics.route_counts()["topo/torch"] == before + 1
        assert m.topo_solver.choose_topo_route(8) == ("torch", None)
        assert m.topo_solver.topo_solve_key("torch", 8, [2, 2, 1]) == \
            ("topo_box", "torch", 8, (2, 2, 1))

    def test_sharded_route_waits_for_the_mesh(self):
        """The origin-sharded scan raised until the mesh was ported; now
        two CPU shards answer their own origin rows, equal to the
        single-device scan, and a bucket that does not divide into the
        shards is refused."""
        from kube_batch_tpu_torch.parallel import make_mesh
        m = mods("torch")
        view = m.topology.build_view(_torus(m, "torch", 2, 2, 2))
        n = len(view.node_names)
        rng = np.random.default_rng(3)
        free = rng.random(n) < 0.6
        evictable = ~free & (rng.random(n) < 0.5)
        vic = rng.integers(0, 3, n).astype(np.int32)
        inp = m.topo_solver.BoxInputs(view.coords[:n].copy(), free,
                                      evictable, vic, vic * 7)
        single = m.topo_solver.box_scan(
            m.topo_solver.stage_box_inputs(inp, "cpu"), 2, 2, 1).numpy()
        sharded = m.topo_solver.box_scan_sharded(inp, 2, 2, 1,
                                                 make_mesh(2)).numpy()
        np.testing.assert_array_equal(sharded, single)
        with pytest.raises(ValueError, match="do not divide"):
            m.topo_solver.box_scan_sharded(inp, 2, 2, 1, make_mesh(3))


# ----------------------------------------------------------------------
# chaos site topology.bad_coords


class TestBadCoordsChaos:
    def test_site_degrades_nodes_counts_and_survives(self):
        def body(m, pkg):
            before = m.metrics.topo_bad_coords.value()
            m.plan.install(m.plan.FaultPlan(
                seed=11, rate=1.0, sites=("topology.bad_coords",)))
            degraded = m.topology.build_view(_torus(m, pkg, 2, 2, 1))
            counted = m.metrics.topo_bad_coords.value() - before
            m.plan.disable()
            return (degraded.n_valid, counted,
                    m.topology.build_view(_torus(m, pkg, 2, 2, 1)).n_valid)
        assert both(body) == (0, 4, 4)

    def test_slice_refuses_organically_degraded_node(self):
        """The only feasible box holds a node with malformed coordinate
        labels: the slice stays pending, never scattered flat."""
        def body(p):
            t = mods(p.pkg).topology
            cache, binder, _ev = p.empty_cache()
            cache.add_queue(p.queue("q0"))
            for x in (0, 1):
                for y in (0, 1):
                    labels = _labels(t, "p", x, y, 0)
                    if (x, y) == (0, 0):
                        labels[t.AXIS_LABELS[0]] = "oops"
                    cache.add_node(p.node(
                        f"t-{x}-{y}-0", {"cpu": "8", "memory": "16Gi",
                                         "pods": 110}, labels=labels))
            pg = p.pod_group("s", "topo", 4, "q0")
            pg.metadata.annotations[t.SLICE_SHAPE_ANNOTATION] = "2x2x1"
            cache.add_pod_group(pg)
            for i in range(4):
                cache.add_pod(p.pod("topo", f"s-{i}", "", "Pending",
                                    {"cpu": "4", "memory": "4Gi"},
                                    groupname="s", ts=float(i)))
            actions, tiers = p.load(TOPO_CONF)
            conds = []
            for _ in range(2):
                ssn = p.m.framework.open_session(cache, tiers)
                try:
                    for a in actions:
                        a.execute(ssn)
                finally:
                    p.m.framework.close_session(ssn)
            for pgs in cache.status_updater.pod_groups:
                conds.append(_status_record(pgs))
            return dict(binder.binds), conds
        binds, conds = twin(body)
        assert binds == {}
        assert any(c[2] == "NoContiguousSlice"
                   for rec in conds for c in rec[-1])


# ----------------------------------------------------------------------
# end to end: bench._run_topo_arm on make_topo_cache


def run_topo_arm(p, defrag, batch, dims=(4, 4, 2), slice_shape="2x2x2",
                 env=None):
    """The reference's two-cycle fragmentation-pressure protocol: cycle 1,
    the evicted victims echoed as deletions, the fragmentation stats at
    truth, cycle 2.  Returns what the twins compare."""
    m = mods(p.pkg)
    arm = {m.topology.TOPO_BATCH_ENV: "1" if batch else "0",
           m.topology.TOPO_DEFRAG_ENV: "1" if defrag else "0",
           **(env or {})}
    with environ(arm):
        cache, binder = m.synthetic.make_topo_cache(
            dims=dims, slice_shape=slice_shape)
        actions, tiers = p.load(TOPO_CONF)
        assert [a.name() for a in actions] == ["topo-allocate",
                                                "tpu-allocate", "backfill"]
        podmap = {m.api.pod_key(t.pod): t.pod for job in cache.jobs.values()
                  for t in job.tasks.values()}
        dispatches = m.metrics.session_dispatch_counts().get("topo", 0)

        def cycle():
            ssn = m.framework.open_session(cache, tiers)
            try:
                for a in actions:
                    a.execute(ssn)
            finally:
                m.framework.close_session(ssn)

        cycle()
        evicts = list(cache.evictor.evicts)
        for key in evicts:
            pod = podmap.pop(key, None)
            if pod is not None:
                cache.delete_pod(pod)
        snap_nodes = {name: cache.nodes[name] for name in cache.nodes}
        view = m.topology.build_view(snap_nodes)
        free = np.asarray([not snap_nodes[n].tasks
                           for n in view.node_names], bool) & view.valid
        frag_after = view.frag_stats(free)
        cycle()
    return dict(
        binds=list(binder.binds.items()), channel=list(binder.channel),
        evicts=evicts, frag_after=frag_after, events=list(cache.events),
        statuses=[_status_record(pg)
                  for pg in cache.status_updater.pod_groups],
        dispatches=m.metrics.session_dispatch_counts().get("topo", 0)
        - dispatches)


ARMS = [(True, True), (True, False), (False, True)]   # (defrag, batch)


@pytest.mark.parametrize("x64", [True, False], ids=["x64", "f32"])
@pytest.mark.parametrize("defrag,batch", ARMS,
                         ids=["defrag-batched", "defrag-oracle",
                              "capacity-batched"])
def test_topo_arm_equals_the_reference(defrag, batch, x64):
    got = twin(lambda p: run_topo_arm(p, defrag, batch), x64=x64)
    slice_binds = [host for key, host in got["binds"] if "slice0" in key]
    if defrag:
        assert len(got["evicts"]) == 4 and len(slice_binds) == 8
        coords = sorted(tuple(int(v) for v in h.split("-")[2:])
                        for h in slice_binds)
        x0, y0, z0 = coords[0]
        assert coords == sorted(((x0 + a) % 4, (y0 + b) % 4, (z0 + c) % 2)
                                for a in range(2) for b in range(2)
                                for c in range(2))
        assert got["frag_after"]["pod-a"]["largest_block"] >= 8
    else:
        assert got["evicts"] == [] and slice_binds == []
        assert got["frag_after"]["pod-a"]["largest_block"] == 1
    assert got["dispatches"] == (2 if batch else 0)


def test_topology_off_is_bit_parity_with_an_unlisted_conf():
    p = Pkg("torch")
    off = run_topo_arm(p, True, True,
                       env={mods("torch").topology.TOPOLOGY_ENV: "0"})
    conf = TOPO_CONF.replace('"topo-allocate, tpu-allocate, backfill"',
                             '"tpu-allocate, backfill"') \
        .replace("  - name: topology\n", "")
    m = mods("torch")
    with environ({m.topology.TOPOLOGY_ENV: "1"}):
        cache, binder = m.synthetic.make_topo_cache()
        actions, tiers = p.load(conf)
        for _ in range(2):
            ssn = m.framework.open_session(cache, tiers)
            try:
                for a in actions:
                    a.execute(ssn)
            finally:
                m.framework.close_session(ssn)
    assert off["binds"] == list(binder.binds.items())
    assert off["evicts"] == list(cache.evictor.evicts) == []


def test_max_nodes_cap_degrades_and_never_scatters():
    def body(p):
        m = mods(p.pkg)
        before = m.metrics.topo_slice_counts().get("degraded", 0)
        got = run_topo_arm(p, True, True,
                           env={m.topology.TOPO_MAX_NODES_ENV: "2"})
        got["degraded"] = m.metrics.topo_slice_counts().get(
            "degraded", 0) - before
        return got
    got = twin(body)
    assert got["degraded"] == 2 and got["dispatches"] == 0
    assert not any("slice0" in key for key, _ in got["binds"])


def test_a_failed_device_scan_raises(monkeypatch):
    """A failed device box scan degrades to the numpy oracle, as in the
    reference: the action does not raise, places what the
    ``TOPO_BATCH=0`` arm places, counts the swallowed scan, and — unlike
    the reference — also feeds the device breaker under stage ``topo``
    with a degraded note (a fed breaker is what keeps the fallback
    from being silent)."""
    m = mods("torch")
    import kube_batch_tpu_torch.chaos.breaker as brk
    breaker = brk.CircuitBreaker("device_solve", threshold=99,
                                 cooldown=1.0)
    monkeypatch.setattr(brk, "_device_breaker", breaker)

    def arm(batch):
        with environ({m.topology.TOPO_BATCH_ENV: batch,
                      "KUBE_BATCH_TPU_FUSED": "0"}):
            cache, _binder = m.synthetic.make_topo_cache()
            actions, tiers = Pkg("torch").load(TOPO_CONF)
            ssn = m.framework.open_session(cache, tiers)
            m.spans.begin_session()
            try:
                actions[0].execute(ssn)
                notes = m.spans.current_trace().meta.get("degraded", [])
                return session_state(ssn), list(cache.evictor.evicts), notes
            finally:
                m.spans.end_session()
                m.framework.close_session(ssn)

    oracle = arm("0")

    def fail(*_a, **_k):
        raise RuntimeError("device scan failed")

    monkeypatch.setattr(m.topo_solver, "box_scan", fail)
    swallowed = m.metrics.swallowed_exceptions.value("topo_box_scan")
    failures = m.metrics.device_solve_failures.value("topo")
    state, evicts, notes = arm("1")
    assert (state, evicts) == oracle[:2] and evicts
    assert m.metrics.swallowed_exceptions.value("topo_box_scan") \
        == swallowed + 1
    assert m.metrics.device_solve_failures.value("topo") == failures + 1
    assert breaker._failures == 1
    assert [n for n in notes if "host oracle" in n] == [
        "topo box scan degraded to the host oracle (RuntimeError: device "
        "scan failed)"]


# ----------------------------------------------------------------------
# the tensorizer's coordinate leaf and the folded fragmentation bonus


def _leaf_rows(snap):
    inp = snap.inputs
    return (np.asarray(inp.node_coords).tolist(),
            np.asarray(inp.sig_bonus).tolist(), list(snap.node_names))


def tensorize_topology(p):
    """A labelled topo cache under the topology plugin: a full build, one
    session, then a node's coordinates change (it moves to a position the
    torus lacked, and a second node loses its labels) and the next build
    is micro.  Returns the leaf, the folded bonus and the plugin's bonus
    rows of both builds, and each build's kind."""
    m = mods(p.pkg)
    cache, binder = m.synthetic.make_topo_cache(dims=(4, 2, 2))
    actions, tiers = p.load(TOPO_CONF)
    tensorize = p.mod.models_tensor_snapshot.tensorize_session
    out = []

    def build():
        ssn = m.framework.open_session(cache, tiers)
        try:
            snap = (tensorize(ssn) if p.pkg == "jax"
                    else tensorize(ssn, p.dtype))
            bonus = ssn.prescan["topo_frag_bonus"].tolist()
            for a in actions:
                a.execute(ssn)
        finally:
            m.framework.close_session(ssn)
        state = m.incremental.state_for(cache, create=False)
        out.append((_leaf_rows(snap), bonus,
                    state.last_kind if state is not None else None))

    build()
    t = m.topology
    for name, labels in (("t-0-3-1-1", _labels(t, "pod-a", 3, 2, 1)),
                         ("t-0-0-1-0", {})):
        old = cache.nodes[name].node
        cache.update_node(old, dataclasses.replace(
            old, metadata=dataclasses.replace(old.metadata, labels=labels)))
    build()
    return out


@pytest.mark.parametrize("x64", [True, False], ids=["x64", "f32"])
def test_coordinate_leaf_and_frag_bonus_equal_the_reference(x64):
    (full, micro) = twin(tensorize_topology, x64=x64)
    for (coords, sig_bonus, names), bonus, _kind in (full, micro):
        n = len(names)
        assert any(bonus) and any(row[0] >= 0 for row in coords)
        # No preferred-affinity bonus here: the folded rows are the
        # plugin's bonus exactly, on every signature row.
        for row in sig_bonus:
            assert row[:n] == bonus
    assert micro[2] == "micro"
    assert full[0][0] != micro[0][0]          # the leaf moved
    moved = micro[0][2].index("t-0-3-1-1")
    assert micro[0][0][moved][2:5] == [3, 2, 1]
    assert micro[0][0][micro[0][2].index("t-0-0-1-0")] == [-1] * 8
