"""Heterogeneous-snapshot tensorization, the JAX package against the port,
on the CPU.

Twin of tests/test_tensorize_hetero.py: with 64 static signatures the
port's [S, N] predicate mask and score bonus equal a brute-force
predicate_fn walk per (signature, node) and the JAX package's arrays; the
predicate calls scale with node profiles, not nodes; and the device
solve places exactly like the host allocate oracle in both packages.
Both packages load the default conf whole.
"""

import numpy as np

from tests.test_torch_utils import twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

S = 64


def _open_hetero(p, n_tasks=256, n_nodes=96, n_jobs=S, n_queues=4):
    cache, _ = p.mod.models_synthetic.make_synthetic_cache(
        n_tasks, n_nodes, n_jobs, n_queues, n_signatures=S)
    return p.m.framework.open_session(cache, p.tiers())


def _tensorize(p, ssn):
    ts = p.mod.models_tensor_snapshot
    if p.pkg == "torch":
        return ts.tensorize_session(ssn, p.dtype)
    return ts.tensorize_session(ssn)


def test_mask_matches_bruteforce():
    def body(p):
        ts = p.mod.models_tensor_snapshot
        nodeorder = p.mod.plugins_nodeorder
        ssn = _open_hetero(p)
        try:
            snap = _tensorize(p, ssn)
            assert not snap.needs_fallback, snap.fallback_reason
            sig_mask = np.asarray(snap.inputs.sig_mask)
            sig_bonus = np.asarray(snap.inputs.sig_bonus)
            seen, examples = {}, []
            for t in snap.tasks:
                sig = ts._task_signature(t)
                if sig not in seen:
                    seen[sig] = len(examples)
                    examples.append(t)
            assert len(examples) >= S
            node_objs = [ssn.nodes[name] for name in snap.node_names]
            for si, example in enumerate(examples):
                stripped = ts._static_example(example)
                for nix, node in enumerate(node_objs):
                    try:
                        ssn.predicate_fn(stripped, node)
                        expect = True
                    except Exception:
                        # lint: allow-swallow(the host predicate IS the oracle here — any raise means infeasible, mirrored against the device mask below)
                        expect = False
                    assert sig_mask[si, nix] == expect, (si, nix)
                    affinity = example.pod.spec.affinity
                    if affinity is not None and \
                            affinity.preferred_node_terms:
                        assert sig_bonus[si, nix] == \
                            nodeorder.node_affinity_score(example, node)
            return sig_mask.tolist(), sig_bonus.tolist()
        finally:
            p.m.framework.close_session(ssn)
    twin(body)


def test_predicate_calls_scale_with_profiles_not_nodes():
    def body(p):
        ssn = _open_hetero(p, n_nodes=96)
        try:
            calls = [0]
            inner = ssn.predicate_fn

            def counting(task, node):
                calls[0] += 1
                return inner(task, node)

            ssn.predicate_fn = counting
            snap = _tensorize(p, ssn)
            assert not snap.needs_fallback, snap.fallback_reason
            n_sigs = int(np.asarray(snap.inputs.sig_mask).shape[0])
            assert calls[0] <= n_sigs * 8, calls[0]
            assert calls[0] < n_sigs * 96
            return calls[0], n_sigs
        finally:
            p.m.framework.close_session(ssn)
    twin(body)


def test_hetero_device_host_parity():
    def body(p):
        results = []
        for action in ("allocate", "tpu_allocate"):
            cache, binder = p.mod.models_synthetic.make_synthetic_cache(
                128, 24, 16, 2, n_signatures=16)
            ssn = p.m.framework.open_session(cache, p.tiers())
            try:
                p.action(action).execute(ssn)
            finally:
                p.m.framework.close_session(ssn)
            results.append(dict(binder.binds))
        host, dev = results
        assert dev == host and host
        return dev
    twin(body)
