"""The eviction engine's tensor programs, the JAX package against the port.

``ops/scan.scan_nodes`` (one preemptor's [N] fit-and-score row) and
``ops/evict_solver.evict_batch_solve`` (the [K, N] rows of K profiles and
the victim permutation) run on the same seeded numpy inputs through the
JAX package's jitted programs and through the port's PyTorch code on the
CPU.  Exact equality: every term is int32, and the victim permutation is
the lexsort's, padding rows (node = N, rank = mb) in index order.  Cases
cover host ports, required pod (anti-)affinity, the preferred-affinity
score, other score weights, and K and M at bucket edges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.ops import evict_solver as jax_evict
from kube_batch_tpu.ops import scan as jax_scan
from kube_batch_tpu.ops.scoring import ScoreWeights as JaxWeights
from kube_batch_tpu.ops.solver import SolverConfig as JaxConfig
from kube_batch_tpu_torch.ops import evict_solver as torch_evict
from kube_batch_tpu_torch.ops import scan as torch_scan
from kube_batch_tpu_torch.ops.compile_cache import bucket
from kube_batch_tpu_torch.ops.resources import score_shift_for
from kube_batch_tpu_torch.ops.scoring import SCORE_NEG_INF
from kube_batch_tpu_torch.ops.scoring import ScoreWeights as TorchWeights
from kube_batch_tpu_torch.ops.solver import SolverConfig as TorchConfig

# name: (has_ports, has_pod_affinity, has_pod_affinity_score, weights)
CONFIGS = {
    "plain": (False, False, False, (1, 0, 1)),
    "ports": (True, False, False, (1, 0, 1)),
    "affinity": (False, True, False, (1, 0, 1)),
    "affinity-score": (False, False, True, (1, 0, 1)),
    "all-most-requested": (True, True, True, (2, 3, 1)),
}
N_REAL, N_PAD, R, NP, NS, S = 37, 48, 3, 4, 5, 6


def configs(name):
    ports, aff, aff_score, w = CONFIGS[name]
    kw = dict(has_ports=ports, has_pod_affinity=aff,
              has_pod_affinity_score=aff_score)
    return (JaxConfig(weights=JaxWeights(*w), **kw),
            TorchConfig(weights=TorchWeights(*w), **kw))


def make_inputs(seed, k_real, m_real):
    """Seeded statics, packed node state, K packed profiles (padded to
    bucket(K) with zero rows) and M victims (padded to bucket(M) with
    node = N, rank = mb), all numpy."""
    rng = np.random.default_rng(seed)
    alloc = np.zeros((N_PAD, R), np.int32)
    alloc[:N_REAL, 0] = rng.choice([4000, 8000, 16000, 0], N_REAL)
    alloc[:N_REAL, 1] = rng.choice([8192, 16384, 65536], N_REAL)
    alloc[:N_REAL, 2] = rng.integers(0, 4000, N_REAL)
    exists = np.zeros(N_PAD, bool)
    exists[:N_REAL] = True
    statics = dict(
        sig_mask=rng.random((S, N_PAD)) < 0.8,
        sig_bonus=rng.integers(0, 60, (S, N_PAD)).astype(np.int32),
        node_alloc=alloc,
        node_max_tasks=np.where(exists, rng.integers(1, 6, N_PAD),
                                0).astype(np.int32),
        node_exists=exists,
        score_shift=np.asarray([score_shift_for(int(alloc[:, d].max()))
                                for d in range(2)], np.int32))
    used = (alloc * rng.random((N_PAD, R))).astype(np.int32)
    dyn = np.concatenate([
        used, rng.integers(0, 6, (N_PAD, 1)),
        (rng.random((N_PAD, NP)) < 0.3),
        rng.integers(0, 3, (N_PAD, NS)) * (rng.random((N_PAD, NS)) < 0.5),
    ], axis=1).astype(np.int32)
    kb = bucket(k_real)
    trows = np.zeros((kb, 1 + R + NP + 4 * NS), np.int32)
    trows[:k_real, 0] = rng.integers(0, S, k_real)
    trows[:k_real, 1:1 + R] = rng.integers(0, 9000, (k_real, R))
    off = 1 + R
    trows[:k_real, off:off + NP] = rng.random((k_real, NP)) < 0.25
    off += NP
    for _ in range(2):   # required affinity, anti-affinity
        trows[:k_real, off:off + NS] = rng.random((k_real, NS)) < 0.2
        off += NS
    for _ in range(2):   # preferred affinity and anti-affinity weights
        trows[:k_real, off:off + NS] = (
            rng.integers(0, 100, (k_real, NS))
            * (rng.random((k_real, NS)) < 0.4))
        off += NS
    mb = bucket(max(m_real, 1))
    vic_node = np.full(mb, N_PAD, np.int32)
    vic_rank = np.full(mb, mb, np.int32)
    vic_node[:m_real] = rng.integers(0, N_REAL, m_real)
    vic_rank[:m_real] = rng.permutation(m_real)
    return statics, dyn, trows, vic_node, vic_rank


def both_statics(statics):
    return (jax_scan.ScanStatics(**{k: jnp.asarray(v)
                                    for k, v in statics.items()}),
            torch_scan.ScanStatics(**{k: torch.as_tensor(v)
                                      for k, v in statics.items()}))


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_scan_nodes_equals_jax(cfg_name):
    jcfg, tcfg = configs(cfg_name)
    statics, dyn, trows, _, _ = make_inputs(11, 9, 9)
    js, ts = both_statics(statics)
    feasible = 0
    for k in range(9):
        want = np.asarray(jax_scan.scan_nodes(
            jcfg, R, NP, NS, js, jnp.asarray(dyn), jnp.asarray(trows[k])))
        got = torch_scan.scan_nodes(tcfg, R, NP, NS, ts,
                                    torch.as_tensor(dyn),
                                    torch.as_tensor(trows[k]))
        assert got.dtype == torch.int32 and got.shape == (N_PAD,)
        np.testing.assert_array_equal(got.numpy(), want)
        feasible += int((want > SCORE_NEG_INF).sum())
    assert 0 < feasible < 9 * N_PAD   # both outcomes exercised
    # best_scan_nodes takes the host's numpy rows and routes to the same
    # program.
    routed = torch_scan.best_scan_nodes(tcfg, R, NP, NS, ts, dyn, trows[3])
    np.testing.assert_array_equal(
        routed.numpy(),
        torch_scan.scan_nodes(tcfg, R, NP, NS, ts, torch.as_tensor(dyn),
                              torch.as_tensor(trows[3])).numpy())


@pytest.mark.parametrize("k_real,m_real", [(1, 0), (8, 8), (9, 9),
                                           (16, 1024), (17, 1025)])
@pytest.mark.parametrize("cfg_name", ["plain", "all-most-requested"])
def test_evict_batch_solve_equals_jax(cfg_name, k_real, m_real):
    jcfg, tcfg = configs(cfg_name)
    statics, dyn, trows, vic_node, vic_rank = make_inputs(
        7 + k_real, k_real, m_real)
    js, ts = both_statics(statics)
    want_scores, want_perm = jax_evict.evict_batch_solve(
        jcfg, R, NP, NS, js, jnp.asarray(dyn), jnp.asarray(trows),
        jnp.asarray(vic_node), jnp.asarray(vic_rank))
    scores, perm = torch_evict.evict_batch_solve(
        tcfg, R, NP, NS, ts, torch.as_tensor(dyn), torch.as_tensor(trows),
        torch.as_tensor(vic_node), torch.as_tensor(vic_rank))
    assert scores.dtype == torch.int32
    assert scores.shape == (bucket(k_real), N_PAD)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(want_scores))
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(want_perm).astype(np.int32))
    # Row k of the batch is the single-profile scan of trows[k], padding
    # rows included.
    for k in (0, k_real - 1, bucket(k_real) - 1):
        row = torch_scan.scan_nodes(tcfg, R, NP, NS, ts,
                                    torch.as_tensor(dyn),
                                    torch.as_tensor(trows[k]))
        np.testing.assert_array_equal(scores[k].numpy(), row.numpy())
    # The dispatch chokepoint routes to the same program.
    d_scores, d_perm = torch_evict.dispatch_evict_batch_solve(
        tcfg, R, NP, NS, ts, torch.as_tensor(dyn), torch.as_tensor(trows),
        torch.as_tensor(vic_node), torch.as_tensor(vic_rank))
    assert torch.equal(d_scores, scores) and torch.equal(d_perm, perm)


def test_victim_order_keeps_lexsort_ties():
    """Equal (node, rank) pairs — the padding rows, and any duplicate —
    keep their index order, as jnp.lexsort does."""
    rng = np.random.default_rng(3)
    node = rng.integers(0, 4, 40).astype(np.int32)
    rank = rng.integers(0, 5, 40).astype(np.int32)
    node[30:] = 9
    rank[30:] = 40
    want = np.asarray(jnp.lexsort((jnp.asarray(rank), jnp.asarray(node))))
    got = torch_evict.victim_order(torch.as_tensor(node),
                                   torch.as_tensor(rank))
    np.testing.assert_array_equal(got.numpy(), want)
