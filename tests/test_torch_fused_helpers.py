"""The fused program's tensor helpers against the JAX package's:
``_lex_argmin``, ``dynamic_predicate_mask`` and ``_postevict_adjust``
(the storm leg's prediction and adjustment), each against the
reference's under ``jax.jit`` on the same staged inputs from a numpy
seed, in both float modes, exactly (integers, masks and the adjusted
leaves bit for bit).  The session twins are in tests/test_torch_fused.py
and tests/test_torch_fused_storm.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FLOAT_MODES = {"f64": (torch.float64, True), "f32": (torch.float32, False)}


def _jax_inputs(inp):
    from kube_batch_tpu.ops import solver as jax_solver
    return jax_solver.SolverInputs(*[jnp.asarray(t.numpy()) for t in inp])


def _jax_cfg(cfg):
    from kube_batch_tpu.ops import solver as jax_solver
    from kube_batch_tpu.ops.scoring import ScoreWeights
    return jax_solver.SolverConfig(**{**cfg._asdict(),
                                      "weights": ScoreWeights(*cfg.weights)})


@pytest.mark.parametrize("mode", sorted(FLOAT_MODES))
def test_lex_argmin_matches_the_reference(mode):
    """Masked lexicographic argmin with int keys past 2**24 (promoted to
    the key dtype: they tie in float32 and not in float64), float keys,
    and an all-false mask (index 0)."""
    from kube_batch_tpu.ops.solver import _lex_argmin as jax_lex
    from kube_batch_tpu_torch.ops.solver import _lex_argmin
    dtype, x64 = FLOAT_MODES[mode]
    rng = np.random.default_rng(11)
    fnp = np.float64 if x64 else np.float32
    for trial in range(40):
        n = 37
        mask = rng.random(n) < (0.0 if trial == 0 else 0.6)
        prio = -(2_000_000_000 + rng.integers(0, 3, n)).astype(np.int32)
        ts = rng.integers(0, 4, n).astype(fnp)
        rank = rng.permutation(n).astype(fnp)
        keys = [prio, ts, rank]
        with jax.enable_x64(x64):
            want = int(jax.jit(jax_lex)(jnp.asarray(mask),
                                        [jnp.asarray(k) for k in keys]))
        got = _lex_argmin(torch.from_numpy(mask),
                          [torch.from_numpy(k) for k in keys], dtype)
        assert got.dtype == torch.int32 and int(got) == want, trial


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dynamic_predicate_mask_matches_the_reference(seed):
    """Host-port and required pod (anti-)affinity masks for every task
    of a feature session, against the reference's."""
    from kube_batch_tpu.ops.solver import \
        dynamic_predicate_mask as jax_mask
    from kube_batch_tpu_torch.models.synthetic import make_feature_inputs
    from kube_batch_tpu_torch.ops.solver import dynamic_predicate_mask
    inp, cfg = make_feature_inputs(seed, dtype=torch.float64, device="cpu")
    cfg = cfg._replace(has_ports=True, has_pod_affinity=True)
    jinp, jcfg = _jax_inputs(inp), _jax_cfg(cfg)
    fn = jax.jit(jax_mask, static_argnums=0)
    for t in range(int(inp.task_req.shape[0])):
        want = np.asarray(fn(jcfg, jnp.int32(t), jinp.task_ports,
                             jinp.task_aff_req, jinp.task_anti,
                             jinp.node_ports, jinp.node_selcnt))
        got = dynamic_predicate_mask(
            cfg, torch.tensor(t, dtype=torch.int32), inp.task_ports,
            inp.task_aff_req, inp.task_anti, inp.node_ports,
            inp.node_selcnt).numpy()
        assert np.array_equal(got, want), t


def _storm_case(case, dtype):
    """Staged inputs, config and a victim staging (node, resreq, queue,
    job) from a numpy seed.  Victims include padding rows (node = N),
    victims of axis-absent queues and jobs (Q, J), and jobs of
    priority above 2**24.  ``did0`` makes every queue Overused, so the
    prediction does nothing."""
    from kube_batch_tpu_torch.models.synthetic import (make_feature_inputs,
                                                       make_synthetic_inputs)
    seed = {"synthetic": 0, "synthetic-seed5": 5, "features": 1,
            "did0": 0}[case]
    if case == "features":
        inp, cfg = make_feature_inputs(seed, dtype=dtype, device="cpu")
    else:
        inp, cfg = make_synthetic_inputs(120, 24, 12, 3, seed=seed,
                                         dtype=dtype, device="cpu")
    rng = np.random.default_rng(100 + seed)
    nb = int(inp.node_exists.shape[0])
    qb = int(inp.queue_exists.shape[0])
    jb = int(inp.job_start.shape[0])
    r = int(inp.task_req.shape[1])
    n_real = int(inp.node_exists.numpy().sum())
    n_jobs = int((inp.job_count.numpy() > 0).sum())
    prio = (2_000_000_000 + rng.integers(0, 3, jb)).astype(np.float64)
    inp = inp._replace(job_prio=torch.from_numpy(prio).to(dtype))
    if case == "did0":
        inp = inp._replace(queue_init_alloc=inp.queue_deserved + 1000)
    mb, m = 64, 44
    vic_node = np.full((mb,), nb, np.int32)
    vic_res = np.zeros((mb, r), np.int32)
    vic_queue = np.full((mb,), qb, np.int32)
    vic_job = np.full((mb,), jb, np.int32)
    vic_node[:m] = np.sort(rng.integers(0, n_real, m))
    vic_res[:m, 0] = rng.choice([500, 1000, 2000, 4000], m)
    vic_res[:m, 1] = rng.choice([512, 2048, 8192], m)
    if r > 2:
        vic_res[:m, 2] = rng.choice([0, 1000], m)
    vic_queue[:m] = rng.integers(0, qb + 1, m)        # qb: absent queue
    vic_job[:m] = rng.integers(0, min(n_jobs + 2, jb + 1), m)
    vic_job[rng.random(mb) < 0.1] = jb                # absent jobs
    return inp, cfg, (vic_node, vic_res, vic_queue, vic_job)


@pytest.mark.parametrize("mode", sorted(FLOAT_MODES))
@pytest.mark.parametrize("case", ["synthetic", "synthetic-seed5",
                                  "features", "did0"])
def test_postevict_adjust_matches_the_reference(case, mode):
    """``_postevict_adjust`` against the reference's under ``jax.jit`` on
    the same staged inputs: equal adjusted leaves, ``meta`` and ``sel``.
    The prediction does something in the synthetic and feature cases
    and nothing in ``did0``."""
    from kube_batch_tpu.ops.fused_solver import \
        _postevict_adjust as jax_adjust
    from kube_batch_tpu_torch.ops.fused_solver import _postevict_adjust
    dtype, x64 = FLOAT_MODES[mode]
    inp, cfg, vic = _storm_case(case, dtype)
    adj, meta, sel = _postevict_adjust(
        inp, cfg, *(torch.from_numpy(v) for v in (vic[0], vic[1], vic[2],
                                                  vic[3])))
    with jax.enable_x64(x64):
        jadj, jmeta, jsel = jax.jit(jax_adjust, static_argnums=1)(
            _jax_inputs(inp), _jax_cfg(cfg), jnp.asarray(vic[0]),
            jnp.asarray(vic[1]), jnp.asarray(vic[2]), jnp.asarray(vic[3]))
        jadj = [np.asarray(leaf) for leaf in jadj]
        jmeta, jsel = np.asarray(jmeta), np.asarray(jsel)
    assert np.array_equal(meta.numpy(), jmeta), (meta, jmeta)
    assert np.array_equal(sel.numpy(), jsel)
    for name, got, want in zip(type(adj)._fields, adj, jadj):
        got = got.numpy()
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name
    if case == "did0":
        assert int(meta[0]) == 0 and not sel.any()
        for got, base in zip(adj, inp):
            assert torch.equal(got, base)
    else:
        assert int(meta[0]) == 1 and int(meta[5]) == int(sel.sum()) > 0


