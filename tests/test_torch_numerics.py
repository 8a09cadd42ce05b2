"""The port's resource, scoring and fairness math against the JAX package.

Same inputs, made with numpy from one seed, through both; every result
must be bit-equal.  Random int32 quanta include values around the
epsilon, zero capacities (cs == 0), zero totals and a third (scalar)
resource dim.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.ops import fairness as jf
from kube_batch_tpu.ops import resources as jr
from kube_batch_tpu.ops import scoring as js
from kube_batch_tpu_torch.ops import fairness as tf
from kube_batch_tpu_torch.ops import resources as tr
from kube_batch_tpu_torch.ops import scoring as ts

torch.set_num_threads(1)


def same(ours: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    ours = ours.numpy()
    assert ours.dtype == ref.dtype, (ours.dtype, ref.dtype)
    assert ours.shape == ref.shape
    assert np.array_equal(ours.view(np.uint8), ref.view(np.uint8))


def quanta(rng, shape, high=70_000):
    """int32 quanta with many near-epsilon differences and zeros."""
    x = rng.integers(0, high, size=shape).astype(np.int32)
    x[rng.random(shape) < 0.2] = 0
    near = rng.random(shape) < 0.3
    x[near] = rng.integers(0, 25, size=int(near.sum()))
    return x


def test_constants_and_host_helpers():
    assert (tr.CPU_QUANTUM, tr.MEMORY_QUANTUM, tr.SCALAR_QUANTUM,
            tr.EPS_QUANTA, tr.SCORE_GRID_K) == (
        jr.CPU_QUANTUM, jr.MEMORY_QUANTUM, jr.SCALAR_QUANTUM, jr.EPS_QUANTA,
        jr.SCORE_GRID_K)
    assert ts.SCORE_NEG_INF == js.SCORE_NEG_INF
    assert ts.ScoreWeights() == tuple(js.ScoreWeights())
    rng = np.random.default_rng(0)
    for cap in [0, 1, 1023, 1024, 65536, 2 ** 31 - 1,
                *rng.integers(0, 2 ** 31 - 1, 20)]:
        assert tr.score_shift_for(cap) == jr.score_shift_for(cap)
    for x, cap, shift in rng.integers(0, 70_000, size=(50, 3)):
        shift = int(shift) % 8
        assert tr.grid_fraction_int(x, cap, shift) == \
            jr.grid_fraction_int(x, cap, shift)
    assert tr.grid_fraction_int(5, 3, 2) == jr.grid_fraction_int(5, 3, 2)
    arr = rng.uniform(0, 1e12, size=(6, 3))
    assert np.array_equal(tr.scale_columns(arr.copy()),
                          jr.scale_columns(arr.copy()))
    assert np.array_equal(tr.quantize_columns(arr), jr.quantize_columns(arr))
    for v, d in ((1.5e9, 1), (2500.0, 0), (7.0, 2)):
        assert tr.quantize_value(v, d) == jr.quantize_value(v, d)


@pytest.mark.parametrize("r", [1, 2, 3])
def test_eps_vector_and_scalar_dims(r):
    same(tr.eps_vector(r, device="cpu"), jr.eps_vector(r))
    same(tr.scalar_dims_mask(r, device="cpu"), jr.scalar_dims_mask(r))


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_epsilon_compares(r, seed):
    rng = np.random.default_rng(seed)
    left = quanta(rng, (64, r))
    right = np.where(rng.random((64, r)) < 0.5,
                     left + rng.integers(-12, 13, size=(64, r)),
                     quanta(rng, (64, r))).astype(np.int32)
    eps_t, eps_j = tr.eps_vector(r, device="cpu"), jr.eps_vector(r)
    sd_t, sd_j = tr.scalar_dims_mask(r, device="cpu"), jr.scalar_dims_mask(r)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    lj, rj = jnp.asarray(left), jnp.asarray(right)
    same(tr.less_equal_vec(lt, rt, eps_t, sd_t),
         jr.less_equal_vec(lj, rj, eps_j, sd_j))
    same(tr.less_vec(lt, rt, eps_t, sd_t), jr.less_vec(lj, rj, eps_j, sd_j))
    same(tr.is_empty_vec(lt, eps_t), jr.is_empty_vec(lj, eps_j))


def test_epsilon_compares_wrap_like_int32():
    extremes = np.array([[-2 ** 31, 5], [2 ** 31 - 1, -2 ** 31],
                         [0, 2 ** 31 - 1]], np.int32)
    other = extremes[::-1].copy()
    eps_t, eps_j = tr.eps_vector(2, device="cpu"), jr.eps_vector(2)
    sd_t, sd_j = tr.scalar_dims_mask(2, device="cpu"), jr.scalar_dims_mask(2)
    same(tr.less_equal_vec(torch.from_numpy(extremes), torch.from_numpy(other),
                           eps_t, sd_t),
         jr.less_equal_vec(jnp.asarray(extremes), jnp.asarray(other), eps_j,
                           sd_j))


@pytest.mark.parametrize("weights", [(1, 0, 1), (0, 1, 0), (2, 3, 5)])
@pytest.mark.parametrize("seed", [0, 1])
def test_grid_score(weights, seed):
    rng = np.random.default_rng(seed)
    n = 96
    alloc = np.zeros((n, 3), np.int32)
    alloc[:, 0] = rng.choice([0, 4000, 16000, 64000], size=n)
    alloc[:, 1] = rng.choice([0, 3, 8192, 65536, 262144], size=n)  # cs == 0
    alloc[:, 2] = rng.integers(0, 5000, size=n)
    used = (alloc * rng.uniform(0, 1.2, size=(n, 1))).astype(np.int32)
    shift = np.asarray([jr.score_shift_for(int(alloc[:, d].max()))
                        for d in range(2)], np.int32)
    res = quanta(rng, (3,), high=9000)
    w_t = ts.ScoreWeights(*weights)
    w_j = js.ScoreWeights(*weights)
    cs_t, den_t = ts.shifted_caps(torch.from_numpy(alloc),
                                  torch.from_numpy(shift))
    cs_j, den_j = js.shifted_caps(jnp.asarray(alloc), jnp.asarray(shift))
    for a, b in zip(cs_t + den_t, cs_j + den_j):
        same(a, b)
    assert any(int((c == 0).sum()) for c in cs_t)
    same(ts.grid_score(torch.from_numpy(res), torch.from_numpy(used),
                       torch.from_numpy(shift), cs_t, den_t, w_t),
         js.grid_score(jnp.asarray(res), jnp.asarray(used),
                       jnp.asarray(shift), cs_j, den_j, w_j))
    same(ts.score_nodes(torch.from_numpy(res), torch.from_numpy(used),
                        torch.from_numpy(alloc), torch.from_numpy(shift), w_t),
         js.score_nodes(jnp.asarray(res), jnp.asarray(used),
                        jnp.asarray(alloc), jnp.asarray(shift), w_j))


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_shares(r, seed):
    rng = np.random.default_rng(seed)
    alloc = quanta(rng, (32, r))
    total = quanta(rng, (r,), high=10 ** 7)
    total[0] = 0                           # total == 0 column
    deserved = rng.uniform(0, 1e5, size=(32, r))
    deserved[rng.random((32, r)) < 0.2] = 0.0
    same(tf.safe_share(torch.from_numpy(alloc), torch.from_numpy(total)),
         jf.safe_share(jnp.asarray(alloc), jnp.asarray(total)))
    same(tf.drf_shares(torch.from_numpy(alloc), torch.from_numpy(total)),
         jf.drf_shares(jnp.asarray(alloc), jnp.asarray(total)))
    for fdt in (np.float64, np.float32):
        d = deserved.astype(fdt)
        same(tf.queue_shares(torch.from_numpy(alloc), torch.from_numpy(d)),
             jf.queue_shares(jnp.asarray(alloc), jnp.asarray(d)))


@pytest.mark.parametrize("x64", [True, False])
@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_proportion_deserved(seed, r, x64):
    rng = np.random.default_rng(seed)
    q = 8
    fdt = np.float64 if x64 else np.float32
    total = rng.integers(10_000, 2_000_000, size=r).astype(fdt)
    if seed == 2:
        total[-1] = 0.0                    # a dim with nothing to share
    weight = rng.integers(1, 5, size=q).astype(fdt)
    request = rng.uniform(0, 800_000, size=(q, r)).astype(fdt)
    request[rng.random((q, r)) < 0.2] = 0.0
    active = rng.random(q) < 0.8
    with jax.enable_x64(x64):
        ref = jf.proportion_deserved(jnp.asarray(total), jnp.asarray(weight),
                                     jnp.asarray(request), jnp.asarray(active))
        ref = np.asarray(ref)
    ours = tf.proportion_deserved(torch.from_numpy(total),
                                  torch.from_numpy(weight),
                                  torch.from_numpy(request),
                                  torch.from_numpy(active))
    same(ours, ref)
