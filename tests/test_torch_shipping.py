"""The port's resident shipper against the JAX package's, on the CPU.

The packed host image must be byte-identical to JAX ``_pack_host`` with
the same dirty-block set; a delta ship must equal a full ship bit for
bit; the generation stays put on a clean ship and moves on a full ship,
a delta ship and ``invalidate``; a solve leaves the resident tensor as
it was.
"""

import jax
import numpy as np
import pytest
import torch

from kube_batch_tpu.models import shipping as jax_shipping
from kube_batch_tpu_torch.models import shipping
from kube_batch_tpu_torch.models.synthetic import (make_feature_inputs,
                                                   make_synthetic_inputs)
from kube_batch_tpu_torch.ops.solver import (SolverInputs, dispatch_solve,
                                             fetch_solve)
from test_torch_solver import to_jax

torch.set_num_threads(1)

STAGINGS = {
    "synthetic": lambda dt: make_synthetic_inputs(300, 60, 25, 4, seed=5,
                                                  dtype=dt, device="cpu"),
    "features": lambda dt: make_feature_inputs(1, dtype=dt, device="cpu"),
}
DTYPES = {"f64": (torch.float64, np.float64, True),
          "f32": (torch.float32, np.float32, False)}


def churn(inp: SolverInputs) -> SolverInputs:
    """A few node rows and one job's fairness state change."""
    used = inp.node_used.clone()
    used[[1, 7], 0] += 250
    alloc = inp.job_init_alloc.clone()
    alloc[3, 1] += 64
    return inp._replace(node_used=used, job_init_alloc=alloc)


def leaves_equal(a: SolverInputs, b: SolverInputs) -> None:
    for name, x, y in zip(SolverInputs._fields, a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


@pytest.mark.parametrize("mode", sorted(DTYPES))
@pytest.mark.parametrize("staging", sorted(STAGINGS))
def test_pack_host_byte_identical_to_jax(staging, mode):
    tdt, ndt, x64 = DTYPES[mode]
    inp, _ = STAGINGS[staging](tdt)
    moved = churn(inp)
    spec, flat = shipping._pack_host(inp, ndt, pad_to=shipping._BLOCK)
    spec2, flat2 = shipping._pack_host(moved, ndt, pad_to=shipping._BLOCK)
    with jax.enable_x64(x64):
        jspec, jflat, _ = jax_shipping._pack_host(to_jax(inp), ndt,
                                                  pad_to=jax_shipping._BLOCK)
        _, jflat2, _ = jax_shipping._pack_host(to_jax(moved), ndt,
                                               pad_to=jax_shipping._BLOCK)
    assert spec == tuple(jspec)
    assert flat.tobytes() == np.asarray(jflat).tobytes()
    assert flat2.tobytes() == np.asarray(jflat2).tobytes()
    ours = shipping.DeviceResidentShipper._dirty_blocks(flat, flat2)
    ref = jax_shipping.DeviceResidentShipper._dirty_blocks(jflat, jflat2)
    assert ours.size > 0
    assert np.array_equal(ours, ref)


def test_pack_host_recycles_a_matching_buffer():
    inp, _ = STAGINGS["synthetic"](torch.float64)
    spec, flat = shipping._pack_host(inp, np.float64, pad_to=shipping._BLOCK)
    out = np.full_like(flat, 7)
    spec2, flat2 = shipping._pack_host(inp, np.float64,
                                       pad_to=shipping._BLOCK, out=out)
    assert flat2 is out and spec2 == spec
    assert flat2.tobytes() == flat.tobytes()


@pytest.mark.parametrize("wire_fast", ["1", "0"])
@pytest.mark.parametrize("mode", sorted(DTYPES))
@pytest.mark.parametrize("staging", sorted(STAGINGS))
def test_delta_ship_equals_full_ship(staging, mode, wire_fast, monkeypatch):
    monkeypatch.setenv("KUBE_BATCH_TPU_WIRE_FAST", wire_fast)
    tdt = DTYPES[mode][0]
    inp, cfg = STAGINGS[staging](tdt)
    steady = shipping.DeviceResidentShipper("cpu")
    steady.ship(inp, cfg)
    moved = churn(inp)
    delta = steady.ship(moved, cfg)
    assert steady.last_mode == "delta"
    assert 0 < steady.last_bytes < steady._state.host_flat.nbytes
    fresh = shipping.DeviceResidentShipper("cpu")
    full = fresh.ship(moved, cfg)
    assert fresh.last_mode == "full"
    leaves_equal(delta, full)
    assert torch.equal(steady._state.device_flat, fresh._state.device_flat)
    # And once more back, through the recycled pack buffer.
    back = steady.ship(inp, cfg)
    assert steady.last_mode == "delta"
    leaves_equal(back, shipping.DeviceResidentShipper("cpu").ship(inp, cfg))


def test_generation_contract():
    inp, cfg = STAGINGS["synthetic"](torch.float64)
    sh = shipping.DeviceResidentShipper("cpu")
    assert sh.generation == 0
    sh.ship(inp, cfg)
    assert (sh.last_mode, sh.generation) == ("full", 1)
    sh.ship(inp, cfg)
    assert (sh.last_mode, sh.generation, sh.last_bytes) == ("clean", 1, 0)
    sh.ship(churn(inp), cfg)
    assert (sh.last_mode, sh.generation) == ("delta", 2)
    sh.invalidate()
    assert sh.generation == 3
    sh.ship(churn(inp), cfg)
    assert (sh.last_mode, sh.generation) == ("full", 4)
    # A solver-config or float-dtype change is a new layout: full ship.
    sh.ship(churn(inp), cfg._replace(has_gang=False))
    assert (sh.last_mode, sh.generation) == ("full", 5)
    sh.ship(churn(inp), cfg._replace(has_gang=False),
            float_dtype=torch.float32)
    assert (sh.last_mode, sh.generation) == ("full", 6)


def test_delta_ship_off_full_ships_every_time(monkeypatch):
    monkeypatch.setenv("KUBE_BATCH_TPU_DELTA_SHIP", "0")
    inp, cfg = STAGINGS["synthetic"](torch.float64)
    sh = shipping.DeviceResidentShipper("cpu")
    first = sh.ship(inp, cfg)
    second = sh.ship(inp, cfg)
    assert (sh.last_mode, sh.generation, sh._state) == ("full", 2, None)
    leaves_equal(first, second)


def test_resident_tensor_unchanged_by_a_solve():
    inp, cfg = STAGINGS["features"](torch.float64)
    sh = shipping.DeviceResidentShipper("cpu")
    shipped = sh.ship(inp, cfg)
    before = sh._state.device_flat.clone()
    assignment, kind, _order, ordered = fetch_solve(
        dispatch_solve(shipped, cfg))
    assert ordered.size > 0 and (kind > 0).sum() == ordered.size
    assert torch.equal(sh._state.device_flat, before)
    leaves_equal(shipped, sh.ship(inp, cfg))
    assert sh.last_mode == "clean"


def test_leaves_view_the_resident_tensor():
    inp, cfg = STAGINGS["synthetic"](torch.float64)
    sh = shipping.DeviceResidentShipper("cpu")
    shipped = sh.ship(inp, cfg)
    base = sh._state.device_flat.data_ptr()
    end = base + sh._state.device_flat.numel()
    assert base <= shipped.node_idle.data_ptr() < end
    assert base <= shipped.task_req.data_ptr() < end


def test_resident_shipper_is_per_owner():
    class Owner:
        pass

    a, b = Owner(), Owner()
    sh = shipping.resident_shipper(a, device="cpu")
    assert shipping.resident_shipper(a, device="cpu") is sh
    assert shipping.resident_shipper(b, device="cpu") is not sh
    b._ship_cache = sh
    with pytest.raises(RuntimeError, match="aliased"):
        shipping.resident_shipper(b)
    throwaway = shipping.resident_shipper(object(), device="cpu")
    assert isinstance(throwaway, shipping.DeviceResidentShipper)
