"""The device breaker and tpu-allocate's degradation, the JAX package
against the port, on the CPU.

Twins of ``tests/test_chaos.py::TestCircuitBreaker`` (its mesh case
waits for the node-sharded route, ROADMAP queue 1 item 5), over
``tests/test_torch_e2e.Harness``, and the degradation of one
tpu-allocate session at each device stage — tensorize, ship, dispatch,
fetch, validation (a poisoned readback) — and the solve deadline, in the
``KUBE_BATCH_TPU_PIPELINE=0`` arm and in the pipelined one.  Each case
runs once per package (tests/test_torch_utils.loop_twin) and both must
give the same binds, failure counts by stage, breaker state and
degraded notes; a failed stage drops the resident image
(``shipper._state is None``) and the next ship is ``full``.
"""

import importlib

import pytest

from tests.test_torch_e2e import CONF_TPU, Harness
from tests.test_torch_utils import loop_twin
from tests.test_torch_utils import reference_gc_guard  # noqa: F401

ROOTS = ("kube_batch_tpu", "kube_batch_tpu_torch")


def _mod(lp, name):
    root = "kube_batch_tpu_torch" if lp.pkg == "torch" else "kube_batch_tpu"
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def _clean_chaos():
    """Both packages' fault plans off and both breakers closed, before
    and after each case."""
    def clean():
        for root in ROOTS:
            importlib.import_module(f"{root}.chaos.plan").disable()
            importlib.import_module(
                f"{root}.chaos.breaker").device_breaker().reset()
    clean()
    yield
    clean()


def _breaker(lp, monkeypatch, threshold, clk):
    brk = _mod(lp, "chaos.breaker")
    br = brk.CircuitBreaker("device_solve", threshold=threshold,
                            cooldown=30.0, clock=lambda: clk[0])
    monkeypatch.setattr(brk, "_device_breaker", br)
    return br


def _notes(lp):
    tr = _mod(lp, "trace").flight_recorder.latest()
    return list(tr.meta.get("degraded", [])) if tr is not None else []


class TestCircuitBreaker:
    def test_state_machine(self):
        def body(lp):
            clk = [0.0]
            br = _mod(lp, "chaos.breaker").CircuitBreaker(
                "t", threshold=3, cooldown=10.0, clock=lambda: clk[0])
            seen = [br.state(), br.allow()]
            br.failure()
            br.failure()
            seen.append(br.state())
            br.failure()
            seen += [br.state(), br.allow()]
            clk[0] = 9.9
            seen.append(br.allow())
            clk[0] = 10.0
            seen += [br.allow(), br.state()]
            br.failure()
            seen += [br.state(), br.allow()]
            clk[0] = 20.0
            seen += [br.allow(), br.state()]
            br.success()
            seen += [br.state(), br.allow()]
            return seen

        assert loop_twin(body) == [
            "closed", True, "closed", "open", False, False, True,
            "half-open", "open", False, True, "half-open", "closed", True]

    def test_success_resets_consecutive_count(self):
        def body(lp):
            br = _mod(lp, "chaos.breaker").CircuitBreaker(
                "t2", threshold=2, cooldown=10.0)
            br.failure()
            br.success()
            br.failure()
            return br.state()

        assert loop_twin(body) == "closed"

    def test_breaker_trips_to_host_path_and_recovers(self, monkeypatch):
        """Repeated device-solve failures degrade cycles to the host path
        (which still schedules), trip the breaker open (the device path
        is no longer attempted), and a half-open probe after the cooldown
        closes it once the device heals."""
        def body(lp):
            clk = [0.0]
            br = _breaker(lp, monkeypatch, 2, clk)
            plan = lp.chaos_plan.install(lp.chaos_plan.FaultPlan(
                seed=1, rate=1.0, sites=("solve.device_error",)))
            h = Harness(lp, conf=CONF_TPU)
            h.add_nodes(2, cpu="4")
            h.create_job("fit", 2, 2)
            h.create_job("hog", 1, 1, cpu="64")  # never fits
            seen = []
            h.cycle()
            seen += [len(h.bound("fit")), br.state()]
            h.cycle()
            seen.append(br.state())
            before = plan.injected().get("solve.device_error", 0)
            h.cycle()
            seen += [plan.injected().get("solve.device_error", 0) - before,
                     br.state(),
                     any("breaker open" in n for n in _notes(lp))]
            lp.chaos_plan.disable()
            clk[0] = 31.0
            h.cycle()
            seen.append(br.state())
            return seen, h.outcome()

        seen, _ = loop_twin(body)
        assert seen == [2, "closed", "open", 0, "open", True, "closed"]

    def test_solve_deadline_counts_as_breaker_failure(self, monkeypatch):
        def body(lp):
            clk = [0.0]
            br = _breaker(lp, monkeypatch, 1, clk)
            brk = _mod(lp, "chaos.breaker")
            monkeypatch.setenv(brk.SOLVE_DEADLINE_ENV, "1")
            lp.chaos_plan.install(lp.chaos_plan.FaultPlan(
                seed=2, rate=1.0, sites=("solve.slow",)))
            before = lp.metrics.solve_deadline_exceeded.value()
            h = Harness(lp, conf=CONF_TPU)
            h.add_nodes(2)
            h.create_job("j", 2, 2)
            h.cycle()
            monkeypatch.delenv(brk.SOLVE_DEADLINE_ENV)
            return (len(h.bound("j")),
                    lp.metrics.solve_deadline_exceeded.value() - before,
                    br.state(),
                    [n.split(" (")[0] for n in _notes(lp)])

        assert loop_twin(body) == (
            2, 1.0, "open", ["session solve exceeded deadline"])


# ----------------------------------------------------------------------
# tpu-allocate degradation at each device stage


def _stage_fault(lp, monkeypatch, stage):
    """Arm the fault for ``stage`` in package ``lp``; returns the plan
    (or None when the fault is a patched function)."""
    cp = lp.chaos_plan
    if stage == "tensorize":
        return cp.install(cp.FaultPlan(seed=1, rate=1.0,
                                       sites=("session.tensorize",)))
    if stage == "dispatch":
        return cp.install(cp.FaultPlan(seed=1, rate=1.0,
                                       sites=("solve.device_error",)))
    if stage == "validation":
        return cp.install(cp.FaultPlan(seed=1, rate=1.0,
                                       sites=("solve.poison",)))
    if stage == "deadline":
        brk = _mod(lp, "chaos.breaker")
        monkeypatch.setenv(brk.SOLVE_DEADLINE_ENV, "1")
        return cp.install(cp.FaultPlan(seed=2, rate=1.0,
                                       sites=("solve.slow",)))
    if stage == "ship":
        # A ship that rewrote the resident image and then failed: the
        # half-written image must never serve as the next baseline.
        cls = lp.shipping.DeviceResidentShipper
        real = cls.ship

        def ship(self, *a, **k):
            real(self, *a, **k)
            raise RuntimeError("injected ship failure")

        monkeypatch.setattr(cls, "ship", ship)
        return None
    assert stage == "fetch"
    name = ("fetch_solve" if lp.pkg_pipelined else "fetch_result")
    real = getattr(lp.solver, name)

    def fetch(*a, **k):
        real(*a, **k)
        raise RuntimeError("injected fetch failure")

    monkeypatch.setattr(lp.solver, name, fetch)
    return None


EXPECT = {
    # stage: (failure-counter label, degraded note prefix, breaker fails)
    "tensorize": ("tensorize", "device tensorize failed", 1),
    "ship": ("solve", "device solve failed", 1),
    "dispatch": ("solve", "device solve failed", 1),
    "fetch": ("solve", "device solve failed", 1),
    "validation": ("solve", "device solve failed", 1),
    "deadline": (None, "session solve exceeded deadline", 1),
}


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["pipeline0", "pipelined"])
@pytest.mark.parametrize("stage", list(EXPECT))
def test_tpu_allocate_degrades_at_stage(monkeypatch, stage, pipelined):
    """One failing session degrades to the host allocate action with the
    binds of a fault-free session; the failure is counted by stage, fed
    to the breaker once and noted in the trace; a failed stage drops the
    resident image and the next session ships ``full``.  The deadline
    is detective: the late result is applied and the image kept."""
    label, note, fails = EXPECT[stage]

    def body(lp):
        lp.pkg_pipelined = pipelined
        monkeypatch.setenv("KUBE_BATCH_TPU_PIPELINE",
                           "1" if pipelined else "0")

        def harness():
            h = Harness(lp, conf=CONF_TPU)
            h.add_nodes(3, cpu="4")
            h.create_job("a", 3, 3)
            h.create_job("b", 2, 2, queue="q2")
            h.create_job("hog", 1, 1, cpu="64")
            return h

        clean = harness()
        clean.cycle()
        want = clean.outcome()
        br = _breaker(lp, monkeypatch, 99, [0.0])
        fed = []
        real_failure = br.failure
        br.failure = lambda: (fed.append(1), real_failure())[1]
        h = harness()
        shipper = lp.shipping.resident_shipper(
            h.cache, **({"device": "cpu"} if lp.pkg == "torch" else {}))
        failures = dict(lp.metrics.device_solve_failures.values())
        _stage_fault(lp, monkeypatch, stage)
        h.cycle()
        got = h.outcome()
        notes = [n for n in _notes(lp) if n.startswith(note)]
        dropped = shipper._state is None
        lp.chaos_plan.disable()
        monkeypatch.undo()
        delta = {k[0]: v - failures.get(k, 0) for k, v in
                 lp.metrics.device_solve_failures.values().items()
                 if v != failures.get(k, 0)}
        # The next session: a pod arrives, the device path ships again.
        h.create_job("late", 1, 1)
        h.cycle()
        return (got == want, len(fed), delta, len(notes), dropped,
                shipper.last_mode, len(h.bound("late")))

    ok, fed, delta, notes, dropped, mode, late = loop_twin(body)
    assert ok
    assert fed == fails and notes == 1
    assert delta == ({label: 1.0} if label else {})
    if stage == "deadline":
        assert not dropped and mode in ("delta", "full")
    else:
        assert dropped and mode == "full"
    assert late == 1
