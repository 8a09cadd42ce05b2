"""The port's knob registry against the JAX package's.

One environment must select the same arm in both packages: every
``KUBE_BATCH_TPU_*`` knob of the reference is declared in the port with
the same kind, default, parity flag and bounds, and reads the same value
from the same environment, malformed values included.
"""

import contextlib
import os

import pytest

import kube_batch_tpu.knobs as jax_knobs
import kube_batch_tpu_torch.knobs as torch_knobs

# Raw values tried against every knob: unset, empty, the two flag values,
# a number, a negative number and garbage.
RAWS = (None, "", "0", "1", "7", "-3", "garbage")


@pytest.fixture(autouse=True)
def _forget_port_warnings():
    """Reading every knob with garbage makes the port's registry warn
    once per knob per process; forget those warnings after each case, as
    tests/conftest.py does for the reference's registry, so a later test
    file in the same worker still sees its own warning."""
    yield
    torch_knobs.reset_warnings()


@contextlib.contextmanager
def raw_env(env, raw):
    """``env`` unset (``raw`` None) or set to ``raw`` for the block."""
    old = os.environ.pop(env, None)
    if raw is not None:
        os.environ[env] = raw
    try:
        yield
    finally:
        os.environ.pop(env, None)
        if old is not None:
            os.environ[env] = old


def _read(knob):
    if knob.kind in ("flag-on", "flag-opt-in", "flag-set"):
        return knob.enabled()
    if knob.kind == "tristate":
        return knob.tristate()
    if knob.kind in ("int", "float"):
        return knob.value()
    return knob.raw()


def test_registries_declare_the_same_knobs():
    assert sorted(torch_knobs.REGISTRY) == sorted(jax_knobs.REGISTRY)
    assert len(torch_knobs.REGISTRY) >= 40


# Help texts that name the port's own tool where the reference names
# JAX's: (the reference's words, the port's words).
HELP_WORDS = {"KUBE_BATCH_TPU_PROFILE": ("JAX profiler", "torch.profiler")}


@pytest.mark.parametrize("env", sorted(jax_knobs.REGISTRY))
def test_knob_reads_equal_the_reference(env):
    ref, ours = jax_knobs.REGISTRY[env], torch_knobs.REGISTRY[env]
    for field in ("kind", "default", "parity", "minimum", "clamp_min",
                  "doc"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.help == ref.help.replace(*HELP_WORDS.get(env, ("", ""))), \
        "help"
    assert ours.owner == ref.owner.replace("kube_batch_tpu.",
                                           "kube_batch_tpu_torch.", 1)
    for raw in RAWS:
        with raw_env(env, raw):
            assert _read(ours) == _read(ref), raw
