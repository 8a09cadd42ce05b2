"""The ``KUBE_BATCH_TPU_*`` knobs this package reads.

Same environment names, kinds and defaults as kube_batch_tpu/knobs.py, so
one environment selects the same arm in both packages.  Only the knobs
the ported modules read are declared here.  Both are ``flag-on`` knobs:
unset or empty means enabled (the default), only ``"0"`` disables, and
any other value warns once per process and counts as enabled.
"""

from __future__ import annotations

import logging
import os
import threading

_warned: set = set()               # guarded-by: _warned_lock
_warned_lock = threading.Lock()


class Knob:
    """One declared ``flag-on`` environment flag; reads are always fresh."""

    __slots__ = ("env", "owner")

    def __init__(self, env: str, owner: str):
        self.env = env
        self.owner = owner

    def enabled(self) -> bool:
        raw = os.environ.get(self.env)
        if raw not in (None, "", "0", "1"):
            with _warned_lock:
                first = self.env not in _warned
                _warned.add(self.env)
            if first:
                logging.getLogger(self.owner).warning(
                    "%s=%r is neither 0 nor 1; treating it as enabled",
                    self.env, raw)
        return raw != "0"


# Pack-scratch recycling of retired host images (models/shipping.py).
WIRE_FAST = Knob("KUBE_BATCH_TPU_WIRE_FAST",
                 "kube_batch_tpu_torch.models.shipping")
# Dirty-block delta shipping to the device-resident buffer; =0 full-ships
# every session and keeps no resident state.
DELTA_SHIP = Knob("KUBE_BATCH_TPU_DELTA_SHIP",
                  "kube_batch_tpu_torch.models.shipping")
