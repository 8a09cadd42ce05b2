"""Scheduler configuration: the default conf and its loader.

Counterpart of the configuration half of kube_batch_tpu/scheduler.py
(reference scheduler/util.go).  The periodic ``Scheduler`` loop and its
tenancy engine come with a later slice (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

from typing import List, Tuple

from .conf import (SchedulerConfiguration, Tier, apply_plugin_conf_defaults,
                   configuration_from_dict)
from .framework import Action, get_action

# The shipped default pipeline puts the device action first: tpu-allocate
# solves the allocate loop on the CUDA card and runs the host allocate
# path only where the session can't be tensorized
# (actions/tpu_allocate.py).  The reference's default is the host pair
# ``allocate, backfill`` (util.go:31-42); behavior is identical by the
# parity suite — only the engine differs.
DEFAULT_SCHEDULER_CONF = """
actions: "tpu-allocate, backfill"
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
"""


def parse_scheduler_conf(conf_str: str) -> SchedulerConfiguration:
    """The YAML conf as a SchedulerConfiguration, plugin enable flags
    defaulted, actions not yet resolved (the first half of
    ``load_scheduler_conf``)."""
    try:
        import yaml
        data = yaml.safe_load(conf_str) or {}
    except ImportError:  # fall back to a micro-parser for the default shape
        data = _mini_yaml(conf_str)

    conf = configuration_from_dict(data)
    for tier in conf.tiers:
        for option in tier.plugins:
            apply_plugin_conf_defaults(option)
    return conf


def load_scheduler_conf(conf_str: str) -> Tuple[List[Action], List[Tier]]:
    """Parse the YAML conf into (actions, tiers) (reference
    scheduler/util.go:44-73).  Every action must be registered
    (actions/factory.py registers allocate, preempt, reclaim, backfill
    and tpu-allocate); an unknown name raises KeyError.  The default conf
    loads whole, and so does the shipped four-action conf
    (config/kube-batch-conf.yaml) with tpu-allocate in place of
    allocate."""
    conf = parse_scheduler_conf(conf_str)
    actions = []
    for name in conf.actions.split(","):
        action = get_action(name.strip())
        if action is None:
            raise KeyError(f"failed to find Action {name.strip()}")
        actions.append(action)
    return actions, conf.tiers


def _mini_yaml(conf_str: str) -> dict:
    """Tiny parser for the conf subset (actions + tiers/plugins/name).

    Only the default conf shape is representable without PyYAML.  Any other
    construct (``arguments:``, ``enabled*`` flags, nested maps...) would
    silently degrade to bare plugin names — a scheduler quietly running a
    different policy than configured — so anything unrecognized raises
    instead (the reference always has yaml.v2; this fallback must never be
    *less* strict than it)."""
    data: dict = {"actions": "", "tiers": []}
    tier = None
    for raw in conf_str.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("actions:"):
            data["actions"] = line.split(":", 1)[1].strip().strip('"')
        elif line == "tiers:":
            continue
        elif line.startswith("- plugins:"):
            tier = {"plugins": []}
            data["tiers"].append(tier)
        elif line.startswith("- name:") and tier is not None:
            tier["plugins"].append({"name": line.split(":", 1)[1].strip()})
        else:
            raise ValueError(
                "scheduler conf uses constructs beyond the default shape "
                f"(line {raw!r}); install PyYAML to parse it — refusing to "
                "silently drop configuration")
    return data
