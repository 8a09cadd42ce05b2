"""Scheduler configuration schema.

Mirrors kube-batch pkg/scheduler/conf/scheduler_conf.go:19-56 (actions
string + plugin tiers with per-callback enable flags + untyped arguments) and
plugins/defaults.go:22-50 (flags default to enabled).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .framework.arguments import Arguments


@dataclass
class PluginOption:
    name: str = ""
    enabled_job_order: Optional[bool] = None
    enabled_job_ready: Optional[bool] = None
    enabled_job_pipelined: Optional[bool] = None
    enabled_task_order: Optional[bool] = None
    enabled_preemptable: Optional[bool] = None
    enabled_reclaimable: Optional[bool] = None
    enabled_queue_order: Optional[bool] = None
    enabled_predicate: Optional[bool] = None
    enabled_node_order: Optional[bool] = None
    arguments: Arguments = field(default_factory=Arguments)


@dataclass
class Tier:
    plugins: List[PluginOption] = field(default_factory=list)


@dataclass
class SchedulerConfiguration:
    actions: str = ""
    tiers: List[Tier] = field(default_factory=list)


_FLAG_KEYS = {
    "enableJobOrder": "enabled_job_order",
    "enableJobReady": "enabled_job_ready",
    "enableJobPipelined": "enabled_job_pipelined",
    "enableTaskOrder": "enabled_task_order",
    "enablePreemptable": "enabled_preemptable",
    "enableReclaimable": "enabled_reclaimable",
    "enableQueueOrder": "enabled_queue_order",
    "enablePredicate": "enabled_predicate",
    "enableNodeOrder": "enabled_node_order",
}


def apply_plugin_conf_defaults(option: PluginOption) -> None:
    """Unset enable flags default to True (plugins/defaults.go:22-50)."""
    for attr in _FLAG_KEYS.values():
        if getattr(option, attr) is None:
            setattr(option, attr, True)


def configuration_from_dict(data: dict) -> SchedulerConfiguration:
    """Build a SchedulerConfiguration from a parsed YAML/JSON mapping."""
    conf = SchedulerConfiguration(actions=data.get("actions", "") or "")
    for tier_data in data.get("tiers") or []:
        tier = Tier()
        for plugin_data in tier_data.get("plugins") or []:
            option = PluginOption(name=plugin_data.get("name", ""))
            for yaml_key, attr in _FLAG_KEYS.items():
                if yaml_key in plugin_data:
                    setattr(option, attr, bool(plugin_data[yaml_key]))
            option.arguments = Arguments(plugin_data.get("arguments") or {})
            tier.plugins.append(option)
        conf.tiers.append(tier)
    return conf
