"""Global action/plugin registries.

Mirrors kube-batch pkg/scheduler/framework/plugins.go:26-88 (mutex-guarded
maps; plugin builders are ``Arguments -> Plugin`` factories).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from .arguments import Arguments
from .interface import Action, Plugin

PluginBuilder = Callable[[Arguments], Plugin]

_lock = threading.Lock()
_plugin_builders: Dict[str, PluginBuilder] = {}  # guarded-by: _lock
_actions: Dict[str, Action] = {}                 # guarded-by: _lock


def register_plugin_builder(name: str, builder: PluginBuilder) -> None:
    with _lock:
        _plugin_builders[name] = builder


def get_plugin_builder(name: str) -> Optional[PluginBuilder]:
    with _lock:
        return _plugin_builders.get(name)


def cleanup_plugin_builders() -> None:
    with _lock:
        _plugin_builders.clear()


def register_action(action: Action) -> None:
    with _lock:
        _actions[action.name()] = action


def get_action(name: str) -> Optional[Action]:
    with _lock:
        return _actions.get(name)


def list_actions() -> Dict[str, Action]:
    with _lock:
        return dict(_actions)
